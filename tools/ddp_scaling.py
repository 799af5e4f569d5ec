#!/usr/bin/env python3
"""Data-parallel scaling of the port's trainer over the GPUs of one host:
`python3 tools/ddp_scaling.py` from the repository's root (on a host with
4 cards: `--worlds 1,2,4`, the default, capped at the visible count).

The fundus reference configuration (chip_smoke.py's main path: domains
1,2,3 -> 0, 256^2, U-Net n=16, the device pipeline over 4 x 64 in-memory
images) at its batch 16 = 3+6+7 and at `--global_batch 48` (16 a domain,
the LR x 3).  For each: `fit` in this process without a process group
(the single-process baseline), then for each world size N a launch of N
NCCL ranks, one GPU a rank (`chip_smoke.ddp_launch`: step 0 against the
single-process step within step_parity's bounds, then `fit`, K1 once a step
on every rank, the replicas bit-equal).  Each run takes `--steps` steps
(medians over those after the step timer's 2 warm-up steps) and an eval of
8 images on rank 0 at each epoch's end (64 images a domain: 21 steps an
epoch at batch 16, 4 at 48) and at the last step.  JSON lines on stdout and in
chiprun_out/ddp_scaling/phases.jsonl: each launch's "ddp" lines, a
"baseline" line a configuration, and a "scaling" line a configuration with
each world's median step, global img/s and speed-up over the baseline, the
gradient all-reduce's CUDA-event time and share, all all-reduces' host time
a step, and each rank's peak memory; then the cards' nvidia-smi lines.

`--device cpu --image_size 32` rehearses it on the CPU with gloo ranks.
"""
import argparse
import dataclasses
import os
import shutil
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--worlds", default="1,2,4")
    p.add_argument("--steps", type=int, default=12)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--image_size", type=int, default=256)
    a = p.parse_args(argv)

    import numpy as np
    import torch

    import chip_smoke as smoke
    from ramdsir_tpu_torch.config import TrainConfig
    from ramdsir_tpu_torch.data.synthetic import fundus_arrays, fundus_test_samples
    from ramdsir_tpu_torch.ops import batch_norm, ram_mix, upsample
    from ramdsir_tpu_torch.train.loop import fit

    on_card = a.device == "cuda"
    if on_card and not torch.cuda.is_available():
        print("ddp_scaling: CUDA is not available", file=sys.stderr)
        return 1
    visible = torch.cuda.device_count() if on_card else 4
    worlds = [w for w in (int(x) for x in a.worlds.split(",")) if w <= visible]
    smoke.OUT = os.path.join(REPO, "chiprun_out", "ddp_scaling")
    smoke.DEVICE, smoke.S = a.device, a.image_size
    shutil.rmtree(smoke.OUT, ignore_errors=True)
    os.makedirs(smoke.OUT)
    if on_card:
        for lib in (ram_mix.LIBRARY, upsample.LIBRARY, batch_norm.LIBRARY):
            lib.path()  # built once here, loaded by every rank
    arrays = fundus_arrays(per_domain_train=64, size=a.image_size, seed=0)
    testset = fundus_test_samples(num=8, size=2 * a.image_size, image_size=a.image_size, seed=1)
    card = smoke.nvidia_smi_line() if on_card else "not measured"
    try:
        for label, variant in (("batch16", {}), ("global_batch48", {"global_batch": 48})):
            cfg = dataclasses.replace(
                smoke.main_path_config(TrainConfig, "default", os.path.join(smoke.OUT, label), **variant),
                device=a.device,
            )
            if on_card:
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            base = fit(dataclasses.replace(cfg, save_path=os.path.join(smoke.OUT, label, "baseline")),
                       max_steps=a.steps, pipeline=smoke.ddp_pipe(cfg, arrays, a.device), testset=testset)
            baseline = dict(config=label, batch=sum(cfg.batch_size_list), median_step_ms=base["median_step_ms"],
                            images_per_sec=base["images_per_sec"], wall_s=time.perf_counter() - t0,
                            peak_memory_bytes=torch.cuda.max_memory_allocated() if on_card else "not measured")
            smoke.emit("baseline", **baseline)
            rows = {}
            for world in worlds:
                devices = [f"cuda:{r}" for r in range(world)] if on_card else ["cpu"] * world
                got = smoke.ddp_launch(torch, np, ram_mix, cfg, arrays, testset, world, "nccl" if on_card else "gloo",
                                       devices, ["plain"], a.steps, f"{label}_world{world}", "one GPU a rank")
                (entry,) = got.values()
                rows[world] = dict(
                    median_step_ms=entry["median_step_ms"][0], images_per_sec=entry["images_per_sec"],
                    speedup=entry["images_per_sec"] / base["images_per_sec"] if base["images_per_sec"] else None,
                    grad_all_reduce_ms=entry["grad_all_reduce_ms"][0],
                    grad_all_reduce_share=entry.get("grad_all_reduce_share"),
                    all_reduce_host_ms_per_step=entry["all_reduce_host_ms_per_step"][0],
                    all_reduce_host_share=entry.get("all_reduce_host_share"),
                    peak_memory_bytes=entry["peak_memory_bytes"],
                )
            smoke.emit("scaling", config=label, card=card, baseline=baseline, worlds=rows)
    finally:
        for root, _, files in os.walk(smoke.OUT):
            for f in files:
                if f.endswith((".pth", ".ckpt")):
                    os.remove(os.path.join(root, f))
        shutil.rmtree(smoke.DDP_OUT, ignore_errors=True)
    if on_card:
        import subprocess

        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
