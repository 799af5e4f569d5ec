"""Train CLI: the JAX package's flags (`ramdsir_tpu/cli/train.py`) plus
--device.  Every variant runs.

--num_devices N > 1 trains data-parallel over N ranks that this
process starts (`parallel/distributed.py`): NCCL on cuda:0..N-1 (one GPU a rank;
more ranks than visible GPUs raise), or with --device cpu N gloo ranks on
the CPU.  Without the flag it is every visible CUDA device, as the JAX
package takes every device; on the CPU, or on a host with one card, that is
the single-process path.  Under torchrun (RANK, WORLD_SIZE, LOCAL_RANK set)
the process joins the launch's group as its rank instead:
  torchrun --nproc_per_node 2 -m ramdsir_tpu_torch.cli.train ...
Rank 0 writes the run's files and evaluates; the step is the global
batch's (sync-BN over the ranks' real rows, train/steps.py).

Examples (RAM-DSIR on the card; fundus target domain 3, prostate target 5
with the five other domains as sources, each evaluated every epoch):
  python -m ramdsir_tpu_torch.cli.train --dataset fundus --domain_idxs 0,1,2 \
      --test_domain_idx 3 --ram --rec --is_out_domain --consistency \
      --consistency_type kd --save_path runs/fundus_t3
  python -m ramdsir_tpu_torch.cli.train --dataset prostate --domain_idxs 0,1,2,3,4 \
      --test_domain_idx 5 --ram --rec --consistency --consistency_type kd \
      --save_path runs/prostate_t5
--compute_dtype bfloat16 runs the U-Net in bfloat16 (float32 master
weights, RAM in float32).  --resume runs/fundus_t3/final_model.ckpt goes on
from a full-state checkpoint of the port or of the JAX package.  The
variants: --norm gn|in, --num_classes 3 (prostate's softmax head), --remat,
--global_batch 48, --trace_dir runs/trace.  --model transunet_r50_b16 trains
TransUNet R50-ViT-B/16 in the U-Net's place (models/transunet.py), e.g. at
--image_size 512 as TransUNet's high-resolution setting.
"""
from __future__ import annotations

import argparse
import dataclasses

import torch

from ramdsir_tpu_torch.config import TrainConfig
from ramdsir_tpu_torch.models.transunet import CONFIGS as TRANSUNETS
from ramdsir_tpu_torch.parallel import distributed
from ramdsir_tpu_torch.train.loop import fit


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="DG Medical Segmentation Train (PyTorch)")
    p.add_argument("--data_root", type=str, default="../dataset")
    p.add_argument("--dataset", type=str, default="fundus", choices=["fundus", "prostate"])
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--test_batch_size", type=int, default=8)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--domain_idxs", type=str, default="0,1,2")
    p.add_argument("--test_domain_idx", type=int, default=3)
    p.add_argument("--in_channels", type=int, default=3)
    p.add_argument("--num_classes", type=int, default=None)
    p.add_argument("--seed", type=int, default=1337)
    p.add_argument("--lambda_rec", type=float, default=0.1)
    p.add_argument("--deterministic", action="store_true")
    p.add_argument("--ram", action="store_true")
    p.add_argument("--rec", action="store_true")
    p.add_argument("--is_out_domain", action="store_true")
    p.add_argument("--consistency", action="store_true")
    p.add_argument("--consistency_type", type=str, default="mse", choices=["mse", "kd"])
    p.add_argument("--save_path", type=str, required=True)
    p.add_argument("--norm", type=str, default="bn", choices=["bn", "gn", "in"],
                   help="the encoder's and seg decoder's norm (the restoration decoder keeps DSBN)")
    p.add_argument("--activation", type=str, default="relu")
    p.add_argument("--image_size", type=int, default=256)
    p.add_argument("--compute_dtype", type=str, default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--num_devices", type=int, default=None,
                   help="data-parallel ranks (default: every visible CUDA device; 1 on the CPU)")
    p.add_argument("--ram_use_pallas", action="store_true",
                   help="full-spectrum RAM with the per-step donor FFT (K1 full mode)")
    p.add_argument("--no_ram_banded_dft", action="store_true",
                   help="rfft2/irfft2 RAM instead of the banded restricted-DFT products")
    p.add_argument("--remat", action="store_true",
                   help="recompute the encoder + seg-decoder forward in the backward (less memory)")
    p.add_argument("--resume", type=str, default=None)
    p.add_argument("--max_steps", type=int, default=None, help="smoke-run cap")
    p.add_argument("--trace_dir", type=str, default=None,
                   help="write a torch.profiler Chrome trace here of the first whole window from step 2 "
                        "on (steps 2-12 at a step a window), graph replays included")
    p.add_argument("--scan_window", type=int, default=None,
                   help="steps a window with the device-resident data (default: the largest divisor "
                        "<= 256 of the steps up to the next eval); on a GPU a window replays a CUDA graph "
                        "of one step, on the CPU and under a process group it runs the steps eagerly; "
                        "1 launches each step on its own, as the host loaders do")
    p.add_argument("--global_batch", type=int, default=None,
                   help="split this batch evenly over the source domains in place of the per-target "
                        "tables; without --lr the LR scales by its ratio to the table's batch")
    p.add_argument("--device", type=str, default="cuda", help="torch device, e.g. cuda or cpu")
    p.add_argument("--model", type=str, default="unet", choices=["unet", *TRANSUNETS],
                   help="the step's network: RAM-DSIR's U-Net, or TransUNet R50-ViT-B/16 (float32, one process, "
                        "--image_size a multiple of 16; the restoration decoder stays RAM-DSIR's)")
    return p.parse_args(argv)


def main(argv=None):
    a = parse_args(argv)
    cfg = TrainConfig(
        data_root=a.data_root,
        dataset=a.dataset,
        batch_size=a.batch_size,
        test_batch_size=a.test_batch_size,
        lr=a.lr,
        epochs=a.epochs,
        domain_idxs=tuple(int(x) for x in a.domain_idxs.split(",")),
        test_domain_idx=a.test_domain_idx,
        in_channels=a.in_channels,
        num_classes=a.num_classes,
        seed=a.seed,
        lambda_rec=a.lambda_rec,
        deterministic=a.deterministic,
        ram=a.ram,
        rec=a.rec,
        is_out_domain=a.is_out_domain,
        consistency=a.consistency,
        consistency_type=a.consistency_type,
        save_path=a.save_path,
        norm=a.norm,
        activation=a.activation,
        image_size=a.image_size,
        compute_dtype=a.compute_dtype,
        num_devices=a.num_devices,
        ram_use_pallas=a.ram_use_pallas,
        ram_banded_dft=not a.no_ram_banded_dft,
        remat=a.remat,
        checkpoint_resume=a.resume,
        trace_dir=a.trace_dir,
        scan_window=a.scan_window,
        global_batch=a.global_batch,
        device=a.device,
        model=a.model,
    )
    if distributed.under_torchrun():
        return _torchrun_rank(cfg, a.max_steps)
    if cfg.num_devices is None:
        visible = torch.cuda.device_count() if torch.device(cfg.device).type == "cuda" else 1
        cfg = dataclasses.replace(cfg, num_devices=max(1, visible))
    summary = fit(cfg, max_steps=a.max_steps)
    print(summary)
    return summary


def _torchrun_rank(cfg: TrainConfig, max_steps):
    """This process as one rank of a torchrun launch."""
    cpu = torch.device(cfg.device).type == "cpu"
    device = distributed.initialize(device="cpu" if cpu else None)
    rank = distributed.rank()
    try:
        cfg = dataclasses.replace(cfg, device=str(device), num_devices=distributed.world())
        summary = fit(cfg, max_steps=max_steps)
    finally:
        torch.distributed.destroy_process_group()
    if rank == 0:
        print(summary)
    return summary


if __name__ == "__main__":
    main()
