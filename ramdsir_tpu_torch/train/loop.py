"""The training loop (PyTorch port of `ramdsir_tpu/train/loop.py:158-478`,
fundus and prostate, one device, one step per dispatch).

Every `eval_every` epochs and at the end, `fit` evaluates on the target
domain (running statistics): the fundus test split (`eval_fundus`) or the
prostate volumes (`eval_prostate_volumes`).  It appends the row to
`{test_domain_idx}_val_log.csv`, logs `eval/avg_dice` and keeps the best
checkpoint `model_<dice>.pth` (`train.checkpoint.BestKeeper`).  Eval draws
no random number and launches no RAM kernel.

At the end it writes `final_model.pth` (the reference's weights) and
`final_model.ckpt` (the full state in the JAX package's format).
`cfg.checkpoint_resume` (--resume) loads such a `.ckpt`, from the port or
the JAX package, and the run goes on from its step: `max_steps` counts
global steps, the poly LR continues, and the epoch plan and the draws start
afresh from the seed, as in the JAX package.  The run stops when the step
reaches the schedule's total_iters; the JAX package's loop would run
`epochs` more epochs and take the LR past zero, to NaN (ROADMAP.md §3).

`cfg.deterministic` (--deterministic) runs the whole of `fit` under
`deterministic_mode`: on the card two runs from one seed then give the same
parameters, statistics, Adam moments and losses bit for bit.

`cfg.trace_dir` (--trace_dir) profiles steps 2-12 (`utils.profiler.TraceWindow`)
into a Chrome trace there.  `cfg.scan_window` is recorded and changes
nothing: in the JAX package it groups steps into one dispatch with the
numerics of single steps; here each step is launched on its own.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch

import ramdsir_tpu_torch
from ramdsir_tpu_torch.config import TrainConfig
from ramdsir_tpu_torch.data.device_pipeline import DeviceFundusPipeline, DeviceProstatePipeline
from ramdsir_tpu_torch.data.fundus import FundusMultiDataset
from ramdsir_tpu_torch.data.prostate import ProstateMultiDataset
from ramdsir_tpu_torch.train.checkpoint import BestKeeper, load_checkpoint, save_checkpoint
from ramdsir_tpu_torch.train.evaluate import append_csv_log, eval_fundus, eval_prostate_volumes
from ramdsir_tpu_torch.train.state import init_state
from ramdsir_tpu_torch.train.steps import check_supported, make_predict_fn, make_train_step
from ramdsir_tpu_torch.utils.device import resolve_device
from ramdsir_tpu_torch.utils.logging import MetricsWriter
from ramdsir_tpu_torch.utils.profiler import StepTimer, TraceWindow
from ramdsir_tpu_torch.utils.torch_compat import export_torch_checkpoint


def tf32_settings() -> Dict[str, bool]:
    """Whether float32 convolutions (cuDNN) and matrix products may use TF32."""
    return {
        "cudnn_allow_tf32": bool(torch.backends.cudnn.allow_tf32),
        "matmul_allow_tf32": bool(torch.backends.cuda.matmul.allow_tf32),
    }


def save_run_config(save_dir: str, cfg: TrainConfig) -> None:
    """The resolved config, the package version and the TF32 settings."""
    os.makedirs(save_dir, exist_ok=True)
    with open(os.path.join(save_dir, "run_config.json"), "w") as f:
        json.dump(
            {
                "version": ramdsir_tpu_torch.__version__,
                "torch": torch.__version__,
                "tf32": tf32_settings(),
                "config": dataclasses.asdict(cfg),
            },
            f, indent=2, default=str,
        )


CUBLAS_WORKSPACE_CONFIG = ":4096:8"  # a deterministic cuBLAS workspace, as torch requires


@contextlib.contextmanager
def deterministic_mode(on: bool):
    """Bit-repeatable device steps for the duration (--deterministic, as
    the reference's train.py:608-614 and more): cuDNN deterministic and
    not benchmarking, `torch.use_deterministic_algorithms(True)` (so the
    upsample's backward is kernel K2, `models/unet.upsample2x`, and any op
    with only an atomics path raises instead of running), and, unless the
    environment sets it, CUBLAS_WORKSPACE_CONFIG, without which torch
    refuses cuBLAS products in this mode.  Every setting is restored on
    exit, so runs in one process do not inherit each other's mode."""
    if not on:
        yield
        return
    cudnn = torch.backends.cudnn
    saved = (torch.are_deterministic_algorithms_enabled(), torch.is_deterministic_algorithms_warn_only_enabled(),
             cudnn.benchmark, cudnn.deterministic, os.environ.get("CUBLAS_WORKSPACE_CONFIG"))
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE_CONFIG)
    cudnn.benchmark, cudnn.deterministic = False, True
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(saved[0], warn_only=saved[1])
        cudnn.benchmark, cudnn.deterministic = saved[2], saved[3]
        if saved[4] is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)


Pipeline = Union[DeviceFundusPipeline, DeviceProstatePipeline]


def build_train_pipeline(cfg: TrainConfig, data_root: str) -> Pipeline:
    """The fundus PNG tree or the prostate slice tree under data_root, on
    cfg.device."""
    kw = dict(
        is_out_domain=cfg.is_out_domain, seed=cfg.seed,
        precompute_donor_amp=cfg.ram_precompute_donor_amp and cfg.ram, device=cfg.device,
    )
    bsl = cfg.batch_size_list[: len(cfg.domain_idxs)]
    if cfg.dataset == "prostate":
        datasets = [ProstateMultiDataset(data_root, [d]) for d in cfg.domain_idxs]
        return DeviceProstatePipeline.from_tree(datasets, bsl, data_root, cfg.test_domain_idx, **kw)
    datasets = [FundusMultiDataset(data_root, [d]) for d in cfg.domain_idxs]
    return DeviceFundusPipeline.from_tree(datasets, bsl, data_root, cfg.image_size, cfg.test_domain_idx, **kw)


def evaluate_target(cfg: TrainConfig, predict, testset, epoch: int, save_dir: str):
    """One in-training eval on the target domain: appends the CSV row and
    returns (avg Dice in percent, summary fields)."""
    data = cfg.data_root if testset is None else testset
    log = os.path.join(save_dir, f"{cfg.test_domain_idx}_val_log.csv")
    if cfg.dataset == "prostate":
        res = eval_prostate_volumes(predict, data, cfg.test_domain_idx, batch_size=cfg.test_batch_size)
        append_csv_log(log, ["batch-size: ", cfg.test_batch_size, epoch, "dice coefficence: ", res.dice])
        return res.dice_pct, dict(dice=res.dice, eval_timing=res.timing)
    res = eval_fundus(predict, data, cfg.test_domain_idx, batch_size=cfg.test_batch_size, image_size=cfg.image_size)
    append_csv_log(log, ["batch-size: ", cfg.test_batch_size, epoch,
                         "cup dice coefficence: ", res.cup_dice,
                         "disc dice coefficence: ", res.disc_dice])
    return res.avg_dice_pct, dict(cup_dice=res.cup_dice, disc_dice=res.disc_dice, eval_timing=res.timing)


def fit(
    cfg: TrainConfig,
    eval_every: int = 1,
    max_steps: Optional[int] = None,
    pipeline: Optional[Pipeline] = None,
    testset: Optional[Sequence] = None,
) -> Dict:
    """Train on cfg.device; returns a summary dict.  `pipeline` and
    `testset` replace the train set and the test data read from
    cfg.data_root (in-memory sets, for smoke runs): fundus test samples, or
    prostate (name, image, mask) volumes."""
    cfg = cfg.resolve()
    check_supported(cfg)
    if not cfg.device_data:
        raise NotImplementedError("device_data=False is not ported yet (ROADMAP.md: host loaders)")
    device = resolve_device(cfg.device)
    with deterministic_mode(cfg.deterministic):
        if cfg.deterministic:
            np.random.seed(cfg.seed)  # reference train.py:608-614
        return _fit(cfg, device, eval_every, max_steps, pipeline, testset)


def _fit(cfg: TrainConfig, device, eval_every, max_steps, pipeline, testset) -> Dict:
    save_dir = cfg.save_path
    save_run_config(save_dir, cfg)
    if pipeline is None:
        pipeline = build_train_pipeline(cfg, os.path.join(cfg.data_root, cfg.dataset))
    steps_per_epoch = len(pipeline)
    total_iters = steps_per_epoch * cfg.epochs
    b_real = sum(pipeline.batch_sizes)

    generator = torch.Generator().manual_seed(cfg.seed)
    state = init_state(cfg, generator, device)
    if cfg.checkpoint_resume:
        load_checkpoint(cfg.checkpoint_resume, state)
        print(f"resumed from {cfg.checkpoint_resume} at step {state.step}", flush=True)
    train_step = make_train_step(
        cfg, total_iters, batch_size_list=pipeline.batch_sizes, device_data=pipeline.device_data
    )
    predict = make_predict_fn(cfg, state.models, bn_adapt=False)
    writer = MetricsWriter(os.path.join(save_dir, "log"))
    keeper = BestKeeper(save_dir)
    timer = StepTimer(device=device)
    tracer = TraceWindow(cfg.trace_dir, device) if cfg.trace_dir else None
    summary: Dict = {}

    step = state.step
    done = max_steps is not None and step >= max_steps
    epoch = 0
    while epoch < cfg.epochs and step < total_iters and not done:
        t_ep = time.time()
        for row in pipeline:
            if tracer:
                tracer.before_step(step)
            metrics = train_step(state, row, generator)
            lr = float(metrics.pop("lr"))
            names = list(metrics)
            values = torch.stack([metrics[k] for k in names]).tolist()  # one device sync
            if tracer:
                tracer.after_step(step)
            timer.tick(b_real)
            if step % cfg.log_interval == 0:
                writer.add_scalars(dict(zip(names, values)), step, prefix="loss/")
                writer.add_scalars({"lr": lr}, step)
            step += 1
            if max_steps is not None and step >= max_steps:
                done = True
                break
            if step >= total_iters:  # a resumed run ends with the schedule
                break
        if (epoch + 1) % eval_every == 0 or done:
            timer.mark()
            writer.flush()
            with timer.paused():
                avg, fields = evaluate_target(cfg, predict, testset, epoch, save_dir)
                summary.update(fields)
                writer.add_scalars({"eval/avg_dice": avg}, step)
                keeper.update(avg, state.models)
            print(
                f"epoch {epoch}: eval avg dice {avg:.2f} | best {keeper.best:.2f} | "
                f"{timer.items_per_sec:.1f} img/s | epoch {time.time() - t_ep:.1f}s",
                flush=True,
            )
        epoch += 1

    timer.mark()
    if tracer:
        tracer.close()  # a run that ended before the window's last step
        summary["trace"] = tracer.path
    final_path = os.path.join(save_dir, "final_model.pth")
    export_torch_checkpoint(final_path, state.models)
    resume_path = os.path.join(save_dir, "final_model.ckpt")
    save_checkpoint(resume_path, state, meta={"steps": step})
    writer.close()
    summary.update(
        best=keeper.best, best_checkpoint=keeper.best_path, steps=step,
        images_per_sec=timer.items_per_sec, median_step_ms=timer.median_step_ms,
        final_checkpoint=final_path, resume_checkpoint=resume_path,
    )
    return summary
