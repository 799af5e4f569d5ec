"""The training loop (PyTorch port of `ramdsir_tpu/train/loop.py:158-478`),
fundus and prostate.

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

Input paths: the device pipeline (`cfg.device_data`, the default) holds the
train set on the card and gathers each batch there.  `device_data=False`
trains from the host loaders (`data/loaders.py`, `cfg.loader` "process" or
"thread", `cfg.num_workers`, `cfg.prefetch`), which build each step's batch
on the host, and `HostToDevice` copies it to the card `max(2, prefetch)`
steps ahead; `fit` stops the loader's workers when it ends, however it
ends.  The host path writes an "input/" row to metrics.jsonl at each
epoch's end (medians of the host's wait for the loader and of the copy's
device time, the epoch's median step, the memory high-water marks), and
the summary's `host_input`.

Every `cfg.log_images_every` steps (and at step 0; with windows, at the
last step of a window that holds such a step) the step returns its viz
slices; `utils.logging.DeviceVizRing` copies them off the card without
a synchronise, and at the next eval boundary and at the end `_log_viz`
writes the reference's image grids as PNGs under log/images/.

Data parallelism (`cfg.num_devices` > 1, `ramdsir_tpu/train/loop.py:174-229`):
`fit` launches that many ranks (`parallel.distributed.launch`: NCCL on
cuda:0..N-1, or gloo ranks with device "cpu") and returns rank 0's summary;
a process that is already a rank (a torchrun launch, or a launched `fn`)
trains as one.  Every rank builds the same epoch plan and draws from the
same seed; with the device pipeline it holds the whole train set and
gathers its rows of each step, with the host loaders it builds its
`local_batch_slice` of the rows.  The state is broadcast from rank 0 after
init or --resume (every rank loads the same `.ckpt`).  Rank 0 writes
metrics.jsonl, the image grids, run_config.json, the keep-best file and the
final checkpoints, and runs the in-training eval (running statistics, no
collective) while the others wait at a barrier.  The summary's img/s is the
global batch's.

`cfg.trace_dir` (--trace_dir) profiles the run as it trains, windows and
graph replays included: the first whole window from step 2 on, after the
capture (steps 2-12 at W = 1; `utils.profiler.TraceWindow`), into a Chrome
trace there (under a group, rank 0's).  The port's spans
(`utils.profiler.span`, `ramdsir.<layer>.<what>`) name the phases in it.

Scan windows (`cfg.scan_window`, --scan_window; `ramdsir_tpu/train/loop.py:230-355`):
with the device pipeline the run goes in segments, the epochs up to the
next eval, their plans concatenated, and each segment in windows of W
steps (`scan_window_size`: the flag, or the largest divisor <= 256 of the
segment's steps), each window min(W, left in the segment, left in the
run) steps through the window step (`train.steps.ScanTrainSteps`).  On a
card outside a process group a window is replays of a CUDA graph of one
step, captured after the run's first two steps; on the CPU and under a
group its steps run eagerly.  W = 1 (--scan_window 1, and the host
loaders, which train a step at a time) launches each step on its own.
No step waits for the device: the steps' metrics go to
`utils.logging.DeviceMetricsRing` (one window's (w,) tables at a time, read
back when it fills, at each eval and at the end; a logged lr is float32),
the image grid of a window that holds a log step is its last step's,
written at that step, and `utils.profiler.StepTimer` times the windows
between CUDA events.  The summary names W (`scan_window`) and the graph's
replays, capture seconds and pool bytes.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import resource
import statistics
import time
from collections import deque
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

import ramdsir_tpu_torch
from ramdsir_tpu_torch.config import TrainConfig
from ramdsir_tpu_torch.data.device_pipeline import DeviceFundusPipeline, DeviceProstatePipeline
from ramdsir_tpu_torch.data.fundus import FundusMultiDataset
from ramdsir_tpu_torch.data.loaders import FusedMultiDomainLoader, ProcessFusedMultiDomainLoader
from ramdsir_tpu_torch.data.prostate import ProstateMultiDataset
from ramdsir_tpu_torch.data.transforms import ScaleCropAug
from ramdsir_tpu_torch.models.transunet import counters as transunet_counters
from ramdsir_tpu_torch.parallel import distributed
from ramdsir_tpu_torch.parallel.mesh import replicate_state
from ramdsir_tpu_torch.train.checkpoint import BestKeeper, load_checkpoint, save_checkpoint
from ramdsir_tpu_torch.train.evaluate import append_csv_log, eval_fundus, eval_prostate_volumes
from ramdsir_tpu_torch.train.state import init_state
from ramdsir_tpu_torch.train.steps import check_supported, make_predict_fn, make_train_step
from ramdsir_tpu_torch.utils.device import resolve_device
from ramdsir_tpu_torch.utils.logging import DeviceMetricsRing, DeviceVizRing, MetricsWriter, decode_seg_map, make_grid
from ramdsir_tpu_torch.utils.profiler import StepTimer, TraceWindow, span
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
    not benchmarking, `torch.use_deterministic_algorithms(True)` (so every x2
    upsample on the card is kernels K3 and K2, eval's channels-last ones
    too, `models/unet.upsample2x`, and any op with only an atomics path
    raises instead of running), and, unless the
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


Pipeline = Union[DeviceFundusPipeline, DeviceProstatePipeline, FusedMultiDomainLoader]


def build_train_pipeline(cfg: TrainConfig, data_root: str, rows: Optional[slice] = None) -> Pipeline:
    """The fundus PNG tree or the prostate slice tree under data_root: on
    cfg.device (the device pipeline), or with cfg.device_data=False behind
    the host loaders (`ramdsir_tpu/train/loop.py:34-107`): one dataset per
    source domain, fundus through the decode cache at image_size and the
    training scale-crop, each sample's draws seeded by its position, and
    `rows` (a data-parallel rank's) the rows of each batch they build."""
    bsl = cfg.batch_size_list[: len(cfg.domain_idxs)]
    if cfg.device_data:
        kw = dict(
            is_out_domain=cfg.is_out_domain, seed=cfg.seed,
            precompute_donor_amp=cfg.ram_precompute_donor_amp and cfg.ram, device=cfg.device,
        )
        if cfg.dataset == "prostate":
            datasets = [ProstateMultiDataset(data_root, [d]) for d in cfg.domain_idxs]
            return DeviceProstatePipeline.from_tree(datasets, bsl, data_root, cfg.test_domain_idx, **kw)
        datasets = [FundusMultiDataset(data_root, [d]) for d in cfg.domain_idxs]
        return DeviceFundusPipeline.from_tree(datasets, bsl, data_root, cfg.image_size, cfg.test_domain_idx, **kw)
    common = dict(is_freq=cfg.ram, is_out_domain=cfg.is_out_domain, test_domain_idx=cfg.test_domain_idx)
    if cfg.dataset == "prostate":
        datasets = [
            ProstateMultiDataset(data_root, [d], rng=np.random.default_rng(cfg.seed + i), **common)
            for i, d in enumerate(cfg.domain_idxs)
        ]
    else:
        datasets = [
            FundusMultiDataset(
                data_root, [d], np_transform=ScaleCropAug(cfg.image_size), donor_size=cfg.image_size,
                rng=np.random.default_rng(cfg.seed + i), resize_to=cfg.image_size, **common,
            )
            for i, d in enumerate(cfg.domain_idxs)
        ]
    keys = ("img", "donor", "mask") if cfg.ram else ("img", "mask")
    if cfg.loader == "process":
        return ProcessFusedMultiDomainLoader(
            datasets, bsl, keys, seed=cfg.seed, num_workers=cfg.num_workers, rows=rows
        )
    if cfg.loader != "thread":
        raise ValueError(f"unknown loader {cfg.loader!r} (use 'process' or 'thread')")
    return FusedMultiDomainLoader(
        datasets, bsl, keys, seed=cfg.seed, prefetch=cfg.prefetch + 2, num_workers=cfg.num_workers or 6, rows=rows
    )


class HostToDevice:
    """One epoch of host batches as tensors on `device`, copied `depth`
    steps ahead (the JAX package's `_device_stream`,
    `ramdsir_tpu/train/loop.py:134-155`).

    On a CUDA device each batch is copied into pinned host memory and from
    there by non_blocking copies on a side stream, so the copy overlaps the
    steps before it; the compute stream waits on the copy's event before
    the step that reads the batch, and the pinned batch stays referenced
    until that step has been queued.  Per batch it records the host's wait
    for the loader (`wait_ms`, the span `ramdsir.input.wait`) and the copy's
    device time (`h2d_ms()`, read once the copies are done; the host's part,
    pinning and queueing, is the span `ramdsir.input.copy`).  On the CPU the
    arrays are wrapped as they are."""

    def __init__(self, batches: Iterable[Dict[str, np.ndarray]], device: torch.device, depth: int):
        self.batches = batches
        self.device = torch.device(device)
        self.depth = max(1, depth)
        self.wait_ms: List[float] = []
        self._events: List[tuple] = []

    def h2d_ms(self) -> List[float]:
        out = []
        for start, end in self._events:
            end.synchronize()
            out.append(start.elapsed_time(end))
        return out

    def _next(self, it) -> Optional[Dict[str, np.ndarray]]:
        """The loader's next batch (None at the epoch's end), timed."""
        timing: Dict[str, float] = {}
        with span("ramdsir.input.wait", timing, "wait"):
            batch = next(it, None)
        if batch is not None:
            self.wait_ms.append(1e3 * timing["wait"])
        return batch

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        it = iter(self.batches)
        if self.device.type != "cuda":
            while (batch := self._next(it)) is not None:
                yield {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}
            return
        compute, side = torch.cuda.current_stream(self.device), torch.cuda.Stream(self.device)
        pending: deque = deque()
        exhausted = False
        while True:
            while not exhausted and len(pending) < self.depth:
                batch = self._next(it)
                if batch is None:
                    exhausted = True
                    break
                with span("ramdsir.input.copy"):
                    pinned = {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory() for k, v in batch.items()}
                    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                    with torch.cuda.stream(side):
                        start.record(side)
                        dev = {k: v.to(self.device, non_blocking=True) for k, v in pinned.items()}
                        end.record(side)
                self._events.append((start, end))
                pending.append((pinned, dev, end))
            if not pending:
                return
            # `current` holds the pinned batch until the generator resumes,
            # that is until the step that reads it has been queued
            current = pending.popleft()
            compute.wait_event(current[2])
            for v in current[1].values():
                v.record_stream(compute)  # the allocator keeps them until the step is done
            yield current[1]


def _log_viz(writer: MetricsWriter, viz: Dict[str, np.ndarray], step: int, cfg: TrainConfig) -> None:
    """The reference's image grids under its tags (code/train.py:306-329),
    as the JAX package's `_log_viz` makes them
    (`ramdsir_tpu/train/loop.py:110-131`)."""
    img = np.asarray(viz["image"])
    writer.add_image("train/Image", make_grid(img[..., :3]), step)
    if "image_freq" in viz:
        writer.add_image("train/Image_Freq", make_grid(np.asarray(viz["image_freq"])[..., :3]), step)
    if "image_rec" in viz:
        writer.add_image("train/Image_Rec", make_grid(np.asarray(viz["image_rec"])[..., :3]), step)
    pred = np.asarray(viz["pred"])
    mask = np.asarray(viz["mask"])
    if cfg.dataset == "fundus":
        writer.add_image("train/Soft_Predicted_OC", make_grid(pred[..., 0]), step)
        writer.add_image("train/Soft_Predicted_OD", make_grid(pred[..., 1]), step)
        writer.add_image("train/GT_OC", make_grid(mask[..., 0], normalize=False), step)
        writer.add_image("train/GT_OD", make_grid(mask[..., 1], normalize=False), step)
    else:
        pred_lbl = np.stack([decode_seg_map(p) for p in pred.argmax(-1)])
        gt_lbl = np.stack([decode_seg_map(m) for m in mask])
        writer.add_image("train/Predicted", make_grid(pred_lbl, normalize=False), step)
        writer.add_image("train/GT", make_grid(gt_lbl, normalize=False), step)


def _input_row(stream: HostToDevice, step_seconds: Sequence[float], batch: int, device: torch.device) -> Dict:
    """One epoch of the host path: the host's median wait for the loader,
    the epoch's median step and img/s (steps after the timer's warm-up),
    the training process's peak RSS so far and, on a card, the copies'
    median device time a step and the peak device memory so far."""
    med = lambda xs: statistics.median(xs) if xs else 0.0
    row = {
        "host_wait_ms": med(stream.wait_ms),
        "median_step_ms": 1e3 * med(step_seconds),
        "images_per_sec": batch * len(step_seconds) / sum(step_seconds) if step_seconds else 0.0,
        "host_peak_rss_bytes": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024,
    }
    if device.type == "cuda":
        row.update(h2d_ms=med(stream.h2d_ms()), device_peak_bytes=torch.cuda.max_memory_allocated(device))
    return row


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


class _NoWriter:
    """The metrics writer of a rank other than 0: rank 0 writes the logs."""

    def add_scalars(self, *args, **kwargs) -> None:
        pass

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


def _fit_rank(rank: int, device: torch.device, cfg: TrainConfig, eval_every: int, max_steps: Optional[int]) -> Dict:
    """One launched rank of `fit`."""
    return fit(dataclasses.replace(cfg, device=str(device)), eval_every=eval_every, max_steps=max_steps)


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
    prostate (name, image, mask) volumes.  cfg.num_devices > 1 outside a
    process group launches that many ranks and returns rank 0's summary
    (the module docstring); in-memory sets cannot be sent to them, so a
    caller with those launches its own ranks and calls `fit` in each."""
    cfg = cfg.resolve()
    check_supported(cfg)
    if (cfg.num_devices or 1) > 1 and not distributed.in_group():
        if pipeline is not None or testset is not None:
            raise ValueError("fit launches its own ranks for num_devices > 1 and cannot send them in-memory sets")
        n = cfg.num_devices  # NCCL on cuda:0..n-1, or n gloo ranks on the CPU
        devices = [f"cuda:{r}" for r in range(n)] if torch.device(cfg.device).type == "cuda" else [cfg.device] * n
        return distributed.launch(_fit_rank, n, devices=devices, args=(cfg, eval_every, max_steps))[0]
    device = resolve_device(cfg.device)
    with deterministic_mode(cfg.deterministic):
        if cfg.deterministic:
            np.random.seed(cfg.seed)  # reference train.py:608-614
        return _fit(cfg, device, eval_every, max_steps, pipeline, testset)


def _fit(cfg: TrainConfig, device, eval_every, max_steps, pipeline, testset) -> Dict:
    save_dir = cfg.save_path
    if distributed.rank() == 0:
        save_run_config(save_dir, cfg)
    if pipeline is None:
        rows = None
        if distributed.in_group() and not cfg.device_data:  # the host loaders build this rank's rows
            rows = distributed.local_batch_slice(sum(cfg.batch_size_list[: len(cfg.domain_idxs)]))
        pipeline = build_train_pipeline(cfg, os.path.join(cfg.data_root, cfg.dataset), rows)
    try:
        return _train(cfg, device, eval_every, max_steps, pipeline, testset, save_dir)
    finally:
        getattr(pipeline, "shutdown", lambda: None)()  # the process loader's workers


SCAN_WINDOW_CAP = 256  # the largest automatic window (`ramdsir_tpu/train/loop.py:252`)


def scan_window_size(
    cfg: TrainConfig, steps_per_epoch: int, eval_every: int, max_steps: Optional[int], device_data: bool
) -> Tuple[int, int]:
    """(W, segment epochs): the JAX package's choice of the scan window
    (`ramdsir_tpu/train/loop.py:235-258`).  A segment is the epochs up to
    the next eval, min(eval_every, epochs).  --scan_window sets W; by
    default W is the largest divisor <= 256 of the segment's steps (of
    max_steps where that is fewer), or min(those steps, 256) where none is.
    W = 1 and one-epoch segments with the host loaders (device_data False),
    which train a step at a time; --trace_dir changes nothing: its trace
    shows the windows the run trains."""
    if not device_data:
        return 1, 1
    seg_epochs = max(1, min(eval_every, cfg.epochs))
    if cfg.scan_window:
        return max(1, cfg.scan_window), seg_epochs
    effective = steps_per_epoch * seg_epochs
    if max_steps is not None:
        effective = min(effective, max_steps)
    divisors = [d for d in range(2, SCAN_WINDOW_CAP + 1) if effective % d == 0]
    return max(1, max(divisors) if divisors else min(effective, SCAN_WINDOW_CAP)), seg_epochs


def _train(cfg: TrainConfig, device, eval_every, max_steps, pipeline, testset, save_dir) -> Dict:
    device_data = getattr(pipeline, "device_data", None)  # None: the host loaders
    steps_per_epoch = len(pipeline)
    total_iters = steps_per_epoch * cfg.epochs
    b_real = sum(pipeline.batch_sizes)

    is_main = distributed.rank() == 0  # writes the logs and checkpoints, evaluates
    grouped = distributed.in_group()
    generator = torch.Generator().manual_seed(cfg.seed)
    state = init_state(cfg, generator, device)
    if cfg.checkpoint_resume:
        load_checkpoint(cfg.checkpoint_resume, state)
        if is_main:
            print(f"resumed from {cfg.checkpoint_resume} at step {state.step}", flush=True)
    replicate_state(state)  # rank 0's state on every rank; nothing without a group
    scan_w, seg_epochs = scan_window_size(cfg, steps_per_epoch, eval_every, max_steps, device_data is not None)
    train_step = make_train_step(cfg, total_iters, batch_size_list=pipeline.batch_sizes, device_data=device_data,
                                 scan=device_data is not None, window=scan_w)
    predict = make_predict_fn(cfg, state.models, bn_adapt=False)
    writer = MetricsWriter(os.path.join(save_dir, "log")) if is_main else _NoWriter()
    ring = DeviceMetricsRing(writer, log_interval=cfg.log_interval)
    keeper = BestKeeper(save_dir) if is_main else None
    timer = StepTimer(device=device)
    tracer = TraceWindow(cfg.trace_dir, device) if cfg.trace_dir and is_main else None
    vizring = DeviceVizRing()
    log_viz = lambda viz, s: _log_viz(writer, viz, s, cfg)
    logs_images = lambda first, n: bool(cfg.log_images_every) and any(
        (first + i) % cfg.log_images_every == 0 for i in range(n))
    host_rows: List[Dict] = []
    summary: Dict = {}

    step = state.step
    done = max_steps is not None and step >= max_steps

    def left() -> int:
        """Steps the run may still take."""
        return min(total_iters, max_steps if max_steps is not None else total_iters) - step

    def run_scan_segment(plan: Dict[str, np.ndarray]) -> None:
        """The segment's windows (`ramdsir_tpu/train/loop.py:294-355`):
        min(W, left in the segment, left in the run) steps each, their
        metrics into the ring, and the grid of a window that holds a log
        step written at its last step."""
        nonlocal step
        pos, seg_len = 0, len(plan["img_idx"])
        while pos < seg_len and left() > 0:
            w = min(scan_w, seg_len - pos, left())
            want_viz = logs_images(step, w)
            if tracer:
                tracer.before_window(step, w, step + left())
            metrics, viz = train_step(state, {k: v[pos : pos + w] for k, v in plan.items()}, generator,
                                      viz=want_viz, timer=timer)
            if is_main:
                ring.append(step, metrics)
                if want_viz:
                    vizring.append(step + w - 1, viz)  # viz assembled on every rank (a collective)
            step += w
            pos += w
            if tracer:
                tracer.after_window(step)

    def run_host_epoch(stream: HostToDevice) -> None:
        """One epoch of host batches, a step each."""
        nonlocal step
        for batch in stream:
            if tracer:
                tracer.before_window(step, 1, step + left())
            log_images = logs_images(step, 1)
            metrics = train_step(state, batch, generator, viz=log_images)
            if log_images:
                viz = metrics.pop("_viz")  # assembled on every rank (a collective), kept by rank 0
                if is_main:
                    vizring.append(step, viz)
            timer.tick(b_real)
            if is_main and step % cfg.log_interval == 0:
                ring.append(step, metrics)
            step += 1
            if tracer:
                tracer.after_window(step)
            if left() <= 0:
                return

    epoch = 0
    while epoch < cfg.epochs and left() > 0 and not done:
        t_ep = time.time()
        if device_data is not None:
            n_ep = min(seg_epochs, cfg.epochs - epoch)
            plans = [pipeline.epoch_plan() for _ in range(n_ep)]
            run_scan_segment({k: np.concatenate([p[k] for p in plans]) for k in plans[0]})
            epoch += n_ep - 1  # the segment's last epoch, which the eval row names
        else:
            stream = HostToDevice(pipeline, device, max(2, cfg.prefetch))
            first_timed = timer.timed_steps
            run_host_epoch(stream)
            host_rows.append(_input_row(stream, timer.step_seconds[first_timed:], b_real, device))
            writer.add_scalars({"epoch": epoch, **host_rows[-1]}, step, prefix="input/")
        done = max_steps is not None and step >= max_steps
        at_eval = (epoch + 1) % eval_every == 0 or done
        if at_eval and is_main:
            timer.mark()
            ring.flush()  # the steps' rows reach the log before the eval row
            writer.flush()
            with timer.paused():
                vizring.flush(log_viz)
                avg, fields = evaluate_target(cfg, predict, testset, epoch, save_dir)
                summary.update(fields)
                writer.add_scalars({"eval/avg_dice": avg}, step)
                keeper.update(avg, state.models)
            print(
                f"epoch {epoch}: eval avg dice {avg:.2f} | best {keeper.best:.2f} | "
                f"{timer.items_per_sec:.1f} img/s | epoch {time.time() - t_ep:.1f}s",
                flush=True,
            )
        if at_eval and grouped:
            with timer.paused():
                torch.distributed.barrier()  # the others wait for rank 0's eval
        epoch += 1

    timer.mark()
    windows = dict(scan_window=scan_w, graph_replays=getattr(train_step, "replays", 0),
                   capture_s=getattr(train_step, "capture_seconds", None),
                   graph_pool_bytes=getattr(train_step, "graph_pool_bytes", None))
    if cfg.model != "unet":
        windows.update(transunet_counters(state.models["encoder"]))
    if not is_main:
        torch.distributed.barrier()  # rank 0 has written the run's files
        return dict(steps=step, rank=distributed.rank(), images_per_sec=timer.items_per_sec,
                    median_step_ms=timer.median_step_ms, **windows)
    ring.flush()
    vizring.flush(log_viz)
    if tracer:
        tracer.close()  # a run that ended before the window's last step
        summary["trace"] = tracer.path
    final_path = os.path.join(save_dir, "final_model.pth")
    export_torch_checkpoint(final_path, state.models)
    resume_path = os.path.join(save_dir, "final_model.ckpt")
    save_checkpoint(resume_path, state, meta={"steps": step})
    writer.close()
    if grouped:
        torch.distributed.barrier()
    summary.update(
        best=keeper.best, best_checkpoint=keeper.best_path, steps=step,
        images_per_sec=timer.items_per_sec, median_step_ms=timer.median_step_ms,
        final_checkpoint=final_path, resume_checkpoint=resume_path, **windows,
    )
    if host_rows:
        summary["host_input"] = dict(
            loader=cfg.loader, epochs=len(host_rows),
            **{k: statistics.median(r[k] for r in host_rows) for k in ("host_wait_ms", "h2d_ms") if k in host_rows[0]},
        )
    return summary
