"""The train step and the predictor (PyTorch port of
`ramdsir_tpu/train/steps.py:50-436` and `:509-553`), fundus and prostate.

One call covers the reference's hot-loop iteration (code/train.py:223-331
fundus, :393-498 prostate): RAM on the clean batch, one encoder +
seg-decoder forward over the concatenation [clean; RAM] with per-half BN
statistics, the supervised losses on both halves, 0.5 x KD consistency, the
restoration decoder with domain-specific BN over the whole RAM bottleneck,
and Adam with the poly LR (encoder at lr x 0.5 under --rec).

Heads: fundus has two sigmoid channels (BCE + dice).  Prostate's 2-class
softmax head is computed from the logit difference l = logits[:, 1] -
logits[:, 0], flattened to (B, H*W): cross-entropy over two classes is BCE
on l, the class-1 dice is the dice of sigmoid(l), and the KD / MSE
consistency has its binary form (ops/losses.py), as in the JAX package.
With --num_classes C other than 2 prostate has the generic head: softmax over the
classes, cross-entropy and the per-class dice without class 0, and the
consistency on the (B, H, W, C) probabilities (`ramdsir_tpu/train/steps.py:132-148`).

Variants (`ramdsir_tpu/train/steps.py:204-366`):
  --norm gn|in   GroupNorm and InstanceNorm are per sample, so the one
                 forward over the flat [clean; RAM] batch needs no per-half
                 statistics (the JAX package vmaps over the two halves to
                 the same effect); the restoration decoder stays DSBN.
  fused_dual, fused_dsbn
                 accepted and recorded; the step runs the one fused path.
                 In the JAX package they choose a TPU layout with the same
                 numerics: one forward over [clean; RAM] in place of two
                 (`ramdsir_tpu/train/steps.py:214-224`), one segment-DSBN
                 restoration pass in place of the per-domain loop (`:316-319`).
  --remat        the encoder + seg-decoder forward runs under
                 torch.utils.checkpoint and is recomputed in the backward;
                 the recompute leaves the running statistics as they are
                 (`models/norm.recomputing`), as `jax.checkpoint`, which
                 has no side effect, does.  It draws no random number: the
                 step's draws come before it.

Randomness: every draw of a step (the RAM ratios and, with the fundus device
pipeline, the scale-crop's apply/factor/offset draws) comes from
`sample_step_draws`, in one place, from one Generator; a caller may pass the
draws instead (the tests pass the numbers the JAX functions drew).

Models (`TrainConfig.model`): the U-Net, or a TransUNet
(`models/transunet.py`) in the encoder and seg-decoder slots, the rest of
the step unchanged.  A TransUNet's dropout takes a seed a row, drawn last
among the step's draws (`dropout_seed`, so the U-Net's draws are as they
were) and loaded through `StepInputs` as the others are; the masks are
hashed from it on the device, so a graph replay drops what an eager step
would.  Under --remat it checkpoints its own transformer blocks and
bottleneck units in place of the whole forward.  `check_supported` says
what it does not run.

Data parallelism (`--num_devices` > 1; `ramdsir_tpu/train/steps.py:69-94`,
`ramdsir_tpu/parallel/mesh.py`): under a process group (`parallel/`) each
rank holds per = ceil(B / world) rows of the global batch of B real rows,
zero-padded at its end to world x per (pad_to_multiple, as JAX's), and
clip(B - rank * per, 0, per) of them are real (`parallel.mesh.rank_rows`).
The norms take their statistics over every rank's real rows and the losses
reduce over them (`models/norm.py`, `ops/losses.py`), so every rank computes
the global batch's loss; padded rows take DSBN domain 0 and enter no
statistic and no loss.  The gradients are averaged over the ranks in one
all-reduce before Adam (`parallel.mesh.all_reduce_grads`, which says why the
mean is the global loss's gradient), so the replicas stay bit-equal.  Every
rank draws the global batch's draws from the shared generator and takes its
rows, so the global batch is the single-process one draw for draw.  Without
a group and with pad_to_multiple the step takes the padded global batch on
one process, as the JAX package's padded single-device step does; without
either it is the single-process step, unchanged.

Windows (`--scan_window`; `ramdsir_tpu/train/steps.py:469-502`): with the
device pipeline, `make_train_step(..., scan=True)` gives `ScanTrainSteps`,
which runs a window of w steps from a (w, B) plan with no host work a step.
Every step, single or in a window, runs one body: it reads its index row,
draws and lr from row `pos` of static buffers on the device
(`StepInputs`, filled once a window through pinned memory), sets each Adam
group's lr from there, writes its metrics into the window's (w, K) table
and advances `pos`; it never copies to or from the host.  On a card the
window is a CUDA graph of that body, captured once and replayed; the
draws are drawn on the host step by step in the order single steps draw
them, so a window and w single steps take the same numbers from one
generator and, under --deterministic, give the same bits.

Layout: batch dicts are NHWC as in the JAX package; the step works on NCHW
from the encoder on.  The host loaders' fundus batches arrive as uint8
(img, donor, mask) and are promoted to float32 on the device, which is
exact; a prostate host batch is float32 img and donor and an integer mask.

Image grids: `train_step(..., viz=True)` (the loop asks at the steps that
log them, every `log_images_every`) also returns the JAX package's viz
slices under "_viz", NHWC: `image`, `image_freq` (batch[0:9:4]), `pred`
as probabilities of every class, `mask`, and `image_rec`, the first
restoration sample of each of the first three domains
(`ramdsir_tpu/train/steps.py:380-397`).  Other steps compute none of it.

Precision (`--compute_dtype`): RAM, and with it K1, runs in float32; only
the encoder's input is cast to the compute dtype, so the U-Net's activations
are bfloat16 under `bfloat16`.  The logits and the restoration output go
back to float32 before the losses, and the restoration MSE reads the
uncast float32 image (`ramdsir_tpu/train/steps.py:114`, `:242`, `:330`).
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Mapping, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ramdsir_tpu_torch.config import CONSISTENCY_WEIGHT, POLY_POWER, TrainConfig
from ramdsir_tpu_torch.data.device_pipeline import gather_and_augment, gather_prostate, sample_crop_draws
from ramdsir_tpu_torch.models.norm import batch_statistics, recomputing
from ramdsir_tpu_torch.models.transunet import CONFIGS as TRANSUNETS, PATCH
from ramdsir_tpu_torch.parallel import distributed
from ramdsir_tpu_torch.parallel.mesh import all_reduce_grads, all_reduce_sum, pad_rows, rank_rows
from ramdsir_tpu_torch.ops.losses import (
    bce_with_logits_loss,
    binary_kd_loss,
    binary_mse_consistency,
    cross_entropy_loss,
    dice_loss,
    dice_loss_multi,
    kd_loss,
    mse_loss,
)
from ramdsir_tpu_torch.ops.ram import (
    ram_augment_fundus,
    ram_augment_fundus_banded,
    ram_augment_prostate,
    ram_augment_prostate_banded,
    sample_ram_ratios,
)
from ramdsir_tpu_torch.train.state import TrainState
from ramdsir_tpu_torch.utils.profiler import span


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a --compute_dtype / predict_dtype value."""
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    if name not in dtypes:
        raise ValueError(f"unknown dtype {name!r} (use 'float32' or 'bfloat16')")
    return dtypes[name]


def check_supported(cfg: TrainConfig) -> None:
    """Raise ValueError for what cannot run: more ranks than the global
    batch has real rows, more NCCL ranks than visible GPUs (under a group,
    cfg.num_devices must be its world size), an unknown dtype or
    consistency type."""
    b_real = sum(cfg.batch_size_list[: len(cfg.domain_idxs)])
    ranks = distributed.world() if distributed.in_group() else (cfg.num_devices or 1)
    if distributed.in_group() and cfg.num_devices not in (None, ranks):
        raise ValueError(f"--num_devices {cfg.num_devices} in a process group of {ranks} ranks")
    if ranks > b_real:
        raise ValueError(f"{ranks} ranks for a global batch of {b_real} rows")
    if ranks > 1 and not distributed.in_group() and torch.device(cfg.device).type == "cuda":
        if ranks > torch.cuda.device_count():
            raise ValueError(
                f"--num_devices {ranks} but {torch.cuda.device_count()} visible GPU(s); NCCL wants one GPU a rank"
            )
    torch_dtype(cfg.compute_dtype)
    if cfg.consistency and cfg.consistency_type not in ("mse", "kd"):
        raise ValueError(f"unknown consistency_type {cfg.consistency_type!r} (use 'mse' or 'kd')")
    if cfg.model != "unet":
        check_transunet(cfg, ranks)


def check_transunet(cfg: TrainConfig, ranks: int) -> None:
    """Raise ValueError, naming the option, for what the TransUNet step
    (`models/transunet.py`) does not run."""
    name = cfg.model
    if name not in TRANSUNETS:
        raise ValueError(f"unknown model {name!r} (use 'unet' or one of {sorted(TRANSUNETS)})")
    refusals = [
        (cfg.norm != "bn", f"--norm {cfg.norm}: {name}'s decoder is batch norm (its encoder GroupNorm and LayerNorm)"),
        (cfg.activation != "relu", f"--activation {cfg.activation}: {name} is ReLU throughout"),
        (cfg.deterministic, f"--deterministic: {name}'s align_corners=True upsample backward (aten's) and SDPA's "
                            "memory-efficient backward have no deterministic CUDA path"),
        (cfg.compute_dtype != "float32" or cfg.predict_dtype != "float32",
         f"bfloat16: {name} runs in float32 only (no test holds its bfloat16 step)"),
        (ranks > 1, f"{ranks} ranks: {name}'s dropout masks are the one-process batch's"),
        (cfg.image_size % PATCH != 0, f"--image_size {cfg.image_size}: {name} takes multiples of {PATCH}"),
    ]
    for refused, why in refusals:
        if refused:
            raise ValueError(f"model {name} does not run with {why}")


def sample_step_draws(
    generator: torch.Generator, batch: int, device: torch.device, crop: bool = True, dropout: bool = False
) -> Dict[str, torch.Tensor]:
    """All of one step's random draws, on `device`: the scale-crop's draws
    (crop=True), the RAM ratios and, with dropout=True (a TransUNet), an
    int64 dropout seed in [0, 2^31) a row (`models.transunet.keep_mask`)."""
    draws = sample_crop_draws(generator, batch) if crop else {}
    draws["ratio"] = sample_ram_ratios(generator, batch)
    if dropout:
        draws["dropout_seed"] = torch.randint(0, 2**31, (batch,), generator=generator, device=generator.device)
    return {k: v.to(device) for k, v in draws.items()}


GRAPH_WARMUP_STEPS = 2  # eager steps of a run before its capture


class StepInputs:
    """A window's per-step inputs in static buffers on the step's device,
    `w` rows each: the index rows (device data), the draws and the lr,
    with `pos`, a 0-d long counter of the step the window is at, and
    `table`, the (w, K) float32 metrics of its steps (the sorted names).

    The host fills them once a window (`load`, through pinned memory on a
    card, with no synchronise); a step reads its row through `pos` and
    writes its metrics' row (`row`, `record`) with no host value, so a
    captured step reads the rows of later windows as well."""

    def __init__(self, w: int, specs: Mapping[str, tuple], device: torch.device):
        self.w = w
        self.rows = {k: torch.zeros((w,) + tuple(tail), dtype=dt, device=device) for k, (tail, dt) in specs.items()}
        self.pos = torch.zeros((), dtype=torch.long, device=device)
        self._index = torch.arange(w, device=device).view(w, 1)
        self.names: Optional[List[str]] = None
        self.table: Optional[torch.Tensor] = None

    def load(self, values: Mapping[str, object]) -> None:
        """values[name] (n, ...), n <= w, numpy, a list or a tensor on any
        device, into the first n rows of each buffer; `pos` to 0."""
        for k, dst in self.rows.items():
            src = values[k]
            src = torch.from_numpy(np.ascontiguousarray(src)) if isinstance(src, np.ndarray) else torch.as_tensor(src)
            if src.shape[0] > self.w:
                raise ValueError(f"{src.shape[0]} rows of {k} for a window of {self.w}")
            if dst.is_cuda and src.device.type == "cpu":
                src = src.to(dst.dtype).pin_memory()
            dst[: src.shape[0]].copy_(src, non_blocking=True)
        self.pos.zero_()

    def row(self, name: str) -> torch.Tensor:
        return self.rows[name].index_select(0, self.pos.view(1))[0]

    def record(self, metrics: Mapping[str, torch.Tensor]) -> None:
        """The step's metrics into row `pos` of the table; `pos` on by one."""
        if self.table is None:
            self.names = sorted(metrics)
            self.table = torch.zeros((self.w, len(self.names)), dtype=torch.float32, device=self.pos.device)
        values = torch.stack([metrics[k].float() for k in self.names]).view(1, -1)
        self.table.copy_(torch.where(self._index == self.pos, values, self.table))
        self.pos.add_(1)

    def metrics(self, n: int) -> Dict[str, torch.Tensor]:
        """The first n steps' metrics, (n,) each (copies)."""
        return {k: self.table[:n, j].clone() for j, k in enumerate(self.names)}


class ScanTrainSteps:
    """`scan_train_steps(state, plan, generator=None, draws=None, viz=False,
    timer=None) -> (metrics, viz)`: the steps of one window, the counterpart
    of the JAX package's `scan_train_steps` (`ramdsir_tpu/train/steps.py:469-502`).

    plan: {img_idx, donor_idx} (w, B) index rows, w <= the buffers' rows;
    draws (w, B, ...) as `sample_step_draws` gives them, or drawn here from
    `generator` step by step.  The host uploads the rows, the draws and the
    w poly-LR values once (`StepInputs.load`) and queues the steps; it reads
    nothing back.  Returns the metrics as (w,) tensors on the step's device
    and the viz slices of the window's last step (with viz=True), and
    advances `state` (modules, statistics, Adam, state.step) by w steps.
    `timer` (a `utils.profiler.StepTimer`) is ticked as the steps are queued.

    On a CUDA device outside a process group, with buffers of more than one
    row, the steps run as a CUDA graph: the first GRAPH_WARMUP_STEPS steps
    of the run are eager, on a side stream (they build the kernels and fill
    the caches and Adam's moments), then one step is captured into a
    `torch.cuda.CUDAGraph` on that stream and every later step is a
    replay.  A capture that fails raises.  Elsewhere (the CPU, a process
    group, one-row buffers) each step runs eagerly.  The hand-written
    kernels count their runs on the device, replays included
    (`ops.cuda_build.launch_counts`).  `replays`, `capture_seconds` and `graph_pool_bytes` (device memory the
    capture reserved) describe the graph.

    Under a profiler the call shows as the span `ramdsir.train.window`,
    holding `ramdsir.train.inputs` (the upload), one `ramdsir.train.eager`
    a step run eagerly, `ramdsir.train.capture` and one
    `ramdsir.train.replay` a replay (`utils.profiler.span`)."""

    def __init__(self, body, new_inputs, window_draws, batch: int, lr_at, window: Optional[int], viz_in_graph: bool):
        self._body, self._new_inputs, self._window_draws = body, new_inputs, window_draws
        self._batch, self._lr_at, self.window = batch, lr_at, window
        self.viz_in_graph = viz_in_graph
        self.inputs: Optional[StepInputs] = None
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.replays = 0
        self.capture_seconds: Optional[float] = None
        self.graph_pool_bytes: Optional[int] = None
        self._graph_viz: Dict[str, torch.Tensor] = {}

    def graphed(self) -> bool:
        """Whether the steps run as a graph (known after the first call)."""
        return (self.inputs is not None and self.inputs.pos.is_cuda and self.inputs.w > 1
                and not distributed.in_group())

    def __call__(self, state: TrainState, plan: Mapping, generator: Optional[torch.Generator] = None,
                 draws: Optional[Mapping] = None, viz: bool = False, timer=None):
        with span("ramdsir.train.window"):
            return self._window(state, plan, generator, draws, viz, timer)

    def _window(self, state: TrainState, plan: Mapping, generator, draws, viz: bool, timer):
        w = len(plan["img_idx"])
        device = next(state.models["encoder"].parameters()).device
        if self.inputs is None:
            self.inputs = self._new_inputs(max(w, self.window or 0), device)
        inputs = self.inputs
        with span("ramdsir.train.inputs"):
            values: Dict[str, object] = dict(self._window_draws(generator, draws, w))
            values.update({k: np.asarray(plan[k]) for k in ("img_idx", "donor_idx")})
            values["lr"] = [self._lr_at(state.step + i) for i in range(w)]
            inputs.load(values)
        tick = (lambda n: timer.tick(self._batch * n, n)) if timer is not None else (lambda n: None)
        out_viz: Dict[str, torch.Tensor] = {}
        done = 0
        if self.graphed() and self.graph is None:
            if viz and not self.viz_in_graph:
                raise ValueError("viz from a graph captured without it (log_images_every 0)")
            done = min(w, GRAPH_WARMUP_STEPS)
            compute, side = torch.cuda.current_stream(device), torch.cuda.Stream(device)
            side.wait_stream(compute)
            with torch.cuda.stream(side):
                for i in range(done):
                    with span("ramdsir.train.eager"):
                        _, out_viz = self._body(state, inputs, None, viz and i == w - 1)
                    tick(1)
            compute.wait_stream(side)
            for t in out_viz.values():  # made on the side stream, read on the compute stream
                t.record_stream(compute)
            if done < w:
                with timer.paused() if timer is not None else contextlib.nullcontext():
                    self._capture(state, inputs, side, device)
        if self.graph is not None:
            r = w - done
            for _ in range(r):
                with span("ramdsir.train.replay"):
                    self.graph.replay()
            self.replays += r
            tick(r)
            if viz:
                out_viz = {k: t.clone() for k, t in self._graph_viz.items()}
        else:
            for i in range(done, w):
                with span("ramdsir.train.eager"):
                    _, out_viz = self._body(state, inputs, None, viz and i == w - 1)
                tick(1)
        state.step += w
        return inputs.metrics(w), (out_viz if viz else {})

    def _capture(self, state: TrainState, inputs: StepInputs, stream: torch.cuda.Stream, device) -> None:
        """Capture one step (the next: row `pos`) into the graph.  The
        capture runs nothing, so the state and `pos` stay as they are."""
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(device)
        graph, timing = torch.cuda.CUDAGraph(), {}
        with span("ramdsir.train.capture", timing, "capture"):
            with torch.cuda.graph(graph, stream=stream):
                _, viz = self._body(state, inputs, None, self.viz_in_graph)
        self.capture_seconds = timing["capture"]
        self.graph_pool_bytes = torch.cuda.memory_reserved(device) - reserved
        self.graph, self._graph_viz = graph, viz


def poly_lr(base_lr: float, step: int, total_iters: int) -> float:
    """The reference sets the schedule after optimizer.step() from the
    pre-increment counter, so step i runs at lr(max(i-1, 0))."""
    return base_lr * (1.0 - max(step - 1, 0) / total_iters) ** POLY_POWER


def make_train_step(
    cfg: TrainConfig,
    total_iters: int,
    batch_size_list: Optional[List[int]] = None,
    device_data: Optional[Mapping[str, torch.Tensor]] = None,
    debug_grads: bool = False,
    pad_to_multiple: Optional[int] = None,
    scan: bool = False,
    window: Optional[int] = None,
) -> Callable:
    """Build `train_step(state, batch, generator=None, draws=None, viz=False) -> metrics`,
    or with scan=True the window step `ScanTrainSteps` (the JAX package's
    `scan_train_steps`; the module docstring), whose buffers hold `window`
    steps (None: the first window's length).

    batch (NHWC), fundus: img (B,H,W,3) [0,255], mask (B,H,W,2), float or
    uint8, and either donor_amp (B,2b+1,b+1,3) banded donor amplitudes or
    donor (B,H,W,3) [0,255] donor images.  Prostate: img and donor in [-1, 1],
    mask (B,H,W) integer labels.  With `device_data` (the device pipeline's
    arrays) batch is instead {img_idx, donor_idx} index rows, and the step
    gathers (and for fundus scale-crops) on the device.

    Data parallelism (module docstring): pad_to_multiple is the world size
    under a process group (the default there).  The device pipeline's index
    row and the draws are the global batch's (B rows), and the step takes
    this rank's rows; any other batch holds this rank's rows already (per
    rows, or only its real ones), as `pad_batch` and `rank_rows` cut them.

    The step updates `state` in place (modules, BN running statistics, Adam,
    state.step) and returns its metrics as 0-d tensors under the JAX
    package's keys; debug_grads=True adds the raw gradients under "_grads"
    (under a group, the global batch's, after the all-reduce).  The
    metrics' `lr` is the step's float32 lr on the step's device.
    """
    cfg = cfg.resolve()
    check_supported(cfg)
    is_fundus = cfg.dataset == "fundus"
    binary_head = not is_fundus and cfg.num_classes == 2
    transunet = cfg.model != "unet"
    dual_bn = cfg.norm == "bn"  # GN and IN are per sample: no per-half statistics
    bsl = list(batch_size_list or cfg.batch_size_list)[: len(cfg.domain_idxs)]
    b_real = sum(bsl)
    world, rank = distributed.world(), distributed.rank()
    grouped = distributed.in_group()
    if grouped and pad_to_multiple not in (None, world):
        raise ValueError(f"pad_to_multiple {pad_to_multiple} under a process group of {world} ranks")
    multiple = world if grouped else pad_to_multiple
    b_pad = b_real + ((-b_real) % multiple if multiple else 0)
    rows, n_local = rank_rows(b_real, world, rank) if grouped else (slice(0, b_pad), b_real)
    per = rows.stop - rows.start
    n_valid = None if n_local == per else n_local  # real rows of this rank's batch (of each half)
    # per-sample DSBN labels of this rank's rows; padded rows take domain 0
    domains = np.concatenate([np.repeat(np.arange(len(bsl)), bsl), np.zeros(b_pad - b_real, np.int64)])[rows]
    viz_rows = list(range(0, min(9, b_real), 4))  # the global batch's rows 0:9:4
    base_lr = float(cfg.lr)
    compute_dtype = torch_dtype(cfg.compute_dtype)
    group_factor = {"encoder": 0.5 if cfg.rec else 1.0}
    seg_cache: Dict[tuple, torch.Tensor] = {}

    def rec_weights(shape, device) -> torch.Tensor:
        """(D, n) segment matrix over this rank's n real rows with each
        domain's 1/(bs*C*H*W), bs its rows in the global batch: per-domain
        mean squared errors as one product."""
        key = (tuple(shape), device)
        if key not in seg_cache:
            seg = np.zeros((len(bsl), shape[0]), np.float32)
            for i, d in enumerate(domains[: shape[0]]):
                seg[d, i] = 1.0 / (bsl[d] * float(np.prod(shape[1:])))
            seg_cache[key] = torch.from_numpy(seg).to(device)
        return seg_cache[key]

    def global_rows(t: torch.Tensor, wanted) -> torch.Tensor:
        """Rows `wanted` of the global batch from t, this rank's real rows
        first: under a group every rank fills the rows it holds into zeros
        and one all-reduce assembles them (gloo's CUDA tensors offer no
        all_gather)."""
        if not grouped:  # row by row: no index tensor to copy to the device (a capture refuses one)
            return torch.stack([t[i] for i in wanted])
        out = t.new_zeros((len(wanted),) + tuple(t.shape[1:]))
        for i, g in enumerate(wanted):
            if rows.start <= g < rows.start + n_local:
                out[i] = t[g - rows.start]
        return all_reduce_sum(out)

    def nchw(x: torch.Tensor) -> torch.Tensor:
        return x.permute(0, 3, 1, 2).contiguous()

    def seg_head(logits: torch.Tensor, mask: torch.Tensor):
        """(repr, supervised loss, dice loss) of NCHW logits; `repr` feeds
        the consistency loss: fundus sigmoid probabilities, the binary
        prostate head the flat (B, H*W) logit-difference map, the generic
        head (B, H, W, C) softmax probabilities."""
        if is_fundus:
            logits = logits.float()
            pred = torch.sigmoid(logits)
            return pred, bce_with_logits_loss(logits, mask), dice_loss(pred, mask)
        if binary_head:
            l = (logits[:, 1].float() - logits[:, 0].float()).reshape(logits.shape[0], -1)
            m = mask.reshape(mask.shape[0], -1)
            return l, bce_with_logits_loss(l, m), dice_loss(torch.sigmoid(l), m == 1)
        lg = logits.float().permute(0, 2, 3, 1)  # the class axis last, as the losses take it
        pred = torch.softmax(lg, dim=-1)
        return pred, cross_entropy_loss(lg, mask), dice_loss_multi(pred, mask, cfg.num_classes, ignore_index=0)

    def consistency(repr2: torch.Tensor, repr1: torch.Tensor) -> torch.Tensor:
        if cfg.consistency_type == "kd":
            # eps guards the log against float32 saturation
            return (binary_kd_loss if binary_head else kd_loss)(repr2, repr1, eps=1e-8)
        return (binary_mse_consistency if binary_head else mse_loss)(repr2, repr1)

    def forward(state: TrainState, x: torch.Tensor, dual: bool = False, seed: Optional[torch.Tensor] = None):
        """(bottleneck, logits) of the encoder and the seg decoder; seed: a
        TransUNet's dropout seeds, one a row of a half."""
        enc, dec = state.models["encoder"], state.models["seg_decoder"]
        kw = {} if seed is None else {"dropout_seed": seed}

        def run(x):
            feats = enc(x, dual=dual, n_valid=n_valid, **kw)
            return feats[-1], dec(feats, dual=dual, n_valid=n_valid)

        if not cfg.remat or transunet:  # a TransUNet checkpoints its own stages
            return run(x)
        return checkpoint(
            run, x, use_reentrant=False, preserve_rng_state=False,  # it draws nothing
            context_fn=lambda: (contextlib.nullcontext(), recomputing(enc, dec)),
        )

    sup_tag = "loss_bce" if is_fundus else "loss_ce"

    def viz_probs(repr1: torch.Tensor, hw) -> torch.Tensor:
        """The head's repr as (n, H, W, C) probabilities."""
        if is_fundus:
            return repr1.permute(0, 2, 3, 1)
        if binary_head:
            l = repr1.reshape(repr1.shape[0], *hw)
            return torch.stack([torch.sigmoid(-l), torch.sigmoid(l)], dim=-1)
        return repr1

    def loss_fn(state: TrainState, batch, draws, want_viz: bool = False):
        metrics: Dict[str, torch.Tensor] = {}
        viz: Dict[str, torch.Tensor] = {}
        if cfg.ram:
            if "donor_amp" in batch:
                aug = ram_augment_fundus_banded if is_fundus else ram_augment_prostate_banded
                img, img_freq = aug(batch["img"], batch["donor_amp"], draws["ratio"], use_dft=cfg.ram_banded_dft)
            else:
                aug = ram_augment_fundus if is_fundus else ram_augment_prostate
                img, img_freq = aug(batch["img"], batch["donor"], draws["ratio"])
        else:
            img, img_freq = (batch["img"] / 127.5 - 1.0 if is_fundus else batch["img"].float()), None
        img = nchw(img)  # float32: RAM ran in float32 and the restoration MSE reads img
        mask = (nchw(batch["mask"]) if is_fundus else batch["mask"])[:n_local]

        if cfg.ram:
            # one forward over [clean; RAM]: per-half BN statistics, the two
            # running-stat updates in order (models/norm.py); GN and IN are
            # per sample and need no halves
            half = img.shape[0]
            last, logits_all = forward(state, torch.cat([img, nchw(img_freq)]).to(compute_dtype), dual=dual_bn,
                                       seed=draws.get("dropout_seed"))
            logits1, logits2 = logits_all[:n_local], logits_all[half : half + n_local]
            feats_f_last = last[half:]
        else:
            logits1 = forward(state, img.to(compute_dtype), seed=draws.get("dropout_seed"))[1][:n_local]

        pred1, loss_sup1, loss_dice1 = seg_head(logits1, mask)
        loss = loss_sup1 + loss_dice1
        metrics.update({f"{sup_tag}_1": loss_sup1, "loss_dice_1": loss_dice1})

        if cfg.ram:
            pred2, loss_sup2, loss_dice2 = seg_head(logits2, mask)
            loss = loss + loss_sup2 + loss_dice2
            loss_cons = consistency(pred2, pred1) if cfg.consistency else img.new_zeros(())
            loss = loss + CONSISTENCY_WEIGHT * loss_cons
            avg_rec = img.new_zeros(())
            if cfg.rec:
                # one rec-decoder pass over the whole RAM bottleneck, DSBN in
                # segment mode; per-domain MSE through the segment matrix
                rec_soft = torch.tanh(
                    state.models["rec_decoder"](feats_f_last, domain=domains, n_valid=n_valid).float()
                )
                per_row = torch.sum(torch.square(rec_soft[:n_local] - img[:n_local]), dim=(1, 2, 3))
                loss_rec_d = all_reduce_sum(rec_weights(rec_soft[:n_local].shape, img.device) @ per_row)
                avg_rec = torch.sum(loss_rec_d)
                loss = loss + cfg.lambda_rec * avg_rec
                if want_viz:
                    firsts = np.cumsum([0] + bsl[:-1])[:3]  # each domain's first row
                    viz["image_rec"] = global_rows(rec_soft.detach(), list(firsts)).permute(0, 2, 3, 1)
            metrics.update({
                f"{sup_tag}_2": loss_sup2,
                "loss_dice_2": loss_dice2,
                "loss_consistency": loss_cons,
                "loss_rec": avg_rec / 4.0,  # the reference logs avg_rec_loss/4
            })
        metrics["loss"] = loss
        if want_viz:
            pick = lambda t: global_rows(t.detach(), viz_rows)
            viz.update(image=pick(img).permute(0, 2, 3, 1), pred=viz_probs(pick(pred1), mask.shape[-2:]),
                       mask=pick(mask.permute(0, 2, 3, 1) if is_fundus else mask))
            if cfg.ram:
                viz["image_freq"] = pick(img_freq)
        return loss, metrics, {k: v.detach() for k, v in viz.items()}

    crop = device_data is not None and is_fundus
    draw_keys = ("crop_apply", "crop_u", "crop_off", "ratio") if crop else ("ratio",)
    specs = {"ratio": ((b_real,), torch.float32), "lr": ((), torch.float32)}
    if transunet:
        draw_keys += ("dropout_seed",)
        specs["dropout_seed"] = ((b_real,), torch.long)
    if crop:
        specs.update(crop_apply=((b_real,), torch.bool), crop_u=((b_real, 2), torch.float32),
                     crop_off=((b_real, 2), torch.float32))
    if device_data is not None:
        specs.update(img_idx=((b_real,), torch.long), donor_idx=((b_real,), torch.long))

    def window_draws(generator, draws, n: int) -> Dict[str, torch.Tensor]:
        """n steps' draws as (n, B, ...): `draws` as given (already stacked),
        or from `generator`, step by step, in the order n single steps
        draw them."""
        if draws is None:
            if generator is None:
                raise ValueError("the train step needs a generator or precomputed draws")
            steps = [sample_step_draws(generator, b_real, torch.device("cpu"), crop=crop, dropout=transunet)
                     for _ in range(n)]
            return {k: torch.stack([d[k] for d in steps]) for k in draw_keys}
        missing = [k for k in draw_keys if k not in draws]
        if missing:
            raise ValueError(f"the step's draws lack {missing}")
        return {k: torch.as_tensor(draws[k])[:, :b_real] for k in draw_keys}

    def body(state: TrainState, inputs: StepInputs, batch: Optional[Mapping] = None, want_viz: bool = False):
        """One step from row `inputs.pos` of the window's buffers (a host
        batch: `batch`, on the device): (metrics, viz slices).  It reads no
        value from the device to the host and copies nothing from the host,
        so it runs the same kernels eagerly and inside a CUDA graph."""
        draws = {k: inputs.row(k) for k in draw_keys}
        if b_pad != b_real or grouped:  # this rank's rows of the global draws
            draws = {k: pad_rows(v, b_pad)[rows] for k, v in draws.items()}
        if device_data is not None:
            idx = {k: inputs.row(k) for k in ("img_idx", "donor_idx")}
            if b_pad != b_real or grouped:  # padded with index 0, masked by n_valid
                idx = {k: pad_rows(v, b_pad)[rows] for k, v in idx.items()}
            if is_fundus:
                batch = gather_and_augment(device_data, idx["img_idx"], idx["donor_idx"], draws, cfg.image_size)
            else:
                batch = gather_prostate(device_data, idx["img_idx"], idx["donor_idx"])
        else:
            if is_fundus:  # a host batch: uint8 on the wire
                batch = {k: v.float() if v.dtype == torch.uint8 else v for k, v in batch.items()}
            batch = {k: pad_rows(v, per) for k, v in batch.items()}  # this rank's rows, padding added
        for m in state.models.values():
            m.train()
        opt = state.optimizer
        opt.zero_grad(set_to_none=True)
        loss, metrics, viz_slices = loss_fn(state, batch, draws, want_viz)
        loss.backward()
        all_reduce_grads(state.models)  # the mean over the ranks; nothing without a group
        grads = None
        if debug_grads:
            grads = {
                name: {k: p.grad.detach().clone() for k, p in m.named_parameters()}
                for name, m in state.models.items()
            }
        lr = inputs.row("lr")
        for name, group in zip(state.models, opt.param_groups):
            factor = group_factor.get(name, 1.0)
            if torch.is_tensor(group["lr"]):  # a capturable Adam's, on the card
                group["lr"].copy_(lr * factor)
            else:
                group["lr"] = float(lr) * factor
        opt.step()
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["lr"] = lr
        inputs.record(metrics)
        if grads is not None:
            metrics["_grads"] = grads
        return metrics, viz_slices

    def new_inputs(w: int, device: torch.device) -> StepInputs:
        return StepInputs(w, specs, device)

    one_step: Dict[torch.device, StepInputs] = {}

    def train_step(
        state: TrainState,
        batch: Mapping,
        generator: Optional[torch.Generator] = None,
        draws: Optional[Mapping[str, torch.Tensor]] = None,
        viz: bool = False,
    ) -> Dict:
        device = next(state.models["encoder"].parameters()).device
        if device not in one_step:
            one_step[device] = new_inputs(1, device)
        inputs = one_step[device]
        one = None if draws is None else {k: torch.as_tensor(v)[None] for k, v in draws.items()}
        values: Dict[str, object] = window_draws(generator, one, 1)
        values["lr"] = [poly_lr(base_lr, state.step, total_iters)]
        if device_data is not None:
            values.update({k: torch.as_tensor(batch[k])[None] for k in ("img_idx", "donor_idx")})
            batch = None
        inputs.load(values)
        metrics, viz_slices = body(state, inputs, batch, viz)
        state.step += 1
        if viz:
            metrics["_viz"] = viz_slices
        return metrics

    if scan:
        if device_data is None:
            raise ValueError("scan=True requires the device-resident dataset")
        return ScanTrainSteps(
            body, new_inputs, window_draws, b_real, lambda step: poly_lr(base_lr, step, total_iters),
            window, viz_in_graph=bool(cfg.log_images_every),
        )
    return train_step


def make_predict_fn(cfg: TrainConfig, models: Mapping[str, torch.nn.Module], bn_adapt: bool = False) -> Callable:
    """Build `predict(img, n_valid=None) -> probabilities`, the counterpart of
    the JAX package's `make_predict_fn` (`train/steps.py:509-553`).

    img: (B, H, W, C) images in [0, 255] (numpy or a tensor, any real dtype);
    returns (B, num_classes, H, W) float32 probabilities on the models'
    device, NCHW (sigmoid for fundus, softmax over classes otherwise), from
    the encoder and seg decoder under no_grad.

    bn_adapt=False normalises with the running statistics.  bn_adapt=True is
    the eval CLIs' BN adaptation: every norm uses the test batch's own
    statistics; no running statistic and no train flag changes, so `fit`
    trains on after an eval exactly as before it.  The port runs a tail
    batch as it is; n_valid (the JAX package pads to one compiled shape and
    passes the real row count) is accepted for parity: with it, the batch
    statistics come from the first n_valid rows.

    cfg.predict_dtype="bfloat16" runs the forward in bfloat16 (the input is
    cast after its normalisation, BN statistics are float32) and returns
    float32 probabilities, as the JAX package does.
    """
    cfg = cfg.resolve()
    pdt = torch_dtype(cfg.predict_dtype)
    is_fundus = cfg.dataset == "fundus"
    enc, dec = models["encoder"], models["seg_decoder"]

    def predict(img, n_valid: Optional[int] = None) -> torch.Tensor:
        device = next(enc.parameters()).device
        x = torch.as_tensor(img).to(device=device, dtype=torch.float32).permute(0, 3, 1, 2)
        if is_fundus:
            x = x / 127.5 - 1.0
        x = x.to(pdt)
        with torch.no_grad():
            if bn_adapt:
                with batch_statistics(enc, dec):
                    logits = dec(enc(x, n_valid=n_valid), n_valid=n_valid)
            else:
                training = {m: m.training for m in (enc, dec)}
                enc.eval(), dec.eval()
                try:
                    logits = dec(enc(x))
                finally:
                    for m, flag in training.items():
                        m.train(flag)
        logits = logits.float()
        if is_fundus:
            return torch.sigmoid(logits)
        return torch.softmax(logits, dim=1)

    return predict
