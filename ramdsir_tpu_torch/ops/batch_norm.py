"""Train-mode batch norm with grouped statistics: hand-written CUDA kernels
(`csrc/batch_norm.cu`), their plain PyTorch version, and the autograd
Function that uses them.

One call normalises x (N, C, H, W) whose rows form G contiguous groups
(`Layout`): group g takes its statistics from its first `stat_rows` rows
(the real rows; the rest are padding), normalises all its rows, and uses
the weight, bias and running buffers of its slot.  `models/norm.py` calls it
for BatchNorm (G = 1; G = 2 halves sharing one slot under dual=True) and for
DomainSpecificBatchNorm in segment mode (a group and a slot a domain), in
float32 training outside a process group.  Statistics are the biased
variance and the mean of the real rows; the running buffers move as
`update_running` says, group after group in row order.

The kernels have no TPU counterpart: the JAX package's norms are XLA
reductions (`ramdsir_tpu/models/norm.py`).  They replace cuDNN's NCHW
train-mode batch norm, which spreads a channel over too few blocks, and the
per-half and per-domain calls joined by torch.cat.  They are built with
nvcc at first use on the card and bound with ctypes (`ops/cuda_build.py`).

`grouped_batch_norm` takes the plain version for tensors on the CPU (the
tests) and launches the kernels for CUDA tensors; a CUDA tensor they cannot
take raises, nothing falls back.  Each of the four kernels counts its runs
on the card, a graph's replays included: `cuda_build.launch_counts()`
under `batch_norm.stats`, `.forward`, `.backward_reduce` and `.backward`.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import torch

from ramdsir_tpu_torch.ops import cuda_build

SOURCE = cuda_build.source_path("batch_norm.cu")
MAX_GROUPS = 8  # the kernels' fixed tables
BLOCK = 256  # threads a block: a unit holds a multiple of it
UNITS_PER_SM = 32  # the chunking aims at this many units a streaming multiprocessor
MAX_UNIT_VECTORS = 16 * BLOCK  # at most 16 vectors a thread in a unit

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
LIBRARY = cuda_build.kernel_library(SOURCE, {
    "batch_norm_forward_launch": [_P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _F, _F, _P,
                                  _P, _P],
    "batch_norm_backward_launch": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P],
})
_sms: Dict[torch.device, int] = {}


class Layout(NamedTuple):
    """The rows of a call as G contiguous groups, in row order: `groups`
    holds (rows, stat_rows, slot) a group; a slot's groups are consecutive
    and slots count 0, 1, .. in order."""

    groups: Tuple[Tuple[int, int, int], ...]

    @property
    def rows(self) -> int:
        return sum(g[0] for g in self.groups)

    @property
    def slots(self) -> int:
        return self.groups[-1][2] + 1

    def starts(self) -> List[int]:
        out, row = [], 0
        for rows, _, _ in self.groups:
            out.append(row)
            row += rows
        return out


def halves(rows: int, halves_count: int, stat_rows: Optional[int] = None) -> Layout:
    """BatchNorm's layout: `halves_count` equal groups of `rows` rows each
    sharing slot 0, statistics from each one's first `stat_rows` rows."""
    real = rows if stat_rows is None else min(stat_rows, rows)
    return Layout(((rows, real, 0),) * halves_count)


def check_layout(layout: Layout, n: int) -> None:
    groups = layout.groups
    if not 1 <= len(groups) <= MAX_GROUPS:
        raise ValueError(f"grouped_batch_norm: 1 to {MAX_GROUPS} groups, got {len(groups)}")
    if layout.rows != n:
        raise ValueError(f"grouped_batch_norm: the groups hold {layout.rows} rows, the tensor {n}")
    slots = [g[2] for g in groups]
    if slots[0] != 0 or any(b not in (a, a + 1) for a, b in zip(slots, slots[1:])):
        raise ValueError(f"grouped_batch_norm: slots must count 0, 1, .. group by group, got {slots}")
    for rows, stat_rows, _ in groups:
        if rows < 1 or not 1 <= stat_rows <= rows:
            raise ValueError(f"grouped_batch_norm: a group of {rows} rows takes statistics from {stat_rows}")


def update_running(running_mean, running_var, mean, var, count: Union[float, torch.Tensor], momentum: float) -> None:
    """new = (1-m)*old + m*batch, the variance made unbiased over `count`
    values a channel (a float, or a float64 tensor: a process group's count,
    the factor rounded once to float32); nothing when the running statistics
    are None."""
    if running_mean is None:
        return
    with torch.no_grad():
        if isinstance(count, torch.Tensor):
            unbias = (count / torch.clamp(count - 1.0, min=1.0)).float()
        else:
            unbias = count / max(count - 1.0, 1.0)
        running_mean.mul_(1.0 - momentum).add_(mean, alpha=momentum)
        running_var.mul_(1.0 - momentum).add_(var * unbias, alpha=momentum)


# --- plain versions ----------------------------------------------------------------


def batch_norm_forward_plain(x, layout: Layout, weights, biases, running_means, running_vars, momentum: float,
                             eps: float):
    """The kernels' forward in plain PyTorch: (y, mean, invstd), the last
    two (G, C).  A group whose rows are all real goes through aten's
    train-mode batch norm (`native_batch_norm`, which also moves the running
    buffers): on the CPU the numbers the port gave before the kernels, to
    which its tests against the JAX package are fitted.  A group with
    padding rows takes the biased statistics of its real rows (var_mean),
    y = (x - mean) * (w * inv) + b over all its rows, and `update_running`.
    Groups go in row order."""
    pieces, means, invs = [], [], []
    hw = x.shape[2] * x.shape[3]
    for start, (rows, stat_rows, slot) in zip(layout.starts(), layout.groups):
        xg = x[start : start + rows]
        w, b, rm, rv = weights[slot], biases[slot], running_means[slot], running_vars[slot]
        if stat_rows == rows:
            y, mean, inv = torch.ops.aten.native_batch_norm(xg, w, b, rm, rv, True, momentum, eps)
        else:
            var, mean = torch.var_mean(xg[:stat_rows], dim=(0, 2, 3), correction=0)
            update_running(rm, rv, mean, var, float(stat_rows * hw), momentum)
            inv = torch.rsqrt(var + eps)
            y = (xg - mean[:, None, None]) * (w * inv)[:, None, None] + b[:, None, None]
        pieces.append(y)
        means.append(mean)
        invs.append(inv)
    return torch.cat(pieces), torch.stack(means), torch.stack(invs)


def batch_norm_backward_plain(dy, x, layout: Layout, mean, invstd, weights):
    """The kernels' backward in plain PyTorch: (dx, [dweight a slot], [dbias
    a slot]), a slot's gradients summed over its groups in row order.  A
    group whose rows are all real goes through aten's batch-norm backward;
    a group with padding rows takes the formula the kernels compute: with
    S1 = sum dy and S2 = sum dy * (x - mean) over all its rows and n its
    real values a channel, dx = ((dy - S1/n) - (x - mean) * inv^2*S2/n) *
    (w*inv) on real rows and dy * (w*inv) on padding rows; dweight =
    inv*S2, dbias = S1."""
    hw = x.shape[2] * x.shape[3]
    dxs, dw, db = [], [None] * layout.slots, [None] * layout.slots
    for g, (start, (rows, stat_rows, slot)) in enumerate(zip(layout.starts(), layout.groups)):
        dyg, xg, inv = dy[start : start + rows], x[start : start + rows], invstd[g]
        if stat_rows == rows:
            dx, gw, gb = torch.ops.aten.native_batch_norm_backward(
                dyg, xg, weights[slot], None, None, mean[g], inv, True, 0.0, [True, True, True])
        else:
            centred = xg - mean[g][:, None, None]
            gb = dyg.sum(dim=(0, 2, 3))
            s2 = (dyg * centred).sum(dim=(0, 2, 3))
            n = float(stat_rows * hw)
            dx = dyg.clone()
            dx[:stat_rows] -= (gb / n)[:, None, None] + centred[:stat_rows] * (inv * inv * s2 / n)[:, None, None]
            dx *= (weights[slot] * inv)[:, None, None]
            gw = inv * s2
        dxs.append(dx)
        dw[slot] = gw if dw[slot] is None else dw[slot] + gw
        db[slot] = gb if db[slot] is None else db[slot] + gb
    return torch.cat(dxs), dw, db


# --- the kernels ---------------------------------------------------------------------


class Plan(NamedTuple):
    vec: bool  # 16-byte accesses (4 floats a vector), else 1 float a vector
    unit_vectors: int  # vectors a unit (chunk) of a channel
    stat_chunks: Tuple[int, ...]  # units a channel of each group over its real rows (forward statistics)
    chunks: Tuple[int, ...]  # units a channel of each group over all its rows


def plan(layout: Layout, c: int, hw: int, vec: bool, sms: int) -> Plan:
    """The kernels' chunking: one chunk size for the call, from the whole
    tensor, so that it splits into about UNITS_PER_SM units a streaming
    multiprocessor (a block a unit, several blocks an SM), in whole rounds
    of BLOCK vectors, at least one a thread and at most 16."""
    qv = hw // 4 if vec else hw
    total = layout.rows * c * qv
    per_unit = -(-total // (UNITS_PER_SM * sms))
    f = min(max(-(-per_unit // BLOCK) * BLOCK, BLOCK), MAX_UNIT_VECTORS)
    ceil = lambda n: -(-n * qv // f)
    return Plan(vec, f, tuple(ceil(s) for _, s, _ in layout.groups), tuple(ceil(r) for r, _, _ in layout.groups))


def _plan_for(x: torch.Tensor, layout: Layout, *others: torch.Tensor) -> Plan:
    dev = x.device
    if dev not in _sms:
        _sms[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    hw = x.shape[2] * x.shape[3]
    vec = hw % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in (x, *others))
    return plan(layout, x.shape[1], hw, vec, _sms[dev])


def _ints(values) -> ctypes.Array:
    return (ctypes.c_int * len(values))(*values)


def _ptrs(tensors) -> ctypes.Array:
    return (ctypes.c_void_p * len(tensors))(*[None if t is None else t.data_ptr() for t in tensors])


def _check_cuda(x: torch.Tensor, params: Sequence[Optional[torch.Tensor]], name: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"{name}: float32 tensors only on the card, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: the tensor must be NCHW contiguous")
    if x.numel() >= 2**31 - 2**14:
        raise ValueError(f"{name}: {x.numel()} elements exceed the kernels' 32-bit indices")
    for t in params:
        if t is not None and (t.device != x.device or t.dtype != torch.float32 or t.shape != (x.shape[1],)
                              or not t.is_contiguous()):
            raise ValueError(f"{name}: weights, biases and running buffers are float32 ({x.shape[1]},) on {x.device}")


def _forward_kernels(x, layout: Layout, weights, biases, running_means, running_vars, momentum, eps):
    n, c, h, w = x.shape
    _check_cuda(x, [*weights, *biases, *running_means, *running_vars], "grouped_batch_norm")
    y = torch.empty_like(x)
    p = _plan_for(x, layout, y)
    stats = torch.empty((2, len(layout.groups), c), dtype=torch.float32, device=x.device)
    partial = torch.empty((sum(p.stat_chunks) * c, 4), dtype=torch.float32, device=x.device)
    rows, stat_rows, slots = zip(*layout.groups)
    unbias = [s * h * w / max(s * h * w - 1.0, 1.0) for s in stat_rows]
    cuda_build.launch(
        LIBRARY, "batch_norm_forward_launch", "batch_norm.stats", x.device,
        x.data_ptr(), y.data_ptr(), n, c, h * w, int(p.vec), p.unit_vectors, len(rows), _ints(rows),
        _ints(stat_rows), _ints(slots), _ints(p.stat_chunks), _ints(p.chunks),
        (ctypes.c_float * len(unbias))(*unbias), _ptrs(weights), _ptrs(biases), _ptrs(running_means),
        _ptrs(running_vars), momentum, eps, partial.data_ptr(), stats[0].data_ptr(), stats[1].data_ptr(),
    )
    return y, stats[0], stats[1]


def _backward_kernels(dy, x, layout: Layout, mean, invstd, weights):
    n, c, h, w = x.shape
    _check_cuda(dy, weights, "grouped_batch_norm backward")
    dx = torch.empty_like(x)
    p = _plan_for(x, layout, dy, dx)
    grads = torch.empty((2, layout.slots, c), dtype=torch.float32, device=x.device)
    partial = torch.empty((sum(p.chunks) * c, 2), dtype=torch.float32, device=x.device)
    rows, stat_rows, slots = zip(*layout.groups)
    cuda_build.launch(
        LIBRARY, "batch_norm_backward_launch", "batch_norm.backward_reduce", x.device,
        dy.data_ptr(), x.data_ptr(), dx.data_ptr(), n, c, h * w, int(p.vec), p.unit_vectors, len(rows),
        _ints(rows), _ints(stat_rows), _ints(slots), _ints(p.chunks), _ptrs(weights), _ptrs(list(grads[0])),
        _ptrs(list(grads[1])), mean.data_ptr(), invstd.data_ptr(), partial.data_ptr(),
    )
    return dx, list(grads[0]), list(grads[1])


class GroupedBatchNorm(torch.autograd.Function):
    """forward(x, layout, running_means, running_vars, momentum, eps,
    *weights, *biases): the kernels on CUDA tensors, the plain version on
    CPU tensors.  Saves x, the (G, C) mean and invstd and the weights."""

    @staticmethod
    def forward(ctx, x, layout, running_means, running_vars, momentum, eps, *params):
        slots = len(params) // 2
        weights, biases = params[:slots], params[slots:]
        run = batch_norm_forward_plain if x.device.type == "cpu" else _forward_kernels
        y, mean, invstd = run(x, layout, weights, biases, running_means, running_vars, momentum, eps)
        ctx.save_for_backward(x, mean, invstd, *weights)
        ctx.layout = layout
        return y

    @staticmethod
    def backward(ctx, dy):
        x, mean, invstd, *weights = ctx.saved_tensors
        run = batch_norm_backward_plain if x.device.type == "cpu" else _backward_kernels
        dx, dw, db = run(dy.contiguous(), x, ctx.layout, mean, invstd, weights)
        return (dx, None, None, None, None, None, *dw, *db)


def grouped_batch_norm(
    x: torch.Tensor,
    layout: Layout,
    weights: Sequence[torch.Tensor],
    biases: Sequence[torch.Tensor],
    running_means: Sequence[Optional[torch.Tensor]],
    running_vars: Sequence[Optional[torch.Tensor]],
    momentum: float,
    eps: float,
) -> torch.Tensor:
    """Train-mode BN of x (N, C, H, W) in `layout`'s groups, with a slot's
    weight, bias and running buffers (None: not updated) at its index."""
    if x.dim() != 4:
        raise ValueError(f"grouped_batch_norm: expected (N, C, H, W), got {tuple(x.shape)}")
    check_layout(layout, x.shape[0])
    if not len(weights) == len(biases) == len(running_means) == len(running_vars) == layout.slots:
        raise ValueError(f"grouped_batch_norm: {layout.slots} slots need a weight, bias and running buffers each")
    return GroupedBatchNorm.apply(x, layout, list(running_means), list(running_vars), momentum, eps, *weights,
                                  *biases)
