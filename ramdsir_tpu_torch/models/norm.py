"""Batch normalisation with nn.BatchNorm2d semantics, NCHW, and the per-sample
GroupNorm and InstanceNorm of `--norm gn|in` (PyTorch port of
`ramdsir_tpu/models/norm.py`).

Train mode normalises with the biased batch variance and moves the running
variance with the unbiased one, momentum 0.1: new = (1-m)*old + m*batch.
Parameters and buffers carry nn.BatchNorm2d's names (weight, bias,
running_mean, running_var), without num_batches_tracked, so the
reference's state dicts load with strict=True.

dual=True: the batch is [pass1; pass2] of the fused clean/RAM forward.  Each
half is normalised with its own statistics and the running statistics take
pass1's update, then pass2's, exactly the reference's two consecutive
forwards.

n_valid: only the first n_valid rows (of each half under dual) are real;
statistics come from them alone, every row is normalised.

In float32 training outside a process group, BatchNorm (both halves under
dual) and segment-mode DomainSpecificBatchNorm (each domain one contiguous
block of rows with a real row) make one call of
`ops.batch_norm.grouped_batch_norm`, a group a half or a domain: on the card
its hand-written kernels (`csrc/batch_norm.cu`), one output and no
torch.cat; on the CPU its plain version.  Any other DSBN labelling takes the
per-domain loop.

`batch_statistics(*modules)`: within it, every BatchNorm of the modules
normalises with the batch's own statistics (from the first n_valid rows)
whatever its train flag, and updates no running statistic: the eval CLIs'
BN adaptation, which leaves the modules as it found them.  These statistics
are summed in float64 (`_adapted_norm`): a prostate window batch holds 1.2 M
values a channel, and float32 sums of that many put the card's and the
CPU's probabilities further apart than eval's 1e-4 parity bound (zero-padded
rows widen the spread); the training step keeps its float32 statistics.

Under bfloat16 activations (`--compute_dtype bfloat16`) the statistics are
computed in float32 from the bfloat16 values, weight, bias and running
statistics stay float32, and the output is bfloat16, as in the JAX package
(`ramdsir_tpu/models/norm.py:76-137`).  The normalisation then follows JAX's
order, rounding four times ((x - mean), * inv, * scale, + bias;
`_apply_norm`): a fused kernel rounds once, and a
one-rounding bfloat16 forward lies further from JAX's bfloat16 forward than
that lies from float32 (tests/test_torch_port_bf16.py).

`recomputing(*modules)`: within it, every BatchNorm of the modules leaves its
running statistics as they are.  `--remat` re-runs the encoder and seg
decoder's forward in the backward (torch.utils.checkpoint), and the running
statistics take one update a forward pass, as without it.

Under a process group (`parallel/distributed.py`, data-parallel training)
BatchNorm and DomainSpecificBatchNorm in training take their statistics over
the real rows of every rank: each rank sums its real rows' x and x^2 a
channel (each half under dual, each domain for DSBN) in float32 and
all-reduces the sums with the counts (`parallel.mesh.all_reduce_sum`, whose
backward carries the statistics' gradient to every rank); mean = E[x] and
var = max(E[x^2] - E[x]^2, 0), as the JAX package computes them
(`ramdsir_tpu/models/norm.py:96-98`, `:219-258`), and the running statistics
take the update of the global count.  DSBN reduces one fixed (D, 2C + 1)
tensor on every rank, whatever domains its rows hold, so every rank issues
the same collectives in the same order; a domain with no real row on any
rank keeps its running statistics.  The eval CLIs' BN adaptation, GroupNorm
and InstanceNorm stay local.
"""
from __future__ import annotations

import contextlib
from typing import Iterator, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ramdsir_tpu_torch.ops.batch_norm import MAX_GROUPS, Layout, grouped_batch_norm, halves, update_running
from ramdsir_tpu_torch.parallel.distributed import in_group
from ramdsir_tpu_torch.parallel.mesh import all_reduce_sum

BN_MOMENTUM = 0.1


def _train_norm(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    running_mean: torch.Tensor,
    running_var: torch.Tensor,
    momentum: float,
    eps: float,
    n_stats: Optional[int] = None,
) -> torch.Tensor:
    """Train-mode BN of a bfloat16 (or other non-float32) x (N, C, H, W)
    with float32 statistics from x[:n_stats]; updates the running
    statistics in place unless they are None.  float32 goes through
    `ops.batch_norm.grouped_batch_norm`."""
    full = n_stats is None or n_stats >= x.shape[0]
    real = x if full else x[:n_stats]
    n = real.numel() // real.shape[1]
    # the statistics need their own gradient only when they come from a
    # part of the rows; the full case's backward accounts for them
    with torch.set_grad_enabled(torch.is_grad_enabled() and not full):
        mean, var = _moments(*_sums(real, (0, 2, 3)), n)
    update_running(running_mean, running_var, mean, var, float(n), momentum)
    inv = torch.rsqrt(var + eps)
    if full:
        return _LowPrecisionBatchNorm.apply(x, weight, bias, mean, inv, eps)
    return _apply_norm(x, weight, bias, mean, inv)


def _sums(x: torch.Tensor, dims) -> tuple:
    """(sum of x, sum of x^2) over `dims`, float32, from x's own values: a
    bfloat16 map is summed in float32 without a float32 copy."""
    s1 = torch.sum(x, dims, dtype=torch.float32)
    if x.dtype == torch.float32:
        return s1, torch.sum(torch.square(x), dims)
    return s1, torch.linalg.vector_norm(x, 2, dims, dtype=torch.float32).square()


def _moments(s1: torch.Tensor, s2: torch.Tensor, n):
    """(E[x], max(E[x^2] - E[x]^2, 0)) from the sums of x and x^2 over n
    values, in the sums' dtype: the JAX package's batch statistics."""
    mean = s1 / n
    return mean, torch.clamp(s2 / n - mean.square(), min=0.0)


def _global_moments(s1: torch.Tensor, s2: torch.Tensor, count: torch.Tensor):
    """(mean, var, count) over the process group from each rank's (G, C)
    sums and (G,) counts: one all-reduce, in float64 (a count is exact
    there).  var = max(E[x^2] - E[x]^2, 0); where the count is 0 both are 0."""
    c = s1.shape[-1]
    tot = all_reduce_sum(torch.cat([s1.double(), s2.double(), count.double()[:, None]], dim=1))
    n = tot[:, -1]
    mean, var = _moments(tot[:, :c], tot[:, c : 2 * c], torch.clamp(n, min=1.0)[:, None])
    return mean.float(), var.float(), n


def _apply_norm(x, weight, bias, mean, inv) -> torch.Tensor:
    """(x - mean) * inv * weight + bias of x (N, C, H, W) with (C,) or
    (N, C) statistics and affine: float32 in one product, bfloat16 in the
    JAX package's four roundings (`ramdsir_tpu/models/norm.py:120-137`),
    each operand and each product rounded to x.dtype, which reproduces its
    bits (cuDNN's fused kernel rounds once)."""
    v = (lambda t: t[None, :, None, None]) if mean.ndim == 1 else (lambda t: t[:, :, None, None])
    if x.dtype != torch.float32:
        c = lambda t: v(t.to(x.dtype))
        return (x - c(mean)) * c(inv) * c(weight) + c(bias)
    return (x - v(mean)) * v(weight * inv) + v(bias)


def _sync_train_norm(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    running_mean: torch.Tensor,
    running_var: torch.Tensor,
    momentum: float,
    eps: float,
    n_stats: Optional[int],
    halves: int,
) -> torch.Tensor:
    """Train-mode BN of x (halves * n, C, H, W) under a process group: each
    half's statistics from its first n_stats rows on every rank, the running
    statistics updated half after half (None: left alone)."""
    parts = x.chunk(halves)
    real = [h if n_stats is None else h[:n_stats] for h in parts]
    sums = [_sums(r, (0, 2, 3)) for r in real]
    # made on the device: a tensor from host data would wait for the stream
    count = torch.full((halves,), real[0].numel() / x.shape[1], dtype=torch.float64, device=x.device)
    mean, var, n = _global_moments(torch.stack([s[0] for s in sums]), torch.stack([s[1] for s in sums]), count)
    inv = torch.rsqrt(var + eps)
    for i in range(halves):
        update_running(running_mean, running_var, mean[i], var[i], n[i], momentum)
    return torch.cat([_apply_norm(h, weight, bias, mean[i], inv[i]) for i, h in enumerate(parts)])


def _adapted_norm(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float, n_stats: Optional[int] = None
) -> torch.Tensor:
    """BN of x (N, C, H, W) with the biased batch statistics of x[:n_stats],
    summed in float64 (two passes), updating nothing."""
    real = x if n_stats is None else x[:n_stats]
    n = real.numel() // real.shape[1]
    dims = (0, 2, 3)
    mean = (torch.sum(real, dim=dims, dtype=torch.float64) / n).float()[None, :, None, None]
    var = torch.sum(torch.square(real - mean), dim=dims, dtype=torch.float64) / n
    if x.dtype != torch.float32:
        return _apply_norm(x, weight, bias, mean.reshape(-1), torch.rsqrt(var.float() + eps))
    scale = (weight.double() * torch.rsqrt(var + eps)).float()
    return (x - mean) * scale[None, :, None, None] + bias[None, :, None, None]


class _LowPrecisionBatchNorm(torch.autograd.Function):
    """Train-mode BN of a bfloat16 x over all its rows, with its float32
    batch statistics given: JAX's four-rounding forward, and for the
    backward aten's fused batch-norm backward (the exact gradient of BN,
    statistics included, in one kernel; JAX differentiates its four ops,
    which differs from it by bfloat16 rounding only)."""

    @staticmethod
    def forward(ctx, x, weight, bias, mean, invstd, eps):
        ctx.save_for_backward(x, weight, mean, invstd)
        ctx.eps = eps
        return _apply_norm(x, weight, bias, mean, invstd)

    @staticmethod
    def backward(ctx, grad_out):
        x, weight, mean, invstd = ctx.saved_tensors
        grad_x, grad_w, grad_b = torch.ops.aten.native_batch_norm_backward(
            grad_out.contiguous(), x, weight, None, None, mean, invstd, True, ctx.eps, [True, True, True]
        )
        return grad_x, grad_w, grad_b, None, None, None


class BatchNorm(nn.Module):
    def __init__(self, features: int, momentum: float = BN_MOMENTUM, eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.batch_stats_only = False  # set by batch_statistics()
        self.recomputing = False  # set by recomputing()

    def normalize_running(self, x: torch.Tensor) -> torch.Tensor:
        """Eval-mode normalisation with the running statistics."""
        if x.dtype != torch.float32:
            inv = torch.rsqrt(self.running_var + self.eps)
            return _apply_norm(x, self.weight, self.bias, self.running_mean, inv)
        return F.batch_norm(
            x, self.running_mean, self.running_var, self.weight, self.bias, False, 0.0, self.eps
        )

    def forward(
        self, x: torch.Tensor, *, dual: bool = False, n_valid: Optional[int] = None
    ) -> torch.Tensor:
        if self.batch_stats_only:
            norm = lambda h: _adapted_norm(h, self.weight, self.bias, self.eps, n_valid)
        elif not self.training:
            return self.normalize_running(x)
        else:
            running = (self.running_mean, self.running_var)
            if self.recomputing:
                # the update goes to copies: the same kernels as the first
                # pass, so the recomputed activations are bit-equal to it
                running = tuple(t.clone() for t in running)
            args = (self.weight, self.bias, *running, self.momentum, self.eps)
            if in_group():
                return _sync_train_norm(x, *args, n_valid, 2 if dual else 1)
            if x.dtype == torch.float32:
                parts = 2 if dual else 1
                layout = halves(x.shape[0] // parts, parts, n_valid)
                return grouped_batch_norm(x.contiguous(), layout, [self.weight], [self.bias], [running[0]],
                                          [running[1]], self.momentum, self.eps)
            norm = lambda h: _train_norm(h, *args, n_valid)
        if dual:
            return torch.cat([norm(h) for h in x.chunk(2)])
        return norm(x)


@contextlib.contextmanager
def _set_on_batch_norms(attr: str, modules: Sequence[nn.Module]) -> Iterator[None]:
    norms = [m for module in modules for m in module.modules() if isinstance(m, BatchNorm)]
    for m in norms:
        setattr(m, attr, True)
    try:
        yield
    finally:
        for m in norms:
            setattr(m, attr, False)


def batch_statistics(*modules: nn.Module):
    """Every BatchNorm of `modules` normalises with batch statistics and
    updates nothing while the context is open (see the module docstring)."""
    return _set_on_batch_norms("batch_stats_only", modules)


def recomputing(*modules: nn.Module):
    """Every BatchNorm of `modules` normalises as in training and leaves its
    running statistics as they are while the context is open (--remat's
    recompute)."""
    return _set_on_batch_norms("recomputing", modules)


def _per_sample(norm: str, dual: bool) -> None:
    if dual:
        raise ValueError(f"dual-half statistics are BatchNorm's only, not {norm}'s (it is per sample)")


class GroupNorm(nn.GroupNorm):
    """flax's nn.GroupNorm(num_groups=1, epsilon=1e-5), the JAX package's
    'gn' (`ramdsir_tpu/models/norm.py:620-621`): each sample normalised over
    (C, H, W), then a per-channel weight and bias (the reference's
    nn.GroupNorm(1, planes), `bn1.weight`, `bn1.bias`).  The statistics are
    float32 and so is the output, whatever the input's dtype: flax promotes
    a bfloat16 input with its float32 scale, so under `--compute_dtype
    bfloat16` every layer after the first GroupNorm runs in float32 in the
    JAX package, and here.  flax computes the variance as E[x^2] - E[x]^2,
    torch's kernel by Welford's sums: they agree within the models' feature
    bounds (tests/test_torch_port_variants.py)."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__(1, features, eps=eps)

    def forward(self, x: torch.Tensor, *, dual: bool = False, n_valid: Optional[int] = None) -> torch.Tensor:
        _per_sample("GroupNorm", dual)
        return F.group_norm(x.float(), 1, self.weight, self.bias, self.eps)


class InstanceNorm(nn.Module):
    """nn.InstanceNorm2d's defaults, the JAX package's 'in'
    (`ramdsir_tpu/models/norm.py:569-582`): each sample's channel normalised
    over (H, W), no affine, no running statistics, no state.  Below float32
    the statistics are float32 and the output is (x - mean) * inv in x's
    dtype, each of the two steps rounded, as in JAX."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps

    def forward(self, x: torch.Tensor, *, dual: bool = False, n_valid: Optional[int] = None) -> torch.Tensor:
        _per_sample("InstanceNorm", dual)
        if x.dtype == torch.float32:
            return F.instance_norm(x, eps=self.eps)
        var, mean = torch.var_mean(x.float(), dim=(2, 3), keepdim=True, correction=0)
        return (x - mean.to(x.dtype)) * torch.rsqrt(var + self.eps).to(x.dtype)


class DomainSpecificBatchNorm(nn.Module):
    """A bank of per-domain BatchNorms (`bns.{d}.*`).

    domain an int: the whole batch belongs to that domain.  domain a
    sequence of per-sample labels (segment mode): each domain's rows are
    normalised with their own statistics and running statistics, the convs
    around the norm still see the whole batch.  A domain with no real row
    keeps its running statistics, and its (padding) rows are normalised with
    them.
    """

    def __init__(self, features: int, num_domains: int, momentum: float = BN_MOMENTUM, eps: float = 1e-5):
        super().__init__()
        self.bns = nn.ModuleList(BatchNorm(features, momentum, eps) for _ in range(num_domains))

    def forward(
        self,
        x: torch.Tensor,
        domain: Union[int, Sequence[int], np.ndarray],
        *,
        n_valid: Optional[int] = None,
    ) -> torch.Tensor:
        if np.ndim(domain) == 0:
            return self.bns[int(domain)](x, n_valid=n_valid)
        labels = np.asarray(domain).reshape(-1)
        if labels.shape[0] != x.shape[0]:
            raise ValueError(f"{labels.shape[0]} domain labels for a batch of {x.shape[0]}")
        n_real = x.shape[0] if n_valid is None else n_valid
        if self.training and in_group() and not self.bns[0].batch_stats_only:
            return self._sync_segments(x, labels, n_real)
        train32 = self.training and x.dtype == torch.float32 and not self.bns[0].batch_stats_only
        segments = _segments(labels, n_real) if train32 else None
        if segments is not None:
            layout, domains = segments
            bns = [self.bns[int(d)] for d in domains]
            running = [(bn.running_mean, bn.running_var) for bn in bns]
            if bns[0].recomputing:  # the update goes to copies, as in BatchNorm
                running = [(m.clone(), v.clone()) for m, v in running]
            return grouped_batch_norm(
                x.contiguous(), layout, [bn.weight for bn in bns], [bn.bias for bn in bns], [r[0] for r in running],
                [r[1] for r in running], bns[0].momentum, bns[0].eps,
            )
        order = np.argsort(labels, kind="stable")
        pieces = []
        for d in np.unique(labels):
            rows = np.flatnonzero(labels == d)
            bn = self.bns[int(d)]
            # contiguous blocks (the train step's layout) are slices; any
            # other labelling gathers its rows
            xd = x[rows[0] : rows[-1] + 1] if rows[-1] - rows[0] + 1 == len(rows) else x[torch.as_tensor(rows, device=x.device)]
            n_stats = int(np.sum(rows < n_real))
            if not self.training or n_stats == 0:
                pieces.append(bn.normalize_running(xd))
            else:
                pieces.append(bn(xd, n_valid=n_stats))
        out = torch.cat(pieces)
        if np.array_equal(order, np.arange(len(labels))):
            return out
        inverse = np.empty_like(order)
        inverse[order] = np.arange(len(order))
        return out[torch.as_tensor(inverse, device=x.device)]

    def _sync_segments(self, x: torch.Tensor, labels: np.ndarray, n_real: int) -> torch.Tensor:
        """Segment-mode DSBN under a process group: per-domain sums of the
        first n_real rows through a one-hot (N, D) weight, all-reduced as
        one (D, 2C + 1) tensor; each row normalised with its domain's global
        statistics, or with its running statistics where no rank holds a
        real row of the domain."""
        bns = self.bns
        d, (nb, c, h, w) = len(bns), x.shape
        lab = torch.from_numpy(np.asarray(labels, np.int64))
        if x.is_cuda:  # pinned and non_blocking: a pageable copy would wait for the stream
            lab = lab.pin_memory().to(x.device, non_blocking=True)
        real = (torch.arange(nb, device=x.device) < n_real).float()
        onehot = F.one_hot(lab, d).float() * real[:, None]  # (N, D), padding rows weigh 0
        s1, s2 = _sums(x, (2, 3))  # (N, C) each
        mean, var, n = _global_moments(onehot.t() @ s1, onehot.t() @ s2, onehot.sum(0).double() * (h * w))
        running_mean = torch.stack([bn.running_mean for bn in bns])
        running_var = torch.stack([bn.running_var for bn in bns])
        present = (n > 0)[:, None]
        use_mean = torch.where(present, mean, running_mean)
        use_var = torch.where(present, var, running_var)
        if not bns[0].recomputing:
            m = bns[0].momentum
            with torch.no_grad():
                unbiased = var * (n / torch.clamp(n - 1.0, min=1.0)).float()[:, None]
                new_mean = torch.where(present, (1.0 - m) * running_mean + m * mean, running_mean)
                new_var = torch.where(present, (1.0 - m) * running_var + m * unbiased, running_var)
                for i, bn in enumerate(bns):
                    bn.running_mean.copy_(new_mean[i])
                    bn.running_var.copy_(new_var[i])
        weight = torch.stack([bn.weight for bn in bns])
        bias = torch.stack([bn.bias for bn in bns])
        inv = torch.rsqrt(use_var + bns[0].eps)
        return _apply_norm(x, weight[lab], bias[lab], use_mean[lab], inv[lab])


def _segments(labels: np.ndarray, n_real: int):
    """(layout, domains) of a labelling whose domains each hold one
    contiguous block of rows, and at most MAX_GROUPS of them, each with a
    real row: a group and a slot a block, in row order; else None."""
    starts = np.flatnonzero(np.r_[True, labels[1:] != labels[:-1]])
    domains = labels[starts]
    if len(np.unique(domains)) != len(domains) or len(domains) > MAX_GROUPS:
        return None
    ends = np.r_[starts[1:], len(labels)]
    groups = tuple((int(e - s), int(min(max(n_real - s, 0), e - s)), i) for i, (s, e) in enumerate(zip(starts, ends)))
    if any(real == 0 for _, real, _ in groups):
        return None
    return Layout(groups), domains
