"""Batch normalisation with nn.BatchNorm2d semantics, NCHW (PyTorch port of
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

`batch_statistics(*modules)`: within it, every BatchNorm of the modules
normalises with the batch's own statistics (from the first n_valid rows)
whatever its train flag, and updates no running statistic: the eval CLIs'
BN adaptation, which leaves the modules as it found them.  These statistics
are summed in float64 (`_adapted_norm`): a prostate window batch holds 1.2 M
values a channel, and float32 sums of that many put the card's and the
CPU's probabilities further apart than eval's 1e-4 parity bound (zero-padded
rows widen the spread); the training step keeps the fused float32 kernel.

Under bfloat16 activations (`--compute_dtype bfloat16`) the statistics are
computed in float32 from the bfloat16 values, weight, bias and running
statistics stay float32, and the output is bfloat16, as in the JAX package
(`ramdsir_tpu/models/norm.py:76-137`).  The normalisation then follows JAX's
order, rounding four times ((x - mean), * inv, * scale, + bias;
`_low_precision_norm`): the fused float32 kernel rounds once, and a
one-rounding bfloat16 forward lies further from JAX's bfloat16 forward than
that lies from float32 (tests/test_torch_port_bf16.py).
"""
from __future__ import annotations

import contextlib
from typing import Iterator, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

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
    """Train-mode BN of x (N, C, H, W) with statistics from x[:n_stats];
    updates the running statistics in place unless they are None."""
    full = n_stats is None or n_stats >= x.shape[0]
    real = x if full else x[:n_stats]
    if x.dtype != torch.float32:
        # the statistics need their own gradient only when they come from a
        # part of the rows; the full case's backward accounts for them
        with torch.set_grad_enabled(torch.is_grad_enabled() and not full):
            mean, var = _low_precision_stats(real)
        _update_running(running_mean, running_var, mean, var, real, momentum)
        inv = torch.rsqrt(var + eps)
        if full:
            return _LowPrecisionBatchNorm.apply(x, weight, bias, mean, inv, eps)
        return _low_precision_norm(x, weight, bias, mean, inv)
    if full:
        return F.batch_norm(x, running_mean, running_var, weight, bias, True, momentum, eps)
    var, mean = torch.var_mean(real, dim=(0, 2, 3), correction=0)
    _update_running(running_mean, running_var, mean, var, real, momentum)
    scale = weight * torch.rsqrt(var + eps)
    return (x - mean[None, :, None, None]) * scale[None, :, None, None] + bias[None, :, None, None]


def _update_running(running_mean, running_var, mean, var, real, momentum) -> None:
    """new = (1-m)*old + m*batch, the variance unbiased over real's values
    a channel; nothing when the running statistics are None."""
    if running_mean is None:
        return
    n = real.numel() / real.shape[1]
    with torch.no_grad():
        running_mean.mul_(1.0 - momentum).add_(mean, alpha=momentum)
        running_var.mul_(1.0 - momentum).add_(var * (n / max(n - 1.0, 1.0)), alpha=momentum)


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
        return _low_precision_norm(x, weight, bias, mean.reshape(-1), torch.rsqrt(var.float() + eps))
    scale = (weight.double() * torch.rsqrt(var + eps)).float()
    return (x - mean) * scale[None, :, None, None] + bias[None, :, None, None]


def _low_precision_norm(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, mean: torch.Tensor, inv: torch.Tensor
) -> torch.Tensor:
    """The JAX package's normalisation of a bfloat16 x with float32
    statistics (`ramdsir_tpu/models/norm.py:120-137`; inv = rsqrt(var +
    eps)): (x - mean) * inv * scale + bias, each operand and each product
    rounded to x.dtype, which reproduces its bits (cuDNN's fused kernel
    rounds once)."""
    c = lambda t: t.to(x.dtype)[None, :, None, None]
    return (x - c(mean)) * c(inv) * c(weight) + c(bias)


def _low_precision_stats(real: torch.Tensor):
    """The JAX package's float32 batch statistics of a bfloat16 map: E[x]
    and max(E[x^2] - E[x]^2, 0), summed in float32 from the bfloat16 values
    (no float32 copy of the map)."""
    n = real.numel() // real.shape[1]
    dims = (0, 2, 3)
    mean = torch.sum(real, dims, dtype=torch.float32) / n
    mean2 = torch.linalg.vector_norm(real, 2, dims, dtype=torch.float32).square() / n
    return mean, torch.clamp(mean2 - mean.square(), min=0.0)


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
        return _low_precision_norm(x, weight, bias, mean, invstd)

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

    def normalize_running(self, x: torch.Tensor) -> torch.Tensor:
        """Eval-mode normalisation with the running statistics."""
        if x.dtype != torch.float32:
            inv = torch.rsqrt(self.running_var + self.eps)
            return _low_precision_norm(x, self.weight, self.bias, self.running_mean, inv)
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
            args = (self.weight, self.bias, self.running_mean, self.running_var, self.momentum, self.eps)
            norm = lambda h: _train_norm(h, *args, n_valid)
        if dual:
            return torch.cat([norm(h) for h in x.chunk(2)])
        return norm(x)


@contextlib.contextmanager
def batch_statistics(*modules: nn.Module) -> Iterator[None]:
    """Every BatchNorm of `modules` normalises with batch statistics and
    updates nothing while the context is open (see the module docstring)."""
    norms = [m for module in modules for m in module.modules() if isinstance(m, BatchNorm)]
    for m in norms:
        m.batch_stats_only = True
    try:
        yield
    finally:
        for m in norms:
            m.batch_stats_only = False


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
