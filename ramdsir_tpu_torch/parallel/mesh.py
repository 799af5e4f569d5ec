"""Data parallelism over a process group (PyTorch port of
`ramdsir_tpu/parallel/mesh.py`).

The JAX package shards the batch over a 1-D device mesh and replicates the
state; under `jax.jit` every BN statistic and loss is a global reduction, so
the sharded step equals the single-device global-batch step (sync-BN for
free), and XLA inserts the gradient sum.  The port states the same
collectives itself, one process a rank:

- each rank holds `per = ceil(B / world)` rows of the global batch, padded
  with zero rows at the end (`pad_batch`), and knows how many of them are
  real (`rank_rows`);
- the norms and the losses reduce their sums over the group with
  `all_reduce_sum` (`models/norm.py`, `ops/losses.py`), from the real rows
  only;
- `all_reduce_grads` averages the gradients in one coalesced all-reduce, and
  `replicate_state` broadcasts rank 0's state: every rank's Adam then sees
  the same gradient and the replicas stay bit-equal.

Gradient scaling.  `all_reduce_sum`'s backward sums the cotangents over the
ranks: it is the adjoint of the sum, so a rank's statistics receive the
gradient that every rank's rows send them.  Every rank back-propagates the
same global loss L, so the ranks' gradients add up to world x dL/dtheta, and
`all_reduce_grads` divides their sum by the world size: the step's gradient
is the global loss's.  (An objective that is a sum of per-rank terms, as a
single process's loss is a sum over its rows, gets the single process's
gradients from the sum alone: tests/test_torch_port_ddp.py holds both.)

These are explicit collectives, not DistributedDataParallel: the step's loss
is already the global loss, and DDP would average it once more.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ramdsir_tpu_torch.parallel.distributed import in_group, world


def pad_batch(batch: Mapping[str, Any], multiple: int) -> Dict[str, np.ndarray]:
    """Zero-pad every array's batch dim up to the next multiple (the JAX
    package's `pad_batch`; the step excludes the padded rows from every
    statistic and loss)."""
    sizes = {np.asarray(v).shape[0] for v in batch.values()}
    if len(sizes) != 1:
        raise ValueError(f"inconsistent batch dims {sizes}")
    b = sizes.pop()
    pad = (-b) % multiple
    if pad == 0:
        return dict(batch)
    return {
        k: np.concatenate([np.asarray(v), np.zeros((pad,) + np.asarray(v).shape[1:], np.asarray(v).dtype)])
        for k, v in batch.items()
    }


def rank_rows(global_batch: int, world_size: int, rank: int) -> Tuple[slice, int]:
    """(rows of the padded global batch, number of them that are real) for
    `rank`: per = ceil(global_batch / world_size) rows each, the padding at
    the end, so rank r holds clip(global_batch - r * per, 0, per) real rows."""
    per = -(-global_batch // world_size)
    start = rank * per
    return slice(start, start + per), int(np.clip(global_batch - start, 0, per))


def pad_rows(t: torch.Tensor, rows: int) -> torch.Tensor:
    """t with zero rows appended up to `rows` rows (t itself when it has them)."""
    if t.shape[0] >= rows:
        return t
    return torch.cat([t, t.new_zeros((rows - t.shape[0],) + tuple(t.shape[1:]))])


class _AllReduceSum(torch.autograd.Function):
    """The sum over the ranks, whose backward sums the cotangents over the
    ranks (the module docstring says why that is the scaling the step
    wants)."""

    @staticmethod
    def forward(ctx, x):
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad)
        return grad


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """x summed over the process group, differentiably; x itself without a
    group."""
    return _AllReduceSum.apply(x) if in_group() else x


def replicate_state(state) -> None:
    """Broadcast rank 0's modules (parameters and BN buffers), Adam's moments
    and counts, and the step counter to every rank, in place, as one flat
    float64 tensor on the modules' device (float32 and integer state fit
    float64 exactly).  Every rank must hold the same structure (the same
    config, and the same checkpoint loaded or none)."""
    if not in_group():
        return
    device = next(next(iter(state.models.values())).parameters()).device
    tensors = [t for m in state.models.values() for t in (*m.parameters(), *m.buffers())]
    for group in state.optimizer.param_groups:
        for p in group["params"]:
            tensors.extend(v for _, v in sorted(state.optimizer.state.get(p, {}).items()) if torch.is_tensor(v))
    step = torch.tensor([state.step], dtype=torch.float64)
    tensors.append(step)
    flat = torch.cat([t.detach().reshape(-1).to(device, torch.float64) for t in tensors])
    dist.broadcast(flat, 0)
    offset = 0
    with torch.no_grad():
        for t in tensors:
            t.copy_(flat[offset : offset + t.numel()].view(t.shape))
            offset += t.numel()
    state.step = int(step.item())


def all_reduce_grads(models: Mapping[str, torch.nn.Module]) -> None:
    """Every parameter's gradient replaced by its mean over the ranks, in
    one all-reduce of the flattened gradients (a parameter without a
    gradient counts as zero, so every rank reduces the same layout)."""
    if not in_group():
        return
    params = [p for m in models.values() for p in m.parameters()]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    grads = [p.grad for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    flat.div_(world())
    offset = 0
    for g in grads:
        g.copy_(flat[offset : offset + g.numel()].view(g.shape))
        offset += g.numel()
