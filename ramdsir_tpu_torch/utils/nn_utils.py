"""NN helpers (PyTorch port of `ramdsir_tpu/utils/nn_utils.py`, the
reference's utils/nn_utils.py, which no entry point uses).

The port is channels-first where the JAX package is channels-last: every
function that reads a channel axis takes it as `axis` (1 for NCHW, -1 for
the JAX package's NHWC).  `make_same_size` is `jax.image.resize` bilinear,
which antialiases where it shrinks: F.interpolate with antialias on a
downscale.  `all_reduce_mean` and `all_gather` run over the process group
of `parallel/distributed.py` (differentiably for the mean, through
`parallel.mesh.all_reduce_sum`); without a group there is one rank.
"""
from __future__ import annotations

import logging
import os
import time
from typing import Dict, List, Optional, TypeVar

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ramdsir_tpu_torch.parallel.distributed import in_group, world
from ramdsir_tpu_torch.parallel.mesh import all_reduce_sum

Params = TypeVar("Params", Dict[str, torch.Tensor], List[torch.Tensor])


def get_probability(logits: torch.Tensor, axis: int = 1) -> torch.Tensor:
    """Sigmoid for a head of at most 2 channels (multilabel), softmax over
    `axis` otherwise."""
    if logits.shape[axis] <= 2:
        return torch.sigmoid(logits)
    return torch.softmax(logits, dim=axis)


def get_prediction(probs: torch.Tensor, threshold: float = 0.5, axis: int = 1) -> torch.Tensor:
    """int32 labels: a 4-D 2-channel map thresholded (multilabel), else the
    argmax over `axis`."""
    if probs.ndim == 4 and probs.shape[axis] == 2:
        return (probs > threshold).to(torch.int32)
    return torch.argmax(probs, dim=axis).to(torch.int32)


def to_one_hot(labels: torch.Tensor, num_classes: int, axis: int = 1) -> torch.Tensor:
    """Integer labels -> float32 one-hot with the class axis at `axis` of the
    result; a label outside [0, num_classes) gives a row of zeros, as
    jax.nn.one_hot."""
    labels = labels.long()
    valid = (labels >= 0) & (labels < num_classes)
    onehot = F.one_hot(torch.where(valid, labels, 0), num_classes).float() * valid[..., None]
    return torch.movedim(onehot, -1, axis)


def make_same_size(x: torch.Tensor, reference: torch.Tensor) -> torch.Tensor:
    """NCHW `x` resized bilinearly (half-pixel) to `reference`'s (H, W),
    antialiased where a side shrinks."""
    size = tuple(reference.shape[-2:])
    shrink = size[0] < x.shape[-2] or size[1] < x.shape[-1]
    return F.interpolate(x, size=size, mode="bilinear", align_corners=False, antialias=shrink)


def sgd_fast_weights(params: Params, grads: Params, lr: float) -> Params:
    """MAML-style inner update theta - lr * grad over a dict or a list of
    tensors, differentiably."""
    if isinstance(params, dict):
        return {k: p - lr * grads[k] for k, p in params.items()}
    return [p - lr * g for p, g in zip(params, grads)]


def all_reduce_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of x over the ranks, differentiably; x without a group."""
    if not in_group():
        return x
    return all_reduce_sum(x) / world()


def all_gather(x: torch.Tensor) -> torch.Tensor:
    """Every rank's x stacked along a new leading axis, (world, ...), in
    rank order; x[None] without a group."""
    if not in_group():
        return x[None]
    parts = [torch.empty_like(x) for _ in range(world())]
    dist.all_gather(parts, x.contiguous())
    return torch.stack(parts)


class Timer:
    """Context-manager wall timer: `elapsed` seconds after the block."""

    def __init__(self, name: str = "", verbose: bool = False):
        self.name = name
        self.verbose = verbose
        self.elapsed = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self._t0
        if self.verbose:
            print(f"[{self.name}] {self.elapsed:.4f}s")
        return False


def mkdir(path: str) -> str:
    os.makedirs(path, exist_ok=True)
    return path


def get_logger(name: str, log_file: Optional[str] = None, level=logging.INFO) -> logging.Logger:
    """A logger to stderr (and `log_file`), handlers added once a name."""
    logger = logging.getLogger(name)
    logger.setLevel(level)
    if not logger.handlers:
        fmt = logging.Formatter("%(asctime)s %(levelname)s %(name)s: %(message)s")
        sh = logging.StreamHandler()
        sh.setFormatter(fmt)
        logger.addHandler(sh)
        if log_file:
            os.makedirs(os.path.dirname(os.path.abspath(log_file)), exist_ok=True)
            fh = logging.FileHandler(log_file)
            fh.setFormatter(fmt)
            logger.addHandler(fh)
    return logger
