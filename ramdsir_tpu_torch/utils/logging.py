"""Scalar metrics as JSON lines, the training steps' metrics ring and the
training image grids as PNGs (PyTorch port of `ramdsir_tpu/utils/logging.py`).

Tags are the reference's SummaryWriter tags (code/train.py:298-329), so
curves compare with the JAX package's `metrics.jsonl`.  The card has no
tensorboard: an image goes to `log/images/<tag, "/" -> "_">/<step>.png`,
written by the port's PNG encoder with the pixels tensorboardX's
`add_image` would store (a float grid in [0, 1] times 255, truncated to
uint8; one channel as RGB).
"""
from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ramdsir_tpu_torch.data import png
from ramdsir_tpu_torch.utils.profiler import span


def make_grid(images: np.ndarray, ncols: int = 3, normalize: bool = True) -> np.ndarray:
    """(N, H, W[, C]) -> (rows * H, ncols * W, C) float32 tiles, min-max
    normalised over the whole batch unless normalize=False."""
    images = np.asarray(images, np.float32)
    if images.ndim == 3:
        images = images[..., None]
    n, h, w, c = images.shape
    if normalize:
        lo, hi = images.min(), images.max()
        images = (images - lo) / max(hi - lo, 1e-12)
    nrows = -(-n // ncols)
    grid = np.zeros((nrows * h, ncols * w, c), np.float32)
    for i in range(n):
        r, col = divmod(i, ncols)
        grid[r * h : (r + 1) * h, col * w : (col + 1) * w] = images[i]
    return grid


# the prostate label maps' colours (the JAX package's small fixed palette)
_PALETTE = np.array([[0, 0, 0], [128, 0, 0], [0, 128, 0], [128, 128, 0], [0, 0, 128]], np.float32) / 255.0


def decode_seg_map(label_mask: np.ndarray, num_classes: int = 5) -> np.ndarray:
    """(H, W) int labels -> (H, W, 3) float RGB."""
    return _PALETTE[np.asarray(label_mask).astype(int) % num_classes]


def image_to_uint8(image_hwc: np.ndarray) -> np.ndarray:
    """An (H, W, C) image as tensorboardX's add_image stores it: uint8 as it
    is, any other dtype times 255 and truncated; one channel repeated to
    RGB."""
    img = np.asarray(image_hwc)
    if img.dtype != np.uint8:
        img = (img * 255.0).astype(np.uint8)
    return np.repeat(img, 3, axis=-1) if img.shape[-1] == 1 else img


class MetricsWriter:
    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.log_dir = log_dir
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._t0 = time.time()

    def add_scalar(self, tag: str, value, step: int) -> None:
        self._jsonl.write(json.dumps({"t": round(time.time() - self._t0, 3), "step": step, tag: float(value)}) + "\n")

    def add_scalars(self, metrics: dict, step: int, prefix: str = "") -> None:
        rec = {"t": round(time.time() - self._t0, 3), "step": step}
        rec.update({prefix + k: float(v) for k, v in metrics.items()})
        self._jsonl.write(json.dumps(rec) + "\n")

    def image_path(self, tag: str, step: int) -> str:
        return os.path.join(self.log_dir, "images", tag.replace("/", "_"), f"{step}.png")

    def add_image(self, tag: str, image_hwc: np.ndarray, step: int) -> str:
        """Write `image_hwc` (H, W, C) as a PNG; returns its path."""
        path = self.image_path(tag, step)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        return png.write(path, image_to_uint8(image_hwc))

    def flush(self) -> None:
        self._jsonl.flush()

    def close(self) -> None:
        self._jsonl.close()


class DeviceMetricsRing:
    """The training steps' scalar metrics, held on their device until
    `flush` (the JAX package's `DeviceMetricsRing`,
    `ramdsir_tpu/utils/logging.py:92-170`), so that no step waits for the
    card.

    `append(start_step, metrics)` takes a dict of 0-d tensors (one step) or
    of (W,) tensors (a window of steps start_step..start_step+W-1) and
    copies them, as float32 rows of the sorted names, into one (cap, K)
    float32 buffer on their device: a copy queued on the current stream, no
    synchronise.  `flush()` reads the rows back in one device-to-host copy
    and writes those whose step is a multiple of `log_interval`: the names
    under `prefix`, those in `no_prefix` (the reference's bare `lr`) in a
    row of their own.  A window that would overfill the buffer flushes it
    first; the training loop flushes again at each eval and at the end.
    Values are float32, as in the JAX ring: a logged lr is the float32
    value.  Under a profiler: spans `ramdsir.ring.append`, `ramdsir.ring.flush`."""

    def __init__(
        self,
        writer: MetricsWriter,
        cap: int = 2048,
        prefix: str = "loss/",
        log_interval: int = 1,
        no_prefix: Tuple[str, ...] = ("lr",),
    ):
        self.writer = writer
        self.cap = cap
        self.prefix = prefix
        self.no_prefix = frozenset(no_prefix)
        self.log_interval = max(1, log_interval)
        self.names: Optional[List[str]] = None
        self.buf: Optional[torch.Tensor] = None
        self.steps: List[int] = []  # row i of buf belongs to step steps[i]

    def append(self, start_step: int, metrics: Dict[str, torch.Tensor]) -> None:
        with span("ramdsir.ring.append"):
            if self.names is None:
                self.names = sorted(metrics)
                device = next(iter(metrics.values())).device
                self.buf = torch.zeros((self.cap, len(self.names)), dtype=torch.float32, device=device)
            table = torch.stack([torch.atleast_1d(metrics[k]).float() for k in self.names], dim=-1)
            w = table.shape[0]
            if w > self.cap:
                raise ValueError(f"a window of {w} steps does not fit a ring of {self.cap}")
            if len(self.steps) + w > self.cap:
                self.flush()
            n = len(self.steps)
            self.buf[n : n + w].copy_(table)
            self.steps.extend(range(start_step, start_step + w))

    def flush(self) -> None:
        """One device-to-host copy; writes the rows whose step hits log_interval."""
        if not self.steps:
            return
        with span("ramdsir.ring.flush"):
            table = self.buf[: len(self.steps)].cpu().numpy()
            for s, row in zip(self.steps, table):
                if s % self.log_interval == 0:
                    vals = dict(zip(self.names, row))
                    bare = {k: vals.pop(k) for k in list(vals) if k in self.no_prefix}
                    self.writer.add_scalars(vals, s, prefix=self.prefix)
                    if bare:
                        self.writer.add_scalars(bare, s)
            self.steps.clear()


class DeviceVizRing:
    """The logged steps' image-grid inputs, held until `flush` (at an eval
    boundary and at the end of training), so that no log step waits for
    the card.  `append` queues a copy of each tensor into pinned host
    memory on the current stream and records an event; `flush` waits for
    the events and hands each step's arrays to `log_fn(viz, step)`.  The
    JAX package quantises the grids to uint8 on the device for a slow
    relay link; the port keeps them float32, so its grids are `_log_viz`'s
    of the unquantised arrays.  At most `cap` steps are held, the newest.
    Under a profiler: spans `ramdsir.viz.append`, `ramdsir.viz.flush`."""

    def __init__(self, cap: int = 32):
        self.cap = cap
        self._slots: List[Tuple[int, Dict[str, torch.Tensor], Optional[torch.cuda.Event]]] = []

    def append(self, step: int, viz: Dict[str, torch.Tensor]) -> None:
        with span("ramdsir.viz.append"):
            host, event = {}, None
            for k, v in viz.items():
                v = v.detach()
                if v.is_cuda:
                    host[k] = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                    host[k].copy_(v, non_blocking=True)
                else:
                    host[k] = v.clone()
            if any(v.is_cuda for v in viz.values()):
                event = torch.cuda.Event()
                event.record()
            if len(self._slots) >= self.cap:
                self._slots.pop(0)
            self._slots.append((step, host, event))

    def flush(self, log_fn: Callable[[Dict[str, np.ndarray], int], None]) -> None:
        with span("ramdsir.viz.flush"):
            for step, host, event in self._slots:
                if event is not None:
                    event.synchronize()
                log_fn({k: v.numpy() for k, v in host.items()}, step)
            self._slots.clear()
