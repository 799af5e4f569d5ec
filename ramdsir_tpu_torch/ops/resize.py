"""Host bilinear resize matching torch F.interpolate(align_corners=False)
(own copy of `ramdsir_tpu/ops/resize.py`).

Eval resizes each probability map back to its image's original mask size,
which varies per image, so it runs on the host in numpy.
"""
from __future__ import annotations

import numpy as np


def _axis_weights(in_size: int, out_size: int):
    # half-pixel mapping: src = (dst + 0.5) * scale - 0.5
    scale = in_size / out_size
    src = (np.arange(out_size) + 0.5) * scale - 0.5
    src = np.clip(src, 0, in_size - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, in_size - 1)
    w = (src - lo).astype(np.float32)
    return lo, hi, w


def bilinear_resize_chw(x: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """(C, H, W) or (B, C, H, W) float -> resized along the last two dims."""
    x = np.asarray(x, np.float32)
    h, w = x.shape[-2], x.shape[-1]
    if (h, w) == (out_h, out_w):
        return x
    ylo, yhi, wy = _axis_weights(h, out_h)
    xlo, xhi, wx = _axis_weights(w, out_w)
    top = x[..., ylo, :]
    bot = x[..., yhi, :]
    rows = top + (bot - top) * wy[:, None]
    left = rows[..., :, xlo]
    right = rows[..., :, xhi]
    return left + (right - left) * wx
