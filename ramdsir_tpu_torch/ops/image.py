"""uint8 image conversions and resizes equal to PIL's, bit for bit.

The JAX package reads a fundus image as `Image.open(p).convert(mode)` and
resizes it with `Image.resize((S, S), BILINEAR)` (images) or `NEAREST`
(masks) (`ramdsir_tpu/data/fundus.py:68-80`).  The card has no PIL, so the
port computes the same integers itself:

  convert  "L" from RGB / RGBA: (R*19595 + G*38470 + B*7471 + 0x8000) >> 16;
           "L" and "RGB" from a palette through the palette; "RGB" from
           gray by replication; alpha dropped; "1" as 0 / 255; 16-bit gray
           ("I;16") clipped to 255, as PIL's I;16 -> L / RGB conversions.
  BILINEAR PIL's separable fixed-point filter (Resample.c): per axis the
           triangle filter widened by the downscale factor, weights
           normalised and rounded to 22 fractional bits; the horizontal pass
           first, rounded to uint8, then the vertical pass on that; a pass
           whose size does not change is skipped.
  NEAREST  source index floor(x0), x0 = scale/2 + k*scale accumulated by
           repeated addition, as PIL's ImagingScaleAffine tabulates it.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np

from ramdsir_tpu_torch.data.png import PNGImage

PRECISION_BITS = 32 - 8 - 2  # Resample.c: fixed-point weights for 8-bit images


def _luma(rgb: np.ndarray) -> np.ndarray:
    """PIL's L24: ITU-R 601-2 luma in 16-bit fixed point, rounded."""
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    return ((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16).astype(np.uint8)


def convert(img: PNGImage, mode: str) -> np.ndarray:
    """`img` as PIL's `convert(mode)` gives it, for mode "L" ((H, W) uint8)
    or "RGB" ((H, W, 3) uint8)."""
    if mode not in ("L", "RGB"):
        raise ValueError(f"convert: mode {mode!r} (only 'L' and 'RGB')")
    a, src = img.array, img.mode
    if src == "P":
        pal = img.palette
        if a.size and int(a.max()) >= len(pal):
            raise ValueError(f"{img.name}: palette index {int(a.max())} past a palette of {len(pal)} entries")
        return pal[a] if mode == "RGB" else _luma(pal)[a]
    if src == "1":
        gray = np.where(a, 255, 0).astype(np.uint8)
    elif src == "I;16":
        gray = np.minimum(a, 255).astype(np.uint8)
    elif src in ("L", "LA"):
        gray = a if src == "L" else a[..., 0]
    elif src in ("RGB", "RGBA"):
        return _luma(a) if mode == "L" else np.ascontiguousarray(a[..., :3])
    else:
        raise ValueError(f"{img.name}: cannot convert mode {src!r}")
    return gray if mode == "L" else np.repeat(gray[..., None], 3, axis=-1)


def bilinear_coefficients(n_in: int, n_out: int) -> Tuple[np.ndarray, np.ndarray]:
    """(first source index (n_out,), int32 weights (n_out, taps)) of PIL's
    BILINEAR filter from n_in to n_out samples (Resample.c precompute_coeffs
    and normalize_coeffs_8bpc), in its order of operations."""
    scale = n_in / n_out
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    taps = int(math.ceil(support)) * 2 + 1
    center = (np.arange(n_out) + 0.5) * scale
    xmin = np.maximum((center - support + 0.5).astype(np.int64), 0)  # C's (int) truncates toward 0
    count = np.minimum((center + support + 0.5).astype(np.int64), n_in) - xmin
    ss = 1.0 / filterscale
    w = np.zeros((n_out, taps))
    total = np.zeros(n_out)
    for x in range(taps):
        t = np.abs(((x + xmin).astype(np.float64) - center + 0.5) * ss)
        wx = np.where((x < count) & (t < 1.0), 1.0 - t, 0.0)
        w[:, x] = wx
        total = total + wx  # summed in the filter's order
    w = w / total[:, None]  # the tap nearest the centre always has weight > 0
    return xmin, (0.5 + w * float(1 << PRECISION_BITS)).astype(np.int32)


def _bilinear_pass(a: np.ndarray, axis: int, n_out: int) -> np.ndarray:
    n_in = a.shape[axis]
    xmin, w = bilinear_coefficients(n_in, n_out)
    shape = [1] * a.ndim
    shape[axis] = n_out
    out_shape = list(a.shape)
    out_shape[axis] = n_out
    acc = np.full(out_shape, 1 << (PRECISION_BITS - 1), np.int32)
    for k in range(w.shape[1]):
        if not w[:, k].any():
            continue
        src = np.take(a, np.minimum(xmin + k, n_in - 1), axis=axis)
        acc += src.astype(np.int32) * w[:, k].reshape(shape)
    return np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)


def nearest_indices(n_in: int, n_out: int) -> np.ndarray:
    """PIL's NEAREST source index of each output sample, -1 where it falls
    outside the input (ImagingScaleAffine: x0 = scale/2, then += scale)."""
    scale = n_in / n_out
    steps = np.full(n_out, scale)
    steps[0] = 0.0 + scale * 0.5
    idx = np.add.accumulate(steps).astype(np.int64)  # added in sequence, as the C loop adds
    return np.where(idx < n_in, idx, -1)


def resize(arr: np.ndarray, size: Tuple[int, int], resample: str) -> np.ndarray:
    """`Image.resize(size, BILINEAR | NEAREST)` of an (H, W) or (H, W, C)
    uint8 array; size is PIL's (width, height), resample "bilinear" or
    "nearest"."""
    a = np.asarray(arr)
    if a.dtype != np.uint8 or a.ndim not in (2, 3):
        raise ValueError(f"resize: uint8 (H, W) or (H, W, C) arrays only, got {a.dtype} {a.shape}")
    width, height = size
    if width <= 0 or height <= 0:
        raise ValueError(f"resize: size {size}")
    if (width, height) == (a.shape[1], a.shape[0]):
        return a.copy()
    if resample == "nearest":
        rows, cols = nearest_indices(a.shape[0], height), nearest_indices(a.shape[1], width)
        out = a[np.maximum(rows, 0)][:, np.maximum(cols, 0)]
        out[rows < 0] = 0
        out[:, cols < 0] = 0
        return out
    if resample != "bilinear":
        raise ValueError(f"resize: resample {resample!r} (only 'bilinear' and 'nearest')")
    if width != a.shape[1]:
        a = _bilinear_pass(a, 1, width)
    if height != a.shape[0]:
        a = _bilinear_pass(a, 0, height)
    return a
