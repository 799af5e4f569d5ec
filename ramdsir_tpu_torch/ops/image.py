"""uint8 image conversions and resizes equal to PIL's, and the training
augmentation's resizes equal to OpenCV's, bit for bit.

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

The JAX package's training scale-crop resizes with cv2 where cv2 is
installed (`ramdsir_tpu/data/transforms.py:541-571`): `INTER_LINEAR` for
the image, `INTER_NEAREST` for the mask.  `cv_resize` computes OpenCV's
integers (`imgproc/src/resize.cpp`, measured equal to cv2 5.0.0):

  LINEAR   per axis the source position f = (d + 0.5) * s - 0.5 with
           s = 1 / (n_out / n_in) in double, rounded to float; weights
           1 - frac(f) and frac(f) rounded to 11 bits.  Columns are clamped
           (weight 1 on the edge pixel), rows are not: a row past the edge
           reads the edge row with its own weight.  The horizontal pass
           keeps the exact int sums; the vertical pass is the SIMD
           rounding, ((h0 >> 4) * b0 >> 16) + ((h1 >> 4) * b1 >> 16),
           then (+ 2) >> 2, for every pixel.  An exact halving of both
           sides is the 2 x 2 mean, (sum + 2) >> 2, as OpenCV switches to
           INTER_AREA there.
  NEAREST  source index floor(d * (1 / (n_out / n_in))), clamped to the
           last pixel.
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


RESIZE_COEF_BITS = 11  # OpenCV's INTER_RESIZE_COEF_BITS


def cv_linear_coefficients(n_in: int, n_out: int, clamp: bool) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(first source index, its weight, the next index's weight) of OpenCV's
    INTER_LINEAR from n_in to n_out samples, weights in 11-bit fixed point.
    clamp=True is the column rule (positions before the first or at or past
    the last pixel take the edge pixel at weight 1); rows keep their
    weights and read the edge row (`cv_resize`)."""
    scale = 1.0 / (n_out / n_in)
    pos = ((np.arange(n_out, dtype=np.float64) + 0.5) * scale - 0.5).astype(np.float32)
    first = np.floor(pos).astype(np.int64)
    frac = pos - first.astype(np.float32)
    if clamp:
        frac = np.where((first < 0) | (first >= n_in - 1), np.float32(0.0), frac)
        first = np.clip(first, 0, n_in - 1)
    one = np.float32(1 << RESIZE_COEF_BITS)
    w0 = np.rint((np.float32(1.0) - frac) * one).astype(np.int32)  # saturate_cast<short>: nearest, ties to even
    w1 = np.rint(frac * one).astype(np.int32)
    return first, w0, w1


def cv_resize(arr: np.ndarray, size: Tuple[int, int], interpolation: str) -> np.ndarray:
    """`cv2.resize(arr, size, interpolation=INTER_LINEAR | INTER_NEAREST)`
    of an (H, W) or (H, W, C) uint8 array; size is cv2's (width, height),
    interpolation "linear" or "nearest"."""
    a = np.asarray(arr)
    if a.dtype != np.uint8 or a.ndim not in (2, 3):
        raise ValueError(f"cv_resize: uint8 (H, W) or (H, W, C) arrays only, got {a.dtype} {a.shape}")
    width, height = size
    if width <= 0 or height <= 0:
        raise ValueError(f"cv_resize: size {size}")
    h_in, w_in = a.shape[:2]
    if (width, height) == (w_in, h_in):
        return a.copy()
    if interpolation == "nearest":
        rows = np.minimum(np.floor(np.arange(height) * (1.0 / (height / h_in))).astype(np.int64), h_in - 1)
        cols = np.minimum(np.floor(np.arange(width) * (1.0 / (width / w_in))).astype(np.int64), w_in - 1)
        return a[rows][:, cols]
    if interpolation != "linear":
        raise ValueError(f"cv_resize: interpolation {interpolation!r} (only 'linear' and 'nearest')")
    x = a.astype(np.int32) if a.ndim == 3 else a.astype(np.int32)[..., None]
    if (w_in, h_in) == (2 * width, 2 * height):
        total = x[0::2, 0::2] + x[1::2, 0::2] + x[0::2, 1::2] + x[1::2, 1::2]
        out = (total + 2) >> 2
    else:
        sx, a0, a1 = cv_linear_coefficients(w_in, width, clamp=True)
        hor = x[:, sx] * a0[:, None] + x[:, np.minimum(sx + 1, w_in - 1)] * a1[:, None]
        sy, b0, b1 = cv_linear_coefficients(h_in, height, clamp=False)
        top = hor[np.clip(sy, 0, h_in - 1)] >> 4
        bottom = hor[np.clip(sy + 1, 0, h_in - 1)] >> 4
        out = (((top * b0[:, None, None]) >> 16) + ((bottom * b1[:, None, None]) >> 16) + 2) >> 2
    out = np.clip(out, 0, 255).astype(np.uint8)
    return out if a.ndim == 3 else out[..., 0]
