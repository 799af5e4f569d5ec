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

The transform library's filters (`data/transforms.py`; the JAX package's
`Rotate`, `Blur`, `Sharpness` and `Solarize` call PIL) compute PIL 12's
integers the same way, measured bit-equal to Pillow 12.1.0:

  rotate   `Image.rotate(angle, resample, fillcolor=...)`: the inverse
           affine matrix built as Image.rotate builds it (cos and sin
           rounded to 15 places, the centre at (w/2, h/2)).  BILINEAR
           (Geometry.c's generic transform): the source point of output
           pixel (x, y) is the matrix applied to (x + 0.5, y + 0.5) in
           double; outside [0, w) x [0, h) the pixel is 0; else the
           point less 0.5, floored, interpolated in double along x on the
           row and the next (the next row taken only inside the image,
           columns clamped), then along y, and truncated.  NEAREST (the
           affine fast path): the matrix in 16.16 fixed point,
           floor(v * 65536 + 0.5), the source index the sum >> 16, an
           index outside the image leaving the fill; where a corner's
           coordinate reaches 32768 PIL steps in double instead
           (x += a0 along a row, x0 += a1 a row), and so does this.
  gaussian_blur
           `ImageFilter.GaussianBlur(radius)` (BoxBlur.c): three box
           passes along x, then three along y, each a box of radius
           l + a (float32, from the extended-box formula); a pass weighs
           the 2*int(r) + 1 pixels of the box by ww = floor(2^24 /
           (2r + 1)) and the two next beyond by fw = (2^24 - (2*int(r) +
           1) * ww) // 2, edges clamped, (sum + 2^23) >> 24 in uint32.
  sharpness
           `ImageEnhance.Sharpness(im).enhance(f)`: the SMOOTH filter (a
           3x3 kernel 1..5..1 over 13 in float32, summed row y+1, y, y-1
           onto 0.5, clipped, truncated; the border pixels copied), then
           `Image.blend(smooth, im, f)`: smooth + f * (im - smooth) in
           float32, truncated.
  solarize `ImageOps.solarize(im, t)`: v < t ? v : 255 - v.
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


# --- the transform library's PIL filters -----------------------------------


def rotation_matrix(angle: float, width: int, height: int) -> Tuple[float, ...]:
    """The inverse affine matrix (a0..a5) that `Image.rotate(angle)` hands
    to its transform, in PIL's own order of operations."""
    angle = -math.radians(angle % 360.0)
    m = [round(math.cos(angle), 15), round(math.sin(angle), 15), 0.0,
         round(-math.sin(angle), 15), round(math.cos(angle), 15), 0.0]
    cx, cy = width / 2, height / 2
    a, b, c, d, e, f = m
    m[2], m[5] = a * -cx + b * -cy + c, d * -cx + e * -cy + f
    m[2] += cx
    m[5] += cy
    return tuple(m)


def _fixed_point_fits(m: Tuple[float, ...], width: int, height: int) -> bool:
    """Geometry.c's check_fixed at the four corners."""
    return all(abs(x * m[0] + y * m[1] + m[2]) < 32768.0 and abs(x * m[3] + y * m[4] + m[5]) < 32768.0
               for x, y in ((0, 0), (width, height), (0, height), (width, 0)))


def _rotate_nearest_indices(m: Tuple[float, ...], width: int, height: int) -> Tuple[np.ndarray, np.ndarray]:
    """Source (column, row) of every output pixel of the NEAREST affine path."""
    if _fixed_point_fits(m, width, height):
        fix = lambda v: math.floor(v * 65536.0 + 0.5)
        a0, a1, a3, a4 = fix(m[0]), fix(m[1]), fix(m[3]), fix(m[4])
        a2 = fix(m[2] + m[0] * 0.5 + m[1] * 0.5)
        a5 = fix(m[5] + m[3] * 0.5 + m[4] * 0.5)
        xs, ys = np.arange(width, dtype=np.int64)[None, :], np.arange(height, dtype=np.int64)[:, None]
        return (a2 + ys * a1 + xs * a0) >> 16, (a5 + ys * a4 + xs * a3) >> 16
    # double steps, added in sequence as the C loop adds them
    x0 = m[2] + m[1] * 0.5 + m[0] * 0.5
    y0 = m[5] + m[4] * 0.5 + m[3] * 0.5
    coords = []
    for start, row_step, col_step in ((x0, m[1], m[0]), (y0, m[4], m[3])):
        steps = np.full((height, width), col_step)
        steps[:, 0] = np.add.accumulate(np.r_[start, np.full(height - 1, row_step)])
        v = np.add.accumulate(steps, axis=1)
        coords.append(np.where(v < 0.0, -1, np.trunc(np.maximum(v, 0.0))).astype(np.int64))
    return coords[0], coords[1]


def _rotate_bilinear(a: np.ndarray, m: Tuple[float, ...]) -> np.ndarray:
    height, width = a.shape[:2]
    xs = np.arange(width, dtype=np.float64)[None, :] + 0.5
    ys = np.arange(height, dtype=np.float64)[:, None] + 0.5
    xin = m[0] * xs + m[1] * ys + m[2]
    yin = m[3] * xs + m[4] * ys + m[5]
    inside = (xin >= 0.0) & (xin < width) & (yin >= 0.0) & (yin < height)
    xin, yin = xin - 0.5, yin - 0.5
    x, y = np.floor(xin).astype(np.int64), np.floor(yin).astype(np.int64)
    dx, dy = xin - x, yin - y
    c0, c1 = np.clip(x, 0, width - 1), np.clip(x + 1, 0, width - 1)
    r0, r1 = np.clip(y, 0, height - 1), np.clip(y + 1, 0, height - 1)
    next_row = (y + 1 >= 0) & (y + 1 < height)
    if a.ndim == 3:
        dx, dy, next_row, inside = dx[..., None], dy[..., None], next_row[..., None], inside[..., None]
    src = a.astype(np.float64)
    v1 = src[r0, c0] + (src[r0, c1] - src[r0, c0]) * dx
    v2 = np.where(next_row, src[r1, c0] + (src[r1, c1] - src[r1, c0]) * dx, v1)
    v = v1 + (v2 - v1) * dy
    return np.where(inside, v.astype(np.uint8), np.uint8(0))


def rotate(arr: np.ndarray, angle: float, resample: str, fill: int = 0) -> np.ndarray:
    """`Image.rotate(angle, BILINEAR | NEAREST, fillcolor=fill)` of an
    (H, W) or (H, W, C) uint8 array (angle in degrees, counter-clockwise;
    BILINEAR fills with 0, as PIL does without a fill colour)."""
    a = _uint8_image(arr, "rotate")
    if resample not in ("bilinear", "nearest"):
        raise ValueError(f"rotate: resample {resample!r} (only 'bilinear' and 'nearest')")
    if angle % 360.0 == 0:
        return a.copy()
    height, width = a.shape[:2]
    m = rotation_matrix(angle, width, height)
    if resample == "bilinear":
        return _rotate_bilinear(a, m)
    cols, rows = _rotate_nearest_indices(m, width, height)
    inside = (cols >= 0) & (cols < width) & (rows >= 0) & (rows < height)
    out = np.full_like(a, fill)
    out[inside] = a[rows[inside], cols[inside]]
    return out


def gaussian_box_radius(radius: float, passes: int = 3) -> np.float32:
    """BoxBlur.c's _gaussian_blur_radius: the extended box radius l + a of
    `passes` boxes with the Gaussian's variance, in float32."""
    f = np.float32
    r = f(radius)
    sigma2 = f(r * r / f(passes))
    big_l = f(math.sqrt(12.0 * float(sigma2) + 1.0))
    small_l = f(math.floor((float(big_l) - 1.0) / 2.0))
    a = f(f(2) * small_l + f(1)) * f(small_l * f(small_l + f(1)) - f(3) * sigma2)
    a = f(a / f(f(6) * f(sigma2 - f(small_l + f(1)) * f(small_l + f(1)))))
    return f(small_l + a)


def _box_pass(a: np.ndarray, axis: int, radius: np.float32) -> np.ndarray:
    """One ImagingLineBoxBlur pass along `axis` over every line."""
    r = int(radius)
    ww = int(np.float32(np.float32(1 << 24) / np.float32(radius * np.float32(2) + np.float32(1))))
    fw = ((1 << 24) - (2 * r + 1) * ww) // 2
    n = a.shape[axis]
    # uint32 as in C: the weights sum to at most 2^24, so no sum wraps
    x = np.moveaxis(a, axis, 0).astype(np.uint32)
    padded = x[np.clip(np.arange(-r - 1, n + r + 1), 0, n - 1)]  # edges clamped
    csum = np.concatenate([np.zeros_like(padded[:1]), np.cumsum(padded, axis=0, dtype=np.uint32)])
    box = csum[2 * r + 2 : 2 * r + 2 + n] - csum[1 : 1 + n]  # pixels x - r .. x + r
    far = padded[:n] + padded[2 * r + 2 :]  # pixels x - r - 1 and x + r + 1
    bulk = box * np.uint32(ww) + far * np.uint32(fw) + np.uint32(1 << 23)
    return np.moveaxis((bulk >> 24).astype(np.uint8), 0, axis)


def gaussian_blur(arr: np.ndarray, radius: float) -> np.ndarray:
    """`im.filter(ImageFilter.GaussianBlur(radius))` of an (H, W) or
    (H, W, C) uint8 array."""
    a = _uint8_image(arr, "gaussian_blur")
    if radius == 0:
        return a.copy()
    box = gaussian_box_radius(radius)
    if box == 0:
        return a.copy()
    for axis in (1, 1, 1, 0, 0, 0):
        a = _box_pass(a, axis, box)
    return a


_SMOOTH = tuple(np.float32(v) / np.float32(13) for v in (1, 1, 1, 1, 5, 1, 1, 1, 1))


def smooth(arr: np.ndarray) -> np.ndarray:
    """`im.filter(ImageFilter.SMOOTH)` of an (H, W) or (H, W, C) uint8 array."""
    a = _uint8_image(arr, "smooth")
    out = a.copy()
    h, w = a.shape[:2]
    if h < 3 or w < 3:
        return out
    x = a.astype(np.float32)

    def row(rows: slice, k: Tuple[np.float32, ...]) -> np.ndarray:
        return x[rows, : w - 2] * k[0] + x[rows, 1 : w - 1] * k[1] + x[rows, 2:] * k[2]

    ss = np.float32(0.5) + row(slice(2, h), _SMOOTH[0:3])  # row y + 1 first, as Filter.c
    ss = ss + row(slice(1, h - 1), _SMOOTH[3:6])
    ss = ss + row(slice(0, h - 2), _SMOOTH[6:9])
    out[1 : h - 1, 1 : w - 1] = np.clip(ss, 0, 255).astype(np.uint8)
    return out


def blend(a: np.ndarray, b: np.ndarray, alpha: float) -> np.ndarray:
    """`Image.blend(a, b, alpha)` of two uint8 arrays, alpha in [0, 1]:
    a + alpha * (b - a) in float32, truncated."""
    if not 0.0 <= alpha <= 1.0:
        raise ValueError(f"blend: alpha {alpha} outside [0, 1]")
    diff = (b.astype(np.int32) - a.astype(np.int32)).astype(np.float32)
    return (a.astype(np.float32) + np.float32(alpha) * diff).astype(np.uint8)


def sharpness(arr: np.ndarray, factor: float) -> np.ndarray:
    """`ImageEnhance.Sharpness(im).enhance(factor)` of an (H, W) or
    (H, W, C) uint8 array, factor in [0, 1]."""
    a = _uint8_image(arr, "sharpness")
    return blend(smooth(a), a, factor)


def solarize(arr: np.ndarray, threshold: int) -> np.ndarray:
    """`ImageOps.solarize(im, threshold)` of a uint8 array."""
    a = _uint8_image(arr, "solarize")
    return np.where(a < threshold, a, 255 - a).astype(np.uint8)


def _uint8_image(arr: np.ndarray, what: str) -> np.ndarray:
    a = np.asarray(arr)
    if a.dtype != np.uint8 or a.ndim not in (2, 3):
        raise ValueError(f"{what}: uint8 (H, W) or (H, W, C) arrays only, got {a.dtype} {a.shape}")
    return a
