"""Result visualisation (PyTorch port of `ramdsir_tpu/utils/viz.py`): the
contour overlays of the eval CLIs' --save_result, the JET heatmaps of
entropy and probability maps, boundary maps, and the untransforms.

Every file is written by the port's own PNG encoder (`data/png.py`).  The
heatmaps are the JAX package's `cv2.applyColorMap(u8, COLORMAP_JET)`:
`JET_BGR` is OpenCV's JET table rebuilt from its definition (the GNU Octave
jet breakpoints at i / 255, as float32, interpolated by OpenCV's interp1 in
float32 and scaled to uint8 with round-half-even), equal to cv2 5.0.0's for
all 256 values.  As in the JAX package, the BGR rows are saved as if RGB.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ramdsir_tpu_torch.data import png

GREEN = np.array([0, 255, 0], np.float32)
BLUE = np.array([0, 0, 255], np.float32)
RED = np.array([255, 0, 0], np.float32)  # ground-truth contour

# the reference's 7-point stamp around every contour point (~3 px lines)
_STAMP_OFFSETS = ((0, 0), (1, 0), (1, 1), (0, 1), (-1, 0), (-1, -1), (0, -1))


def mask_contour(mask: np.ndarray) -> np.ndarray:
    """Binary 1-px boundary: the mask minus its erosion."""
    from scipy import ndimage

    m = np.asarray(mask).astype(bool)
    return m & ~ndimage.binary_erosion(m, border_value=0)


def _contour_points(mask: np.ndarray) -> np.ndarray:
    """The level-0.5 points skimage's `find_contours` gives on a binary map,
    (N, 2) float (row, col): the midpoints of the edges between a 0-pixel
    and a 1-pixel."""
    m = np.asarray(mask) > 0.5
    rh, ch = np.nonzero(m[:, :-1] != m[:, 1:])  # (r, c+0.5)
    rv, cv = np.nonzero(m[:-1, :] != m[1:, :])  # (r+0.5, c)
    return np.concatenate(
        [
            np.stack([rh.astype(np.float64), ch + 0.5], 1),
            np.stack([rv + 0.5, cv.astype(np.float64)], 1),
        ]
    )


def _stamp_contours(out: np.ndarray, mask: np.ndarray, color) -> None:
    """Stamp a binary map's contour points onto `out` as the reference does:
    truncation toward zero on the half-integer coordinate, numpy's negative
    wrap-around on the integer one; points past the bottom or right edge
    are dropped."""
    pts = _contour_points(mask)
    if not len(pts):
        return
    h, w = out.shape[:2]
    for dr, dc in _STAMP_OFFSETS:
        r = (pts[:, 0] + dr).astype(int)
        c = (pts[:, 1] + dc).astype(int)
        keep = (r < h) & (c < w) & (r >= -h) & (c >= -w)
        out[r[keep], c[keep]] = color


def _zero_border(m: np.ndarray) -> np.ndarray:
    """A copy with the outermost frame zeroed."""
    m = np.array(m, copy=True)
    m[0, :] = 0
    m[-1, :] = 0
    m[:, 0] = 0
    m[:, -1] = 0
    return m


def overlay_contours(img: np.ndarray, pred: Optional[np.ndarray] = None, gt: Optional[np.ndarray] = None) -> np.ndarray:
    """The reference overlay: pred channel 1 GREEN then channel 0 BLUE (a
    single channel GREEN), each with its frame zeroed; every gt channel
    through get_largest_fillhole, RED, last.  pred/gt (H, W) or (C, H, W)."""
    from ramdsir_tpu_torch.ops.postprocess import get_largest_fillhole

    out = np.asarray(img, np.float32).copy()
    if out.ndim == 2:
        out = np.repeat(out[..., None], 3, axis=-1)
    out = np.clip(out, 0, 255)
    if pred is not None:
        p = np.asarray(pred)
        if p.ndim == 2:
            p = p[None]
        colors = [GREEN] if len(p) == 1 else [BLUE] + [GREEN] * (len(p) - 1)
        for ch, color in zip(p[::-1], colors[::-1]):  # channel 1 first
            _stamp_contours(out, _zero_border(ch), color)
    if gt is not None:
        g = np.asarray(gt)
        if g.ndim == 2:
            g = g[None]
        for ch in g:
            _stamp_contours(out, get_largest_fillhole(ch).astype(np.uint8), RED)
    return out.astype(np.uint8)


def save_per_img(
    img: np.ndarray,
    output_dir: str,
    name: str,
    pred: Optional[np.ndarray] = None,
    gt: Optional[np.ndarray] = None,
) -> str:
    """Write the overlay as `<output_dir>/<image stem>.png`; returns the path."""
    os.makedirs(output_dir, exist_ok=True)
    base = os.path.splitext(os.path.basename(str(name).split(" ")[0]))[0]
    path = os.path.join(output_dir, f"{base}.png")
    return png.write(path, overlay_contours(img, pred, gt))


def _jet_bgr() -> np.ndarray:
    """OpenCV's COLORMAP_JET lookup table, (256, 3) uint8 in BGR order."""
    e = 8 * np.arange(256)  # 8x at x = i / 255, against the breakpoints' 255 * (1, 3, 5, 7)
    piece = lambda lo, hi: (e >= lo) & (e < hi)
    # each channel at the 256 breakpoints, in units of 1 / 510
    r = np.select([piece(765, 1275), piece(1275, 1785), e >= 1785], [e - 765, 510, 2295 - e], 0)
    g = np.select([piece(255, 765), piece(765, 1275), piece(1275, 1785)], [e - 255, 510, 1785 - e], 0)
    b = np.select([e < 255, piece(255, 765), piece(765, 1275)], [e + 255, 510, 1275 - e], 0)
    base = (np.stack([b, g, r], 1) / 510).astype(np.float32)
    f = np.float32
    step = f(1) / f(255)
    x = f(0) + np.arange(256, dtype=np.float32) * step  # OpenCV's linspace, float32
    table = base.copy()  # interp1 at its own breakpoints: sample i from (i - 1, i)
    dx = (x[1:] - x[:-1])[:, None]
    table[1:] = base[:-1] + dx * (base[1:] - base[:-1]) / dx
    return np.clip(np.rint(table * f(255)), 0, 255).astype(np.uint8)


JET_BGR = _jet_bgr()


def construct_color_img(prob_per_slice: np.ndarray) -> np.ndarray:
    """JET heatmap (H, W, 3) uint8, BGR, of an (H, W) map scaled to its own
    min and max."""
    p = np.asarray(prob_per_slice, np.float32)
    lo, hi = float(p.min()), float(p.max())
    u8 = ((p - lo) / max(hi - lo, 1e-12) * 255).astype(np.uint8)
    return JET_BGR[u8]


def entropy_map(probs: np.ndarray, axis: int = -1, eps: float = 1e-6) -> np.ndarray:
    """Pixelwise prediction entropy, float64."""
    p = np.asarray(probs, np.float64)
    return -(p * np.log(p + eps)).sum(axis=axis)


def _write(output_dir: str, name: str, suffix: str, array: np.ndarray) -> str:
    os.makedirs(output_dir, exist_ok=True)
    return png.write(os.path.join(output_dir, f"{os.path.splitext(name)[0]}_{suffix}.png"), array)


def draw_ent(probs: np.ndarray, output_dir: str, name: str) -> str:
    """`<name stem>_ent.png`: the heatmap of the entropy over the last axis."""
    return _write(output_dir, name, "ent", construct_color_img(entropy_map(probs)))


def draw_mask(probs: np.ndarray, output_dir: str, name: str) -> str:
    """`<name stem>_mask.png`: the heatmap of the foreground (last) channel."""
    p = np.asarray(probs)
    return _write(output_dir, name, "mask", construct_color_img(p[..., -1] if p.ndim == 3 else p))


def draw_boundary(mask: np.ndarray, output_dir: str, name: str) -> str:
    """`<name stem>_boundary.png`: the mask's 1-px contour, 0 / 255 gray."""
    return _write(output_dir, name, "boundary", (mask_contour(mask) * 255).astype(np.uint8))


def untransform(img: np.ndarray) -> np.ndarray:
    """[-1, 1] -> [0, 255] (reference dataset/utils.py:13-16)."""
    return (np.asarray(img, np.float32) + 1.0) * 127.5


def untransform_prostate(img: np.ndarray) -> np.ndarray:
    """A slice min-max scaled to [0, 255] for the overlays (reference
    dataset/utils.py:18-22)."""
    img = np.asarray(img, np.float32)
    lo, hi = img.min(), img.max()
    return (img - lo) / max(hi - lo, 1e-12) * 255.0
