"""Contour overlays of eval predictions (port of `save_per_img` and what it
needs from `ramdsir_tpu/utils/viz.py:31-142`, and `untransform_prostate`).

Used by the eval CLIs' --save_result; the overlays are written by the
port's own PNG encoder (`data/png.py`).
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

GREEN = np.array([0, 255, 0], np.float32)
BLUE = np.array([0, 0, 255], np.float32)
RED = np.array([255, 0, 0], np.float32)  # ground-truth contour

# the reference's 7-point stamp around every contour point (~3 px lines)
_STAMP_OFFSETS = ((0, 0), (1, 0), (1, 1), (0, 1), (-1, 0), (-1, -1), (0, -1))


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
    from ramdsir_tpu_torch.data import png

    os.makedirs(output_dir, exist_ok=True)
    base = os.path.splitext(os.path.basename(str(name).split(" ")[0]))[0]
    path = os.path.join(output_dir, f"{base}.png")
    return png.write(path, overlay_contours(img, pred, gt))


def untransform_prostate(img: np.ndarray) -> np.ndarray:
    """A slice min-max scaled to [0, 255] for the overlays (reference
    dataset/utils.py:18-22)."""
    img = np.asarray(img, np.float32)
    lo, hi = img.min(), img.max()
    return (img - lo) / max(hi - lo, 1e-12) * 255.0
