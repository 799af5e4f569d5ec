"""Data-side helpers (PyTorch port of `ramdsir_tpu/utils/data_utils.py`,
the reference's dataset/utils.py): the poly LR, host cross entropy, IoU and
Dice scorers, a JSON reader and the PASCAL colormap; `untransform` and
`untransform_prostate` live in `utils/viz.py`.  numpy only.
"""
from __future__ import annotations

import json
from typing import Dict, List

import numpy as np

from ramdsir_tpu_torch.utils.viz import untransform, untransform_prostate  # noqa: F401 (re-exported)


def lr_poly(base_lr: float, iter_: int, max_iter: int, power: float = 0.9) -> float:
    """Poly LR: base_lr * (1 - iter / max_iter) ** power."""
    return base_lr * (1.0 - iter_ / max_iter) ** power


def cross_entropy2d(logits: np.ndarray, target: np.ndarray) -> float:
    """Mean softmax cross entropy of channel-last logits, float64."""
    logits = np.asarray(logits, np.float64)
    z = logits - logits.max(-1, keepdims=True)
    logp = z - np.log(np.exp(z).sum(-1, keepdims=True))
    picked = np.take_along_axis(logp, np.asarray(target)[..., None].astype(int), axis=-1)
    return float(-picked.mean())


def get_iou(pred: np.ndarray, gt: np.ndarray, num_classes: int) -> List[float]:
    """Per-class IoU of integer masks (nan for a class in neither)."""
    ious = []
    for c in range(num_classes):
        p, g = pred == c, gt == c
        union = float(np.logical_or(p, g).sum())
        ious.append(float(np.logical_and(p, g).sum()) / union if union else float("nan"))
    return ious


def get_dice(pred: np.ndarray, gt: np.ndarray, num_classes: int) -> List[float]:
    """Per-class Dice of integer masks (nan for a class in neither)."""
    out = []
    for c in range(num_classes):
        p, g = pred == c, gt == c
        denom = float(p.sum() + g.sum())
        out.append(2.0 * float(np.logical_and(p, g).sum()) / denom if denom else float("nan"))
    return out


def get_mc_dice(pred: np.ndarray, gt: np.ndarray, num_classes: int) -> float:
    """Mean foreground Dice over the classes present (0 if none)."""
    vals = [v for v in get_dice(pred, gt, num_classes)[1:] if not np.isnan(v)]
    return float(np.mean(vals)) if vals else 0.0


def json_load(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def pascal_colormap(n: int = 256) -> np.ndarray:
    """The PASCAL VOC label colormap, (n, 3) uint8."""
    cmap = np.zeros((n, 3), np.uint8)
    for i in range(n):
        r = g = b = 0
        c = i
        for j in range(8):
            r |= ((c >> 0) & 1) << (7 - j)
            g |= ((c >> 1) & 1) << (7 - j)
            b |= ((c >> 2) & 1) << (7 - j)
            c >>= 3
        cmap[i] = [r, g, b]
    return cmap
