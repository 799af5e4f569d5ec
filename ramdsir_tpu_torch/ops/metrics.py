"""Eval metrics: Dice, HD95, ASD (port of the parts of
`ramdsir_tpu/ops/metrics.py` that fundus eval uses).

Dice follows the reference metric library: smooth 1.0 for the per-image
binary Dice, and the cup/disc split.  HD95 and ASD have medpy's semantics:
surface voxels are a mask minus its connectivity-1 erosion, distances are
exact Euclidean ones, hd95 is the larger of the two directed 95th
percentiles, asd the mean from the `result` surface to the `reference`
surface.

`surface_distances` runs in the host library (`ramdsir_tpu_torch.native`);
`surface_distances_plain` is the same function with scipy, the plain
version the tests and the smoke run hold the library to.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from ramdsir_tpu_torch import native


def dice_coefficient(binary_segmentation: np.ndarray, binary_gt_label: np.ndarray) -> float:
    """Per-image binary Dice with smooth 1.0."""
    seg = np.asarray(binary_segmentation, dtype=bool)
    gt = np.asarray(binary_gt_label, dtype=bool)
    intersection = float(np.logical_and(seg, gt).sum())
    return (2.0 * intersection + 1.0) / (1.0 + float(seg.sum()) + float(gt.sum()))


def dice_coeff_2label(pred: np.ndarray, target: np.ndarray) -> Tuple[float, float]:
    """(cup, disc) Dice for (2, H, W) masks; a batch (B, 2, H, W) averages."""
    pred = np.asarray(pred)
    target = np.asarray(target)
    if pred.ndim == 3:
        return dice_coefficient(pred[0], target[0]), dice_coefficient(pred[1], target[1])
    cups = [dice_coefficient(pred[i, 0], target[i, 0]) for i in range(pred.shape[0])]
    discs = [dice_coefficient(pred[i, 1], target[i, 1]) for i in range(pred.shape[0])]
    return float(np.mean(cups)), float(np.mean(discs))


def dice_binary(pred: np.ndarray, gt: np.ndarray) -> float:
    """medpy.metric.binary.dc semantics (no smoothing; 0 if both are empty)."""
    pred = np.asarray(pred, dtype=bool)
    gt = np.asarray(gt, dtype=bool)
    denom = float(pred.sum() + gt.sum())
    if denom == 0:
        return 0.0
    return 2.0 * float(np.logical_and(pred, gt).sum()) / denom


def _check_nonempty(result: np.ndarray, reference: np.ndarray) -> None:
    if result.sum() == 0:
        raise RuntimeError("The first input does not contain any binary object.")
    if reference.sum() == 0:
        raise RuntimeError("The second input does not contain any binary object.")


def _surface_mask(binary: np.ndarray) -> np.ndarray:
    """Surface voxels: the mask minus its connectivity-1 erosion."""
    from scipy import ndimage

    binary = np.asarray(binary, dtype=bool)
    structure = ndimage.generate_binary_structure(binary.ndim, 1)
    eroded = ndimage.binary_erosion(binary, structure=structure, border_value=0)
    return binary & ~eroded


def surface_distances_plain(result: np.ndarray, reference: np.ndarray) -> np.ndarray:
    """`surface_distances` with scipy's erosion and exact EDT."""
    from scipy import ndimage

    result = np.atleast_1d(np.asarray(result, dtype=bool))
    reference = np.atleast_1d(np.asarray(reference, dtype=bool))
    _check_nonempty(result, reference)
    dt = ndimage.distance_transform_edt(~_surface_mask(reference))
    return dt[_surface_mask(result)]


def surface_distances(result: np.ndarray, reference: np.ndarray) -> np.ndarray:
    """Directed surface distances result -> reference (medpy
    __surface_distances), through the host library."""
    result = np.atleast_1d(np.asarray(result, dtype=bool))
    reference = np.atleast_1d(np.asarray(reference, dtype=bool))
    _check_nonempty(result, reference)
    return native.surface_distances(result, reference)


def hd95(result: np.ndarray, reference: np.ndarray) -> float:
    """95th-percentile symmetric Hausdorff distance (medpy hd95)."""
    d1 = surface_distances(result, reference)
    d2 = surface_distances(reference, result)
    return float(max(np.percentile(d1, 95), np.percentile(d2, 95)))


def asd(result: np.ndarray, reference: np.ndarray) -> float:
    """Average one-directional surface distance (medpy asd)."""
    return float(surface_distances(result, reference).mean())
