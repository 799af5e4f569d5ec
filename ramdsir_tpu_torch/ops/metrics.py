"""Eval metrics (PyTorch port of `ramdsir_tpu/ops/metrics.py`): Dice, HD95
and ASD for eval, and the rest of the reference's metric library (Jaccard,
ASSD, the (dc, jc, hd95, asd) quadruple, integer-mask multi-class Dice and
the confusion-matrix IoU), all host numpy.

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


def jaccard_binary(pred: np.ndarray, gt: np.ndarray) -> float:
    """medpy.metric.binary.jc semantics (0 if both are empty)."""
    pred = np.asarray(pred, dtype=bool)
    gt = np.asarray(gt, dtype=bool)
    union = float(np.logical_or(pred, gt).sum())
    if union == 0:
        return 0.0
    return float(np.logical_and(pred, gt).sum()) / union


def assd(result: np.ndarray, reference: np.ndarray) -> float:
    """Average symmetric surface distance (medpy assd)."""
    d1 = surface_distances(result, reference)
    d2 = surface_distances(reference, result)
    return float(np.concatenate([d1, d2]).mean())


def calculate_metric_percase(pred: np.ndarray, gt: np.ndarray) -> Tuple[float, float, float, float]:
    """(dc, jc, hd95, asd) of one binary case."""
    return dice_binary(pred, gt), jaccard_binary(pred, gt), hd95(pred, gt), asd(pred, gt)


def dice_multi_class(pred: np.ndarray, target: np.ndarray, num_classes: int = 3, ignore_index=None) -> float:
    """Mean over classes (but `ignore_index`) of integer-mask Dice, smooth 1e-5."""
    smooth = 1e-5
    count, total = 0, 0.0
    for i in range(num_classes):
        if i == ignore_index:
            continue
        count += 1
        pi = pred == i
        ti = target == i
        inter = float(np.logical_and(pi, ti).sum())
        total += (2 * inter + smooth) / (float(pi.sum()) + float(ti.sum()) + smooth)
    return total / count


class SegmentationMetric:
    """Confusion-matrix IoU over integer masks (labels outside [0, C) skipped)."""

    def __init__(self, num_classes: int):
        self.num_classes = num_classes
        self.hist = np.zeros((num_classes, num_classes), dtype=np.int64)

    def update(self, pred: np.ndarray, label: np.ndarray) -> None:
        k = (label >= 0) & (label < self.num_classes)
        self.hist += np.bincount(
            self.num_classes * label[k].astype(int) + pred[k].astype(int),
            minlength=self.num_classes ** 2,
        ).reshape(self.num_classes, self.num_classes)

    def iou(self) -> np.ndarray:
        h = self.hist.astype(np.float64)
        denom = h.sum(1) + h.sum(0) - np.diag(h)
        with np.errstate(divide="ignore", invalid="ignore"):
            return np.diag(h) / denom

    def mean_iou(self) -> float:
        return float(np.nanmean(self.iou()))
