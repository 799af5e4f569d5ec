"""Host-side sample transforms of the training loaders (own copy of the
parts of `ramdsir_tpu/data/transforms.py` the host input path runs).

Randomness flows through an explicit numpy Generator, the loader's
per-sample one, so a sample is a pure function of its position.  The
training scale-crop resizes with `ops.image.cv_resize`, equal to cv2's
INTER_LINEAR / INTER_NEAREST, the branch the JAX package takes where cv2 is
installed.  The PIL-filter transforms (rotate, blur, sharpness, solarize,
cut-out, painting, boundaries, random resize) are not ported.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from ramdsir_tpu_torch.ops.image import cv_resize


def to_multilabel(class_mask: np.ndarray, classes: int = 2) -> np.ndarray:
    """Class map {0: bg, 1: disc, 2: cup} -> (H, W, 2) float32 [cup, disc]:
    disc = [0, 1], cup = [1, 1]."""
    mask = np.zeros((class_mask.shape[0], class_mask.shape[1], classes), np.float32)
    mask[class_mask == 1] = [0, 1]
    mask[class_mask == 2] = [1, 1]
    return mask


def decode_fundus_mask(gray: np.ndarray) -> np.ndarray:
    """Gray-value mask -> class map: >200 bg(0), 51..200 disc(1), <=50 cup(2)."""
    gray = np.asarray(gray).astype(np.uint8)
    out = np.full(gray.shape, 2, np.uint8)
    out[gray > 200] = 0
    out[(gray > 50) & (gray < 201)] = 1
    return out


def fundus_multilabel(gray: np.ndarray) -> np.ndarray:
    """(H, W) gray mask -> (H, W, 2) float32 [cup, disc]."""
    return to_multilabel(decode_fundus_mask(gray))


def np_random_scale_crop(img: np.ndarray, mask: np.ndarray, size: int, rng: np.random.Generator):
    """With probability 0.5 upscale by U(1, 1.5) on each axis (bilinear
    image, nearest mask), then a random size x size crop; the draws in the
    JAX package's order."""
    if rng.random() > 0.5:
        h0, w0 = img.shape[:2]
        w = int(rng.uniform(1.0, 1.5) * w0)
        h = int(rng.uniform(1.0, 1.5) * h0)
        img = cv_resize(img, (w, h), "linear")
        mask = cv_resize(mask, (w, h), "nearest")
    h0, w0 = img.shape[:2]
    y = int(rng.integers(0, h0 - size + 1))
    x = int(rng.integers(0, w0 - size + 1))
    return (
        np.ascontiguousarray(img[y : y + size, x : x + size]),
        np.ascontiguousarray(mask[y : y + size, x : x + size]),
    )


class ScaleCropAug:
    """`np_random_scale_crop` at one size, as a picklable callable for
    process workers: (img, mask, rng) -> (img, mask)."""

    def __init__(self, size: int):
        self.size = size

    def __call__(self, img, mask, rng):
        return np_random_scale_crop(img, mask, self.size, rng)


class CreateOnehotLabel:
    """Integer mask -> one-hot channels under "onehot_label"."""

    def __init__(self, num_classes: int):
        self.num_classes = num_classes

    def __call__(self, sample: Dict) -> Dict:
        mask = np.asarray(sample["mask"]).astype(np.int64)
        onehot = np.stack([(mask == i) for i in range(self.num_classes)], -1).astype(np.float32)
        out = dict(sample)
        out["onehot_label"] = onehot
        return out
