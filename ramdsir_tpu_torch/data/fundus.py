"""Reading the fundus PNG tree (the parts of `ramdsir_tpu/data/fundus.py`
and `data/transforms.py` the device pipeline and eval need).

Layout: `base_dir/DomainX_train.list` manifests with lines
"DomainX/rel_img DomainX/rel_mask" relative to base_dir, and per-domain
`base_dir/DomainX/{train,test}.list` manifests relative to base_dir/DomainX.
Files are decoded by the port's own PNG codec (`data/png.py`) and converted
and resized by `ops/image.py`, bit-equal to the JAX package's PIL reads.
"""
from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np

from ramdsir_tpu_torch.config import FUNDUS_DOMAINS
from ramdsir_tpu_torch.data import png
from ramdsir_tpu_torch.ops.image import convert, resize


def _read_list(path: str) -> List[str]:
    with open(path) as f:
        return [ln.strip() for ln in f if ln.strip()]


def _load_resized(path: str, size: Optional[int], mode: str) -> np.ndarray:
    """Decode an image ("RGB" or "L"), resized bilinear (images) or nearest
    (masks) to size x size when size is given."""
    img = convert(png.decode(path), mode)
    if size is not None:
        img = resize(img, (size, size), "nearest" if mode == "L" else "bilinear")
    return img


def decode_fundus_mask(gray: np.ndarray) -> np.ndarray:
    """Gray-value mask -> class map: >200 bg(0), 51..200 disc(1), <=50 cup(2)."""
    gray = np.asarray(gray).astype(np.uint8)
    out = np.full(gray.shape, 2, np.uint8)
    out[gray > 200] = 0
    out[(gray > 50) & (gray < 201)] = 1
    return out


def fundus_multilabel(gray: np.ndarray) -> np.ndarray:
    """(H, W) gray mask -> (H, W, 2) float32 [cup, disc]: disc=[0,1], cup=[1,1]."""
    cls = decode_fundus_mask(gray)
    mask = np.zeros(cls.shape + (2,), np.float32)
    mask[cls == 1] = [0, 1]
    mask[cls == 2] = [1, 1]
    return mask


class FundusDataset:
    """One domain's test split (`base_dir/DomainX/test.list`, paths relative
    to base_dir/DomainX), as the JAX package's `FundusDataset(split="test")`
    with its eval transform: each item holds `img` (S, S, 3) uint8 resized
    bilinear and `mask` (S, S) uint8 gray resized nearest (S = image_size),
    `mask_orig` (H, W, 2) uint8 [cup, disc] at the original size, and `id`,
    the list line."""

    def __init__(self, base_dir: str, domain_idx: int, image_size: int, num: Optional[int] = None):
        self.base_dir = base_dir
        self.domain = FUNDUS_DOMAINS[domain_idx]
        self.image_size = image_size
        self.id_path = _read_list(os.path.join(base_dir, self.domain, "test.list"))
        if num is not None:
            self.id_path = self.id_path[:num]

    def __len__(self) -> int:
        return len(self.id_path)

    def __getitem__(self, index: int):
        img_rel, mask_rel = self.id_path[index].split(" ")[:2]
        img = _load_resized(os.path.join(self.base_dir, self.domain, img_rel), None, "RGB")
        mask = _load_resized(os.path.join(self.base_dir, self.domain, mask_rel), None, "L")
        size = (self.image_size, self.image_size)
        return {
            "img": resize(img, size, "bilinear"),
            "mask": resize(mask, size, "nearest"),
            "mask_orig": fundus_multilabel(mask).astype(np.uint8),
            "id": self.id_path[index],
        }


class FundusMultiDataset:
    """The train manifests of the given source domains (one domain per
    dataset in the train loop): `id_path` lines, paths relative to base_dir."""

    def __init__(self, base_dir: str, domain_idx_list: Sequence[int], split: str = "train"):
        self.base_dir = base_dir
        self.domain_idx_list = list(domain_idx_list)
        self.id_path: List[str] = []
        for d in self.domain_idx_list:
            self.id_path += _read_list(os.path.join(base_dir, f"{FUNDUS_DOMAINS[d]}_{split}.list"))

    def __len__(self) -> int:
        return len(self.id_path)
