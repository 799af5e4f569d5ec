"""Reading the fundus PNG tree (the parts of `ramdsir_tpu/data/fundus.py`
and `data/transforms.py` the device pipeline needs).

Layout: `base_dir/DomainX_train.list` manifests with lines
"DomainX/rel_img DomainX/rel_mask" relative to base_dir, and per-domain
`base_dir/DomainX/train.list` donor manifests relative to base_dir/DomainX.
PIL is imported inside the functions that decode.
"""
from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np

from ramdsir_tpu_torch.config import FUNDUS_DOMAINS


def _read_list(path: str) -> List[str]:
    with open(path) as f:
        return [ln.strip() for ln in f if ln.strip()]


def _load_resized(path: str, size: Optional[int], mode: str) -> np.ndarray:
    """Decode an image ("RGB" or "L"), resized bilinear (images) or nearest
    (masks) to size x size when size is given."""
    from PIL import Image

    img = Image.open(path).convert(mode)
    if size is not None:
        resample = Image.NEAREST if mode == "L" else Image.BILINEAR
        img = img.resize((size, size), resample)
    return np.asarray(img, np.uint8)


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
