"""Reading the prostate slice tree (own copy of `ramdsir_tpu/data/prostate.py`).

Layout: `base_dir/DomainX/image/*.npy`, (H, W, 3) float slices already in
[-1, 1] (a slice and its two neighbours as channels), and
`base_dir/DomainX/mask/*.npy`, integer maps under the same names.  Prostate
training applies no transform.
"""
from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np

from ramdsir_tpu_torch.config import PROSTATE_DOMAINS


def slice_names(base_dir: str, domain: str) -> List[str]:
    """The sorted slice file names of one domain."""
    return sorted(os.listdir(os.path.join(base_dir, domain, "image")))


def load_slice(base_dir: str, domain: str, name: str):
    """(image float32 (H, W, 3), mask int32 (H, W)) of one slice."""
    img = np.load(os.path.join(base_dir, domain, "image", name)).astype(np.float32)
    mask = np.load(os.path.join(base_dir, domain, "mask", name)).astype(np.int32)
    return img, mask


class ProstateDataset:
    """One domain's slices; items {img, mask} and, for split "test", id."""

    def __init__(self, base_dir: str, domain_idx: int, split: str = "train", num: Optional[int] = None):
        self.base_dir = base_dir
        self.domain = PROSTATE_DOMAINS[domain_idx]
        self.split = split
        self.id_path = slice_names(base_dir, self.domain)[:num]

    def __len__(self) -> int:
        return len(self.id_path)

    def __getitem__(self, index: int):
        name = self.id_path[index]
        img, mask = load_slice(self.base_dir, self.domain, name)
        out = {"img": img, "mask": mask}
        if self.split == "test":
            out["id"] = name
        return out


class ProstateMultiDataset:
    """The train slices of the given source domains (one domain per dataset
    in the train loop): `id_path` entries "DomainX/image/<name>", relative
    to base_dir.  The device pipeline reads the slices and draws the donors
    itself; this class lists them."""

    def __init__(self, base_dir: str, domain_idx_list: Sequence[int], num: Optional[int] = None):
        self.base_dir = base_dir
        self.domain_idx_list = list(domain_idx_list)
        self.id_path: List[str] = []
        for d in self.domain_idx_list:
            dom = PROSTATE_DOMAINS[d]
            self.id_path += [f"{dom}/image/{n}" for n in slice_names(base_dir, dom)]
        self.id_path = self.id_path[:num]

    def __len__(self) -> int:
        return len(self.id_path)
