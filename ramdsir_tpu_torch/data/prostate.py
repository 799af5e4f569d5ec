"""Reading the prostate slice tree (own copy of `ramdsir_tpu/data/prostate.py`).

Layout: `base_dir/DomainX/image/*.npy`, (H, W, 3) float slices already in
[-1, 1] (a slice and its two neighbours as channels), and
`base_dir/DomainX/mask/*.npy`, integer maps under the same names.  Prostate
training applies no transform: a host-loader item is the slice as stored
with a donor slice of a source domain (the RAM mix clips to [-1, 1] and
does not renormalise).
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
    to base_dir.  The device pipeline reads them itself; the host loaders
    call `get_item(index, rng)`: {img (H, W, 3) float32, mask (H, W) int32,
    domain int32} and, with is_freq, a random `donor` slice (float32) of a
    source domain, under is_out_domain another than the item's own."""

    def __init__(
        self,
        base_dir: str,
        domain_idx_list: Sequence[int],
        split: str = "train",
        num: Optional[int] = None,
        is_freq: bool = True,
        is_out_domain: bool = False,
        test_domain_idx: Optional[int] = None,
        rng: Optional[np.random.Generator] = None,
    ):
        self.base_dir = base_dir
        self.domain_idx_list = list(domain_idx_list)
        self.is_freq = is_freq
        self.is_out_domain = is_out_domain
        self.test_domain_idx = test_domain_idx
        self.rng = rng or np.random.default_rng()
        self.id_path: List[str] = []
        for d in self.domain_idx_list:
            dom = PROSTATE_DOMAINS[d]
            self.id_path += [f"{dom}/image/{n}" for n in slice_names(base_dir, dom)]
        self.id_path = self.id_path[:num]
        self.train_domains = [
            d for d in PROSTATE_DOMAINS if test_domain_idx is None or d != PROSTATE_DOMAINS[test_domain_idx]
        ]
        self._donor_lists = {}

    def __len__(self) -> int:
        return len(self.id_path)

    def _donor_names(self, domain_name: str) -> List[str]:
        if domain_name not in self._donor_lists:
            self._donor_lists[domain_name] = slice_names(self.base_dir, domain_name)
        return self._donor_lists[domain_name]

    def _sample_donor(self, cur_domain: str, rng: np.random.Generator) -> np.ndarray:
        pool = [d for d in self.train_domains if not (self.is_out_domain and d == cur_domain)]
        donor_domain = pool[int(rng.integers(0, len(pool)))]
        names = self._donor_names(donor_domain)
        name = names[int(rng.integers(0, len(names)))]
        return np.load(os.path.join(self.base_dir, donor_domain, "image", name)).astype(np.float32)

    def get_item(self, index: int, rng: Optional[np.random.Generator] = None):
        """Item `index`, its donor drawn from `rng` (default the dataset's own)."""
        rng = self.rng if rng is None else rng
        cur_domain, _, name = self.id_path[index].split("/")
        img, mask = load_slice(self.base_dir, cur_domain, name)
        out = {"img": img, "mask": mask, "domain": np.int32(PROSTATE_DOMAINS.index(cur_domain))}
        if self.is_freq:
            out["donor"] = self._sample_donor(cur_domain, rng)
        return out

    def __getitem__(self, index: int):
        return self.get_item(index)
