"""Reading the fundus PNG tree (own copy of `ramdsir_tpu/data/fundus.py`).

Layout: `base_dir/DomainX_train.list` manifests with lines
"DomainX/rel_img DomainX/rel_mask" relative to base_dir, and per-domain
`base_dir/DomainX/{train,test}.list` manifests relative to base_dir/DomainX.
Files are decoded by the port's own PNG codec (`data/png.py`) and converted
and resized by `ops/image.py`, bit-equal to the JAX package's PIL reads.

`FundusMultiDataset` serves both input paths: the device pipeline reads its
`id_path` (`DeviceFundusPipeline.from_tree`); the host loaders call
`get_item(index, rng)`, which returns the sample after the random
transform with a donor image of another source domain, uint8 on the wire.
"""
from __future__ import annotations

import os
import threading
from typing import List, Optional, Sequence

import numpy as np

from ramdsir_tpu_torch.config import FUNDUS_DOMAINS
from ramdsir_tpu_torch.data import png
from ramdsir_tpu_torch.data.transforms import decode_fundus_mask, fundus_multilabel  # noqa: F401 (re-exported)
from ramdsir_tpu_torch.ops.image import convert, resize


def _read_list(path: str) -> List[str]:
    with open(path) as f:
        return [ln.strip() for ln in f if ln.strip()]


class _DecodeCache:
    """Thread-safe cache of decoded (and resized) images.  A fundus train
    set resized to 256^2 fits in memory (~150 MB for all four domains), so
    after the first epoch the loaders never decode a PNG again.  It pickles
    its configuration and not its contents: each process worker warms its
    own."""

    def __init__(self, max_items: int = 4096):
        self.max_items = max_items
        self._store = {}
        self._lock = threading.Lock()

    def __getstate__(self):
        return {"max_items": self.max_items}

    def __setstate__(self, state):
        self.__init__(state["max_items"])

    def get(self, key, build):
        with self._lock:
            if key in self._store:
                return self._store[key]
        val = build()
        with self._lock:
            if len(self._store) < self.max_items:
                self._store[key] = val
        return val


def _load_resized(cache: Optional[_DecodeCache], path: str, size: Optional[int], mode: str) -> np.ndarray:
    """Decode an image ("RGB" or "L"), resized bilinear (images) or nearest
    (masks) to size x size when size is given; through `cache` when given."""

    def build():
        img = convert(png.decode(path), mode)
        if size is not None:
            img = resize(img, (size, size), "nearest" if mode == "L" else "bilinear")
        return img

    if cache is None:
        return build()
    return cache.get((path, size, mode), build)


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
        img = _load_resized(None, os.path.join(self.base_dir, self.domain, img_rel), None, "RGB")
        mask = _load_resized(None, os.path.join(self.base_dir, self.domain, mask_rel), None, "L")
        size = (self.image_size, self.image_size)
        return {
            "img": resize(img, size, "bilinear"),
            "mask": resize(mask, size, "nearest"),
            "mask_orig": fundus_multilabel(mask).astype(np.uint8),
            "id": self.id_path[index],
        }


class FundusMultiDataset:
    """The train (or test) manifests of the given source domains, with
    cross-domain donor sampling.

    A train item: `img` (S, S, 3) uint8 after `np_transform` (the training
    scale-crop), `mask` (S, S, 2) uint8 [cup, disc], `domain` int32 and,
    with is_freq, `donor` (donor_size^2, 3) uint8, a random train image of
    a source domain other than the item's own under is_out_domain.  With
    resize_to the decode is resized first, through the decode cache.  A test
    item: the original-size `img` and gray `mask`, `mask_orig` (H, W, 2)
    uint8 and the list line as `id`."""

    def __init__(
        self,
        base_dir: str,
        domain_idx_list: Sequence[int],
        split: str = "train",
        num: Optional[int] = None,
        is_freq: bool = True,
        is_out_domain: bool = False,
        test_domain_idx: Optional[int] = None,
        donor_size: int = 256,
        rng: Optional[np.random.Generator] = None,
        resize_to: Optional[int] = None,
        cache: bool = True,
        np_transform=None,
    ):
        self.base_dir = base_dir
        self.domain_idx_list = list(domain_idx_list)
        self.split = split
        self.np_transform = np_transform  # (img_u8, mask_u8, rng) -> (img, mask)
        self.resize_to = resize_to
        self._cache = _DecodeCache() if cache else None
        self.is_freq = is_freq
        self.is_out_domain = is_out_domain
        self.test_domain_idx = test_domain_idx
        self.donor_size = donor_size
        self.rng = rng or np.random.default_rng()
        self.id_path: List[str] = []
        for d in self.domain_idx_list:
            self.id_path += _read_list(os.path.join(base_dir, f"{FUNDUS_DOMAINS[d]}_{split}.list"))
        self.id_path = self.id_path[:num]
        self.train_domains = [
            d for d in FUNDUS_DOMAINS if test_domain_idx is None or d != FUNDUS_DOMAINS[test_domain_idx]
        ]
        self._donor_lists = {}

    def __len__(self) -> int:
        return len(self.id_path)

    def _donor_ids(self, domain_name: str) -> List[str]:
        if domain_name not in self._donor_lists:
            self._donor_lists[domain_name] = _read_list(os.path.join(self.base_dir, domain_name, "train.list"))
        return self._donor_lists[domain_name]

    def _sample_donor(self, cur_domain: str, rng: np.random.Generator) -> np.ndarray:
        pool = [d for d in self.train_domains if not (self.is_out_domain and d == cur_domain)]
        donor_domain = pool[int(rng.integers(0, len(pool)))]
        ids = self._donor_ids(donor_domain)
        donor_id = ids[int(rng.integers(0, len(ids)))].split(" ")[0]
        return _load_resized(self._cache, os.path.join(self.base_dir, donor_domain, donor_id), self.donor_size, "RGB")

    def get_item(self, index: int, rng: Optional[np.random.Generator] = None):
        """Item `index`, its random draws from `rng` (the loaders pass one
        seeded by the sample's position; default the dataset's own)."""
        rng = self.rng if rng is None else rng
        img_rel, mask_rel = self.id_path[index].split(" ")[:2]
        cur_domain = img_rel.split("/")[0]
        if self.split == "test":
            img = _load_resized(None, os.path.join(self.base_dir, img_rel), None, "RGB")
            mask = _load_resized(None, os.path.join(self.base_dir, mask_rel), None, "L")
            return {"img": img, "mask": mask, "mask_orig": fundus_multilabel(mask).astype(np.uint8),
                    "id": self.id_path[index]}
        img = _load_resized(self._cache, os.path.join(self.base_dir, img_rel), self.resize_to, "RGB")
        mask = _load_resized(self._cache, os.path.join(self.base_dir, mask_rel), self.resize_to, "L")
        if self.np_transform is not None:
            img, mask = self.np_transform(img, mask, rng)
        domain = self.domain_idx_list[0] if len(self.domain_idx_list) == 1 else FUNDUS_DOMAINS.index(cur_domain)
        out = {
            "img": np.asarray(img, np.uint8),
            "mask": fundus_multilabel(mask).astype(np.uint8),
            "domain": np.int32(domain),
        }
        if self.is_freq:
            out["donor"] = self._sample_donor(cur_domain, rng)
        return out

    def __getitem__(self, index: int):
        return self.get_item(index)
