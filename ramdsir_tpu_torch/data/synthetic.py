"""Synthetic fundus and prostate data for smoke runs and tests (PyTorch
port of `ramdsir_tpu/data/synthetic.py`).

`fundus_arrays` builds the stacked train arrays and `fundus_test_samples` a
test split in memory, writing nothing; `make_fundus_tree` writes the PNG
tree + .list manifests the fundus reader expects, through the port's own PNG
encoder.  `prostate_arrays` and `prostate_volumes` draw the prostate train
slices and eval volumes in memory; `make_prostate_tree` and
`make_prostate_volumes` write the same draws as the .npy slice tree and the
.nii.gz volumes the JAX package's generators write.
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Mapping, Sequence, Tuple, Union

import numpy as np

from ramdsir_tpu_torch.config import FUNDUS_DOMAINS, PROSTATE_DOMAINS, PROSTATE_VOLUME_DOMAINS
from ramdsir_tpu_torch.data import png
from ramdsir_tpu_torch.data.fundus import fundus_multilabel
from ramdsir_tpu_torch.data.nifti import write_nifti
from ramdsir_tpu_torch.ops.image import resize

# the gray levels of a fundus mask, as a palette (index 0, 1, 2 -> 0, 128, 255)
MASK_PALETTE = np.array([[0, 0, 0], [128, 128, 128], [255, 255, 255]], np.uint8)


def _fundus_pair(rng: np.random.Generator, size: int):
    """A blobby RGB 'fundus' + gray mask (255 bg / 128 disc / 0 cup)."""
    img = rng.integers(30, 220, (size, size, 3), dtype=np.uint8)
    yy, xx = np.mgrid[:size, :size]
    cy, cx = rng.integers(size // 3, 2 * size // 3, 2)
    r_disc = size // rng.integers(4, 7)
    r_cup = max(2, int(r_disc * rng.uniform(0.3, 0.7)))
    d2 = (yy - cy) ** 2 + (xx - cx) ** 2
    mask = np.full((size, size), 255, np.uint8)
    mask[d2 < r_disc**2] = 128
    mask[d2 < r_cup**2] = 0
    img[d2 < r_disc**2] = (img[d2 < r_disc**2] * 0.5 + 120).astype(np.uint8)
    return img, mask


def fundus_arrays(
    per_domain_train: int = 64,
    size: int = 256,
    seed: int = 0,
    domains: Sequence[str] = tuple(FUNDUS_DOMAINS),
) -> Dict[str, Dict[str, np.ndarray]]:
    """In-memory synthetic train sets: {domain: {"images": (N, S, S, 3) u8,
    "masks": (N, S, S) u8 gray}} with the images `make_fundus_tree` would
    draw (not the same draws: the tree also draws test images)."""
    rng = np.random.default_rng(seed)
    out = {}
    for dom in domains:
        pairs = [_fundus_pair(rng, size) for _ in range(per_domain_train)]
        out[dom] = {
            "images": np.stack([p[0] for p in pairs]),
            "masks": np.stack([p[1] for p in pairs]),
        }
    return out


def fundus_test_samples(
    num: int = 50, size: int = 512, image_size: int = 256, seed: int = 0
) -> List[Dict]:
    """An in-memory test split of one domain: `num` samples {img, mask,
    mask_orig, id} as `data.fundus.FundusDataset` gives them for the same
    pairs written as PNGs, drawn by `_fundus_pair` at size x size."""
    rng = np.random.default_rng(seed)
    out_size = (image_size, image_size)
    samples = []
    for i in range(num):
        img, mask = _fundus_pair(rng, size)
        samples.append({
            "img": resize(img, out_size, "bilinear"),
            "mask": resize(mask, out_size, "nearest"),
            "mask_orig": fundus_multilabel(mask).astype(np.uint8),
            "id": f"test/image/{i:03d}.png test/mask/{i:03d}.png",
        })
    return samples


def fundus_tree_pairs(
    per_domain_train: int = 6,
    per_domain_test: Union[int, Mapping[str, int]] = 3,
    size: int = 96,
    seed: int = 0,
    domains: Sequence[str] = tuple(FUNDUS_DOMAINS),
) -> Iterator[Tuple[str, str, int, np.ndarray, np.ndarray]]:
    """(domain, split, index, image, gray mask) of every pair
    `make_fundus_tree` writes, in its order: per domain the train split,
    then the test split (per_domain_test: one count, or one per domain)."""
    rng = np.random.default_rng(seed)
    for dom in domains:
        n_test = per_domain_test if isinstance(per_domain_test, int) else per_domain_test[dom]
        for split, n in (("train", per_domain_train), ("test", n_test)):
            for i in range(n):
                yield (dom, split, i) + _fundus_pair(rng, size)


def make_fundus_tree(
    root: str,
    per_domain_train: int = 6,
    per_domain_test: Union[int, Mapping[str, int]] = 3,
    size: int = 96,
    seed: int = 0,
    domains: Sequence[str] = tuple(FUNDUS_DOMAINS),
    filter_types: Sequence[Union[int, str]] = (png.ADAPTIVE,),
    palette_mask_domains: Sequence[str] = (),
) -> str:
    """`fundus_tree_pairs` written as `root/fundus/DomainX/{train,test}/
    {image,mask}/NNN.png` with the manifests: the JAX package's tree, the
    same draws, names and lists.  The n-th file written takes
    filter_types[n % len(filter_types)] (a PNG row filter, data/png.py);
    masks of `palette_mask_domains` are palette images over MASK_PALETTE,
    which decode to the same gray values.  The draws are sequential; the
    files are encoded on a few threads (zlib and numpy release the GIL)."""
    base = os.path.join(root, "fundus")
    for dom in domains:
        for split in ("train", "test"):
            os.makedirs(os.path.join(base, dom, split, "image"), exist_ok=True)
            os.makedirs(os.path.join(base, dom, split, "mask"), exist_ok=True)
    lines: Dict[Tuple[str, str], List[str]] = {}
    written = []
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        for dom, split, i, img, mask in fundus_tree_pairs(per_domain_train, per_domain_test, size, seed, domains):
            rel_img, rel_mask = f"{split}/image/{i:03d}.png", f"{split}/mask/{i:03d}.png"
            lines.setdefault((dom, split), []).append((rel_img, rel_mask))
            kw = {}
            if dom in palette_mask_domains:
                mask, kw = np.searchsorted(MASK_PALETTE[:, 0], mask).astype(np.uint8), {"palette": MASK_PALETTE}
            for rel, arr, extra in ((rel_img, img, {}), (rel_mask, mask, kw)):
                ft = filter_types[len(written) % len(filter_types)]
                written.append(pool.submit(png.write, os.path.join(base, dom, rel), arr, filter_type=ft, **extra))
        for job in written:
            job.result()  # raises what a write raised
    for dom in domains:
        for split in ("train", "test"):
            pairs = lines.get((dom, split), [])
            with open(os.path.join(base, dom, f"{split}.list"), "w") as f:
                f.write("\n".join(f"{a} {b}" for a, b in pairs) + "\n")
            with open(os.path.join(base, f"{dom}_{split}.list"), "w") as f:
                f.write("\n".join(f"{dom}/{a} {dom}/{b}" for a, b in pairs) + "\n")
    return base


def prostate_arrays(
    per_domain: int = 40,
    size: int = 384,
    seed: int = 0,
    domains: Sequence[str] = tuple(PROSTATE_DOMAINS),
) -> Dict[str, Dict[str, np.ndarray]]:
    """In-memory prostate train slices: {domain: {"images": (N, S, S, 3)
    float32 in [-1, 1], "masks": (N, S, S) int64 0/1}}, a disc of brighter
    foreground on uniform noise, the draws `make_prostate_tree` writes."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:size, :size]
    out = {}
    for dom in domains:
        imgs, masks = [], []
        for _ in range(per_domain):
            img = rng.uniform(-1, 0.2, (size, size, 3)).astype(np.float32)
            cy, cx = rng.integers(size // 3, 2 * size // 3, 2)
            r = size // rng.integers(4, 7)
            mask = (((yy - cy) ** 2 + (xx - cx) ** 2) < r * r).astype(np.int64)
            img[mask > 0] += 0.8  # learnable signal: the foreground is brighter
            imgs.append(np.clip(img, -1, 1))
            masks.append(mask)
        out[dom] = {"images": np.stack(imgs), "masks": np.stack(masks)}
    return out


def make_prostate_tree(
    root: str,
    per_domain: int = 6,
    size: int = 64,
    seed: int = 0,
    domains: Sequence[str] = tuple(PROSTATE_DOMAINS),
) -> str:
    """`prostate_arrays` written as `root/prostate/DomainX/{image,mask}/*.npy`."""
    base = os.path.join(root, "prostate")
    for dom, arrays in prostate_arrays(per_domain, size, seed, domains).items():
        for sub in ("image", "mask"):
            os.makedirs(os.path.join(base, dom, sub), exist_ok=True)
        for i, (img, mask) in enumerate(zip(arrays["images"], arrays["masks"])):
            np.save(os.path.join(base, dom, "image", f"{dom}_{i:03d}.npy"), img)
            np.save(os.path.join(base, dom, "mask", f"{dom}_{i:03d}.npy"), mask)
    return base


def prostate_volumes(
    per_domain: int = 1,
    depth: int = 12,
    size: int = 64,
    seed: int = 0,
    domains: Sequence[str] = tuple(PROSTATE_VOLUME_DOMAINS),
) -> Dict[str, List[Tuple[str, np.ndarray, np.ndarray]]]:
    """In-memory eval volumes {domain: [(file name, image (D, S, S) float32
    in [0, 600), mask (D, S, S) uint8)]}: a centred disc, brighter, on the
    middle half of the slices."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:size, :size]
    disc = ((yy - size // 2) ** 2 + (xx - size // 2) ** 2) < (size // 5) ** 2
    out = {}
    for dom in domains:
        out[dom] = []
        for i in range(per_domain):
            vol = rng.uniform(0, 400, (depth, size, size)).astype(np.float32)
            mask = np.zeros((depth, size, size), np.uint8)
            mask[depth // 4 : 3 * depth // 4, disc] = 1
            vol[mask > 0] += 200
            out[dom].append((f"Case{i:02d}.nii.gz", vol, mask))
    return out


def make_prostate_volumes(
    root: str,
    per_domain: int = 1,
    depth: int = 12,
    size: int = 64,
    seed: int = 0,
    domains: Sequence[str] = tuple(PROSTATE_VOLUME_DOMAINS),
    base_name: str = "prostate",
) -> str:
    """`prostate_volumes` written as `root/<base_name>/<domain>/CaseNN.nii.gz`
    and `CaseNN_segmentation.nii.gz`."""
    base = os.path.join(root, base_name)
    for dom, cases in prostate_volumes(per_domain, depth, size, seed, domains).items():
        os.makedirs(os.path.join(base, dom), exist_ok=True)
        for name, vol, mask in cases:
            write_nifti(os.path.join(base, dom, name), vol)
            write_nifti(os.path.join(base, dom, name.replace(".nii.gz", "_segmentation.nii.gz")), mask)
    return base
