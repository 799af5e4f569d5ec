"""Synthetic fundus and prostate data for smoke runs and tests (PyTorch
port of `ramdsir_tpu/data/synthetic.py`).

`fundus_arrays` builds the stacked train arrays and `fundus_test_samples` a
test split in memory, writing nothing; `make_fundus_tree` writes the PNG
tree + .list manifests the fundus reader expects (it needs PIL, imported
inside).  `prostate_arrays` and `prostate_volumes` draw the prostate train
slices and eval volumes in memory; `make_prostate_tree` and
`make_prostate_volumes` write the same draws as the .npy slice tree and the
.nii.gz volumes the JAX package's generators write.
"""
from __future__ import annotations

import os
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ramdsir_tpu_torch.config import FUNDUS_DOMAINS, PROSTATE_DOMAINS, PROSTATE_VOLUME_DOMAINS
from ramdsir_tpu_torch.data.fundus import fundus_multilabel
from ramdsir_tpu_torch.data.nifti import write_nifti


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
    """An in-memory test split of one domain, without PIL: `num` samples
    {img, mask, mask_orig, id} as `data.fundus.FundusDataset` gives them,
    drawn by `_fundus_pair` at size x size.  `img` is resized to image_size
    by torch's antialiased bilinear resize (PIL's bilinear filter is
    antialiased too, the values differ slightly), `mask` by PIL's nearest
    rule."""
    rng = np.random.default_rng(seed)
    near = np.floor((np.arange(image_size) + 0.5) * size / image_size).astype(np.int64)
    samples = []
    for i in range(num):
        img, mask = _fundus_pair(rng, size)
        x = torch.from_numpy(img).permute(2, 0, 1)[None].float()
        small = F.interpolate(x, size=(image_size, image_size), mode="bilinear", align_corners=False, antialias=True)
        samples.append({
            "img": small[0].permute(1, 2, 0).round().clamp(0, 255).to(torch.uint8).numpy(),
            "mask": mask[near][:, near],
            "mask_orig": fundus_multilabel(mask).astype(np.uint8),
            "id": f"test/image/{i:03d}.png test/mask/{i:03d}.png",
        })
    return samples


def make_fundus_tree(
    root: str,
    per_domain_train: int = 6,
    per_domain_test: int = 3,
    size: int = 96,
    seed: int = 0,
    domains: Sequence[str] = tuple(FUNDUS_DOMAINS),
) -> str:
    from PIL import Image

    rng = np.random.default_rng(seed)
    base = os.path.join(root, "fundus")
    for dom in domains:
        for split, n in [("train", per_domain_train), ("test", per_domain_test)]:
            img_dir = os.path.join(base, dom, split, "image")
            mask_dir = os.path.join(base, dom, split, "mask")
            os.makedirs(img_dir, exist_ok=True)
            os.makedirs(mask_dir, exist_ok=True)
            lines_local, lines_global = [], []
            for i in range(n):
                img, mask = _fundus_pair(rng, size)
                rel_img = f"{split}/image/{i:03d}.png"
                rel_mask = f"{split}/mask/{i:03d}.png"
                Image.fromarray(img).save(os.path.join(base, dom, rel_img))
                Image.fromarray(mask).save(os.path.join(base, dom, rel_mask))
                lines_local.append(f"{rel_img} {rel_mask}")
                lines_global.append(f"{dom}/{rel_img} {dom}/{rel_mask}")
            with open(os.path.join(base, dom, f"{split}.list"), "w") as f:
                f.write("\n".join(lines_local) + "\n")
            with open(os.path.join(base, f"{dom}_{split}.list"), "w") as f:
                f.write("\n".join(lines_global) + "\n")
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
