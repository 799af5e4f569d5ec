"""The benchmark's inputs, made from a seed: synthetic fundus and prostate
images with their masks (frozen copies of the port's synthetic generators'
scheme: a brighter disc, and for fundus a cup inside it, on noise), drawn
on the card from a `torch.Generator` in a few large calls; and the files
the eval cells read, written by the benchmark's own encoders: PNG (8-bit
gray or RGB, filter type 0, zlib) and NIfTI-1 (.nii.gz)."""
from __future__ import annotations

import gzip
import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch


def _discs(gen: torch.Generator, n: int, size: int, device, fixed: bool = False):
    """Per image a centre in [S/3, 2S/3) and a radius S // k, k in {4, 5, 6}:
    (squared distance (n, S, S) to the centre, radius (n,)).  fixed: every
    seed the same radii (k = 4, 5, 6, 4, ... over the images), in an order
    of its own, so that the seed moves the discs but not the work."""
    c = torch.randint(size // 3, 2 * size // 3, (n, 2), generator=gen, device=device)
    if fixed:
        k = 4 + torch.arange(n, device=device) % 3
        r = size // k[torch.randperm(n, generator=gen, device=device)]
    else:
        r = size // torch.randint(4, 7, (n,), generator=gen, device=device)
    i = torch.arange(size, device=device)
    d2 = (i[None, :, None] - c[:, 0, None, None]) ** 2 + (i[None, None, :] - c[:, 1, None, None]) ** 2
    return d2, r


def fundus_pairs(seed: int, n: int, size: int, device, chunk: int = 64,
                 fixed: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    """n RGB images (n, S, S, 3) uint8 and gray masks (n, S, S) uint8 (255
    background, 128 disc, 0 cup), host arrays drawn on `device`; fixed: the
    same disc radii and cup fractions (0.3 to 0.7 evenly) for every seed,
    permuted, over each chunk of images."""
    gen = torch.Generator(device=device).manual_seed(seed)
    imgs, masks = [], []
    for start in range(0, n, chunk):
        m = min(chunk, n - start)
        img = torch.randint(30, 220, (m, size, size, 3), generator=gen, device=device, dtype=torch.uint8)
        d2, r_disc = _discs(gen, m, size, device, fixed)
        if fixed:
            frac = 0.3 + 0.4 * (torch.arange(m, device=device) + 0.5) / m
            frac = frac[torch.randperm(m, generator=gen, device=device)]
        else:
            frac = 0.3 + 0.4 * torch.rand(m, generator=gen, device=device)
        r_cup = torch.clamp((r_disc * frac).long(), min=2)
        disc = d2 < (r_disc**2)[:, None, None]
        cup = d2 < (r_cup**2)[:, None, None]
        mask = torch.full((m, size, size), 255, dtype=torch.uint8, device=device)
        mask[disc] = 128
        mask[cup] = 0
        img = torch.where(disc[..., None], (img.float() * 0.5 + 120).to(torch.uint8), img)
        imgs.append(img.cpu().numpy())
        masks.append(mask.cpu().numpy())
    return np.concatenate(imgs), np.concatenate(masks)


def prostate_slices(seed: int, n: int, size: int, device, chunk: int = 128) -> Tuple[np.ndarray, np.ndarray]:
    """n slices (n, S, S, 3) float32 in [-1, 1] (noise in [-1, 0.2), the
    disc brighter by 0.8) and masks (n, S, S) int64 0/1."""
    gen = torch.Generator(device=device).manual_seed(seed)
    imgs, masks = np.empty((n, size, size, 3), np.float32), np.empty((n, size, size), np.int64)
    for start in range(0, n, chunk):
        m = min(chunk, n - start)
        img = torch.rand((m, size, size, 3), generator=gen, device=device) * 1.2 - 1.0
        d2, r = _discs(gen, m, size, device)
        mask = d2 < (r**2)[:, None, None]
        img = torch.clamp(img + 0.8 * mask[..., None], -1.0, 1.0)
        imgs[start : start + m] = img.cpu().numpy()
        masks[start : start + m] = mask.cpu().numpy()
    return imgs, masks


def prostate_volumes(seed: int, n: int, depth: int, size: int, device) -> List[Tuple[np.ndarray, np.ndarray]]:
    """n (image (D, S, S) int16 in [0, 600), mask (D, S, S) uint8) volumes:
    noise, and on the middle half of the slices a disc of random centre,
    brighter by 200; every seed the same radii (`_discs`, fixed), permuted."""
    gen = torch.Generator(device=device).manual_seed(seed)
    d2s, rs = _discs(gen, n, size, device, fixed=True)
    out = []
    for i in range(n):
        vol = torch.randint(0, 400, (depth, size, size), generator=gen, device=device, dtype=torch.int16)
        disc = d2s[i] < rs[i] ** 2
        mask = torch.zeros((depth, size, size), dtype=torch.uint8, device=device)
        mask[depth // 4 : 3 * depth // 4] = disc.to(torch.uint8)
        vol = vol + 200 * mask.to(torch.int16)
        out.append((vol.cpu().numpy(), mask.cpu().numpy()))
    return out


# --- file writers ---------------------------------------------------------------------


def _png_chunk(ctype: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + ctype + body + struct.pack(">I", zlib.crc32(ctype + body))


def png_bytes(a: np.ndarray, level: int = 1) -> bytes:
    """An 8-bit gray (H, W) or RGB (H, W, 3) image as PNG: every row filter
    type 0, one IDAT chunk."""
    a = np.ascontiguousarray(a, np.uint8)
    h, w = a.shape[:2]
    colour = 0 if a.ndim == 2 else 2
    raw = np.concatenate([np.zeros((h, 1), np.uint8), a.reshape(h, -1)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0)
    return b"".join([b"\x89PNG\r\n\x1a\n", _png_chunk(b"IHDR", ihdr),
                     _png_chunk(b"IDAT", zlib.compress(raw.tobytes(), level)), _png_chunk(b"IEND", b"")])


def nifti_gz(path: str, a: np.ndarray) -> None:
    """A (z, y, x) uint8 or int16 array as a single-file NIfTI-1 .nii.gz
    (unit voxels, no scaling, gzip level 1)."""
    codes = {np.dtype(np.uint8): 2, np.dtype(np.int16): 4}
    a = np.ascontiguousarray(a)
    shape = a.shape[::-1]
    hdr = bytearray(348)
    struct.pack_into("<i", hdr, 0, 348)
    struct.pack_into("<8h", hdr, 40, len(shape), *shape, *[1] * (7 - len(shape)))
    struct.pack_into("<hh", hdr, 70, codes[a.dtype], a.dtype.itemsize * 8)
    struct.pack_into("<8f", hdr, 76, 1.0, *[1.0] * 7)
    struct.pack_into("<3f", hdr, 108, 352.0, 1.0, 0.0)
    hdr[344:348] = b"n+1\x00"
    with gzip.open(path, "wb", compresslevel=1) as f:
        f.write(bytes(hdr) + b"\x00" * 4 + a.tobytes())


WRITERS = 4  # threads encoding files at set-up


def _write(path: str, arr: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(png_bytes(arr))


def write_fundus_test_tree(root: str, domain: str, images: Sequence[np.ndarray], masks: Sequence[np.ndarray]) -> str:
    """`root/fundus/<domain>/test/{image,mask}/NNN.png` with the domain's
    test.list (paths relative to the domain's directory)."""
    base = os.path.join(root, "fundus", domain)
    for sub in ("image", "mask"):
        os.makedirs(os.path.join(base, "test", sub), exist_ok=True)
    lines, jobs = [], []
    with ThreadPoolExecutor(WRITERS) as pool:  # zlib releases the interpreter lock
        for i, (img, mask) in enumerate(zip(images, masks)):
            rel_i, rel_m = f"test/image/{i:03d}.png", f"test/mask/{i:03d}.png"
            for rel, arr in ((rel_i, img), (rel_m, mask)):
                jobs.append(pool.submit(_write, os.path.join(base, rel), arr))
            lines.append(f"{rel_i} {rel_m}")
        for job in jobs:
            job.result()
    with open(os.path.join(base, "test.list"), "w") as f:
        f.write("\n".join(lines) + "\n")
    return base


def write_prostate_volumes(root: str, domain: str, volumes: Sequence[Tuple[np.ndarray, np.ndarray]]) -> str:
    """`root/prostate/<domain>/CaseNN.nii.gz` and `CaseNN_segmentation.nii.gz`."""
    base = os.path.join(root, "prostate", domain)
    os.makedirs(base, exist_ok=True)
    with ThreadPoolExecutor(WRITERS) as pool:
        jobs = [pool.submit(nifti_gz, os.path.join(base, f"Case{i:02d}{tag}.nii.gz"), arr)
                for i, (vol, mask) in enumerate(volumes) for tag, arr in (("", vol), ("_segmentation", mask))]
        for job in jobs:
            job.result()
    return base


# --- the epoch plans ------------------------------------------------------------------------


class EpochPlanner:
    """Index plans in the device pipeline's format, {img_idx, donor_idx}
    (steps, B) int32 per epoch: per source domain a shuffle without
    replacement, batches of its sub-batch size, a domain that runs out
    reshuffled; the longest domain sets the epoch (reference train.py's
    cycling loaders, drop_last).  Donors uniform over the train domains
    other than the sample's own (is_out_domain), then uniform within."""

    def __init__(self, sizes: Sequence[int], batch_sizes: Sequence[int], is_out_domain: bool, seed: int):
        self.sizes, self.bs = list(sizes), list(batch_sizes)
        self.starts = np.cumsum([0] + self.sizes[:-1]).tolist()
        self.is_out_domain = is_out_domain
        self.rng = np.random.default_rng(seed)
        self.steps = max(n // b for n, b in zip(self.sizes, self.bs))

    def epoch(self) -> Dict[str, np.ndarray]:
        steps, total = self.steps, sum(self.bs)
        img = np.empty((steps, total), np.int32)
        donor = np.empty((steps, total), np.int32)
        orders = [self.rng.permutation(n) for n in self.sizes]
        pos = [0] * len(self.sizes)
        for s in range(steps):
            col = 0
            for d, b in enumerate(self.bs):
                if pos[d] + b > self.sizes[d]:
                    orders[d], pos[d] = self.rng.permutation(self.sizes[d]), 0
                img[s, col : col + b] = self.starts[d] + orders[d][pos[d] : pos[d] + b]
                pos[d] += b
                col += b
        col = 0
        for d, b in enumerate(self.bs):
            pool = [p for p in range(len(self.sizes)) if not (self.is_out_domain and p == d)]
            dom = np.asarray(pool)[self.rng.integers(0, len(pool), size=(steps, b))]
            u = self.rng.random((steps, b))
            donor[:, col : col + b] = np.asarray(self.starts)[dom] + (u * np.asarray(self.sizes)[dom]).astype(np.int64)
            col += b
        return {"img_idx": img, "donor_idx": donor}
