"""Device-resident training data (PyTorch port of
`ramdsir_tpu/data/device_pipeline.py`).

The whole source-domain train set lives on the device, so the host's
per-step work is two (B,) index vectors: the gather, the fundus random
scale-crop and the donor lookup run on the device.  Fundus keeps uint8
images (all four domains at 256^2 are ~92 MB); prostate keeps one float32
slice stack (no exact uint8 form) that is also its donor pool, and applies
no augmentation.  Epochs follow the reference (train.py:549-566): per-domain
shuffle without replacement with drop_last, the longest domain sets the
epoch, shorter domains reshuffle and cycle; donors are uniform over the
train domains (excluding the sample's own under is_out_domain).

Layout: the device arrays are NCHW; the batch dicts handed to the train
step are NHWC, as in the JAX package (views of NCHW memory).
"""
from __future__ import annotations

import os
from typing import Dict, List, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from ramdsir_tpu_torch.config import FUNDUS_DOMAINS, PROSTATE_DOMAINS
from ramdsir_tpu_torch.data.fundus import _load_resized, _read_list, fundus_multilabel
from ramdsir_tpu_torch.data.prostate import load_slice, slice_names
from ramdsir_tpu_torch.utils.device import resolve_device


def stack_fundus_domains(datasets: Sequence, size: int):
    """Decode every train image/mask of each per-domain dataset into stacked
    uint8 arrays: (images (N,S,S,3), masks (N,S,S,2) multilabel,
    domain_offsets [start0, start1, ..., N])."""
    imgs, msks, offsets = [], [], [0]
    for ds in datasets:
        for entry_line in ds.id_path:
            entry = entry_line.split(" ")
            imgs.append(_load_resized(os.path.join(ds.base_dir, entry[0]), size, "RGB"))
            gray = _load_resized(os.path.join(ds.base_dir, entry[1]), size, "L")
            msks.append(fundus_multilabel(gray).astype(np.uint8))
        offsets.append(len(imgs))
    return np.stack(imgs), np.stack(msks), offsets


def stack_donor_pool(base_dir: str, train_domains: Sequence[str], size: int):
    """Donor images per train domain (`DomainX/train.list`), stacked, with
    {domain: (start, count)}."""
    donors, offsets = [], {}
    for d in train_domains:
        ids = _read_list(os.path.join(base_dir, d, "train.list"))
        offsets[d] = (len(donors), len(ids))
        for line in ids:
            donors.append(_load_resized(os.path.join(base_dir, d, line.split(" ")[0]), size, "RGB"))
    return np.stack(donors), offsets


def _train_domains(test_domain_idx: Optional[int], domains: Sequence[str] = FUNDUS_DOMAINS) -> List[str]:
    return [d for d in domains if test_domain_idx is None or d != domains[test_domain_idx]]


class _EpochPlanner:
    """The epoch plan of both pipelines.  starts/sizes: each source domain's
    first row and row count in the image stack, in `ds_domains` order;
    donor_offsets: {train domain: (first row, count)} in the donor pool."""

    def __init__(
        self,
        batch_sizes: Sequence[int],
        ds_domains: Sequence[str],
        train_domains: Sequence[str],
        starts: Sequence[int],
        sizes: Sequence[int],
        donor_offsets: Mapping[str, tuple],
        is_out_domain: bool,
        seed: Optional[int],
    ):
        self.batch_sizes = list(batch_sizes)
        self.ds_domains = list(ds_domains)
        self.train_domains = list(train_domains)
        self._starts, self._sizes = list(starts), list(sizes)
        self.donor_offsets = dict(donor_offsets)
        self.is_out_domain = is_out_domain
        self.rng = np.random.default_rng(seed)
        self._base_seed = seed if seed is not None else 0
        self._epoch = 0
        for dom, n, bs in zip(self.ds_domains, self._sizes, self.batch_sizes):
            if n < bs:
                raise ValueError(f"domain {dom}: {n} images < batch {bs}")
        self.steps_per_epoch = max(n // bs for n, bs in zip(self._sizes, self.batch_sizes))

    def __len__(self) -> int:
        return self.steps_per_epoch

    def epoch_plan(self) -> Dict[str, np.ndarray]:
        """The whole epoch's index plan as (steps_per_epoch, B) int32 arrays
        (the JAX package's plan, draw for draw)."""
        epoch = self._epoch
        self._epoch += 1
        spe = self.steps_per_epoch
        orders = [self.rng.permutation(n) for n in self._sizes]
        pos = [0] * len(orders)
        img_plan = np.empty((spe, sum(self.batch_sizes)), np.int32)
        donor_plan = np.empty_like(img_plan)
        for s in range(spe):
            img_idx = []
            for d, bs in enumerate(self.batch_sizes):
                if pos[d] + bs > len(orders[d]):
                    orders[d] = self.rng.permutation(self._sizes[d])
                    pos[d] = 0
                rows = orders[d][pos[d] : pos[d] + bs]
                pos[d] += bs
                img_idx.extend(self._starts[d] + rows)
            img_plan[s] = img_idx
        # donors: one (seed, epoch)-seeded draw per domain per epoch, uniform
        # over the donor domains, then uniform within the chosen one
        drng = np.random.default_rng((self._base_seed, epoch))
        col = 0
        for d, bs in enumerate(self.batch_sizes):
            cur = self.ds_domains[d]
            pool = [dom for dom in self.train_domains if not (self.is_out_domain and dom == cur)]
            starts = np.array([self.donor_offsets[p][0] for p in pool])
            ns = np.array([self.donor_offsets[p][1] for p in pool])
            dom = drng.integers(0, len(pool), size=(spe, bs))
            u = drng.random((spe, bs))
            donor_plan[:, col : col + bs] = starts[dom] + (u * ns[dom]).astype(np.int64)
            col += bs
        return {"img_idx": img_plan, "donor_idx": donor_plan}

    def __iter__(self):
        plan = self.epoch_plan()
        for s in range(self.steps_per_epoch):
            yield {k: v[s] for k, v in plan.items()}


class DeviceFundusPipeline(_EpochPlanner):
    """Index planner + device arrays.

    Iterating yields per-step dicts {img_idx (B,), donor_idx (B,)} of int32
    numpy rows; `gather_and_augment` turns one into a batch on the device.
    """

    def __init__(
        self,
        images: np.ndarray,
        masks: np.ndarray,
        offsets: Sequence[int],
        donors: np.ndarray,
        donor_offsets: Mapping[str, tuple],
        ds_domains: Sequence[str],
        train_domains: Sequence[str],
        batch_sizes: Sequence[int],
        *,
        is_out_domain: bool = False,
        seed: Optional[int] = None,
        precompute_donor_amp: bool = True,
        device: Union[str, torch.device] = "cuda",
    ):
        """images (N,S,S,3) u8 and masks (N,S,S,2) u8 multilabel of the
        source domains, in `ds_domains` order with `offsets`; donors
        (M,S,S,3) u8 of `train_domains` with `donor_offsets`."""
        dev = resolve_device(device)
        self.offsets = list(offsets)
        super().__init__(
            batch_sizes, ds_domains, train_domains, self.offsets[:-1], np.diff(self.offsets).tolist(),
            donor_offsets, is_out_domain, seed,
        )

        to_dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev).permute(0, 3, 1, 2).contiguous()
        self.device_data: Dict[str, torch.Tensor] = {"images": to_dev(images), "masks": to_dev(masks)}
        if precompute_donor_amp:
            # the donor pool is fixed for the run: its banded amplitudes once,
            # instead of a donor rfft2 in every step
            from ramdsir_tpu_torch.ops.ram import banded_amplitude_spectrum

            pool = torch.from_numpy(np.ascontiguousarray(donors)).to(dev)
            self.device_data["donor_amp"] = banded_amplitude_spectrum(pool)
        else:
            self.device_data["donors"] = to_dev(donors)

    @classmethod
    def from_tree(
        cls,
        datasets: Sequence,
        batch_sizes: Sequence[int],
        base_dir: str,
        size: int,
        test_domain_idx: Optional[int],
        **kwargs,
    ) -> "DeviceFundusPipeline":
        """Read the PNG tree (one `FundusMultiDataset` per source domain),
        as the JAX package's constructor does."""
        images, masks, offsets = stack_fundus_domains(datasets, size)
        train_domains = _train_domains(test_domain_idx)
        donors, donor_offsets = stack_donor_pool(base_dir, train_domains, size)
        ds_domains = [FUNDUS_DOMAINS[ds.domain_idx_list[0]] for ds in datasets]
        return cls(images, masks, offsets, donors, donor_offsets, ds_domains, train_domains, batch_sizes, **kwargs)

    @classmethod
    def from_arrays(
        cls,
        domain_arrays: Mapping[str, Mapping[str, np.ndarray]],
        domain_idxs: Sequence[int],
        batch_sizes: Sequence[int],
        test_domain_idx: Optional[int],
        **kwargs,
    ) -> "DeviceFundusPipeline":
        """In-memory train sets {"DomainX": {"images": (N,S,S,3) u8,
        "masks": (N,S,S) u8 gray}} for every train domain (as
        `data.synthetic.fundus_arrays` makes them); each domain's images are
        both its training samples and its donor pool."""
        ds_domains = [FUNDUS_DOMAINS[d] for d in domain_idxs]
        train_domains = _train_domains(test_domain_idx)
        images = np.concatenate([domain_arrays[d]["images"] for d in ds_domains])
        masks = np.concatenate(
            [np.stack([fundus_multilabel(g) for g in domain_arrays[d]["masks"]]) for d in ds_domains]
        ).astype(np.uint8)
        offsets = np.cumsum([0] + [len(domain_arrays[d]["images"]) for d in ds_domains]).tolist()
        donors = np.concatenate([domain_arrays[d]["images"] for d in train_domains])
        starts = np.cumsum([0] + [len(domain_arrays[d]["images"]) for d in train_domains])
        donor_offsets = {d: (int(starts[i]), len(domain_arrays[d]["images"])) for i, d in enumerate(train_domains)}
        return cls(images, masks, offsets, donors, donor_offsets, ds_domains, train_domains, batch_sizes, **kwargs)


def sample_crop_draws(generator: torch.Generator, batch: int) -> Dict[str, torch.Tensor]:
    """The scale-crop's random draws: apply ~ Bernoulli(0.5), factors
    u ~ U(1, 1.5) for (h, w), offsets ~ U(0, 1) for (y, x); on the
    generator's device."""
    kw = dict(generator=generator, device=generator.device)
    return {
        "crop_apply": torch.rand(batch, **kw) < 0.5,
        "crop_u": 1.0 + 0.5 * torch.rand(batch, 2, **kw),
        "crop_off": torch.rand(batch, 2, **kw),
    }


def resample_crop(imgs, masks, fy, fx, y0, x0, size: int):
    """Crop window [y0:y0+S, x0:x0+S] of each (virtually) fy/fx-upscaled
    image: bilinear for images (cv2 half-pixel mapping), nearest for masks.
    The batched counterpart of the JAX package's `_resample_one`, by
    gathers instead of one-hot products.

    imgs (B,S,S,C) float or uint8, masks (B,S,S,K) uint8, fy/fx/y0/x0 (B,)
    float32.  Returns (float32 images, masks in their dtype), NHWC.
    """
    b = imgs.shape[0]
    i = torch.arange(size, dtype=torch.float32, device=imgs.device)
    sy = ((y0[:, None] + i + 0.5) / fy[:, None] - 0.5).clamp(0.0, size - 1.0)  # (B, S)
    sx = ((x0[:, None] + i + 0.5) / fx[:, None] - 0.5).clamp(0.0, size - 1.0)
    y0f, x0f = sy.floor(), sx.floor()
    wy, wx = sy - y0f, sx - x0f
    y0i, x0i = y0f.long(), x0f.long()
    y1i, x1i = (y0i + 1).clamp(max=size - 1), (x0i + 1).clamp(max=size - 1)

    def pick_rows(t, idx):  # t (B, C, S, S), idx (B, S) over H
        return torch.gather(t, 2, idx[:, None, :, None].expand(b, t.shape[1], size, t.shape[3]))

    def pick_cols(t, idx):  # idx (B, S) over W
        return torch.gather(t, 3, idx[:, None, None, :].expand(b, t.shape[1], t.shape[2], size))

    x = imgs.permute(0, 3, 1, 2).float()
    ry, rx = wy[:, None, :, None], wx[:, None, None, :]
    rows = pick_rows(x, y0i) * (1.0 - ry) + pick_rows(x, y1i) * ry
    out = pick_cols(rows, x0i) * (1.0 - rx) + pick_cols(rows, x1i) * rx

    my = sy.round().clamp(0, size - 1).long()
    mx = sx.round().clamp(0, size - 1).long()
    mout = pick_cols(pick_rows(masks.permute(0, 3, 1, 2), my), mx)
    return out.permute(0, 2, 3, 1), mout.permute(0, 2, 3, 1)


def device_scale_crop(imgs, masks, draws: Mapping[str, torch.Tensor], size: int):
    """Batched RandomScaleCrop: with probability 0.5 keep the image, else
    upscale to integer dims floor(U(1,1.5)*S) and take a uniform random
    S x S crop.  imgs/masks NHWC; draws from `sample_crop_draws`."""
    apply, u, off_u = draws["crop_apply"], draws["crop_u"], draws["crop_off"]
    tgt = torch.floor(u * size)  # integer scaled dims (h', w') as float
    one, zero = torch.ones_like(tgt[:, 0]), torch.zeros_like(tgt[:, 0])
    fy = torch.where(apply, tgt[:, 0] / size, one)
    fx = torch.where(apply, tgt[:, 1] / size, one)
    # crop offset ~ randint(0, h' - S + 1)
    y0 = torch.where(apply, torch.floor(off_u[:, 0] * (tgt[:, 0] - size + 1)), zero)
    x0 = torch.where(apply, torch.floor(off_u[:, 1] * (tgt[:, 1] - size + 1)), zero)
    return resample_crop(imgs, masks, fy, fx, y0, x0, size)


def gather_and_augment(
    device_data: Mapping[str, torch.Tensor],
    img_idx: torch.Tensor,
    donor_idx: torch.Tensor,
    draws: Mapping[str, torch.Tensor],
    size: int,
) -> Dict[str, torch.Tensor]:
    """Indices -> the batch dict the train step takes (NHWC): img float
    [0,255], mask float multilabel, and the donor image [0,255] or its
    precomputed banded amplitudes."""
    imgs = device_data["images"].index_select(0, img_idx).permute(0, 2, 3, 1)
    masks = device_data["masks"].index_select(0, img_idx).permute(0, 2, 3, 1)
    out_i, out_m = device_scale_crop(imgs, masks, draws, size)
    batch = {"img": out_i, "mask": out_m.float()}
    if "donor_amp" in device_data:
        batch["donor_amp"] = device_data["donor_amp"].index_select(0, donor_idx)
    else:
        batch["donor"] = device_data["donors"].index_select(0, donor_idx).permute(0, 2, 3, 1).float()
    return batch


class DeviceProstatePipeline(_EpochPlanner):
    """The prostate train slices on the device (the JAX package's
    `DeviceProstatePipeline`): one float32 NCHW stack of every train
    domain's slices, which is also the donor pool, masks as uint8, and with
    precompute_donor_amp the stack's banded donor amplitudes.  Iterating
    yields {img_idx (B,), donor_idx (B,)} rows; `gather_prostate` turns one
    into a batch."""

    def __init__(
        self,
        images: np.ndarray,
        masks: np.ndarray,
        domain_offsets: Mapping[str, tuple],
        ds_domains: Sequence[str],
        train_domains: Sequence[str],
        batch_sizes: Sequence[int],
        *,
        is_out_domain: bool = False,
        seed: Optional[int] = None,
        precompute_donor_amp: bool = True,
        device: Union[str, torch.device] = "cuda",
    ):
        """images (N,S,S,3) float32 in [-1, 1] and masks (N,S,S) integer
        labels of every train domain, in `train_domains` order with
        domain_offsets {domain: (first row, count)}."""
        dev = resolve_device(device)
        super().__init__(
            batch_sizes, ds_domains, train_domains, [domain_offsets[d][0] for d in ds_domains],
            [domain_offsets[d][1] for d in ds_domains], domain_offsets, is_out_domain, seed,
        )
        stack = torch.from_numpy(np.ascontiguousarray(images, np.float32)).to(dev).permute(0, 3, 1, 2).contiguous()
        # labels are 0/1/2: uint8 on the device, widened in gather_prostate
        self.device_data: Dict[str, torch.Tensor] = {
            "images": stack,
            "masks": torch.from_numpy(np.ascontiguousarray(masks).astype(np.uint8)).to(dev),
        }
        if precompute_donor_amp:
            from ramdsir_tpu_torch.ops.ram import banded_amplitude_spectrum

            self.device_data["donor_amp"] = banded_amplitude_spectrum(stack.permute(0, 2, 3, 1))

    @classmethod
    def from_tree(
        cls,
        datasets: Sequence,
        batch_sizes: Sequence[int],
        base_dir: str,
        test_domain_idx: Optional[int],
        **kwargs,
    ) -> "DeviceProstatePipeline":
        """Read every train domain's .npy slices under base_dir (one
        `ProstateMultiDataset` per source domain), as the JAX package's
        constructor does."""
        train_domains = _train_domains(test_domain_idx, PROSTATE_DOMAINS)
        imgs, msks, offsets = [], [], {}
        for dom in train_domains:
            names = slice_names(base_dir, dom)
            offsets[dom] = (len(imgs), len(names))
            for name in names:
                img, mask = load_slice(base_dir, dom, name)
                imgs.append(img)
                msks.append(mask)
        ds_domains = [PROSTATE_DOMAINS[ds.domain_idx_list[0]] for ds in datasets]
        return cls(np.stack(imgs), np.stack(msks), offsets, ds_domains, train_domains, batch_sizes, **kwargs)

    @classmethod
    def from_arrays(
        cls,
        domain_arrays: Mapping[str, Mapping[str, np.ndarray]],
        domain_idxs: Sequence[int],
        batch_sizes: Sequence[int],
        test_domain_idx: Optional[int],
        **kwargs,
    ) -> "DeviceProstatePipeline":
        """In-memory slices {"DomainX": {"images": (N,S,S,3) float32,
        "masks": (N,S,S) int}} for every train domain (as
        `data.synthetic.prostate_arrays` makes them)."""
        train_domains = _train_domains(test_domain_idx, PROSTATE_DOMAINS)
        counts = [len(domain_arrays[d]["images"]) for d in train_domains]
        starts = np.cumsum([0] + counts)
        offsets = {d: (int(starts[i]), counts[i]) for i, d in enumerate(train_domains)}
        images = np.concatenate([domain_arrays[d]["images"] for d in train_domains])
        masks = np.concatenate([domain_arrays[d]["masks"] for d in train_domains])
        ds_domains = [PROSTATE_DOMAINS[d] for d in domain_idxs]
        return cls(images, masks, offsets, ds_domains, train_domains, batch_sizes, **kwargs)


def gather_prostate(
    device_data: Mapping[str, torch.Tensor], img_idx: torch.Tensor, donor_idx: torch.Tensor
) -> Dict[str, torch.Tensor]:
    """Indices -> the batch dict the train step takes (NHWC): img float32
    [-1, 1], mask int32, and the donor slice or its precomputed banded
    amplitudes.  No augmentation: prostate trains on the raw slices."""
    batch = {
        "img": device_data["images"].index_select(0, img_idx).permute(0, 2, 3, 1),
        "mask": device_data["masks"].index_select(0, img_idx).to(torch.int32),
    }
    if "donor_amp" in device_data:
        batch["donor_amp"] = device_data["donor_amp"].index_select(0, donor_idx)
    else:
        batch["donor"] = device_data["images"].index_select(0, donor_idx).permute(0, 2, 3, 1)
    return batch
