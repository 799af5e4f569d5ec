"""Leave-one-domain-out evaluation (PyTorch port of
`ramdsir_tpu/train/evaluate.py`).

`eval_fundus` predicts every test batch at the train resolution on the
device, quantises the probabilities to uint16 there (`_q16`) and reads them
back once per EVAL_PULL_BYTES; on the host it resizes each map bilinearly to
its image's original mask size, thresholds at 0.75 and keeps the largest
component with holes filled (`ops.postprocess`), and scores cup and disc
Dice, and with_distances HD95 and ASD with the empty-prediction sentinel 100.

`eval_prostate_volumes` scores 3-D volumes: min-max to [-1, 1] in float64,
3-slice windows in full batches (`predict_volume`), argmax labels computed
on the device as uint8 and read back once a volume, the largest
connectivity-1 component on the host, and volume Dice (HD95 and ASD with
the sentinel).

The post-processing and distances run in the port's host library
(`ramdsir_tpu_torch.native`).

Each phase is a span (`utils.profiler.span`): `ramdsir.eval.pass` around a
pass, `.load` (a fundus batch's reads and decodes, a prostate volume's read
and min-max), `.forward`, `.readback`, `.dequantise` (fundus), `.windows`
and `.scatter` (prostate), and one `.case` an image or a volume around its
`.resize` (fundus), `.post`, `.save`, `.dice` and `.distances`.  The
result's `timing` sums them by phase.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ramdsir_tpu_torch.config import PROSTATE_VOLUME_DOMAINS
from ramdsir_tpu_torch.data.fundus import FundusDataset
from ramdsir_tpu_torch.data.loaders import sequential_batches
from ramdsir_tpu_torch.data.nifti import read_nifti
from ramdsir_tpu_torch.ops.metrics import asd as asd_metric
from ramdsir_tpu_torch.ops.metrics import dice_binary, dice_coeff_2label
from ramdsir_tpu_torch.ops.metrics import hd95 as hd95_metric
from ramdsir_tpu_torch.ops.postprocess import connectivity_region_analysis, postprocessing
from ramdsir_tpu_torch.ops.resize import bilinear_resize_chw
from ramdsir_tpu_torch.utils.profiler import span

EMPTY_SENTINEL = 100.0  # reference test_fundus_slice.py:111-131

# the most quantised-probability bytes parked on the device per readback
EVAL_PULL_BYTES = 128e6

# `res.timing`'s phases, seconds each: the `ramdsir.eval.<phase>` spans
# summed (`postprocess` the `.post` spans); `wall` is `ramdsir.eval.pass`
FUNDUS_PHASES = ("load", "forward", "readback", "dequantise", "resize", "postprocess", "save", "dice", "distances")
PROSTATE_PHASES = ("load", "windows", "forward", "readback", "scatter", "postprocess", "save", "dice", "distances")


def _q16(p: torch.Tensor) -> torch.Tensor:
    """[0, 1] probabilities -> uint16 codes round(p * 65535) on p's device,
    rounding half to even as `jnp.round`.  Half the bytes of float32 to
    read back; the reconstruction error, at most 1/131070, can move the
    0.75 threshold only for probabilities within 7.6e-6 of it, as in the
    JAX package."""
    return torch.round(p * 65535.0).to(torch.uint16)


@dataclass
class FundusEvalResult:
    cup_dice: float = 0.0
    disc_dice: float = 0.0
    hd_oc: float = 0.0
    hd_od: float = 0.0
    asd_oc: float = 0.0
    asd_od: float = 0.0
    num: int = 0
    # seconds by phase (FUNDUS_PHASES and wall) and the batch and image
    # counts (batches, cases); not a result
    timing: Dict[str, float] = field(default_factory=dict, compare=False, repr=False)

    @property
    def avg_dice_pct(self) -> float:
        return (self.cup_dice + self.disc_dice) * 100.0 / 2


def _test_split(data, test_domain_idx, image_size, dataset_name, num) -> Sequence[Dict]:
    if not isinstance(data, str):
        return list(data)[:num] if num is not None else data
    base = data if data.endswith(dataset_name) else os.path.join(data, dataset_name)
    return FundusDataset(base, test_domain_idx, image_size, num=num)


def eval_fundus(
    predict: Callable,
    data: Union[str, Sequence[Dict]],
    test_domain_idx: int,
    batch_size: int = 8,
    image_size: int = 256,
    with_distances: bool = False,
    dataset_name: str = "fundus",
    num: Optional[int] = None,
    save_dir: Optional[str] = None,
) -> FundusEvalResult:
    """Score `predict` (from `make_predict_fn`) on the test split of domain
    test_domain_idx.

    data: the data root of the PNG tree (as the JAX package's data_dir), or
    the test samples themselves (`data.synthetic.fundus_test_samples`).
    The tail batch runs as it is, with fewer rows.
    """
    res = FundusEvalResult()
    timing = dict.fromkeys(FUNDUS_PHASES, 0.0)
    pending = []  # (n_real, host_batch, device uint16 probabilities)
    with span("ramdsir.eval.pass", timing, "wall"):
        testset = _test_split(data, test_domain_idx, image_size, dataset_name, num)
        # dispatch every batch before any readback
        batches = sequential_batches(testset, batch_size)
        while True:
            with span("ramdsir.eval.load", timing, "load"):
                batch = next(batches, None)
            if batch is None:
                break
            with span("ramdsir.eval.forward", timing, "forward"):
                pending.append((batch["img"].shape[0], batch, _q16(predict(batch["img"]))))
        if pending and pending[0][2].device.type == "cuda":
            with span("ramdsir.eval.forward", timing, "forward"):
                torch.cuda.synchronize(pending[0][2].device)

        per_batch_bytes = 2 * batch_size * image_size * image_size * 2  # uint16, 2 channels
        pull_chunk = max(1, int(EVAL_PULL_BYTES // per_batch_bytes))
        for start in range(0, len(pending), pull_chunk):
            part = pending[start : start + pull_chunk]
            offsets = np.cumsum([0] + [n for n, _, _ in part])
            with span("ramdsir.eval.readback", timing, "readback"):
                # one device buffer, one readback: copy_ is all a uint16 tensor needs
                buf = torch.empty((int(offsets[-1]),) + tuple(part[0][2].shape[1:]), dtype=torch.uint16,
                                  device=part[0][2].device)
                for (n, _, q), lo in zip(part, offsets):
                    buf[lo : lo + n].copy_(q)
                codes = buf.cpu().numpy()
            with span("ramdsir.eval.dequantise", timing, "dequantise"):
                stacked = codes.astype(np.float32) / 65535.0
            probs = [stacked[lo : lo + n] for (n, _, _), lo in zip(part, offsets)]
            _consume_fundus_batches(part, probs, res, dataset_name, save_dir, with_distances, timing)

        if res.num:
            for f in ("cup_dice", "disc_dice", "hd_oc", "hd_od", "asd_oc", "asd_od"):
                setattr(res, f, getattr(res, f) / res.num)
    res.timing = dict(timing, batches=len(pending), cases=res.num)
    return res


def _consume_fundus_batches(pending, probs_per_batch, res, dataset_name, save_dir, with_distances, timing):
    """Score one read-back chunk: (n_real, host_batch, _) triples and each
    batch's (n, 2, S, S) float32 probabilities, a `ramdsir.eval.case` span
    an image."""
    for (n, batch, _), probs in zip(pending, probs_per_batch):
        for i in range(n):
            with span("ramdsir.eval.case"):
                with span("ramdsir.eval.resize", timing, "resize"):
                    target = batch["mask_orig"][i]  # (H, W, 2) at the original size
                    th, tw = target.shape[0], target.shape[1]
                    pred_full = bilinear_resize_chw(probs[i], th, tw)
                with span("ramdsir.eval.post", timing, "postprocess"):
                    pred_post = postprocessing(pred_full, dataset=dataset_name, threshold=0.75)
                    tgt_chw = target.transpose(2, 0, 1)
                if save_dir:  # contour overlays (reference test_fundus_slice.py:145-151)
                    with span("ramdsir.eval.save", timing, "save"):
                        from ramdsir_tpu_torch.utils.viz import save_per_img

                        img_full = bilinear_resize_chw(
                            np.asarray(batch["img"][i], np.float32).transpose(2, 0, 1), th, tw
                        ).transpose(1, 2, 0)
                        save_per_img(img_full, save_dir, batch["id"][i], pred_post, tgt_chw)
                with span("ramdsir.eval.dice", timing, "dice"):
                    cup, disc = dice_coeff_2label(pred_post, tgt_chw)
                    res.cup_dice += cup
                    res.disc_dice += disc
                if with_distances:
                    with span("ramdsir.eval.distances", timing, "distances"):
                        for ch, (hd_attr, asd_attr) in enumerate([("hd_oc", "asd_oc"), ("hd_od", "asd_od")]):
                            p, t = pred_post[ch].astype(bool), tgt_chw[ch].astype(bool)
                            if p.sum() < 1e-4 or t.sum() == 0:
                                hd, a = EMPTY_SENTINEL, EMPTY_SENTINEL
                            else:
                                hd, a = hd95_metric(p, t), asd_metric(p, t)
                            setattr(res, hd_attr, getattr(res, hd_attr) + hd)
                            setattr(res, asd_attr, getattr(res, asd_attr) + a)
                res.num += 1


@dataclass
class ProstateEvalResult:
    dice: float = 0.0
    hd: float = 0.0
    asd: float = 0.0
    num: int = 0
    per_case: List[Dict] = field(default_factory=list)
    # seconds by phase (PROSTATE_PHASES and wall) and the batch and volume
    # counts (batches, volumes, cases); not a result
    timing: Dict[str, float] = field(default_factory=dict, compare=False, repr=False)

    @property
    def dice_pct(self) -> float:
        return self.dice * 100.0


def _labels_u8(probs: torch.Tensor) -> torch.Tensor:
    """Class labels of (B, C, H, W) probabilities as uint8 on their device:
    the first maximum, as np.argmax, and an eighth of float32's bytes."""
    return torch.argmax(probs, dim=1).to(torch.uint8)


def predict_volume(
    predict: Callable,
    image: np.ndarray,
    mask: np.ndarray,
    batch_size: int = 8,
    timing: Optional[Dict[str, float]] = None,
) -> np.ndarray:
    """3-slice sliding-window prediction over a (D, H, W) float32 volume,
    as the reference does: depth // batch_size full batches over the frames
    1..D-2, the last one padded with zero windows (which, under BN
    adaptation, enter the batch statistics), leftover frames dropped, and
    frames whose ground truth is empty left at 0.  Every batch is dispatched
    before the one readback of the volume's labels.  Returns (D, H, W)
    float64 labels."""
    timing = {} if timing is None else timing
    for k in ("windows", "forward", "readback", "scatter"):
        timing.setdefault(k, 0.0)
    depth, h, w = image.shape
    pred_y = np.zeros(mask.shape)
    frame_list = list(range(1, depth - 1))
    dispatched = []  # (frames, device labels)
    for ii in range(depth // batch_size):
        with span("ramdsir.eval.windows", timing, "windows"):
            frames = frame_list[ii * batch_size : (ii + 1) * batch_size]
            vol = np.zeros((batch_size, h, w, 3), np.float32)
            for idx, jj in enumerate(frames):
                vol[idx] = image[jj - 1 : jj + 2].transpose(1, 2, 0)
        with span("ramdsir.eval.forward", timing, "forward"):
            dispatched.append((frames, _labels_u8(predict(vol))))
        timing["batches"] = timing.get("batches", 0) + 1
    if not dispatched:
        return pred_y
    labels = dispatched[0][1]
    if labels.device.type == "cuda":
        with span("ramdsir.eval.forward", timing, "forward"):
            torch.cuda.synchronize(labels.device)
    with span("ramdsir.eval.readback", timing, "readback"):
        stacked = torch.stack([p for _, p in dispatched]).cpu().numpy()
    with span("ramdsir.eval.scatter", timing, "scatter"):
        for (frames, _), lab in zip(dispatched, stacked):
            for idx, jj in enumerate(frames):
                if mask[jj].sum() == 0:  # empty-GT frames stay 0 (reference quirk, kept)
                    continue
                pred_y[jj] = lab[idx]
    return pred_y


def _volumes(data, test_domain_idx: int, dataset_name: str):
    """(name, image, mask) of each test volume: in-memory triples as they
    are, or the sorted NIfTI cases under data/<dataset_name>/<domain>."""
    if not isinstance(data, str):
        yield from data
        return
    vol_dir = os.path.join(data, dataset_name, PROSTATE_VOLUME_DOMAINS[test_domain_idx])
    for name in sorted(f for f in os.listdir(vol_dir) if "segmentation" not in f):
        image = read_nifti(os.path.join(vol_dir, name))
        mask = read_nifti(os.path.join(vol_dir, name.replace(".nii.gz", "_segmentation.nii.gz")))
        yield name, image, mask


def eval_prostate_volumes(
    predict: Callable,
    data: Union[str, Sequence[Tuple[str, np.ndarray, np.ndarray]]],
    test_domain_idx: int,
    batch_size: int = 8,
    with_distances: bool = False,
    dataset_name: str = "prostate",
    save_dir: Optional[str] = None,
) -> ProstateEvalResult:
    """Score `predict` (from `make_predict_fn`, prostate) on the test
    volumes of domain test_domain_idx, a `ramdsir.eval.case` span a volume.

    data: the data root (volumes under data/<dataset_name>/<domain>, as the
    JAX package's data_dir), or in-memory (name, image (D, H, W), mask
    (D, H, W)) volumes (`data.synthetic.prostate_volumes`).
    """
    res = ProstateEvalResult()
    timing = dict(dict.fromkeys(PROSTATE_PHASES, 0.0), batches=0)
    with span("ramdsir.eval.pass", timing, "wall"):
        volumes = _volumes(data, test_domain_idx, dataset_name)
        while True:
            with span("ramdsir.eval.load", timing, "load"):
                item = next(volumes, None)
                if item is not None:
                    name, image, mask = item
                    image = np.asarray(image).astype(np.float64)
                    lo, hi = image.min(), image.max()
                    image = 2.0 * (image - lo) / max(hi - lo, 1e-12) - 1.0
                    mask = np.asarray(mask)
                    mask = np.where(mask == 2, 1, mask)
            if item is None:
                break
            with span("ramdsir.eval.case"):
                pred_y = predict_volume(predict, image.astype(np.float32), mask, batch_size, timing)
                with span("ramdsir.eval.post", timing, "postprocess"):
                    processed = connectivity_region_analysis(pred_y)
                if save_dir:  # slice overlays (reference test_prostate_volume.py:129-141)
                    with span("ramdsir.eval.save", timing, "save"):
                        from ramdsir_tpu_torch.utils.viz import save_per_img, untransform_prostate

                        for z in range(image.shape[0]):
                            if mask[z].sum() == 0:  # empty-GT slices are skipped, as in the reference
                                continue
                            save_per_img(untransform_prostate(image[z]), save_dir, f"{name.split('.')[0]}_{z}",
                                         processed[z], mask[z])
                with span("ramdsir.eval.dice", timing, "dice"):
                    pred_b, gt_b = processed.astype(bool), mask.astype(bool)
                    d = dice_binary(pred_b, gt_b)
                    case = {"id": name, "dice": d}
                    res.dice += d
                if with_distances:
                    with span("ramdsir.eval.distances", timing, "distances"):
                        if pred_b.sum() == 0 or gt_b.sum() == 0:
                            hd = a = EMPTY_SENTINEL
                        else:
                            hd, a = hd95_metric(pred_b, gt_b), asd_metric(pred_b, gt_b)
                        res.hd += hd
                        res.asd += a
                        case.update(hd95=hd, asd=a)
                res.per_case.append(case)
                res.num += 1
        if res.num:
            res.dice /= res.num
            res.hd /= res.num
            res.asd /= res.num
    res.timing = dict(timing, volumes=res.num, cases=res.num)
    return res


def append_csv_log(path: str, fields: List) -> None:
    """Append one comma-joined row (the reference train.py:125-130 log)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "a") as f:
        f.write(",".join(str(x) for x in fields) + "\n")
