"""Leave-one-domain-out fundus evaluation (PyTorch port of the fundus part
of `ramdsir_tpu/train/evaluate.py`).

`eval_fundus` predicts every test batch at the train resolution on the
device, quantises the probabilities to uint16 there (`_q16`) and reads them
back once per EVAL_PULL_BYTES; on the host it resizes each map bilinearly to
its image's original mask size, thresholds at 0.75 and keeps the largest
component with holes filled (`ops.postprocess`), and scores cup and disc
Dice, and with_distances HD95 and ASD with the empty-prediction sentinel 100.
The post-processing and distances run in the port's host library
(`ramdsir_tpu_torch.native`).
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ramdsir_tpu_torch.data.fundus import FundusDataset
from ramdsir_tpu_torch.data.loaders import sequential_batches
from ramdsir_tpu_torch.ops.metrics import asd as asd_metric
from ramdsir_tpu_torch.ops.metrics import dice_coeff_2label
from ramdsir_tpu_torch.ops.metrics import hd95 as hd95_metric
from ramdsir_tpu_torch.ops.postprocess import postprocessing
from ramdsir_tpu_torch.ops.resize import bilinear_resize_chw

EMPTY_SENTINEL = 100.0  # reference test_fundus_slice.py:111-131

# the most quantised-probability bytes parked on the device per readback
EVAL_PULL_BYTES = 128e6


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
    # seconds by phase (load, forward, readback, dequantise, resize,
    # postprocess, save, dice, distances, wall) and the batch count; not a
    # result
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
    t_start = time.perf_counter()
    testset = _test_split(data, test_domain_idx, image_size, dataset_name, num)
    res = FundusEvalResult()
    timing = dict.fromkeys(
        ("load", "forward", "readback", "dequantise", "resize", "postprocess", "save", "dice", "distances"), 0.0
    )

    # dispatch every batch before any readback
    pending = []  # (n_real, host_batch, device uint16 probabilities)
    t = time.perf_counter()
    for batch in sequential_batches(testset, batch_size):
        t_loaded = time.perf_counter()
        timing["load"] += t_loaded - t
        pending.append((batch["img"].shape[0], batch, _q16(predict(batch["img"]))))
        t = time.perf_counter()
        timing["forward"] += t - t_loaded
    if pending:
        device = pending[0][2].device
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        timing["forward"] += time.perf_counter() - t

    per_batch_bytes = 2 * batch_size * image_size * image_size * 2  # uint16, 2 channels
    pull_chunk = max(1, int(EVAL_PULL_BYTES // per_batch_bytes))
    for start in range(0, len(pending), pull_chunk):
        part = pending[start : start + pull_chunk]
        t = time.perf_counter()
        # one device buffer, one readback: copy_ is all a uint16 tensor needs
        rows = sum(n for n, _, _ in part)
        buf = torch.empty((rows,) + tuple(part[0][2].shape[1:]), dtype=torch.uint16, device=part[0][2].device)
        offsets = np.cumsum([0] + [n for n, _, _ in part])
        for (n, _, q), lo in zip(part, offsets):
            buf[lo : lo + n].copy_(q)
        codes = buf.cpu().numpy()
        t_read = time.perf_counter()
        stacked = codes.astype(np.float32) / 65535.0
        timing["readback"] += t_read - t
        timing["dequantise"] += time.perf_counter() - t_read
        probs = [stacked[lo : lo + n] for (n, _, _), lo in zip(part, offsets)]
        _consume_fundus_batches(part, probs, res, dataset_name, save_dir, with_distances, timing)

    if res.num:
        for f in ("cup_dice", "disc_dice", "hd_oc", "hd_od", "asd_oc", "asd_od"):
            setattr(res, f, getattr(res, f) / res.num)
    res.timing = dict(timing, batches=len(pending), wall=time.perf_counter() - t_start)
    return res


def _consume_fundus_batches(pending, probs_per_batch, res, dataset_name, save_dir, with_distances, timing):
    """Score one read-back chunk: (n_real, host_batch, _) triples and each
    batch's (n, 2, S, S) float32 probabilities."""
    for (n, batch, _), probs in zip(pending, probs_per_batch):
        for i in range(n):
            t0 = time.perf_counter()
            target = batch["mask_orig"][i]  # (H, W, 2) at the original size
            th, tw = target.shape[0], target.shape[1]
            pred_full = bilinear_resize_chw(probs[i], th, tw)
            t1 = time.perf_counter()
            pred_post = postprocessing(pred_full, dataset=dataset_name, threshold=0.75)
            tgt_chw = target.transpose(2, 0, 1)
            t2 = time.perf_counter()
            if save_dir:  # contour overlays (reference test_fundus_slice.py:145-151)
                from ramdsir_tpu_torch.utils.viz import save_per_img

                img_full = bilinear_resize_chw(
                    np.asarray(batch["img"][i], np.float32).transpose(2, 0, 1), th, tw
                ).transpose(1, 2, 0)
                save_per_img(img_full, save_dir, batch["id"][i], pred_post, tgt_chw)
            t3 = time.perf_counter()
            cup, disc = dice_coeff_2label(pred_post, tgt_chw)
            res.cup_dice += cup
            res.disc_dice += disc
            t4 = time.perf_counter()
            if with_distances:
                for ch, (hd_attr, asd_attr) in enumerate([("hd_oc", "asd_oc"), ("hd_od", "asd_od")]):
                    p, t = pred_post[ch].astype(bool), tgt_chw[ch].astype(bool)
                    if p.sum() < 1e-4 or t.sum() == 0:
                        hd, a = EMPTY_SENTINEL, EMPTY_SENTINEL
                    else:
                        hd, a = hd95_metric(p, t), asd_metric(p, t)
                    setattr(res, hd_attr, getattr(res, hd_attr) + hd)
                    setattr(res, asd_attr, getattr(res, asd_attr) + a)
            res.num += 1
            timing["resize"] += t1 - t0
            timing["postprocess"] += t2 - t1
            timing["save"] += t3 - t2
            timing["dice"] += t4 - t3
            timing["distances"] += time.perf_counter() - t4


def append_csv_log(path: str, fields: List) -> None:
    """Append one comma-joined row (the reference train.py:125-130 log)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "a") as f:
        f.write(",".join(str(x) for x in fields) + "\n")
