"""Changes planted in the program for the fault tests and the readings of
the correctness limits: each a context manager that patches the port's
modules for its duration and restores them after.

    with planted("train", "stale_rows", ctx.device):
        out = harness.run_cell(ctx)

Faults of a training cell:
  state_unchanged  Adam's step does nothing, so the state stays as it was;
  half_batch       the second half of every batch's rows replaced by the
                   first half (half the batch left out, the means over the
                   rest);
  answer_altered   every step's logged loss x 1.01, where it is produced;
  replay_noop      a graph replay does nothing (on the CPU, where every step
                   is eager, the steps after the graph's eager ones do
                   nothing);
  stale_rows       every window after the first reads the first window's
                   index rows, draws and lrs: the new rows never reach the
                   buffers that the steps (and the graph's replays) read.
Faults of an eval cell:
  half_batch           the second half of every predicted batch replaced
                       by the first half;
  answer_altered       one image's probabilities of every batch + 0.05;
  postprocess_skipped  the labels thresholded (fundus) or taken as
                       predicted (prostate), without the largest component
                       and the fill.
Not a fault: tf32_off, the program's cuDNN convolutions in full float32
(the configuration states TF32), a witness for the source of a gap."""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, Iterator

import numpy as np
import torch


class Patches:
    """setattr with the old values kept; undo() restores them in reverse."""

    def __init__(self):
        self._old = []

    def set(self, obj, name: str, value) -> None:
        self._old.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def undo(self) -> None:
        while self._old:
            obj, name, value = self._old.pop()
            setattr(obj, name, value)


def _state_unchanged(p: Patches, device) -> None:
    import ramdsir_tpu_torch.train.state as state

    init_state = state.init_state

    def frozen(*args, **kwargs):
        s = init_state(*args, **kwargs)
        s.optimizer.step = lambda *a, **k: None
        return s

    p.set(state, "init_state", frozen)


def _train_half_batch(p: Patches, device) -> None:
    import ramdsir_tpu_torch.train.steps as steps

    def halve(fn):
        def wrapped(device_data, img_idx, donor_idx, *args):
            h = img_idx.shape[0] // 2
            img_idx, donor_idx = img_idx.clone(), donor_idx.clone()
            img_idx[-h:], donor_idx[-h:] = img_idx[:h], donor_idx[:h]
            return fn(device_data, img_idx, donor_idx, *args)
        return wrapped

    p.set(steps, "gather_and_augment", halve(steps.gather_and_augment))
    p.set(steps, "gather_prostate", halve(steps.gather_prostate))


def _loss_altered(p: Patches, device) -> None:
    import ramdsir_tpu_torch.train.steps as steps

    metrics = steps.StepInputs.metrics

    def altered(self, n):
        out = metrics(self, n)
        out["loss"] = out["loss"] * 1.01
        return out

    p.set(steps.StepInputs, "metrics", altered)


def _replay_noop(p: Patches, device) -> None:
    import ramdsir_tpu_torch.train.steps as steps

    if torch.device(device).type == "cuda":
        p.set(torch.cuda.CUDAGraph, "replay", lambda self: None)
        return
    init = steps.ScanTrainSteps.__init__

    def init_eager_noop(self, body, *args, **kwargs):
        calls = [0]

        def first_ones(*a, **k):
            calls[0] += 1
            return body(*a, **k) if calls[0] <= steps.GRAPH_WARMUP_STEPS else (None, {})

        init(self, first_ones, *args, **kwargs)

    p.set(steps.ScanTrainSteps, "__init__", init_eager_noop)


def _stale_rows(p: Patches, device) -> None:
    import ramdsir_tpu_torch.train.steps as steps

    load = steps.StepInputs.load
    loaded = set()

    def stale(self, values):
        if id(self) in loaded:
            self.pos.zero_()
            return None
        loaded.add(id(self))
        return load(self, values)

    p.set(steps.StepInputs, "load", stale)


def _predict_changed(change: Callable) -> Callable:
    def plant(p: Patches, device) -> None:
        import ramdsir_tpu_torch.train.steps as steps

        make = steps.make_predict_fn

        def made(*args, **kwargs):
            predict = make(*args, **kwargs)
            return lambda img, n_valid=None: change(predict(img, n_valid).clone())

        p.set(steps, "make_predict_fn", made)

    return plant


def _halve_rows(prob: torch.Tensor) -> torch.Tensor:
    h = prob.shape[0] // 2
    if h:
        prob[-h:] = prob[:h]
    return prob


def _alter_one(prob: torch.Tensor) -> torch.Tensor:
    prob[0] = (prob[0] + 0.05).clamp(0.0, 1.0)  # one image's answer, where it is produced
    return prob


def _postprocess_skipped(p: Patches, device) -> None:
    import ramdsir_tpu_torch.train.evaluate as evaluate

    p.set(evaluate, "postprocessing",
          lambda prediction, threshold=0.5, dataset="G", **kw: (np.asarray(prediction) > threshold).astype(np.uint8))
    p.set(evaluate, "connectivity_region_analysis", lambda mask: (np.asarray(mask) != 0).astype(np.float64))


def _tf32_off(p: Patches, device) -> None:
    p.set(torch.backends.cudnn, "allow_tf32", False)


TRAIN: Dict[str, Callable] = {"state_unchanged": _state_unchanged, "half_batch": _train_half_batch,
                              "answer_altered": _loss_altered, "replay_noop": _replay_noop,
                              "stale_rows": _stale_rows, "tf32_off": _tf32_off}
EVAL: Dict[str, Callable] = {"half_batch": _predict_changed(_halve_rows),
                             "answer_altered": _predict_changed(_alter_one),
                             "postprocess_skipped": _postprocess_skipped, "tf32_off": _tf32_off}
KINDS = {"train": TRAIN, "eval": EVAL}
FAULTS = {"train": [k for k in TRAIN if k != "tf32_off"], "eval": [k for k in EVAL if k != "tf32_off"]}


@contextlib.contextmanager
def planted(kind: str, name, device) -> Iterator[None]:
    """The change `name` (None: nothing) of a `kind` cell ("train",
    "eval") planted for the duration."""
    p = Patches()
    try:
        if name is not None:
            KINDS[kind][name](p, device)
        yield
    finally:
        p.undo()
