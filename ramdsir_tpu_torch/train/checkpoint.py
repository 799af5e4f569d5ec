"""Checkpoints (PyTorch port of `ramdsir_tpu/train/checkpoint.py`).

Two formats:
  .ckpt   the JAX package's: flax msgpack of {"state": the TrainState's
          state dict (params, batch_stats, opt_state = optax Adam's {count,
          mu, nu}, step), "meta": {...}}, read and written with the port's
          own codec (`utils/msgpack.py`).  `fit` writes the full state to
          `final_model.ckpt` and resumes from one; the JAX package's
          `load_checkpoint` reads the port's files and the port reads its.
  .pth    the reference's (`utils.torch_compat.export_torch_checkpoint`):
          {"<module>_state_dict": state_dict}, weights and BN statistics, no
          optimiser; the keep-best `model_<dice>.pth` and `final_model.pth`.
"""
from __future__ import annotations

import glob
import os
from typing import Any, Dict, Mapping, Optional

import torch

from ramdsir_tpu_torch.train.state import TrainState, load_state_tree, state_to_tree
from ramdsir_tpu_torch.utils import msgpack
from ramdsir_tpu_torch.utils.torch_compat import export_torch_checkpoint, load_jax_params


def save_checkpoint(
    path: str, state: TrainState, meta: Optional[Dict[str, Any]] = None, weights_only: bool = False
) -> None:
    """Write `state` as the JAX package's `.ckpt`; weights_only drops the
    Adam state, as the JAX package's rolling best does."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tree = state_to_tree(state)
    if weights_only:
        tree.pop("opt_state")
    with open(path, "wb") as f:
        f.write(msgpack.packb({"state": tree, "meta": meta or {}}))


def read_checkpoint(path: str) -> Dict[str, Any]:
    """A `.ckpt`'s {"state": ..., "meta": ...} with numpy leaves."""
    with open(path, "rb") as f:
        return msgpack.unpackb(f.read())


def load_checkpoint(path: str, state: TrainState) -> Dict[str, Any]:
    """Load a `.ckpt` into `state` in place (a weights-only file keeps the
    state's own Adam state); returns its meta."""
    payload = read_checkpoint(path)
    load_state_tree(state, payload["state"])
    return payload.get("meta", {})


def load_torch_checkpoint(path: str, models: Mapping[str, torch.nn.Module]) -> None:
    """Load a `.pth` into `models` in place: every built module from its
    `<name>_state_dict`, strictly; modules that were not built (the eval CLI
    builds no rec decoder) are not read."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    for name, module in models.items():
        key = f"{name}_state_dict"
        if key not in payload:
            raise KeyError(f"{path} has no {key} (it holds {sorted(payload)})")
        module.load_state_dict(payload[key], strict=True)


def load_any_checkpoint(path: str, models: Mapping[str, torch.nn.Module]) -> None:
    """The eval CLIs' loader: a `.pth`/`.pt` through `load_torch_checkpoint`,
    anything else as a `.ckpt` (full or weights-only, from the port or the
    JAX package); weights and BN statistics of the built modules, in place."""
    if path.endswith((".pth", ".pt")):
        load_torch_checkpoint(path, models)
        return
    state = read_checkpoint(path)["state"]
    load_jax_params(models, state["params"], state["batch_stats"])


class BestKeeper:
    """The rolling best checkpoint `model_<score>.pth` (reference
    train.py:337-361): the first eval always saves, a tie rewrites the file
    (PARITY.md #8), the previous best is deleted.  A save_dir that already
    holds a best, the port's `model_<score>.pth` or the JAX package's
    weights-only `model_<score>.ckpt`, starts from the highest score; only
    that file and the keeper's own are ever removed."""

    def __init__(self, save_dir: str):
        self.save_dir = save_dir
        self.best: float = 0.0
        self.best_path: Optional[str] = None
        os.makedirs(save_dir, exist_ok=True)
        # adopt an existing best by numeric order (a lexicographic sort
        # would rank 9.50 above 12.00)
        scored = []
        for p in glob.glob(os.path.join(save_dir, "model_*.pth")) + glob.glob(os.path.join(save_dir, "model_*.ckpt")):
            try:
                scored.append((float(os.path.splitext(os.path.basename(p))[0][6:]), p))
            except ValueError:
                pass
        if scored:
            self.best, self.best_path = max(scored)

    def update(self, score: float, models: Mapping[str, torch.nn.Module]) -> bool:
        """Save `models` as the new best if score >= the best so far."""
        if score < self.best:
            return False
        if self.best_path and os.path.exists(self.best_path):
            os.remove(self.best_path)
        self.best_path = os.path.join(self.save_dir, "model_%.2f.pth" % score)
        export_torch_checkpoint(self.best_path, models)
        self.best = score
        return True
