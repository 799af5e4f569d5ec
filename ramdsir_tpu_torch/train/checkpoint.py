"""Keep-best checkpoints and loading the reference's `.pth` format (port of
`BestKeeper` in `ramdsir_tpu/train/checkpoint.py:77-114`).

The files are the reference's format (`utils.torch_compat.export_torch_checkpoint`):
{"<module>_state_dict": state_dict} with weights and BN statistics, no
optimiser.  The flax msgpack `.ckpt` of the JAX package is not read here.
"""
from __future__ import annotations

import glob
import os
from typing import Mapping, Optional

import torch

from ramdsir_tpu_torch.utils.torch_compat import export_torch_checkpoint


def load_torch_checkpoint(path: str, models: Mapping[str, torch.nn.Module]) -> None:
    """Load a `.pth` into `models` in place: every built module from its
    `<name>_state_dict`, strictly; modules that were not built (the eval CLI
    builds no rec decoder) are not read."""
    if path.endswith(".ckpt"):
        raise NotImplementedError(
            f"{path}: flax .ckpt checkpoints are not read by the port yet "
            "(ROADMAP.md: Resume and checkpoint interchange); pass a .pth"
        )
    payload = torch.load(path, map_location="cpu", weights_only=True)
    for name, module in models.items():
        key = f"{name}_state_dict"
        if key not in payload:
            raise KeyError(f"{path} has no {key} (it holds {sorted(payload)})")
        module.load_state_dict(payload[key], strict=True)


class BestKeeper:
    """The rolling best checkpoint `model_<score>.pth` (reference
    train.py:337-361): the first eval always saves, a tie rewrites the file
    (PARITY.md #8), the previous best is deleted."""

    def __init__(self, save_dir: str):
        self.save_dir = save_dir
        self.best: float = 0.0
        self.best_path: Optional[str] = None
        os.makedirs(save_dir, exist_ok=True)
        # adopt an existing best by numeric order (a lexicographic sort
        # would rank 9.50 above 12.00)
        scored = []
        for p in glob.glob(os.path.join(save_dir, "model_*.pth")):
            try:
                scored.append((float(os.path.basename(p)[6:-4]), p))
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
