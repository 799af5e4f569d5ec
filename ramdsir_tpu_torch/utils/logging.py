"""Scalar metrics as JSON lines (PyTorch port of
`ramdsir_tpu/utils/logging.py:39-84`).

Tags are the reference's SummaryWriter tags (code/train.py:298-329), so
curves compare with the JAX package's `metrics.jsonl`.  TensorBoard event
files and image grids are not written.
"""
from __future__ import annotations

import json
import os
import time


class MetricsWriter:
    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._t0 = time.time()

    def add_scalars(self, metrics: dict, step: int, prefix: str = "") -> None:
        rec = {"t": round(time.time() - self._t0, 3), "step": step}
        rec.update({prefix + k: float(v) for k, v in metrics.items()})
        self._jsonl.write(json.dumps(rec) + "\n")

    def flush(self) -> None:
        self._jsonl.flush()

    def close(self) -> None:
        self._jsonl.close()
