"""Sequential batching for eval (the batches of `ramdsir_tpu/data/loaders.py`'s
`DataLoader(shuffle=False, drop_last=False)`, whose threads only prefetch)."""
from __future__ import annotations

from typing import Dict, Iterator, List, Sequence

import numpy as np


def collate(items: List[Dict]) -> Dict:
    """Arrays and numbers stacked along a new first axis; anything else (the
    string ids) kept as a list."""
    out = {}
    for k in items[0]:
        vals = [it[k] for it in items]
        if isinstance(vals[0], (np.ndarray, int, float, np.integer, np.floating)):
            out[k] = np.stack([np.asarray(v) for v in vals])
        else:
            out[k] = vals
    return out


def sequential_batches(dataset: Sequence[Dict], batch_size: int) -> Iterator[Dict]:
    """Batches of `batch_size` items in order; the last holds the rest."""
    for start in range(0, len(dataset), batch_size):
        yield collate([dataset[i] for i in range(start, min(start + batch_size, len(dataset)))])
