"""Step timing and throughput (PyTorch port of `ramdsir_tpu/utils/profiler.py:15-71`)."""
from __future__ import annotations

import contextlib
import statistics
import time
from typing import Iterator, List, Optional, Union

import torch


class StepTimer:
    """Wall-clock step timer with the first `warmup` steps excluded.

    `tick()` after each step; on a CUDA device `mark()` synchronises the
    device first, so the window ends at completed work, not at the last
    enqueue.  `step_seconds` holds the time between consecutive ticks after
    warm-up.
    """

    def __init__(self, warmup: int = 2, device: Union[str, torch.device] = "cpu"):
        self.warmup = warmup
        self.device = torch.device(device)
        self.steps = 0
        self.items = 0
        self.step_seconds: List[float] = []
        self._t0: Optional[float] = None
        self._last: Optional[float] = None
        self._dirty = False  # ticks since the last mark

    def tick(self, batch_items: int) -> None:
        self.steps += 1
        now = time.perf_counter()
        if self.steps == self.warmup:
            self._t0 = now
            self.items = 0
        elif self.steps > self.warmup:
            self.items += batch_items
            self.step_seconds.append(now - self._last)
        self._last = now
        self._dirty = True

    def mark(self) -> None:
        """Extend the window to now (after a device synchronise) without
        adding items.  A mark with no tick since the previous one is a
        no-op: whatever ran in between (eval, checkpoints) is not step work."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        if self._t0 and self._dirty:
            self._last = time.perf_counter()
        self._dirty = False

    @contextlib.contextmanager
    def paused(self) -> Iterator[None]:
        """Time spent inside (eval, checkpoints) counts in neither the
        throughput window nor the next step's time."""
        t = time.perf_counter()
        try:
            yield
        finally:
            gap = time.perf_counter() - t
            if self._t0 is not None:
                self._t0 += gap
            if self._last is not None:
                self._last += gap

    @property
    def elapsed(self) -> float:
        if not self._t0:
            return 0.0
        return (self._last or self._t0) - self._t0

    @property
    def items_per_sec(self) -> float:
        return self.items / self.elapsed if self._t0 and self.elapsed > 0 else 0.0

    @property
    def median_step_ms(self) -> float:
        return 1e3 * statistics.median(self.step_seconds) if self.step_seconds else 0.0
