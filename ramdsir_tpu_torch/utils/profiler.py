"""Step timing and throughput (PyTorch port of `ramdsir_tpu/utils/profiler.py`),
the --trace_dir profiler window (`ramdsir_tpu/train/loop.py:386-393`), and
`trace_context`, a profiler trace around any block."""
from __future__ import annotations

import contextlib
import os
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
    def steps_per_sec(self) -> float:
        n = self.steps - self.warmup
        return n / self.elapsed if self._t0 and self.elapsed > 0 else 0.0

    @property
    def median_step_ms(self) -> float:
        return 1e3 * statistics.median(self.step_seconds) if self.step_seconds else 0.0


class TraceWindow:
    """torch.profiler over steps FIRST..LAST of a run (--trace_dir; 2-12, as
    the JAX package's jax.profiler window, which skips the compile step):
    CPU activity and, on a CUDA device, the card's kernels.  The trace stops
    after a CUDA synchronise when step LAST ends, or at `close()` if the run
    ends first, and goes to `trace_dir` as a Chrome trace; `path` names the
    file.  It reads the steps and changes none of them."""

    FIRST, LAST = 2, 12

    def __init__(self, trace_dir: str, device: Union[str, torch.device]):
        self.trace_dir = trace_dir
        self.device = torch.device(device)
        self.path: Optional[str] = None
        self._prof = None
        self._last_seen = self.FIRST

    def before_step(self, step: int) -> None:
        if step == self.FIRST and self._prof is None and self.path is None:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=activities)
            self._prof.start()

    def after_step(self, step: int) -> None:
        self._last_seen = step
        if step == self.LAST:
            self.close()

    def close(self) -> None:
        if self._prof is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._prof.stop()
        os.makedirs(self.trace_dir, exist_ok=True)
        self.path = os.path.join(self.trace_dir, f"trace_steps_{self.FIRST}-{self._last_seen}.json")
        self._prof.export_chrome_trace(self.path)
        self._prof = None
        print(f"profiler trace (steps {self.FIRST}-{self._last_seen}) written to {self.path}", flush=True)


@contextlib.contextmanager
def trace_context(trace_dir: Optional[str]) -> Iterator[Optional[str]]:
    """A torch.profiler trace of the block (CPU activity and, where CUDA is
    available, the card's kernels, after a synchronise) written into
    `trace_dir` as a Chrome trace, `trace.json`; yields its path.  With no
    directory, a no-op that yields None."""
    if not trace_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, "trace.json")
    with profile(activities=activities) as prof:
        yield path
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)
