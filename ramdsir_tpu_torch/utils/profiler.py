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
    """Step timer with the first `warmup` steps excluded.

    `tick(items, steps)` after `steps` steps have been queued: one step, or
    a window of them.  On the CPU a tick reads the host clock.  On a CUDA
    device it records a CUDA event on the current stream and adds no
    synchronise: the time between two ticks' events is the device-paced
    time of the steps in between (idle gaps while the host queues them
    included), read when the events are done, at `mark()` (after a
    synchronise, at an eval and at the end) or when a property is read.
    `step_seconds` holds each timed step's share of its tick's interval;
    `timed_steps` counts them without reading an event.  Time inside
    `paused()` (eval, checkpoints, a graph capture) counts nowhere: on a
    card the next interval starts at an event recorded after it.
    """

    def __init__(self, warmup: int = 2, device: Union[str, torch.device] = "cpu"):
        self.warmup = warmup
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.steps = 0
        self.items = 0
        self.timed_steps = 0
        self._seconds: List[float] = []
        self._pending: List[tuple] = []  # (start event, end event, steps) not read yet
        self._t0: Optional[float] = None
        self._last = None  # host clock (CPU) or the last event (CUDA)
        self._elapsed = 0.0  # CUDA: seconds of the read intervals
        self._dirty = False  # ticks since the last mark

    def _now(self):
        if not self.cuda:
            return time.perf_counter()
        event = torch.cuda.Event(enable_timing=True)
        event.record(torch.cuda.current_stream(self.device))
        return event

    def tick(self, batch_items: int, steps: int = 1) -> None:
        before, self.steps = self.steps, self.steps + steps
        now = self._now()
        if before < self.warmup <= self.steps:  # the window opens after this tick's steps
            self._t0 = now if not self.cuda else 0.0
            self.items = 0
        elif before >= self.warmup:
            self.items += batch_items
            self.timed_steps += steps
            if self.cuda:
                self._pending.append((self._last, now, steps))
            else:
                self._seconds.extend([(now - self._last) / steps] * steps)
        self._last = now
        self._dirty = True

    def _read(self) -> None:
        """The pending CUDA intervals, waiting for their events."""
        for start, end, steps in self._pending:
            end.synchronize()
            seconds = start.elapsed_time(end) / 1e3
            self._elapsed += seconds
            self._seconds.extend([seconds / steps] * steps)
        self._pending.clear()

    def mark(self) -> None:
        """Close the window at completed work: on a CUDA device synchronise
        and read the intervals; on the CPU extend it to now without adding
        items.  A mark with no tick since the previous one is a no-op:
        whatever ran in between (eval, checkpoints) is not step work."""
        if self.cuda:
            torch.cuda.synchronize(self.device)
            self._read()
        elif self._t0 and self._dirty:
            self._last = time.perf_counter()
        self._dirty = False

    @contextlib.contextmanager
    def paused(self) -> Iterator[None]:
        """Time spent inside counts in neither the throughput window nor
        the next step's time."""
        t = time.perf_counter()
        try:
            yield
        finally:
            if self.cuda:
                if self._last is not None:
                    self._last = self._now()
            else:
                gap = time.perf_counter() - t
                if self._t0 is not None:
                    self._t0 += gap
                if self._last is not None:
                    self._last += gap

    @property
    def step_seconds(self) -> List[float]:
        self._read()
        return self._seconds

    @property
    def elapsed(self) -> float:
        if self._t0 is None:
            return 0.0
        if self.cuda:
            self._read()
            return self._elapsed
        return (self._last or self._t0) - self._t0

    @property
    def items_per_sec(self) -> float:
        return self.items / self.elapsed if self.elapsed > 0 else 0.0

    @property
    def steps_per_sec(self) -> float:
        return self.timed_steps / self.elapsed if self.elapsed > 0 else 0.0

    @property
    def median_step_ms(self) -> float:
        seconds = self.step_seconds
        return 1e3 * statistics.median(seconds) if seconds else 0.0


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
