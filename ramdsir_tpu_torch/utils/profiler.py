"""Step timing and throughput (PyTorch port of `ramdsir_tpu/utils/profiler.py`),
`span`, the port's named ranges on the profiler's clock, the --trace_dir
profiler window (`ramdsir_tpu/train/loop.py:386-393`), and `trace_context`,
a profiler trace around any block."""
from __future__ import annotations

import contextlib
import os
import statistics
import time
from typing import Dict, Iterator, List, Optional, Union

import torch

_profiler_enabled = torch._C._autograd._profiler_enabled


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


class span:
    """`with span(name, timing=None, key=None):` a named range of host time.

    While a torch.profiler records (`torch._C._autograd._profiler_enabled()`)
    it enters `torch.profiler.record_function(name)`, so the range shows in
    the trace on the device timeline's clock; otherwise it enters nothing.
    Given a `timing` dict it adds the range's host seconds to
    `timing[key or name]`.  With no profiler recording it costs that check
    and, with a dict, two `time.perf_counter()` reads.  The port's ranges
    are named `ramdsir.<layer>.<what>`."""

    __slots__ = ("name", "timing", "key", "_range", "_t0")

    def __init__(self, name: str, timing: Optional[Dict[str, float]] = None, key: Optional[str] = None):
        self.name, self.timing, self.key = name, timing, key or name
        self._range = None

    def __enter__(self) -> "span":
        if _profiler_enabled():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        if self.timing is not None:
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        if self.timing is not None:
            self.timing[self.key] = self.timing.get(self.key, 0.0) + time.perf_counter() - self._t0
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None


class _Recording:
    """A started torch.profiler: CPU activity and, on a CUDA device, the
    card's kernels and copies.  `export(path)` synchronises the card,
    stops and writes a Chrome trace; `stop()` discards it."""

    def __init__(self, device: torch.device):
        from torch.profiler import ProfilerActivity, profile

        self.device = device
        cuda = [ProfilerActivity.CUDA] if device.type == "cuda" else []
        self._prof = profile(activities=[ProfilerActivity.CPU] + cuda)
        self._prof.start()

    def stop(self) -> None:
        self._prof.stop()

    def export(self, path: str) -> str:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._prof.stop()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._prof.export_chrome_trace(path)
        return path


class TraceWindow:
    """torch.profiler over the training path of a run (--trace_dir), as it
    trains: graph replays on a card, windows of W steps.  The trace opens
    before the first window that starts at or after step FIRST and is not
    the run's first (which holds the eager warm-up steps and, on a card,
    the graph's capture), and closes when the window that holds step LAST
    has been queued and has run (a CUDA synchronise): one whole window at
    least, steps FIRST..LAST at a step a window.  A run with no such window
    traces its last window if that holds or follows step FIRST.  The trace
    goes to `trace_dir` as a Chrome trace named by its steps; `path` names
    the file.  It reads the steps and changes none of them."""

    FIRST, LAST = 2, 12

    def __init__(self, trace_dir: str, device: Union[str, torch.device]):
        self.trace_dir = trace_dir
        self.device = torch.device(device)
        self.path: Optional[str] = None
        self._rec: Optional[_Recording] = None
        self._windows = 0
        self._first = self._last = self.FIRST

    def before_window(self, step: int, w: int, end: int) -> None:
        """Before the window of steps step..step+w-1; `end`, the step the
        run stops at."""
        if self._rec is not None or self.path is not None:
            return
        whole = step >= self.FIRST and self._windows > 0
        last = step + w > self.FIRST and step + w >= end
        if whole or last:
            self._first = step
            self._rec = _Recording(self.device)

    def after_window(self, end: int) -> None:
        """After the window that ends before step `end` has been queued."""
        self._windows += 1
        self._last = end - 1
        if end - 1 >= self.LAST:
            self.close()

    def close(self) -> None:
        if self._rec is None:
            return
        self.path = os.path.join(self.trace_dir, f"trace_steps_{self._first}-{self._last}.json")
        self._rec.export(self.path)
        self._rec = None
        print(f"profiler trace (steps {self._first}-{self._last}) written to {self.path}", flush=True)


@contextlib.contextmanager
def trace_context(trace_dir: Optional[str]) -> Iterator[Optional[str]]:
    """A torch.profiler trace of the block (CPU activity and, where CUDA is
    available, the card's kernels, after a synchronise) written into
    `trace_dir` as a Chrome trace, `trace.json`; yields its path.  With no
    directory, a no-op that yields None."""
    if not trace_dir:
        yield None
        return
    path = os.path.join(trace_dir, "trace.json")
    rec = _Recording(torch.device("cuda" if torch.cuda.is_available() else "cpu"))
    try:
        yield path
    except BaseException:
        rec.stop()
        raise
    rec.export(path)
