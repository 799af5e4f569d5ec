"""The device trace of a traced window: torch.profiler (CPU and CUDA
activity) around the window's calls, exported as a Chrome trace and read
back as intervals.

Device intervals are the kernels, copies and sets the card ran ("kernel",
"gpu_memcpy", "gpu_memset"); busy time is the length of their union, so
overlapping streams count once.  Host intervals are the profiler's CPU
operations and runtime calls and the harness's own spans
(`torch.profiler.record_function`)."""
from __future__ import annotations

import contextlib
import json
import os
import tempfile
from typing import Dict, Iterable, List, Sequence, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "python_function")


def union_length(intervals: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals: Sequence[Tuple[float, float]], start: float, end: float) -> List[Tuple[float, float]]:
    """The idle gaps in [start, end) left by the union of the intervals."""
    out, t = [], start
    for s, e in sorted(intervals):
        if s > t:
            out.append((t, min(s, end)))
        t = max(t, e)
        if t >= end:
            break
    if t < end:
        out.append((t, end))
    return [(s, e) for s, e in out if e > s]


class Trace:
    """Intervals in microseconds on the profiler's clock.

    device: (name, start, end) of every kernel, copy and set; host: (name,
    start, end, category) of the host's events; window: (start, end) of the
    traced window (the harness's span named `window_span`)."""

    def __init__(self, device, host, window, span: str):
        self.device: List[Tuple[str, float, float]] = device
        self.host: List[Tuple[str, float, float, str]] = host
        self.window: Tuple[float, float] = window
        self.span = span

    @classmethod
    def from_chrome(cls, events: Sequence[Dict], window_span: str) -> "Trace":
        device, host, window = [], [], None
        for ev in events:
            if ev.get("ph") != "X" or "dur" not in ev:
                continue
            s = float(ev["ts"])
            e = s + float(ev["dur"])
            cat = ev.get("cat", "")
            if cat in DEVICE_CATS:
                device.append((ev.get("name", ""), s, e))
            elif cat in HOST_CATS:
                if cat == "user_annotation" and ev.get("name") == window_span:
                    window = (s, e)
                host.append((ev.get("name", ""), s, e, cat))
        if window is None:
            raise RuntimeError(f"the trace holds no span {window_span!r}")
        return cls(device, host, window, window_span)

    @property
    def window_us(self) -> float:
        return self.window[1] - self.window[0]

    def in_window(self) -> List[Tuple[str, float, float]]:
        w0, w1 = self.window
        return [(n, max(s, w0), min(e, w1)) for n, s, e in self.device if e > w0 and s < w1]

    def busy_us(self) -> float:
        return union_length((s, e) for _, s, e in self.in_window())

    def time_in(self, patterns: Sequence[str]) -> float:
        """Microseconds of device work in the window whose name holds one of
        the patterns (each interval once)."""
        return sum(e - s for n, s, e in self.in_window() if any(p in n for p in patterns))

    def device_ops(self, top: int = 10) -> List[List]:
        per: Dict[str, float] = {}
        for n, s, e in self.in_window():
            per[n] = per.get(n, 0.0) + (e - s)
        return [[n[:120], us / 1e6] for n, us in sorted(per.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> List[List]:
        """The idle gaps of the window, summed by what the host was doing
        then: the innermost host span over the gap's midpoint (the
        harness's spans, then operators and runtime calls), "host" if none."""
        per: Dict[str, float] = {}
        w0, w1 = self.window
        spans = [h for h in self.host if h[1] < w1 and h[2] > w0 and h[0] != self.span]
        spans.sort(key=lambda h: h[1])
        for gs, ge in gaps([(s, e) for _, s, e in self.in_window()], w0, w1):
            mid = 0.5 * (gs + ge)
            over = [h for h in spans if h[1] <= mid < h[2]]
            name = min(over, key=lambda h: h[2] - h[1])[0] if over else "host"
            per[name] = per.get(name, 0.0) + (ge - gs)
        return [[n[:120], us / 1e6] for n, us in sorted(per.items(), key=lambda kv: -kv[1])[:top]]


@contextlib.contextmanager
def traced(window_span: str, out: List):
    """Profile the block; the block runs its window inside
    `torch.profiler.record_function(window_span)` and synchronises before
    it ends.  On exit `out` holds the Trace.  The Chrome trace goes to a
    temporary file under TMPDIR, removed once read."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        yield
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.remove(path)
    events = data["traceEvents"] if isinstance(data, dict) else data
    out.append(Trace.from_chrome(events, window_span))
