"""What the per-layer readers of the program's own spans share.

The port names its phases with `torch.profiler.record_function` ranges,
`ramdsir.<layer>.<what>` (`ramdsir_tpu_torch.utils.profiler.span`); in
the Chrome trace they are `user_annotation` events on the host, on the
device timeline's clock.  A program without them gives no reading."""
from __future__ import annotations

import bisect
from typing import List, Optional, Tuple

from port_bench.lib.trace import gaps, union_length


def intervals(trace, name: str) -> List[Tuple[float, float]]:
    """(start, end) of every span named `name`, in microseconds, by start."""
    return sorted((s, e) for n, s, e, cat in trace.host if cat == "user_annotation" and n == name)


def window_share(rec, kind: str, name: str) -> Optional[float]:
    """The share of the traced window that the `name` spans cover, their
    union clipped to the window (nested or overlapping spans count once),
    in %; nothing outside a traced run of a `kind` cell or where no such
    span reaches into the window."""
    if rec.kind != kind or rec.trace is None or rec.trace.window_us <= 0:
        return None
    w0, w1 = rec.trace.window
    inside = [(max(s, w0), min(e, w1)) for s, e in intervals(rec.trace, name) if e > w0 and s < w1]
    if not inside:
        return None
    return 100.0 * union_length(inside) / rec.trace.window_us


def idle_under(rec, kind: str, name: str) -> Optional[float]:
    """The device idle time of the traced window whose gaps' midpoints lie
    inside a `name` span, summed, over the number of such spans that start
    in the window, in microseconds; nothing outside a traced run of a
    `kind` cell or where no such span starts in the window.  The spans
    must not overlap one another (a replay follows the one before)."""
    if rec.kind != kind or rec.trace is None:
        return None
    w0, w1 = rec.trace.window
    spans = intervals(rec.trace, name)
    count = sum(1 for s, _ in spans if w0 <= s < w1)
    if not count:
        return None
    starts = [s for s, _ in spans]
    idle = 0.0
    for gs, ge in gaps([(s, e) for _, s, e in rec.trace.in_window()], w0, w1):
        mid = 0.5 * (gs + ge)
        i = bisect.bisect_right(starts, mid) - 1
        if i >= 0 and mid < spans[i][1]:
            idle += ge - gs
    return idle / count
