"""What the per-layer metric readers (`port_bench/metrics/<metric>.py`)
share: a kernel group's share of its roofline and the device's idle share,
each from a run's `spec.Record`."""
from __future__ import annotations

from typing import Optional


def roofline(rec, metric: str, count_key: str) -> Optional[float]:
    """The least time the card needs for the traced steps' `count_key`
    bytes (`lib.counts`) at its HBM bandwidth, over the device time of the
    kernels that <metric>.kernels/*.txt name, in %; nothing for a run that
    is not a traced training run, or when no such kernel ran."""
    if rec.kind != "train" or rec.trace is None or not rec.peaks or not rec.traced_steps:
        return None
    us = rec.trace.time_in(rec.kernels(metric))
    if us <= 0:
        return None
    bound_s = rec.counts[count_key] * rec.traced_steps / rec.peaks["hbm_bytes_per_s"]
    return 100.0 * bound_s / (us / 1e6)


def idle_share(rec, kind: str) -> Optional[float]:
    """The share of the traced window in which no kernel, copy or set ran
    on the card, 100 x (1 - union of the device intervals / the window's
    wall), from torch.profiler's trace; nothing outside a traced run of a
    `kind` cell."""
    if rec.kind != kind or rec.trace is None or rec.trace.window_us <= 0:
        return None
    return 100.0 * (1.0 - rec.trace.busy_us() / rec.trace.window_us)
