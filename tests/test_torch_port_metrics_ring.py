"""The port's `DeviceMetricsRing` against the JAX package's, on the CPU.

Both rings are given the same tables, one step's 0-d values or a window's
(W,) columns, made with numpy from a seed (the JAX ring jnp arrays, the
port's torch tensors), and each writes through its own package's
`MetricsWriter`.  The rows of the two metrics.jsonl files must be equal
but for the wall-clock field "t": the steps, the `loss/` names, the bare
`lr` row, the float32 values, the log_interval filter, the flush when a
window would overfill the ring, and nothing for an empty flush.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ramdsir_tpu.utils.logging import DeviceMetricsRing as JRing
from ramdsir_tpu.utils.logging import MetricsWriter as JWriter
from ramdsir_tpu_torch.utils.logging import DeviceMetricsRing, MetricsWriter
from tests._torch_threads import torch_threads  # noqa: F401 (module-scoped autouse)

NAMES = ("loss", "loss_bce_1", "loss_dice_1", "loss_rec", "lr")


def _tables(seed, widths):
    """One table per width: 0 a step's scalars, w > 0 a window's columns."""
    rng = np.random.default_rng(seed)
    out = []
    for w in widths:
        shape = () if w == 0 else (w,)
        out.append({k: rng.normal(size=shape).astype(np.float32) * (1e-3 if k == "lr" else 3.0) for k in NAMES})
    return out


def _rows(path):
    return [{k: v for k, v in json.loads(line).items() if k != "t"} for line in open(path)]


def _run_both(tmp_path, tables, cap, log_interval, flush=True, no_prefix=("lr",)):
    """Append `tables` at consecutive steps to both rings; the rows each wrote."""
    jw, tw = JWriter(str(tmp_path / "jax"), use_tensorboard=False), MetricsWriter(str(tmp_path / "port"))
    jring = JRing(jw, cap=cap, log_interval=log_interval, no_prefix=no_prefix)
    tring = DeviceMetricsRing(tw, cap=cap, log_interval=log_interval, no_prefix=no_prefix)
    step = 0
    for table in tables:
        jring.append(step, {k: jnp.asarray(v) for k, v in table.items()})
        tring.append(step, {k: torch.from_numpy(np.array(v)) for k, v in table.items()})
        step += 1 if np.ndim(table["loss"]) == 0 else len(table["loss"])
    if flush:
        jring.flush()
        tring.flush()
    jw.close()
    tw.close()
    return _rows(tmp_path / "jax" / "metrics.jsonl"), _rows(tmp_path / "port" / "metrics.jsonl")


CASES = {
    # (widths of the appended tables, cap, log_interval)
    "scalars": ((0, 0, 0, 0, 0), 8, 1),
    "windows": ((3, 3, 2), 16, 1),
    "interval": ((4, 0, 5, 1), 32, 3),
    "autoflush": ((4, 4, 4), 6, 1),  # the second and third windows overfill the ring: it flushes first
    "autoflush_interval": ((0, 5, 0, 5), 6, 2),
}


@pytest.mark.parametrize("case", list(CASES))
def test_ring_rows_match_jax(tmp_path, case):
    widths, cap, interval = CASES[case]
    want, got = _run_both(tmp_path, _tables(len(widths), widths), cap, interval)
    assert got == want
    steps = sum(max(1, w) for w in widths)
    logged = sorted({r["step"] for r in got})
    assert logged == [s for s in range(steps) if s % interval == 0]
    assert all(("lr" in r) != any(k.startswith("loss/") for k in r) for r in got)  # lr bare, in a row of its own


def test_autoflush_writes_before_the_end(tmp_path):
    """A window that would overfill the ring flushes it first: the earlier
    rows are in the file before any explicit flush, the window's are not."""
    tables = _tables(0, (4, 4))
    want, got = _run_both(tmp_path, tables, cap=6, log_interval=1, flush=False)
    assert got == want and sorted({r["step"] for r in got}) == [0, 1, 2, 3]


def test_empty_flush_writes_nothing(tmp_path):
    want, got = _run_both(tmp_path, [], cap=4, log_interval=1)
    assert got == want == []


def test_no_prefix_names(tmp_path):
    """Every name under loss/ when no name is exempt, as the JAX ring does."""
    want, got = _run_both(tmp_path, _tables(1, (2, 0)), cap=8, log_interval=1, no_prefix=())
    assert got == want and all("lr" not in r for r in got) and any("loss/lr" in r for r in got)


def test_window_larger_than_the_ring_raises(tmp_path):
    ring = DeviceMetricsRing(MetricsWriter(str(tmp_path)), cap=4)
    with pytest.raises(ValueError, match="does not fit"):
        ring.append(0, {"loss": torch.zeros(5)})
