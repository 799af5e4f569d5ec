"""The readers of the program's own spans (`lib.spans` and the metrics
eval_load_share.eval, eval_decode_share.eval, eval_post_share.eval,
replay_gap_us.train) on recorded lists of profiler events (Chrome-trace
form, microseconds): a gap under a replay span, spans straddling the
window's edges, nested and overlapping spans counted once, and no reading
where the spans are absent, as in a program that has none."""
import pytest

from port_bench.lib import spec
from port_bench.lib.trace import Trace

SPAN = "port_bench.window"


def ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def span(name, ts, dur):
    return ev(name, "user_annotation", ts, dur)


def record(events, kind):
    return spec.Record(kind=kind, cfg={}, traffic={}, device_name="NVIDIA H100 80GB HBM3",
                       host={"setup_s": 1.0, "window_s": 1.0}, trace=Trace.from_chrome(events, SPAN))


EVAL = [
    span(SPAN, 1000.0, 1000.0),  # the window: [1000, 2000)
    span("port_bench.eval_pass", 1000.0, 1000.0),
    span("ramdsir.eval.load", 900.0, 200.0),  # straddles the start: [1000, 1100) counts
    span("ramdsir.data.decode", 950.0, 100.0),  # [1000, 1050)
    span("ramdsir.eval.load", 1300.0, 200.0),  # [1300, 1500)
    span("ramdsir.eval.load", 1350.0, 50.0),  # nested in the one before: counted once
    span("ramdsir.data.decode", 1320.0, 100.0),  # [1320, 1420)
    span("ramdsir.data.decode", 1400.0, 60.0),  # overlaps the one before: [1320, 1460) in all
    span("ramdsir.eval.post", 1900.0, 300.0),  # straddles the end: [1900, 2000)
    span("ramdsir.eval.post", 2100.0, 100.0),  # after the window
    span("ramdsir.eval.loader", 1600.0, 100.0),  # another name
    ev("ramdsir.eval.load", "gpu_user_annotation", 1500.0, 100.0),  # the device's copy of a range: not a span
    ev("aten::copy_", "cpu_op", 1600.0, 50.0),
    ev("kernel", "kernel", 1150.0, 50.0),
]


def test_eval_shares_are_the_spans_union_in_the_window():
    r = record(EVAL, "eval")
    assert spec.reader("eval_load_share.eval")(r) == pytest.approx(30.0)  # 100 + 200 of 1000
    assert spec.reader("eval_decode_share.eval")(r) == pytest.approx(19.0)  # 50 + 140
    assert spec.reader("eval_post_share.eval")(r) == pytest.approx(10.0)
    assert spec.reader("eval_load_share.eval")(record(EVAL, "train")) is None


TRAIN = [
    span(SPAN, 1000.0, 1000.0),
    span("port_bench.window_call", 1000.0, 700.0),
    span("ramdsir.train.window", 1000.0, 700.0),
    span("ramdsir.train.replay", 900.0, 150.0),  # starts before the window: its gap counts, it does not
    span("ramdsir.train.replay", 1100.0, 100.0),
    span("ramdsir.train.replay", 1400.0, 50.0),
    span("ramdsir.train.replay", 1900.0, 300.0),  # straddles the end
    ev("cudaGraphLaunch", "cuda_runtime", 1100.0, 100.0),
    ev("k0", "kernel", 1020.0, 100.0),  # gap [1000, 1020), midpoint 1010 in the first replay: 20
    ev("k1", "kernel", 1180.0, 200.0),  # gap [1120, 1180), midpoint 1150 in the second: 60
    ev("k2", "kernel", 1380.0, 60.0),  # gap [1380, 1380) none
    ev("k3", "kernel", 1470.0, 400.0),  # gap [1440, 1470), midpoint 1455 after the third (ends 1450): 0
    ev("k4", "kernel", 1880.0, 10.0),  # gap [1870, 1880) outside; gap [1890, 2000), midpoint 1945 in the fourth: 110
]


def test_replay_gap_is_the_idle_under_replay_spans_a_replay():
    r = record(TRAIN, "train")
    # (20 + 60 + 110) over the 3 replays that start in the window
    assert spec.reader("replay_gap_us.train")(r) == pytest.approx(190.0 / 3)
    assert spec.reader("replay_gap_us.train")(record(TRAIN, "eval")) is None


def test_no_reading_without_the_programs_spans():
    bare = [e for e in EVAL + TRAIN if not e["name"].startswith("ramdsir.")] + [span(SPAN, 1000.0, 1000.0)]
    bare = [e for i, e in enumerate(bare) if e["name"] != SPAN or i == len(bare) - 1]
    for name, kind in (("eval_load_share.eval", "eval"), ("eval_decode_share.eval", "eval"),
                       ("eval_post_share.eval", "eval"), ("replay_gap_us.train", "train")):
        assert spec.reader(name)(record(bare, kind)) is None
    untraced = spec.Record(kind="eval", cfg={}, traffic={}, device_name="x", host={})
    assert spec.reader("eval_load_share.eval")(untraced) is None
