"""The trace reduction and every metric reader on a recorded list of
profiler events (Chrome-trace form, microseconds), with overlapping device
intervals: busy time is their union, not their sum."""
import pytest

from port_bench.lib import spec
from port_bench.lib.trace import Trace, gaps, union_length

SPAN = "port_bench.window"


def ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


EVENTS = [
    ev(SPAN, "user_annotation", 1000.0, 1000.0),  # the window: [1000, 2000)
    ev("port_bench.window_call", "user_annotation", 1000.0, 50.0),
    ev("cudaGraphLaunch", "cuda_runtime", 1750.0, 150.0),
    ev("void cudnn::bn_fw_tr_1C11_kernel_NCHW<float>", "kernel", 1050.0, 200.0),  # [1050, 1250)
    ev("void cudnn::bn_bw_1C11_kernel_new<float>", "kernel", 1200.0, 100.0),  # overlaps: [1200, 1300)
    ev("upsample_bilinear2d_out_frame", "kernel", 1400.0, 100.0),  # [1400, 1500)
    ev("mix_delta_flat_kernel", "kernel", 1500.0, 10.0),  # [1500, 1510)
    ev("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", 1600.0, 100.0),  # [1600, 1700)
    ev("before the window", "kernel", 500.0, 100.0),
    ev("straddles the end", "kernel", 1950.0, 100.0),  # counts [1950, 2000)
    ev("gpu range", "gpu_user_annotation", 1000.0, 1000.0),  # not device work
    ev("instant", "kernel", 1000.0, 0.0) | {"ph": "i"},
]


@pytest.fixture
def trace():
    return Trace.from_chrome(EVENTS, SPAN)


def test_union_and_gaps():
    assert union_length([(0, 2), (1, 3), (5, 6)]) == 4
    assert gaps([(1, 2), (4, 5)], 0, 6) == [(0, 1), (2, 4), (5, 6)]


def test_busy_is_the_union_in_the_window(trace):
    # [1050, 1300) + [1400, 1510) + [1600, 1700) + [1950, 2000) = 250 + 110 + 100 + 50
    assert trace.window_us == 1000.0
    assert trace.busy_us() == pytest.approx(510.0)
    assert trace.time_in(["bn_fw_tr_1C11", "bn_bw_1C11"]) == pytest.approx(300.0)  # each interval once


def test_breakdown(trace):
    ops = dict(trace.device_ops())
    assert ops["void cudnn::bn_fw_tr_1C11_kernel_NCHW<float>"] == pytest.approx(200e-6)
    idle = dict(trace.idle_gaps())
    assert idle["port_bench.window_call"] == pytest.approx(50e-6)  # [1000, 1050)
    assert idle["cudaGraphLaunch"] == pytest.approx(250e-6)  # [1700, 1950)
    assert sum(idle.values()) == pytest.approx(490e-6)


def record(trace, kind="train", **kw):
    cfg = {"compute_dtype": "float32"}
    base = dict(kind=kind, cfg=cfg, traffic={}, device_name="NVIDIA H100 80GB HBM3", trace=trace,
                host={"setup_s": 12.5, "window_s": 2.0, "images": 400, "steps": 25}, traced_steps=2,
                peak_reserved_bytes=3 * 2**30, peaks={"tf32_flops": 1e9, "bf16_flops": 2e9, "hbm_bytes_per_s": 1e9},
                counts={"flops": 1e3, "norm_bytes": 30.0, "upsample_bytes": 10.0, "ram_mix_bytes": 1.0})
    base.update(kw)
    return spec.Record(**base)


def test_end_to_end_readers(trace):
    r = record(trace)
    assert spec.reader("setup_s")(r) == 12.5
    assert spec.reader("train_img_per_s")(r) == 200.0
    assert spec.reader("eval_img_per_s")(r) is None
    assert spec.reader("peak_mem_gib")(r) == 3.0
    e = record(trace, kind="eval")
    assert spec.reader("eval_img_per_s")(e) == 200.0 and spec.reader("peak_mem_gib")(e) is None


def test_per_layer_readers(trace):
    r = record(trace)
    assert spec.reader("idle_share.train")(r) == pytest.approx(49.0)
    assert spec.reader("idle_share.eval")(r) is None
    # 2 steps of 1e3 FLOP over 1 ms at 1e9 FLOP/s
    assert spec.reader("step_mfu.train")(r) == pytest.approx(100.0 * 2e3 / 1e-3 / 1e9)
    # 2 x 30 bytes at 1e9 B/s = 60 ns against 300 us of bn kernels
    assert spec.reader("norm_roofline.train")(r) == pytest.approx(100.0 * 60e-9 / 300e-6)
    assert spec.reader("upsample_roofline.train")(r) == pytest.approx(100.0 * 20e-9 / 100e-6)
    assert spec.reader("ram_mix_roofline.train")(r) == pytest.approx(100.0 * 2e-9 / 10e-6)


def test_readers_report_nothing_without_a_reading(trace):
    quiet = Trace.from_chrome([ev(SPAN, "user_annotation", 0.0, 100.0), ev("other", "kernel", 10.0, 5.0)], SPAN)
    r = record(quiet)
    for name in ("norm_roofline.train", "upsample_roofline.train", "ram_mix_roofline.train"):
        assert spec.reader(name)(r) is None
    assert spec.reader("step_mfu.train")(record(trace, peaks=None)) is None
    assert spec.reader("idle_share.train")(record(None)) is None


def test_eval_host_share_from_the_programs_timing():
    r = record(None, kind="eval", timing={"wall": 10.0, "forward": 1.5, "readback": 0.5, "load": 6.0})
    assert spec.reader("eval_host_share.eval")(r) == pytest.approx(80.0)


def test_a_trace_without_the_window_span_is_refused():
    with pytest.raises(RuntimeError):
        Trace.from_chrome([ev("k", "kernel", 0.0, 1.0)], SPAN)
