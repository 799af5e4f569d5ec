"""The port's spans (`utils.profiler.span`) on the CPU: no profiler range
entered while no profiler records; under torch.profiler, a fundus eval pass
over a PNG tree and a prostate pass over two NIfTI volumes name their
phases (`ramdsir.eval.*`, one `.case` an image or a volume holding its
resize / post / dice, `ramdsir.data.decode` inside `.load`) and
`res.timing` sums the same spans; and a window of `ScanTrainSteps` (eager on the CPU)
shows `ramdsir.train.window` around `.inputs` and one `.eager` a step."""
import contextlib
import time
from unittest import mock

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import ramdsir_tpu_torch.train.state as tstate_mod
from ramdsir_tpu_torch.config import FUNDUS_DOMAINS, PROSTATE_VOLUME_DOMAINS, TrainConfig
from ramdsir_tpu_torch.data.device_pipeline import DeviceFundusPipeline
from ramdsir_tpu_torch.data.synthetic import fundus_arrays, make_fundus_tree, make_prostate_volumes
from ramdsir_tpu_torch.models.unet import Decoder, Encoder, RecDecoder
from ramdsir_tpu_torch.train.evaluate import eval_fundus, eval_prostate_volumes
from ramdsir_tpu_torch.train.state import init_state
from ramdsir_tpu_torch.train.steps import make_train_step
from ramdsir_tpu_torch.utils import profiler
from ramdsir_tpu_torch.utils.profiler import span
from tests._torch_threads import torch_threads  # noqa: F401 (module-scoped autouse)


def ranges(prof, prefix="ramdsir."):
    """{name: [(start, end), ...]} in microseconds of the profiled ranges."""
    out = {}
    for e in prof.events():
        if e.name.startswith(prefix):
            out.setdefault(e.name, []).append((e.time_range.start, e.time_range.end))
    return out


@contextlib.contextmanager
def recorded():
    """The spans entered in the block, {name: [(enter, exit), ...]} in
    seconds of the host clock, as a profiler would see them but without its
    cost or its clock: the check reads True and record_function is a
    stand-in."""
    out = {}

    class Range:
        def __init__(self, name):
            self.name = name

        def __enter__(self):
            self.start = time.perf_counter()

        def __exit__(self, *exc):
            out.setdefault(self.name, []).append((self.start, time.perf_counter()))

    with mock.patch.object(profiler, "_profiler_enabled", lambda: True), \
            mock.patch.object(torch.profiler, "record_function", Range):
        yield out


def within(inner, outer):
    """Each inner range lies in one of the outer ranges."""
    return all(any(s0 <= s and e <= e0 for s0, e0 in outer) for s, e in inner)


def test_span_enters_a_profiler_range_only_while_one_records():
    calls = []
    real = torch.profiler.record_function

    def counted(name, *args):
        calls.append(name)
        return real(name, *args)

    timing = {}
    with mock.patch.object(torch.profiler, "record_function", counted):
        for _ in range(3):
            with span("ramdsir.test.off", timing):
                pass
        assert calls == [] and timing["ramdsir.test.off"] >= 0.0
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with span("ramdsir.test.on", timing, "on"):
                with span("ramdsir.test.inner"):
                    pass
    assert calls == ["ramdsir.test.on", "ramdsir.test.inner"] and set(timing) == {"ramdsir.test.off", "on"}
    r = ranges(prof)
    assert within(r["ramdsir.test.inner"], r["ramdsir.test.on"])


# `res.timing`'s keys and the spans each one sums
FUNDUS_KEYS = {"load": "load", "forward": "forward", "readback": "readback", "dequantise": "dequantise",
               "resize": "resize", "postprocess": "post", "save": "save", "dice": "dice", "distances": "distances",
               "wall": "pass"}
PROSTATE_KEYS = {"load": "load", "windows": "windows", "forward": "forward", "readback": "readback",
                 "scatter": "scatter", "postprocess": "post", "save": "save", "dice": "dice",
                 "distances": "distances", "wall": "pass"}


def probabilities(channels):
    def predict(img, n_valid=None):
        x = torch.as_tensor(np.asarray(img, np.float32)).mean(-1, keepdim=True)  # (B, H, W, 1)
        p = torch.sigmoid((x - x.mean()) / (x.std() + 1e-6)).permute(0, 3, 1, 2)
        return torch.cat([p, 1 - p][:channels] if channels == 2 else [p] * channels, 1)
    return predict


def check_timing(timing, keys, r, counters):
    """Each phase of `timing` against its spans' summed seconds."""
    assert set(timing) == set(keys) | set(counters)
    for key, phase in keys.items():
        spans_s = sum(e - s for s, e in r.get(f"ramdsir.eval.{phase}", []))
        assert abs(timing[key] - spans_s) <= 1e-3 + 0.05 * spans_s, key
    assert {k: timing[k] for k in counters} == counters


@pytest.mark.parametrize("dataset", ["fundus", "prostate"])
def test_an_eval_pass_names_its_phases(tmp_path, dataset):
    root = str(tmp_path)
    if dataset == "fundus":
        make_fundus_tree(root, per_domain_train=0, per_domain_test=3, size=40, domains=(FUNDUS_DOMAINS[0],))
        run = lambda: eval_fundus(probabilities(2), root, 0, batch_size=2, image_size=32)
        keys, counters = FUNDUS_KEYS, {"batches": 2, "cases": 3}
    else:
        make_prostate_volumes(root, per_domain=2, depth=6, size=32, domains=(PROSTATE_VOLUME_DOMAINS[5],))
        run = lambda: eval_prostate_volumes(probabilities(2), root, 5, batch_size=2)
        keys, counters = PROSTATE_KEYS, {"batches": 6, "volumes": 2, "cases": 2}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = run()
    r = ranges(prof)
    cases = r["ramdsir.eval.case"]
    assert len(r["ramdsir.eval.pass"]) == 1 and len(cases) == counters["cases"] == res.num
    for phase in (["resize"] if dataset == "fundus" else []) + ["post", "dice"]:
        assert len(r[f"ramdsir.eval.{phase}"]) == len(cases) and within(r[f"ramdsir.eval.{phase}"], cases), phase
    decodes = r["ramdsir.data.decode"]
    assert len(decodes) == 2 * counters["cases"] and within(decodes, r["ramdsir.eval.load"])
    assert within([s for name, v in r.items() if name != "ramdsir.eval.pass" for s in v], r["ramdsir.eval.pass"])
    with recorded() as spans:  # the timing against the spans on the host clock, clear of the profiler's own work
        res = run()
    check_timing(res.timing, keys, spans, counters)


def test_a_cpu_window_shows_its_upload_and_each_eager_step():
    cfg = TrainConfig(dataset="fundus", domain_idxs=(1, 2, 3), test_domain_idx=0, ram=True, rec=True,
                      consistency=True, consistency_type="kd", image_size=16, is_out_domain=True,
                      global_batch=6, log_images_every=0, device="cpu").resolve()
    pipe = DeviceFundusPipeline.from_arrays(fundus_arrays(per_domain_train=4, size=16), cfg.domain_idxs,
                                            cfg.batch_size_list, cfg.test_domain_idx, seed=0, device="cpu")
    narrow = lambda c: {"encoder": Encoder(c=c.in_channels, n=2), "seg_decoder": Decoder(n=2, num_classes=2),
                        "rec_decoder": RecDecoder(n=2, num_classes=c.in_channels, num_domains=c.num_domains)}
    with mock.patch.object(tstate_mod, "build_models", narrow):
        state = init_state(cfg, torch.Generator().manual_seed(0), "cpu")
    window = make_train_step(cfg, 10, batch_size_list=pipe.batch_sizes, device_data=pipe.device_data, scan=True,
                             window=2)
    plan = {k: v[:2] for k, v in pipe.epoch_plan().items()}
    with recorded() as r:
        window(state, plan, torch.Generator().manual_seed(1))
    assert len(r["ramdsir.train.window"]) == len(r["ramdsir.train.inputs"]) == 1
    assert len(r["ramdsir.train.eager"]) == 2 and "ramdsir.train.replay" not in r
    assert within(r["ramdsir.train.inputs"] + r["ramdsir.train.eager"], r["ramdsir.train.window"])
