"""The benchmark finds its configurations, model families, traffic mixes,
traffic kinds, limits and metric readers by the names in BENCHMARK.json, and
a cell, a mix, a kind, a metric or a model family added as files and entries
is found without an edit to any file."""
import json
import os
import shutil
import subprocess
import sys

import pytest

from port_bench.lib import harness, spec


def every_name_has_its_files(root: str = spec.ROOT, pkg: str = spec.PKG):
    """Each cell's configuration, model family, traffic kind and limits, and
    each metric's reader, found by name in the checkout at `root`."""
    bench = spec.benchmark(root)
    for w in bench["workloads"]:
        cfg = spec.config(bench, w["config"], root)
        assert callable(harness.family_module(cfg["reference"]).program_config)
        assert callable(harness.kind_module(spec.traffic(w["traffic"], pkg)["kind"]).run)
        assert spec.limits(w["name"], pkg)
    for section in ("end_to_end", "per_layer"):
        for m in bench[section]:
            assert callable(spec.reader(m["name"], pkg))


def test_every_name_in_the_benchmark_has_its_files():
    every_name_has_its_files()


def test_metrics_for_a_cell_follow_their_workloads_key():
    bench = spec.benchmark()
    e2e = {m["name"] for m in spec.metrics_for(bench, "prostate.eval", "end_to_end")}
    assert e2e == {"setup_s", "eval_img_per_s"}
    per_layer = {m["name"] for m in spec.metrics_for(bench, "prostate.train", "per_layer")}
    assert "norm_roofline.train" in per_layer and "idle_share.eval" not in per_layer


def test_roofline_patterns_come_from_every_implementation_file():
    pats = spec.kernel_patterns("upsample_roofline.train")
    assert "upsample_bilinear2d" in pats and "upsample2x_backward_kernel" in pats


@pytest.fixture
def copy_of_the_benchmark(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(spec.PKG, root / "port_bench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), root / "BENCHMARK.json")
    return root


def test_an_added_cell_mix_metric_and_kernel_file_are_found(copy_of_the_benchmark):
    root = copy_of_the_benchmark
    pkg = root / "port_bench"
    (pkg / "traffic" / "train_short.json").write_text(json.dumps({"kind": "train", "compared_steps": 3,
                                                                 "warmup_steps": 4, "trace_seconds": 2}))
    (pkg / "limits" / "fundus.train_short.json").write_text(json.dumps({"loss_gap": 1.0}))
    (pkg / "metrics" / "steps_a_window.train.py").write_text("def read(rec):\n    return rec.host.get('steps')\n")
    (pkg / "metrics" / "norm_roofline.train.kernels" / "fused.txt").write_text("my_fused_norm_kernel\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "fundus.train_short", "config": "fundus", "traffic": "train_short",
                               "chips": 1, "why": "a test cell"})
    bench["per_layer"].append({"name": "steps_a_window.train", "unit": "steps", "better": "higher",
                               "source": "host_clock", "layer": "device", "moves": "train_img_per_s",
                               "workloads": ["fundus.train_short"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    bench = spec.benchmark(str(root))
    w = spec.workload(bench, "fundus.train_short")
    assert spec.config(bench, w["config"], str(root))["dataset"] == "fundus"
    assert spec.traffic(w["traffic"], str(pkg))["warmup_steps"] == 4
    assert spec.limits("fundus.train_short", str(pkg)) == {"loss_gap": 1.0}
    names = [m["name"] for m in spec.metrics_for(bench, "fundus.train_short", "per_layer")]
    assert names == ["steps_a_window.train"]
    rec = spec.Record(kind="train", cfg={}, traffic={}, device_name="x", host={"steps": 7}, pkg=str(pkg))
    assert spec.reader("steps_a_window.train", str(pkg))(rec) == 7
    assert "my_fused_norm_kernel" in rec.kernels("norm_roofline.train")
    assert "bn_bw_1C11" in rec.kernels("norm_roofline.train")


def test_an_added_traffic_kind_is_found(copy_of_the_benchmark):
    root = copy_of_the_benchmark
    pkg = root / "port_bench"
    (pkg / "lib" / "replay_cell.py").write_text(
        "def run(ctx):\n"
        "    return {'host': {'setup_s': 1.5, 'window_s': 2.0}, 'check': {'gap': 0.0},\n"
        "            'extra': {'kind': ctx.traffic['kind'], 'steps': ctx.traffic['steps']}}\n")
    (pkg / "traffic" / "replayed.json").write_text(json.dumps({"kind": "replay", "steps": 5}))
    (pkg / "limits" / "fundus.replayed.json").write_text(json.dumps({"gap": 0.1}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "fundus.replayed", "config": "fundus", "traffic": "replayed", "chips": 1,
                               "why": "a test cell of a new kind"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import sys, time, types; sys.path.insert(0, '.'); from port_bench.lib import harness, spec;"
            "bench = spec.benchmark('.');"
            "ctx = harness.context(bench, 'fundus.replayed', 1, 1.0, False, 'cpu', time.perf_counter(), '.',"
            " pkg='port_bench', root='.');"
            "out = harness.run_cell(ctx); print(harness.kind_module('replay').__file__); print(out['extra'])")
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    where, extra = out.stdout.strip().splitlines()[-2:]
    assert where == str(pkg / "lib" / "replay_cell.py")
    assert extra == "{'kind': 'replay', 'steps': 5}"


def test_an_unknown_traffic_kind_fails_the_run():
    with pytest.raises(SystemExit):
        harness.kind_module("no_such_kind")


TOY_FAMILY = '''"""A model family for the test: the RAM-DSIR family's functions, each
TrainConfig it builds kept, its counts marked."""
from port_bench.families import ramdsir
from port_bench.families.ramdsir import make_data, reference_data, step_draws  # noqa: F401

BUILT = []
FLOPS = 1234567.0


def program_config(*args, **kwargs):
    BUILT.append(ramdsir.program_config(*args, **kwargs))
    return BUILT[-1]


def step_counts(c):
    return dict(ramdsir.step_counts(c), flops=FLOPS, toy=1.0)
'''

TOY_RUN = '''import json, sys, time
sys.path.insert(0, ".")
import torch
torch.set_num_threads(2)
from port_bench.families import toy
from port_bench.lib import harness, spec
from port_bench.lib.trace import Trace

sys.path.insert(0, "port_bench/tests")
from test_port_bench_discovery import every_name_has_its_files
every_name_has_its_files(".", "port_bench")
bench = spec.benchmark(".")
ctx = harness.context(bench, "toy.train_tiny", 123, 0.3, False, "cpu", time.perf_counter(), sys.argv[1],
                      pkg="port_bench", root=".")
out = harness.run_cell(ctx)
checked = harness.judge(out["check"], spec.limits("toy.train_tiny", "port_bench"))
rec = spec.Record(kind="train", cfg=ctx.cfg, traffic=ctx.traffic, device_name="stub", host=out["host"],
                  peak_reserved_bytes=3 * 2**30, counts=out["counts"], trace=Trace([], [], (0.0, 1e6), "w"),
                  traced_steps=4, peaks={"tf32_flops": 1e9, "bf16_flops": 2e9, "hbm_bytes_per_s": 1e9},
                  pkg="port_bench")
names = [m["name"] for s in ("end_to_end", "per_layer") for m in spec.metrics_for(bench, "toy.train_tiny", s)]
print(json.dumps({"remat": [c.remat for c in toy.BUILT], "counts": out["counts"], "host": out["host"],
                  "correct": all(v["value"] <= v["limit"] for v in checked.values()), "checked": checked,
                  "read": {n: spec.reader(n, "port_bench")(rec) for n in names}}))
'''


def test_an_added_model_family_runs_a_train_cell(copy_of_the_benchmark, tmp_path):
    """A family, its reference, a configuration with a `program` option, a
    mix and limits, added as files with entries in BENCHMARK.json: the
    copy's names test finds every file, the train kind runs the cell at a
    CPU size through `harness.run_cell` with the option in the port's
    TrainConfig, and the generic metrics read the family's counts."""
    from _tiny import SMALL

    root = copy_of_the_benchmark
    pkg = root / "port_bench"
    (pkg / "families" / "toy.py").write_text(TOY_FAMILY)
    (pkg / "reference" / "toy.py").write_text('"""The RAM-DSIR reference under another name."""\n'
                                              "from port_bench.reference.ramdsir import *  # noqa: F401,F403\n")
    cfg = json.loads((pkg / "configs" / "fundus.json").read_text())
    cfg.update(SMALL["fundus"], name="toy", reference="toy", program={"remat": True})
    (pkg / "configs" / "toy.json").write_text(json.dumps(cfg))
    (pkg / "traffic" / "train_tiny.json").write_text(json.dumps({"kind": "train", "compared_steps": 6,
                                                                "warmup_steps": 2, "trace_seconds": 0.3}))
    shutil.copy(pkg / "limits" / "fundus.train.json", pkg / "limits" / "toy.train_tiny.json")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "toy", "source": "https://arxiv.org/abs/2208.03901",
                             "file": "port_bench/configs/toy.json", "reduced": [], "why": "a test family"})
    bench["workloads"].append({"name": "toy.train_tiny", "config": "toy", "traffic": "train_tiny", "chips": 1,
                               "why": "a test cell of a new model family"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in ("train_img_per_s", "peak_mem_gib", "step_mfu.train"):
            m["workloads"].append("toy.train_tiny")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    (root / "run.py").write_text(TOY_RUN)

    env = dict(os.environ, PYTHONPATH=spec.ROOT)  # the program, beside the copy's port_bench
    out = subprocess.run([sys.executable, "run.py", str(tmp_path / "work")], cwd=root, capture_output=True,
                         text=True, timeout=600, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["remat"] and all(got["remat"])
    assert got["counts"]["flops"] == 1234567.0 and got["counts"]["toy"] == 1.0
    assert got["correct"], got["checked"]
    read, host = got["read"], got["host"]
    assert set(read) == {"setup_s", "train_img_per_s", "peak_mem_gib", "step_mfu.train"}
    assert read["train_img_per_s"] == host["images"] / host["window_s"] > 0
    assert read["peak_mem_gib"] == 3.0
    assert read["step_mfu.train"] == pytest.approx(100.0 * 1234567.0 * 4 / 1.0 / 1e9)


@pytest.mark.parametrize("program,named", [({"no_such_option": 1}, "'no_such_option'"),
                                           ({"image_size": 64}, "'image_size'"),
                                           ({"save_path": "elsewhere"}, "'save_path'"),
                                           ({"global_batch": 48}, "batch_size_list = [16, 16, 16]")])
def test_a_wrong_program_option_fails_the_run(program, named, tmp_path, capsys):
    from _tiny import tiny_context

    ctx = tiny_context("fundus.train", str(tmp_path))
    ctx.cfg["program"] = program
    with pytest.raises(SystemExit):
        harness.run_cell(ctx)
    assert named in capsys.readouterr().err


def test_a_configuration_without_its_family_fails_the_run(capsys):
    with pytest.raises(SystemExit):
        harness.family_module("no_such_family")
    assert "port_bench/families/no_such_family.py" in capsys.readouterr().err
