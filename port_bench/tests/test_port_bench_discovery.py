"""The benchmark finds its configurations, traffic mixes, traffic kinds,
limits and metric readers by the names in BENCHMARK.json, and a cell, a mix,
a kind or a metric added as files and entries is found without an edit to
any file."""
import json
import os
import shutil
import subprocess
import sys

import pytest

from port_bench.lib import harness, spec


def test_every_name_in_the_benchmark_has_its_files():
    bench = spec.benchmark()
    for w in bench["workloads"]:
        cfg = spec.config(bench, w["config"])
        assert cfg["reference"] == "ramdsir"
        assert callable(harness.kind_module(spec.traffic(w["traffic"])["kind"]).run)
        assert spec.limits(w["name"])
    for section in ("end_to_end", "per_layer"):
        for m in bench[section]:
            assert callable(spec.reader(m["name"]))


def test_metrics_for_a_cell_follow_their_workloads_key():
    bench = spec.benchmark()
    e2e = {m["name"] for m in spec.metrics_for(bench, "fundus.eval", "end_to_end")}
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
