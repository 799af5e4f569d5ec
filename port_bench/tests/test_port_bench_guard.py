"""What a run refuses: JAX or the JAX package loaded (compared by whole
top-level names, since the port's name begins with the JAX package's), no
CUDA card, a checkout without the program; and what the harness and the
reference import."""
import json
import os
import shutil
import subprocess
import sys

from port_bench.lib import harness, spec

ROOT = spec.ROOT


def test_the_guard_compares_whole_top_level_names():
    loaded = ["ramdsir_tpu_torch", "ramdsir_tpu_torch.train.loop", "jaxtyping", "flaxen", "torch",
              "jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "ramdsir_tpu", "ramdsir_tpu.ops.ram"]
    assert harness.forbidden_modules(loaded) == ["flax.linen", "jax", "jax.numpy", "jaxlib.xla_client",
                                                 "ramdsir_tpu", "ramdsir_tpu.ops.ram"]


def _run(code: str, cwd: str = ROOT, env=None):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, capture_output=True, text=True, timeout=300,
                          env=env)


def _references() -> list:
    """The `reference` names of the benchmark's configurations: each names a
    plain reference and a model family."""
    bench = spec.benchmark()
    return sorted({spec.config(bench, c["name"])["reference"] for c in bench["configs"]})


def test_the_harness_and_the_program_load_no_jax():
    families = ", ".join(f"port_bench.families.{r}, port_bench.reference.{r}" for r in _references())
    code = ("import sys; sys.path.insert(0, '.');"
            "import port_bench.lib.harness, port_bench.lib.train_cell, port_bench.lib.eval_cell;"
            f"import {families}, port_bench.tools.readings;"
            "import ramdsir_tpu_torch.train.loop, ramdsir_tpu_torch.train.steps, ramdsir_tpu_torch.train.evaluate;"
            "from port_bench.lib.harness import forbidden_modules; print(forbidden_modules())")
    out = _run(code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_the_reference_imports_nothing_of_the_program():
    references = ", ".join(f"port_bench.reference.{r}" for r in _references())
    code = (f"import sys; sys.path.insert(0, '.'); import {references};"
            "print(sorted({m.split('.')[0] for m in sys.modules} & {'ramdsir_tpu', 'ramdsir_tpu_torch', 'jax'}))")
    out = _run(code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_a_run_without_a_card_fails_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "port_bench/run.py", "--workload", "fundus.train", "--seed", "3000000017",
                          "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env=env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no CUDA device" in out.stderr


def test_a_checkout_without_the_program_fails_and_prints_no_result(tmp_path):
    shutil.copytree(os.path.join(ROOT, "port_bench"), tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    out = subprocess.run([sys.executable, "port_bench/run.py", "--workload", "fundus.train", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    # past the look for a card, the missing program stops it
    code = ("import sys, time, types; sys.path.insert(0, '.'); from port_bench.lib import harness;"
            "harness.check_device = lambda need: None;"
            "args = types.SimpleNamespace(workload='fundus.train', seed=1, seconds=1, trace=0);"
            f"harness.main(args, time.perf_counter(), root={str(tmp_path)!r}, pkg={str(tmp_path / 'port_bench')!r})")
    out = _run(code, cwd=str(tmp_path))
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "the program is missing" in out.stderr


def test_the_benchmark_file_keeps_to_the_contract():
    bench = spec.benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names)) and "setup_s" in names
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for w in bench["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
    assert len(json.dumps(bench)) < 64 * 1024
