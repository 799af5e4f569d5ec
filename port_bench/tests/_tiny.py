"""Contexts of the benchmark's cells, and of those in KEPT_OUT, at a size a
CPU test run holds: 32^2 images, a few images a domain (an epoch of six
steps, as many as the steps compared), short windows, three supervised
steps for the eval weights (cached under the test's directory)."""
import importlib
import time

import torch

from port_bench.lib import harness, spec

SMALL = {
    "fundus": dict(image_size=32, train_per_domain=[6, 36, 14], test_images=3, original_size=40),
    "prostate": dict(image_size=32, train_per_domain=[12, 4, 4, 4, 4], test_volumes=2, volume_depth=10),
}


# cells whose path, traffic and limits the benchmark keeps, tested here, that
# BENCHMARK.json does not run: fundus.eval's host-clock rate spread too widely
# between runs to hold any bound the contract allows (PERF.md, section 7)
KEPT_OUT = {"fundus.eval": {"name": "fundus.eval", "config": "fundus", "traffic": "eval", "chips": 1}}


def entry(workload: str):
    """The cell's BENCHMARK.json entry, or its entry in KEPT_OUT."""
    return KEPT_OUT.get(workload) or spec.workload(spec.benchmark(), workload)


def tiny_context(workload: str, workdir: str, seed: int = 123, trace: bool = False, seconds: float = 0.3, **kw):
    torch.set_num_threads(2)
    bench = spec.benchmark()
    w = entry(workload)
    cfg = dict(spec.config(bench, w["config"]), **SMALL[w["config"]])
    traffic = dict(spec.traffic(w["traffic"]), warmup_steps=2, trace_seconds=0.3, weights_steps=3, weights_images=8)
    ref = importlib.import_module(f"port_bench.reference.{cfg['reference']}")
    return harness.Context(workload, cfg, traffic, seed, seconds, trace, torch.device("cpu"), time.perf_counter(),
                           workdir, ref, harness.family_module(cfg["reference"]), cache_dir=f"{workdir}/cache", **kw)


def judged(workload: str, check):
    """(correct, the judged numbers) of a run's check under the cell's limits."""
    got = harness.judge(check, spec.limits(workload))
    return all(v["value"] <= v["limit"] for v in got.values()), got
