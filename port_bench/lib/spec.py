"""Finding the benchmark's pieces by name.

BENCHMARK.json (at the checkout's root) names each cell's configuration and
traffic mix and each metric; the files behind the names:

  port_bench/configs/<config>.json          sizes, flags, source, precision;
                                            "reference" names its family,
                                            "program" holds TrainConfig
                                            fields passed as given
  port_bench/families/<reference>.py        the model family: the port's
                                            TrainConfig, data, draws and
                                            counts (`families/ramdsir.py`)
  port_bench/reference/<reference>.py       the family's plain reference
  port_bench/traffic/<mix>.json             the mix's parameters ("kind"
                                            picks the general generator)
  port_bench/lib/<kind>_cell.py             a kind's generator: run(ctx)
  port_bench/limits/<workload>.json         the cell's correctness limits
  port_bench/metrics/<metric>.py            read(record) -> number or None
  port_bench/metrics/<metric>.kernels/*.txt kernel name patterns, one file
                                            an implementation

Adding a cell, a mix, a metric or a model family adds files and entries; no
file is edited.
"""
from __future__ import annotations

import dataclasses
import glob
import importlib.util
import json
import os
import sys
from typing import Any, Dict, List, Mapping, Optional

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PKG)


class RunFailed(SystemExit):
    """A run that prints no result: the message on standard error, exit 2."""

    def __init__(self, message: str):
        print(message, file=sys.stderr, flush=True)
        super().__init__(2)


def load_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> Dict:
    path = os.path.join(root, "BENCHMARK.json")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no BENCHMARK.json at {root}")
    return load_json(path)


def workload(bench: Mapping, name: str) -> Dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: Mapping, name: str, root: str = ROOT) -> Dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return load_json(os.path.join(root, c["file"]))
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str, pkg: str = PKG) -> Dict:
    return load_json(os.path.join(pkg, "traffic", f"{name}.json"))


def limits(workload_name: str, pkg: str = PKG) -> Dict[str, float]:
    return load_json(os.path.join(pkg, "limits", f"{workload_name}.json"))


def metrics_for(bench: Mapping, workload_name: str, section: str) -> List[Dict]:
    """The metrics of `section` ("end_to_end" or "per_layer") that the cell
    reports: those with no `workloads` key, and those that list it."""
    return [m for m in bench[section] if "workloads" not in m or workload_name in m["workloads"]]


def reader(metric: str, pkg: str = PKG):
    """The `read` function of port_bench/metrics/<metric>.py."""
    path = os.path.join(pkg, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(f"port_bench_metric_{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def kernel_patterns(metric: str, pkg: str = PKG) -> List[str]:
    """Every pattern of every port_bench/metrics/<metric>.kernels/*.txt file
    (one a line; '#' starts a comment)."""
    out = []
    for path in sorted(glob.glob(os.path.join(pkg, "metrics", f"{metric}.kernels", "*.txt"))):
        with open(path) as f:
            for line in f:
                line = line.split("#", 1)[0].strip()
                if line:
                    out.append(line)
    return out


@dataclasses.dataclass
class Record:
    """What a run measured, for the metric readers.

    kind: the traffic's kind ("train", "eval"); cfg, traffic: the files'
    contents; host: host-clock readings (setup_s, window_s, and per kind
    steps, images, passes); peak_reserved_bytes; counts: the per-step work
    (the family's `step_counts`, train); timing: the eval passes' phases
    summed (the program's `res.timing`); trace: the traced window's
    `lib.trace.Trace` (None without --trace 1); peaks: the card's
    published peaks (None for an unknown card)."""

    kind: str
    cfg: Dict
    traffic: Dict
    device_name: str
    host: Dict[str, float]
    peak_reserved_bytes: int = 0
    counts: Dict[str, float] = dataclasses.field(default_factory=dict)
    timing: Dict[str, float] = dataclasses.field(default_factory=dict)
    trace: Optional[Any] = None
    traced_steps: int = 0
    peaks: Optional[Dict[str, float]] = None
    pkg: str = PKG

    def kernels(self, metric: str) -> List[str]:
        return kernel_patterns(metric, self.pkg)
