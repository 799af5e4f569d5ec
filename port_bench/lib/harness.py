"""One run of one cell: look up the cell and its configuration's model
family (`families/<reference>.py`, found by the configuration's
`reference` name), run its traffic kind's generator (`lib/<kind>_cell.py`,
found by the kind's name: `lib.train_cell`, `lib.eval_cell`), read the
metrics the cell reports,
check that no JAX module was loaded, and print the result line.

Standard output's last line is one JSON object: correct, attempted, failed,
metrics (the cell's end-to-end metrics with --trace 0, its per-layer
metrics with --trace 1), device, with --trace 1 breakdown, and last
`check`: each compared number with its limit.  Standard error's last lines
are the same numbers and limits.  A run that cannot produce a result
(no card, too few cards, a missing program, a JAX module loaded) exits
non-zero and prints no result line."""
from __future__ import annotations

import dataclasses
import importlib
import json
import sys
import tempfile
from typing import Any, Dict, Optional

from port_bench.lib import spec
from port_bench.lib.spec import RunFailed

FORBIDDEN = ("jax", "jaxlib", "flax", "ramdsir_tpu")


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name (the part before the first dot)
    is one of FORBIDDEN, compared whole."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".", 1)[0] in FORBIDDEN})


@dataclasses.dataclass
class Context:
    """What a cell runner gets."""

    workload: str
    cfg: Dict
    traffic: Dict
    seed: int
    seconds: float
    trace: bool
    device: Any
    t0: float
    workdir: str
    reference: Any
    family: Any
    cache_dir: Optional[str] = None


def cards_needed(bench: Dict, workload: str) -> int:
    return int(spec.workload(bench, workload).get("chips", 1))


def check_device(need: int) -> None:
    import torch

    if not torch.cuda.is_available():
        raise RunFailed("no CUDA device: the benchmark measures the port on the card and never on the CPU")
    if torch.cuda.device_count() < need:
        raise RunFailed(f"the cell needs {need} CUDA devices, {torch.cuda.device_count()} visible")


def context(bench: Dict, workload: str, seed: int, seconds: float, trace: bool, device, t0: float,
            workdir: str, pkg: str = spec.PKG, root: str = spec.ROOT, **kw) -> Context:
    w = spec.workload(bench, workload)
    cfg = spec.config(bench, w["config"], root)
    cfg.setdefault("name", w["config"])
    ref = importlib.import_module(f"port_bench.reference.{cfg['reference']}")
    return Context(workload, cfg, spec.traffic(w["traffic"], pkg), seed, seconds, trace, device, t0, workdir,
                   ref, family_module(cfg["reference"]), **kw)


def family_module(name: str):
    """The model family of the configurations whose `reference` is `name`:
    the module port_bench/families/<name>.py of the `port_bench` package on
    the path (`families/ramdsir.py` says what it holds)."""
    try:
        return importlib.import_module(f"port_bench.families.{name}")
    except ModuleNotFoundError as e:
        if e.name != f"port_bench.families.{name}":
            raise
        raise RunFailed(f"no model family for the configuration's reference {name!r}: port_bench/families/{name}.py")


def kind_module(kind: str):
    """The generator of a traffic kind: the module port_bench/lib/<kind>_cell.py
    of the `port_bench` package on the path, with run(ctx) and control(ctx,
    variant)."""
    try:
        return importlib.import_module(f"port_bench.lib.{kind}_cell")
    except ModuleNotFoundError as e:
        if e.name != f"port_bench.lib.{kind}_cell":
            raise
        raise RunFailed(f"no generator for the traffic kind {kind!r}: port_bench/lib/{kind}_cell.py")


def run_cell(ctx: Context) -> Dict:
    """The traffic kind's runner: dict(host, peak, check, ...)."""
    return kind_module(ctx.traffic["kind"]).run(ctx)


def read_metrics(bench: Dict, ctx: Context, out: Dict, pkg: str = spec.PKG):
    """(metrics, record) of the cell's section for this run."""
    import torch

    from port_bench.lib.peaks import peaks

    name = torch.cuda.get_device_name(0) if torch.device(ctx.device).type == "cuda" else "cpu"
    rec = spec.Record(kind=ctx.traffic["kind"], cfg=ctx.cfg, traffic=ctx.traffic, device_name=name,
                      host=out["host"], peak_reserved_bytes=out.get("peak", 0), counts=out.get("counts", {}),
                      timing=out.get("timing", {}), trace=out.get("trace"), traced_steps=out.get("traced_steps", 0),
                      peaks=peaks(name), pkg=pkg)
    section = "per_layer" if ctx.trace else "end_to_end"
    metrics = {}
    for m in spec.metrics_for(bench, ctx.workload, section):
        value = spec.reader(m["name"], pkg)(rec)
        if value is None:
            if section == "end_to_end":
                raise RunFailed(f"end-to-end metric {m['name']} has no reading in {ctx.workload}")
            continue
        metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return metrics, rec


def judge(check: Dict[str, float], limits: Dict[str, float]) -> Dict[str, Dict[str, float]]:
    missing = sorted(set(limits) - set(check))
    if missing:
        raise RunFailed(f"no reading for the limits {missing}")
    return {k: {"value": float(check[k]), "limit": float(limits[k])} for k in sorted(limits)}


def main(args, t0: float, root: str = spec.ROOT, pkg: str = spec.PKG) -> int:
    bench = spec.benchmark(root)
    need = cards_needed(bench, args.workload)
    check_device(need)
    import torch

    try:
        importlib.import_module("ramdsir_tpu_torch")
    except ImportError as e:
        raise RunFailed(f"the program is missing: {e}")
    limits = spec.limits(args.workload, pkg)
    with tempfile.TemporaryDirectory(prefix="port_bench_") as workdir:
        ctx = context(bench, args.workload, args.seed, float(args.seconds), bool(args.trace), torch.device("cuda:0"),
                      t0, workdir, pkg, root)
        out = run_cell(ctx)
    found = forbidden_modules()
    if found:
        raise RunFailed(f"modules of JAX or the JAX package were loaded: {', '.join(found)}")
    metrics, rec = read_metrics(bench, ctx, out, pkg)
    checked = judge(out["check"], limits)
    correct = all(v["value"] <= v["limit"] for v in checked.values())
    device = {"platform": "gpu", "kind": rec.device_name, "count": need, "memory_peak_bytes": int(rec.peak_reserved_bytes)}
    result = {"correct": correct, "attempted": 1, "failed": 0 if correct else 1, "metrics": metrics, "device": device}
    if rec.trace is not None:
        device["busy_s"] = rec.trace.busy_us() / 1e6
        device["window_s"] = rec.trace.window_us / 1e6
        result["breakdown"] = {"device_ops": rec.trace.device_ops(), "idle_gaps": rec.trace.idle_gaps()}
    extra = dict(out.get("extra") or {})
    extra.update({f"unjudged.{k}": v for k, v in out["check"].items() if k not in limits})
    if extra:
        result["extra"] = extra
    result["check"] = checked
    for k, v in checked.items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
