"""Readings for the cells' correctness limits, in one process on the card:
the compared numbers of the program over a run of seeds (each a whole
set-up, a short window and the check), of the program with a change
planted (`lib.plants`: a fault, or tf32_off), and of the reference put in
the program's place (the kind's `control`: bf16, the control; for training
cells also half_batch, a fault, and tf32, a witness).

    python3 port_bench/tools/readings.py --workload fundus.train --first-seed 4000000000 \
        --program 12 --reference bf16=3,half_batch=3 --plant replay_noop=3,stale_rows=3

prints one JSON line a reading and a summary: each number's largest
program reading and, for every other source, its smallest."""
import argparse
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def counts(text: str):
    """"a=3,b=2" -> [("a", 3), ("b", 2)]."""
    out = []
    for part in filter(None, text.split(",")):
        name, n = part.split("=")
        out.append((name, int(n)))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--first-seed", type=int, required=True)
    p.add_argument("--program", type=int, default=12)
    p.add_argument("--reference", default="bf16=3", help="variant=runs of the kind's control(ctx, variant)")
    p.add_argument("--plant", default="", help="change=runs of the program with lib.plants' change planted")
    p.add_argument("--seconds", type=float, default=0.5)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from port_bench.lib import harness, plants, spec

    bench = spec.benchmark(ROOT)
    harness.check_device(1)
    device = torch.device("cuda:0")
    rows = []

    def ctx_for(seed, workdir):
        return harness.context(bench, args.workload, seed, args.seconds, False, device, time.perf_counter(), workdir)

    def emit(row):
        rows.append(row)
        print(json.dumps(row), flush=True)

    runs = [("program", None, args.program)] + [(name, name, n) for name, n in counts(args.plant)]
    for offset, (who, plant, n) in enumerate(runs):
        for i in range(n):
            seed = args.first_seed + 2000 * offset + i
            with tempfile.TemporaryDirectory() as wd:
                ctx = ctx_for(seed, wd)
                with plants.planted(ctx.traffic["kind"], plant, device):
                    out = harness.run_cell(ctx)
            emit({"who": who, "seed": seed, **out["check"], "extra": out.get("extra")})
    for offset, (who, n) in enumerate(counts(args.reference)):
        for i in range(n):
            seed = args.first_seed + 1000 + 2000 * offset + i
            with tempfile.TemporaryDirectory() as wd:
                ctx = ctx_for(seed, wd)
                got = harness.kind_module(ctx.traffic["kind"]).control(ctx, who)
            emit({"who": who, "seed": seed, **got})
    summary = {}
    for r in rows:
        for k, v in r.items():
            if not isinstance(v, (int, float)) or k == "seed":
                continue
            s = summary.setdefault(k, {})
            if r["who"] == "program":
                s["program_max"] = max(s.get("program_max", 0.0), v)
            else:
                s[f"{r['who']}_min"] = min(s.get(f"{r['who']}_min", float("inf")), v)
    print(json.dumps({"summary": summary, "workload": args.workload}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
