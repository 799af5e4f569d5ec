#!/usr/bin/env python3
"""The grouped batch-norm kernels (csrc/batch_norm.cu) on one NVIDIA GPU at
every norm shape of a fundus and a prostate training step:
`python3 tools/batch_norm_study.py` from the repository's root.

A step's norms (models/unet.py, counted as port_bench/lib/counts.py counts
them): the encoder's and the seg decoder's over the dual batch (two halves,
one slot), the restoration decoder's DSBN over the RAM half (a group a
domain: fundus 3 + 6 + 7 rows, prostate 5 x 2).  At each distinct shape one
JSON line:

  *_err        the kernels' y, dx, dweight, dbias, mean / invstd and running
               buffers against the plain version (ops/batch_norm.py) run in
               float64 on the same float32 inputs, as a share of each
               result's largest magnitude
  repeat_equal two runs of forward and backward bit-equal
  fwd_ms, bwd_ms
               the device time of a call's kernels (torch.profiler over 10
               calls; no flush): the forward's two, the backward's two, and
               `by_kernel`
  library_fwd_ms, library_bwd_ms
               the same for what the port ran before: cuDNN's train-mode
               F.batch_norm a half or a domain, joined by torch.cat (the
               backward: torch.autograd.grad of it, less its forward)
  plain_ms     the plain version's forward + backward in float32 (its
               kernels' device time)
  bound_ms     5 float32 passes over the activation at the card's rate
               (port_bench/lib/counts.norm_bytes's arithmetic)

then a line a configuration summing a step's norms (each shape times its
count), with `roofline` = bound / (fwd + bwd).  ptxas's registers and
spills come first.  Lines go to stdout and to
chiprun_out/batch_norm_study/study.jsonl.
"""
import json
import os
import re
import subprocess
import sys
import tempfile
from collections import Counter

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "chiprun_out", "batch_norm_study")
# device memory bandwidth by card (NVIDIA data sheets); the first match wins
PEAK_BYTES_PER_S = [("H200", 4.8e12), ("H100 NVL", 3.9e12), ("H100 PCIe", 2.0e12), ("H100", 3.35e12)]
CONFIGS = {"fundus": os.path.join(REPO, "port_bench", "configs", "fundus.json"),
           "prostate": os.path.join(REPO, "port_bench", "configs", "prostate.json")}


def step_norms(cfg):
    """Counter of (rows, C, side, groups) over a step's norms; groups is
    ((rows, stat_rows, slot), ..), the layout the port's norm gives them."""
    sys.path.insert(0, REPO)
    from port_bench.lib.counts import _stages

    bsl = list(cfg["batch_size_list"])
    b = sum(bsl)
    out = Counter()
    for name, rows, _, cout, _, side in _stages(cfg):
        if name.endswith("out1"):
            continue
        if name.startswith("rec_decoder"):
            groups = tuple((r, r, i) for i, r in enumerate(bsl))
        else:
            groups = ((b, b, 0), (b, b, 0))
        out[(rows, cout, side, groups)] += 1
    return out


def emit(line):
    text = json.dumps(line)
    print(text, flush=True)
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(OUT, "study.jsonl"), "a") as f:
        f.write(text + "\n")


def ptxas_info(nvcc, source):
    """{kernel<variant>: [spill line, registers line]} from `nvcc -Xptxas -v`."""
    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xptxas", "-v",
                               "-cubin", "-o", os.path.join(tmp, "bn.cubin"), source],
                              capture_output=True, text=True, timeout=600)
    info, kernel = {}, None
    for ln in (proc.stdout + proc.stderr).splitlines():
        if "Compiling entry function" in ln:
            found = re.search(r"ramdsir_batch_norm_[a-z_]+_kernel", ln)
            kernel = (found.group(0) if found else ln.strip()) + ("<4>" if "ILi4E" in ln else "<1>" if "ILi1E" in ln else "")
        elif kernel and ("registers" in ln or "spill" in ln):
            info.setdefault(kernel, []).append(ln.split(":", 1)[-1].strip())
    return info


def device_ms(torch, fn, reps=10):
    """{kernel name: device ms a call} over `reps` calls, from
    torch.profiler's CUDA activity, after 3 warm-up calls: the kernels'
    own time, without the host's launch overhead or the gaps between."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = Counter()
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            out[e.name] += e.time_range.elapsed_us() / 1e3 / reps
    return dict(out)


def case_inputs(torch, gen, rows, c, side, groups):
    """x with a per-channel offset of a few deviations (the shifted sums'
    hard case), dy, and per-slot weights, biases and running buffers."""
    x = torch.randn((rows, c, side, side), generator=gen, device="cuda")
    x = x * (0.5 + torch.rand((1, c, 1, 1), generator=gen, device="cuda")) + 4.0 * torch.randn((1, c, 1, 1), generator=gen, device="cuda")
    dy = torch.randn((rows, c, side, side), generator=gen, device="cuda")
    slots = groups[-1][2] + 1
    w = [0.5 + torch.rand(c, generator=gen, device="cuda") for _ in range(slots)]
    b = [torch.randn(c, generator=gen, device="cuda") for _ in range(slots)]
    rm = [torch.randn(c, generator=gen, device="cuda") for _ in range(slots)]
    rv = [0.5 + torch.rand(c, generator=gen, device="cuda") for _ in range(slots)]
    return x, dy, w, b, rm, rv


def rel_err(got, want):
    scale = float(want.abs().max())
    return float((got.double() - want.double()).abs().max()) / (scale if scale > 0 else 1.0)


def check_case(torch, bn, x, dy, layout, w, b, rm, rv):
    """The kernels against the float64 plain version: relative errors of y,
    dx, dweight, dbias, mean, invstd, running mean and var; and whether two
    runs are bit-equal."""
    runs = []
    for _ in range(2):
        rms, rvs = [t.clone() for t in rm], [t.clone() for t in rv]
        y, mean, invstd = bn._forward_kernels(x, layout, w, b, rms, rvs, 0.1, 1e-5)
        dx, dw, db = bn._backward_kernels(dy, x, layout, mean, invstd, w)
        runs.append((y, mean, invstd, dx, dw, db, rms, rvs))
    torch.cuda.synchronize()
    flat = lambda r: [r[0], r[1], r[2], r[3], *r[4], *r[5], *r[6], *r[7]]
    repeat_equal = all(torch.equal(p, q) for p, q in zip(flat(runs[0]), flat(runs[1])))
    d = lambda ts: [t.double() for t in ts]
    rms64, rvs64 = d(rm), d(rv)
    y64, mean64, inv64 = bn.batch_norm_forward_plain(x.double(), layout, d(w), d(b), rms64, rvs64, 0.1, 1e-5)
    dx64, dw64, db64 = bn.batch_norm_backward_plain(dy.double(), x.double(), layout, mean64, inv64, d(w))
    y, mean, invstd, dx, dw, db, rms, rvs = runs[0]
    worst = lambda pairs: max(rel_err(g, w_) for g, w_ in pairs)
    return dict(
        y_err=rel_err(y, y64), dx_err=rel_err(dx, dx64), dweight_err=worst(zip(dw, dw64)),
        dbias_err=worst(zip(db, db64)), mean_err=rel_err(mean, mean64), invstd_err=rel_err(invstd, inv64),
        running_err=max(worst(zip(rms, rms64)), worst(zip(rvs, rvs64))), repeat_equal=repeat_equal,
    )


def library_fn(torch, x, layout, w, b, rm, rv):
    """What the port ran before: cuDNN's train-mode batch norm a group,
    joined by torch.cat."""
    import torch.nn.functional as F

    def run():
        pieces, start = [], 0
        for rows, _, slot in layout.groups:
            pieces.append(F.batch_norm(x[start:start + rows], rm[slot], rv[slot], w[slot], b[slot], True, 0.1, 1e-5))
            start += rows
        return torch.cat(pieces)

    return run


def time_case(torch, bn, x, dy, layout, w, b, rm, rv):
    """Device ms a call: the kernels forward and backward (and by kernel),
    the library's forward and forward + backward, the plain version's."""
    fwd = lambda: bn._forward_kernels(x, layout, w, b, rm, rv, 0.1, 1e-5)
    _, mean, invstd = fwd()
    bwd = lambda: bn._backward_kernels(dy, x, layout, mean, invstd, w)
    xr = x.detach().clone().requires_grad_()
    wr = [t.detach().clone().requires_grad_() for t in w]
    br = [t.detach().clone().requires_grad_() for t in b]
    lib = library_fn(torch, xr, layout, wr, br, rm, rv)

    def lib_both():
        torch.autograd.grad(lib(), [xr, *wr, *br], dy)

    def plain_both():
        y, m, i = bn.batch_norm_forward_plain(x, layout, w, b, [None] * len(w), [None] * len(w), 0.1, 1e-5)
        bn.batch_norm_backward_plain(dy, x, layout, m, i, w)

    short = lambda name: (re.search(r"ramdsir_batch_norm_\w+", name) or re.search(r"^[^(<]+", name)).group(0)
    fk, bk = device_ms(torch, fwd), device_ms(torch, bwd)
    lib_fwd = sum(device_ms(torch, lib).values())
    return dict(fwd_ms=sum(fk.values()), bwd_ms=sum(bk.values()),
                by_kernel={short(k): v for k, v in {**fk, **bk}.items()},
                library_fwd_ms=lib_fwd, library_bwd_ms=sum(device_ms(torch, lib_both).values()) - lib_fwd,
                plain_ms=sum(device_ms(torch, plain_both, reps=3).values()))


def main():
    import torch

    sys.path.insert(0, REPO)
    from ramdsir_tpu_torch.ops import batch_norm as bn
    from ramdsir_tpu_torch.ops.cuda_build import nvcc

    os.makedirs(OUT, exist_ok=True)
    name = torch.cuda.get_device_name(0)
    bw = next(v for k, v in PEAK_BYTES_PER_S if k in name)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    emit({"card": card, "torch": torch.__version__, "cuda": torch.version.cuda, "peak_bytes_per_s": bw,
          "ptxas": ptxas_info(nvcc(), bn.SOURCE)})
    torch.backends.cudnn.benchmark = False
    gen = torch.Generator(device="cuda").manual_seed(11)
    failures = []
    for cfg_name, path in CONFIGS.items():
        with open(path) as f:
            cfg = json.load(f)
        totals = Counter()
        for (rows, c, side, groups), count in sorted(step_norms(cfg).items()):
            layout = bn.Layout(groups)
            x, dy, w, b, rm, rv = case_inputs(torch, gen, rows, c, side, groups)
            line = {"config": cfg_name, "shape": [rows, c, side, side], "groups": [g[0] for g in groups],
                    "count": count, "plan": bn._plan_for(x, layout)._asdict()}
            line.update(check_case(torch, bn, x, dy, layout, w, b, rm, rv))
            line.update(time_case(torch, bn, x, dy, layout, w, b, rm, rv))
            line["bound_ms"] = 1e3 * 5 * 4 * x.numel() / bw
            emit(line)
            for k in ("fwd_ms", "bwd_ms", "library_fwd_ms", "library_bwd_ms", "bound_ms"):
                totals[k] += count * line[k]
            # float32 against float64: a few ulps of the largest value, and
            # the statistics' sums over up to 1.5M values
            if not line["repeat_equal"] or max(line[k] for k in line if k.endswith("_err")) > 1e-5:
                failures.append(line)
            del x, dy
            torch.cuda.empty_cache()
        ms = totals["fwd_ms"] + totals["bwd_ms"]
        emit({"config": cfg_name, "step_norms": sum(step_norms(cfg).values()), **totals,
              "kernels_ms": ms, "library_ms": totals["library_fwd_ms"] + totals["library_bwd_ms"],
              "roofline": totals["bound_ms"] / ms})
    if failures:
        raise SystemExit(f"{len(failures)} cases off their plain version or not repeatable")


if __name__ == "__main__":
    main()
