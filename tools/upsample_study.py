#!/usr/bin/env python3
"""K2 and K3, the deterministic bilinear x2 upsample's kernels, on one NVIDIA
GPU at every shape a --deterministic training step gives them:
`python3 tools/upsample_study.py [--parent DIR]` from the repository's root.

The shapes are the U-Net's eight upsamples a step at n=16: the seg decoder
over the dual batch and the restoration decoder over the RAM half, for
fundus (batch 16 at 256^2: 32 and 16 rows) and prostate (batch 10 at 384^2:
20 and 10 rows), each in float32 and bfloat16.  At each, one JSON line:

  bit_equal     K3 and K2 against their plain versions (ops/upsample.py)
  aten_*        K3 against aten's CUDA forward (upsample_bilinear2d.vec) of
                the same input and of its float32 copy, as a share of the
                largest output
  *_ms          CUDA events around one call after an L2 flush (chip_smoke's
                `cuda_time_ms`) and `*_kernel_ms`, one call among 20 queued
                back to back (chip_smoke's `back_to_back_ms`): K3, K2,
                aten's forward and its atomics backward
  bound_ms      the bytes bound (chip_smoke's `k2_bytes` at the card's rate)

With --parent DIR (an unpacked earlier checkout), its K2 is built from its
own source and timed in turns with this one (parent, this, this, parent), so
the two are compared on one card in one call.  Then a summary line sums each
step's eight shapes.  ptxas's registers and spills for every kernel come
first.  With --sweep, variants of csrc/upsample2x.cu (VARIANTS: the row walk
unrolled twice, the strip length, the grid's thread target, evict-first
stores) are built from edited copies of the source and each step's K2 and
K3 sums timed through them, beside the source as it is (`as_is`), in turns
(as_is first and last), each held bit-equal to the plain versions.  Lines go to stdout and to
chiprun_out/upsample_study/study.jsonl.
"""
import argparse
import dataclasses
import importlib.util
import json
import os
import re
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "chiprun_out", "upsample_study")
N = 16  # the U-Net's base width


def step_shapes(batch, size):
    """(N, C, H, W) of a step's eight upsample inputs: the seg decoder's four
    stages over the dual batch, then the restoration decoder's over the RAM
    half (models/unet.py: ConvU, ConvURec)."""
    seg = [(2 * batch, 16 * N >> k, size // 16 << k, size // 16 << k) for k in range(4)]
    rec = [(batch, 8 * N >> k, size // 16 << k, size // 16 << k) for k in range(4)]
    return seg + rec


STEPS = {"fundus": step_shapes(16, 256), "prostate": step_shapes(10, 384)}


# (old, new) edits of csrc/upsample2x.cu, each applied wherever it matches
VARIANTS = {
    "unroll_2": [("  for (int k = 0; k < rows; ++k) {", "#pragma unroll 2\n  for (int k = 0; k < rows; ++k) {")],
    "rows_16": [("g.rows = 8;", "g.rows = 16;")],
    "rows_4": [("g.rows = 8;", "g.rows = 4;")],
    "threads_quarter": [("MIN_THREADS = 1LL << 20", "MIN_THREADS = 1LL << 18")],
    "evict_first_stores": [
        ("reinterpret_cast<float4*>(p)[k] = make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);",
         "__stcs(reinterpret_cast<float4*>(p) + k, make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]));"),
        ("reinterpret_cast<uint4*>(p)[k] = make_uint4(", "__stcs(reinterpret_cast<uint4*>(p) + k, make_uint4("),
        ("pack_bf16(v[8 * k + 6], v[8 * k + 7]));", "pack_bf16(v[8 * k + 6], v[8 * k + 7])));"),
    ],
}


def variant_source(src, edits, path):
    text = open(src).read()
    for old, new in edits:
        if not text.count(old):
            raise SystemExit(f"upsample_study: the edit {old!r} matches nothing")
        text = text.replace(old, new)
    with open(path, "w") as f:
        f.write(text)
    return path


def sweep(torch, smoke, upsample, emit):
    """Each variant's step sums of K2 and K3 (back to back), in turns."""
    vdir = os.path.join(OUT, "variants")
    os.makedirs(vdir, exist_ok=True)
    names = ["as_is", *VARIANTS, "as_is"]
    libs = {name: dataclasses.replace(upsample.LIBRARY, source=variant_source(
        upsample.SOURCE, edits, os.path.join(vdir, f"upsample2x_{name}.cu"))) for name, edits in VARIANTS.items()}
    with ThreadPoolExecutor(len(libs)) as pool:
        list(pool.map(lambda lib: lib.path(), libs.values()))  # built at once, loaded at first launch
    libs["as_is"] = upsample.LIBRARY
    gen = torch.Generator(device="cuda").manual_seed(11)
    cases = [(run, dtype, shape, torch.randn(shape, generator=gen, device="cuda").to(dtype),
              torch.randn((shape[0], shape[1], 2 * shape[2], 2 * shape[3]), generator=gen, device="cuda").to(dtype))
             for run, shapes in STEPS.items() for dtype in (torch.float32, torch.bfloat16) for shape in shapes]
    want = [(upsample.upsample2x_forward_plain(x), upsample.upsample2x_backward_plain(g)) for *_, x, g in cases]
    sums = {}
    for turn, name in enumerate(names):
        with mock.patch.object(upsample, "LIBRARY", libs[name]):
            for (run, dtype, shape, x, g), (y, dx) in zip(cases, want):
                equal = torch.equal(upsample.upsample2x_forward(x), y) and torch.equal(upsample.upsample2x_backward(g), dx)
                key = (name, run, str(dtype).split(".")[-1])
                total = sums.setdefault(key, {"k3_kernel_ms": [0.0, 0.0], "k2_kernel_ms": [0.0, 0.0], "bit_equal": True})
                total["bit_equal"] &= equal
                slot = 1 if turn == len(names) - 1 else 0
                total["k3_kernel_ms"][slot] += smoke.back_to_back_ms(lambda: upsample.upsample2x_forward(x))
                total["k2_kernel_ms"][slot] += smoke.back_to_back_ms(lambda: upsample.upsample2x_backward(g))
    for (name, run, dtype), total in sums.items():
        bound = sum(1e3 * smoke.k2_bytes(shape, x.element_size()) / smoke.peak_bandwidth(torch.cuda.get_device_name(0))
                    for r, d, shape, x, _ in cases if r == run and str(d).endswith(dtype))
        turns = 2 if name == "as_is" else 1
        k3, k2 = sum(total["k3_kernel_ms"]) / turns, sum(total["k2_kernel_ms"]) / turns
        emit(phase="sweep", variant=name, step=f"{run}:{dtype}", bit_equal=total["bit_equal"], k3_kernel_ms=k3,
             k2_kernel_ms=k2, bound_ms=bound, k3_share_of_bound=bound / k3, k2_share_of_bound=bound / k2,
             **({"as_is_turns_ms": {"k3": total["k3_kernel_ms"], "k2": total["k2_kernel_ms"]}} if turns == 2 else {}))


def load_parent(parent):
    """The parent checkout's ops/upsample.py, building its own csrc/upsample2x.cu
    (a checkout that binds its kernels through `ops.cuda_build.launch`)."""
    spec = importlib.util.spec_from_file_location(
        "parent_upsample", os.path.join(parent, "ramdsir_tpu_torch", "ops", "upsample.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.SOURCE = os.path.join(parent, "ramdsir_tpu_torch", "csrc", "upsample2x.cu")
    mod.LIBRARY = dataclasses.replace(mod.LIBRARY, source=mod.SOURCE)
    return mod


def ptxas(nvcc, sources):
    """Registers and spills of every kernel, by `nvcc -Xptxas -v`."""
    info, kernel = {}, None
    with tempfile.TemporaryDirectory() as tmp:
        for tag, src in sources.items():
            out = subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xptxas",
                                  "-v", "-cubin", "-o", os.path.join(tmp, f"{tag}.cubin"), src],
                                 capture_output=True, text=True, check=True).stderr
            for ln in out.splitlines():
                if "Compiling entry function" in ln:
                    mangled = re.search(r"_Z\w+", ln)
                    kernel = f"{tag}:{mangled.group(0) if mangled else ln.strip()}"
                elif kernel and ("registers" in ln or "spill" in ln):
                    info.setdefault(kernel, []).append(ln.split(":", 1)[-1].strip())
    return info


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="an unpacked earlier checkout whose K2 is timed beside this one")
    ap.add_argument("--sweep", action="store_true", help="time the VARIANTS of the source too")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("upsample_study: CUDA is not available; this script runs on the card", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import chip_smoke as smoke
    from ramdsir_tpu_torch.ops import cuda_build, upsample

    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(OUT, "study.jsonl"), "w") as log:
        run_study(args, torch, smoke, upsample, cuda_build, lambda **kw: emit(log, **kw))
    return 0


def emit(log, **kw):
    line = json.dumps(kw)
    print(line, flush=True)
    log.write(line + "\n")


def run_study(args, torch, smoke, upsample, cuda_build, emit):
    name = torch.cuda.get_device_name(0)
    bw = smoke.peak_bandwidth(name)
    parent = load_parent(args.parent) if args.parent else None
    sources = {"this": upsample.SOURCE, **({"parent": parent.SOURCE} if parent else {})}
    emit(phase="device", nvidia_smi=smoke.nvidia_smi_line(), name=name, torch=torch.__version__,
         peak_bytes_per_s=bw, ptxas=ptxas(cuda_build.nvcc(), sources))

    gen = torch.Generator(device="cuda").manual_seed(7)
    flush_buf = torch.empty(128 * 2**20, dtype=torch.uint8, device="cuda")
    flush = lambda: flush_buf.zero_()
    timed = lambda fn: (smoke.cuda_time_ms(fn, reps=20, flush=flush), smoke.back_to_back_ms(fn))
    sums = {}
    for run, shapes in STEPS.items():
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            for shape in shapes:
                n, c, h, w = shape
                x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
                g = torch.randn((n, c, 2 * h, 2 * w), generator=gen, device="cuda").to(dtype)
                y, dx = upsample.upsample2x_forward(x), upsample.upsample2x_backward(g)
                fwd = lambda: torch.ops.aten.upsample_bilinear2d.vec(x, None, False, [2.0, 2.0])
                bwd = lambda: torch.ops.aten.upsample_bilinear2d_backward(g, [2 * h, 2 * w], list(shape), False, 2.0, 2.0)
                ref, ref32 = fwd(), torch.ops.aten.upsample_bilinear2d.vec(x.float(), None, False, [2.0, 2.0])
                entry = dict(
                    phase="case", run=run, dtype=dname, shape=list(shape),
                    k3_bit_equal=torch.equal(y, upsample.upsample2x_forward_plain(x)),
                    k2_bit_equal=torch.equal(dx, upsample.upsample2x_backward_plain(g)),
                    aten_max_rel=float((y.float() - ref.float()).abs().max() / ref.float().abs().max()),
                    aten_float32_max_rel=float((y.float() - ref32).abs().max() / ref32.abs().max()),
                    bound_ms=1e3 * smoke.k2_bytes(shape, x.element_size()) / bw)
                if parent is not None:
                    entry["parent_k2_bit_equal"] = torch.equal(parent.upsample2x_backward(g), dx)
                    turns = [timed(lambda: parent.upsample2x_backward(g)), timed(lambda: upsample.upsample2x_backward(g)),
                             timed(lambda: upsample.upsample2x_backward(g)), timed(lambda: parent.upsample2x_backward(g))]
                    entry["parent_k2_ms"], entry["parent_k2_kernel_ms"] = [(turns[0][i] + turns[3][i]) / 2 for i in range(2)]
                    entry["k2_ms"], entry["k2_kernel_ms"] = [(turns[1][i] + turns[2][i]) / 2 for i in range(2)]
                else:
                    entry["k2_ms"], entry["k2_kernel_ms"] = timed(lambda: upsample.upsample2x_backward(g))
                entry["k3_ms"], entry["k3_kernel_ms"] = timed(lambda: upsample.upsample2x_forward(x))
                entry["aten_forward_ms"], entry["aten_forward_kernel_ms"] = timed(fwd)
                entry["aten_backward_ms"], entry["aten_backward_kernel_ms"] = timed(bwd)
                emit(**entry)
                total = sums.setdefault(f"{run}:{dname}", {})
                for k, v in entry.items():
                    if k.endswith("_ms"):
                        total[k] = total.get(k, 0.0) + v
    for key, total in sums.items():
        emit(phase="step_sum", step=key, **total,
             k2_share_of_bound=total["bound_ms"] / total["k2_kernel_ms"],
             k3_share_of_bound=total["bound_ms"] / total["k3_kernel_ms"])
    if args.sweep:
        sweep(torch, smoke, upsample, emit)


if __name__ == "__main__":
    sys.exit(main())
