#!/usr/bin/env python3
"""Smoke run of ramdsir_tpu_torch on one NVIDIA GPU: `python3 chip_smoke.py`.

Phases, one JSON line each (any failure raises and exits non-zero, with no
result line):
  device      the card, its power limit, the TF32 settings
  build       K1 (csrc/ram_mix.cu) compiled with nvcc for sm_90a
  kernel      K1 against its plain PyTorch version on the card, in full,
              band and delta modes, at the main path's shapes and at
              (65, 63), plus the zero-amplitude and ratio-1 cases, a
              spectrum off 16 bytes (the strided path), a single plane, an
              odd element count and tiny out-of-band amplitudes (bit-equal);
              each case names the code path it launched.  At the main
              path's shapes: `ms`, CUDA events around one cold-L2 call
              after an L2 flush that leaves dirty lines, and
              `floor_ms`, an empty launch timed the same way; `kernel_ms`,
              the kernel's own device time (torch.profiler), beside
              `kernel_floor_ms`; `ms_clean_flush` and `floor_ms_clean_flush`,
              the same two after a flush that leaves L2 clean (a read instead
              of zero_); the bound from `k1_min_bytes`
  ram_oracle  the RAM functions on the card against a float64 numpy oracle
  main_path   the fundus trainer (`train.loop.fit`) at 256^2, U-Net n=16,
              batch 16 = 3+6+7 over domains 1,2,3, on an in-memory synthetic
              set: the defaults (banded-DFT RAM, K1 band-delta mode),
              ram_use_pallas (K1 full mode) and no_ram_banded_dft (K1 band
              mode); K1's launch count is read around each run and must equal
              its step count, all through the mode's own code path
  profile     where a default step's device time goes (torch.profiler)
  step_parity one step with K1 and the same step with the plain mix, from
              the same state and draws (TF32 off, deterministic cuDNN)
Then the card line from nvidia-smi, the kernels line, and the result line.
Run artefacts go to chiprun_out/chip_smoke/.
"""
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from unittest import mock

REPO = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(REPO, "chiprun_out", "chip_smoke")
SOURCE_REL = "ramdsir_tpu_torch/csrc/ram_mix.cu"
REPLACES = "ramdsir_tpu/ops/ram_pallas.py:26"  # _mix_kernel, launched by pl.pallas_call at :48

# device memory bandwidth by card (NVIDIA data sheets); the first match wins
PEAK_BYTES_PER_S = [("H200", 4.8e12), ("H100 NVL", 3.9e12), ("H100 PCIe", 2.0e12), ("H100", 3.35e12)]
PEAK_F32_FLOPS = 67e12  # H100 SXM, float32 outside the tensor cores

B, C, S = 16, 3, 256  # main path: batch 16, RGB, 256^2
STEPS = {"default": 30, "ram_use_pallas": 10, "no_ram_banded_dft": 10}


MAIN_PATHS = {"default": "delta_flat", "ram_use_pallas": "full_vec", "no_ram_banded_dft": "strided"}
MODE_PATHS = {"full": "full_vec", "band": "strided", "delta": "delta_flat"}


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def peak_bandwidth(name):
    for key, bw in PEAK_BYTES_PER_S:
        if key in name:
            return bw
    raise SystemExit(f"chip_smoke: no memory bandwidth on record for {name!r}")


# --- K1 against its plain version ------------------------------------------


def k1_min_bytes(n, c, h, wh, band, mode):
    """The least bytes K1 must move, each needed byte once, for a finite
    non-zero spectrum.  Full mode (in place) reads the whole (h, wh)
    spectrum, 8 bytes a complex element, and writes back only the band:
    out of it z*(amp/amp) is z.  It reads the donor amplitude (4 bytes) in
    the band only.  Band and delta modes read and write the band and read its
    donor amplitudes.  Plus one 4-byte ratio a sample."""
    band_elems = n * c * (2 * band + 1) * (band + 1)
    if mode == "full":
        return 8 * n * c * h * wh + (8 + 4) * band_elems + 4 * n
    return (8 + 8 + 4) * band_elems + 4 * n


def cuda_time_ms(fn, reps=30, flush=None):
    """Median over `reps` single calls, each timed with CUDA events after
    `flush()` has evicted the L2 cache, after 3 warm-up calls.  A ~1 ms spin
    kernel ahead of the start event keeps the device busy while the host
    enqueues the call, so the window holds device time only, not the
    wrapper's host overhead."""
    import torch

    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush()
        torch.cuda._sleep(2_000_000)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_time_ms(fn, key, reps=30, flush=None):
    """Median device time of the kernels whose name holds `key`, one a
    call, from torch.profiler's CUDA activity: the kernel alone, without
    the launch and event overhead that `cuda_time_ms` holds."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            if flush is not None:
                flush()
            fn()
        torch.cuda.synchronize()
    times = [e.time_range.elapsed_us() / 1e3 for e in prof.events()
             if e.device_type == DeviceType.CUDA and key in e.name]
    if len(times) != reps:
        raise SystemExit(f"profiler saw {len(times)} kernels named *{key}* in {reps} calls")
    return statistics.median(times)


def kernel_cases(torch, tram, ram_mix, gen):
    """(name, inputs) for every mode at the main path's shapes and (65, 63),
    and the corner cases."""

    def spectrum(n, h, w, c=C):
        x = torch.rand((n, c, h, w), generator=gen, device="cuda") * 255.0
        return torch.fft.rfft2(x)  # (n, c, h, w//2+1) complex64

    cases = []
    for h, w in ((S, S), (65, 63)):
        b = tram.band_halfwidth(h, w)
        z = spectrum(B, h, w)
        donor = torch.rand((B, h, w, C), generator=gen, device="cuda") * 255.0
        amp_full = tram.amplitude_spectrum(donor).permute(0, 3, 1, 2)  # as ram_mixup passes it
        amp_band = tram.banded_amplitude_spectrum(donor).permute(0, 3, 1, 2)
        ratio = (torch.randint(1, 11, (B,), generator=gen, device="cuda") / 10.0).float()
        rows = torch.cat([torch.arange(b + 1, device="cuda"), torch.arange(h - b, h, device="cuda")])
        blk = z[:, :, rows, : b + 1]
        tag = f"{h}x{w}"
        cases.append((f"full@{tag}", dict(z=z, amp=amp_full, ratio=ratio, band=b, full=True, delta=False)))
        cases.append((f"band@{tag}", dict(z=z, amp=amp_band, ratio=ratio, band=b, full=False, delta=False)))
        cases.append((f"delta@{tag}", dict(z=blk, amp=amp_band, ratio=ratio, band=b, full=False, delta=True)))
    # zero amplitude in and out of the band, and ratio 1 (exact identity)
    h = w = 64
    b = tram.band_halfwidth(h, w)
    z = spectrum(4, h, w)
    z[:, :, 0, 0] = 0
    z[:, 1, 1, 2] = 0
    z[:, 2, 20, 9] = 0
    donor = torch.rand((4, h, w, C), generator=gen, device="cuda") * 255.0
    amp_full = tram.amplitude_spectrum(donor).permute(0, 3, 1, 2)
    amp_band = tram.banded_amplitude_spectrum(donor).permute(0, 3, 1, 2)
    r = torch.tensor([0.1, 0.5, 0.9, 1.0], device="cuda")
    cases.append(("zero_amp_full", dict(z=z, amp=amp_full, ratio=r, band=b, full=True, delta=False)))
    cases.append(("zero_amp_band", dict(z=z, amp=amp_band, ratio=r, band=b, full=False, delta=False)))
    one = torch.ones(4, device="cuda")
    cases.append(("ratio1_full", dict(z=z, amp=amp_full, ratio=one, band=b, full=True, delta=False, identity=True)))
    cases.append(("ratio1_band", dict(z=z, amp=amp_band, ratio=one, band=b, full=False, delta=False, identity=True)))
    cases.append(("ratio1_delta", dict(z=z[:, :, torch.cat([torch.arange(b + 1), torch.arange(h - b, h)]).cuda(), : b + 1],
                                      amp=amp_band, ratio=one, band=b, full=False, delta=True, identity=True)))
    # one complex element off 16 bytes: the strided path
    cases.append(("misaligned_full", dict(z=z, amp=amp_full, ratio=r, band=b, full=True, delta=False, offset=1)))
    cases.append(("misaligned_band", dict(z=z, amp=amp_band, ratio=r, band=b, full=False, delta=False, offset=1)))
    # amplitudes whose squares underflow (below 2^-75) or are subnormal, and
    # zeros, out of the band: the plain version's values, bit for bit
    zt = z.clone()
    tiny = torch.tensor([1e-23, -2e-23 + 1e-24j, 3e-23, 1e-20j, 0.0, -0.0, 1e-30 - 1e-30j], device="cuda")
    zt[:, :, h // 2, b + 1 : b + 1 + len(tiny)] = tiny
    zt[:, :, b + 1, : len(tiny)] = tiny
    cases.append(("tiny_full", dict(z=zt, amp=amp_full, ratio=r, band=b, full=True, delta=False, exact=True)))
    # a single plane (N*C = 1) at the main path's size
    h = w = S
    b = tram.band_halfwidth(h, w)
    z = spectrum(1, h, w, c=1)
    donor = torch.rand((1, h, w, 1), generator=gen, device="cuda") * 255.0
    amp_full = tram.amplitude_spectrum(donor).permute(0, 3, 1, 2)
    amp_band = tram.banded_amplitude_spectrum(donor).permute(0, 3, 1, 2)
    r = torch.tensor([0.3], device="cuda")
    rows = torch.cat([torch.arange(b + 1, device="cuda"), torch.arange(h - b, h, device="cuda")])
    cases.append(("single_plane_full", dict(z=z, amp=amp_full, ratio=r, band=b, full=True, delta=False)))
    cases.append(("single_plane_band", dict(z=z, amp=amp_band, ratio=r, band=b, full=False, delta=False)))
    cases.append(("single_plane_delta", dict(z=z[:, :, rows, : b + 1], amp=amp_band, ratio=r, band=b, full=False, delta=True)))
    # an odd element count (65 x 33): the last element has no float4 partner
    h, w = 65, 64
    donor = torch.rand((1, h, w, 1), generator=gen, device="cuda") * 255.0
    z = spectrum(1, h, w, c=1)
    amp_full = tram.amplitude_spectrum(donor).permute(0, 3, 1, 2)
    cases.append(("odd_count_full", dict(z=z, amp=amp_full, ratio=r, band=tram.band_halfwidth(h, w), full=True, delta=False)))
    for _, case in cases:
        case["mode"] = "full" if case["full"] else "delta" if case["delta"] else "band"
        case["path"] = "strided" if case.get("offset") else MODE_PATHS[case["mode"]]
    return cases


def at_offset(t, offset):
    """A copy of t that starts `offset` elements into its storage."""
    import torch

    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    out = buf[offset:].view(t.shape)
    out.copy_(t)
    return out


def run_mix(fn, case):
    """Apply one mix to fresh copies; returns the output planes."""
    import torch

    z = at_offset(case["z"], case.get("offset", 0))
    if case["delta"]:
        re, im = z.real.contiguous(), z.imag.contiguous()  # the DFT path's separate blocks
    else:
        zv = torch.view_as_real(z)
        re, im = zv[..., 0], zv[..., 1]  # in place on the complex spectrum
    out_re, out_im = fn(re, im, case["amp"], case["ratio"], case["band"], full=case["full"], delta=case["delta"])
    return torch.stack([out_re, out_im]), torch.stack([case["z"].real, case["z"].imag])


def phase_kernel(torch, tram, ram_mix, bw):
    gen = torch.Generator(device="cuda").manual_seed(0)
    flush_buf = torch.empty(128 * 2**20, dtype=torch.uint8, device="cuda")  # > the 50 MB L2
    # zeroing 128 MB evicts the kernel's data and leaves 50 MB of dirty lines
    # in L2, whose write-back the timed kernel pays, as on the main path
    # after the FFTs that write the spectrum; reading them leaves L2 clean
    flush = lambda: flush_buf.zero_()
    clean_flush = lambda: flush_buf.sum()
    results = {}
    # an empty launch under the same timing: the least a launch-bound mode can take
    spin = lambda: torch.cuda._sleep(1)
    floor_ms = cuda_time_ms(spin, flush=flush)
    floor_ms_clean_flush = cuda_time_ms(spin, flush=clean_flush)
    kernel_floor_ms = kernel_time_ms(spin, "spin", flush=flush)
    for name, case in kernel_cases(torch, tram, ram_mix, gen):
        by_path = dict(ram_mix.launches_by_path)
        got, before = run_mix(ram_mix.mix_spectrum, case)
        path = [p for p, k in ram_mix.launches_by_path.items() if k != by_path[p]]
        want, _ = run_mix(ram_mix.mix_spectrum_plain, case)
        torch.cuda.synchronize()
        if path != [case["path"]]:
            raise SystemExit(f"K1 {name}: launched {path}, expected the {case['path']} path")
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        rel = err / max(scale, 1e-30)
        if not torch.isfinite(got).all():
            raise SystemExit(f"K1 {name}: non-finite output")
        # both evaluate the same IEEE operations in the same order: equal up
        # to a rounding of the largest value
        if err > 1e-6 * scale:
            raise SystemExit(f"K1 {name}: max abs err {err} vs plain (scale {scale})")
        if case.get("identity"):
            exact = (got == 0).all() if case["delta"] else (got == before).all()
            if not exact:
                raise SystemExit(f"K1 {name}: ratio 1 is not the exact identity")
        if case.get("exact") and not torch.equal(got, want):
            raise SystemExit(f"K1 {name}: not bit-equal to the plain version")
        entry = dict(case=name, path=case["path"], max_abs_err=err, max_rel_err=rel)
        if name.endswith(f"@{S}x{S}"):
            n, c, h, wh = case["z"].shape if not case["delta"] else (B, C, S, S // 2 + 1)
            b = case["band"]
            band_elems = n * c * (2 * b + 1) * (b + 1)
            nbytes = k1_min_bytes(n, c, h, wh, b, case["mode"])
            # |z|^2 of every element (3 flops), the mix of the band's (~10)
            flops = 3 * n * c * h * wh + 10 * band_elems if case["full"] else 10 * band_elems
            bound_ms = 1e3 * max(nbytes / bw, flops / PEAK_F32_FLOPS)
            keep = case["z"].clone()

            def timed(fn, case=case, keep=keep):
                z = keep
                if case["delta"]:
                    re, im = case["_re"], case["_im"]
                else:
                    zv = torch.view_as_real(z)
                    re, im = zv[..., 0], zv[..., 1]
                fn(re, im, case["amp"], case["ratio"], case["band"], full=case["full"], delta=case["delta"])

            if case["delta"]:
                case["_re"], case["_im"] = case["z"].real.contiguous(), case["z"].imag.contiguous()
            launches_before, by_path = ram_mix.launches, dict(ram_mix.launches_by_path)
            ms = cuda_time_ms(lambda: timed(ram_mix.mix_spectrum), flush=flush)
            kernel_ms = kernel_time_ms(lambda: timed(ram_mix.mix_spectrum), "mix_", flush=flush)
            ms_clean_flush = cuda_time_ms(lambda: timed(ram_mix.mix_spectrum), flush=clean_flush)
            plain_ms = cuda_time_ms(lambda: timed(ram_mix.mix_spectrum_plain), flush=flush)
            ram_mix.launches = launches_before  # comparison launches do not count
            ram_mix.launches_by_path.update(by_path)
            entry.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by="bytes"
                         if nbytes / bw >= flops / PEAK_F32_FLOPS else "operations",
                         bytes=nbytes, floor_ms=floor_ms, kernel_ms=kernel_ms,
                         kernel_floor_ms=kernel_floor_ms, ms_clean_flush=ms_clean_flush,
                         floor_ms_clean_flush=floor_ms_clean_flush, library_ms=None)
        results[name] = entry
        emit("kernel", **entry)
    return results


# --- RAM against a float64 oracle ------------------------------------------


def oracle_ram(src_hwc, donor_hwc, ratio, L=0.1):
    """The reference augmentation in float64 numpy: full fft2, fftshift,
    in-band blend, phase kept, real part."""
    import numpy as np

    src = src_hwc.astype(np.float64).transpose(2, 0, 1)
    donor = donor_hwc.astype(np.float64).transpose(2, 0, 1)
    fft_src = np.fft.fft2(src, axes=(-2, -1))
    amp_src, pha_src = np.abs(fft_src), np.angle(fft_src)
    amp_trg = np.abs(np.fft.fft2(donor, axes=(-2, -1)))
    a_src = np.fft.fftshift(amp_src, axes=(-2, -1))
    a_trg = np.fft.fftshift(amp_trg, axes=(-2, -1))
    _, h, w = a_src.shape
    b = int(np.floor(min(h, w) * L))
    c_h, c_w = h // 2, w // 2
    sl = (slice(None), slice(c_h - b, c_h + b + 1), slice(c_w - b, c_w + b + 1))
    a_src[sl] = a_src[sl] * ratio + a_trg[sl] * (1 - ratio)
    a_src = np.fft.ifftshift(a_src, axes=(-2, -1))
    return np.real(np.fft.ifft2(a_src * np.exp(1j * pha_src), axes=(-2, -1))).transpose(1, 2, 0)


def phase_ram_oracle(torch, tram, np):
    rng = np.random.default_rng(0)
    worst = {}
    for h, w in ((64, 64), (65, 63)):
        src = rng.uniform(0, 255, (3, h, w, 3)).astype(np.float32)
        donor = rng.uniform(0, 255, (3, h, w, 3)).astype(np.float32)
        ratio = np.array([0.1, 0.5, 1.0], np.float32)
        ts, td, tr = (torch.from_numpy(a).cuda() for a in (src, donor, ratio))
        outs = {
            "ram_mixup": tram.ram_mixup(ts, tram.amplitude_spectrum(td), tr),
            "ram_mixup_banded": tram.ram_mixup_banded(ts, tram.banded_amplitude_spectrum(td), tr),
            "ram_mixup_banded_dft": tram.ram_mixup_banded_dft(ts, tram.banded_amplitude_spectrum(td), tr),
        }
        for name, out in outs.items():
            got = out.cpu().numpy()
            err = max(float(np.abs(got[i] - oracle_ram(src[i], donor[i], ratio[i])).max()) for i in range(3))
            # the repo's bound for float32 RAM against the float64 oracle (tests/test_ram.py)
            if err > 2e-2:
                raise SystemExit(f"{name} at {h}x{w}: max err {err} against the float64 oracle")
            worst[f"{name}@{h}x{w}"] = err
    emit("ram_oracle", max_abs_err=worst, tolerance=2e-2)


# --- the main path ------------------------------------------------------------


def main_path_config(TrainConfig, name, run_dir):
    extra = {"ram_use_pallas": {"ram_use_pallas": True}, "no_ram_banded_dft": {"ram_banded_dft": False}}
    return TrainConfig(
        dataset="fundus", domain_idxs=(1, 2, 3), test_domain_idx=0, ram=True, rec=True,
        is_out_domain=True, consistency=True, consistency_type="kd", image_size=S,
        save_path=run_dir, device="cuda", **extra.get(name, {}),
    ).resolve()


def phase_main_path(torch, np, ram_mix, arrays):
    from ramdsir_tpu_torch.config import TrainConfig
    from ramdsir_tpu_torch.data.device_pipeline import DeviceFundusPipeline
    from ramdsir_tpu_torch.train.loop import fit, tf32_settings
    from ramdsir_tpu_torch.train.state import build_models

    runs = {}
    for name, steps in STEPS.items():
        run_dir = os.path.join(OUT, name)
        shutil.rmtree(run_dir, ignore_errors=True)
        cfg = main_path_config(TrainConfig, name, run_dir)
        pipe = DeviceFundusPipeline.from_arrays(
            arrays, cfg.domain_idxs, cfg.batch_size_list, cfg.test_domain_idx,
            is_out_domain=cfg.is_out_domain, seed=cfg.seed,
            precompute_donor_amp=cfg.ram_precompute_donor_amp, device="cuda",
        )
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ram_mix.launches = 0
        ram_mix.launches_by_path.update(dict.fromkeys(ram_mix.launches_by_path, 0))
        t0 = time.perf_counter()
        summary = fit(cfg, max_steps=steps, pipeline=pipe)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ram_mix.launches
        paths = {p: k for p, k in ram_mix.launches_by_path.items() if k}
        peak = torch.cuda.max_memory_allocated()
        rows = [json.loads(line) for line in open(os.path.join(run_dir, "log", "metrics.jsonl"))]
        losses = [v for r in rows for k, v in r.items() if k.startswith("loss/")]
        finite = bool(np.all(np.isfinite(losses))) and len(losses) == 7 * steps
        # the final checkpoint is the reference's format and loads strictly
        payload = torch.load(summary["final_checkpoint"], map_location="cpu")
        for mname, module in build_models(cfg).items():
            module.load_state_dict(payload[f"{mname}_state_dict"], strict=True)
        entry = dict(
            run=name, steps=summary["steps"], k1_launches=launches, k1_paths=paths, losses_finite=finite,
            first_loss=rows[0]["loss/loss"], last_loss=[r for r in rows if "loss/loss" in r][-1]["loss/loss"],
            median_step_ms=summary["median_step_ms"], images_per_sec=summary["images_per_sec"],
            peak_memory_bytes=peak, wall_s=wall, batch=sum(cfg.batch_size_list), image_size=S,
            tf32=tf32_settings(),
        )
        emit("main_path", **entry)
        if not finite:
            raise SystemExit(f"main path {name}: non-finite or missing losses")
        if summary["steps"] != steps or launches != steps:
            raise SystemExit(f"main path {name}: {summary['steps']} steps, {launches} K1 launches, expected {steps}")
        if paths != {MAIN_PATHS[name]: steps}:
            raise SystemExit(f"main path {name}: K1 paths {paths}, expected {MAIN_PATHS[name]} only")
        runs[name] = entry
    return runs


def phase_step_parity(torch, np, ram_mix, arrays):
    """One step through K1 and the same step through the plain mix, from the
    same weights, batch and draws, in float32 (TF32 off, deterministic
    cuDNN).  K1 and the plain version agree to the last bit (phase kernel),
    so the steps agree up to the order of cuDNN's sums; the params bound is
    2.5*lr because a first Adam step is ~lr*sign(g) and a near-zero
    gradient may flip (tests/test_torch_step_parity.py:232)."""
    from ramdsir_tpu_torch.config import TrainConfig
    from ramdsir_tpu_torch.data.device_pipeline import DeviceFundusPipeline
    from ramdsir_tpu_torch.train.state import init_state
    from ramdsir_tpu_torch.train.steps import make_train_step, sample_step_draws

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    results = {}
    for name in ("default", "ram_use_pallas"):
        cfg = main_path_config(TrainConfig, name, os.path.join(OUT, "parity"))
        pipe = DeviceFundusPipeline.from_arrays(
            arrays, cfg.domain_idxs, cfg.batch_size_list, cfg.test_domain_idx,
            is_out_domain=True, seed=cfg.seed, precompute_donor_amp=cfg.ram_precompute_donor_amp, device="cuda",
        )
        row = next(iter(pipe))
        draws = sample_step_draws(torch.Generator().manual_seed(5), sum(cfg.batch_size_list), torch.device("cuda"))
        out = {}
        for impl in ("kernel", "plain"):
            state = init_state(cfg, torch.Generator().manual_seed(cfg.seed), "cuda")
            step = make_train_step(cfg, total_iters=1000, batch_size_list=cfg.batch_size_list, device_data=pipe.device_data)
            if impl == "plain":
                with mock.patch.object(ram_mix, "mix_spectrum", ram_mix.mix_spectrum_plain):
                    m = step(state, row, draws=draws)
            else:
                m = step(state, row, draws=draws)
            out[impl] = (
                {k: float(v) for k, v in m.items()},
                {f"{n}.{k}": v.detach().clone() for n, mod in state.models.items() for k, v in mod.state_dict().items()},
            )
        (mk, pk), (mp, pp) = out["kernel"], out["plain"]
        loss_rel = max(abs(mk[k] - mp[k]) / max(abs(mp[k]), 1e-6) for k in mk)
        param_err = max(float((pk[k] - pp[k]).abs().max()) for k in pk if "running" not in k)
        stats = [k for k in pk if "running" in k]
        stat_err = max(float((pk[k] - pp[k]).abs().max()) for k in stats)
        stats_ok = all(torch.allclose(pk[k], pp[k], rtol=1e-4, atol=1e-5) for k in stats)
        entry = dict(run=name, loss=mk["loss"], loss_max_rel=loss_rel, loss_tol=1e-5,
                     params_max_abs=param_err, params_tol=2.5 * cfg.lr,
                     running_stats_max_abs=stat_err, stats_tol="rtol 1e-4, atol 1e-5")
        emit("step_parity", **entry)
        if not (loss_rel <= 1e-5 and param_err <= 2.5 * cfg.lr and stats_ok):
            raise SystemExit(f"step parity {name}: kernel and plain steps disagree: {entry}")
        results[name] = entry
    return results


KERNEL_GROUPS = [  # (group, substrings of CUDA kernel names), first match wins
    ("K1 ram_mix", ("mix_full_vec_kernel", "mix_delta_flat_kernel", "mix_strided_kernel")),
    ("fft", ("fft", "radix", "regular_fft", "vector_fft")),
    ("batch_norm", ("batch_norm", "bn_", "welford")),
    ("layout nchw<->nhwc", ("nchwToNhwc", "nhwcToNchw")),
    ("upsample", ("upsample",)),
    ("conv", ("conv", "xmma", "implicit", "wgrad", "dgrad", "cudnn", "sm90_", "cutlass")),
    ("matmul", ("gemm", "gemv", "cublas")),
    ("copy/cat", ("copy", "Copy", "memcpy", "Memcpy", "memset", "Memset", "CatArray")),
]


def phase_profile(torch, ram_mix, arrays, steps=5, warmup=3):
    """Where a default step's device time goes: torch.profiler over `steps`
    steps after `warmup`, each step synchronised as `fit` does."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ramdsir_tpu_torch.config import TrainConfig
    from ramdsir_tpu_torch.data.device_pipeline import DeviceFundusPipeline
    from ramdsir_tpu_torch.train.state import init_state
    from ramdsir_tpu_torch.train.steps import make_train_step

    cfg = main_path_config(TrainConfig, "default", os.path.join(OUT, "profile"))
    pipe = DeviceFundusPipeline.from_arrays(
        arrays, cfg.domain_idxs, cfg.batch_size_list, cfg.test_domain_idx,
        is_out_domain=True, seed=cfg.seed, precompute_donor_amp=True, device="cuda",
    )
    state = init_state(cfg, torch.Generator().manual_seed(cfg.seed), "cuda")
    step = make_train_step(cfg, total_iters=1000, batch_size_list=cfg.batch_size_list, device_data=pipe.device_data)
    gen = torch.Generator().manual_seed(0)
    rows = iter(pipe)

    def one():
        m = step(state, next(rows), gen)
        torch.stack([v for k, v in m.items() if k != "lr"]).tolist()

    for _ in range(warmup):
        one()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            one()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    per_name, per_group = {}, {}
    for e in kernels:
        us = e.time_range.elapsed_us()
        per_name[e.name] = per_name.get(e.name, 0.0) + us
        group = next((g for g, keys in KERNEL_GROUPS if any(k in e.name for k in keys)), "elementwise/other")
        per_group[group] = per_group.get(group, 0.0) + us
    busy_us = sum(per_name.values())
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:12]
    emit(
        "profile", run="default", steps=steps, step_ms=wall_us / steps / 1e3,
        device_busy_ms_per_step=busy_us / steps / 1e3,
        device_idle_share=(1.0 - busy_us / wall_us) if kernels else "not measured",
        kernel_launches_per_step=len(kernels) / steps,
        ms_per_step_by_group={g: us / steps / 1e3 for g, us in sorted(per_group.items(), key=lambda kv: -kv[1])},
        top_kernels_ms_per_step=[[name[:80], us / steps / 1e3] for name, us in top],
    )


# --- build -------------------------------------------------------------------


def phase_build(ram_mix):
    """Build the library and, beside it, ask ptxas for the kernel's
    registers and spills (two nvcc processes, started together)."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ptxas = subprocess.Popen(
            [ram_mix._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
             "-Xptxas", "-v", "-cubin", "-o", os.path.join(tmp, "ram_mix.cubin"), ram_mix.SOURCE],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        try:
            path = ram_mix.build_library()
            ram_mix._library()
        finally:
            ptxas_out, _ = ptxas.communicate(timeout=600)
    # ptxas prints each kernel's name, then its spills, then its registers
    info, kernel = {}, None
    for ln in ptxas_out.splitlines():
        if "Compiling entry function" in ln:
            found = re.search(r"mix_[a-z_]+?_kernel", ln)
            kernel = found.group(0) if found else ln.strip()
            kernel += "<full>" if "ILb1E" in ln else "<delta>" if "ILb0ELb1E" in ln else "<band>" if "ILb0ELb0E" in ln else ""
        elif kernel and ("registers" in ln or "spill" in ln):
            info.setdefault(kernel, []).append(ln.split(":", 1)[-1].strip())
    emit("build", library=os.path.relpath(path, REPO), seconds=time.perf_counter() - t0,
         nvcc_flags=list(ram_mix.NVCC_FLAGS), ptxas=info)


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the card", file=sys.stderr)
        return 1
    if not os.path.isfile(os.path.join(REPO, "ramdsir_tpu_torch", "csrc", "ram_mix.cu")):
        print("chip_smoke: run it from a checkout of the repository (ramdsir_tpu_torch/ is missing)", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import numpy as np

    from ramdsir_tpu_torch.data.synthetic import fundus_arrays
    from ramdsir_tpu_torch.ops import ram as tram
    from ramdsir_tpu_torch.ops import ram_mix
    from ramdsir_tpu_torch.train.loop import tf32_settings

    os.makedirs(OUT, exist_ok=True)
    card = nvidia_smi_line()
    name = torch.cuda.get_device_name(0)
    bw = peak_bandwidth(name)
    emit("device", nvidia_smi=card, name=name, count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, peak_bytes_per_s=bw, tf32=tf32_settings())

    phase_build(ram_mix)
    kernels = phase_kernel(torch, tram, ram_mix, bw)
    phase_ram_oracle(torch, tram, np)

    t0 = time.perf_counter()
    arrays = fundus_arrays(per_domain_train=64, size=S, seed=0)  # 4 domains x 64 images, as bench.py:68
    emit("data", domains=len(arrays), per_domain=64, size=S, seconds=time.perf_counter() - t0)
    runs = phase_main_path(torch, np, ram_mix, arrays)
    phase_profile(torch, ram_mix, arrays)
    phase_step_parity(torch, np, ram_mix, arrays)

    modes = [("band,delta", "delta", "default"), ("full", "full", "ram_use_pallas"), ("band", "band", "no_ram_banded_dft")]
    line = {"kernels": []}
    for label, case, run in modes:
        k = kernels[f"{case}@{S}x{S}"]
        line["kernels"].append({
            "name": f"ram_mix[{label}]", "route": "cuda", "source": SOURCE_REL, "replaces": REPLACES,
            "launches": runs[run]["k1_launches"], "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "library_ms": None, "floor_ms": k["floor_ms"], "kernel_ms": k["kernel_ms"],
            "ms_clean_flush": k["ms_clean_flush"], "floor_ms_clean_flush": k["floor_ms_clean_flush"], "path": k["path"],
        })
    print(card, flush=True)
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
