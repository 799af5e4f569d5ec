#!/usr/bin/env python3
"""Smoke run of ramdsir_tpu_torch on one NVIDIA GPU: `python3 chip_smoke.py`.

Phases, one JSON line each (any failure raises and exits non-zero, with no
result line):
  device      the card, its power limit, the TF32 settings
  build       K1 (csrc/ram_mix.cu) and K2 (csrc/upsample2x.cu) compiled with
              nvcc for sm_90a, the host post-processing library
              (native/postproc.cpp) and the PNG unfilter (native/png.cpp)
              with g++, all started together, beside ptxas's registers
  cuda_tests  the card tests (tests/test_torch_port_cuda.py, marker cuda) in
              a subprocess: all must pass
  kernel      K1 against its plain PyTorch version on the card, in full,
              band and delta modes, at the main path's shapes and at
              (65, 63), in band and delta modes at the prostate path's
              (10 x 3 planes at 384^2, b = 38; bit-equal), plus the
              zero-amplitude and ratio-1 cases, a
              spectrum off 16 bytes (the strided path), a single plane, an
              odd element count and tiny out-of-band amplitudes (bit-equal);
              each case names the code path it launched.  At the main
              path's shapes: `ms`, CUDA events around one cold-L2 call
              after an L2 flush that leaves dirty lines, and
              `floor_ms`, an empty launch timed the same way; `kernel_ms`,
              the kernel's own device time (torch.profiler), beside
              `kernel_floor_ms`; `ms_clean_flush` and `floor_ms_clean_flush`,
              the same two after a flush that leaves L2 clean (a read instead
              of zero_); the bound from `k1_min_bytes`.  delta@384x384
              is timed the same way
  ram_oracle  the RAM functions on the card against a float64 numpy oracle
  main_path   the fundus trainer (`train.loop.fit`) at 256^2, U-Net n=16,
              batch 16 = 3+6+7 over domains 1,2,3, on an in-memory synthetic
              set: the defaults (banded-DFT RAM, K1 band-delta mode),
              ram_use_pallas (K1 full mode) and no_ram_banded_dft (K1 band
              mode); K1's launch count is read around each run and must equal
              its step count, all through the mode's own code path.  Each
              run evaluates at each epoch's end and at its last step, on an
              in-memory test split of target domain 0 (50 images at 512^2,
              test batch 8: six batches and a tail of 2); the last eval's
              seconds, forward ms per batch (CUDA-synchronised), readback
              ms, host ms per image, Dice, the best file (which must load
              strictly) and the CSV rows; eval adds no K1 launch
  bf16_path   the same trainer in bfloat16 (--compute_dtype and
              predict_dtype bfloat16), 21 steps (one epoch, one eval), with
              the same checks, beside the float32 default run's median
              step, img/s and peak memory
  eval_cli    the eval CLI's path on the default run's final_model.pth: the
              loader, BN-adapted prediction, eval_fundus with distances over
              the same split; the six metrics, the timings, the host's share
              of the eval's wall time, and where the forward's device time
              goes (torch.profiler over four batches of 8); the same path
              from final_model.ckpt must give the same six metrics
  profile     where a fundus step's and a prostate step's device time goes,
              float32 and bfloat16, and a fundus step under --deterministic
              (torch.profiler over 5 steps each)
  step_parity one step with K1 and the same step with the plain mix, from
              the same state and draws (TF32 off, deterministic cuDNN)
  bf16_step_parity
              the same for a bfloat16 step, then the bfloat16 step against
              the float32 one from the same state (losses within the spread
              the CPU tests measure)
  eval_parity the same weights and 16 test images on the card and on the
              CPU (TF32 off, deterministic cuDNN): probabilities within 1e-4
              in both BN modes, tail batch included, Dice within 1e-3, and
              the host library's post-processing and distances bit-equal to
              their scipy plain versions on the eval's own maps
  resume      the default run's final_model.ckpt loaded into a fresh state
              equals the file; saved and loaded again, every tensor and Adam
              moment is bit-equal, and a step from it has the same losses and
              running statistics bit for bit; then `fit` resumed from the
              file for 5 more steps (5 K1 launches, the lr continuing the
              schedule)
  prostate_path
              the prostate trainer (`fit`) at the reference configuration:
              domains 0-4 -> target 5, batch 10 = 2 x 5, 384^2, U-Net n=16,
              5 DSBN domains, banded-DFT RAM (K1 on delta_flat), 25 steps on
              an in-memory synthetic set of 5 domains x 40 slices; it
              evaluates 3 synthetic volumes of 32 slices, written as .nii.gz
              and read back, at each epoch's end (20 steps) and at the last
              step, test batch 8 (4 window batches a volume, the last with
              2 zero rows).  K1 launches == steps, all on delta_flat, none in
              eval; the 7 losses finite every step; 2 CSV rows; Dice in
              [0, 1]; the final and keep-best .pth load strictly
  prostate_bf16_path
              the same in bfloat16, 12 steps (one eval, at the last), beside
              the float32 run's figures
  prostate_eval_cli
              cli/test_prostate_volume.py's main on that run's
              final_model.pth: BN adaptation, Dice, HD95, ASD, the timing
  prostate_step_parity
              one prostate step with K1 and with the plain mix (as
              step_parity)
  prostate_eval_parity
              that run's weights and one volume on the card and on the CPU,
              both BN modes: probabilities within 1e-4, labels differing at
              most at 1e-4 of the voxels, Dice within 1e-3; the host
              library's largest component and 3-D surface distances
              bit-equal to scipy on the card's predictions
  png_tree    the fundus path from a PNG tree the port writes and reads
              without PIL: 800^2 sources, 4 domains x 32 train pairs and 50
              test pairs of target 0, every row filter and palette masks;
              each file decodes to its array; from_tree equals the port's
              resize of those arrays; cli.train trains the reference
              configuration one epoch with its eval (K1 launches == steps);
              cli.test_fundus_slice --save_result, every overlay read back;
              decode and resize ms an image, the eval's load share
  deterministic
              --deterministic: fundus and prostate, float32 and bfloat16,
              fit runs of 8 steps without, with, with and without the mode:
              the two with it bit-equal (state, Adam moments, losses), K2
              launches 8 a step and none in eval or without the mode; two
              steps from one re-loaded state bit-equal; the mode's cost in
              median step time
  k2          K2 against its plain version (bit-equal) and torch's atomics
              backward at every shape and dtype of those steps, with `ms`,
              `kernel_ms`, plain and library times and the bytes bound
Then the card line from nvidia-smi, the kernels line (K1 per mode and at
the prostate shape; K2 summed over a deterministic step's 8 launches for
each run, and at the largest shape), and the result line.
Run artefacts go to chiprun_out/chip_smoke/ (prostate: chip_smoke/prostate/);
the .pth and .ckpt files and the NIfTI volumes are deleted at exit.
"""
import contextlib
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

REPO = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(REPO, "chiprun_out", "chip_smoke")
SOURCE_REL = "ramdsir_tpu_torch/csrc/ram_mix.cu"
REPLACES = "ramdsir_tpu/ops/ram_pallas.py:26"  # _mix_kernel, launched by pl.pallas_call at :48

# device memory bandwidth by card (NVIDIA data sheets); the first match wins
PEAK_BYTES_PER_S = [("H200", 4.8e12), ("H100 NVL", 3.9e12), ("H100 PCIe", 2.0e12), ("H100", 3.35e12)]
PEAK_F32_FLOPS = 67e12  # H100 SXM, float32 outside the tensor cores

B, C, S = 16, 3, 256  # main path: batch 16, RGB, 256^2
STEPS = {"default": 30, "ram_use_pallas": 10, "no_ram_banded_dft": 10, "bf16": 21}  # bf16: one epoch
EVAL_N, EVAL_SIZE = 50, 512  # in-memory test split: images, original size
PB, PS = 10, 384  # prostate path: batch 10 = 2 x 5, 384^2
PROSTATE_STEPS, PROSTATE_SLICES = 25, 40  # 20 steps an epoch: evals at step 20 and 25
PROSTATE_BF16_STEPS = 12  # one eval, at the last step
RESUME_STEPS = 5  # steps the resumed default run takes
PROSTATE_VOLUMES, PROSTATE_DEPTH, PROSTATE_TEST_BATCH = 3, 32, 8
PROSTATE_OUT = os.path.join(OUT, "prostate")
PNG_OUT = os.path.join(OUT, "png_tree")
PNG_SIZE, PNG_TRAIN, PNG_TEST = 800, 32, 50  # source size, train pairs a domain, target test pairs
PNG_FILTERS = (0, 1, 2, 3, 4, "adaptive")  # the n-th file written takes PNG_FILTERS[n % 6]
DET_STEPS = 8  # steps of each --deterministic run
SOURCE_K2 = "ramdsir_tpu_torch/csrc/upsample2x.cu"
# K2 has no TPU kernel: the JAX package's upsample is jax.image.resize, differentiated by XLA
REPLACES_K2 = "ramdsir_tpu/models/unet.py:76"
DEVICE = "cuda"  # the device of the prostate, png_tree and deterministic phases (a rehearsal on the CPU may set "cpu")
TIMED = (f"full@{S}x{S}", f"band@{S}x{S}", f"delta@{S}x{S}", f"delta@{PS}x{PS}")


MAIN_PATHS = {"default": "delta_flat", "ram_use_pallas": "full_vec", "no_ram_banded_dft": "strided", "bf16": "delta_flat"}
BF16 = {"compute_dtype": "bfloat16", "predict_dtype": "bfloat16"}
MODE_PATHS = {"full": "full_vec", "band": "strided", "delta": "delta_flat"}


def sync(torch):
    if DEVICE == "cuda":
        torch.cuda.synchronize()


def emit(phase, **kw):
    """A phase's JSON line, on stdout and appended to OUT/phases.jsonl (the
    end of stdout is all that may come back from a long run)."""
    line = json.dumps({"phase": phase, **kw})
    print(line, flush=True)
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(OUT, "phases.jsonl"), "a") as f:
        f.write(line + "\n")


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


def back_to_back_ms(fn, reps=20):
    """Mean device time of one call among `reps` calls queued back to back
    (CUDA events around them, behind a ~1 ms spin that lets the host enqueue
    them all first; no flush between): the kernel's own time plus the gap
    between two queued kernels, without the launch latency `cuda_time_ms`
    holds."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(2_000_000)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_time_ms(fn, key, reps=30, flush=None, attempts=3):
    """Median device time of the kernels whose name holds `key`, one a
    call, from torch.profiler's CUDA activity: the kernel alone, without
    the launch and event overhead that `cuda_time_ms` holds.  On the card
    the profiler sometimes returns fewer kernel records than were launched
    (13 of 20 and 19 of 30 in two calls of six); such a sample is taken
    again, up to `attempts` times, and never used."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                if flush is not None:
                    flush()
                fn()
            torch.cuda.synchronize()
        times = [e.time_range.elapsed_us() / 1e3 for e in prof.events()
                 if e.device_type == DeviceType.CUDA and key in e.name]
        if len(times) == reps:
            return statistics.median(times)
        seen.append(len(times))
    raise SystemExit(f"profiler saw {seen} kernels named *{key}* in {attempts} samples of {reps} calls")


def kernel_cases(torch, tram, ram_mix, gen):
    """(name, inputs) for every mode at the main path's shapes and (65, 63),
    and the corner cases."""

    def spectrum(n, h, w, c=C):
        x = torch.rand((n, c, h, w), generator=gen, device="cuda") * 255.0
        return torch.fft.rfft2(x)  # (n, c, h, w//2+1) complex64

    cases = []
    # the fundus main path, an odd shape, and the prostate path (bit-equal)
    for n, h, w, modes in ((B, S, S, "full band delta"), (B, 65, 63, "full band delta"), (PB, PS, PS, "band delta")):
        b = tram.band_halfwidth(h, w)
        z = spectrum(n, h, w)
        donor = torch.rand((n, h, w, C), generator=gen, device="cuda") * 255.0
        amp_full = tram.amplitude_spectrum(donor).permute(0, 3, 1, 2)  # as ram_mixup passes it
        amp_band = tram.banded_amplitude_spectrum(donor).permute(0, 3, 1, 2)
        ratio = (torch.randint(1, 11, (n,), generator=gen, device="cuda") / 10.0).float()
        rows = torch.cat([torch.arange(b + 1, device="cuda"), torch.arange(h - b, h, device="cuda")])
        blk = z[:, :, rows, : b + 1]
        tag, common = f"{h}x{w}", dict(ratio=ratio, band=b, dims=(n, C, h, w // 2 + 1), exact=n == PB)
        if "full" in modes:
            cases.append((f"full@{tag}", dict(z=z, amp=amp_full, full=True, delta=False, **common)))
        cases.append((f"band@{tag}", dict(z=z, amp=amp_band, full=False, delta=False, **common)))
        cases.append((f"delta@{tag}", dict(z=blk, amp=amp_band, full=False, delta=True, **common)))
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
        if case.get("exact"):
            entry["bit_equal"] = True
        if name in TIMED:
            n, c, h, wh = case["dims"]
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
    extra = {"ram_use_pallas": {"ram_use_pallas": True}, "no_ram_banded_dft": {"ram_banded_dft": False}, "bf16": BF16}
    return TrainConfig(
        dataset="fundus", domain_idxs=(1, 2, 3), test_domain_idx=0, ram=True, rec=True,
        is_out_domain=True, consistency=True, consistency_type="kd", image_size=S,
        save_path=run_dir, device="cuda", **extra.get(name, {}),
    ).resolve()


def eval_fields(res_timing, num):
    """The eval's split by phase, from `FundusEvalResult.timing`."""
    parts = ("dequantise", "resize", "postprocess", "save", "dice", "distances")
    host = sum(res_timing[k] for k in parts)
    return dict(
        eval_s=res_timing["wall"], eval_batches=res_timing["batches"],
        forward_ms_per_batch=1e3 * res_timing["forward"] / res_timing["batches"],
        readback_ms=1e3 * res_timing["readback"], load_ms=1e3 * res_timing["load"],
        host_ms_per_image=1e3 * host / num,
        host_ms_per_image_by_part={k: 1e3 * res_timing[k] / num for k in parts},
        host_share=host / res_timing["wall"],
    )


def phase_main_path(torch, np, ram_mix, arrays, testset):
    from ramdsir_tpu_torch.config import TrainConfig
    from ramdsir_tpu_torch.data.device_pipeline import DeviceFundusPipeline
    from ramdsir_tpu_torch.train.checkpoint import load_torch_checkpoint
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
        summary = fit(cfg, max_steps=steps, pipeline=pipe, testset=testset)
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
        # the keep-best file loads strictly into freshly built modules
        load_torch_checkpoint(summary["best_checkpoint"], build_models(cfg))
        csv_rows = open(os.path.join(run_dir, f"{cfg.test_domain_idx}_val_log.csv")).read().splitlines()
        evals = [r["eval/avg_dice"] for r in rows if "eval/avg_dice" in r]
        entry = dict(
            run=name, steps=summary["steps"], k1_launches=launches, k1_paths=paths, losses_finite=finite,
            first_loss=rows[0]["loss/loss"], last_loss=[r for r in rows if "loss/loss" in r][-1]["loss/loss"],
            median_step_ms=summary["median_step_ms"], images_per_sec=summary["images_per_sec"],
            peak_memory_bytes=peak, wall_s=wall, batch=sum(cfg.batch_size_list), image_size=S,
            tf32=tf32_settings(), cup_dice=summary["cup_dice"], disc_dice=summary["disc_dice"],
            best=summary["best"], best_file=os.path.basename(summary["best_checkpoint"]),
            csv_rows=len(csv_rows), evals=len(evals), eval_images=len(testset), eval_original_size=EVAL_SIZE,
            test_batch=cfg.test_batch_size, **eval_fields(summary["eval_timing"], len(testset)),
            compute_dtype=cfg.compute_dtype, predict_dtype=cfg.predict_dtype,
        )
        if name == "bf16":
            entry["float32"] = {k: runs["default"][k] for k in ("median_step_ms", "images_per_sec", "peak_memory_bytes")}
        emit("bf16_path" if name == "bf16" else "main_path", **entry)
        if not finite:
            raise SystemExit(f"main path {name}: non-finite or missing losses")
        expected_evals = (steps - 1) // len(pipe) + 1  # one an epoch, and one at the last step
        if len(csv_rows) != expected_evals or len(evals) != expected_evals:
            raise SystemExit(f"main path {name}: {len(csv_rows)} CSV rows, {len(evals)} evals, expected {expected_evals}")
        dice_ok = all(0.0 <= summary[k] <= 1.0 for k in ("cup_dice", "disc_dice"))
        if not dice_ok or summary["eval_timing"]["batches"] != -(-len(testset) // cfg.test_batch_size):
            raise SystemExit(f"main path {name}: eval gave {summary['cup_dice']}, {summary['disc_dice']}")
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
    from ramdsir_tpu_torch.train.steps import sample_step_draws

    set_exact_float32(torch)
    results = {}
    for name in ("default", "ram_use_pallas"):
        cfg = main_path_config(TrainConfig, name, os.path.join(OUT, "parity"))
        pipe = DeviceFundusPipeline.from_arrays(
            arrays, cfg.domain_idxs, cfg.batch_size_list, cfg.test_domain_idx,
            is_out_domain=True, seed=cfg.seed, precompute_donor_amp=cfg.ram_precompute_donor_amp, device="cuda",
        )
        row = next(iter(pipe))
        draws = sample_step_draws(torch.Generator().manual_seed(5), sum(cfg.batch_size_list), torch.device("cuda"))
        out = {impl: step_from_seed(torch, ram_mix, cfg, pipe, row, draws, plain=impl == "plain")[:2]
               for impl in ("kernel", "plain")}
        loss_rel, param_err, stat_err, stats_ok = step_distance(torch, out["kernel"], out["plain"])
        entry = dict(run=name, loss=out["kernel"][0]["loss"], loss_max_rel=loss_rel, loss_tol=1e-5,
                     params_max_abs=param_err, params_tol=2.5 * cfg.lr,
                     running_stats_max_abs=stat_err, stats_tol="rtol 1e-4, atol 1e-5")
        emit("step_parity", **entry)
        if not (loss_rel <= 1e-5 and param_err <= 2.5 * cfg.lr and stats_ok):
            raise SystemExit(f"step parity {name}: kernel and plain steps disagree: {entry}")
        results[name] = entry
    return results


def step_from_seed(torch, ram_mix, cfg, pipe, row, draws, plain=False, load=None, device="cuda"):
    """One step from the seed's fresh state (or from the `.ckpt` `load`),
    through K1 or through the plain mix: its metrics, its state dict and its
    K1 launches."""
    from ramdsir_tpu_torch.train.checkpoint import load_checkpoint
    from ramdsir_tpu_torch.train.state import init_state
    from ramdsir_tpu_torch.train.steps import make_train_step

    state = init_state(cfg, torch.Generator().manual_seed(cfg.seed), device)
    if load:
        load_checkpoint(load, state)
    step = make_train_step(cfg, total_iters=1000, batch_size_list=cfg.batch_size_list, device_data=pipe.device_data)
    before = ram_mix.launches
    with mock.patch.object(ram_mix, "mix_spectrum", ram_mix.mix_spectrum_plain) if plain else contextlib.nullcontext():
        m = step(state, row, draws=draws)
    sd = {f"{n}.{k}": v.detach().clone() for n, mod in state.models.items() for k, v in mod.state_dict().items()}
    return {k: float(v) for k, v in m.items()}, sd, ram_mix.launches - before


def step_distance(torch, a, b):
    """(largest relative loss difference, largest parameter difference,
    largest running-statistic difference, running statistics within rtol
    1e-4 / atol 1e-5) between two steps' (metrics, state dict)."""
    (ma, sa), (mb, sb) = a, b
    loss_rel = max(abs(ma[k] - mb[k]) / max(abs(mb[k]), 1e-6) for k in ma)
    param_err = max(float((sa[k] - sb[k]).abs().max()) for k in sa if "running" not in k)
    stats = [k for k in sa if "running" in k]
    stat_err = max(float((sa[k] - sb[k]).abs().max()) for k in stats)
    return loss_rel, param_err, stat_err, all(torch.allclose(sa[k], sb[k], rtol=1e-4, atol=1e-5) for k in stats)


BF16_LOSS_TOL = {"loss": 5e-3, "term": 5e-2}  # tests/test_torch_port_bf16.py


def phase_bf16_step_parity(torch, np, ram_mix, arrays):
    """One bfloat16 step through K1 and through the plain mix from the same
    state and draws (TF32 off, deterministic cuDNN): K1 is bit-equal to its
    plain version, so the two agree within step_parity's float32 bounds.
    Then the float32 step from the same state: each loss within the spread
    of bfloat16 from float32 that the CPU tests measure (JAX's own bfloat16
    step lies up to 4.1e-2 from its float32 one by term, 2.4e-3 in total, at
    32^2): 5e-2 by term, 5e-3 for the total."""
    from ramdsir_tpu_torch.config import TrainConfig
    from ramdsir_tpu_torch.data.device_pipeline import DeviceFundusPipeline
    from ramdsir_tpu_torch.train.steps import sample_step_draws

    set_exact_float32(torch)
    cfg16 = main_path_config(TrainConfig, "bf16", os.path.join(OUT, "parity"))
    cfg32 = main_path_config(TrainConfig, "default", os.path.join(OUT, "parity"))
    pipe = DeviceFundusPipeline.from_arrays(
        arrays, cfg16.domain_idxs, cfg16.batch_size_list, cfg16.test_domain_idx,
        is_out_domain=True, seed=cfg16.seed, precompute_donor_amp=cfg16.ram_precompute_donor_amp, device="cuda",
    )
    row = next(iter(pipe))
    draws = sample_step_draws(torch.Generator().manual_seed(5), sum(cfg16.batch_size_list), torch.device("cuda"))
    steps = {name: step_from_seed(torch, ram_mix, cfg, pipe, row, draws, plain=plain)
             for name, cfg, plain in (("kernel", cfg16, False), ("plain", cfg16, True), ("float32", cfg32, False))}
    launches = {name: s[2] for name, s in steps.items()}
    loss_rel, param_err, stat_err, stats_ok = step_distance(torch, steps["kernel"][:2], steps["plain"][:2])
    m16, m32 = steps["kernel"][0], steps["float32"][0]
    spread = {k: abs(m16[k] - m32[k]) / max(abs(m32[k]), 1e-6) for k in m16 if k != "lr"}
    spread_ok = all(v <= BF16_LOSS_TOL["loss" if k == "loss" else "term"] for k, v in spread.items())
    entry = dict(run="bf16", loss=m16["loss"], loss_max_rel=loss_rel, loss_tol=1e-5, params_max_abs=param_err,
                 params_tol=2.5 * cfg16.lr, running_stats_max_abs=stat_err, stats_tol="rtol 1e-4, atol 1e-5",
                 k1_launches=launches, float32_loss=m32["loss"], bf16_vs_float32_rel=spread,
                 bf16_vs_float32_tol=BF16_LOSS_TOL)
    emit("bf16_step_parity", **entry)
    if launches != {"kernel": 1, "plain": 0, "float32": 1}:
        raise SystemExit(f"bf16 step parity: K1 launches {launches}")
    if not (loss_rel <= 1e-5 and param_err <= 2.5 * cfg16.lr and stats_ok):
        raise SystemExit(f"bf16 step parity: kernel and plain steps disagree: {entry}")
    if not spread_ok:
        raise SystemExit(f"bf16 step parity: the bfloat16 and float32 losses part by {spread}")


def phase_resume(torch, np, ram_mix, arrays, testset, steps_done):
    """The default run's final_model.ckpt loaded into a fresh state on the
    card equals the file; saved again and loaded into another fresh state,
    every parameter, buffer and Adam moment is bit-equal.  One step from
    each (same row and draws, TF32 off, deterministic cuDNN): the forward
    (losses, running statistics) bit-equal, and the parameters as close as
    two steps from the same loaded state come (the bilinear upsample's
    backward adds with atomics, so two steps from one state may part by a
    flipped Adam sign, within step_parity's 2.5*lr).  Then `fit` resumed
    from the file with max_steps = its steps + RESUME_STEPS: that many steps,
    as many K1 launches, all on delta_flat, the lr going on along the
    schedule."""
    import dataclasses

    from ramdsir_tpu_torch.config import TrainConfig
    from ramdsir_tpu_torch.data.device_pipeline import DeviceFundusPipeline
    from ramdsir_tpu_torch.train.checkpoint import load_checkpoint, read_checkpoint, save_checkpoint
    from ramdsir_tpu_torch.train.loop import fit
    from ramdsir_tpu_torch.train.state import init_state, state_to_tree
    from ramdsir_tpu_torch.train.steps import poly_lr, sample_step_draws

    set_exact_float32(torch)
    src = os.path.join(OUT, "default", "final_model.ckpt")
    run_dir = os.path.join(OUT, "resume")
    shutil.rmtree(run_dir, ignore_errors=True)
    os.makedirs(run_dir)
    cfg = main_path_config(TrainConfig, "default", run_dir)
    a = init_state(cfg, torch.Generator().manual_seed(cfg.seed), "cuda")
    load_checkpoint(src, a)

    def same(x, y):
        if isinstance(x, dict):
            return isinstance(y, dict) and x.keys() == y.keys() and all(same(x[k], y[k]) for k in x)
        return x.dtype == y.dtype and x.shape == y.shape and np.array_equal(x, y)

    file_equal = same(read_checkpoint(src)["state"], state_to_tree(a))
    copy = os.path.join(run_dir, "state.ckpt")
    save_checkpoint(copy, a)
    b = init_state(cfg, torch.Generator().manual_seed(cfg.seed + 1), "cuda")
    load_checkpoint(copy, b)

    def tensors(state):
        out = {f"{n}.{k}": v for n, mod in state.models.items() for k, v in mod.state_dict().items()}
        for i, p in enumerate(p for mod in state.models.values() for p in mod.parameters()):
            out.update({f"adam{i}.{k}": v for k, v in state.optimizer.state[p].items()})
        return out

    ta, tb = tensors(a), tensors(b)
    differing = [k for k in ta if not torch.equal(ta[k].cpu(), tb[k].cpu())]
    pipe = DeviceFundusPipeline.from_arrays(
        arrays, cfg.domain_idxs, cfg.batch_size_list, cfg.test_domain_idx,
        is_out_domain=True, seed=cfg.seed, precompute_donor_amp=cfg.ram_precompute_donor_amp, device="cuda",
    )
    row = next(iter(pipe))
    draws = sample_step_draws(torch.Generator().manual_seed(6), sum(cfg.batch_size_list), torch.device("cuda"))
    one = {name: step_from_seed(torch, ram_mix, cfg, pipe, row, draws, load=path)[:2]
           for name, path in (("original", src), ("again", src), ("resaved", copy))}
    loss_rel, param_err, stat_err, _ = step_distance(torch, one["resaved"], one["original"])
    floor = step_distance(torch, one["again"], one["original"])[1]
    forward_equal = loss_rel == 0.0 and stat_err == 0.0

    ram_mix.launches = 0
    ram_mix.launches_by_path.update(dict.fromkeys(ram_mix.launches_by_path, 0))
    summary = fit(dataclasses.replace(cfg, checkpoint_resume=src), max_steps=steps_done + RESUME_STEPS,
                  pipeline=pipe, testset=testset)
    launches = ram_mix.launches
    paths = {p: k for p, k in ram_mix.launches_by_path.items() if k}
    rows = [json.loads(line) for line in open(os.path.join(run_dir, "log", "metrics.jsonl"))]
    lrs = [(r["step"], r["lr"]) for r in rows if "lr" in r]
    want_lr = poly_lr(cfg.lr, steps_done, len(pipe) * cfg.epochs)
    entry = dict(checkpoint=os.path.relpath(src, REPO), tensors=len(ta), file_equal=file_equal,
                 round_trip_differing=len(differing), step_losses_bit_equal=loss_rel == 0.0,
                 step_running_stats_bit_equal=stat_err == 0.0, step_params_max_abs=param_err,
                 step_params_bit_equal=param_err == 0.0, same_state_params_max_abs=floor, params_tol=2.5 * cfg.lr,
                 resumed_steps=summary["steps"] - steps_done, k1_launches=launches, k1_paths=paths,
                 first_lr=lrs[0] if lrs else None, expected_lr=[steps_done, want_lr])
    emit("resume", **entry)
    if not file_equal or differing:
        raise SystemExit(f"resume: the loaded state differs from the file ({file_equal}) or after a round trip: {differing[:5]}")
    if not forward_equal or param_err > 2.5 * cfg.lr:
        raise SystemExit(f"resume: a step from the re-loaded state differs: {entry}")
    if summary["steps"] != steps_done + RESUME_STEPS or launches != RESUME_STEPS or paths != {"delta_flat": RESUME_STEPS}:
        raise SystemExit(f"resume: fit took {summary['steps']} steps with {launches} K1 launches on {paths}")
    if not lrs or lrs[0][0] != steps_done or abs(lrs[0][1] - want_lr) > 1e-6 * want_lr:  # logged in float32
        raise SystemExit(f"resume: first logged lr {lrs[:1]}, expected {want_lr} at step {steps_done}")


def eval_models(torch, path, device):
    """The eval CLI's modules (encoder, seg decoder) from a .pth or a .ckpt,
    on device, through the eval CLIs' loader."""
    from ramdsir_tpu_torch.config import TrainConfig
    from ramdsir_tpu_torch.train.checkpoint import load_any_checkpoint
    from ramdsir_tpu_torch.train.state import build_models

    cfg = TrainConfig(dataset="fundus", rec=False, ram=False, image_size=S, device=device).resolve()
    models = build_models(cfg)
    load_any_checkpoint(path, models)
    for m in models.values():
        m.to(device)
    return cfg, models


def phase_eval_cli(torch, np, testset):
    """cli/test_fundus_slice.py's path on the default run's final model (the
    CLI itself reads PNGs, which this machine cannot decode), from
    final_model.pth and from final_model.ckpt: the six metrics must be
    equal."""
    from ramdsir_tpu_torch.train.evaluate import eval_fundus
    from ramdsir_tpu_torch.train.steps import make_predict_fn

    scores = {}
    for ext in ("pth", "ckpt"):
        path = os.path.join(OUT, "default", f"final_model.{ext}")
        cfg, models = eval_models(torch, path, "cuda")
        predict = make_predict_fn(cfg, models, bn_adapt=True)
        res = eval_fundus(predict, testset, 0, batch_size=8, image_size=S, with_distances=True)
        torch.cuda.synchronize()
        scores[ext] = {k: getattr(res, k) for k in ("cup_dice", "disc_dice", "hd_oc", "hd_od", "asd_oc", "asd_od")}
        if ext == "pth":
            six, timing, num, pth_path = scores[ext], res.timing, res.num, path
            forward = profile_eval_forward(torch, predict, np.stack([x["img"] for x in testset]))
    emit("eval_cli", model_file=os.path.relpath(pth_path, REPO), bn_adapt=True, with_distances=True, num=num,
         test_batch=8, eval_original_size=EVAL_SIZE, **six, **eval_fields(timing, num),
         ckpt_metrics_equal=scores["ckpt"] == six, forward_profile=forward)
    finite = all(np.isfinite(v) for v in six.values())
    if num != len(testset) or not finite or not all(0.0 <= six[k] <= 1.0 for k in ("cup_dice", "disc_dice")):
        raise SystemExit(f"eval_cli: {num} images, metrics {six}")
    if scores["ckpt"] != six:
        raise SystemExit(f"eval_cli: final_model.ckpt scores {scores['ckpt']}, final_model.pth {six}")


def phase_eval_parity(torch, np, testset, n=16, batch=7):
    """The default run's final weights on the card and on the CPU over the
    first n test images in batches of `batch` (a tail of n % batch)."""
    from ramdsir_tpu_torch.ops import metrics, postprocess
    from ramdsir_tpu_torch.ops.resize import bilinear_resize_chw
    from ramdsir_tpu_torch.train.evaluate import _q16, eval_fundus
    from ramdsir_tpu_torch.train.steps import make_predict_fn

    set_exact_float32(torch)
    path = os.path.join(OUT, "default", "final_model.pth")
    models = {dev: eval_models(torch, path, dev) for dev in ("cuda", "cpu")}
    samples = testset[:n]
    imgs = np.stack([x["img"] for x in samples])
    entry = dict(images=n, batch=batch, tail=n % batch, prob_tol=1e-4, dice_tol=1e-3)
    maps = []  # (probabilities on the card, target) for the host checks
    for bn_adapt in (False, True):
        preds = {dev: make_predict_fn(cfg, m, bn_adapt=bn_adapt) for dev, (cfg, m) in models.items()}
        err = 0.0
        for lo in range(0, n, batch):
            got, want = preds["cuda"](imgs[lo : lo + batch]), preds["cpu"](imgs[lo : lo + batch])
            err = max(err, float((got.cpu() - want).abs().max()))
            if bn_adapt:
                q = _q16(got).cpu().numpy().astype(np.float32) / 65535.0
                maps += [(q[i], samples[lo + i]["mask_orig"]) for i in range(q.shape[0])]
        res = {dev: eval_fundus(p, samples, 0, batch_size=batch, image_size=S) for dev, p in preds.items()}
        dice_err = max(abs(res["cuda"].cup_dice - res["cpu"].cup_dice), abs(res["cuda"].disc_dice - res["cpu"].disc_dice))
        tag = "bn_adapt" if bn_adapt else "running_stats"
        entry[tag] = dict(prob_max_abs=err, dice_max_abs=dice_err, cup_dice=res["cuda"].cup_dice,
                          disc_dice=res["cuda"].disc_dice)
        if err > 1e-4 or dice_err > 1e-3:
            raise SystemExit(f"eval_parity {tag}: probabilities differ by {err}, Dice by {dice_err}")
    # the host library against its scipy plain versions on those maps
    masks = distances = 0
    for prob, target in maps:
        full = bilinear_resize_chw(prob, target.shape[0], target.shape[1])
        tgt = target.transpose(2, 0, 1).astype(bool)
        for threshold in (0.75, 0.5):
            ours = postprocess.postprocessing(full, threshold=threshold, dataset="fundus")
            plain = postprocess.postprocessing(full, threshold=threshold, dataset="fundus",
                                               largest=postprocess.get_largest_fillhole_plain)
            if not np.array_equal(ours, plain):
                raise SystemExit("eval_parity: post-processing differs from its plain version")
            masks += 2
            for ch in range(2):
                p = ours[ch].astype(bool)
                if not (p.any() and tgt[ch].any()):
                    continue
                for a, b in ((p, tgt[ch]), (tgt[ch], p)):
                    if not np.array_equal(metrics.surface_distances(a, b), metrics.surface_distances_plain(a, b)):
                        raise SystemExit("eval_parity: surface distances differ from their plain version")
                    distances += 1
    entry.update(postprocess_masks_bit_equal=masks, distance_sets_bit_equal=distances)
    emit("eval_parity", **entry)
    if not distances:
        raise SystemExit("eval_parity: every predicted mask was empty; no distance was compared")


# --- the prostate path ------------------------------------------------------------


def prostate_config(TrainConfig, run_dir, data_root, bf16=False):
    """The reference prostate configuration (bench.py:72-74, :193-210)."""
    return TrainConfig(
        dataset="prostate", domain_idxs=(0, 1, 2, 3, 4), test_domain_idx=5, ram=True, rec=True,
        consistency=True, consistency_type="kd", image_size=PS, save_path=run_dir, data_root=data_root,
        device=DEVICE, **(BF16 if bf16 else {}),
    ).resolve()


def prostate_eval_fields(timing):
    """The volume eval's split by phase, from `ProstateEvalResult.timing`."""
    host_parts = ("load", "windows", "scatter", "postprocess", "save", "dice", "distances")
    host = sum(timing[k] for k in host_parts)
    return dict(
        eval_s=timing["wall"], eval_volumes=timing["volumes"], eval_batches=timing["batches"],
        forward_ms_per_batch=1e3 * timing["forward"] / timing["batches"],
        readback_ms_per_volume=1e3 * timing["readback"] / timing["volumes"],
        host_ms_per_volume_by_part={k: 1e3 * timing[k] / timing["volumes"] for k in host_parts},
        host_share=host / timing["wall"],
    )


def phase_prostate_path(torch, np, ram_mix, prostate, data_root, bf16_beside=None):
    """The float32 run (`prostate_path`), or with `bf16_beside` (that run's
    entry) the bfloat16 run (`prostate_bf16_path`)."""
    from ramdsir_tpu_torch.config import TrainConfig
    from ramdsir_tpu_torch.data.device_pipeline import DeviceProstatePipeline
    from ramdsir_tpu_torch.train.checkpoint import load_torch_checkpoint
    from ramdsir_tpu_torch.train.loop import fit, tf32_settings
    from ramdsir_tpu_torch.train.state import build_models

    bf16 = bf16_beside is not None
    phase, steps = ("prostate_bf16_path", PROSTATE_BF16_STEPS) if bf16 else ("prostate_path", PROSTATE_STEPS)
    run_dir = os.path.join(PROSTATE_OUT, "bf16" if bf16 else "run")
    shutil.rmtree(run_dir, ignore_errors=True)
    cfg = prostate_config(TrainConfig, run_dir, data_root, bf16)
    pipe = DeviceProstatePipeline.from_arrays(
        prostate, cfg.domain_idxs, cfg.batch_size_list, cfg.test_domain_idx,
        is_out_domain=cfg.is_out_domain, seed=cfg.seed, precompute_donor_amp=cfg.ram_precompute_donor_amp,
        device=DEVICE,
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
    keys = ("loss_ce_1", "loss_dice_1", "loss_ce_2", "loss_dice_2", "loss_consistency", "loss_rec", "loss")
    steps_logged = [r for r in rows if "loss/loss" in r]
    finite = len(steps_logged) == steps and all(
        set(k[5:] for k in r if k.startswith("loss/")) == set(keys) and np.all(np.isfinite([r[f"loss/{k}"] for k in keys]))
        for r in steps_logged
    )
    payload = torch.load(summary["final_checkpoint"], map_location="cpu")
    for mname, module in build_models(cfg).items():
        module.load_state_dict(payload[f"{mname}_state_dict"], strict=True)
    load_torch_checkpoint(summary["best_checkpoint"], build_models(cfg))
    csv_rows = open(os.path.join(run_dir, f"{cfg.test_domain_idx}_val_log.csv")).read().splitlines()
    timing = summary["eval_timing"]
    entry = dict(
        run="prostate_bf16" if bf16 else "prostate", steps=summary["steps"], k1_launches=launches, k1_paths=paths,
        losses_finite=finite, compute_dtype=cfg.compute_dtype, predict_dtype=cfg.predict_dtype,
        first_loss=steps_logged[0]["loss/loss"], last_loss=steps_logged[-1]["loss/loss"],
        median_step_ms=summary["median_step_ms"], images_per_sec=summary["images_per_sec"],
        peak_memory_bytes=peak, wall_s=wall, batch=sum(cfg.batch_size_list), image_size=PS,
        dsbn_domains=len(cfg.domain_idxs), tf32=tf32_settings(), dice=summary["dice"], best=summary["best"],
        best_file=os.path.basename(summary["best_checkpoint"]), csv_rows=len(csv_rows),
        eval_depth=PROSTATE_DEPTH, test_batch=cfg.test_batch_size, **prostate_eval_fields(timing),
    )
    if bf16:
        entry["float32"] = {k: bf16_beside[k] for k in ("median_step_ms", "images_per_sec", "peak_memory_bytes")}
    emit(phase, **entry)
    if not finite:
        raise SystemExit(f"{phase}: non-finite or missing losses")
    if summary["steps"] != steps or launches != steps or paths != {"delta_flat": steps}:
        raise SystemExit(f"{phase}: {summary['steps']} steps, K1 launches {launches} on {paths}, "
                         f"expected {steps} on delta_flat")
    expected_evals = (steps - 1) // len(pipe) + 1  # one an epoch, and one at the last step
    if len(csv_rows) != expected_evals or not 0.0 <= summary["dice"] <= 1.0:
        raise SystemExit(f"{phase}: {len(csv_rows)} CSV rows (expected {expected_evals}), Dice {summary['dice']}")
    if timing["volumes"] != PROSTATE_VOLUMES or timing["batches"] != PROSTATE_VOLUMES * (PROSTATE_DEPTH // cfg.test_batch_size):
        raise SystemExit(f"{phase}: eval read {timing['volumes']} volumes in {timing['batches']} batches")
    return entry


def phase_prostate_eval_cli(torch, np, data_root):
    """cli/test_prostate_volume.py's main on the prostate run's final model,
    on the card by default: BN adaptation, distances, the CSV log."""
    from ramdsir_tpu_torch.cli.test_prostate_volume import main as eval_main

    path = os.path.join(PROSTATE_OUT, "run", "final_model.pth")
    save = os.path.join(PROSTATE_OUT, "eval")
    res = eval_main(["--model_file", path, "--data_dir", data_root, "--datasetTest", "5",
                     "--test_prediction_save_path", save, "--batch_size", str(PROSTATE_TEST_BATCH),
                     "--device", DEVICE])
    torch.cuda.synchronize()
    three = dict(dice=res.dice, hd95=res.hd, asd=res.asd)
    emit("prostate_eval_cli", model_file=os.path.relpath(path, REPO), bn_adapt=True, with_distances=True,
         num=res.num, per_case=res.per_case, **three, **prostate_eval_fields(res.timing))
    if res.num != PROSTATE_VOLUMES or not all(np.isfinite(v) for v in three.values()) or not 0.0 <= res.dice <= 1.0:
        raise SystemExit(f"prostate_eval_cli: {res.num} volumes, metrics {three}")
    if not os.path.isfile(os.path.join(save, "test5_log.csv")):
        raise SystemExit("prostate_eval_cli: no CSV log")


def phase_prostate_step_parity(torch, np, ram_mix, prostate):
    """One prostate step through K1 and through the plain mix, as
    phase_step_parity does for fundus."""
    from ramdsir_tpu_torch.config import TrainConfig
    from ramdsir_tpu_torch.data.device_pipeline import DeviceProstatePipeline
    from ramdsir_tpu_torch.train.steps import sample_step_draws

    set_exact_float32(torch)
    cfg = prostate_config(TrainConfig, os.path.join(PROSTATE_OUT, "parity"), "unused")
    pipe = DeviceProstatePipeline.from_arrays(
        prostate, cfg.domain_idxs, cfg.batch_size_list, cfg.test_domain_idx, seed=cfg.seed, device=DEVICE
    )
    row = next(iter(pipe))
    draws = sample_step_draws(torch.Generator().manual_seed(5), PB, torch.device(DEVICE), crop=False)
    out = {}
    for impl in ("kernel", "plain"):
        metrics, sd, launched = step_from_seed(torch, ram_mix, cfg, pipe, row, draws, plain=impl == "plain", device=DEVICE)
        out[impl] = (metrics, sd)
        if launched != (impl == "kernel"):
            raise SystemExit(f"prostate step parity: the {impl} step launched K1 {launched} times")
    loss_rel, param_err, stat_err, stats_ok = step_distance(torch, out["kernel"], out["plain"])
    entry = dict(run="prostate", loss=out["kernel"][0]["loss"], loss_max_rel=loss_rel, loss_tol=1e-5,
                 params_max_abs=param_err, params_tol=2.5 * cfg.lr,
                 running_stats_max_abs=stat_err, stats_tol="rtol 1e-4, atol 1e-5")
    emit("prostate_step_parity", **entry)
    if not (loss_rel <= 1e-5 and param_err <= 2.5 * cfg.lr and stats_ok):
        raise SystemExit(f"prostate step parity: kernel and plain steps disagree: {entry}")


def phase_prostate_eval_parity(torch, np, volume):
    """The prostate run's final weights and one volume on the card and on the
    CPU (TF32 off, deterministic cuDNN) in both BN modes, through
    eval_prostate_volumes; then the host library against scipy on the card's
    predictions."""
    from ramdsir_tpu_torch.config import TrainConfig
    from ramdsir_tpu_torch.ops import metrics, postprocess
    from ramdsir_tpu_torch.train import evaluate
    from ramdsir_tpu_torch.train.checkpoint import load_torch_checkpoint
    from ramdsir_tpu_torch.train.state import build_models
    from ramdsir_tpu_torch.train.steps import make_predict_fn

    set_exact_float32(torch)
    path = os.path.join(PROSTATE_OUT, "run", "final_model.pth")
    entry = dict(volume=volume[0], depth=volume[1].shape[0], batch=PROSTATE_TEST_BATCH, prob_tol=1e-4,
                 label_share_tol=1e-4, dice_tol=1e-3)
    card_labels = None
    for bn_adapt in (False, True):
        got = {}
        for dev in (DEVICE, "cpu"):
            cfg = TrainConfig(dataset="prostate", rec=False, ram=False, device=dev).resolve()
            models = build_models(cfg)
            load_torch_checkpoint(path, models)
            for m in models.values():
                m.to(dev)
            predict = make_predict_fn(cfg, models, bn_adapt=bn_adapt)
            probs, labels = [], []

            def recording(x, predict=predict, probs=probs):
                probs.append(predict(x).cpu())
                return probs[-1].to(dev)

            def region(pred_y, labels=labels):
                labels.append(pred_y)
                return postprocess.connectivity_region_analysis(pred_y)

            with mock.patch.object(evaluate, "connectivity_region_analysis", region):
                res = evaluate.eval_prostate_volumes(recording, [volume], 5, batch_size=PROSTATE_TEST_BATCH)
            got[dev] = (torch.stack(probs), labels[0], res.dice)
        (pc, lc, dc), (pp, lp, dp) = got[DEVICE], got["cpu"]
        prob_err = float((pc - pp).abs().max())
        label_share = float(np.mean(lc != lp))
        tag = "bn_adapt" if bn_adapt else "running_stats"
        entry[tag] = dict(prob_max_abs=prob_err, label_share_differing=label_share, dice_abs=abs(dc - dp),
                          dice=dc, batches=len(pc), foreground_voxels=int(lc.sum()))
        if prob_err > 1e-4 or label_share > 1e-4 or abs(dc - dp) > 1e-3:
            raise SystemExit(f"prostate_eval_parity {tag}: {entry[tag]}")
        card_labels = lc
    # the host library against scipy on the card's labels of the volume
    mask = volume[2] != 0
    ours = postprocess.connectivity_region_analysis(card_labels)
    plain = postprocess.connectivity_region_analysis_plain(card_labels)
    if ours.dtype != plain.dtype or not np.array_equal(ours, plain):
        raise SystemExit("prostate_eval_parity: largest_cc_nd differs from its plain version")
    distances = 0
    for pred in (ours.astype(bool), card_labels != 0):
        if not (pred.any() and mask.any()):
            continue
        for a, b in ((pred, mask), (mask, pred)):
            if not np.array_equal(metrics.surface_distances(a, b), metrics.surface_distances_plain(a, b)):
                raise SystemExit("prostate_eval_parity: 3-D surface distances differ from their plain version")
            distances += 1
    entry.update(largest_cc_bit_equal=True, distance_sets_bit_equal=distances)
    emit("prostate_eval_parity", **entry)
    if not distances:
        raise SystemExit("prostate_eval_parity: the card predicted no foreground; no distance was compared")


def set_exact_float32(torch):
    """float32 convolutions and products without TF32, deterministic cuDNN."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


KERNEL_GROUPS = [  # (group, substrings of CUDA kernel names), first match wins
    ("K1 ram_mix", ("mix_full_vec_kernel", "mix_delta_flat_kernel", "mix_strided_kernel")),
    ("K2 upsample2x_backward", ("upsample2x_backward_kernel",)),
    ("fft", ("fft", "radix", "regular_fft", "vector_fft")),
    ("batch_norm", ("batch_norm", "bn_", "welford")),
    ("layout nchw<->nhwc", ("nchwToNhwc", "nhwcToNchw")),
    ("upsample", ("upsample",)),
    ("conv", ("conv", "xmma", "implicit", "wgrad", "dgrad", "cudnn", "sm90_", "cutlass")),
    ("matmul", ("gemm", "gemv", "cublas")),
    ("copy/cat", ("copy", "Copy", "memcpy", "Memcpy", "memset", "Memset", "CatArray")),
]


def phase_profile(torch, ram_mix, arrays, prostate, steps=5, warmup=3):
    """Where a default fundus step's and a prostate step's device time goes,
    in float32 and in bfloat16, and a fundus float32 step under
    deterministic_mode (K2 for the upsample's backward): torch.profiler over
    `steps` steps after `warmup`, each step synchronised as `fit` does."""
    from ramdsir_tpu_torch.config import TrainConfig
    from ramdsir_tpu_torch.data.device_pipeline import DeviceFundusPipeline, DeviceProstatePipeline

    from ramdsir_tpu_torch.train.loop import deterministic_mode

    for run in ("default", "bf16", "default_deterministic"):
        cfg = main_path_config(TrainConfig, run.replace("_deterministic", ""), os.path.join(OUT, "profile"))
        pipe = DeviceFundusPipeline.from_arrays(
            arrays, cfg.domain_idxs, cfg.batch_size_list, cfg.test_domain_idx,
            is_out_domain=True, seed=cfg.seed, precompute_donor_amp=True, device="cuda",
        )
        with deterministic_mode(run.endswith("deterministic")):
            profile_steps(torch, run, cfg, pipe, steps, warmup)
    for run in ("prostate", "prostate_bf16"):
        cfg = prostate_config(TrainConfig, os.path.join(PROSTATE_OUT, "profile"), "unused", run == "prostate_bf16")
        pipe = DeviceProstatePipeline.from_arrays(
            prostate, cfg.domain_idxs, cfg.batch_size_list, cfg.test_domain_idx, seed=cfg.seed, device="cuda"
        )
        profile_steps(torch, run, cfg, pipe, steps, warmup)


def profile_steps(torch, run, cfg, pipe, steps, warmup):
    from torch.profiler import ProfilerActivity, profile

    from ramdsir_tpu_torch.train.state import init_state
    from ramdsir_tpu_torch.train.steps import make_train_step

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
    emit("profile", run=run, steps=steps, step_ms=wall_us / steps / 1e3, batch=sum(cfg.batch_size_list),
         image_size=cfg.image_size, compute_dtype=cfg.compute_dtype, **device_breakdown(prof, wall_us, steps, "step"))


def device_breakdown(prof, wall_us, count, unit):
    """Device busy time, idle share, launches and time by kernel group per
    `unit` from a torch.profiler run over `count` units in `wall_us`."""
    from torch.autograd import DeviceType

    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    per_name, per_group = {}, {}
    for e in kernels:
        us = e.time_range.elapsed_us()
        per_name[e.name] = per_name.get(e.name, 0.0) + us
        group = next((g for g, keys in KERNEL_GROUPS if any(k in e.name for k in keys)), "elementwise/other")
        per_group[group] = per_group.get(group, 0.0) + us
    busy_us = sum(per_name.values())
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:12]
    return {
        f"device_busy_ms_per_{unit}": busy_us / count / 1e3,
        "device_idle_share": (1.0 - busy_us / wall_us) if kernels else "not measured",
        f"kernel_launches_per_{unit}": len(kernels) / count,
        f"ms_per_{unit}_by_group": {g: us / count / 1e3 for g, us in sorted(per_group.items(), key=lambda kv: -kv[1])},
        f"top_kernels_ms_per_{unit}": [[name[:80], us / count / 1e3] for name, us in top],
    }


def profile_eval_forward(torch, predict, imgs, batch=8, reps=4):
    """Where the eval forward's time goes: torch.profiler over `reps` full
    batches, dispatched as eval_fundus does (sigmoid and uint16 quantisation
    included), one synchronise at the end."""
    from torch.profiler import ProfilerActivity, profile

    from ramdsir_tpu_torch.train.evaluate import _q16

    for _ in range(2):
        _q16(predict(imgs[:batch]))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(reps):
            _q16(predict(imgs[i * batch : (i + 1) * batch]))
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    return dict(batches=reps, batch=batch, ms_per_batch=wall_us / reps / 1e3,
                **device_breakdown(prof, wall_us, reps, "batch"))


# --- the fundus path from a PNG tree ------------------------------------------------


def phase_png_tree(torch, np, ram_mix):
    """The reference fundus configuration trained and scored from a PNG tree
    that the port writes and reads itself (no PIL on this machine): 800^2
    source images, 4 domains x PNG_TRAIN train pairs, PNG_TEST test pairs in
    target domain 0 (one in the others), every row filter and the adaptive
    choice across the files, palette masks in Domain3.  Every file decodes
    to the array written; `DeviceFundusPipeline.from_tree` equals the port's
    resize of those arrays; cli.train trains one epoch with its eval
    (K1 launches == steps); cli.test_fundus_slice scores it with
    --save_result, and every overlay decodes to the array written."""
    from ramdsir_tpu_torch.cli.test_fundus_slice import main as eval_main
    from ramdsir_tpu_torch.cli.train import main as train_main
    from ramdsir_tpu_torch.config import FUNDUS_DOMAINS, TrainConfig
    from ramdsir_tpu_torch.data import png
    from ramdsir_tpu_torch.data.device_pipeline import DeviceFundusPipeline
    from ramdsir_tpu_torch.data.fundus import FundusMultiDataset, fundus_multilabel
    from ramdsir_tpu_torch.data.synthetic import fundus_tree_pairs, make_fundus_tree
    from ramdsir_tpu_torch.ops.image import convert, resize
    from ramdsir_tpu_torch.ops.ram import banded_amplitude_spectrum

    shutil.rmtree(PNG_OUT, ignore_errors=True)
    data_root = os.path.join(PNG_OUT, "data")
    tree = dict(per_domain_train=PNG_TRAIN, per_domain_test={d: PNG_TEST if i == 0 else 1 for i, d in enumerate(FUNDUS_DOMAINS)},
                size=PNG_SIZE, seed=2)
    t0 = time.perf_counter()
    base = make_fundus_tree(data_root, filter_types=PNG_FILTERS, palette_mask_domains=("Domain3",), **tree)
    write_s = time.perf_counter() - t0

    # every file back to its array; the host's decode and resize costs; the
    # expected device arrays of the three source domains (1, 2, 3)
    cfg = TrainConfig(dataset="fundus", domain_idxs=(1, 2, 3), test_domain_idx=0, image_size=S).resolve()
    sources = [FUNDUS_DOMAINS[d] for d in cfg.domain_idxs]
    want = {"images": {d: [] for d in sources}, "masks": {d: [] for d in sources}}
    cost = {"decode_rgb": [], "decode_mask": [], "resize_bilinear": [], "resize_nearest": []}
    files, modes = 0, set()
    for dom, split, i, img, mask in fundus_tree_pairs(**tree):
        for kind, arr in (("image", img), ("mask", mask)):
            path = os.path.join(base, dom, split, kind, f"{i:03d}.png")
            t = time.perf_counter()
            dec = png.decode(path)
            cost["decode_rgb" if kind == "image" else "decode_mask"].append(time.perf_counter() - t)
            got = convert(dec, "RGB" if kind == "image" else "L")
            if not np.array_equal(got, arr):
                raise SystemExit(f"png_tree: {path} decodes to other values than were written")
            files += 1
            modes.add(dec.mode)
        if split == "train" and dom in sources:
            t = time.perf_counter()
            small = resize(img, (S, S), "bilinear")
            cost["resize_bilinear"].append(time.perf_counter() - t)
            t = time.perf_counter()
            gray = resize(mask, (S, S), "nearest")
            cost["resize_nearest"].append(time.perf_counter() - t)
            want["images"][dom].append(small)
            want["masks"][dom].append(fundus_multilabel(gray).astype(np.uint8))
    t0 = time.perf_counter()
    pipe = DeviceFundusPipeline.from_tree(
        [FundusMultiDataset(base, [d]) for d in cfg.domain_idxs], cfg.batch_size_list, base, S, 0,
        is_out_domain=True, seed=cfg.seed, precompute_donor_amp=True, device=DEVICE,
    )
    sync(torch)
    from_tree_s = time.perf_counter() - t0
    images = np.concatenate([np.stack(want["images"][d]) for d in sources])
    masks = np.concatenate([np.stack(want["masks"][d]) for d in sources])
    donor_amp = banded_amplitude_spectrum(torch.from_numpy(images).to(DEVICE))  # the donor pool: the same images
    from_tree_equal = {
        "images": torch.equal(pipe.device_data["images"].cpu(), torch.from_numpy(images).permute(0, 3, 1, 2)),
        "masks": torch.equal(pipe.device_data["masks"].cpu(), torch.from_numpy(masks).permute(0, 3, 1, 2)),
        "donor_amp": torch.equal(pipe.device_data["donor_amp"], donor_amp),
    }
    del pipe

    # the train CLI: one epoch of the reference configuration, its eval
    run_dir = os.path.join(PNG_OUT, "run")
    ram_mix.launches = 0
    ram_mix.launches_by_path.update(dict.fromkeys(ram_mix.launches_by_path, 0))
    t0 = time.perf_counter()
    summary = train_main(["--data_root", data_root, "--dataset", "fundus", "--domain_idxs", "1,2,3",
                          "--test_domain_idx", "0", "--ram", "--rec", "--consistency", "--consistency_type", "kd",
                          "--is_out_domain", "--image_size", str(S), "--epochs", "1", "--save_path", run_dir,
                          "--device", DEVICE])
    sync(torch)
    train_s = time.perf_counter() - t0
    k1 = ram_mix.launches
    timing = summary["eval_timing"]

    # the eval CLI with --save_result: every overlay decodes to what was written
    written = {}
    write = png.write

    def recording_write(path, array, **kw):
        written[path] = np.array(array)
        return write(path, array, **kw)

    eval_dir = os.path.join(PNG_OUT, "eval")
    t0 = time.perf_counter()
    with mock.patch.object(png, "write", recording_write):
        res = eval_main(["--model_file", os.path.join(run_dir, "final_model.pth"), "--data_dir", data_root,
                         "--datasetTest", "0", "--test_prediction_save_path", eval_dir, "--batch_size", "8",
                         "--image_size", str(S), "--save_result", "--device", DEVICE])
    sync(torch)
    eval_cli_s = time.perf_counter() - t0
    round_trip = sum(np.array_equal(png.decode(p).array, a) for p, a in written.items())
    six = {k: getattr(res, k) for k in ("cup_dice", "disc_dice", "hd_oc", "hd_od", "asd_oc", "asd_od")}
    ms = lambda xs: 1e3 * statistics.median(xs)
    entry = dict(
        source_size=PNG_SIZE, domains=len(FUNDUS_DOMAINS), per_domain_train=PNG_TRAIN, target_test=PNG_TEST,
        files=files, modes=sorted(modes), filters=[str(f) for f in PNG_FILTERS], write_s=write_s,
        decode_ms_per_image={"rgb": ms(cost["decode_rgb"]), "mask": ms(cost["decode_mask"])},
        resize_ms_per_image={"bilinear_rgb": ms(cost["resize_bilinear"]), "nearest_mask": ms(cost["resize_nearest"])},
        from_tree_s=from_tree_s, from_tree_images=len(images), from_tree_equal=from_tree_equal,
        train_s=train_s, steps=summary["steps"], k1_launches=k1, median_step_ms=summary["median_step_ms"],
        cup_dice=summary["cup_dice"], disc_dice=summary["disc_dice"],
        eval_load_share=timing["load"] / timing["wall"], **eval_fields(timing, PNG_TEST),
        eval_cli=dict(seconds=eval_cli_s, num=res.num, **six, load_share=res.timing["load"] / res.timing["wall"],
                      save_share=res.timing["save"] / res.timing["wall"], overlays=len(written),
                      overlays_round_trip=round_trip),
    )
    emit("png_tree", **entry)
    if files != 2 * (len(FUNDUS_DOMAINS) * PNG_TRAIN + PNG_TEST + len(FUNDUS_DOMAINS) - 1) or modes != {"RGB", "L", "P"}:
        raise SystemExit(f"png_tree: {files} files checked in modes {modes}")
    if not all(from_tree_equal.values()):
        raise SystemExit(f"png_tree: from_tree differs from the resized arrays: {from_tree_equal}")
    steps = PNG_TRAIN // min(cfg.batch_size_list)
    if summary["steps"] != steps or k1 != steps or timing["batches"] != -(-PNG_TEST // cfg.test_batch_size):
        raise SystemExit(f"png_tree: {summary['steps']} steps, {k1} K1 launches, {timing['batches']} eval batches")
    if res.num != PNG_TEST or not all(np.isfinite(v) for v in six.values()):
        raise SystemExit(f"png_tree: the eval CLI scored {res.num} images: {six}")
    if len(written) != PNG_TEST or round_trip != PNG_TEST:
        raise SystemExit(f"png_tree: {len(written)} overlays written, {round_trip} read back equal")


# --- --deterministic and K2 ---------------------------------------------------------


def k2_bytes(shape, itemsize):
    """The least bytes K2 must move for an (N, C, H, W) input gradient: the
    (N, C, 2H, 2W) output gradient read once, the input gradient written once."""
    n, c, h, w = shape
    return itemsize * (4 * n * c * h * w + n * c * h * w)


def phase_k2(torch, bw, shapes):
    """K2 against its plain version on the card at each (shape, dtype) a
    deterministic step gives it, bit for bit, and against torch's own
    upsample_bilinear2d backward (atomics, another summation order) of the
    same gradient in float32; beside it, torch's backward in the gradient's
    own dtype (in bfloat16 its atomics round every add); at
    each: `ms` as K1's, `kernel_ms`, the plain version's and the
    library call's times, and the bytes bound.  K2's `kernel_ms` is
    `back_to_back_ms` (torch.profiler dropped some of K2's kernels on the
    card: it saw 13 of 20)."""
    from ramdsir_tpu_torch.ops import upsample

    gen = torch.Generator(device="cuda").manual_seed(7)
    flush_buf = torch.empty(128 * 2**20, dtype=torch.uint8, device="cuda")
    flush = lambda: flush_buf.zero_()
    out = {}
    for shape, dtype in shapes:
        n, c, h, w = shape
        g = torch.randn((n, c, 2 * h, 2 * w), generator=gen, device="cuda").to(dtype)
        before = upsample.launches
        got = upsample.upsample2x_backward(g)
        want = upsample.upsample2x_backward_plain(g)
        lib = lambda x=g: torch.ops.aten.upsample_bilinear2d_backward(x, [2 * h, 2 * w], list(shape), False, 2.0, 2.0)
        ref, ref32 = lib(), lib(g.float())
        torch.cuda.synchronize()
        if upsample.launches != before + 1:
            raise SystemExit(f"K2 at {shape}: {upsample.launches - before} launches for one call")
        err = float((got.float() - want.float()).abs().max())
        lib_err = float((got.float() - ref.float()).abs().max() / ref.float().abs().max())
        lib32_err = float((got.float() - ref32).abs().max() / ref32.abs().max())
        key = f"{'x'.join(map(str, shape))}:{str(dtype).split('.')[-1]}"
        entry = dict(shape=list(shape), dtype=str(dtype).split(".")[-1], max_abs_err=err, bit_equal=err == 0.0,
                     library_max_rel_err=lib_err, float32_library_max_rel_err=lib32_err,
                     ms=cuda_time_ms(lambda: upsample.upsample2x_backward(g), reps=20, flush=flush),
                     kernel_ms=back_to_back_ms(lambda: upsample.upsample2x_backward(g)),
                     plain_ms=cuda_time_ms(lambda: upsample.upsample2x_backward_plain(g), reps=10, flush=flush),
                     library_ms=cuda_time_ms(lib, reps=20, flush=flush),
                     bound_ms=1e3 * k2_bytes(shape, g.element_size()) / bw, bound_by="bytes")
        emit("k2", case=key, **entry)
        # against torch's float32 backward of the same gradient: float32 sums in
        # another order (1e-5), and in bfloat16 K2's one rounding (2^-8)
        if not entry["bit_equal"] or lib32_err > (1e-5 if dtype == torch.float32 else 2.0**-8):
            raise SystemExit(f"K2 at {key}: {err} from its plain version, {lib32_err} from torch's float32 backward")
        out[key] = entry
    return out


def _same_tree(np, x, y):
    if isinstance(x, dict):
        return isinstance(y, dict) and x.keys() == y.keys() and all(_same_tree(np, x[k], y[k]) for k in x)
    return x.dtype == y.dtype and x.shape == y.shape and np.array_equal(x, y)


DET_RUNS = ("default", "deterministic", "deterministic_again", "default_again")  # in turns, one call


def phase_deterministic(torch, np, ram_mix, arrays, testset, prostate, prostate_root):
    """--deterministic on the card: for fundus and prostate, float32 and
    bfloat16, four `fit` runs of DET_STEPS steps from one seed, in turns
    without and with the mode.  The two deterministic runs must end in
    bit-equal parameters, BN statistics and Adam moments (their
    final_model.ckpt) and log bit-equal losses; K2 launches 8 a step with
    --rec and none in eval (launches == 8 x steps), none without the mode;
    K1 launches == steps in every run.  Two steps from one re-loaded state
    under the mode are bit-equal (without it they part by ~9e-6: the
    atomics of torch's upsample backward).
    Every (shape, dtype) K2 met then goes through phase_k2."""
    import dataclasses

    from ramdsir_tpu_torch.config import TrainConfig
    from ramdsir_tpu_torch.data.device_pipeline import DeviceFundusPipeline, DeviceProstatePipeline
    from ramdsir_tpu_torch.ops import upsample
    from ramdsir_tpu_torch.train.checkpoint import read_checkpoint
    from ramdsir_tpu_torch.train.loop import deterministic_mode, fit
    from ramdsir_tpu_torch.train.steps import sample_step_draws

    shapes, runs = [], {}
    record = upsample.upsample2x_backward

    def recording(grad):
        key = (tuple(grad.shape[:2]) + (grad.shape[2] // 2, grad.shape[3] // 2), grad.dtype)
        if key not in shapes:
            shapes.append(key)
        return record(grad)

    for dataset, bf16 in (("fundus", False), ("fundus", True), ("prostate", False), ("prostate", True)):
        name = dataset + ("_bf16" if bf16 else "")
        root = os.path.join(OUT, "deterministic", name)
        if dataset == "fundus":
            cfg0 = dataclasses.replace(main_path_config(TrainConfig, "bf16" if bf16 else "default", root), device=DEVICE)
            make_pipe = lambda cfg: DeviceFundusPipeline.from_arrays(
                arrays, cfg.domain_idxs, cfg.batch_size_list, cfg.test_domain_idx, is_out_domain=True,
                seed=cfg.seed, precompute_donor_amp=cfg.ram_precompute_donor_amp, device=DEVICE)
            data = testset
        else:
            cfg0 = prostate_config(TrainConfig, root, prostate_root, bf16)
            make_pipe = lambda cfg: DeviceProstatePipeline.from_arrays(
                prostate, cfg.domain_idxs, cfg.batch_size_list, cfg.test_domain_idx, seed=cfg.seed, device=DEVICE)
            data = None
        out = {}
        for rep in DET_RUNS:
            cfg = dataclasses.replace(cfg0, save_path=os.path.join(root, rep), deterministic=rep.startswith("det"))
            shutil.rmtree(cfg.save_path, ignore_errors=True)
            ram_mix.launches, upsample.launches = 0, 0
            with mock.patch.object(upsample, "upsample2x_backward", recording):
                summary = fit(cfg, max_steps=DET_STEPS, pipeline=make_pipe(cfg), testset=data)
            sync(torch)
            rows = [json.loads(line) for line in open(os.path.join(cfg.save_path, "log", "metrics.jsonl"))]
            out[rep] = dict(summary=summary, k1=ram_mix.launches, k2=upsample.launches,
                            losses=[{k: v for k, v in r.items() if k.startswith("loss/")} for r in rows if "loss/loss" in r],
                            state=read_checkpoint(summary["resume_checkpoint"])["state"])
        a, b = out["deterministic"], out["deterministic_again"]
        state_equal = _same_tree(np, a["state"], b["state"])
        losses_equal = a["losses"] == b["losses"] and len(a["losses"]) == DET_STEPS
        med = {rep: out[rep]["summary"]["median_step_ms"] for rep in DET_RUNS}
        off = statistics.mean([med["default"], med["default_again"]])
        on = statistics.mean([med["deterministic"], med["deterministic_again"]])
        # two steps from one re-loaded state, under the mode
        src = a["summary"]["resume_checkpoint"]
        pipe = make_pipe(cfg0)
        row = next(iter(pipe))
        draws = sample_step_draws(torch.Generator().manual_seed(6), sum(cfg0.batch_size_list), torch.device(DEVICE),
                                  crop=dataset == "fundus")
        with deterministic_mode(True):
            cublas_config = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
            one = [step_from_seed(torch, ram_mix, cfg0, pipe, row, draws, load=src, device=DEVICE)[:2] for _ in range(2)]
        loss_rel, param_err, stat_err, _ = step_distance(torch, one[1], one[0])
        entry = dict(run=name, steps=DET_STEPS, state_tensors_bit_equal=state_equal, losses_bit_equal=losses_equal,
                     k1_launches={rep: out[rep]["k1"] for rep in DET_RUNS},
                     k2_launches={rep: out[rep]["k2"] for rep in DET_RUNS},
                     median_step_ms=med, mode_cost_ms=on - off, mode_cost_share=(on - off) / off,
                     reloaded_step_params_max_abs=param_err, reloaded_step_losses_max_rel=loss_rel,
                     reloaded_step_running_stats_max_abs=stat_err,
                     cublas_workspace_config_in_mode=cublas_config,
                     deterministic_after=torch.are_deterministic_algorithms_enabled())
        emit("deterministic", **entry)
        if not (state_equal and losses_equal):
            raise SystemExit(f"deterministic {name}: the two runs differ (state {state_equal}, losses {losses_equal})")
        if any(out[rep]["k1"] != DET_STEPS for rep in DET_RUNS):
            raise SystemExit(f"deterministic {name}: K1 launches {entry['k1_launches']}, expected {DET_STEPS} each")
        want_k2 = {rep: 8 * DET_STEPS if rep.startswith("det") else 0 for rep in DET_RUNS}
        if entry["k2_launches"] != want_k2:
            raise SystemExit(f"deterministic {name}: K2 launches {entry['k2_launches']}, expected {want_k2}")
        if param_err != 0.0 or loss_rel != 0.0 or stat_err != 0.0 or entry["deterministic_after"]:
            raise SystemExit(f"deterministic {name}: two steps from one re-loaded state differ: {entry}")
        runs[name] = entry
    return runs, shapes


# --- build -------------------------------------------------------------------


def timed_call(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def phase_build(ram_mix, upsample, native):
    """Build K1's and K2's libraries and the two host libraries and, beside
    them, ask ptxas for each kernel's registers and spills (four nvcc and two
    g++ processes, started together)."""
    t0 = time.perf_counter()
    sources = {"ram_mix": ram_mix.SOURCE, "upsample2x": upsample.SOURCE}
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(4) as pool:
        ptxas = {
            name: subprocess.Popen(
                [ram_mix._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                 "-Xptxas", "-v", "-cubin", "-o", os.path.join(tmp, f"{name}.cubin"), src],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for name, src in sources.items()
        }
        try:
            builds = {
                "k1": pool.submit(timed_call, ram_mix.build_library),
                "k2": pool.submit(timed_call, upsample.build_library),
                "host": pool.submit(timed_call, native.build_library),
                "png": pool.submit(timed_call, lambda: native.build_library(native.PNG_SOURCE)),
            }
            done = {k: f.result() for k, f in builds.items()}
            ram_mix._library()
            upsample._library()
            native.library()
            native.png_library()
        finally:
            ptxas_out = "".join(p.communicate(timeout=600)[0] for p in ptxas.values())
    # ptxas prints each kernel's name, then its spills, then its registers
    info, kernel = {}, None
    for ln in ptxas_out.splitlines():
        if "Compiling entry function" in ln:
            found = re.search(r"(mix_[a-z_]+?_kernel|upsample2x_backward_kernel)", ln)
            kernel = found.group(0) if found else ln.strip()
            if kernel.startswith("mix_"):
                kernel += "<full>" if "ILb1E" in ln else "<delta>" if "ILb0ELb1E" in ln else "<band>" if "ILb0ELb0E" in ln else ""
            else:
                kernel += "<bfloat16>" if "bfloat16" in ln else "<float32>"
        elif kernel and ("registers" in ln or "spill" in ln):
            info.setdefault(kernel, []).append(ln.split(":", 1)[-1].strip())
    emit("build", library=os.path.relpath(done["k1"][0], REPO), seconds=time.perf_counter() - t0,
         k1_seconds=done["k1"][1], k2_library=os.path.relpath(done["k2"][0], REPO), k2_seconds=done["k2"][1],
         nvcc_flags=list(ram_mix.NVCC_FLAGS), ptxas=info, host_library=os.path.relpath(done["host"][0], REPO),
         host_library_seconds=done["host"][1], png_library=os.path.relpath(done["png"][0], REPO),
         png_library_seconds=done["png"][1], host_flags=[native.CXX, *native.CXX_FLAGS])


def phase_cuda_tests():
    """The card tests (marker `cuda`, tests/test_torch_port_cuda.py) in a
    subprocess, after the build, so they reuse its libraries; every one must
    pass, none may skip."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "--noconftest", "-p", "no:cacheprovider", "tests/test_torch_port_cuda.py"],
        cwd=REPO, capture_output=True, text=True, timeout=900,
    )
    tail = proc.stdout.strip().splitlines()[-1] if proc.stdout.strip() else ""
    counts = {k: int(n) for n, k in re.findall(r"(\d+) (passed|failed|skipped|error|errors)", tail)}
    emit("cuda_tests", command="python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py",
         rc=proc.returncode, summary=tail, seconds=time.perf_counter() - t0)
    if proc.returncode != 0 or not counts.get("passed") or set(counts) != {"passed"}:
        print(proc.stdout[-6000:], proc.stderr[-3000:], file=sys.stderr)
        raise SystemExit(f"cuda_tests: {tail or 'no summary'} (rc {proc.returncode})")
    return counts["passed"]


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the card", file=sys.stderr)
        return 1
    if not all(os.path.isfile(os.path.join(REPO, rel)) for rel in (SOURCE_REL, SOURCE_K2, "tests/test_torch_port_cuda.py")):
        print("chip_smoke: run it from a checkout of the repository (ramdsir_tpu_torch/ is missing)", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from ramdsir_tpu_torch.train.loop import tf32_settings

    shutil.rmtree(OUT, ignore_errors=True)
    os.makedirs(OUT)
    card = nvidia_smi_line()
    name = torch.cuda.get_device_name(0)
    bw = peak_bandwidth(name)
    emit("device", nvidia_smi=card, name=name, count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, peak_bytes_per_s=bw, tf32=tf32_settings())

    try:
        return run_phases(torch, card, name, bw)
    finally:
        # the checkpoints are ~10-30 MB each, the volumes ~19 MB, the 800^2
        # PNG tree ~330 MB and its overlays ~2 MB each: keep the logs, drop
        # the weights and the data
        for root, _, files in os.walk(OUT):
            for f in files:
                if f.endswith((".pth", ".ckpt", ".nii.gz", ".png")):
                    os.remove(os.path.join(root, f))


def run_phases(torch, card, name, bw):
    import numpy as np

    from ramdsir_tpu_torch import native
    from ramdsir_tpu_torch.config import PROSTATE_DOMAINS, PROSTATE_VOLUME_DOMAINS
    from ramdsir_tpu_torch.data.synthetic import (
        fundus_arrays,
        fundus_test_samples,
        make_prostate_volumes,
        prostate_arrays,
        prostate_volumes,
    )
    from ramdsir_tpu_torch.ops import ram as tram
    from ramdsir_tpu_torch.ops import ram_mix, upsample

    phase_build(ram_mix, upsample, native)
    phase_cuda_tests()
    kernels = phase_kernel(torch, tram, ram_mix, bw)
    phase_ram_oracle(torch, tram, np)

    t0 = time.perf_counter()
    arrays = fundus_arrays(per_domain_train=64, size=S, seed=0)  # 4 domains x 64 images, as bench.py:68
    testset = fundus_test_samples(num=EVAL_N, size=EVAL_SIZE, image_size=S, seed=1)
    emit("data", domains=len(arrays), per_domain=64, size=S, test_images=EVAL_N, test_original_size=EVAL_SIZE,
         seconds=time.perf_counter() - t0)
    runs = phase_main_path(torch, np, ram_mix, arrays, testset)
    phase_eval_cli(torch, np, testset)

    t0 = time.perf_counter()
    # 5 source domains x 40 slices at 384^2, as bench.py:74 (354 MB of float32)
    prostate = prostate_arrays(per_domain=PROSTATE_SLICES, size=PS, seed=0, domains=PROSTATE_DOMAINS[:5])
    data_root = os.path.join(PROSTATE_OUT, "data")
    shutil.rmtree(data_root, ignore_errors=True)
    make_prostate_volumes(data_root, per_domain=PROSTATE_VOLUMES, depth=PROSTATE_DEPTH, size=PS, seed=1,
                          domains=[PROSTATE_VOLUME_DOMAINS[5]])
    emit("prostate_data", domains=len(prostate), per_domain=PROSTATE_SLICES, size=PS,
         volumes=PROSTATE_VOLUMES, depth=PROSTATE_DEPTH, seconds=time.perf_counter() - t0)
    prostate_run = phase_prostate_path(torch, np, ram_mix, prostate, data_root)
    phase_prostate_path(torch, np, ram_mix, prostate, data_root, bf16_beside=prostate_run)
    phase_prostate_eval_cli(torch, np, data_root)
    phase_png_tree(torch, np, ram_mix)
    det_runs, k2_shapes = phase_deterministic(torch, np, ram_mix, arrays, testset, prostate, data_root)
    k2 = phase_k2(torch, bw, k2_shapes)

    phase_profile(torch, ram_mix, arrays, prostate)
    phase_step_parity(torch, np, ram_mix, arrays)
    phase_bf16_step_parity(torch, np, ram_mix, arrays)
    phase_eval_parity(torch, np, testset)
    phase_resume(torch, np, ram_mix, arrays, testset, runs["default"]["steps"])
    phase_prostate_step_parity(torch, np, ram_mix, prostate)
    volume = prostate_volumes(per_domain=1, depth=PROSTATE_DEPTH, size=PS, seed=1, domains=["HK"])["HK"][0]
    phase_prostate_eval_parity(torch, np, volume)

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
    k = kernels[f"delta@{PS}x{PS}"]
    line["kernels"].append({
        "name": f"ram_mix[band,delta]@prostate {PB}x{C}x{PS}x{PS}", "route": "cuda", "source": SOURCE_REL,
        "replaces": REPLACES, "launches": prostate_run["k1_launches"], "max_abs_err": k["max_abs_err"], "ms": k["ms"],
        "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"], "bound_by": k["bound_by"], "library_ms": None,
        "floor_ms": k["floor_ms"], "kernel_ms": k["kernel_ms"], "ms_clean_flush": k["ms_clean_flush"],
        "floor_ms_clean_flush": k["floor_ms_clean_flush"], "path": k["path"],
    })
    # K2: the sum over the 8 launches of one deterministic step (each shape
    # once a step), for each run, and the largest shape alone
    for run, det in det_runs.items():
        dtype = "bfloat16" if run.endswith("bf16") else "float32"
        step_cases = [k2[f"{'x'.join(map(str, shape))}:{dtype}"] for shape, dt in k2_shapes
                      if str(dt).endswith(dtype) and (shape[0] in (B, 2 * B)) == run.startswith("fundus")]
        if len(step_cases) != 8:
            raise SystemExit(f"K2: {len(step_cases)} shapes in a {run} step, expected 8")
        total = lambda key: sum(c[key] for c in step_cases)
        line["kernels"].append({
            "name": f"upsample2x_backward[{run} step: 8 shapes]", "route": "cuda", "source": SOURCE_K2,
            "replaces": REPLACES_K2, "launches": det["k2_launches"]["deterministic"],
            "max_abs_err": max(c["max_abs_err"] for c in step_cases), "ms": total("ms"), "plain_ms": total("plain_ms"),
            "bound_ms": total("bound_ms"), "bound_by": "bytes", "library_ms": total("library_ms"),
            "kernel_ms": total("kernel_ms"), "shapes": [c["shape"] for c in step_cases],
        })
    big = k2[f"{2 * B}x32x{S // 2}x{S // 2}:float32"]
    line["kernels"].append({
        "name": f"upsample2x_backward[{2 * B}x32x{S // 2}x{S // 2} float32]", "route": "cuda", "source": SOURCE_K2,
        "replaces": REPLACES_K2, "launches": det_runs["fundus"]["k2_launches"]["deterministic"] // 8,
        **{k: big[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "kernel_ms")},
    })
    print(card, flush=True)
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
