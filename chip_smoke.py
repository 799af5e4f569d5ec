#!/usr/bin/env python3
"""Smoke run of ramdsir_tpu_torch on one NVIDIA GPU: `python3 chip_smoke.py`.

Phases, one JSON line each (any failure raises and exits non-zero, with no
result line):
  device      the card, its power limit, the TF32 settings
  build       K1 (csrc/ram_mix.cu), K2 and K3 (csrc/upsample2x.cu) and the
              batch norm (csrc/batch_norm.cu) compiled with nvcc for
              sm_90a, the host post-processing library (native/postproc.cpp)
              and the PNG unfilter (native/png.cpp) with g++, all started
              together, beside ptxas's registers
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
  batch_norm  the grouped batch norm's kernels (csrc/batch_norm.cu) at every
              norm shape of a fundus and a prostate step
              (tools/batch_norm_study.py): forward and backward against the
              plain version in float64 (within BN_TOL) and two runs bit-equal;
              each shape's device ms (torch.profiler: forward, backward, by
              kernel), cuDNN's per-group F.batch_norm + torch.cat forward and
              backward (`library_ms`), the plain version's, and the bound (5
              float32 passes); `batch_norm_summary` sums a step's 38 norms
  ram_oracle  the RAM functions on the card against a float64 numpy oracle
  main_path   the fundus trainer (`train.loop.fit`, its default scan windows:
              CUDA-graph replays; the window, replays, capture seconds and
              graph pool reported) at 256^2, U-Net n=16,
              batch 16 = 3+6+7 over domains 1,2,3, on an in-memory synthetic
              set: the defaults (banded-DFT RAM, K1 band-delta mode),
              ram_use_pallas (K1 full mode) and no_ram_banded_dft (K1 band
              mode); K1's launches are counted by the kernel itself on the
              card (graph replays included), read around each run, and must
              equal its step count, all through the mode's own code path.  Each
              run evaluates at each epoch's end and at its last step, on an
              in-memory test split of target domain 0 (50 images at 512^2,
              test batch 8: six batches and a tail of 2); the last eval's
              seconds, forward ms per batch (CUDA-synchronised), readback
              ms, host ms per image, Dice, the best file (which must load
              strictly) and the CSV rows; eval adds no K1 launch; the batch
              norm's four kernels each run 38 times a float32 step (none in
              bfloat16 or in eval), and K2 and K3 8 times a step each (the
              train step's NCHW activations) and never in eval (its
              channels-last activations take aten's NHWC kernel), all
              counted on the card, eval's apart
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
              (torch.profiler over 5 single steps each, a synchronise a step)
  scan        scan windows (--scan_window): `fit` with the default window, a
              CUDA graph of one step replayed after two eager steps, against
              --scan_window 1, fundus and prostate under --deterministic over
              two segments with an eval between: state and logged rows
              bit-equal, K1 once a step and K2 / K3 8 a step both ways
              (counted through the replays); then fundus and prostate,
              float32 and bfloat16, in turns a step a launch and graphs:
              median step, img/s, device busy and idle share, host launch
              calls a step, peak memory, capture seconds and graph pool
              bytes; a graph window and its ring append under the sync debug
              mode "error"; graph-vs-eager and eager-vs-eager loss distances
              without --deterministic
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
              eval; K2 and K3 8 a step each, none in eval (as main_path); the
              7 losses finite every step; 2 CSV rows; Dice in
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
              the weights of the prostate float32 run under --deterministic
              (phase deterministic; one set a software stack) and one volume
              on the card and on the CPU, both BN modes: probabilities within
              1e-4 (and by class), labels differing at most at 1e-4 of the
              voxels, Dice within 1e-3; the prostate run's own weights the
              same way, reported only; the host library's largest component
              and 3-D surface distances bit-equal to scipy on the card's
              predictions
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
              and K3 launch 8 a training step each in every run, mode or
              not; in eval K2 never, K3 4 an eval batch under the mode
              (eval's channels-last activations made contiguous), none
              without it (aten's NHWC kernel); two
              steps from one re-loaded state bit-equal; the mode's cost in
              median step time
  k2          K2 against its plain version (bit-equal) and torch's atomics
              backward at every shape and dtype of those steps, with `ms`,
              `kernel_ms`, plain and library times and the bytes bound; K3
              (lines `k3`) the same against aten's forward
  variants    the single-card training variants at the reference widths,
              each a `fit` of 8 steps (13 for the trace) with its eval, K1
              held to its plain version at every call and launched once a
              step: prostate --num_classes 3 (the volume eval at C = 3),
              fundus --norm gn and --norm in (each with a step on the card
              against the same step on the CPU, TF32 off, within
              step_parity's bounds; the softmax head too), --norm gn in
              bfloat16 (the activations after the first GroupNorm are
              float32, as in JAX), fused_dual=False + fused_dsbn=False (a
              step against the fused one from the same state), --remat for
              fundus and prostate (without and with in turns, then both
              under --deterministic: bit-equal; median step and peak memory
              each way), --global_batch 48 (LR x 3; img/s beside the
              default run's) and --trace_dir (windows of 4: a Chrome trace
              of steps 4-12, graph replays included, that names K1's kernel
              and holds a `ramdsir.train.replay` span a replay)
  host_loader training from the host loaders (device_data=False): fundus
              at the reference configuration from png_tree's 800^2 tree, two
              epochs each under the process and the thread loader (median
              step, img/s, the host's wait for the loader and the copies'
              device time a step, peak memory, for the cold and the warm
              epoch, beside the device pipeline's median step on the same
              tree), and prostate at 384^2 (process) from prostate_path's
              slices written as the .npy tree; image grids every 5 steps,
              each PNG read back equal; K1 (full mode) once a step and
              bit-equal in the warm-up steps; the two loader kinds' first
              batches equal for one seed; a card step on a host batch
              against the CPU step (TF32 off) within step_parity's bounds
  ddp         data-parallel training (`--num_devices` > 1) on the one card,
              each world a `parallel.distributed.launch` of spawned ranks:
              fundus at the reference configuration over 1 NCCL rank, over 2
              gloo ranks sharing cuda:0 (rows 8 + 8, domain 1 on both),
              then twice more under --deterministic, and prostate over 3
              gloo ranks (batch 10 padded to 12: 4 + 4 + 2 real rows).  Each
              launch's step 0 against the single-process step from the same
              state and draws (TF32 off) within step_parity's bounds; each
              run a `fit` of 10 steps (prostate 4) with one eval on rank 0,
              K1 once a step on every rank and bit-equal in the warm-up
              steps, the replicas bit-equal at the end (all-reduces MAX and
              MIN of every parameter and buffer), the two deterministic runs
              bit-equal; the median step, global img/s, each rank's peak
              memory, the gradient all-reduce (CUDA events) and all
              all-reduces' host time a step.  Ranks sharing one card: no
              figure is a multi-GPU speed
  host_library
              the reference's transform library (data/transforms.py), on
              this machine's host without PIL: 16 of png_tree's 800^2 pairs
              through the training chain (Resize, RandomScaleCrop to 256^2),
              the test chain (Resize, Normalize) and every other transform
              and painting function once, each pair on its own Generator
              from one seed; mean ms an image per transform (host clock); a
              second run from the seed (8 threads) equal array for array
  zoo         the model zoo (models/unet.py) at n=16, batch 16 at 256^2:
              Unet2D, Unet2DMT (both heads), Unet2DDS (deep_sup), Unet2DMS
              (multi_scale_output), Discriminator; one train-mode forward
              with TF32 off against the CPU's (running statistics within
              rtol 1e-4 / atol 1e-5) and the float64 forward (within 1e-5
              of the largest output, or twice the CPU float32 forward's
              distance where that is larger); the median of 10
              forward+backward passes at the default settings, peak memory,
              count_params
Then the card line from nvidia-smi, the kernels line (K1 per mode and at
the prostate shape, the variant and ddp runs' launches (per rank) added to
the band-delta entries by run and the host-loader runs' to the full entry;
K2 and K3 each summed over a step's 8 shapes, with the launches in
training and in eval of the main_path and prostate_path runs, float32
and bfloat16, and at the largest shape), and the result line.  Every run's
launches are the kernels' own counts on the card (`read_launches`): each
kernel adds one to a device counter as it runs, so a graph replay counts
and a launch recorded into a graph that never runs does not.
Run artefacts go to chiprun_out/chip_smoke/ (prostate: chip_smoke/prostate/);
the .pth and .ckpt files, the NIfTI volumes, the PNGs and the .npy slices are
deleted at exit.
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

# the byte counts behind K1's and K2's bounds, and the union of device
# intervals, are the benchmark's own (port_bench/lib)
from port_bench.lib.counts import k1_min_bytes, k2_bytes
from port_bench.lib.trace import union_length

T0 = time.perf_counter()  # the script's start: each phase line carries its elapsed seconds
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
HOST_OUT = os.path.join(OUT, "host_loader")
HOST_EPOCHS, HOST_LOG_IMAGES, HOST_COMPARED_BATCHES = 2, 5, 4  # fundus: 10 steps an epoch
DET_STEPS = 8  # steps of each --deterministic run
NORMS_PER_STEP = 38  # a step's train-mode norms at n=16: 26 dual BatchNorms, 12 segment DSBNs
BN_TOL = 5e-6  # the batch norm's kernels against float64, as tests/test_torch_port_cuda.py's BN_TOL
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


def zero_launches():
    """Every kernel's launch count on the card to 0 before a run."""
    from ramdsir_tpu_torch.ops import cuda_build

    cuda_build.zero_launch_counts()


def read_launches():
    """The launches since `zero_launches` as the kernels counted them on the
    card while they ran, CUDA graph replays included: K1 (`k1`, and
    `k1_paths`, the paths with any), K2 (`k2`), K3 (`k3`) and the batch
    norm's four kernels (`bn`, by kernel)."""
    from ramdsir_tpu_torch.ops import cuda_build

    counts = cuda_build.launch_counts()
    of = lambda lib: {k.split(".", 1)[1]: n for k, n in counts.items() if k.startswith(lib + ".")}
    paths, up = of("ram_mix"), of("upsample2x")
    return dict(k1=sum(paths.values()), k1_paths={p: k for p, k in paths.items() if k}, k2=up["backward"],
                k3=up["forward"], bn=of("batch_norm"))


@contextlib.contextmanager
def eval_launches():
    """While it lasts, `fit`'s in-training evals count K2's and K3's device
    launches apart from the steps': yields a dict whose `k2` and `k3` are
    the launches inside the evals so far and whose `in_eval` is true while
    one runs."""
    from ramdsir_tpu_torch.train import loop

    evaluate, seen = loop.evaluate_target, dict(k2=0, k3=0, in_eval=False)

    def counting(*args, **kwargs):
        before, seen["in_eval"] = read_launches(), True
        try:
            return evaluate(*args, **kwargs)
        finally:
            after = read_launches()
            seen["k2"] += after["k2"] - before["k2"]
            seen["k3"] += after["k3"] - before["k3"]
            seen["in_eval"] = False

    with mock.patch.object(loop, "evaluate_target", counting):
        yield seen


def upsample_fields(counts, eval_counts):
    """K2's and K3's launches of a run (`read_launches`' counts, `eval_counts`
    from `eval_launches`): in the steps and in the evals."""
    return dict(k2_launches=counts["k2"] - eval_counts["k2"], k3_launches=counts["k3"] - eval_counts["k3"],
                k2_eval_launches=eval_counts["k2"], k3_eval_launches=eval_counts["k3"])


def check_upsample(phase, entry, steps):
    """K2 and K3 run 8 times a training step each on the card (the train
    step's activations are NCHW-contiguous) and never in eval (channels-last:
    aten's NHWC kernel)."""
    got = {k: entry[k] for k in ("k2_launches", "k3_launches", "k2_eval_launches", "k3_eval_launches")}
    want = dict(k2_launches=8 * steps, k3_launches=8 * steps, k2_eval_launches=0, k3_eval_launches=0)
    if got != want:
        raise SystemExit(f"{phase}: upsample launches {got}, expected {want}")


def emit(phase, **kw):
    """A phase's JSON line, on stdout and appended to OUT/phases.jsonl (the
    end of stdout is all that may come back from a long run)."""
    line = json.dumps({"phase": phase, **kw, "elapsed_s": time.perf_counter() - T0})
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
        zero_launches()
        got, before = run_mix(ram_mix.mix_spectrum, case)
        path = list(read_launches()["k1_paths"])
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
            ms = cuda_time_ms(lambda: timed(ram_mix.mix_spectrum), flush=flush)
            kernel_ms = kernel_time_ms(lambda: timed(ram_mix.mix_spectrum), "mix_", flush=flush)
            ms_clean_flush = cuda_time_ms(lambda: timed(ram_mix.mix_spectrum), flush=clean_flush)
            plain_ms = cuda_time_ms(lambda: timed(ram_mix.mix_spectrum_plain), flush=flush)
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


def main_path_config(TrainConfig, name, run_dir, **variant):
    extra = {"ram_use_pallas": {"ram_use_pallas": True}, "no_ram_banded_dft": {"ram_banded_dft": False}, "bf16": BF16}
    return TrainConfig(
        dataset="fundus", domain_idxs=(1, 2, 3), test_domain_idx=0, ram=True, rec=True,
        is_out_domain=True, consistency=True, consistency_type="kd", image_size=S,
        save_path=run_dir, device="cuda", **extra.get(name, {}), **variant,
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
        zero_launches()
        t0 = time.perf_counter()
        with eval_launches() as eval_counts:
            summary = fit(cfg, max_steps=steps, pipeline=pipe, testset=testset)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_launches()
        launches, paths = counts["k1"], counts["k1_paths"]
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
            run=name, steps=summary["steps"], k1_launches=launches, k1_paths=paths,
            bn_launches=counts["bn"], **upsample_fields(counts, eval_counts), losses_finite=finite,
            first_loss=rows[0]["loss/loss"], last_loss=[r for r in rows if "loss/loss" in r][-1]["loss/loss"],
            median_step_ms=summary["median_step_ms"], images_per_sec=summary["images_per_sec"],
            peak_memory_bytes=peak, wall_s=wall, batch=sum(cfg.batch_size_list), image_size=S,
            tf32=tf32_settings(), cup_dice=summary["cup_dice"], disc_dice=summary["disc_dice"],
            best=summary["best"], best_file=os.path.basename(summary["best_checkpoint"]),
            csv_rows=len(csv_rows), evals=len(evals), eval_images=len(testset), eval_original_size=EVAL_SIZE,
            test_batch=cfg.test_batch_size, **eval_fields(summary["eval_timing"], len(testset)),
            compute_dtype=cfg.compute_dtype, predict_dtype=cfg.predict_dtype,
            **{k: summary[k] for k in ("scan_window", "graph_replays", "capture_s", "graph_pool_bytes")},
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
        bn_expected = NORMS_PER_STEP * steps if cfg.compute_dtype == "float32" else 0
        if counts["bn"] != {k: bn_expected for k in counts["bn"]}:
            raise SystemExit(f"main path {name}: batch norm kernels ran {counts['bn']}, expected {bn_expected} each")
        check_upsample(f"main path {name}", entry, steps)
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
    before = read_launches()["k1"]
    with mock.patch.object(ram_mix, "mix_spectrum", ram_mix.mix_spectrum_plain) if plain else contextlib.nullcontext():
        m = step(state, row, draws=draws)
    sd = {f"{n}.{k}": v.detach().clone() for n, mod in state.models.items() for k, v in mod.state_dict().items()}
    return {k: float(v) for k, v in m.items()}, sd, read_launches()["k1"] - before


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
    two steps from the same loaded state come (some of torch's backward
    kernels add with atomics, so two steps from one state may part by a
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

    zero_launches()
    summary = fit(dataclasses.replace(cfg, checkpoint_resume=src), max_steps=steps_done + RESUME_STEPS,
                  pipeline=pipe, testset=testset)
    counts = read_launches()
    launches, paths = counts["k1"], counts["k1_paths"]
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


def prostate_config(TrainConfig, run_dir, data_root, bf16=False, **variant):
    """The reference prostate configuration (bench.py:72-74, :193-210)."""
    return TrainConfig(
        dataset="prostate", domain_idxs=(0, 1, 2, 3, 4), test_domain_idx=5, ram=True, rec=True,
        consistency=True, consistency_type="kd", image_size=PS, save_path=run_dir, data_root=data_root,
        device=DEVICE, **(BF16 if bf16 else {}), **variant,
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
    zero_launches()
    t0 = time.perf_counter()
    with eval_launches() as eval_counts:
        summary = fit(cfg, max_steps=steps, pipeline=pipe)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_launches()
    launches, paths = counts["k1"], counts["k1_paths"]
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
        bn_launches=counts["bn"], **upsample_fields(counts, eval_counts), losses_finite=finite,
        compute_dtype=cfg.compute_dtype,
        predict_dtype=cfg.predict_dtype,
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
    bn_expected = 0 if bf16 else NORMS_PER_STEP * steps
    if counts["bn"] != {k: bn_expected for k in counts["bn"]}:
        raise SystemExit(f"{phase}: batch norm kernels ran {counts['bn']}, expected {bn_expected} each")
    check_upsample(phase, entry, steps)
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


def prostate_eval_parity_on(torch, np, path, volume):
    """The weights at `path` and one volume on the card and on the CPU (TF32
    off, deterministic cuDNN) in both BN modes, through
    eval_prostate_volumes: each mode's numbers and the card's labels."""
    from ramdsir_tpu_torch.config import TrainConfig
    from ramdsir_tpu_torch.ops import postprocess
    from ramdsir_tpu_torch.train import evaluate
    from ramdsir_tpu_torch.train.checkpoint import load_torch_checkpoint
    from ramdsir_tpu_torch.train.state import build_models
    from ramdsir_tpu_torch.train.steps import make_predict_fn

    entry, card_labels = dict(weights=os.path.relpath(path, REPO)), None
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
        diff = (pc - pp).abs()  # (batches, batch, class, H, W)
        worst = diff.amax(dim=(0, 1, 3, 4))
        entry["bn_adapt" if bn_adapt else "running_stats"] = dict(
            prob_max_abs=float(diff.max()), prob_max_abs_by_class=worst.tolist(),
            label_share_differing=float(np.mean(lc != lp)), dice_abs=abs(dc - dp), dice=dc, batches=len(pc),
            foreground_voxels=int(lc.sum()))
        card_labels = lc
    return entry, card_labels


def phase_prostate_eval_parity(torch, np, volume):
    """Card against CPU eval of one volume, held on the weights of the
    prostate float32 run under --deterministic (phase deterministic), which
    are one set a software stack: probabilities within 1e-4, labels
    differing at most at 1e-4 of the voxels, Dice within 1e-3, both BN
    modes.  The prostate run's own weights (non-repeatable training) go
    through the same comparison, reported only.  Then the host library's
    largest component and 3-D surface distances against scipy on the
    card's labels."""
    from ramdsir_tpu_torch.ops import metrics, postprocess

    with exact_float32(torch):
        entry, card_labels = prostate_eval_parity_on(
            torch, np, os.path.join(OUT, "deterministic", "prostate", "deterministic", "final_model.pth"), volume)
        reported, _ = prostate_eval_parity_on(torch, np, os.path.join(PROSTATE_OUT, "run", "final_model.pth"), volume)
    entry.update(volume=volume[0], depth=volume[1].shape[0], batch=PROSTATE_TEST_BATCH, prob_tol=1e-4,
                 label_share_tol=1e-4, dice_tol=1e-3, prostate_run_weights_reported_only=reported)
    for tag in ("running_stats", "bn_adapt"):
        e = entry[tag]
        if e["prob_max_abs"] > 1e-4 or e["label_share_differing"] > 1e-4 or e["dice_abs"] > 1e-3:
            emit("prostate_eval_parity", **entry)
            raise SystemExit(f"prostate_eval_parity {tag}: {e}")
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
    ("K3 upsample2x_forward", ("upsample2x_forward_kernel",)),
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
    deterministic_mode (K3 and K2 for the upsample): torch.profiler over
    `steps` single steps after `warmup`, each step's losses read back (a
    synchronise a step, as `fit` did before its scan windows; phase scan
    times the windows)."""
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

    # the device's kernels and copies; a record_function range (such as
    # "Optimizer.step#Adam.step") is also a CUDA event, spanning its kernels
    # and the gaps between them, so it is not busy time
    kernels = [e for e in prof.events()
               if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]
    per_name, per_group = {}, {}
    for e in kernels:
        us = e.time_range.elapsed_us()
        per_name[e.name] = per_name.get(e.name, 0.0) + us
        group = next((g for g, keys in KERNEL_GROUPS if any(k in e.name for k in keys)), "elementwise/other")
        per_group[group] = per_group.get(group, 0.0) + us
    # busy: the union of the intervals, so that work on two streams at once counts once
    busy_us = union_length((e.time_range.start, e.time_range.end) for e in kernels)
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
    zero_launches()
    t0 = time.perf_counter()
    summary = train_main(["--data_root", data_root, "--dataset", "fundus", "--domain_idxs", "1,2,3",
                          "--test_domain_idx", "0", "--ram", "--rec", "--consistency", "--consistency_type", "kd",
                          "--is_out_domain", "--image_size", str(S), "--epochs", "1", "--save_path", run_dir,
                          "--device", DEVICE])
    sync(torch)
    train_s = time.perf_counter() - t0
    k1 = read_launches()["k1"]
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
        images_per_sec=summary["images_per_sec"],
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
    return entry


# --- the host loaders ---------------------------------------------------------------


def host_fit(torch, np, ram_mix, name, cfg, steps=None):
    """`fit` on the host loaders (cfg.device_data=False) with K1 held to its
    plain version in the untimed warm-up steps and every PNG the run writes
    recorded: the run's entry, with the epochs' "input/" rows (median step,
    img/s, the host's wait for the loader, the copies' device time, the
    memory high-water marks).  Losses finite every step, K1 launches ==
    steps on full_vec, bit-equal; one PNG per tag at each logged step, each
    read back equal."""
    from ramdsir_tpu_torch.data import png
    from ramdsir_tpu_torch.train.loop import fit
    from ramdsir_tpu_torch.utils.profiler import StepTimer

    shutil.rmtree(cfg.save_path, ignore_errors=True)
    sync(torch)
    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()
    zero_launches()
    errs, written, write = [], {}, png.write

    def recording_write(path, array, **kw):
        written[path] = np.array(array)
        return write(path, array, **kw)

    checked = StepTimer().warmup
    t0 = time.perf_counter()
    with k1_held_to_plain(torch, ram_mix, errs, checked), mock.patch.object(png, "write", recording_write):
        summary = fit(cfg, max_steps=steps)
    sync(torch)
    wall = time.perf_counter() - t0
    rows = [json.loads(line) for line in open(os.path.join(cfg.save_path, "log", "metrics.jsonl"))]
    losses = [{k: v for k, v in r.items() if k.startswith("loss/")} for r in rows if "loss/loss" in r]
    finite = len(losses) == summary["steps"] and all(np.all(np.isfinite(list(r.values()))) for r in losses)
    epochs = [{k.split("/", 1)[1]: v for k, v in r.items() if k.startswith("input/")} for r in rows if "input/epoch" in r]
    logged = [s for s in range(summary["steps"]) if s % cfg.log_images_every == 0]
    tags = 7 if cfg.dataset == "fundus" else 5
    grid_paths = [p for p in written if os.sep + "images" + os.sep in p]
    round_trip = sum(np.array_equal(png.decode(p).array, written[p]) for p in grid_paths)
    evals = [r["eval/avg_dice"] for r in rows if "eval/avg_dice" in r]
    counts = read_launches()
    paths = counts["k1_paths"]
    entry = dict(
        run=name, loader=cfg.loader, dataset=cfg.dataset, steps=summary["steps"], epochs_run=len(epochs),
        batch=sum(cfg.batch_size_list), image_size=cfg.image_size, k1_launches=counts["k1"], k1_paths=paths,
        k1_max_abs_err=max(float(e) for e in errs) if errs else None, k1_checked_steps=checked,
        losses_finite=finite, first_loss=losses[0]["loss/loss"], last_loss=losses[-1]["loss/loss"],
        median_step_ms=summary["median_step_ms"], images_per_sec=summary["images_per_sec"],
        peak_memory_bytes=torch.cuda.max_memory_allocated() if DEVICE == "cuda" else "not measured", wall_s=wall,
        host_input=summary["host_input"],
        epochs=epochs, grids=dict(logged_steps=logged, tags=tags, pngs=len(grid_paths), round_trip=round_trip),
        evals=len(evals), last_eval_avg_dice=evals[-1] if evals else None,
    )
    bad = (not finite or entry["k1_launches"] != summary["steps"] or paths != {"full_vec": summary["steps"]}
           or entry["k1_max_abs_err"] != 0.0 or len(grid_paths) != tags * len(logged) or round_trip != len(grid_paths))
    if bad:
        emit("host_loader", **entry)
        raise SystemExit(f"host_loader {name}: {summary['steps']} steps, K1 {entry['k1_launches']} on {paths} "
                         f"(max err {entry['k1_max_abs_err']}), losses finite {finite}, "
                         f"{len(grid_paths)} grids for {len(logged)} logged steps, {round_trip} read back equal")
    return entry


def phase_host_loader(torch, np, ram_mix, png_run, prostate, prostate_root):
    """Training from the host loaders (device_data=False), the reference's
    input path: fundus at the reference configuration from the 800^2 PNG
    tree of phase png_tree, HOST_EPOCHS epochs under loader="process" and
    again under "thread" (the first epoch decodes, the second reads the
    decode cache), beside the device pipeline's median step on the same
    tree (png_tree's run); prostate at 384^2 under "process" from phase
    prostate_path's slices, written as the .npy tree.  Image grids every
    HOST_LOG_IMAGES steps.  Checks: finite losses, K1 (full_vec) once a step
    and bit-equal in the warm-up steps, every grid read back equal, the two
    loader kinds' first batches equal for one seed, and one card step on a
    host batch against the CPU step on the same batch (TF32 off) within
    step_parity's bounds."""
    import dataclasses
    import types

    from ramdsir_tpu_torch.config import TrainConfig
    from ramdsir_tpu_torch.train.loop import build_train_pipeline

    t_phase = time.perf_counter()
    data_root = os.path.join(PNG_OUT, "data")
    fundus_cfg = lambda loader: TrainConfig(
        data_root=data_root, dataset="fundus", domain_idxs=(1, 2, 3), test_domain_idx=0, ram=True, rec=True,
        consistency=True, consistency_type="kd", is_out_domain=True, image_size=S, epochs=HOST_EPOCHS,
        save_path=os.path.join(HOST_OUT, f"fundus_{loader}"), device=DEVICE, device_data=False, loader=loader,
        log_images_every=HOST_LOG_IMAGES,
    ).resolve()
    runs = {}
    for loader in ("process", "thread"):
        runs[f"fundus_{loader}"] = host_fit(torch, np, ram_mix, f"fundus_{loader}", fundus_cfg(loader))
    for entry in runs.values():
        entry["device_pipeline"] = {k: png_run[k] for k in ("median_step_ms", "images_per_sec")}
        emit("host_loader", **entry)

    # the thread and the process loader build the same batches for one seed
    t0 = time.perf_counter()
    firsts = {}
    for loader in ("process", "thread"):
        pipe = build_train_pipeline(fundus_cfg(loader), os.path.join(data_root, "fundus"))
        try:
            it = iter(pipe)
            firsts[loader] = [next(it) for _ in range(HOST_COMPARED_BATCHES)]
        finally:
            getattr(pipe, "shutdown", lambda: None)()
    same = all(np.array_equal(a[k], b[k]) for a, b in zip(firsts["process"], firsts["thread"]) for k in a)
    batch_check_s = time.perf_counter() - t0

    # one step on a host batch, card against CPU
    cfg = fundus_cfg("process")
    batch = firsts["process"][0]
    draws = {"ratio": torch.randint(1, 11, (sum(cfg.batch_size_list),), generator=torch.Generator().manual_seed(5))
             .float() / 10.0}
    host = types.SimpleNamespace(device_data=None)
    with exact_float32(torch):
        card = step_from_seed(torch, ram_mix, cfg, host, {k: torch.from_numpy(v).to(DEVICE) for k, v in batch.items()},
                              {k: v.to(DEVICE) for k, v in draws.items()}, device=DEVICE)
        t0 = time.perf_counter()
        cpu = step_from_seed(torch, ram_mix, dataclasses.replace(cfg, device="cpu"), host,
                             {k: torch.from_numpy(v) for k, v in batch.items()}, draws, device="cpu")
        cpu_s = time.perf_counter() - t0
    loss_rel, param_err, stat_err, stats_ok = step_distance(
        torch, (card[0], {k: v.cpu() for k, v in card[1].items()}), cpu[:2])
    parity = dict(loss_max_rel=loss_rel, loss_tol=1e-5, params_max_abs=param_err, params_tol=2.5 * cfg.lr,
                  running_stats_max_abs=stat_err, stats_tol="rtol 1e-4, atol 1e-5", k1_launches=card[2],
                  cpu_step_s=cpu_s, batch_dtypes={k: str(v.dtype) for k, v in batch.items()},
                  card_losses=card[0], cpu_losses=cpu[0], cpu_threads=torch.get_num_threads(),
                  batch_sums={k: int(v.astype(np.int64).sum()) for k, v in batch.items()})
    parity_ok = loss_rel <= 1e-5 and param_err <= 2.5 * cfg.lr and stats_ok and card[2] == 1

    # prostate: phase prostate_path's slices as the .npy tree, then fit
    base = os.path.join(prostate_root, "prostate")
    t0 = time.perf_counter()
    for dom, arr in prostate.items():
        for kind, key in (("image", "images"), ("mask", "masks")):
            os.makedirs(os.path.join(base, dom, kind), exist_ok=True)
            for i, a in enumerate(arr[key]):
                np.save(os.path.join(base, dom, kind, f"{dom}_{i:03d}.npy"), a)
    write_s = time.perf_counter() - t0
    try:
        cfg = prostate_config(TrainConfig, os.path.join(HOST_OUT, "prostate_process"), prostate_root,
                              device_data=False, loader="process", log_images_every=HOST_LOG_IMAGES)
        runs["prostate_process"] = host_fit(torch, np, ram_mix, "prostate_process", cfg, steps=PROSTATE_STEPS)
    finally:
        for dom in prostate:
            shutil.rmtree(os.path.join(base, dom), ignore_errors=True)
    runs["prostate_process"]["slice_tree_write_s"] = write_s
    emit("host_loader", **runs["prostate_process"])
    summary = dict(seconds=time.perf_counter() - t_phase, loaders_equal=same, compared_batches=HOST_COMPARED_BATCHES,
                   batch_check_s=batch_check_s, card_cpu_step=parity,
                   k1_launches={k: v["k1_launches"] for k, v in runs.items()})
    emit("host_loader_summary", **summary)
    if not same:
        raise SystemExit("host_loader: the thread and the process loader built different batches for one seed")
    if not parity_ok:
        raise SystemExit(f"host_loader: a card step on a host batch parts from the CPU step: {parity}")
    return runs


# --- --deterministic and K2 ---------------------------------------------------------


def phase_k2(torch, bw, shapes, forward_shapes):
    """K2 against its plain version on the card at each (shape, dtype) a
    deterministic step gives it, bit for bit, and against torch's own
    upsample_bilinear2d backward (atomics, another summation order) of the
    same gradient in float32; beside it, torch's backward in the gradient's
    own dtype (in bfloat16 its atomics round every add); at
    each: `ms` as K1's, `kernel_ms`, the plain version's and the
    library call's times (`library_kernel_ms` back to back, as
    `kernel_ms`), and the bytes bound.  K2's `kernel_ms` is
    `back_to_back_ms` (torch.profiler dropped some of K2's kernels on the
    card: it saw 13 of 20).  Then K3 the same way at each (shape, dtype) of
    the forward (lines `k3`), against its plain version bit for bit and
    against aten's forward (upsample_bilinear2d.vec, which contracts to FMA
    where K3 rounds every product): within 1e-6 of the input's largest
    element in float32, and a bfloat16 result within 2^-8 of aten's float32
    forward of the same input (one rounding).  Returns the K2 and K3 cases."""
    from ramdsir_tpu_torch.ops import upsample

    gen = torch.Generator(device="cuda").manual_seed(7)
    flush_buf = torch.empty(128 * 2**20, dtype=torch.uint8, device="cuda")
    flush = lambda: flush_buf.zero_()
    dtype_name = lambda dtype: str(dtype).split(".")[-1]
    out = {}
    for shape, dtype in shapes:
        n, c, h, w = shape
        g = torch.randn((n, c, 2 * h, 2 * w), generator=gen, device="cuda").to(dtype)
        zero_launches()
        got = upsample.upsample2x_backward(g)
        want = upsample.upsample2x_backward_plain(g)
        lib = lambda x=g: torch.ops.aten.upsample_bilinear2d_backward(x, [2 * h, 2 * w], list(shape), False, 2.0, 2.0)
        ref, ref32 = lib(), lib(g.float())
        torch.cuda.synchronize()
        if read_launches()["k2"] != 1:
            raise SystemExit(f"K2 at {shape}: {read_launches()['k2']} launches for one call")
        err = float((got.float() - want.float()).abs().max())
        lib_err = float((got.float() - ref.float()).abs().max() / ref.float().abs().max())
        lib32_err = float((got.float() - ref32).abs().max() / ref32.abs().max())
        key = f"{'x'.join(map(str, shape))}:{dtype_name(dtype)}"
        entry = dict(shape=list(shape), dtype=dtype_name(dtype), max_abs_err=err, bit_equal=err == 0.0,
                     library_max_rel_err=lib_err, float32_library_max_rel_err=lib32_err,
                     vector_path=upsample.vector_path(g, got),
                     ms=cuda_time_ms(lambda: upsample.upsample2x_backward(g), reps=20, flush=flush),
                     kernel_ms=back_to_back_ms(lambda: upsample.upsample2x_backward(g)),
                     plain_ms=cuda_time_ms(lambda: upsample.upsample2x_backward_plain(g), reps=10, flush=flush),
                     library_ms=cuda_time_ms(lib, reps=20, flush=flush), library_kernel_ms=back_to_back_ms(lib),
                     bound_ms=1e3 * k2_bytes(shape, g.element_size()) / bw, bound_by="bytes")
        emit("k2", case=key, **entry)
        # against torch's float32 backward of the same gradient: float32 sums in
        # another order (1e-5), and in bfloat16 K2's one rounding (2^-8)
        if not entry["bit_equal"] or lib32_err > (1e-5 if dtype == torch.float32 else 2.0**-8):
            raise SystemExit(f"K2 at {key}: {err} from its plain version, {lib32_err} from torch's float32 backward")
        out[key] = entry
    out3 = {}
    for shape, dtype in forward_shapes:
        x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        zero_launches()
        got = upsample.upsample2x_forward(x)
        want = upsample.upsample2x_forward_plain(x)
        lib = lambda t=x: torch.ops.aten.upsample_bilinear2d.vec(t, None, False, [2.0, 2.0])
        ref, ref32 = lib(), lib(x.float())
        torch.cuda.synchronize()
        if read_launches()["k3"] != 1:
            raise SystemExit(f"K3 at {shape}: {read_launches()['k3']} launches for one call")
        err = float((got.float() - want.float()).abs().max())
        scale = float(x.float().abs().max()) if dtype == torch.float32 else float(ref32.abs().max())
        lib32_err = float((got.float() - ref32).abs().max()) / scale
        key = f"{'x'.join(map(str, shape))}:{dtype_name(dtype)}"
        entry = dict(shape=list(shape), dtype=dtype_name(dtype), max_abs_err=err, bit_equal=err == 0.0,
                     library_max_rel_err=float((got.float() - ref.float()).abs().max() / ref.float().abs().max()),
                     float32_library_max_rel_err=lib32_err, vector_path=upsample.vector_path(x, got),
                     ms=cuda_time_ms(lambda: upsample.upsample2x_forward(x), reps=20, flush=flush),
                     kernel_ms=back_to_back_ms(lambda: upsample.upsample2x_forward(x)),
                     plain_ms=cuda_time_ms(lambda: upsample.upsample2x_forward_plain(x), reps=10, flush=flush),
                     library_ms=cuda_time_ms(lib, reps=20, flush=flush), library_kernel_ms=back_to_back_ms(lib),
                     bound_ms=1e3 * k2_bytes(shape, x.element_size()) / bw, bound_by="bytes")
        emit("k3", case=key, **entry)
        if not entry["bit_equal"] or lib32_err > (1e-6 if dtype == torch.float32 else 2.0**-8):
            raise SystemExit(f"K3 at {key}: {err} from its plain version, {lib32_err} from aten's float32 forward")
        out3[key] = entry
    return out, out3


def phase_batch_norm(torch, bw):
    """The grouped batch norm's kernels (csrc/batch_norm.cu) at every norm
    shape of a fundus and a prostate step (tools/batch_norm_study.py): the
    forward and backward against the float64 plain version (within
    BN_TOL of each result's largest magnitude, as the card tests) and two
    runs bit-equal; the device ms of each kernel (torch.profiler), cuDNN's
    per-group F.batch_norm + torch.cat forward and backward (`library_ms`),
    the plain version's, and the bound (5 float32 passes, counts.norm_bytes's
    arithmetic); then each step's sums.  Returns {config: sums}."""
    from ramdsir_tpu_torch.ops import batch_norm as bn
    from tools import batch_norm_study as study

    gen = torch.Generator(device="cuda").manual_seed(11)
    out = {}
    for config, path in study.CONFIGS.items():
        with open(path) as f:
            norms = study.step_norms(json.load(f))
        sums = dict.fromkeys(("fwd_ms", "bwd_ms", "library_ms", "plain_ms", "bound_ms"), 0.0)
        for (rows, c, side, groups), count in sorted(norms.items()):
            layout = bn.Layout(groups)
            x, dy, w, b, rm, rv = study.case_inputs(torch, gen, rows, c, side, groups)
            entry = {**study.check_case(torch, bn, x, dy, layout, w, b, rm, rv),
                     **study.time_case(torch, bn, x, dy, layout, w, b, rm, rv)}
            entry.update(library_ms=entry.pop("library_fwd_ms") + entry.pop("library_bwd_ms"),
                         bound_ms=1e3 * 5 * 4 * x.numel() / bw, vector_path=bn._plan_for(x, layout).vec)
            emit("batch_norm", config=config, shape=[rows, c, side, side], groups=[g[0] for g in groups],
                 per_step=count, **entry)
            errs = [v for k, v in entry.items() if k.endswith("_err")]
            if not entry["repeat_equal"] or max(errs) > BN_TOL:
                raise SystemExit(f"batch_norm at {config} {rows}x{c}x{side}^2: {entry}")
            for k in sums:
                sums[k] += count * entry[k]
            del x, dy
        sums.update(norms=sum(norms.values()), kernels_ms=sums["fwd_ms"] + sums["bwd_ms"])
        sums["roofline"] = sums["bound_ms"] / sums["kernels_ms"]
        emit("batch_norm_summary", config=config, **sums)
        out[config] = sums
    torch.cuda.empty_cache()
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
    final_model.ckpt) and log bit-equal losses; K2 and K3 launch 8 a
    training step each with --rec in every run, with the mode or without
    it (the train step's activations are NCHW-contiguous); in eval K2
    never, K3 4 an eval batch under the mode (counted apart from the
    steps), none without it (channels-last: aten's NHWC kernel);
    K1 launches == steps in every run.  Two steps from one re-loaded state
    under the mode are bit-equal (without it cuDNN's algorithms may part
    them).
    Every (shape, dtype) K2 and K3 met then goes through phase_k2.  The runs
    take the default scan windows, so the recording hooks on K2's and K3's
    wrappers see the two eager warm-up steps and the capture only, never a
    replay: the shapes are those of every step all the same.  The K1, K2
    and K3 counts are the kernels' own on the card, replays included, and
    K2's and K3's in eval are read on the card around each eval."""
    import dataclasses

    from ramdsir_tpu_torch.config import TrainConfig
    from ramdsir_tpu_torch.data.device_pipeline import DeviceFundusPipeline, DeviceProstatePipeline
    from ramdsir_tpu_torch.ops import upsample
    from ramdsir_tpu_torch.train.checkpoint import read_checkpoint
    from ramdsir_tpu_torch.train.loop import deterministic_mode, fit
    from ramdsir_tpu_torch.train.steps import sample_step_draws

    shapes, forward_shapes, runs, eval_now = [], [], {}, [dict(in_eval=False)]
    record, record_forward = upsample.upsample2x_backward, upsample.upsample2x_forward

    def recording(grad):
        key = (tuple(grad.shape[:2]) + (grad.shape[2] // 2, grad.shape[3] // 2), grad.dtype)
        if key not in shapes:
            shapes.append(key)
        return record(grad)

    def recording_forward(x):  # the training steps' shapes only
        if not eval_now[0]["in_eval"] and (tuple(x.shape), x.dtype) not in forward_shapes:
            forward_shapes.append((tuple(x.shape), x.dtype))
        return record_forward(x)

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
            zero_launches()
            with mock.patch.object(upsample, "upsample2x_backward", recording), \
                    mock.patch.object(upsample, "upsample2x_forward", recording_forward), \
                    eval_launches() as seen:
                eval_now[0] = seen
                summary = fit(cfg, max_steps=DET_STEPS, pipeline=make_pipe(cfg), testset=data)
            counts = read_launches()
            rows = [json.loads(line) for line in open(os.path.join(cfg.save_path, "log", "metrics.jsonl"))]
            out[rep] = dict(summary=summary, k1=counts["k1"], k2=counts["k2"] - seen["k2"], k3=counts["k3"] - seen["k3"],
                            k2_eval=seen["k2"], k3_eval=seen["k3"],
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
                     k3_launches={rep: out[rep]["k3"] for rep in DET_RUNS},
                     k2_eval_launches={rep: out[rep]["k2_eval"] for rep in DET_RUNS},
                     k3_eval_launches={rep: out[rep]["k3_eval"] for rep in DET_RUNS},
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
        want_k2 = {rep: 8 * DET_STEPS for rep in DET_RUNS}
        if entry["k2_launches"] != want_k2 or any(entry["k2_eval_launches"].values()):
            raise SystemExit(f"deterministic {name}: K2 launches {entry['k2_launches']} in training, "
                             f"{entry['k2_eval_launches']} in eval, expected {want_k2} and none")
        if entry["k3_launches"] != want_k2:
            raise SystemExit(f"deterministic {name}: K3 launches in training {entry['k3_launches']}, expected {want_k2}")
        if any((n > 0 and n % 4 == 0) != rep.startswith("det") for rep, n in entry["k3_eval_launches"].items()):
            raise SystemExit(f"deterministic {name}: K3 launches in eval {entry['k3_eval_launches']}, expected 4 a batch")
        if param_err != 0.0 or loss_rel != 0.0 or stat_err != 0.0 or entry["deterministic_after"]:
            raise SystemExit(f"deterministic {name}: two steps from one re-loaded state differ: {entry}")
        runs[name] = entry
    return runs, shapes, forward_shapes


# --- scan windows: CUDA-graph replays of the train step ---------------------------------


SCAN_STEPS = {"fundus": 24, "prostate": 22}  # a segment's window (21 / 20 steps), an eval, then 3 / 2 more steps
SCAN_OUT = os.path.join(OUT, "scan")
HOST_LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernelEx",
                     "cudaGraphLaunch", "cuGraphLaunch")


def scan_fit(torch, ram_mix, cfg, pipe, steps, testset):
    """`fit` of `steps` steps with K1, K2 and K3 counted from 0 and K2's and
    K3's eval launches apart: (summary, counts, the loss and lr rows without
    the clock, the final .ckpt tree)."""
    from ramdsir_tpu_torch.train.checkpoint import read_checkpoint
    from ramdsir_tpu_torch.train.loop import fit

    shutil.rmtree(cfg.save_path, ignore_errors=True)
    zero_launches()
    with eval_launches() as eval_counts:
        summary = fit(cfg, max_steps=steps, pipeline=pipe, testset=testset)
    got = read_launches()
    counts = dict(k1=got["k1"], k2=got["k2"] - eval_counts["k2"], k3=got["k3"] - eval_counts["k3"],
                  k2_eval=eval_counts["k2"], k3_eval=eval_counts["k3"])
    rows = [json.loads(line) for line in open(os.path.join(cfg.save_path, "log", "metrics.jsonl"))]
    rows = [{k: v for k, v in r.items() if k != "t"} for r in rows if "loss/loss" in r or "lr" in r]
    return summary, counts, rows, read_checkpoint(summary["resume_checkpoint"])["state"]


SCAN_WARM_STEPS, SCAN_PROFILED_STEPS = 3, 5  # the graph's two eager steps, its capture and a replay


def scan_timing(torch, np, name, cfg, pipe, graphs, seed=0):
    """Windows from the seed's state through the window step, as single-step
    windows (--scan_window 1) or graph windows of up to W = steps an epoch:
    SCAN_WARM_STEPS steps (the graph's capture, or a warm-up), W steps
    timed between CUDA events (each step, or the window), and
    SCAN_PROFILED_STEPS steps under torch.profiler.  With graphs a window of
    SCAN_WARM_STEPS and its ring append then run under
    torch.cuda.set_sync_debug_mode("error").  Per-step losses of the timed
    window come back for the distances between runs."""
    from torch.profiler import ProfilerActivity, profile

    from ramdsir_tpu_torch.train.state import init_state
    from ramdsir_tpu_torch.train.steps import make_train_step
    from ramdsir_tpu_torch.utils.logging import DeviceMetricsRing, MetricsWriter

    w, b = len(pipe), sum(cfg.batch_size_list)
    state = init_state(cfg, torch.Generator().manual_seed(seed), "cuda")
    runner = make_train_step(cfg, total_iters=1000, batch_size_list=cfg.batch_size_list, device_data=pipe.device_data,
                             scan=True, window=w if graphs else 1)
    gen = torch.Generator().manual_seed(seed)
    plans = [pipe.epoch_plan() for _ in range(4)]
    plans = [{k: v[:n] for k, v in p.items()} for p, n in zip(plans, (SCAN_WARM_STEPS, w, SCAN_PROFILED_STEPS,
                                                                         SCAN_WARM_STEPS))]
    units = (lambda plan: [plan]) if graphs else (
        lambda plan: [{k: v[i : i + 1] for k, v in plan.items()} for i in range(len(plan["img_idx"]))])

    def window(plan, events=None):
        tables = []
        for unit in units(plan):
            tables.append(runner(state, unit, gen)[0])
            if events is not None:
                events.append(torch.cuda.Event(enable_timing=True))
                events[-1].record()
        return {k: torch.cat([t[k] for t in tables]) for k in tables[0]}

    sync(torch)
    torch.cuda.reset_peak_memory_stats()
    window(plans[0])
    events = [torch.cuda.Event(enable_timing=True)]
    events[0].record()
    timed = window(plans[1], events)
    sync(torch)
    ms = [a.elapsed_time(c) for a, c in zip(events, events[1:])]
    per_step = [m / (w if graphs else 1) for m in ms for _ in range(w if graphs else 1)]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        window(plans[2])
        sync(torch)
        wall_us = 1e6 * (time.perf_counter() - t0)
    host_calls = sum(1 for e in prof.events() if e.name in HOST_LAUNCH_CALLS)
    n = SCAN_PROFILED_STEPS
    entry = dict(run=name, mode="graph" if graphs else "scan_window_1", steps_a_window=w, batch=b,
                 image_size=cfg.image_size, compute_dtype=cfg.compute_dtype,
                 median_step_ms=statistics.median(per_step), images_per_sec=b * w / (sum(ms) / 1e3),
                 host_launch_calls_per_step=host_calls / n, peak_memory_bytes=torch.cuda.max_memory_allocated(),
                 capture_s=runner.capture_seconds, graph_pool_bytes=runner.graph_pool_bytes, replays=runner.replays,
                 graphed=runner.graphed(), profiled_steps=n, **device_breakdown(prof, wall_us, n, "step"))
    entry.pop("top_kernels_ms_per_step")
    if graphs:
        writer = MetricsWriter(os.path.join(SCAN_OUT, "sync_check"))
        ring = DeviceMetricsRing(writer)
        torch.cuda.set_sync_debug_mode("error")
        try:
            ring.append(state.step, window(plans[3]))
        finally:
            torch.cuda.set_sync_debug_mode(0)
        ring.flush()
        writer.close()
        entry["window_and_ring_append_without_sync"] = True
    losses = timed["loss"].cpu().numpy()
    entry["losses_finite"] = bool(np.all(np.isfinite(losses)))
    return entry, losses


def phase_scan(torch, np, ram_mix, arrays, testset, prostate, prostate_root, card):
    """Scan windows on the card: `fit` with the default window (W = the
    steps of the segment up to the next eval: CUDA-graph replays of one
    step after two eager ones) against --scan_window 1 (a step a launch).

    Under --deterministic, fundus at the reference configuration and
    prostate, each over two segments with an eval between them: the final
    parameters, BN statistics, Adam moments and steps and every logged loss
    and lr row bit-equal, K1 counted once a step and K2 and K3 8 times a
    step in both runs (K3's eval launches apart), and the graph replayed at
    every step after the first two.  Then, for fundus and prostate in
    float32 and bfloat16, in turns a step a launch and graphs (fundus
    float32: eager, graph, graph, eager), the window step's timing
    (`scan_timing`): median step, img/s, device busy and idle share
    (torch.profiler over one window), host launch calls a step, peak
    memory, capture seconds and the graph's pool; one graph window and its
    ring append under the sync debug mode "error"; and, without
    --deterministic, the fundus float32 losses of graph against eager and
    of eager against eager (the atomics of cuDNN's and torch's backward
    kernels make two eager runs part), gated on finite losses only."""
    import dataclasses

    from ramdsir_tpu_torch.config import TrainConfig
    from ramdsir_tpu_torch.data.device_pipeline import DeviceFundusPipeline, DeviceProstatePipeline

    def fundus_pipe(cfg):
        return DeviceFundusPipeline.from_arrays(
            arrays, cfg.domain_idxs, cfg.batch_size_list, cfg.test_domain_idx, is_out_domain=True,
            seed=cfg.seed, precompute_donor_amp=cfg.ram_precompute_donor_amp, device="cuda")

    def prostate_pipe(cfg):
        return DeviceProstatePipeline.from_arrays(
            prostate, cfg.domain_idxs, cfg.batch_size_list, cfg.test_domain_idx, seed=cfg.seed, device="cuda")

    def config(dataset, run_dir, bf16=False, **kw):
        if dataset == "fundus":
            return main_path_config(TrainConfig, "bf16" if bf16 else "default", run_dir, **kw)
        return prostate_config(TrainConfig, run_dir, prostate_root, bf16, **kw)

    results = {"bit_equality": {}, "timing": []}
    for dataset in ("fundus", "prostate"):
        steps, out = SCAN_STEPS[dataset], {}
        for mode, sw in (("scan_window_1", 1), ("graph", None)):
            cfg = config(dataset, os.path.join(SCAN_OUT, dataset, mode), deterministic=True, scan_window=sw)
            pipe = fundus_pipe(cfg) if dataset == "fundus" else prostate_pipe(cfg)
            out[mode] = scan_fit(torch, ram_mix, cfg, pipe, steps, testset if dataset == "fundus" else None)
        (sa, ca, ra, ta), (sb, cb, rb, tb) = out["scan_window_1"], out["graph"]
        want = dict(k1=steps, k2=8 * steps, k3=8 * steps, k2_eval=0)
        entry = dict(run=dataset, steps=steps, deterministic=True, state_bit_equal=_same_tree(np, ta, tb),
                     logged_rows_bit_equal=ra == rb and len(ra) == 2 * steps,
                     launches={"scan_window_1": ca, "graph": cb},
                     scan_window={"scan_window_1": sa["scan_window"], "graph": sb["scan_window"]},
                     graph_replays=sb["graph_replays"], capture_s=sb["capture_s"],
                     graph_pool_bytes=sb["graph_pool_bytes"],
                     median_step_ms={"scan_window_1": sa["median_step_ms"], "graph": sb["median_step_ms"]},
                     images_per_sec={"scan_window_1": sa["images_per_sec"], "graph": sb["images_per_sec"]})
        emit("scan", **entry)
        results["bit_equality"][dataset] = entry
        if not (entry["state_bit_equal"] and entry["logged_rows_bit_equal"]):
            raise SystemExit(f"scan {dataset}: graph windows and --scan_window 1 differ: {entry}")
        if any({k: c[k] for k in want} != want for c in (ca, cb)):
            raise SystemExit(f"scan {dataset}: launches {entry['launches']}, expected {want} in both runs")
        if sa["graph_replays"] != 0 or sb["graph_replays"] != steps - 2 or sb["scan_window"] != len(pipe):
            raise SystemExit(f"scan {dataset}: W {entry['scan_window']}, replays {sb['graph_replays']}")

    losses = {}
    turns = [("fundus", False, (False, True, True, False)), ("fundus", True, (False, True)),
             ("prostate", False, (False, True)), ("prostate", True, (False, True))]
    for dataset, bf16, modes in turns:
        name = dataset + ("_bf16" if bf16 else "")
        cfg = config(dataset, os.path.join(SCAN_OUT, "timing"), bf16)
        for i, graphs in enumerate(modes):
            pipe = fundus_pipe(cfg) if dataset == "fundus" else prostate_pipe(cfg)
            entry, loss = scan_timing(torch, np, name, cfg, pipe, graphs)
            entry.update(turn=i, card=card)
            emit("scan", **entry)
            results["timing"].append(entry)
            losses.setdefault(name, []).append((graphs, loss))
            if not entry["losses_finite"] or entry["graphed"] != graphs:
                raise SystemExit(f"scan timing {name}: {entry}")
    (_, e1), (_, g1), (_, g2), (_, e2) = losses["fundus"]
    rel = lambda a, c: float(np.max(np.abs(a - c) / np.maximum(np.abs(c), 1e-6)))
    results["default_mode_loss_distance"] = dict(graph_vs_eager=rel(g1, e1), graph_vs_graph=rel(g2, g1),
                                                 eager_vs_eager=rel(e2, e1), steps=len(e1))
    emit("scan_summary", card=card, **results["default_mode_loss_distance"],
         launches_by_run={f"scan_{d}_{m}": e["launches"][m]["k1"] for d, e in results["bit_equality"].items()
                          for m in ("scan_window_1", "graph")})
    return results


# --- the single-card training variants ------------------------------------------------


VARIANT_STEPS, TRACE_STEPS, GLOBAL_BATCH = 8, 13, 48
REMAT_RUNS = ("plain", "remat", "remat_deterministic", "plain_deterministic")  # in turns, one call
VARIANTS_OUT = os.path.join(OUT, "variants")


@contextlib.contextmanager
def exact_float32(torch):
    """set_exact_float32 for the duration; the settings before it come back."""
    b = torch.backends
    saved = (b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32, b.cudnn.deterministic, b.cudnn.benchmark)
    set_exact_float32(torch)
    try:
        yield
    finally:
        b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32, b.cudnn.deterministic, b.cudnn.benchmark = saved


@contextlib.contextmanager
def k1_held_to_plain(torch, ram_mix, errs, calls):
    """K1's first `calls` calls of the run also run the plain version on
    copies of their inputs, and their largest difference (a device tensor,
    read after the run) goes to `errs`.  With `calls` the run's eager
    warm-up steps (GRAPH_WARMUP_STEPS, before a graph run's capture; also
    the step timer's warm-up) the timed steps carry no check, and a call
    inside a capture is never checked (it would run nothing but record the
    plain version into the graph).  The plain version launches nothing, so
    K1's counts stay the run's own."""
    kernel = ram_mix.mix_spectrum
    left = [calls]

    def checked(re, im, amp_t, ratio, band, *, full, delta=False):
        if not left[0] or torch.cuda.is_current_stream_capturing():
            return kernel(re, im, amp_t, ratio, band, full=full, delta=delta)
        left[0] -= 1
        want = ram_mix.mix_spectrum_plain(re.clone(), im.clone(), amp_t, ratio, band, full=full, delta=delta)
        got = kernel(re, im, amp_t, ratio, band, full=full, delta=delta)
        errs.extend((g - w).abs().max() for g, w in zip(got, want))
        return got

    with mock.patch.object(ram_mix, "mix_spectrum", checked):
        yield


def variant_fit(torch, np, ram_mix, name, cfg, pipe, steps, testset=None):
    """`fit` for `steps` steps (one eval at the end of each epoch and at the
    last step) with K1 held to its plain version in the untimed warm-up
    steps: the run's entry.  Losses finite every step, K1 launches ==
    steps, bit-equal.  K2's and K3's launches (eval included) are reported."""
    from ramdsir_tpu_torch.ops import upsample
    from ramdsir_tpu_torch.train.loop import fit
    from ramdsir_tpu_torch.train.steps import GRAPH_WARMUP_STEPS

    shutil.rmtree(cfg.save_path, ignore_errors=True)
    sync(torch)
    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()
    zero_launches()
    errs = []
    t0 = time.perf_counter()
    checked = GRAPH_WARMUP_STEPS
    with k1_held_to_plain(torch, ram_mix, errs, checked):
        summary = fit(cfg, max_steps=steps, pipeline=pipe, testset=testset)
    sync(torch)
    wall = time.perf_counter() - t0
    counts = read_launches()
    rows = [json.loads(line) for line in open(os.path.join(cfg.save_path, "log", "metrics.jsonl"))]
    losses = [{k: v for k, v in r.items() if k.startswith("loss/")} for r in rows if "loss/loss" in r]
    finite = len(losses) == steps and all(np.all(np.isfinite(list(r.values()))) for r in losses)
    evals = [r["eval/avg_dice"] for r in rows if "eval/avg_dice" in r]
    entry = dict(
        run=name, steps=summary["steps"], k1_launches=counts["k1"], k2_launches=counts["k2"],
        k3_launches=counts["k3"],
        k1_max_abs_err=max(float(e) for e in errs) if errs else None, k1_checked_steps=checked,
        losses_finite=finite,
        first_loss=losses[0]["loss/loss"], last_loss=losses[-1]["loss/loss"],
        median_step_ms=summary["median_step_ms"], images_per_sec=summary["images_per_sec"],
        peak_memory_bytes=torch.cuda.max_memory_allocated() if DEVICE == "cuda" else "not measured",
        wall_s=wall, batch=sum(cfg.batch_size_list), lr=cfg.lr, norm=cfg.norm, num_classes=cfg.num_classes,
        compute_dtype=cfg.compute_dtype, remat=cfg.remat, deterministic=cfg.deterministic, evals=len(evals),
        last_eval_avg_dice=evals[-1] if evals else None,
    )
    if cfg.dataset == "prostate":
        entry.update(dice=summary["dice"], eval_volumes=summary["eval_timing"]["volumes"])
    else:
        entry.update(cup_dice=summary["cup_dice"], disc_dice=summary["disc_dice"])
    if not finite or summary["steps"] != steps or entry["k1_launches"] != steps or entry["k1_max_abs_err"] != 0.0:
        emit("variants", **entry)
        raise SystemExit(f"variants {name}: {summary['steps']} steps, K1 launches {entry['k1_launches']} "
                         f"(max err {entry['k1_max_abs_err']}), losses finite {finite}")
    return entry, summary, losses


def card_cpu_step_parity(torch, ram_mix, cfg, pipe, crop):
    """One step from the seed's state on the card and on the CPU, from the
    same row, data and draws (TF32 off, deterministic cuDNN): step_parity's
    numbers and whether they are within its bounds."""
    import dataclasses
    import types

    from ramdsir_tpu_torch.train.steps import sample_step_draws

    row = next(iter(pipe))
    draws = sample_step_draws(torch.Generator().manual_seed(5), sum(cfg.batch_size_list), torch.device(DEVICE),
                              crop=crop)
    on_cpu = types.SimpleNamespace(device_data={k: v.cpu() for k, v in pipe.device_data.items()})
    with exact_float32(torch):
        card = step_from_seed(torch, ram_mix, cfg, pipe, row, draws, device=DEVICE)
        t0 = time.perf_counter()
        cpu = step_from_seed(torch, ram_mix, dataclasses.replace(cfg, device="cpu"), on_cpu, row,
                             {k: v.cpu() for k, v in draws.items()}, device="cpu")
        cpu_s = time.perf_counter() - t0
    loss_rel, param_err, stat_err, stats_ok = step_distance(
        torch, (card[0], {k: v.cpu() for k, v in card[1].items()}), cpu[:2])
    parity = dict(loss_max_rel=loss_rel, loss_tol=1e-5, params_max_abs=param_err, params_tol=2.5 * cfg.lr,
                  running_stats_max_abs=stat_err, stats_tol="rtol 1e-4, atol 1e-5", k1_launches=card[2],
                  cpu_step_s=cpu_s)
    ok = loss_rel <= 1e-5 and param_err <= 2.5 * cfg.lr and stats_ok and card[2] == 1
    return parity, ok


def phase_variants(torch, np, ram_mix, arrays, testset, prostate, prostate_root, default_run):
    """Every single-card training variant at full width, each a `fit` of a
    few steps with its eval: prostate --num_classes 3 (the volume eval at
    C = 3), fundus --norm gn / in (and gn in bfloat16), --remat (fundus
    and prostate, without and with in turns, then both under
    --deterministic), --global_batch 48 and --trace_dir.  K1 is launched
    once a step and held to its plain version in each run's untimed
    warm-up steps; the step parities hold card against CPU within
    step_parity's bounds.  The timed steps run as a user's do, so each
    run's median step compares with fundus_remat:plain and
    prostate_remat:plain, the BN runs of this phase."""
    import dataclasses

    from ramdsir_tpu_torch.config import TrainConfig
    from ramdsir_tpu_torch.data.device_pipeline import DeviceFundusPipeline, DeviceProstatePipeline
    from ramdsir_tpu_torch.train.checkpoint import read_checkpoint
    from ramdsir_tpu_torch.train.state import build_models

    def fundus_pipe(cfg):
        return DeviceFundusPipeline.from_arrays(
            arrays, cfg.domain_idxs, cfg.batch_size_list, cfg.test_domain_idx, is_out_domain=True,
            seed=cfg.seed, precompute_donor_amp=cfg.ram_precompute_donor_amp, device=DEVICE)

    def prostate_pipe(cfg):
        return DeviceProstatePipeline.from_arrays(
            prostate, cfg.domain_idxs, cfg.batch_size_list, cfg.test_domain_idx, seed=cfg.seed, device=DEVICE)

    def fundus_cfg(name, **variant):
        cfg = main_path_config(TrainConfig, "default", os.path.join(VARIANTS_OUT, name), **variant)
        return dataclasses.replace(cfg, device=DEVICE)

    def prostate_cfg(name, **variant):
        return prostate_config(TrainConfig, os.path.join(VARIANTS_OUT, name), prostate_root, **variant)

    t_phase = time.perf_counter()
    out = {}
    launches = {"fundus": {}, "prostate": {}}

    def record(entry, dataset, **extra):
        entry.update(extra)
        emit("variants", **entry)
        launches[dataset][entry["run"]] = entry["k1_launches"]
        out[entry["run"]] = entry

    # the softmax head, GN and IN, each with its card <-> CPU step
    for name, dataset, variant in (("prostate_softmax3", "prostate", dict(num_classes=3)),
                                   ("fundus_gn", "fundus", dict(norm="gn")),
                                   ("fundus_in", "fundus", dict(norm="in"))):
        cfg = (prostate_cfg if dataset == "prostate" else fundus_cfg)(name, **variant)
        pipe = (prostate_pipe if dataset == "prostate" else fundus_pipe)(cfg)
        entry, summary, _ = variant_fit(torch, np, ram_mix, name, cfg, pipe, VARIANT_STEPS,
                                        None if dataset == "prostate" else testset)
        parity, ok = card_cpu_step_parity(torch, ram_mix, cfg, pipe, crop=dataset == "fundus")
        if dataset == "prostate":
            head = torch.load(summary["final_checkpoint"], map_location="cpu")["seg_decoder_state_dict"]["out1.weight"]
            entry.update(head_classes=int(head.shape[0]), eval_volumes=summary["eval_timing"]["volumes"])
            ok = ok and head.shape[0] == 3 and summary["eval_timing"]["volumes"] == PROSTATE_VOLUMES
        record(entry, dataset, step_parity_card_vs_cpu=parity)
        if not ok:
            raise SystemExit(f"variants {name}: {parity}")

    # GN in bfloat16: the activations after the first GroupNorm are float32, as in JAX
    cfg = fundus_cfg("fundus_gn_bf16", norm="gn", **BF16)
    entry, _, _ = variant_fit(torch, np, ram_mix, "fundus_gn_bf16", cfg, fundus_pipe(cfg), VARIANT_STEPS, testset)
    enc = build_models(cfg)["encoder"].to(DEVICE).train()
    seen = []
    enc.convd1.bn1.register_forward_hook(lambda m, a, o: seen.append(str(o.dtype).split(".")[-1]))
    with torch.no_grad():
        feats = enc(torch.zeros((2, C, S, S), device=DEVICE, dtype=torch.bfloat16))
    record(entry, "fundus", dtype_after_first_gn=seen[0], bottleneck_dtype=str(feats[-1].dtype).split(".")[-1])
    if seen[0] != "float32":
        raise SystemExit(f"variants fundus_gn_bf16: {seen[0]} after the first GroupNorm, expected float32")

    # --remat, without and with in turns, then both under --deterministic (bit-equal)
    for dataset in ("fundus", "prostate"):
        name = f"{dataset}_remat"
        runs, states = {}, {}
        for rep in REMAT_RUNS:
            variant = dict(remat=rep.startswith("remat"), deterministic=rep.endswith("deterministic"))
            cfg = (prostate_cfg if dataset == "prostate" else fundus_cfg)(f"{name}/{rep}", **variant)
            pipe = (prostate_pipe if dataset == "prostate" else fundus_pipe)(cfg)
            entry, summary, losses = variant_fit(torch, np, ram_mix, f"{name}:{rep}", cfg, pipe, VARIANT_STEPS,
                                                 None if dataset == "prostate" else testset)
            runs[rep] = entry
            states[rep] = (read_checkpoint(summary["resume_checkpoint"])["state"], losses)
            launches[dataset][f"{name}:{rep}"] = entry["k1_launches"]
        (sa, la), (sb, lb) = states["remat_deterministic"], states["plain_deterministic"]
        bit_equal = _same_tree(np, sa, sb) and la == lb
        med = {rep: runs[rep]["median_step_ms"] for rep in REMAT_RUNS}
        peak = {rep: runs[rep]["peak_memory_bytes"] for rep in REMAT_RUNS}
        entry = dict(run=name, steps=VARIANT_STEPS, median_step_ms=med, peak_memory_bytes=peak,
                     images_per_sec={rep: runs[rep]["images_per_sec"] for rep in REMAT_RUNS},
                     remat_step_cost_share=med["remat"] / med["plain"] - 1.0,
                     remat_peak_memory_share=peak["remat"] / peak["plain"] if DEVICE == "cuda" else "not measured",
                     deterministic_bit_equal=bit_equal, k1_launches={r: runs[r]["k1_launches"] for r in REMAT_RUNS},
                     k1_max_abs_err=max(runs[r]["k1_max_abs_err"] for r in REMAT_RUNS),
                     losses={r: runs[r]["last_loss"] for r in REMAT_RUNS})
        emit("variants", **entry)
        out[name] = entry
        if not bit_equal:
            raise SystemExit(f"variants {name}: --remat and no remat under --deterministic are not bit-equal")

    # --global_batch 48: 16 a domain, the LR x 3
    cfg = fundus_cfg("fundus_global_batch", global_batch=GLOBAL_BATCH)
    entry, _, _ = variant_fit(torch, np, ram_mix, "fundus_global_batch", cfg, fundus_pipe(cfg), VARIANT_STEPS, testset)
    record(entry, "fundus", batch_size_list=cfg.batch_size_list, default_lr=fundus_cfg("unused").lr,
           default_images_per_sec=default_run["images_per_sec"], default_median_step_ms=default_run["median_step_ms"],
           bn_run_images_per_sec=out["fundus_remat"]["images_per_sec"]["plain"],
           bn_run_median_step_ms=out["fundus_remat"]["median_step_ms"]["plain"])
    if cfg.batch_size_list != [16, 16, 16] or abs(cfg.lr - 3 * fundus_cfg("unused").lr) > 1e-12:
        raise SystemExit(f"variants fundus_global_batch: batches {cfg.batch_size_list}, lr {cfg.lr}")

    # --trace_dir with windows of 4: the trace of steps 4-12 (the first whole
    # window after the capture to the one that holds step 12), graph replays
    # and all, names K1's kernel and holds a ramdsir.train.replay span a replay
    trace_dir = os.path.join(VARIANTS_OUT, "trace")
    shutil.rmtree(trace_dir, ignore_errors=True)
    cfg = fundus_cfg("fundus_trace", trace_dir=trace_dir, scan_window=4)
    entry, summary, _ = variant_fit(torch, np, ram_mix, "fundus_trace", cfg, fundus_pipe(cfg), TRACE_STEPS, testset)
    path = summary.get("trace")
    text = open(path).read() if path and os.path.isfile(path) else ""
    names_k1 = "mix_delta_flat_kernel" in text
    replay_spans = sum(e.get("cat") == "user_annotation" and e.get("name") == "ramdsir.train.replay"
                       for e in (json.loads(text)["traceEvents"] if text else []))
    record(entry, "fundus", trace=os.path.relpath(path, REPO) if path else None, trace_bytes=len(text),
           trace_names_k1=names_k1, trace_k1_events=text.count("mix_delta_flat_kernel"), trace_replay_spans=replay_spans)
    if path:
        os.remove(path)  # tens of MB; the check is made
    if not names_k1 or not path.endswith("trace_steps_4-12.json") or replay_spans != 9:
        raise SystemExit(f"variants fundus_trace: trace {path}, names K1 {names_k1}, {replay_spans} replay spans")
    emit("variants_summary", seconds=time.perf_counter() - t_phase, k1_launches=launches)
    return out, launches


# --- ddp: data-parallel training over several ranks on the one card --------------

DDP_OUT = os.path.join(OUT, "ddp")
DDP_STEPS, DDP_PROSTATE_STEPS, DDP_PROSTATE_SLICES = 10, 4, 8  # prostate: 8 slices a domain, one epoch
DDP_VARIANTS = {"deterministic": {"deterministic": True}, "deterministic_again": {"deterministic": True}}


def state_digest(torch, state):
    """sha256 of every parameter, buffer and Adam moment, and the step."""
    import hashlib

    h = hashlib.sha256(str(state.step).encode())
    for m in state.models.values():
        for t in m.state_dict().values():
            h.update(t.detach().cpu().contiguous().numpy().tobytes())
    for st in state.optimizer.state.values():
        for k in sorted(st):
            h.update(torch.as_tensor(st[k]).detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def ddp_pipe(cfg, data, device):
    from ramdsir_tpu_torch.data.device_pipeline import DeviceFundusPipeline, DeviceProstatePipeline

    if cfg.dataset == "prostate":
        return DeviceProstatePipeline.from_arrays(data, cfg.domain_idxs, cfg.batch_size_list, cfg.test_domain_idx,
                                                  seed=cfg.seed, device=device)
    return DeviceFundusPipeline.from_arrays(data, cfg.domain_idxs, cfg.batch_size_list, cfg.test_domain_idx,
                                            is_out_domain=True, seed=cfg.seed,
                                            precompute_donor_amp=cfg.ram_precompute_donor_amp, device=device)


def ddp_rank(rank, device, job):
    """One rank of a ddp launch: step 0 from the seed's state on this rank's
    rows (TF32 off), then each of job's runs, a `fit` of job's steps with K1
    held to its plain version in the two untimed warm-up steps, the
    gradient all-reduce timed with CUDA events and every all-reduce counted
    and timed on the host; after each run the replicas' spread, the largest
    elementwise max - min over the ranks of every parameter and buffer
    (all-reduces MAX and MIN: 0 when they are bit-equal)."""
    import dataclasses

    import torch

    from ramdsir_tpu_torch.ops import ram_mix
    from ramdsir_tpu_torch.train import loop
    from ramdsir_tpu_torch.train import steps as train_steps

    dist = torch.distributed
    cfg = dataclasses.replace(job["cfg"], device=str(device))
    on_card = torch.device(device).type == "cuda"
    pipe = ddp_pipe(cfg, job["data"], device)
    draws = {k: torch.from_numpy(v).to(device) for k, v in job["draws"].items()}
    with exact_float32(torch):
        metrics, sd, k1 = step_from_seed(torch, ram_mix, cfg, pipe, job["row"], draws, device=device)
    out = {"rank": rank, "step0": {"metrics": metrics, "k1_launches": k1}, "runs": {}}
    if rank == 0:
        out["step0"]["state"] = {k: v.cpu().numpy() for k, v in sd.items()}
    for run, variant in job["runs"]:
        rcfg = dataclasses.replace(cfg, save_path=os.path.join(DDP_OUT, run), **variant)
        pipe = ddp_pipe(rcfg, job["data"], device)
        captured, grad_events, host = {}, [], {"n": 0, "s": 0.0}
        real_init, real_grads, real_all_reduce = loop.init_state, train_steps.all_reduce_grads, dist.all_reduce

        def capture(*a, **k):
            captured["state"] = loop_state = real_init(*a, **k)
            return loop_state

        def timed_grads(models):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)] if on_card else None
            if ev:
                ev[0].record()
            real_grads(models)
            if ev:
                ev[1].record()
                grad_events.append(ev)

        def counted(*a, **k):
            t = time.perf_counter()
            try:
                return real_all_reduce(*a, **k)
            finally:
                host["n"] += 1
                host["s"] += time.perf_counter() - t

        if rank == 0:
            shutil.rmtree(rcfg.save_path, ignore_errors=True)
        dist.barrier()
        if on_card:
            torch.cuda.reset_peak_memory_stats(device)
        zero_launches()
        errs = []
        with mock.patch.object(loop, "init_state", capture), mock.patch.object(train_steps, "all_reduce_grads", timed_grads), \
                mock.patch.object(dist, "all_reduce", counted), k1_held_to_plain(torch, ram_mix, errs, 2):
            summary = loop.fit(rcfg, max_steps=job["steps"], pipeline=pipe,
                               testset=job["testset"] if rank == 0 else None)
        if on_card:
            torch.cuda.synchronize(device)
        launches = read_launches()["k1"]
        state = captured["state"]
        flat = torch.cat([t.detach().reshape(-1).float() for m in state.models.values()
                          for t in m.state_dict().values()])
        hi, lo = flat.clone(), flat.clone()
        dist.all_reduce(hi, op=dist.ReduceOp.MAX)
        dist.all_reduce(lo, op=dist.ReduceOp.MIN)
        grad_ms = [a.elapsed_time(b) for a, b in grad_events[2:]]  # after the timer's warm-up steps
        entry = dict(
            steps=summary["steps"], k1_launches=launches,
            k1_max_abs_err=max(float(e) for e in errs) if errs else None,
            median_step_ms=summary["median_step_ms"], images_per_sec=summary["images_per_sec"],
            peak_memory_bytes=torch.cuda.max_memory_allocated(device) if on_card else "not measured",
            grad_all_reduce_ms=statistics.median(grad_ms) if grad_ms else "not measured",
            all_reduces_per_step=host["n"] / max(summary["steps"], 1),
            all_reduce_host_ms_per_step=1e3 * host["s"] / max(summary["steps"], 1),
            replica_spread=float((hi - lo).abs().max()), digest=state_digest(torch, state),
        )
        if rank == 0:
            rows = [json.loads(line) for line in open(os.path.join(rcfg.save_path, "log", "metrics.jsonl"))]
            entry["losses"] = [r["loss/loss"] for r in rows if "loss/loss" in r]
            entry["evals"] = sum("eval/avg_dice" in r for r in rows)
        out["runs"][run] = entry
    return out


def ddp_launch(torch, np, ram_mix, cfg, data, testset, world, backend, devices, variants, steps, name, note):
    """One launch of `world` ranks on `devices`: step 0 from the seed's
    state against the single-process step from the same state and draws
    (TF32 off) within step_parity's bounds, then a `fit` of `steps` steps for
    each of `variants` ("plain" or a DDP_VARIANTS key) in turn.  Each run:
    finite losses, an eval on rank 0 at each epoch's end and at the last
    step, K1 once a step on every rank and
    bit-equal in the warm-up steps, the replicas bit-equal at the end.
    Emits a "ddp" line for step 0 and for each run, raises on any failed
    check; returns {run: entry} (with rank 0's losses and state digest)."""
    from ramdsir_tpu_torch.parallel import distributed
    from ramdsir_tpu_torch.train.steps import sample_step_draws

    runs = [name if v == "plain" else f"{name}_{v}" for v in variants]
    fundus = cfg.dataset == "fundus"
    pipe = ddp_pipe(cfg, data, DEVICE)
    row = next(iter(pipe))
    evals = -(-steps // len(pipe))  # at each epoch's end and at the last step
    draws = sample_step_draws(torch.Generator().manual_seed(5), sum(cfg.batch_size_list), torch.device(DEVICE),
                              crop=fundus)
    with exact_float32(torch):
        ref = step_from_seed(torch, ram_mix, cfg, pipe, row, draws, device=DEVICE)
    del pipe
    job = dict(cfg=cfg, data=data, testset=testset, row=row, draws={k: v.cpu().numpy() for k, v in draws.items()},
               runs=[(r, DDP_VARIANTS.get(v, {})) for r, v in zip(runs, variants)], steps=steps)
    t0 = time.perf_counter()
    got = distributed.launch(ddp_rank, world, devices=devices, backend=backend, args=(job,), timeout_s=600.0)
    launch_s = time.perf_counter() - t0
    sd0 = {k: torch.from_numpy(v) for k, v in got[0]["step0"]["state"].items()}
    loss_rel, param_err, stat_err, stats_ok = step_distance(
        torch, (got[0]["step0"]["metrics"], sd0), (ref[0], {k: v.cpu() for k, v in ref[1].items()}))
    parity = dict(loss_max_rel=loss_rel, loss_tol=1e-5, params_max_abs=param_err, params_tol=2.5 * cfg.lr,
                  running_stats_max_abs=stat_err, stats_tol="rtol 1e-4, atol 1e-5",
                  k1_launches=[g["step0"]["k1_launches"] for g in got],
                  losses_equal_across_ranks=all(g["step0"]["metrics"] == got[0]["step0"]["metrics"] for g in got))
    k1_per_step = 1 if DEVICE == "cuda" else 0  # a CPU rehearsal runs the plain mix
    ok = (loss_rel <= 1e-5 and param_err <= 2.5 * cfg.lr and stats_ok and parity["losses_equal_across_ranks"]
          and parity["k1_launches"] == [k1_per_step] * world)
    batch = sum(cfg.batch_size_list)
    emit("ddp", run=f"{name}:step0", world=world, backend=backend, devices=list(devices),
         rows_per_rank=-(-batch // world), batch=batch, step_parity=parity, launch_s=launch_s)
    if not ok:
        raise SystemExit(f"ddp {name}: step 0 against the single-process step: {parity}")
    results = {}
    for run in runs:
        per_rank = [g["runs"][run] for g in got]
        r0 = per_rank[0]
        entry = dict(
            run=run, world=world, backend=backend, steps=r0["steps"], batch=batch,
            k1_launches=[r["k1_launches"] for r in per_rank], k1_max_abs_err=[r["k1_max_abs_err"] for r in per_rank],
            median_step_ms=[r["median_step_ms"] for r in per_rank], images_per_sec=r0["images_per_sec"],
            peak_memory_bytes=[r["peak_memory_bytes"] for r in per_rank],
            grad_all_reduce_ms=[r["grad_all_reduce_ms"] for r in per_rank],
            all_reduces_per_step=r0["all_reduces_per_step"],
            all_reduce_host_ms_per_step=[r["all_reduce_host_ms_per_step"] for r in per_rank],
            replica_spread=r0["replica_spread"], digests_equal=len({r["digest"] for r in per_rank}) == 1,
            evals=r0["evals"], first_loss=r0["losses"][0], last_loss=r0["losses"][-1], note=note,
        )
        if isinstance(r0["grad_all_reduce_ms"], float) and r0["median_step_ms"]:
            entry["grad_all_reduce_share"] = r0["grad_all_reduce_ms"] / r0["median_step_ms"]
            entry["all_reduce_host_share"] = r0["all_reduce_host_ms_per_step"] / r0["median_step_ms"]
        finite = len(r0["losses"]) == steps and all(np.isfinite(r0["losses"]))
        results[run] = dict(entry, losses=r0["losses"], digest=r0["digest"])
        emit("ddp", **entry)
        if not (finite and r0["steps"] == steps and entry["k1_launches"] == [k1_per_step * steps] * world
                and all(e == 0.0 for e in entry["k1_max_abs_err"]) and entry["replica_spread"] == 0.0
                and entry["digests_equal"] and r0["evals"] == evals):
            raise SystemExit(f"ddp {run}: {entry}")
    return results


def phase_ddp(torch, np, ram_mix, arrays, testset, prostate_root):
    """Data-parallel training at the reference configurations on the one
    card (`ddp_launch` each): (a) fundus, one NCCL rank; (b) fundus, two
    gloo ranks on the same card (rows 8 + 8, domain 1 on both), then twice
    under --deterministic, whose two runs must end with the same state
    digest and losses; (c) prostate, three gloo ranks (batch 10 padded to
    12: 4 + 4 + 2 real rows).  Several ranks share one H100 here: the times
    are not a multi-GPU speed."""
    import dataclasses

    from ramdsir_tpu_torch.config import PROSTATE_DOMAINS, TrainConfig
    from ramdsir_tpu_torch.data.synthetic import prostate_arrays

    t_phase = time.perf_counter()
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    small_prostate = prostate_arrays(per_domain=DDP_PROSTATE_SLICES, size=PS, seed=0, domains=PROSTATE_DOMAINS[:5])
    fundus_cfg = dataclasses.replace(main_path_config(TrainConfig, "default", DDP_OUT), device=DEVICE)
    prostate_cfg = prostate_config(TrainConfig, DDP_OUT, prostate_root)
    one_card = f"{DEVICE}:0" if DEVICE == "cuda" else DEVICE
    note = "several ranks share one card: not a multi-GPU speed"
    launches = {"fundus": {}, "prostate": {}}
    results = {}
    groups = [  # (dataset, world, backend, variants run in turn in the one launch)
        ("fundus", 1, "nccl" if DEVICE == "cuda" else "gloo", ["plain"]),
        ("fundus", 2, "gloo", ["plain", "deterministic", "deterministic_again"]),
        ("prostate", 3, "gloo", ["plain"]),
    ]
    for dataset, world, backend, variants in groups:
        fundus = dataset == "fundus"
        got = ddp_launch(torch, np, ram_mix, fundus_cfg if fundus else prostate_cfg,
                         arrays if fundus else small_prostate, testset if fundus else None, world, backend,
                         [one_card] * world, variants, DDP_STEPS if fundus else DDP_PROSTATE_STEPS,
                         f"{dataset}_world{world}_{backend}", note)
        results.update(got)
        launches[dataset].update({f"ddp_{run}": entry["k1_launches"] for run, entry in got.items()})
    a, b = (results[f"fundus_world2_gloo_deterministic{s}"] for s in ("", "_again"))
    det_equal = a["digest"] == b["digest"] and a["losses"] == b["losses"]
    emit("ddp_summary", seconds=time.perf_counter() - t_phase, deterministic_bit_equal=det_equal,
         k1_launches=launches, note=note)
    if not det_equal:
        raise SystemExit("ddp: the two --deterministic world-2 runs are not bit-equal")
    return results, launches


# --- build -------------------------------------------------------------------


# --- the model zoo and the host transform library ------------------------------

ZOO_N = 16  # the reference width
ZOO_TIMED, ZOO_WARMUP = 10, 2
# name -> (class, forward kwargs); Unet2DMT's two heads share one model
ZOO = (("Unet2D", "Unet2D", {}), ("Unet2DMT[seg]", "Unet2DMT", {"is_rec": False}),
       ("Unet2DMT[rec]", "Unet2DMT", {"is_rec": True}), ("Unet2DDS[deep_sup]", "Unet2DDS", {"deep_sup": True}),
       ("Unet2DMS[multi_scale_output]", "Unet2DMS", {"multi_scale_output": True}), ("Discriminator", "Discriminator", {}))
ZOO_OUT_REL = 1e-5  # of the largest absolute output, as tests/test_torch_port_zoo.py


def _heads(y):
    return tuple(y) if isinstance(y, (tuple, list)) else (y,)


def phase_zoo(torch, np, n=ZOO_N, batch=B, size=S, device="cuda"):
    """The model zoo (models/unet.py) at the reference width on the card,
    batch 16 at 256^2 (the fundus reference batch): Unet2D, Unet2DMT with
    both heads, Unet2DDS with deep_sup, Unet2DMS with multi_scale_output,
    and the Discriminator on the same input.  Each: one train-mode forward
    with TF32 off beside the CPU forward of the same weights and input and
    the float64 forward (tests/_float64_forward.py, on the card): the running
    statistics within rtol 1e-4 / atol 1e-5 of the CPU's, every head within
    1e-5 of the largest absolute output of the float64 forward (the CPU
    test's rule) or, where the CPU's own float32 forward lies further from
    it at this size, within twice the CPU's distance; then the median of 10
    forward+backward passes (the loss: the mean of every head) on the
    port's default settings after 2 warm-up passes, the peak memory, and
    count_params."""
    import copy

    from ramdsir_tpu_torch.models import unet
    from ramdsir_tpu_torch.train.loop import tf32_settings
    from tests._float64_forward import float64_forward

    t_phase = time.perf_counter()
    x_cpu = torch.from_numpy(np.random.default_rng(11).normal(size=(batch, 3, size, size)).astype(np.float32))
    x = x_cpu.to(device)
    models, entries, ok = {}, {}, True
    for name, cls, kw in ZOO:
        if cls not in models:
            torch.manual_seed(0)  # the Discriminator's torch-default init
            build = getattr(unet, cls)
            models[cls] = build(n=n) if cls == "Discriminator" else build(n=n, generator=torch.Generator().manual_seed(1))
        model = models[cls]
        cpu = copy.deepcopy(model).train()
        card = copy.deepcopy(model).to(device).train()
        with exact_float32(torch), torch.no_grad():
            got = _heads(card(x, **kw))
            t0 = time.perf_counter()
            want = _heads(cpu(x_cpu, **kw))
            cpu_s = time.perf_counter() - t0
            exact = float64_forward(copy.deepcopy(model).to(device).train(), x, **kw)
        scale = max(float(w.abs().max()) for w in want)
        out_err = max(float((g.cpu() - w).abs().max()) for g, w in zip(got, want))
        card_f64 = max(float((g.double() - e).abs().max()) for g, e in zip(got, exact))
        cpu_f64 = max(float((w.double() - e.cpu()).abs().max()) for w, e in zip(want, exact))
        stats = [(k, v, card.state_dict()[k].cpu()) for k, v in cpu.state_dict().items() if k.endswith(("running_mean", "running_var"))]
        stat_err = max((float((c - v).abs().max()) for _, v, c in stats), default=0.0)
        stats_ok = all(torch.allclose(c, v, rtol=1e-4, atol=1e-5) for _, v, c in stats)
        shapes_ok = [tuple(g.shape) for g in got] == [tuple(w.shape) for w in want]
        finite = all(bool(torch.isfinite(g).all()) for g in got)
        del card, cpu
        # the timed passes: a fresh copy on the card, the port's default TF32 settings
        timed = copy.deepcopy(model).to(device).train()
        times = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        for i in range(ZOO_WARMUP + ZOO_TIMED):
            t0 = time.perf_counter()
            loss = sum(h.float().mean() for h in _heads(timed(x, **kw)))
            loss.backward()
            torch.cuda.synchronize()
            if i >= ZOO_WARMUP:
                times.append(time.perf_counter() - t0)
            timed.zero_grad(set_to_none=True)
        peak = torch.cuda.max_memory_allocated()
        del timed
        entry = dict(heads=[list(g.shape) for g in got], params_m=unet.count_params(model),
                     card_from_cpu=out_err, out_scale=scale, card_from_float64=card_f64, cpu_from_float64=cpu_f64,
                     running_stats=len(stats), running_stats_max_abs=stat_err, cpu_forward_s=cpu_s,
                     median_ms=1e3 * statistics.median(times), min_ms=1e3 * min(times),
                     peak_memory_gb=peak / 1e9, peak_above_inputs_gb=(peak - base) / 1e9)
        entries[name] = entry
        # the CPU test's rule (within 1e-5 of the largest output of the
        # float64 forward), or where float32 itself lies further at this
        # size, as the CPU's float32 forward does, within twice its distance
        out_tol = max(ZOO_OUT_REL * scale, 2.0 * cpu_f64)
        entry["out_tol_from_float64"] = out_tol
        if not (shapes_ok and finite and card_f64 <= out_tol and stats_ok):
            ok = False
    emit("zoo", n=n, batch=batch, size=size, tf32=tf32_settings(), models=entries, seconds=time.perf_counter() - t_phase)
    if not ok:
        raise SystemExit(f"zoo: a model on the card parts from its CPU forward: {entries}")
    return entries


HOST_LIB_IMAGES, HOST_LIB_SIZE, HOST_LIB_SEED = 16, (S, S), 21


def host_library_transforms(np, T, rng):
    """Every transform of the library, built on one Generator: name -> (the
    call, what it takes: the sample, the multilabel, one of its planes, or
    the image and the Generator)."""
    size = HOST_LIB_SIZE
    sample = {
        "train_chain": T.Compose([T.Resize(size), T.RandomScaleCrop(size, rng)]),
        "test_chain": T.Compose([T.Resize(size), T.Normalize()]),
        "Resize": T.Resize(size), "RandomCrop": T.RandomCrop(size, rng), "CenterCrop": T.CenterCrop(size),
        "RandomScaleCrop": T.RandomScaleCrop(size, rng), "Hflip": T.Hflip(rng), "RandomResize": T.RandomResize(rng=rng),
        "ResizeRatio": T.ResizeRatio(size[0]), "Rotate": T.Rotate(rng), "Blur": T.Blur(rng),
        "Sharpness": T.Sharpness(1.0, rng), "Solarize": T.Solarize(1.0, rng), "CutOut": T.CutOut(1.0, rng=rng),
        "GetPair": T.GetPair(rng=rng), "Normalize": T.Normalize(),
    }
    out = {name: (t, "sample") for name, t in sample.items()}
    out.update({"GetBoundary": (T.GetBoundary(), "multilabel"), "GetContourBg": (T.GetContourBg(), "multilabel"),
                "GetBoundary_Single": (T.GetBoundary_Single(), "plane"),
                "GetContourBg_Single": (T.GetContourBg_Single(), "plane")})
    for name in ("image_in_painting", "image_in_painting_constant", "image_in_painting_rand_constant",
                 "image_out_painting", "image_out_painting_constant", "image_out_painting_rand_constant"):
        out[name] = (getattr(T, name), "image")
    return out


def host_library_pair(np, T, img, mask, seed, index, times=None):
    """One pair through every transform, on its own Generator from (seed,
    index): the outputs as a flat list of arrays; each call's seconds into
    `times`."""
    rng = np.random.default_rng([seed, index])
    multilabel = T.fundus_multilabel(mask)
    args = {"sample": lambda: {"img": img, "mask": mask}, "multilabel": lambda: multilabel,
            "plane": lambda: multilabel[:, :, 1], "image": lambda: img}
    outs = []
    for name, (fn, takes) in host_library_transforms(np, T, rng).items():
        arg = args[takes]()
        t0 = time.perf_counter()
        y = fn(arg, rng) if takes == "image" else fn(arg)
        if times is not None:
            times.setdefault(name, []).append(time.perf_counter() - t0)
        if isinstance(y, dict):
            outs += [np.asarray(y[k]) for k in sorted(y)]
        else:
            outs += [np.asarray(v) for v in (y if isinstance(y, tuple) else (y,))]
    return outs


def phase_host_library(np, data_root):
    """The reference's transform library (data/transforms.py) on this
    machine's host, which has no PIL: HOST_LIB_IMAGES of png_tree's 800^2
    train images and masks (Domain1) through the training chain
    Compose([Resize(256^2), RandomScaleCrop(256^2)]), the test chain
    Compose([Resize(256^2), Normalize]) and every other transform once
    (Sharpness, Solarize and CutOut at p = 1), each pair on its own
    Generator from one seed.  The first run is timed transform by transform
    (mean ms an image, host clock); a second run from the same seed, over 8
    threads, must give every array equal."""
    from ramdsir_tpu_torch.data import png
    from ramdsir_tpu_torch.data import transforms as T
    from ramdsir_tpu_torch.ops.image import convert

    t_phase = time.perf_counter()
    base = os.path.join(data_root, "fundus", "Domain1", "train")
    pairs = [(convert(png.decode(os.path.join(base, "image", f"{i:03d}.png")), "RGB"),
              convert(png.decode(os.path.join(base, "mask", f"{i:03d}.png")), "L")) for i in range(HOST_LIB_IMAGES)]
    times = {}
    first = [host_library_pair(np, T, img, mask, HOST_LIB_SEED, i, times) for i, (img, mask) in enumerate(pairs)]
    run_s = time.perf_counter() - t_phase
    with ThreadPoolExecutor(8) as pool:
        second = list(pool.map(lambda a: host_library_pair(np, T, *a[1], HOST_LIB_SEED, a[0]), enumerate(pairs)))
    equal = sum(len(a) == len(b) and all(x.dtype == y.dtype and np.array_equal(x, y) for x, y in zip(a, b))
                for a, b in zip(first, second))
    train = first[0][:2]  # train_chain's img, mask
    chains_ok = train[0].shape == (S, S, 3) and train[0].dtype == np.uint8 and train[1].shape == (S, S)
    ms = {name: 1e3 * statistics.mean(t) for name, t in times.items()}  # a mean: Blur and Hflip skip half the images
    emit("host_library", images=HOST_LIB_IMAGES, source_size=list(pairs[0][0].shape), transforms=len(ms),
         ms_per_image=ms, ms_per_image_total=sum(ms.values()), arrays_per_pair=len(first[0]),
         runs_equal=f"{equal}/{HOST_LIB_IMAGES}", first_run_s=run_s, seconds=time.perf_counter() - t_phase)
    if equal != HOST_LIB_IMAGES or not chains_ok:
        raise SystemExit(f"host_library: {equal} of {HOST_LIB_IMAGES} pairs equal across two runs, chains ok {chains_ok}")
    return ms


def timed_call(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def phase_build(ram_mix, upsample, batch_norm, native):
    """Build K1's, K2/K3's and the batch norm's libraries and the two host
    libraries and, beside them, ask ptxas for each kernel's registers and
    spills (six nvcc and two g++ processes, started together)."""
    from ramdsir_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    sources = {"ram_mix": ram_mix.SOURCE, "upsample2x": upsample.SOURCE, "batch_norm": batch_norm.SOURCE}
    libraries = {"k1": ram_mix.LIBRARY, "k2": upsample.LIBRARY, "bn": batch_norm.LIBRARY, "host": native.POSTPROC,
                 "png": native.PNG}
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(len(libraries)) as pool:
        ptxas = {
            name: subprocess.Popen(
                [cuda_build.nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                 "-Xptxas", "-v", "-cubin", "-o", os.path.join(tmp, f"{name}.cubin"), src],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for name, src in sources.items()
        }
        try:
            builds = {k: pool.submit(timed_call, lib.path) for k, lib in libraries.items()}
            done = {k: f.result() for k, f in builds.items()}
            for lib in libraries.values():
                lib.load()
        finally:
            ptxas_out = "".join(p.communicate(timeout=600)[0] for p in ptxas.values())
    # ptxas prints each kernel's name, then its spills, then its registers
    info, kernel = {}, None
    for ln in ptxas_out.splitlines():
        if "Compiling entry function" in ln:
            found = re.search(r"(mix_[a-z_]+?_kernel|upsample2x_(?:backward|forward)_kernel|ramdsir_batch_norm_[a-z_]+_kernel)", ln)
            kernel = found.group(0) if found else ln.strip()
            if kernel.startswith("ramdsir_batch_norm"):  # <V>: 4 floats (16-byte) or 1 float a vector
                kernel += "<vector>" if "ILi4E" in ln else "<scalar>"
            elif kernel.startswith("mix_"):
                kernel += "<full>" if "ILb1E" in ln else "<delta>" if "ILb0ELb1E" in ln else "<band>" if "ILb0ELb0E" in ln else ""
            elif found:  # <dtype, V, vector path>
                kernel += ("<bfloat16" if "bfloat16" in ln else "<float32") + (", vector>" if "Lb1E" in ln else ", scalar>")
        elif kernel and ("registers" in ln or "spill" in ln):
            info.setdefault(kernel, []).append(ln.split(":", 1)[-1].strip())
    emit("build", library=os.path.relpath(done["k1"][0], REPO), seconds=time.perf_counter() - t0,
         k1_seconds=done["k1"][1], k2_library=os.path.relpath(done["k2"][0], REPO), k2_seconds=done["k2"][1],
         bn_library=os.path.relpath(done["bn"][0], REPO), bn_seconds=done["bn"][1],
         nvcc_flags=list(cuda_build.NVCC_FLAGS), ptxas=info, host_library=os.path.relpath(done["host"][0], REPO),
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
                if f.endswith((".pth", ".ckpt", ".nii.gz", ".png", ".npy")):
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
    from ramdsir_tpu_torch.ops import batch_norm
    from ramdsir_tpu_torch.ops import ram as tram
    from ramdsir_tpu_torch.ops import ram_mix, upsample

    phase_build(ram_mix, upsample, batch_norm, native)
    phase_cuda_tests()
    kernels = phase_kernel(torch, tram, ram_mix, bw)
    bn_sums = phase_batch_norm(torch, bw)
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
    prostate_bf16_run = phase_prostate_path(torch, np, ram_mix, prostate, data_root, bf16_beside=prostate_run)
    phase_prostate_eval_cli(torch, np, data_root)
    png_run = phase_png_tree(torch, np, ram_mix)
    host_runs = phase_host_loader(torch, np, ram_mix, png_run, prostate, data_root)
    _, k2_shapes, k3_shapes = phase_deterministic(torch, np, ram_mix, arrays, testset, prostate, data_root)
    k2, k3 = phase_k2(torch, bw, k2_shapes, k3_shapes)
    _, variant_launches = phase_variants(torch, np, ram_mix, arrays, testset, prostate, data_root, runs["default"])
    _, ddp_launches = phase_ddp(torch, np, ram_mix, arrays, testset, data_root)
    phase_host_library(np, os.path.join(PNG_OUT, "data"))
    phase_zoo(torch, np)

    phase_profile(torch, ram_mix, arrays, prostate)
    scan = phase_scan(torch, np, ram_mix, arrays, testset, prostate, data_root, card)
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
        # launches: the run at this entry's shape; the fundus variant runs
        # (some at other batches) only in launches_by_run
        scan_runs = {f"scan_fundus_{m}": e["k1"] for m, e in scan["bit_equality"]["fundus"]["launches"].items()}
        variants = {**variant_launches["fundus"], **ddp_launches["fundus"], **scan_runs} if run == "default" else {}
        if run == "ram_use_pallas":  # the host loaders' batches carry donor images: full mode
            variants = {name: r["k1_launches"] for name, r in host_runs.items()}
        line["kernels"].append({
            "name": f"ram_mix[{label}]", "route": "cuda", "source": SOURCE_REL, "replaces": REPLACES,
            "launches": runs[run]["k1_launches"],
            "launches_by_run": {run: runs[run]["k1_launches"], **variants},
            "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "library_ms": None, "floor_ms": k["floor_ms"], "kernel_ms": k["kernel_ms"],
            "ms_clean_flush": k["ms_clean_flush"], "floor_ms_clean_flush": k["floor_ms_clean_flush"], "path": k["path"],
        })
    k = kernels[f"delta@{PS}x{PS}"]
    line["kernels"].append({
        "name": f"ram_mix[band,delta]@prostate {PB}x{C}x{PS}x{PS}", "route": "cuda", "source": SOURCE_REL,
        "replaces": REPLACES, "launches": prostate_run["k1_launches"],
        "launches_by_run": {"prostate": prostate_run["k1_launches"], **variant_launches["prostate"],
                            **ddp_launches["prostate"],
                            **{f"scan_prostate_{m}": e["k1"]
                               for m, e in scan["bit_equality"]["prostate"]["launches"].items()}},
        "max_abs_err": k["max_abs_err"], "ms": k["ms"],
        "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"], "bound_by": k["bound_by"], "library_ms": None,
        "floor_ms": k["floor_ms"], "kernel_ms": k["kernel_ms"], "ms_clean_flush": k["ms_clean_flush"],
        "floor_ms_clean_flush": k["floor_ms_clean_flush"], "path": k["path"],
    })
    # K2 and K3: the sum over the 8 launches of one step (each shape once a
    # step), with the launches of each main path run, and the largest shape alone
    train_runs = {"fundus": runs["default"], "fundus_bf16": runs["bf16"], "prostate": prostate_run,
                  "prostate_bf16": prostate_bf16_run}
    for kernel, cases, shapes, launches in (("upsample2x_backward", k2, k2_shapes, "k2"),
                                            ("upsample2x_forward", k3, k3_shapes, "k3")):
        for run, entry in train_runs.items():
            dtype = "bfloat16" if run.endswith("bf16") else "float32"
            step_cases = [cases[f"{'x'.join(map(str, shape))}:{dtype}"] for shape, dt in shapes
                          if str(dt).endswith(dtype) and (shape[0] in (B, 2 * B)) == run.startswith("fundus")]
            if len(step_cases) != 8:
                raise SystemExit(f"{kernel}: {len(step_cases)} shapes in a {run} step, expected 8")
            total = lambda key: sum(c[key] for c in step_cases)
            line["kernels"].append({
                "name": f"{kernel}[{run} step: 8 shapes]", "route": "cuda", "source": SOURCE_K2,
                "replaces": REPLACES_K2, "launches": entry[f"{launches}_launches"],
                "eval_launches": entry[f"{launches}_eval_launches"],
                "max_abs_err": max(c["max_abs_err"] for c in step_cases), "ms": total("ms"),
                "plain_ms": total("plain_ms"), "bound_ms": total("bound_ms"), "bound_by": "bytes",
                "library_ms": total("library_ms"), "kernel_ms": total("kernel_ms"),
                "library_kernel_ms": total("library_kernel_ms"), "shapes": [c["shape"] for c in step_cases],
            })
        big = cases[f"{2 * B}x32x{S // 2}x{S // 2}:float32"]
        line["kernels"].append({
            "name": f"{kernel}[{2 * B}x32x{S // 2}x{S // 2} float32]", "route": "cuda", "source": SOURCE_K2,
            "replaces": REPLACES_K2, "launches": runs["default"][f"{launches}_launches"] // 8,
            **{k: big[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "kernel_ms",
                                   "library_kernel_ms")},
        })
    # the batch norm: a step's norms summed, launches per step from the
    # float32 main path and prostate runs (4 kernels a norm a step)
    for config, run in (("fundus", runs["default"]), ("prostate", prostate_run)):
        sums = bn_sums[config]
        line["kernels"].append({
            "name": f"batch_norm[{config} step: {sums['norms']} norms]", "route": "cuda",
            "source": "ramdsir_tpu_torch/csrc/batch_norm.cu", "replaces": None, "launches": run["bn_launches"],
            "ms": sums["kernels_ms"], "plain_ms": sums["plain_ms"], "bound_ms": sums["bound_ms"], "bound_by": "bytes",
            "library_ms": sums["library_ms"], "roofline": sums["roofline"],
        })
    print(card, flush=True)
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
