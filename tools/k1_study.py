#!/usr/bin/env python3
"""K1's code paths against each other and against a plain read, on one
NVIDIA GPU: `python3 tools/k1_study.py` from the repository's root.

At the main path's shapes (16x3 planes of 256^2, b = 25; the `@256x256`
cases of `chip_smoke.kernel_cases`):

  path     each K1 mode through every code path that can take its layout:
           the one `mix_spectrum` picks and `strided`
  ceiling  a float4 read of the same interleaved spectrum by a kernel that
           reads and does nothing else (`READ_SRC`, built here): evict-first
           against plain loads, one float4 a thread against a resident wave
           walking four a thread by a grid-stride loop
  sweep    the evict-first, one-a-thread read over 1x to 16x the spectrum's
           bytes; a least-squares line through its kernel times splits them
           into a fixed cost and a streaming rate
  floor    an empty launch

Each under both L2 flushes of `chip_smoke.py`: `dirty` (zeroing 128 MB, as
its `ms` is timed, leaves dirty lines whose write-back the timed kernel pays)
and `clean` (reading them). `ms` is CUDA events around one call, `kernel_ms`
the kernel alone from torch.profiler. One JSON line per reading, on stdout and in
chiprun_out/k1_study/study.jsonl.
"""
import ctypes
import json
import os
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "chiprun_out", "k1_study")

READ_SRC = r"""
#include <cuda_runtime.h>

// The value a load can never return on the study's data: a store on it
// keeps the load, and never happens.
__device__ __forceinline__ void keep(const float4& v, float4* sink) {
  if (v.x == -12345.0f && v.w == -12345.0f) *sink = v;
}

template <bool EVICT_FIRST>
__device__ __forceinline__ float4 load(const float4* p) {
  return EVICT_FIRST ? __ldcs(p) : *p;
}

template <bool EVICT_FIRST>
__global__ void __launch_bounds__(128) ceiling_one_kernel(const float4* p, unsigned n, float4* sink) {
  const unsigned i = blockIdx.x * 128 + threadIdx.x;
  if (i < n) keep(load<EVICT_FIRST>(p + i), sink);
}

template <bool EVICT_FIRST>
__global__ void __launch_bounds__(128) ceiling_wave_kernel(const float4* p, unsigned n, float4* sink) {
  const unsigned stride = gridDim.x * 128;
  for (unsigned i = blockIdx.x * 128 + threadIdx.x; i < n; i += 4 * stride) {
    float4 v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = i + k * stride < n ? load<EVICT_FIRST>(p + i + k * stride) : float4{};
#pragma unroll
    for (int k = 0; k < 4; ++k) keep(v[k], sink);
  }
}

extern "C" int ceiling_launch(int variant, const void* p, unsigned n, void* sink, int sms, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float4* in = static_cast<const float4*>(p);
  float4* out = static_cast<float4*>(sink);
  const unsigned one = (n + 127) / 128, wave = 16 * sms;  // 16 blocks of 128 fill an SM's 2,048 threads
  switch (variant) {
    case 0: ceiling_one_kernel<true><<<one, 128, 0, st>>>(in, n, out); break;
    case 1: ceiling_one_kernel<false><<<one, 128, 0, st>>>(in, n, out); break;
    case 2: ceiling_wave_kernel<true><<<wave, 128, 0, st>>>(in, n, out); break;
    case 3: ceiling_wave_kernel<false><<<wave, 128, 0, st>>>(in, n, out); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
"""
CEILINGS = {  # variant code, kernel-name key
    "one_evict_first": (0, "ceiling_one"),
    "one_plain": (1, "ceiling_one"),
    "wave4_evict_first": (2, "ceiling_wave"),
    "wave4_plain": (3, "ceiling_wave"),
}
SWEEP = (1, 2, 4, 8, 16)


def build_ceiling(tmp):
    """The ceiling kernels' launch function, built from READ_SRC as the port's kernels are."""
    from ramdsir_tpu_torch.native.build import Library
    from ramdsir_tpu_torch.ops import cuda_build

    src = os.path.join(tmp, "ceiling.cu")
    with open(src, "w") as f:
        f.write(READ_SRC)
    args = [ctypes.c_int, ctypes.c_void_p, ctypes.c_uint, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    lib = Library(src, cuda_build.nvcc(), cuda_build.NVCC_FLAGS, {"ceiling_launch": (ctypes.c_int, args)})
    return lib.load().ceiling_launch


def main():
    import torch

    if not torch.cuda.is_available():
        print("k1_study: CUDA is not available; this script runs on the card", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import chip_smoke as smoke
    from ramdsir_tpu_torch.ops import ram as tram
    from ramdsir_tpu_torch.ops import ram_mix

    os.makedirs(OUT, exist_ok=True)
    log = open(os.path.join(OUT, "study.jsonl"), "w")

    def emit(**kw):
        line = json.dumps(kw)
        print(line, flush=True)
        log.write(line + "\n")

    card = smoke.nvidia_smi_line()
    bw = smoke.peak_bandwidth(torch.cuda.get_device_name(0))
    emit(kind="device", nvidia_smi=card, torch=torch.__version__, cuda=torch.version.cuda, peak_bytes_per_s=bw)
    flush_buf = torch.empty(128 * 2**20, dtype=torch.uint8, device="cuda")
    flushes = {"dirty": lambda: flush_buf.zero_(), "clean": lambda: flush_buf.sum()}

    def timings(fn, key):
        out = {}
        for fname, flush in flushes.items():
            out[f"ms_{fname}"] = smoke.cuda_time_ms(fn, flush=flush)
            out[f"kernel_ms_{fname}"] = smoke.kernel_time_ms(fn, key, flush=flush)
        return out

    emit(kind="floor", **timings(lambda: torch.cuda._sleep(1), "spin"))

    gen = torch.Generator(device="cuda").manual_seed(0)
    spectrum = None
    for name, case in smoke.kernel_cases(torch, tram, ram_mix, gen):
        if not name.endswith(f"@{smoke.S}x{smoke.S}"):
            continue
        z = case["z"].clone()
        if case["delta"]:
            re, im = z.real.contiguous(), z.imag.contiguous()
            out = (torch.empty_like(re), torch.empty_like(im))
        else:
            zv = torch.view_as_real(z)
            re, im = zv[..., 0], zv[..., 1]
            out = (re, im)
            if case["full"]:
                spectrum = z
        own = ram_mix._path(ram_mix._layout(re, im), case["full"], case["delta"], compact=case["delta"])
        for path in dict.fromkeys((own, "strided")):
            fn = lambda path=path: ram_mix._launch(path, re, im, case["amp"], case["ratio"], case["band"], *out,
                                                   full=case["full"], delta=case["delta"])
            emit(kind="path", mode=case["mode"], path=path, picked=path == own, **timings(fn, "mix_"))

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    sink = torch.empty(4, device="cuda")
    stream = lambda: torch.cuda.current_stream().cuda_stream
    with tempfile.TemporaryDirectory() as tmp:
        launch = build_ceiling(tmp)

    def read(variant, data):
        n = data.numel() // 4
        return lambda: launch(variant, data.data_ptr(), n, sink.data_ptr(), sms, stream())

    flat = torch.view_as_real(spectrum).reshape(-1)  # the full-mode spectrum, 12.7 MB
    nbytes = flat.numel() * 4
    for cname, (variant, key) in CEILINGS.items():
        emit(kind="ceiling", variant=cname, bytes=nbytes, **timings(read(variant, flat), key))
    points = []
    for mult in SWEEP:
        data = flat if mult == 1 else torch.rand(mult * flat.numel(), generator=gen, device="cuda")
        t = timings(read(0, data), "ceiling_one")
        points.append((mult * nbytes, t["kernel_ms_clean"]))
        emit(kind="sweep", bytes=mult * nbytes, rate_clean=mult * nbytes / (1e-3 * t["kernel_ms_clean"]), **t)
    # kernel_ms = fixed + bytes / rate, least squares over the sweep
    n = len(points)
    mx, my = sum(p[0] for p in points) / n, sum(p[1] for p in points) / n
    slope = sum((x - mx) * (y - my) for x, y in points) / sum((x - mx) ** 2 for x, _ in points)
    emit(kind="fit", flush="clean", fixed_ms=my - slope * mx, rate_bytes_per_s=1e3 / slope, peak_bytes_per_s=bw,
         points=points)
    print(card, flush=True)
    log.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
