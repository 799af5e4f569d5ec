// K1: the RAM amplitude band-mix (Random Amplitude Mixup) for NVIDIA Hopper, sm_90a.
//
// Replaces the TPU kernel ramdsir_tpu/ops/ram_pallas.py::_mix_kernel (one
// pl.pallas_call grid step per (B*C) plane, launched by _mix_planes) and the
// same arithmetic in ramdsir_tpu/ops/ram.py (_mix_spectrum, _mix_block and the
// delta form of ram_mixup_banded_dft).  Per complex element z = (re, im) of
// an rfft2 half-spectrum, with the sample's ratio r:
//
//   amp_s = sqrt(re*re + im*im)
//   new   = r*amp_s + (1-r)*amp_t   inside the band,  amp_s outside it
//   f     = new / max(amp_s, FLT_MIN)
//   z'    = z*f,  or (new, 0) where amp_s == 0
//   delta mode writes z' - z instead: z*(f-1), or (new, 0) where amp_s == 0
//
// In unshifted rfft2 coordinates the band is rows [0..b] u [h-b..h-1] x cols
// [0..b] (ramdsir_tpu/ops/ram.py:76-80); it is tested from the indices, no
// mask is loaded.
//
// It is an elementwise pass of about 10 flops per element against 8-20 bytes,
// far below the ~20 flop/byte at which f32 arithmetic would limit the H100,
// and there is no matrix product in it: the tensor cores (wgmma) have nothing
// to do.  What bounds each mode on this card:
//
// * Full mode (ram_mixup; 48 planes of 256 x 129 on the main path): bytes.
//   The mix is in place, and out of the band a finite non-zero amplitude
//   gives z*(amp/amp) = z bit for bit, so the least traffic is one read of
//   the spectrum plus the band's writes and donor amplitudes (13.4 MB, 4.0 us
//   at 3.35 TB/s).  mix_full_vec_kernel reads the interleaved complex tensor
//   as one flat array of float4, two complex elements a thread, with
//   evict-first loads (each line is read once).  Row and column come from
//   the flat index by multiply-add-shift division, once a pair; the sample
//   and channel only in the band.  The band test needs only the indices, so
//   an in-band element's donor amplitude and ratio are loaded beside the
//   spectrum, before any arithmetic: one DRAM round trip.  Out of the band
//   it stores nothing unless the amplitude is 0 or not finite; 0 also covers
//   |re|, |im| below 2^-75, whose squares underflow, which the TPU kernel
//   sets to (0, 0).  The grid covers the spectrum, one float4 a thread, and
//   the hardware schedules the blocks.  On the card a plain read of the
//   same spectrum takes the same time this way as a resident wave walking
//   four float4 a thread, and as with plain loads, when L2 is clean; when L2
//   holds dirty lines, as after the FFTs that write the spectrum, this way
//   and evict-first are the faster (tools/k1_study.py).  Even that read
//   spends a fixed part of its time filling and draining the card, which no
//   layout of the work removes at 12.7 MB; what full mode spends above it is
//   the band test's index work, the band's donor gathers and its stores.
// * Band and delta modes (63,648 elements, 1.27 MB, 0.38 us of bytes): the
//   latency of one launch and of the DRAM round trip inside it.  Each thread
//   of mix_strided_kernel (band mode, and any layout the other kernels do not
//   take) and mix_delta_flat_kernel (the DFT path's compact planar blocks,
//   read at their flat index) issues the loads of z, the donor amplitude and
//   the ratio together, so it waits for DRAM once.  At 128 threads a block
//   the band is ~500 blocks, all resident at once on 132 SMs.
//
// No TMA and no shared memory: each byte is used once by the thread that
// loads it, and enough resident threads keep the memory system busy without
// staging.
//
// IEEE arithmetic throughout (no --use_fast_math; the explicit _rn
// intrinsics also stop the compiler contracting r*a + (1-r)*b into an FMA):
// the out-of-band and ratio-1 identities rely on amp/amp == 1 exactly, so
// ratio 1 leaves the spectrum unchanged and the delta exactly 0, and every
// path equals the plain PyTorch version bit for bit.

#include <cfloat>
#include <cmath>
#include <cuda_runtime.h>

namespace {

// Unsigned division by a divisor fixed at launch, as a multiply, an add and
// a shift (the round-up method of Granlund and Montgomery); exact for
// 0 <= x < 2^31, where the add cannot overflow.
struct FastDiv {
  unsigned d, mul, shr;
  __device__ __forceinline__ unsigned div(unsigned x) const { return (__umulhi(x, mul) + x) >> shr; }
};

FastDiv fast_div(unsigned d) {
  unsigned l = 0;
  while ((1ull << l) < d) ++l;  // ceil(log2(d))
  return FastDiv{d, static_cast<unsigned>((1ull << 32) * ((1ull << l) - d) / d + 1), l};
}

struct Strides {
  long long n, c, h, w;
};

// Where an element sits: sample, channel, row and column of its iteration
// space (the full (H, Wh) plane, or the (2b+1, b+1) band).
struct Pos {
  unsigned n, ch, row, col;
};

struct Grid {
  FastDiv rows, cols, c;
  unsigned count;  // elements in the iteration space

  __device__ __forceinline__ Pos locate(unsigned e) const {
    const unsigned t = cols.div(e);
    const unsigned plane = rows.div(t);
    const unsigned n = c.div(plane);
    return Pos{n, plane - n * c.d, t - plane * rows.d, e - t * cols.d};
  }
};

__device__ __forceinline__ long long offset(const Strides& s, unsigned n, unsigned ch, unsigned row,
                                            unsigned col) {
  return n * s.n + ch * s.c + row * s.h + col * s.w;
}

__device__ __forceinline__ float sq_sum(float re, float im) {
  return __fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im));
}

// The mixed element (or its change, DELTA) from z and its squared amplitude.
template <bool DELTA>
__device__ __forceinline__ float2 mix(float re, float im, float ss, bool in_band, float amp_t, float r) {
  const float amp_s = __fsqrt_rn(ss);
  const float new_amp =
      in_band ? __fadd_rn(__fmul_rn(r, amp_s), __fmul_rn(__fsub_rn(1.0f, r), amp_t)) : amp_s;
  if (amp_s == 0.0f) return make_float2(new_amp, 0.0f);
  float f = __fdiv_rn(new_amp, fmaxf(amp_s, FLT_MIN));
  if (DELTA) f = __fsub_rn(f, 1.0f);
  return make_float2(__fmul_rn(re, f), __fmul_rn(im, f));
}

// Out of the band, z maps to itself bit for bit unless 0 < amp_s < inf fails.
__device__ __forceinline__ bool changes(bool in_band, float ss) {
  return in_band || !(ss > 0.0f && ss < INFINITY);
}

struct MixArgs {
  const float* re;
  const float* im;
  const float* amp_t;
  const float* ratio;
  float* out_re;
  float* out_im;
  Strides s;  // spectrum planes (re and im share strides)
  Strides a;  // donor amplitude
  Strides o;  // outputs
  Grid g;     // iteration space
  unsigned band;    // b = floor(min(h, w) * L)
  unsigned height;  // spectrum rows; band rows past b sit at +height-(2b+1)
  unsigned long long* launches;  // the wrapper's device counter of this path, or null
};

// One count a launch, by the grid's first thread, so that a run can read
// how often the kernel ran, CUDA graph replays included.
__device__ __forceinline__ void count_launch(const MixArgs& a) {
  if (a.launches != nullptr && blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(a.launches, 1ull);
}

__device__ __forceinline__ bool in_band_rows(const MixArgs& a, unsigned row) {
  return row <= a.band || row >= a.height - a.band;
}

__device__ __forceinline__ bool in_full_band(const MixArgs& a, const Pos& p) {
  return p.col <= a.band && in_band_rows(a, p.row);
}

__device__ __forceinline__ unsigned band_row(const MixArgs& a, unsigned r_idx) {
  return r_idx <= a.band ? r_idx : r_idx + a.height - (2 * a.band + 1);
}

constexpr int kThreads = 128;

// The full mode's mix of one complex element in place: stores only if it changes.
__device__ __forceinline__ void mix_full_one(const MixArgs& a, float* zf, const Pos& p) {
  const bool in = in_full_band(a, p);
  const float at = in ? __ldg(a.amp_t + offset(a.a, p.n, p.ch, p.row, p.col)) : 0.0f;
  const float r = in ? __ldg(a.ratio + p.n) : 0.0f;
  const float re = zf[0], im = zf[1];
  const float ss = sq_sum(re, im);
  if (changes(in, ss)) {
    const float2 m = mix<false>(re, im, ss, in, at, r);
    zf[0] = m.x;
    zf[1] = m.y;
  }
}

// The donor amplitude and ratio of a full-mode element, from its plane.
__device__ __forceinline__ void load_donor(const MixArgs& a, unsigned plane, unsigned row, unsigned col,
                                           float& amp_t, float& r) {
  const unsigned n = a.g.c.div(plane);
  amp_t = __ldg(a.amp_t + offset(a.a, n, plane - n * a.g.c.d, row, col));
  r = __ldg(a.ratio + n);
}

// Full mode on one contiguous interleaved complex spectrum, 16-byte aligned:
// one float4 (two complex elements) a thread.
__global__ void __launch_bounds__(kThreads) mix_full_vec_kernel(const MixArgs a) {
  count_launch(a);
  const unsigned i = blockIdx.x * kThreads + threadIdx.x;
  const unsigned e = 2 * i;
  if (e >= a.g.count) return;
  if (e + 1 == a.g.count) {  // an odd element count leaves one element past the last float4
    mix_full_one(a, a.out_re + 2 * e, a.g.locate(e));
    return;
  }
  float4* zp = reinterpret_cast<float4*>(a.out_re) + i;
  const float4 v = __ldcs(zp);
  // (plane, row, col) of the pair's first element; the second is the next
  // column, or column 0 of the next row
  const unsigned t = a.g.cols.div(e);
  const unsigned col = e - t * a.g.cols.d;
  const unsigned plane = a.g.rows.div(t);
  const unsigned row = t - plane * a.g.rows.d;
  const bool wrap = col + 1 == a.g.cols.d;
  const unsigned row1 = wrap ? (row + 1 == a.g.rows.d ? 0 : row + 1) : row;
  const unsigned plane1 = wrap && row1 == 0 ? plane + 1 : plane;
  const unsigned col1 = wrap ? 0 : col + 1;
  const bool in0 = col <= a.band && in_band_rows(a, row);
  const bool in1 = col1 <= a.band && in_band_rows(a, row1);
  // the in-band elements' donor loads go out beside the pair's, before any arithmetic
  float t0 = 0.0f, r0 = 0.0f, t1 = 0.0f, r1 = 0.0f;
  if (in0) load_donor(a, plane, row, col, t0, r0);
  if (in1) load_donor(a, plane1, row1, col1, t1, r1);
  const float ss0 = sq_sum(v.x, v.y);
  const float ss1 = sq_sum(v.z, v.w);
  const bool w0 = changes(in0, ss0), w1 = changes(in1, ss1);
  if (!(w0 || w1)) return;  // both elements map to themselves
  float4 out = v;
  if (w0) {
    const float2 m = mix<false>(v.x, v.y, ss0, in0, t0, r0);
    out.x = m.x;
    out.y = m.y;
  }
  if (w1) {
    const float2 m = mix<false>(v.z, v.w, ss1, in1, t1, r1);
    out.z = m.x;
    out.w = m.y;
  }
  *zp = out;
}

// Delta mode on the DFT path's compact planar (N, C, 2b+1, b+1) blocks, all
// contiguous: one element a thread at its flat index, so the loads of z go
// out before the index arithmetic that the donor's load waits for.
__global__ void __launch_bounds__(kThreads) mix_delta_flat_kernel(const MixArgs a) {
  count_launch(a);
  const unsigned e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= a.g.count) return;
  const Pos p = a.g.locate(e);
  const float re = __ldg(a.re + e);
  const float im = __ldg(a.im + e);
  const float at = __ldg(a.amp_t + offset(a.a, p.n, p.ch, p.row, p.col));
  const float r = __ldg(a.ratio + p.n);
  const float2 m = mix<true>(re, im, sq_sum(re, im), true, at, r);
  a.out_re[e] = m.x;
  a.out_im[e] = m.y;
}

// Any layout, by element strides: one thread per element.  re/im may alias
// one complex tensor; the delta output is a compact block.  Band mode in
// place on the interleaved spectrum takes this path too.
template <bool FULL, bool DELTA>
__global__ void __launch_bounds__(kThreads) mix_strided_kernel(const MixArgs a) {
  count_launch(a);
  const unsigned e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= a.g.count) return;
  const Pos p = a.g.locate(e);
  const unsigned row = FULL ? p.row : band_row(a, p.row);
  const long long si = offset(a.s, p.n, p.ch, row, p.col);
  const bool in_band = !FULL || in_full_band(a, p);
  const float re = a.re[si];
  const float im = a.im[si];
  const float at = in_band ? __ldg(a.amp_t + offset(a.a, p.n, p.ch, p.row, p.col)) : 0.0f;
  const float r = __ldg(a.ratio + p.n);
  const float ss = sq_sum(re, im);
  if (FULL && !changes(in_band, ss)) return;
  const float2 m = mix<DELTA>(re, im, ss, in_band, at, r);
  // in place writes back to the spectrum row; delta writes a compact block
  const long long oi = offset(a.o, p.n, p.ch, DELTA ? p.row : row, p.col);
  a.out_re[oi] = m.x;
  a.out_im[oi] = m.y;
}

enum Path { kStrided = 0, kFullVec = 1, kDeltaFlat = 2 };

}  // namespace

extern "C" int ram_mix_launch(int path, const float* re, const float* im, const float* amp_t,
                              const float* ratio, float* out_re, float* out_im,
                              long long s_n, long long s_c, long long s_h, long long s_w,
                              long long a_n, long long a_c, long long a_h, long long a_w,
                              long long o_n, long long o_c, long long o_h, long long o_w,
                              int n, int c, int rows, int cols, int band, int height,
                              int full, int delta, unsigned long long* launches, void* stream) {
  MixArgs args;
  args.re = re;
  args.im = im;
  args.amp_t = amp_t;
  args.ratio = ratio;
  args.out_re = out_re;
  args.out_im = out_im;
  args.s = Strides{s_n, s_c, s_h, s_w};
  args.a = Strides{a_n, a_c, a_h, a_w};
  args.o = Strides{o_n, o_c, o_h, o_w};
  args.g = Grid{fast_div(rows), fast_div(cols), fast_div(c),
                static_cast<unsigned>(n) * c * rows * cols};
  args.band = band;
  args.height = height;
  args.launches = launches;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // one thread per element, or per pair of elements in full_vec
  const unsigned units = path == kFullVec ? (args.g.count + 1) / 2 : args.g.count;
  const dim3 grid((units + kThreads - 1) / kThreads);

  switch (path) {
    case kFullVec:
      mix_full_vec_kernel<<<grid, kThreads, 0, st>>>(args);
      break;
    case kDeltaFlat:
      mix_delta_flat_kernel<<<grid, kThreads, 0, st>>>(args);
      break;
    case kStrided:
      if (full) {
        mix_strided_kernel<true, false><<<grid, kThreads, 0, st>>>(args);
      } else if (delta) {
        mix_strided_kernel<false, true><<<grid, kThreads, 0, st>>>(args);
      } else {
        mix_strided_kernel<false, false><<<grid, kThreads, 0, st>>>(args);
      }
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
