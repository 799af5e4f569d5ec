// RAM amplitude band-mix (Random Amplitude Mixup) for NVIDIA Hopper, sm_90a.
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
// What bounds it: memory.  Each element costs a handful of flops against
// 16-20 bytes of traffic (re, im read; amp_t read in the band; re, im
// written), far below the ~20 flop/byte the H100 needs before arithmetic
// limits f32 work.  The design therefore only tries to touch each byte once:
//   * no fold/unfold transposes (ram_pallas.py:71-82): the kernel takes the
//     real and imaginary planes by pointer and element strides, so it works
//     in place on torch.view_as_real of a complex spectrum (re at offset 0,
//     im at offset 1, stride 2) or on the separate zr/zi blocks of the DFT
//     path alike;
//   * no band mask is loaded: in unshifted rfft2 coordinates the band is
//     rows [0..b] u [h-b..h-1] x cols [0..b] (ramdsir_tpu/ops/ram.py:76-80),
//     tested from the indices;
//   * band mode visits only the (2b+1) x (b+1) in-band index space, and the
//     donor amplitude arrives already restricted to it.
// One thread per complex element; blockIdx.y is the (sample, channel) plane,
// so the only integer division per element is by the row length.
//
// IEEE arithmetic throughout (no --use_fast_math; the explicit _rn
// intrinsics also stop the compiler contracting r*a + (1-r)*b into an FMA):
// the out-of-band and ratio-1 identities rely on amp/amp == 1 exactly, so
// ratio 1 leaves the spectrum unchanged and the delta exactly 0.

#include <cfloat>
#include <cuda_runtime.h>

namespace {

struct Strides {
  long long n, c, h, w;
};

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
  int n, c, rows, cols;  // iteration space: full (H, Wh) or band (2b+1, b+1)
  int band;              // b = floor(min(h, w) * L)
  int height;            // spectrum rows; band rows past b sit at +height-(2b+1)
  int full;
  int delta;
};

__global__ void ram_mix_kernel(const MixArgs a) {
  const int plane = blockIdx.y;
  const int b = plane / a.c;
  const int ch = plane - b * a.c;
  const int plane_elems = a.rows * a.cols;
  const int row_off = a.height - (2 * a.band + 1);
  const float r = a.ratio[b];
  const float one_minus_r = __fsub_rn(1.0f, r);
  const long long s0 = b * a.s.n + ch * a.s.c;
  const long long a0 = b * a.a.n + ch * a.a.c;
  const long long o0 = b * a.o.n + ch * a.o.c;

  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < plane_elems;
       e += gridDim.x * blockDim.x) {
    const int r_idx = e / a.cols;
    const int k = e - r_idx * a.cols;
    // spectrum row of this element: band rows past b map to [h-b..h-1]
    const int row = (a.full || r_idx <= a.band) ? r_idx : r_idx + row_off;
    const long long si = s0 + row * a.s.h + k * a.s.w;
    const float re = a.re[si];
    const float im = a.im[si];
    const float amp_s = __fsqrt_rn(__fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im)));
    const bool in_band =
        !a.full || ((row <= a.band || row >= a.height - a.band) && k <= a.band);
    float new_amp = amp_s;
    if (in_band) {
      const float amp_t = a.amp_t[a0 + r_idx * a.a.h + k * a.a.w];
      new_amp = __fadd_rn(__fmul_rn(r, amp_s), __fmul_rn(one_minus_r, amp_t));
    }
    const float f = __fdiv_rn(new_amp, fmaxf(amp_s, FLT_MIN));
    float out_re, out_im;
    if (amp_s == 0.0f) {
      out_re = new_amp;
      out_im = 0.0f;
    } else if (a.delta) {
      const float g = __fsub_rn(f, 1.0f);
      out_re = __fmul_rn(re, g);
      out_im = __fmul_rn(im, g);
    } else {
      out_re = __fmul_rn(re, f);
      out_im = __fmul_rn(im, f);
    }
    // in place writes back to the spectrum row; delta writes a compact block
    const long long oi = o0 + (a.delta ? r_idx : row) * a.o.h + k * a.o.w;
    a.out_re[oi] = out_re;
    a.out_im[oi] = out_im;
  }
}

}  // namespace

extern "C" int ram_mix_launch(const float* re, const float* im, const float* amp_t,
                              const float* ratio, float* out_re, float* out_im,
                              long long s_n, long long s_c, long long s_h, long long s_w,
                              long long a_n, long long a_c, long long a_h, long long a_w,
                              long long o_n, long long o_c, long long o_h, long long o_w,
                              int n, int c, int rows, int cols, int band, int height,
                              int full, int delta, void* stream) {
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
  args.n = n;
  args.c = c;
  args.rows = rows;
  args.cols = cols;
  args.band = band;
  args.height = height;
  args.full = full;
  args.delta = delta;

  const int threads = 256;
  const int plane_elems = rows * cols;
  int blocks_x = (plane_elems + threads - 1) / threads;
  if (blocks_x > 65535) blocks_x = 65535;  // the loop covers the rest
  const dim3 grid(blocks_x, n * c);
  ram_mix_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(args);
  return static_cast<int>(cudaGetLastError());
}
