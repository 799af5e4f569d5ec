// K2: the deterministic backward of the bilinear x2 upsample (align_corners
// False, half-pixel centres) for NVIDIA Hopper, sm_90a.
//
// The forward is F.interpolate(x, scale_factor=2, mode="bilinear",
// align_corners=False), the U-Net's up-stages (models/unet.py), which the
// JAX package computes with jax.image.resize (ramdsir_tpu/models/unet.py:73-76).
// Its VJP there is an XLA computation, not a Pallas kernel: K2 has no TPU
// counterpart.  It exists because torch's CUDA backward of that upsample
// scatters every output gradient into its input neighbours with atomicAdd,
// so two steps from one state part in the last bits, and under
// torch.use_deterministic_algorithms(True) torch refuses to run it.
//
// Per axis of n inputs and 2n outputs, after torch's clamp of the source
// coordinate at 0, output 2k takes 0.25 of input k-1 and 0.75 of input k
// (output 0: 1 of input 0), and output 2k+1 takes 0.75 of input k and 0.25
// of input k+1 (output 2n-1: 0.75 + 0.25 of input n-1).  Transposed, the
// gradient of input i gathers, in this order, the outputs
//   2i-1 (0.25, if i >= 1), 2i (0.75; 1 if i == 0),
//   2i+1 (0.75; 1 if i == n-1), 2i+2 (0.25, if i <= n-2),
// and the 2-D gradient is that gather along the columns of each gathered
// row, then along the rows: at most 4 x 4 output gradients, fixed weights
// from {1, 0.75, 0.25}.  A gather, not a scatter: no atomics, one thread per
// input element, so each result is a fixed sum in a fixed order.
//
// What bounds it on this card: bytes.  It reads the output gradient once
// (4 elements an input element) and writes the input gradient once, ~2
// flops a byte read at most, far below the ~20 flop/byte at which float32
// arithmetic would limit the H100.  The threads of a warp take neighbouring
// columns of one row, so their reads of each gathered output row and their
// write are coalesced; the overlap of neighbouring threads' 4-column windows
// is served by L1.  No shared memory and no tensor cores (no matrix
// product).  A first, simple kernel: tiling rows through shared memory and
// vector loads are later work.
//
// Numerics: float32 and bfloat16 gradients, accumulated in float32 with the
// _rn intrinsics (no FMA contraction, no fast math) in the order above, and
// rounded once to the gradient's type, so it is bit-equal to its plain
// version (ops/upsample.py::upsample2x_backward_plain).
//
// Layout: NCHW contiguous gradients in and out; the wrapper refuses others.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// Tap k (0..3) of input i on an axis of n inputs: output 2i-1+k, its weight,
// and whether it exists.  Fully unrolled at every call, so the taps live in
// registers (an indexed array of them went to local memory).
__device__ __forceinline__ bool tap(int k, int i, int n, int& o, float& w) {
  o = 2 * i - 1 + k;
  if (k == 0) {
    w = 0.25f;
    return i >= 1;
  }
  if (k == 3) {
    w = 0.25f;
    return i <= n - 2;
  }
  w = (k == 1 ? i == 0 : i == n - 1) ? 1.0f : 0.75f;
  return true;
}

// grad: (planes, 2h, 2w); out: (planes, h, w); one thread per out element,
// total = planes*h*w < 2^31 (the wrapper checks), so the index arithmetic is
// 32-bit; only the offsets into grad, 4x larger, are 64-bit.
template <typename T>
__global__ void upsample2x_backward_kernel(const T* __restrict__ grad, T* __restrict__ out, unsigned total,
                                           unsigned h, unsigned w) {
  const unsigned e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const unsigned t = e / w;
  const int j = static_cast<int>(e - t * w);
  const unsigned plane = t / h;
  const int i = static_cast<int>(t - plane * h);
  const long long ow = 2LL * w;
  const T* g = grad + static_cast<long long>(plane) * (2LL * h) * ow;
  float acc = 0.0f;
  bool first_row = true;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    int oa;
    float wa;
    if (!tap(a, i, static_cast<int>(h), oa, wa)) continue;
    const T* row = g + oa * ow;
    float r = 0.0f;
    bool first_col = true;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      int ob;
      float wb;
      if (!tap(b, j, static_cast<int>(w), ob, wb)) continue;
      const float term = __fmul_rn(wb, to_float(row[ob]));
      r = first_col ? term : __fadd_rn(r, term);
      first_col = false;
    }
    const float term = __fmul_rn(wa, r);
    acc = first_row ? term : __fadd_rn(acc, term);
    first_row = false;
  }
  store(out + e, acc);
}

}  // namespace

// dtype 0: float32, 1: bfloat16.  Returns the launch's cudaError_t (0 on
// success); a refused launch never runs, so the wrapper raises on it.
extern "C" int upsample2x_backward_launch(int dtype, const void* grad, void* out, long long planes, int h, int w,
                                          void* stream) {
  const long long total = planes * h * w;
  if (total == 0) return 0;
  if (total >= (1LL << 31) || h <= 0 || w <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned threads = 256;
  const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned n = static_cast<unsigned>(total), uh = static_cast<unsigned>(h), uw = static_cast<unsigned>(w);
  if (dtype == 0) {
    upsample2x_backward_kernel<float><<<blocks, threads, 0, s>>>(
        static_cast<const float*>(grad), static_cast<float*>(out), n, uh, uw);
  } else if (dtype == 1) {
    upsample2x_backward_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(grad), static_cast<__nv_bfloat16*>(out), n, uh, uw);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
