// K2 and K3: the bilinear x2 upsample (align_corners False, half-pixel
// centres) both ways, for NVIDIA Hopper, sm_90a.  K3 is the forward, K2 its
// deterministic backward.
//
// The upsample is F.interpolate(x, scale_factor=2, mode="bilinear",
// align_corners=False), the U-Net's up-stages (models/unet.py), which the
// JAX package computes with jax.image.resize (ramdsir_tpu/models/unet.py:73-76),
// differentiated by XLA: neither kernel has a TPU counterpart.  K2 exists
// because torch's CUDA backward scatters every output gradient into its
// input neighbours with atomicAdd, so two steps from one state part in the
// last bits, and under torch.use_deterministic_algorithms(True) torch
// refuses it.  K3 exists because aten's NCHW forward
// (upsample_bilinear2d_out_frame) gives one thread to each output pixel of
// a single plane and loops it over all N*C planes: at the decoder's first
// stage, 1,024 threads for 8,192 planes, a few SMs' worth of work.
//
// Per axis of n inputs and 2n outputs, output o samples the input at
// s = max(0, (o + 0.5)/2 - 0.5): output 2k takes 0.25 of input k-1 and 0.75
// of input k (output 0: 1 of input 0 and 0 of input min(1, n-1)), output
// 2k+1 takes 0.75 of input k and 0.25 of input min(k+1, n-1).
//
// K3 computes aten's nested form exactly: per output,
//   y = lh0*(lw0*x[i0,j0] + lw1*x[i0,j1]) + lh1*(lw0*x[i1,j0] + lw1*x[i1,j1]),
// every product and sum rounded on its own (__fmul_rn / __fadd_rn, no FMA),
// the zero-weight terms kept so that inf and NaN spread as in aten.  The
// column combination of an input row is computed once and shared by the
// output rows that use it.
//
// K2 is the transpose as a gather: the gradient of input i gathers, in this
// order, the outputs
//   2i-1 (0.25, if i >= 1), 2i (0.75; 1 if i == 0),
//   2i+1 (0.75; 1 if i == n-1), 2i+2 (0.25, if i <= n-2),
// along the columns of each gathered output-gradient row, then along the
// rows.  No atomics: each result is a fixed sum in a fixed order.
//
// Both accumulate in float32 and round once to the tensor's type (float32
// or bfloat16), so each is bit-equal to its plain version
// (ops/upsample.py: upsample2x_forward_plain, upsample2x_backward_plain).
//
// What bounds them on this card: bytes.  Each moves five elements for every
// input element (K3 reads x and writes the 4x output, K2 reads the 4x
// gradient and writes the input gradient) at ~3-7 flops an element, far
// below the flops a byte at which float32 arithmetic would limit an H100.
// The design reads and writes each byte once with 16-byte accesses:
//   - a thread owns V adjacent input columns of one plane (V = 4 in float32,
//     8 in bfloat16: one 16-byte access of the input side) and walks down a
//     strip of `rows` input rows;
//   - it loads each row it meets once (K3: V inputs; K2: the 2V output
//     gradients over those columns), takes the one-element halo on each side
//     from the neighbouring lane by shuffle (lanes at a warp's edge load it),
//     and computes that row's column pass once;
//   - it keeps the column-pass rows that the next input row shares in
//     registers (K3: the previous and the current input row; K2: the two
//     gradient rows 2i+1 and 2i+2 that input row i+1 gathers too), so a row
//     is read again only at a strip's two ends;
//   - consecutive threads take consecutive column groups of a row, then the
//     strips, then the planes, so a warp's accesses are contiguous and every
//     lane works even when a row (16 columns at the first stage) is narrower
//     than a warp.  The launcher shortens the strips (8 rows down to 2)
//     until the grid holds about four waves of threads: more threads, each
//     with a shorter walk, kept more bytes in flight than longer strips with
//     fewer halo rows (tools/upsample_study.py --sweep).
// Plain 16-byte loads from enough resident warps keep the bytes in flight
// without shared memory: no staging ring, no tensor cores (no product).
// A width that is not a multiple of V or a pointer off 16 bytes takes the
// same kernel with V = 1 and element-wise accesses (the scalar edge path).
//
// Layout: NCHW contiguous tensors in and out; the wrapper refuses others.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int BLOCK = 256;
constexpr long long MIN_THREADS = 1LL << 20;  // ~four waves of 2,048 threads on 132 SMs

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// N consecutive elements as float: 16-byte loads when VEC (the launcher has
// checked the alignment), else one element at a time.
template <bool VEC, int N>
__device__ __forceinline__ void load(const float* __restrict__ p, float (&e)[N]) {
  if constexpr (VEC) {
    static_assert(N % 4 == 0, "float32 vector loads take 4 elements");
#pragma unroll
    for (int k = 0; k < N / 4; ++k) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(p) + k);
      e[4 * k] = v.x;
      e[4 * k + 1] = v.y;
      e[4 * k + 2] = v.z;
      e[4 * k + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) e[k] = p[k];
  }
}

// a bfloat16 is the high half of its float32: the widening is exact
__device__ __forceinline__ float bf16_lo(unsigned u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf16_hi(unsigned u) { return __uint_as_float(u & 0xffff0000u); }

template <bool VEC, int N>
__device__ __forceinline__ void load(const __nv_bfloat16* __restrict__ p, float (&e)[N]) {
  if constexpr (VEC) {
    static_assert(N % 8 == 0, "bfloat16 vector loads take 8 elements");
#pragma unroll
    for (int k = 0; k < N / 8; ++k) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(p) + k);
      const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        e[8 * k + 2 * m] = bf16_lo(w[m]);
        e[8 * k + 2 * m + 1] = bf16_hi(w[m]);
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) e[k] = __bfloat162float(p[k]);
  }
}

template <bool VEC, int N>
__device__ __forceinline__ void store(float* __restrict__ p, const float (&v)[N]) {
  if constexpr (VEC) {
    static_assert(N % 4 == 0, "float32 vector stores take 4 elements");
#pragma unroll
    for (int k = 0; k < N / 4; ++k)
      reinterpret_cast<float4*>(p)[k] = make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) p[k] = v[k];
  }
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 b = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo, each rounded to nearest even
  return *reinterpret_cast<const unsigned*>(&b);
}

template <bool VEC, int N>
__device__ __forceinline__ void store(__nv_bfloat16* __restrict__ p, const float (&v)[N]) {
  if constexpr (VEC) {
    static_assert(N % 8 == 0, "bfloat16 vector stores take 8 elements");
#pragma unroll
    for (int k = 0; k < N / 8; ++k)
      reinterpret_cast<uint4*>(p)[k] = make_uint4(pack_bf16(v[8 * k], v[8 * k + 1]), pack_bf16(v[8 * k + 2], v[8 * k + 3]),
                                                  pack_bf16(v[8 * k + 4], v[8 * k + 5]), pack_bf16(v[8 * k + 6], v[8 * k + 7]));
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) p[k] = __float2bfloat16_rn(v[k]);
  }
}

// Where a thread works: column group q (input columns q*V ..) of `groups`
// in a row, strip s (input rows s*rows ..) of `strips` in a plane, plane p.
// A thread past the end takes the last thread's place: it loads what that
// one loads, so its shuffles are harmless, and stores nothing.
struct Place {
  bool live, first_col, last_col, fetch_left, fetch_right;
  int q, i0;
  unsigned plane;
};

__device__ __forceinline__ Place place(unsigned total, int groups, int rows, int strips) {
  Place at;
  const unsigned t0 = blockIdx.x * blockDim.x + threadIdx.x;
  at.live = t0 < total;
  const unsigned t = at.live ? t0 : total - 1;
  at.q = static_cast<int>(t % static_cast<unsigned>(groups));
  const unsigned rest = t / static_cast<unsigned>(groups);
  at.i0 = static_cast<int>(rest % static_cast<unsigned>(strips)) * rows;
  at.plane = rest / static_cast<unsigned>(strips);
  at.first_col = at.q == 0;
  at.last_col = at.q == groups - 1;
  // the halo comes from lane -+ 1, which holds column group q -+ 1 of the
  // same row, except across a warp's edge
  const unsigned lane = threadIdx.x & 31u;
  at.fetch_left = lane == 0 && !at.first_col;
  at.fetch_right = lane == 31 && !at.last_col;
  return at;
}

// One count a launch, by the grid's first thread, into the wrapper's device
// counter (null: none), so that a run can read how often the kernel ran,
// CUDA graph replays included.
__device__ __forceinline__ void count_launch(unsigned long long* launches) {
  if (launches != nullptr && blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(launches, 1ull);
}

// K2.  grad: (planes, 2h, 2w); out: (planes, h, w).  One thread: V input
// columns, `rows` input rows.  Input row i gathers the column passes of
// gradient rows 2i-1 (a), 2i (b), 2i+1 (c) and 2i+2 (d); row i+1 gathers c
// and d again, so each step of the walk computes two new ones.
template <typename T, int V, bool VEC>
__global__ void __launch_bounds__(BLOCK)
upsample2x_backward_kernel(const T* __restrict__ grad, T* __restrict__ out, unsigned total, int h, int w, int groups,
                           int rows, int strips, unsigned long long* launches) {
  count_launch(launches);
  const Place at = place(total, groups, rows, strips);
  const long long gw = 2LL * w;
  const T* g = grad + static_cast<long long>(at.plane) * (2LL * h) * gw + 2LL * at.q * V;
  T* o = out + static_cast<long long>(at.plane) * h * w + static_cast<long long>(at.q) * V;

  // the column pass of gradient row r, clamped into the plane (a row
  // outside it is computed and never used): c[v] for the V input columns
  auto column_pass = [&](int r, float(&c)[V]) {
    r = min(max(r, 0), 2 * h - 1);
    const T* row = g + r * gw;
    float e[2 * V];
    load<VEC>(row, e);
    float left = __shfl_up_sync(FULL_MASK, e[2 * V - 1], 1);  // column 2j0-1
    float right = __shfl_down_sync(FULL_MASK, e[0], 1);       // column 2j0+2V
    if (at.fetch_left) left = to_float(row[-1]);
    if (at.fetch_right) right = to_float(row[2 * V]);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      float acc;
      if (v == 0 && at.first_col) {
        acc = e[0];  // input column 0: weight 1
      } else {
        const float before = v == 0 ? left : e[v == 0 ? 0 : 2 * v - 1];
        acc = __fadd_rn(__fmul_rn(0.25f, before), __fmul_rn(0.75f, e[2 * v]));
      }
      const bool last = v == V - 1 && at.last_col;  // input column w-1
      acc = __fadd_rn(acc, last ? e[2 * v + 1] : __fmul_rn(0.75f, e[2 * v + 1]));
      if (!last) acc = __fadd_rn(acc, __fmul_rn(0.25f, v == V - 1 ? right : e[v == V - 1 ? 0 : 2 * v + 2]));
      c[v] = acc;
    }
  };

  float a[V], b[V], c[V], d[V];
  column_pass(2 * at.i0 - 1, a);
  column_pass(2 * at.i0, b);
  for (int k = 0; k < rows; ++k) {  // the same count in every lane: the shuffles need them all
    const int i = at.i0 + k;
    column_pass(2 * i + 1, c);
    column_pass(2 * i + 2, d);
    if (at.live && i < h) {
      float r[V];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        float acc = i >= 1 ? __fadd_rn(__fmul_rn(0.25f, a[v]), __fmul_rn(0.75f, b[v])) : b[v];
        acc = __fadd_rn(acc, i == h - 1 ? c[v] : __fmul_rn(0.75f, c[v]));
        if (i <= h - 2) acc = __fadd_rn(acc, __fmul_rn(0.25f, d[v]));
        r[v] = acc;
      }
      store<VEC>(o + static_cast<long long>(i) * w, r);
    }
#pragma unroll
    for (int v = 0; v < V; ++v) {
      a[v] = c[v];
      b[v] = d[v];
    }
  }
}

// K3.  x: (planes, h, w); y: (planes, 2h, 2w).  One thread: V input
// columns (2V output columns), `rows` input rows; input row i writes output
// rows 2i and 2i+1 from the column combinations of input rows i-1, i and
// min(i+1, h-1).
template <typename T, int V, bool VEC>
__global__ void __launch_bounds__(BLOCK)
upsample2x_forward_kernel(const T* __restrict__ x, T* __restrict__ y, unsigned total, int h, int w, int groups,
                          int rows, int strips, unsigned long long* launches) {
  count_launch(launches);
  const Place at = place(total, groups, rows, strips);
  const long long yw = 2LL * w;
  const T* xp = x + static_cast<long long>(at.plane) * h * w + static_cast<long long>(at.q) * V;
  T* yp = y + static_cast<long long>(at.plane) * (2LL * h) * yw + 2LL * at.q * V;

  // the column combination of input row r, clamped into the plane: the 2V
  // output columns 2j0 ..
  auto row_pass = [&](int r, float(&u)[2 * V]) {
    r = min(max(r, 0), h - 1);
    const T* row = xp + static_cast<long long>(r) * w;
    float e[V];
    load<VEC>(row, e);
    float left = __shfl_up_sync(FULL_MASK, e[V - 1], 1);  // column j0-1
    float right = __shfl_down_sync(FULL_MASK, e[0], 1);   // column j0+V
    if (at.fetch_left) left = to_float(row[-1]);
    if (at.fetch_right) right = to_float(row[V]);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      // input column min(j+1, w-1)
      const float after = v < V - 1 ? e[v < V - 1 ? v + 1 : 0] : (at.last_col ? e[v] : right);
      if (v == 0 && at.first_col) {
        u[0] = __fadd_rn(__fmul_rn(1.0f, e[0]), __fmul_rn(0.0f, after));
      } else {
        const float before = v == 0 ? left : e[v == 0 ? 0 : v - 1];
        u[2 * v] = __fadd_rn(__fmul_rn(0.25f, before), __fmul_rn(0.75f, e[v]));
      }
      u[2 * v + 1] = __fadd_rn(__fmul_rn(0.75f, e[v]), __fmul_rn(0.25f, after));
    }
  };

  float prev[2 * V], cur[2 * V], next[2 * V];
  row_pass(at.i0 - 1, prev);
  row_pass(at.i0, cur);
  for (int k = 0; k < rows; ++k) {  // the same count in every lane: the shuffles need them all
    const int i = at.i0 + k;
    row_pass(i + 1, next);
    if (at.live && i < h) {
      float top[2 * V], bottom[2 * V];
#pragma unroll
      for (int m = 0; m < 2 * V; ++m) {
        top[m] = i == 0 ? __fadd_rn(__fmul_rn(1.0f, cur[m]), __fmul_rn(0.0f, next[m]))
                        : __fadd_rn(__fmul_rn(0.25f, prev[m]), __fmul_rn(0.75f, cur[m]));
        bottom[m] = __fadd_rn(__fmul_rn(0.75f, cur[m]), __fmul_rn(0.25f, next[m]));
      }
      store<VEC>(yp + 2LL * i * yw, top);
      store<VEC>(yp + (2LL * i + 1) * yw, bottom);
    }
#pragma unroll
    for (int m = 0; m < 2 * V; ++m) {
      prev[m] = cur[m];
      cur[m] = next[m];
    }
  }
}

// The grid of either kernel: column groups of V, strips of `rows` input
// rows (at most 8, fewer while the grid is short of MIN_THREADS, at least 2
// unless the plane is shorter).
struct Grid {
  int groups, rows, strips;
  unsigned total, blocks;
};

Grid grid(long long planes, int h, int w, int v) {
  Grid g;
  g.groups = w / v;
  g.rows = 8;
  auto threads = [&](int rows) { return planes * g.groups * ((h + rows - 1) / rows); };
  while (g.rows > 2 && threads(g.rows) < MIN_THREADS) g.rows /= 2;
  g.rows = g.rows < h ? g.rows : h;
  g.strips = (h + g.rows - 1) / g.rows;
  g.total = static_cast<unsigned>(threads(g.rows));
  g.blocks = (g.total + BLOCK - 1) / BLOCK;
  return g;
}

bool aligned16(const void* p) { return (reinterpret_cast<unsigned long long>(p) & 15u) == 0; }

template <typename T, int V>
int launch_backward(const void* in, void* out, long long planes, int h, int w, cudaStream_t s, bool vec,
                    unsigned long long* launches) {
  const Grid g = grid(planes, h, w, vec ? V : 1);
  if (vec)
    upsample2x_backward_kernel<T, V, true><<<g.blocks, BLOCK, 0, s>>>(
        static_cast<const T*>(in), static_cast<T*>(out), g.total, h, w, g.groups, g.rows, g.strips, launches);
  else
    upsample2x_backward_kernel<T, 1, false><<<g.blocks, BLOCK, 0, s>>>(
        static_cast<const T*>(in), static_cast<T*>(out), g.total, h, w, g.groups, g.rows, g.strips, launches);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int V>
int launch_forward(const void* in, void* out, long long planes, int h, int w, cudaStream_t s, bool vec,
                   unsigned long long* launches) {
  const Grid g = grid(planes, h, w, vec ? V : 1);
  if (vec)
    upsample2x_forward_kernel<T, V, true><<<g.blocks, BLOCK, 0, s>>>(
        static_cast<const T*>(in), static_cast<T*>(out), g.total, h, w, g.groups, g.rows, g.strips, launches);
  else
    upsample2x_forward_kernel<T, 1, false><<<g.blocks, BLOCK, 0, s>>>(
        static_cast<const T*>(in), static_cast<T*>(out), g.total, h, w, g.groups, g.rows, g.strips, launches);
  return static_cast<int>(cudaGetLastError());
}

// dtype 0: float32, 1: bfloat16.  `vec` asks for the 16-byte path, which
// is refused for a width or a pointer it cannot take.  planes*h*w < 2^31
// (the wrapper checks too), so thread indices are 32-bit.  0 if the
// arguments can be launched, else the error to return.
int check(int dtype, int vec, const void* in, const void* out, long long planes, int h, int w) {
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (planes < 0 || h <= 0 || w <= 0 || planes * h * w >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const int v = dtype == 0 ? 4 : 8;
  if (vec && (w % v != 0 || !aligned16(in) || !aligned16(out))) return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

}  // namespace

// Each returns the launch's cudaError_t (0 on success); a refused launch
// never runs, so the wrapper raises on it.
extern "C" int upsample2x_backward_launch(int dtype, int vec, const void* grad, void* out, long long planes, int h,
                                          int w, unsigned long long* launches, void* stream) {
  if (const int err = check(dtype, vec, grad, out, planes, h, w)) return err;
  if (planes == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch_backward<float, 4>(grad, out, planes, h, w, s, vec != 0, launches)
                    : launch_backward<__nv_bfloat16, 8>(grad, out, planes, h, w, s, vec != 0, launches);
}

extern "C" int upsample2x_forward_launch(int dtype, int vec, const void* x, void* y, long long planes, int h, int w,
                                         unsigned long long* launches, void* stream) {
  if (const int err = check(dtype, vec, x, y, planes, h, w)) return err;
  if (planes == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch_forward<float, 4>(x, y, planes, h, w, s, vec != 0, launches)
                    : launch_forward<__nv_bfloat16, 8>(x, y, planes, h, w, s, vec != 0, launches);
}
