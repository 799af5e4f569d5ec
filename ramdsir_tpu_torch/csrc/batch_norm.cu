// Train-mode batch norm with grouped statistics, float32 NCHW, for NVIDIA
// Hopper, sm_90a: a statistics kernel and an apply kernel forward, a
// reduction kernel and an apply kernel backward.
//
// One call normalises x (N, C, H, W), whose rows form G contiguous groups.
// Group g takes its statistics from its first stat_rows[g] rows (the real
// rows; the rest are padding), normalises all its rows, and uses the
// weight, bias and running buffers of its slot.  The port's two callers
// (models/norm.py): BatchNorm(dual=True), the clean and the RAM half of the
// fused forward, G = 2 sharing one slot; DomainSpecificBatchNorm in segment
// mode, one group and one slot a domain.  G = 1 is plain train-mode BN.
// The JAX package computes these norms with XLA's reductions
// (ramdsir_tpu/models/norm.py): no Pallas kernel is replaced.  The kernels
// replace cuDNN's NCHW bn_fw_tr_1C11 / bn_bw_1C11, which give each
// channel's reduction to too few blocks (a layer has 16-256 channels of up
// to 1M values each), called once a half or a domain, the pieces then
// joined by torch.cat.
//
// What bounds them: bytes.  A norm does a few flops a value, far below the
// card's flops a byte.  The least traffic reads x and writes y forward and
// reads x and dy and writes dx backward; the split reductions here read x
// once more forward and x and dy once more backward (8 passes against 5),
// since a layer of the train step (up to 268 MB) does not fit on chip.  The
// design keeps HBM streaming at full width on every layer shape:
//   - work is cut into units: (group, channel, chunk of `f` vectors of
//     that channel's rows x H x W values), a vector being 4 floats (one
//     16-byte access) or, where H*W % 4 or a pointer forbids it, 1 float;
//     the launcher (ops/batch_norm.plan) sizes the chunks from the whole
//     tensor so that each layer gives every SM several units, from C = 16
//     over 1M values a channel to C = 256 over 4K;
//   - each block takes a contiguous range of units (one wave of blocks,
//     as many as fit on the card) and the apply kernels walk their range
//     backwards, so they start on what the reduction read last, still in
//     the 50 MB L2;
//   - the statistics are Welford / Chan partials (count, mean, M2): four
//     values at a time into a thread's running triple, the threads merged
//     by a fixed tree, one partial a unit; the apply kernels combine a
//     channel's partials in double, in a fixed order (a warp's lanes over
//     the partials, then a fixed shuffle tree), so every block of the
//     channel gets the same bits;
//   - the block that holds unit (group 0, channel c, chunk 0) also writes
//     the channel's mean and inverse deviation of every group and moves
//     the running buffers, group after group in row order (dual: half 1's
//     update, then half 2's); backward it writes the slots' weight and bias
//     gradients, summed over a slot's groups in row order.
// No floating-point atomics: the same inputs give the same bits, in a
// CUDA graph's replays too.  No host synchronisation and no allocation:
// the wrapper hands in every buffer (ops/batch_norm.py).
//
// Forward:  y = (x - mean) * (w * inv) + b, inv = 1 / sqrt(var + eps), var
//           the biased variance of the real rows.
// Backward: with S1 = sum dy and S2 = sum dy * (x - mean) over all rows of
//           the group, n the real rows' values a channel,
//           dx = ((dy - S1/n) - (x - mean) * inv^2*S2/n) * (w*inv) on real
//           rows and dy * (w*inv) on padding rows; dw = inv * S2, db = S1.
//           This is the standard form, each operation rounded on its own,
//           as the library's kernel (and aten's) computes it.  A conv
//           bias feeding the norm gets the channel's sum of dx, zero in
//           exact arithmetic: the standard form leaves round-off of ~1e-6
//           there, as the library does, where the same formula fused into
//           two FMAs left ~3e-8 (fundus and prostate steps on an H100).
//           Adam's first step divides by |g| + 1e-8, so at ~3e-8 such a
//           bias moved by less than the learning rate, and a step parted
//           from the float32 reference (which moves it by the full rate).
//
// Layout: NCHW contiguous float32; the wrapper refuses others.

#include <cuda_runtime.h>

namespace {

constexpr int BLOCK = 256;
constexpr int WARPS = BLOCK / 32;
constexpr int MAX_GROUPS = 8;
constexpr int UNROLL = 4;  // vectors a thread has in flight
constexpr unsigned FULL_MASK = 0xffffffffu;

// n / d for n < 2^31 as a multiply-high and a shift (d fixed per call).
struct FastDiv {
  unsigned d, mul, shr;
};

FastDiv fast_div(unsigned d) {
  FastDiv f{d, 0u, 0u};
  if (d != 1) {
    unsigned log2 = 0;
    while ((1ull << log2) < d) ++log2;  // ceil(log2(d))
    const unsigned p = 31 + log2;
    f.mul = static_cast<unsigned>(((1ull << p) + d - 1) / d);
    f.shr = p - 32;
  }
  return f;
}

__device__ __forceinline__ unsigned quot(unsigned n, const FastDiv& f) {
  return f.mul ? __umulhi(n, f.mul) >> f.shr : n;
}

// The call: x (n, c, hw), rows in `groups` contiguous groups.
struct Shape {
  int c, hw, f;             // channels, values a plane, vectors a unit
  long long row_stride;     // c * hw
  FastDiv qv;               // vectors a plane
  int groups;
  int row0[MAX_GROUPS];     // first row of each group
  int stat_rows[MAX_GROUPS];
  int slot[MAX_GROUPS];
  float count[MAX_GROUPS];  // the real values a channel: stat_rows * hw
  float unbias[MAX_GROUPS]; // count / max(count - 1, 1)
};

// A pass's units: group g, channel c, chunk k is unit0[g] + c * chunks[g] + k.
struct Units {
  int unit0[MAX_GROUPS + 1];
  int chunks[MAX_GROUPS];
  int rows[MAX_GROUPS];  // the rows the pass covers
};

// Per slot (the groups of a slot are consecutive): parameters, buffers and
// gradients; a null running buffer is left alone.
struct Slots {
  const float* weight[MAX_GROUPS];
  const float* bias[MAX_GROUPS];
  float* running_mean[MAX_GROUPS];
  float* running_var[MAX_GROUPS];
  float* grad_weight[MAX_GROUPS];
  float* grad_bias[MAX_GROUPS];
};

struct Unit {
  int g, c, k;
};

__device__ __forceinline__ Unit unit_of(const Units& u, int groups, int i) {
  int g = 0;
  while (g + 1 < groups && i >= u.unit0[g + 1]) ++g;
  const int rel = i - u.unit0[g];
  return {g, rel / u.chunks[g], rel % u.chunks[g]};
}

// This block's contiguous range [first, last) of `total` units.
__device__ __forceinline__ void block_range(int total, int& first, int& last) {
  first = static_cast<int>(static_cast<long long>(total) * blockIdx.x / gridDim.x);
  last = static_cast<int>(static_cast<long long>(total) * (blockIdx.x + 1) / gridDim.x);
}

// One count a launch, by the grid's first thread, into the wrapper's device
// counter, so that a run can read how often the kernel ran, CUDA graph
// replays included.
__device__ __forceinline__ void count_launch(unsigned long long* launches) {
  if (launches != nullptr && blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(launches, 1ull);
}

// Vector f (of a group's channel, row-major over its rows' planes) as an
// element offset from the channel's first value.
template <int V>
__device__ __forceinline__ long long offset(const Shape& s, unsigned f) {
  const unsigned r = quot(f, s.qv);
  return static_cast<long long>(r) * s.row_stride + static_cast<long long>(f - r * s.qv.d) * V;
}

// STREAM: the last read of these bytes (evict first).
template <int V, bool STREAM>
__device__ __forceinline__ void load(const float* __restrict__ p, float (&e)[V]) {
  if constexpr (V == 4) {
    const float4* q = reinterpret_cast<const float4*>(p);
    const float4 t = STREAM ? __ldcs(q) : __ldg(q);
    e[0] = t.x;
    e[1] = t.y;
    e[2] = t.z;
    e[3] = t.w;
  } else {
    e[0] = STREAM ? __ldcs(p) : __ldg(p);
  }
}

template <int V>
__device__ __forceinline__ void store(float* __restrict__ p, const float (&e)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(e[0], e[1], e[2], e[3]);
  } else {
    p[0] = e[0];
  }
}

// Chan's merge of (nb, mb, qb) into (n, mean, m2); an empty side is exact.
template <typename T>
__device__ __forceinline__ void merge(T& n, T& mean, T& m2, T nb, T mb, T qb) {
  if (nb == T(0)) return;
  const T nn = n + nb;
  const T d = mb - mean;
  const T r = nb / nn;
  mean = mean + d * r;
  m2 = m2 + qb + d * d * n * r;
  n = nn;
}

// V values into a thread's running triple: their own mean and M2, merged.
template <int V>
__device__ __forceinline__ void add_values(float& n, float& mean, float& m2, const float (&e)[V]) {
  if constexpr (V == 4) {
    const float m4 = ((e[0] + e[1]) + (e[2] + e[3])) * 0.25f;
    const float d0 = e[0] - m4, d1 = e[1] - m4, d2 = e[2] - m4, d3 = e[3] - m4;
    merge(n, mean, m2, 4.0f, m4, (d0 * d0 + d1 * d1) + (d2 * d2 + d3 * d3));
  } else {
    merge(n, mean, m2, 1.0f, e[0], 0.0f);
  }
}

// The block's triple, in thread 0, by a fixed tree: lanes, then warps in order.
__device__ __forceinline__ void block_merge(float& n, float& mean, float& m2, float (*sh)[WARPS]) {
  for (int off = 16; off > 0; off >>= 1) {
    const float nb = __shfl_down_sync(FULL_MASK, n, off);
    const float mb = __shfl_down_sync(FULL_MASK, mean, off);
    const float qb = __shfl_down_sync(FULL_MASK, m2, off);
    merge(n, mean, m2, nb, mb, qb);
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    sh[0][warp] = n;
    sh[1][warp] = mean;
    sh[2][warp] = m2;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < WARPS; ++w) merge(n, mean, m2, sh[0][w], sh[1][w], sh[2][w]);
  }
}

// The block's two sums, in thread 0, by a fixed tree.
__device__ __forceinline__ void block_sum(float& a, float& b, float (*sh)[WARPS]) {
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_down_sync(FULL_MASK, a, off);
    b += __shfl_down_sync(FULL_MASK, b, off);
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    sh[0][warp] = a;
    sh[1][warp] = b;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < WARPS; ++w) {
      a += sh[0][w];
      b += sh[1][w];
    }
  }
}

// A channel's statistics from its `count` partials, in double, by warp 0 in
// a fixed order; every lane returns the result.
__device__ __forceinline__ void combine_stats(const float4* __restrict__ p, int count, double& n, double& mean,
                                              double& m2) {
  n = 0.0;
  mean = 0.0;
  m2 = 0.0;
  for (int j = threadIdx.x & 31; j < count; j += 32) {
    const float4 t = p[j];
    merge<double>(n, mean, m2, t.x, t.y, t.z);
  }
  for (int off = 16; off > 0; off >>= 1) {
    const double nb = __shfl_down_sync(FULL_MASK, n, off);
    const double mb = __shfl_down_sync(FULL_MASK, mean, off);
    const double qb = __shfl_down_sync(FULL_MASK, m2, off);
    merge(n, mean, m2, nb, mb, qb);
  }
  n = __shfl_sync(FULL_MASK, n, 0);
  mean = __shfl_sync(FULL_MASK, mean, 0);
  m2 = __shfl_sync(FULL_MASK, m2, 0);
}

// A channel's two backward sums from its `count` partials, the same way.
__device__ __forceinline__ void combine_sums(const float2* __restrict__ p, int count, double& s1, double& s2) {
  s1 = 0.0;
  s2 = 0.0;
  for (int j = threadIdx.x & 31; j < count; j += 32) {
    const float2 t = p[j];
    s1 += t.x;
    s2 += t.y;
  }
  for (int off = 16; off > 0; off >>= 1) {
    s1 += __shfl_down_sync(FULL_MASK, s1, off);
    s2 += __shfl_down_sync(FULL_MASK, s2, off);
  }
  s1 = __shfl_sync(FULL_MASK, s1, 0);
  s2 = __shfl_sync(FULL_MASK, s2, 0);
}

// Forward, pass 1: one (count, mean, M2) partial a unit of the real rows.
template <int V>
__global__ void __launch_bounds__(BLOCK)
ramdsir_batch_norm_stats_kernel(const float* __restrict__ x, const __grid_constant__ Shape s, const __grid_constant__ Units u, float4* __restrict__ partial,
                                unsigned long long* launches) {
  count_launch(launches);
  __shared__ float sh[3][WARPS];
  int first, last;
  block_range(u.unit0[s.groups], first, last);
  for (int i = first; i < last; ++i) {
    const Unit w = unit_of(u, s.groups, i);
    const float* base = x + (static_cast<long long>(s.row0[w.g]) * s.c + w.c) * s.hw;
    const int fb = w.k * s.f;
    const int fe = min(fb + s.f, u.rows[w.g] * static_cast<int>(s.qv.d));
    float n = 0.0f, mean = 0.0f, m2 = 0.0f;
    for (int f0 = fb + threadIdx.x; f0 < fe; f0 += BLOCK * UNROLL) {
      float e[UNROLL][V];
#pragma unroll
      for (int j = 0; j < UNROLL; ++j) {
        const int f = f0 + j * BLOCK;
        if (f < fe) load<V, false>(base + offset<V>(s, f), e[j]);
      }
#pragma unroll
      for (int j = 0; j < UNROLL; ++j) {
        if (f0 + j * BLOCK < fe) add_values<V>(n, mean, m2, e[j]);
      }
    }
    block_merge(n, mean, m2, sh);
    if (threadIdx.x == 0) partial[i] = make_float4(n, mean, m2, 0.0f);
    __syncthreads();  // sh is free for the next unit
  }
}

// Forward, pass 2: y = (x - mean) * (w * inv) + b over every row; the block
// holding (group 0, c, chunk 0) writes mean / inv of every group and moves
// the running buffers, in row order.
template <int V>
__global__ void __launch_bounds__(BLOCK)
ramdsir_batch_norm_forward_kernel(const float* __restrict__ x, float* __restrict__ y, const __grid_constant__ Shape s,
                                  const __grid_constant__ Units su, const __grid_constant__ Units u,
                                  const float4* __restrict__ partial, const __grid_constant__ Slots p, float momentum, float keep, float eps,
                                  float* __restrict__ mean_out, float* __restrict__ invstd_out,
                                  unsigned long long* launches) {
  count_launch(launches);
  __shared__ float coef[3];  // mean, scale, bias of the current (group, channel)
  int first, last;
  block_range(u.unit0[s.groups], first, last);
  int current = -1;
  for (int i = last - 1; i >= first; --i) {
    const Unit w = unit_of(u, s.groups, i);
    const int gc = w.g * s.c + w.c;
    const bool owner = w.g == 0 && w.k == 0;
    if (gc != current || owner) {  // the same in every thread
      __syncthreads();               // every thread is done with the previous coefficients
      if (threadIdx.x < 32) {
        for (int g = owner ? 0 : w.g; g < (owner ? s.groups : w.g + 1); ++g) {
          double n, mean, m2;
          combine_stats(partial + su.unit0[g] + w.c * su.chunks[g], su.chunks[g], n, mean, m2);
          const float mu = static_cast<float>(mean);
          const float var = static_cast<float>(m2 / n);
          const float inv = 1.0f / sqrtf(var + eps);
          if (threadIdx.x == 0) {
            const int sl = s.slot[g];
            if (g == w.g) {
              coef[0] = mu;
              coef[1] = p.weight[sl][w.c] * inv;
              coef[2] = p.bias[sl][w.c];
            }
            if (owner) {
              mean_out[g * s.c + w.c] = mu;
              invstd_out[g * s.c + w.c] = inv;
              if (p.running_mean[sl] != nullptr) {
                float* rm = p.running_mean[sl] + w.c;
                float* rv = p.running_var[sl] + w.c;
                *rm = fmaf(momentum, mu, *rm * keep);
                *rv = fmaf(momentum, var * s.unbias[g], *rv * keep);
              }
            }
          }
        }
      }
      __syncthreads();
      current = gc;
    }
    const float mu = coef[0], scale = coef[1], shift = coef[2];
    const long long base = (static_cast<long long>(s.row0[w.g]) * s.c + w.c) * s.hw;
    const int fb = w.k * s.f;
    const int fe = min(fb + s.f, u.rows[w.g] * static_cast<int>(s.qv.d));
    for (int f0 = fb + threadIdx.x; f0 < fe; f0 += BLOCK * UNROLL) {
      float e[UNROLL][V];
      long long at[UNROLL];
#pragma unroll
      for (int j = 0; j < UNROLL; ++j) {
        const int f = f0 + j * BLOCK;
        at[j] = base + offset<V>(s, f);
        if (f < fe) load<V, true>(x + at[j], e[j]);
      }
#pragma unroll
      for (int j = 0; j < UNROLL; ++j) {
        if (f0 + j * BLOCK < fe) {
#pragma unroll
          for (int v = 0; v < V; ++v) e[j][v] = fmaf(e[j][v] - mu, scale, shift);
          store<V>(y + at[j], e[j]);
        }
      }
    }
  }
}

// Backward, pass 1: one (sum dy, sum dy * (x - mean)) partial a unit of all rows.
template <int V>
__global__ void __launch_bounds__(BLOCK)
ramdsir_batch_norm_backward_reduce_kernel(const float* __restrict__ dy, const float* __restrict__ x, const __grid_constant__ Shape s, const __grid_constant__ Units u,
                                          const float* __restrict__ mean, float2* __restrict__ partial,
                                          unsigned long long* launches) {
  count_launch(launches);
  __shared__ float sh[2][WARPS];
  int first, last;
  block_range(u.unit0[s.groups], first, last);
  for (int i = first; i < last; ++i) {
    const Unit w = unit_of(u, s.groups, i);
    const float mu = mean[w.g * s.c + w.c];
    const long long base = (static_cast<long long>(s.row0[w.g]) * s.c + w.c) * s.hw;
    const int fb = w.k * s.f;
    const int fe = min(fb + s.f, u.rows[w.g] * static_cast<int>(s.qv.d));
    float s1 = 0.0f, s2 = 0.0f;
    for (int f0 = fb + threadIdx.x; f0 < fe; f0 += BLOCK * UNROLL) {
      float g[UNROLL][V], e[UNROLL][V];
#pragma unroll
      for (int j = 0; j < UNROLL; ++j) {
        const int f = f0 + j * BLOCK;
        if (f < fe) {
          const long long at = base + offset<V>(s, f);
          load<V, false>(dy + at, g[j]);
          load<V, false>(x + at, e[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < UNROLL; ++j) {
        if (f0 + j * BLOCK < fe) {
#pragma unroll
          for (int v = 0; v < V; ++v) {
            s1 += g[j][v];
            s2 = fmaf(g[j][v], e[j][v] - mu, s2);
          }
        }
      }
    }
    block_sum(s1, s2, sh);
    if (threadIdx.x == 0) partial[i] = make_float2(s1, s2);
    __syncthreads();
  }
}

// Backward, pass 2: dx over every row; the block holding (group 0, c,
// chunk 0) writes each slot's weight and bias gradients of channel c.
template <int V>
__global__ void __launch_bounds__(BLOCK)
ramdsir_batch_norm_backward_kernel(const float* __restrict__ dy, const float* __restrict__ x, float* __restrict__ dx,
                                   const __grid_constant__ Shape s, const __grid_constant__ Units u, const float2* __restrict__ partial, const __grid_constant__ Slots p,
                                   const float* __restrict__ mean, const float* __restrict__ invstd,
                                   unsigned long long* launches) {
  count_launch(launches);
  __shared__ float coef[4];  // mean, w*inv, inv^2*S2/n, S1/n
  int first, last;
  block_range(u.unit0[s.groups], first, last);
  int current = -1;
  for (int i = last - 1; i >= first; --i) {
    const Unit w = unit_of(u, s.groups, i);
    const int gc = w.g * s.c + w.c;
    const bool owner = w.g == 0 && w.k == 0;
    if (gc != current || owner) {
      __syncthreads();
      if (threadIdx.x < 32) {
        double gw = 0.0, gb = 0.0;  // the current slot's gradients (owner)
        for (int g = owner ? 0 : w.g; g < (owner ? s.groups : w.g + 1); ++g) {
          double s1, s2;
          combine_sums(partial + u.unit0[g] + w.c * u.chunks[g], u.chunks[g], s1, s2);
          const int sl = s.slot[g];
          const double inv = invstd[g * s.c + w.c];
          if (threadIdx.x == 0) {
            if (g == w.g) {
              coef[0] = mean[gc];
              coef[1] = static_cast<float>(static_cast<double>(p.weight[sl][w.c]) * inv);
              coef[2] = static_cast<float>(inv * inv * s2 / s.count[g]);
              coef[3] = static_cast<float>(s1 / s.count[g]);
            }
            if (owner) {
              gw += inv * s2;
              gb += s1;
              if (g + 1 == s.groups || s.slot[g + 1] != sl) {  // the slot's last group
                p.grad_weight[sl][w.c] = static_cast<float>(gw);
                p.grad_bias[sl][w.c] = static_cast<float>(gb);
                gw = 0.0;
                gb = 0.0;
              }
            }
          }
        }
      }
      __syncthreads();
      current = gc;
    }
    const float mu = coef[0], scale = coef[1], proj = coef[2], mean_dy = coef[3];
    const int real = s.stat_rows[w.g];
    const long long base = (static_cast<long long>(s.row0[w.g]) * s.c + w.c) * s.hw;
    const int fb = w.k * s.f;
    const int fe = min(fb + s.f, u.rows[w.g] * static_cast<int>(s.qv.d));
    for (int f0 = fb + threadIdx.x; f0 < fe; f0 += BLOCK * UNROLL) {
      float g[UNROLL][V], e[UNROLL][V];
      long long at[UNROLL];
      bool pad[UNROLL];
#pragma unroll
      for (int j = 0; j < UNROLL; ++j) {
        const int f = f0 + j * BLOCK;
        at[j] = base + offset<V>(s, f);
        pad[j] = static_cast<int>(quot(f, s.qv)) >= real;
        if (f < fe) {
          load<V, true>(dy + at[j], g[j]);
          load<V, true>(x + at[j], e[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < UNROLL; ++j) {
        if (f0 + j * BLOCK < fe) {
#pragma unroll
          for (int v = 0; v < V; ++v)
            e[j][v] = pad[j] ? __fmul_rn(g[j][v], scale)
                             : __fmul_rn(__fsub_rn(__fsub_rn(g[j][v], mean_dy), __fmul_rn(__fsub_rn(e[j][v], mu), proj)), scale);
          store<V>(dx + at[j], e[j]);
        }
      }
    }
  }
}

bool aligned16(const void* q) { return (reinterpret_cast<unsigned long long>(q) & 15u) == 0; }

constexpr int MAX_DEVICES = 16;
int capacities[8][MAX_DEVICES];  // per kernel (id) and device: blocks that fit on the card at once

// The grid for `units` units of `kernel` (id): one block a unit, at most
// as many blocks as fit on the card at once.
template <typename K>
int grid_for(int units, K kernel, int id) {
  int dev = 0;
  cudaGetDevice(&dev);
  int cap = 132;
  if (dev >= 0 && dev < MAX_DEVICES) {
    int& cached = capacities[id][dev];
    if (cached == 0) {
      int sms = 0, per_sm = 0;
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, BLOCK, 0);
      cached = (sms > 0 ? sms : 132) * (per_sm > 0 ? per_sm : 1);
    }
    cap = cached;
  }
  return units < cap ? units : cap;
}

// Checks the call and fills the shape and a pass's units; 0 or the error.
int setup(int n, int c, int hw, int vec, int f, int groups, const int* rows, const int* stat_rows, const int* slot,
          const int* chunks, const int* stat_chunks, const float* unbias, Shape& s, Units& u, Units* su) {
  if (groups < 1 || groups > MAX_GROUPS || n < 1 || c < 1 || hw < 1 || f < 1) return cudaErrorInvalidValue;
  if (static_cast<long long>(n) * c * hw >= (1LL << 31) - 4LL * BLOCK * UNROLL) return cudaErrorInvalidValue;
  const int width = vec ? 4 : 1;
  if (hw % width != 0) return cudaErrorInvalidValue;
  s.c = c;
  s.hw = hw;
  s.f = f;
  s.row_stride = static_cast<long long>(c) * hw;
  s.qv = fast_div(static_cast<unsigned>(hw / width));
  s.groups = groups;
  int row = 0, unit = 0, stat_unit = 0;
  for (int g = 0; g < groups; ++g) {
    if (rows[g] < 1 || stat_rows[g] < 1 || stat_rows[g] > rows[g]) return cudaErrorInvalidValue;
    // slots start at 0 and a slot's groups are consecutive
    if (slot[g] != (g == 0 ? 0 : slot[g - 1]) && slot[g] != (g == 0 ? 0 : slot[g - 1] + 1)) return cudaErrorInvalidValue;
    const long long vectors = static_cast<long long>(rows[g]) * (hw / width);
    if (chunks[g] != (vectors + f - 1) / f) return cudaErrorInvalidValue;
    s.row0[g] = row;
    s.stat_rows[g] = stat_rows[g];
    s.slot[g] = slot[g];
    s.count[g] = static_cast<float>(static_cast<long long>(stat_rows[g]) * hw);
    s.unbias[g] = unbias != nullptr ? unbias[g] : 1.0f;
    u.unit0[g] = unit;
    u.chunks[g] = chunks[g];
    u.rows[g] = rows[g];
    unit += c * chunks[g];
    if (su != nullptr) {
      const long long stat_vectors = static_cast<long long>(stat_rows[g]) * (hw / width);
      if (stat_chunks[g] != (stat_vectors + f - 1) / f) return cudaErrorInvalidValue;
      su->unit0[g] = stat_unit;
      su->chunks[g] = stat_chunks[g];
      su->rows[g] = stat_rows[g];
      stat_unit += c * stat_chunks[g];
    }
    row += rows[g];
  }
  if (row != n) return cudaErrorInvalidValue;
  u.unit0[groups] = unit;
  if (su != nullptr) su->unit0[groups] = stat_unit;
  return 0;
}

}  // namespace

// Forward: the statistics kernel, then the apply kernel, on `stream`.
// weight / bias / running_* are per slot (running null: not updated);
// partial holds sum(stat_chunks) * c float4s; mean / invstd (groups, c).
// Returns the launches' cudaError_t (0 on success); a refused call
// launches nothing.
extern "C" int batch_norm_forward_launch(const float* x, float* y, int n, int c, int hw, int vec, int f, int groups,
                                         const int* rows, const int* stat_rows, const int* slot, const int* stat_chunks,
                                         const int* chunks, const float* unbias, const void* const* weight,
                                         const void* const* bias, void* const* running_mean,
                                         void* const* running_var, float momentum, float eps, void* partial,
                                         float* mean, float* invstd, unsigned long long* launches, void* stream) {
  Shape s;
  Units u, su;
  if (const int err = setup(n, c, hw, vec, f, groups, rows, stat_rows, slot, chunks, stat_chunks, unbias, s, u, &su))
    return err;
  if (vec && (!aligned16(x) || !aligned16(y))) return cudaErrorInvalidValue;
  Slots p{};
  for (int g = 0; g < groups; ++g) {
    const int sl = slot[g];
    p.weight[sl] = static_cast<const float*>(weight[sl]);
    p.bias[sl] = static_cast<const float*>(bias[sl]);
    p.running_mean[sl] = static_cast<float*>(running_mean[sl]);
    p.running_var[sl] = static_cast<float*>(running_var[sl]);
    if ((p.running_mean[sl] == nullptr) != (p.running_var[sl] == nullptr)) return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float4* part = static_cast<float4*>(partial);
  const float keep = 1.0f - momentum;
  unsigned long long* applied = launches != nullptr ? launches + 1 : nullptr;
  if (vec) {
    ramdsir_batch_norm_stats_kernel<4><<<grid_for(su.unit0[groups], ramdsir_batch_norm_stats_kernel<4>, 0), BLOCK, 0, st>>>(
        x, s, su, part, launches);
    ramdsir_batch_norm_forward_kernel<4><<<grid_for(u.unit0[groups], ramdsir_batch_norm_forward_kernel<4>, 1), BLOCK, 0, st>>>(
        x, y, s, su, u, part, p, momentum, keep, eps, mean, invstd, applied);
  } else {
    ramdsir_batch_norm_stats_kernel<1><<<grid_for(su.unit0[groups], ramdsir_batch_norm_stats_kernel<1>, 2), BLOCK, 0, st>>>(
        x, s, su, part, launches);
    ramdsir_batch_norm_forward_kernel<1><<<grid_for(u.unit0[groups], ramdsir_batch_norm_forward_kernel<1>, 3), BLOCK, 0, st>>>(
        x, y, s, su, u, part, p, momentum, keep, eps, mean, invstd, applied);
  }
  return static_cast<int>(cudaGetLastError());
}

// Backward: the reduction kernel, then the apply kernel; partial holds
// sum(chunks) * c float2s; grad_weight / grad_bias per slot.
extern "C" int batch_norm_backward_launch(const float* dy, const float* x, float* dx, int n, int c, int hw, int vec,
                                          int f, int groups, const int* rows, const int* stat_rows, const int* slot,
                                          const int* chunks, const void* const* weight, void* const* grad_weight,
                                          void* const* grad_bias, const float* mean, const float* invstd,
                                          void* partial, unsigned long long* launches, void* stream) {
  Shape s;
  Units u;
  if (const int err = setup(n, c, hw, vec, f, groups, rows, stat_rows, slot, chunks, nullptr, nullptr, s, u, nullptr))
    return err;
  if (vec && (!aligned16(dy) || !aligned16(x) || !aligned16(dx))) return cudaErrorInvalidValue;
  Slots p{};
  for (int g = 0; g < groups; ++g) {
    const int sl = slot[g];
    p.weight[sl] = static_cast<const float*>(weight[sl]);
    p.grad_weight[sl] = static_cast<float*>(grad_weight[sl]);
    p.grad_bias[sl] = static_cast<float*>(grad_bias[sl]);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float2* part = static_cast<float2*>(partial);
  unsigned long long* applied = launches != nullptr ? launches + 1 : nullptr;
  if (vec) {
    ramdsir_batch_norm_backward_reduce_kernel<4><<<grid_for(u.unit0[groups], ramdsir_batch_norm_backward_reduce_kernel<4>, 4), BLOCK, 0, st>>>(
        dy, x, s, u, mean, part, launches);
    ramdsir_batch_norm_backward_kernel<4><<<grid_for(u.unit0[groups], ramdsir_batch_norm_backward_kernel<4>, 5), BLOCK, 0, st>>>(
        dy, x, dx, s, u, part, p, mean, invstd, applied);
  } else {
    ramdsir_batch_norm_backward_reduce_kernel<1><<<grid_for(u.unit0[groups], ramdsir_batch_norm_backward_reduce_kernel<1>, 6), BLOCK, 0, st>>>(
        dy, x, s, u, mean, part, launches);
    ramdsir_batch_norm_backward_kernel<1><<<grid_for(u.unit0[groups], ramdsir_batch_norm_backward_kernel<1>, 7), BLOCK, 0, st>>>(
        dy, x, dx, s, u, part, p, mean, invstd, applied);
  }
  return static_cast<int>(cudaGetLastError());
}
