// Train-mode BatchNorm over channels_last activations on Hopper: the batch
// statistics, the transform, and both passes of the backward, in four
// kernels whose names hold `batch_norm`.
//
// It replaces no Pallas kernel: in crfr, BatchNorm is flax's nnx.BatchNorm,
// compiled by XLA. It was added because ATen's generic channels_last kernels
// took 29.5 ms of IR-50's 88.5 ms train step at B=512 on an H100 against a
// 13.56 ms bound for the bytes the four passes must move (its statistics
// pass, one read of x, ran at 17% of the card's bandwidth).
//
// The input is x (N, C, H, W) in channels_last memory: R = N*H*W rows of C
// channels, bf16 or f32, with f32 weight and bias; the output is in x's type.
// Each pass is bound by bytes, at 3.35 TB/s (b = bytes of an element):
//
//   1. statistics   read x                          b    per element
//   2. transform    read x, write y                 2b
//   3. bwd reduce   read dy, x                      2b
//   4. bwd apply    read dy, x, write dx            3b
//
// and does a few flops an element, far under the card's rate. So the design
// keeps enough bytes in flight on every SM whatever C is, and keeps the
// cross-CTA reductions off the critical path:
//
// - A CTA owns a block of rows and a block of VB vectors of a row (a vector
//   is 16 bytes, 8 bf16 or 4 f32 channels; 1 channel where C is not a
//   multiple of it; VB a power of two, 16 at most in the wrapper's plan).
//   Its 256 threads stand on 256/VB rows at once, one vector each, so a warp
//   reads whole 128-byte lines and a thread's channels stay fixed: its
//   per-channel sums and coefficients live in registers. A thread loads a
//   round of rows before it uses any (8 for the statistics, 4 where it
//   loads two tensors), the last round under guards, and the grid is about
//   two CTAs an SM however many rows there are: for C = 64 over 6.4 M rows,
//   264 CTAs of 24 K rows, where ATen's statistics kernel could not spread
//   the reduction over the card.
// - The reductions (passes 1 and 3) sum in f32 registers, then across the
//   CTA (shuffles, then one shared-memory step over the 8 warps), and each
//   CTA writes one f32 partial a channel. The CTA that takes the last ticket
//   of its group's atomic counter (after a __threadfence) sums the group's
//   ~sqrt(CTAs) partials in a fixed order, and the last of the groups sums
//   theirs: no one CTA reads all the partials (a single level took 90 us at
//   C = 256 over 100 K rows, whose read takes 15). Each counter's last taker
//   resets it. No float atomics: the results are the same bits on every run.
// - Pass 1's last CTA writes the mean and 1/sigma from flax's biased
//   E[x^2] - E[x]^2, and moves running_mean / running_var by flax's rule
//   (0.9 old + 0.1 batch, the biased variance) unless told not to (a
//   recomputation). Pass 3's writes sum(dy) and sum(dy * xhat), which are
//   also the bias and weight gradients.
// - Passes 2 and 4 walk each CTA's rows in the reverse of passes 1 and 3,
//   so that the rows read last by the reduction, still in the 50 MB L2 when
//   the tensor is near its size, are read first (3.0% less BN time a step
//   and 0.5% more images a second than the same order, on an H100).
//
// Plain C interface, built with nvcc into a shared library and called
// through ctypes (crfr_torch/ops/_build.py). The caller allocates every
// buffer (outputs, the f32 partials, and zeroed unsigned tickets that
// outlive the call) and passes PyTorch's current stream; nothing here
// allocates or synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;      // rows a thread loads before it uses any (x and dy, or x)
constexpr int kStatsUnroll = 8; // the same for the statistics, which load x alone: the
                                // loads of a round are in flight together, the last
                                // round's under guards
constexpr int kLanes = 4;       // (column, split) pairs a thread sums in the last CTA

// The shape of a launch: R rows of `channels`, `cv` vectors a row, `vb` of
// them a CTA (a power of two, <= 32, dividing cv), `rpi` = kThreads / vb rows
// a CTA stands on at once; gridDim = (row blocks, cv / vb). The reductions
// sum the row blocks' partials in groups of `group`, then the groups'.
struct Geometry {
  long long rows;
  int channels;
  int cv;
  int vb;
  int rpi;
  int group;
};

template <int Bytes> struct RawOf;
template <> struct RawOf<16> { using type = uint4; };
template <> struct RawOf<4> { using type = uint32_t; };
template <> struct RawOf<2> { using type = uint16_t; };

// V elements of T (uint16_t holds a bf16's bits) as one load or store.
template <typename T, int V>
struct Pack {
  using Raw = typename RawOf<sizeof(T) * V>::type;
  union {
    Raw raw;
    T e[V];
  };
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(uint16_t v) {
  return __uint_as_float(static_cast<uint32_t>(v) << 16);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ uint16_t from_f<uint16_t>(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// The rows of row block `b` of `nb`: [rows * b / nb, rows * (b + 1) / nb).
__device__ __forceinline__ long long row_edge(long long rows, int b, int nb) {
  return rows * b / nb;
}

// Sums rows [lo, hi) of `src` ([2][nrows][channels] f32) over the block's
// 2 * cbch columns (channel c0 + j, both planes) into out[]: every
// (column, split) pair sums the rows lo + split, lo + split + S, ... in
// order, then each column its splits in order. `scratch` holds
// kLanes * kThreads floats. Ends with the CTA synchronised.
__device__ void sum_rows(const float* src, int nrows, int lo, int hi, int channels, int c0,
                         int cbch, float* scratch, float* out) {
  const int tid = threadIdx.x, ncol = 2 * cbch;
  const int splits = kLanes * kThreads / ncol;      // ncol <= 512, so >= 2
  const int steps = (hi - lo + splits - 1) / splits;
  float acc[kLanes];
  const float* at[kLanes];
  int first[kLanes];
#pragma unroll
  for (int i = 0; i < kLanes; ++i) {
    const int p = tid + i * kThreads, col = p % ncol;
    first[i] = lo + p / ncol;
    at[i] = src + static_cast<long long>(col / cbch) * nrows * channels + c0 + col % cbch;
    acc[i] = 0.f;
  }
#pragma unroll 4
  for (int k = 0; k < steps; ++k) {
#pragma unroll
    for (int i = 0; i < kLanes; ++i) {
      const int r = first[i] + k * splits;
      if (first[i] < lo + splits && r < hi)
        acc[i] += __ldcg(at[i] + static_cast<long long>(r) * channels);
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kLanes; ++i) scratch[tid + i * kThreads] = acc[i];
  __syncthreads();
  for (int col = tid; col < ncol; col += kThreads) {
    float s = 0.f;
    for (int sp = 0; sp < splits; ++sp) s += scratch[sp * ncol + col];
    out[col] = s;
  }
  __syncthreads();
}

// Takes a ticket of `counter` after this CTA's writes; true in the CTA that
// takes the last of `n`, which resets the counter and then sees every
// other CTA's writes.
__device__ bool last_of(unsigned* counter, int n, bool* flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    *flag = atomicAdd(counter, 1u) == static_cast<unsigned>(n - 1);
    if (*flag) *counter = 0u;
  }
  __syncthreads();
  const bool last = *flag;
  if (last) __threadfence();
  return last;
}

// Sum a[] and b[] (V channels each, the thread's) over the CTA and write
// the CTA's partials; the last CTA of each group of g.group row blocks sums
// its group's, and the last of those the groups'. Returns true in that one
// CTA a column block, where `tot` then holds the sums over every row, a
// first and b second, cbch = vb * V channels each. `part` holds
// [2][gridDim.x][C] then [2][groups][C] f32; `tickets` groups + 1 a
// column block.
template <int V>
__device__ bool reduce_over_ctas(float (&a)[V], float (&b)[V], const Geometry& g,
                                 float* __restrict__ part, unsigned* __restrict__ tickets,
                                 float* smem, float* tot) {
  __shared__ bool flag;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tv = tid % g.vb;
  const int cbch = g.vb * V;
  // lanes l and l + vb hold the same channels
  for (int off = g.vb; off < 32; off <<= 1) {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      a[k] += __shfl_xor_sync(0xffffffffu, a[k], off);
      b[k] += __shfl_xor_sync(0xffffffffu, b[k], off);
    }
  }
  if (lane < g.vb) {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      smem[(warp * 2 + 0) * cbch + tv * V + k] = a[k];
      smem[(warp * 2 + 1) * cbch + tv * V + k] = b[k];
    }
  }
  __syncthreads();
  const int nrb = gridDim.x, c0 = blockIdx.y * cbch;
  for (int j = tid; j < 2 * cbch; j += kThreads) {
    const int plane = j / cbch, ch = j % cbch;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += smem[(w * 2 + plane) * cbch + ch];
    part[(static_cast<long long>(plane) * nrb + blockIdx.x) * g.channels + c0 + ch] = s;
  }
  const int groups = (nrb + g.group - 1) / g.group, grp = blockIdx.x / g.group;
  const int lo = grp * g.group, hi = min(lo + g.group, nrb);
  unsigned* mine = tickets + blockIdx.y * (groups + 1);
  if (!last_of(mine + grp, hi - lo, &flag)) return false;
  float* gpart = part + 2LL * nrb * g.channels;
  sum_rows(part, nrb, lo, hi, g.channels, c0, cbch, smem, tot);
  for (int j = tid; j < 2 * cbch; j += kThreads)
    gpart[(static_cast<long long>(j / cbch) * groups + grp) * g.channels + c0 + j % cbch] =
        tot[j];
  if (!last_of(mine + groups, groups, &flag)) return false;
  sum_rows(gpart, groups, 0, groups, g.channels, c0, cbch, smem, tot);
  return true;
}

// Pass 1: mean and 1/sigma a channel (and the running statistics).
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
crfr_batch_norm_stats_kernel(const T* __restrict__ x, Geometry g, float* __restrict__ part,
                             unsigned* __restrict__ tickets, float* __restrict__ mean,
                             float* __restrict__ invstd, float* __restrict__ running_mean,
                             float* __restrict__ running_var, float momentum, float eps,
                             int update) {
  using P = Pack<T, V>;
  constexpr int U = kStatsUnroll;
  __shared__ float smem[kLanes * kThreads > 2 * kWarps * 32 * V ? kLanes * kThreads
                                                                 : 2 * kWarps * 32 * V];
  __shared__ float tot[2 * 32 * V];
  const int tv = threadIdx.x % g.vb, tr = threadIdx.x / g.vb, rpi = g.rpi;
  const typename P::Raw* src =
      reinterpret_cast<const typename P::Raw*>(x) + blockIdx.y * g.vb + tv;
  float s[V], q[V];
#pragma unroll
  for (int k = 0; k < V; ++k) s[k] = q[k] = 0.f;
  const long long r1 = row_edge(g.rows, blockIdx.x + 1, gridDim.x);
  for (long long r = row_edge(g.rows, blockIdx.x, gridDim.x) + tr; r < r1; r += U * rpi) {
    P p[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (r + u * rpi < r1) p[u].raw = src[(r + u * rpi) * g.cv];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (r + u * rpi < r1) {
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const float f = to_f(p[u].e[k]);
          s[k] += f;
          q[k] = fmaf(f, f, q[k]);
        }
      }
  }
  if (!reduce_over_ctas<V>(s, q, g, part, tickets, smem, tot)) return;
  const int cbch = g.vb * V;
  const float n = static_cast<float>(g.rows);
  for (int j = threadIdx.x; j < cbch; j += kThreads) {
    const int c = blockIdx.y * cbch + j;
    const float m = tot[j] / n;
    const float var = fmaxf(tot[cbch + j] / n - m * m, 0.f);
    mean[c] = m;
    invstd[c] = 1.f / sqrtf(var + eps);
    if (update) {
      running_mean[c] = (1.f - momentum) * running_mean[c] + momentum * m;
      running_var[c] = (1.f - momentum) * running_var[c] + momentum * var;
    }
  }
}

// Pass 2: y = (x - mean) * (weight / sigma) + bias, the rows backwards.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
crfr_batch_norm_transform_kernel(const T* __restrict__ x, T* __restrict__ y, Geometry g,
                                 const float* __restrict__ mean,
                                 const float* __restrict__ invstd,
                                 const float* __restrict__ weight,
                                 const float* __restrict__ bias) {
  using P = Pack<T, V>;
  constexpr int U = kUnroll;
  const int tv = threadIdx.x % g.vb, tr = threadIdx.x / g.vb, rpi = g.rpi;
  const int vec = blockIdx.y * g.vb + tv;
  float m[V], sc[V], sh[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int c = vec * V + k;
    m[k] = mean[c];
    sc[k] = invstd[c] * weight[c];
    sh[k] = bias[c];
  }
  const typename P::Raw* src = reinterpret_cast<const typename P::Raw*>(x) + vec;
  typename P::Raw* dst = reinterpret_cast<typename P::Raw*>(y) + vec;
  const long long r0 = row_edge(g.rows, blockIdx.x, gridDim.x);
  for (long long r = row_edge(g.rows, blockIdx.x + 1, gridDim.x) - 1 - tr; r >= r0;
       r -= U * rpi) {
    P p[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (r - u * rpi >= r0) p[u].raw = src[(r - u * rpi) * g.cv];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (r - u * rpi >= r0) {
        P o;
#pragma unroll
        for (int k = 0; k < V; ++k)
          o.e[k] = from_f<T>(fmaf(to_f(p[u].e[k]) - m[k], sc[k], sh[k]));
        dst[(r - u * rpi) * g.cv] = o.raw;
      }
  }
}

// Pass 3: sum(dy) and sum(dy * xhat) a channel, the bias and weight gradients.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
crfr_batch_norm_backward_reduce_kernel(const T* __restrict__ dy, const T* __restrict__ x,
                                       Geometry g, float* __restrict__ part,
                                       unsigned* __restrict__ tickets,
                                       const float* __restrict__ mean,
                                       const float* __restrict__ invstd,
                                       float* __restrict__ grad_weight,
                                       float* __restrict__ grad_bias) {
  using P = Pack<T, V>;
  constexpr int U = kUnroll;
  __shared__ float smem[kLanes * kThreads > 2 * kWarps * 32 * V ? kLanes * kThreads
                                                                 : 2 * kWarps * 32 * V];
  __shared__ float tot[2 * 32 * V];
  const int tv = threadIdx.x % g.vb, tr = threadIdx.x / g.vb, rpi = g.rpi;
  const int vec = blockIdx.y * g.vb + tv;
  float m[V], s[V], q[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    m[k] = mean[vec * V + k];
    s[k] = q[k] = 0.f;
  }
  const typename P::Raw* gsrc = reinterpret_cast<const typename P::Raw*>(dy) + vec;
  const typename P::Raw* xsrc = reinterpret_cast<const typename P::Raw*>(x) + vec;
  const long long r1 = row_edge(g.rows, blockIdx.x + 1, gridDim.x);
  for (long long r = row_edge(g.rows, blockIdx.x, gridDim.x) + tr; r < r1; r += U * rpi) {
    P pg[U], px[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (r + u * rpi < r1) {
        pg[u].raw = gsrc[(r + u * rpi) * g.cv];
        px[u].raw = xsrc[(r + u * rpi) * g.cv];
      }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (r + u * rpi < r1) {
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const float d = to_f(pg[u].e[k]);
          s[k] += d;
          q[k] = fmaf(d, to_f(px[u].e[k]) - m[k], q[k]);
        }
      }
  }
  if (!reduce_over_ctas<V>(s, q, g, part, tickets, smem, tot)) return;
  const int cbch = g.vb * V;
  for (int j = threadIdx.x; j < cbch; j += kThreads) {
    const int c = blockIdx.y * cbch + j;
    grad_bias[c] = tot[j];
    grad_weight[c] = tot[cbch + j] * invstd[c];
  }
}

// Pass 4: dx = (weight / sigma) * (dy - sum(dy) / R - xhat * sum(dy * xhat) / R),
// the rows backwards.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
crfr_batch_norm_backward_apply_kernel(const T* __restrict__ dy, const T* __restrict__ x,
                                      T* __restrict__ dx, Geometry g,
                                      const float* __restrict__ mean,
                                      const float* __restrict__ invstd,
                                      const float* __restrict__ weight,
                                      const float* __restrict__ grad_weight,
                                      const float* __restrict__ grad_bias) {
  using P = Pack<T, V>;
  constexpr int U = kUnroll;
  const int tv = threadIdx.x % g.vb, tr = threadIdx.x / g.vb, rpi = g.rpi;
  const int vec = blockIdx.y * g.vb + tv;
  const float n = static_cast<float>(g.rows);
  // dx = k1 * (dy - a - (x - mean) * b)
  float m[V], k1[V], a[V], b[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int c = vec * V + k;
    m[k] = mean[c];
    k1[k] = invstd[c] * weight[c];
    a[k] = grad_bias[c] / n;
    b[k] = grad_weight[c] / n * invstd[c];
  }
  const typename P::Raw* gsrc = reinterpret_cast<const typename P::Raw*>(dy) + vec;
  const typename P::Raw* xsrc = reinterpret_cast<const typename P::Raw*>(x) + vec;
  typename P::Raw* dst = reinterpret_cast<typename P::Raw*>(dx) + vec;
  const long long r0 = row_edge(g.rows, blockIdx.x, gridDim.x);
  for (long long r = row_edge(g.rows, blockIdx.x + 1, gridDim.x) - 1 - tr; r >= r0;
       r -= U * rpi) {
    P pg[U], px[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (r - u * rpi >= r0) {
        pg[u].raw = gsrc[(r - u * rpi) * g.cv];
        px[u].raw = xsrc[(r - u * rpi) * g.cv];
      }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (r - u * rpi >= r0) {
        P o;
#pragma unroll
        for (int k = 0; k < V; ++k)
          o.e[k] = from_f<T>(k1[k] * (to_f(pg[u].e[k]) - a[k] - (to_f(px[u].e[k]) - m[k]) * b[k]));
        dst[(r - u * rpi) * g.cv] = o.raw;
      }
  }
}

template <typename T_, int V_> struct Tag {
  using T = T_;
  static constexpr int V = V_;
};

// dtype 0 = f32, 1 = bf16; vec the channels a load: 16 bytes' worth, or 1.
template <typename F>
cudaError_t dispatch(int dtype, int vec, F&& launch) {
  if (dtype == 0 && vec == 4) return launch(Tag<float, 4>{});
  if (dtype == 0 && vec == 1) return launch(Tag<float, 1>{});
  if (dtype == 1 && vec == 8) return launch(Tag<uint16_t, 8>{});
  if (dtype == 1 && vec == 1) return launch(Tag<uint16_t, 1>{});
  return cudaErrorInvalidValue;
}

// The launch's geometry, or false if the plan does not fit the shape.
bool make_geometry(long long rows, int channels, int vec, int vb, int row_blocks, int group,
                   Geometry* g) {
  if (rows < 1 || channels < 1 || vec < 1 || channels % vec || row_blocks < 1 ||
      row_blocks > 65535 || vb < 1 || vb > 32 || (vb & (vb - 1)) || group < 1)
    return false;
  const int cv = channels / vec;
  if (cv % vb || cv / vb > 65535) return false;
  *g = Geometry{rows, channels, cv, vb, kThreads / vb, group};
  return true;
}

}  // namespace

extern "C" {

// Every function takes x (rows, channels) row-major (a channels_last NCHW
// tensor), dtype 0 = f32 or 1 = bf16, `vec` channels a load (4 f32 or 8
// bf16 on 16-byte-aligned rows, else 1), `vb` vectors a CTA's column block,
// `row_blocks` CTAs down the rows and the reductions' `group` of row blocks;
// the grid is row_blocks x (channels / vec / vb). With groups =
// ceil(row_blocks / group), `part` holds 2 * (row_blocks + groups) *
// channels f32 and `tickets` groups + 1 zeroed unsigned a column block,
// left zeroed. Returns a cudaError_t.

int crfr_batch_norm_stats(const void* x, int dtype, long long rows, int channels, int vec,
                          int vb, int row_blocks, int group, void* part, void* tickets, void* mean,
                          void* invstd, void* running_mean, void* running_var, float momentum,
                          float eps, int update, void* stream) {
  Geometry g;
  if (!make_geometry(rows, channels, vec, vb, row_blocks, group, &g))
    return cudaErrorInvalidValue;
  const dim3 grid(row_blocks, g.cv / vb);
  return dispatch(dtype, vec, [&](auto tag) {
    using T = typename decltype(tag)::T;
    constexpr int V = decltype(tag)::V;
    crfr_batch_norm_stats_kernel<T, V><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(x), g, static_cast<float*>(part), static_cast<unsigned*>(tickets),
        static_cast<float*>(mean), static_cast<float*>(invstd),
        static_cast<float*>(running_mean), static_cast<float*>(running_var), momentum, eps,
        update);
    return cudaGetLastError();
  });
}

int crfr_batch_norm_transform(const void* x, void* y, int dtype, long long rows, int channels,
                              int vec, int vb, int row_blocks, int group, const void* mean,
                              const void* invstd, const void* weight, const void* bias,
                              void* stream) {
  Geometry g;
  if (!make_geometry(rows, channels, vec, vb, row_blocks, group, &g))
    return cudaErrorInvalidValue;
  const dim3 grid(row_blocks, g.cv / vb);
  return dispatch(dtype, vec, [&](auto tag) {
    using T = typename decltype(tag)::T;
    constexpr int V = decltype(tag)::V;
    crfr_batch_norm_transform_kernel<T, V>
        <<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const T*>(x), static_cast<T*>(y), g, static_cast<const float*>(mean),
            static_cast<const float*>(invstd), static_cast<const float*>(weight),
            static_cast<const float*>(bias));
    return cudaGetLastError();
  });
}

int crfr_batch_norm_backward_reduce(const void* dy, const void* x, int dtype, long long rows,
                                    int channels, int vec, int vb, int row_blocks, int group,
                                    void* part,
                                    void* tickets, const void* mean, const void* invstd,
                                    void* grad_weight, void* grad_bias, void* stream) {
  Geometry g;
  if (!make_geometry(rows, channels, vec, vb, row_blocks, group, &g))
    return cudaErrorInvalidValue;
  const dim3 grid(row_blocks, g.cv / vb);
  return dispatch(dtype, vec, [&](auto tag) {
    using T = typename decltype(tag)::T;
    constexpr int V = decltype(tag)::V;
    crfr_batch_norm_backward_reduce_kernel<T, V>
        <<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const T*>(dy), static_cast<const T*>(x), g, static_cast<float*>(part),
            static_cast<unsigned*>(tickets), static_cast<const float*>(mean),
            static_cast<const float*>(invstd), static_cast<float*>(grad_weight),
            static_cast<float*>(grad_bias));
    return cudaGetLastError();
  });
}

int crfr_batch_norm_backward_apply(const void* dy, const void* x, void* dx, int dtype,
                                   long long rows, int channels, int vec, int vb,
                                   int row_blocks, int group, const void* mean,
                                   const void* invstd,
                                   const void* weight, const void* grad_weight,
                                   const void* grad_bias, void* stream) {
  Geometry g;
  if (!make_geometry(rows, channels, vec, vb, row_blocks, group, &g))
    return cudaErrorInvalidValue;
  const dim3 grid(row_blocks, g.cv / vb);
  return dispatch(dtype, vec, [&](auto tag) {
    using T = typename decltype(tag)::T;
    constexpr int V = decltype(tag)::V;
    crfr_batch_norm_backward_apply_kernel<T, V>
        <<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const T*>(dy), static_cast<const T*>(x), static_cast<T*>(dx), g,
            static_cast<const float*>(mean), static_cast<const float*>(invstd),
            static_cast<const float*>(weight), static_cast<const float*>(grad_weight),
            static_cast<const float*>(grad_bias));
    return cudaGetLastError();
  });
}

}  // extern "C"
