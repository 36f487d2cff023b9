// Fused bicubic resample + normalise + cast for NHWC image batches, Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels in crfr/ops/fused_pallas.py: `_kernel`
// (behind fused_degrade_normalize) and the inner `kernel` of
// fused_resize_normalize. For every image of an NHWC batch and every channel
// it computes
//
//     Y   = Wr . X . Wc^T            Wr (OH x H), Wc (OW x W)
//     out = cast((Y - 127.5) / 128)  f32 or bf16, NHWC
//
// A resize has Wr = resize_matrix(H, OH), Wc = resize_matrix(W, OW); a degrade
// (bicubic down to `low`, back up) has Wr = up_H . down_H, Wc = up_W . down_W.
//
// What bounds it on an H100: at the main path's B=256, S=112, C=3 it must read
// 9.6 MB of uint8 and write 19.3 MB of bf16, 28.9 MB, 8.7 us at 3.35 TB/s.
// The bicubic factors are narrow bands (pil 112->16: at most 27 inputs per
// output; 16->112: at most 4), so through them the function needs 0.15 GFLOP,
// 2 us at the f32 FMA peak. It is bound by bytes; tensor cores would not help.
//
// Design. Each 1-D factor arrives as a band table (built on the host by
// crfr_torch/ops/fused_preprocess.py): per output index the first input
// index and n_taps f32 weights, resize_matrix's own entries, zero-padded to
// the factor's widest span. One CTA takes one band of `rows` output rows of
// one image (a degrade's band is the whole image, a resize's 32 rows: the
// fastest measured, PERF.md), all channels together, so every row it reads
// or writes is W*C contiguous NHWC elements. A degrade, per band:
//   (s) stage: the input rows the band reads, one contiguous stretch of
//       NHWC, copied to shared memory by cp.async, 16 bytes a thread, all in
//       flight at once, so each input byte leaves device memory once. (Read
//       from global memory inside (a) instead, the loads waited on latency;
//       PERF.md.)
//   (a) vertical down, only the low-res rows the band's output rows touch
//       (at most `span`): two rows a thread, the overlap of their windows
//       loaded and converted once (uint8 by PRMT + FADD), to [span][W*C] f32;
//   (b) horizontal down, [span][low*C], and (c) horizontal up, [span][W*C],
//       one output pixel a thread, each weight loaded once for all channels:
//       the horizontal passes run on the low-res rows only;
//   (d) vertical up fused with the epilogue and the cast. A band's output
//       rows are one contiguous stretch of NHWC, stored 16 bytes a thread
//       where aligned (else 8 or 4 bytes, or one element). With four taps
//       (every bicubic upscale) each thread keeps four source rows of its
//       column chunk in registers and walks a run of output rows, so each
//       source value leaves shared memory about once.
// A resize is (s), (c) along W on its input rows, then (d) along H.
// Every sum is f32 fmaf over a row's taps in order, so the result does not
// depend on the band height. What holds it back, measured: a single wave of
// CTAs, at most two on an SM, each running its passes one after another
// behind barriers (PERF.md; crfr_torch/bench/preprocess_phases.py times each).
//
// A resize whose band of one output row does not fit in shared memory (a
// photo's last pyramid levels: 640x480 -> 18x14 reads 138 input rows of
// 1,920 bytes for one output row, 295 KB with its buffers) takes the two-pass plan
// (crfr_resize_two_pass): resize_rows_kernel runs (c) over every input row
// of the batch straight from device memory into a float32 (B, H, OW, C)
// scratch the caller allocates, and resize_cols_kernel runs (d) from that
// scratch. Same device functions, same sums in the same order, so both
// plans give the same bits where both fit. It needs no shared memory and
// so takes any size; it reads the input once and writes and reads the
// scratch once more.
//
// A low per image (degrade_lows_kernel, the train step's form; crfr's train
// step computes it as einsum('boi,bijc,bpj->bopc', W[idx], x, W[idx]),
// crfr/train/loop.py:263-278): the host builds the four band tables of
// every low of the range once, and a device table of their structs; each
// CTA reads its image's low, copies that low's four structs over p.op and
// runs the same band. The shared-memory plan holds the largest low's
// buffers, so large lows (up to S) take shorter bands (56 rows for uint8 at
// 112², 28 for f32) and the bands run as several waves. Each output's sums
// are the int form's, bit for bit. At B=512, 112², uint8 -> bf16 it must
// move 57.8 MB, 0.017 ms at 3.35 TB/s: bound by bytes.
//
// Plain C interface, built with nvcc into a shared library and called
// through ctypes (crfr_torch/ops/_build.py). The caller allocates `out` and
// passes PyTorch's current stream; nothing here allocates or synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

extern "C" {
// One 1-D bicubic factor as a band table (device pointers).
typedef struct {
  const int* start;    // [n_out] first input index of each output's window
  const float* taps;   // [n_taps][n_out] weights, zero-padded
  int n_in, n_out, n_taps;
} crfr_band;
}

namespace {

constexpr int kThreads = 384;

struct Params {
  crfr_band op[4];  // degrade: down H, down W, up H, up W; resize: H, W
  int B, C, H, W, OH, OW;
  int rows;         // output rows per CTA (the two-pass plan's rows kernel: input rows)
  int bands;        // CTAs per image
  int rows_off;     // float offset of the [span][max(W, OW)*C] buffer
  int low_off;      // degrade: float offset of the [span][low*C] buffer
  int in_vec;       // input elements per load in (a)
  int out_vec;      // outputs per store in (d)
  // a low per image (degrade_lows_kernel): image i takes the four factors
  // table[4 * (lows[i] - low0) ...], for lows in [low0, low0 + n_lows)
  const crfr_band* table;
  const int* lows;
  int low0, n_lows;
};

// Walks the items (row, column) of a grid `cols` wide, kThreads apart,
// without a division per step.
struct Walk {
  int r, c, dr, dc, cols;
  __device__ __forceinline__ explicit Walk(int cols_) : cols(cols_) {
    r = threadIdx.x / cols;
    c = threadIdx.x - r * cols;
    dr = kThreads / cols;
    dc = kThreads - dr * cols;
  }
  __device__ __forceinline__ void next() {
    r += dr;
    c += dc;
    if (c >= cols) { c -= cols; ++r; }
  }
};

// ---- loads and stores of V consecutive elements --------------------------

// V staged input pixels from shared memory, as floats.
template <int V>
__device__ __forceinline__ void load_vec(const uint8_t* p, float (&v)[V]) {
  uint32_t w[(V + 3) / 4];
  if constexpr (V == 8) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    w[0] = u.x; w[1] = u.y;
  } else if constexpr (V == 4) {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  } else {
    w[0] = *p;
  }
  // byte k into the mantissa of 2^23: (2^23 + byte) - 2^23, exact, two full-rate ops
#pragma unroll
  for (int k = 0; k < V; ++k)
    v[k] = __uint_as_float(__byte_perm(w[k >> 2], 0x4b000000u, 0x7440u | (k & 3))) - 8388608.0f;
}

template <int V>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[V]) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int k = 0; k < V; k += 4) {
      const float4 u = *reinterpret_cast<const float4*>(p + k);
      v[k] = u.x; v[k + 1] = u.y; v[k + 2] = u.z; v[k + 3] = u.w;
    }
  } else if constexpr (V == 2) {
    const float2 u = *reinterpret_cast<const float2*>(p);
    v[0] = u.x; v[1] = u.y;
  } else {
    v[0] = *p;
  }
}

template <typename T>
__device__ __forceinline__ float load_one(const T* p) {
  float v[1];
  load_vec<1>(p, v);
  return v[0];
}

template <int V>
__device__ __forceinline__ void store_vec(float* p, const float (&y)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(y[0], y[1], y[2], y[3]);
  } else {
    p[0] = y[0];
  }
}

template <int V>
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float (&y)[V]) {
  if constexpr (V == 1) {
    p[0] = __float2bfloat16(y[0]);
  } else {
    __nv_bfloat162 h[V / 2];
#pragma unroll
    for (int k = 0; k < V / 2; ++k) h[k] = __floats2bfloat162_rn(y[2 * k], y[2 * k + 1]);
    if constexpr (V == 8) {
      uint4 u;
      u.x = *reinterpret_cast<const uint32_t*>(&h[0]);
      u.y = *reinterpret_cast<const uint32_t*>(&h[1]);
      u.z = *reinterpret_cast<const uint32_t*>(&h[2]);
      u.w = *reinterpret_cast<const uint32_t*>(&h[3]);
      *reinterpret_cast<uint4*>(p) = u;
    } else if constexpr (V == 4) {
      uint2 u;
      u.x = *reinterpret_cast<const uint32_t*>(&h[0]);
      u.y = *reinterpret_cast<const uint32_t*>(&h[1]);
      *reinterpret_cast<uint2*>(p) = u;
    } else {
      *reinterpret_cast<__nv_bfloat162*>(p) = h[0];
    }
  }
}

// Copies `bytes` bytes from global to shared memory, dst and src congruent
// modulo 16: cp.async 16 bytes a thread for the aligned middle, all in
// flight at once, single bytes at the ends. Returns when the CTA has them.
__device__ __forceinline__ void stage_rows(const uint8_t* __restrict__ src,
                                           uint8_t* __restrict__ dst, int bytes) {
  const int head = min(bytes, static_cast<int>((16 - (reinterpret_cast<uintptr_t>(src) & 15)) & 15));
  const int n16 = (bytes - head) >> 4;
  for (int i = threadIdx.x; i < n16; i += kThreads) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst + head + 16 * i));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src + head + 16 * i)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (int i = threadIdx.x; i < head; i += kThreads) dst[i] = src[i];
  for (int i = head + 16 * n16 + threadIdx.x; i < bytes; i += kThreads) dst[i] = src[i];
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
}

// Built with -DCRFR_PHASE_CLOCK (crfr_torch/bench/preprocess_phases.py only),
// thread 0 of every CTA records the global timer after each pass, and its SM.
#ifdef CRFR_PHASE_CLOCK
__device__ unsigned long long* crfr_phase_clock_buf = nullptr;  // [CTA][8]
__device__ __forceinline__ void phase_clock(int k) {
  if (threadIdx.x == 0 && crfr_phase_clock_buf != nullptr) {
    unsigned long long t;
    unsigned int sm;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    crfr_phase_clock_buf[blockIdx.x * 8 + k] = t;
    crfr_phase_clock_buf[blockIdx.x * 8 + 7] = sm;
  }
}
#else
__device__ __forceinline__ void phase_clock(int) {}
#endif

// ---- the passes --------------------------------------------------------------
// Rows are NHWC rows, n_pixels*C contiguous elements, all in shared memory.
// A table's weight t of output o is taps[t * n_out + o]: threads on
// neighbouring outputs load neighbouring weights.

// acc[k] += w * src[k] for V consecutive elements.
template <int V, typename T>
__device__ __forceinline__ void tap(float (&acc)[V], const T* src, float w) {
  float v[V];
  load_vec<V>(src, v);
#pragma unroll
  for (int k = 0; k < V; ++k) acc[k] = fmaf(w, v[k], acc[k]);
}

// acc[k] = sum_t w(o, t) * src[t * len + k], t in order; four taps unrolled.
template <int V, typename T>
__device__ __forceinline__ void vertical_sum(float (&acc)[V], const T* src, int len,
                                             const crfr_band& op, int o) {
#pragma unroll
  for (int k = 0; k < V; ++k) acc[k] = 0.f;
  const float* w = op.taps + o;
  if (op.n_taps == 4) {
#pragma unroll
    for (int t = 0; t < 4; ++t) tap<V>(acc, src + t * len, __ldg(w + t * op.n_out));
  } else {
#pragma unroll 4
    for (int t = 0; t < op.n_taps; ++t) tap<V>(acc, src + t * len, __ldg(w + t * op.n_out));
  }
}

// (a) dst[r][e] = sum_t w(o0 + r, t) * src[start[o0 + r] - first + t][e] for
// r < n, e < len: V elements of two neighbouring rows a thread. The two
// windows overlap (a downscale's stride is below its taps), so each source
// element of the overlap is loaded and converted once for both sums; each
// row's sum still runs over its taps in order.
template <int V, typename Tin>
__device__ __forceinline__ void vertical(const Tin* __restrict__ src, int first,
                                         const crfr_band& op, int o0, int n, int len,
                                         float* __restrict__ dst) {
  const int T = op.n_taps;
  Walk it(len / V);
  for (; 2 * it.r < n; it.next()) {
    const int ra = 2 * it.r, oa = o0 + ra;
    const bool two = ra + 1 < n;
    const int sa = __ldg(op.start + oa) - first;
    const int sb = two ? __ldg(op.start + oa + 1) - first : sa + T;
    const int tb = two ? T : 0;                       // row b's taps (none without it)
    const float* wa = op.taps + oa;
    const float* wb = wa + 1;
    const Tin* col = src + it.c * V;
    float a[V], b[V], v[V];
#pragma unroll
    for (int k = 0; k < V; ++k) a[k] = b[k] = 0.f;
    int k = sa;
    for (const int end = min(sb, sa + T); k < end; ++k) {              // row a alone
      load_vec<V>(col + k * len, v);
      const float w = __ldg(wa + (k - sa) * op.n_out);
#pragma unroll
      for (int q = 0; q < V; ++q) a[q] = fmaf(w, v[q], a[q]);
    }
    for (; k < sa + T; ++k) {                                          // both rows
      load_vec<V>(col + k * len, v);
      const float w = __ldg(wa + (k - sa) * op.n_out), u = __ldg(wb + (k - sb) * op.n_out);
#pragma unroll
      for (int q = 0; q < V; ++q) {
        a[q] = fmaf(w, v[q], a[q]);
        b[q] = fmaf(u, v[q], b[q]);
      }
    }
    for (k = max(k, sb); k < sb + tb; ++k) {                           // row b alone
      load_vec<V>(col + k * len, v);
      const float u = __ldg(wb + (k - sb) * op.n_out);
#pragma unroll
      for (int q = 0; q < V; ++q) b[q] = fmaf(u, v[q], b[q]);
    }
    float* d = dst + ra * len + it.c * V;
#pragma unroll
    for (int q = 0; q < V; ++q) d[q] = a[q];
    if (two) {
#pragma unroll
      for (int q = 0; q < V; ++q) d[len + q] = b[q];
    }
  }
}

template <typename Tin>
__device__ __forceinline__ void vertical_by_width(int vec, const Tin* __restrict__ src, int first,
                                                  const crfr_band& op, int o0, int n, int len,
                                                  float* __restrict__ dst) {
  if constexpr (sizeof(Tin) == 1) {
    if (vec == 8) vertical<8>(src, first, op, o0, n, len, dst);
    else if (vec == 4) vertical<4>(src, first, op, o0, n, len, dst);
    else vertical<1>(src, first, op, o0, n, len, dst);
  } else {
    if (vec == 4) vertical<4>(src, first, op, o0, n, len, dst);
    else if (vec == 2) vertical<2>(src, first, op, o0, n, len, dst);
    else vertical<1>(src, first, op, o0, n, len, dst);
  }
}

// (b), (c) dst[r][q][c] = sum_t w(q, t) * src[r][start[q] + t][c] for r < n:
// one output pixel a thread, each weight loaded once for four channels.
template <typename Tsrc>
__device__ __forceinline__ void horizontal(const Tsrc* __restrict__ src, int src_len,
                                           const crfr_band& op, int n, int C,
                                           float* __restrict__ dst) {
  Walk it(op.n_out);
  for (; it.r < n; it.next()) {
    const int q = it.c;
    const Tsrc* s = src + it.r * src_len + __ldg(op.start + q) * C;
    float* d = dst + (it.r * op.n_out + q) * C;
    for (int cc = 0; cc < C; cc += 4) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int t = 0; t < op.n_taps; ++t) {
        const float wt = __ldg(op.taps + t * op.n_out + q);
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (cc + k < C) acc[k] = fmaf(wt, load_one(s + t * C + cc + k), acc[k]);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (cc + k < C) d[cc + k] = acc[k];
    }
  }
}

// (d) out[r][e] = cast((sum_t w(o0 + r, t) * src[start[o0 + r] - first + t][e]
// - 127.5) / 128) for r < n, e < len: the band's output rows, one contiguous
// stretch of NHWC, V outputs a thread (16 bytes where aligned).
template <int V, typename Tout>
__device__ __forceinline__ void vertical_store(const float* __restrict__ src, int first,
                                               const crfr_band& op, int o0, int n, int len,
                                               Tout* __restrict__ out) {
  Walk it(len / V);
  for (; it.r < n; it.next()) {
    const int o = o0 + it.r;
    float acc[V];
    vertical_sum<V>(acc, src + (__ldg(op.start + o) - first) * len + it.c * V, len, op, o);
    // (acc - 127.5) / 128 in one rounding, as the two steps give: 1/128 is a power of 2
#pragma unroll
    for (int k = 0; k < V; ++k) acc[k] = fmaf(acc[k], 1.0f / 128.0f, -127.5f / 128.0f);
    store_vec<V>(out + it.r * len + it.c * V, acc);
  }
}

// (d) for a factor of four taps (every bicubic upscale): each thread keeps
// one column chunk of four source rows in registers and walks a run of
// output rows down it, loading a source row when the window moves, so each
// source value leaves shared memory about once. Same sums, same order.
template <int V, typename Tout>
__device__ __forceinline__ void vertical_store4(const float* __restrict__ src, int first,
                                                const crfr_band& op, int o0, int n, int len,
                                                Tout* __restrict__ out) {
  const int chunks = len / V;
  const int groups = max(1, kThreads / chunks);
  const int run = (n + groups - 1) / groups;
  for (int item = threadIdx.x; item < chunks * groups; item += kThreads) {
    const int g = item / chunks;
    const int c = item - g * chunks;
    const int i1 = min(n, (g + 1) * run);
    int i = g * run;
    if (i >= i1) continue;
    const float* col = src + c * V;
    int base = __ldg(op.start + o0 + i) - first;
    float w0[V], w1[V], w2[V], w3[V];
    load_vec<V>(col + base * len, w0);
    load_vec<V>(col + (base + 1) * len, w1);
    load_vec<V>(col + (base + 2) * len, w2);
    load_vec<V>(col + (base + 3) * len, w3);
    for (; i < i1; ++i) {
      const int o = o0 + i;
      for (const int s = __ldg(op.start + o) - first; base < s; ++base) {
#pragma unroll
        for (int k = 0; k < V; ++k) { w0[k] = w1[k]; w1[k] = w2[k]; w2[k] = w3[k]; }
        load_vec<V>(col + (base + 4) * len, w3);
      }
      const float* w = op.taps + o;
      const float t0 = __ldg(w), t1 = __ldg(w + op.n_out), t2 = __ldg(w + 2 * op.n_out),
                  t3 = __ldg(w + 3 * op.n_out);
      float acc[V];
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float a = fmaf(t3, w3[k], fmaf(t2, w2[k], fmaf(t1, w1[k], fmaf(t0, w0[k], 0.f))));
        acc[k] = fmaf(a, 1.0f / 128.0f, -127.5f / 128.0f);
      }
      store_vec<V>(out + i * len + c * V, acc);
    }
  }
}

template <typename Tout>
__device__ __forceinline__ void vertical_store_by_width(int vec, const float* __restrict__ src,
                                                        int first, const crfr_band& op, int o0,
                                                        int n, int len, Tout* __restrict__ out) {
  if (op.n_taps == 4) {
    if constexpr (sizeof(Tout) == 2) {
      if (vec == 8) vertical_store4<8>(src, first, op, o0, n, len, out);
      else if (vec == 4) vertical_store4<4>(src, first, op, o0, n, len, out);
      else if (vec == 2) vertical_store4<2>(src, first, op, o0, n, len, out);
      else vertical_store4<1>(src, first, op, o0, n, len, out);
    } else {
      if (vec == 4) vertical_store4<4>(src, first, op, o0, n, len, out);
      else vertical_store4<1>(src, first, op, o0, n, len, out);
    }
    return;
  }
  if constexpr (sizeof(Tout) == 2) {
    if (vec == 8) vertical_store<8>(src, first, op, o0, n, len, out);
    else if (vec == 4) vertical_store<4>(src, first, op, o0, n, len, out);
    else if (vec == 2) vertical_store<2>(src, first, op, o0, n, len, out);
    else vertical_store<1>(src, first, op, o0, n, len, out);
  } else {
    if (vec == 4) vertical_store<4>(src, first, op, o0, n, len, out);
    else vertical_store<1>(src, first, op, o0, n, len, out);
  }
}

// One CTA's band. grid (B * bands); block kThreads; dynamic shared memory
// from make_plan(). The vertical factor into the output (up along H, or the
// resize's H) names the rows a band reads before its last pass:
// [lo, lo + nl), nl <= span.
template <typename Tin, typename Tout, bool kDegrade>
__device__ __forceinline__ void resample_band(const Tin* __restrict__ x, Tout* __restrict__ out,
                                              const Params& p) {
  extern __shared__ __align__(16) float smem[];
  phase_clock(0);
  const int img = blockIdx.x / p.bands;
  const int r0 = (blockIdx.x - img * p.bands) * p.rows;
  const int n = min(p.rows, p.OH - r0);
  const int in_len = p.W * p.C;
  const int out_len = p.OW * p.C;
  const crfr_band& last = p.op[kDegrade ? 2 : 0];
  const int lo = __ldg(last.start + r0);
  const int nl = __ldg(last.start + r0 + n - 1) + last.n_taps - lo;
  // the input rows the band reads: [in_lo, in_lo + in_n)
  int in_lo = lo, in_n = nl;
  if constexpr (kDegrade) {
    in_lo = __ldg(p.op[0].start + lo);
    in_n = __ldg(p.op[0].start + lo + nl - 1) + p.op[0].n_taps - in_lo;
  }
  const uint8_t* g = reinterpret_cast<const uint8_t*>(
      x + (static_cast<size_t>(img) * p.H + in_lo) * in_len);
  uint8_t* staged = reinterpret_cast<uint8_t*>(smem) + (reinterpret_cast<uintptr_t>(g) & 15);
  stage_rows(g, staged, in_n * in_len * static_cast<int>(sizeof(Tin)));                // (s)
  phase_clock(1);
  const Tin* xs = reinterpret_cast<const Tin*>(staged);
  float* s_rows = smem + p.rows_off;   // [span][OW*C] before (d)
  Tout* oi = out + (static_cast<size_t>(img) * p.OH + r0) * out_len;
  if constexpr (kDegrade) {
    float* s_low = smem + p.low_off;
    vertical_by_width<Tin>(p.in_vec, xs, in_lo, p.op[0], lo, nl, in_len, s_rows);       // (a)
    __syncthreads();
    phase_clock(2);
    horizontal(s_rows, in_len, p.op[1], nl, p.C, s_low);                                // (b)
    __syncthreads();
    phase_clock(3);
    horizontal(s_low, p.op[1].n_out * p.C, p.op[3], nl, p.C, s_rows);                   // (c)
  } else {
    horizontal(xs, in_len, p.op[1], nl, p.C, s_rows);                                   // (c)
  }
  __syncthreads();
  phase_clock(4);
  vertical_store_by_width<Tout>(p.out_vec, s_rows, lo, last, r0, n, out_len,
                                oi);                                                   // (d)
#ifdef CRFR_PHASE_CLOCK
  __syncthreads();
  phase_clock(5);
#endif
}

template <typename Tin, typename Tout, bool kDegrade>
__global__ void __launch_bounds__(kThreads)
resample_normalize_kernel(const Tin* __restrict__ x, Tout* __restrict__ out, const Params p) {
  resample_band<Tin, Tout, kDegrade>(x, out, p);
}

// A degrade with a low per image: the CTA reads its image's low, takes that
// low's four band tables from the device table in place of p.op, and runs
// the same band. The shared-memory plan holds the largest low's buffers. A
// low outside the table writes NaN over the band rather than read outside it.
template <typename Tin, typename Tout>
__global__ void __launch_bounds__(kThreads)
degrade_lows_kernel(const Tin* __restrict__ x, Tout* __restrict__ out, const Params p) {
  const int img = blockIdx.x / p.bands;
  const int l = __ldg(p.lows + img) - p.low0;
  if (l < 0 || l >= p.n_lows) {
    const int r0 = (blockIdx.x - img * p.bands) * p.rows;
    const int len = min(p.rows, p.OH - r0) * p.OW * p.C;
    Tout* o = out + (static_cast<size_t>(img) * p.OH + r0) * p.OW * p.C;
    const float nan = __int_as_float(0x7fc00000);
    for (int i = threadIdx.x; i < len; i += kThreads) {
      float v[1] = {nan};
      store_vec<1>(o + i, v);
    }
    return;
  }
  Params q = p;
#pragma unroll
  for (int k = 0; k < 4; ++k) q.op[k] = p.table[4 * l + k];
  resample_band<Tin, Tout, true>(x, out, q);
}

// The two-pass plan of a resize. (c) over `p.rows` of the batch's B*H input
// rows a CTA, from device memory into the f32 scratch tmp (B, H, OW, C).
template <typename Tin>
__global__ void __launch_bounds__(kThreads)
resize_rows_kernel(const Tin* __restrict__ x, float* __restrict__ tmp, const Params p) {
  const long long r0 = static_cast<long long>(blockIdx.x) * p.rows;
  const int n = static_cast<int>(min(static_cast<long long>(p.rows),
                                     static_cast<long long>(p.B) * p.H - r0));
  horizontal(x + r0 * p.W * p.C, p.W * p.C, p.op[1], n, p.C, tmp + r0 * p.OW * p.C);
}

// (d) over a band of `p.rows` output rows of one image a CTA, from the scratch.
template <typename Tout>
__global__ void __launch_bounds__(kThreads)
resize_cols_kernel(const float* __restrict__ tmp, Tout* __restrict__ out, const Params p) {
  const int img = blockIdx.x / p.bands;
  const int r0 = (blockIdx.x - img * p.bands) * p.rows;
  const int len = p.OW * p.C;
  vertical_store_by_width<Tout>(p.out_vec, tmp + static_cast<size_t>(img) * p.H * len, 0,
                                p.op[0], r0, min(p.rows, p.OH - r0), len,
                                out + (static_cast<size_t>(img) * p.OH + r0) * len);
}

// ---- host side -------------------------------------------------------------

struct Plan {
  Params p;
  int smem;   // dynamic shared memory bytes
  int ctas;
};

bool valid_band(const crfr_band& b) {
  return b.start != nullptr && b.taps != nullptr && b.n_in > 0 && b.n_out > 0 &&
         b.n_taps > 0 && b.n_taps <= b.n_in;
}

// Shapes and shared memory of one launch; false when the shapes do not chain
// or the plan does not fit in `limit` bytes.
bool make_plan(int B, int C, int in_bytes, const crfr_band* ops, int n_ops, int rows, int span,
               int in_span, int limit, Plan* plan) {
  if (B <= 0 || C <= 0 || rows <= 0 || (n_ops != 2 && n_ops != 4)) return false;
  for (int i = 0; i < n_ops; ++i)
    if (!valid_band(ops[i])) return false;
  const bool degrade = n_ops == 4;
  if (degrade && (ops[2].n_in != ops[0].n_out || ops[3].n_in != ops[1].n_out)) return false;
  if (span <= 0 || span > ops[degrade ? 2 : 0].n_in || in_span <= 0 || in_span > ops[0].n_in ||
      (!degrade && in_span != span))
    return false;
  Params& p = plan->p;
  p = Params{};
  for (int i = 0; i < n_ops; ++i) p.op[i] = ops[i];
  p.B = B;
  p.C = C;
  p.H = ops[0].n_in;
  p.W = ops[1].n_in;
  p.OH = ops[n_ops - 2].n_out;
  p.OW = ops[n_ops - 1].n_out;
  p.rows = rows < p.OH ? rows : p.OH;
  p.bands = (p.OH + p.rows - 1) / p.rows;
  // [staged input rows, 16 bytes of slack][span][max(W, OW)*C][span][low*C] (degrade)
  const long long in_len = static_cast<long long>(p.W) * C;
  const long long out_len = static_cast<long long>(p.OW) * C;
  long long floats = (in_span * in_len * in_bytes + 16 + 15) / 16 * 4;
  p.rows_off = static_cast<int>(floats);
  floats += span * (degrade && in_len > out_len ? in_len : out_len);
  if (degrade) {
    p.low_off = static_cast<int>(floats);
    floats += span * static_cast<long long>(ops[1].n_out) * C;
  }
  const long long ctas = static_cast<long long>(B) * p.bands;
  if (floats * 4 > limit || ctas > 0x7fffffffLL) return false;
  plan->smem = static_cast<int>(floats * 4);
  plan->ctas = static_cast<int>(ctas);
  return true;
}

cudaError_t smem_limit(int* bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return err;
}

// The widest vector of `widths` (elements of `elem_bytes` bytes each) that
// divides a row of `len` elements, where the pointer is aligned to the
// vector's size (at most 16 bytes).
int widest(const void* ptr, int len, int elem_bytes, const int* widths, int n) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(ptr);
  for (int i = 0; i < n; ++i) {
    const uintptr_t align = widths[i] * elem_bytes < 16 ? widths[i] * elem_bytes : 16;
    if (len % widths[i] == 0 && a % align == 0) return widths[i];
  }
  return 1;
}

template <typename Tin, typename Tout, bool kDegrade>
const void* kernel_fn() {
  return reinterpret_cast<const void*>(&resample_normalize_kernel<Tin, Tout, kDegrade>);
}

const void* kernel_for(int in_dtype, int out_dtype, bool degrade) {
  if (in_dtype == 0 && out_dtype == 0)
    return degrade ? kernel_fn<uint8_t, float, true>() : kernel_fn<uint8_t, float, false>();
  if (in_dtype == 0 && out_dtype == 1)
    return degrade ? kernel_fn<uint8_t, __nv_bfloat16, true>()
                   : kernel_fn<uint8_t, __nv_bfloat16, false>();
  if (in_dtype == 1 && out_dtype == 0)
    return degrade ? kernel_fn<float, float, true>() : kernel_fn<float, float, false>();
  if (in_dtype == 1 && out_dtype == 1)
    return degrade ? kernel_fn<float, __nv_bfloat16, true>()
                   : kernel_fn<float, __nv_bfloat16, false>();
  return nullptr;
}

template <typename Tin, typename Tout>
const void* lows_fn() {
  return reinterpret_cast<const void*>(&degrade_lows_kernel<Tin, Tout>);
}

const void* lows_kernel_for(int in_dtype, int out_dtype) {
  if (in_dtype == 0 && out_dtype == 0) return lows_fn<uint8_t, float>();
  if (in_dtype == 0 && out_dtype == 1) return lows_fn<uint8_t, __nv_bfloat16>();
  if (in_dtype == 1 && out_dtype == 0) return lows_fn<float, float>();
  if (in_dtype == 1 && out_dtype == 1) return lows_fn<float, __nv_bfloat16>();
  return nullptr;
}

// The plan of a degrade with a low per image. `ops` holds four band tables
// per low (down H, down W, up H, up W), `spans` (span, in_span) per low at
// `rows` output rows per band. Each low must plan on its own; the buffers
// take the largest span, input span and low-res width over the lows.
bool make_plan_lows(int B, int C, int in_bytes, const crfr_band* ops, int n_lows, int rows,
                    const int* spans, int limit, Plan* plan) {
  if (n_lows <= 0 || spans == nullptr) return false;
  int span = 0, in_span = 0, widest = 0;
  for (int l = 0; l < n_lows; ++l) {
    const crfr_band* o = ops + 4 * l;
    if (!make_plan(B, C, in_bytes, o, 4, rows, spans[2 * l], spans[2 * l + 1], 0x7fffffff, plan))
      return false;
    if (o[0].n_in != ops[0].n_in || o[1].n_in != ops[1].n_in || o[2].n_out != ops[2].n_out ||
        o[3].n_out != ops[3].n_out)
      return false;
    span = std::max(span, spans[2 * l]);
    in_span = std::max(in_span, spans[2 * l + 1]);
    if (o[1].n_out > ops[4 * widest + 1].n_out) widest = l;
  }
  return make_plan(B, C, in_bytes, ops + 4 * widest, 4, rows, span, in_span, limit, plan);
}

// Sets the load and store widths from the pointers, then launches `fn`.
cudaError_t launch(const void* fn, Plan& plan, const void* x, int in_dtype, void* out,
                   int out_dtype, void* stream) {
  Params& p = plan.p;
  static const int kInU8[] = {8, 4}, kInF32[] = {4, 2}, kOutBf16[] = {8, 4, 2},
                   kOutF32[] = {4};
  p.in_vec = in_dtype == 0 ? widest(x, p.W * p.C, 1, kInU8, 2)
                           : widest(x, p.W * p.C, 4, kInF32, 2);
  p.out_vec = out_dtype == 1 ? widest(out, p.OW * p.C, 2, kOutBf16, 3)
                             : widest(out, p.OW * p.C, 4, kOutF32, 1);
  cudaError_t err = cudaSuccess;
  if (plan.smem > 48 * 1024) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, plan.smem);
    if (err != cudaSuccess) return err;
  }
  void* args[] = {const_cast<void**>(&x), &out, &p};
  err = cudaLaunchKernel(fn, dim3(plan.ctas), dim3(kThreads), args, plan.smem,
                         static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// info[] of crfr_resample_info for a plan made (`ok`) or refused.
int report(const void* fn, bool ok, const Plan& plan, int refused_smem, int limit, int* info) {
  info[6] = limit;
  if (!ok) {
    info[2] = refused_smem;
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  info[0] = attr.numRegs;
  info[1] = static_cast<int>(attr.localSizeBytes);
  info[2] = plan.smem;
  info[3] = plan.ctas;
  info[4] = plan.p.rows;
  info[5] = kThreads;
  return 0;
}

// The two-pass plan: the rows kernel takes about kTwoPassPixels output
// pixels of (c) a CTA, the cols kernel bands of kTwoPassRows output rows.
constexpr int kTwoPassPixels = 2048;
constexpr int kTwoPassRows = 8;

struct TwoPass {
  Params rows, cols;
  int rows_ctas, cols_ctas;
};

// false when the bands are not a resize's two, or an image's input, scratch
// or output holds more elements than a CTA's int offsets reach.
bool make_two_pass(int B, int C, const crfr_band* ops, TwoPass* tp) {
  if (B <= 0 || C <= 0 || ops == nullptr || !valid_band(ops[0]) || !valid_band(ops[1]))
    return false;
  Params p{};
  p.op[0] = ops[0];
  p.op[1] = ops[1];
  p.B = B;
  p.C = C;
  p.H = ops[0].n_in;
  p.W = ops[1].n_in;
  p.OH = ops[0].n_out;
  p.OW = ops[1].n_out;
  const long long widest_row = std::max(p.W, p.OW) * static_cast<long long>(C);
  if (widest_row * std::max(p.H, p.OH) > 0x7fffffffLL) return false;
  p.rows = std::max(1, kTwoPassPixels / p.OW);
  const long long rows_ctas = (static_cast<long long>(B) * p.H + p.rows - 1) / p.rows;
  tp->rows = p;
  p.rows = std::min(kTwoPassRows, p.OH);
  p.bands = (p.OH + p.rows - 1) / p.rows;
  const long long cols_ctas = static_cast<long long>(B) * p.bands;
  if (rows_ctas > 0x7fffffffLL || cols_ctas > 0x7fffffffLL) return false;
  tp->cols = p;
  tp->rows_ctas = static_cast<int>(rows_ctas);
  tp->cols_ctas = static_cast<int>(cols_ctas);
  return true;
}

const void* rows_kernel_for(int in_dtype) {
  if (in_dtype == 0) return reinterpret_cast<const void*>(&resize_rows_kernel<uint8_t>);
  if (in_dtype == 1) return reinterpret_cast<const void*>(&resize_rows_kernel<float>);
  return nullptr;
}

const void* cols_kernel_for(int out_dtype) {
  if (out_dtype == 0) return reinterpret_cast<const void*>(&resize_cols_kernel<float>);
  if (out_dtype == 1) return reinterpret_cast<const void*>(&resize_cols_kernel<__nv_bfloat16>);
  return nullptr;
}

}  // namespace

extern "C" {

// x (B, H, W, C) uint8 (in_dtype 0) or f32 (1), contiguous; out (B, OH, OW, C)
// f32 (out_dtype 0) or bf16 (1), contiguous. `ops` are 4 band tables for a
// degrade (down H, down W, up H, up W) or 2 for a resize (H, W); `rows`
// output rows per CTA; `span` the most rows one band reads through the
// vertical factor into the output (up H, or the resize's H) and `in_span` the
// most input rows it reads (equal for a resize). Returns a cudaError_t: 0
// when the launch was accepted.
int crfr_resample_normalize(const void* x, int in_dtype, void* out, int out_dtype, int B, int C,
                            const crfr_band* ops, int n_ops, int rows, int span, int in_span,
                            void* stream) {
  const void* fn = kernel_for(in_dtype, out_dtype, n_ops == 4);
  int limit = 0;
  cudaError_t err = smem_limit(&limit);
  if (err != cudaSuccess) return static_cast<int>(err);
  Plan plan;
  if (fn == nullptr || x == nullptr || out == nullptr ||
      !make_plan(B, C, in_dtype == 0 ? 1 : 4, ops, n_ops, rows, span, in_span, limit, &plan))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch(fn, plan, x, in_dtype, out, out_dtype, stream));
}

// A degrade of (B, S, S, C) with a low per image. `ops` are the host's copy
// of 4 band tables per low for the lows low0 ... low0 + n_lows - 1 and
// `dev_ops` the same structs in device memory; `lows` (B,) int32 on the
// device, each image's low; `spans` (span, in_span) per low at `rows`
// output rows per band. Otherwise as crfr_resample_normalize.
int crfr_degrade_lows_normalize(const void* x, int in_dtype, void* out, int out_dtype, int B,
                                int C, const crfr_band* ops, const crfr_band* dev_ops, int n_lows,
                                int low0, const int* lows, int rows, const int* spans,
                                void* stream) {
  const void* fn = lows_kernel_for(in_dtype, out_dtype);
  int limit = 0;
  cudaError_t err = smem_limit(&limit);
  if (err != cudaSuccess) return static_cast<int>(err);
  Plan plan;
  if (fn == nullptr || x == nullptr || out == nullptr || dev_ops == nullptr || lows == nullptr ||
      !make_plan_lows(B, C, in_dtype == 0 ? 1 : 4, ops, n_lows, rows, spans, limit, &plan))
    return static_cast<int>(cudaErrorInvalidValue);
  plan.p.table = dev_ops;
  plan.p.lows = lows;
  plan.p.low0 = low0;
  plan.p.n_lows = n_lows;
  return static_cast<int>(launch(fn, plan, x, in_dtype, out, out_dtype, stream));
}

// What a call with these shapes launches: info[0] registers per thread,
// [1] local-memory (spill) bytes per thread, [2] dynamic shared memory bytes,
// [3] CTAs, [4] output rows per CTA, [5] threads per CTA, [6] the shared
// memory a CTA may have on this device. Returns a cudaError_t; when the plan
// exceeds that limit, cudaErrorInvalidValue with info[2] and info[6] filled.
int crfr_resample_info(int in_dtype, int out_dtype, int B, int C, const crfr_band* ops, int n_ops,
                       int rows, int span, int in_span, int* info) {
  const void* fn = kernel_for(in_dtype, out_dtype, n_ops == 4);
  int limit = 0;
  cudaError_t err = smem_limit(&limit);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  Plan plan;
  const int in_bytes = in_dtype == 0 ? 1 : 4;
  const bool ok = make_plan(B, C, in_bytes, ops, n_ops, rows, span, in_span, limit, &plan);
  // what the plan would need, whatever the limit
  const int need = ok ? plan.smem
      : make_plan(B, C, in_bytes, ops, n_ops, rows, span, in_span, 0x7fffffff, &plan) ? plan.smem
      : -1;
  return report(fn, ok, plan, need, limit, info);
}

// crfr_resample_info for crfr_degrade_lows_normalize's arguments.
int crfr_degrade_lows_info(int in_dtype, int out_dtype, int B, int C, const crfr_band* ops,
                           int n_lows, int rows, const int* spans, int* info) {
  const void* fn = lows_kernel_for(in_dtype, out_dtype);
  int limit = 0;
  cudaError_t err = smem_limit(&limit);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  Plan plan;
  const int in_bytes = in_dtype == 0 ? 1 : 4;
  const bool ok = make_plan_lows(B, C, in_bytes, ops, n_lows, rows, spans, limit, &plan);
  const int need = ok ? plan.smem
      : make_plan_lows(B, C, in_bytes, ops, n_lows, rows, spans, 0x7fffffff, &plan) ? plan.smem
      : -1;
  return report(fn, ok, plan, need, limit, info);
}

// A resize of x (B, H, W, C) into out (B, OH, OW, C) by the two-pass plan:
// `ops` the resize's two band tables (H, W), `tmp` a float32 (B, H, OW, C)
// scratch, 16-byte aligned. Otherwise as crfr_resample_normalize.
int crfr_resize_two_pass(const void* x, int in_dtype, void* tmp, void* out, int out_dtype, int B,
                         int C, const crfr_band* ops, void* stream) {
  const void* rows_fn = rows_kernel_for(in_dtype);
  const void* cols_fn = cols_kernel_for(out_dtype);
  TwoPass tp;
  if (rows_fn == nullptr || cols_fn == nullptr || x == nullptr || out == nullptr ||
      tmp == nullptr || reinterpret_cast<uintptr_t>(tmp) % 16 != 0 ||
      !make_two_pass(B, C, ops, &tp))
    return static_cast<int>(cudaErrorInvalidValue);
  static const int kOutBf16[] = {8, 4, 2}, kOutF32[] = {4};
  const int len = tp.cols.OW * C;
  tp.cols.out_vec = out_dtype == 1 ? widest(out, len, 2, kOutBf16, 3)
                                   : widest(out, len, 4, kOutF32, 1);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  void* rows_args[] = {const_cast<void**>(&x), &tmp, &tp.rows};
  cudaError_t err = cudaLaunchKernel(rows_fn, dim3(tp.rows_ctas), dim3(kThreads), rows_args, 0, s);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  void* cols_args[] = {&tmp, &out, &tp.cols};
  err = cudaLaunchKernel(cols_fn, dim3(tp.cols_ctas), dim3(kThreads), cols_args, 0, s);
  if (err == cudaSuccess) err = cudaGetLastError();
  return static_cast<int>(err);
}

// crfr_resample_info for the two-pass plan: info[0] and [1] the larger of
// the two kernels' registers and spill bytes, [2] 0, [3] the CTAs of both,
// [4] the output rows of a cols-kernel CTA, [5] and [6] as there.
int crfr_resize_two_pass_info(int in_dtype, int out_dtype, int B, int C, const crfr_band* ops,
                              int* info) {
  const void* fns[] = {rows_kernel_for(in_dtype), cols_kernel_for(out_dtype)};
  int limit = 0;
  cudaError_t err = smem_limit(&limit);
  if (err != cudaSuccess) return static_cast<int>(err);
  TwoPass tp;
  if (fns[0] == nullptr || fns[1] == nullptr || !make_two_pass(B, C, ops, &tp))
    return static_cast<int>(cudaErrorInvalidValue);
  info[0] = info[1] = 0;
  for (const void* fn : fns) {
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, fn);
    if (err != cudaSuccess) return static_cast<int>(err);
    info[0] = std::max(info[0], attr.numRegs);
    info[1] = std::max(info[1], static_cast<int>(attr.localSizeBytes));
  }
  info[2] = 0;
  info[3] = tp.rows_ctas + tp.cols_ctas;
  info[4] = tp.cols.rows;
  info[5] = kThreads;
  info[6] = limit;
  return 0;
}

const char* crfr_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

#ifdef CRFR_PHASE_CLOCK
// Where the kernel records its phase clock: 8 words per CTA, or nullptr.
int crfr_resample_phase_clock(void* buf) {
  return static_cast<int>(cudaMemcpyToSymbol(crfr_phase_clock_buf, &buf, sizeof(buf)));
}
#endif

}  // extern "C"
