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
// crfr/train/loop.py:263-278). At B=512, 112², uint8 -> bf16 it must move
// 57.8 MB, 0.017 ms at 3.35 TB/s: bound by bytes. The lows stay on the
// device (the host never reads them), so the host plans every low of the
// range once (crfr_torch/ops/fused_preprocess.py, lows_plan, which owns the
// layout): each low gets its own band height, the tallest whose buffers fit
// the shared memory of one of kLowsCtasPerSm CTAs an SM (whole images for
// uint8 lows up to 57 at 112², 56 rows up to 91, 28 above), or of fewer
// CTAs where some low fits no height in that (float32 pil input at
// 112²x3: a row of output at low 8 reads ~100 input rows); each low's
// [span][low*C] buffer lies over its staged input rows, which (a) has read
// before (b) writes it. The host uploads a crfr_low_plan record a low
// beside its four band structs; here make_plan_lows only checks that each
// record's buffers fit and do not clash. A launch sizes its shared memory
// for the largest of those records and covers B x (the most bands of any
// low) CTAs, band-major: band 0 of every image first (the whole images,
// the costliest CTAs), then band 1, ... Two CTAs an SM overlap one CTA's
// passes and barriers with the other's: at one CTA an SM (one plan for all
// lows) each CTA's passes ran one after another with nothing to hide them.
// A CTA reads its image's low and that low's record and structs, returns at
// once where its band index is past that low's bands, and else runs the
// int form's band. Each output's sums are the int form's, bit for bit,
// whatever the height.
//
// The ragged forms, for a detector's photo (crfr_pyramid_normalize,
// crfr_crop_resize_normalize). A pyramid is every level of one photo, each
// resized from the photo itself (a level made from the one above would
// change the numbers); a stage's crops are boxes of one photo, each a
// window of it read as zero outside the photo. One launch takes them all:
// a device table of crfr_windows gives each resized image's two factors,
// origin and output offset, and each CTA takes one tile of one of them (a
// pyramid: a table of crfr_tiles, (level, row band, column tile), the
// costliest first; crops: a band of rows of one crop, from blockIdx). What
// bounds a pyramid: at 640x480 uint8 -> f32, min_face 20, it must read the
// photo once (0.92 MB) and write its ten levels once (2.68 MB), 1.07 us at
// 3.35 TB/s, and through the banded factors it needs 86 MFLOP, 1.29 us at
// the f32 FMA peak (1280x720: 10.8 MB, 3.22 us; 282 MFLOP, 4.20 us): bytes
// and operations alike, a few microseconds. A launch a level left the deep
// levels 1-14 CTAs, each walking ~200 taps. Here every level is cut into
// tiles whose horizontal sums fit 32 KB of shared memory and whose
// multiply-adds stay under 2^18, columns split first (no work done twice),
// then rows: the deep levels take hundreds of CTAs. A tile stages the input
// it reads a chunk of rows at a time, only its own columns, coalesced (a
// warp a row, 8 loads a lane in flight), keeps its horizontal weights in
// shared memory and runs (c) one output element a thread; the photo stays
// in L2, so the tiles' overlapping reads come from there (PERF.md times
// the passes: crfr_torch/bench/ragged_levels.py --phases). No
// sum is split: each output's taps run in order, by the band plans' own
// device functions, so every level and crop equals a launch of its own bit
// for bit.
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

// One resized image of a ragged launch: a pyramid level of the photo, or a
// crop of it (the window of v.n_in x h.n_in pixels at (y0, x0), zero
// outside the photo; v.n_in == 0 for a box with no area).
typedef struct {
  crfr_band v, h;      // the factors along H and along W
  int y0, x0;
  long long out;       // element offset of its first output
} crfr_window;

// A pyramid CTA's work: output rows [o0, o0 + n), columns [q0, q0 + m) of
// window `window`.
typedef struct {
  int window, o0, n, q0, m;
} crfr_tile;

// One low's plan in a degrade with a low per image: output rows per band,
// the float offsets of its [span][W*C] and [span][low*C] buffers (its
// staged input rows start at 0), and its bytes of shared memory.
typedef struct {
  int rows, rows_off, low_off, smem;
} crfr_low_plan;
}

namespace {

constexpr int kThreads = 384;
// CTAs an SM that the form with a low per image plans for: its registers
// are held to it, and the host reads it (crfr_degrade_lows_device) to size
// each low's shared memory. Three, at 56 registers, spilled and ran slower
// than two (PERF.md).
constexpr int kLowsCtasPerSm = 2;

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
  // table[4 * l ...] and the plan plans[l], l = lows[i] - low0 < n_lows
  const crfr_band* table;
  const crfr_low_plan* plans;
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
// word 6 of the CTA's record: what it worked on (a low per image: the low)
__device__ __forceinline__ void phase_tag(int v) {
  if (threadIdx.x == 0 && crfr_phase_clock_buf != nullptr)
    crfr_phase_clock_buf[blockIdx.x * 8 + 6] = v;
}
#else
__device__ __forceinline__ void phase_clock(int) {}
__device__ __forceinline__ void phase_tag(int) {}
#endif

// The ragged forms' tile, under CRFR_PHASE_CLOCK: thread 0 sums the time of
// its chunks' staging ([CTA][2]) and horizontal passes ([CTA][3]) in ns;
// phase_clock(0), (1), (4) mark the tile's start, its last chunk and its end.
struct PassTimer {
#ifdef CRFR_PHASE_CLOCK
  unsigned long long t = 0, sum[2] = {0, 0};
  __device__ __forceinline__ static unsigned long long now() {
    unsigned long long v;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(v));
    return v;
  }
  __device__ __forceinline__ void start() { t = now(); }
  __device__ __forceinline__ void lap(int k) {
    const unsigned long long v = now();
    sum[k] += v - t;
    t = v;
  }
  __device__ __forceinline__ void store() const {
    if (threadIdx.x == 0 && crfr_phase_clock_buf != nullptr) {
      crfr_phase_clock_buf[blockIdx.x * 8 + 2] = sum[0];
      crfr_phase_clock_buf[blockIdx.x * 8 + 3] = sum[1];
    }
  }
#else
  __device__ __forceinline__ void start() {}
  __device__ __forceinline__ void lap(int) {}
  __device__ __forceinline__ void store() const {}
#endif
};

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

// One CTA's band: output rows [r0, r0 + rows) of image img; block kThreads;
// dynamic shared memory from make_plan(). The vertical factor into the
// output (up along H, or the resize's H) names the rows a band reads before
// its last pass: [lo, lo + nl), nl <= span.
template <typename Tin, typename Tout, bool kDegrade>
__device__ __forceinline__ void resample_band(const Tin* __restrict__ x, Tout* __restrict__ out,
                                              const Params& p, int img, int r0) {
  extern __shared__ __align__(16) float smem[];
  phase_clock(0);
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
  const int img = blockIdx.x / p.bands;
  resample_band<Tin, Tout, kDegrade>(x, out, p, img, (blockIdx.x - img * p.bands) * p.rows);
}

// A degrade with a low per image. grid (bands * B), band-major: CTA i takes
// band i / B of image i % B. It reads the image's low, takes that low's plan
// and four band tables from the device tables in place of p's, and runs the
// int form's band, or returns where the low has fewer bands. A low outside
// the table writes NaN over the image (band 0's CTA) rather than read
// outside it.
template <typename Tin, typename Tout>
__global__ void __launch_bounds__(kThreads, kLowsCtasPerSm)
degrade_lows_kernel(const Tin* __restrict__ x, Tout* __restrict__ out, const Params p) {
  const int img = blockIdx.x % p.B;
  const int band = blockIdx.x / p.B;
  const int l = __ldg(p.lows + img) - p.low0;
  if (l < 0 || l >= p.n_lows) {
    if (band != 0) return;
    const int len = p.OH * p.OW * p.C;
    Tout* o = out + static_cast<size_t>(img) * len;
    const float nan = __int_as_float(0x7fc00000);
    for (int i = threadIdx.x; i < len; i += kThreads) {
      float v[1] = {nan};
      store_vec<1>(o + i, v);
    }
    return;
  }
  const int4 plan = __ldg(reinterpret_cast<const int4*>(p.plans) + l);
  if (band * plan.x >= p.OH) return;
  Params q = p;
#pragma unroll
  for (int k = 0; k < 4; ++k) q.op[k] = p.table[4 * l + k];
  q.rows = plan.x;
  q.rows_off = plan.y;
  q.low_off = plan.z;
  phase_tag(l + p.low0);
  resample_band<Tin, Tout, true>(x, out, q, img, band * plan.x);
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

// ---- the ragged forms: a photo's pyramid, a stage's crops -------------------

constexpr int kStageLoads = 8;   // loads a thread keeps in flight while staging a tile

struct Ragged {
  const crfr_window* win;   // the resized images
  const crfr_tile* tiles;   // the pyramid: one tile a CTA (crops: nullptr)
  int H, W, C;              // the photo
  int taps_off;             // bytes: where a tile's horizontal weights start in shared memory
  int stage_off;            // bytes: where the staging area starts
  int stage_bytes;          // its size
  int size;                 // crops: the output side; a CTA's tile of rows x cols,
  int rows, cols;           // bands x col_tiles tiles a crop
  int bands, col_tiles;
};

// One tile of a resized image w: output rows [o0, o0 + n) and columns
// [q0, q0 + m), written at `out` (the tile's first output; rows
// w.h.n_out * C apart). The image is the window of the photo x of
// w.v.n_in x w.h.n_in pixels at (w.y0, w.x0); with kPad, pixels outside the
// photo read 0. The input rows the tile reads, [lo, lo + nl), are staged a
// chunk at a time, only the columns its m outputs read (`pitch` elements
// a row), a warp a row, coalesced; (c) runs on each chunk into
// [nl][m*C] f32 at the start of shared memory, then (d) on those. The sums
// are the band plans' own, in the same order: (c) as `horizontal` takes
// each channel's taps, (d) by vertical_sum, so each output equals a
// per-image launch's bit for bit.
template <typename Tin, typename Tout, bool kPad>
__device__ __forceinline__ void resize_tile(const Tin* __restrict__ x, const Ragged& p,
                                            const crfr_window& w, int o0, int n, int q0, int m,
                                            Tout* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  const crfr_band& v = w.v;
  const crfr_band& h = w.h;
  const int C = p.C;
  const int len = m * C;
  const int lo = __ldg(v.start + o0);
  const int nl = __ldg(v.start + o0 + n - 1) + v.n_taps - lo;
  const int cl = __ldg(h.start + q0);
  const int pitch = (__ldg(h.start + q0 + m - 1) + h.n_taps - cl) * C;
  const int chunk = min(nl, p.stage_bytes / (pitch * static_cast<int>(sizeof(Tin))));
  Tin* staged = reinterpret_cast<Tin*>(reinterpret_cast<uint8_t*>(smem) + p.stage_off);
  const long long row_len = static_cast<long long>(p.W) * C;
  const long long col0 = static_cast<long long>(w.x0 + cl) * C;   // element of the first column
  PassTimer timer;
  phase_clock(0);
  // the tile's horizontal weights, [t][j]: read at every tap, from the L2
  // they would wait hundreds of cycles (the staging evicts them from L1)
  float* s_taps = reinterpret_cast<float*>(reinterpret_cast<uint8_t*>(smem) + p.taps_off);
  for (int e = threadIdx.x; e < h.n_taps * m; e += kThreads) {
    const int t = e / m;
    s_taps[e] = __ldg(h.taps + t * h.n_out + q0 + e - t * m);
  }
  const int lane = threadIdx.x & 31;
  for (int i0 = 0; i0 < nl; i0 += chunk) {
    timer.start();
    const int k = min(chunk, nl - i0);
    // a warp a row, its lanes along it, kStageLoads loads a lane in flight
    // before their stores (one at a time, each waited on the L2's latency)
    for (int r = threadIdx.x >> 5; r < k; r += kThreads / 32) {
      const long long row = w.y0 + lo + i0 + r;
      const bool row_in = !kPad || (row >= 0 && row < p.H);
      const long long base = row * row_len + col0;
      Tin* dst = staged + r * pitch;
      for (int c0 = lane; c0 < pitch; c0 += 32 * kStageLoads) {
        Tin vals[kStageLoads];
#pragma unroll
        for (int u = 0; u < kStageLoads; ++u) {
          const int c = c0 + 32 * u;
          vals[u] = Tin(0);
          if (row_in && c < pitch && (!kPad || (col0 + c >= 0 && col0 + c < row_len)))
            vals[u] = __ldg(x + base + c);
        }
#pragma unroll
        for (int u = 0; u < kStageLoads; ++u)
          if (c0 + 32 * u < pitch) dst[c0 + 32 * u] = vals[u];
      }
    }
    __syncthreads();
    timer.lap(0);
    // (c), one output element a thread: a tile of few columns keeps more
    // threads busy than horizontal()'s pixel a thread; the same sums
    Walk it(len);
    for (; it.r < k; it.next()) {
      const int j = it.c / C;
      const Tin* src = staged + it.r * pitch + (__ldg(h.start + q0 + j) - cl) * C + it.c - j * C;
      float acc = 0.f;
#pragma unroll 4
      for (int t = 0; t < h.n_taps; ++t) acc = fmaf(s_taps[t * m + j], load_one(src + t * C), acc);
      smem[(i0 + it.r) * len + it.c] = acc;
    }
    __syncthreads();
    timer.lap(1);
  }
  phase_clock(1);
  timer.store();
  Walk it(len);                                                                         // (d)
  for (; it.r < n; it.next()) {
    const int o = o0 + it.r;
    float acc[1];
    vertical_sum<1>(acc, smem + (__ldg(v.start + o) - lo) * len + it.c, len, v, o);
    acc[0] = fmaf(acc[0], 1.0f / 128.0f, -127.5f / 128.0f);
    store_vec<1>(out + static_cast<size_t>(it.r) * h.n_out * C + it.c, acc);
  }
#ifdef CRFR_PHASE_CLOCK
  __syncthreads();
  phase_clock(4);
#endif
}

// Every level of a photo's pyramid: CTA i takes tile p.tiles[i].
template <typename Tin, typename Tout>
__global__ void __launch_bounds__(kThreads)
pyramid_kernel(const Tin* __restrict__ x, Tout* __restrict__ out, const Ragged p) {
  const crfr_tile t = p.tiles[blockIdx.x];
  const crfr_window w = p.win[t.window];
  resize_tile<Tin, Tout, false>(
      x, p, w, t.o0, t.n, t.q0, t.m,
      out + w.out + (static_cast<size_t>(t.o0) * w.h.n_out + t.q0) * p.C);
}

// Every crop of a stage: a crop is p.bands x p.col_tiles tiles of p.rows x
// p.cols outputs, one a CTA, in order. A crop with no area (w.v.n_in == 0)
// is (0 - 127.5) / 128 everywhere.
template <typename Tin, typename Tout>
__global__ void __launch_bounds__(kThreads)
crop_kernel(const Tin* __restrict__ x, Tout* __restrict__ out, const Ragged p) {
  const int per_crop = p.bands * p.col_tiles;
  const int i = blockIdx.x / per_crop;
  const int band = (blockIdx.x - i * per_crop) / p.col_tiles;
  const int o0 = band * p.rows;
  const int q0 = (blockIdx.x - i * per_crop - band * p.col_tiles) * p.cols;
  const int n = min(p.rows, p.size - o0);
  const int m = min(p.cols, p.size - q0);
  const crfr_window w = p.win[i];
  Tout* o = out + w.out + (static_cast<size_t>(o0) * p.size + q0) * p.C;
  if (w.v.n_in <= 0) {
    Walk it(m * p.C);
    for (; it.r < n; it.next()) {
      float y[1] = {fmaf(0.f, 1.0f / 128.0f, -127.5f / 128.0f)};
      store_vec<1>(o + it.r * p.size * p.C + it.c, y);
    }
    return;
  }
  resize_tile<Tin, Tout, true>(x, p, w, o0, n, q0, m, o);
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
// per low (down H, down W, up H, up W), `plans` a crfr_low_plan per low and
// `spans` (span, in_span) per low at that low's band height. The host lays
// each low's buffers out (lows_plan); this checks only that they fit: the
// sizes come from make_plan (the int form's plan of that low and height),
// the offsets from the record, 16-byte aligned. The [span][W*C] buffer may
// meet neither the staged rows nor the [span][low*C] buffer; the latter may
// lie over the staged rows, which (a) has read before (b) writes it. The
// launch takes the most shared memory and the most bands of any low, and
// reports the shortest band height as its rows.
bool make_plan_lows(int B, int C, int in_bytes, const crfr_band* ops, int n_lows,
                    const crfr_low_plan* plans, const int* spans, int limit, Plan* plan) {
  if (n_lows <= 0 || plans == nullptr || spans == nullptr) return false;
  int smem = 0, bands = 0, rows = 0;
  for (int l = 0; l < n_lows; ++l) {
    const crfr_band* o = ops + 4 * l;
    const crfr_low_plan& lp = plans[l];
    if (!make_plan(B, C, in_bytes, o, 4, lp.rows, spans[2 * l], spans[2 * l + 1], 0x7fffffff,
                   plan))
      return false;
    // make_plan's layout: [staged rows + slack][span][W*C][span][low*C]
    const Params& q = plan->p;
    const long long staged = q.rows_off, row_buf = q.low_off - q.rows_off;
    const long long low_buf = plan->smem / 4 - q.low_off;
    const long long rows_end = static_cast<long long>(lp.rows_off) + row_buf;
    const long long low_end = static_cast<long long>(lp.low_off) + low_buf;
    const bool apart = rows_end <= lp.low_off || low_end <= lp.rows_off;
    if (o[0].n_in != ops[0].n_in || o[1].n_in != ops[1].n_in || o[2].n_out != ops[2].n_out ||
        o[3].n_out != ops[3].n_out || q.rows != lp.rows || lp.rows_off % 4 != 0 ||
        lp.low_off % 4 != 0 || lp.low_off < 0 || lp.rows_off < staged || !apart ||
        std::max(rows_end, low_end) * 4 > lp.smem)
      return false;
    smem = std::max(smem, lp.smem);
    if (q.bands > bands) {
      bands = q.bands;
      rows = lp.rows;
    }
  }
  const long long ctas = static_cast<long long>(B) * bands;
  if (smem > limit || ctas > 0x7fffffffLL) {
    plan->smem = smem;
    return false;
  }
  plan->p.rows = rows;
  plan->p.bands = bands;
  plan->p.rows_off = plan->p.low_off = 0;   // each CTA takes its low's
  plan->smem = smem;
  plan->ctas = static_cast<int>(ctas);
  return true;
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
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err == cudaSuccess && plan.smem > 48 * 1024)
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, plan.smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[7], fn, kThreads, plan.smem);
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

template <typename Tin, typename Tout>
const void* ragged_fn(bool crops) {
  return crops ? reinterpret_cast<const void*>(&crop_kernel<Tin, Tout>)
               : reinterpret_cast<const void*>(&pyramid_kernel<Tin, Tout>);
}

const void* ragged_kernel_for(int in_dtype, int out_dtype, bool crops) {
  if (in_dtype == 0 && out_dtype == 0) return ragged_fn<uint8_t, float>(crops);
  if (in_dtype == 0 && out_dtype == 1) return ragged_fn<uint8_t, __nv_bfloat16>(crops);
  if (in_dtype == 1 && out_dtype == 0) return ragged_fn<float, float>(crops);
  if (in_dtype == 1 && out_dtype == 1) return ragged_fn<float, __nv_bfloat16>(crops);
  return nullptr;
}

// Checks a ragged launch's arguments against the device, then launches `fn`
// over `ctas` CTAs with `smem` bytes of dynamic shared memory: a tile's
// horizontal sums below byte `taps_off`, its horizontal weights below
// `stage_off`, the staging area from there to the end (both offsets
// multiples of 16).
int launch_ragged(const void* fn, const void* x, void* out, Ragged& p, int ctas, int taps_off,
                  int stage_off, int smem, void* stream) {
  int limit = 0;
  cudaError_t err = smem_limit(&limit);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (fn == nullptr || x == nullptr || out == nullptr || p.win == nullptr || p.H <= 0 ||
      p.W <= 0 || p.C <= 0 || ctas <= 0 || taps_off <= 0 || taps_off % 16 != 0 ||
      stage_off <= taps_off || stage_off % 16 != 0 || smem <= stage_off || smem > limit)
    return static_cast<int>(cudaErrorInvalidValue);
  p.taps_off = taps_off;
  p.stage_off = stage_off;
  p.stage_bytes = smem - stage_off;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  void* args[] = {const_cast<void**>(&x), &out, &p};
  err = cudaLaunchKernel(fn, dim3(ctas), dim3(kThreads), args, smem,
                         static_cast<cudaStream_t>(stream));
  if (err == cudaSuccess) err = cudaGetLastError();
  return static_cast<int>(err);
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
// `dev_ops` the same structs in device memory; `plans` a crfr_low_plan per
// low (host) and `dev_plans` the same records in device memory (16-byte
// aligned); `spans` (span, in_span) per low at its band height; `lows` (B,)
// int32 on the device, each image's low, never read here. Otherwise as
// crfr_resample_normalize.
int crfr_degrade_lows_normalize(const void* x, int in_dtype, void* out, int out_dtype, int B,
                                int C, const crfr_band* ops, const crfr_band* dev_ops, int n_lows,
                                int low0, const int* lows, const crfr_low_plan* plans,
                                const crfr_low_plan* dev_plans, const int* spans, void* stream) {
  const void* fn = lows_kernel_for(in_dtype, out_dtype);
  int limit = 0;
  cudaError_t err = smem_limit(&limit);
  if (err != cudaSuccess) return static_cast<int>(err);
  Plan plan;
  if (fn == nullptr || x == nullptr || out == nullptr || dev_ops == nullptr || lows == nullptr ||
      dev_plans == nullptr || reinterpret_cast<uintptr_t>(dev_plans) % 16 != 0 ||
      !make_plan_lows(B, C, in_dtype == 0 ? 1 : 4, ops, n_lows, plans, spans, limit, &plan))
    return static_cast<int>(cudaErrorInvalidValue);
  plan.p.table = dev_ops;
  plan.p.plans = dev_plans;
  plan.p.lows = lows;
  plan.p.low0 = low0;
  plan.p.n_lows = n_lows;
  return static_cast<int>(launch(fn, plan, x, in_dtype, out, out_dtype, stream));
}

// What a call with these shapes launches: info[0] registers per thread,
// [1] local-memory (spill) bytes per thread, [2] dynamic shared memory bytes,
// [3] CTAs, [4] output rows per CTA, [5] threads per CTA, [6] the shared
// memory a CTA may have on this device, [7] CTAs an SM holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor). Returns a cudaError_t;
// when the plan exceeds that limit, cudaErrorInvalidValue with info[2] and
// info[6] filled.
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

// crfr_resample_info for crfr_degrade_lows_normalize's arguments; info[4]
// the shortest band height of any low (the one that sets the CTAs).
int crfr_degrade_lows_info(int in_dtype, int out_dtype, int B, int C, const crfr_band* ops,
                           int n_lows, const crfr_low_plan* plans, const int* spans, int* info) {
  const void* fn = lows_kernel_for(in_dtype, out_dtype);
  int limit = 0;
  cudaError_t err = smem_limit(&limit);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  Plan plan;
  const int in_bytes = in_dtype == 0 ? 1 : 4;
  const bool ok = make_plan_lows(B, C, in_bytes, ops, n_lows, plans, spans, limit, &plan);
  const int need = ok ? plan.smem
      : make_plan_lows(B, C, in_bytes, ops, n_lows, plans, spans, 0x7fffffff, &plan) ? plan.smem
      : -1;
  return report(fn, ok, plan, need, limit, info);
}

// What the host plans a low per image for, on the current device: out[0]
// the shared memory of an SM, [1] the shared memory the device reserves for
// each CTA, [2] the most a CTA may have, [3] kLowsCtasPerSm.
int crfr_degrade_lows_device(int* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&out[0], cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&out[1], cudaDevAttrReservedSharedMemoryPerBlock, dev);
  if (err == cudaSuccess) err = smem_limit(&out[2]);
  out[3] = kLowsCtasPerSm;
  return static_cast<int>(err);
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
// [4] the output rows of a cols-kernel CTA, [5] and [6] as there, [7] the
// fewer CTAs an SM of the two kernels.
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
  info[7] = 0;
  for (const void* fn : fns) {
    int n = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, kThreads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    info[7] = info[7] == 0 ? n : std::min(info[7], n);
  }
  return 0;
}

// Every level of the pyramid of one photo x (H, W, C), uint8 (in_dtype 0) or
// f32 (1), contiguous, into the one buffer `out`, f32 (out_dtype 0) or bf16
// (1): `windows` (device) a crfr_window a level (y0 = x0 = 0, v.n_in = H,
// h.n_in = W, `out` the level's offset in the buffer); `tiles` (device)
// n_tiles crfr_tiles, one a CTA; `smem` bytes of dynamic shared memory: the
// [nl][m*C] f32 sums of the largest tile below `taps_off`, the largest
// tile's [taps][m] horizontal weights below `stage_off`, the staging area
// above. Returns a cudaError_t: 0 when the launch was accepted.
int crfr_pyramid_normalize(const void* x, int in_dtype, void* out, int out_dtype, int H, int W,
                           int C, const void* windows, const void* tiles, int n_tiles,
                           int taps_off, int stage_off, int smem, void* stream) {
  Ragged p{};
  p.win = static_cast<const crfr_window*>(windows);
  p.tiles = static_cast<const crfr_tile*>(tiles);
  p.H = H;
  p.W = W;
  p.C = C;
  if (tiles == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch_ragged(ragged_kernel_for(in_dtype, out_dtype, false), x, out, p, n_tiles,
                       taps_off, stage_off, smem, stream);
}

// n crops of the image x (H, W, C), each resized to size x size, into `out`
// (n, size, size, C): `windows` (device) a crfr_window a crop (its box's
// origin and factors, `out` = i * size * size * C; v.n_in = 0 for a box with
// no area), in tiles of `rows` x `cols` outputs, one a CTA. Otherwise as
// crfr_pyramid_normalize.
int crfr_crop_resize_normalize(const void* x, int in_dtype, void* out, int out_dtype, int H,
                               int W, int C, const void* windows, int n, int size, int rows,
                               int cols, int taps_off, int stage_off, int smem, void* stream) {
  Ragged p{};
  p.win = static_cast<const crfr_window*>(windows);
  p.H = H;
  p.W = W;
  p.C = C;
  p.size = size;
  p.rows = rows;
  p.cols = cols;
  if (n <= 0 || size <= 0 || rows <= 0 || rows > size || cols <= 0 || cols > size)
    return static_cast<int>(cudaErrorInvalidValue);
  p.bands = (size + rows - 1) / rows;
  p.col_tiles = (size + cols - 1) / cols;
  const long long ctas = static_cast<long long>(n) * p.bands * p.col_tiles;
  if (ctas > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  return launch_ragged(ragged_kernel_for(in_dtype, out_dtype, true), x, out, p,
                       static_cast<int>(ctas), taps_off, stage_off, smem, stream);
}

// The ragged kernels as compiled: info[0] registers per thread, [1] local
// (spill) bytes per thread, [2] threads per CTA, [3] the shared memory a CTA
// may have on this device; `crops` 0 for the pyramid kernel, 1 for crops.
int crfr_ragged_info(int in_dtype, int out_dtype, int crops, int* info) {
  const void* fn = ragged_kernel_for(in_dtype, out_dtype, crops != 0);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  int limit = 0;
  cudaError_t err = smem_limit(&limit);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  info[0] = attr.numRegs;
  info[1] = static_cast<int>(attr.localSizeBytes);
  info[2] = kThreads;
  info[3] = limit;
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
