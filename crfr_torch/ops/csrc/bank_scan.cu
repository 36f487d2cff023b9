// Per-(probe, gallery tile) maxima of int8 bank scores, Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_tilemax_kernel` behind `bank_tilemax` in
// crfr/ops/bank_scan.py: phase 1 of the exact three-phase top-k over an int8
// gallery bank. For int8 probes pq (N x D), an int8 bank q (M x D), f32 row
// scales sc (M) and a validity mask (M) it computes, for every probe n and
// every tile t of kTile consecutive bank rows,
//
//     out[n, t] = max over rows r of tile t of
//                 (valid[r] ? float(sum_d pq[n,d] * q[r,d]) * sc[r] : -3e38)
//
// Rows at or past M count as invalid, so the ragged last tile needs no
// padding. The output is (N, ceil(M / kTile)) f32, probes in rows (the TPU
// kernel's transposed layout was a Pallas block rule).
//
// Exactness. The dot accumulates in s32 with __dp4a; |sum| <= 1024 * 127^2
// < 2^24, so the float conversion is exact and equals the f32 product of the
// int8 values that the plain version computes. The score is one rounded
// multiply (__fmul_rn, so nvcc cannot contract it into an FMA), and an
// invalid row is a select, not a bias: the TPU kernel's `acc * sc + bias`
// gives the same bits, since adding a bias of 0 is exact and -3e38 plus any
// score rounds back to -3e38. So the kernel equals its plain version exactly.
//
// What bounds it on an H100. At the serving shape (N = 256, M = 2^20,
// D = 512) the function reads 537 MB of bank, 4 MB of scales and 1 MB of
// mask and writes 8 MB: 0.165 ms at 3.35 TB/s. It does 2*N*M*D = 275 G int8
// operations: 0.139 ms at the tensor cores' 1,979 TOP/s. So bytes bound it,
// with the two sides close. This design does not reach either: __dp4a runs
// on the integer pipes, about 120 TOP/s on the whole card, so ~2.3 ms at
// that shape. Reaching the bound needs int8 tensor cores (wgmma with TMA
// loads, all probes resident in shared memory so the bank streams once).
//
// Design. One CTA of 256 threads takes one tile of kTile = 128 bank rows
// against kProbes = 64 probes; the grid walks (tile, probe block) with the
// probe block fastest, so the CTAs sharing a tile run together and read it
// from device memory once and from L2 after that (re-reading the bank from
// device memory once per probe block would multiply its bytes by N / 64).
// The CTA loops over D in chunks of 64 bytes: each chunk of the tile and of
// the probes is staged transposed in shared memory (word-major, 12 KB), so a
// lane reads its 4 rows as one 16-byte load and a warp's 8 probes are a
// broadcast. Each thread keeps 4 rows x 8 probes of s32 sums. The epilogue
// scales, masks and takes the max over the thread's rows, then over the
// warp's 32 lanes with shuffles (a warp covers the tile's 128 rows), and one
// lane writes the warp's 8 maxima.
//
// Plain C interface, built with nvcc into a shared library and called
// through ctypes (crfr_torch/ops/_build.py). The caller allocates `out` and
// passes PyTorch's current stream; nothing here allocates or synchronises.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 128;             // bank rows per output tile (and per CTA)
constexpr int kProbes = 64;            // probes per CTA
constexpr int kThreads = 256;          // 8 warps
constexpr int kChunk = 64;             // bytes of D staged per step
constexpr int kWords = kChunk / 4;     // 16 int8x4 words per row per step
constexpr int kParts = kChunk / 16;    // 16-byte loads per row per step
constexpr int kRowsPerLane = kTile / 32;                 // 4
constexpr int kProbesPerWarp = kProbes / (kThreads / 32);  // 8
constexpr int kMaxD = 1024;            // D * 127^2 < 2^24 keeps float(acc) exact
constexpr float kNeg = -3.0e38f;

__global__ void __launch_bounds__(kThreads)
bank_tilemax_kernel(const int8_t* __restrict__ pq, const int8_t* __restrict__ q,
                    const float* __restrict__ sc, const uint8_t* __restrict__ valid,
                    float* __restrict__ out, int N, int M, int D, int n_tiles,
                    int probe_blocks) {
  __shared__ __align__(16) int s_q[kWords][kTile];    // s_q[w][r]: word w of row r's chunk
  __shared__ __align__(16) int s_p[kWords][kProbes];  // s_p[w][p]: word w of probe p's chunk

  const int pb = static_cast<int>(blockIdx.x % probe_blocks);
  const int tile = static_cast<int>(blockIdx.x / probe_blocks);
  const int row0 = tile * kTile;
  const int p0 = pb * kProbes;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  int acc[kRowsPerLane][kProbesPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerLane; ++i)
#pragma unroll
    for (int j = 0; j < kProbesPerWarp; ++j) acc[i][j] = 0;

  for (int d0 = 0; d0 < D; d0 += kChunk) {
    // Stage the tile's chunk: kTile rows x kParts 16-byte parts; a warp takes
    // 32 consecutive rows of one part, so the transposed stores hit 32 banks.
    for (int i = threadIdx.x; i < kTile * kParts; i += kThreads) {
      const int r = i % kTile;
      const int part = i / kTile;
      const int row = row0 + r;
      const int d = d0 + part * 16;
      int4 v = make_int4(0, 0, 0, 0);
      if (row < M && d < D)
        v = __ldg(reinterpret_cast<const int4*>(q + static_cast<size_t>(row) * D + d));
      s_q[part * 4 + 0][r] = v.x;
      s_q[part * 4 + 1][r] = v.y;
      s_q[part * 4 + 2][r] = v.z;
      s_q[part * 4 + 3][r] = v.w;
    }
    for (int i = threadIdx.x; i < kProbes * kParts; i += kThreads) {
      const int p = i % kProbes;
      const int part = i / kProbes;
      const int n = p0 + p;
      const int d = d0 + part * 16;
      int4 v = make_int4(0, 0, 0, 0);
      if (n < N && d < D)
        v = __ldg(reinterpret_cast<const int4*>(pq + static_cast<size_t>(n) * D + d));
      s_p[part * 4 + 0][p] = v.x;
      s_p[part * 4 + 1][p] = v.y;
      s_p[part * 4 + 2][p] = v.z;
      s_p[part * 4 + 3][p] = v.w;
    }
    __syncthreads();

#pragma unroll
    for (int w = 0; w < kWords; ++w) {
      const int4 a = *reinterpret_cast<const int4*>(&s_q[w][lane * kRowsPerLane]);
      const int4 b0 = *reinterpret_cast<const int4*>(&s_p[w][warp * kProbesPerWarp]);
      const int4 b1 = *reinterpret_cast<const int4*>(&s_p[w][warp * kProbesPerWarp + 4]);
      const int av[kRowsPerLane] = {a.x, a.y, a.z, a.w};
      const int bv[kProbesPerWarp] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < kRowsPerLane; ++i)
#pragma unroll
        for (int j = 0; j < kProbesPerWarp; ++j) acc[i][j] = __dp4a(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  float best[kProbesPerWarp];
#pragma unroll
  for (int j = 0; j < kProbesPerWarp; ++j) best[j] = kNeg;
#pragma unroll
  for (int i = 0; i < kRowsPerLane; ++i) {
    const int row = row0 + lane * kRowsPerLane + i;
    const bool ok = row < M && valid[row] != 0;
    const float s = ok ? sc[row] : 0.f;
#pragma unroll
    for (int j = 0; j < kProbesPerWarp; ++j) {
      const float v = ok ? __fmul_rn(static_cast<float>(acc[i][j]), s) : kNeg;
      best[j] = fmaxf(best[j], v);
    }
  }
#pragma unroll
  for (int j = 0; j < kProbesPerWarp; ++j)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      best[j] = fmaxf(best[j], __shfl_xor_sync(0xffffffffu, best[j], off));
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < kProbesPerWarp; ++j) {
      const int n = p0 + warp * kProbesPerWarp + j;
      if (n < N) out[static_cast<size_t>(n) * n_tiles + tile] = best[j];
    }
  }
}

}  // namespace

extern "C" {

// The tile the kernel computes.
int crfr_bank_tilemax_tile(void) { return kTile; }

// pq (N, D) int8, q (M, D) int8, sc (M,) f32, valid (M,) bool/uint8, all
// contiguous; out (N, ceil(M / tile)) f32. D a multiple of 16, at most kMaxD;
// tile == kTile. Returns a cudaError_t: 0 when the launch was accepted.
int crfr_bank_tilemax(const void* pq, const void* q, const float* sc, const void* valid,
                      float* out, int N, int M, int D, int tile, void* stream) {
  if (N <= 0 || M <= 0 || D <= 0 || D % 16 != 0 || D > kMaxD || tile != kTile)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n_tiles = (static_cast<long long>(M) + kTile - 1) / kTile;
  const long long probe_blocks = (static_cast<long long>(N) + kProbes - 1) / kProbes;
  if (n_tiles * probe_blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  bank_tilemax_kernel<<<static_cast<unsigned>(n_tiles * probe_blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(pq), static_cast<const int8_t*>(q), sc,
      static_cast<const uint8_t*>(valid), out, N, M, D, static_cast<int>(n_tiles),
      static_cast<int>(probe_blocks));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
