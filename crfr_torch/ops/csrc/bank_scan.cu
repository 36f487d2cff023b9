// Per-(probe, gallery tile) maxima of int8 bank scores on Hopper's int8
// tensor cores (sm_90a: TMA, mbarrier, wgmma).
//
// Replaces the Pallas TPU kernel `_tilemax_kernel` behind `bank_tilemax` in
// crfr/ops/bank_scan.py: phase 1 of the exact three-phase top-k over an int8
// gallery bank. For int8 probes pq (N x D), an int8 bank q (M x D), f32 row
// scales sc (M) and a validity mask (M) it computes, for every probe n and
// every tile t of kTile = 128 consecutive bank rows,
//
//     out[n, t] = max over rows r of tile t of
//                 (valid[r] && r < M ? float(sum_d pq[n,d] * q[r,d]) * sc[r] : -3e38)
//
// The output is (N, ceil(M / 128)) f32, probes in rows, as phase 2 reads it.
//
// What bounds it on an H100. At the serving shape (N = 256, M = 2^20,
// D = 512) the function reads 537 MB of bank, 4 MB of scales and 1 MB of
// mask and writes 8 MB: 0.164 ms at 3.35 TB/s. It does 2*N*M*D = 275 G int8
// operations: 0.139 ms at the tensor cores' 1,979 TOP/s. So bytes bound it,
// with the two sides close: the product has to run on the int8 tensor
// cores (wgmma, the only way to their full rate) while the bank streams
// from device memory once.
//
// Design.
// - Probes resident. One probe group of P = 64 * nb probes (nb m64 blocks,
//   nb in {1, 2, 4}) stays in shared memory for the CTA's lifetime, loaded
//   once by TMA in the 128-byte-swizzled K-major layout wgmma reads:
//   ceil(D / 128) chunks of P rows x 128 bytes. P is the largest such
//   multiple of 64 with P * roundup(D, 128) <= 128 KB: 256 at D <= 512, 128
//   up to D = 1024 (fewer when N is small). TMA zero-fills rows past N and
//   bytes past D, so nothing is padded on the host.
// - Bank streamed once per probe group. A ring of 5-8 stages of one TMA box
//   each (128 bank rows x 128 bytes of D, 16 KB, 128-byte swizzle) behind
//   full/empty mbarriers. TMA zero-fills rows past M, so the ragged last
//   tile needs no padding. With N > P the probe groups are gridDim.y, each
//   streaming the bank again: ceil(N / P) x M x D bytes (twice the bank at
//   N = 256, D = 1024); still one launch per call.
// - wgmma.mma_async m64n128k32 .s32.s8.s8, both operands from shared-memory
//   descriptors (start >> 4, SBO = 8 rows x 128 B = 1024, 128-byte swizzle;
//   a 32-byte K step advances the start address inside the swizzle atom).
//   A is one m64 probe block, B the 128-row bank tile, so n = 128 is exactly
//   one output tile and the tile's max runs along the accumulator's N. A
//   last chunk past D still runs its four K steps on zero bytes: a branch
//   around a wgmma makes ptxas serialise them.
// - Warp roles, persistent: one CTA per SM walks tiles blockIdx.x,
//   blockIdx.x + gridDim.x, ..., so the CTAs together stream the bank in
//   order and the strided output columns of neighbouring tiles meet in L2
//   (runs of consecutive tiles per CTA, with each probe's maxima buffered
//   into 32-byte writes, measured slower). One or two consumer
//   warpgroups each own kBpw of the group's m64 blocks (kBpw * 64 s32
//   accumulators per thread, 168 registers without spills, so no
//   setmaxnreg). One producer thread issues every TMA load: the probes
//   once, the bank boxes, and each tile's scales and mask bytes as two
//   small 1-D boxes into a ring of four slots (a warp of plain loads, one
//   round trip to device memory per tile, paced a first version). A
//   consumer keeps two chunks' wgmma groups in flight and frees a stage once
//   the group that read it has completed.
// - Epilogue, per thread: the s32 accumulator of m64nNk32 holds rows
//   16 * warp + lane / 4 (+ 8) and columns 8 * j + 2 * (lane % 4) (+ 1), the
//   same layout as f32. Each thread scales and takes the max over its 32
//   columns per row, then over its 4-lane quad with two shuffles; one lane
//   per quad writes. No shared-memory round trip.
//
// Exactness. The tensor cores sum s8 x s8 products in s32 exactly;
// |sum| <= 1024 * 128^2 = 2^24, so float(sum) is exact and equals the f32
// product of the int8 values that the plain version computes. The score is
// one rounded multiply (__fmul_rn, so nvcc cannot contract it into an FMA).
// An invalid row (mask 0, or past M where TMA reads zeros) multiplies by
// NaN and fmaxf drops NaN, which is a select against the running max that
// starts at -3e38: the same bits as the TPU kernel's `acc * sc + bias`
// (adding a bias of 0 is exact, and -3e38 plus any score rounds back to
// -3e38). So the kernel equals its plain version bit for bit.
//
// Plain C interface, built with nvcc into a shared library and called
// through ctypes (crfr_torch/ops/_build.py). cuTensorMapEncodeTiled lives
// in libcuda and is looked up through the runtime's entry-point query, so
// the library needs no -lcuda; the tensor maps encode the global addresses
// and are made on the host for every call, passed as __grid_constant__
// parameters. The caller allocates `out` and passes PyTorch's current
// stream; nothing here allocates or synchronises.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 128;                   // bank rows per output tile = wgmma N
constexpr int kChunk = 128;                  // bytes of D per TMA box = the swizzle span
constexpr int kStep = 32;                    // bytes of D per wgmma (k32 for s8)
constexpr int kBlock = 64;                   // probes per wgmma (m64)
constexpr int kStageBytes = kTile * kChunk;  // 16 KB per ring stage
constexpr int kBlockBytes = kBlock * kChunk; // 8 KB per probe block and chunk
constexpr int kProbeBudget = 128 * 1024;     // resident probes per CTA
constexpr int kMaxStages = 8;
constexpr int kScaleSlots = 4;               // tiles of scales and mask in flight
constexpr int kSlotBytes = 1024;             // scales at 0, mask at kMaskAt
constexpr int kScaleBox = kTile + 4;         // f32 scales per box: a tile and 16 bytes
constexpr int kMaskBox = kTile + 16;         // mask bytes per box: a tile and 16 bytes
constexpr int kMaskAt = 640;                 // 128-byte aligned, past the scales
constexpr int kSmemLimit = 232448;           // 227 KB per block on sm_90
constexpr int kAlign = 1024;                 // 128-byte swizzle atom: 8 rows x 128 B
constexpr int kMaxD = 1024;                  // D * 128^2 <= 2^24 keeps float(acc) exact
constexpr int kConsumerThreads = 128;        // one warpgroup
constexpr int kMaxThreads = 2 * kConsumerThreads + 32;
constexpr float kNeg = -3.0e38f;

// ---- PTX wrappers ----------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int x, int y,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_load_1d(uint32_t dst, const CUtensorMap* map, int x,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2}], [%3];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(bar)
      : "memory");
}

// Shared-memory matrix descriptor: K-major, 128-byte swizzle, 8-row groups
// 1024 bytes apart (SBO); LBO is unused for this layout.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma issue and wait.
__device__ __forceinline__ void fence_acc(uint32_t (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d (64 x 128 s32) (+)= A (64 x 32 s8, K-major) . B (128 x 32 s8, K-major)^T
__device__ __forceinline__ void wgmma_s8(uint32_t (&d)[64], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
        "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]),
        "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]),
        "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// ---- the kernel ------------------------------------------------------------

// One 32-byte K step of the warpgroup's kBpw probe blocks against the bank
// tile: a0 is the warpgroup's first probe block in this chunk (its blocks
// lie nwg * 8 KB apart), b0 the ring stage.
template <int kBpw>
__device__ __forceinline__ void mma_step(uint32_t (&acc)[kBpw][64], uint32_t a0, uint32_t b0,
                                         int k, int nwg, int accumulate) {
  const uint64_t b = smem_desc(b0 + k * kStep);
#pragma unroll
  for (int i = 0; i < kBpw; ++i)
    wgmma_s8(acc[i], smem_desc(a0 + i * nwg * kBlockBytes + k * kStep), b, accumulate);
}

// Shared memory from a 1024-byte-aligned base: probes [chunks][P rows][128 B],
// the bank ring [stages][128 rows][128 B], the scale ring [slots] (a tile's
// f32 scales and mask bytes), then the barriers.
struct Layout {
  int probe_bytes, stages;
  __host__ __device__ int ring() const { return probe_bytes; }
  __host__ __device__ int slots() const { return probe_bytes + stages * kStageBytes; }
  __host__ __device__ int bars() const { return slots() + kScaleSlots * kSlotBytes; }
  // full[kMaxStages], empty[kMaxStages], sfull[kScaleSlots], sempty[kScaleSlots], probes
  __host__ __device__ int bytes() const {
    return kAlign + bars() + 8 * (2 * kMaxStages + 2 * kScaleSlots + 1);
  }
};

struct Params {
  int N, D, n_tiles, nwg, probe_bytes, stages, sc_off, valid_off;
};

// kBpw: m64 probe blocks per consumer warpgroup (1 or 2); nwg consumer
// warpgroups (1 or 2); the probe group holds nb = kBpw * nwg blocks and
// consumer warpgroup w owns blocks w, w + nwg. CTA x walks tiles x,
// x + gridDim.x, ... against probe group blockIdx.y.
template <int kBpw>
__global__ void __launch_bounds__(kMaxThreads, 1)
bank_tilemax_kernel(const __grid_constant__ CUtensorMap tm_bank,
                    const __grid_constant__ CUtensorMap tm_probes,
                    const __grid_constant__ CUtensorMap tm_scale,
                    const __grid_constant__ CUtensorMap tm_valid, float* __restrict__ out,
                    const Params prm) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + kAlign - 1) & ~static_cast<uintptr_t>(kAlign - 1));
  const int nwg = prm.nwg;
  const int nb = kBpw * nwg;
  const int P = nb * kBlock;
  const Layout L{prm.probe_bytes, prm.stages};
  const int stages = prm.stages;
  const uint32_t probe_addr = smem_u32(smem);
  const uint32_t ring_addr = smem_u32(smem + L.ring());
  uint8_t* slots = smem + L.slots();
  const uint32_t bar0 = smem_u32(smem + L.bars());
  auto full = [&](int s) { return bar0 + 8 * s; };
  auto empty = [&](int s) { return bar0 + 8 * (kMaxStages + s); };
  auto sfull = [&](int s) { return bar0 + 8 * (2 * kMaxStages + s); };
  auto sempty = [&](int s) { return bar0 + 8 * (2 * kMaxStages + kScaleSlots + s); };
  const uint32_t pbar = bar0 + 8 * (2 * kMaxStages + 2 * kScaleSlots);

  const int chunks = (prm.D + kChunk - 1) / kChunk;
  const int consumer_warps = 4 * nwg;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int group = blockIdx.y;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), consumer_warps);
    }
    for (int s = 0; s < kScaleSlots; ++s) {
      mbar_init(sfull(s), 1);
      mbar_init(sempty(s), consumer_warps);
    }
    mbar_init(pbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == consumer_warps) {
    // ---- producer: one thread issues every TMA load --------------------
    if (lane == 0) {
      mbar_expect_tx(pbar, static_cast<uint32_t>(chunks * nb * kBlockBytes));
      for (int c = 0; c < chunks; ++c)
        for (int b = 0; b < nb; ++b)
          tma_load_2d(probe_addr + (c * P + b * kBlock) * kChunk, &tm_probes, c * kChunk,
                      group * P + b * kBlock, pbar);
      int stage = 0, slot = 0;
      uint32_t phase = 0, sphase = 0;
      for (int tile = blockIdx.x; tile < prm.n_tiles; tile += gridDim.x) {
        // the tile's scales and mask; rows past M read as mask 0
        mbar_wait(sempty(slot), sphase ^ 1);
        mbar_expect_tx(sfull(slot), kScaleBox * 4 + kMaskBox);
        const uint32_t sa = smem_u32(slots + slot * kSlotBytes);
        tma_load_1d(sa, &tm_scale, tile * kTile, sfull(slot));
        tma_load_1d(sa + kMaskAt, &tm_valid, tile * kTile, sfull(slot));
        if (++slot == kScaleSlots) {
          slot = 0;
          sphase ^= 1;
        }
        // the bank tile, one 128-row x 128-byte box per stage
        for (int c = 0; c < chunks; ++c) {
          mbar_wait(empty(stage), phase ^ 1);
          mbar_expect_tx(full(stage), kStageBytes);
          tma_load_2d(ring_addr + stage * kStageBytes, &tm_bank, c * kChunk, tile * kTile,
                      full(stage));
          if (++stage == stages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // ---- consumers: wgmma and the epilogue -----------------------------
    const int wg = warp / 4;
    const int wq = warp % 4;
    uint32_t acc[kBpw][64];
#pragma unroll
    for (int i = 0; i < kBpw; ++i)
#pragma unroll
      for (int j = 0; j < 64; ++j) acc[i][j] = 0;

    mbar_wait(pbar, 0);
    int stage = 0, slot = 0;
    uint32_t phase = 0, sphase = 0;
    for (int tile = blockIdx.x; tile < prm.n_tiles; tile += gridDim.x) {
      int prev = -1;
      for (int c = 0; c < chunks; ++c) {
        mbar_wait(full(stage), phase);
#pragma unroll
        for (int i = 0; i < kBpw; ++i) fence_acc(acc[i]);
        wgmma_fence();
        const uint32_t a0 = probe_addr + (c * P + wg * kBlock) * kChunk;
        const uint32_t b0 = ring_addr + stage * kStageBytes;
        // all four K steps, also in a last chunk past D: its bytes there
        // are zeros in both operands, and a branch here would serialise
        // the wgmmas
#pragma unroll
        for (int k = 0; k < kChunk / kStep; ++k) mma_step<kBpw>(acc, a0, b0, k, nwg, c | k);
        wgmma_commit();
        wgmma_wait<1>();  // the previous chunk's products are done: free its stage
        if (prev >= 0) {
          __syncwarp();
          if (lane == 0) mbar_arrive(empty(prev));
        }
        prev = stage;
        if (++stage == stages) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < kBpw; ++i) fence_acc(acc[i]);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(prev));

      // epilogue: scale, select, max over the tile's 128 rows; an invalid
      // row's scale becomes NaN, which fmaxf drops
      mbar_wait(sfull(slot), sphase);
      const float* s =
          reinterpret_cast<const float*>(slots + slot * kSlotBytes) + prm.sc_off + 2 * (lane % 4);
      const uint8_t* mask = slots + slot * kSlotBytes + kMaskAt + prm.valid_off + 2 * (lane % 4);
      float best[kBpw][2];
#pragma unroll
      for (int i = 0; i < kBpw; ++i) best[i][0] = best[i][1] = kNeg;
#pragma unroll
      for (int j = 0; j < kTile / 8; ++j) {
        const float s0 = mask[8 * j] ? s[8 * j] : __int_as_float(0x7fffffff);
        const float s1 = mask[8 * j + 1] ? s[8 * j + 1] : __int_as_float(0x7fffffff);
#pragma unroll
        for (int i = 0; i < kBpw; ++i) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float v0 = __fmul_rn(static_cast<float>(static_cast<int>(acc[i][4 * j + 2 * h])), s0);
            const float v1 = __fmul_rn(static_cast<float>(static_cast<int>(acc[i][4 * j + 2 * h + 1])), s1);
            best[i][h] = fmaxf(best[i][h], fmaxf(v0, v1));
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(sempty(slot));
      if (++slot == kScaleSlots) {
        slot = 0;
        sphase ^= 1;
      }
      // the quad's max; the CTAs walk neighbouring tiles together, so the
      // strided column writes of a probe's row meet in L2
#pragma unroll
      for (int i = 0; i < kBpw; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float v = best[i][h];
          v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
          v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
          const int n = group * P + (wg + i * nwg) * kBlock + 16 * wq + lane / 4 + 8 * h;
          if (lane % 4 == 0 && n < prm.N) out[static_cast<size_t>(n) * prm.n_tiles + tile] = v;
        }
      }
    }
  }
}

// ---- host side -------------------------------------------------------------

struct Plan {
  int bpw, nwg, P, groups, stages, probe_bytes, smem, threads, grid_x;
};

// Probe blocks per group: as many m64 blocks as the 128 KB budget holds
// (4 at D <= 512, 2 up to 1024), fewer when N is small; one CTA per SM.
Plan make_plan(int N, int M, int D, int sms) {
  Plan p{};
  const int chunks = (D + kChunk - 1) / kChunk;
  const int nb_max = 4 * kBlock * chunks * kChunk <= kProbeBudget ? 4 : 2;
  const int need = (N + kBlock - 1) / kBlock;
  const int nb = need <= 1 ? 1 : need <= 2 ? 2 : nb_max;
  p.bpw = nb == 4 ? 2 : 1;
  p.nwg = nb / p.bpw;
  p.P = nb * kBlock;
  p.groups = (N + p.P - 1) / p.P;
  p.probe_bytes = chunks * p.P * kChunk;
  const Layout base{p.probe_bytes, 0};
  p.stages = (kSmemLimit - base.bytes()) / kStageBytes;
  if (p.stages > kMaxStages) p.stages = kMaxStages;
  p.smem = Layout{p.probe_bytes, p.stages}.bytes();
  p.threads = p.nwg * kConsumerThreads + 32;
  const long long n_tiles = (static_cast<long long>(M) + kTile - 1) / kTile;
  p.grid_x = static_cast<int>(n_tiles < sms ? n_tiles : sms);
  return p;
}

using EncodeFn = PFN_cuTensorMapEncodeTiled_v12000;

EncodeFn encode_fn() {
  static EncodeFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeFn>(ptr);
  }
  return fn;
}

// A (rows, D) int8 row-major matrix read in boxes of box_rows x 128 bytes,
// 128-byte swizzle; out-of-bounds rows and bytes read as zero.
bool encode_rows(EncodeFn fn, CUtensorMap* map, const void* base, int rows, int D,
                 int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(D)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kChunk), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A vector of n elements read in boxes of box_elems. TMA wants its base
// and each box's start on a 16-byte boundary, so the map starts at the
// aligned address below `ptr`, *off is the element offset of ptr[0] in it
// (the bytes in between lie in ptr[0]'s 16-byte granule), and a box one
// granule longer than a tile, started at tile * kTile, holds the tile's
// elements at [*off, *off + kTile). Elements past the end read as zero.
bool encode_vector(EncodeFn fn, CUtensorMap* map, const void* ptr, CUtensorMapDataType type,
                   int elem_bytes, int box_elems, int n, int* off) {
  const uintptr_t p = reinterpret_cast<uintptr_t>(ptr);
  const uintptr_t base = p & ~static_cast<uintptr_t>(15);
  *off = static_cast<int>((p - base) / elem_bytes);
  const cuuint64_t dims[1] = {static_cast<cuuint64_t>(n) + *off};
  const cuuint64_t strides[1] = {0};
  const cuuint32_t box[1] = {static_cast<cuuint32_t>(box_elems)};
  const cuuint32_t elem[1] = {1};
  return fn(map, type, 1, reinterpret_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

bool valid_shape(int N, int M, int D) {
  return N > 0 && M > 0 && D > 0 && D % 16 == 0 && D <= kMaxD;
}

cudaError_t plan_for(int N, int M, int D, Plan* p) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  *p = make_plan(N, M, D, sms);
  if (p->groups > 65535 || p->stages < 3) return cudaErrorInvalidValue;
  return cudaSuccess;
}

template <int kBpw>
cudaError_t launch(const Plan& p, const CUtensorMap (&maps)[4], float* out, const Params& prm,
                   cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      bank_tilemax_kernel<kBpw>, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return err;
  bank_tilemax_kernel<kBpw><<<dim3(p.grid_x, p.groups), p.threads, p.smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], out, prm);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The tile the kernel computes.
int crfr_bank_tilemax_tile(void) { return kTile; }

// pq (N, D) int8, q (M, D) int8, sc (M,) f32, valid (M,) bool/uint8, all
// contiguous, pq and q 16-byte aligned (sc and valid need not be); out
// (N, ceil(M / tile)) f32. D a multiple of 16, at most kMaxD; tile ==
// kTile. Returns a cudaError_t: 0 when the launch was accepted.
int crfr_bank_tilemax(const void* pq, const void* q, const float* sc, const void* valid,
                      float* out, int N, int M, int D, int tile, void* stream) {
  if (!valid_shape(N, M, D) || tile != kTile) return static_cast<int>(cudaErrorInvalidValue);
  Plan p;
  cudaError_t err = plan_for(N, M, D, &p);
  if (err != cudaSuccess) return static_cast<int>(err);
  const EncodeFn fn = encode_fn();
  if (fn == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  Params prm{N, D, static_cast<int>((static_cast<long long>(M) + kTile - 1) / kTile), p.nwg,
             p.probe_bytes, p.stages, 0, 0};
  CUtensorMap maps[4];
  if (!encode_rows(fn, &maps[0], q, M, D, kTile) || !encode_rows(fn, &maps[1], pq, N, D, kBlock) ||
      !encode_vector(fn, &maps[2], sc, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, kScaleBox, M,
                     &prm.sc_off) ||
      !encode_vector(fn, &maps[3], valid, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, kMaskBox, M,
                     &prm.valid_off))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = p.bpw == 2 ? launch<2>(p, maps, out, prm, s) : launch<1>(p, maps, out, prm, s);
  return static_cast<int>(err);
}

// What a call at (N, M, D) launches: info[0] registers per thread, [1]
// local-memory (spill) bytes per thread, [2] dynamic shared memory bytes,
// [3] CTAs, [4] probe groups, [5] ring stages, [6] threads per CTA, [7]
// probes per group. Returns a cudaError_t.
int crfr_bank_tilemax_info(int N, int M, int D, int* info) {
  if (!valid_shape(N, M, D)) return static_cast<int>(cudaErrorInvalidValue);
  Plan p;
  cudaError_t err = plan_for(N, M, D, &p);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  err = p.bpw == 2 ? cudaFuncGetAttributes(&attr, bank_tilemax_kernel<2>)
                   : cudaFuncGetAttributes(&attr, bank_tilemax_kernel<1>);
  if (err != cudaSuccess) return static_cast<int>(err);
  info[0] = attr.numRegs;
  info[1] = static_cast<int>(attr.localSizeBytes);
  info[2] = p.smem;
  info[3] = p.grid_x * p.groups;
  info[4] = p.groups;
  info[5] = p.stages;
  info[6] = p.threads;
  info[7] = p.P;
  return 0;
}

}  // extern "C"
