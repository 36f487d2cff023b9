// Fused bicubic resample + normalise + cast for NHWC image batches, Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels in crfr/ops/fused_pallas.py: `_kernel`
// (behind fused_degrade_normalize) and the inner `kernel` of
// fused_resize_normalize. For every (image, channel) plane X (H x W) of an
// NHWC batch it computes
//
//     Y   = Wr . X . Wc^T            Wr (OH x H), Wc (OW x W), f32
//     out = cast((Y - 127.5) / 128)  f32 or bf16, NHWC
//
// Degrade (bicubic down to `low`, back up) is Wr = Wc = degrade_matrix(S, low).
//
// What bounds it on an H100: at the main path's B=256, S=112, C=3 the
// function moves 9.6 MB of uint8 in and 19 MB of bf16 out (3.35 TB/s:
// 8.7 us). Its operators are banded bicubic factors (degrade = up . down,
// rank `low`), so the flops it needs are small: 0.15 GFLOP through the
// factors' nonzero taps (2 us at 67 TFLOP/s f32). The function is bound by
// bytes. This design instead does the two dense products, 4*S^3 = 5.6 MFLOP
// per plane, 4.3 GFLOP in all (64 us in f32 FMA), so the design, not the
// function, is bound by arithmetic. TF32 tensor cores would miss the f32
// tolerance the reference holds this stage to (atol 2e-3), so it stays on
// FMA; reaching the byte bound means applying the banded factors.
//
// Design. The TPU kernel keeps a whole plane, W and W.X in VMEM per grid
// step. On Hopper that is ~147 KB for 112x112 (one CTA per SM) and ~287 KB
// for 160x140 -> 112 (more than a CTA may have). Here each CTA computes a
// band of kBand output rows of one plane:
//   phase 1  T = Wr[band, :] . X   (kBand x W), X read straight from global
//            memory through L1/L2 (each plane is re-read by its OH/kBand
//            bands; the whole input stays resident in the 50 MB L2), the
//            band's Wr rows staged transposed in shared memory so every k
//            step is 4 broadcast float4 loads feeding 16 FMAs per thread;
//   phase 2  Y[band, :] = T . Wc^T, T from shared memory the same way, Wc^T
//            read coalesced from global memory (L2 resident).
// Shared memory is (H + W) * kBand floats (14 KB at 112x112), so many CTAs
// share an SM and hide the global-load latency. uint8 or f32 pixels are read
// directly from NHWC (channel stride C); the NHWC output is the channels_last
// layout of an NCHW tensor, so the backbone takes it without a transpose.
// No tensor cores, TMA or wgmma: a faster version (the banded factors, or a
// 3xTF32 split on wgmma) is later work.
//
// Plain C interface, built with nvcc into a shared library and called
// through ctypes (crfr_torch/ops/_build.py). The caller allocates `out` and
// passes PyTorch's current stream; nothing here allocates or synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBand = 16;                 // output rows per CTA
constexpr int kMaxSmemBytes = 48 * 1024;  // no dynamic-smem opt-in needed

__device__ __forceinline__ float load_px(const uint8_t* p) { return static_cast<float>(__ldg(p)); }
__device__ __forceinline__ float load_px(const float* p) { return __ldg(p); }

__device__ __forceinline__ void store_px(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_px(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

__device__ __forceinline__ void fma16(float (&acc)[kBand], const float* w16, float v) {
  const float4* w4 = reinterpret_cast<const float4*>(w16);
#pragma unroll
  for (int q = 0; q < kBand / 4; ++q) {
    const float4 w = w4[q];
    acc[4 * q + 0] = fmaf(w.x, v, acc[4 * q + 0]);
    acc[4 * q + 1] = fmaf(w.y, v, acc[4 * q + 1]);
    acc[4 * q + 2] = fmaf(w.z, v, acc[4 * q + 2]);
    acc[4 * q + 3] = fmaf(w.w, v, acc[4 * q + 3]);
  }
}

// grid (B*C, ceil(OH / kBand)); block kThreads; dynamic smem (H + W) * kBand floats.
// wr_t is Wr^T (H x OH), wc_t is Wc^T (W x OW), both contiguous f32.
template <typename Tin, typename Tout>
__global__ void __launch_bounds__(kThreads)
resample_normalize_kernel(const Tin* __restrict__ x, const float* __restrict__ wr_t,
                          const float* __restrict__ wc_t, Tout* __restrict__ out,
                          int C, int H, int W, int OH, int OW) {
  extern __shared__ __align__(16) float smem[];
  float* s_wr = smem;             // [H][kBand]: s_wr[k][i] = Wr[r0 + i][k]
  float* s_t = smem + H * kBand;  // [W][kBand]: s_t[j][i]  = T[i][j]

  const int plane = blockIdx.x;
  const int b = plane / C;
  const int c = plane - b * C;
  const int r0 = blockIdx.y * kBand;

  for (int e = threadIdx.x; e < H * kBand; e += kThreads) {
    const int k = e / kBand;
    const int i = e - k * kBand;
    s_wr[e] = (r0 + i < OH) ? wr_t[k * OH + r0 + i] : 0.f;
  }
  __syncthreads();

  // Phase 1: T = Wr[band, :] . X, one column j of T per thread.
  const Tin* xp = x + static_cast<size_t>(b) * H * W * C + c;
  const int row_stride = W * C;
  for (int j = threadIdx.x; j < W; j += kThreads) {
    float acc[kBand];
#pragma unroll
    for (int i = 0; i < kBand; ++i) acc[i] = 0.f;
    const Tin* col = xp + j * C;
#pragma unroll 4
    for (int k = 0; k < H; ++k) fma16(acc, s_wr + k * kBand, load_px(col + k * row_stride));
    float4* t4 = reinterpret_cast<float4*>(s_t + j * kBand);
#pragma unroll
    for (int q = 0; q < kBand / 4; ++q)
      t4[q] = make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2], acc[4 * q + 3]);
  }
  __syncthreads();

  // Phase 2: Y[band, p] = T . Wc[p, :]^T, one output column p per thread.
  Tout* op = out + static_cast<size_t>(b) * OH * OW * C + c;
  for (int p = threadIdx.x; p < OW; p += kThreads) {
    float acc[kBand];
#pragma unroll
    for (int i = 0; i < kBand; ++i) acc[i] = 0.f;
#pragma unroll 4
    for (int j = 0; j < W; ++j) fma16(acc, s_t + j * kBand, __ldg(wc_t + j * OW + p));
#pragma unroll
    for (int i = 0; i < kBand; ++i) {
      const int r = r0 + i;
      if (r < OH) store_px(op + (static_cast<size_t>(r) * OW + p) * C, (acc[i] - 127.5f) * (1.0f / 128.0f));
    }
  }
}

template <typename Tin, typename Tout>
cudaError_t launch(const void* x, const float* wr_t, const float* wc_t, void* out, int B, int C,
                   int H, int W, int OH, int OW, cudaStream_t stream) {
  const dim3 grid(B * C, (OH + kBand - 1) / kBand);
  const size_t smem = static_cast<size_t>(H + W) * kBand * sizeof(float);
  resample_normalize_kernel<Tin, Tout><<<grid, kThreads, smem, stream>>>(
      static_cast<const Tin*>(x), wr_t, wc_t, static_cast<Tout*>(out), C, H, W, OH, OW);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest H + W one launch takes (the shared-memory budget above).
int crfr_resample_max_hw(void) { return kMaxSmemBytes / (kBand * static_cast<int>(sizeof(float))); }

// in_dtype: 0 uint8, 1 float32; out_dtype: 0 float32, 1 bfloat16.
// Returns a cudaError_t: 0 when the launch was accepted.
int crfr_resample_normalize(const void* x, int in_dtype, const float* wr_t, const float* wc_t,
                            void* out, int out_dtype, int B, int C, int H, int W, int OH, int OW,
                            void* stream) {
  if (B <= 0 || C <= 0 || H <= 0 || W <= 0 || OH <= 0 || OW <= 0 ||
      H + W > crfr_resample_max_hw() || static_cast<long long>(B) * C > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == 0 && out_dtype == 0) return launch<uint8_t, float>(x, wr_t, wc_t, out, B, C, H, W, OH, OW, s);
  if (in_dtype == 0 && out_dtype == 1) return launch<uint8_t, __nv_bfloat16>(x, wr_t, wc_t, out, B, C, H, W, OH, OW, s);
  if (in_dtype == 1 && out_dtype == 0) return launch<float, float>(x, wr_t, wc_t, out, B, C, H, W, OH, OW, s);
  if (in_dtype == 1 && out_dtype == 1) return launch<float, __nv_bfloat16>(x, wr_t, wc_t, out, B, C, H, W, OH, OW, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* crfr_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
