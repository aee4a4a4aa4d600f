// Flash attention forward for Hopper (sm_90a), bound to Python through a
// plain C interface (ops/_build.py compiles it with nvcc, ops/
// flash_attention.py loads it with ctypes).
//
// Replaces the Pallas TPU kernel `_fwd_kernel` launched by `_flash_fwd`
// (ray_memory_management_tpu/ops/flash_attention.py): online-softmax
// blockwise attention over q [BH, S, D], k/v [BH, Skv, D], fp32 or bf16,
// writing o [BH, S, D] in the input dtype and, when the caller passes a
// pointer, lse [BH, S] fp32 (= m + log l, for the backward kernels).
//
// Arithmetic follows the TPU kernel: inputs are widened to fp32, q is
// multiplied by `scale` before QK^T, the running max m starts at -1e30,
// the denominator l is clamped at 1e-30 before the divide, and the causal
// mask keeps col <= row + off with off = Skv - S (bottom-right aligned).
// Key tiles that lie wholly above the diagonal (k0 > q0 + 63 + off) are
// skipped. The TPU picked divisor blocks; here the ragged tail of q and of
// k/v is masked instead: tail q rows are computed but never stored, tail
// key columns score -inf so they add exactly nothing to m, l or acc.
// (With S > Skv and causal, a query row that sees no key averages the
// values of the tiles visited, as the TPU kernel does for its blocks;
// the model never asks for that: its prefill has S == Skv.)
//
// Design: one CTA of 256 threads per (bh, 64-row q tile); a loop inside
// the CTA walks 64-row K/V tiles staged in shared memory (fp32, padded
// rows so the QK^T reads are free of bank conflicts), which replaces the
// TPU's sequential innermost grid axis. Each thread owns a 4x4 block of
// the score tile and a 4 x (DP/16) block of the output accumulator;
// row max and row sum are reduced across the 16 threads of a row group
// with warp shuffles. Products run in fp32 on the CUDA cores, as the TPU
// kernel computes them in fp32.
//
// What bounds it on this card: at the serving prefill shape (BH = 12,
// S = 992, D = 64, bf16, causal) the function moves about 6.1 MB of
// q/k/v/o (1.8 us at 3.35 TB/s) and needs about 1.5 GFLOP (1.5 us at the
// 989 TFLOP/s bf16 tensor-core rate), so its bound is memory and launch.
// This first version runs the products on fp32 CUDA cores (67 TFLOP/s
// peak) from shared memory, so it sits far above that bound: wgmma with
// TMA-fed tiles is the later step that closes the gap.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;
constexpr int kPStride = kBlockK + 4;  // score-tile row stride in smem
constexpr float kNegBig = -1e30f;     // the TPU kernel's _NEG_INF

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <int DP>
constexpr size_t smem_bytes() {
  // q and k tiles with one float of row padding, v tile, score tile
  return sizeof(float) * (2 * kBlockQ * (DP + 1) + kBlockK * DP +
                          kBlockQ * kPStride);
}

// DP is the head dim padded up to 32, 64 or 128; D <= DP is the real one.
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int S, int Skv, int D,
                     float scale, int causal) {
  constexpr int kQKStride = DP + 1;
  constexpr int kCols = DP / 16;  // output columns owned by one thread
  extern __shared__ float smem[];
  float* qs = smem;                         // [kBlockQ][kQKStride]
  float* ks = qs + kBlockQ * kQKStride;     // [kBlockK][kQKStride]
  float* vs = ks + kBlockK * kQKStride;     // [kBlockK][DP]
  float* ps = vs + kBlockK * DP;            // [kBlockQ][kPStride]

  const int bh = blockIdx.x;
  // causal tiles near the bottom do the most work: schedule them first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockQ;
  const int off = Skv - S;
  const int tid = threadIdx.x;
  const int ty = tid / 16;  // rows ty*4 .. ty*4+3 of the tile
  const int tx = tid % 16;  // cols tx + 16*j

  const T* qb = q + static_cast<size_t>(bh) * S * D;
  const T* kb = k + static_cast<size_t>(bh) * Skv * D;
  const T* vb = v + static_cast<size_t>(bh) * Skv * D;

  for (int i = tid; i < kBlockQ * DP; i += kThreads) {
    const int r = i / DP, c = i % DP;
    float x = 0.f;
    if (q0 + r < S && c < D)
      x = to_f32(qb[static_cast<size_t>(q0 + r) * D + c]) * scale;
    qs[r * kQKStride + c] = x;
  }

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegBig;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < Skv; k0 += kBlockK) {
    if (causal && k0 > q0 + kBlockQ - 1 + off) break;  // fully masked
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < kBlockK * DP; i += kThreads) {
      const int r = i / DP, c = i % DP;
      float kx = 0.f, vx = 0.f;
      if (k0 + r < Skv && c < D) {
        const size_t g = static_cast<size_t>(k0 + r) * D + c;
        kx = to_f32(kb[g]);
        vx = to_f32(vb[g]);
      }
      ks[r * kQKStride + c] = kx;
      vs[r * DP + c] = vx;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DP; ++d) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(ty * 4 + i) * kQKStride + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ks[(tx + 16 * j) * kQKStride + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mx = kNegBig;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        if (col >= Skv)
          s[i][j] = -INFINITY;  // ragged tail: contributes nothing
        else if (causal && col > row + off)
          s[i][j] = kNegBig;
        mx = fmaxf(mx, s[i][j]);
      }
      // the 16 threads of one row group are one half of a warp
#pragma unroll
      for (int w = 8; w >= 1; w >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps[(ty * 4 + i) * kPStride + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int w = 8; w >= 1; w >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, w);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBlockK; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(ty * 4 + i) * kPStride + kk];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float vv = vs[kk * DP + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(p[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= S) continue;
    const float li = fmaxf(l[i], 1e-30f);
    T* orow = o + (static_cast<size_t>(bh) * S + row) * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = tx + 16 * c;
      if (col < D) orow[col] = from_f32<T>(acc[i][c] / li);
    }
    if (lse != nullptr && tx == 0)
      lse[static_cast<size_t>(bh) * S + row] = m[i] + logf(li);
  }
}

template <typename T, int DP>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int bh, int s, int skv, int d, float scale,
                   int causal, cudaStream_t stream) {
  const size_t smem = smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (s + kBlockQ - 1) / kBlockQ);
  flash_fwd_kernel<T, DP><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o),
      static_cast<float*>(lse), s, skv, d, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     void* lse, int bh, int s, int skv, int d, float scale,
                     int causal, cudaStream_t stream) {
  if (d <= 32)
    return launch<T, 32>(q, k, v, o, lse, bh, s, skv, d, scale, causal,
                         stream);
  if (d <= 64)
    return launch<T, 64>(q, k, v, o, lse, bh, s, skv, d, scale, causal,
                         stream);
  return launch<T, 128>(q, k, v, o, lse, bh, s, skv, d, scale, causal,
                        stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. lse may be null (inference). Returns
// the cudaError_t of the launch (0 = launched).
int rmt_flash_fwd(const void* q, const void* k, const void* v, void* o,
                  void* lse, int bh, int s, int skv, int d, float scale,
                  int causal, int dtype, void* stream) {
  if (bh <= 0 || s <= 0 || skv <= 0 || d <= 0 || d > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((s + kBlockQ - 1) / kBlockQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch<float>(q, k, v, o, lse, bh, s, skv, d, scale, causal, st);
  else if (dtype == 1)
    err = dispatch<__nv_bfloat16>(q, k, v, o, lse, bh, s, skv, d, scale,
                                  causal, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

const char* rmt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
