// Flash attention backward for Hopper (sm_90a): the dq kernel and the
// dk/dv kernel, bound to Python through a plain C interface (ops/_build.py
// compiles it with nvcc, ops/flash_attention.py loads it with ctypes).
//
// Replaces the Pallas TPU kernels `_dq_kernel` and `_dkv_kernel` launched
// by `_flash_bwd` (ray_memory_management_tpu/ops/flash_attention.py). Both
// take q, dO [BH, S, D] and k, v [BH, Skv, D] (fp32 or bf16), the forward's
// lse and delta = rowsum(dO * O) as [BH, S] fp32 (behind [BH, S, 1]
// tensors), and recompute the probability tile from lse instead of storing
// the S x Skv matrix:
//
//   s  = (q k^T) * scale      (the scale goes on after the product here;
//                              the forward puts it on q)
//   s  = -1e30 where col > row + off, off = Skv - S (bottom-right causal)
//   p  = exp(s - lse)
//   dp = dO v^T
//   ds = p * (dp - delta) * scale
//   dq = ds k,   dk = ds^T q,   dv = p^T dO
//
// Arithmetic follows the TPU kernels: inputs are widened to fp32, products
// and sums run in fp32, each output is rounded once to the input dtype.
//
// Design. The TPU split stays: no atomics, so every output element is
// summed by exactly one CTA in a fixed order and the result does not
// depend on scheduling.
//   - dq: one CTA of 256 threads per (bh, 64-row q tile); a loop inside the
//     CTA walks 64-row k/v tiles (the TPU's innermost grid axis). Under the
//     causal mask the loop stops at the first tile with k0 > q0 + 63 + off.
//   - dk/dv: one CTA per (bh, 64-row k tile); the loop walks q tiles,
//     starting at the first one with q0 + 63 + off >= k0 (the mirror
//     predicate).
// Tiles sit in shared memory in fp32 with one float of row padding, so the
// reads of the product loops are free of bank conflicts. Each thread owns
// a 4 x 4 block of the 64 x 64 score tile and a 4 x (DP/16) block of its
// outputs. Ragged tails are masked, not padded by the caller: key columns
// past Skv get p = 0 in the dq kernel, and q rows past S get p = 0 (hence
// ds = 0) in the dk/dv kernel, so they add nothing to any sum.
//
// What bounds it on this card: at the training shape (BH = 96,
// S = Skv = 1024, D = 64, bf16, causal) dq needs 19.3 GFLOP over the
// admitted pairs (19.6 us at 989 TFLOP/s) and moves 63.7 MB (19.0 us at
// 3.35 TB/s); dk/dv needs 25.8 GFLOP (26.1 us) and 76.3 MB (22.8 us): both
// are bound by operations. This first version runs the products as fp32
// FMAs on the CUDA cores from shared memory, as the forward kernel does,
// so it sits far above that bound; wgmma on bf16 tiles fed by TMA is the
// later step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;
constexpr int kPStride = kBlockK + 4;  // row stride of the p / ds tiles
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

// Rows [r0, r0 + 64) of a row-major [n, D] matrix into a [64][stride] fp32
// tile; rows >= n and columns >= D read as 0.
template <typename T, int DP>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int r0,
                                          int n, int D) {
  for (int i = threadIdx.x; i < kBlockQ * DP; i += kThreads) {
    const int r = i / DP, c = i % DP;
    float x = 0.f;
    if (r0 + r < n && c < D)
      x = to_f32(src[static_cast<size_t>(r0 + r) * D + c]);
    dst[r * (DP + 1) + c] = x;
  }
}

template <int DP>
constexpr size_t dq_smem_bytes() {
  // q, dO, k, v tiles and the ds tile
  return sizeof(float) * (4 * kBlockQ * (DP + 1) + kBlockQ * kPStride);
}

template <int DP>
constexpr size_t dkv_smem_bytes() {
  // k, v, q, dO tiles, the p and ds tiles, and lse / delta of the q tile
  return sizeof(float) *
         (4 * kBlockQ * (DP + 1) + 2 * kBlockQ * kPStride + 2 * kBlockQ);
}

// DP is the head dim padded up to 32, 64 or 128; D <= DP is the real one.
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        int S, int Skv, int D, float scale, int causal) {
  constexpr int kStride = DP + 1;
  constexpr int kCols = DP / 16;  // output columns owned by one thread
  extern __shared__ float smem[];
  float* qs = smem;                    // [64][kStride]
  float* dos = qs + kBlockQ * kStride;  // [64][kStride]
  float* ks = dos + kBlockQ * kStride;  // [64][kStride]
  float* vs = ks + kBlockK * kStride;   // [64][kStride]
  float* dss = vs + kBlockK * kStride;  // [64][kPStride]

  const int bh = blockIdx.x;
  // causal tiles near the bottom visit the most k tiles: schedule them first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockQ;
  const int off = Skv - S;
  const int tid = threadIdx.x;
  const int ty = tid / 16;  // rows ty*4 .. ty*4+3 of the tile
  const int tx = tid % 16;  // cols tx + 16*j

  const size_t qbase = static_cast<size_t>(bh) * S * D;
  const size_t kbase = static_cast<size_t>(bh) * Skv * D;
  load_tile<T, DP>(qs, q + qbase, q0, S, D);
  load_tile<T, DP>(dos, dout + qbase, q0, S, D);

  float lse_r[4], delta_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    const bool in = row < S;
    lse_r[i] = in ? lse[static_cast<size_t>(bh) * S + row] : 0.f;
    delta_r[i] = in ? delta[static_cast<size_t>(bh) * S + row] : 0.f;
  }

  float acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;

  for (int k0 = 0; k0 < Skv; k0 += kBlockK) {
    if (causal && k0 > q0 + kBlockQ - 1 + off) break;  // fully masked
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, DP>(ks, k + kbase, k0, Skv, D);
    load_tile<T, DP>(vs, v + kbase, k0, Skv, D);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DP; ++d) {
      float a[4], g[4], b[4], w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = qs[(ty * 4 + i) * kStride + d];
        g[i] = dos[(ty * 4 + i) * kStride + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        b[j] = ks[(tx + 16 * j) * kStride + d];
        w[j] = vs[(tx + 16 * j) * kStride + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i], b[j], s[i][j]);
          dp[i][j] = fmaf(g[i], w[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (causal && col > row + off) x = kNegBig;
        const float p = col < Skv ? expf(x - lse_r[i]) : 0.f;  // ragged tail
        dss[(ty * 4 + i) * kPStride + tx + 16 * j] =
            p * (dp[i][j] - delta_r[i]) * scale;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBlockK; ++kk) {
      float dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = dss[(ty * 4 + i) * kPStride + kk];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float kv = ks[kk * kStride + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(dsv[i], kv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= S) continue;
    T* out = dq + (static_cast<size_t>(bh) * S + row) * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = tx + 16 * c;
      if (col < D) out[col] = from_f32<T>(acc[i][c]);
    }
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dk,
                         T* __restrict__ dv, int S, int Skv, int D,
                         float scale, int causal) {
  constexpr int kStride = DP + 1;
  constexpr int kCols = DP / 16;
  extern __shared__ float smem[];
  float* ks = smem;                      // [64][kStride]
  float* vs = ks + kBlockK * kStride;     // [64][kStride]
  float* qs = vs + kBlockK * kStride;     // [64][kStride]
  float* dos = qs + kBlockQ * kStride;    // [64][kStride]
  float* ps = dos + kBlockQ * kStride;    // p^T tile [64 k][kPStride]
  float* dss = ps + kBlockK * kPStride;   // ds^T tile [64 k][kPStride]
  float* lses = dss + kBlockK * kPStride;  // [64]
  float* deltas = lses + kBlockQ;         // [64]

  const int bh = blockIdx.x;
  // causal tiles near the top visit the most q tiles: blockIdx.y = 0 first
  const int k0 = blockIdx.y * kBlockK;
  const int off = Skv - S;
  const int tid = threadIdx.x;
  const int ty = tid / 16;  // k rows ty*4 .. ty*4+3 of the tile
  const int tx = tid % 16;  // q cols tx + 16*j

  const size_t qbase = static_cast<size_t>(bh) * S * D;
  const size_t kbase = static_cast<size_t>(bh) * Skv * D;
  load_tile<T, DP>(ks, k + kbase, k0, Skv, D);
  load_tile<T, DP>(vs, v + kbase, k0, Skv, D);

  float acc_k[4][kCols], acc_v[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  // the first q tile that sees a key of this tile: q0 + 63 + off >= k0
  int q_first = 0;
  if (causal) {
    const int need = k0 - off - (kBlockQ - 1);
    if (need > 0) q_first = (need + kBlockQ - 1) / kBlockQ * kBlockQ;
  }

  for (int q0 = q_first; q0 < S; q0 += kBlockQ) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, DP>(qs, q + qbase, q0, S, D);
    load_tile<T, DP>(dos, dout + qbase, q0, S, D);
    if (tid < kBlockQ) {
      const bool in = q0 + tid < S;
      const size_t r = static_cast<size_t>(bh) * S + q0 + tid;
      lses[tid] = in ? lse[r] : 0.f;
      deltas[tid] = in ? delta[r] : 0.f;
    }
    __syncthreads();

    float s[4][4], dp[4][4];  // transposed: [k row][q col]
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DP; ++d) {
      float a[4], w[4], b[4], g[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = ks[(ty * 4 + i) * kStride + d];
        w[i] = vs[(ty * 4 + i) * kStride + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        b[j] = qs[(tx + 16 * j) * kStride + d];
        g[j] = dos[(tx + 16 * j) * kStride + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i], b[j], s[i][j]);
          dp[i][j] = fmaf(w[i], g[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int krow = k0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qc = tx + 16 * j;
        const int qrow = q0 + qc;
        float x = s[i][j] * scale;
        if (causal && krow > qrow + off) x = kNegBig;
        // tail q rows (q = dO = 0, lse = 0) would give p = 1: mask them
        const float p = qrow < S ? expf(x - lses[qc]) : 0.f;
        ps[(ty * 4 + i) * kPStride + qc] = p;
        dss[(ty * 4 + i) * kPStride + qc] = p * (dp[i][j] - deltas[qc]) * scale;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int qq = 0; qq < kBlockQ; ++qq) {
      float pv[4], dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = ps[(ty * 4 + i) * kPStride + qq];
        dsv[i] = dss[(ty * 4 + i) * kPStride + qq];
      }
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float g = dos[qq * kStride + tx + 16 * c];
        const float x = qs[qq * kStride + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc_v[i][c] = fmaf(pv[i], g, acc_v[i][c]);
          acc_k[i][c] = fmaf(dsv[i], x, acc_k[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int krow = k0 + ty * 4 + i;
    if (krow >= Skv) continue;
    const size_t base = (static_cast<size_t>(bh) * Skv + krow) * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = tx + 16 * c;
      if (col < D) {
        dk[base + col] = from_f32<T>(acc_k[i][c]);
        dv[base + col] = from_f32<T>(acc_v[i][c]);
      }
    }
  }
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *dq, *dk, *dv;
  int bh, s, skv, d;
  float scale;
  int causal;
};

template <typename T, int DP>
cudaError_t launch_dq(const Args& a, cudaStream_t stream) {
  const size_t smem = dq_smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(a.bh, (a.s + kBlockQ - 1) / kBlockQ);
  flash_bwd_dq_kernel<T, DP><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, static_cast<T*>(a.dq), a.s, a.skv, a.d, a.scale, a.causal);
  return cudaGetLastError();
}

template <typename T, int DP>
cudaError_t launch_dkv(const Args& a, cudaStream_t stream) {
  const size_t smem = dkv_smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(a.bh, (a.skv + kBlockK - 1) / kBlockK);
  flash_bwd_dkv_kernel<T, DP><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.s, a.skv,
      a.d, a.scale, a.causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(bool dq, const Args& a, cudaStream_t st) {
  if (a.d <= 32) return dq ? launch_dq<T, 32>(a, st) : launch_dkv<T, 32>(a, st);
  if (a.d <= 64) return dq ? launch_dq<T, 64>(a, st) : launch_dkv<T, 64>(a, st);
  return dq ? launch_dq<T, 128>(a, st) : launch_dkv<T, 128>(a, st);
}

int run(bool dq, const Args& a, int dtype, void* stream) {
  if (a.bh <= 0 || a.s <= 0 || a.skv <= 0 || a.d <= 0 || a.d > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = ((dq ? a.s : a.skv) + kBlockQ - 1) / kBlockQ;
  if (tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch<float>(dq, a, st);
  else if (dtype == 1)
    err = dispatch<__nv_bfloat16>(dq, a, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. lse and delta are [bh, s] fp32. Each
// returns the cudaError_t of its launch (0 = launched).
int rmt_flash_bwd_dq(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dq, int bh, int s, int skv, int d, float scale,
                     int causal, int dtype, void* stream) {
  const Args a{q, k, v, dout,
               static_cast<const float*>(lse), static_cast<const float*>(delta),
               dq, nullptr, nullptr, bh, s, skv, d, scale, causal};
  return run(true, a, dtype, stream);
}

int rmt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dk, void* dv, int bh, int s, int skv, int d,
                      float scale, int causal, int dtype, void* stream) {
  const Args a{q, k, v, dout,
               static_cast<const float*>(lse), static_cast<const float*>(delta),
               nullptr, dk, dv, bh, s, skv, d, scale, causal};
  return run(false, a, dtype, stream);
}

const char* rmt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
