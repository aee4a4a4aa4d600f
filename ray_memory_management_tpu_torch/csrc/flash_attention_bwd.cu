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
// The TPU split stays in both designs below: no atomics, so every output
// element is summed by exactly one CTA in a fixed order and the result
// does not depend on scheduling.
//   - dq: one CTA per (bh, 64-row q tile), causal tiles near the bottom
//     first; a loop inside the CTA walks 64-row k/v tiles (the TPU's
//     innermost grid axis). Under the causal mask the loop stops at the
//     first tile with k0 > q0 + 63 + off.
//   - dk/dv: one CTA per (bh, 64-row k tile), top first; the loop walks q
//     tiles, starting at the first one with q0 + 63 + off >= k0 (the
//     mirror predicate).
// Ragged tails are masked, not padded by the caller: key columns past Skv
// get p = 0 in the dq kernel, and q rows past S get p = 0 (hence ds = 0)
// in the dk/dv kernel, so they add nothing to any sum.
//
// Two designs, chosen in rmt_flash_bwd_dq / rmt_flash_bwd_dkv by dtype and
// head dim (the rule ops/flash_attention.py `bwd_design` states):
//
// * wgmma (bf16, D = 64 or 128: the training path). 160 threads: warps
//   0-3 are the consumer warpgroup (64 rows), warp 4 the producer. The
//   dq CTA loads Q and dO once by TMA and streams K and V tiles through a
//   2-stage ring of 128B-swizzled bf16 tiles (a full barrier per tile and
//   stage, an empty barrier per stage); the dk/dv CTA loads K and V once
//   and streams Q and dO, with the q tile's lse and delta copied beside
//   them by the producer warp's 32 lanes. The consumer runs S = Q K^T and
//   dP = dO V^T (dk/dv: S^T = K Q^T and dP^T = V dO^T) as wgmma m64n64k16
//   with both operands K-major in shared memory, recomputes p and ds in
//   fp32 on the accumulator fragment (the scale on the fp32 scores, exp2),
//   and feeds them as register A fragments to dq += ds K (dv += p^T dO,
//   dk += ds^T Q), with the B tile MN-major (the transpose bit; no staged
//   transpose). Those three products take p or ds as a bf16 operand, and
//   one bf16 rounding of p and ds breaks the bf16 tolerance (2^-8 |ref| +
//   1e-3 max|ref|) in about 1e-5 of the elements at the training shape
//   (tests/test_torch_flash_bwd_tiled.py): so each is split into
//   hi = bf16(x) and lo = bf16(x - hi), and each of the three products
//   runs once per half (dq 4 products instead of 3, dk/dv 6 instead of
//   4). The producer is one warp, not a warpgroup, so no setmaxnreg is
//   needed: the launch bound itself gives the consumer its registers.
//   Two CTAs per SM put three of their ten warps on one quarter of the
//   register file, which caps a thread at 168 registers; dk/dv at
//   D = 128, with 128 accumulator floats a thread, runs one CTA per SM
//   (255).
//
// * SIMT (fp32, and bf16 with another head dim; also exported as
//   rmt_flash_bwd_dq_simt / rmt_flash_bwd_dkv_simt so its time can be
//   read beside the wgmma design). Arithmetic follows the TPU kernels:
//   inputs are widened to fp32, products and sums run in fp32, each output
//   is rounded once to the input dtype. One CTA of 256 threads per tile;
//   tiles sit in shared memory in fp32 with one float of row padding, so
//   the reads of the product loops are free of bank conflicts. Each thread
//   owns a 4 x 4 block of the 64 x 64 score tile and a 4 x (DP/16) block
//   of its outputs. fp32 needs these FMAs: it is held to 1e-4, which bf16
//   or TF32 tensor-core operands could not meet.
//
// What bounds it on this card: at the training shape (BH = 96,
// S = Skv = 1024, D = 64, bf16, causal) dq needs 19.3 GFLOP over the
// admitted pairs (19.6 us at 989 TFLOP/s) and moves 63.7 MB (19.0 us at
// 3.35 TB/s); dk/dv needs 25.8 GFLOP (26.1 us) and 76.3 MB (22.8 us): both
// are bound by operations (the hi/lo split raises the tensor-core work
// to 25.8 and 38.7 GFLOP). The SIMT design runs its products as fp32 FMAs
// on the CUDA cores, 37-42x above those bounds; the wgmma design puts
// them on the tensor cores and keeps the tiles bf16 in shared memory.

#include "hopper_common.cuh"

#include <math.h>
#include <stdint.h>

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

  for (int q0 = first_q_tile(k0, off, causal); q0 < S; q0 += kBlockQ) {
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

// ---------------------------------------------------------------------------
// The wgmma design (bf16, D = 64 or 128).

constexpr int kConsumers = 128;              // one warpgroup: 64 rows
constexpr int kWgThreads = kConsumers + 32;  // + the producer warp
constexpr int kStages = 2;                   // depth of the streamed ring

// The q tile of the dq CTA and the k tile of the dk/dv CTA stay for the
// whole loop ("fixed"); the other two tiles stream through the ring.
template <int D>
struct BwdLayout {
  static constexpr int kTile = (D / kSlabCols) * kSlabBytes;  // 64 rows x D
  static constexpr int kFixed0 = 0;       // Q (dq) or K (dk/dv)
  static constexpr int kFixed1 = kTile;   // dO (dq) or V (dk/dv)
  static constexpr int kRing0 = 2 * kTile;                   // + stage * tile
  static constexpr int kRing1 = kRing0 + kStages * kTile;    // + stage * tile
  // lse and delta of each stage's q tile (dk/dv only): [kStages][2][64]
  static constexpr int kStats = kRing1 + kStages * kTile;
  static constexpr int kBars = kStats + kStages * 2 * 64 * 4;
  // fixed_full, ring_full[kStages], ring_empty[kStages]
  static constexpr int kBytes = kBars + 8 * (1 + 2 * kStages);
  // the tiles must start on 1024 bytes for the 128B swizzle
  static constexpr int kSmem = kBytes + 1024;
};

// CTAs per SM the launch bound asks for: dk/dv at D = 128 keeps 128
// accumulator floats a thread, and one CTA per SM lifts the register cap
// from 168 to 255
constexpr int ctas_per_sm(bool dq, int d) { return dq || d == 64 ? 2 : 1; }

// hi = bf16(x) and lo = bf16(x - hi) of two neighbouring values, packed as
// two A-fragment registers: hi + lo carries x to about 2^-16 relative
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x0 - hf.x, x1 - hf.y);
}

// The m64n64 fp32 fragment x (rows: 16 warp + g + {0, 8}; cols 8 j +
// 2 quad + {0, 1}) as the hi and lo A fragments of four k16 steps: the
// accumulator layout of two n8 blocks is the A layout of one k16 step
__device__ __forceinline__ void split_fragment(const float (&x)[32],
                                               uint32_t (&hi)[4][4],
                                               uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      split_bf16(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1], hi[kk][r],
                 lo[kk][r]);
}

// acc += A B over one 64-deep product, once with A's hi half and once with
// its lo half; B is the 64-row tile at `tile`, read MN-major
template <int N>
__device__ __forceinline__ void wgmma_split(float (&acc)[N],
                                            const uint32_t (&hi)[4][4],
                                            const uint32_t (&lo)[4][4],
                                            uint32_t tile) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    wgmma_rs(acc, hi[kk], desc_mn_major(tile, kk));
    wgmma_rs(acc, lo[kk], desc_mn_major(tile, kk));
  }
}

// acc = A B^T over depth D, both 64-row tiles K-major in shared memory
template <int D>
__device__ __forceinline__ void wgmma_abt(float (&acc)[32], uint32_t a,
                                          uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss_m64n64k16(acc, desc_k_major(a, kk), desc_k_major(b, kk), kk > 0);
}

template <int N>
__device__ __forceinline__ void zero(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = 0.f;
}

// Store this thread's share of an m64nD fp32 fragment, rows r0 and r0 + 8,
// as bf16 into out [n, D], skipping rows >= n
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out,
                                           const float (&acc)[D / 2], int r0,
                                           int n, int quad) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + 8 * h;
    if (row >= n) continue;
    __nv_bfloat16* orow = out + static_cast<size_t>(row) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * quad) =
          pack_bf16(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  }
}

struct Bars {
  uint32_t fixed, full, empty;  // full and empty: + 8 * stage
};

template <int D>
__device__ __forceinline__ Bars init_bars(uint32_t base, uint32_t ring_count) {
  using L = BwdLayout<D>;
  const Bars b{base + L::kBars, base + L::kBars + 8,
               base + L::kBars + 8 + 8 * kStages};
  if (threadIdx.x == 0) {
    mbar_init(b.fixed, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(b.full + 8 * s, ring_count);
      mbar_init(b.empty + 8 * s, 4);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return b;
}

template <int D>
__global__ void __launch_bounds__(kWgThreads, ctas_per_sm(true, D))
    flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const __grid_constant__ CUtensorMap tdo,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              __nv_bfloat16* __restrict__ dq, int S, int Skv,
                              float scale, int causal) {
  using L = BwdLayout<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  // fixed: Q and dO; ring_full: K and V of a stage (one TMA arrival)
  const Bars bars = init_bars<D>(base, 1);

  const int bh = blockIdx.x;
  // causal tiles near the bottom visit the most k tiles: schedule them first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockQ;
  const int off = Skv - S;
  const int n_k = key_tiles(q0, Skv, off, causal);
  const int tid = threadIdx.x;

  if (tid >= kConsumers) {
    // ---- producer warp: one thread keeps the ring full ----
    if (tid != kConsumers || n_k == 0) return;
    mbar_expect_tx(bars.fixed, 2 * L::kTile);
    tma_load_tile<D>(base + L::kFixed0, &tq, bars.fixed, q0, bh);
    tma_load_tile<D>(base + L::kFixed1, &tdo, bars.fixed, q0, bh);
    for (int t = 0; t < n_k; ++t) {
      const int st = t % kStages;
      if (t >= kStages)
        mbar_wait(bars.empty + 8 * st, ((t / kStages) & 1) ^ 1);
      const uint32_t full = bars.full + 8 * st;
      mbar_expect_tx(full, 2 * L::kTile);
      tma_load_tile<D>(base + L::kRing0 + st * L::kTile, &tk, full,
                       t * kBlockK, bh);
      tma_load_tile<D>(base + L::kRing1 + st * L::kTile, &tv, full,
                       t * kBlockK, bh);
    }
    return;
  }

  // ---- consumer warpgroup: 64 query rows ----
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, quad = lane % 4;
  const int r0 = q0 + 16 * warp + g;  // this thread's rows: r0 and r0 + 8
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool in = r0 + 8 * h < S;
    const size_t r = static_cast<size_t>(bh) * S + r0 + 8 * h;
    lse_r[h] = in ? lse[r] : 0.f;
    delta_r[h] = in ? delta[r] : 0.f;
  }

  float acc[D / 2];  // dq: n8 block j holds cols 8j + 2 quad + {0, 1}
  zero(acc);
  if (n_k > 0) mbar_wait(bars.fixed, 0);
  for (int t = 0; t < n_k; ++t) {
    const int st = t % kStages;
    const int k0 = t * kBlockK;
    const uint32_t k_tile = base + L::kRing0 + st * L::kTile;
    const uint32_t v_tile = base + L::kRing1 + st * L::kTile;

    // S = Q K^T and dP = dO V^T
    float s[32], dp[32];
    zero(s);
    zero(dp);
    mbar_wait(bars.full + 8 * st, (t / kStages) & 1);
    wgmma_fence();
    wgmma_abt<D>(s, base + L::kFixed0, k_tile);
    wgmma_abt<D>(dp, base + L::kFixed1, v_tile);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);

    // p = exp(s scale - lse) and ds = p (dp - delta) scale, in fp32 on
    // the fragment; ds overwrites s
    const bool edge =
        k0 + kBlockK > Skv || (causal && k0 + kBlockK - 1 > q0 + off);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * h + e;
          const int col = k0 + 8 * j + 2 * quad + e;
          const bool masked = edge && causal && col > r0 + 8 * h + off;
          const float x = masked ? kNegBig : s[i] * scale;
          float p = exp2f((x - lse_r[h]) * kLog2e);
          if (edge && col >= Skv) p = 0.f;  // ragged tail
          s[i] = p * (dp[i] - delta_r[h]) * scale;
        }

    // dq += ds K with ds split into bf16 hi + lo; K is [key][d], MN-major
    uint32_t hi[4][4], lo[4][4];
    split_fragment(s, hi, lo);
    fence_regs(acc);
    wgmma_fence();
    wgmma_split(acc, hi, lo, k_tile);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // read until here
      fence_regs(hi[kk]);
      fence_regs(lo[kk]);
    }
    if (lane == 0) mbar_arrive(bars.empty + 8 * st);  // the stage is free
  }
  store_rows<D>(dq + static_cast<size_t>(bh) * S * D, acc, r0, S, quad);
}

template <int D>
__global__ void __launch_bounds__(kWgThreads, ctas_per_sm(false, D))
    flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                               const __grid_constant__ CUtensorMap tk,
                               const __grid_constant__ CUtensorMap tv,
                               const __grid_constant__ CUtensorMap tdo,
                               const float* __restrict__ lse,
                               const float* __restrict__ delta,
                               __nv_bfloat16* __restrict__ dk,
                               __nv_bfloat16* __restrict__ dv, int S,
                               int Skv, float scale, int causal) {
  using L = BwdLayout<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const smem =
      smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t base = smem_u32(smem);
  // fixed: K and V; ring_full: Q and dO of a stage (one TMA arrival) and
  // their lse and delta (an arrival from each of the producer's 32 lanes)
  const Bars bars = init_bars<D>(base, 32);
  const float* const stats = reinterpret_cast<const float*>(smem + L::kStats);

  const int bh = blockIdx.x;
  // causal tiles near the top visit the most q tiles: blockIdx.y = 0 first
  const int k0 = blockIdx.y * kBlockK;
  const int off = Skv - S;
  const int q_first = first_q_tile(k0, off, causal);
  const int n_q = q_first < S ? (S - q_first + kBlockQ - 1) / kBlockQ : 0;
  const int tid = threadIdx.x;

  if (tid >= kConsumers) {
    // ---- producer warp: lane 0 issues the TMA loads, all 32 lanes copy
    // the q tile's lse and delta ----
    const int lane = tid - kConsumers;
    if (n_q == 0) return;
    if (lane == 0) {
      mbar_expect_tx(bars.fixed, 2 * L::kTile);
      tma_load_tile<D>(base + L::kFixed0, &tk, bars.fixed, k0, bh);
      tma_load_tile<D>(base + L::kFixed1, &tv, bars.fixed, k0, bh);
    }
    for (int t = 0; t < n_q; ++t) {
      const int st = t % kStages;
      const int q0 = q_first + t * kBlockQ;
      if (t >= kStages)
        mbar_wait(bars.empty + 8 * st, ((t / kStages) & 1) ^ 1);
      float* const st_stats =
          reinterpret_cast<float*>(smem + L::kStats) + st * 2 * kBlockQ;
      for (int i = lane; i < kBlockQ; i += 32) {
        const bool in = q0 + i < S;
        const size_t r = static_cast<size_t>(bh) * S + q0 + i;
        st_stats[i] = in ? lse[r] : 0.f;
        st_stats[kBlockQ + i] = in ? delta[r] : 0.f;
      }
      const uint32_t full = bars.full + 8 * st;
      if (lane == 0) {
        mbar_expect_tx(full, 2 * L::kTile);
        tma_load_tile<D>(base + L::kRing0 + st * L::kTile, &tq, full, q0, bh);
        tma_load_tile<D>(base + L::kRing1 + st * L::kTile, &tdo, full, q0,
                         bh);
      } else {
        mbar_arrive(full);
      }
    }
    return;
  }

  // ---- consumer warpgroup: 64 key rows ----
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, quad = lane % 4;
  const int kr0 = k0 + 16 * warp + g;  // this thread's keys: kr0, kr0 + 8

  float acc_k[D / 2], acc_v[D / 2];  // n8 block j: cols 8j + 2 quad + {0, 1}
  zero(acc_k);
  zero(acc_v);
  if (n_q > 0) mbar_wait(bars.fixed, 0);
  for (int t = 0; t < n_q; ++t) {
    const int st = t % kStages;
    const int q0 = q_first + t * kBlockQ;
    const uint32_t q_tile = base + L::kRing0 + st * L::kTile;
    const uint32_t do_tile = base + L::kRing1 + st * L::kTile;
    const float* const st_stats = stats + st * 2 * kBlockQ;

    // S^T = K Q^T and dP^T = V dO^T: [key][q] fragments
    float s[32], dp[32];
    zero(s);
    zero(dp);
    mbar_wait(bars.full + 8 * st, (t / kStages) & 1);
    wgmma_fence();
    wgmma_abt<D>(s, base + L::kFixed0, q_tile);
    wgmma_abt<D>(dp, base + L::kFixed1, do_tile);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);

    // p^T and ds^T in fp32 on the fragment; lse and delta are per column
    // (q row) here, read from the stage's copy. p overwrites s, ds dp.
    const bool edge =
        q0 + kBlockQ > S || (causal && k0 + kBlockK - 1 > q0 + off);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qc = 8 * j + 2 * quad + e;
        const float l = st_stats[qc], dl = st_stats[kBlockQ + qc];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 4 * j + 2 * h + e;
          const bool masked = edge && causal && kr0 + 8 * h > q0 + qc + off;
          const float x = masked ? kNegBig : s[i] * scale;
          float p = exp2f((x - l) * kLog2e);
          // tail q rows (q = dO = 0, lse = 0) would give p = 1: mask them
          if (edge && q0 + qc >= S) p = 0.f;
          s[i] = p;
          dp[i] = p * (dp[i] - dl) * scale;
        }
      }

    // dv += p^T dO and dk += ds^T Q, each A split into bf16 hi + lo;
    // dO and Q are [q][d], MN-major
    uint32_t p_hi[4][4], p_lo[4][4], ds_hi[4][4], ds_lo[4][4];
    split_fragment(s, p_hi, p_lo);
    split_fragment(dp, ds_hi, ds_lo);
    fence_regs(acc_v);
    fence_regs(acc_k);
    wgmma_fence();
    wgmma_split(acc_v, p_hi, p_lo, do_tile);
    wgmma_split(acc_k, ds_hi, ds_lo, q_tile);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc_v);
    fence_regs(acc_k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // read until here
      fence_regs(p_hi[kk]);
      fence_regs(p_lo[kk]);
      fence_regs(ds_hi[kk]);
      fence_regs(ds_lo[kk]);
    }
    if (lane == 0) mbar_arrive(bars.empty + 8 * st);  // the stage is free
  }
  const size_t head = static_cast<size_t>(bh) * Skv * D;
  store_rows<D>(dk + head, acc_k, kr0, Skv, quad);
  store_rows<D>(dv + head, acc_v, kr0, Skv, quad);
}

// ---------------------------------------------------------------------------
// Host side.

template <int D>
cudaError_t launch_wgmma(bool dq, const Args& a, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err = encode_map(&tq, a.q, a.bh, a.s, D);
  if (err == cudaSuccess) err = encode_map(&tk, a.k, a.bh, a.skv, D);
  if (err == cudaSuccess) err = encode_map(&tv, a.v, a.bh, a.skv, D);
  if (err == cudaSuccess) err = encode_map(&tdo, a.dout, a.bh, a.s, D);
  if (err != cudaSuccess) return err;
  constexpr int smem = BwdLayout<D>::kSmem;
  if (dq) {
    err = cudaFuncSetAttribute(flash_bwd_dq_wgmma_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(a.bh, (a.s + kBlockQ - 1) / kBlockQ);
    flash_bwd_dq_wgmma_kernel<D><<<grid, kWgThreads, smem, stream>>>(
        tq, tk, tv, tdo, a.lse, a.delta, static_cast<__nv_bfloat16*>(a.dq),
        a.s, a.skv, a.scale, a.causal);
  } else {
    err = cudaFuncSetAttribute(flash_bwd_dkv_wgmma_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(a.bh, (a.skv + kBlockK - 1) / kBlockK);
    flash_bwd_dkv_wgmma_kernel<D><<<grid, kWgThreads, smem, stream>>>(
        tq, tk, tv, tdo, a.lse, a.delta, static_cast<__nv_bfloat16*>(a.dk),
        static_cast<__nv_bfloat16*>(a.dv), a.s, a.skv, a.scale, a.causal);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(bool dq, const Args& a, cudaStream_t st) {
  if (a.d <= 32) return dq ? launch_dq<T, 32>(a, st) : launch_dkv<T, 32>(a, st);
  if (a.d <= 64) return dq ? launch_dq<T, 64>(a, st) : launch_dkv<T, 64>(a, st);
  return dq ? launch_dq<T, 128>(a, st) : launch_dkv<T, 128>(a, st);
}

cudaError_t launch_simt(bool dq, const Args& a, int dtype, cudaStream_t st) {
  if (dtype == 0) return dispatch<float>(dq, a, st);
  if (dtype == 1) return dispatch<__nv_bfloat16>(dq, a, st);
  return cudaErrorInvalidValue;
}

// bf16 with D = 64 or 128 takes the wgmma design (unless `simt`), the rest
// the SIMT one
int run(bool dq, const Args& a, int dtype, bool simt, void* stream) {
  if (a.bh <= 0 || a.s <= 0 || a.skv <= 0 || a.d <= 0 || a.d > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = ((dq ? a.s : a.skv) + kBlockQ - 1) / kBlockQ;
  if (tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (!simt && dtype == 1 && a.d == 64)
    err = launch_wgmma<64>(dq, a, st);
  else if (!simt && dtype == 1 && a.d == 128)
    err = launch_wgmma<128>(dq, a, st);
  else
    err = launch_simt(dq, a, dtype, st);
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. lse and delta are [bh, s] fp32. Each
// returns the cudaError_t of its launch (0 = launched). bf16 with D = 64
// or 128 takes the wgmma design, everything else the SIMT one.
int rmt_flash_bwd_dq(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dq, int bh, int s, int skv, int d, float scale,
                     int causal, int dtype, void* stream) {
  const Args a{q, k, v, dout,
               static_cast<const float*>(lse), static_cast<const float*>(delta),
               dq, nullptr, nullptr, bh, s, skv, d, scale, causal};
  return run(true, a, dtype, false, stream);
}

int rmt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dk, void* dv, int bh, int s, int skv, int d,
                      float scale, int causal, int dtype, void* stream) {
  const Args a{q, k, v, dout,
               static_cast<const float*>(lse), static_cast<const float*>(delta),
               nullptr, dk, dv, bh, s, skv, d, scale, causal};
  return run(false, a, dtype, false, stream);
}

// The SIMT design whatever the dtype and head dim: only for timing it
// beside the wgmma design; the main path never calls these.
int rmt_flash_bwd_dq_simt(const void* q, const void* k, const void* v,
                          const void* dout, const void* lse,
                          const void* delta, void* dq, int bh, int s,
                          int skv, int d, float scale, int causal, int dtype,
                          void* stream) {
  const Args a{q, k, v, dout,
               static_cast<const float*>(lse), static_cast<const float*>(delta),
               dq, nullptr, nullptr, bh, s, skv, d, scale, causal};
  return run(true, a, dtype, true, stream);
}

int rmt_flash_bwd_dkv_simt(const void* q, const void* k, const void* v,
                           const void* dout, const void* lse,
                           const void* delta, void* dk, void* dv, int bh,
                           int s, int skv, int d, float scale, int causal,
                           int dtype, void* stream) {
  const Args a{q, k, v, dout,
               static_cast<const float*>(lse), static_cast<const float*>(delta),
               nullptr, dk, dv, bh, s, skv, d, scale, causal};
  return run(false, a, dtype, true, stream);
}

const char* rmt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
