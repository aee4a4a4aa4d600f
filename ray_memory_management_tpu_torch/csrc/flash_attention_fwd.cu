// Flash attention forward for Hopper (sm_90a), bound to Python through a
// plain C interface (ops/_build.py compiles it with nvcc, ops/
// flash_attention.py loads it with ctypes).
//
// Replaces the Pallas TPU kernel `_fwd_kernel` launched by `_flash_fwd`
// (ray_memory_management_tpu/ops/flash_attention.py): online-softmax
// blockwise attention over q [BH, S, D], k/v [BH, Skv, D], writing o
// [BH, S, D] in the input dtype and, when the caller passes a pointer,
// lse [BH, S] fp32 (= m + log l, for the backward kernels).
//
// Arithmetic follows the TPU kernel: the running max m starts at -1e30,
// l sums the fp32 p and is clamped at 1e-30 before the divide, and the
// causal mask keeps col <= row + off with off = Skv - S (bottom-right
// aligned). Key tiles wholly above the diagonal (k0 > q0 + 63 + off) are
// skipped; only tiles that straddle it are masked. The TPU picked divisor
// blocks; here the ragged tail of q and of k/v is masked instead: tail q
// rows are computed but never stored, tail key columns score -inf so they
// add exactly nothing to m, l or acc. (With S > Skv and causal, a query
// row that sees no key averages the values of the tiles visited, as the
// TPU kernel does for its blocks; the model never asks for that: its
// prefill has S == Skv.)
//
// Two designs, chosen in rmt_flash_fwd by dtype and head dim:
//
// * wgmma (bf16, D = 64 or 128: both main paths). One CTA per (bh,
//   64-row q tile), 256 threads: warpgroup 0 is the producer (one thread
//   issues TMA loads, the group gives its registers away with setmaxnreg),
//   warpgroup 1 the consumer. Q is loaded once; K and V tiles of 64 keys
//   stream through a 2-stage ring of 128B-swizzled bf16 tiles in shared
//   memory, with a full barrier each for K and V and an empty barrier per
//   stage. S = Q K^T is wgmma m64n64k16 with both operands K-major in
//   shared memory; the scale goes on the fp32 scores after the product
//   (q * scale in bf16 would round for D = 128); the softmax runs in fp32
//   on the accumulator fragment, row max across the quad that shares a
//   row; P is rounded to bf16 in registers and is the A operand of
//   O += P V (wgmma m64nDk16, A from registers, V as an MN-major B with
//   the transpose bit set; no staged V^T). That P rounding is the one
//   rounding the TPU kernel does not make. Tensor maps are 3-D [BH, rows,
//   D], encoded on the host per call, so TMA's zero fill stops at each
//   head's end; cuTensorMapEncodeTiled comes through
//   cudaGetDriverEntryPoint, so the library needs no -lcuda. Two CTAs fit
//   an SM (launch bounds, 42 KB of shared memory at D = 64, 83 KB at 128):
//   at the serving prefill (BH = 12, S = 992) the 192 CTAs all run in one
//   wave on 132 SMs, where 128-row CTAs would leave 36 SMs idle; at the
//   training shape (BH = 96, S = 1024) 1536 CTAs run in about six waves,
//   heaviest causal tiles first. D = 16 and 32 (rows under 128 bytes,
//   which would need a narrower swizzle) take the SIMT design.
//
// * SIMT (fp32, and bf16 with another head dim; also exported as
//   rmt_flash_fwd_simt so its time can be read beside the wgmma design).
//   One CTA of 256 threads per (bh, 64-row q tile); a loop walks 64-row
//   K/V tiles widened to fp32 in shared memory; q is multiplied by scale
//   before QK^T as in the TPU kernel; products are fp32 FMAs on the CUDA
//   cores, which fp32 needs: the fp32 route is held to 1e-4, which TF32
//   tensor-core products could not meet.
//
// What bounds it on this card: at the training shape (BH = 96, S = 1024,
// D = 64, bf16, causal, lse) the function moves 50.7 MB (15.1 us at
// 3.35 TB/s) and needs 12.9 GFLOP (13.0 us at the 989 TFLOP/s bf16
// tensor-core rate): bytes, barely. The SIMT design runs its products at
// about a third of the 67 TFLOP/s fp32 peak (0.55 ms there on an H100
// 80GB HBM3 at 700 W); the wgmma design puts them on the tensor cores and
// keeps the tiles bf16 in shared memory (0.066 ms, 196 TFLOP/s, on the
// same card; chip_smoke.py). What holds it back now is the softmax: one
// tile's softmax does not overlap the next tile's products inside a
// CTA, only the second CTA on the SM fills those gaps.

#include "hopper_common.cuh"

#include <math.h>
#include <stdint.h>

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

// ---------------------------------------------------------------------------
// The wgmma design (bf16, D = 64 or 128).

constexpr int kWgThreads = 256;     // warpgroup 0 loads, warpgroup 1 computes
constexpr int kStages = 2;          // K/V ring depth
// setmaxnreg: 40 + 216 = 2 x 128, the entry count of a 2-CTA/SM launch.
// ptxas still compiles the consumer within 128 registers (the launch
// bound), which it fits without spills; the split pays once a consumer
// needs more, as with one CTA per SM.
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 216;

template <int D>
struct WgLayout {
  static constexpr int kSlabs = D / kSlabCols;
  static constexpr int kTileBytes = kSlabs * kSlabBytes;  // 64 rows x D
  static constexpr int kQ = 0;
  static constexpr int kK = kTileBytes;                   // + stage * tile
  static constexpr int kV = kK + kStages * kTileBytes;    // + stage * tile
  static constexpr int kBars = kV + kStages * kTileBytes;
  // q_full, k_full[kStages], v_full[kStages], empty[kStages]
  static constexpr int kBytes = kBars + 8 * (1 + 3 * kStages);
  // the tiles must start on 1024 bytes for the 128B swizzle
  static constexpr int kSmem = kBytes + 1024;
};

template <int D>
__global__ void __launch_bounds__(kWgThreads, 2)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           __nv_bfloat16* __restrict__ o,
                           float* __restrict__ lse, int S, int Skv,
                           float scale, int causal) {
  using L = WgLayout<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar_q = base + L::kBars;
  const uint32_t bar_k = bar_q + 8;                 // + 8 * stage
  const uint32_t bar_v = bar_k + 8 * kStages;
  const uint32_t bar_empty = bar_v + 8 * kStages;

  const int bh = blockIdx.x;
  // causal tiles near the bottom do the most work: schedule them first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockQ;
  const int off = Skv - S;
  const int n_k = key_tiles(q0, Skv, off, causal);
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_k + 8 * s, 1);
      mbar_init(bar_v + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 4);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {
    // ---- producer warpgroup: one thread keeps the ring full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (tid != 0 || n_k == 0) return;
    mbar_expect_tx(bar_q, L::kTileBytes);
    tma_load_tile<D>(base + L::kQ, &tq, bar_q, q0, bh);
    for (int t = 0; t < n_k; ++t) {
      const int st = t % kStages;
      if (t >= kStages) mbar_wait(bar_empty + 8 * st, ((t / kStages) & 1) ^ 1);
      const int k0 = t * kBlockK;
      mbar_expect_tx(bar_k + 8 * st, L::kTileBytes);
      tma_load_tile<D>(base + L::kK + st * L::kTileBytes, &tk, bar_k + 8 * st,
                       k0, bh);
      mbar_expect_tx(bar_v + 8 * st, L::kTileBytes);
      tma_load_tile<D>(base + L::kV + st * L::kTileBytes, &tv, bar_v + 8 * st,
                       k0, bh);
    }
    return;
  }

  // ---- consumer warpgroup: 64 query rows ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int ct = tid - 128;
  const int warp = ct / 32, lane = ct % 32;
  const int g = lane / 4, quad = lane % 4;
  // this thread's two rows: r0 and r0 + 8
  const int r0 = q0 + 16 * warp + g;

  float acc[D / 2];  // O: n8 block j holds cols 8j + 2 quad + {0, 1}
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {kNegBig, kNegBig};
  float l[2] = {0.f, 0.f};  // this thread's share of each row's sum

  if (n_k > 0) mbar_wait(bar_q, 0);
  for (int t = 0; t < n_k; ++t) {
    const int st = t % kStages;
    const uint32_t parity = (t / kStages) & 1;
    const int k0 = t * kBlockK;
    const uint32_t k_tile = base + L::kK + st * L::kTileBytes;
    const uint32_t v_tile = base + L::kV + st * L::kTileBytes;

    // S = Q K^T: both operands K-major from shared memory; a k-step of
    // 16 columns is 32 bytes into the 128-byte swizzled row
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    mbar_wait(bar_k + 8 * st, parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_m64n64k16(s, desc_k_major(base + L::kQ, kk),
                         desc_k_major(k_tile, kk), kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] *= scale;
    if (k0 + kBlockK > Skv || (causal && k0 + kBlockK - 1 > q0 + off)) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = k0 + 8 * j + 2 * quad + e;
            const int row = r0 + 8 * h;
            float& x = s[4 * j + 2 * h + e];
            if (col >= Skv)
              x = -INFINITY;  // ragged tail: contributes nothing
            else if (causal && col > row + off)
              x = kNegBig;
          }
    }

    // online softmax in fp32 on the accumulator fragment; the 4 threads
    // of a quad share a row
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = kNegBig;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        mx = fmaxf(mx, fmaxf(s[4 * j + 2 * h], s[4 * j + 2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h], mx);
      alpha[h] = exp2f((m[h] - m_new) * kLog2e);
      m[h] = m_new;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[4 * j + 2 * h + e];
          x = exp2f((x - m_new) * kLog2e);
          rs += x;  // l sums the fp32 p
        }
      l[h] = l[h] * alpha[h] + rs;
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[4 * j + 0] *= alpha[0];
      acc[4 * j + 1] *= alpha[0];
      acc[4 * j + 2] *= alpha[1];
      acc[4 * j + 3] *= alpha[1];
    }

    // P, rounded to bf16, becomes the register A operand of P V: the
    // accumulator layout of two n8 blocks is the A layout of one k16 step
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
      pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }

    // O += P V: V is [key][d], MN-major for this product (transpose bit);
    // 16 keys are two 8-row groups, 2048 bytes; the second 64 columns of
    // D = 128 lie one slab further (the leading byte offset)
    mbar_wait(bar_v + 8 * st, parity);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs(acc, pa[kk], desc_mn_major(v_tile, kk));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) fence_regs(pa[kk]);  // read until here
    if (lane == 0) mbar_arrive(bar_empty + 8 * st);  // the stage is free
  }

  // epilogue: o = acc / max(l, 1e-30) in bf16, lse = m + log l; rows past
  // S are never stored
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float lt = l[h];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const float li = fmaxf(lt, 1e-30f);
    const int row = r0 + 8 * h;
    if (row >= S) continue;
    __nv_bfloat16* orow = o + (static_cast<size_t>(blockIdx.x) * S + row) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const uint32_t v =
          pack_bf16(acc[4 * j + 2 * h] / li, acc[4 * j + 2 * h + 1] / li);
      *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * quad) = v;
    }
    if (lse != nullptr && quad == 0)
      lse[static_cast<size_t>(blockIdx.x) * S + row] = m[h] + logf(li);
  }
}

// ---------------------------------------------------------------------------
// Host side of the wgmma design.

template <int D>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         void* o, void* lse, int bh, int s, int skv,
                         float scale, int causal, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  cudaError_t err = encode_map(&tq, q, bh, s, D);
  if (err == cudaSuccess) err = encode_map(&tk, k, bh, skv, D);
  if (err == cudaSuccess) err = encode_map(&tv, v, bh, skv, D);
  if (err != cudaSuccess) return err;
  constexpr int smem = WgLayout<D>::kSmem;
  err = cudaFuncSetAttribute(flash_fwd_wgmma_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (s + kBlockQ - 1) / kBlockQ);
  flash_fwd_wgmma_kernel<D><<<grid, kWgThreads, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse),
      s, skv, scale, causal);
  return cudaGetLastError();
}

bool bad_shape(int bh, int s, int skv, int d) {
  return bh <= 0 || s <= 0 || skv <= 0 || d <= 0 || d > 128 ||
         (s + kBlockQ - 1) / kBlockQ > 65535;
}

cudaError_t launch_simt(const void* q, const void* k, const void* v,
                        void* o, void* lse, int bh, int s, int skv, int d,
                        float scale, int causal, int dtype,
                        cudaStream_t st) {
  if (dtype == 0)
    return dispatch<float>(q, k, v, o, lse, bh, s, skv, d, scale, causal,
                           st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, o, lse, bh, s, skv, d, scale,
                                   causal, st);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. lse may be null (inference). Returns
// the cudaError_t of the launch (0 = launched). bf16 with D = 64 or 128
// takes the wgmma design, everything else the SIMT one (the rule
// ops/flash_attention.py `fwd_design` states for the launch counts).
int rmt_flash_fwd(const void* q, const void* k, const void* v, void* o,
                  void* lse, int bh, int s, int skv, int d, float scale,
                  int causal, int dtype, void* stream) {
  if (bad_shape(bh, s, skv, d)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 1 && d == 64)
    err = launch_wgmma<64>(q, k, v, o, lse, bh, s, skv, scale, causal, st);
  else if (dtype == 1 && d == 128)
    err = launch_wgmma<128>(q, k, v, o, lse, bh, s, skv, scale, causal, st);
  else
    err = launch_simt(q, k, v, o, lse, bh, s, skv, d, scale, causal, dtype,
                      st);
  return static_cast<int>(err);
}

// The SIMT design whatever the dtype and head dim: only for timing it
// beside the wgmma design; the main path never calls it.
int rmt_flash_fwd_simt(const void* q, const void* k, const void* v, void* o,
                       void* lse, int bh, int s, int skv, int d, float scale,
                       int causal, int dtype, void* stream) {
  if (bad_shape(bh, s, skv, d)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_simt(q, k, v, o, lse, bh, s, skv, d, scale,
                                      causal, dtype,
                                      static_cast<cudaStream_t>(stream)));
}

const char* rmt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
