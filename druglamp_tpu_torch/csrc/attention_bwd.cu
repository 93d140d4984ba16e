// Hand-written Hopper (sm_90a) backward kernels for PMMA attention.
//
// Replaces the Pallas TPU backward kernels of
// druglamp_tpu/kernels/paired_attention_pallas.py:
//   paired_attention_bwd  <- _paired_bwd / _bwd_kernel (the vjp of paired_attention_pallas)
//   self_attention_bwd    <- _self_bwd / _self_bwd_kernel (the vjp of self_attention_pallas)
// For each query set n with its incoming gradient dO_n and P_n = softmax(Q_n Kᵀ·scale):
//   dP_n = dO_n Vᵀ,   δ_n = rowsum(dP_n ⊙ P_n),   dS_n = P_n ⊙ (dP_n − δ_n)
//   dQ_n = dS_n K · scale,   dK = Σ_n dS_nᵀ Q_n · scale,   dV = Σ_n P_nᵀ dO_n
// The paired kernels sum the two products' dK and dV in f32 and round once,
// as the Pallas kernel does.  Operands are contiguous (B·H, L, D) queries,
// forward outputs and incoming gradients, (B·H, S, D) keys/values; D is 64
// or 128; inputs are float or bf16.  lse is the forward kernel's (NQ, B·H,
// L) f32 log-sum-exp; delta is an (NQ, B·H, L) f32 buffer that the first
// kernel fills with δ and the second reads.
//
// What bounds it on an H100: at the training shapes (B·H = 64, L = S = 256)
// the paired backward reads q, k, v, q_o, dO1, dO2 and writes dQ, dK, dV, dQ_o
// (21.0 MB in bf16: 6.3 us at 3.35 TB/s) for 5.4 GFLOP (5.4 us at the bf16
// tensor-core peak); the self backward moves 29.4 MB (8.8 us) for 5.4 GFLOP.
// So the floor is the memory traffic, as long as P and dS (L×S per head and
// query set) never reach device memory.
//
// Both routes take the FlashAttention-2 split.  The Pallas kernel holds a
// whole (b·h) slice in VMEM and recomputes the full P; a Hopper block carries
// nothing across blocks and has 227 KB of shared memory, so the work is cut
// in two kernels over 64×64 tiles, without atomics (the result is
// deterministic):
//  - a dQ kernel, one block per (b·h, 64-row query tile, query set), which
//    also fills δ;
//  - a dK/dV kernel, one block per (b·h, 64-key tile), which loads K and V of
//    its tile once and loops over the query chunks of every query set, so one
//    K/V load serves both query sets, which is the Pallas kernel's point.
// P and dS never leave the chip.
//
// bf16 (attention_dq_wgmma_kernel, attention_dkv_wgmma_kernel): the products
// run on the tensor cores, built from the forward's primitives
// (attention_common.cuh).
//   - TMA: 3-D tensor maps over (B·H, rows, D), 128-byte swizzle, 64 × 64
//     boxes (D = 128 is two panels); rows past L or S inside a slice come back
//     as zeros and the TMA stores drop them.  Streamed chunks come through a
//     two-stage ring, one mbarrier per tile and stage; a stage is refilled
//     after a barrier that follows every warpgroup's wgmma wait on it.
//   - δ = rowsum(dO ⊙ O), from the forward's bf16 output O (FlashAttention-2's
//     pre-pass, here the dQ kernel's prologue), in place of a sweep that
//     recomputes P and dP: 7 tile products per query set instead of 9.  The
//     CPU test of this tile algorithm (tests/test_torch_port_kernels.py)
//     holds it within one bf16 ulp of the Pallas backward.
//   - P and dS enter the products that take them from registers (dV += Pᵀ dO,
//     dQ += dS K, dK += dSᵀ Q) as bf16 hi + lo pairs, as P does in the
//     forward: a single bf16 rounding of either breaks the one-ulp tolerance
//     (PERF.md §6), so each of the three products is two wgmma chains.
//   - dQ kernel, one warpgroup: Q and dO of the tile arrive once, K and V in
//     64-key chunks; S = Q Kᵀ and dP = dO Vᵀ (both operands K-major), then
//     dQ += dS K with dS from the accumulator registers and K read MN-major.
//   - dK/dV kernel, two warpgroups, so that neither holds both D-wide
//     accumulators (at D = 128 they alone would take 128 registers a
//     thread): warpgroup 0 computes Sᵀ = K Qᵀ, P, and dV += Pᵀ dO; warpgroup
//     1 computes dPᵀ = V dOᵀ, takes P from warpgroup 0 through shared memory
//     (f32, in accumulator order, behind a named barrier), forms dSᵀ and
//     dK += dSᵀ Q.  Q and dO arrive in 64-row chunks; both query sets run
//     through the same accumulators.
// f32 (attention_dq_kernel, attention_dkv_kernel): the tensor cores have no
//   true-f32 product, so f32 keeps the plain FMA kernels: the dQ kernel sweeps
//   the keys twice (δ from the recomputed f32 P, then dS and dQ), the dK/dV
//   kernel recomputes P and dS; 16×16 thread grids own register tiles.

#include <math.h>
#include <stddef.h>

#include "attention_common.cuh"

namespace {

using attn::from_f32;
using attn::kChunk;
using attn::kRows;
using attn::kThreads;
using attn::to_f32;

static_assert(kRows == kChunk, "query and key tiles share one shape");

// --- f32: the FMA kernels --------------------------------------------------------------

template <int D>
struct BwdLayout {
  static constexpr int kDP = D + 1;       // padded row strides spread the banks
  static constexpr int kCP = kChunk + 1;
  static constexpr int kFloats = 4 * kRows * kDP   // dq: Q, dO tile, K, V chunk; dkv: K, V tile, Q, dO chunk
                               + 2 * kRows * kCP   // dq: dS (one used); dkv: Pᵀ, dSᵀ
                               + 2 * kRows;        // lse, delta of the staged query rows
  static constexpr size_t kBytes = sizeof(float) * kFloats;
};

// Stage rows [row0, row0 + kRows) of a (·, n, D) slice into f32 shared memory
// with row stride DP; rows past n are zeros.
template <typename T, int D>
__device__ __forceinline__ void stage(float* dst, const T* src, int row0, int n) {
  constexpr int DP = D + 1;
  for (int idx = threadIdx.x; idx < kRows * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    dst[r * DP + d] = row0 + r < n ? to_f32(src[(size_t)(row0 + r) * D + d]) : 0.f;
  }
}

// Block (b·h, query tile, query set).  Query set n is qn with incoming gradient
// don and output gradient dqn.  Rows past L are computed on zeros and not
// stored; keys past S get P = 0.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
attention_dq_kernel(const T* __restrict__ q0, const T* __restrict__ q1,
                    const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ do0, const T* __restrict__ do1,
                    const float* __restrict__ lse, float* __restrict__ delta,
                    T* __restrict__ dq0, T* __restrict__ dq1, int L, int S, float scale) {
  constexpr int DP = BwdLayout<D>::kDP, CP = BwdLayout<D>::kCP;
  constexpr int RI = kRows / 16;   // query rows per thread
  constexpr int CJ = kChunk / 16;  // key columns per thread
  constexpr int DJ = D / 16;       // dQ columns per thread

  extern __shared__ float smem[];
  float* sQ = smem;                // [kRows][DP]
  float* sDO = sQ + kRows * DP;    // [kRows][DP]
  float* sK = sDO + kRows * DP;    // [kChunk][DP]
  float* sV = sK + kChunk * DP;    // [kChunk][DP]
  float* sS = sV + kChunk * DP;    // [kRows][CP]: dS of the chunk
  float* sLse = sS + 2 * kRows * CP;
  float* sDelta = sLse + kRows;

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const size_t bh = blockIdx.x;
  const int row0 = blockIdx.y * kRows;
  const int set = blockIdx.z;
  const T* qs = (set ? q1 : q0) + bh * L * D;
  const T* dos = (set ? do1 : do0) + bh * L * D;
  T* dqs = (set ? dq1 : dq0) + bh * L * D;
  const T* kb = k + bh * S * D;
  const T* vb = v + bh * S * D;
  const size_t stat0 = ((size_t)set * gridDim.x + bh) * L;  // (set, b·h) rows of lse / delta

  stage<T, D>(sQ, qs, row0, L);
  stage<T, D>(sDO, dos, row0, L);
  for (int r = tid; r < kRows; r += kThreads) sLse[r] = row0 + r < L ? lse[stat0 + row0 + r] : 0.f;

  float acc[RI][DJ];
  float rowsum[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    rowsum[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  // sweep 0: δ = rowsum(dP ⊙ P); sweep 1: dS = P ⊙ (dP − δ), dQ += dS K
  for (int sweep = 0; sweep < 2; ++sweep) {
    for (int c0 = 0; c0 < S; c0 += kChunk) {
      __syncthreads();  // the previous chunk's K, V and dS are consumed; δ is staged
      stage<T, D>(sK, kb, c0, S);
      stage<T, D>(sV, vb, c0, S);
      __syncthreads();

      float s[RI][CJ], dp[RI][CJ];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float qv[RI], dov[RI], kv[CJ], vv[CJ];
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          qv[i] = sQ[(ty + 16 * i) * DP + d];
          dov[i] = sDO[(ty + 16 * i) * DP + d];
        }
#pragma unroll
        for (int j = 0; j < CJ; ++j) {
          kv[j] = sK[(tx + 16 * j) * DP + d];
          vv[j] = sV[(tx + 16 * j) * DP + d];
        }
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
          for (int j = 0; j < CJ; ++j) {
            s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
            dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const int r = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < CJ; ++j) {
          const int c = tx + 16 * j;
          const float p = (c0 + c < S && row0 + r < L) ? expf(s[i][j] * scale - sLse[r]) : 0.f;
          if (sweep == 0)
            rowsum[i] = fmaf(p, dp[i][j], rowsum[i]);
          else
            sS[r * CP + c] = p * (dp[i][j] - sDelta[r]);
        }
      }
      if (sweep == 1) {
        __syncthreads();  // dS of the chunk is complete
#pragma unroll 4
        for (int c = 0; c < kChunk; ++c) {
          float sv[RI], kv[DJ];
#pragma unroll
          for (int i = 0; i < RI; ++i) sv[i] = sS[(ty + 16 * i) * CP + c];
#pragma unroll
          for (int j = 0; j < DJ; ++j) kv[j] = sK[c * DP + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < RI; ++i)
#pragma unroll
            for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(sv[i], kv[j], acc[i][j]);
        }
      }
    }
    if (sweep == 0) {
      // the 16 threads of a row are 16 adjacent lanes of one warp
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        float x = rowsum[i];
#pragma unroll
        for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
        const int r = ty + 16 * i;
        if (tx == 0) {
          sDelta[r] = x;
          if (row0 + r < L) delta[stat0 + row0 + r] = x;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = row0 + ty + 16 * i;
    if (row >= L) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      dqs[(size_t)row * D + tx + 16 * j] = from_f32<T>(acc[i][j] * scale);
  }
}

// Block (b·h, key tile): dK and dV of 64 keys, summed over the NQ query sets.
// Keys past S are computed on zeros and not stored; query rows past L get P = 0.
template <typename T, int D, int NQ>
__global__ void __launch_bounds__(kThreads)
attention_dkv_kernel(const T* __restrict__ q0, const T* __restrict__ q1,
                     const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ do0, const T* __restrict__ do1,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     T* __restrict__ dk, T* __restrict__ dv, int L, int S, float scale) {
  constexpr int DP = BwdLayout<D>::kDP, CP = BwdLayout<D>::kCP;
  constexpr int RI = kChunk / 16;  // keys per thread
  constexpr int CJ = kRows / 16;   // query columns per thread
  constexpr int DJ = D / 16;       // dK / dV columns per thread

  extern __shared__ float smem[];
  float* sK = smem;                // [kChunk][DP]
  float* sV = sK + kChunk * DP;    // [kChunk][DP]
  float* sQ = sV + kChunk * DP;    // [kRows][DP]
  float* sDO = sQ + kRows * DP;    // [kRows][DP]
  float* sPT = sDO + kRows * DP;   // [kChunk][CP]: Pᵀ of the chunk
  float* sDST = sPT + kChunk * CP; // [kChunk][CP]: dSᵀ of the chunk
  float* sLse = sDST + kChunk * CP;
  float* sDelta = sLse + kRows;

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const size_t bh = blockIdx.x;
  const int key0 = blockIdx.y * kChunk;

  stage<T, D>(sK, k + bh * S * D, key0, S);
  stage<T, D>(sV, v + bh * S * D, key0, S);

  float adk[RI][DJ], adv[RI][DJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) adk[i][j] = adv[i][j] = 0.f;

  for (int set = 0; set < NQ; ++set) {
    const T* qs = (set ? q1 : q0) + bh * L * D;
    const T* dos = (set ? do1 : do0) + bh * L * D;
    const size_t stat0 = ((size_t)set * gridDim.x + bh) * L;
    for (int r0 = 0; r0 < L; r0 += kRows) {
      __syncthreads();  // the previous chunk's Q, dO, Pᵀ and dSᵀ are consumed
      stage<T, D>(sQ, qs, r0, L);
      stage<T, D>(sDO, dos, r0, L);
      for (int r = tid; r < kRows; r += kThreads) {
        const bool in = r0 + r < L;
        sLse[r] = in ? lse[stat0 + r0 + r] : 0.f;
        sDelta[r] = in ? delta[stat0 + r0 + r] : 0.f;
      }
      __syncthreads();

      // Sᵀ and dPᵀ tiles: thread rows are keys, thread columns query rows
      float s[RI][CJ], dp[RI][CJ];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float kv[RI], vv[RI], qv[CJ], dov[CJ];
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          kv[i] = sK[(ty + 16 * i) * DP + d];
          vv[i] = sV[(ty + 16 * i) * DP + d];
        }
#pragma unroll
        for (int j = 0; j < CJ; ++j) {
          qv[j] = sQ[(tx + 16 * j) * DP + d];
          dov[j] = sDO[(tx + 16 * j) * DP + d];
        }
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
          for (int j = 0; j < CJ; ++j) {
            s[i][j] = fmaf(qv[j], kv[i], s[i][j]);
            dp[i][j] = fmaf(dov[j], vv[i], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const int c = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < CJ; ++j) {
          const int r = tx + 16 * j;
          const float p = r0 + r < L ? expf(s[i][j] * scale - sLse[r]) : 0.f;
          sPT[c * CP + r] = p;
          sDST[c * CP + r] = p * (dp[i][j] - sDelta[r]);
        }
      }
      __syncthreads();

      // dV += Pᵀ dO;  dK += dSᵀ Q
#pragma unroll 4
      for (int r = 0; r < kRows; ++r) {
        float pv[RI], dsv[RI], dov[DJ], qv[DJ];
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          pv[i] = sPT[(ty + 16 * i) * CP + r];
          dsv[i] = sDST[(ty + 16 * i) * CP + r];
        }
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          dov[j] = sDO[r * DP + tx + 16 * j];
          qv[j] = sQ[r * DP + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
          for (int j = 0; j < DJ; ++j) {
            adv[i][j] = fmaf(pv[i], dov[j], adv[i][j]);
            adk[i][j] = fmaf(dsv[i], qv[j], adk[i][j]);
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int key = key0 + ty + 16 * i;
    if (key >= S) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const size_t at = (bh * S + key) * D + tx + 16 * j;
      dk[at] = from_f32<T>(adk[i][j] * scale);
      dv[at] = from_f32<T>(adv[i][j]);
    }
  }
}

template <typename T, int D, int NQ>
cudaError_t launch(const void* q0, const void* q1, const void* k, const void* v, const void* do0,
                   const void* do1, const float* lse, float* delta, void* dq0, void* dq1,
                   void* dk, void* dv, int bh, int L, int S, cudaStream_t stream) {
  const size_t smem = BwdLayout<D>::kBytes;
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
  const T* tq0 = static_cast<const T*>(q0);
  const T* tq1 = static_cast<const T*>(q1);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tdo0 = static_cast<const T*>(do0);
  const T* tdo1 = static_cast<const T*>(do1);

  auto dq_kernel = attention_dq_kernel<T, D>;
  cudaError_t err = attn::allow_smem(dq_kernel, smem);
  if (err != cudaSuccess) return err;
  dq_kernel<<<dim3(bh, (L + kRows - 1) / kRows, NQ), kThreads, smem, stream>>>(
      tq0, tq1, tk, tv, tdo0, tdo1, lse, delta, static_cast<T*>(dq0), static_cast<T*>(dq1), L, S,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto dkv_kernel = attention_dkv_kernel<T, D, NQ>;
  err = attn::allow_smem(dkv_kernel, smem);
  if (err != cudaSuccess) return err;
  dkv_kernel<<<dim3(bh, (S + kChunk - 1) / kChunk), kThreads, smem, stream>>>(
      tq0, tq1, tk, tv, tdo0, tdo1, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), L, S,
      scale);
  return cudaGetLastError();
}

// --- bf16: the tensor-core kernels -------------------------------------------------------

namespace sm90 = attn::sm90;
using sm90::issue_pv;
using sm90::issue_qk;
using sm90::pack_p;

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kPanel = kRows * 128;  // one TMA box: 64 rows x 64 bf16 columns
constexpr int kPReady = 1;           // named barrier: P of the chunk is in shared memory

// Tensor maps of the query sets, their incoming gradients, K, V and the
// gradients, passed by value.
struct BwdMaps {
  CUtensorMap q[2], dout[2], k, v, dq[2], dk, dv;
};

template <int D>
struct DqLayout {
  static constexpr int kTile = (D / 64) * kPanel;   // 64 rows x D columns
  static constexpr int kQ = 0;                      // the row tile's Q, then dQ
  static constexpr int kDO = kTile;                 // the row tile's dO
  static constexpr int kK = 2 * kTile;              // two K stages
  static constexpr int kV = kK + 2 * kTile;         // two V stages
  static constexpr int kDelta = kV + 2 * kTile;     // δ of the tile's rows, f32
  static constexpr int kBar = kDelta + kRows * 4;   // mbarriers: Q and dO, K[2], V[2]
  static constexpr size_t kBytes = kBar + 5 * 8 + 1024;  // + slack to align the base to 1024
};

template <int D>
struct DkvLayout {
  static constexpr int kTile = (D / 64) * kPanel;
  static constexpr int kK = 0;                      // the key tile's K, then dK
  static constexpr int kV = kTile;                  // its V, then dV
  static constexpr int kQ = 2 * kTile;              // two stages of query chunks
  static constexpr int kDO = kQ + 2 * kTile;        // two stages of dO chunks
  static constexpr int kP = kDO + 2 * kTile;        // P of the chunk, f32 [32][128]
  static constexpr int kBar = kP + 32 * 128 * 4;    // mbarriers: K and V, Q[2], dO[2]
  // No slack to align the base (see the kernel): at D = 128 the 1024 bytes
  // would leave room for one block per SM instead of two.
  static constexpr size_t kBytes = kBar + 5 * 8;
};

// acc + Σ a_i b_i over the 8 bf16 pairs of a and b.
__device__ __forceinline__ float dot8(uint4 a, uint4 b, float acc) {
  const uint32_t aw[4] = {a.x, a.y, a.z, a.w}, bw[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&aw[i]));
    const float2 y = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&bw[i]));
    acc = fmaf(x.x, y.x, acc);
    acc = fmaf(x.y, y.y, acc);
  }
  return acc;
}

// Block (b·h, 64-row query tile, query set), one warpgroup.  o_n and do_n
// are query set n's forward output and incoming gradient, read directly for
// δ; lse and delta are (NQ, gridDim.x = B·H, L).  Rows past L are computed on
// zeros and not stored; keys past S get P = 0.
template <int D>
__global__ void __launch_bounds__(128)
attention_dq_wgmma_kernel(const __grid_constant__ BwdMaps maps,
                          const __nv_bfloat16* __restrict__ o0, const __nv_bfloat16* __restrict__ o1,
                          const __nv_bfloat16* __restrict__ do0,
                          const __nv_bfloat16* __restrict__ do1, const float* __restrict__ lse,
                          float* __restrict__ delta, int L, int S, float scale, float scale_log2) {
  using Lay = DqLayout<D>;
  constexpr int kPanels = D / 64;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = sm90::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // swizzled tiles are 1024-byte aligned
  uint8_t* smem = smem_raw + (base - raw);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, quad = lane % 4;
  const int bh = blockIdx.x;
  const int row0 = blockIdx.y * kRows;
  const int set = blockIdx.z;
  const int chunks = (S + kChunk - 1) / kChunk;
  const size_t stat0 = ((size_t)set * gridDim.x + bh) * L;  // (set, b·h) rows of lse / delta
  const uint32_t sq = base + Lay::kQ, sdo = base + Lay::kDO;
  const uint32_t bar_q = base + Lay::kBar;
  // ring stage c % 2 of chunk c: its K and V tiles and their barriers
  const auto sk = [&](int c) { return base + Lay::kK + (c & 1) * Lay::kTile; };
  const auto sv = [&](int c) { return base + Lay::kV + (c & 1) * Lay::kTile; };
  const auto bar_k = [&](int c) { return bar_q + 8 + 8 * (c & 1); };
  const auto bar_v = [&](int c) { return bar_q + 24 + 8 * (c & 1); };

  // chunk c of K and of V into its ring stage (thread 0 only)
  const auto load_kv = [&](int c) {
    sm90::mbar_expect_tx(bar_k(c), Lay::kTile);
#pragma unroll
    for (int p = 0; p < kPanels; ++p)
      sm90::tma_load_3d(sk(c) + p * kPanel, &maps.k, bar_k(c), 64 * p, c * kChunk, bh);
    sm90::mbar_expect_tx(bar_v(c), Lay::kTile);
#pragma unroll
    for (int p = 0; p < kPanels; ++p)
      sm90::tma_load_3d(sv(c) + p * kPanel, &maps.v, bar_v(c), 64 * p, c * kChunk, bh);
  };

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < 5; ++i) sm90::mbar_init(bar_q + 8 * i, 1);
    sm90::mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    sm90::mbar_expect_tx(bar_q, 2 * Lay::kTile);
#pragma unroll
    for (int p = 0; p < kPanels; ++p) {
      sm90::tma_load_3d(sq + p * kPanel, &maps.q[set], bar_q, 64 * p, row0, bh);
      sm90::tma_load_3d(sdo + p * kPanel, &maps.dout[set], bar_q, 64 * p, row0, bh);
    }
    load_kv(0);
    if (chunks > 1) load_kv(1);
  }

  // δ = rowsum(dO ⊙ O) of the tile's rows while the copies run: two threads
  // a row, D/2 columns each; rows past L get 0
  float* s_delta = reinterpret_cast<float*>(smem + Lay::kDelta);
  {
    const int r = tid / 2, row = row0 + r;
    float x = 0.f;
    if (row < L) {
      const size_t off = ((size_t)bh * L + row) * D + (tid % 2) * (D / 2);
      const uint4* po = reinterpret_cast<const uint4*>((set ? o1 : o0) + off);
      const uint4* pd = reinterpret_cast<const uint4*>((set ? do1 : do0) + off);
#pragma unroll
      for (int c = 0; c < D / 16; ++c) x = dot8(__ldg(po + c), __ldg(pd + c), x);
    }
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    if (tid % 2 == 0) {
      s_delta[r] = x;
      if (row < L) delta[stat0 + row] = x;
    }
  }
  __syncthreads();

  // this thread's rows: δ and the base-2 log-sum-exp
  const int rows[2] = {warp * 16 + lane / 4, warp * 16 + lane / 4 + 8};
  float dl[2], lse2[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    dl[r] = s_delta[rows[r]];
    lse2[r] = row0 + rows[r] < L ? lse[stat0 + row0 + rows[r]] * kLog2e : 0.f;
  }

  float dq[D / 2], s[32], dp[32];
  uint32_t ds_hi[4][4], ds_lo[4][4];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;  // defined for the compiler: step 0 overwrites
  sm90::mbar_wait(bar_q, 0);

  for (int c = 0; c < chunks; ++c) {
    const uint32_t parity = (c >> 1) & 1;
    sm90::mbar_wait(bar_k(c), parity);
    issue_qk<D, kPanel>(s, sq, sk(c));    // S = Q Kᵀ
    sm90::mbar_wait(bar_v(c), parity);
    issue_qk<D, kPanel>(dp, sdo, sv(c));  // dP = dO Vᵀ
    sm90::wgmma_wait<0>();
    sm90::fence_regs(s);
    sm90::fence_regs(dp);
    const int key0 = c * kChunk + 2 * quad;
#pragma unroll
    for (int i = 0; i < 32; ++i)  // P = exp(S·scale − lse); keys ≥ S get 0
      s[i] = key0 + 8 * (i / 4) + (i & 1) < S ? exp2f(s[i] * scale_log2 - lse2[(i / 2) % 2]) : 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) dp[i] = s[i] * (dp[i] - dl[(i / 2) % 2]);  // dS
    pack_p(dp, ds_hi, ds_lo);
    issue_pv<kPanel>(dq, ds_hi, ds_lo, sk(c));  // dQ += dS K, K read MN-major
    sm90::wgmma_wait<0>();
    sm90::fence_regs(dq);
    sm90::fence_regs(ds_hi);
    sm90::fence_regs(ds_lo);
    __syncthreads();  // done with stage c % 2: refill it
    if (tid == 0 && c + 2 < chunks) load_kv(c + 2);
  }

  // epilogue: dQ · scale in bf16 into the Q tile, one TMA store per panel
  const float f[2] = {scale, scale};
  sm90::store_tile<D, kPanel>(smem + Lay::kQ, dq, f);
  sm90::fence_proxy_async();
  __syncthreads();
  if (tid == 0) {
#pragma unroll
    for (int p = 0; p < kPanels; ++p)
      sm90::tma_store_3d(&maps.dq[set], sq + p * kPanel, 64 * p, row0, bh);
    sm90::tma_store_commit_and_wait();
  }
}

// Block (b·h, 64-key tile): dK and dV of 64 keys, summed over the NQ query
// sets.  Warpgroup 0 owns dV, warpgroup 1 dK; the accumulator acc is dV in
// one and dK in the other.  Keys past S are computed on zeros and not
// stored; query rows past L get P = 0.  Two blocks fit on an SM: at most 128
// registers a thread, and at D = 128 112 KB of shared memory each.
template <int D, int NQ>
__global__ void __launch_bounds__(256, 2)
attention_dkv_wgmma_kernel(const __grid_constant__ BwdMaps maps, const float* __restrict__ lse,
                           const float* __restrict__ delta, int L, int S, float scale,
                           float scale_log2) {
  using Lay = DkvLayout<D>;
  constexpr int kPanels = D / 64;
  // The swizzled tiles need a 1024-byte aligned base.  A block's dynamic
  // shared memory starts right after the 1 KB the driver reserves for it, so
  // the base is aligned and the layout carries no slack; trap if it is not.
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw;
  const uint32_t base = sm90::smem_addr(smem);
  if (base & 1023) __trap();

  const int tid = threadIdx.x;
  const int wg = tid / 128, t = tid % 128, quad = t % 4;
  const int bh = blockIdx.x;
  const int key0 = blockIdx.y * kChunk;
  const int row_chunks = (L + kRows - 1) / kRows;
  const int chunks = NQ * row_chunks;  // chunk i: query set i / row_chunks, rows 64·(i % row_chunks) on
  const uint32_t bar_kv = base + Lay::kBar;
  // ring stage i % 2 of chunk i: its Q and dO tiles and their barriers
  const auto sq = [&](int i) { return base + Lay::kQ + (i & 1) * Lay::kTile; };
  const auto sdo = [&](int i) { return base + Lay::kDO + (i & 1) * Lay::kTile; };
  const auto bar_q = [&](int i) { return bar_kv + 8 + 8 * (i & 1); };
  const auto bar_do = [&](int i) { return bar_kv + 24 + 8 * (i & 1); };

  // chunk i of the queries and of their incoming gradient (thread 0 only)
  const auto load_chunk = [&](int i) {
    const int set = i / row_chunks, r0 = (i % row_chunks) * kRows;
    sm90::mbar_expect_tx(bar_q(i), Lay::kTile);
#pragma unroll
    for (int p = 0; p < kPanels; ++p)
      sm90::tma_load_3d(sq(i) + p * kPanel, &maps.q[set], bar_q(i), 64 * p, r0, bh);
    sm90::mbar_expect_tx(bar_do(i), Lay::kTile);
#pragma unroll
    for (int p = 0; p < kPanels; ++p)
      sm90::tma_load_3d(sdo(i) + p * kPanel, &maps.dout[set], bar_do(i), 64 * p, r0, bh);
  };

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < 5; ++i) sm90::mbar_init(bar_kv + 8 * i, 1);
    sm90::mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    sm90::mbar_expect_tx(bar_kv, 2 * Lay::kTile);
#pragma unroll
    for (int p = 0; p < kPanels; ++p) {
      sm90::tma_load_3d(base + Lay::kK + p * kPanel, &maps.k, bar_kv, 64 * p, key0, bh);
      sm90::tma_load_3d(base + Lay::kV + p * kPanel, &maps.v, bar_kv, 64 * p, key0, bh);
    }
    load_chunk(0);
    if (chunks > 1) load_chunk(1);
  }

  // P handed from warpgroup 0 to warpgroup 1: value k of thread t at [k][t]
  float* sp = reinterpret_cast<float*>(smem + Lay::kP);
  float acc[D / 2], x[32];
  uint32_t hi[4][4], lo[4][4];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) x[i] = 0.f;  // defined for the compiler: step 0 overwrites it
  sm90::mbar_wait(bar_kv, 0);

  // value k of a 64 x 64 accumulator is this thread's query column 8·(k/4) + 2·quad + (k&1)
  for (int i = 0; i < chunks; ++i) {
    const int r0 = (i % row_chunks) * kRows;
    const size_t stat = ((size_t)(i / row_chunks) * gridDim.x + bh) * L + r0;
    const uint32_t parity = (i >> 1) & 1;
    if (wg == 0) {
      sm90::mbar_wait(bar_q(i), parity);
      issue_qk<D, kPanel>(x, base + Lay::kK, sq(i));  // Sᵀ = K Qᵀ
      float l2[16];  // base-2 lse of the columns; +inf past L, so that P = 0 there
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const int col = 8 * (c / 2) + 2 * quad + (c & 1);
        l2[c] = r0 + col < L ? lse[stat + col] * kLog2e : INFINITY;
      }
      sm90::wgmma_wait<0>();
      sm90::fence_regs(x);
#pragma unroll
      for (int k = 0; k < 32; ++k) x[k] = exp2f(x[k] * scale_log2 - l2[2 * (k / 4) + (k & 1)]);
#pragma unroll
      for (int k = 0; k < 32; ++k) sp[k * 128 + t] = x[k];
      __threadfence_block();
      sm90::named_barrier_arrive(kPReady, 256);
      pack_p(x, hi, lo);
      sm90::mbar_wait(bar_do(i), parity);
      issue_pv<kPanel>(acc, hi, lo, sdo(i));  // dV += Pᵀ dO, dO read MN-major
    } else {
      sm90::mbar_wait(bar_do(i), parity);
      issue_qk<D, kPanel>(x, base + Lay::kV, sdo(i));  // dPᵀ = V dOᵀ
      float dl[16];  // δ of the columns
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const int col = 8 * (c / 2) + 2 * quad + (c & 1);
        dl[c] = r0 + col < L ? delta[stat + col] : 0.f;
      }
      sm90::wgmma_wait<0>();
      sm90::fence_regs(x);
      sm90::named_barrier(kPReady, 256);  // warpgroup 0's P of this chunk is in sp
#pragma unroll
      for (int k = 0; k < 32; ++k) x[k] = sp[k * 128 + t] * (x[k] - dl[2 * (k / 4) + (k & 1)]);
      pack_p(x, hi, lo);
      sm90::mbar_wait(bar_q(i), parity);
      issue_pv<kPanel>(acc, hi, lo, sq(i));  // dK += dSᵀ Q, Q read MN-major
    }
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);
    sm90::fence_regs(hi);
    sm90::fence_regs(lo);
    __syncthreads();  // both warpgroups are done with stage i % 2 and with sp: refill it
    if (tid == 0 && i + 2 < chunks) load_chunk(i + 2);
  }

  // epilogue: dV into the V tile, dK · scale into the K tile, in bf16; one TMA
  // store per panel and warpgroup
  const uint32_t tile = wg ? Lay::kK : Lay::kV;
  const float f[2] = {wg ? scale : 1.f, wg ? scale : 1.f};
  sm90::store_tile<D, kPanel>(smem + tile, acc, f);
  sm90::fence_proxy_async();
  __syncthreads();
  if (t == 0) {
#pragma unroll
    for (int p = 0; p < kPanels; ++p)
      sm90::tma_store_3d(wg ? &maps.dk : &maps.dv, base + tile + p * kPanel, 64 * p, key0, bh);
    sm90::tma_store_commit_and_wait();
  }
}

template <int D, int NQ>
cudaError_t launch_wgmma(const void* q0, const void* q1, const void* k, const void* v,
                         const void* o0, const void* o1, const void* do0, const void* do1,
                         const float* lse, float* delta, void* dq0, void* dq1, void* dk, void* dv,
                         int bh, int L, int S, cudaStream_t stream) {
  const attn::EncodeTiled encode = attn::tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  BwdMaps maps;
  const bool encoded = attn::encode_map(encode, &maps.q[0], q0, bh, L, D) &&
                       attn::encode_map(encode, &maps.q[1], q1, bh, L, D) &&
                       attn::encode_map(encode, &maps.dout[0], do0, bh, L, D) &&
                       attn::encode_map(encode, &maps.dout[1], do1, bh, L, D) &&
                       attn::encode_map(encode, &maps.k, k, bh, S, D) &&
                       attn::encode_map(encode, &maps.v, v, bh, S, D) &&
                       attn::encode_map(encode, &maps.dq[0], dq0, bh, L, D) &&
                       attn::encode_map(encode, &maps.dq[1], dq1, bh, L, D) &&
                       attn::encode_map(encode, &maps.dk, dk, bh, S, D) &&
                       attn::encode_map(encode, &maps.dv, dv, bh, S, D);
  if (!encoded) return cudaErrorInvalidValue;
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
  const float scale_log2 = static_cast<float>(1.4426950408889634 / sqrt(static_cast<double>(D)));
  using bf16 = __nv_bfloat16;

  auto dq_kernel = attention_dq_wgmma_kernel<D>;
  cudaError_t err = attn::allow_smem(dq_kernel, DqLayout<D>::kBytes);
  if (err != cudaSuccess) return err;
  dq_kernel<<<dim3(bh, (L + kRows - 1) / kRows, NQ), 128, DqLayout<D>::kBytes, stream>>>(
      maps, static_cast<const bf16*>(o0), static_cast<const bf16*>(o1),
      static_cast<const bf16*>(do0), static_cast<const bf16*>(do1), lse, delta, L, S, scale,
      scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto dkv_kernel = attention_dkv_wgmma_kernel<D, NQ>;
  err = attn::allow_smem(dkv_kernel, DkvLayout<D>::kBytes);
  if (err != cudaSuccess) return err;
  dkv_kernel<<<dim3(bh, (S + kChunk - 1) / kChunk), 256, DkvLayout<D>::kBytes, stream>>>(
      maps, lse, delta, L, S, scale, scale_log2);
  return cudaGetLastError();
}

// Dynamic shared memory and resident blocks per SM of the two bf16 kernels.
template <int D, int NQ>
cudaError_t wgmma_occupancy(int* info) {
  auto dq_kernel = attention_dq_wgmma_kernel<D>;
  auto dkv_kernel = attention_dkv_wgmma_kernel<D, NQ>;
  info[0] = static_cast<int>(DqLayout<D>::kBytes);
  info[2] = static_cast<int>(DkvLayout<D>::kBytes);
  cudaError_t err = attn::allow_smem(dq_kernel, info[0]);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[1], dq_kernel, 128, info[0]);
  if (err == cudaSuccess) err = attn::allow_smem(dkv_kernel, info[2]);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[3], dkv_kernel, 256, info[2]);
  return err;
}

template <int NQ>
int dispatch(const void* q0, const void* q1, const void* k, const void* v, const void* o0,
             const void* o1, const void* do0, const void* do1, const void* lse_ptr,
             void* delta_ptr, void* dq0, void* dq1, void* dk, void* dv, int bh, int L, int S, int D,
             int dtype, void* stream) {
  if (bh < 1 || L < 1 || S < 1 || lse_ptr == nullptr || delta_ptr == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* lse = static_cast<const float*>(lse_ptr);
  float* delta = static_cast<float*>(delta_ptr);
  if (dtype == 0 && D == 64)
    return launch<float, 64, NQ>(q0, q1, k, v, do0, do1, lse, delta, dq0, dq1, dk, dv, bh, L, S,
                                 st);
  if (dtype == 0 && D == 128)
    return launch<float, 128, NQ>(q0, q1, k, v, do0, do1, lse, delta, dq0, dq1, dk, dv, bh, L,
                                  S, st);
  if (dtype == 1 && D == 64)
    return launch_wgmma<64, NQ>(q0, q1, k, v, o0, o1, do0, do1, lse, delta, dq0, dq1, dk, dv, bh,
                                L, S, st);
  if (dtype == 1 && D == 128)
    return launch_wgmma<128, NQ>(q0, q1, k, v, o0, o1, do0, do1, lse, delta, dq0, dq1, dk, dv,
                                 bh, L, S, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32 (FMA kernels, which take δ from their own sweep and do
// not read o), 1 = bfloat16 (tensor-core kernels).  o1, o2 / o: the forward's
// outputs; lse: the forward's (NQ, bh, L) f32; delta: (NQ, bh, L) f32 scratch.
// Returns the cudaError_t of the launches.
extern "C" int paired_attention_bwd(const void* q, const void* k, const void* v, const void* q_other,
                                    const void* o1, const void* o2, const void* do1,
                                    const void* do2, const void* lse, void* delta, void* dq,
                                    void* dk, void* dv, void* dq_other, int bh, int L, int S,
                                    int D, int dtype, void* stream) {
  return dispatch<2>(q, q_other, k, v, o1, o2, do1, do2, lse, delta, dq, dq_other, dk, dv, bh, L,
                     S, D, dtype, stream);
}

extern "C" int self_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                  const void* dout, const void* lse, void* delta, void* dq,
                                  void* dk, void* dv, int bh, int L, int S, int D, int dtype,
                                  void* stream) {
  return dispatch<1>(q, q, k, v, o, o, dout, dout, lse, delta, dq, dq, dk, dv, bh, L, S, D, dtype,
                     stream);
}

// For the build report: info[0..3] = the bf16 dQ kernel's dynamic shared
// memory (bytes) and resident blocks per SM, then the dK/dV kernel's, at
// head dim D with NQ query sets.  Returns the cudaError_t.
extern "C" int attention_bwd_wgmma_occupancy(int D, int NQ, int* info) {
  if (D == 64 && NQ == 2) return wgmma_occupancy<64, 2>(info);
  if (D == 64 && NQ == 1) return wgmma_occupancy<64, 1>(info);
  if (D == 128 && NQ == 2) return wgmma_occupancy<128, 2>(info);
  if (D == 128 && NQ == 1) return wgmma_occupancy<128, 1>(info);
  return static_cast<int>(cudaErrorInvalidValue);
}
