// Hand-written Hopper (sm_90a) backward kernels for PMMA attention.
//
// Replaces the Pallas TPU backward kernels of
// druglamp_tpu/kernels/paired_attention_pallas.py:
//   paired_attention_bwd  <- _paired_bwd / _bwd_kernel (the vjp of paired_attention_pallas)
//   self_attention_bwd    <- _self_bwd / _self_bwd_kernel (the vjp of self_attention_pallas)
// For each query set n with its incoming gradient dO_n and P_n = softmax(Q_n Kᵀ·scale):
//   dP_n = dO_n Vᵀ,   δ_n = rowsum(dP_n ⊙ P_n),   dS_n = P_n ⊙ (dP_n − δ_n)
//   dQ_n = dS_n K · scale,   dK = Σ_n dS_nᵀ Q_n · scale,   dV = Σ_n P_nᵀ dO_n
// All arithmetic is f32 whatever the input dtype; the paired kernel sums the
// two products' dK and dV in f32 and rounds once, as the Pallas kernel does.
// Operands are contiguous (B·H, L, D) queries and incoming gradients,
// (B·H, S, D) keys/values; D is 64 or 128; inputs are float or bf16.  lse is
// the forward kernel's (NQ, B·H, L) f32 log-sum-exp; delta is an (NQ, B·H, L)
// f32 scratch buffer that the first kernel fills and the second reads.
//
// What bounds it on an H100: at the training shapes (B·H = 64, L = S = 256)
// the paired backward reads q, k, v, q_o, dO1, dO2 and writes dQ, dK, dV, dQ_o
// (21.0 MB in bf16: 6.3 us at 3.35 TB/s) for 5.4 GFLOP (5.4 us at the bf16
// tensor-core peak); the self backward moves 29.4 MB (8.8 us) for 5.4 GFLOP.
// So the floor is the memory traffic, as long as P and dS (L×S per head and
// query set) never reach device memory.
//
// Design, the FlashAttention-2 split.  The Pallas kernel holds a whole (b·h)
// slice in VMEM and recomputes the full P; a Hopper block carries nothing
// across blocks and has 227 KB of shared memory (a whole K/V at D = 128 is
// already 128 KB in f32), so the work is cut in two kernels over 64×64 tiles:
//  - attention_dq_kernel: one block per (b·h, 64-row query tile, query set).
//    A first sweep over 64-key chunks forms δ = rowsum(dP ⊙ P) in f32 (from
//    the recomputed P, not from the rounded forward output) and stores it; a
//    second sweep forms dS and accumulates dQ = dS K in registers.  No
//    atomics, so the result is deterministic.
//  - attention_dkv_kernel: one block per (b·h, 64-key tile).  K and V of the
//    tile are staged once; the block loops over the query chunks of every
//    query set, recomputes P = exp(S·scale − lse) and dS from δ, and
//    accumulates dV and dK in f32 registers until the one store.  One K/V load
//    serves both query sets, which is the Pallas kernel's point.
// P and dS live only in shared memory.  The arithmetic is plain f32 FMA on a
// 16×16 thread grid, as in the forward; tensor cores are later work.

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

template <int NQ>
int dispatch(const void* q0, const void* q1, const void* k, const void* v, const void* do0,
             const void* do1, const void* lse_ptr, void* delta_ptr, void* dq0, void* dq1, void* dk,
             void* dv, int bh, int L, int S, int D, int dtype, void* stream) {
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
    return launch<__nv_bfloat16, 64, NQ>(q0, q1, k, v, do0, do1, lse, delta, dq0, dq1, dk, dv,
                                         bh, L, S, st);
  if (dtype == 1 && D == 128)
    return launch<__nv_bfloat16, 128, NQ>(q0, q1, k, v, do0, do1, lse, delta, dq0, dq1, dk, dv,
                                          bh, L, S, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  lse: the forward's (NQ, bh, L) f32;
// delta: (NQ, bh, L) f32 scratch.  Returns the cudaError_t of the launches.
extern "C" int paired_attention_bwd(const void* q, const void* k, const void* v, const void* q_other,
                                    const void* do1, const void* do2, const void* lse, void* delta,
                                    void* dq, void* dk, void* dv, void* dq_other, int bh, int L,
                                    int S, int D, int dtype, void* stream) {
  return dispatch<2>(q, q_other, k, v, do1, do2, lse, delta, dq, dq_other, dk, dv, bh, L, S, D,
                     dtype, stream);
}

extern "C" int self_attention_bwd(const void* q, const void* k, const void* v, const void* dout,
                                  const void* lse, void* delta, void* dq, void* dk, void* dv,
                                  int bh, int L, int S, int D, int dtype, void* stream) {
  return dispatch<1>(q, q, k, v, dout, dout, lse, delta, dq, dq, dk, dv, bh, L, S, D, dtype,
                     stream);
}
