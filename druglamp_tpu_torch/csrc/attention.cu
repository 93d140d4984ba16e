// Hand-written Hopper (sm_90a) forward kernels for PMMA attention.
//
// Replaces the Pallas TPU kernels of druglamp_tpu/kernels/paired_attention_pallas.py:
//   paired_attention_fwd  <- paired_attention_pallas (forward, _fwd_kernel / _fwd_call)
//       O1 = softmax(Q Kᵀ/√D) V  and  O2 = softmax(Q_o Kᵀ/√D) V  against one shared K/V
//   self_attention_fwd    <- self_attention_pallas (forward, _self_fwd_kernel / _self_call)
//       O = softmax(Q Kᵀ/√D) V
// Logits, softmax and accumulation are f32 whatever the input dtype; the
// output has the input dtype.  Operands are contiguous (B·H, L, D) queries and
// (B·H, S, D) keys/values; D is 64 or 128; inputs are float or bf16.
//
// What bounds it on an H100: at the serving shapes (B·H = 128, L = S = 256)
// one paired launch reads q, k, v, q_o and writes two outputs (25.2 MB in
// bf16, 7.5 us at 3.35 TB/s) for 4.3 GFLOP (4.3 us at the bf16 tensor-core
// peak), so the floor is the memory traffic — as long as the probabilities
// (L×S per head, twice) never reach device memory.
//
// Design: one thread block per (b·h, 64-row query tile) and per query set
// it serves; the block streams K/V in 64-key chunks through shared memory and
// keeps an online softmax (running max and sum per row), so the probabilities
// live only in shared memory and any S works.  The paired kernel stages both
// query sets of the tile and computes them against the same K/V chunk: each
// K/V byte is read from device memory once per tile for both products, which
// is what the Pallas kernel's shared K/V load bought on the TPU.  K and V of
// a chunk share one shared-memory buffer (V is staged after the scores are
// formed).  The arithmetic is plain f32 FMA on a 16×16 thread grid (no tensor
// cores yet): each thread owns a register tile of scores and of the output.
// It is correct first; wgmma/TMA staging is later work.
//
// For training, the kernel also writes each row's log-sum-exp of the scaled
// logits, lse = m + log(l), f32, laid out (NQ, B·H, L); the backward kernels
// (attention_bwd.cu) recompute P = exp(S·scale − lse) from it.  Serving passes
// lse = nullptr and writes nothing extra.

#include <math.h>
#include <stddef.h>

#include "attention_common.cuh"

namespace {

using attn::from_f32;
using attn::kChunk;
using attn::kRows;
using attn::kThreads;
using attn::to_f32;

template <int D, int NQ>
struct Layout {
  static constexpr int kQRows = NQ * kRows;  // query rows per block, all sets
  static constexpr int kDP = D + 1;          // padded row strides spread the banks
  static constexpr int kCP = kChunk + 1;
  static constexpr int kFloats = kQRows * kDP      // staged queries
                               + kChunk * kDP      // K chunk, then V chunk
                               + kQRows * kCP      // scores, then probabilities
                               + 3 * kQRows;       // row max, row sum, rescale
  static constexpr size_t kBytes = sizeof(float) * kFloats;
};

// Query set n (n < NQ) is qn, its output on. Rows past L are computed on zeros
// and not stored.  lse, when not null, is (NQ, gridDim.x = B·H, L).
template <typename T, int D, int NQ>
__global__ void __launch_bounds__(kThreads)
attention_fwd_kernel(const T* __restrict__ q0, const T* __restrict__ q1,
                     const T* __restrict__ k, const T* __restrict__ v,
                     T* __restrict__ o0, T* __restrict__ o1, float* __restrict__ lse,
                     int L, int S, float scale) {
  using Lay = Layout<D, NQ>;
  constexpr int QR = Lay::kQRows, DP = Lay::kDP, CP = Lay::kCP;
  constexpr int RI = QR / 16;      // query rows per thread
  constexpr int CJ = kChunk / 16;  // score columns per thread
  constexpr int DJ = D / 16;       // output columns per thread
  constexpr int kWarps = kThreads / 32;

  extern __shared__ float smem[];
  float* sQ = smem;              // [QR][DP]
  float* sKV = sQ + QR * DP;     // [kChunk][DP]
  float* sP = sKV + kChunk * DP; // [QR][CP]
  float* sM = sP + QR * CP;      // [QR]
  float* sL = sM + QR;           // [QR]
  float* sA = sL + QR;           // [QR]

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int lane = tid % 32, warp = tid / 32;
  const size_t bh = blockIdx.x;
  const int row0 = blockIdx.y * kRows;
  const T* kb = k + bh * S * D;
  const T* vb = v + bh * S * D;

  for (int idx = tid; idx < QR * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    const int row = row0 + r % kRows;
    const T* qs = (r < kRows) ? q0 : q1;
    sQ[r * DP + d] = row < L ? to_f32(qs[(bh * L + row) * D + d]) : 0.f;
  }
  for (int r = tid; r < QR; r += kThreads) {
    sM[r] = -INFINITY;
    sL[r] = 0.f;
  }

  float acc[RI][DJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  for (int c0 = 0; c0 < S; c0 += kChunk) {
    __syncthreads();  // the previous chunk's V and probabilities are consumed
    for (int idx = tid; idx < kChunk * D; idx += kThreads) {
      const int c = idx / D, d = idx % D;
      sKV[c * DP + d] = c0 + c < S ? to_f32(kb[(size_t)(c0 + c) * D + d]) : 0.f;
    }
    __syncthreads();

    // scores: s = (q · k) * scale; keys past S are -inf
    float s[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[RI], kv[CJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) qv[i] = sQ[(ty + 16 * i) * DP + d];
#pragma unroll
      for (int j = 0; j < CJ; ++j) kv[j] = sKV[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int c = tx + 16 * j;
        sP[(ty + 16 * i) * CP + c] = c0 + c < S ? s[i][j] * scale : -INFINITY;
      }
    __syncthreads();  // scores written; K no longer read

    // stage V into the K buffer while the warps run the softmax
    for (int idx = tid; idx < kChunk * D; idx += kThreads) {
      const int c = idx / D, d = idx % D;
      sKV[c * DP + d] = c0 + c < S ? to_f32(vb[(size_t)(c0 + c) * D + d]) : 0.f;
    }
    // online softmax, one warp per row; each chunk has at least one real key,
    // so the new row max is finite
    for (int r = warp; r < QR; r += kWarps) {
      const float x0 = sP[r * CP + lane], x1 = sP[r * CP + lane + 32];
      float mx = fmaxf(x0, x1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = sM[r];
      const float m_new = fmaxf(m_old, mx);
      const float p0 = expf(x0 - m_new), p1 = expf(x1 - m_new);
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      sP[r * CP + lane] = p0;
      sP[r * CP + lane + 32] = p1;
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);  // 0 on the first chunk
        sA[r] = alpha;
        sL[r] = sL[r] * alpha + sum;
        sM[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const float alpha = sA[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
#pragma unroll 4
    for (int c = 0; c < kChunk; ++c) {
      float pv[RI], vv[DJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) pv[i] = sP[(ty + 16 * i) * CP + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = sKV[c * DP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = ty + 16 * i;
    const int row = row0 + r % kRows;
    if (row >= L) continue;
    const float inv = 1.f / sL[r];
    T* os = (r < kRows) ? o0 : o1;
    if (lse != nullptr && tx == 0)
      lse[((size_t)(r / kRows) * gridDim.x + bh) * L + row] = sM[r] + logf(sL[r]);
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      os[(bh * L + row) * D + tx + 16 * j] = from_f32<T>(acc[i][j] * inv);
  }
}

template <typename T, int D, int NQ>
cudaError_t launch(const void* q0, const void* q1, const void* k, const void* v, void* o0,
                   void* o1, float* lse, int bh, int L, int S, cudaStream_t stream) {
  auto kernel = attention_fwd_kernel<T, D, NQ>;
  const size_t smem = Layout<D, NQ>::kBytes;
  cudaError_t err = attn::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (L + kRows - 1) / kRows);
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q0), static_cast<const T*>(q1), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o0), static_cast<T*>(o1), lse, L, S, scale);
  return cudaGetLastError();
}

template <int NQ>
int dispatch(const void* q0, const void* q1, const void* k, const void* v, void* o0, void* o1,
             void* lse_ptr, int bh, int L, int S, int D, int dtype, void* stream) {
  if (bh < 1 || L < 1 || S < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* lse = static_cast<float*>(lse_ptr);
  if (dtype == 0 && D == 64) return launch<float, 64, NQ>(q0, q1, k, v, o0, o1, lse, bh, L, S, st);
  if (dtype == 0 && D == 128)
    return launch<float, 128, NQ>(q0, q1, k, v, o0, o1, lse, bh, L, S, st);
  if (dtype == 1 && D == 64)
    return launch<__nv_bfloat16, 64, NQ>(q0, q1, k, v, o0, o1, lse, bh, L, S, st);
  if (dtype == 1 && D == 128)
    return launch<__nv_bfloat16, 128, NQ>(q0, q1, k, v, o0, o1, lse, bh, L, S, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  lse: (NQ, bh, L) f32 or null.  Returns the
// cudaError_t of the launch.
extern "C" int paired_attention_fwd(const void* q, const void* k, const void* v, const void* q_other,
                                    void* o1, void* o2, void* lse, int bh, int L, int S, int D,
                                    int dtype, void* stream) {
  return dispatch<2>(q, q_other, k, v, o1, o2, lse, bh, L, S, D, dtype, stream);
}

extern "C" int self_attention_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                                  int bh, int L, int S, int D, int dtype, void* stream) {
  return dispatch<1>(q, q, k, v, o, o, lse, bh, L, S, D, dtype, stream);
}
