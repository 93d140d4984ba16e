// Hand-written Hopper (sm_90a) forward kernels for PMMA attention.
//
// Replaces the Pallas TPU kernels of druglamp_tpu/kernels/paired_attention_pallas.py:
//   paired_attention_fwd  <- paired_attention_pallas (forward, _fwd_kernel / _fwd_call, :102)
//       O1 = softmax(Q Kᵀ/√D) V  and  O2 = softmax(Q_o Kᵀ/√D) V  against one shared K/V
//   self_attention_fwd    <- self_attention_pallas (forward, _self_fwd_kernel / _self_call, :191)
//       O = softmax(Q Kᵀ/√D) V
// Logits, softmax and accumulation are f32 whatever the input dtype; the
// output has the input dtype.  Operands are contiguous (B·H, L, D) queries and
// (B·H, S, D) keys/values; D is 64 or 128; inputs are float or bf16.
//
// What bounds it on an H100: at the serving shapes (B·H = 128, L = S = 256)
// one paired launch reads q, k, v, q_o and writes two outputs (25.2 MB in
// bf16, 7.5 us at 3.35 TB/s) for 4.3 GFLOP (4.3 us at the bf16 tensor-core
// peak), so the floor is the memory traffic — as long as the probabilities
// (L×S per head, twice) never reach device memory.  At the f32 non-tensor
// rate (67 TFLOP/s) the same 4.3 GFLOP take 64 us: a kernel that multiplies
// on the CUDA cores is bound by its arithmetic, not by the bytes.  The
// tensor-core kernel below runs at 2–3× the bytes bound (PERF.md §6): each
// warpgroup waits, chunk by chunk, on its own chain of copy, QKᵀ, softmax
// and PV.
//
// Both kernels take one thread block per (b·h, 64-row query tile), stream K/V
// in 64-key chunks and keep an online softmax (running max and sum per row),
// so the probabilities never leave the chip and any S works.  The paired
// kernel computes both query sets of a tile against the same K/V chunk, so
// each K/V byte crosses from device memory once per tile for both products,
// which is what the Pallas kernel's shared K/V load bought on the TPU.
//
// bf16 (attention_fwd_wgmma_kernel): the products run on the tensor cores.
//   - One consumer warpgroup (128 threads) per query set: 2 for paired, 1 for
//     self.  Thread 0 also issues the copies.
//   - TMA: 3-D tensor maps over (B·H, rows, D) with 128-byte swizzle; a box
//     is 64 rows × 64 columns (8 KB), so D = 128 is two panels.  Rows past L
//     or S inside a slice come back as zeros, and the output's store drops
//     them.  Q arrives once; K and V arrive in a two-stage ring of 64-key
//     chunks, each on its own mbarrier, so the next chunk's copy overlaps this
//     chunk's products and QKᵀ starts before V has landed.  A stage is
//     refilled only after a __syncthreads that follows every warpgroup's
//     wgmma wait on it.
//   - S = Q Kᵀ: wgmma m64n64k16, both operands K-major in shared memory,
//     f32 accumulators, D/16 steps.  Keys ≥ S get -inf before the row max.
//   - Online softmax in registers: a row of S lives in the 4 threads of a
//     quad (shuffles 1 and 2); exponentials in base 2 with the scale folded.
//   - O += P V: P is reused from the accumulator registers as the A operand
//     (wgmma m64nDk16, 4 steps per chunk); V is the B operand read MN-major
//     (transpose bit).  P is split into P_hi = bf16(P) and P_lo = bf16(P -
//     P_hi), two products into the same f32 accumulators, so P keeps ~16
//     bits as the Pallas kernel's f32 P does.  That lifts a paired launch to
//     6.4 GFLOP, 6.5 us at the tensor-core peak: still under the bytes bound.
//   - Epilogue: O/l rounded to bf16 into the (swizzled) Q tile, then one TMA
//     store per panel; lse = m + log l when asked for.
// f32 (attention_fwd_kernel): the tensor cores have no true-f32 product, so
//   f32 keeps the plain FMA kernel: each block stages both query sets and each
//   K then V chunk in f32 shared memory, and a 16×16 thread grid owns register
//   tiles of scores and of the output.
//
// For training, both kernels also write each row's log-sum-exp of the scaled
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

// --- f32: the FMA kernel --------------------------------------------------------------

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

// --- bf16: the tensor-core kernel -------------------------------------------------------

namespace sm90 = attn::sm90;
using sm90::issue_pv;
using sm90::issue_qk;
using sm90::pack_p;

constexpr float kLn2 = 0.6931471805599453f;

template <int D, int NQ>
struct TcLayout {
  static constexpr int kPanel = kRows * 128;         // one TMA box: 64 rows x 64 bf16 columns
  static constexpr int kTile = (D / 64) * kPanel;    // 64 rows x D columns
  static constexpr int kK = NQ * kTile;              // after the query tiles: two K stages
  static constexpr int kV = kK + 2 * kTile;          // two V stages
  static constexpr int kBar = kV + 2 * kTile;        // mbarriers: Q, K[2], V[2]
  static constexpr size_t kBytes = kBar + 5 * 8 + 1024;  // + slack to align the base to 1024
};

// Tensor maps of the query sets, K, V and the outputs, passed by value.
struct TcMaps {
  CUtensorMap q[2], k, v, o[2];
};

// The online softmax of one chunk, in place: sc becomes exp2(x - m) of the
// base-2 scaled logits x (keys ≥ S masked to -inf), m_r the new row max,
// l_r this thread's share of the row sum; alpha = exp2(m_old - m) rescales
// what was accumulated before.  Each chunk has at least one key < S, so the
// new max is finite; on the first chunk alpha is 0.
__device__ __forceinline__ void online_softmax(float (&sc)[32], float (&m_r)[2], float (&l_r)[2],
                                               float (&alpha)[2], int key0, int S,
                                               float scale_log2) {
  float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = key0 + 8 * j + (e & 1) < S ? sc[4 * j + e] * scale_log2 : -INFINITY;
      sc[4 * j + e] = x;
      mx[e / 2] = fmaxf(mx[e / 2], x);
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    alpha[r] = exp2f(m_r[r] - mx[r]);
    m_r[r] = mx[r];
    l_r[r] *= alpha[r];
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    sc[i] = exp2f(sc[i] - m_r[(i / 2) % 2]);
    l_r[(i / 2) % 2] += sc[i];
  }
}

// Warpgroup n (n < NQ) computes query set n of the tile (the accumulator
// layout is in attention_common.cuh).  lse, when not null, is (NQ,
// gridDim.x = B·H, L).
template <int D, int NQ>
__global__ void __launch_bounds__(NQ * 128)
attention_fwd_wgmma_kernel(const __grid_constant__ TcMaps maps, float* __restrict__ lse, int L,
                           int S, float scale_log2) {
  using Lay = TcLayout<D, NQ>;
  constexpr int kPanels = D / 64;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = sm90::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // swizzled tiles are 1024-byte aligned
  uint8_t* smem = smem_raw + (base - raw);

  const int tid = threadIdx.x;
  const int set = tid / 128;
  const int warp = (tid % 128) / 32, lane = tid % 32, quad = lane % 4;
  const int bh = blockIdx.x;
  const int row0 = blockIdx.y * kRows;
  const int chunks = (S + kChunk - 1) / kChunk;
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
      sm90::tma_load_3d(sk(c) + p * Lay::kPanel, &maps.k, bar_k(c), 64 * p, c * kChunk, bh);
    sm90::mbar_expect_tx(bar_v(c), Lay::kTile);
#pragma unroll
    for (int p = 0; p < kPanels; ++p)
      sm90::tma_load_3d(sv(c) + p * Lay::kPanel, &maps.v, bar_v(c), 64 * p, c * kChunk, bh);
  };

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < 5; ++i) sm90::mbar_init(bar_q + 8 * i, 1);
    sm90::mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    sm90::mbar_expect_tx(bar_q, NQ * Lay::kTile);
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int p = 0; p < kPanels; ++p)
        sm90::tma_load_3d(base + n * Lay::kTile + p * Lay::kPanel, &maps.q[n], bar_q, 64 * p, row0,
                          bh);
    load_kv(0);
    if (chunks > 1) load_kv(1);
  }

  float o[D / 2], sc[32], alpha[2];
  uint32_t p_hi[4][4], p_lo[4][4];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = 0.f;  // defined for the compiler: step 0 overwrites it
  float m_r[2] = {-INFINITY, -INFINITY};  // running row max, base-2 scaled logits
  float l_r[2] = {0.f, 0.f};              // this thread's share of the running row sum
  const uint32_t sq = base + set * Lay::kTile;
  sm90::mbar_wait(bar_q, 0);

  for (int c = 0; c < chunks; ++c) {
    sm90::mbar_wait(bar_k(c), (c >> 1) & 1);
    issue_qk<D, Lay::kPanel>(sc, sq, sk(c));
    sm90::wgmma_wait<0>();
    sm90::fence_regs(sc);
    online_softmax(sc, m_r, l_r, alpha, c * kChunk + 2 * quad, S, scale_log2);
    pack_p(sc, p_hi, p_lo);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i / 2) % 2];
    sm90::mbar_wait(bar_v(c), (c >> 1) & 1);
    issue_pv<Lay::kPanel>(o, p_hi, p_lo, sv(c));
    sm90::wgmma_wait<0>();
    sm90::fence_regs(o);
    sm90::fence_regs(p_hi);
    sm90::fence_regs(p_lo);
    __syncthreads();  // every warpgroup is done with stage c % 2: refill it
    if (tid == 0 && c + 2 < chunks) load_kv(c + 2);
  }

  // epilogue: O / l in bf16 into this set's Q tile, swizzled as TMA expects
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
    inv[r] = 1.f / l_r[r];
  }
  const int rows[2] = {warp * 16 + lane / 4, warp * 16 + lane / 4 + 8};
  sm90::store_tile<D, Lay::kPanel>(smem + set * Lay::kTile, o, inv);
  if (lse != nullptr && quad == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + rows[r];
      if (row < L)
        lse[((size_t)set * gridDim.x + bh) * L + row] = (m_r[r] + log2f(l_r[r])) * kLn2;
    }
  }
  sm90::fence_proxy_async();
  sm90::named_barrier(1 + set, 128);
  if (tid % 128 == 0) {
#pragma unroll
    for (int p = 0; p < kPanels; ++p)
      sm90::tma_store_3d(&maps.o[set], sq + p * Lay::kPanel, 64 * p, row0, bh);
    sm90::tma_store_commit_and_wait();
  }
}

template <int D, int NQ>
cudaError_t launch_wgmma(const void* q0, const void* q1, const void* k, const void* v, void* o0,
                         void* o1, float* lse, int bh, int L, int S, cudaStream_t stream) {
  const attn::EncodeTiled encode = attn::tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  TcMaps maps;
  const bool encoded = attn::encode_map(encode, &maps.q[0], q0, bh, L, D) &&
                       attn::encode_map(encode, &maps.q[1], q1, bh, L, D) &&
                       attn::encode_map(encode, &maps.k, k, bh, S, D) &&
                       attn::encode_map(encode, &maps.v, v, bh, S, D) &&
                       attn::encode_map(encode, &maps.o[0], o0, bh, L, D) &&
                       attn::encode_map(encode, &maps.o[1], o1, bh, L, D);
  if (!encoded) return cudaErrorInvalidValue;
  auto kernel = attention_fwd_wgmma_kernel<D, NQ>;
  const size_t smem = TcLayout<D, NQ>::kBytes;
  cudaError_t err = attn::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (L + kRows - 1) / kRows);
  const float scale_log2 = static_cast<float>(1.4426950408889634 / sqrt(static_cast<double>(D)));
  kernel<<<grid, NQ * 128, smem, stream>>>(maps, lse, L, S, scale_log2);
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
    return launch_wgmma<64, NQ>(q0, q1, k, v, o0, o1, lse, bh, L, S, st);
  if (dtype == 1 && D == 128)
    return launch_wgmma<128, NQ>(q0, q1, k, v, o0, o1, lse, bh, L, S, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32 (FMA kernel), 1 = bfloat16 (tensor-core kernel).  lse:
// (NQ, bh, L) f32 or null.  Returns the cudaError_t of the launch.
extern "C" int paired_attention_fwd(const void* q, const void* k, const void* v, const void* q_other,
                                    void* o1, void* o2, void* lse, int bh, int L, int S, int D,
                                    int dtype, void* stream) {
  return dispatch<2>(q, q_other, k, v, o1, o2, lse, bh, L, S, D, dtype, stream);
}

extern "C" int self_attention_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                                  int bh, int L, int S, int D, int dtype, void* stream) {
  return dispatch<1>(q, q, k, v, o, o, lse, bh, L, S, D, dtype, stream);
}
