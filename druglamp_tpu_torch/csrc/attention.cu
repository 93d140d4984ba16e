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
// on the CUDA cores is bound by its arithmetic, not by the bytes.  The paired
// tensor-core kernel below runs at 2–3× the bytes bound (PERF.md §6): each
// warpgroup waits, chunk by chunk, on its own chain of copy, QKᵀ, softmax
// and PV.
//
// The f32 kernel and the paired bf16 kernel take one thread block per (b·h,
// 64-row query tile); every kernel streams K/V in 64-key chunks and keep an online softmax (running max and sum per row),
// so the probabilities never leave the chip and any S works.  The paired
// kernel computes both query sets of a tile against the same K/V chunk, so
// each K/V byte crosses from device memory once per tile for both products,
// which is what the Pallas kernel's shared K/V load bought on the TPU.
//
// bf16 paired (attention_fwd_wgmma_kernel<D, 2>): the products run on the
// tensor cores.
//   - One consumer warpgroup (128 threads) per query set.  Thread 0 also
//     issues the copies.
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
//     quad (shuffles 1 and 2); exponentials in base 2, the scale folded into
//     one FMA; only a chunk that runs past S is masked, and a rescale by
//     alpha = 1 is skipped.
//   - O += P V: P is reused from the accumulator registers as the A operand
//     (wgmma m64nDk16, 4 steps per chunk); V is the B operand read MN-major
//     (transpose bit).  P is split into P_hi = bf16(P) and P_lo = bf16(P -
//     P_hi), two products into the same f32 accumulators, so P keeps ~16
//     bits as the Pallas kernel's f32 P does.  That lifts a paired launch to
//     6.4 GFLOP, 6.5 us at the tensor-core peak: still under the bytes bound.
//   - Epilogue: O/l rounded to bf16 into the (swizzled) Q tile, then one TMA
//     store per panel; lse = m + log l when asked for.
// bf16 self (attention_fwd_ws_wgmma_kernel): the same arithmetic, warp-
//   specialised and persistent, because one warpgroup that waits chunk by
//   chunk on its own copy, QKᵀ, softmax and P·V left the tensor cores idle
//   (2.1× the bytes bound at B = 32 on an H100, PERF.md §6): a producer
//   warpgroup issues every TMA load and gives its registers to two consumer
//   warpgroups, which own the two 64-row halves of a 128-row tile, share
//   each K/V chunk and take turns at the tensor cores, so one's softmax
//   overlaps the other's products.
//   Each consumer also issues chunk c's QKᵀ with chunk c-1's P·V.  Chunks
//   are 128 keys (S = 256 is two), so each step's products are twice as
//   large as the paired kernel's and there are half as many waits.  One block
//   per SM walks the tiles; Q is double-buffered and K/V run in a two-stage
//   ring, so the next tile's loads overlap this tile's work and epilogue.
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

// 2^x, flushing a subnormal result to 0 (one MUFU.EX2; exp2f adds the
// subnormal range, which no probability here needs).
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The online softmax of one chunk of raw logits sc = q·k (an m64 accumulator
// of N / 2 keys key0 .. key0 + N / 2; keys ≥ S masked to -inf), in place: sc becomes exp2(x - m)
// of the base-2 scaled logits x = sc · scale_log2, taken in one FMA, m_r the
// new row max of x, l_r this thread's share of the row sum; alpha =
// exp2(m_old - m) rescales what was accumulated before.  The scale is > 0,
// so the max of the scaled logits is the scaled max.  Each chunk has at
// least one key < S, so the new max is finite; on the first chunk alpha is 0.
template <int N>
__device__ __forceinline__ void online_softmax(float (&sc)[N], float (&m_r)[2], float (&l_r)[2],
                                               float (&alpha)[2], int key0, int S,
                                               float scale_log2) {
  if (key0 + 2 * N > S) {  // the chunk runs past S (the same for the whole warpgroup)
    const int k0 = key0 + 2 * (threadIdx.x % 4);
#pragma unroll
    for (int j = 0; j < N / 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (k0 + 8 * j + (e & 1) >= S) sc[4 * j + e] = -INFINITY;
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < N; ++i) mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], sc[i]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m_r[r], mx[r] * scale_log2);
    alpha[r] = exp2_ftz(m_r[r] - m_new);
    m_r[r] = m_new;
    l_r[r] *= alpha[r];
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    sc[i] = exp2_ftz(fmaf(sc[i], scale_log2, -m_r[(i / 2) % 2]));
    l_r[(i / 2) % 2] += sc[i];
  }
}

// acc *= alpha (its row's factor), skipped when every row of the warp keeps
// its max (alpha = 1 exactly: the product would change nothing).
template <int N>
__device__ __forceinline__ void rescale(float (&acc)[N], const float (&alpha)[2]) {
  if (!__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) return;
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] *= alpha[(i / 2) % 2];
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
    online_softmax(sc, m_r, l_r, alpha, c * kChunk, S, scale_log2);
    pack_p(sc, p_hi, p_lo);
    rescale(o, alpha);
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

// --- bf16 self-attention: warp-specialised, persistent ----------------------------------

constexpr int kWsChunk = 128;    // keys per K/V chunk
constexpr int kWsStages = 2;     // K/V ring stages: a whole S = 256 in flight
constexpr int kWsThreads = 384;  // producer warpgroup + two consumer warpgroups
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
// The consumers' registers come from the producer's: the block holds
// kWsThreads × (its launch count) registers, so the launch count must be at
// least what the split needs, or setmaxnreg.inc would wait for ever.
constexpr int kWsMinRegs = (128 * kProducerRegs + 256 * kConsumerRegs + kWsThreads - 1) / kWsThreads;
// Named barriers: 1 + n is consumer n's turn at the tensor cores, 3 + n its
// epilogue (0 is __syncthreads).
constexpr int kTurnBar = 1;
constexpr int kStoreBar = 3;

template <int D>
struct WsLayout {
  static constexpr int kPanel = kRows * 128;       // one TMA box: 64 rows x 64 bf16 columns
  static constexpr int kTile = (D / 64) * kPanel;  // 64 rows x D columns: a Q tile
  static constexpr int kKVPanel = 2 * kPanel;      // a chunk's 128 rows x 64 columns: two boxes
  static constexpr int kKVTile = (D / 64) * kKVPanel;
  static constexpr int kK = 4 * kTile;             // after Q: 2 buffers x 2 consumer tiles
  static constexpr int kV = kK + kWsStages * kKVTile;
  static constexpr int kBar = kV + kWsStages * kKVTile;
  // mbarriers: q_full[2], q_empty[2], k_full[kWsStages], v_full[kWsStages],
  // kv_empty[kWsStages]
  static constexpr size_t kBytes = kBar + (4 + 3 * kWsStages) * 8 + 1024;  // + 1024-byte alignment
};

// softmax(Q Kᵀ/√D) V for bf16, one query set.  Persistent blocks walk the
// (b·h, 128-row) tiles; each block is three warpgroups:
//   - warpgroup 0, the producer: one thread issues every TMA load (Q of a
//     tile into one of two buffers, 128-key K and V chunks into a kWsStages
//     ring), waiting only for buffers to be released; its registers go to
//     the consumers (setmaxnreg).
//   - warpgroups 1 and 2, the consumers: each owns one 64-row half of the
//     tile against the same K/V chunks.  A consumer's step c issues QKᵀ of
//     chunk c and P·V of chunk c-1 together, in its turn at the tensor cores
//     (named barriers hand the turn back and forth), then runs chunk c's
//     softmax while the other consumer's products run.
// The arithmetic per row is that of attention_fwd_wgmma_kernel over 128-key
// chunks (tests/test_torch_port_kernels.py::_tile_attention emulates both):
// S = Q Kᵀ, online softmax (rescale by alpha after chunk c-1's P·V, before
// chunk c's), P as bf16 hi + lo, O / l in bf16 by a TMA store through the
// consumer's Q tile, lse = m + log l when asked for.
template <int D>
__global__ void __launch_bounds__(kWsThreads, 1)
attention_fwd_ws_wgmma_kernel(const __grid_constant__ TcMaps maps, float* __restrict__ lse,
                              int bh_count, int L, int S, float scale_log2) {
  using Lay = WsLayout<D>;
  constexpr int kPanels = D / 64;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = sm90::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // swizzled tiles are 1024-byte aligned
  uint8_t* smem = smem_raw + (base - raw);

  const int row_tiles = (L + 2 * kRows - 1) / (2 * kRows);
  const int tiles = bh_count * row_tiles;
  const int chunks = (S + kWsChunk - 1) / kWsChunk;
  const uint32_t bars = base + Lay::kBar;
  const auto q_full = [&](int b) { return bars + 8 * b; };
  const auto q_empty = [&](int b) { return bars + 16 + 8 * b; };
  const auto k_full = [&](int s) { return bars + 32 + 8 * s; };
  const auto v_full = [&](int s) { return bars + 32 + 8 * (kWsStages + s); };
  const auto kv_empty = [&](int s) { return bars + 32 + 8 * (2 * kWsStages + s); };
  const auto sq = [&](int b, int n) { return base + (2 * b + n) * Lay::kTile; };
  const auto sk = [&](int s) { return base + Lay::kK + s * Lay::kKVTile; };
  const auto sv = [&](int s) { return base + Lay::kV + s * Lay::kKVTile; };

  if (threadIdx.x == 0) {
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      sm90::mbar_init(q_full(b), 1);
      sm90::mbar_init(q_empty(b), 2);  // one arrival per consumer
    }
#pragma unroll
    for (int s = 0; s < kWsStages; ++s) {
      sm90::mbar_init(k_full(s), 1);
      sm90::mbar_init(v_full(s), 1);
      sm90::mbar_init(kv_empty(s), 2);
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer ----
    sm90::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      int it = 0;  // K/V chunks issued so far
      int i = 0;   // tiles of this block so far
      for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++i) {
        const int bh = t / row_tiles, row0 = (t % row_tiles) * 2 * kRows;
        const int b = i & 1;
        sm90::mbar_wait(q_empty(b), ((i >> 1) & 1) ^ 1);  // the first use of a buffer passes
        sm90::mbar_expect_tx(q_full(b), 2 * Lay::kTile);
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int p = 0; p < kPanels; ++p)
            sm90::tma_load_3d(sq(b, n) + p * Lay::kPanel, &maps.q[0], q_full(b), 64 * p,
                              row0 + n * kRows, bh);
        for (int c = 0; c < chunks; ++c, ++it) {
          const int s = it % kWsStages;
          sm90::mbar_wait(kv_empty(s), ((it / kWsStages) & 1) ^ 1);
          sm90::mbar_expect_tx(k_full(s), Lay::kKVTile);
          sm90::mbar_expect_tx(v_full(s), Lay::kKVTile);
#pragma unroll
          for (int p = 0; p < kPanels; ++p)
#pragma unroll
            for (int h = 0; h < 2; ++h) {  // the chunk's two 64-row boxes of panel p
              const uint32_t off = p * Lay::kKVPanel + h * Lay::kPanel;
              const int row = c * kWsChunk + h * kRows;
              sm90::tma_load_3d(sk(s) + off, &maps.k, k_full(s), 64 * p, row, bh);
              sm90::tma_load_3d(sv(s) + off, &maps.v, v_full(s), 64 * p, row, bh);
            }
        }
      }
    }
  } else {
    // ---- consumers ----
    sm90::setmaxnreg_inc<kConsumerRegs>();
    const int n = threadIdx.x / 128 - 1;  // which 64-row half of the tile
    const int t128 = threadIdx.x % 128;
    const int warp = t128 / 32, lane = t128 % 32, quad = lane % 4;
    const int rows[2] = {warp * 16 + lane / 4, warp * 16 + lane / 4 + 8};
    if (n == 1) sm90::named_barrier_arrive(kTurnBar, 256);  // consumer 0 goes first

    constexpr int kSteps = kWsChunk / 16;  // 16-key steps of P·V per chunk
    float o[D / 2], sc[kWsChunk / 2], alpha[2], m_r[2], l_r[2];
    uint32_t p_hi[kSteps][4], p_lo[kSteps][4];
#pragma unroll
    for (int i = 0; i < kWsChunk / 2; ++i) sc[i] = 0.f;  // defined for the compiler: QKᵀ overwrites it
#pragma unroll
    for (int k = 0; k < kSteps; ++k)
#pragma unroll
      for (int e = 0; e < 4; ++e) p_hi[k][e] = p_lo[k][e] = 0u;
    int it = 0, i = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++i) {
      const int bh = t / row_tiles, row0 = (t % row_tiles) * 2 * kRows + n * kRows;
      const int b = i & 1;
      const bool last_tile = t + gridDim.x >= tiles;
      const uint32_t q = sq(b, n);
#pragma unroll
      for (int k = 0; k < D / 2; ++k) o[k] = 0.f;
      m_r[0] = m_r[1] = -INFINITY;  // running row max, base-2 scaled logits
      l_r[0] = l_r[1] = 0.f;        // this thread's share of the running row sum
      sm90::mbar_wait(q_full(b), (i >> 1) & 1);

      const auto stage = [&](int c) { return (it + c) % kWsStages; };
      const auto parity = [&](int c) { return static_cast<uint32_t>((it + c) / kWsStages) & 1; };
      // Each step issues its products in this consumer's turn and hands the
      // turn over; consumer 1's last step has no turn of consumer 0 after it.
      // wgmma issues stay out of conditional code: ptxas serialises them there.
      const auto take_turn = [&] { sm90::named_barrier(kTurnBar + n, 256); };
      const auto pass_turn = [&](bool last_step) {
        if (!(n == 1 && last_tile && last_step)) sm90::named_barrier_arrive(kTurnBar + 1 - n, 256);
      };

      // step 0: QKᵀ of chunk 0 (o is 0: nothing to rescale)
      sm90::mbar_wait(k_full(stage(0)), parity(0));
      take_turn();
      issue_qk<D, Lay::kPanel, Lay::kKVPanel>(sc, q, sk(stage(0)));
      pass_turn(false);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(sc);
      online_softmax(sc, m_r, l_r, alpha, 0, S, scale_log2);
      pack_p(sc, p_hi, p_lo);
      // step c: QKᵀ of chunk c with P·V of chunk c - 1; chunk c's softmax runs
      // while P·V does
      for (int c = 1; c < chunks; ++c) {
        sm90::mbar_wait(k_full(stage(c)), parity(c));
        sm90::mbar_wait(v_full(stage(c - 1)), parity(c - 1));
        take_turn();
        issue_qk<D, Lay::kPanel, Lay::kKVPanel>(sc, q, sk(stage(c)));
        issue_pv<Lay::kKVPanel>(o, p_hi, p_lo, sv(stage(c - 1)));
        pass_turn(false);
        sm90::wgmma_wait<1>();  // QKᵀ, committed first, is done
        sm90::fence_regs(sc);
        online_softmax(sc, m_r, l_r, alpha, c * kWsChunk, S, scale_log2);
        sm90::wgmma_wait<0>();
        sm90::fence_regs(o);
        sm90::fence_regs(p_hi);
        sm90::fence_regs(p_lo);
        if (t128 == 0) sm90::mbar_arrive(kv_empty(stage(c - 1)));  // done with chunk c - 1
        pack_p(sc, p_hi, p_lo);
        rescale(o, alpha);
      }
      // last step: P·V of the last chunk
      sm90::mbar_wait(v_full(stage(chunks - 1)), parity(chunks - 1));
      take_turn();
      issue_pv<Lay::kKVPanel>(o, p_hi, p_lo, sv(stage(chunks - 1)));
      pass_turn(true);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(o);
      if (t128 == 0) sm90::mbar_arrive(kv_empty(stage(chunks - 1)));
      it += chunks;

      // epilogue: O / l in bf16 into this consumer's Q tile, swizzled as TMA expects
      float inv[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
        l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
        inv[r] = 1.f / l_r[r];
      }
      sm90::store_tile<D, Lay::kPanel>(smem + (q - base), o, inv);
      if (lse != nullptr && quad == 0) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = row0 + rows[r];
          if (row < L) lse[(size_t)bh * L + row] = (m_r[r] + log2f(l_r[r])) * kLn2;
        }
      }
      sm90::fence_proxy_async();
      sm90::named_barrier(kStoreBar + n, 128);
      if (t128 == 0) {
#pragma unroll
        for (int p = 0; p < kPanels; ++p)
          sm90::tma_store_3d(&maps.o[0], q + p * Lay::kPanel, 64 * p, row0, bh);
        sm90::tma_store_commit_and_wait();  // the tile is read: Q's buffer may be refilled
        sm90::mbar_arrive(q_empty(b));
      }
    }
  }
}

// The number of SMs of the current device (the persistent grid's size).
inline int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return sms;
}

template <int D>
cudaError_t launch_self_ws(const void* q, const void* k, const void* v, void* o, float* lse,
                           int bh, int L, int S, cudaStream_t stream) {
  const attn::EncodeTiled encode = attn::tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  TcMaps maps;
  const bool encoded = attn::encode_map(encode, &maps.q[0], q, bh, L, D) &&
                       attn::encode_map(encode, &maps.k, k, bh, S, D) &&
                       attn::encode_map(encode, &maps.v, v, bh, S, D) &&
                       attn::encode_map(encode, &maps.o[0], o, bh, L, D);
  if (!encoded) return cudaErrorInvalidValue;
  maps.q[1] = maps.q[0];
  maps.o[1] = maps.o[0];
  auto kernel = attention_fwd_ws_wgmma_kernel<D>;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  if (attr.numRegs < kWsMinRegs) return cudaErrorInvalidConfiguration;
  const size_t smem = WsLayout<D>::kBytes;
  err = attn::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int tiles = bh * ((L + 2 * kRows - 1) / (2 * kRows));
  const int sms = sm_count();
  if (sms <= 0) return cudaErrorInvalidDevice;
  const float scale_log2 = static_cast<float>(1.4426950408889634 / sqrt(static_cast<double>(D)));
  kernel<<<tiles < sms ? tiles : sms, kWsThreads, smem, stream>>>(maps, lse, bh, L, S,
                                                                 scale_log2);
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
  if constexpr (NQ == 1) {
    if (dtype == 1 && D == 64) return launch_self_ws<64>(q0, k, v, o0, lse, bh, L, S, st);
    if (dtype == 1 && D == 128) return launch_self_ws<128>(q0, k, v, o0, lse, bh, L, S, st);
  } else {
    if (dtype == 1 && D == 64)
      return launch_wgmma<64, NQ>(q0, q1, k, v, o0, o1, lse, bh, L, S, st);
    if (dtype == 1 && D == 128)
      return launch_wgmma<128, NQ>(q0, q1, k, v, o0, o1, lse, bh, L, S, st);
  }
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
