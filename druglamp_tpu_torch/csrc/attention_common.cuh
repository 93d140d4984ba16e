// Shared by the PMMA attention kernels (attention.cu, attention_bwd.cu).
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only: nothing links libcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace attn {

constexpr int kThreads = 256;  // a 16 x 16 grid of threads
constexpr int kRows = 64;      // query rows of each query set per tile
constexpr int kChunk = 64;     // keys per K/V chunk (two per lane in the softmax)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Above 48 KB, dynamic shared memory must be allowed per kernel.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// --- Hopper (sm_90a) primitives: mbarriers, TMA, wgmma ------------------------------

namespace sm90 {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// Makes the initialised barriers visible to the TMA unit; a __syncthreads follows.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// The single arrival of a phase, announcing the bytes the TMA copies will deliver.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// One arrival (of the count given at init), without bytes.
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Returns once the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 3-D tensor map, global -> shared, completing on `bar`.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// One box shared -> global; elements outside the map's bounds are not written.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_store_commit_and_wait() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Orders this thread's generic shared-memory writes before later async-proxy
// (TMA, wgmma) reads of them.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Counts this thread's arrival at a named barrier without waiting; threads
// that named_barrier on the same id and count wait for it.
__device__ __forceinline__ void named_barrier_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Lowers (dec) or raises (inc) this warpgroup's registers per thread; all
// four warps execute it together.  Warp-specialised kernels move registers
// from the producer warpgroup to the consumers this way.
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Returns once at most N committed wgmma groups of this warpgroup are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins registers that an asynchronous wgmma reads or writes to this point of
// the program, so the compiler moves no access to them across a wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}
template <int N, int M>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i) fence_regs(r[i]);
}

// wgmma shared-memory matrix descriptor for a tile written by TMA with 128-byte
// swizzle (layout type 1): rows of 128 bytes, 8-row swizzle atoms 1024 bytes
// apart (stride byte offset).  The leading byte offset is the distance between
// two 64-column panels along the MN dimension of an MN-major operand; a
// K-major operand reads 16 columns of one panel per instruction and ignores it.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t leading_bytes) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(leading_bytes >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// --- wgmma products on 64-row tiles ---------------------------------------------------
//
// Tiles arrive by TMA with 128-byte swizzle in panels of 64 rows x 64 bf16
// columns (kPanel = 8192 bytes); a tile of D columns is D/64 panels.  In an
// m64nN f32 accumulator, thread t of a warpgroup holds rows 16·(t/32) +
// (t%32)/4 (+8) and, per 8-column group j, columns 8j + 2·(t%4) (+1):
// d[4j + 2r + e] is row half r, column e.

#define ATTN_ACC8(i)                                                                  \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),         \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x 64) = A Bᵀ (+ d unless scale_d is 0): A 64 rows x 16 columns and B
// 64 rows x 16 columns, both K-major in shared memory.
__device__ __forceinline__ void wgmma_qk(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : ATTN_ACC8(0), ATTN_ACC8(8), ATTN_ACC8(16), ATTN_ACC8(24)
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (64 x 128) = A Bᵀ (+ d unless scale_d is 0), as above with B 128 rows.
__device__ __forceinline__ void wgmma_qk(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : ATTN_ACC8(0), ATTN_ACC8(8), ATTN_ACC8(16), ATTN_ACC8(24), ATTN_ACC8(32), ATTN_ACC8(40),
        ATTN_ACC8(48), ATTN_ACC8(56)
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (64 x D) += A B: A the 64 x 16 bf16 fragment in registers, B 16 rows x D
// columns in shared memory, MN-major (transpose bit set).
__device__ __forceinline__ void wgmma_pv(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : ATTN_ACC8(0), ATTN_ACC8(8), ATTN_ACC8(16), ATTN_ACC8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_pv(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : ATTN_ACC8(0), ATTN_ACC8(8), ATTN_ACC8(16), ATTN_ACC8(24), ATTN_ACC8(32), ATTN_ACC8(40),
        ATTN_ACC8(48), ATTN_ACC8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

#undef ATTN_ACC8

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 x) {
  return *reinterpret_cast<const uint32_t*>(&x);
}

// d (64 x 2N: 64 or 128 columns) = A Bᵀ over D columns (S = Q Kᵀ in the
// forward), both tiles K-major at shared addresses sa and sb, their 64-column
// panels kPanel and kPanelB bytes apart, issued and committed as one wgmma
// group; the caller waits for it.
template <int D, int kPanel, int kPanelB = kPanel, int N>
__device__ __forceinline__ void issue_qk(float (&d)[N], uint32_t sa, uint32_t sb) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t col = (kk % 4) * 32;
    wgmma_qk(d, sw128_desc(sa + (kk / 4) * kPanel + col, 16),
             sw128_desc(sb + (kk / 4) * kPanelB + col, 16), kk);
  }
  wgmma_commit();
}

// A 64 x 16·KK f32 accumulator (P in the forward) as the A operand of a
// product over its columns, split into bf16 hi = bf16(x) and lo = bf16(x -
// hi): 16-column step kk holds 8-column groups 2kk and 2kk+1, so register
// 2h + r of step kk is group 2kk + h, row half r.
template <int KK>
__device__ __forceinline__ void pack_p(const float (&x)[8 * KK], uint32_t (&hi)[KK][4],
                                       uint32_t (&lo)[KK][4]) {
#pragma unroll
  for (int j = 0; j < 2 * KK; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float x0 = x[4 * j + 2 * r], x1 = x[4 * j + 2 * r + 1];
      const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
      const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - __low2float(h), x1 - __high2float(h));
      hi[j / 2][2 * (j % 2) + r] = bf16x2_bits(h);
      lo[j / 2][2 * (j % 2) + r] = bf16x2_bits(l);
    }
}

// d += hi B + lo B (O += P V in the forward) over B's 16·KK rows, B MN-major
// at shared address sb with its 64-column panels kPanel bytes apart, issued
// and committed as one wgmma group.
template <int kPanel, int N, int KK>
__device__ __forceinline__ void issue_pv(float (&d)[N], const uint32_t (&hi)[KK][4],
                                         const uint32_t (&lo)[KK][4], uint32_t sb) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KK; ++kk) {
    const uint64_t desc = sw128_desc(sb + kk * 16 * 128, kPanel);
    wgmma_pv(d, hi[kk], desc);
    wgmma_pv(d, lo[kk], desc);
  }
  wgmma_commit();
}

// The m64nD accumulator acc, times its row's factor f[r], in bf16 into a
// tile laid out as TMA's 128-byte swizzle expects (for a TMA store).
template <int D, int kPanel>
__device__ __forceinline__ void store_tile(uint8_t* tile, const float (&acc)[D / 2],
                                           const float (&f)[2]) {
  const int t = threadIdx.x % 128;
  const int quad = t % 4;
  const int rows[2] = {(t / 32) * 16 + (t % 32) / 4, (t / 32) * 16 + (t % 32) / 4 + 8};
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int chunk16 = (j % 8) ^ (rows[r] % 8);
      *reinterpret_cast<__nv_bfloat162*>(tile + (j / 8) * kPanel + rows[r] * 128 + chunk16 * 16 +
                                         quad * 4) =
          __floats2bfloat162_rn(acc[4 * j + 2 * r] * f[r], acc[4 * j + 2 * r + 1] * f[r]);
    }
}

}  // namespace sm90

// --- tensor maps (host) ---------------------------------------------------------------

// cuTensorMapEncodeTiled from the driver, found at run time (no -lcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled tensor_map_encoder() {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      encode = reinterpret_cast<EncodeTiled>(fn);
  }
  return encode;
}

// A map over a contiguous (bh, rows, D) bf16 tensor in boxes of 64 rows x 64
// columns, 128-byte swizzle; reads outside it return zeros.
inline bool encode_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int bh, int rows,
                       int D) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(rows) * D * 2};
  const cuuint32_t box[3] = {64, kRows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides,
                box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace attn
