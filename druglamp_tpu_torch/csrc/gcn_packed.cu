// Hand-written Hopper (sm_90a) kernel for the GCN aggregate over a bit-packed
// adjacency.
//
// Replaces the Pallas TPU kernel druglamp_tpu/kernels/gcn_pallas.py::
// gcn_packed_matmul (_gcn_kernel / _gcn_call):
//     y = diag(n) · A · diag(n) · x + diag(n²·real) · x
// A is the (B, N, N) {0,1} adjacency (bonds plus one self-loop on every node),
// read from its bits; the second self-loop of the real atoms is the n2r term.
// x·n is rounded to x's dtype before the product, as the Pallas kernel does;
// the products with A's 0/1 entries are exact, the sums are f32 and y is f32.
// Operands: packed (B, N, N/8) uint8, nrm = n and n2r = n²·real (B, N) f32,
// x (B, N, C) float or bf16, y (B, N, C) f32, all contiguous; N a multiple
// of 64, C 64 or 128.
//
// Bit layout (group-64, druglamp_tpu_torch/data/encoding.py): column j of a
// row lives in byte j mod nb, bit j div nb (nb = N/8), so bit k of the row's
// bytes is the contiguous column range [k·nb, (k+1)·nb) — not np.packbits'
// order.  Read as little-endian 32-bit words, bit t of word w is byte
// 4w + t/8, plane t%8: column (t%8)·nb + 4w + t/8.
//
// What bounds it on an H100: at the training shape (B=16, N=512, C=128, bf16
// x) one launch reads 0.52 MB of bits, 2.10 MB of x and 64 KB of scales and
// writes 4.19 MB of y: 6.9 MB, 2.1 us at 3.35 TB/s.  The dense product would
// be 1.07 GFLOP (1.1 us at the bf16 tensor-core peak), so the bytes set the
// bound — provided A is never expanded in device memory.
//
// Design: a molecule's adjacency is sparse (2 to 4 set bits in a row of 512),
// so the kernel walks the set bits instead of multiplying by zeros.  One block
// per (b, 64-row tile), one warp per row at a time; each lane owns C/32
// columns (lane + 32·v, so every load of a warp is one contiguous row
// segment).  The warp loads the row's words (one per lane), and walks the
// non-zero ones in order with a ballot and a shuffle: the loop is uniform over
// the warp, with no divergence.  For each set bit j it adds round(x[j]·n[j])
// to its f32 accumulators (x's rows are re-read from L1/L2 by their few
// neighbours).  A dense adjacency is still right, only slower.  The work
// follows the set bits; tensor cores would need A's dense tiles and are not
// used.
//
// The backward is a second launch on dy: S = diag(n)(A + diag(real))diag(n)
// is symmetric, so dx = S·dy (kernels/gcn.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowsPerBlock = 64;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// x rounded to T and back (the Pallas kernel's (x * nrm).astype(x.dtype)).
template <typename T> __device__ __forceinline__ float round_as(float x);
template <> __device__ __forceinline__ float round_as<float>(float x) { return x; }
template <> __device__ __forceinline__ float round_as<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// VPL = C / 32 columns per lane.
template <typename T, int VPL>
__global__ void __launch_bounds__(kThreads)
gcn_packed_kernel(const uint8_t* __restrict__ packed, const float* __restrict__ nrm,
                  const float* __restrict__ n2r, const T* __restrict__ x,
                  float* __restrict__ y, int N) {
  constexpr int C = 32 * VPL;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const size_t g0 = static_cast<size_t>(blockIdx.y) * N;  // first row of graph b
  const int nb = N / 8;                                    // bytes per row
  const int nwords = nb / 4;
  const T* xb = x + g0 * C;
  const float* nrmb = nrm + g0;
  const int row_end = (blockIdx.x + 1) * kRowsPerBlock;

  for (int r = blockIdx.x * kRowsPerBlock + warp; r < row_end; r += kWarps) {
    const uint32_t* words = reinterpret_cast<const uint32_t*>(packed + (g0 + r) * nb);
    float acc[VPL];
#pragma unroll
    for (int v = 0; v < VPL; ++v) acc[v] = 0.f;

    for (int w0 = 0; w0 < nwords; w0 += 32) {
      const uint32_t mine = w0 + lane < nwords ? words[w0 + lane] : 0u;
      unsigned pending = __ballot_sync(kFull, mine != 0u);
      while (pending != 0u) {  // warp-uniform: every lane walks the same bits
        const int src = __ffs(static_cast<int>(pending)) - 1;
        pending &= pending - 1u;
        uint32_t word = __shfl_sync(kFull, mine, src);
        const int byte0 = (w0 + src) * 4;
        while (word != 0u) {
          const int t = __ffs(static_cast<int>(word)) - 1;
          word &= word - 1u;
          const int j = (t & 7) * nb + byte0 + (t >> 3);
          const float s = nrmb[j];
          const T* xj = xb + static_cast<size_t>(j) * C + lane;
#pragma unroll
          for (int v = 0; v < VPL; ++v) acc[v] += round_as<T>(to_f32(xj[32 * v]) * s);
        }
      }
    }

    const float nr = nrmb[r], n2 = n2r[g0 + r];
    const T* xr = xb + static_cast<size_t>(r) * C + lane;
    float* yr = y + (g0 + r) * C + lane;
#pragma unroll
    for (int v = 0; v < VPL; ++v) yr[32 * v] = nr * acc[v] + n2 * to_f32(xr[32 * v]);
  }
}

template <typename T, int VPL>
cudaError_t launch(const void* packed, const void* nrm, const void* n2r, const void* x, void* y,
                   int B, int N, cudaStream_t stream) {
  const dim3 grid(N / kRowsPerBlock, B);
  gcn_packed_kernel<T, VPL><<<grid, kThreads, 0, stream>>>(
      static_cast<const uint8_t*>(packed), static_cast<const float*>(nrm),
      static_cast<const float*>(n2r), static_cast<const T*>(x), static_cast<float*>(y), N);
  return cudaGetLastError();
}

}  // namespace

// dtype of x: 0 = float32, 1 = bfloat16.  Returns the cudaError_t of the
// launch (cudaErrorInvalidValue for a shape or dtype it does not take).
extern "C" int gcn_packed_fwd(const void* packed, const void* nrm, const void* n2r, const void* x,
                              void* y, int B, int N, int C, int dtype, void* stream) {
  if (B < 1 || B > 65535 || N < kRowsPerBlock || N % kRowsPerBlock != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && C == 64) return launch<float, 2>(packed, nrm, n2r, x, y, B, N, st);
  if (dtype == 0 && C == 128) return launch<float, 4>(packed, nrm, n2r, x, y, B, N, st);
  if (dtype == 1 && C == 64) return launch<__nv_bfloat16, 2>(packed, nrm, n2r, x, y, B, N, st);
  if (dtype == 1 && C == 128) return launch<__nv_bfloat16, 4>(packed, nrm, n2r, x, y, B, N, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
