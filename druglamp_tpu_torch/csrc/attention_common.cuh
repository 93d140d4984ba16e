// Shared by the PMMA attention kernels (attention.cu, attention_bwd.cu).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

}  // namespace attn
