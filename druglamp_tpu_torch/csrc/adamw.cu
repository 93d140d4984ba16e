// Hand-written Hopper (sm_90a) kernel for one AdamW step over every leaf of
// one optimizer, in one launch.
//
// Replaces no TPU kernel: on the TPU, XLA fuses the JAX package's optimizer
// update (druglamp_tpu/train/state.py, optax's adamw) into the step's one
// program.  In eager PyTorch, torch.optim.AdamW's foreach path issues a chain
// of foreach ops (the moments, the decay, the update and, with capturable,
// the bias corrections from the device's step counts), each split into
// several launches: over DrugLAMP's 236 leaves that is 528 launches an
// optimizer, and the host's time to issue them, not the card's time to run
// them, paces a training step that runs three optimizers.
//
// The arithmetic is torch's capturable foreach AdamW (decoupled weight
// decay), op for op and in its order, in f32:
//     t = step + 1
//     p ← p·(1 − lr·wd)
//     m ← m + (1 − β1)·(g − m)                       (torch's lerp, weight < ½)
//     v ← v·β2 + (1 − β2)·g·g
//     s = 1 / ((β1^t − 1) / lr)                       (= −lr / (1 − β1^t))
//     p ← p + m / ((√v / √(1 − β2^t) + ε) / s)
// with each leaf's own step count t, read from and written back to its
// device tensor.  β1, β2, ε and wd are the reference's (0.9, 0.999, 1e-8,
// 0.01); lr and 1 − lr·wd come from the host as f32, as torch casts them.
//
// What bounds it on an H100: one step reads p, g, m and v and writes p, m and
// v, 28 bytes an entry: 416.7 MB for DrugLAMP2C2P's 14,882,888 entries, 124 us
// at 3.35 TB/s.  No tensor cores, TMA or shared-memory tiles: a bandwidth
// kernel, whose bound is its bytes.
//
// Design: every leaf is cut into chunks of kChunk entries (an empty leaf has
// one chunk of nothing, so its step count still advances), and each block
// takes one chunk, so the 151 leaves of under 4,096 entries and the
// 1,048,576-entry leaves share one grid (3,800-odd blocks for DrugLAMP) with
// no block holding more than kChunk entries.  The launch's own arguments
// (Leaves, about 23 KB: CUDA 12.1 and later take 32,764 bytes of kernel
// arguments) carry each leaf's p, m, v, step and gradient pointers, its size
// and its first block; a block finds its leaf by a binary search over the
// first blocks.  So nothing but the ticket counters lives on the device
// between launches, and every pointer is the host's of this very step.  Each
// thread loads its kVec float4s of p, g, m and v before it computes (16
// loads in flight), and stores p, m and v once; a chunk whose four pointers
// are not all 16-byte aligned, and the tail of a leaf whose size is not a
// multiple of 4, go by scalars.  Every entry is read once and written once.
//
// The step counts: thread 0 of each block reads its leaf's count and works
// out the bias terms for the block.  Then, after a fence, it takes a ticket on
// the leaf's counter; the block that takes the leaf's last ticket has seen
// every other block of the leaf read the old count, writes the count t and
// resets the counter.  So the counts are incremented on the device in the
// same launch, and nothing is read back to the host.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;                           // float4s of each tensor a thread holds
constexpr int kChunk = kThreads * kVec * 4;       // 4,096 entries a block
constexpr int kMaxLeaves = 448;                   // leaves a launch's arguments carry

// torch's constants: Python doubles cast to f32 where its kernels take them
constexpr float kB1 = 0.9f;
constexpr float kB2 = 0.999f;
constexpr float kOneMinusB1 = static_cast<float>(1.0 - 0.9);
constexpr float kOneMinusB2 = static_cast<float>(1.0 - 0.999);
constexpr float kEps = 1e-8f;

// The launch's arguments for n leaves: the entries [0, n) of each array, and
// first[n], the grid.  first[i] is leaf i's first block; it rises strictly.
struct Leaves {
  float* p[kMaxLeaves];
  float* m[kMaxLeaves];
  float* v[kMaxLeaves];
  float* step[kMaxLeaves];
  const float* g[kMaxLeaves];
  int64_t numel[kMaxLeaves];
  int first[kMaxLeaves + 1];
};

__device__ __forceinline__ void update(float& p, float g, float& m, float& v, float decay,
                                       float step_size, float bc2_sqrt) {
  p = p * decay;
  m = m + kOneMinusB1 * (g - m);
  v = v * kB2;
  v = v + kOneMinusB2 * g * g;
  float denom = sqrtf(v) / bc2_sqrt;
  denom = denom + kEps;
  denom = denom / step_size;
  p = p + m / denom;
}

__device__ __forceinline__ void update4(float4& p, const float4& g, float4& m, float4& v,
                                        float decay, float s, float c) {
  update(p.x, g.x, m.x, v.x, decay, s, c);
  update(p.y, g.y, m.y, v.y, decay, s, c);
  update(p.z, g.z, m.z, v.z, decay, s, c);
  update(p.w, g.w, m.w, v.w, decay, s, c);
}

__global__ void __launch_bounds__(kThreads)
adamw_kernel(const Leaves L, int n, unsigned int* __restrict__ tickets, float lr, float decay) {
  int leaf = 0;                                           // the last leaf starting at or before
  for (int hi = n - 1; leaf < hi;) {                      // this block
    const int mid = (leaf + hi + 1) >> 1;
    if (L.first[mid] <= static_cast<int>(blockIdx.x)) leaf = mid; else hi = mid - 1;
  }
  const int64_t chunk = blockIdx.x - L.first[leaf];
  const int64_t numel = L.numel[leaf];
  float* const step = L.step[leaf];

  __shared__ float coef[2];
  if (threadIdx.x == 0) {
    const float t = *step + 1.0f;
    float bc1 = powf(kB1, t) - 1.0f;
    bc1 = bc1 / lr;
    coef[0] = 1.0f / bc1;                                 // −lr / (1 − β1^t)
    coef[1] = sqrtf(-(powf(kB2, t) - 1.0f));              // √(1 − β2^t)
    __threadfence();                                      // the count read before the ticket
    const unsigned int chunks = L.first[leaf + 1] - L.first[leaf];
    if (atomicAdd(tickets + leaf, 1u) == chunks - 1) {    // every other block has read it
      *step = t;
      tickets[leaf] = 0;
    }
  }
  __syncthreads();
  const float step_size = coef[0], bc2_sqrt = coef[1];

  const int64_t start = chunk * kChunk;
  const int len = static_cast<int>(max(static_cast<int64_t>(0),
                                       min(static_cast<int64_t>(kChunk), numel - start)));
  float* __restrict__ p = L.p[leaf] + start;
  float* __restrict__ m = L.m[leaf] + start;
  float* __restrict__ v = L.v[leaf] + start;
  const float* __restrict__ g = L.g[leaf] + start;
  const bool aligned = ((reinterpret_cast<uintptr_t>(p) | reinterpret_cast<uintptr_t>(g) |
                         reinterpret_cast<uintptr_t>(m) | reinterpret_cast<uintptr_t>(v)) & 15) == 0;
  const int nvec = aligned ? len / 4 : 0;
  if (nvec > 0) {
    float4* p4 = reinterpret_cast<float4*>(p);
    const float4* g4 = reinterpret_cast<const float4*>(g);
    float4* m4 = reinterpret_cast<float4*>(m);
    float4* v4 = reinterpret_cast<float4*>(v);
    float4 rp[kVec], rg[kVec], rm[kVec], rv[kVec];
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const int i = threadIdx.x + k * kThreads;
      if (i < nvec) {
        rp[k] = p4[i];
        rg[k] = g4[i];
        rm[k] = m4[i];
        rv[k] = v4[i];
      }
    }
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const int i = threadIdx.x + k * kThreads;
      if (i < nvec) {
        update4(rp[k], rg[k], rm[k], rv[k], decay, step_size, bc2_sqrt);
        p4[i] = rp[k];
        m4[i] = rm[k];
        v4[i] = rv[k];
      }
    }
  }
  for (int i = 4 * nvec + threadIdx.x; i < len; i += kThreads) {
    float pi = p[i], mi = m[i], vi = v[i];
    update(pi, g[i], mi, vi, decay, step_size, bc2_sqrt);
    p[i] = pi;
    m[i] = mi;
    v[i] = vi;
  }
}

}  // namespace

extern "C" {

int adamw_chunk(void) { return kChunk; }

int adamw_max_leaves(void) { return kMaxLeaves; }

// One AdamW step over n leaves.  leaves: 5n int64, for each leaf its p
// pointer, its size, and its step, m and v pointers; first: n + 1 ints, each
// leaf's first block and then the grid; grads: n device pointers; tickets: n
// unsigned ints on the device, zero between launches.  The host arrays are
// copied into the launch.  Returns the CUDA error of the launch (0 on
// success).
int adamw_step(int n, const int64_t* leaves, const int* first, const void* const* grads,
               void* tickets, float lr, float decay, void* stream) {
  if (n < 1 || n > kMaxLeaves || first[0] != 0 || first[n] < n)
    return static_cast<int>(cudaErrorInvalidValue);
  Leaves args;
  for (int i = 0; i < n; ++i) {
    const int64_t* leaf = leaves + 5 * i;
    args.p[i] = reinterpret_cast<float*>(leaf[0]);
    args.numel[i] = leaf[1];
    args.step[i] = reinterpret_cast<float*>(leaf[2]);
    args.m[i] = reinterpret_cast<float*>(leaf[3]);
    args.v[i] = reinterpret_cast<float*>(leaf[4]);
    args.g[i] = static_cast<const float*>(grads[i]);
    args.first[i] = first[i];
  }
  args.first[n] = first[n];
  adamw_kernel<<<first[n], kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      args, n, static_cast<unsigned int*>(tickets), lr, decay);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
