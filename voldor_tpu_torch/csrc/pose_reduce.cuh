// The pose kernels' fixed-order block sum (meanshift_kernel.cu,
// robust_gaussian_kernel.cu), for sm_90a.
//
// One block of kThreads threads per search. Each thread keeps Q partial
// sums: thread t adds the rows t, t + kThreads, t + 2 kThreads, ... in
// turn (the caller's loop). block_sum then adds them by a halving tree:
// partial t + h into partial t for h = kThreads / 2, ..., 1 -- through
// shared memory while h >= 32, by warp shuffles below. The order depends
// on nothing but the row count, so two launches give the same bits, and
// ops/reduce.py:block_sum writes the same order in plain torch.
#pragma once

#include <cuda_runtime.h>

namespace pose {

constexpr int kThreads = 512;  // ops/reduce.py:THREADS
constexpr unsigned kFull = 0xffffffffu;

// Shared scratch of block_sum for Q values.
template <int Q>
struct TreeScratch {
  float half[Q][kThreads / 2];
  float out[Q];
};

// Sum every acc[q] over the block into s.out[q]; all threads see it on
// return. Every thread of the block must call it.
template <int Q>
__device__ __forceinline__ void block_sum(float (&acc)[Q], TreeScratch<Q>& s) {
  const int t = threadIdx.x;
#pragma unroll 1
  for (int h = kThreads / 2; h >= 32; h >>= 1) {
    if (t >= h && t < 2 * h) {
#pragma unroll
      for (int q = 0; q < Q; ++q) s.half[q][t - h] = acc[q];
    }
    __syncthreads();
    if (t < h) {
#pragma unroll
      for (int q = 0; q < Q; ++q) acc[q] = acc[q] + s.half[q][t];
    }
    __syncthreads();
  }
  if (t < 32) {
#pragma unroll
    for (int h = 16; h >= 1; h >>= 1) {
#pragma unroll
      for (int q = 0; q < Q; ++q) acc[q] = acc[q] + __shfl_down_sync(kFull, acc[q], h);
    }
    if (t == 0) {
#pragma unroll
      for (int q = 0; q < Q; ++q) s.out[q] = acc[q];
    }
  }
  __syncthreads();
}

}  // namespace pose
