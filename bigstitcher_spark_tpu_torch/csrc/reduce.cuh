// Shared fixed-order float64 reductions of K24/K25 (cg.cu) and K29
// (shard.cu). Both kernels' dot products must add in the same order, so the
// order lives here once: a rerun repeats bit for bit and no atomic touches a
// float. kThreads is the block size of the launch (a multiple of 32).
#pragma once

#include <cuda_runtime.h>

namespace bst {

// Fixed-order sum of one value per thread of the block, one barrier: each
// warp's xor tree, then thread 0 adds the warps' sums in order; the result
// is valid in thread 0. sh holds kThreads / 32 doubles.
template <int kThreads>
__device__ double block_sum(double v, double* sh) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = v + __shfl_xor_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = v;
  __syncthreads();
  double t = 0.0;
  if (threadIdx.x == 0)
    for (int w = 0; w < kThreads / 32; ++w) t = t + sh[w];
  return t;
}

// Store this block's partial and take a ticket; true in every thread of the
// last block to arrive, which then sums all partials in a fixed order
// (each thread a stride of them in index order, then the block sum) into
// *total. The ticket is reset for the next launch.
template <int kThreads>
__device__ bool last_block_total(double partial, double* partials, int* ticket,
                                 double* sh, double* total) {
  __shared__ bool am_last;
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = partial;
    __threadfence();
    am_last = atomicAdd(ticket, 1) == static_cast<int>(gridDim.x) - 1;
  }
  __syncthreads();
  if (!am_last) return false;
  __threadfence();
  double v = 0.0;
#pragma unroll 8
  for (int b = threadIdx.x; b < static_cast<int>(gridDim.x); b += kThreads)
    v = v + __ldcg(partials + b);
  const double t = block_sum<kThreads>(v, sh);
  if (threadIdx.x == 0) {
    *total = t;
    *ticket = 0;
  }
  return true;
}

}  // namespace bst
