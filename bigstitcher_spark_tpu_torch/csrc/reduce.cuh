// Shared fixed-order float64 reductions of K24/K25 (cg.cu) and K29
// (shard.cu). Both kernels' dot products must add in the same order, so the
// order lives here once: a rerun repeats bit for bit and no atomic touches a
// float. kThreads is the block size of the launch (a multiple of 32). Also
// the last-block ticket of K13's fused form and the shard partials that the
// sharded forms of K12 and K14 (solve.cu) add as they load them.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

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

// The last block of a launch to arrive, for a kernel whose blocks write
// several results each (last_block_total stores one partial from thread 0):
// every thread of the block calls it after the block's writing threads
// have written and fenced (__threadfence). A barrier, then thread 0 takes a
// ticket; true in every thread of the last block, which may then read
// every block's results through L2 (__ldcg). The last block resets the
// ticket for the next launch (every block has taken its ticket by then).
__device__ __forceinline__ bool last_block_arrived(int* ticket) {
  __shared__ bool am_last;
  __syncthreads();
  if (threadIdx.x == 0) {
    am_last = atomicAdd(ticket, 1) == static_cast<int>(gridDim.x) - 1;
    if (am_last) *ticket = 0;
  }
  __syncthreads();
  if (am_last) __threadfence();
  return am_last;
}

// S <= kMaxShards partial buffers of one length, passed by value in a
// kernel's parameters; their sum is taken in K29's order (shard.cu):
// ((p_0[i] + p_1[i]) + ...) + p_{S-1}[i], each add rounded on its own.
// A reader keeps several loads in flight: a load that waits for the add
// before it costs a round trip to L2 each (K12's first sharded form, one
// partial after the other for each of a tile's 36 moments, took 0.0205 ms
// against 0.0139 for K29 then K12).
constexpr int kMaxShards = 64;

struct ShardParts {
  const double* p[kMaxShards];
  int S;

  // elements off .. off + N - 1, partial by partial: N loads in flight, S
  // round trips
  template <int N>
  __device__ __forceinline__ void row(int64_t off, double (&x)[N]) const {
#pragma unroll
    for (int v = 0; v < N; ++v) x[v] = p[0][off + v];
    for (int d = 1; d < S; ++d) {
      const double* q = p[d] + off;
#pragma unroll
      for (int v = 0; v < N; ++v) x[v] = x[v] + q[v];
    }
  }
};

}  // namespace bst
