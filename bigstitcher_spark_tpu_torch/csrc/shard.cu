// K29: the shard sum, the reduction of the sharded global solves: the
// counterpart of lax.psum in the JAX programs _build_relax_fn (shard_map at
// bigstitcher_spark_tpu/ops/solve.py:428, psums of the segment moments and
// error sums) and _build_cg_fn (shard_map at :600, a psum of each matvec's
// data term).
//
// bst_shard_sum: on one device,
//   out[i] = ((p_0[i] + p_1[i]) + ... + p_{S-1}[i]) [+ rep[i]]
// over S float64 partial buffers of length n, in shard order, every add
// rounded on its own (-fmad=false), as the plain twin ops/shard.py
// shard_sum_plain adds. The relax shards hold every tile's entry and a tile's
// rows lie on one shard, so the other shards add exact zeros: the sum is
// bitwise the one-device segment sum. With v, also dot = out . v: each
// thread sums its strided share in index order, a fixed warp / block tree
// adds the threads, and the last block to finish (a ticket) adds the block
// partials in index order into *dot: reduce.cuh's block_sum and
// last_block_total, the order of K24/K25 in cg.cu. With done, the launch
// returns at once when *done != 0 (the solve loops launch in chunks and
// read their state once a chunk).
//
// The S partial pointers travel by value in the kernel's parameters (at most
// kMaxShards); the host wrapper brings the partials of other devices to this
// one first (peer copies ordered by CUDA events). No atomics touch a float:
// a rerun repeats bit for bit.
//
// Bound: bytes. Reads S (+ rep, + v) x 8 B an element, writes 8 B.
#include <cuda_runtime.h>
#include <stdint.h>

#include "reduce.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 1024;
constexpr int kMaxShards = 64;

struct Parts {
  const double* p[kMaxShards];
};

int blocks_for(int64_t n) {
  const int64_t b = (n + kThreads - 1) / kThreads;
  return static_cast<int>(b < 1 ? 1 : (b > kMaxBlocks ? kMaxBlocks : b));
}

__global__ void __launch_bounds__(kThreads)
shard_sum_kernel(int64_t n, int S, Parts parts, const double* __restrict__ rep,
                 double* __restrict__ out, const double* __restrict__ v,
                 double* __restrict__ dot, double* __restrict__ partials,
                 int* __restrict__ ticket, const int* __restrict__ done) {
  __shared__ double sh[kThreads / 32];
  if (done != nullptr && *done) return;
  double acc = 0.0;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * kThreads) {
    double s = parts.p[0][i];
    for (int d = 1; d < S; ++d) s = s + parts.p[d][i];
    if (rep != nullptr) s = s + rep[i];
    out[i] = s;
    if (v != nullptr) acc = acc + s * v[i];
  }
  if (v == nullptr) return;
  const double part = bst::block_sum<kThreads>(acc, sh);
  __syncthreads();
  double total;
  if (bst::last_block_total<kThreads>(part, partials, ticket, sh, &total) &&
      threadIdx.x == 0)
    *dot = total;
}

}  // namespace

// parts: a host array of S device pointers (1 <= S <= 64), each n doubles;
// rep, v, dot, done may be null (v and dot together); with v, partials holds
// n_partials >= bst_shard_sum_blocks(n) doubles and ticket an int that is 0.
extern "C" int bst_shard_sum_blocks(int64_t n) { return blocks_for(n); }

extern "C" int bst_shard_sum(int64_t n, int S, const void* parts,
                             const void* rep, void* out, const void* v,
                             void* dot, void* partials, int n_partials,
                             void* ticket, const void* done, void* stream) {
  if (n <= 0 || S < 1 || S > kMaxShards || parts == nullptr ||
      out == nullptr || (v == nullptr) != (dot == nullptr) ||
      (v != nullptr && (partials == nullptr || ticket == nullptr ||
                        n_partials < blocks_for(n))))
    return cudaErrorInvalidValue;
  Parts P = {};
  const double* const* host = static_cast<const double* const*>(parts);
  for (int d = 0; d < S; ++d) {
    if (host[d] == nullptr) return cudaErrorInvalidValue;
    P.p[d] = host[d];
  }
  shard_sum_kernel<<<blocks_for(n), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      n, S, P, static_cast<const double*>(rep), static_cast<double*>(out),
      static_cast<const double*>(v), static_cast<double*>(dot),
      static_cast<double*>(partials), static_cast<int*>(ticket),
      static_cast<const int*>(done));
  return static_cast<int>(cudaGetLastError());
}

// Text of a cudaError_t returned by a launcher (each library has its own copy).
extern "C" const char* bst_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
