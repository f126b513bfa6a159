// K24-K25: float64 conjugate gradients of the intensity coefficient solve,
// the port of the JAX program _build_cg_fn (bigstitcher_spark_tpu/ops/
// solve.py:527, jit :587; called from ops/intensity.py:252
// _solve_coefficients_device).
//
// JAX runs matrix-free CG in one while_loop: the matvec gathers each match
// row's four unknowns and scatters its 4x4 block by segment sums, adds the
// smoothness Laplacian over adjacent-cell pairs and the diagonal. Here the
// host merges those terms once into fixed-order per-unknown lists (CSR,
// ops/solve.py assemble_cg), and one iteration is two launches on one
// stream:
//
// K24 bst_cg_spmv: G lanes a row: p_new[i] = r[i] + beta p_old[i], and
//   Ap[i] = sum_k vals[k] p_new[cols[k]], each lane summing its terms in
//   list order and a fixed xor-shuffle tree adding the lanes; each
//   neighbour's p_new is recomputed from r and p_old with the same two
//   roundings (so no grid-wide barrier is needed between the direction
//   update and the product; r and p_old, 8 MB at the large system, stay in
//   L2). Each block sums p_new[i] Ap[i] over its rows in a fixed order; the
//   last block to finish (a ticket) sums the block partials in index order
//   into dstate[3].
//   Its partial form (kPartial, the sharded CG's: the counterpart of one
//   shard's data term under shard_map, ops/solve.py:600) writes the shard's
//   Ap_d only, and p_new where p_new is not null (one launch a device needs
//   it); it takes no p.Ap block sums, no partials and no ticket: the shard
//   sum K29 (shard.cu) adds the shards' Ap_d and takes p.Ap. A template
//   flag, so the full form compiles to the parent's code.
// K25 bst_cg_update: alpha = rs / max(p.Ap, 1e-300); x += alpha p,
//   r -= alpha Ap; r.r summed as above; the last block sets beta =
//   rs_new / max(rs, 1e-300), rs, the iteration count and the done flag
//   (r.r <= tol2 or the cap). In its init form it forms r = rhs - A x0 and
//   rs only. Every block reads rs before it takes its ticket, so the last
//   block's write races with nothing.
//
// Both return at once when the done flag is set: the host launches them in
// chunks and reads the state once a chunk. No atomics touch a float: a
// rerun repeats bit for bit. Every float op is rounded on its own
// (-fmad=false); the twins in ops/solve.py take the same operations.
//
// Bound: bytes. K24 reads the lists (12 B a term), r and p_old (16 B an
// unknown; neighbours' values come from L2) and writes p_new and Ap; K25
// reads x, r, p, Ap and writes x and r (48 B an unknown).
//
// K24's design. At the large system (524,288 unknowns, 7.9 terms a row,
// 4,154,768 terms) it moves ~69 MB. A thread a row chains two dependent
// loads a term (cols[k], then r[c] and p_old[c]), ~16 serial latencies a
// row, with a warp's list loads spread over 32 rows: latency, not bytes,
// bounds it. So:
//   * G lanes a row, a power of two <= 32 that the wrapper picks from the
//     mean row length (ops/solve.py cg_lanes: 2 at the large system, the
//     fastest of G = 1 to 16 there on an H100; 8, a lane a term, was 1.25x
//     slower: a row's bounds, shuffles and stores then take 8 lanes).
//     Lane l takes terms k0 + l, k0 + l + G, ..., its first two loaded
//     together, so a warp's cols and vals loads are contiguous and a row
//     is two or three short chains, not eight long ones.
//   * The grid is sized to the rows: a block per kSweeps groups of 256 / G
//     rows (1024 rows, 512 blocks at the large system; the wrapper sizes
//     the partials buffer to it). A block's fixed costs (the state load,
//     the partial's fence and ticket) are paid once per 1024 rows; a block
//     per 256 / G rows ran 1.3-2x slower, its time growing ~3 ns a block.
//   * The lists are loaded with an L2 evict-first policy: they pass through
//     once a launch, and r, p_old (gathered) and p_new, Ap (read by K25)
//     stay in L2.
//   * Block sums (K25's too, reduce.cuh) by warp shuffles and one barrier; the last
//     block reads the partials eight loads at a time.
#include <cuda_runtime.h>
#include <stdint.h>

#include "reduce.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 1024;  // K25's grid at most
// K24: groups of 256 / G rows a block (ops/solve.py CG_SWEEPS)
constexpr int kSweeps = 8;
// dstate: rs, beta, tol2, p.Ap; istate: iterations, done, cap, tickets
enum { D_RS = 0, D_BETA = 1, D_TOL2 = 2, D_PAP = 3 };
enum { I_ITERS = 0, I_DONE = 1, I_CAP = 2, I_TICKET_SPMV = 3,
       I_TICKET_UPDATE = 4 };

int blocks_for(int n) {
  const int b = (n + kThreads - 1) / kThreads;
  return b < 1 ? 1 : (b > kMaxBlocks ? kMaxBlocks : b);
}

// K24's grid: a block per kSweeps x 256 / G rows (ops/solve.py cg_blocks)
int spmv_blocks(int n, int lanes) {
  const int rows = kThreads / lanes * kSweeps;
  return (n + rows - 1) / rows;
}

// a load of a list term, evicted first from L2: the lists pass through
// once a launch, and r, p_old (gathered) and p_new, Ap (read by K25) stay
// in L2
__device__ __forceinline__ uint64_t evict_first() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(policy));
  return policy;
}

__device__ __forceinline__ int load_stream(const int* p, uint64_t policy) {
  int v;
  asm volatile("ld.global.nc.L2::cache_hint.b32 %0, [%1], %2;\n"
               : "=r"(v)
               : "l"(p), "l"(policy));
  return v;
}

__device__ __forceinline__ double load_stream(const double* p,
                                              uint64_t policy) {
  double v;
  asm volatile("ld.global.nc.L2::cache_hint.f64 %0, [%1], %2;\n"
               : "=d"(v)
               : "l"(p), "l"(policy));
  return v;
}

// G lanes a row: lane l of row i sums terms k0 + l, k0 + l + G, ... of its
// list in order, a fixed xor tree adds the G lane sums, and lane 0 writes
// the row. A block takes kSweeps groups of 256 / G rows in turn; in each,
// a lane loads its first two terms together, then any longer row's tail.
// kPartial: Ap (and p_new unless null) only, no p.Ap.
template <int G, bool kPartial>
__global__ void __launch_bounds__(kThreads)
cg_spmv_kernel(int n, const int* __restrict__ row_ptr,
               const int* __restrict__ cols, const double* __restrict__ vals,
               const double* __restrict__ r, const double* __restrict__ p_old,
               double* __restrict__ p_new, double* __restrict__ ap,
               double* __restrict__ dstate, int* __restrict__ istate,
               double* __restrict__ partials) {
  constexpr int kRows = kThreads / G;
  __shared__ double sh[kThreads / 32];
  if (istate[I_DONE]) return;
  const double beta = dstate[D_BETA];
  const int lane = threadIdx.x & (G - 1);
  const int first = blockIdx.x * kRows * kSweeps + threadIdx.x / G;
  const uint64_t policy = evict_first();
  double dot = 0.0;
  for (int sw = 0; sw < kSweeps; ++sw) {
    const int i = first + sw * kRows;
    const bool live = i < n;
    const int k = live ? row_ptr[i] + lane : 0;
    const int k1 = live ? row_ptr[i + 1] : 0;
    const double ri = live ? r[i] : 0.0, poi = live ? p_old[i] : 0.0;
    int c[2];
    double v[2];
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      c[t] = k + t * G < k1 ? load_stream(cols + k + t * G, policy) : 0;
      v[t] = k + t * G < k1 ? load_stream(vals + k + t * G, policy) : 0.0;
    }
    double s = 0.0;
#pragma unroll
    for (int t = 0; t < 2; ++t)
      if (k + t * G < k1) s = s + v[t] * (r[c[t]] + beta * p_old[c[t]]);
    for (int kk = k + 2 * G; kk < k1; kk += G) {
      const int cc = load_stream(cols + kk, policy);
      s = s + load_stream(vals + kk, policy) * (r[cc] + beta * p_old[cc]);
    }
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1)
      s = s + __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0 && live) {
      const double pi = ri + beta * poi;
      if constexpr (kPartial) {
        if (p_new != nullptr) p_new[i] = pi;
        ap[i] = s;
      } else {
        p_new[i] = pi;
        ap[i] = s;
        dot = dot + pi * s;
      }
    }
  }
  if constexpr (kPartial) return;
  const double part = bst::block_sum<kThreads>(dot, sh);
  __syncthreads();
  double total;
  if (bst::last_block_total<kThreads>(part, partials, istate + I_TICKET_SPMV,
                                      sh, &total) &&
      threadIdx.x == 0)
    dstate[D_PAP] = total;
}

__global__ void __launch_bounds__(kThreads)
cg_update_kernel(int n, int init, const double* __restrict__ rhs,
                 double* __restrict__ x, double* __restrict__ r,
                 const double* __restrict__ p, const double* __restrict__ ap,
                 double* __restrict__ dstate, int* __restrict__ istate,
                 double* __restrict__ partials) {
  __shared__ double sh[kThreads / 32];
  if (istate[I_DONE]) return;
  const double rs = dstate[D_RS];
  const double alpha = init ? 0.0 : rs / fmax(dstate[D_PAP], 1e-300);
  double acc = 0.0;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n;
       i += gridDim.x * kThreads) {
    double ri;
    if (init) {
      ri = rhs[i] - ap[i];
    } else {
      x[i] = x[i] + alpha * p[i];
      ri = r[i] - alpha * ap[i];
    }
    r[i] = ri;
    acc = acc + ri * ri;
  }
  const double part = bst::block_sum<kThreads>(acc, sh);
  __syncthreads();
  double rs_new;
  if (bst::last_block_total<kThreads>(part, partials,
                                      istate + I_TICKET_UPDATE, sh, &rs_new) &&
      threadIdx.x == 0) {
    const int k = init ? 0 : istate[I_ITERS] + 1;
    dstate[D_BETA] = init ? 0.0 : rs_new / fmax(rs, 1e-300);
    dstate[D_RS] = rs_new;
    istate[I_ITERS] = k;
    istate[I_DONE] = (rs_new > dstate[D_TOL2] && k < istate[I_CAP]) ? 0 : 1;
  }
}

template <int G, bool kPartial>
cudaError_t launch_spmv(int n, const void* row_ptr, const void* cols,
                        const void* vals, const void* r, const void* p_old,
                        void* p_new, void* ap, void* dstate, void* istate,
                        void* partials, cudaStream_t stream) {
  cg_spmv_kernel<G, kPartial><<<spmv_blocks(n, G), kThreads, 0, stream>>>(
      n, static_cast<const int*>(row_ptr), static_cast<const int*>(cols),
      static_cast<const double*>(vals), static_cast<const double*>(r),
      static_cast<const double*>(p_old), static_cast<double*>(p_new),
      static_cast<double*>(ap), static_cast<double*>(dstate),
      static_cast<int*>(istate), static_cast<double*>(partials));
  return cudaGetLastError();
}

}  // namespace

// lanes: G lanes a row (a power of two, 1 to 32); partial: 0 the full form
// (partials: n_partials doubles, at least one a block (spmv_blocks) and 1024
// (K25's)), 1 the partial form (p_new may be null; partials unused)
extern "C" int bst_cg_spmv(int n, int lanes, int partial, const void* row_ptr,
                           const void* cols, const void* vals, const void* r,
                           const void* p_old, void* p_new, void* ap,
                           void* dstate, void* istate, void* partials,
                           int n_partials, void* stream) {
  if (n <= 0 || lanes < 1 || lanes > 32 || (lanes & (lanes - 1)) ||
      (partial != 0 && partial != 1) ||
      (!partial && (p_new == nullptr || n_partials < spmv_blocks(n, lanes))))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (lanes) {
#define BST_CG_LANES(G)                                                     \
  case G:                                                                   \
    err = partial ? launch_spmv<G, true>(n, row_ptr, cols, vals, r, p_old,  \
                                         p_new, ap, dstate, istate,         \
                                         partials, s)                       \
                  : launch_spmv<G, false>(n, row_ptr, cols, vals, r, p_old, \
                                          p_new, ap, dstate, istate,        \
                                          partials, s);                     \
    break;
    BST_CG_LANES(1)
    BST_CG_LANES(2)
    BST_CG_LANES(4)
    BST_CG_LANES(8)
    BST_CG_LANES(16)
    BST_CG_LANES(32)
#undef BST_CG_LANES
    default:
      return cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" int bst_cg_update(int n, int init, const void* rhs, void* x,
                             void* r, const void* p, const void* ap,
                             void* dstate, void* istate, void* partials,
                             void* stream) {
  if (n <= 0) return cudaErrorInvalidValue;
  cg_update_kernel<<<blocks_for(n), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      n, init, static_cast<const double*>(rhs), static_cast<double*>(x),
      static_cast<double*>(r), static_cast<const double*>(p),
      static_cast<const double*>(ap), static_cast<double*>(dstate),
      static_cast<int*>(istate), static_cast<double*>(partials));
  return static_cast<int>(cudaGetLastError());
}

// Text of a cudaError_t returned by a launcher (each library has its own copy).
extern "C" const char* bst_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
