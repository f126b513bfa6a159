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
// K24 bst_cg_spmv: grid-stride over the unknowns, one thread a row:
//   p_new[i] = r[i] + beta p_old[i], and Ap[i] = sum_k vals[k] p_new[cols[k]]
//   in list order, each neighbour's p_new recomputed from r and p_old with
//   the same two roundings (so no grid-wide barrier is needed between the
//   direction update and the product). Each block sums p_new[i] Ap[i] in a
//   fixed tree; the last block to finish (a ticket) sums the block partials
//   in index order into dstate[3].
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
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 1024;  // the wrappers' partials buffer
// dstate: rs, beta, tol2, p.Ap; istate: iterations, done, cap, tickets
enum { D_RS = 0, D_BETA = 1, D_TOL2 = 2, D_PAP = 3 };
enum { I_ITERS = 0, I_DONE = 1, I_CAP = 2, I_TICKET_SPMV = 3,
       I_TICKET_UPDATE = 4 };

int blocks_for(int n) {
  const int b = (n + kThreads - 1) / kThreads;
  return b < 1 ? 1 : (b > kMaxBlocks ? kMaxBlocks : b);
}

// Fixed-order sum of one value per thread of the block (tree in shared
// memory); the result is valid in thread 0.
__device__ double block_sum(double v, double* sh) {
  sh[threadIdx.x] = v;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) sh[threadIdx.x] = sh[threadIdx.x] + sh[threadIdx.x + s];
    __syncthreads();
  }
  return sh[0];
}

// Store this block's partial and take a ticket; true in every thread of the
// last block to arrive, which then sums all partials in a fixed order
// (each thread a stride of them in index order, then the tree) into
// *total. The ticket is reset for the next launch.
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
  for (int b = threadIdx.x; b < static_cast<int>(gridDim.x); b += kThreads)
    v = v + __ldcg(partials + b);
  const double t = block_sum(v, sh);
  if (threadIdx.x == 0) {
    *total = t;
    *ticket = 0;
  }
  return true;
}

__global__ void __launch_bounds__(kThreads)
cg_spmv_kernel(int n, const int* __restrict__ row_ptr,
               const int* __restrict__ cols, const double* __restrict__ vals,
               const double* __restrict__ r, const double* __restrict__ p_old,
               double* __restrict__ p_new, double* __restrict__ ap,
               double* __restrict__ dstate, int* __restrict__ istate,
               double* __restrict__ partials) {
  __shared__ double sh[kThreads];
  if (istate[I_DONE]) return;
  const double beta = dstate[D_BETA];
  double dot = 0.0;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n;
       i += gridDim.x * kThreads) {
    const int k0 = row_ptr[i], k1 = row_ptr[i + 1];
    double s = 0.0;
    for (int k = k0; k < k1; ++k) {
      const int c = cols[k];
      const double pc = r[c] + beta * p_old[c];
      s = k == k0 ? vals[k] * pc : s + vals[k] * pc;
    }
    const double pi = r[i] + beta * p_old[i];
    p_new[i] = pi;
    ap[i] = s;
    dot = dot + pi * s;
  }
  const double part = block_sum(dot, sh);
  __syncthreads();
  double total;
  if (last_block_total(part, partials, istate + I_TICKET_SPMV, sh, &total) &&
      threadIdx.x == 0)
    dstate[D_PAP] = total;
}

__global__ void __launch_bounds__(kThreads)
cg_update_kernel(int n, int init, const double* __restrict__ rhs,
                 double* __restrict__ x, double* __restrict__ r,
                 const double* __restrict__ p, const double* __restrict__ ap,
                 double* __restrict__ dstate, int* __restrict__ istate,
                 double* __restrict__ partials) {
  __shared__ double sh[kThreads];
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
  const double part = block_sum(acc, sh);
  __syncthreads();
  double rs_new;
  if (last_block_total(part, partials, istate + I_TICKET_UPDATE, sh,
                       &rs_new) &&
      threadIdx.x == 0) {
    const int k = init ? 0 : istate[I_ITERS] + 1;
    dstate[D_BETA] = init ? 0.0 : rs_new / fmax(rs, 1e-300);
    dstate[D_RS] = rs_new;
    istate[I_ITERS] = k;
    istate[I_DONE] = (rs_new > dstate[D_TOL2] && k < istate[I_CAP]) ? 0 : 1;
  }
}

}  // namespace

extern "C" int bst_cg_spmv(int n, const void* row_ptr, const void* cols,
                           const void* vals, const void* r, const void* p_old,
                           void* p_new, void* ap, void* dstate, void* istate,
                           void* partials, void* stream) {
  if (n <= 0) return cudaErrorInvalidValue;
  cg_spmv_kernel<<<blocks_for(n), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      n, static_cast<const int*>(row_ptr), static_cast<const int*>(cols),
      static_cast<const double*>(vals), static_cast<const double*>(r),
      static_cast<const double*>(p_old), static_cast<double*>(p_new),
      static_cast<double*>(ap), static_cast<double*>(dstate),
      static_cast<int*>(istate), static_cast<double*>(partials));
  return static_cast<int>(cudaGetLastError());
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
