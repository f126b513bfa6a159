// K11-K14: the tile relaxation of the global solver, in float64
// (bigstitcher_spark_tpu/ops/solve.py:308 _relax_core, jitted at :410; the
// JAX program is one lax.while_loop). One iteration is K11 -> K12 -> K13
// with K14 in its last block (the fused form below) on one stream; sharded,
// K11 and K13 on each shard and K12 and K14 adding the shards' partials as
// they load them. The host launches iterations in chunks and reads the
// state (iteration count, done flag) once per chunk, so nothing crosses to
// the host per iteration. Every kernel returns at once when the state's done
// flag is set.
//
// Rows (one per point match and side, ops/solve.py prepare_relax) are
// grouped by owner tile, in their flattened order within each tile:
// tile_ptr (T+1) is the CSR of the groups. A tile is reduced by `wpt` warps
// (1, 2, 4 or 8; the wrapper picks it from the rows per tile), each lane
// striding over the tile's rows, then warp shuffles, then the wpt warps'
// partial sums added in warp order: every sum has one fixed order, no
// atomics, so a run repeats bit for bit (the convergence thresholds compare
// differences of 1e-9 and the iteration counts must not move).
//
// K11 relax_moments: per tile, under the current models `cur` (T, 3, 4):
//   w_eff = w * link_w[link_id], tw = M_other [q; 1] - o, ph = [p - o; 1]
//   with o the tile's origin (the mean of its active rows' p, computed
//   once a solve by ops/solve.py tile_origin),
//   and the 36 sums sw, swp (4), swq (3), spp (4x4), spq (4x3) of w_eff,
//   w_eff ph, w_eff tw, (w_eff ph) ph^T, (w_eff ph) tw^T -> moments (T,
//   36). About the world origin (as the JAX program sums) the AFFINE normal
//   equations of 2048-px tiles ~30,000 px out reach condition numbers of
//   1e11-1e13; about o they are well conditioned. Bound: bytes (64 B a
//   row: p, q, other, w, link_id; the gathered models stay in L2).
// K12 relax_fit: the model from the moments (_fit_from_moments_jnp,
//   ops/solve.py:273), and the regulariser's, then (1 - lam) m + lam r,
//   shifted back from o to world coordinates (t = (t' + o) - A o); identity
//   where sw <= 0 or the tile is fixed; then cur = (1 - damping) cur +
//   damping new, in place. TRANSLATION in closed form; AFFINE by Gaussian
//   elimination with partial pivoting on the 4x4 spp + 1e-9 I (that ridge
//   carried to o) with 3 right-hand sides; RIGID the weighted Kabsch fit
//   from the 3x3 H through a one-sided Jacobi SVD, singular values sorted
//   in descending order (the JAX code flips the LAST singular vector, which
//   in LAPACK's order is the smallest). Bound: operations (a few hundred
//   float64 flops a tile), but a tile's fit is one long dependent chain of
//   float64 divides and square roots (each a multi-instruction sequence):
//   latency, not throughput, sets the time. The first form gave a
//   thread a tile and ran both fits one after the other, every fit kind
//   compiled into one body, the moments loaded 288 B apart, the singular
//   vectors indexed by a run-time permutation (a 256-byte local stack).
//   This form: a block of 32 tiles, templated on the (model, regulariser)
//   pair so that only the fits it needs are compiled; warp 0 fits the
//   model while warp 1 fits the regulariser (two chains at once, on two
//   schedulers), its results handed over in shared memory; warp 0 blends,
//   shifts back and writes; the sort and the pivoting move values between
//   registers (no local stack). Every divide, square root and sum is the
//   first form's, in its order (-fmad=false): bitwise the first form's
//   models. Sharded form (fit_parts_kernel): the S shards' moment partials
//   travel by value (bst::ShardParts, at most 64) and each moment is their
//   sum in K29's order, ((p_0 + p_1) + ...) + p_{S-1}, taken as a lane
//   loads its tile's 36 moments partial by partial (36 loads in flight, S
//   round trips): bitwise K29 then K12, without K29's launch (2.7 us for
//   0.2 us of bytes at 4 x 512 x 36).
// K13 relax_error: per segment, sum ||M_own p - M_other q|| w_eff and
//   sum w_eff. Segments are tiles (rows contiguous, for the mean error of
//   K14), or links (rows listed by index: the A-side rows of each link, for
//   the per-link errors under the final models, :387-395). Bound: bytes.
// K14 relax_converge: one block. err = sum(num) / max(sum(den), 1e-12) over
//   the tiles (each thread a strided share in tile order, then a tree), then
//   _relax_core's rules (:360-373): hist[i] = err; the stall count (prev -
//   err < 1e-9 max(err, 1), 5 in a row); the plateau (it > pw, err <
//   max_error, and hist[it - pw - 1] - min(hist[it - pw : it]) < 1e-4
//   max(err, 1e-12) or err < 1e-9); the max_iter cap. state = {iterations,
//   stall, done, 0} (int32). Bound: its launch. Its work (T = 512: 8 KiB
//   read, ~2.5 ns at 3.35 TB/s) is far below the ~3.7 us a launch of one
//   block costs, so no standalone form can approach it; the work moves into
//   the kernels that already read the data. The standalone kernel is the
//   sharded form only: the S shards' num / den partials added in K29's
//   order as it loads them (bitwise K29 then K14).
// K13 + K14 relax_error_converge (one device): K13 over the tiles; each
//   block's writing threads fence, the block meets at a barrier and thread
//   0 takes a ticket (reduce.cuh last_block_arrived); the last block reads
//   every tile's num / den through L2 and runs K14's body (the same
//   function, the same block size and order: bitwise K13 then K14). The
//   ticket is one int32 a replica that the last block resets; after done no
//   block takes one.
//
// Built with -fmad=false: every product and sum rounds on its own, as in the
// plain-torch twins (ops/solve.py), which evaluate in the same order.
#include "fusion_common.cuh"
#include "reduce.cuh"

namespace {

constexpr int kM = 36;          // moments per tile
constexpr int kWarps = bst::kThreads / 32;
constexpr double kEpsFit = 1e-9;

enum Model : int { NONE = -1, IDENTITY = 0, TRANSLATION = 1, RIGID = 2,
                   AFFINE = 3 };

__device__ __forceinline__ bool finished(const int* state) {
  return state != nullptr && state[2] != 0;
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// m (3x4 row-major) applied to x: ((m0 x0 + m1 x1) + m2 x2) + m3 per row
__device__ __forceinline__ void apply(const double* m, const double* x,
                                      double* y) {
#pragma unroll
  for (int j = 0; j < 3; ++j)
    y[j] = ((m[4 * j] * x[0] + m[4 * j + 1] * x[1]) + m[4 * j + 2] * x[2]) +
           m[4 * j + 3];
}

// ----------------------------------------------------------------- K11

__global__ void moments_kernel(const double* __restrict__ local,
                               const double* __restrict__ target,
                               const int* __restrict__ other,
                               const double* __restrict__ w,
                               const int* __restrict__ link_id,
                               const double* __restrict__ link_w,
                               const int* __restrict__ tile_ptr,
                               const double* __restrict__ origin, int T,
                               int wpt, const double* __restrict__ cur,
                               const int* __restrict__ state,
                               double* __restrict__ moments) {
  if (finished(state)) return;
  __shared__ double sh[kWarps][kM];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tpb = kWarps / wpt;
  const int tile = blockIdx.x * tpb + warp / wpt;
  double acc[kM];
#pragma unroll
  for (int v = 0; v < kM; ++v) acc[v] = 0.0;
  if (tile < T) {
    const int hi = tile_ptr[tile + 1];
    const double o[3] = {origin[3 * tile], origin[3 * tile + 1],
                         origin[3 * tile + 2]};
    for (int r = tile_ptr[tile] + (warp % wpt) * 32 + lane; r < hi;
         r += wpt * 32) {
      const double we = w[r] * link_w[link_id[r]];
      double tw[3];
      apply(cur + 12 * static_cast<int64_t>(other[r]), target + 3 * (int64_t)r,
            tw);
#pragma unroll
      for (int j = 0; j < 3; ++j) tw[j] -= o[j];
      const double ph[4] = {local[3 * (int64_t)r] - o[0],
                            local[3 * (int64_t)r + 1] - o[1],
                            local[3 * (int64_t)r + 2] - o[2], 1.0};
      acc[0] += we;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const double wp = we * ph[k];
        acc[1 + k] += wp;
#pragma unroll
        for (int l = 0; l < 4; ++l) acc[8 + 4 * k + l] += wp * ph[l];
#pragma unroll
        for (int j = 0; j < 3; ++j) acc[24 + 3 * k + j] += wp * tw[j];
      }
#pragma unroll
      for (int j = 0; j < 3; ++j) acc[5 + j] += we * tw[j];
    }
  }
#pragma unroll
  for (int v = 0; v < kM; ++v) {
    const double s = warp_sum(acc[v]);
    if (lane == 0) sh[warp][v] = s;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < tpb * kM; i += blockDim.x) {
    const int t = i / kM, v = i % kM;
    const int tt = blockIdx.x * tpb + t;
    if (tt >= T) continue;
    double s = sh[t * wpt][v];
    for (int k = 1; k < wpt; ++k) s += sh[t * wpt + k][v];
    moments[static_cast<int64_t>(tt) * kM + v] = s;
  }
}

// ----------------------------------------------------------------- K12

__device__ void set_identity(double* m) {
#pragma unroll
  for (int i = 0; i < 12; ++i) m[i] = (i % 5 == 0) ? 1.0 : 0.0;
}

// The JAX program's (spp + eps I) X = spq about the world origin, taken
// about the tile's origin o: (spp' + eps C C^T) X' = spq' + eps D with C C^T
// = [[I + o o^T, -o], [-o^T, 1]] and D = [[o o^T], [-o^T]] (ops/solve.py
// ridge_terms). Gaussian elimination with partial pivoting (the first
// largest |pivot|, as LAPACK's idamax); model row j = X'[:, j].
__device__ void fit_affine(const double* mo, const double* o, double* out) {
  double a[4][4], b[4][3];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      double cc;
      if (k < 3 && l < 3) cc = (k == l ? 1.0 : 0.0) + o[k] * o[l];
      else if (k < 3) cc = -o[k];
      else if (l < 3) cc = -o[l];
      else cc = 1.0;
      a[k][l] = mo[8 + 4 * k + l] + kEpsFit * cc;
    }
#pragma unroll
    for (int j = 0; j < 3; ++j)
      b[k][j] = mo[24 + 3 * k + j] + kEpsFit * (k < 3 ? o[k] * o[j] : -o[j]);
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    // the pivot row p and its swap by compile-time indices, so that a and
    // b stay in registers
    int p = c;
    double best = fabs(a[c][c]);
#pragma unroll
    for (int r = c + 1; r < 4; ++r) {
      const double x = fabs(a[r][c]);
      if (x > best) {
        best = x;
        p = r;
      }
    }
#pragma unroll
    for (int r = c + 1; r < 4; ++r) {
      if (p != r) continue;
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        const double t = a[c][l]; a[c][l] = a[r][l]; a[r][l] = t;
      }
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const double t = b[c][j]; b[c][j] = b[r][j]; b[r][j] = t;
      }
    }
#pragma unroll
    for (int r = c + 1; r < 4; ++r) {
      const double f = a[r][c] / a[c][c];
#pragma unroll
      for (int l = c + 1; l < 4; ++l) a[r][l] -= f * a[c][l];
#pragma unroll
      for (int j = 0; j < 3; ++j) b[r][j] -= f * b[c][j];
    }
  }
  double x[4][3];
#pragma unroll
  for (int c = 3; c >= 0; --c) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      double s = b[c][j];
#pragma unroll
      for (int l = c + 1; l < 4; ++l) s -= a[c][l] * x[l][j];
      x[c][j] = s / a[c][c];
    }
  }
#pragma unroll
  for (int j = 0; j < 3; ++j)
#pragma unroll
    for (int k = 0; k < 4; ++k) out[4 * j + k] = x[k][j];
}

// Weighted Kabsch from the moments. H = U S V^T by one-sided Jacobi on the
// columns of H (H V = U S); the singular pairs sorted by descending S. With
// s = (1, 1, det(V U^T)), R = sum_k s_k v_k u_k^T, where only u1, u2 need
// S > 0: u3 = u1 x u2 (det U = 1) gives the same R as any orthonormal u3,
// because flipping u3 flips det(V U^T) too.
__device__ void fit_rigid(const double* mo, double* out) {
  const double sw = fmax(mo[0], kEpsFit);
  double pc[3], qc[3], a[3][3], v[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    pc[i] = mo[1 + i] / sw;
    qc[i] = mo[5 + i] / sw;
  }
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      a[i][j] = ((mo[24 + 3 * i + j] - pc[i] * mo[5 + j]) - mo[1 + i] * qc[j]) +
                (sw * pc[i]) * qc[j];
      v[i][j] = (i == j) ? 1.0 : 0.0;
    }
  for (int sweep = 0; sweep < 60; ++sweep) {
    bool rotated = false;
#pragma unroll
    for (int pair = 0; pair < 3; ++pair) {
      const int p = pair == 2 ? 1 : 0, q = pair == 0 ? 1 : 2;
      double alpha = 0.0, beta = 0.0, gamma = 0.0;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        alpha += a[i][p] * a[i][p];
        beta += a[i][q] * a[i][q];
        gamma += a[i][p] * a[i][q];
      }
      if (!(fabs(gamma) > 1e-15 * sqrt(alpha * beta))) continue;
      rotated = true;
      const double zeta = (beta - alpha) / (2.0 * gamma);
      const double t = copysign(1.0, zeta) / (fabs(zeta) + sqrt(1.0 + zeta * zeta));
      const double c = 1.0 / sqrt(1.0 + t * t), s = c * t;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const double ap = a[i][p], aq = a[i][q];
        a[i][p] = c * ap - s * aq;
        a[i][q] = s * ap + c * aq;
        const double vp = v[i][p], vq = v[i][q];
        v[i][p] = c * vp - s * vq;
        v[i][q] = s * vp + c * vq;
      }
    }
    if (!rotated) break;
  }
  double sig[3];
#pragma unroll
  for (int k = 0; k < 3; ++k)
    sig[k] = sqrt((a[0][k] * a[0][k] + a[1][k] * a[1][k]) + a[2][k] * a[2][k]);
  // descending and stable: the first form's insertion sort over (0, 1, 2)
  // as three compare-exchanges, each moving a column pair of a and v with
  // its singular values, in registers (the third pass exchanges only where
  // the second did: otherwise its pair is the first pass's, in order)
  auto cswap = [&](int p, int q) {
    if (sig[q] > sig[p]) {
      const double t = sig[p]; sig[p] = sig[q]; sig[q] = t;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const double ta = a[i][p]; a[i][p] = a[i][q]; a[i][q] = ta;
        const double tv = v[i][p]; v[i][p] = v[i][q]; v[i][q] = tv;
      }
    }
  };
  cswap(0, 1);
  cswap(1, 2);
  cswap(0, 1);
  double u[3][3];
  const double (&vs)[3][3] = v;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const double s = sig[k];
#pragma unroll
    for (int i = 0; i < 3; ++i) u[i][k] = s > 0.0 ? a[i][k] / s : 0.0;
  }
  u[0][2] = u[1][0] * u[2][1] - u[2][0] * u[1][1];
  u[1][2] = u[2][0] * u[0][1] - u[0][0] * u[2][1];
  u[2][2] = u[0][0] * u[1][1] - u[1][0] * u[0][1];
  const double d =
      (vs[0][0] * (vs[1][1] * vs[2][2] - vs[1][2] * vs[2][1]) -
       vs[0][1] * (vs[1][0] * vs[2][2] - vs[1][2] * vs[2][0])) +
      vs[0][2] * (vs[1][0] * vs[2][1] - vs[1][1] * vs[2][0]);
  double r[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      r[i][j] = (vs[i][0] * u[j][0] + vs[i][1] * u[j][1]) + vs[i][2] * (d * u[j][2]);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) out[4 * i + j] = r[i][j];
    out[4 * i + 3] = qc[i] - ((r[i][0] * pc[0] + r[i][1] * pc[1]) + r[i][2] * pc[2]);
  }
}

// A fit of kind KIND about the tile's origin o (identity for IDENTITY).
template <int KIND>
__device__ __forceinline__ void fit_kind(const double* mo, const double* o,
                                         double* out) {
  set_identity(out);
  if constexpr (KIND == TRANSLATION) {
    const double sw = fmax(mo[0], kEpsFit);
#pragma unroll
    for (int j = 0; j < 3; ++j) out[4 * j + 3] = (mo[5 + j] - mo[1 + j]) / sw;
  } else if constexpr (KIND == AFFINE) {
    fit_affine(mo, o, out);
  } else if constexpr (KIND == RIGID) {
    fit_rigid(mo, out);
  }
}

constexpr int kFitTiles = 32;  // tiles a block: a warp's lanes

// One block's fits: LOAD(off, mo) reads the 36 moments at off of the
// (T, 36) moments.
template <int MODEL, int REG, class Load>
__device__ __forceinline__ void fit_body(const Load& load,
                                         const uint8_t* __restrict__ fixed,
                                         const double* __restrict__ origin,
                                         int T, double lam, double damping,
                                         double* __restrict__ cur) {
  constexpr bool kReg = REG != NONE;
  __shared__ double sreg[kReg ? kFitTiles : 1][13];
  const int base = blockIdx.x * kFitTiles;
  const int nt = min(kFitTiles, T - base);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool live = lane < nt;
  // each warp loads its lanes' tiles' moments, every load issued before
  // the fit (staging them in shared memory by coalesced loads first took
  // 1-2 us longer a launch: one more round trip and a barrier)
  double mo[kM], o[3];
  if (live) {
    load(static_cast<int64_t>(base + lane) * kM, mo);
#pragma unroll
    for (int d = 0; d < 3; ++d)
      o[d] = origin[3 * static_cast<int64_t>(base + lane) + d];
  }
  double m[12];
  if (warp == 0) {
    if (live) fit_kind<MODEL>(mo, o, m);
  } else if (kReg && live) {
    // the regulariser's fit, at the same time as warp 0's
    double rm[12];
    fit_kind<REG>(mo, o, rm);
#pragma unroll
    for (int i = 0; i < 12; ++i) sreg[lane][i] = rm[i];
  }
  if (kReg) {
    __syncthreads();
    if (warp == 0 && live) {
#pragma unroll
      for (int i = 0; i < 12; ++i)
        m[i] = (1.0 - lam) * m[i] + lam * sreg[lane][i];
    }
  }
  if (warp != 0 || !live) return;
  const int t = base + lane;
#pragma unroll
  for (int j = 0; j < 3; ++j)
    m[4 * j + 3] = (m[4 * j + 3] + o[j]) -
                   ((m[4 * j] * o[0] + m[4 * j + 1] * o[1]) + m[4 * j + 2] * o[2]);
  if (mo[0] <= 0.0 || fixed[t]) set_identity(m);
  double* c = cur + 12 * static_cast<int64_t>(t);
#pragma unroll
  for (int i = 0; i < 12; ++i) c[i] = (1.0 - damping) * c[i] + damping * m[i];
}

template <int MODEL, int REG>
__global__ void __launch_bounds__(2 * kFitTiles)
    fit_kernel(const double* __restrict__ moments,
               const uint8_t* __restrict__ fixed,
               const double* __restrict__ origin, int T, double lam,
               double damping, const int* __restrict__ state,
               double* __restrict__ cur) {
  if (finished(state)) return;
  fit_body<MODEL, REG>(
      [&](int64_t off, double(&mo)[kM]) {
#pragma unroll
        for (int v = 0; v < kM; ++v) mo[v] = moments[off + v];
      },
      fixed, origin, T, lam, damping, cur);
}

// The sharded form: the shards' moment partials added as they are loaded,
// in K29's order (the sum K29 wrote into `moments` before).
template <int MODEL, int REG>
__global__ void __launch_bounds__(2 * kFitTiles)
    fit_parts_kernel(const bst::ShardParts parts,
                     const uint8_t* __restrict__ fixed,
                     const double* __restrict__ origin, int T, double lam,
                     double damping, const int* __restrict__ state,
                     double* __restrict__ cur) {
  if (finished(state)) return;
  fit_body<MODEL, REG>(
      [&](int64_t off, double(&mo)[kM]) { parts.row(off, mo); }, fixed,
      origin, T, lam, damping, cur);
}

// ----------------------------------------------------------------- K13

// rows of segment s: idx[ptr[s] .. ptr[s+1]) (idx == nullptr: the rows
// themselves); the owner model is seg_own[s] (nullptr: s); sh holds 2 *
// kWarps doubles
__device__ __forceinline__ void error_body(
    const double* __restrict__ local, const double* __restrict__ target,
    const int* __restrict__ other, const double* __restrict__ w,
    const int* __restrict__ link_id, const double* __restrict__ link_w,
    const int* __restrict__ ptr, const int* __restrict__ idx,
    const int* __restrict__ seg_own, int S, int wpt,
    const double* __restrict__ cur, double* __restrict__ num,
    double* __restrict__ den, double* sh) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tpb = kWarps / wpt;
  const int seg = blockIdx.x * tpb + warp / wpt;
  double sn = 0.0, sd = 0.0;
  if (seg < S) {
    const double* mown =
        cur + 12 * static_cast<int64_t>(seg_own ? seg_own[seg] : seg);
    const int hi = ptr[seg + 1];
    for (int j = ptr[seg] + (warp % wpt) * 32 + lane; j < hi; j += wpt * 32) {
      const int64_t r = idx ? idx[j] : j;
      const double we = w[r] * link_w[link_id[r]];
      double a[3], b[3];
      apply(mown, local + 3 * r, a);
      apply(cur + 12 * static_cast<int64_t>(other[r]), target + 3 * r, b);
      const double dx = a[0] - b[0], dy = a[1] - b[1], dz = a[2] - b[2];
      sn += sqrt((dx * dx + dy * dy) + dz * dz) * we;
      sd += we;
    }
  }
  sn = warp_sum(sn);
  sd = warp_sum(sd);
  if (lane == 0) {
    sh[2 * warp] = sn;
    sh[2 * warp + 1] = sd;
  }
  __syncthreads();
  if (threadIdx.x < tpb) {
    const int t = threadIdx.x, ss = blockIdx.x * tpb + t;
    if (ss < S) {
      double a = sh[2 * t * wpt], b = sh[2 * t * wpt + 1];
      for (int k = 1; k < wpt; ++k) {
        a += sh[2 * (t * wpt + k)];
        b += sh[2 * (t * wpt + k) + 1];
      }
      num[ss] = a;
      den[ss] = b;
    }
  }
}

__global__ void error_kernel(const double* __restrict__ local,
                             const double* __restrict__ target,
                             const int* __restrict__ other,
                             const double* __restrict__ w,
                             const int* __restrict__ link_id,
                             const double* __restrict__ link_w,
                             const int* __restrict__ ptr,
                             const int* __restrict__ idx,
                             const int* __restrict__ seg_own, int S, int wpt,
                             const double* __restrict__ cur,
                             const int* __restrict__ state,
                             double* __restrict__ num,
                             double* __restrict__ den) {
  if (finished(state)) return;
  __shared__ double sh[2 * kWarps];
  error_body(local, target, other, w, link_id, link_w, ptr, idx, seg_own, S,
             wpt, cur, num, den, sh);
}

// ----------------------------------------------------------------- K14

// The tree of K14's sums and window minimum: at each level s = kThreads /
// 2 .. 1, v[t] = v[t] (op) v[t + s] for t < s. block_reduce2 takes two sums
// through the same tree side by side (each in its own order, half the
// barriers). sh holds kThreads doubles (block_reduce2: twice that).
__device__ double block_reduce(double v, double* sh, bool is_min) {
  sh[threadIdx.x] = v;
  __syncthreads();
  for (int s = bst::kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) {
      const double o = sh[threadIdx.x + s];
      sh[threadIdx.x] = is_min ? fmin(sh[threadIdx.x], o) : sh[threadIdx.x] + o;
    }
    __syncthreads();
  }
  const double r = sh[0];
  __syncthreads();
  return r;
}

__device__ void block_reduce2(double& a, double& b, double* sh) {
  double* sa = sh;
  double* sb = sh + bst::kThreads;
  sa[threadIdx.x] = a;
  sb[threadIdx.x] = b;
  __syncthreads();
  for (int s = bst::kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) {
      sa[threadIdx.x] = sa[threadIdx.x] + sa[threadIdx.x + s];
      sb[threadIdx.x] = sb[threadIdx.x] + sb[threadIdx.x + s];
    }
    __syncthreads();
  }
  a = sa[0];
  b = sb[0];
  __syncthreads();
}

// K14's loads of the tiles t[0 .. n) (n <= 4), all in flight at once:
// x[k] = num's entry, y[k] = den's. The fused form reads one buffer each
// that other blocks of the launch wrote (through L2); the sharded form the
// S shards' partials, four at a time, each entry their sum in K29's order
// (the first taken as it is, so that a -0.0 stays -0.0).
struct L2Buffer {
  const double* p;
};

__device__ __forceinline__ void load_sums(const L2Buffer& num,
                                          const L2Buffer& den,
                                          const int (&t)[4], int n,
                                          double (&x)[4], double (&y)[4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (k < n) {
      x[k] = __ldcg(num.p + t[k]);
      y[k] = __ldcg(den.p + t[k]);
    }
}

__device__ __forceinline__ void load_sums(const bst::ShardParts& num,
                                          const bst::ShardParts& den,
                                          const int (&t)[4], int n,
                                          double (&x)[4], double (&y)[4]) {
  for (int d0 = 0; d0 < num.S; d0 += 4) {
    double xs[4][4], ys[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (d0 + j < num.S && k < n) {
          xs[j][k] = num.p[d0 + j][t[k]];
          ys[j][k] = den.p[d0 + j][t[k]];
        }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (d0 + j < num.S && k < n) {
          x[k] = d0 + j == 0 ? xs[j][k] : x[k] + xs[j][k];
          y[k] = d0 + j == 0 ? ys[j][k] : y[k] + ys[j][k];
        }
  }
}

// K14's body, in one block of bst::kThreads threads: NUM and DEN hold the
// tiles' sums (load_sums); sh holds 2 * bst::kThreads doubles. The state
// and the history entries the rules read are loaded first, and each
// thread's tiles four at a time, so that their latencies overlap; every
// sum, minimum and rule is taken in the first form's order (each thread's
// share in tile order, then the trees).
template <class Load>
__device__ __forceinline__ void converge_body(const Load& num,
                                              const Load& den, int T,
                                              double* __restrict__ hist,
                                              int pw, double max_error,
                                              int max_iter, int* state,
                                              double* sh) {
  const int i = state[0];
  const int it = i + 1;
  // this thread's first entry of the plateau window hist[it - pw : it]
  // (hist[i] is the error this launch computes), and thread 0's entries
  const int k0 = it - pw + static_cast<int>(threadIdx.x);
  const bool window = it > pw;
  const double h0 = window && k0 < i ? hist[k0] : 0.0;
  int stall = 0;
  double prev = 0.0, first = 0.0;
  if (threadIdx.x == 0) {
    stall = state[1];
    if (i > 0) prev = hist[i - 1];
    if (window) first = hist[it - pw - 1];
  }
  double a = 0.0, b = 0.0;
  for (int t0 = threadIdx.x; t0 < T; t0 += 4 * blockDim.x) {
    int t[4], n = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      t[k] = t0 + k * static_cast<int>(blockDim.x);
      if (t[k] < T) n = k + 1;
    }
    double x[4], y[4];
    load_sums(num, den, t, n, x, y);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (k < n) {
        a += x[k];
        b += y[k];
      }
  }
  block_reduce2(a, b, sh);
  const double err = a / fmax(b, 1e-12);
  double lo = INFINITY;
  if (window) {
    int k = k0;
    if (k < it) {
      lo = fmin(lo, k == i ? err : h0);
      k += blockDim.x;
    }
    for (; k < it; k += blockDim.x) lo = fmin(lo, k == i ? err : hist[k]);
  }
  lo = block_reduce(lo, sh, true);
  if (threadIdx.x != 0) return;
  hist[i] = err;
  if (i > 0) stall = (prev - err < 1e-9 * fmax(err, 1.0)) ? stall + 1 : 0;
  bool plateau = false;
  if (window && err < max_error) {
    const double improvement = first - lo;
    plateau = improvement < 1e-4 * fmax(err, 1e-12) || err < 1e-9;
  }
  state[0] = it;
  state[1] = stall;
  state[2] = (stall >= 5 || plateau || it >= max_iter) ? 1 : 0;
}

// The standalone K14 (the sharded relax): the shards' partial sums added
// as they are loaded, in K29's order.
__global__ void converge_kernel(const bst::ShardParts num,
                                const bst::ShardParts den, int T,
                                double* __restrict__ hist, int pw,
                                double max_error, int max_iter,
                                int* __restrict__ state) {
  __shared__ double sh[2 * bst::kThreads];
  if (finished(state)) return;
  converge_body(num, den, T, hist, pw, max_error, max_iter, state, sh);
}

// ------------------------------------------------------------ K13 + K14

// K13 over the tiles, then K14 in the last block to finish. Every block
// passes its finished(state) check before it takes a ticket, and the last
// block writes the state only after every ticket is taken: no block of the
// launch reads the state the last block writes. After done every block
// returns at once and none takes a ticket.
__global__ void error_converge_kernel(
    const double* __restrict__ local, const double* __restrict__ target,
    const int* __restrict__ other, const double* __restrict__ w,
    const int* __restrict__ link_id, const double* __restrict__ link_w,
    const int* __restrict__ tile_ptr, int T, int wpt,
    const double* __restrict__ cur, int* __restrict__ state,
    double* __restrict__ num, double* __restrict__ den,
    double* __restrict__ hist, int pw, double max_error, int max_iter,
    int* __restrict__ ticket) {
  if (finished(state)) return;
  __shared__ double sh[2 * bst::kThreads];
  error_body(local, target, other, w, link_id, link_w, tile_ptr, nullptr,
             nullptr, T, wpt, cur, num, den, sh);
  // the threads that wrote this block's num and den, before its ticket
  if (threadIdx.x < kWarps / wpt) __threadfence();
  if (!bst::last_block_arrived(ticket)) return;
  converge_body(L2Buffer{num}, L2Buffer{den}, T, hist, pw, max_error,
                max_iter, state, sh);
}

inline unsigned int blocks_for(int n, int per_block) {
  return static_cast<unsigned int>((n + per_block - 1) / per_block);
}

bool bad_wpt(int wpt) {
  return wpt != 1 && wpt != 2 && wpt != 4 && wpt != 8;
}

// S host-side device pointers as kernel parameters; false if S is out of
// range or a pointer is null
bool shard_parts(const void* host, int S, bst::ShardParts* out) {
  if (host == nullptr || S < 1 || S > bst::kMaxShards) return false;
  *out = {};
  out->S = S;
  const double* const* h = static_cast<const double* const*>(host);
  for (int d = 0; d < S; ++d) {
    if (h[d] == nullptr) return false;
    out->p[d] = h[d];
  }
  return true;
}

struct FitArgs {
  const double* moments;  // nullptr: the sharded form, from parts
  bst::ShardParts parts;
  const uint8_t* fixed;
  const double* origin;
  const int* state;
  double* cur;
  cudaStream_t stream;
};

// K12 for one (model, regulariser) pair: a block of kFitTiles tiles, one
// warp, or two with a regulariser.
template <int MODEL, int REG>
cudaError_t launch_fit(int T, double lam, double damping, const FitArgs& a) {
  const unsigned int grid = blocks_for(T, kFitTiles);
  const int block = REG == NONE ? 32 : 2 * kFitTiles;
  if (a.moments != nullptr)
    fit_kernel<MODEL, REG><<<grid, block, 0, a.stream>>>(
        a.moments, a.fixed, a.origin, T, lam, damping, a.state, a.cur);
  else
    fit_parts_kernel<MODEL, REG><<<grid, block, 0, a.stream>>>(
        a.parts, a.fixed, a.origin, T, lam, damping, a.state, a.cur);
  return cudaGetLastError();
}

}  // namespace

extern "C" int bst_relax_moments(const void* local, const void* target,
                                 const void* other, const void* w,
                                 const void* link_id, const void* link_w,
                                 const void* tile_ptr, const void* origin,
                                 int T, int wpt,
                                 const void* cur, const void* state,
                                 void* moments, void* stream) {
  if (T <= 0 || bad_wpt(wpt)) return cudaErrorInvalidValue;
  moments_kernel<<<blocks_for(T, kWarps / wpt), bst::kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(local), static_cast<const double*>(target),
      static_cast<const int*>(other), static_cast<const double*>(w),
      static_cast<const int*>(link_id), static_cast<const double*>(link_w),
      static_cast<const int*>(tile_ptr), static_cast<const double*>(origin),
      T, wpt, static_cast<const double*>(cur),
      static_cast<const int*>(state), static_cast<double*>(moments));
  return static_cast<int>(cudaGetLastError());
}

// The (model, regulariser) pairs compiled: every model but NONE, with
// every regulariser (ops/solve.py fit_pair).
#define BST_FIT_REG(M)                                                  \
  switch (reg) {                                                        \
    case NONE: err = launch_fit<M, NONE>(T, lam, damping, args); break; \
    case IDENTITY:                                                      \
      err = launch_fit<M, IDENTITY>(T, lam, damping, args); break;      \
    case TRANSLATION:                                                   \
      err = launch_fit<M, TRANSLATION>(T, lam, damping, args); break;   \
    case RIGID: err = launch_fit<M, RIGID>(T, lam, damping, args); break; \
    case AFFINE:                                                        \
      err = launch_fit<M, AFFINE>(T, lam, damping, args); break;        \
    default: return cudaErrorInvalidValue;                              \
  }

// moments (T x 36), or with moments null the S shards' partials: parts, a
// host array of S device pointers (1 <= S <= 64), each T x 36
extern "C" int bst_relax_fit(const void* moments, const void* parts, int S,
                             const void* fixed, const void* origin, int T,
                             int model, int reg, double lam, double damping,
                             const void* state, void* cur, void* stream) {
  if (T <= 0) return cudaErrorInvalidValue;
  bst::ShardParts P = {};
  if (moments == nullptr && !shard_parts(parts, S, &P))
    return cudaErrorInvalidValue;
  const FitArgs args{static_cast<const double*>(moments), P,
                     static_cast<const uint8_t*>(fixed),
                     static_cast<const double*>(origin),
                     static_cast<const int*>(state), static_cast<double*>(cur),
                     static_cast<cudaStream_t>(stream)};
  cudaError_t err = cudaSuccess;
  switch (model) {
    case IDENTITY: BST_FIT_REG(IDENTITY); break;
    case TRANSLATION: BST_FIT_REG(TRANSLATION); break;
    case RIGID: BST_FIT_REG(RIGID); break;
    case AFFINE: BST_FIT_REG(AFFINE); break;
    default: return cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

#undef BST_FIT_REG

extern "C" int bst_relax_error(const void* local, const void* target,
                               const void* other, const void* w,
                               const void* link_id, const void* link_w,
                               const void* ptr, const void* idx,
                               const void* seg_own, int S, int wpt,
                               const void* cur, const void* state, void* num,
                               void* den, void* stream) {
  if (S <= 0 || bad_wpt(wpt)) return cudaErrorInvalidValue;
  error_kernel<<<blocks_for(S, kWarps / wpt), bst::kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(local), static_cast<const double*>(target),
      static_cast<const int*>(other), static_cast<const double*>(w),
      static_cast<const int*>(link_id), static_cast<const double*>(link_w),
      static_cast<const int*>(ptr), static_cast<const int*>(idx),
      static_cast<const int*>(seg_own), S, wpt,
      static_cast<const double*>(cur), static_cast<const int*>(state),
      static_cast<double*>(num), static_cast<double*>(den));
  return static_cast<int>(cudaGetLastError());
}

// num_parts, den_parts: host arrays of S device pointers (1 <= S <= 64),
// each T doubles: the shards' error sums
extern "C" int bst_relax_converge(const void* num_parts,
                                  const void* den_parts, int S, int T,
                                  void* hist, int pw, double max_error,
                                  int max_iter, void* state, void* stream) {
  bst::ShardParts num, den;
  if (T <= 0 || pw < 1 || max_iter < 1 || !shard_parts(num_parts, S, &num) ||
      !shard_parts(den_parts, S, &den))
    return cudaErrorInvalidValue;
  converge_kernel<<<1, bst::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      num, den, T, static_cast<double*>(hist), pw, max_error, max_iter,
      static_cast<int*>(state));
  return static_cast<int>(cudaGetLastError());
}

// K13 over the T tiles, then K14: ticket one int32 that is 0 (the launch
// leaves it 0)
extern "C" int bst_relax_error_converge(
    const void* local, const void* target, const void* other, const void* w,
    const void* link_id, const void* link_w, const void* tile_ptr, int T,
    int wpt, const void* cur, void* state, void* num, void* den, void* hist,
    int pw, double max_error, int max_iter, void* ticket, void* stream) {
  if (T <= 0 || bad_wpt(wpt) || pw < 1 || max_iter < 1 || ticket == nullptr)
    return cudaErrorInvalidValue;
  error_converge_kernel<<<blocks_for(T, kWarps / wpt), bst::kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(local), static_cast<const double*>(target),
      static_cast<const int*>(other), static_cast<const double*>(w),
      static_cast<const int*>(link_id), static_cast<const double*>(link_w),
      static_cast<const int*>(tile_ptr), T, wpt,
      static_cast<const double*>(cur), static_cast<int*>(state),
      static_cast<double*>(num), static_cast<double*>(den),
      static_cast<double*>(hist), pw, max_error, max_iter,
      static_cast<int*>(ticket));
  return static_cast<int>(cudaGetLastError());
}
