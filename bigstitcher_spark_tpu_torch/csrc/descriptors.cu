// K19-K20: geometric descriptors and the descriptor ratio test, the JAX
// device programs of bigstitcher_spark_tpu/ops/descriptors.py. Every float
// op is rounded on its own (-fmad=false); the plain twins in
// ops/descriptors.py repeat the same operations in the same order, so
// kernel and twin agree bit for bit.
//
// K19 knn_descriptors (_knn_kernel :48, build_descriptors :84,
//   block_descriptors_impl :128): B batch entries of K points (x, y, z)
//   float32, optionally with validity flags (the masked form). Per point
//   the list of its P = n + r nearest (distance, index) pairs in
//   lexicographic order, the lower index first on equal distances
//   (lax.top_k's order). The distance is ((dx dx + dy dy) + dz dz) with
//   d = own - other, as the JAX sum in x, y, z order; the point itself,
//   and with flags any pair that is not valid on both sides, count as +inf
//   (and so still fill the list, in index order, when fewer than P others
//   exist). Then the P offsets neighbour - own (zeroed with flags when the
//   P-th neighbour is not finite: dvalid false), each n-subset of the
//   subset table, and with rotation invariance the local frame: ex = o0 /
//   (|o0| + 1e-12), ey = o1 - (o1 . ex) ex normalised the same way, ez =
//   ex x ey, coordinates ((b_0 o_0 + b_1 o_1) + b_2 o_2) per basis vector
//   b. Writes the kNN indices (optional), the descriptors (B, K, S, 3n)
//   and dvalid.
//
//   Launch (ops/descriptors.py knn_plan), three kernels:
//   1. knn_pack_kernel: the candidates as float4 (x, y, z, not-valid
//      flag), K padded to whole stages.
//   2. knn_scan_kernel, grid (row blocks, splits, B): a thread holds Q
//      queries in registers (Q = 4; 1 in the masked form, whose few
//      valid queries then spread over more blocks), i = row0 + t + 128 q,
//      each with its list and its threshold thr (-inf for a query past K
//      or, masked, not valid: inert). A split's candidates stream through
//      shared memory in stages of 512 float4, the next stage's 16-byte
//      copies (cp.async) in flight while one is scanned; one broadcast
//      float4 read serves Q queries. Two candidates a step: their 2 Q
//      distances (8 operations a pair), a compare d <= thr each, one vote
//      of the warp, the next step's candidates read before it. Only where
//      a compare passes does the exact rule run: (d, j) enters when d <
//      last or (d == last and j < last index). A split is scanned in
//      increasing j, so once a list is full thr is the float just below
//      its last distance (before, the last distance itself: the
//      placeholders (+inf, INT_MAX) still give way to +inf pairs). The
//      self test (j == i gives +inf) runs only on the stages that hold a
//      query's own index; the masked form selects +inf for a candidate
//      that is not valid. Splits of the candidates (whole stages) are
//      taken when B x row blocks would not give the card 3 blocks an SM,
//      each writing its lists; a block whose queries are all inert
//      writes nothing, a warp of them only stages.
//   3. knn_tail_kernel, one thread a query: the splits' lists merged in
//      split order by the exact rule, then the offsets, frames and
//      descriptors (the first form's code). A query that is not valid
//      (masked) is not scanned: its list is fixed, the P lowest indices at
//      +inf (self included), as the scan would have found it.
//   Bits: the set of the P smallest pairs in (distance, index) order is
//   unique (the indices differ), so any scan order and any split of the
//   candidates gives the same list; every distance is computed as the
//   first form computed it, and the tail is unchanged: the outputs are
//   bitwise the first form's and the twin's.
//   Bound: operations, 8 float ops a pair of points (10^10 pairs at 9b's
//   100,000 points: 1.19 ms at 67 TFLOP/s, which counts an FMA as two;
//   every op here is its own instruction (-fmad=false), so the issue rate
//   gives a floor of 10^10 x 8 / 33.5e12 = 2.39 ms). The first form (one
//   query a thread: 3 scalar shared loads and a byte load, the self and
//   validity tests, a two-part compare a pair) issued ~20 instructions a
//   pair: 16.7 ms at 9b.
//   Tried on the card and not kept (9b's cloud and 8d's bucket; PERF.md's K19
//   findings): 8 queries a thread (6.2 ms: half the warps, more splits),
//   16 (spills, 23 ms); one candidate a step (5.6 ms) or four (5.2-6.7:
//   registers); 5 or 6 blocks an SM (5.0-5.7, no gain beyond the noise);
//   splits chosen to fill whole waves (16 at 9b: 8.2 ms, each split's
//   list warming up anew); the masked form at 4 queries a thread (0.32-
//   0.36 ms: its valid queries sit in one row block an entry); a
//   threshold of the last distance itself once a list is full (the
//   masked form's splits of invalid slots then took the exact insertion
//   at every candidate: 0.44 ms).
//
// K20 ratio_match (_pairwise_sqdist :191, _match_ratio_dense :208,
//   _match_ratio_row_chunk :220; ICP's nearest neighbour :585-588): A
//   (Da, D) against B (Db, D) float32, D = 3n <= 24. Per row of A: the
//   best column (argmin, the first on ties) or its owner, its squared
//   distance d1 and, with owners, accept = sqrt(d2nd) >= ratio sqrt(d1),
//   d2nd the best distance of an owner other than the best's (exact, no
//   top-k truncation). The twin's distance is d = max((a2 + b2) - 2 dot,
//   0) on a - c and b - c, c = B's mean (float64 sum rounded once; the
//   JAX dense form centres on B's mean too), a2, b2 and dot summed in
//   dimension order.
//
//   What bounds it: at 9b (400,000 x 400,000 descriptors of 9) the
//   one-thread-a-row form issued ~35 instructions a pair (9 scalar shared
//   loads, 17 float ops, the top-2 branches): issue-bound, 223 ms on an
//   H100. This design is an exact filter-and-refine on the tensor cores:
//
//   1. Prologue: B's mean over the whole card (center_partial_kernel,
//      then the partial sums in a fixed order), then A and B centred once
//      with a2, b2 (prep_kernel), and B' = (-2 (b - c), (1 - kappa) b2)
//      rounded to TF32 and stored in the MMA's fragment order.
//   2. Filter: A' = (tf32(a - c), 1) stays in registers, B' tiles stream
//      through a two-stage cp.async ring, and TF32 MMAs give q ~ (1 -
//      kappa) b2 - 2 dot for 16 x 8 pairs a tile: m16n8k8 steps over K =
//      D + 1, the last one an m16n8k4 step where 4 suffice (K = 12 for D
//      = 9). A pair is skipped when q > t, t = fl(fl(T (1 + 2^-20)) -
//      fl(a2 (1 - kappa))), T the row's running d2nd (d1 in nearest
//      mode). A warp issues all its MMAs of a group of 8 columns, then
//      one test and one branch for the group: with a branch per tile the
//      MMAs waited on the compares (44 ms against 34 ms at 9b on an
//      H100).
//   3. Refine: a pair that is not skipped is recomputed exactly as the
//      twin does (the unfused dot in order, (a2 + b2) - 2 dot, max 0) and
//      enters the scan rule of the old kernel: if d < d1 { if owner !=
//      o1: d2nd = d1; d1, c1, o1 = d, j, owner } else if owner != o1 and
//      d < d2nd: d2nd = d. So every distance returned is the twin's.
//   4. Merge: lane t of a quad scans columns 8m + 2t, 8m + 2t + 1 of its
//      rows in column order; the quad's four states, then the column
//      splits' states, are merged in a fixed order by the rule: the
//      smaller d1 wins, the smaller column on a tie (argmin); with equal
//      owners d2nd = min of the two d2nd, else d2nd = min(winner's d2nd,
//      loser's d1). Proof: the merged d1, column and owner are the
//      argmin's over the union. With equal owners O, the union's entries
//      of owners other than O are each side's, whose minima are the two
//      d2nd. Otherwise, the winner's side contributes its d2nd, and every
//      entry of the loser's side of an owner other than the winner's is
//      at least the loser's d1, whose owner differs from the winner's: so
//      its minimum there is the loser's d1. The empty state (inf, INT_MAX,
//      -1, inf) is neutral.
//   5. A counter of the pairs refined (the survivors), read by the wrapper.
//
//   Why a skipped pair cannot change the result. Scan states only lower
//   d2nd (d1) as entries are added, so any state's T is >= the final
//   d2nd (d1) of the row over all of B. The skip test is strict: a
//   skipped pair has d > T >= final d2nd >= final d1, and removing such
//   an entry leaves d1, the column, the owner and d2nd of the whole row
//   unchanged. So thresholds may be shared across the quad (their
//   minimum) and the order of the scan does not matter.
//
//   The margin. Let u = 2^-24. TF32 rounding to nearest is within 2^-11
//   relative of each operand, so each product a_k (-2 b_k) is within
//   (2^-10 + 2^-22) |2 a_k b_k|, and 2 sum |a_k b_k| <= (a2 + b2)(1 + D
//   u); the (1 - kappa) b2 operand is within (2^-11 + u) b2; the tensor
//   core's float32 accumulation of the D + 1 <= 25 terms, magnitude sum M
//   <= a2 + 3 b2, is within 2^-17 M (below). The twin's
//   own d is within (D + 4) u (a2 + b2) <= 2^-19 (a2 + b2) of the exact
//   value of its float32 inputs. Together: eps (a2 + b2) with eps <=
//   1.53 * 2^-10, so d >= a2 + q + kappa b2 - eps (a2 + b2) >= a2 + q -
//   (kappa / 2) a2 once eps <= kappa / 2, and t >= T - a2 (1 - kappa / 2)
//   after its three roundings (the 2^-20 bump covers T's). So q > t
//   implies d > T. With kappa = 2^-7, kappa / 2 is 2.6 times the eps it
//   must cover: the safety factor.
//
//   The accumulation term (1.5 % of eps). Fasi, Higham, Mikaitis and
//   Pranesh, "Numerical behavior of NVIDIA tensor cores", PeerJ Computer
//   Science 7:e330 (2021), found on V100, T4 and A100 that the products
//   are exact and each MMA adds them and the accumulator aligned to the
//   largest, the bits below float32's significand cut off, the result
//   rounded to float32 once. Each of those cuts loses less than 2^-23 of
//   the largest addend, so at most 2^-23 M: the <= 25 terms, and the
//   accumulator and the result of each of the <= 8 MMAs (or of each group
//   of 4 products, if an MMA adds in such groups), lose under 41 x 2^-23 M
//   < 2^-17 M. Hopper is not in that study, so tests/test_torch_kernels.py
//   test_ratio_filter_mma_error measures the filter's own MMAs (filter_dot,
//   launched alone by bst_ratio_mma_probe) on the card against 2^-17 M for
//   every D, on operands whose cut bits are set, that cancel, and the
//   filter's own.
//
//   Bound: operations, the TF32 dot (2 (D + 1) a pair at 495 TFLOP/s; the
//   zero padding of the MMA's depth is not counted) plus the
//   filter's compare (one float32 operation a pair) and the survivors'
//   2D + 3 exact operations (at 67 TFLOP/s). Finite inputs; one block of
//   8 warps (32 rows, two m16 tiles, a warp: more warps hide the MMA
//   latency better than more tiles a warp) a 256-row tile, splits of
//   whole 128-column tiles when the row tiles alone would not fill the
//   card (ops/descriptors.py ratio_plan).
#include "fusion_common.cuh"

namespace {

constexpr int kMaxPool = 8;
constexpr int kMaxDim = 24;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// ----------------------------------------------------------------- K19

namespace k19 {
constexpr int kThreads = 128;       // ops/descriptors.py KNN_THREADS
constexpr int kTile = 512;          // candidates a stage (KNN_TILE)
constexpr int kBlocksPerSM = 4;     // its __launch_bounds__
constexpr int kStep = 2;            // candidates a step of the scan
constexpr int kPackThreads = 256;
constexpr int kTailThreads = 128;
}  // namespace k19

// The candidates as float4 (x, y, z, 1 where the slot is not valid, else
// 0), B rows of kp (K padded to whole stages with invalid zeros).
__global__ void knn_pack_kernel(const float* __restrict__ pts,
                                const uint8_t* __restrict__ valid, int B,
                                int K, int kp, float4* __restrict__ pts4) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (e >= static_cast<int64_t>(B) * kp) return;
  const int b = static_cast<int>(e / kp);
  const int j = static_cast<int>(e - static_cast<int64_t>(b) * kp);
  float4 c = make_float4(0.0f, 0.0f, 0.0f, 1.0f);
  if (j < K) {
    const int64_t g = static_cast<int64_t>(b) * K + j;
    c = make_float4(pts[3 * g], pts[3 * g + 1], pts[3 * g + 2],
                    valid == nullptr || valid[g] ? 0.0f : 1.0f);
  }
  pts4[e] = c;
}

// (d, j) enters the ascending list (ld, li) of the P smallest pairs in
// (distance, index) order when it precedes the last.
template <int P>
__device__ __forceinline__ void knn_insert(float (&ld)[P], int (&li)[P],
                                           float d, int j) {
  if (!(d < ld[P - 1] || (d == ld[P - 1] && j < li[P - 1]))) return;
  int k = P - 1;
#pragma unroll
  for (int q = P - 1; q > 0; --q) {
    if (k == q && (d < ld[q - 1] || (d == ld[q - 1] && j < li[q - 1]))) {
      ld[q] = ld[q - 1];
      li[q] = li[q - 1];
      k = q - 1;
    }
  }
#pragma unroll
  for (int q = 0; q < P; ++q)
    if (q == k) {
      ld[q] = d;
      li[q] = j;
    }
}

// One candidate's distances to a thread's Q queries: +inf on a stage
// holding a query's own index (kSelf) for the query itself, and for a
// candidate that is not valid (kMasked: w != 0). Returns whether one of
// them passes its query's threshold.
template <int Q, bool kSelf, bool kMasked>
__device__ __forceinline__ bool knn_dist(const float4 c, int j, int q0,
                                         const float (&qx)[Q],
                                         const float (&qy)[Q],
                                         const float (&qz)[Q],
                                         const float (&thr)[Q],
                                         float (&d)[Q]) {
  bool any = false;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const float dx = qx[q] - c.x, dy = qy[q] - c.y, dz = qz[q] - c.z;
    float dd = (dx * dx + dy * dy) + dz * dz;
    if (kMasked) dd = c.w != 0.0f ? INFINITY : dd;
    if (kSelf) dd = j == q0 + q * k19::kThreads ? INFINITY : dd;
    d[q] = dd;
    any |= dd <= thr[q];
  }
  return any;
}

// The exact insertion of candidate j where its distance passes the
// query's threshold. A split is scanned in increasing j, so once its
// list is full a later candidate enters only at a smaller distance than
// the last: the threshold is then the float just below the last distance
// (+inf: the largest finite; +0: NaN, which no distance passes); while a
// placeholder (+inf, INT_MAX) is last, it is the last distance itself.
template <int P, int Q>
__device__ __forceinline__ void knn_take(const float (&d)[Q], int j,
                                         float (&thr)[Q], float (&ld)[Q][P],
                                         int (&li)[Q][P]) {
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    if (d[q] <= thr[q]) {
      knn_insert<P>(ld[q], li[q], d[q], j);
      thr[q] = li[q][P - 1] == 0x7fffffff
                   ? ld[q][P - 1]
                   : __int_as_float(__float_as_int(ld[q][P - 1]) - 1);
    }
  }
}

// One stage's candidates against a thread's Q queries, kStep candidates
// a step: their kStep Q distances, one vote of the warp on whether any
// passes its threshold (thr: the list's last distance; -inf for an inert
// query), and only then the exact insertions, candidate by candidate. The
// next step's candidates are read from shared memory before the vote (the
// stage holds kStep entries past its end for them).
template <int P, int Q, bool kSelf, bool kMasked>
__device__ __forceinline__ void knn_scan_stage(
    const float4* __restrict__ tile, int nt, int c0, int q0,
    const float (&qx)[Q], const float (&qy)[Q], const float (&qz)[Q],
    float (&thr)[Q], float (&ld)[Q][P], int (&li)[Q][P]) {
  constexpr int S = k19::kStep;
  float4 next[S];
#pragma unroll
  for (int s = 0; s < S; ++s) next[s] = tile[s];
  int t = 0;
  for (; t + S <= nt; t += S) {
    float4 c[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      c[s] = next[s];
      next[s] = tile[t + S + s];
    }
    float d[S][Q];
    bool any = false;
#pragma unroll
    for (int s = 0; s < S; ++s)
      any |= knn_dist<Q, kSelf, kMasked>(c[s], c0 + t + s, q0, qx, qy, qz,
                                         thr, d[s]);
    if (!__any_sync(0xffffffffu, any)) continue;
#pragma unroll
    for (int s = 0; s < S; ++s) knn_take<P, Q>(d[s], c0 + t + s, thr, ld, li);
  }
  for (; t < nt; ++t) {
    float d[Q];
    knn_dist<Q, kSelf, kMasked>(tile[t], c0 + t, q0, qx, qy, qz, thr, d);
    knn_take<P, Q>(d, c0 + t, thr, ld, li);
  }
}

// The candidate scan: grid (row_blocks, splits, B), a block of kThreads
// threads, thread t holding queries row0 + t + kThreads q (q < Q) of row
// block blockIdx.x, split blockIdx.y scanning the candidates [s per_split,
// (s + 1) per_split) in stages of kTile float4, two in flight (cp.async).
// Writes each query's list of the split to part_d / part_i (splits, B, K,
// P).
template <int P, int Q, bool kMasked>
__global__ void __launch_bounds__(k19::kThreads, k19::kBlocksPerSM)
    knn_scan_kernel(const float4* __restrict__ pts4, int K, int kp,
                    int per_split, float* __restrict__ part_d,
                    int* __restrict__ part_i) {
  __shared__ __align__(16) float4 tile[2][k19::kTile + k19::kStep];
  const int b = blockIdx.z;
  const int split = blockIdx.y;
  const int row0 = blockIdx.x * k19::kThreads * Q;
  const int row1 = row0 + k19::kThreads * Q;
  const int q0 = row0 + threadIdx.x;
  const float4* bp = pts4 + static_cast<int64_t>(b) * kp;
  float qx[Q], qy[Q], qz[Q], thr[Q];
  float ld[Q][P];
  int li[Q][P];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int i = q0 + q * k19::kThreads;
    const float4 p = bp[min(i, kp - 1)];
    qx[q] = p.x;
    qy[q] = p.y;
    qz[q] = p.z;
    // past K, or (masked) not valid: inert
    thr[q] = i < K && !(kMasked && p.w != 0.0f) ? INFINITY : -INFINITY;
#pragma unroll
    for (int k = 0; k < P; ++k) {
      ld[q][k] = INFINITY;
      li[q][k] = 0x7fffffff;
    }
  }
  bool active = false;
#pragma unroll
  for (int q = 0; q < Q; ++q) active |= thr[q] > -INFINITY;
  // a block of inert queries writes nothing (the tail reads no list of
  // theirs); a warp of them only stages
  if (!__syncthreads_or(active)) return;
  const bool warp_active = __any_sync(0xffffffffu, active);
  const int c_begin = split * per_split;
  const int c_end = min(K, c_begin + per_split);
  auto stage = [&](int buf, int c0) {
#pragma unroll
    for (int u = 0; u < k19::kTile / k19::kThreads; ++u) {
      const int t = threadIdx.x + u * k19::kThreads;
      cp_async16(&tile[buf][t], bp + c0 + t);
    }
  };
  stage(0, c_begin);
  cp_async_commit();
  int buf = 0;
  for (int c0 = c_begin; c0 < c_end; c0 += k19::kTile, buf ^= 1) {
    if (c0 + k19::kTile < c_end) stage(buf ^ 1, c0 + k19::kTile);
    cp_async_commit();
    asm volatile("cp.async.wait_group 1;\n" ::);
    __syncthreads();
    const int nt = min(k19::kTile, c_end - c0);
    if (warp_active && c0 < row1 && c0 + k19::kTile > row0)
      knn_scan_stage<P, Q, true, kMasked>(tile[buf], nt, c0, q0, qx, qy, qz,
                                          thr, ld, li);
    else if (warp_active)
      knn_scan_stage<P, Q, false, kMasked>(tile[buf], nt, c0, q0, qx, qy,
                                           qz, thr, ld, li);
    __syncthreads();  // the stage is read before its buffer is refilled
  }
  const int64_t base = (static_cast<int64_t>(split) * gridDim.z + b) * K;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int i = q0 + q * k19::kThreads;
    if (i >= K) continue;
#pragma unroll
    for (int k = 0; k < P; ++k) {
      part_d[(base + i) * P + k] = ld[q][k];
      part_i[(base + i) * P + k] = li[q][k];
    }
  }
}

// The splits' lists merged in split order by (distance, index), then the
// descriptors: one thread a query. A query that is not valid (masked) has
// the fixed list of the P lowest indices at +inf. Then the P offsets
// neighbour - own (zeroed with flags when the P-th neighbour is not
// finite: dvalid false), each n-subset of the subset table, and with
// rotation invariance the local frame.
template <int P>
__global__ void __launch_bounds__(k19::kTailThreads) knn_tail_kernel(
    const float* __restrict__ pts, const uint8_t* __restrict__ valid, int B,
    int K, int splits, const float* __restrict__ part_d,
    const int* __restrict__ part_i, int n, int S,
    const int* __restrict__ subsets, int rot, int* __restrict__ idx_out,
    float* __restrict__ desc_out, uint8_t* __restrict__ dvalid_out) {
  const int64_t g = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (g >= static_cast<int64_t>(B) * K) return;
  const int b = static_cast<int>(g / K);
  const int i = static_cast<int>(g - static_cast<int64_t>(b) * K);
  const float* bp = pts + 3 * static_cast<int64_t>(b) * K;
  const float px = bp[3 * i], py = bp[3 * i + 1], pz = bp[3 * i + 2];
  const bool vi = valid ? valid[g] != 0 : true;
  float ld[P];
  int li[P];
#pragma unroll
  for (int k = 0; k < P; ++k) {
    ld[k] = INFINITY;
    li[k] = vi ? 0x7fffffff : (k < K ? k : 0x7fffffff);
  }
  if (vi) {
    for (int s = 0; s < splits; ++s) {
      const int64_t e = (static_cast<int64_t>(s) * B * K + g) * P;
#pragma unroll
      for (int k = 0; k < P; ++k) knn_insert<P>(ld, li, part_d[e + k],
                                                part_i[e + k]);
    }
  }
  if (idx_out) {
#pragma unroll
    for (int k = 0; k < P; ++k) idx_out[g * P + k] = li[k];
  }
  const bool dv = vi && ld[P - 1] < INFINITY;
  if (dvalid_out) dvalid_out[g] = dv ? 1 : 0;
  float off[P][3];
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int j = li[k] < K ? li[k] : 0;
    const bool keep = valid == nullptr || dv;
    off[k][0] = keep ? bp[3 * j] - px : 0.0f;
    off[k][1] = keep ? bp[3 * j + 1] - py : 0.0f;
    off[k][2] = keep ? bp[3 * j + 2] - pz : 0.0f;
  }
  const int dim = 3 * n;
  float* out = desc_out + g * S * dim;
  for (int s = 0; s < S; ++s) {
    float e[3][3];
    if (rot) {
      const int a0 = subsets[s * n], a1 = subsets[s * n + (1 % n)];
      float o0[3], o1[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
#pragma unroll
        for (int k = 0; k < P; ++k) {
          if (k == a0) o0[c] = off[k][c];
          if (k == a1) o1[c] = off[k][c];
        }
      }
      const float n0 = sqrtf((o0[0] * o0[0] + o0[1] * o0[1]) + o0[2] * o0[2]) + 1e-12f;
#pragma unroll
      for (int c = 0; c < 3; ++c) e[0][c] = o0[c] / n0;
      const float dot = (o1[0] * e[0][0] + o1[1] * e[0][1]) + o1[2] * e[0][2];
      float y[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) y[c] = o1[c] - dot * e[0][c];
      const float n1 = sqrtf((y[0] * y[0] + y[1] * y[1]) + y[2] * y[2]) + 1e-12f;
#pragma unroll
      for (int c = 0; c < 3; ++c) e[1][c] = y[c] / n1;
      e[2][0] = e[0][1] * e[1][2] - e[0][2] * e[1][1];
      e[2][1] = e[0][2] * e[1][0] - e[0][0] * e[1][2];
      e[2][2] = e[0][0] * e[1][1] - e[0][1] * e[1][0];
    }
    for (int t = 0; t < n; ++t) {
      const int a = subsets[s * n + t];
      float o[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        o[c] = 0.0f;
#pragma unroll
        for (int k = 0; k < P; ++k)
          if (k == a) o[c] = off[k][c];
      }
#pragma unroll
      for (int c = 0; c < 3; ++c)
        out[s * dim + 3 * t + c] =
            rot ? (e[c][0] * o[0] + e[c][1] * o[1]) + e[c][2] * o[2] : o[c];
    }
  }
}

// ----------------------------------------------------------------- K20

namespace k20 {
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMT = 2;                     // m16 row tiles a warp
constexpr int kWarpRows = 16 * kMT;        // 32 rows a warp
constexpr int kRows = kWarpRows * kWarps;  // 256 rows a block
constexpr int kTile = 128;                 // columns a ring stage
constexpr int kGroups = kTile / 8;         // n8 column groups a stage
constexpr int kGroupUnroll = 4;
constexpr int kCenterThreads = 256;
constexpr float kKappa = 0.0078125f;                // 2^-7
constexpr float kBump = 1.00000095367431640625f;    // 1 + 2^-20
}  // namespace k20

// Round to the nearest TF32 value (10 fraction bits), ties away from zero.
// The low 13 bits come out zero, so the tensor core reads it exactly.
__device__ __forceinline__ float tf32_rna(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
}

// c += a b on one m16n8k8 TF32 tile. With g = lane / 4 and t = lane % 4:
// a holds (row g, k t), (g + 8, t), (g, t + 4), (g + 8, t + 4); b holds
// (k t, column g), (t + 4, g); c holds (g, 2t), (g, 2t + 1), (g + 8, 2t),
// (g + 8, 2t + 1).
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b on one m16n8k4 TF32 tile: a holds (row g, k t), (g + 8, t); b
// holds (k t, column g).
__device__ __forceinline__ void mma_tf32_k4(float (&c)[4], uint32_t a0,
                                            uint32_t a1, uint32_t b0) {
  asm("mma.sync.aligned.m16n8k4.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// The filter's dot of one m16 tile and one n8 column group, from zero:
// D + 1 in k8 steps, the last one a k4 step where 4 suffice.
template <int D, int KP>
__device__ __forceinline__ void filter_dot(float (&c)[4],
                                           const uint32_t (&af)[KP / 8][4],
                                           const uint32_t (&bf)[KP / 4]) {
  constexpr int R8 = (D + 1) % 8;
  constexpr int NK8 = R8 > 4 ? (D + 8) / 8 : (D + 1) / 8;
  c[0] = c[1] = c[2] = c[3] = 0.0f;
#pragma unroll
  for (int ks = 0; ks < NK8; ++ks)
    mma_tf32(c, af[ks], bf[2 * ks], bf[2 * ks + 1]);
  if constexpr (R8 != 0 && R8 <= 4)
    mma_tf32_k4(c, af[NK8][0], af[NK8][1], bf[2 * NK8]);
}

// A scan state (d1, column bits, owner bits, d2nd); the empty state is
// (inf, INT_MAX, -1, inf). The exact merge rule of the note.
__device__ __forceinline__ float4 merge_state(float4 p, float4 q) {
  const int cp = __float_as_int(p.y), cq = __float_as_int(q.y);
  const bool pw = p.x < q.x || (p.x == q.x && cp <= cq);
  const float4 w = pw ? p : q, l = pw ? q : p;
  const float d2 = __float_as_int(w.z) == __float_as_int(l.z)
                       ? fminf(w.w, l.w) : fminf(w.w, l.x);
  return make_float4(w.x, w.y, w.z, d2);
}

// B's mean: per block a float64 sum of each dimension over a grid-strided
// set of rows, a fixed xor tree in each warp and the warps in order.
template <int D>
__global__ void __launch_bounds__(k20::kCenterThreads)
    center_partial_kernel(const float* __restrict__ b, int Db,
                          double* __restrict__ partials) {
  __shared__ double sh[k20::kCenterThreads / 32][D];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  double s[D];
#pragma unroll
  for (int d = 0; d < D; ++d) s[d] = 0.0;
  for (int64_t r = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       r < Db; r += static_cast<int64_t>(gridDim.x) * blockDim.x) {
#pragma unroll
    for (int d = 0; d < D; ++d) s[d] += static_cast<double>(b[r * D + d]);
  }
#pragma unroll
  for (int d = 0; d < D; ++d) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s[d] += __shfl_xor_sync(0xffffffffu, s[d], off);
    if (lane == 0) sh[warp][d] = s[d];
  }
  __syncthreads();
  if (threadIdx.x < D) {
    double t = 0.0;
    for (int w = 0; w < k20::kCenterThreads / 32; ++w) t += sh[w][threadIdx.x];
    partials[static_cast<int64_t>(blockIdx.x) * D + threadIdx.x] = t;
  }
}

// ... then the blocks' sums in block order, divided once, rounded once
__global__ void center_final_kernel(const double* __restrict__ partials,
                                    int nparts, int D, int Db,
                                    float* __restrict__ center) {
  const int d = threadIdx.x;
  if (d >= D) return;
  double t = 0.0;
  for (int p = 0; p < nparts; ++p) t += partials[static_cast<int64_t>(p) * D + d];
  center[d] = static_cast<float>(t / static_cast<double>(Db));
}

// The prologue: A and B centred once as the twin centres them, with their
// sums of squares in dimension order (ae rows (a - c, a2), WA floats; be
// rows (b - c, b2, owner bits), WB floats), and B' = (-2 (b - c), (1 -
// kappa) b2, 0...) rounded to TF32 in the MMA's fragment order: per group
// of 8 columns, lane 4 n + t holds b0, b1 of each k-step for column n.
// Columns past Db get B' = (0, ..., inf, 0...): their filter value is inf.
template <int D, int KP, int WA, int WB>
__global__ void prep_kernel(const float* __restrict__ a, int Da,
                            const float* __restrict__ b, int Db,
                            const int* __restrict__ owner,
                            const float* __restrict__ center, int Db_pad,
                            float* __restrict__ ae, float* __restrict__ be,
                            float* __restrict__ bt,
                            unsigned long long* __restrict__ refined) {
  __shared__ float c[D];
  if (threadIdx.x < D) c[threadIdx.x] = center[threadIdx.x];
  __syncthreads();
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i == 0) *refined = 0ull;
  if (i < Da) {
    float s = 0.0f;
#pragma unroll
    for (int k = 0; k < D; ++k) {
      const float v = a[i * D + k] - c[k];
      ae[i * WA + k] = v;
      s = k == 0 ? v * v : s + v * v;
    }
    ae[i * WA + D] = s;
    return;
  }
  const int64_t j = i - Da;
  if (j >= Db_pad) return;
  float v[KP];
#pragma unroll
  for (int k = 0; k < KP; ++k) v[k] = 0.0f;
  if (j < Db) {
    float s = 0.0f;
#pragma unroll
    for (int k = 0; k < D; ++k) {
      const float x = b[j * D + k] - c[k];
      be[j * WB + k] = x;
      s = k == 0 ? x * x : s + x * x;
      v[k] = tf32_rna(-2.0f * x);
    }
    be[j * WB + D] = s;
    be[j * WB + D + 1] = __int_as_float(owner ? owner[j] : static_cast<int>(j));
    v[D] = tf32_rna((1.0f - k20::kKappa) * s);
  } else {
    v[D] = INFINITY;
  }
  float* dst = bt + (j >> 3) * (8 * KP) + (j & 7) * KP;
#pragma unroll
  for (int k = 0; k < KP; ++k)
    dst[(k & 3) * (KP / 4) + 2 * (k >> 3) + ((k >> 2) & 1)] = v[k];
}

// The exact refine of one pair, as the twin computes it, and the scan
// rule on the lane's state; returns the lane's new filter threshold
// fl(fl(T (1 + 2^-20)) - fl(a2 (1 - kappa))), T = d2nd (d1 in nearest
// mode).
template <int D, bool NEAREST>
__device__ __forceinline__ float refine(const float* __restrict__ ar,
                                        const float* __restrict__ bc, int j,
                                        float4* s) {
  float dot = ar[0] * bc[0];
#pragma unroll
  for (int k = 1; k < D; ++k) dot = dot + ar[k] * bc[k];
  const float a2 = ar[D];
  const float d = fmaxf((a2 + bc[D]) - 2.0f * dot, 0.0f);
  const int ow = NEAREST ? j : __float_as_int(bc[D + 1]);
  float4 v = *s;
  const int o1 = __float_as_int(v.z);
  if (d < v.x) {
    if (ow != o1) v.w = v.x;
    v.x = d;
    v.y = __int_as_float(j);
    v.z = __int_as_float(ow);
  } else if (ow != o1 && d < v.w) {
    v.w = d;
  }
  *s = v;
  return (NEAREST ? v.x : v.w) * k20::kBump - a2 * (1.0f - k20::kKappa);
}

// The filter: a block of 8 warps holds 256 rows of A' = (tf32(a - c), 1,
// 0...) in registers (32 rows a warp, 2 m16 tiles) and streams the B'
// tiles of its column split through a two-stage cp.async ring. Per group
// of 8 columns each m16 tile takes NK8 k8 MMAs and maybe one k4; a pair
// is refined only when its value is not above its row's threshold. Lane t of a quad
// scans columns 8 m + 2t, 8 m + 2t + 1 of each row in order, in its own
// state (shared memory); the quad shares its thresholds after each stage.
// At the end the four lanes' states are merged in lane order into the
// split's state of each row.
template <int D, int KP, int WA, int WB, bool NEAREST>
__global__ void __launch_bounds__(k20::kThreads)
    filter_kernel(const float* __restrict__ ae, int Da,
                  const float* __restrict__ be, int Db,
                  const float* __restrict__ bt, int tiles_per_split,
                  int tiles, float4* __restrict__ part,
                  unsigned long long* __restrict__ refined) {
  using namespace k20;
  extern __shared__ float4 k20_smem[];
  float* ring = reinterpret_cast<float*>(k20_smem);
  float4* st = k20_smem + 2 * kTile * KP / 4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rb = blockIdx.x * kRows;
  const int wr = warp * kWarpRows;
  const int tile0 = blockIdx.y * tiles_per_split;
  const int nt = min(tiles_per_split, tiles - tile0);
  for (int e = threadIdx.x; e < kRows * 4; e += kThreads)
    st[e] = make_float4(INFINITY, __int_as_float(0x7fffffff),
                        __int_as_float(-1), INFINITY);
  uint32_t af[kMT][KP / 8][4];
  float thr[kMT][2];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = rb + wr + mt * 16 + g + 8 * h;
      thr[mt][h] = r < Da ? INFINITY : -INFINITY;
#pragma unroll
      for (int ks = 0; ks < KP / 8; ++ks) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int k = 8 * ks + t + 4 * q;
          float v = k == D ? 1.0f : 0.0f;
          if (r < Da && k < D)
            v = tf32_rna(ae[static_cast<int64_t>(r) * WA + k]);
          af[mt][ks][h + 2 * q] = __float_as_uint(v);
        }
      }
    }
  }
  auto issue = [&](int it) {
    const float* src = bt + static_cast<int64_t>(tile0 + it) * (kTile * KP);
    float* dst = ring + (it & 1) * (kTile * KP);
    for (int c = threadIdx.x; c < kTile * KP / 4; c += kThreads)
      cp_async16(dst + 4 * c, src + 4 * c);
    cp_async_commit();
  };
  if (nt > 0) issue(0);
  unsigned long long n_ref = 0;
  for (int it = 0; it < nt; ++it) {
    if (it + 1 < nt)
      issue(it + 1);
    else
      cp_async_commit();  // an empty group: wait_group 1 waits for `it`
    asm volatile("cp.async.wait_group 1;\n" ::);
    __syncthreads();
    const float* tb = ring + (it & 1) * (kTile * KP);
    const int j0 = (tile0 + it) * kTile;
#pragma unroll kGroupUnroll
    for (int gi = 0; gi < kGroups; ++gi) {
      uint32_t bf[KP / 4];
      const float4* bp =
          reinterpret_cast<const float4*>(tb + gi * 8 * KP + lane * (KP / 4));
#pragma unroll
      for (int q = 0; q < KP / 16; ++q) {
        const float4 v = bp[q];
        bf[4 * q] = __float_as_uint(v.x);
        bf[4 * q + 1] = __float_as_uint(v.y);
        bf[4 * q + 2] = __float_as_uint(v.z);
        bf[4 * q + 3] = __float_as_uint(v.w);
      }
      // all the warp's MMAs of the group first, then one test and one
      // branch for the group: the MMAs issue back to back
      float c[kMT][4];
      bool any = false;
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) filter_dot<D, KP>(c[mt], af[mt], bf);
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
        any |= (c[mt][0] <= thr[mt][0]) | (c[mt][1] <= thr[mt][0]) |
               (c[mt][2] <= thr[mt][1]) | (c[mt][3] <= thr[mt][1]);
      if (any) {
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int h = e >> 1;
            const int lr = wr + mt * 16 + g + 8 * h;
            const int r = rb + lr;
            const int j = j0 + gi * 8 + 2 * t + (e & 1);
            if (c[mt][e] <= thr[mt][h] && r < Da && j < Db) {
              ++n_ref;
              thr[mt][h] = fminf(
                  thr[mt][h],
                  refine<D, NEAREST>(ae + static_cast<int64_t>(r) * WA,
                                     be + static_cast<int64_t>(j) * WB, j,
                                     st + lr * 4 + t));
            }
          }
        }
      }
    }
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v = thr[mt][h];
        v = fminf(v, __shfl_xor_sync(0xffffffffu, v, 1));
        v = fminf(v, __shfl_xor_sync(0xffffffffu, v, 2));
        thr[mt][h] = v;
      }
    }
    __syncthreads();  // the stage is refilled by the next issue
  }
  __syncthreads();
  for (int lr = threadIdx.x; lr < kRows; lr += kThreads) {
    const int r = rb + lr;
    if (r >= Da) continue;
    float4 m = st[lr * 4];
#pragma unroll
    for (int q = 1; q < 4; ++q) m = merge_state(m, st[lr * 4 + q]);
    part[static_cast<int64_t>(blockIdx.y) * Da + r] = m;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    n_ref += __shfl_xor_sync(0xffffffffu, n_ref, off);
  if (lane == 0 && n_ref) atomicAdd(refined, n_ref);
}

// The filter's MMAs alone, for measuring their error against the note's
// accumulation bound: a warp a problem, A' (16, KP) and B' (8, KP) float32
// rows of TF32 values, out (16, 8) = A' B'^T as filter_dot sums it.
template <int D, int KP>
__global__ void mma_probe_kernel(const float* __restrict__ a,
                                 const float* __restrict__ b, int n,
                                 float* __restrict__ out) {
  const int p = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (p >= n) return;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* pa = a + static_cast<int64_t>(p) * 16 * KP;
  const float* pb = b + static_cast<int64_t>(p) * 8 * KP;
  uint32_t af[KP / 8][4], bf[KP / 4];
#pragma unroll
  for (int ks = 0; ks < KP / 8; ++ks) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int k = 8 * ks + t + 4 * q;
      af[ks][2 * q] = __float_as_uint(pa[g * KP + k]);
      af[ks][1 + 2 * q] = __float_as_uint(pa[(g + 8) * KP + k]);
      bf[2 * ks + q] = __float_as_uint(pb[g * KP + k]);
    }
  }
  float c[4];
  filter_dot<D, KP>(c, af, bf);
  float* o = out + static_cast<int64_t>(p) * 128;
  o[g * 8 + 2 * t] = c[0];
  o[g * 8 + 2 * t + 1] = c[1];
  o[(g + 8) * 8 + 2 * t] = c[2];
  o[(g + 8) * 8 + 2 * t + 1] = c[3];
}

// The splits' states of each row merged in split order; the outputs.
__global__ void merge_kernel(const float4* __restrict__ part, int Da,
                             int splits, int nearest, float ratio,
                             int* __restrict__ best, float* __restrict__ bestd,
                             uint8_t* __restrict__ accept) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= Da) return;
  float4 m = part[r];
  for (int s = 1; s < splits; ++s)
    m = merge_state(m, part[static_cast<int64_t>(s) * Da + r]);
  best[r] = __float_as_int(nearest ? m.y : m.z);
  bestd[r] = m.x;
  if (accept) accept[r] = (sqrtf(m.w) >= ratio * sqrtf(m.x)) ? 1 : 0;
}

template <int D>
cudaError_t launch_center(const float* b, int Db, double* partials, int nparts,
                          float* center, cudaStream_t s) {
  center_partial_kernel<D><<<nparts, k20::kCenterThreads, 0, s>>>(b, Db,
                                                                 partials);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  center_final_kernel<<<1, 32, 0, s>>>(partials, nparts, D, Db, center);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_ratio(const float* a, int Da, const float* b, int Db,
                         const int* owner, float ratio, const float* center,
                         int row_blocks, int splits, int tiles_per_split,
                         int tiles, float* ae, float* be, float* bt,
                         float4* part, unsigned long long* refined, int* best,
                         float* bestd, uint8_t* accept, cudaStream_t s) {
  constexpr int KP = D + 1 <= 16 ? 16 : 32;
  constexpr int WA = (D + 1 + 3) / 4 * 4;
  constexpr int WB = (D + 2 + 3) / 4 * 4;
  const int Db_pad = tiles * k20::kTile;
  const int64_t n = static_cast<int64_t>(Da) + Db_pad;
  prep_kernel<D, KP, WA, WB><<<static_cast<unsigned>((n + 255) / 256), 256, 0,
                               s>>>(a, Da, b, Db, owner, center, Db_pad, ae,
                                    be, bt, refined);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int shmem = (2 * k20::kTile * KP + 16 * k20::kRows) * sizeof(float);
  auto kern = owner ? filter_kernel<D, KP, WA, WB, false>
                    : filter_kernel<D, KP, WA, WB, true>;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           shmem);
  if (e != cudaSuccess) return e;
  kern<<<dim3(row_blocks, splits), k20::kThreads, shmem, s>>>(
      ae, Da, be, Db, bt, tiles_per_split, tiles, part, refined);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  merge_kernel<<<(Da + 255) / 256, 256, 0, s>>>(part, Da, splits,
                                                owner == nullptr, ratio, best,
                                                bestd, accept);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_probe(const float* a, const float* b, int n, float* out,
                         cudaStream_t s) {
  constexpr int KP = D + 1 <= 16 ? 16 : 32;
  mma_probe_kernel<D, KP><<<static_cast<unsigned>((n + 3) / 4), 128, 0, s>>>(
      a, b, n, out);
  return cudaGetLastError();
}

// Queries a thread of the scan holds (ops/descriptors.py knn_queries):
// the masked form's few valid queries spread over more threads.
constexpr int knn_queries(bool masked) { return masked ? 1 : 4; }

template <int P>
cudaError_t launch_knn(const float* pts, const uint8_t* valid, int B, int K,
                       int n, int S, const int* subsets, int rot,
                       int row_blocks, int splits, int per_split, int kp,
                       float4* pts4, float* part_d, int* part_i, int* idx,
                       float* desc, uint8_t* dvalid, cudaStream_t s) {
  const int64_t packed = static_cast<int64_t>(B) * kp;
  knn_pack_kernel<<<static_cast<unsigned>(
                        (packed + k19::kPackThreads - 1) / k19::kPackThreads),
                    k19::kPackThreads, 0, s>>>(pts, valid, B, K, kp, pts4);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const dim3 grid(row_blocks, splits, B);
  if (valid)
    knn_scan_kernel<P, knn_queries(true), true>
        <<<grid, k19::kThreads, 0, s>>>(pts4, K, kp, per_split, part_d,
                                         part_i);
  else
    knn_scan_kernel<P, knn_queries(false), false>
        <<<grid, k19::kThreads, 0, s>>>(pts4, K, kp, per_split, part_d,
                                         part_i);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int64_t rows = static_cast<int64_t>(B) * K;
  knn_tail_kernel<P><<<static_cast<unsigned>(
                           (rows + k19::kTailThreads - 1) / k19::kTailThreads),
                       k19::kTailThreads, 0, s>>>(
      pts, valid, B, K, splits, part_d, part_i, n, S, subsets, rot, idx, desc,
      dvalid);
  return cudaGetLastError();
}

}  // namespace

// q, row_blocks, splits, per_split, kp: ops/descriptors.py knn_plan.
// pts (B, K, 3) float32, valid (B, K) or null; scratch pts4 (B, kp) float4,
// part_d, part_i (splits, B, K, pool); idx (B, K, pool) or null, desc (B,
// K, S, 3n), dvalid (B, K).
extern "C" int bst_knn_descriptors(const float* pts, const uint8_t* valid,
                                   int B, int K, int pool, int n, int S,
                                   const int* subsets, int rot, int q,
                                   int row_blocks, int splits, int per_split,
                                   int kp, void* pts4, float* part_d,
                                   int* part_i, int* idx, float* desc,
                                   uint8_t* dvalid, void* stream) {
  if (B < 1 || B > 65535 || K < 1 || pool < 1 || pool > kMaxPool || n < 1 ||
      n > pool || S < 1 || desc == nullptr ||
      static_cast<int64_t>(K) * 3 > 2147483647LL)
    return cudaErrorInvalidValue;
  const int64_t rows = static_cast<int64_t>(k19::kThreads) * q;
  const int64_t tiles = (static_cast<int64_t>(K) + k19::kTile - 1) /
                        k19::kTile;
  if (q != knn_queries(valid != nullptr) || row_blocks < 1 || row_blocks * rows < K ||
      (row_blocks - 1) * rows >= K ||
      kp != tiles * k19::kTile || per_split < 1 ||
      per_split % k19::kTile != 0 || splits < 1 || splits > 65535 ||
      static_cast<int64_t>(splits) * per_split < K ||
      static_cast<int64_t>(splits - 1) * per_split >= K)
    return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(pts4) % 16 != 0)
    return cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float4* p4 = static_cast<float4*>(pts4);
  cudaError_t e = cudaErrorInvalidValue;
  switch (pool) {
#define BST_CASE(p)                                                          \
  case p:                                                                    \
    e = launch_knn<p>(pts, valid, B, K, n, S, subsets, rot, row_blocks,     \
                      splits, per_split, kp, p4, part_d, part_i, idx, desc, \
                      dvalid, s);                                            \
    break;
    BST_CASE(1) BST_CASE(2) BST_CASE(3) BST_CASE(4) BST_CASE(5) BST_CASE(6)
    BST_CASE(7) BST_CASE(8)
#undef BST_CASE
  }
  return static_cast<int>(e);
}

#define BST_K20_DIMS(X) X(3) X(6) X(9) X(12) X(15) X(18) X(21) X(24)

extern "C" int bst_ratio_center(const float* b, int Db, int D,
                                double* partials, int nparts, float* center,
                                void* stream) {
  if (Db < 1 || D < 3 || D > kMaxDim || D % 3 != 0 || nparts < 1 ||
      nparts > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
  switch (D) {
#define BST_CASE(d) \
  case d: e = launch_center<d>(b, Db, partials, nparts, center, s); break;
    BST_K20_DIMS(BST_CASE)
#undef BST_CASE
  }
  return static_cast<int>(e);
}

extern "C" int bst_ratio_mma_probe(const float* a, const float* b, int D,
                                   int n, float* out, void* stream) {
  if (n < 1 || D < 3 || D > kMaxDim || D % 3 != 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
  switch (D) {
#define BST_CASE(d) \
  case d: e = launch_probe<d>(a, b, n, out, s); break;
    BST_K20_DIMS(BST_CASE)
#undef BST_CASE
  }
  return static_cast<int>(e);
}

extern "C" int bst_ratio_match(const float* a, int Da, const float* b, int Db,
                               int D, const int* owner, float ratio,
                               const float* center, int row_blocks,
                               int splits, int tiles_per_split, int tiles,
                               float* ae, float* be, float* bt, float* part,
                               unsigned long long* refined, int* best,
                               float* bestd, uint8_t* accept, void* stream) {
  const int64_t rows = static_cast<int64_t>(row_blocks) * k20::kRows;
  if (Da < 1 || Db < 1 || D < 3 || D > kMaxDim || D % 3 != 0 ||
      (owner != nullptr && accept == nullptr) || row_blocks < 1 ||
      rows < Da || rows - k20::kRows >= Da || tiles < 1 ||
      static_cast<int64_t>(tiles) * k20::kTile < Db ||
      static_cast<int64_t>(tiles - 1) * k20::kTile >= Db ||
      static_cast<int64_t>(tiles) * k20::kTile > 2147483647LL ||
      tiles_per_split < 1 || splits < 1 || splits > 65535 ||
      static_cast<int64_t>(splits) * tiles_per_split < tiles ||
      static_cast<int64_t>(splits - 1) * tiles_per_split >= tiles)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float4* p4 = reinterpret_cast<float4*>(part);
  cudaError_t e = cudaErrorInvalidValue;
  switch (D) {
#define BST_CASE(d)                                                          \
  case d:                                                                    \
    e = launch_ratio<d>(a, Da, b, Db, owner, ratio, center, row_blocks,      \
                        splits, tiles_per_split, tiles, ae, be, bt, p4,      \
                        refined, best, bestd, accept, s);                    \
    break;
    BST_K20_DIMS(BST_CASE)
#undef BST_CASE
  }
  return static_cast<int>(e);
}
