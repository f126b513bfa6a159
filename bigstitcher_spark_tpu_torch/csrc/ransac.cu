// K21-K22: hypothesis-parallel RANSAC, the JAX device programs
// _ransac_kernel and _ransac_score_chunk
// (bigstitcher_spark_tpu/ops/descriptors.py:380, :413). Candidate pairs
// pa, pb are (M, 3) float32. The hypotheses' sample indices are drawn by
// the wrapper (ops/descriptors.py draw_hypotheses) and are an input here.
// Fits come from fit3d.cuh. Every float op is rounded on its own
// (-fmad=false); the plain twins in ops/descriptors.py repeat K21's float
// operations in the same order.
//
// K21 ransac_score (_ransac_kernel :386-398 and _ransac_score_chunk):
//   a block of 8 warps owns a group of kGroup = 128 hypotheses (32 lanes x
//   kSlots = 4, hypothesis 128 g + 32 s + lane in lane's slot s) and one
//   split of the candidates (ops/descriptors.py ransac_plan: as many
//   splits as bring the blocks to whole waves of the SMs' block slots,
//   none shorter than a tile). Warp s < kSlots fits slot s of every lane
//   (one thread a hypothesis): it loads the `sample` pairs idx[h, :],
//   takes their centroids ((p0 + p1) + ...) / n and the centred moments A,
//   H summed in sample order, and fits fit_model(kind) in float32
//   (fit3d.cuh); split 0 stores the models. Every lane then holds its four
//   models in registers. The split's candidates are staged kTile at a
//   time in shared memory (float4 loads of the contiguous AoS rows where
//   the rows are 16-byte aligned, one float4 a candidate and side there),
//   each warp takes every eighth candidate of a tile (all lanes read the
//   same one: a broadcast) and scores it against its lanes' four models:
//   pred_j = ((m_j0 p_x + m_j1 p_y) + m_j2 p_z) + m_j3, e2 = (dx dx + dy
//   dy) + dz dz, an inlier when e2 < eps * eps. The warps' counts meet in
//   shared memory; a block stores them, or adds them atomically where
//   several splits share a hypothesis (integers: the same total in any
//   order; the launcher zeroes the counts first). The (I, M) error matrix
//   never exists. A second kernel (one block) takes the argmax of the
//   counts, the lowest index on ties (jnp.argmax), and writes its index
//   and its model (as double).
//   Bound: operations (27 float ops per hypothesis and candidate, each
//   rounded on its own). The scoring loop issues ~30.6 instructions a
//   pair (26 FMUL/FADD, the compare, the count, its share of the shared
//   loads and the loop), so the card's issue rate, not its FP32 peak, is
//   the floor. The first form gave each hypothesis a block whose thread 0
//   fitted it while 255 threads waited, and every block streamed all M
//   candidates from L2 (14 GB of L2 reads at 9b); here a staged candidate
//   serves 128 hypotheses and a block's 128 fits run at once. Fitting in
//   the scoring blocks (each split refits its group) beat a separate fit
//   launch at 9a's and 9b's shapes (H100 SXM).
//
// K22 ransac_refit (_ransac_kernel :399-408): given a model (double),
//   mark the inliers (e2 < eps^2 in double) and, when fitting, sum the raw
//   weighted moments of the inliers in double (sw, sum p, sum q, sum pp^T,
//   sum pq^T), centre them (A = spp - sp pc^T, H = spq - sp qc^T) and fit
//   fit_interpolated(kind, reg, lam) in double. It runs twice per RANSAC
//   call (the two consensus refits) and once more without the fit for the
//   final inlier mask. Bound: bytes (the candidates read once, the mask
//   written once); the first form, one block of 256 threads, walked 9b's
//   58,274 candidates on one SM of 132 (0.0913 ms against a 0.0004 ms
//   bound). Now a grid of blocks (ops/descriptors.py refit_plan: one block
//   where M is small, else up to one an SM, each a contiguous run of
//   per_block candidates). A block's threads take its rows r0 + t, r0 + t
//   + 256, ... and sum their moments in that order; each warp's
//   shuffle-down tree, then the warps in order, give the block's partial,
//   which it stores with its count. The last block to arrive (a ticket,
//   reduce.cuh last_block_arrived) loads every partial into shared memory
//   at once, adds them in block order (a thread a moment) and fits. So one launch a call, and a repeat gives the
//   same bits; with one block the order, and so every bit, is the first
//   form's. The per-row arithmetic is the first form's: the masks are
//   bitwise its (and the twin's) for any grid.
#include "fit3d.cuh"
#include "fusion_common.cuh"
#include "reduce.cuh"

namespace {

constexpr int kScoreWarps = 8;
constexpr int kScoreThreads = 32 * kScoreWarps;
constexpr int kSlots = 4;               // hypotheses a lane scores
constexpr int kGroup = 32 * kSlots;     // hypotheses a block
constexpr int kTile = 256;              // candidates staged at a time
// blocks an SM holds (at most 128 registers a thread; ops/descriptors.py
// RANSAC_BLOCKS_PER_SM plans the grid's waves by it)
constexpr int kScoreBlocksPerSM = 2;
constexpr int kRefitThreads = 256;
constexpr int kMaxSample = 8;
constexpr int kMoments = 22;  // sw, sp[3], sq[3], spp[6], spq[9]
// a block's partial: the moments, then its inlier count (exact in double)
constexpr int kPartial = kMoments + 1;
// blocks a launch at most (the last block holds every partial in shared
// memory; ops/descriptors.py REFIT_MAX_BLOCKS)
constexpr int kRefitMaxBlocks = 192;

static_assert(kSlots <= kScoreWarps, "a warp fits one slot");
static_assert(kTile % 4 == 0, "tiles start on whole float4s");

// The model of `kind` fitted to hypothesis h's `sample` pairs (the first
// form's thread 0, operation for operation).
__device__ void fit_hypothesis(const float* __restrict__ pa,
                               const float* __restrict__ pb,
                               const int* __restrict__ idx, int h,
                               int sample, int kind, float* m) {
  float p[kMaxSample][3], q[kMaxSample][3];
  for (int k = 0; k < sample; ++k) {
    const int64_t r = idx[static_cast<int64_t>(h) * sample + k];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      p[k][c] = pa[3 * r + c];
      q[k][c] = pb[3 * r + c];
    }
  }
  const float n = static_cast<float>(sample);
  float pc[3], qc[3], A[3][3], H[3][3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float sp = p[0][c], sq = q[0][c];
    for (int k = 1; k < sample; ++k) {
      sp = sp + p[k][c];
      sq = sq + q[k][c];
    }
    pc[c] = sp / n;
    qc[c] = sq / n;
  }
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      float sa = (p[0][i] - pc[i]) * (p[0][j] - pc[j]);
      float sh = (p[0][i] - pc[i]) * (q[0][j] - qc[j]);
      for (int k = 1; k < sample; ++k) {
        sa = sa + (p[k][i] - pc[i]) * (p[k][j] - pc[j]);
        sh = sh + (p[k][i] - pc[i]) * (q[k][j] - qc[j]);
      }
      A[i][j] = sa;
      H[i][j] = sh;
    }
  bst::fit_centred<float>(kind, pc, qc, A, H, m);
}

// Candidates [c0, c0 + n) of one side into s[0, n) (x, y, z of each float4;
// w unused). c0 is a multiple of 4, so with `vec` (the rows 16-byte
// aligned) their 3 n floats start on a float4.
__device__ __forceinline__ void stage_side(const float* __restrict__ src,
                                           int c0, int n, int vec,
                                           float4* s) {
  float* sf = reinterpret_cast<float*>(s);
  const float* base = src + 3 * static_cast<int64_t>(c0);
  const int nf = 3 * n;
  int e0 = 0;
  if (vec) {
    const float4* b4 = reinterpret_cast<const float4*>(base);
    for (int v = threadIdx.x; v < nf / 4; v += kScoreThreads) {
      const float4 x = b4[v];
      const float w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = 4 * v + u, c = e / 3;
        sf[4 * c + (e - 3 * c)] = w[u];
      }
    }
    e0 = nf / 4 * 4;
  }
  for (int e = e0 + threadIdx.x; e < nf; e += kScoreThreads) {
    const int c = e / 3;
    sf[4 * c + (e - 3 * c)] = base[e];
  }
}

__global__ void __launch_bounds__(kScoreThreads, kScoreBlocksPerSM)
score_kernel(const float* __restrict__ pa, const float* __restrict__ pb,
             int M, const int* __restrict__ idx, int I, int sample, int kind,
             float eps2, int per_split, int vec, int* __restrict__ counts,
             float* __restrict__ models) {
  __shared__ float4 sp[kTile], sq[kTile];
  __shared__ float sm[kSlots][12][32];
  __shared__ int red[kScoreWarps][kGroup];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h0 = blockIdx.x * kGroup;
  if (warp < kSlots) {
    const int h = h0 + 32 * warp + lane;
    float m[12];
#pragma unroll
    for (int k = 0; k < 12; ++k) m[k] = 0.0f;
    if (h < I) fit_hypothesis(pa, pb, idx, h, sample, kind, m);
#pragma unroll
    for (int k = 0; k < 12; ++k) sm[warp][k][lane] = m[k];
    if (blockIdx.y == 0 && h < I) {
      float4* dst =
          reinterpret_cast<float4*>(models + 12 * static_cast<int64_t>(h));
      dst[0] = make_float4(m[0], m[1], m[2], m[3]);
      dst[1] = make_float4(m[4], m[5], m[6], m[7]);
      dst[2] = make_float4(m[8], m[9], m[10], m[11]);
    }
  }
  __syncthreads();
  float m[kSlots][12];
  int cnt[kSlots];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    cnt[s] = 0;
#pragma unroll
    for (int k = 0; k < 12; ++k) m[s][k] = sm[s][k][lane];
  }
  const int split = blockIdx.y;
  const int c_end = min(M, (split + 1) * per_split);
  for (int t0 = split * per_split; t0 < c_end; t0 += kTile) {
    const int n = min(kTile, c_end - t0);
    __syncthreads();  // the previous tile is consumed
    stage_side(pa, t0, n, vec, sp);
    stage_side(pb, t0, n, vec, sq);
    __syncthreads();
#pragma unroll 2
    for (int c = warp; c < n; c += kScoreWarps) {
      const float4 p = sp[c], q = sq[c];
      const float qv[3] = {q.x, q.y, q.z};
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        float e2 = 0.0f;
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const float pred = ((m[s][4 * j] * p.x + m[s][4 * j + 1] * p.y) +
                              m[s][4 * j + 2] * p.z) + m[s][4 * j + 3];
          const float d = pred - qv[j];
          e2 = j == 0 ? d * d : e2 + d * d;
        }
        cnt[s] += e2 < eps2 ? 1 : 0;
      }
    }
  }
#pragma unroll
  for (int s = 0; s < kSlots; ++s) red[warp][32 * s + lane] = cnt[s];
  __syncthreads();
  if (threadIdx.x < kGroup) {
    const int h = h0 + threadIdx.x;
    int total = 0;
#pragma unroll
    for (int w = 0; w < kScoreWarps; ++w) total += red[w][threadIdx.x];
    if (h < I) {
      if (gridDim.y == 1)
        counts[h] = total;
      else
        atomicAdd(counts + h, total);
    }
  }
}

__global__ void argmax_kernel(const int* __restrict__ counts, int I,
                              const float* __restrict__ models,
                              int* __restrict__ best,
                              double* __restrict__ best_model) {
  __shared__ int sc[1024], si[1024];
  int bc = -1, bi = 0x7fffffff;
  for (int h = threadIdx.x; h < I; h += blockDim.x)
    if (counts[h] > bc) {  // ascending h: the first maximum stays
      bc = counts[h];
      bi = h;
    }
  sc[threadIdx.x] = bc;
  si[threadIdx.x] = bi;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) {
      const int oc = sc[threadIdx.x + s], oi = si[threadIdx.x + s];
      if (oc > sc[threadIdx.x] || (oc == sc[threadIdx.x] && oi < si[threadIdx.x])) {
        sc[threadIdx.x] = oc;
        si[threadIdx.x] = oi;
      }
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    best[0] = si[0];
    best[1] = sc[0];
#pragma unroll
    for (int i = 0; i < 12; ++i)
      best_model[i] = static_cast<double>(models[12 * static_cast<int64_t>(si[0]) + i]);
  }
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kRefitThreads)
refit_kernel(const float* __restrict__ pa, const float* __restrict__ pb,
             int M, int per_block, const double* __restrict__ model_in,
             double eps2, int fit, int kind, int reg, double lam,
             uint8_t* __restrict__ mask, int* __restrict__ count,
             double* __restrict__ model_out, double* __restrict__ partials,
             int* __restrict__ ticket) {
  constexpr int kWarps = kRefitThreads / 32;
  __shared__ double sh[kWarps][kMoments];
  __shared__ int shc[kWarps];
  __shared__ double mo[kMoments];
  __shared__ int total;
  double m[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) m[i] = model_in[i];
  double acc[kMoments];
#pragma unroll
  for (int v = 0; v < kMoments; ++v) acc[v] = 0.0;
  int cnt = 0;
  const int r0 = blockIdx.x * per_block;
  const int r1 = min(M, r0 + per_block);
  for (int r = r0 + threadIdx.x; r < r1; r += kRefitThreads) {
    double p[3], q[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      p[c] = pa[3 * static_cast<int64_t>(r) + c];
      q[c] = pb[3 * static_cast<int64_t>(r) + c];
    }
    double e2 = 0.0;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const double d =
          (((m[4 * j] * p[0] + m[4 * j + 1] * p[1]) + m[4 * j + 2] * p[2]) +
           m[4 * j + 3]) - q[j];
      e2 = j == 0 ? d * d : e2 + d * d;
    }
    const bool inl = e2 < eps2;
    mask[r] = inl ? 1 : 0;
    if (!inl) continue;
    ++cnt;
    if (!fit) continue;
    acc[0] += 1.0;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      acc[1 + c] += p[c];
      acc[4 + c] += q[c];
    }
    int k = 7;
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = i; j < 3; ++j) acc[k++] += p[i] * p[j];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) acc[13 + 3 * i + j] += p[i] * q[j];
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (fit) {
#pragma unroll
    for (int v = 0; v < kMoments; ++v) {
      const double s = warp_sum(acc[v]);
      if (lane == 0) sh[warp][v] = s;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    cnt += __shfl_down_sync(0xffffffffu, cnt, off);
  if (lane == 0) shc[warp] = cnt;
  __syncthreads();
  // the block's sums, the warps in order: thread v < kMoments moment v,
  // thread kMoments the count
  double part = 0.0;
  int n = 0;
  if (threadIdx.x < kMoments && fit) {
    for (int w = 0; w < kWarps; ++w) part += sh[w][threadIdx.x];
  } else if (threadIdx.x == kMoments) {
    for (int w = 0; w < kWarps; ++w) n += shc[w];
  }
  if (gridDim.x > 1) {
    double* own = partials + static_cast<int64_t>(blockIdx.x) * kPartial;
    if (threadIdx.x < kMoments && fit)
      own[threadIdx.x] = part;
    else if (threadIdx.x == kMoments)
      own[kMoments] = static_cast<double>(n);
    __threadfence();
    if (!bst::last_block_arrived(ticket)) return;
    // the last block: every block's partial (its count alone without the
    // fit) into shared memory at once, then each sum in block order
    __shared__ double parts[kRefitMaxBlocks * kPartial];
    const int blocks = static_cast<int>(gridDim.x);
    if (fit) {
      for (int e = threadIdx.x; e < blocks * kPartial; e += kRefitThreads)
        parts[e] = __ldcg(partials + e);
    } else {
      for (int e = threadIdx.x; e < blocks; e += kRefitThreads)
        parts[e * kPartial + kMoments] =
            __ldcg(partials + e * kPartial + kMoments);
    }
    __syncthreads();
    part = 0.0;
    n = 0;
    if (threadIdx.x < kMoments && fit) {
#pragma unroll 8
      for (int b = 0; b < blocks; ++b) part += parts[b * kPartial + threadIdx.x];
    } else if (threadIdx.x == kMoments) {
#pragma unroll 8
      for (int b = 0; b < blocks; ++b)
        n += static_cast<int>(parts[b * kPartial + kMoments]);
    }
  }
  if (threadIdx.x < kMoments) mo[threadIdx.x] = part;
  if (threadIdx.x == kMoments) total = n;
  __syncthreads();
  if (threadIdx.x != 0) return;
  count[0] = total;
  if (!fit) return;
  const double sw = mo[0];
  double pc[3], qc[3], A[3][3], H[3][3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    pc[c] = mo[1 + c] / sw;
    qc[c] = mo[4 + c] / sw;
  }
  int k = 7;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = i; j < 3; ++j) {
      A[i][j] = mo[k++] - mo[1 + i] * pc[j];
      A[j][i] = A[i][j];
    }
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) H[i][j] = mo[13 + 3 * i + j] - mo[1 + i] * qc[j];
  double out[12];
  bst::fit_interpolated<double>(kind, reg, lam, pc, qc, A, H, out);
#pragma unroll
  for (int i = 0; i < 12; ++i) model_out[i] = out[i];
}

}  // namespace

extern "C" int bst_ransac_score(const float* pa, const float* pb, int M,
                                const int* idx, int I, int sample, int kind,
                                float eps, int groups, int splits,
                                int per_split, int vec, int* counts,
                                float* models, int* best, double* best_model,
                                void* stream) {
  if (M < 1 || I < 1 || I > 2147483647 / 12 || sample < 1 ||
      sample > kMaxSample || kind < bst::FIT_TRANSLATION ||
      kind > bst::FIT_IDENTITY || groups != (I + kGroup - 1) / kGroup ||
      splits < 1 || splits > 65535 || per_split < 1 || per_split % 4 ||
      static_cast<int64_t>(splits) * per_split < M ||
      static_cast<int64_t>(splits - 1) * per_split >= M ||
      (vec && ((reinterpret_cast<uintptr_t>(pa) |
                reinterpret_cast<uintptr_t>(pb)) & 15)) ||
      (reinterpret_cast<uintptr_t>(models) & 15))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (splits > 1) {
    cudaError_t e = cudaMemsetAsync(counts, 0, sizeof(int) * I, s);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(groups, splits);
  score_kernel<<<grid, kScoreThreads, 0, s>>>(pa, pb, M, idx, I, sample, kind,
                                              eps * eps, per_split, vec,
                                              counts, models);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  argmax_kernel<<<1, 1024, 0, s>>>(counts, I, models, best, best_model);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bst_ransac_refit(const float* pa, const float* pb, int M,
                                const double* model_in, double eps, int fit,
                                int kind, int reg, double lam, int blocks,
                                int per_block, uint8_t* mask, int* count,
                                double* model_out, double* partials,
                                int* ticket, void* stream) {
  if (M < 1 || kind < bst::FIT_TRANSLATION || kind > bst::FIT_IDENTITY ||
      reg < bst::FIT_NONE || reg > bst::FIT_IDENTITY ||
      (fit && model_out == nullptr) || blocks < 1 ||
      blocks > kRefitMaxBlocks ||
      per_block < 1 || static_cast<int64_t>(blocks) * per_block < M ||
      static_cast<int64_t>(blocks - 1) * per_block >= M ||
      (blocks > 1 && (partials == nullptr || ticket == nullptr)))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  refit_kernel<<<blocks, kRefitThreads, 0, s>>>(
      pa, pb, M, per_block, model_in, eps * eps, fit, kind, reg, lam, mask,
      count, model_out, partials, ticket);
  return static_cast<int>(cudaGetLastError());
}
