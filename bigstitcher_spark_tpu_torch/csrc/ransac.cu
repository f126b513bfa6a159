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
//   one thread block per hypothesis h. Thread 0 loads the `sample` pairs
//   idx[h, :], takes their centroids ((p0 + p1) + ...) / n and the centred
//   moments A, H summed in sample order, and fits fit_model(kind) in
//   float32 (fit3d.cuh). Every thread then streams a stride of the M
//   candidates: pred_j = ((m_j0 p_x + m_j1 p_y) + m_j2 p_z) + m_j3,
//   e2 = (dx dx + dy dy) + dz dz, an inlier when e2 < eps * eps; the
//   block sums its integer counts. The (I, M) error matrix never exists,
//   so one launch covers what JAX chunks. A second kernel (one block)
//   takes the argmax of the counts, the lowest index on ties
//   (jnp.argmax), and writes its index and its model (as double).
//   Bound: operations (27 float ops per hypothesis and candidate);
//   the candidates stay in L2.
//
// K22 ransac_refit (_ransac_kernel :399-408): one block of 256 threads.
//   Given a model (double), each thread strides over the candidates,
//   marks inliers (e2 < eps^2 in double) and, when fitting, sums the raw
//   weighted moments of its inliers in double (sw, sum p, sum q, sum pp^T,
//   sum pq^T). Warp shuffles and one thread then reduce them in a fixed
//   order (no atomics: a repeat gives the same bits), centre them (A =
//   spp - sp pc^T, H = spq - sp qc^T) and fit fit_interpolated(kind, reg,
//   lam) in double. It runs twice per RANSAC call (the two consensus
//   refits) and once more without the fit for the final inlier mask.
//   Bound: bytes (the candidates read once).
#include "fit3d.cuh"
#include "fusion_common.cuh"

namespace {

constexpr int kScoreThreads = 256;
constexpr int kRefitThreads = 256;
constexpr int kMaxSample = 8;
constexpr int kMoments = 22;  // sw, sp[3], sq[3], spp[6], spq[9]

__global__ void score_kernel(const float* __restrict__ pa,
                             const float* __restrict__ pb, int M,
                             const int* __restrict__ idx, int I, int sample,
                             int kind, float eps2, int* __restrict__ counts,
                             float* __restrict__ models) {
  __shared__ float sm[12];
  __shared__ int warp_counts[kScoreThreads / 32];
  const int h = blockIdx.x;
  if (threadIdx.x == 0) {
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
    float m[12];
    bst::fit_centred<float>(kind, pc, qc, A, H, m);
#pragma unroll
    for (int i = 0; i < 12; ++i) sm[i] = m[i];
  }
  __syncthreads();
  float m[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) m[i] = sm[i];
  int cnt = 0;
  for (int r = threadIdx.x; r < M; r += blockDim.x) {
    const float x = pa[3 * static_cast<int64_t>(r)];
    const float y = pa[3 * static_cast<int64_t>(r) + 1];
    const float z = pa[3 * static_cast<int64_t>(r) + 2];
    float e2 = 0.0f;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float pred =
          ((m[4 * j] * x + m[4 * j + 1] * y) + m[4 * j + 2] * z) + m[4 * j + 3];
      const float d = pred - pb[3 * static_cast<int64_t>(r) + j];
      e2 = j == 0 ? d * d : e2 + d * d;
    }
    cnt += e2 < eps2 ? 1 : 0;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    cnt += __shfl_down_sync(0xffffffffu, cnt, off);
  if ((threadIdx.x & 31) == 0) warp_counts[threadIdx.x >> 5] = cnt;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int w = 0; w < kScoreThreads / 32; ++w) total += warp_counts[w];
    counts[h] = total;
#pragma unroll
    for (int i = 0; i < 12; ++i) models[12 * static_cast<int64_t>(h) + i] = m[i];
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

__global__ void refit_kernel(const float* __restrict__ pa,
                             const float* __restrict__ pb, int M,
                             const double* __restrict__ model_in, double eps2,
                             int fit, int kind, int reg, double lam,
                             uint8_t* __restrict__ mask,
                             int* __restrict__ count,
                             double* __restrict__ model_out) {
  __shared__ double sh[kRefitThreads / 32][kMoments];
  __shared__ int shc[kRefitThreads / 32];
  double m[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) m[i] = model_in[i];
  double acc[kMoments];
#pragma unroll
  for (int v = 0; v < kMoments; ++v) acc[v] = 0.0;
  int cnt = 0;
  for (int r = threadIdx.x; r < M; r += blockDim.x) {
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
#pragma unroll
  for (int v = 0; v < kMoments; ++v) {
    const double s = warp_sum(acc[v]);
    if (lane == 0) sh[warp][v] = s;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    cnt += __shfl_down_sync(0xffffffffu, cnt, off);
  if (lane == 0) shc[warp] = cnt;
  __syncthreads();
  if (threadIdx.x != 0) return;
  int total = 0;
  double mo[kMoments];
#pragma unroll
  for (int v = 0; v < kMoments; ++v) mo[v] = 0.0;
  for (int w = 0; w < kRefitThreads / 32; ++w) {
    total += shc[w];
#pragma unroll
    for (int v = 0; v < kMoments; ++v) mo[v] += sh[w][v];
  }
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
                                float eps, int* counts, float* models,
                                int* best, double* best_model, void* stream) {
  if (M < 1 || I < 1 || I > 2147483647 / 12 || sample < 1 ||
      sample > kMaxSample || kind < bst::FIT_TRANSLATION ||
      kind > bst::FIT_IDENTITY)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  score_kernel<<<I, kScoreThreads, 0, s>>>(pa, pb, M, idx, I, sample, kind,
                                           eps * eps, counts, models);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  argmax_kernel<<<1, 1024, 0, s>>>(counts, I, models, best, best_model);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bst_ransac_refit(const float* pa, const float* pb, int M,
                                const double* model_in, double eps, int fit,
                                int kind, int reg, double lam, uint8_t* mask,
                                int* count, double* model_out, void* stream) {
  if (M < 1 || kind < bst::FIT_TRANSLATION || kind > bst::FIT_IDENTITY ||
      reg < bst::FIT_NONE || reg > bst::FIT_IDENTITY ||
      (fit && model_out == nullptr))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  refit_kernel<<<1, kRefitThreads, 0, s>>>(pa, pb, M, model_in, eps * eps,
                                           fit, kind, reg, lam, mask, count,
                                           model_out);
  return static_cast<int>(cudaGetLastError());
}
