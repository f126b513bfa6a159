// K23: hypothesis-parallel RANSAC line fits of the intensity matching, the
// port of _linefit_ransac_kernel (bigstitcher_spark_tpu/ops/intensity.py:36).
//
// For each cell pair p < P, samples x, y and a validity mask (P, N) float32,
// and I hypotheses of two sample indices each (drawn by the wrapper with
// replacement over [0, N), ops/intensity.py draw_hypotheses; an input, so
// the plain twin sees the same draws):
//   a = (y1 - y0) / (x1 - x0), 1 where |x1 - x0| <= 1e-6; b = y0 - a x0;
//   inliers |y - (a x + b)| < eps among the valid samples; the first
//   hypothesis with the most inliers; then the float32 weighted least
//   squares refit on its inliers: mx, my, cov / var, my - a mx.
// Two kernels on one stream:
//   linefit_score: grid (hypothesis chunks of 256, P); the pair's x, y and
//     valid in shared memory (12 B a sample), one thread a hypothesis
//     streaming all N samples (every lane of a warp reads the same sample:
//     a broadcast), its count written to counts[p, h];
//   linefit_refit: one block a pair: the first argmax of the counts
//     (ascending strides, ties to the lower index), the best line
//     recomputed, then the weighted sums in two passes (means, then the
//     centred moments), each a fixed-order block tree.
// Every float op is rounded on its own (-fmad=false), in the twin's order
// (ops/intensity.py linefit_ransac_plain): counts and argmax equal the
// twin's bit for bit; the refit's sums are taken in another order.
//
// Bound: operations, about 6 float32 operations a (hypothesis, sample): a
// multiply and an add for the prediction, a subtract, an absolute value, a
// compare and the valid test. The samples stay in shared memory.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void hypothesis_line(const float* x, const float* y,
                                                int i0, int i1, float* a,
                                                float* b) {
  const float x0 = x[i0], x1 = x[i1], y0 = y[i0], y1 = y[i1];
  const float dx = x1 - x0;
  const float aa = fabsf(dx) > 1e-6f ? (y1 - y0) / dx : 1.0f;
  *a = aa;
  *b = y0 - aa * x0;
}

__device__ __forceinline__ bool is_inlier(float a, float b, float xv, float yv,
                                          float vv, float eps) {
  const float pred = a * xv + b;
  return fabsf(yv - pred) < eps && vv > 0.0f;
}

__global__ void __launch_bounds__(kThreads)
linefit_score(const float* __restrict__ x, const float* __restrict__ y,
              const float* __restrict__ valid, int N,
              const int* __restrict__ hyp, int I, float eps,
              int* __restrict__ counts) {
  extern __shared__ float smem[];
  float* sx = smem;
  float* sy = smem + N;
  float* sv = smem + 2 * N;
  const int p = blockIdx.y;
  const int64_t base = static_cast<int64_t>(p) * N;
  for (int j = threadIdx.x; j < N; j += kThreads) {
    sx[j] = x[base + j];
    sy[j] = y[base + j];
    sv[j] = valid[base + j];
  }
  __syncthreads();
  const int h = blockIdx.x * kThreads + threadIdx.x;
  if (h >= I) return;
  const int64_t hi = (static_cast<int64_t>(p) * I + h) * 2;
  float a, b;
  hypothesis_line(sx, sy, hyp[hi], hyp[hi + 1], &a, &b);
  int cnt = 0;
  for (int j = 0; j < N; ++j) cnt += is_inlier(a, b, sx[j], sy[j], sv[j], eps);
  counts[static_cast<int64_t>(p) * I + h] = cnt;
}

__device__ float block_sum(float v, float* sh) {
  __syncthreads();
  sh[threadIdx.x] = v;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) sh[threadIdx.x] = sh[threadIdx.x] + sh[threadIdx.x + s];
    __syncthreads();
  }
  return sh[0];
}

__global__ void __launch_bounds__(kThreads)
linefit_refit(const float* __restrict__ x, const float* __restrict__ y,
              const float* __restrict__ valid, int N,
              const int* __restrict__ hyp, int I, float eps,
              const int* __restrict__ counts, int* __restrict__ best_out,
              int* __restrict__ count_out, float* __restrict__ a_out,
              float* __restrict__ b_out) {
  __shared__ int sc[kThreads], si[kThreads];
  __shared__ float sh[kThreads];
  __shared__ float line[2];
  const int p = blockIdx.x;
  const int* cp = counts + static_cast<int64_t>(p) * I;
  int bc = -1, bi = 0x7fffffff;
  for (int h = threadIdx.x; h < I; h += kThreads)
    if (cp[h] > bc) {  // ascending h: the first maximum stays
      bc = cp[h];
      bi = h;
    }
  sc[threadIdx.x] = bc;
  si[threadIdx.x] = bi;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) {
      const int oc = sc[threadIdx.x + s], oi = si[threadIdx.x + s];
      if (oc > sc[threadIdx.x] ||
          (oc == sc[threadIdx.x] && oi < si[threadIdx.x])) {
        sc[threadIdx.x] = oc;
        si[threadIdx.x] = oi;
      }
    }
    __syncthreads();
  }
  const int64_t base = static_cast<int64_t>(p) * N;
  const float* xp = x + base;
  const float* yp = y + base;
  const float* vp = valid + base;
  if (threadIdx.x == 0) {
    const int64_t hi = (static_cast<int64_t>(p) * I + si[0]) * 2;
    hypothesis_line(xp, yp, hyp[hi], hyp[hi + 1], &line[0], &line[1]);
    best_out[p] = si[0];
    count_out[p] = sc[0];
  }
  __syncthreads();
  const float a = line[0], b = line[1];
  float sw = 0.0f, swx = 0.0f, swy = 0.0f;
  for (int j = threadIdx.x; j < N; j += kThreads) {
    const float w = is_inlier(a, b, xp[j], yp[j], vp[j], eps) ? 1.0f : 0.0f;
    sw = sw + w;
    swx = swx + w * xp[j];
    swy = swy + w * yp[j];
  }
  const float sw_t = fmaxf(block_sum(sw, sh), 1e-6f);
  const float mx = block_sum(swx, sh) / sw_t;
  const float my = block_sum(swy, sh) / sw_t;
  float cov = 0.0f, var = 0.0f;
  for (int j = threadIdx.x; j < N; j += kThreads) {
    const float w = is_inlier(a, b, xp[j], yp[j], vp[j], eps) ? 1.0f : 0.0f;
    const float dxm = xp[j] - mx;
    cov = cov + w * dxm * (yp[j] - my);
    var = var + w * (dxm * dxm);
  }
  const float cov_t = block_sum(cov, sh);
  const float var_t = fmaxf(block_sum(var, sh), 1e-12f);
  if (threadIdx.x == 0) {
    const float af = cov_t / var_t;
    a_out[p] = af;
    b_out[p] = my - af * mx;
  }
}

}  // namespace

extern "C" int bst_linefit_ransac(const void* x, const void* y,
                                  const void* valid, int P, int N,
                                  const void* hyp, int I, float eps,
                                  void* counts, void* best, void* count,
                                  void* a, void* b, void* stream) {
  if (P <= 0 || N <= 0 || I <= 0 || P > 65535) return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(3) * N * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      linefit_score, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((I + kThreads - 1) / kThreads, P);
  linefit_score<<<grid, kThreads, smem, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<const float*>(valid), N, static_cast<const int*>(hyp), I,
      eps, static_cast<int*>(counts));
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  linefit_refit<<<P, kThreads, 0, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<const float*>(valid), N, static_cast<const int*>(hyp), I,
      eps, static_cast<const int*>(counts), static_cast<int*>(best),
      static_cast<int*>(count), static_cast<float*>(a),
      static_cast<float*>(b));
  return static_cast<int>(cudaGetLastError());
}

// Text of a cudaError_t returned by a launcher (each library has its own copy).
extern "C" const char* bst_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
