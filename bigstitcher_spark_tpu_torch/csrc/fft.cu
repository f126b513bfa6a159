// K8: batched FFT of a power-of-two length along one axis, the FFT part of
// pcm_peaks / pcm_peaks_batch (bigstitcher_spark_tpu/ops/phasecorr.py:68,
// :104: jnp.fft.rfftn and jnp.fft.irfftn of the windowed crops). The
// wrappers compose numpy's rfftn from three passes (r2c along z, c2c along
// y, c2c along x) and irfftn from three more (c2c along x, then y, then c2r
// along z).
//
//   mode C2C  complex64 (outer, N, inner) -> the same shape, forward or
//             inverse (unscaled), along the middle axis; may run in place
//   mode R2C  float32 (lines, N) -> complex64 (lines, N/2+1): the complex
//             FFT of the real line, bins 0..N/2 kept
//   mode C2R  complex64 (lines, N/2+1) -> float32 (lines, N): Hermitian fill
//             (bin k >= N/2+1 is conj(bin N-k)), the imaginary parts of the
//             DC and Nyquist bins dropped as numpy's irfft drops them, then
//             the inverse transform's real part
//   every output is multiplied by `scale` (irfftn's 1 / (X Y Z): a power of
//   two, so exact)
//
// One block transforms L = max(1, 4096 / N) lines in shared memory (L*N
// complex values, 32 KB; 64 KB for N = 8192, which needs the dynamic shared
// memory attribute): load in bit-reversed order, log2(N) in-place radix-2
// decimation-in-time stages, store. Threads load element k of L neighbouring
// lines side by side, so for an inner axis (x and y passes) a warp reads
// consecutive addresses; along z a line is contiguous. Twiddles
// exp(-2 pi i m / N), m < N/2, come from a table the wrapper computes in
// float64 on the device and rounds to float32 (the inverse conjugates them).
// Lengths 1 to 8192; the wrapper raises beyond that.
//
// Bound: one real 3-D transform moves its input and output once (bytes) and
// does ~2.5 N log2 N float operations; the y pass of a 1024-line, 65-bin
// spectrum keeps only 4 lines side by side (32-byte rows), so this simple
// kernel is far from the byte bound there. Faster layouts are later work.
#include "fusion_common.cuh"

namespace {

enum FftMode : int { C2C = 0, R2C = 1, C2R = 2 };

constexpr int kLineElems = 4096;  // complex values per block (L * N)

__host__ __device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// line j, element k of a block's loop counter e: element-major over an inner
// axis (neighbouring lines side by side), line-major along a contiguous one
__device__ __forceinline__ void split(int e, int nl, int len, bool contiguous,
                                      int* j, int* k) {
  if (contiguous) {
    *j = e / len;
    *k = e - *j * len;
  } else {
    *k = e / nl;
    *j = e - *k * nl;
  }
}

template <int MODE>
__global__ void fft_lines(const void* in, void* out, const float2* tw, int N,
                          int logN, int64_t inner, int64_t n_lines, int L,
                          int inverse, float scale) {
  extern __shared__ float2 s[];
  const int64_t line0 = static_cast<int64_t>(blockIdx.x) * L;
  const int nl = static_cast<int>(min64(L, n_lines - line0));
  const int Nh = N / 2 + 1;
  const bool contiguous = inner == 1;

  for (int e = threadIdx.x; e < nl * N; e += blockDim.x) {
    int j, k;
    split(e, nl, N, contiguous, &j, &k);
    const int64_t l = line0 + j;
    float2 v;
    if (MODE == R2C) {
      v = make_float2(static_cast<const float*>(in)[l * N + k], 0.0f);
    } else if (MODE == C2R) {
      const float2* src = static_cast<const float2*>(in) + l * Nh;
      if (k < Nh) {
        v = src[k];
      } else {
        const float2 c = src[N - k];
        v = make_float2(c.x, -c.y);
      }
      if (k == 0 || k == N / 2) v.y = 0.0f;
    } else {
      const int64_t o = l / inner, i = l - o * inner;
      v = static_cast<const float2*>(in)[(o * N + k) * inner + i];
    }
    const int r = logN ? static_cast<int>(__brev(static_cast<unsigned>(k)) >>
                                          (32 - logN))
                       : 0;
    s[j * N + r] = v;
  }
  __syncthreads();

  const int half_n = N / 2;
  for (int lg = 1; lg <= logN; ++lg) {
    const int half = 1 << (lg - 1);
    const int step = N >> lg;
    for (int b = threadIdx.x; b < nl * half_n; b += blockDim.x) {
      const int j = b / half_n;
      const int r = b - j * half_n;
      const int grp = r / half, pos = r - grp * half;
      const int i1 = j * N + grp * 2 * half + pos, i2 = i1 + half;
      float2 w = tw[pos * step];
      if (inverse) w.y = -w.y;
      const float2 u = s[i1];
      const float2 v = cmul(s[i2], w);
      s[i1] = make_float2(u.x + v.x, u.y + v.y);
      s[i2] = make_float2(u.x - v.x, u.y - v.y);
    }
    __syncthreads();
  }

  const int kout = MODE == R2C ? Nh : N;
  for (int e = threadIdx.x; e < nl * kout; e += blockDim.x) {
    int j, k;
    split(e, nl, kout, contiguous, &j, &k);
    const int64_t l = line0 + j;
    const float2 v = s[j * N + k];
    if (MODE == C2R) {
      static_cast<float*>(out)[l * N + k] = v.x * scale;
    } else if (MODE == R2C) {
      static_cast<float2*>(out)[l * Nh + k] =
          make_float2(v.x * scale, v.y * scale);
    } else {
      const int64_t o = l / inner, i = l - o * inner;
      static_cast<float2*>(out)[(o * N + k) * inner + i] =
          make_float2(v.x * scale, v.y * scale);
    }
  }
}

template <int MODE>
cudaError_t launch(const void* in, void* out, const float2* tw, int N,
                   int logN, int64_t inner, int64_t n_lines, int inverse,
                   float scale, cudaStream_t s) {
  const int L = N < kLineElems ? kLineElems / N : 1;
  const size_t smem = static_cast<size_t>(L) * N * sizeof(float2);
  const int64_t blocks = (n_lines + L - 1) / L;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fft_lines<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  fft_lines<MODE><<<static_cast<unsigned int>(blocks), bst::kThreads, smem,
                    s>>>(in, out, tw, N, logN, inner, n_lines, L, inverse,
                         scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int bst_fft_pow2(const void* in, void* out, const void* twiddles,
                            int mode, int N, int64_t outer, int64_t inner,
                            int inverse, float scale, void* stream) {
  if (N < 1 || N > 8192 || (N & (N - 1)) || outer < 1 || inner < 1)
    return cudaErrorInvalidValue;
  if (mode != C2C && inner != 1) return cudaErrorInvalidValue;
  int logN = 0;
  while ((1 << logN) < N) ++logN;
  const float2* tw = static_cast<const float2*>(twiddles);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t n_lines = outer * inner;
  cudaError_t err;
  switch (mode) {
    case C2C:
      err = launch<C2C>(in, out, tw, N, logN, inner, n_lines, inverse, scale, s);
      break;
    case R2C:
      err = launch<R2C>(in, out, tw, N, logN, inner, n_lines, 0, scale, s);
      break;
    case C2R:
      err = launch<C2R>(in, out, tw, N, logN, inner, n_lines, 1, scale, s);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
