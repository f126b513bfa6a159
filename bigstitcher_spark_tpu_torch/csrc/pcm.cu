// K7, K9, K10: the non-FFT steps of pcm_peaks / pcm_peaks_batch
// (bigstitcher_spark_tpu/ops/phasecorr.py:68, :104), over a batch of B pairs
// of (X, Y, Z) crops, z contiguous. K8 (fft.cu) does the transforms between
// them. Every reduction has a fixed order, so results do not change from
// run to run.
//
// K7 pcm_window (_windowed, :47): x (B, X, Y, Z) uint16 or float32 ->
//   float32 (x - mean) * mx[i] * my[j] * mz[k]. Pass 1: each of `parts`
//   blocks per pair sums a contiguous chunk in float64 (a tree in shared
//   memory). Pass 2: every block first reduces its pair's partial sums in
//   the same order, mean = float(sum) / max(float product of the extents, 1),
//   then writes its voxels. The fade masks (B, X+Y+Z) come from the
//   wrapper's torch function, which the plain twin reads too. Bound: bytes
//   (x read twice here, once by the bound; out written once).
//
// K9 pcm_cross_power (:85-90): fa, fb (B, X, Y, Zh) complex64 -> norm.
//   cross = fa * conj(fb) with every product rounded on its own, mag =
//   hypotf(re, im) (overflow-safe: |cross| of large crops passes 1e19, whose
//   square would overflow float32), per-pair max by a partial pass and an
//   in-block reduction of the partials (a max is exact in any order), then
//   norm = cross / max(mag, 1e-30) where mag > 1e-5 * max, else 0. Zh =
//   Z/2+1 is not a power of two: the spectra are indexed flat. Bound: bytes
//   (both spectra read twice here, once by the bound).
//
// K10 pcm_peaks_topk (_local_maxima :33 + lax.top_k :95): pcm (B, X, Y, Z)
//   float32 -> (B, n, 3) int32. Pass 1: a block takes 2048 voxels of one
//   pair; a voxel that is >= its 27 periodic neighbours keeps its value,
//   any other becomes -inf; each voxel's key is (value descending, flat
//   index ascending) in 64 bits, the block sorts its 2048 keys (bitonic, in
//   shared memory) and writes its first n. Pass 2: one block per pair
//   merges the candidates (keeps the first n of its running list plus the
//   next chunk, sorted again) and writes the first n as (x, y, z). This is
//   lax.top_k's order, -inf entries of non-maxima by ascending index
//   included, and each tile's first n keys hold every key the pair's first
//   n can take. n <= 256. Bound: bytes (the PCM read once); the sorts make
//   it operation-heavy beside that.
#include "fusion_common.cuh"

namespace {

constexpr int kTopkTile = 2048;   // voxels a K10 pass-1 block sorts
constexpr int kMergeKeys = 2048;  // keys a K10 pass-2 block sorts at once

__host__ __device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

// the block reduction trees below assume this many threads
static_assert(bst::kThreads == 256, "reductions are written for 256 threads");

template <typename T>
__device__ __forceinline__ T block_tree(T v, T* sh, bool is_max) {
  sh[threadIdx.x] = v;
  __syncthreads();
  for (int w = bst::kThreads / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) {
      const T o = sh[threadIdx.x + w];
      sh[threadIdx.x] = is_max ? (o > sh[threadIdx.x] ? o : sh[threadIdx.x])
                               : sh[threadIdx.x] + o;
    }
    __syncthreads();
  }
  const T r = sh[0];
  __syncthreads();
  return r;
}

// ----------------------------------------------------------------- K7

template <typename T>
__global__ void window_sum_kernel(const T* __restrict__ x, int64_t n,
                                  int parts, double* __restrict__ partial) {
  __shared__ double sh[bst::kThreads];
  const int b = blockIdx.y, p = blockIdx.x;
  const int64_t chunk = (n + parts - 1) / parts;
  const int64_t lo = p * chunk, hi = min64(n, lo + chunk);
  const T* src = x + b * n;
  double acc = 0.0;
  for (int64_t i = lo + threadIdx.x; i < hi; i += blockDim.x)
    acc += static_cast<double>(src[i]);
  acc = block_tree(acc, sh, false);
  if (threadIdx.x == 0) partial[static_cast<int64_t>(b) * parts + p] = acc;
}

template <typename T>
__global__ void window_kernel(const T* __restrict__ x, int X, int Y, int Z,
                              const int* __restrict__ ext,
                              const float* __restrict__ masks, int parts,
                              const double* __restrict__ partial,
                              float* __restrict__ out) {
  __shared__ double sh[bst::kThreads];
  const int b = blockIdx.y;
  double acc = 0.0;
  for (int p = threadIdx.x; p < parts; p += blockDim.x)
    acc += partial[static_cast<int64_t>(b) * parts + p];
  acc = block_tree(acc, sh, false);
  const float cnt = fmaxf(static_cast<float>(ext[3 * b]) *
                              static_cast<float>(ext[3 * b + 1]) *
                              static_cast<float>(ext[3 * b + 2]),
                          1.0f);
  const float mean = static_cast<float>(acc) / cnt;
  const int64_t n = static_cast<int64_t>(X) * Y * Z;
  const float* mx = masks + static_cast<int64_t>(b) * (X + Y + Z);
  const float* my = mx + X;
  const float* mz = my + Y;
  const T* src = x + b * n;
  float* dst = out + b * n;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int k = static_cast<int>(i % Z);
    const int64_t r = i / Z;
    const int j = static_cast<int>(r % Y);
    const int ii = static_cast<int>(r / Y);
    const float w = mx[ii] * my[j] * mz[k];
    dst[i] = (static_cast<float>(src[i]) - mean) * w;
  }
}

// ----------------------------------------------------------------- K9

__device__ __forceinline__ void cross_at(const float2* fa, const float2* fb,
                                         int64_t i, float* re, float* im) {
  const float2 a = fa[i], c = fb[i];
  *re = a.x * c.x + a.y * c.y;
  *im = a.y * c.x - a.x * c.y;
}

__global__ void cross_max_kernel(const float2* __restrict__ fa,
                                 const float2* __restrict__ fb, int64_t m,
                                 int parts, float* __restrict__ partial) {
  __shared__ float sh[bst::kThreads];
  const int b = blockIdx.y, p = blockIdx.x;
  const int64_t chunk = (m + parts - 1) / parts;
  const int64_t lo = p * chunk, hi = min64(m, lo + chunk);
  const float2* A = fa + b * m;
  const float2* Bp = fb + b * m;
  float mx = 0.0f;
  for (int64_t i = lo + threadIdx.x; i < hi; i += blockDim.x) {
    float re, im;
    cross_at(A, Bp, i, &re, &im);
    mx = fmaxf(mx, hypotf(re, im));
  }
  mx = block_tree(mx, sh, true);
  if (threadIdx.x == 0) partial[static_cast<int64_t>(b) * parts + p] = mx;
}

__global__ void cross_norm_kernel(const float2* __restrict__ fa,
                                  const float2* __restrict__ fb, int64_t m,
                                  int parts, const float* __restrict__ partial,
                                  float2* __restrict__ out) {
  __shared__ float sh[bst::kThreads];
  const int b = blockIdx.y;
  float mx = 0.0f;
  for (int p = threadIdx.x; p < parts; p += blockDim.x)
    mx = fmaxf(mx, partial[static_cast<int64_t>(b) * parts + p]);
  mx = block_tree(mx, sh, true);
  const float thr = mx * 1e-5f;
  const float2* A = fa + b * m;
  const float2* Bp = fb + b * m;
  float2* dst = out + b * m;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < m; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    float re, im;
    cross_at(A, Bp, i, &re, &im);
    const float mag = hypotf(re, im);
    const float den = fmaxf(mag, 1e-30f);
    dst[i] = mag > thr ? make_float2(re / den, im / den)
                       : make_float2(0.0f, 0.0f);
  }
}

// ----------------------------------------------------------------- K10

// order-preserving map of a float to 32 bits (-0 taken as +0), inverted so
// that ascending keys run from the largest value down
__device__ __forceinline__ uint64_t topk_key(float v, uint32_t idx) {
  if (v == 0.0f) v = 0.0f;
  const uint32_t u = __float_as_uint(v);
  const uint32_t ord = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<uint64_t>(~ord) << 32) | idx;
}

__device__ void bitonic_sort(uint64_t* s, int n) {
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const uint64_t a = s[i], c = s[ixj];
          if ((a > c) == ((i & k) == 0)) {
            s[i] = c;
            s[ixj] = a;
          }
        }
      }
      __syncthreads();
    }
  }
}

__global__ void topk_candidates_kernel(const float* __restrict__ pcm, int X,
                                       int Y, int Z, int n_peaks, int tiles,
                                       uint64_t* __restrict__ cand) {
  __shared__ uint64_t s[kTopkTile];
  const int b = blockIdx.y, t = blockIdx.x;
  const int64_t n = static_cast<int64_t>(X) * Y * Z;
  const float* P = pcm + b * n;
  const int64_t base = static_cast<int64_t>(t) * kTopkTile;
  for (int e = threadIdx.x; e < kTopkTile; e += blockDim.x) {
    const int64_t idx = base + e;
    if (idx >= n) {
      s[e] = ~0ull;
      continue;
    }
    const int k = static_cast<int>(idx % Z);
    const int j = static_cast<int>((idx / Z) % Y);
    const int i = static_cast<int>(idx / (static_cast<int64_t>(Y) * Z));
    const float v = P[idx];
    float mx = v;
    for (int dx = -1; dx <= 1; ++dx) {
      const int64_t xi = (i + dx + X) % X;
      for (int dy = -1; dy <= 1; ++dy) {
        const int64_t row = (xi * Y + (j + dy + Y) % Y) * Z;
        for (int dz = -1; dz <= 1; ++dz)
          mx = fmaxf(mx, P[row + (k + dz + Z) % Z]);
      }
    }
    s[e] = topk_key(v >= mx ? v : -INFINITY, static_cast<uint32_t>(idx));
  }
  __syncthreads();
  bitonic_sort(s, kTopkTile);
  uint64_t* dst = cand + (static_cast<int64_t>(b) * tiles + t) * n_peaks;
  for (int e = threadIdx.x; e < n_peaks; e += blockDim.x) dst[e] = s[e];
}

__global__ void topk_merge_kernel(const uint64_t* __restrict__ cand,
                                  int64_t n_cand, int n_peaks, int Y, int Z,
                                  int* __restrict__ out) {
  __shared__ uint64_t s[kMergeKeys];
  const int b = blockIdx.x;
  const uint64_t* src = cand + b * n_cand;
  for (int e = threadIdx.x; e < n_peaks; e += blockDim.x) s[e] = ~0ull;
  const int room = kMergeKeys - n_peaks;
  for (int64_t c0 = 0; c0 < n_cand; c0 += room) {
    for (int e = threadIdx.x; e < room; e += blockDim.x)
      s[n_peaks + e] = c0 + e < n_cand ? src[c0 + e] : ~0ull;
    __syncthreads();
    bitonic_sort(s, kMergeKeys);
  }
  for (int e = threadIdx.x; e < n_peaks; e += blockDim.x) {
    const int64_t idx = static_cast<int64_t>(s[e] & 0xffffffffu);
    int* o = out + (static_cast<int64_t>(b) * n_peaks + e) * 3;
    o[0] = static_cast<int>(idx / (static_cast<int64_t>(Y) * Z));
    o[1] = static_cast<int>((idx / Z) % Y);
    o[2] = static_cast<int>(idx % Z);
  }
}

// blocks of a grid-stride elementwise pass over n values of each pair
unsigned int pass_blocks(int64_t n) {
  const int64_t b = min64(1024, (n + bst::kThreads * 4 - 1) / (bst::kThreads * 4));
  return static_cast<unsigned int>(b < 1 ? 1 : b);
}

}  // namespace

extern "C" int bst_pcm_window(const void* x, int in_dtype, int B, int X,
                              int Y, int Z, const int* ext, const float* masks,
                              int parts, double* partial, float* out,
                              void* stream) {
  if (B < 1 || X < 1 || Y < 1 || Z < 1 || parts < 1 || parts > 65535 ||
      B > 65535)
    return cudaErrorInvalidValue;
  const int64_t n = static_cast<int64_t>(X) * Y * Z;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (in_dtype) {
    case bst::IN_U16:
      window_sum_kernel<uint16_t><<<dim3(parts, B), bst::kThreads, 0, s>>>(
          static_cast<const uint16_t*>(x), n, parts, partial);
      window_kernel<uint16_t><<<dim3(pass_blocks(n), B), bst::kThreads, 0, s>>>(
          static_cast<const uint16_t*>(x), X, Y, Z, ext, masks, parts, partial,
          out);
      break;
    case bst::IN_F32:
      window_sum_kernel<float><<<dim3(parts, B), bst::kThreads, 0, s>>>(
          static_cast<const float*>(x), n, parts, partial);
      window_kernel<float><<<dim3(pass_blocks(n), B), bst::kThreads, 0, s>>>(
          static_cast<const float*>(x), X, Y, Z, ext, masks, parts, partial,
          out);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bst_pcm_cross_power(const void* fa, const void* fb, int B,
                                   int64_t m, int parts, float* partial,
                                   void* out, void* stream) {
  if (B < 1 || B > 65535 || m < 1 || parts < 1 || parts > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float2* A = static_cast<const float2*>(fa);
  const float2* Bp = static_cast<const float2*>(fb);
  cross_max_kernel<<<dim3(parts, B), bst::kThreads, 0, s>>>(A, Bp, m, parts,
                                                             partial);
  cross_norm_kernel<<<dim3(pass_blocks(m), B), bst::kThreads, 0, s>>>(
      A, Bp, m, parts, partial, static_cast<float2*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bst_pcm_peaks_topk(const float* pcm, int B, int X, int Y,
                                  int Z, int n_peaks, int tiles,
                                  uint64_t* cand, int* out, void* stream) {
  const int64_t n = static_cast<int64_t>(X) * Y * Z;
  if (B < 1 || B > 65535 || X < 1 || Y < 1 || Z < 1 || n > 2147483647LL ||
      n_peaks < 1 || n_peaks > 256 || n_peaks > n ||
      tiles != (n + kTopkTile - 1) / kTopkTile)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  topk_candidates_kernel<<<dim3(tiles, B), bst::kThreads, 0, s>>>(
      pcm, X, Y, Z, n_peaks, tiles, cand);
  topk_merge_kernel<<<B, 1024, 0, s>>>(
      cand, static_cast<int64_t>(tiles) * n_peaks, n_peaks, Y, Z, out);
  return static_cast<int>(cudaGetLastError());
}
