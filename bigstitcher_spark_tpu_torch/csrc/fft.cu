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
//   two, so exact). Lengths 1 to 8192; the wrapper raises beyond that.
//
// Bound: bytes. A pass reads and writes every line once; its ~2.5 N log2 N
// float operations a real line are far below the card's rate. At the
// stitching bucket (2, 64, 512, 128) the six passes move ~408 MB, and the
// spectrum (34 MB) mostly stays in the 50 MB L2 between passes.
//
// Design: each pass is one trip through device memory, coalesced, with the
// butterflies in registers.
//   * Stockham autosort, radix 8 in registers. A line of M complex values
//     is held by T = M / 8 threads, 8 values each (thread t holds elements
//     t + s T). A radix-R stage (R = 8 while it fits, then one stage of 2
//     or 4 for the rest of log2 M) is 8 / R butterflies a thread, each a
//     twiddle multiply and an R-point DFT in registers (its own twiddles are
//     constants); its outputs go to the line's row in shared memory at the
//     autosorted position, and the next stage reads elements t + s T back.
//     So a line takes ceil(log8 M) - 1 exchanges (2 at N = 512), no
//     bit-reversal pass, and the first stage reads device memory while the
//     last one writes it. Rows are padded (one float2 every 16 elements, an
//     odd row stride) so strided stores and neighbouring rows do not share
//     banks. Threads are held to 64 registers, so two 512-thread blocks (or
//     four of 256) share an SM and one block's loads overlap another's
//     butterflies (radix 16 needed 128 registers, one block an SM, and ran
//     the passes slower).
//   * Real lines through a half-length complex transform. R2C packs each
//     (even, odd) sample pair as one of N/2 complex values (one float2
//     load), transforms, and splits X[k] = E[k] + w^k O[k] with E, O from
//     Z[k] and conj(Z[N/2 - k]), w = exp(-2 pi i / N). C2R merges Z[k] =
//     (X[k] + conj(X[N/2 - k])) + i w^-k (X[k] - conj(X[N/2 - k])) and runs
//     the inverse of length N/2, whose real and imaginary parts are the
//     even and odd samples. Half the arithmetic and shared memory of a
//     length-N complex line.
//   * Strided passes read whole sectors: along an inner axis a block takes
//     L = 16 neighbouring lines up to M = 512 (then as many as 1024
//     threads hold: 8 at M = 1024 down to 1 at 8192), the threads of a warp
//     on neighbouring lines, so each load and store is a row of 16 float2
//     (128 bytes; whole 32-byte sectors up to M = 2048). Along a contiguous
//     axis a line's threads are neighbours. Dynamic shared memory, up to
//     70 KB a block. (16 lines of 1024 need 16 values a thread in 1024
//     threads: at 64 registers those spilled and ran the pass slower, with
//     radix 8 or radix 4 butterflies.)
//   Twiddles exp(-2 pi i m / N), m < N/2, come from the wrapper's table
//   (float64 rounded to complex64) through the read-only path, negated
//   for m >= N/2; an inverse conjugates its input and output around the
//   forward transform (exact).
#include "fusion_common.cuh"

#include <limits.h>

namespace {

enum FftMode : int { C2C = 0, R2C = 1, C2R = 2 };

constexpr int kE = 8;               // complex values a thread holds
constexpr int kTargetThreads = 256;
constexpr int kBigThreads = 1024;   // the most threads a block
constexpr int kSmallThreads = 512;  // blocks above this take the big form
constexpr int kInnerLines = 16;     // lines a block along an inner axis
constexpr int kRegs = 64;           // registers a thread at most

__host__ __device__ constexpr int ilog2(int v) {
  return v <= 1 ? 0 : 1 + ilog2(v / 2);
}

// i's lowest `bits` (<= 3) bits reversed
__host__ __device__ constexpr int brev(int i, int bits) {
  return (((i & 1) << 2) | (i & 2) | ((i & 4) >> 2)) >> (3 - bits);
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ float2 conj2(float2 a) {
  return make_float2(a.x, -a.y);
}

__device__ __forceinline__ float2 cscale(float2 a, float s) {
  return make_float2(a.x * s, a.y * s);
}

// z exp(-2 pi i k / 8), k in 0..3 (a constant once the DFT is unrolled)
__device__ __forceinline__ float2 rot8(float2 z, int k) {
  constexpr float h = 0.70710678118654752f;  // sqrt(1/2)
  switch (k) {
    case 0: return z;
    case 1: return make_float2((z.x + z.y) * h, (z.y - z.x) * h);
    case 2: return make_float2(z.y, -z.x);
    default: return make_float2((z.y - z.x) * h, -(z.x + z.y) * h);
  }
}

// Forward R-point DFT in registers: radix-2 decimation in frequency, then
// the bit-reversed outputs renamed into natural order.
template <int R>
__device__ __forceinline__ void dft(float2 (&v)[R]) {
  constexpr int LR = ilog2(R);
#pragma unroll
  for (int lev = 0; lev < LR; ++lev) {
    const int h = R >> (lev + 1);
#pragma unroll
    for (int i = 0; i < R / 2; ++i) {
      const int n = i % h, b = (i / h) * 2 * h;
      const float2 a = v[b + n], c = v[b + n + h];
      v[b + n] = cadd(a, c);
      v[b + n + h] = rot8(csub(a, c), n * (4 / h));
    }
  }
  float2 o[R];
#pragma unroll
  for (int i = 0; i < R; ++i) o[brev(i, LR)] = v[i];
#pragma unroll
  for (int i = 0; i < R; ++i) v[i] = o[i];
}

// exp(-2 pi i m / N), 0 <= m < N, from the table of m < N/2
__device__ __forceinline__ float2 twiddle(const float2* __restrict__ tw, int m,
                                          int half_n) {
  if (m < half_n) return __ldg(tw + m);
  const float2 w = __ldg(tw + (m - half_n));
  return make_float2(-w.x, -w.y);
}

// a line row's padded index: one float2 of padding every 16
__device__ __forceinline__ int pad(int e) { return e + (e >> 4); }

__host__ __device__ __forceinline__ int row_stride(int M) {
  return M + (M >> 4) + 1;
}

// One radix-R Stockham stage on the E values a thread holds (x[s] is
// element t + s T of its line of M = T E): butterflies j = t + q T, q <
// E / R, each on elements j + r M / R = x[q + (E / R) r], twiddled by
// W^(r (j mod Ns) M / (Ns R)) with W = exp(-2 pi i / M), Ns the product of
// the earlier radices. Output r of butterfly j is element (j / Ns) Ns R +
// (j mod Ns) + r Ns: written to the line's shared row, or, in the last
// stage (Ns R = M), element j + r M / R, i.e. back into x[q + (E / R) r].
template <int R, int E>
__device__ __forceinline__ void stage(float2 (&x)[E], int t, int T, int logM,
                                      int logNs, const float2* __restrict__ tw,
                                      int tw_shift, int half_n, float2* row,
                                      bool last) {
  constexpr int Q = E / R;
  constexpr int LR = ilog2(R);
  const int ns_mask = (1 << logNs) - 1;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int j = t + q * T;
    const int k = j & ns_mask;
    float2 v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = x[q + Q * r];
    if (logNs > 0) {
      const int sh = logM - logNs - LR + tw_shift;
#pragma unroll
      for (int r = 1; r < R; ++r)
        v[r] = cmul(v[r], twiddle(tw, (r * k) << sh, half_n));
    }
    dft<R>(v);
    if (last) {
#pragma unroll
      for (int r = 0; r < R; ++r) x[q + Q * r] = v[r];
    } else {
      const int d = ((j >> logNs) << (logNs + LR)) + k;
#pragma unroll
      for (int r = 0; r < R; ++r) row[pad(d + (r << logNs))] = v[r];
    }
  }
}

template <int E>
__device__ __forceinline__ void any_stage(int R, float2 (&x)[E], int t, int T,
                                          int logM, int logNs,
                                          const float2* __restrict__ tw,
                                          int tw_shift, int half_n,
                                          float2* row, bool last) {
  switch (R) {
    case 8:
      if constexpr (E >= 8)
        stage<8, E>(x, t, T, logM, logNs, tw, tw_shift, half_n, row, last);
      break;
    case 4:
      if constexpr (E >= 4)
        stage<4, E>(x, t, T, logM, logNs, tw, tw_shift, half_n, row, last);
      break;
    case 2:
      if constexpr (E >= 2)
        stage<2, E>(x, t, T, logM, logNs, tw, tw_shift, half_n, row, last);
      break;
    default:
      break;
  }
}

// blocks of MAXT threads an SM must hold at kRegs registers a thread
constexpr int min_blocks(int maxt) {
  return 65536 / (maxt * kRegs) > 1 ? 65536 / (maxt * kRegs) : 1;
}

// L lines a block of a complex transform of length M = T E (M = N for
// C2C, N / 2 for R2C and C2R, N >= 2). lines_fast: thread = t L + l (the
// lines of an inner axis side by side in a warp), else l T + t.
template <int MODE, int E, int MAXT>
__global__ void __launch_bounds__(MAXT, min_blocks(MAXT))
fft_lines(const void* in, void* out, const float2* __restrict__ tw, int N,
          int M, int logM, int64_t inner, int64_t n_lines, int L,
          int lines_fast, int inverse, float scale) {
  extern __shared__ float2 sbuf[];
  const int T = M / E;
  int l, t;
  if (lines_fast) {
    l = threadIdx.x % L;
    t = threadIdx.x / L;
  } else {
    t = threadIdx.x % T;
    l = threadIdx.x / T;
  }
  const int64_t gl = static_cast<int64_t>(blockIdx.x) * L + l;
  const bool live = gl < n_lines;
  float2* row = sbuf + l * row_stride(M);
  const int half_n = N >> 1;
  const float2 zero = make_float2(0.0f, 0.0f);
  float2 x[E];

  // C2C: element e of line gl = (o, i) sits at (o N + e) inner + i
  int64_t base = 0;
  if (MODE == C2C && live) {
    const int64_t o = gl / inner, i = gl - o * inner;
    base = o * N * inner + i;
  }
  if (MODE == C2C) {
    const float2* src = static_cast<const float2*>(in);
#pragma unroll
    for (int s = 0; s < E; ++s) {
      const float2 v = live ? src[base + (t + s * T) * inner] : zero;
      x[s] = inverse ? conj2(v) : v;
    }
  } else if (MODE == R2C) {
    // the (even, odd) sample pairs of the real line as M complex values
    const float2* src = static_cast<const float2*>(in) + (live ? gl * M : 0);
#pragma unroll
    for (int s = 0; s < E; ++s) x[s] = live ? src[t + s * T] : zero;
  } else {
    // merge: Z[k] = Fe + i Fo, Fe = X[k] + conj(X[M - k]),
    // Fo = (X[k] - conj(X[M - k])) exp(+2 pi i k / N); conjugated for the
    // inverse through the forward transform
    const float2* src =
        static_cast<const float2*>(in) + (live ? gl * (M + 1) : 0);
#pragma unroll
    for (int s = 0; s < E; ++s) {
      const int k = t + s * T;
      float2 a = live ? src[k] : zero, b = live ? src[M - k] : zero;
      if (k == 0) {
        a.y = 0.0f;
        b.y = 0.0f;
      }
      const float2 fe = make_float2(a.x + b.x, a.y - b.y);
      const float2 fo =
          cmul(make_float2(a.x - b.x, a.y + b.y), conj2(__ldg(tw + k)));
      x[s] = make_float2(fe.x - fo.y, -(fe.y + fo.x));
    }
  }

  constexpr int LE = ilog2(E);
  const int n_full = LE ? logM / LE : 0, rem = LE ? logM % LE : 0;
  const int n_stages = n_full + (rem ? 1 : 0);
  const int tw_shift = MODE == C2C ? 0 : 1;
  int logNs = 0;
  for (int st = 0; st < n_stages; ++st) {
    if (st > 0) {
      __syncthreads();
#pragma unroll
      for (int s = 0; s < E; ++s) x[s] = row[pad(t + s * T)];
      __syncthreads();
    }
    const int lr = st < n_full ? LE : rem;
    any_stage<E>(1 << lr, x, t, T, logM, logNs, tw, tw_shift, half_n, row,
                 st == n_stages - 1);
    logNs += lr;
  }

  if (MODE == C2C) {
    if (!live) return;
    float2* dst = static_cast<float2*>(out);
#pragma unroll
    for (int s = 0; s < E; ++s) {
      const float2 v = inverse ? conj2(x[s]) : x[s];
      dst[base + (t + s * T) * inner] = cscale(v, scale);
    }
  } else if (MODE == C2R) {
    if (!live) return;
    float2* dst = static_cast<float2*>(out) + gl * M;
#pragma unroll
    for (int s = 0; s < E; ++s) dst[t + s * T] = cscale(conj2(x[s]), scale);
  } else {
    // split: E[k] = (Z[k] + conj(Z[M - k])) / 2,
    // O[k] = (Z[k] - conj(Z[M - k])) / 2i, X[k] = E[k] + w^k O[k], X[M] =
    // E[0] - O[0]; every thread read its row before the last stage
#pragma unroll
    for (int s = 0; s < E; ++s) row[pad(t + s * T)] = x[s];
    __syncthreads();
    if (!live) return;
    float2* dst = static_cast<float2*>(out) + gl * (M + 1);
#pragma unroll
    for (int s = 0; s < E; ++s) {
      const int k = t + s * T;
      const float2 a = x[s], b = row[pad((M - k) & (M - 1))];
      const float2 e = make_float2((a.x + b.x) * 0.5f, (a.y - b.y) * 0.5f);
      const float2 o = make_float2((a.y + b.y) * 0.5f, (b.x - a.x) * 0.5f);
      dst[k] = cscale(cadd(e, cmul(__ldg(tw + k), o)), scale);
      if (k == 0) dst[M] = cscale(csub(e, o), scale);
    }
  }
}

// N = 1: the transform is the identity (R2C: imaginary part 0; C2R: the
// real part)
template <int MODE>
__global__ void fft_len1(const void* in, void* out, int64_t n_lines,
                         float scale) {
  const int64_t l = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (l >= n_lines) return;
  if (MODE == R2C) {
    static_cast<float2*>(out)[l] =
        make_float2(static_cast<const float*>(in)[l] * scale, 0.0f);
  } else if (MODE == C2R) {
    static_cast<float*>(out)[l] = static_cast<const float2*>(in)[l].x * scale;
  } else {
    static_cast<float2*>(out)[l] =
        cscale(static_cast<const float2*>(in)[l], scale);
  }
}

struct Plan {
  int M, logM, E, T, L, lines_fast;
};

// Lines a block: ~256 threads; along an inner axis 16 lines, or as many as
// 1024 threads hold
Plan plan_for(int mode, int N, int64_t inner, int64_t n_lines) {
  Plan p;
  p.M = mode == C2C ? N : N / 2;
  p.logM = ilog2(p.M);
  p.E = p.M < kE ? p.M : kE;
  p.T = p.M / p.E;
  p.lines_fast = inner > 1;
  int L = kTargetThreads / p.T;
  if (L < 1) L = 1;
  if (p.lines_fast && L < kInnerLines) L = kInnerLines;
  if (L > kBigThreads / p.T) L = kBigThreads / p.T;
  if (L > n_lines) L = static_cast<int>(n_lines);
  p.L = L;
  return p;
}

template <int MODE, int E, int MAXT>
cudaError_t launch_lines(const void* in, void* out, const float2* tw, int N,
                         const Plan& p, int64_t inner, int64_t n_lines,
                         int inverse, float scale, cudaStream_t s) {
  const size_t smem =
      static_cast<size_t>(p.L) * row_stride(p.M) * sizeof(float2);
  const int64_t blocks = (n_lines + p.L - 1) / p.L;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fft_lines<MODE, E, MAXT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  fft_lines<MODE, E, MAXT>
      <<<static_cast<unsigned int>(blocks), p.L * p.T, smem, s>>>(
          in, out, tw, N, p.M, p.logM, inner, n_lines, p.L, p.lines_fast,
          inverse, scale);
  return cudaGetLastError();
}

// the kernel whose launch bound holds the plan's threads
template <int MODE, int E>
cudaError_t launch_e(const void* in, void* out, const float2* tw, int N,
                     const Plan& p, int64_t inner, int64_t n_lines,
                     int inverse, float scale, cudaStream_t s) {
  if constexpr (E >= 4) {
    if (p.L * p.T > kSmallThreads)
      return launch_lines<MODE, E, kBigThreads>(in, out, tw, N, p, inner,
                                                n_lines, inverse, scale, s);
  }
  return launch_lines<MODE, E, kSmallThreads>(in, out, tw, N, p, inner,
                                              n_lines, inverse, scale, s);
}

template <int MODE>
cudaError_t launch(const void* in, void* out, const float2* tw, int N,
                   int64_t inner, int64_t n_lines, int inverse, float scale,
                   cudaStream_t s) {
  if (N == 1) {
    const int64_t blocks = (n_lines + bst::kThreads - 1) / bst::kThreads;
    if (blocks > INT_MAX) return cudaErrorInvalidValue;
    fft_len1<MODE><<<static_cast<unsigned int>(blocks), bst::kThreads, 0,
                     s>>>(in, out, n_lines, scale);
    return cudaGetLastError();
  }
  const Plan p = plan_for(MODE, N, inner, n_lines);
  switch (p.E) {
    case 1:
      return launch_e<MODE, 1>(in, out, tw, N, p, inner, n_lines, inverse,
                               scale, s);
    case 2:
      return launch_e<MODE, 2>(in, out, tw, N, p, inner, n_lines, inverse,
                               scale, s);
    case 4:
      return launch_e<MODE, 4>(in, out, tw, N, p, inner, n_lines, inverse,
                               scale, s);
    default:
      return launch_e<MODE, 8>(in, out, tw, N, p, inner, n_lines, inverse,
                               scale, s);
  }
}

}  // namespace

extern "C" int bst_fft_pow2(const void* in, void* out, const void* twiddles,
                            int mode, int N, int64_t outer, int64_t inner,
                            int inverse, float scale, void* stream) {
  if (N < 1 || N > 8192 || (N & (N - 1)) || outer < 1 || inner < 1)
    return cudaErrorInvalidValue;
  if (mode != C2C && inner != 1) return cudaErrorInvalidValue;
  // R2C reads, and C2R writes, sample pairs as float2
  if ((reinterpret_cast<uintptr_t>(in) | reinterpret_cast<uintptr_t>(out)) %
      sizeof(float2))
    return cudaErrorMisalignedAddress;
  const float2* tw = static_cast<const float2*>(twiddles);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t n_lines = outer * inner;
  cudaError_t err;
  switch (mode) {
    case C2C:
      err = launch<C2C>(in, out, tw, N, inner, n_lines, inverse, scale, s);
      break;
    case R2C:
      err = launch<R2C>(in, out, tw, N, inner, n_lines, 0, scale, s);
      break;
    case C2R:
      err = launch<C2R>(in, out, tw, N, inner, n_lines, 1, scale, s);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
