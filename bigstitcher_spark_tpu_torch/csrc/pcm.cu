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
//   float32 -> (B, n, 3) int32, n <= 256, in one launch. A voxel that is
//   >= its 27 periodic neighbours keeps its value, any other becomes -inf;
//   its key is (value descending, flat index ascending) in 64 bits, and the
//   answer is the n smallest keys in order: lax.top_k's order, -inf
//   entries of non-maxima by ascending index included. Bound: bytes (the
//   PCM read once, 0.0100 ms at phase 1's bucket, 2 x 64 x 512 x 128).
//   The first form took two kernels: a block a 2048-voxel tile doing 27
//   loads a voxel, each index wrapped by %, and a bitonic sort of all 2048
//   keys, then one block a pair merging the tiles' candidates by sorting
//   2048 keys again and again (0.6577 ms at that bucket: 65 x its bound).
//   Now one launch over ops/phasecorr.py peaks_plan's grid, a few blocks a
//   pair that the card holds at once, and it selects instead of sorting. A
//   warp marches a unit, 4 y rows x 32 z lanes, along a chunk of x planes,
//   several planes in flight, and keeps its n best keys (of N = 32 J >= n,
//   sorted across its lanes' registers) behind a running threshold: its
//   own n-th key or the largest of the pair's n slots, where every key a
//   warp takes in goes by atomicMin to the slot of its flat index mod n. A
//   plane whose voxels all lie below the threshold's value
//   costs its loads, one compare a voxel and one ballot: no key can go in.
//   Else the warp takes the exact test there, the 3x3x3 periodic maximum
//   from the rows in registers, the rows beside them and the outer z
//   neighbours, and its keys go in one at a time or sorted and
//   bitonic-merged. A block merges its warps' lists into scratch; the last
//   block of a pair (a ticket) merges the pair's lists the same way and
//   writes the first n.
#include "fusion_common.cuh"
#include "reduce.cuh"

namespace {

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

constexpr int kPeakThreads = 256;
constexpr int kPeakWarps = kPeakThreads / 32;
constexpr int kPeakBlocksPerSm = 2;       // PEAKS_BLOCKS_PER_SM in the plan
constexpr int kPeakMaxN = 256;            // ops/phasecorr.py MAX_PEAKS
constexpr int kPeakRows = 4;                // y rows of a warp's unit
constexpr int kPeakAhead = 3;               // planes it has in flight
constexpr int kPeakRing = kPeakAhead + 3;   // planes it holds

// order-preserving map of a float to 32 bits (-0 taken as +0), inverted so
// that ascending keys run from the largest value down
__device__ __forceinline__ uint64_t topk_key(float v, uint32_t idx) {
  if (v == 0.0f) v = 0.0f;
  const uint32_t u = __float_as_uint(v);
  const uint32_t ord = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<uint64_t>(~ord) << 32) | idx;
}

__device__ __forceinline__ uint64_t min_u64(uint64_t a, uint64_t b) {
  return a < b ? a : b;
}

__device__ __forceinline__ uint64_t max_u64(uint64_t a, uint64_t b) {
  return a < b ? b : a;
}

// one key a lane, sorted ascending across the warp (a bitonic sort)
__device__ __forceinline__ uint64_t warp_sort(uint64_t x, int lane) {
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
    for (int d = k >> 1; d > 0; d >>= 1) {
      const uint64_t o = __shfl_xor_sync(0xffffffffu, x, d);
      x = (((lane & d) == 0) == ((lane & k) == 0)) ? min_u64(x, o)
                                                   : max_u64(x, o);
    }
  }
  return x;
}

// A warp's list of N = 32 J keys, entry 32 j + lane in a[j]: a bitonic
// sequence sorted ascending (the half-cleaners, first across a lane's
// registers, then across lanes).
template <int J>
__device__ __forceinline__ void bitonic_merge(uint64_t (&a)[J], int lane) {
#pragma unroll
  for (int d = J >> 1; d > 0; d >>= 1) {
#pragma unroll
    for (int j = 0; j < J; ++j) {
      if ((j & d) == 0) {
        const uint64_t lo = min_u64(a[j], a[j + d]);
        const uint64_t hi = max_u64(a[j], a[j + d]);
        a[j] = lo;
        a[j + d] = hi;
      }
    }
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const uint64_t o = __shfl_xor_sync(0xffffffffu, a[j], d);
      a[j] = (lane & d) ? max_u64(a[j], o) : min_u64(a[j], o);
    }
  }
}

// The list L (sorted) becomes the N smallest of L and the warp's keys c
// (one a lane, ~0 for none): c sorted, min(L[e], c'[N - 1 - e]) with c'
// padded by ~0 is bitonic and holds them, then merged.
template <int J>
__device__ __forceinline__ void add_candidates(uint64_t (&L)[J], uint64_t c,
                                               int lane) {
  c = warp_sort(c, lane);
  L[J - 1] = min_u64(L[J - 1], __shfl_sync(0xffffffffu, c, 31 - lane));
  bitonic_merge<J>(L, lane);
}

// The list L (sorted) with the one key x inserted in order (the last entry
// dropped): each entry keeps its key, or takes x or the entry before it.
template <int J>
__device__ __forceinline__ void insert_one(uint64_t (&L)[J], uint64_t x,
                                           int lane) {
  uint64_t carry = 0;  // entry 32 j - 1, for lane 0
#pragma unroll
  for (int j = 0; j < J; ++j) {
    uint64_t prev = __shfl_up_sync(0xffffffffu, L[j], 1);
    const uint64_t last = __shfl_sync(0xffffffffu, L[j], 31);
    const bool first = j == 0 && lane == 0;
    if (lane == 0) prev = carry;
    carry = last;
    L[j] = L[j] < x ? L[j] : ((first || prev < x) ? x : prev);
  }
}

// entry 32 jn + ln of the warp's list, in every lane
template <int J>
__device__ __forceinline__ uint64_t list_entry(const uint64_t (&L)[J], int jn,
                                               int ln) {
  uint64_t v = L[0];
#pragma unroll
  for (int j = 1; j < J; ++j)
    if (j == jn) v = L[j];
  return __shfl_sync(0xffffffffu, v, ln);
}

// A warp's n best keys behind a threshold: own, its list's n-th key, and
// gl, the pair's. A key below both goes in, one at a time when the warp
// has few, else sorted and merged, and also goes to the pair's slot of its
// flat index mod n (atomicMin). So the n slots hold n distinct keys of the
// pair once each has one, and their largest, read now and then into gl,
// has n keys at or below it: no key past it is among the pair's first n.
// Nor is a key past own, and a key leaves a list only for n better ones:
// so the lists keep the pair's first n keys. (The largest slot is about
// the pair's n ln(n)-th key so far, where a list's own n-th key saw one
// warp's data.) tv is the threshold's value: a voxel below it cannot go
// in. While the threshold is no finite value's key (~0, or a -inf key of
// the fill), all is set and every voxel is tested.
template <int J>
struct PeakList {
  uint64_t L[J];
  uint64_t own, gl;
  float tv;
  bool all;
  int n, jn, ln, lane;

  __device__ __forceinline__ void init(int n_, int lane_) {
#pragma unroll
    for (int j = 0; j < J; ++j) L[j] = ~0ull;
    own = gl = ~0ull;
    n = n_;
    jn = (n - 1) >> 5;
    ln = (n - 1) & 31;
    lane = lane_;
    refresh();
  }

  // tv and all from min(own, gl): the inverse of topk_key's value map
  __device__ __forceinline__ void refresh() {
    const uint32_t hi = static_cast<uint32_t>(min_u64(own, gl) >> 32);
    const uint32_t ord = ~hi;
    all = hi >= 0xff800000u;
    tv = __uint_as_float((ord & 0x80000000u) ? (ord & 0x7fffffffu) : ~ord);
  }

  __device__ __forceinline__ void lower(uint64_t g) {
    if (g < gl) {
      gl = g;
      refresh();
    }
  }

  // the largest of the pair's n slots, in every lane
  __device__ __forceinline__ uint64_t slots_max(
      const unsigned long long* slots) const {
    uint64_t t = 0;
#pragma unroll
    for (int j = 0; j < J; ++j)
      if (32 * j + lane < n) t = max_u64(t, __ldcg(slots + 32 * j + lane));
#pragma unroll
    for (int d = 16; d > 0; d >>= 1)
      t = max_u64(t, __shfl_xor_sync(0xffffffffu, t, d));
    return t;
  }

  // slots: the pair's n slots, or nullptr (the last block's merge)
  __device__ __forceinline__ void consider(uint64_t key,
                                           unsigned long long* slots) {
    const bool cand = key < min_u64(own, gl);
    unsigned bal = __ballot_sync(0xffffffffu, cand);
    if (bal == 0u) return;
    if (cand && slots != nullptr)
      atomicMin(slots + static_cast<uint32_t>(key) % static_cast<uint32_t>(n),
                static_cast<unsigned long long>(key));
    if (__popc(bal) > 2) {
      add_candidates<J>(L, cand ? key : ~0ull, lane);
    } else {
      do {
        const int src = __ffs(bal) - 1;
        bal &= bal - 1;
        insert_one<J>(L, __shfl_sync(0xffffffffu, key, src), lane);
      } while (bal);
    }
    own = list_entry<J>(L, jn, ln);
    refresh();
  }
};

// The block's eight warp lists merged into warp 0's, in three rounds: warp
// w + s hands its list to warp w through shared memory (buf: 4 N keys),
// which takes min(L[e], other[N - 1 - e]) and merges. Every thread calls
// it.
template <int J>
__device__ void block_merge(uint64_t (&L)[J], uint64_t* buf, int warp,
                            int lane) {
  constexpr int N = 32 * J;
#pragma unroll
  for (int s = 1; s < kPeakWarps; s <<= 1) {
    if ((warp & (2 * s - 1)) == s) {
      uint64_t* dst = buf + (warp / (2 * s)) * N;
#pragma unroll
      for (int j = 0; j < J; ++j) dst[32 * j + lane] = L[j];
    }
    __syncthreads();
    if ((warp & (2 * s - 1)) == 0) {
      const uint64_t* src = buf + (warp / (2 * s)) * N + N - 1 - lane;
#pragma unroll
      for (int j = 0; j < J; ++j) L[j] = min_u64(L[j], src[-32 * j]);
      bitonic_merge<J>(L, lane);
    }
    __syncthreads();
  }
}

__device__ __forceinline__ int wrap_index(int v, int n) {
  v %= n;
  return v < 0 ? v + n : v;
}

// A warp unit: kPeakRows rows y0.. of 32 z lanes z0.. of one pair, along a
// chunk of x planes x0..x1-1. Lane l holds z0 + l (periodic) of the rows
// (periodic) of planes x0 - 1..x1 (periodic), kPeakAhead planes in flight
// and the last three in registers. When plane p lands, plane p - 1 is
// tested: a voxel at or above the threshold's value (one ballot for the
// unit's rows) sends the warp to the exact test, its 27-voxel maximum from
// the three planes' rows, the two rows beside them and lanes 0 and 31's
// outer z neighbours (loaded then: the threshold soon passes nearly every
// voxel by; a plane's 3x3 maxima kept for the next test), and the rows'
// keys to the list.
struct PeakUnit {
  const float* V;
  int64_t YZ;
  int X, Z, x0, x1, zl, ze;
  int yoff[kPeakRows + 2];  // rows y0 - 1..y0 + kPeakRows, times Z
  uint32_t base;            // y0 Z + z0 + lane
  bool edge, ok[kPeakRows];
  int cq;                   // ma, mb: 3x3 maxima of planes cq - 1, cq
  float ma[kPeakRows], mb[kPeakRows];

  __device__ __forceinline__ const float* plane(int p) const {
    return V + (p < 0 ? p + X : (p >= X ? p - X : p)) * YZ;
  }

  __device__ __forceinline__ void load(int p, float (&v)[kPeakRows]) const {
    const float* src = plane(p) + zl;
#pragma unroll
    for (int i = 0; i < kPeakRows; ++i) v[i] = __ldg(src + yoff[i + 1]);
  }

  // m: each row's 3x3 maximum (periodic) in plane p, whose unit rows are
  // own
  __device__ __forceinline__ void plane_max(int p, const float (&own)[kPeakRows],
                                            float (&m)[kPeakRows],
                                            int lane) const {
    const float* src = plane(p);
    float row[kPeakRows + 2];
    row[0] = __ldg(src + yoff[0] + zl);
#pragma unroll
    for (int i = 0; i < kPeakRows; ++i) row[i + 1] = own[i];
    row[kPeakRows + 1] = __ldg(src + yoff[kPeakRows + 1] + zl);
    float z3[kPeakRows + 2];
#pragma unroll
    for (int r = 0; r < kPeakRows + 2; ++r) {
      float lo = __shfl_up_sync(0xffffffffu, row[r], 1);
      float hi = __shfl_down_sync(0xffffffffu, row[r], 1);
      const float e = edge ? __ldg(src + yoff[r] + ze) : 0.0f;
      if (lane == 0) lo = e;
      if (lane == 31) hi = e;
      z3[r] = fmaxf(fmaxf(lo, row[r]), hi);
    }
#pragma unroll
    for (int i = 0; i < kPeakRows; ++i)
      m[i] = fmaxf(fmaxf(z3[i], z3[i + 1]), z3[i + 2]);
  }

  // plane q's rows (mid) between planes q - 1 (prev) and q + 1 (next); the
  // 3x3 maxima of planes q - 1 and q are kept from the test before when it
  // was plane q - 1's (ma, mb of planes cq - 1, cq)
  template <int J>
  __device__ __forceinline__ void test(int q, const float (&prev)[kPeakRows],
                                       const float (&mid)[kPeakRows],
                                       const float (&next)[kPeakRows],
                                       PeakList<J>& pl,
                                       unsigned long long* slots) {
    bool pass = false;
#pragma unroll
    for (int i = 0; i < kPeakRows; ++i)
      pass |= ok[i] && (pl.all || mid[i] >= pl.tv);
    if (!__any_sync(0xffffffffu, pass)) return;
    if (cq != q) {
      plane_max(q - 1, prev, ma, pl.lane);
      plane_max(q, mid, mb, pl.lane);
    }
    float mc[kPeakRows], m[kPeakRows];
    plane_max(q + 1, next, mc, pl.lane);
#pragma unroll
    for (int i = 0; i < kPeakRows; ++i) {
      m[i] = fmaxf(fmaxf(ma[i], mb[i]), mc[i]);
      ma[i] = mb[i];
      mb[i] = mc[i];
    }
    cq = q + 1;
    const uint32_t qb = base + static_cast<uint32_t>(q * YZ);
#pragma unroll
    for (int i = 0; i < kPeakRows; ++i) {
      const uint64_t key =
          ok[i] ? topk_key(mid[i] >= m[i] ? mid[i] : -INFINITY,
                           qb + static_cast<uint32_t>(i * Z))
                : ~0ull;
      pl.consider(key, slots);
    }
  }
};

// P blocks a pair (gridDim.x) of eight warps; warp w of block q takes the
// pair's units 8 q + w, then 8 P further on, behind the pair's threshold
// (its slots read once every kPeakRing planes, used when the planes loaded
// with them are). A block's eight lists are merged and its first n keys go
// to the pair's lists; the last block of the pair (a ticket) takes those
// P n keys through the final threshold (keys at or below the largest
// slot), merges, writes the first n and resets the pair's slots.
template <int J>
__global__ void __launch_bounds__(kPeakThreads, kPeakBlocksPerSm)
    peaks_kernel(const float* __restrict__ pcm, int X, int Y, int Z,
                 int n_peaks, int xc, int units,
                 uint64_t* __restrict__ lists, int* __restrict__ ticket,
                 unsigned long long* __restrict__ all_slots,
                 int* __restrict__ out) {
  constexpr int N = 32 * J;
  __shared__ uint64_t buf[(kPeakWarps / 2) * N];
  const int b = blockIdx.y, P = gridDim.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned long long* slots = all_slots + b * kPeakMaxN;
  PeakList<J> pl;
  pl.init(n_peaks, lane);
  PeakUnit w;
  w.YZ = static_cast<int64_t>(Y) * Z;
  w.V = pcm + b * (X * w.YZ);
  w.X = X;
  w.Z = Z;
  w.edge = lane == 0 || lane == 31;
  const int nyg = (Y + kPeakRows - 1) / kPeakRows, nzs = (Z + 31) / 32;
  for (int u = blockIdx.x * kPeakWarps + warp; u < units;
       u += P * kPeakWarps) {
    const int zs = u % nzs, rest = u / nzs;
    const int y0 = (rest % nyg) * kPeakRows, z0 = 32 * zs;
    w.x0 = (rest / nyg) * xc;
    w.x1 = min(X, w.x0 + xc);
    w.zl = wrap_index(z0 + lane, Z);
    w.ze = wrap_index(lane == 0 ? z0 - 1 : z0 + 32, Z);
    w.base = static_cast<uint32_t>(y0 * Z + z0 + lane);
    w.cq = -1;
#pragma unroll
    for (int r = 0; r < kPeakRows + 2; ++r)
      w.yoff[r] = wrap_index(y0 - 1 + r, Y) * Z;
#pragma unroll
    for (int i = 0; i < kPeakRows; ++i)
      w.ok[i] = y0 + i < Y && z0 + lane < Z;
    // ring slot s holds planes x0 - 1 + s, + kPeakRing, ...
    float ring[kPeakRing][kPeakRows];
#pragma unroll
    for (int s = 0; s < kPeakAhead; ++s)
      if (w.x0 - 1 + s <= w.x1) w.load(w.x0 - 1 + s, ring[s]);
    uint64_t sv[J];  // this lane's slots, read with a ring's first loads
    for (int p0 = w.x0 - 1; p0 <= w.x1; p0 += kPeakRing) {
#pragma unroll
      for (int s = 0; s < kPeakRing; ++s) {
        const int p = p0 + s;
        if (p > w.x1) break;
        if (p + kPeakAhead <= w.x1)
          w.load(p + kPeakAhead, ring[(s + kPeakAhead) % kPeakRing]);
        if (s == 0) {
#pragma unroll
          for (int j = 0; j < J; ++j)
            sv[j] = 32 * j + lane < n_peaks ? __ldcg(slots + 32 * j + lane)
                                            : 0ull;
        }
        if (s == kPeakAhead) {
          uint64_t t = sv[0];
#pragma unroll
          for (int j = 1; j < J; ++j) t = max_u64(t, sv[j]);
#pragma unroll
          for (int d = 16; d > 0; d >>= 1)
            t = max_u64(t, __shfl_xor_sync(0xffffffffu, t, d));
          pl.lower(t);
        }
        if (p > w.x0)
          w.test<J>(p - 1, ring[(s + kPeakRing - 2) % kPeakRing],
                    ring[(s + kPeakRing - 1) % kPeakRing], ring[s], pl, slots);
      }
    }
  }
  block_merge<J>(pl.L, buf, warp, lane);
  if (warp == 0) {
    uint64_t* dst = lists + (static_cast<int64_t>(b) * P + blockIdx.x) *
                                n_peaks;
#pragma unroll
    for (int j = 0; j < J; ++j)
      if (32 * j + lane < n_peaks) dst[32 * j + lane] = pl.L[j];
  }
  __threadfence();  // the lists and every warp's atomicMin before the ticket
  if (!bst::last_block_arrived(ticket + b)) return;
  // the pair's P n keys, four loads in flight a lane, through the final
  // threshold G, the largest slot (its own key included); then the block's
  // lists merged
  pl.init(n_peaks, lane);
  const uint64_t G = pl.slots_max(slots);
  pl.lower(G == ~0ull ? G : G + 1);
  const uint64_t* src = lists + static_cast<int64_t>(b) * P * n_peaks;
  const int total = P * n_peaks;
  for (int c = warp * 32 + lane; c - lane < total; c += 4 * kPeakThreads) {
    uint64_t k[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int at = c + i * kPeakThreads;
      k[i] = at < total ? __ldcg(src + at) : ~0ull;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) pl.consider(k[i], nullptr);
  }
  block_merge<J>(pl.L, buf, warp, lane);
  if (warp == 0) {
    const int64_t YZ = w.YZ;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int e = 32 * j + lane;
      if (e < n_peaks) {
        const int64_t idx = static_cast<int64_t>(pl.L[j] & 0xffffffffu);
        int* o = out + (static_cast<int64_t>(b) * n_peaks + e) * 3;
        o[0] = static_cast<int>(idx / YZ);
        o[1] = static_cast<int>((idx / Z) % Y);
        o[2] = static_cast<int>(idx % Z);
      }
    }
  }
  for (int e = threadIdx.x; e < n_peaks; e += kPeakThreads) slots[e] = ~0ull;
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

// The launch plan (J, xc, P) is ops/phasecorr.py peaks_plan's: a list of
// N = 32 J >= n_peaks keys a warp, chunks of xc planes, P blocks a pair
// (at most one for every eight units). lists holds B x P x n keys; ticket
// B int32 and slots B x kPeakMaxN uint64, zero and ~0 between launches (the
// last block of a pair resets its own).
extern "C" int bst_pcm_peaks_topk(const float* pcm, int B, int X, int Y,
                                  int Z, int n_peaks, int J, int xc, int P,
                                  uint64_t* lists, int* ticket,
                                  unsigned long long* slots, int* out,
                                  void* stream) {
  const int64_t n = static_cast<int64_t>(X) * Y * Z;
  if (B < 1 || B > 65535 || X < 1 || Y < 1 || Z < 1 || n > 2147483647LL ||
      (J != 1 && J != 2 && J != 4 && J != 8) || n_peaks < 1 ||
      n_peaks > 32 * J || n_peaks > kPeakMaxN || n_peaks > n || xc < 1 ||
      xc > X || P < 1 ||
      P > 65535)
    return cudaErrorInvalidValue;
  const int64_t units = static_cast<int64_t>((Y + kPeakRows - 1) / kPeakRows) *
                        ((Z + 31) / 32) * ((X + xc - 1) / xc);
  if (units > 2147483647LL || P > (units + kPeakWarps - 1) / kPeakWarps)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(P, B);
#define BST_PEAKS(JJ)                                                     \
  peaks_kernel<JJ><<<grid, kPeakThreads, 0, s>>>(                         \
      pcm, X, Y, Z, n_peaks, xc, static_cast<int>(units), lists, ticket, \
      slots, out)
  switch (J) {
    case 1: BST_PEAKS(1); break;
    case 2: BST_PEAKS(2); break;
    case 4: BST_PEAKS(4); break;
    default: BST_PEAKS(8); break;
  }
#undef BST_PEAKS
  return static_cast<int>(cudaGetLastError());
}
