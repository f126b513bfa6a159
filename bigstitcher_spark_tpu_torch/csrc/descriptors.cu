// K19-K20: geometric descriptors and the descriptor ratio test, the JAX
// device programs of bigstitcher_spark_tpu/ops/descriptors.py. Every float
// op is rounded on its own (-fmad=false); the plain twins in
// ops/descriptors.py repeat the same operations in the same order, so
// kernel and twin agree bit for bit.
//
// K19 knn_descriptors (_knn_kernel :48, build_descriptors :84,
//   block_descriptors_impl :128): B batch entries of K points (x, y, z)
//   float32, optionally with validity flags. One thread per point streams
//   the entry's points through shared memory in tiles and keeps a sorted
//   register list of its P = n + r nearest (distance, index) keys, the
//   lower index first on equal distances (lax.top_k's order). The
//   distance is ((dx dx + dy dy) + dz dz) with d = own - other, as the JAX
//   sum in x, y, z order; the point itself, and with flags any pair that
//   is not valid on both sides, count as +inf (and so still fill the list,
//   in index order, when fewer than P others exist). Then the P offsets
//   neighbour - own (zeroed with flags when the P-th neighbour is not
//   finite: dvalid false), each n-subset of the subset table, and with
//   rotation invariance the local frame: ex = o0 / (|o0| + 1e-12), ey =
//   o1 - (o1 . ex) ex normalised the same way, ez = ex x ey, coordinates
//   ((b_0 o_0 + b_1 o_1) + b_2 o_2) per basis vector b. Writes the kNN
//   indices (optional), the descriptors (B, K, S, 3n) and, with flags,
//   dvalid. Memory is O(K S 3n). Bound: operations (8 float ops per pair
//   of points).
//
// K20 ratio_match (_pairwise_sqdist :191, _match_ratio_dense :208,
//   _match_ratio_row_chunk :220; ICP's nearest neighbour :585-588): A
//   (Da, D) against B (Db, D) float32. A first kernel takes the mean c of
//   B in double (a fixed order) and rounds it to float32; the JAX dense
//   form centres on B's mean too (its tiled form on each tile's). One
//   thread per row of A keeps a - c and a2 = sum (a - c)^2 in registers
//   and streams B - c through shared memory in tiles (b2 likewise), d2 =
//   max((a2 + b2) - 2 dot, 0) with dot summed in dimension order. Ratio
//   mode keeps the best (distance, column; the first column on ties, as
//   argmin) and the best distance of a different owner than the best's
//   (exact: no top-k truncation), and writes the best owner, its distance
//   and accept = sqrt(second) >= ratio sqrt(best). Nearest mode (owners
//   null) writes the best column and its distance. Bound: operations
//   (2D + 3 a pair: the dot's D products and D - 1 sums, 2 sums, a
//   product and a max).
#include "fusion_common.cuh"

namespace {

constexpr int kKnnThreads = 128;
constexpr int kKnnTile = 256;
constexpr int kMaxPool = 8;
constexpr int kMatchThreads = 128;
constexpr int kMatchTile = 128;
constexpr int kMaxDim = 24;

template <int P>
__global__ void knn_desc_kernel(const float* __restrict__ pts,
                                const uint8_t* __restrict__ valid, int K,
                                int n, int S, const int* __restrict__ subsets,
                                int rot, int* __restrict__ idx_out,
                                float* __restrict__ desc_out,
                                uint8_t* __restrict__ dvalid_out) {
  __shared__ float tx[kKnnTile], ty[kKnnTile], tz[kKnnTile];
  __shared__ uint8_t tv[kKnnTile];
  const int b = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const float* bp = pts + 3 * static_cast<int64_t>(b) * K;
  const uint8_t* bv = valid ? valid + static_cast<int64_t>(b) * K : nullptr;
  const bool row = i < K;
  float px = 0.0f, py = 0.0f, pz = 0.0f;
  bool vi = true;
  if (row) {
    px = bp[3 * i];
    py = bp[3 * i + 1];
    pz = bp[3 * i + 2];
    vi = bv ? bv[i] != 0 : true;
  }
  float ld[P];
  int li[P];
#pragma unroll
  for (int k = 0; k < P; ++k) {
    ld[k] = INFINITY;
    li[k] = 0x7fffffff;
  }
  for (int j0 = 0; j0 < K; j0 += kKnnTile) {
    __syncthreads();
    for (int t = threadIdx.x; t < kKnnTile && j0 + t < K; t += blockDim.x) {
      tx[t] = bp[3 * (j0 + t)];
      ty[t] = bp[3 * (j0 + t) + 1];
      tz[t] = bp[3 * (j0 + t) + 2];
      tv[t] = bv ? bv[j0 + t] : 1;
    }
    __syncthreads();
    if (!row) continue;
    const int nt = min(kKnnTile, K - j0);
    for (int t = 0; t < nt; ++t) {
      const int j = j0 + t;
      float d;
      if (j == i || !vi || !tv[t]) {
        d = INFINITY;
      } else {
        const float dx = px - tx[t], dy = py - ty[t], dz = pz - tz[t];
        d = (dx * dx + dy * dy) + dz * dz;
      }
      if (!(d < ld[P - 1] || (d == ld[P - 1] && j < li[P - 1]))) continue;
      // insert (d, j) keeping (distance, index) ascending
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
  }
  if (!row) return;
  const int64_t g = static_cast<int64_t>(b) * K + i;
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

__global__ void mean_kernel(const float* __restrict__ b, int64_t Db, int D,
                            float* __restrict__ center) {
  __shared__ double sh[32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int d = 0; d < D; ++d) {
    double s = 0.0;
    for (int64_t r = threadIdx.x; r < Db; r += blockDim.x) s += b[r * D + d];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) sh[warp] = s;
    __syncthreads();
    if (threadIdx.x == 0) {
      double t = 0.0;
      for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) t += sh[w];
      center[d] = static_cast<float>(t / static_cast<double>(Db));
    }
    __syncthreads();
  }
}

template <int D>
__global__ void match_kernel(const float* __restrict__ a, int Da,
                             const float* __restrict__ b, int Db,
                             const int* __restrict__ owner,
                             const float* __restrict__ center, float ratio,
                             int* __restrict__ best_out,
                             float* __restrict__ bestd_out,
                             uint8_t* __restrict__ accept_out) {
  __shared__ float tb[kMatchTile][D];
  __shared__ float tb2[kMatchTile];
  __shared__ int tow[kMatchTile];
  __shared__ float c[D];
  if (threadIdx.x < D) c[threadIdx.x] = center[threadIdx.x];
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool row = i < Da;
  float av[D];
  float a2 = 0.0f;
#pragma unroll
  for (int k = 0; k < D; ++k) {
    av[k] = row ? a[static_cast<int64_t>(i) * D + k] - c[k] : 0.0f;
    a2 = k == 0 ? av[k] * av[k] : a2 + av[k] * av[k];
  }
  float d1 = INFINITY, d2nd = INFINITY;
  int c1 = -1, o1 = -1;
  for (int j0 = 0; j0 < Db; j0 += kMatchTile) {
    __syncthreads();
    const int nt = min(kMatchTile, Db - j0);
    for (int t = threadIdx.x; t < nt; t += blockDim.x) {
      float s = 0.0f;
#pragma unroll
      for (int k = 0; k < D; ++k) {
        const float v = b[static_cast<int64_t>(j0 + t) * D + k] - c[k];
        tb[t][k] = v;
        s = k == 0 ? v * v : s + v * v;
      }
      tb2[t] = s;
      tow[t] = owner ? owner[j0 + t] : j0 + t;
    }
    __syncthreads();
    if (!row) continue;
    for (int t = 0; t < nt; ++t) {
      float dot = av[0] * tb[t][0];
#pragma unroll
      for (int k = 1; k < D; ++k) dot = dot + av[k] * tb[t][k];
      const float d = fmaxf((a2 + tb2[t]) - 2.0f * dot, 0.0f);
      const int ow = tow[t];
      if (d < d1) {
        if (ow != o1) d2nd = d1;
        d1 = d;
        c1 = j0 + t;
        o1 = ow;
      } else if (ow != o1 && d < d2nd) {
        d2nd = d;
      }
    }
  }
  if (!row) return;
  best_out[i] = owner ? o1 : c1;
  bestd_out[i] = d1;
  if (accept_out)
    accept_out[i] = (sqrtf(d2nd) >= ratio * sqrtf(d1)) ? 1 : 0;
}

template <int P>
cudaError_t launch_knn(const float* pts, const uint8_t* valid, int B, int K,
                       int n, int S, const int* subsets, int rot, int* idx,
                       float* desc, uint8_t* dvalid, cudaStream_t s) {
  dim3 grid((K + kKnnThreads - 1) / kKnnThreads, B);
  knn_desc_kernel<P><<<grid, kKnnThreads, 0, s>>>(pts, valid, K, n, S,
                                                  subsets, rot, idx, desc,
                                                  dvalid);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_match(const float* a, int Da, const float* b, int Db,
                         const int* owner, const float* center, float ratio,
                         int* best, float* bestd, uint8_t* accept,
                         cudaStream_t s) {
  match_kernel<D><<<(Da + kMatchThreads - 1) / kMatchThreads, kMatchThreads,
                    0, s>>>(a, Da, b, Db, owner, center, ratio, best, bestd,
                            accept);
  return cudaGetLastError();
}

}  // namespace

extern "C" int bst_knn_descriptors(const float* pts, const uint8_t* valid,
                                   int B, int K, int pool, int n, int S,
                                   const int* subsets, int rot, int* idx,
                                   float* desc, uint8_t* dvalid,
                                   void* stream) {
  if (B < 1 || B > 65535 || K < 1 || pool < 1 || pool > kMaxPool || n < 1 ||
      n > pool || S < 1 || desc == nullptr ||
      static_cast<int64_t>(K) * 3 > 2147483647LL)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (pool) {
    case 1: e = launch_knn<1>(pts, valid, B, K, n, S, subsets, rot, idx, desc, dvalid, s); break;
    case 2: e = launch_knn<2>(pts, valid, B, K, n, S, subsets, rot, idx, desc, dvalid, s); break;
    case 3: e = launch_knn<3>(pts, valid, B, K, n, S, subsets, rot, idx, desc, dvalid, s); break;
    case 4: e = launch_knn<4>(pts, valid, B, K, n, S, subsets, rot, idx, desc, dvalid, s); break;
    case 5: e = launch_knn<5>(pts, valid, B, K, n, S, subsets, rot, idx, desc, dvalid, s); break;
    case 6: e = launch_knn<6>(pts, valid, B, K, n, S, subsets, rot, idx, desc, dvalid, s); break;
    case 7: e = launch_knn<7>(pts, valid, B, K, n, S, subsets, rot, idx, desc, dvalid, s); break;
    default: e = launch_knn<8>(pts, valid, B, K, n, S, subsets, rot, idx, desc, dvalid, s); break;
  }
  return static_cast<int>(e);
}

extern "C" int bst_ratio_match(const float* a, int Da, const float* b, int Db,
                               int D, const int* owner, float ratio,
                               float* center, int* best, float* bestd,
                               uint8_t* accept, void* stream) {
  if (Da < 1 || Db < 1 || D < 1 || D > kMaxDim || D % 3 != 0 ||
      (owner != nullptr && accept == nullptr))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  mean_kernel<<<1, 1024, 0, s>>>(b, Db, D, center);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  switch (D) {
    case 3: e = launch_match<3>(a, Da, b, Db, owner, center, ratio, best, bestd, accept, s); break;
    case 6: e = launch_match<6>(a, Da, b, Db, owner, center, ratio, best, bestd, accept, s); break;
    case 9: e = launch_match<9>(a, Da, b, Db, owner, center, ratio, best, bestd, accept, s); break;
    case 12: e = launch_match<12>(a, Da, b, Db, owner, center, ratio, best, bestd, accept, s); break;
    case 15: e = launch_match<15>(a, Da, b, Db, owner, center, ratio, best, bestd, accept, s); break;
    case 18: e = launch_match<18>(a, Da, b, Db, owner, center, ratio, best, bestd, accept, s); break;
    case 21: e = launch_match<21>(a, Da, b, Db, owner, center, ratio, best, bestd, accept, s); break;
    default: e = launch_match<24>(a, Da, b, Db, owner, center, ratio, best, bestd, accept, s); break;
  }
  return static_cast<int>(e);
}
