// K15-K18: the DoG detection program dog_block_topk_batch
// (bigstitcher_spark_tpu/ops/dog.py:374, one vmapped dog_block_topk_impl
// :323 per block) and the dense dog_block / dog_block_batch (:164, :235),
// over a batch of B blocks (X, Y, Z), z contiguous, float32. K6
// (downsample.cu) does the residual pooling before K15 when rel != 1.
// Every float op is rounded on its own (-fmad=false): the plain twins in
// ops/dog.py repeat the same operations in the same order, so kernel and
// twin agree bit for bit.
//
// K15 dog_blur (_blur_separable :61): one 1-D pass of a normalised
//   Gaussian of 2r+1 taps along one axis, the index mirrored as np.pad's
//   "reflect" (i < 0 -> -i, i >= n -> 2n-2-i, repeated while out of
//   range); acc = w[0] x[i-r], then acc = acc + w[q] x[i-r+q] for q = 1..2r.
//   Reads uint8, uint16, int16 or float32, writes float32. Six passes make
//   the two blurs. Bound: bytes (each pass reads the input once and writes
//   the output once: 0.19 ms a pass at 8a's bucket, 2 x 528 x 528 x 144
//   float32). The first form, a thread an output issuing 2r+1 loads each
//   behind a mirror loop, took 1.32-1.60 ms a pass: load-issue bound, the
//   y and z passes re-reading each input 2r+1 times through L1/L2. Now
//   two forms, chosen by ops/dog.py blur_plan:
//   - run (x, y; z only where r > 480): a thread owns one line,
//     neighbouring threads on neighbouring lines (coalesced along x and
//     y), and walks a run of 16 outputs from a register window of 16 + 2r
//     inputs: (16 + 2r) / 16 loads an output instead of 2r + 1, the mirror
//     resolved only in runs that touch an axis end. For r = 6 or 7 (sigma
//     1.8 and 1.8 * 2^(1/4)) the taps sit in registers; for any other r
//     the window slides through two blocks of 16 registers while the taps
//     are read in order, one tap load for 16 outputs;
//   - row (z, r <= 480): a warp stages a chunk of <= 480 outputs of one
//     row plus its mirrored 2r halo in shared memory, 8 loads in flight a
//     lane, converted to float once; for r = 6 or 7 each lane computes 3
//     neighbouring outputs from a register window of 3 + 2r staged values
//     (lanes 3 words apart: no bank conflicts), else one output from 2r +
//     1 shared reads.
//   Each form takes the same products and sums in the same order, so all
//   agree bit for bit with the twin, also where an axis is shorter than r
//   and the mirror repeats.
//
// K16 dog_extrema (dog_block :184-217, the halo core :344-352, count
//   :361): dog = (b1 - b2) * scale[b] (scale = (1/(k-1)) * the gated
//   1/(max-min), computed by the wrapper) and, per voxel, the tie-break
//   hash of its absolute coordinates (uint32 arithmetic, the low 10 bits
//   of JAX's wrapping int32 hash) times 2^-30; a maximum when dog >
//   threshold and dog + tb >= every neighbour's dog + tb of the 3x3x3
//   window inside the block (the -inf padding), a minimum when dog <
//   -threshold and dog - tb <= every neighbour's. Only voxels past the
//   threshold read their window, and stop at the first neighbour past
//   them (the same answer: fmaxf over the window, NaNs skipped, then >=).
//   A voxel that is an extremum inside the halo core is either written to
//   the dense mask, or appended to the block's candidate list (flat
//   index, |dog|) through an atomic counter, whose final value is the
//   exact count; the list holds a whole block, so it never overflows, and
//   its order is arbitrary. Bound: bytes (b1, b2 read once, dog written
//   once; the list is sparse). The first form took two passes, the
//   response (a grid-stride scalar pass), then the extrema reading dog
//   back from DRAM (0.64 ms at 8a's bucket against a 0.29 ms bound). Now
//   one pass (ops/dog.py extrema_plan): a block owns a (y, z) tile of one
//   batch entry (12 rows of whole z rows at 8a's bucket) and a chunk of x
//   planes (about 30), and marches along x. For each plane it loads b1 and
//   b2 over the tile and a one-voxel y / z halo into registers (float4s
//   along z where Z and the pointers allow; the halo rows come through L2,
//   as neighbouring tiles read them too), computes dog with the twin's two
//   roundings, keeps it in a ring of four planes in shared memory and
//   stores the tile's own voxels to dog once; each thread notes which of
//   its own voxels are past the threshold. The next plane's loads are in
//   flight while the block tests the plane behind: each warp gathers its
//   voxels past the threshold into a queue in shared memory and its lanes
//   take them one each, reading the 26 neighbours from the ring, so that
//   a bead's voxels or a noisy block's spread over the lanes instead of
//   one thread walking four windows. Where a neighbour lies outside the
//   block it is skipped, as before; a tile's edge is not a block's. Small
//   tiles won (12 rows over 26): the ring's shared memory is taken from
//   the L1 that holds the loads in flight.
//
// K17 dog_topk (lax.top_k :353-359): the K smallest 64-bit keys
//   (~order(|dog|) << 32 | flat index: |dog| descending, then the lower
//   index first, lax.top_k's order) of each block's candidate list, in
//   order, in one launch whose plan (ops/dog.py topk_plan) depends on K and
//   B only: the count stays on the device. Rows past the count are invalid
//   and hold flat index 0. Any count and any order of the list are
//   handled. Bound: the list read once (launch latency in practice). The
//   first form, one block an entry, bitonic-sorted a power-of-two buffer
//   of at least 2K keys whatever the count (8,192 at K = 4,096: 0.0847 ms
//   for ~430 candidates), once for every K keys of the list. Now a block
//   of 256 threads for every 256 rows of the answer: each builds the same
//   array of the min(count, K) best keys in shared memory (the list itself
//   when count <= K, the usual case; else a radix select of the K-th key,
//   a histogram of one 8-bit digit a round, and the keys at or below it
//   compacted in list order), then ranks its share of the array (the keys
//   smaller, equal keys by position) and writes each to its row.
//
// K18 dog_localize (_localize_quadratic_device :259): one thread per
//   candidate, up to 4 rounds: gradient and Hessian by central
//   differences from 19 gathers (indices clipped as _gather3 does),
//   LU with partial pivoting (the first largest |pivot|), det = the
//   signed product of U's diagonal, and where |det| > 1e-12 the offset
//   -H^-1 g clipped to [-1, 1]; an eligible candidate (active, 1 <= p <=
//   dims-2) takes p + offset and c + g.offset / 2, and moves one voxel
//   along each axis where |offset| > 0.5 for the next round. Invalid rows
//   give sub 0 and val 0. Bound: launch latency (19 gathers a round).
#include "fusion_common.cuh"

namespace {

constexpr int kTopkThreads = 256;  // K17's block
constexpr int kTopkMaxK = 8192;    // ops/dog.py MAX_TOPK

__device__ __forceinline__ int reflect(int i, int n) {
  if (n == 1) return 0;
  while (i < 0 || i >= n) {
    if (i < 0) i = -i;
    if (i >= n) i = 2 * n - 2 - i;
  }
  return i;
}

// ----------------------------------------------------------------- K15

constexpr int kBlurRun = 16;         // outputs a thread walks (run form)
constexpr int kBlurRunThreads = 128;
constexpr int kBlurRowWarps = 8;     // warps a block (row form)
constexpr int kBlurMaxChunk = 480;   // z outputs a warp stages at a time
constexpr int kBlurRowRun = 3;       // outputs a lane (row form, r 6 or 7)
constexpr int kBlurStage = 8;        // loads in flight a lane when staging

// The run form: a thread owns one line (neighbouring threads on
// neighbouring lines, so along x and y every load is coalesced) and walks
// kBlurRun outputs along it, each input of the run's kBlurRun + 2r window
// read once (the 2r halo again by the neighbouring run); the mirror is
// resolved only in runs that touch an end of the axis. R = 6 or 7: the
// window and the taps in registers. R = 0 (the radius r at run time; any
// axis, z only where r is too long for the row form): the window slides
// through two register blocks of kBlurRun inputs while the taps are read
// in order, so each output still takes w[0] x[o], then + w[q] x[o + q]
// for q = 1..2r.
template <typename T, int R>
__global__ void __launch_bounds__(kBlurRunThreads)
    blur_run_kernel(const T* __restrict__ x, int X, int Y, int Z, int axis,
                    const float* __restrict__ taps, int r_rt,
                    float* __restrict__ out) {
  constexpr int L = kBlurRun;
  const int r = R > 0 ? R : r_rt;
  const int64_t yz = static_cast<int64_t>(Y) * Z;
  const int64_t lines = axis == 0   ? yz
                        : axis == 1 ? static_cast<int64_t>(X) * Z
                                    : static_cast<int64_t>(X) * Y;
  const int64_t t = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (t >= lines) return;
  const int n = axis == 0 ? X : axis == 1 ? Y : Z;
  const int64_t stride = axis == 0 ? yz : axis == 1 ? Z : 1;
  const int64_t base = blockIdx.z * static_cast<int64_t>(X) * yz +
                       (axis == 0   ? t
                        : axis == 1 ? (t / Z) * yz + t % Z
                                    : t * Z);
  const int c0 = blockIdx.y * L;
  const bool inner = c0 >= r && c0 + L + r <= n;
  const T* src = x + base;
  float* dst = out + base;
  if constexpr (R > 0) {
    constexpr int W = L + 2 * R;
    float w[2 * R + 1];
#pragma unroll
    for (int q = 0; q <= 2 * R; ++q) w[q] = taps[q];
    float v[W];
    if (inner) {
#pragma unroll
      for (int q = 0; q < W; ++q)
        v[q] = static_cast<float>(src[(c0 - R + q) * stride]);
    } else {
#pragma unroll
      for (int q = 0; q < W; ++q)
        v[q] = static_cast<float>(src[reflect(c0 - R + q, n) * stride]);
    }
#pragma unroll
    for (int o = 0; o < L; ++o) {  // past n: computed, not stored
      float acc = w[0] * v[o];
#pragma unroll
      for (int q = 1; q <= 2 * R; ++q) acc = acc + w[q] * v[o + q];
      if (c0 + o < n) dst[(c0 + o) * stride] = acc;
    }
  } else {
    // window input u is x[c0 - r + u], u < L + 2r; cur holds u0 .. u0 + L
    // - 1 and nxt the next L, so tap q = u0 + qq of output o reads cur or
    // nxt at a compile-time index
    const int W = L + 2 * r;
    auto load = [&](int u) {
      if (u >= W) return 0.0f;
      const int p = c0 - r + u;
      return static_cast<float>(src[(inner ? p : reflect(p, n)) * stride]);
    };
    float cur[L], nxt[L], acc[L];
#pragma unroll
    for (int o = 0; o < L; ++o) cur[o] = load(o);
    const float w0 = taps[0];
#pragma unroll
    for (int o = 0; o < L; ++o) acc[o] = w0 * cur[o];
    for (int u0 = 0; u0 < 2 * r; u0 += L) {
#pragma unroll
      for (int o = 0; o < L; ++o) nxt[o] = load(u0 + L + o);
#pragma unroll
      for (int qq = 1; qq <= L; ++qq) {
        if (u0 + qq <= 2 * r) {
          const float w = taps[u0 + qq];
#pragma unroll
          for (int o = 0; o < L; ++o)
            acc[o] = acc[o] + w * (o + qq < L ? cur[o + qq] : nxt[o + qq - L]);
        }
      }
#pragma unroll
      for (int o = 0; o < L; ++o) cur[o] = nxt[o];
    }
#pragma unroll
    for (int o = 0; o < L; ++o)  // past n: computed, not stored
      if (c0 + o < n) dst[(c0 + o) * stride] = acc[o];
  }
}

// The row form, z: a warp stages a chunk of one row plus its mirrored halo
// in shared memory (coalesced loads, kBlurStage in flight a lane,
// converted to float once). For r = 6 or 7 each lane then computes
// kBlurRowRun neighbouring outputs from a register window of kBlurRowRun +
// 2R staged values (lanes kBlurRowRun words apart, an odd stride: no bank
// conflicts); R = 0 (the radius r at run time): a lane an output from its
// 2r + 1 staged values.
template <typename T, int R>
__global__ void __launch_bounds__(32 * kBlurRowWarps)
    blur_row_kernel(const T* __restrict__ x, int64_t rows, int Z, int r_rt,
                    int chunk, const float* __restrict__ taps,
                    float* __restrict__ out) {
  extern __shared__ float blur_smem[];
  const int r = R > 0 ? R : r_rt;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nch = (Z + chunk - 1) / chunk;
  const int64_t item = blockIdx.x * static_cast<int64_t>(kBlurRowWarps) + warp;
  if (item >= rows * nch) return;
  const int64_t row = item / nch;
  const int z0 = static_cast<int>(item - row * nch) * chunk;
  const int m = min(chunk, Z - z0);
  float* s = blur_smem + warp * (chunk + 2 * r + kBlurRowRun);
  const T* src = x + row * Z;
  for (int q0 = lane; q0 < m + 2 * r; q0 += 32 * kBlurStage) {
    float v[kBlurStage];
#pragma unroll
    for (int u = 0; u < kBlurStage; ++u) {
      const int q = q0 + 32 * u;
      v[u] = q < m + 2 * r ? static_cast<float>(src[reflect(z0 - r + q, Z)])
                           : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kBlurStage; ++u)
      if (q0 + 32 * u < m + 2 * r) s[q0 + 32 * u] = v[u];
  }
  __syncwarp();
  float* dst = out + row * Z + z0;
  if (R > 0) {
    constexpr int L = kBlurRowRun;
    float w[2 * R + 1];
#pragma unroll
    for (int q = 0; q <= 2 * R; ++q) w[q] = taps[q];
    for (int k0 = lane * L; k0 < m; k0 += 32 * L) {
      float v[L + 2 * R];
#pragma unroll
      for (int q = 0; q < L + 2 * R; ++q) v[q] = s[k0 + q];
#pragma unroll
      for (int o = 0; o < L; ++o) {  // past m: computed, not stored
        float acc = w[0] * v[o];
#pragma unroll
        for (int q = 1; q <= 2 * R; ++q) acc = acc + w[q] * v[o + q];
        if (k0 + o < m) dst[k0 + o] = acc;
      }
    }
  } else {
    for (int k = lane; k < m; k += 32) {
      float acc = taps[0] * s[k];
      for (int q = 1; q <= 2 * r; ++q) acc = acc + taps[q] * s[k + q];
      dst[k] = acc;
    }
  }
}

enum BlurRoute : int { BLUR_RUN = 0, BLUR_ROW = 1 };

template <typename T>
cudaError_t launch_blur(const void* xv, int B, int X, int Y, int Z, int axis,
                        const float* taps, int r, int route, dim3 grid,
                        int chunk, float* out, cudaStream_t s) {
  const T* x = static_cast<const T*>(xv);
  if (route == BLUR_RUN) {
    if (r == 6)
      blur_run_kernel<T, 6><<<grid, kBlurRunThreads, 0, s>>>(x, X, Y, Z, axis,
                                                             taps, r, out);
    else if (r == 7)
      blur_run_kernel<T, 7><<<grid, kBlurRunThreads, 0, s>>>(x, X, Y, Z, axis,
                                                             taps, r, out);
    else
      blur_run_kernel<T, 0><<<grid, kBlurRunThreads, 0, s>>>(x, X, Y, Z, axis,
                                                             taps, r, out);
  } else {
    const int64_t rows = static_cast<int64_t>(B) * X * Y;
    const size_t smem =
        sizeof(float) * kBlurRowWarps * (chunk + 2 * r + kBlurRowRun);
    if (r == 6)
      blur_row_kernel<T, 6><<<grid, 32 * kBlurRowWarps, smem, s>>>(
          x, rows, Z, r, chunk, taps, out);
    else if (r == 7)
      blur_row_kernel<T, 7><<<grid, 32 * kBlurRowWarps, smem, s>>>(
          x, rows, Z, r, chunk, taps, out);
    else
      blur_row_kernel<T, 0><<<grid, 32 * kBlurRowWarps, smem, s>>>(
          x, rows, Z, r, chunk, taps, out);
  }
  return cudaGetLastError();
}

// ----------------------------------------------------------------- K16

constexpr int kExThreads = 256;
constexpr int kExItems = 4;        // loaded items a thread a plane, at most
constexpr int kExBlocksPerSM = 3;  // ops/dog.py EXTREMA_BLOCKS_PER_SM
constexpr int kExRing = 4;         // planes of dog in shared memory
constexpr int kExWarpQueue = 32 * kExItems * 4;  // a warp's own voxels

__device__ __forceinline__ uint32_t tb_hash(int ax, int ay, int az) {
  return static_cast<uint32_t>(ax) * 73856093u +
         static_cast<uint32_t>(ay) * 19349663u +
         static_cast<uint32_t>(az) * 83492791u;
}

__device__ __forceinline__ float tb_of(uint32_t h) {
  return static_cast<float>(h & 1023u) * 9.313225746154785e-10f;  // 2^-30
}

template <int V>
__device__ __forceinline__ void load_v(const float* __restrict__ p,
                                       float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else {
    v[0] = __ldg(p);
  }
}

// b1 and b2 of plane offset po at this thread's items (goff < 0: outside
// the block) and its z-halo voxel
template <int V>
__device__ __forceinline__ void load_plane(
    const float* __restrict__ B1, const float* __restrict__ B2, int64_t po,
    const int (&goff)[kExItems], int hoff, float (&r1)[kExItems][V],
    float (&r2)[kExItems][V], float& h1, float& h2) {
#pragma unroll
  for (int k = 0; k < kExItems; ++k)
    if (goff[k] >= 0) {
      load_v<V>(B1 + po + goff[k], r1[k]);
      load_v<V>(B2 + po + goff[k], r2[k]);
    }
  if (hoff >= 0) {
    h1 = __ldg(B1 + po + hoff);
    h2 = __ldg(B2 + po + hoff);
  }
}

// Whether d (the voxel's dog + sign * tb) is the largest (sign 1) or
// smallest (sign -1) of dog + sign * tb over its 3x3x3 window inside the
// block: no neighbour beyond it. so is the voxel's (i, j, k) offset in
// its plane's ring slot; ring slots are SS floats apart, rows SP.
template <int SIGN>
__device__ __forceinline__ bool window_holds(const float* __restrict__ ring,
                                             int SS, int SP, int X, int Y,
                                             int Z, int i, int j, int k,
                                             int so, int ox, int oy, int oz,
                                             float d) {
  for (int dx = -1; dx <= 1; ++dx) {
    const int xi = i + dx;
    if (xi < 0 || xi >= X) continue;
    const float* P = ring + (xi & (kExRing - 1)) * SS + so;
    const uint32_t hx = static_cast<uint32_t>(ox + xi) * 73856093u;
    for (int dy = -1; dy <= 1; ++dy) {
      const int yi = j + dy;
      if (yi < 0 || yi >= Y) continue;
      const float* row = P + dy * SP;
      const uint32_t hxy = hx + static_cast<uint32_t>(oy + yi) * 19349663u;
      for (int dz = -1; dz <= 1; ++dz) {
        const int zi = k + dz;
        if (zi < 0 || zi >= Z) continue;
        const float tb =
            tb_of(hxy + static_cast<uint32_t>(oz + zi) * 83492791u);
        if (SIGN > 0 ? row[dz] + tb > d : row[dz] - tb < d) return false;
      }
    }
  }
  return true;
}

template <int V>
__global__ void __launch_bounds__(kExThreads, kExBlocksPerSM)
    extrema_kernel(const float* __restrict__ b1, const float* __restrict__ b2,
                   int X, int Y, int Z, int TY, int TZ, int XC, int ntz,
                   const float* __restrict__ scale,
                   const float* __restrict__ thr,
                   const int* __restrict__ origins, int find_max,
                   int find_min, int halo, float* __restrict__ dog,
                   uint8_t* __restrict__ mask, int* __restrict__ cand_idx,
                   float* __restrict__ cand_score, int* __restrict__ count) {
  extern __shared__ float4 ring4[];
  float* ring = reinterpret_cast<float*>(ring4);
  const int SP = ((TZ + 3) & ~3) + 8;  // a row: z0 - 1 at 3, z0 at 4
  const int SS = (TY + 2) * SP;        // a plane: rows y0 - 1 .. y0 + TY
  // after the ring: each warp's queue of its voxels past the threshold in
  // the plane under test (their ring offsets)
  uint16_t* wq = reinterpret_cast<uint16_t*>(ring + kExRing * SS) +
                 (threadIdx.x >> 5) * kExWarpQueue;
  const int b = blockIdx.z;
  const int tyi = blockIdx.x / ntz;
  const int y0 = tyi * TY, z0 = (blockIdx.x - tyi * ntz) * TZ;
  const int ny = min(TY, Y - y0), nz = min(TZ, Z - z0);
  const int xs = blockIdx.y * XC, xe = min(X, xs + XC);
  const int yz = Y * Z;
  const int64_t vol = static_cast<int64_t>(X) * yz;
  const float* B1 = b1 + b * vol;
  const float* B2 = b2 + b * vol;
  float* Dg = dog + b * vol;
  const float sc = scale[b], th = thr[b];
  const int ox = origins[3 * b], oy = origins[3 * b + 1],
            oz = origins[3 * b + 2];
  const int nzv = nz / V;  // items a row
  const int lane = threadIdx.x & 31;
  // this thread's items of a plane (the same in every plane): offset in
  // the plane (-1 outside the block), offset in a ring slot, and whether
  // it is the tile's own (not its halo): the items this thread tests
  int goff[kExItems], soff[kExItems];
  bool own[kExItems];
#pragma unroll
  for (int k = 0; k < kExItems; ++k) {
    const int it = threadIdx.x + k * kExThreads;
    goff[k] = -1;
    soff[k] = 0;
    own[k] = false;
    if (it < (ny + 2) * nzv) {
      const int r = it / nzv, c = it - r * nzv, y = y0 - 1 + r;
      if (y >= 0 && y < Y) {
        goff[k] = y * Z + z0 + c * V;
        soff[k] = r * SP + 4 + c * V;
        own[k] = r >= 1 && r <= ny;
      }
    }
  }
  int hoff = -1, hsoff = 0;
  if (threadIdx.x < 2 * (ny + 2)) {
    const int r = threadIdx.x >> 1, y = y0 - 1 + r;
    const int z = (threadIdx.x & 1) ? z0 + nz : z0 - 1;
    if (y >= 0 && y < Y && z >= 0 && z < Z) {
      hoff = y * Z + z;
      hsoff = r * SP + 4 + (z - z0);
    }
  }
  float r1[kExItems][V], r2[kExItems][V], h1 = 0.0f, h2 = 0.0f;
  // bit 4 k + u: voxel u of own item k is past the threshold, in the plane
  // just computed and in the one behind it (under test)
  unsigned past = 0, past_behind = 0;
  const int xa = max(0, xs - 1), xb = min(X - 1, xe);
  load_plane<V>(B1, B2, static_cast<int64_t>(xa) * yz, goff, hoff, r1, r2,
                h1, h2);
  for (int x = xa; x <= xe; ++x) {
    if (x <= xb) {
      // plane x: dog into its ring slot and, for the tile's own voxels of
      // this chunk's planes, to DRAM; then the next plane's loads
      float* slot = ring + (x & (kExRing - 1)) * SS;
      const bool mine = x >= xs && x < xe;
      const int64_t po = static_cast<int64_t>(x) * yz;
#pragma unroll
      for (int k = 0; k < kExItems; ++k)
        if (goff[k] >= 0) {
          float d[V];
#pragma unroll
          for (int u = 0; u < V; ++u) d[u] = (r1[k][u] - r2[k][u]) * sc;
          if constexpr (V == 4) {
            const float4 d4 = make_float4(d[0], d[1], d[2], d[3]);
            *reinterpret_cast<float4*>(slot + soff[k]) = d4;
            if (mine && own[k])
              *reinterpret_cast<float4*>(Dg + po + goff[k]) = d4;
          } else {
            slot[soff[k]] = d[0];
            if (mine && own[k]) Dg[po + goff[k]] = d[0];
          }
          if (mine && own[k]) {
            // the voxels past the threshold will read their window; the
            // dense mask is 0 elsewhere (and there until they are tested)
#pragma unroll
            for (int u = 0; u < V; ++u)
              if ((find_max && d[u] > th) || (find_min && d[u] < -th))
                past |= 1u << (4 * k + u);
            if (mask != nullptr) {
              uint8_t* mo = mask + b * vol + po + goff[k];
              if constexpr (V == 4)
                *reinterpret_cast<uchar4*>(mo) = make_uchar4(0, 0, 0, 0);
              else
                mo[0] = 0;
            }
          }
        }
      if (hoff >= 0) slot[hsoff] = (h1 - h2) * sc;
      if (x < xb)
        load_plane<V>(B1, B2, po + yz, goff, hoff, r1, r2, h1, h2);
    }
    __syncthreads();
    const int i = x - 1;  // the plane behind: its window is in the ring
    const unsigned mine_past = past_behind;
    past_behind = past;
    past = 0;
    if (i < xs || !__any_sync(0xffffffffu, mine_past != 0u)) continue;
    // the warp's voxels of plane i past the threshold into its queue, then
    // a lane a voxel: its window from the ring
    const float* C = ring + (i & (kExRing - 1)) * SS;
    const int pi = i * yz;
    const int n = __popc(mine_past);
    int incl = n;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += t;
    }
    const int nq = __shfl_sync(0xffffffffu, incl, 31);
    int pos = incl - n;
#pragma unroll
    for (int k = 0; k < kExItems; ++k)
#pragma unroll
      for (int u = 0; u < V; ++u)
        if ((mine_past >> (4 * k + u)) & 1u)
          wq[pos++] = static_cast<uint16_t>(soff[k] + u);
    __syncwarp();
    for (int e = lane; e < nq; e += 32) {
      const int so = wq[e];
      const int rr = so / SP, j = y0 - 1 + rr, kz = z0 - 4 + (so - rr * SP);
      const float v = C[so];
      bool m = false;
      if (find_max && v > th)
        m = window_holds<1>(ring, SS, SP, X, Y, Z, i, j, kz, so, ox, oy, oz,
                            v + tb_of(tb_hash(ox + i, oy + j, oz + kz)));
      if (!m && find_min && v < -th)
        m = window_holds<-1>(ring, SS, SP, X, Y, Z, i, j, kz, so, ox, oy, oz,
                             v - tb_of(tb_hash(ox + i, oy + j, oz + kz)));
      m = m && i >= halo && i < X - halo && j >= halo && j < Y - halo &&
          kz >= halo && kz < Z - halo;
      if (!m) continue;
      const int flat = pi + j * Z + kz;
      if (mask != nullptr) mask[b * vol + flat] = 1;
      if (cand_idx != nullptr) {
        const int slot = atomicAdd(count + b, 1);
        cand_idx[b * vol + slot] = flat;
        cand_score[b * vol + slot] = fabsf(v);
      }
    }
  }
}

// ----------------------------------------------------------------- K17

// order-preserving map of a float to 32 bits (-0 taken as +0), inverted so
// that ascending keys run from the largest value down (pcm.cu's K10 key)
__device__ __forceinline__ uint64_t topk_key(float v, uint32_t idx) {
  if (v == 0.0f) v = 0.0f;
  const uint32_t u = __float_as_uint(v);
  const uint32_t ord = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<uint64_t>(~ord) << 32) | idx;
}

__device__ __forceinline__ uint64_t cand_key(const int* __restrict__ ci,
                                             const float* __restrict__ cs,
                                             int64_t i) {
  return topk_key(cs[i], static_cast<uint32_t>(ci[i]));
}

// The n keys' exclusive prefix of a per-thread value v over the block
// (kTopkThreads threads, thread order), and the block's total; sh holds
// kTopkThreads / 32 + 1 values. Every thread calls it.
__device__ __forceinline__ uint32_t block_scan(uint32_t v, uint32_t* sh,
                                               uint32_t* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t o = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += o;
  }
  if (lane == 31) sh[warp] = x;
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t t = 0;
    for (int w = 0; w < kTopkThreads / 32; ++w) {
      const uint32_t c = sh[w];
      sh[w] = t;
      t += c;
    }
    sh[kTopkThreads / 32] = t;
  }
  __syncthreads();
  const uint32_t pre = sh[warp] + x - v;
  *total = sh[kTopkThreads / 32];
  __syncthreads();
  return pre;
}

// The G blocks of batch entry b (grid (G, B), G kTopkThreads >= K) each
// build the same array s of its m = min(n, K) best keys: the list itself
// when n <= K; else a radix select of the K-th smallest key (8-bit digits
// from the top, every block reading the list, stopping where a digit's
// bucket is taken whole), then the keys below it and as many equal to it
// as make K, compacted in list order by a block scan. Block g ranks s's
// entries g kTopkThreads + t (the keys before it, equal keys by position)
// and writes each to its row; rows m..K-1 of its share are invalid.
__global__ void __launch_bounds__(kTopkThreads)
    topk_kernel(const int* __restrict__ cand_idx,
                const float* __restrict__ cand_score,
                const int* __restrict__ count, int64_t cap, int K, int Y,
                int Z, int* __restrict__ idx_out,
                uint8_t* __restrict__ valid_out) {
  extern __shared__ uint64_t s[];
  __shared__ uint32_t hist[256];
  __shared__ uint32_t sh[kTopkThreads / 32 + 1];
  __shared__ uint32_t pick[2];
  const int b = blockIdx.y;
  const int64_t c = count[b];
  const int64_t n = c < 0 ? 0 : (c < cap ? c : cap);
  const int m = n < K ? static_cast<int>(n) : K;
  const int* ci = cand_idx + b * cap;
  const float* cs = cand_score + b * cap;
  if (n <= K) {
    for (int i = threadIdx.x; i < m; i += kTopkThreads)
      s[i] = cand_key(ci, cs, i);
  } else {
    uint64_t prefix = 0;
    uint32_t need = static_cast<uint32_t>(K);  // rank among the matching
    int shift = 64;
    while (shift > 0) {
      shift -= 8;
      const uint64_t hi = shift == 56 ? 0ull : ~0ull << (shift + 8);
      for (int i = threadIdx.x; i < 256; i += kTopkThreads) hist[i] = 0;
      __syncthreads();
      for (int64_t i = threadIdx.x; i < n; i += kTopkThreads) {
        const uint64_t x = cand_key(ci, cs, i);
        if (((x ^ prefix) & hi) == 0)
          atomicAdd(&hist[static_cast<uint32_t>(x >> shift) & 255u], 1u);
      }
      __syncthreads();
      if (threadIdx.x < 32) {  // the digit whose bucket holds the need-th
        const int lane = threadIdx.x;
        uint32_t own = 0;
#pragma unroll
        for (int d = 0; d < 8; ++d) own += hist[8 * lane + d];
        uint32_t inc = own;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const uint32_t o = __shfl_up_sync(0xffffffffu, inc, d);
          if (lane >= d) inc += o;
        }
        const uint32_t before = inc - own;
        if (before < need && need <= inc) {
          uint32_t below = before;
          int d = 0;
          while (below + hist[8 * lane + d] < need) below += hist[8 * lane + d++];
          pick[0] = 8 * lane + d;
          pick[1] = below;
        }
      }
      __syncthreads();
      const uint32_t digit = pick[0];
      prefix |= static_cast<uint64_t>(digit) << shift;
      need -= pick[1];
      const bool whole = hist[digit] == need;
      __syncthreads();
      if (whole) break;
    }
    // keys whose top 64 - shift bits are below prefix's: all; equal: the
    // first `need` in list order
    const uint64_t top = ~0ull << shift;
    constexpr int E = 8;
    uint32_t lt_base = 0, eq_base = 0;
    for (int64_t c0 = 0; c0 < n; c0 += static_cast<int64_t>(kTopkThreads) * E) {
      const int64_t i0 = c0 + static_cast<int64_t>(threadIdx.x) * E;
      uint64_t x[E];
      uint32_t cls = 0, lt = 0, eq = 0;  // cls: 2 bits an entry
#pragma unroll
      for (int e = 0; e < E; ++e) {
        x[e] = ~0ull;
        if (i0 + e < n) {
          x[e] = cand_key(ci, cs, i0 + e);
          const uint64_t t = x[e] & top;
          if (t < prefix) {
            cls |= 1u << (2 * e);
            ++lt;
          } else if (t == prefix) {
            cls |= 2u << (2 * e);
            ++eq;
          }
        }
      }
      uint32_t total;
      const uint32_t pre = block_scan(lt | (eq << 16), sh, &total);
      uint32_t lb = lt_base + (pre & 0xffffu), eb = eq_base + (pre >> 16);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const uint32_t k = (cls >> (2 * e)) & 3u;
        if (k == 1u) {
          s[lb + (eb < need ? eb : need)] = x[e];
          ++lb;
        } else if (k == 2u) {
          if (eb < need) s[lb + eb] = x[e];
          ++eb;
        }
      }
      lt_base += total & 0xffffu;
      eq_base += total >> 16;
    }
  }
  __syncthreads();
  const int i = blockIdx.x * kTopkThreads + threadIdx.x;
  if (i < K) {
    int f = 0;
    if (i < m) {
      const uint64_t x = s[i];
      int r = 0;
      for (int j = 0; j < m; ++j) {
        const uint64_t y = s[j];
        r += (y < x) | ((y == x) & (j < i));
      }
      f = static_cast<int>(x & 0xffffffffu);
      int* o = idx_out + (static_cast<int64_t>(b) * K + r) * 3;
      o[0] = f / (Y * Z);
      o[1] = (f / Z) % Y;
      o[2] = f % Z;
      valid_out[static_cast<int64_t>(b) * K + r] = 1;
    } else {
      int* o = idx_out + (static_cast<int64_t>(b) * K + i) * 3;
      o[0] = o[1] = o[2] = 0;
      valid_out[static_cast<int64_t>(b) * K + i] = 0;
    }
  }
}

// ----------------------------------------------------------------- K18

__device__ __forceinline__ float gather3(const float* __restrict__ D, int X,
                                         int Y, int Z, int x, int y, int z) {
  x = min(max(x, 0), X - 1);
  y = min(max(y, 0), Y - 1);
  z = min(max(z, 0), Z - 1);
  return D[(static_cast<int64_t>(x) * Y + y) * Z + z];
}

__global__ void localize_kernel(const float* __restrict__ dog, int B, int X,
                                int Y, int Z, const int* __restrict__ idx,
                                const uint8_t* __restrict__ valid, int K,
                                float* __restrict__ sub,
                                float* __restrict__ val) {
  const int64_t q = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (q >= static_cast<int64_t>(B) * K) return;
  const int b = static_cast<int>(q / K);
  const float* D = dog + b * static_cast<int64_t>(X) * Y * Z;
  const int dims[3] = {X, Y, Z};
  int p[3] = {idx[3 * q], idx[3 * q + 1], idx[3 * q + 2]};
  float res[3] = {static_cast<float>(p[0]), static_cast<float>(p[1]),
                  static_cast<float>(p[2])};
  float value = gather3(D, X, Y, Z, p[0], p[1], p[2]);
  bool active = valid[q] != 0;
  for (int round = 0; round < 4 && active; ++round) {
    bool ok = true;
    for (int d = 0; d < 3; ++d) ok = ok && p[d] >= 1 && p[d] <= dims[d] - 2;
    if (!ok) break;
    const float c = gather3(D, X, Y, Z, p[0], p[1], p[2]);
    float g[3], h[3][3];
    for (int d = 0; d < 3; ++d) {
      int u[3] = {p[0], p[1], p[2]}, w[3] = {p[0], p[1], p[2]};
      u[d] += 1;
      w[d] -= 1;
      const float plus = gather3(D, X, Y, Z, u[0], u[1], u[2]);
      const float minus = gather3(D, X, Y, Z, w[0], w[1], w[2]);
      g[d] = 0.5f * (plus - minus);
      h[d][d] = (plus - 2.0f * c) + minus;
    }
    for (int d = 0; d < 3; ++d) {
      for (int e = d + 1; e < 3; ++e) {
        int pp[3] = {p[0], p[1], p[2]}, pm[3] = {p[0], p[1], p[2]};
        int mp[3] = {p[0], p[1], p[2]}, mm[3] = {p[0], p[1], p[2]};
        pp[d] += 1; pp[e] += 1;
        pm[d] += 1; pm[e] -= 1;
        mp[d] -= 1; mp[e] += 1;
        mm[d] -= 1; mm[e] -= 1;
        const float v = 0.25f * (((gather3(D, X, Y, Z, pp[0], pp[1], pp[2]) -
                                   gather3(D, X, Y, Z, pm[0], pm[1], pm[2])) -
                                  gather3(D, X, Y, Z, mp[0], mp[1], mp[2])) +
                                 gather3(D, X, Y, Z, mm[0], mm[1], mm[2]));
        h[d][e] = v;
        h[e][d] = v;
      }
    }
    // LU with partial pivoting of h, the same row swaps applied to g
    float a[3][3], y[3];
    for (int r = 0; r < 3; ++r) {
      y[r] = g[r];
      for (int cc = 0; cc < 3; ++cc) a[r][cc] = h[r][cc];
    }
    float sgn = 1.0f;
    for (int j = 0; j < 3; ++j) {
      int piv = j;
      float best = fabsf(a[j][j]);
      for (int r = j + 1; r < 3; ++r) {
        if (fabsf(a[r][j]) > best) {
          best = fabsf(a[r][j]);
          piv = r;
        }
      }
      if (piv != j) {
        for (int cc = 0; cc < 3; ++cc) {
          const float tmp = a[j][cc];
          a[j][cc] = a[piv][cc];
          a[piv][cc] = tmp;
        }
        const float ty = y[j];
        y[j] = y[piv];
        y[piv] = ty;
        sgn = -sgn;
      }
      for (int r = j + 1; r < 3; ++r) {
        const float l = a[j][j] != 0.0f ? a[r][j] / a[j][j] : 0.0f;
        a[r][j] = l;
        for (int cc = j + 1; cc < 3; ++cc) a[r][cc] = a[r][cc] - l * a[j][cc];
      }
    }
    const float det = ((a[0][0] * a[1][1]) * a[2][2]) * sgn;
    const bool det_ok = fabsf(det) > 1e-12f;
    float off[3] = {0.0f, 0.0f, 0.0f};
    if (det_ok) {
      y[1] = y[1] - a[1][0] * y[0];
      y[2] = (y[2] - a[2][0] * y[0]) - a[2][1] * y[1];
      const float x2 = y[2] / a[2][2];
      const float x1 = (y[1] - a[1][2] * x2) / a[1][1];
      const float x0 = ((y[0] - a[0][1] * x1) - a[0][2] * x2) / a[0][0];
      off[0] = fminf(fmaxf(-x0, -1.0f), 1.0f);
      off[1] = fminf(fmaxf(-x1, -1.0f), 1.0f);
      off[2] = fminf(fmaxf(-x2, -1.0f), 1.0f);
    }
    for (int d = 0; d < 3; ++d) res[d] = static_cast<float>(p[d]) + off[d];
    value = c + 0.5f * ((g[0] * off[0] + g[1] * off[1]) + g[2] * off[2]);
    bool moved = false;
    for (int d = 0; d < 3; ++d) moved = moved || fabsf(off[d]) > 0.5f;
    active = moved && det_ok;
    if (active)
      for (int d = 0; d < 3; ++d)
        if (fabsf(off[d]) > 0.5f) p[d] += off[d] > 0.0f ? 1 : -1;
  }
  const bool ok = valid[q] != 0;
  for (int d = 0; d < 3; ++d) sub[3 * q + d] = ok ? res[d] : 0.0f;
  val[q] = ok ? value : 0.0f;
}

}  // namespace

extern "C" int bst_dog_blur(const void* x, int in_dtype, int B, int X, int Y,
                            int Z, int axis, const float* taps, int r,
                            int route, int gx, int gy, int gz, int chunk,
                            float* out, void* stream) {
  const int64_t yz = static_cast<int64_t>(Y) * Z;
  if (B < 1 || B > 65535 || X < 1 || X > 65535 || Y < 1 || Z < 1 ||
      yz > 2147483647LL || axis < 0 || axis > 2 || r < 0 || gx < 1 ||
      gy < 1 || gz < 1 || gy > 65535 || gz > 65535)
    return cudaErrorInvalidValue;
  // the plan of ops/dog.py blur_plan, checked to cover every output once
  bool ok = false;
  if (route == BLUR_RUN) {
    const int64_t lines = axis == 0   ? yz
                          : axis == 1 ? static_cast<int64_t>(X) * Z
                                      : static_cast<int64_t>(X) * Y;
    const int n = axis == 0 ? X : axis == 1 ? Y : Z;
    ok = (axis < 2 || r > kBlurMaxChunk) && gz == B &&
         static_cast<int64_t>(gx) * kBlurRunThreads >= lines &&
         static_cast<int64_t>(gx - 1) * kBlurRunThreads < lines &&
         static_cast<int64_t>(gy) * kBlurRun >= n &&
         static_cast<int64_t>(gy - 1) * kBlurRun < n;
  } else if (route == BLUR_ROW) {
    const int64_t items =
        static_cast<int64_t>(B) * X * Y * ((Z + chunk - 1) / (chunk > 0 ? chunk : 1));
    ok = axis == 2 && chunk >= 1 && chunk <= kBlurMaxChunk && chunk <= Z &&
         r <= kBlurMaxChunk && gy == 1 && gz == 1 &&
         static_cast<int64_t>(gx) * kBlurRowWarps >= items &&
         static_cast<int64_t>(gx - 1) * kBlurRowWarps < items;
  }
  if (!ok) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(gx, gy, gz);
  switch (in_dtype) {
    case bst::IN_U8:
      return launch_blur<uint8_t>(x, B, X, Y, Z, axis, taps, r, route, grid,
                                  chunk, out, s);
    case bst::IN_U16:
      return launch_blur<uint16_t>(x, B, X, Y, Z, axis, taps, r, route, grid,
                                   chunk, out, s);
    case bst::IN_I16:
      return launch_blur<int16_t>(x, B, X, Y, Z, axis, taps, r, route, grid,
                                  chunk, out, s);
    case bst::IN_F32:
      return launch_blur<float>(x, B, X, Y, Z, axis, taps, r, route, grid,
                                chunk, out, s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <int V>
static cudaError_t launch_extrema(const float* b1, const float* b2, int B,
                                  int X, int Y, int Z, int ty, int tz, int xc,
                                  const float* scale, const float* thr,
                                  const int* origins, int find_max,
                                  int find_min, int halo, float* dog,
                                  uint8_t* mask, int* cand_idx,
                                  float* cand_score, int* count,
                                  cudaStream_t s) {
  const int ntz = (Z + tz - 1) / tz;
  const int64_t tiles = static_cast<int64_t>((Y + ty - 1) / ty) * ntz;
  const int chunks = (X + xc - 1) / xc;
  const size_t smem =
      sizeof(float) * kExRing * (ty + 2) *
          static_cast<size_t>(((tz + 3) & ~3) + 8) +
      sizeof(uint16_t) * kExWarpQueue * (kExThreads / 32);
  if (tiles > 2147483647LL || chunks > 65535 || smem > 232448)
    return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      extrema_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid(static_cast<unsigned int>(tiles), chunks, B);
  extrema_kernel<V><<<grid, kExThreads, smem, s>>>(
      b1, b2, X, Y, Z, ty, tz, xc, ntz, scale, thr, origins, find_max,
      find_min, halo, dog, mask, cand_idx, cand_score, count);
  return cudaGetLastError();
}

// The launch plan (vec, ty, tz, xc) is ops/dog.py extrema_plan's: vec
// loads float4s along z (Z % 4 == 0, b1, b2, dog 16-byte and the mask
// 4-byte aligned); a tile of ty x tz voxels and its halo is at most
// kExItems loads a thread, and a ring slot's offsets fit 16 bits (the
// warps' queues).
extern "C" int bst_dog_extrema(const float* b1, const float* b2, int B, int X,
                               int Y, int Z, const float* scale,
                               const float* thr, const int* origins,
                               int find_max, int find_min, int halo, int vec,
                               int ty, int tz, int xc, float* dog,
                               uint8_t* mask, int* cand_idx,
                               float* cand_score, int* count, void* stream) {
  const int64_t vol = static_cast<int64_t>(X) * Y * Z;
  const int V = vec ? 4 : 1;
  if (B < 1 || B > 65535 || X < 1 || Y < 1 || Z < 1 || vol > 2147483647LL ||
      halo < 0 ||
      (cand_idx != nullptr && (cand_score == nullptr || count == nullptr)) ||
      ty < 1 || tz < 1 || xc < 1 || tz % V != 0 ||
      static_cast<int64_t>(ty + 2) * (tz / V) > kExItems * kExThreads ||
      2 * (ty + 2) > kExThreads ||
      static_cast<int64_t>(ty + 2) * (((tz + 3) & ~3) + 8) > 65535 ||
      (vec && (Z % 4 != 0 ||
               ((reinterpret_cast<uintptr_t>(b1) |
                 reinterpret_cast<uintptr_t>(b2) |
                 reinterpret_cast<uintptr_t>(dog)) & 15) ||
               (reinterpret_cast<uintptr_t>(mask) & 3))))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      vec ? launch_extrema<4>(b1, b2, B, X, Y, Z, ty, tz, xc, scale, thr,
                              origins, find_max, find_min, halo, dog, mask,
                              cand_idx, cand_score, count, s)
          : launch_extrema<1>(b1, b2, B, X, Y, Z, ty, tz, xc, scale, thr,
                              origins, find_max, find_min, halo, dog, mask,
                              cand_idx, cand_score, count, s));
}

// The launch plan is ops/dog.py topk_plan's: grid (ceil(K /
// kTopkThreads), B), K keys of dynamic shared memory.
extern "C" int bst_dog_topk(const int* cand_idx, const float* cand_score,
                            const int* count, int B, int X, int Y, int Z,
                            int K, int G, int* idx_out, uint8_t* valid_out,
                            void* stream) {
  const int64_t vol = static_cast<int64_t>(X) * Y * Z;
  if (B < 1 || B > 65535 || X < 1 || Y < 1 || Z < 1 || vol > 2147483647LL ||
      K < 1 || K > vol || K > kTopkMaxK ||
      G != (K + kTopkThreads - 1) / kTopkThreads)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = static_cast<size_t>(K) * sizeof(uint64_t);
  cudaError_t e = cudaFuncSetAttribute(
      topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  topk_kernel<<<dim3(G, B), kTopkThreads, smem, s>>>(
      cand_idx, cand_score, count, vol, K, Y, Z, idx_out, valid_out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bst_dog_localize(const float* dog, int B, int X, int Y, int Z,
                                const int* idx, const uint8_t* valid, int K,
                                float* sub, float* val, void* stream) {
  if (B < 1 || X < 1 || Y < 1 || Z < 1 || K < 1 ||
      static_cast<int64_t>(X) * Y * Z > 2147483647LL)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t n = static_cast<int64_t>(B) * K;
  localize_kernel<<<static_cast<unsigned int>((n + 127) / 128), 128, 0, s>>>(
      dog, B, X, Y, Z, idx, valid, K, sub, val);
  return static_cast<int>(cudaGetLastError());
}
