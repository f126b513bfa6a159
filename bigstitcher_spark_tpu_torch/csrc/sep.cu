// K5: per-block fusion of views with a diagonal block->patch affine, the
// port of fuse_block_sep (bigstitcher_spark_tpu/ops/fusion.py:276, impl
// fuse_block_sep_impl :249, per view _one_view_sep :226 with
// _separable_interp_matrix :509, combine _combine_views :281).
//
// A diagonal affine (translation-registered tiles under
// --preserveAnisotropy z scaling, or mirrored axes) maps output voxel
// (i, j, k) to patch position (diag_x i + t_x, diag_y j + t_y,
// diag_z k + t_z), each coordinate one fused multiply-add (XLA contracts
// the JAX expression so; with one rounding instead of two, a steep image
// sampled at a position one ulp off would differ visibly). Trilinear
// sampling then factorises per axis: each axis has its two taps and weight
// from one row of _separable_interp_matrix over the patch extent
// (interp_row with pad 0: the position clamps to [0, c-1], lo to [0, c-2],
// hi = min(lo+1, c-1)), and the 8 taps are contracted along x,
// then y, then z - the order of the JAX program's three tensordots, so the
// plain twin (ops/fusion.py fuse_block_sep_plain) rounds as this kernel
// does. The blend weight and inside mask are outer products of per-view 1-D
// vectors; the wrapper computes them once per block (ops/fusion.py
// sep_axis_tables, shared with the twin) into `tables` (V, 2, bx+by+bz):
// [v][0] blend, [v][1] inside, x then y then z.
//
// Launch (ops/fusion.py sep_launch_plan): a thread owns kSepR = 4 z
// outputs of one (i, j) column, lanes_z threads a column (K2's and K3's
// choice), a block of 256 threads a tile of one i (tile_j columns x tile_z
// outputs); grid index blockIdx.z is the batch row. A thread's outputs
// are interleaved, k = z0 + lz + lanes_z r, so that the lanes of a column
// read neighbouring patch values at each tap. No division runs per voxel:
// a thread finds its place once, 32-bit.
//   * Taps computed once. Per view a block tabulates, in shared memory,
//     the x tap of its i (one a block), the y taps of its tile_j columns
//     and the z taps of its tile_z ks, each with the parent's very
//     fmaf(diag, c, t) and interp_row; with them a column's 4 patch-row
//     offsets (lo_x / hi_x by lo_y / hi_y), its 1 - f_y, and its x-y
//     products ins[i] ins[bx+j] and w[i] w[bx+j]; a k's lo_z, f_z and z
//     tables. Up to 8 views a stage, as 47 KB of shared memory allow.
//   * Sampling. A voxel reads its 8 taps straight from the patch (L1):
//     each of the column's 4 rows at lo_z and, in the same 4-byte window,
//     at lo_z + 1 (hi_z = lo_z + 1 whenever the z extent is 2 or more; the
//     generic instantiation takes min(lo_z + 1, pz - 1)). Integer taps
//     convert with a bit-or into 2^23's significand and one subtraction.
//   * The fusion type is a template parameter (K2's and K3's dispatch;
//     read at run time in the generic instantiation only: patches of 2^31
//     elements or more, or a z extent of 1).
// What sets its time (probes on the card; PERF.md's K5 findings): the taps'
// gathers. With each lane's z tap replaced by its lane index (neighbouring
// lanes on neighbouring values) the kernel takes 0.050 ms at the main
// path's block, without any tap 0.036 ms, as it stands 0.086 ms: with
// diag_z = 3 a column's 16 lanes read values 6 bytes apart, 1-2 L1 lines
// a load, and each (x, y) row is read by two neighbouring columns.
// Tried on the card and not kept (each slower at the main path's block):
//   * taps staged in shared memory as (lo_z, hi_z) pairs of the tile's 2
//     x-planes and tile_j + 1 y rows, one 16-byte read a row for a run of
//     4 consecutive ks (0.154-0.158 ms), and as x-lerped rows (0.160 ms):
//     filling them is latency-bound and their 41-46 KB of shared memory
//     cost the views left in L1 their cache;
//   * consecutive runs k = z0 + lz R + r (K2's; 0.097 ms), 2 outputs a
//     thread with 32 lanes a column (0.093 ms), 8 a thread (0.103 ms);
//   * I2F conversions (the same time: the bit-or form is kept for its
//     full-rate instructions), 3, 4 or 6 blocks an SM (0.086-0.101 ms),
//     the views loop unrolled by 2 or 4 (0.090-0.098 ms).
//
// Batch form (bst_fuse_block_sep_batch, ops/fusion.py fuse_block_sep_batch):
// the sharded route's batch of B blocks of one bucket (parallel/mesh.py:223
// vmap of fuse_block_sep_impl) in one launch; grid index blockIdx.z selects
// the block, whose patches, diagonals, translations, tables and valid mask
// are read at a row stride. The per-block launch is the batch of one, so a
// row is bitwise the per-block output; padding rows (valid all 0) write
// zeros.
//
// Bound: bytes, the patch values the taps touch (each read once from
// device memory) and two floats written a voxel. The kernel issues ~64
// instructions a view-voxel (8 tap loads with their addresses and
// conversions, 21 for the three contractions, 7 for the combine); the
// gathers above, not the bytes, set its time.
#include "fusion_common.cuh"

namespace {

// Threads a block (ops/fusion.py SEP_THREADS), blocks an SM the register
// budget is set for, and z outputs a thread (SEP_R).
constexpr int kSepThreads = 256;
constexpr int kSepBlocksPerSM = 5;
constexpr int kSepR = 4;
// Dynamic shared memory a block may take without opting in, less the
// static constants (ops/fusion.py SEP_SMEM).
constexpr int kSepSmemBytes = 48 * 1024 - 1024;

// A view's x tap (one a block: its i) and valid flag.
struct __align__(16) SepView {
  float fx, gx, valid, unused;
};

// A column's y weights and x-y products of one view.
struct __align__(16) SepColumn {
  float fy, gy, ins, blend;
};

// A k's z tap and z tables of one view.
struct __align__(16) SepZ {
  int lo;
  float f, ins, blend;
};

// A thread's r-th output along z: z0 + lz + lanes_z r.
__device__ __forceinline__ int kofs(int lz, int lanes_z, int r) {
  return lz + lanes_z * r;
}

// A patch value as float32, read through L1. Integers convert exactly
// with a bit-or into the significand of 2^23 and one subtraction: the
// value static_cast<float> gives, +0 for 0.
template <typename T>
__device__ __forceinline__ float tap(const T* p);

template <>
__device__ __forceinline__ float tap<float>(const float* p) {
  return __ldg(p);
}

template <>
__device__ __forceinline__ float tap<uint16_t>(const uint16_t* p) {
  return __uint_as_float(0x4B000000u | __ldg(p)) - 8388608.0f;
}

template <>
__device__ __forceinline__ float tap<uint8_t>(const uint8_t* p) {
  return __uint_as_float(0x4B000000u | __ldg(p)) - 8388608.0f;
}

// int16: s + 2^15 in [0, 2^16) in the significand, less 2^23 + 2^15
template <>
__device__ __forceinline__ float tap<int16_t>(const int16_t* p) {
  const unsigned u = static_cast<uint16_t>(__ldg(p)) ^ 0x8000u;
  return __uint_as_float(0x4B000000u | u) - 8421376.0f;
}

// Grid: (bx n_jt, z tiles, B); ops/fusion.py sep_launch_plan, which also
// gives nvs (views tabulated at once). Dynamic shared memory, per stage:
// the nvs views' SepView, then their columns (tile_j SepColumn each), z
// taps (tile_z SepZ each) and the columns' 4 patch-row offsets (Idx).
template <typename T, typename Idx, int FT>
__global__ void __launch_bounds__(kSepThreads, kSepBlocksPerSM)
    fuse_block_sep_kernel(
    const T* __restrict__ patches, int px, int py, int pz,
    const float* __restrict__ diags, const float* __restrict__ ts,
    const float* __restrict__ tables, const float* __restrict__ valid, int V,
    int bx, int by, int bz, int ft, int lanes_z, int n_jt, int nvs,
    float* __restrict__ fused, float* __restrict__ wsum) {
  constexpr bool kGeneric = FT == bst::kRuntimeFT;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tile_j = kSepThreads / lanes_z;
  const int tile_z = kSepR * lanes_z;
  SepView* sv = reinterpret_cast<SepView*>(smem);
  SepColumn* scol = reinterpret_cast<SepColumn*>(sv + nvs);
  SepZ* sz = reinterpret_cast<SepZ*>(scol + nvs * tile_j);
  Idx* srow = reinterpret_cast<Idx*>(sz + nvs * tile_z);
  const int S = bx + by + bz;
  const int64_t pvol = static_cast<int64_t>(px) * py * pz;
  const int64_t n = static_cast<int64_t>(bx) * by * bz;
  {
    // the batch row: its views' patches and parameters, its outputs
    const int64_t row = blockIdx.z;
    patches += row * V * pvol;
    diags += row * V * 3;
    ts += row * V * 3;
    tables += row * V * 2 * S;
    valid += row * V;
    fused += row * n;
    wsum += row * n;
  }
  const int lz = threadIdx.x & (lanes_z - 1);
  const int jj = threadIdx.x / lanes_z;
  const int i = blockIdx.x / n_jt;
  const int j0 = (blockIdx.x - i * n_jt) * tile_j;
  const int j = j0 + jj;
  const int z0 = blockIdx.y * tile_z;

  bst::CombinerT<FT> comb[kSepR];
#pragma unroll
  for (int r = 0; r < kSepR; ++r) comb[r] = bst::CombinerT<FT>(ft);
  const bool blended = comb[0].kind() == bst::AVG_BLEND;

  for (int c0 = 0; c0 < V; c0 += nvs) {
    const int nv = min(nvs, V - c0);
    __syncthreads();  // the previous stage is read
    // the views' x taps (the block's i)
    for (int t = threadIdx.x; t < nv; t += kSepThreads) {
      const int v = c0 + t;
      int lo, hi;
      float f;
      bst::interp_row(fmaf(diags[3 * v], static_cast<float>(i), ts[3 * v]),
                      0, px, &lo, &hi, &f);
      sv[t] = SepView{f, 1.0f - f, valid[v], 0.0f};
    }
    // the columns: y taps, x-y products and patch-row offsets (a column
    // past the block takes the last one's: computed, never stored)
    for (int t = threadIdx.x; t < nv * tile_j; t += kSepThreads) {
      const int vv = t / tile_j, u = t - vv * tile_j;
      const int v = c0 + vv;
      const int jc = min(j0 + u, by - 1);
      int xlo, xhi, ylo, yhi;
      float fx, fy;
      bst::interp_row(fmaf(diags[3 * v], static_cast<float>(i), ts[3 * v]),
                      0, px, &xlo, &xhi, &fx);
      bst::interp_row(
          fmaf(diags[3 * v + 1], static_cast<float>(jc), ts[3 * v + 1]), 0,
          py, &ylo, &yhi, &fy);
      const float* tb = tables + static_cast<int64_t>(2 * v) * S;
      scol[t] = SepColumn{fy, 1.0f - fy, tb[S + i] * tb[S + bx + jc],
                          blended ? tb[i] * tb[bx + jc] : 0.0f};
      Idx* ro = srow + 4 * t;
      ro[0] = (static_cast<Idx>(xlo) * py + ylo) * pz;
      ro[1] = (static_cast<Idx>(xhi) * py + ylo) * pz;
      ro[2] = (static_cast<Idx>(xlo) * py + yhi) * pz;
      ro[3] = (static_cast<Idx>(xhi) * py + yhi) * pz;
    }
    // the z taps and z tables of the tile's ks (past the block: the last
    // k's, never stored)
    for (int t = threadIdx.x; t < nv * tile_z; t += kSepThreads) {
      const int vv = t / tile_z, u = t - vv * tile_z;
      const int v = c0 + vv;
      const int kc = min(z0 + u, bz - 1);
      int lo, hi;
      float f;
      bst::interp_row(
          fmaf(diags[3 * v + 2], static_cast<float>(kc), ts[3 * v + 2]), 0,
          pz, &lo, &hi, &f);
      const float* tb = tables + static_cast<int64_t>(2 * v) * S;
      sz[t] = SepZ{lo, f, tb[S + bx + by + kc],
                   blended ? tb[bx + by + kc] : 0.0f};
    }
    __syncthreads();
    if (j >= by) continue;
#pragma unroll 1
    for (int vv = 0; vv < nv; ++vv) {
      const T* P = patches + static_cast<int64_t>(c0 + vv) * pvol;
      const SepView s = sv[vv];
      const SepColumn col = scol[vv * tile_j + jj];
      const Idx* ro = srow + 4 * (vv * tile_j + jj);
      const T* row[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) row[q] = bst::offset32(P, ro[q]);
#pragma unroll
      for (int r = 0; r < kSepR; ++r) {
        const SepZ z = sz[vv * tile_z + kofs(lz, lanes_z, r)];
        // hi_z = min(lo_z + 1, pz - 1): lo_z + 1 unless pz is 1
        const int dz = kGeneric ? min(z.lo + 1, pz - 1) - z.lo : 1;
        float vy[2][2];  // [cz][cy]
#pragma unroll
        for (int cy = 0; cy < 2; ++cy) {
          const T* a = bst::offset32(row[2 * cy], z.lo);
          const T* b = bst::offset32(row[2 * cy + 1], z.lo);
          vy[0][cy] = tap(a) * s.gx + tap(b) * s.fx;
          vy[1][cy] = tap(a + dz) * s.gx + tap(b + dz) * s.fx;
        }
        float vz[2];
#pragma unroll
        for (int cz = 0; cz < 2; ++cz)
          vz[cz] = vy[cz][0] * col.gy + vy[cz][1] * col.fy;
        const float sample = vz[0] * (1.0f - z.f) + vz[1] * z.f;
        comb[r].add(sample, col.ins * z.ins, col.blend * z.blend, s.valid);
      }
    }
  }
  if (j >= by) return;
  const int64_t at = (static_cast<int64_t>(i) * by + j) * bz + z0;
#pragma unroll
  for (int r = 0; r < kSepR; ++r) {
    const int u = kofs(lz, lanes_z, r);
    if (z0 + u < bz) {
      fused[at + u] = comb[r].fused();
      wsum[at + u] = comb[r].wsum;
    }
  }
}

template <typename T, typename Idx, int FT>
cudaError_t launch_sep(dim3 grid, cudaStream_t s, int smem, const T* patches,
                       int px, int py, int pz, const float* diags,
                       const float* ts, const float* tables,
                       const float* valid, int V, int bx, int by, int bz,
                       int ft, int lanes_z, int n_jt, int nvs, float* fused,
                       float* wsum) {
  fuse_block_sep_kernel<T, Idx, FT><<<grid, kSepThreads, smem, s>>>(
      patches, px, py, pz, diags, ts, tables, valid, V, bx, by, bz, ft,
      lanes_z, n_jt, nvs, fused, wsum);
  return cudaGetLastError();
}

}  // namespace

// lanes_z, n_jt, grid_x, grid_y, nvs, smem, generic: ops/fusion.py
// sep_launch_plan (generic: patches of 2^31 elements or more, or a z
// extent of 1: 64-bit patch indices, the fusion type read at run time).
// patches (B, V, px, py, pz), diags, ts (B, V, 3), tables (B, V, 2,
// bx+by+bz), valid (B, V); fused, wsum (B, bx, by, bz).
extern "C" int bst_fuse_block_sep_batch(
    const void* patches, int in_dtype, int px, int py, int pz,
    const void* diags, const void* ts, const void* tables, const void* valid,
    int B, int V, int bx, int by, int bz, int ft, int lanes_z, int n_jt,
    int grid_x, int grid_y, int nvs, int smem, int generic, void* fused,
    void* wsum, void* stream) {
  const int64_t n = static_cast<int64_t>(bx) * by * bz;
  if (n <= 0 || V <= 0 || px <= 0 || py <= 0 || pz <= 0 || B <= 0 ||
      B > 65535)
    return cudaErrorInvalidValue;
  const int tile_j = kSepThreads / lanes_z;
  const int tile_z = kSepR * lanes_z;
  if (lanes_z < 1 || lanes_z > 32 || (lanes_z & (lanes_z - 1)) != 0 ||
      n_jt != (by + tile_j - 1) / tile_j ||
      static_cast<int64_t>(grid_x) != static_cast<int64_t>(bx) * n_jt ||
      static_cast<int64_t>(grid_y) * tile_z < bz ||
      static_cast<int64_t>(grid_y - 1) * tile_z >= bz || grid_y > 65535)
    return cudaErrorInvalidValue;
  const int64_t pvol = static_cast<int64_t>(px) * py * pz;
  const bool need_generic = pvol >= (int64_t{1} << 31) || pz < 2;
  if (need_generic && !generic) return cudaErrorInvalidValue;
  const int isz = generic ? 8 : 4;
  const int64_t need =
      static_cast<int64_t>(nvs) *
      (sizeof(SepView) + tile_j * (sizeof(SepColumn) + 4 * isz) +
       tile_z * sizeof(SepZ));
  if (nvs < 1 || nvs > bst::kResampleViewChunk || smem < need ||
      smem > kSepSmemBytes)
    return cudaErrorInvalidValue;
  const dim3 grid(grid_x, grid_y, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
#define BST_SEP_ARGS(T)                                                      \
  grid, s, smem, static_cast<const T*>(patches), px, py, pz,                \
      static_cast<const float*>(diags), static_cast<const float*>(ts),      \
      static_cast<const float*>(tables), static_cast<const float*>(valid),  \
      V, bx, by, bz, ft, lanes_z, n_jt, nvs, static_cast<float*>(fused),    \
      static_cast<float*>(wsum)
  if (generic) {
    BST_DISPATCH_IN(in_dtype, T,
        err = (launch_sep<T, int64_t, bst::kRuntimeFT>(BST_SEP_ARGS(T))));
  } else {
    BST_DISPATCH_IN(in_dtype, T,
        BST_DISPATCH_FT(ft, FT,
            err = (launch_sep<T, int, FT>(BST_SEP_ARGS(T)))));
  }
#undef BST_SEP_ARGS
  return static_cast<int>(err);
}
