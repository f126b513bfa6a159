// K26: per-block non-rigid fusion, the port of nonrigid_fuse_block
// (bigstitcher_spark_tpu/ops/nonrigid.py:104 nonrigid_fuse_block_impl, jit
// :133, with _sample_one_view_nonrigid :62, and ops/fusion.py
// _separable_interp_matrix :509, _trilinear_sample, _blend_weight and
// _combine_views).
//
// Each view carries a (Gx, Gy, Gz) grid of vertex models, 12 float32 each
// (row-major 3x4, target world -> view world). Per output voxel:
//   * the grid coordinate along each axis, ((origin + i) - grid_origin) /
//     spacing, takes the two taps of _separable_interp_matrix's clamp rule
//     (position clamped to [0, c-1], low tap to [0, c-2]); the taps are the
//     same for every view and are computed once;
//   * the 12 coefficients are interpolated along x at the four (y, z)
//     corners, then along y, then along z (the JAX tensordot order), each
//     lerp fma(b, f, a * (1 - f)) (lerp4);
//   * the world position w = origin + (i, j, k) is deformed to
//     d = A0 wx + A1 wy + A2 wz + A3 and mapped into the patch by the
//     view's affine, each row rounded as XLA contracts it on the CPU
//     (apply_row);
//   * the patch is sampled trilinearly, clamped at its edges, weighted by
//     the inside test and the cosine blend at the level position, and the
//     views combined in view order by fusion type (bst::CombinerT, as K3).
// The first form ran one thread per output voxel and redid, for every
// voxel, the three grid taps (each with a divide) and the x and y stages
// of the coefficient lerp (24 float4 vertex reads and ~250 flops a
// view-voxel): 0.60 ms at the main path's block, 16x its bound. This
// form takes K3's launch (ops/fusion.py resample_plan: a block a tile of
// one i, tile_j columns along j, 4 lanes_z outputs along z; per-view
// parameters staged in shared memory 8 views at a time; 32-bit patch
// indices below 2^31 elements, each address one wide multiply-add; the
// fusion type a template parameter), except that a thread's 4 voxels are
// lanes_z apart along z, so that a warp's lanes read consecutive k (the
// samples here are gathered per voxel, not in runs). It shares what the
// parent recomputed:
//   * the grid taps: x once a block (one i), y once a column of the tile,
//     z once a block for each k of the tile, into shared memory;
//   * the x and y lerps: the parent's voxel computes
//       c = lerp4(lerp4(a00, a10, g1, f1), lerp4(a01, a11, g1, f1), g2, f2)
//     with a00, a10 the x-lerps at (lo1, lo2), (hi1, lo2) and a01, a11 at
//     (lo1, hi2), (hi1, hi2). So lerp4(a00, a10, g1, f1) is
//     C_xy(lo2) = lerp4(x(lo1, lo2), x(hi1, lo2), g1, f1) and the second
//     operand C_xy(hi2): values that depend only on the column (i, j) and
//     the z vertex, and x(y, z) only on i and the vertex. A block computes
//     x(yv, zv) once for each (y, z) vertex its tile reaches (~4 x 8 at
//     -cpd 10), then C_xy(zv) once for each column and z vertex, into
//     shared memory, in the parent's operations; a voxel does only the z
//     lerp lerp4(C_xy(lo2), C_xy(hi2), g2, f2). The same operations on the
//     same operands, so the same values: outputs bitwise equal to the
//     first form's. The tables of as many views as fit (40 KB) are built
//     between barriers (the main path's 4 views at once); a tile whose
//     z range reaches more vertices than one view's tables hold (a spacing
//     below ~1.6 voxels at 64 z outputs a tile) takes the parent's
//     per-voxel lerps instead, with the shared taps.
//
// Batch form (bst_nonrigid_fuse_batch, the one entry; ops/nonrigid.py
// nonrigid_fuse_block_batch): the sharded route's batch of B blocks of one
// bucket (models/nonrigid_fusion.py:263-273, the vmap of
// nonrigid_fuse_block_impl) in one launch. A bucket shares its block, patch
// shape and view count, so the launch plan (resample_plan) is the
// per-block one; grid index blockIdx.z selects the block, whose patches,
// grids, per-view parameters, origins and outputs sit at a row stride. The
// kBatch template parameter keeps the per-block instantiation the
// parent's code: a row is bitwise the per-block output. A padding row
// (valid all 0) loops over no view and writes zeros, what its views would
// have given.
//
// Bound: operations at the main path's compute block (256x256x64, 4
// uint16 views): ~150 flops a view-voxel (the z lerp of 12 coefficients,
// the deform, the view affine, the sample and the blend; the grid taps and
// the x and y lerps are a column's), 0.038 ms at 67 TFLOP/s; the patches,
// grids (~100 KB a view) and outputs, ~97 MB, take 0.029 ms.
#include "fusion_common.cuh"

namespace {

// One row of _separable_interp_matrix over an extent c: taps lo (weight
// 1-f) and hi (weight f).
__device__ __forceinline__ void grid_taps(float pos, int c, int* lo, int* hi,
                                          float* f) {
  const float p = fminf(fmaxf(pos, 0.0f), static_cast<float>(c - 1));
  const int l = min(max(static_cast<int>(floorf(p)), 0), max(c - 2, 0));
  *f = p - static_cast<float>(l);
  *lo = l;
  *hi = min(l + 1, c - 1);
}

// The two nonzero terms of a row of _separable_interp_matrix, accumulated
// as XLA's dot accumulates them on the CPU at the main path's shapes:
// fma(b, f, a * g) with g = 1 - f.
__device__ __forceinline__ float4 lerp4(float4 a, float4 b, float g, float f) {
  return make_float4(fmaf(b.x, f, a.x * g), fmaf(b.y, f, a.y * g),
                     fmaf(b.z, f, a.z * g), fmaf(b.w, f, a.w * g));
}

// c0 x + c1 y + c2 z + c3 as XLA contracts the JAX expression on the CPU:
// fma(c2, z, fma(c0, x, c1 y)) + c3 (explicit fmaf: -fmad=false only stops
// the compiler from contracting on its own)
__device__ __forceinline__ float apply_row(const float* c, const float* x) {
  return fmaf(c[2], x[2], fmaf(c[0], x[0], c[1] * x[1])) + c[3];
}

// One view's parameters in shared memory.
struct NonrigidView {
  float M[12];   // view world -> patch position, row-major 3x4
  float off[3];  // patch -> level position
  bst::AxisTerms ax[3];
  float valid;
};

// One grid coordinate's taps (grid_taps) and weights.
struct Taps {
  int lo, hi;
  float f, g;
};

__device__ __forceinline__ Taps taps_at(float w, float origin, float spacing,
                                        int c) {
  Taps t;
  grid_taps((w - origin) / spacing, c, &t.lo, &t.hi, &t.f);
  t.g = 1.0f - t.f;
  return t;
}

// float4s of the C_xy tables (32 KB): tile_j columns x vertices x 3 quads
// (+ 1 of padding a column) a view, for as many views as fit; and of the
// x-lerped vertex rows they are built from (8 KB): the tile's y vertices x
// z vertices x 3 quads a view
constexpr int kTableF4 = 2048;
constexpr int kRowsF4 = 512;

// Quad q of the grid's vertex record (x, y, z).
__device__ __forceinline__ float4 vertex(const float* __restrict__ G, int x,
                                         int y, int z, int q, int gy,
                                         int gz) {
  const int64_t at = ((static_cast<int64_t>(x) * gy + y) * gz + z) * 12;
  return __ldg(reinterpret_cast<const float4*>(G + at) + q);
}

// Quad q of one column's model at z vertex z: the x lerps at (y lo, z)
// and (y hi, z), then their y lerp (the parent's a00 / a10 and their lerp).
__device__ __forceinline__ float4 cxy(const float* __restrict__ G,
                                      const Taps& tx, const Taps& ty, int z,
                                      int q, int gy, int gz) {
  const float4 a0 = lerp4(vertex(G, tx.lo, ty.lo, z, q, gy, gz),
                          vertex(G, tx.hi, ty.lo, z, q, gy, gz), tx.g, tx.f);
  const float4 a1 = lerp4(vertex(G, tx.lo, ty.hi, z, q, gy, gz),
                          vertex(G, tx.hi, ty.hi, z, q, gy, gz), tx.g, tx.f);
  return lerp4(a0, a1, ty.g, ty.f);
}

// 3 blocks an SM (80 registers): faster at the main path's block than 2
// (128 registers, no spills) or 4 (64).
template <typename T, typename Idx, int FT, bool kBatch>
__global__ void __launch_bounds__(bst::kResampleThreads, 3) nonrigid_kernel(
    const T* __restrict__ patches, int px, int py, int pz,
    const float* __restrict__ grids, int gx, int gy, int gz,
    const float* __restrict__ vaffs, const float* __restrict__ offsets,
    const float* __restrict__ img_dims, const float* __restrict__ borders,
    const float* __restrict__ ranges, const float* __restrict__ valid,
    const float* __restrict__ block_origin,
    const float* __restrict__ grid_origin,
    const float* __restrict__ grid_spacing, int V, int by, int bz, int ft,
    int lanes_z, int n_jt, float* __restrict__ fused,
    float* __restrict__ wsum) {
  if (kBatch) {
    // the batch row: its views' patches, grids and parameters, its
    // block's origins, its outputs (gridDim.x is bx n_jt)
    const int64_t row = blockIdx.z;
    const int64_t rv = row * V;
    patches += rv * px * py * pz;
    grids += rv * gx * gy * gz * 12;
    vaffs += rv * 12;
    offsets += rv * 3;
    img_dims += rv * 3;
    borders += rv * 3;
    ranges += rv * 3;
    valid += rv;
    block_origin += row * 3;
    grid_origin += row * 3;
    grid_spacing += row * 3;
    const int64_t n = static_cast<int64_t>(gridDim.x / n_jt) * by * bz;
    fused += row * n;
    wsum += row * n;
    bool dead = true;
    for (int v = 0; v < V; ++v) dead = dead && valid[v] == 0.0f;
    if (dead) V = 0;  // a padding row: no view, zeros
  }
  __shared__ NonrigidView sv[bst::kResampleViewChunk];
  __shared__ Taps ztab[bst::kResampleMaxTileZ];
  __shared__ Taps ytab[bst::kResampleThreads];
  __shared__ float4 ctab[kTableF4];
  __shared__ float4 xrows[kRowsF4];
  const int tile_j = bst::kResampleThreads / lanes_z;
  const int tile_z = bst::kResampleR * lanes_z;
  const int lz = threadIdx.x % lanes_z;
  const int lj = threadIdx.x / lanes_z;
  const int i = blockIdx.x / n_jt;
  const int j0 = (blockIdx.x % n_jt) * tile_j;
  const int j = j0 + lj;
  const int z0 = blockIdx.y * tile_z;
  // the thread's voxel r is at k = z0 + r lanes_z + lz: a warp's lanes
  // read consecutive k (the tile's k in any order are the plan's)
  const bool active = j < by && z0 + lz < bz;
  const int nzk = min(tile_z, bz - z0);  // >= 1: the plan's grid
  const float bo[3] = {__ldg(block_origin), __ldg(block_origin + 1),
                       __ldg(block_origin + 2)};
  const float go[3] = {__ldg(grid_origin), __ldg(grid_origin + 1),
                       __ldg(grid_origin + 2)};
  const float gs[3] = {__ldg(grid_spacing), __ldg(grid_spacing + 1),
                       __ldg(grid_spacing + 2)};

  // grid taps: z for each k of the tile (a k past the block's end takes
  // the last k's), y for each column, x of the row
  for (int t = threadIdx.x; t < tile_z; t += bst::kResampleThreads)
    ztab[t] = taps_at(bo[2] + static_cast<float>(z0 + min(t, nzk - 1)),
                      go[2], gs[2], gz);
  for (int t = threadIdx.x; t < tile_j; t += bst::kResampleThreads)
    ytab[t] = taps_at(bo[1] + static_cast<float>(j0 + t), go[1], gs[1], gy);
  const float w0 = bo[0] + static_cast<float>(i);
  const float w1 = bo[1] + static_cast<float>(j);
  const Taps xt = taps_at(w0, go[0], gs[0], gx);
  __syncthreads();
  const Taps yt = ytab[lj];
  // the tile's y and z vertices (the taps are monotone in j and k)
  const int vy0 = min(ytab[0].lo, ytab[tile_j - 1].lo);
  const int ny = max(ytab[0].hi, ytab[tile_j - 1].hi) - vy0 + 1;
  const int vz0 = min(ztab[0].lo, ztab[tile_z - 1].lo);
  const int nz = max(ztab[0].hi, ztab[tile_z - 1].hi) - vz0 + 1;
  // a view's tables: x-lerped rows, ny x nz x 3; the columns' models,
  // tile_j x (3 nz + 1), a column's stride padded by a float4 (the two
  // columns of a warp on other banks)
  const int per_rows = ny * nz * 3;
  const int col_stride = nz * 3 + 1;
  const int per_view = tile_j * col_stride;
  const bool tabled = per_view <= kTableF4 && per_rows <= kRowsF4;
  const int group = tabled ? min(kTableF4 / per_view, kRowsF4 / per_rows)
                           : bst::kResampleViewChunk;

  const int64_t gvol = static_cast<int64_t>(gx) * gy * gz * 12;
  const int64_t pvol = static_cast<int64_t>(px) * py * pz;
  const Idx syz = static_cast<Idx>(py) * pz;
  const int pmax[3] = {px - 1, py - 1, pz - 1};

  bst::CombinerT<FT> comb[bst::kResampleR];
#pragma unroll
  for (int r = 0; r < bst::kResampleR; ++r) comb[r] = bst::CombinerT<FT>(ft);

  for (int c0 = 0; c0 < V; c0 += bst::kResampleViewChunk) {
    const int nv = min(bst::kResampleViewChunk, V - c0);
    __syncthreads();  // the previous chunk's parameters and tables are read
    if (threadIdx.x < nv) {
      const int v = c0 + threadIdx.x;
      NonrigidView& s = sv[threadIdx.x];
      for (int q = 0; q < 12; ++q) s.M[q] = vaffs[12 * v + q];
      for (int d = 0; d < 3; ++d) {
        s.off[d] = offsets[3 * v + d];
        s.ax[d] = bst::axis_terms(img_dims[3 * v + d], 0.0f,
                                  borders[3 * v + d], ranges[3 * v + d]);
      }
      s.valid = valid[v];
    }
    __syncthreads();
    for (int g0 = 0; g0 < nv; g0 += group) {
      const int ng = min(group, nv - g0);
      if (tabled) {
        if (g0 > 0) __syncthreads();  // the previous group's tables are read
        // the x lerps at the tile's (y, z) vertices, every view of the
        // group (one round of vertex loads a thread)
        for (int t = threadIdx.x; t < ng * per_rows;
             t += bst::kResampleThreads) {
          const int vt = t / per_rows, e = t - vt * per_rows;
          const int yi = e / (3 * nz), rem = e - yi * 3 * nz;
          const float* Gv = grids + static_cast<int64_t>(c0 + g0 + vt) * gvol;
          const int zv = vz0 + rem / 3, q = rem % 3;
          xrows[t] = lerp4(vertex(Gv, xt.lo, vy0 + yi, zv, q, gy, gz),
                           vertex(Gv, xt.hi, vy0 + yi, zv, q, gy, gz), xt.g,
                           xt.f);
        }
        __syncthreads();
        // then each column's lanes lerp its entries along y
        for (int vt = 0; vt < ng; ++vt) {
          const float4* rows = xrows + vt * per_rows;
          float4* col = ctab + vt * per_view + lj * col_stride;
          for (int e = lz; e < 3 * nz; e += lanes_z)
            col[e] = lerp4(rows[(yt.lo - vy0) * 3 * nz + e],
                           rows[(yt.hi - vy0) * 3 * nz + e], yt.g, yt.f);
        }
        __syncthreads();
      }
      if (!active) continue;
      for (int vv = g0; vv < g0 + ng; ++vv) {
        const NonrigidView& s = sv[vv];
        const float* G = grids + static_cast<int64_t>(c0 + vv) * gvol;
        const float4* tab = ctab + (vv - g0) * per_view + lj * col_stride;
        const T* P = patches + static_cast<int64_t>(c0 + vv) * pvol;
        // each voxel of the run (one past the block's end takes the last
        // k's z taps and is dropped); ``model`` gives quad q of a voxel's
        // interpolated model from its z taps
        auto run = [&](auto model) {
#pragma unroll
          for (int r = 0; r < bst::kResampleR; ++r) {
            const int kt = r * lanes_z + lz;
            const Taps zt = ztab[kt];
            const float w[3] = {w0, w1, bo[2] + static_cast<float>(z0 + kt)};
            float A[12];
            for (int q = 0; q < 3; ++q) {
              const float4 c = model(zt, q);
              A[4 * q + 0] = c.x;
              A[4 * q + 1] = c.y;
              A[4 * q + 2] = c.z;
              A[4 * q + 3] = c.w;
            }
            float dw[3], p[3], f[3], g[3];
            int lo[3], hi[3];
            for (int rr = 0; rr < 3; ++rr) dw[rr] = apply_row(A + 4 * rr, w);
            for (int d = 0; d < 3; ++d) {
              p[d] = apply_row(s.M + 4 * d, dw);
              bst::sample_taps(p[d], pmax[d], &lo[d], &hi[d], &f[d]);
              g[d] = 1.0f - f[d];
            }
            const Idx xo[2] = {lo[0] * syz, hi[0] * syz};
            const Idx yo[2] = {static_cast<Idx>(lo[1]) * pz,
                               static_cast<Idx>(hi[1]) * pz};
            float c8[8];
#pragma unroll
            for (int n = 0; n < 8; ++n)
              c8[n] = static_cast<float>(__ldg(bst::offset32(
                  P, xo[n & 1] + yo[(n >> 1) & 1] + (n & 4 ? hi[2] : lo[2]))));
            const float val = bst::trilinear8(c8, f, g);
            float inside = 1.0f, blend = 1.0f;
            for (int d = 0; d < 3; ++d) {
              const float lpos = p[d] + s.off[d];
              inside = bst::inside_at(lpos, s.ax[d]) ? inside : 0.0f;
              blend = blend * bst::blend_at(lpos, s.ax[d]);
            }
            comb[r].add(val, inside, blend, s.valid);
          }
        };
        if (tabled) {
          run([&](const Taps& zt, int q) {
            return lerp4(tab[(zt.lo - vz0) * 3 + q],
                         tab[(zt.hi - vz0) * 3 + q], zt.g, zt.f);
          });
        } else {
          run([&](const Taps& zt, int q) {
            return lerp4(cxy(G, xt, yt, zt.lo, q, gy, gz),
                         cxy(G, xt, yt, zt.hi, q, gy, gz), zt.g, zt.f);
          });
        }
      }
    }
  }
  if (!active) return;
  // lanes on consecutive k: each store is coalesced
  const int64_t at = (static_cast<int64_t>(i) * by + j) * bz + z0 + lz;
#pragma unroll
  for (int r = 0; r < bst::kResampleR; ++r) {
    if (z0 + r * lanes_z + lz < bz) {
      fused[at + r * lanes_z] = comb[r].fused();
      wsum[at + r * lanes_z] = comb[r].wsum;
    }
  }
}

template <typename T, typename Idx, int FT, bool kBatch>
cudaError_t launch(dim3 grid, cudaStream_t s, const T* patches, int px, int py,
                   int pz, const float* grids, int gx, int gy, int gz,
                   const float* vaffs, const float* offsets,
                   const float* img_dims, const float* borders,
                   const float* ranges, const float* valid,
                   const float* block_origin, const float* grid_origin,
                   const float* grid_spacing, int V, int by, int bz, int ft,
                   int lanes_z, int n_jt, float* fused, float* wsum) {
  nonrigid_kernel<T, Idx, FT, kBatch><<<grid, bst::kResampleThreads, 0, s>>>(
      patches, px, py, pz, grids, gx, gy, gz, vaffs, offsets, img_dims,
      borders, ranges, valid, block_origin, grid_origin, grid_spacing, V, by,
      bz, ft, lanes_z, n_jt, fused, wsum);
  return cudaGetLastError();
}

}  // namespace

#define BST_NONRIGID_ARGS(T)                                                 \
  grid, s, static_cast<const T*>(patches), px, py, pz,                       \
      static_cast<const float*>(grids), gx, gy, gz,                          \
      static_cast<const float*>(vaffs), static_cast<const float*>(offsets),  \
      static_cast<const float*>(img_dims),                                   \
      static_cast<const float*>(borders), static_cast<const float*>(ranges), \
      static_cast<const float*>(valid),                                      \
      static_cast<const float*>(block_origin),                               \
      static_cast<const float*>(grid_origin),                                \
      static_cast<const float*>(grid_spacing), V, by, bz, ft, lanes_z, n_jt, \
      static_cast<float*>(fused), static_cast<float*>(wsum)

#define BST_NONRIGID_BATCH(T, Idx, FT)                            \
  (B > 1 ? launch<T, Idx, FT, true>(BST_NONRIGID_ARGS(T))        \
         : launch<T, Idx, FT, false>(BST_NONRIGID_ARGS(T)))

// patches (B, V, px, py, pz), grids (B, V, gx, gy, gz, 12), vaffs (B, V,
// 3, 4), the other per-view arrays (B, V, 3), valid (B, V), the origins
// and spacings (B, 3); fused, wsum (B, bx, by, bz). lanes_z, n_jt, grid_x,
// grid_y: ops/fusion.py resample_plan, the per-block one; idx64: one
// view's patch of 2^31 elements or more (rows are offset in 64 bits).
// B = 1 takes the per-block instantiation.
extern "C" int bst_nonrigid_fuse_batch(
    const void* patches, int in_dtype, int px, int py, int pz,
    const void* grids, int gx, int gy, int gz, const void* vaffs,
    const void* offsets, const void* img_dims, const void* borders,
    const void* ranges, const void* valid, const void* block_origin,
    const void* grid_origin, const void* grid_spacing, int B, int V, int bx,
    int by, int bz, int ft, int lanes_z, int n_jt, int grid_x, int grid_y,
    int idx64, void* fused, void* wsum, void* stream) {
  const int64_t n = static_cast<int64_t>(bx) * by * bz;
  if (n <= 0 || V <= 0 || px <= 0 || py <= 0 || pz <= 0 || gx <= 0 ||
      gy <= 0 || gz <= 0 || B <= 0 || B > 65535)
    return cudaErrorInvalidValue;
  // vertex records are read as float4
  if (reinterpret_cast<uintptr_t>(grids) % 16 != 0)
    return cudaErrorMisalignedAddress;
  if (lanes_z < 1 || lanes_z > 32 || (lanes_z & (lanes_z - 1)) != 0 ||
      n_jt != (by + bst::kResampleThreads / lanes_z - 1) /
                  (bst::kResampleThreads / lanes_z) ||
      static_cast<int64_t>(grid_x) != static_cast<int64_t>(bx) * n_jt ||
      static_cast<int64_t>(grid_y) * bst::kResampleR * lanes_z < bz ||
      static_cast<int64_t>(grid_y - 1) * bst::kResampleR * lanes_z >= bz ||
      grid_y > 65535)
    return cudaErrorInvalidValue;
  if (!idx64 && static_cast<int64_t>(px) * py * pz >= (int64_t{1} << 31))
    return cudaErrorInvalidValue;
  const dim3 grid(grid_x, grid_y, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  if (idx64) {
    BST_DISPATCH_IN(in_dtype, T,
        err = BST_NONRIGID_BATCH(T, int64_t, bst::kRuntimeFT));
  } else {
    BST_DISPATCH_IN(in_dtype, T,
        BST_DISPATCH_FT(ft, FT, err = BST_NONRIGID_BATCH(T, int, FT)));
  }
  return static_cast<int>(err);
}
