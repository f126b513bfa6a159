// K3: per-block general-affine fusion, the port of fuse_block
// (bigstitcher_spark_tpu/ops/fusion.py:116 fuse_block_impl, jit :154, with
// _sample_one_view :90, _trilinear_sample :42, _blend_weight :72 and
// _combine_views :281).
//
// Each output voxel maps through its view's block->patch affine to a float
// position in the prefetched patch and samples it trilinearly, clamped at
// the patch edges (a position outside the patch reads its nearest edge
// voxels, as jnp.take of clipped indices does); the views are combined in
// view order by fusion type.
//
// Intensity coefficients (the coeff branch of _sample_one_view :98-103 with
// ops/nonrigid.py:28 _trilinear_vec): with a view's (Cx, Cy, Cz, 2) float32
// grid of [scale, offset] and its (3, 4) level position -> grid affine, the
// grid coordinate g = ((l_x C0 + l_y C1) + l_z C2) + C3 of the level
// position l = p + offset is sampled trilinearly, floor and fraction with
// both corner indices clipped to the grid (8 corners, the JAX sum order),
// and applied as scale * val + offset before the blend. A null grid
// pointer takes the kernel without the branch.
//
// Bound: bytes at the main path's block (256x256x64 outputs, 4 uint16
// views of 288x288x96: 97 MB, 0.029 ms at 3.35 TB/s); the function needs
// ~92 operations a view-voxel (~192 with coefficients), under the float32
// rate. The first form (one thread a voxel, every per-view parameter
// loaded and every partial product recomputed per view-voxel) issued ~400
// instructions a view-voxel and ran at 7x the bound. This form:
//   * stages the per-view parameters in shared memory once per block,
//     with the terms the blend and the inside test derive from them
//     (bst::axis_terms), 8 views at a time (any V: the combiners carry
//     over the chunks in registers);
//   * gives a thread 4 consecutive z outputs of one (i, j) column
//     (bst::kResampleR; ops/fusion.py resample_plan), views looped outside
//     the 4 voxels, and stores them as float4 where the block allows;
//   * keeps the column's partial sums: p_d = ((i A0 + j A1) + k A2) + A3
//     is the parent's left-to-right sum, so s_d = i A0 + j A1 is the value
//     the parent computed per voxel. For a separable view (A2, A6, A8 and
//     A9 zeros: translations and rotations about z, every view of the main
//     path), k A2 and k A6 are zeros of one sign for every k >= 0 and i A8
//     + j A9 a zero of one sign for every column: p_x and p_y, their taps,
//     the x and y inside tests and blend ramps and the four patch rows are
//     the column's, and p_z, its taps, the z inside test and blend ramp are
//     k's, computed once a block for each k of its tile into shared memory
//     (ZRec) and read by every column;
//   * a column's lanes share its x and y terms: lane u computes them for
//     the u-th view of a group of lanes_z views (column_terms) and the
//     others read them by warp shuffles (shfl_column), so a column computes
//     them once a view and not once a lane;
//   * reads a run whose z floors step by one (4 voxels, 5 values a row,
//     clamped at the patch's ends as the taps are) with one address a row
//     where none is clamped, and computes each address in one wide
//     multiply-add (bst::offset32; 32-bit patch indices below 2^31
//     elements, int64 above);
//   * takes the fusion type as a template parameter (3-5 % of the time at
//     AVG_BLEND against a run-time switch; read at run time in the int64
//     instantiations only, which keeps the build short): the blend ramps
//     are computed for AVG_BLEND alone;
//   * coefficients: (l_x C0 + l_y C1) is the column's; where C2, C6, C8
//     and C9 are zeros too, the grid's x and y taps are the column's and
//     its z taps k's (a zero whose sign may differ between columns changes
//     neither floor, fraction nor taps), and a thread keeps the 8 corners'
//     (G wx) wy of its current z cell pair in registers (read as float2
//     from the column's four grid rows): a voxel then does only the z
//     products and the sum. The grid is read through the read-only cache,
//     not staged: a thread reads 8 pairs a view and z cell, and staging
//     whole grids per block would move more;
//   * 3 blocks an SM for the plain kernel (80 registers), 2 for the
//     coefficient branch: the form is latency-bound, not bound by its
//     loads (PERF.md, the K3 and K26 redesign).
// A general affine takes the parent's voxel, from the column's sums.
// Every voxel therefore takes the parent's float32 operations in the
// parent's order (-fmad=false): outputs bitwise equal to the first form's.
//
// Batch form (bst_fuse_block_batch, ops/fusion.py fuse_block_batch): the
// sharded route's batch of B blocks of one bucket (parallel/mesh.py:223
// vmap of fuse_block_impl, with or without coefficients) in one launch.
// A bucket shares its block, patch shape and view count, so the launch
// plan (resample_plan) is the per-block one; grid index blockIdx.z selects
// the block, whose patches, per-view parameters, grids and outputs sit at
// a row stride. The per-block launch is the batch of one: a row is bitwise
// the per-block output. Padding rows (valid all 0) write zeros.
#include "fusion_common.cuh"

namespace {

using bst::kResampleR;

// One view's parameters in shared memory.
struct GatherView {
  float A[12];   // block index -> patch position, row-major 3x4
  float C[12];   // level position -> coefficient grid coordinate
  float off[3];  // patch -> level position
  bst::AxisTerms ax[3];
  float valid;
  int sep;   // A2, A6, A8, A9 zeros: p_x, p_y are the column's, p_z is k's
  int csep;  // sep, and C2, C6, C8, C9 zeros: so are the grid's taps
};

// What a separable view's voxel needs of its k, the same in every column.
struct ZRec {
  int q;       // floor(p_z), unclamped: the taps are q and q + 1, clamped
  int inside;  // inside along z
  float fz;    // the z fraction
  float bz;    // the z blend ramp
};

// A separable view's coefficient-grid z taps at a k.
struct CZRec {
  int zl, zh;
  float f, g;
};

// [scale, offset] of one view's grid at grid coordinates g (_trilinear_vec).
__device__ __forceinline__ void coeff_trilinear(const float* __restrict__ G,
                                                int cx, int cy, int cz,
                                                const float* g, float* so) {
  int lo[3], hi[3];
  float f[3];
  const int cmax[3] = {cx - 1, cy - 1, cz - 1};
  for (int d = 0; d < 3; ++d) bst::sample_taps(g[d], cmax[d], &lo[d], &hi[d],
                                                &f[d]);
  auto at = [&](int x, int y, int z, int c) {
    return __ldg(G + ((static_cast<int64_t>(x) * cy + y) * cz + z) * 2 + c);
  };
  const float gx = 1.0f - f[0], gy = 1.0f - f[1], gz = 1.0f - f[2];
  for (int c = 0; c < 2; ++c) {
    so[c] = at(lo[0], lo[1], lo[2], c) * gx * gy * gz +
            at(hi[0], lo[1], lo[2], c) * f[0] * gy * gz +
            at(lo[0], hi[1], lo[2], c) * gx * f[1] * gz +
            at(hi[0], hi[1], lo[2], c) * f[0] * f[1] * gz +
            at(lo[0], lo[1], hi[2], c) * gx * gy * f[2] +
            at(hi[0], lo[1], hi[2], c) * f[0] * gy * f[2] +
            at(lo[0], hi[1], hi[2], c) * gx * f[1] * f[2] +
            at(hi[0], hi[1], hi[2], c) * f[0] * f[1] * f[2];
  }
}

template <bool kCoeff>
__device__ void stage_view(GatherView& s, int v,
                           const float* __restrict__ affines,
                           const float* __restrict__ offsets,
                           const float* __restrict__ img_dims,
                           const float* __restrict__ borders,
                           const float* __restrict__ ranges,
                           const float* __restrict__ valid,
                           const float* __restrict__ ioffs,
                           const float* __restrict__ coeff_affs) {
  for (int q = 0; q < 12; ++q) s.A[q] = affines[12 * v + q];
  for (int q = 0; q < 12; ++q) s.C[q] = kCoeff ? coeff_affs[12 * v + q] : 0.0f;
  for (int d = 0; d < 3; ++d) {
    s.off[d] = offsets[3 * v + d];
    s.ax[d] = bst::axis_terms(img_dims[3 * v + d], ioffs[3 * v + d],
                              borders[3 * v + d], ranges[3 * v + d]);
  }
  s.valid = valid[v];
  s.sep = s.A[2] == 0.0f && s.A[6] == 0.0f && s.A[8] == 0.0f &&
          s.A[9] == 0.0f;
  s.csep = s.sep && s.C[2] == 0.0f && s.C[6] == 0.0f && s.C[8] == 0.0f &&
           s.C[9] == 0.0f;
}

// The 8 corners' (G wx) wy of one grid cell pair (x and y taps fixed, z
// taps zl, zh), both channels: T[2 n + c] for corner n (x, y, z at bits
// 0, 1, 2), the leading products of coeff_trilinear's terms. rows[m]: the
// grid's [scale, offset] pairs along z at the column's x and y taps m
// (x, y at bits 0, 1).
__device__ __forceinline__ void coeff_corners(const float2* const* rows,
                                              const float* f, const float* g,
                                              int zl, int zh, float* T) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const float wx = n & 1 ? f[0] : g[0];
    const float wy = n & 2 ? f[1] : g[1];
    const float2 v = __ldg(rows[n & 3] + (n & 4 ? zh : zl));
    T[2 * n] = v.x * wx * wy;
    T[2 * n + 1] = v.y * wx * wy;
  }
}

// A separable view's terms of one column: computed by one lane of the
// column and shared with the others (shfl_column).
template <typename Idx>
struct Column {
  Idx row[4];   // the four patch rows: x and y taps (lo, lo), (hi, lo), ...
  float f[2];   // the x and y fractions
  float b_xy;   // the x and y blend ramps' product (1 unless AVG_BLEND)
  int in_xy;    // inside along x and y
  float cp[3];  // with coefficients: l_x C_d0 + l_y C_d1
  int clo[2], chi[2];  // the grid's x and y taps (C2, C6, C8, C9 zeros)
  float cf[2];         // and fractions
};

// k A2 and k A6 are zeros of one sign for every k >= 0, so any k0 of the
// column gives its p_x and p_y; with C2 and C6 zeros, l_z C2 is a zero
// whose sign may follow k0's l_z, which changes neither floor, fraction nor
// taps: any lane's terms are the column's.
template <bool kCoeff, typename Idx>
__device__ __forceinline__ Column<Idx> column_terms(
    const GatherView& s, float ci, float cj, int k0, const int* pmax, Idx syz,
    int pz, bool blended, int cx, int cy) {
  Column<Idx> c;
  const float ck0 = static_cast<float>(k0);
  int lo[2], hi[2];
  float lp[2];
  for (int d = 0; d < 2; ++d) {
    const float p = ci * s.A[4 * d] + cj * s.A[4 * d + 1] +
                    ck0 * s.A[4 * d + 2] + s.A[4 * d + 3];
    bst::sample_taps(p, pmax[d], &lo[d], &hi[d], &c.f[d]);
    lp[d] = p + s.off[d];
  }
  c.in_xy = bst::inside_at(lp[0], s.ax[0]) && bst::inside_at(lp[1], s.ax[1]);
  c.b_xy = blended ? bst::blend_at(lp[0], s.ax[0]) *
                         bst::blend_at(lp[1], s.ax[1])
                   : 1.0f;
  const Idx ylo = static_cast<Idx>(lo[1]) * pz,
            yhi = static_cast<Idx>(hi[1]) * pz;
  c.row[0] = lo[0] * syz + ylo;
  c.row[1] = hi[0] * syz + ylo;
  c.row[2] = lo[0] * syz + yhi;
  c.row[3] = hi[0] * syz + yhi;
  if (kCoeff) {
    for (int d = 0; d < 3; ++d)
      c.cp[d] = lp[0] * s.C[4 * d] + lp[1] * s.C[4 * d + 1];
    if (s.csep) {
      const float lz0 = ci * s.A[8] + cj * s.A[9] + ck0 * s.A[10] +
                        s.A[11] + s.off[2];
      const int cmax[2] = {cx - 1, cy - 1};
      for (int d = 0; d < 2; ++d) {
        const float gd = c.cp[d] + lz0 * s.C[4 * d + 2] + s.C[4 * d + 3];
        bst::sample_taps(gd, cmax[d], &c.clo[d], &c.chi[d], &c.cf[d]);
      }
    }
  }
  return c;
}

// Lane src's terms (all lanes of the warp call it together).
template <bool kCoeff, typename Idx>
__device__ __forceinline__ Column<Idx> shfl_column(const Column<Idx>& m,
                                                   int src, bool csep) {
  constexpr unsigned kAll = 0xffffffffu;
  Column<Idx> c;
  for (int q = 0; q < 4; ++q) c.row[q] = __shfl_sync(kAll, m.row[q], src);
  for (int d = 0; d < 2; ++d) c.f[d] = __shfl_sync(kAll, m.f[d], src);
  c.b_xy = __shfl_sync(kAll, m.b_xy, src);
  c.in_xy = __shfl_sync(kAll, m.in_xy, src);
  if (kCoeff) {
    for (int d = 0; d < 3; ++d) c.cp[d] = __shfl_sync(kAll, m.cp[d], src);
    if (csep) {
      for (int d = 0; d < 2; ++d) {
        c.clo[d] = __shfl_sync(kAll, m.clo[d], src);
        c.chi[d] = __shfl_sync(kAll, m.chi[d], src);
        c.cf[d] = __shfl_sync(kAll, m.cf[d], src);
      }
    }
  }
  return c;
}

// Blocks an SM the register budget allows: 3 (80 registers) for the plain
// kernel, 2 (128) for the coefficient branch, whose corner products and
// grid taps spill at 80 (both measured at their main-path shapes).
template <typename T, typename Idx, int FT, bool kCoeff>
__global__ void __launch_bounds__(bst::kResampleThreads, kCoeff ? 2 : 3)
    fuse_block_kernel(
    const T* __restrict__ patches, int px, int py, int pz,
    const float* __restrict__ affines, const float* __restrict__ offsets,
    const float* __restrict__ img_dims, const float* __restrict__ borders,
    const float* __restrict__ ranges, const float* __restrict__ valid,
    const float* __restrict__ ioffs, int V, int bx, int by, int bz, int ft,
    const float* __restrict__ coeffs, const float* __restrict__ coeff_affs,
    int cx, int cy, int cz, int lanes_z, int n_jt, int vec4,
    float* __restrict__ fused, float* __restrict__ wsum) {
  {
    // the batch row: its views' patches and parameters, its outputs
    const int64_t row = blockIdx.z;
    const int64_t rv = row * V;
    patches += rv * px * py * pz;
    affines += rv * 12;
    offsets += rv * 3;
    img_dims += rv * 3;
    borders += rv * 3;
    ranges += rv * 3;
    ioffs += rv * 3;
    valid += rv;
    if (kCoeff) {
      coeffs += rv * cx * cy * cz * 2;
      coeff_affs += rv * 12;
    }
    fused += row * bx * by * bz;
    wsum += row * bx * by * bz;
  }
  constexpr int kChunk = bst::kResampleViewChunk;
  constexpr int kTileZ = bst::kResampleMaxTileZ;
  __shared__ GatherView sv[kChunk];
  __shared__ ZRec ztab[kChunk][kTileZ];
  __shared__ CZRec cztab[kCoeff ? kChunk : 1][kCoeff ? kTileZ : 1];
  const int tile_j = bst::kResampleThreads / lanes_z;
  const int tile_z = kResampleR * lanes_z;
  const int lz = threadIdx.x % lanes_z;
  const int i = blockIdx.x / n_jt;
  const int j = (blockIdx.x % n_jt) * tile_j + threadIdx.x / lanes_z;
  const int z0 = blockIdx.y * tile_z;
  const int k0 = z0 + lz * kResampleR;
  const int nk = j < by ? max(0, min(kResampleR, bz - k0)) : 0;
  const float ci = static_cast<float>(i), cj = static_cast<float>(j);
  const int64_t pvol = static_cast<int64_t>(px) * py * pz;
  const Idx syz = static_cast<Idx>(py) * pz;
  const int pmax[3] = {px - 1, py - 1, pz - 1};
  const int64_t gvol = static_cast<int64_t>(cx) * cy * cz * 2;

  bst::CombinerT<FT> comb[kResampleR];
#pragma unroll
  for (int r = 0; r < kResampleR; ++r) comb[r] = bst::CombinerT<FT>(ft);
  const bool blended = comb[0].kind() == bst::AVG_BLEND;

  for (int c0 = 0; c0 < V; c0 += kChunk) {
    const int nv = min(kChunk, V - c0);
    __syncthreads();  // the previous chunk's parameters and records are read
    if (threadIdx.x < nv)
      stage_view<kCoeff>(sv[threadIdx.x], c0 + threadIdx.x, affines, offsets,
                         img_dims, borders, ranges, valid, ioffs, coeff_affs);
    __syncthreads();
    // the separable views' z records for each k of the tile
    for (int t = threadIdx.x; t < nv * tile_z; t += bst::kResampleThreads) {
      const int vv = t / tile_z, kk = t - vv * tile_z;
      const GatherView& s = sv[vv];
      if (!s.sep) continue;
      // a column's i A8 + j A9: a zero whose sign is A8's and A9's
      const float sz = 0.0f * s.A[8] + 0.0f * s.A[9];
      const float p2 = sz + static_cast<float>(z0 + kk) * s.A[10] + s.A[11];
      ZRec z;
      const float fl = floorf(p2);  // bst::sample_taps' steps
      z.fz = p2 - fl;
      z.q = static_cast<int>(fl);
      const float lp2 = p2 + s.off[2];
      z.inside = bst::inside_at(lp2, s.ax[2]);
      z.bz = blended ? bst::blend_at(lp2, s.ax[2]) : 1.0f;
      // run-major: thread lz reads its run's r-th record at r lanes_z + lz,
      // so a warp's 128-bit reads fall on distinct banks
      const int at = (kk % kResampleR) * lanes_z + kk / kResampleR;
      ztab[vv][at] = z;
      if (kCoeff && s.csep) {
        // a column's l_x C8 + l_y C9 is a zero whose sign may differ from
        // this one's: it changes neither floor, fraction nor taps
        const float g2 =
            (0.0f * s.C[8] + 0.0f * s.C[9]) + lp2 * s.C[10] + s.C[11];
        CZRec c;
        bst::sample_taps(g2, cz - 1, &c.zl, &c.zh, &c.f);
        c.g = 1.0f - c.f;
        cztab[vv][at] = c;
      }
    }
    __syncthreads();
    // the views in groups of lanes_z: lane lz of a column computes the
    // column terms of view vb + lz, and the column's lanes share them
    for (int vb = 0; vb < nv; vb += lanes_z) {
      Column<Idx> mine;
      if (vb + lz < nv && sv[vb + lz].sep)
        mine = column_terms<kCoeff>(sv[vb + lz], ci, cj, k0, pmax, syz, pz,
                                    blended, cx, cy);
      for (int vv = vb; vv < min(nv, vb + lanes_z); ++vv) {
      const GatherView& s = sv[vv];
      const T* P = patches + static_cast<int64_t>(c0 + vv) * pvol;
      const float* G = kCoeff ? coeffs + static_cast<int64_t>(c0 + vv) * gvol
                              : nullptr;
      if (s.sep) {
        // x and y: the column's; z: the tile's records
        const Column<Idx> col = shfl_column<kCoeff>(
            mine, (threadIdx.x & 31 & ~(lanes_z - 1)) + (vv - vb), s.csep);
        if (nk == 0) continue;
        float f[3] = {col.f[0], col.f[1], 0.0f};
        float g[3] = {1.0f - col.f[0], 1.0f - col.f[1], 0.0f};
        const bool in_xy = col.in_xy;
        const float b_xy = col.b_xy;
        const T* rp[4];
        for (int q = 0; q < 4; ++q) rp[q] = bst::offset32(P, col.row[q]);
        ZRec zr[kResampleR];
        bool unit = true;  // the run's floors step by one
#pragma unroll
        for (int r = 0; r < kResampleR; ++r) {
          zr[r] = ztab[vv][r * lanes_z + lz];
          unit = unit && zr[r].q == zr[0].q + r;
        }
        // each voxel's [scale, offset], before the samples are loaded
        float so[kResampleR][2];
        if (kCoeff) {
          const float* cp = col.cp;
          if (s.csep) {
            const float cg[2] = {1.0f - col.cf[0], 1.0f - col.cf[1]};
            const float2* rows[4];
            for (int m = 0; m < 4; ++m)
              rows[m] = reinterpret_cast<const float2*>(G) +
                        (static_cast<int64_t>(m & 1 ? col.chi[0] : col.clo[0]) *
                             cy +
                         (m & 2 ? col.chi[1] : col.clo[1])) *
                            cz;
            float CT[16];
            int czl = -1, czh = -1;
#pragma unroll
            for (int r = 0; r < kResampleR; ++r) {
              const CZRec c = cztab[vv][r * lanes_z + lz];
              if (c.zl != czl || c.zh != czh) {
                coeff_corners(rows, col.cf, cg, c.zl, c.zh, CT);
                czl = c.zl;
                czh = c.zh;
              }
              for (int h = 0; h < 2; ++h) {
                float a = CT[h] * c.g;
                a = a + CT[2 + h] * c.g;
                a = a + CT[4 + h] * c.g;
                a = a + CT[6 + h] * c.g;
                a = a + CT[8 + h] * c.f;
                a = a + CT[10 + h] * c.f;
                a = a + CT[12 + h] * c.f;
                a = a + CT[14 + h] * c.f;
                so[r][h] = a;
              }
            }
          } else {
#pragma unroll
            for (int r = 0; r < kResampleR; ++r) {
              const float lz = ci * s.A[8] + cj * s.A[9] +
                               static_cast<float>(k0 + r) * s.A[10] +
                               s.A[11] + s.off[2];
              float gg[3];
              for (int d = 0; d < 3; ++d)
                gg[d] = cp[d] + lz * s.C[4 * d + 2] + s.C[4 * d + 3];
              coeff_trilinear(G, cx, cy, cz, gg, so[r]);
            }
          }
        }
        // the samples, then the rest (a voxel past the block's end reads
        // clamped taps and is dropped)
        auto voxel = [&](int r, const float* c8) {
          f[2] = zr[r].fz;
          g[2] = 1.0f - zr[r].fz;
          float val = bst::trilinear8(c8, f, g);
          if (kCoeff) val = so[r][0] * val + so[r][1];
          const float inside = in_xy && zr[r].inside ? 1.0f : 0.0f;
          comb[r].add(val, inside, b_xy * zr[r].bz, s.valid);
        };
        if (unit) {
          // a unit z step: each voxel's low tap is its predecessor's high
          // one, and the run reads the 5 values at clamp(q0 + 0..4) a row,
          // loaded together; from one address where none is clamped
          const int q0 = zr[0].q;
          float c[4][kResampleR + 1];
          if (q0 >= 0 && q0 + kResampleR <= pmax[2]) {
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const T* z0p = bst::offset32(rp[q], q0);
#pragma unroll
              for (int r = 0; r <= kResampleR; ++r)
                c[q][r] = static_cast<float>(__ldg(z0p + r));
            }
          } else {
#pragma unroll
            for (int r = 0; r <= kResampleR; ++r) {
              const int z = min(max(q0 + r, 0), pmax[2]);
              for (int q = 0; q < 4; ++q)
                c[q][r] = static_cast<float>(__ldg(bst::offset32(rp[q], z)));
            }
          }
#pragma unroll
          for (int r = 0; r < kResampleR; ++r) {
            const float c8[8] = {c[0][r], c[1][r], c[2][r], c[3][r],
                                 c[0][r + 1], c[1][r + 1], c[2][r + 1],
                                 c[3][r + 1]};
            voxel(r, c8);
          }
        } else {
#pragma unroll
          for (int r = 0; r < kResampleR; ++r) {
            const int zl = min(max(zr[r].q, 0), pmax[2]);
            const int zh = min(max(zr[r].q + 1, 0), pmax[2]);
            float c8[8];
            for (int q = 0; q < 4; ++q) {
              c8[q] = static_cast<float>(__ldg(bst::offset32(rp[q], zl)));
              c8[4 + q] = static_cast<float>(__ldg(bst::offset32(rp[q], zh)));
            }
            voxel(r, c8);
          }
        }
      } else {
        // a general affine: the parent's voxel, from the column's sums
        if (nk == 0) continue;
        float sp[3];
        for (int d = 0; d < 3; ++d)
          sp[d] = ci * s.A[4 * d] + cj * s.A[4 * d + 1];
#pragma unroll
        for (int r = 0; r < kResampleR; ++r) {
          const float ck = static_cast<float>(k0 + r);
          float p[3], f[3], g[3], lp[3];
          int lo[3], hi[3];
          for (int d = 0; d < 3; ++d) {
            p[d] = sp[d] + ck * s.A[4 * d + 2] + s.A[4 * d + 3];
            bst::sample_taps(p[d], pmax[d], &lo[d], &hi[d], &f[d]);
            g[d] = 1.0f - f[d];
          }
          float c8[8];
          for (int n = 0; n < 8; ++n)
            c8[n] = static_cast<float>(__ldg(bst::offset32(
                P, (n & 1 ? hi[0] : lo[0]) * syz +
                       static_cast<Idx>(n & 2 ? hi[1] : lo[1]) * pz +
                       (n & 4 ? hi[2] : lo[2]))));
          float val = bst::trilinear8(c8, f, g);
          for (int d = 0; d < 3; ++d) lp[d] = p[d] + s.off[d];
          if (kCoeff) {
            float gg[3], so[2];
            for (int d = 0; d < 3; ++d)
              gg[d] = lp[0] * s.C[4 * d + 0] + lp[1] * s.C[4 * d + 1] +
                      lp[2] * s.C[4 * d + 2] + s.C[4 * d + 3];
            coeff_trilinear(G, cx, cy, cz, gg, so);
            val = so[0] * val + so[1];
          }
          float inside = 1.0f, blend = 1.0f;
          for (int d = 0; d < 3; ++d) {
            inside = bst::inside_at(lp[d], s.ax[d]) ? inside : 0.0f;
            blend = blend * bst::blend_at(lp[d], s.ax[d]);
          }
          comb[r].add(val, inside, blend, s.valid);
        }
      }
      }
    }
  }
  if (nk == 0) return;
  const int64_t at = (static_cast<int64_t>(i) * by + j) * bz + k0;
  if (vec4 && nk == kResampleR) {
#pragma unroll
    for (int r = 0; r < kResampleR; r += 4) {
      *reinterpret_cast<float4*>(fused + at + r) =
          make_float4(comb[r].fused(), comb[r + 1].fused(),
                      comb[r + 2].fused(), comb[r + 3].fused());
      *reinterpret_cast<float4*>(wsum + at + r) =
          make_float4(comb[r].wsum, comb[r + 1].wsum, comb[r + 2].wsum,
                      comb[r + 3].wsum);
    }
  } else {
    for (int r = 0; r < nk; ++r) {
      fused[at + r] = comb[r].fused();
      wsum[at + r] = comb[r].wsum;
    }
  }
}

template <typename T, typename Idx, int FT, bool kCoeff>
cudaError_t launch(dim3 grid, cudaStream_t s, const T* patches, int px, int py,
                   int pz, const float* affines, const float* offsets,
                   const float* img_dims, const float* borders,
                   const float* ranges, const float* valid, const float* ioffs,
                   int V, int bx, int by, int bz, int ft, const float* coeffs,
                   const float* coeff_affs, int cx, int cy, int cz,
                   int lanes_z, int n_jt, int vec4, float* fused,
                   float* wsum) {
  fuse_block_kernel<T, Idx, FT, kCoeff><<<grid, bst::kResampleThreads, 0, s>>>(
      patches, px, py, pz, affines, offsets, img_dims, borders, ranges, valid,
      ioffs, V, bx, by, bz, ft, coeffs, coeff_affs, cx, cy, cz, lanes_z, n_jt,
      vec4, fused, wsum);
  return cudaGetLastError();
}

}  // namespace

#define BST_GATHER_ARGS(T)                                                    \
  grid, s, static_cast<const T*>(patches), px, py, pz,                        \
      static_cast<const float*>(affines), static_cast<const float*>(offsets), \
      static_cast<const float*>(img_dims),                                    \
      static_cast<const float*>(borders), static_cast<const float*>(ranges),  \
      static_cast<const float*>(valid), static_cast<const float*>(ioffs), V,  \
      bx, by, bz, ft, static_cast<const float*>(coeffs),                      \
      static_cast<const float*>(coeff_affs), cx, cy, cz, lanes_z, n_jt, vec4, \
      static_cast<float*>(fused), static_cast<float*>(wsum)

#define BST_GATHER_COEFF(T, Idx, FT)                                 \
  (coeffs != nullptr ? launch<T, Idx, FT, true>(BST_GATHER_ARGS(T))  \
                     : launch<T, Idx, FT, false>(BST_GATHER_ARGS(T)))

// lanes_z, n_jt, grid_x, grid_y: ops/fusion.py resample_plan; idx64: a
// patch of 2^31 elements or more. patches (B, V, px, py, pz), affines and
// coeff_affs (B, V, 3, 4), the other per-view arrays (B, V, 3), valid
// (B, V), coeffs (B, V, cx, cy, cz, 2); fused, wsum (B, bx, by, bz).
extern "C" int bst_fuse_block_batch(
    const void* patches, int in_dtype, int px, int py, int pz,
    const void* affines, const void* offsets, const void* img_dims,
    const void* borders, const void* ranges, const void* valid,
    const void* ioffs, int B, int V, int bx, int by, int bz, int ft,
    const void* coeffs, const void* coeff_affs, int cx, int cy, int cz,
    int lanes_z, int n_jt, int grid_x, int grid_y, int idx64, void* fused,
    void* wsum, void* stream) {
  const int64_t n = static_cast<int64_t>(bx) * by * bz;
  if (n <= 0 || V <= 0 || px <= 0 || py <= 0 || pz <= 0 || B <= 0 ||
      B > 65535)
    return cudaErrorInvalidValue;
  if (coeffs != nullptr &&
      (coeff_affs == nullptr || cx <= 0 || cy <= 0 || cz <= 0))
    return cudaErrorInvalidValue;
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
  // a grid's [scale, offset] pairs are read as float2
  if (reinterpret_cast<uintptr_t>(coeffs) % 8 != 0)
    return cudaErrorMisalignedAddress;
  const int vec4 = bz % 4 == 0 && reinterpret_cast<uintptr_t>(fused) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(wsum) % 16 == 0;
  const dim3 grid(grid_x, grid_y, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  if (idx64) {
    BST_DISPATCH_IN(in_dtype, T,
        err = BST_GATHER_COEFF(T, int64_t, bst::kRuntimeFT));
  } else {
    BST_DISPATCH_IN(in_dtype, T,
        BST_DISPATCH_FT(ft, FT, err = BST_GATHER_COEFF(T, int, FT)));
  }
  return static_cast<int>(err);
}
