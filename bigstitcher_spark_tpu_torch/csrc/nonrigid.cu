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
//     views combined by fusion type (bst::Combiner, as K3).
// One thread per output voxel, z fastest, views looped inside the thread
// (K3's layout); the 8 vertex records are read through the read-only cache
// as three float4 each.
//
// Bound: bytes at the main path's compute block (256x256x64, 4 uint16
// views): the patches and the 32 MB of output dominate, the grids are
// ~100 KB a view. The function needs ~150 flops per view-voxel (the z
// lerp of 12 coefficients, the deform, the view affine, the sample and the
// blend), a third of the time the bytes take. This kernel redoes the x and
// y stages of the coefficient lerp for every voxel (~250 flops more) and
// gathers 24 float4 a view-voxel from L1/L2; sharing those stages across a
// z column, or staging the grid in shared memory, is the next step.
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

template <typename T>
__global__ void nonrigid_kernel(
    const T* __restrict__ patches, int px, int py, int pz,
    const float* __restrict__ grids, int gx, int gy, int gz,
    const float* __restrict__ vaffs, const float* __restrict__ offsets,
    const float* __restrict__ img_dims, const float* __restrict__ borders,
    const float* __restrict__ ranges, const float* __restrict__ valid,
    const float* __restrict__ block_origin,
    const float* __restrict__ grid_origin,
    const float* __restrict__ grid_spacing, int V, int bx, int by, int bz,
    int ft, float* __restrict__ fused, float* __restrict__ wsum) {
  const int64_t n = static_cast<int64_t>(bx) * by * bz;
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const int k = static_cast<int>(idx % bz);
  const int64_t r = idx / bz;
  const int j = static_cast<int>(r % by);
  const int i = static_cast<int>(r / by);
  const float li[3] = {static_cast<float>(i), static_cast<float>(j),
                       static_cast<float>(k)};
  const int gd[3] = {gx, gy, gz};
  float w[3], f[3], g[3];
  int lo[3], hi[3];
  for (int d = 0; d < 3; ++d) {
    w[d] = block_origin[d] + li[d];
    grid_taps((w[d] - grid_origin[d]) / grid_spacing[d], gd[d], &lo[d],
              &hi[d], &f[d]);
    g[d] = 1.0f - f[d];
  }
  const int64_t gvol = static_cast<int64_t>(gx) * gy * gz * 12;
  const int64_t pvol = static_cast<int64_t>(px) * py * pz;
  const int64_t syz = static_cast<int64_t>(py) * pz;
  const int pmax[3] = {px - 1, py - 1, pz - 1};

  bst::Combiner comb(ft);
  for (int v = 0; v < V; ++v) {
    const float* G = grids + v * gvol;
    auto vert = [&](int x, int y, int z, int q) {
      const int64_t at = ((static_cast<int64_t>(x) * gy + y) * gz + z) * 12;
      return __ldg(reinterpret_cast<const float4*>(G + at) + q);
    };
    float A[12];
    for (int q = 0; q < 3; ++q) {
      // x at the corners (y lo/hi, z lo/hi), then y, then z
      const float4 a00 = lerp4(vert(lo[0], lo[1], lo[2], q),
                               vert(hi[0], lo[1], lo[2], q), g[0], f[0]);
      const float4 a10 = lerp4(vert(lo[0], hi[1], lo[2], q),
                               vert(hi[0], hi[1], lo[2], q), g[0], f[0]);
      const float4 a01 = lerp4(vert(lo[0], lo[1], hi[2], q),
                               vert(hi[0], lo[1], hi[2], q), g[0], f[0]);
      const float4 a11 = lerp4(vert(lo[0], hi[1], hi[2], q),
                               vert(hi[0], hi[1], hi[2], q), g[0], f[0]);
      const float4 c = lerp4(lerp4(a00, a10, g[1], f[1]),
                             lerp4(a01, a11, g[1], f[1]), g[2], f[2]);
      A[4 * q + 0] = c.x;
      A[4 * q + 1] = c.y;
      A[4 * q + 2] = c.z;
      A[4 * q + 3] = c.w;
    }
    float dw[3];
    for (int rr = 0; rr < 3; ++rr) dw[rr] = apply_row(A + 4 * rr, w);
    const float* M = vaffs + 12 * v;
    float p[3], fr[3];
    int s0[3], s1[3];
    for (int d = 0; d < 3; ++d) {
      p[d] = apply_row(M + 4 * d, dw);
      const float fl = floorf(p[d]);
      fr[d] = p[d] - fl;
      const int qd = static_cast<int>(fl);
      s0[d] = min(max(qd, 0), pmax[d]);
      s1[d] = min(max(qd + 1, 0), pmax[d]);
    }
    const T* P = patches + v * pvol;
    auto s = [&](int x, int y, int z) {
      return bst::ldf(P, static_cast<int64_t>(x) * syz +
                             static_cast<int64_t>(y) * pz + z);
    };
    const float hx = 1.0f - fr[0], hy = 1.0f - fr[1], hz = 1.0f - fr[2];
    const float c000 = s(s0[0], s0[1], s0[2]) * hx * hy * hz;
    const float c100 = s(s1[0], s0[1], s0[2]) * fr[0] * hy * hz;
    const float c010 = s(s0[0], s1[1], s0[2]) * hx * fr[1] * hz;
    const float c110 = s(s1[0], s1[1], s0[2]) * fr[0] * fr[1] * hz;
    const float c001 = s(s0[0], s0[1], s1[2]) * hx * hy * fr[2];
    const float c101 = s(s1[0], s0[1], s1[2]) * fr[0] * hy * fr[2];
    const float c011 = s(s0[0], s1[1], s1[2]) * hx * fr[1] * fr[2];
    const float c111 = s(s1[0], s1[1], s1[2]) * fr[0] * fr[1] * fr[2];
    const float val = c000 + c100 + c010 + c110 + c001 + c101 + c011 + c111;

    float inside = 1.0f, blend = 1.0f;
    for (int d = 0; d < 3; ++d) {
      const float lpos = p[d] + offsets[3 * v + d];
      const float dim = img_dims[3 * v + d];
      inside = bst::inside_axis(lpos, dim, 0.0f) > 0.0f ? inside : 0.0f;
      blend = blend * bst::blend_axis(lpos, dim, borders[3 * v + d],
                                      ranges[3 * v + d]);
    }
    comb.add(val, inside, blend, valid[v]);
  }
  fused[idx] = comb.fused();
  wsum[idx] = comb.wsum;
}

}  // namespace

extern "C" int bst_nonrigid_fuse(
    const void* patches, int in_dtype, int px, int py, int pz,
    const void* grids, int gx, int gy, int gz, const void* vaffs,
    const void* offsets, const void* img_dims, const void* borders,
    const void* ranges, const void* valid, const void* block_origin,
    const void* grid_origin, const void* grid_spacing, int V, int bx, int by,
    int bz, int ft, void* fused, void* wsum, void* stream) {
  const int64_t n = static_cast<int64_t>(bx) * by * bz;
  if (n <= 0 || V <= 0 || px <= 0 || py <= 0 || pz <= 0 || gx <= 0 ||
      gy <= 0 || gz <= 0)
    return cudaErrorInvalidValue;
  // vertex records are read as float4
  if (reinterpret_cast<uintptr_t>(grids) % 16 != 0)
    return cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  BST_DISPATCH_IN(in_dtype, T,
      nonrigid_kernel<T><<<bst::grid_for(n), bst::kThreads, 0, s>>>(
          static_cast<const T*>(patches), px, py, pz,
          static_cast<const float*>(grids), gx, gy, gz,
          static_cast<const float*>(vaffs),
          static_cast<const float*>(offsets),
          static_cast<const float*>(img_dims),
          static_cast<const float*>(borders),
          static_cast<const float*>(ranges), static_cast<const float*>(valid),
          static_cast<const float*>(block_origin),
          static_cast<const float*>(grid_origin),
          static_cast<const float*>(grid_spacing), V, bx, by, bz, ft,
          static_cast<float*>(fused), static_cast<float*>(wsum)));
  return static_cast<int>(cudaGetLastError());
}
