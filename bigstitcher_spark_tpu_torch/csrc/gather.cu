// K3: per-block general-affine fusion, the port of fuse_block
// (bigstitcher_spark_tpu/ops/fusion.py:116 fuse_block_impl, jit :154, with
// _sample_one_view :90, _trilinear_sample :42, _blend_weight :72 and
// _combine_views :281).
//
// Each output voxel maps through its view's block->patch affine to a float
// position in the prefetched patch and samples it trilinearly, clamped at
// the patch edges (a position outside the patch reads its nearest edge
// voxels, as jnp.take of clipped indices does). One thread per output voxel,
// z fastest, views looped inside the thread.
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
// Bound: bytes, through gathers. The 8 taps of neighbouring threads overlap
// heavily and stay in L1/L2, so device memory sees each patch byte about
// once; the ~70 flops per view-voxel stay well under the float32 rate.
#include "fusion_common.cuh"

namespace {

// [scale, offset] of one view's grid at grid coordinates g (_trilinear_vec).
__device__ __forceinline__ void coeff_trilinear(const float* __restrict__ G,
                                                int cx, int cy, int cz,
                                                const float* g, float* so) {
  int lo[3], hi[3];
  float f[3];
  const int cmax[3] = {cx - 1, cy - 1, cz - 1};
  for (int d = 0; d < 3; ++d) {
    const float fl = floorf(g[d]);
    f[d] = g[d] - fl;
    const int q = static_cast<int>(fl);
    lo[d] = min(max(q, 0), cmax[d]);
    hi[d] = min(max(q + 1, 0), cmax[d]);
  }
  auto at = [&](int x, int y, int z, int c) {
    return G[((static_cast<int64_t>(x) * cy + y) * cz + z) * 2 + c];
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

template <typename T, bool kCoeff>
__global__ void fuse_block_kernel(
    const T* __restrict__ patches, int px, int py, int pz,
    const float* __restrict__ affines, const float* __restrict__ offsets,
    const float* __restrict__ img_dims, const float* __restrict__ borders,
    const float* __restrict__ ranges, const float* __restrict__ valid,
    const float* __restrict__ ioffs, int V, int bx, int by, int bz, int ft,
    const float* __restrict__ coeffs, const float* __restrict__ coeff_affs,
    int cx, int cy, int cz, float* __restrict__ fused,
    float* __restrict__ wsum) {
  const int64_t n = static_cast<int64_t>(bx) * by * bz;
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const int k = static_cast<int>(idx % bz);
  const int64_t r = idx / bz;
  const int j = static_cast<int>(r % by);
  const int i = static_cast<int>(r / by);
  const float ci = static_cast<float>(i), cj = static_cast<float>(j),
              ck = static_cast<float>(k);
  const int64_t pvol = static_cast<int64_t>(px) * py * pz;
  const int64_t syz = static_cast<int64_t>(py) * pz;
  const int pmax[3] = {px - 1, py - 1, pz - 1};

  bst::Combiner comb(ft);
  for (int v = 0; v < V; ++v) {
    const T* P = patches + v * pvol;
    const float* A = affines + 12 * v;
    float p[3], f[3];
    int lo[3], hi[3];
    for (int d = 0; d < 3; ++d) {
      p[d] = ci * A[4 * d + 0] + cj * A[4 * d + 1] + ck * A[4 * d + 2] +
             A[4 * d + 3];
      const float fl = floorf(p[d]);
      f[d] = p[d] - fl;
      const int q = static_cast<int>(fl);
      lo[d] = min(max(q, 0), pmax[d]);
      hi[d] = min(max(q + 1, 0), pmax[d]);
    }
    auto g = [&](int x, int y, int z) {
      return bst::ldf(P, static_cast<int64_t>(x) * syz +
                             static_cast<int64_t>(y) * pz + z);
    };
    const float gx = 1.0f - f[0], gy = 1.0f - f[1], gz = 1.0f - f[2];
    const float c000 = g(lo[0], lo[1], lo[2]) * gx * gy * gz;
    const float c100 = g(hi[0], lo[1], lo[2]) * f[0] * gy * gz;
    const float c010 = g(lo[0], hi[1], lo[2]) * gx * f[1] * gz;
    const float c110 = g(hi[0], hi[1], lo[2]) * f[0] * f[1] * gz;
    const float c001 = g(lo[0], lo[1], hi[2]) * gx * gy * f[2];
    const float c101 = g(hi[0], lo[1], hi[2]) * f[0] * gy * f[2];
    const float c011 = g(lo[0], hi[1], hi[2]) * gx * f[1] * f[2];
    const float c111 = g(hi[0], hi[1], hi[2]) * f[0] * f[1] * f[2];
    float val = c000 + c100 + c010 + c110 + c001 + c101 + c011 + c111;
    float lp[3];
    for (int d = 0; d < 3; ++d) lp[d] = p[d] + offsets[3 * v + d];
    if (kCoeff) {
      const float* C = coeff_affs + 12 * v;
      float g[3], so[2];
      for (int d = 0; d < 3; ++d)
        g[d] = lp[0] * C[4 * d + 0] + lp[1] * C[4 * d + 1] +
               lp[2] * C[4 * d + 2] + C[4 * d + 3];
      coeff_trilinear(coeffs + static_cast<int64_t>(v) * cx * cy * cz * 2, cx,
                      cy, cz, g, so);
      val = so[0] * val + so[1];
    }

    float inside = 1.0f, blend = 1.0f;
    for (int d = 0; d < 3; ++d) {
      const float lpos = lp[d];
      const float dim = img_dims[3 * v + d];
      inside = bst::inside_axis(lpos, dim, ioffs[3 * v + d]) > 0.0f ? inside
                                                                    : 0.0f;
      blend = blend * bst::blend_axis(lpos, dim, borders[3 * v + d],
                                      ranges[3 * v + d]);
    }
    comb.add(val, inside, blend, valid[v]);
  }
  fused[idx] = comb.fused();
  wsum[idx] = comb.wsum;
}

}  // namespace

#define BST_GATHER_ARGS(T)                                                    \
  static_cast<const T*>(patches), px, py, pz,                                 \
      static_cast<const float*>(affines), static_cast<const float*>(offsets), \
      static_cast<const float*>(img_dims),                                    \
      static_cast<const float*>(borders), static_cast<const float*>(ranges),  \
      static_cast<const float*>(valid), static_cast<const float*>(ioffs), V,  \
      bx, by, bz, ft, static_cast<const float*>(coeffs),                      \
      static_cast<const float*>(coeff_affs), cx, cy, cz,                      \
      static_cast<float*>(fused), static_cast<float*>(wsum)

extern "C" int bst_fuse_block(
    const void* patches, int in_dtype, int px, int py, int pz,
    const void* affines, const void* offsets, const void* img_dims,
    const void* borders, const void* ranges, const void* valid,
    const void* ioffs, int V, int bx, int by, int bz, int ft,
    const void* coeffs, const void* coeff_affs, int cx, int cy, int cz,
    void* fused, void* wsum, void* stream) {
  const int64_t n = static_cast<int64_t>(bx) * by * bz;
  if (n <= 0 || V <= 0 || px <= 0 || py <= 0 || pz <= 0)
    return cudaErrorInvalidValue;
  if (coeffs != nullptr &&
      (coeff_affs == nullptr || cx <= 0 || cy <= 0 || cz <= 0))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (coeffs != nullptr) {
    BST_DISPATCH_IN(in_dtype, T,
        fuse_block_kernel<T, true><<<bst::grid_for(n), bst::kThreads, 0, s>>>(
            BST_GATHER_ARGS(T)));
  } else {
    BST_DISPATCH_IN(in_dtype, T,
        fuse_block_kernel<T, false><<<bst::grid_for(n), bst::kThreads, 0, s>>>(
            BST_GATHER_ARGS(T)));
  }
  return static_cast<int>(cudaGetLastError());
}
