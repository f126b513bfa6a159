// K2: per-block translation fusion, the port of fuse_block_shift
// (bigstitcher_spark_tpu/ops/fusion.py:315 fuse_block_shift_impl, jit :337,
// per view _one_view_shift :186, combine _combine_views :281).
//
// Each view's inverse affine is a pure shift, so its sample at output voxel
// (i,j,k) mixes the 2x2x2 patch voxels at (i..i+1, j..j+1, k..k+1) with
// constant corner weights from the sub-pixel fraction, and its blend weight
// and inside mask are outer products of 1-D vectors, as in the JAX program.
// The wrapper computes those vectors once per block (ops/fusion.py
// shift_axis_tables, shared with the plain twin, so both sides use the very
// same weights); the kernel reads them from `tables` (V, 2, bx+by+bz):
// [v][0] blend, [v][1] inside, x then y then z. One thread per output
// voxel, z fastest so a warp reads neighbouring patch addresses; the views
// are a loop inside the thread, so the combine needs no second pass.
//
// Bound: bytes. Per voxel it reads V patch values (8 taps that hit L1/L2
// mostly once from device memory) and writes two floats; ~30 flops per
// view-voxel stay far below the card's float32 rate.
#include "fusion_common.cuh"

namespace {

template <typename T>
__global__ void fuse_block_shift_kernel(
    const T* __restrict__ patches, const float* __restrict__ fracs,
    const float* __restrict__ tables, const float* __restrict__ valid, int V,
    int bx, int by, int bz, int ft, float* __restrict__ fused,
    float* __restrict__ wsum) {
  const int64_t n = static_cast<int64_t>(bx) * by * bz;
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const int k = static_cast<int>(idx % bz);
  const int64_t r = idx / bz;
  const int j = static_cast<int>(r % by);
  const int i = static_cast<int>(r / by);
  const int py = by + 1, pz = bz + 1;
  const int64_t pvol = static_cast<int64_t>(bx + 1) * py * pz;
  const int S = bx + by + bz;

  bst::Combiner comb(ft);
  for (int v = 0; v < V; ++v) {
    const T* P = patches + v * pvol;
    const float* f = fracs + 3 * v;
    float val = 0.0f;
    for (int cx = 0; cx < 2; ++cx) {
      const float wx = cx ? f[0] : 1.0f - f[0];
      for (int cy = 0; cy < 2; ++cy) {
        const float wy = cy ? f[1] : 1.0f - f[1];
        for (int cz = 0; cz < 2; ++cz) {
          const float wz = cz ? f[2] : 1.0f - f[2];
          const int64_t p =
              (static_cast<int64_t>(i + cx) * py + (j + cy)) * pz + (k + cz);
          val = val + (wx * wy * wz) * bst::ldf(P, p);
        }
      }
    }
    const float* w = tables + static_cast<int64_t>(2 * v) * S;
    const float* ins = w + S;
    comb.add(val, ins[i] * ins[bx + j] * ins[bx + by + k],
             w[i] * w[bx + j] * w[bx + by + k], valid[v]);
  }
  fused[idx] = comb.fused();
  wsum[idx] = comb.wsum;
}

}  // namespace

extern "C" int bst_fuse_block_shift(
    const void* patches, int in_dtype, const void* fracs, const void* tables,
    const void* valid, int V, int bx, int by, int bz, int ft, void* fused,
    void* wsum, void* stream) {
  const int64_t n = static_cast<int64_t>(bx) * by * bz;
  if (n <= 0 || V <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  BST_DISPATCH_IN(in_dtype, T,
      fuse_block_shift_kernel<T><<<bst::grid_for(n), bst::kThreads, 0, s>>>(
          static_cast<const T*>(patches), static_cast<const float*>(fracs),
          static_cast<const float*>(tables), static_cast<const float*>(valid),
          V, bx, by, bz, ft, static_cast<float*>(fused),
          static_cast<float*>(wsum)));
  return static_cast<int>(cudaGetLastError());
}
