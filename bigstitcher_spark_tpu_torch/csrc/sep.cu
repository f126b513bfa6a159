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
// [v][0] blend, [v][1] inside, x then y then z. One thread per output voxel,
// z fastest; the views are a loop inside the thread, combined by fusion type
// as K2 does (bst::Combiner).
//
// Bound: bytes. Per voxel it reads V x 8 patch taps (neighbouring threads
// share them through L1/L2, so device memory sees each patch byte about
// once) and writes two floats; ~40 flops per view-voxel stay far below the
// card's float32 rate.
//
// Batch form (bst_fuse_block_sep_batch, ops/fusion.py fuse_block_sep_batch):
// the sharded route's batch of B blocks of one bucket (parallel/mesh.py:223
// vmap of fuse_block_sep_impl) in one launch; grid row blockIdx.y selects
// the block, whose patches, diagonals, translations, tables and valid mask
// are read at a row stride. The per-block launch is the batch of one, so a
// row is bitwise the per-block output; padding rows (valid all 0) write
// zeros.
#include "fusion_common.cuh"

namespace {

// kBatch: grid row blockIdx.y selects the batch row (the batch form); the
// per-block launch takes the instantiation without it, the parent's code.
template <typename T, bool kBatch>
__global__ void fuse_block_sep_kernel(
    const T* __restrict__ patches, int px, int py, int pz,
    const float* __restrict__ diags, const float* __restrict__ ts,
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
  const int c[3] = {i, j, k};
  const int ext[3] = {px, py, pz};
  const int64_t pvol = static_cast<int64_t>(px) * py * pz;
  const int S = bx + by + bz;
  // the batch row: its views' patches and parameters, its outputs
  const int64_t row = kBatch ? blockIdx.y : 0;
  const T* __restrict__ pat = patches + row * V * pvol;
  const float* __restrict__ dg = diags + row * V * 3;
  const float* __restrict__ tr = ts + row * V * 3;
  const float* __restrict__ tab = tables + row * V * 2 * S;
  const float* __restrict__ val = valid + row * V;

  bst::Combiner comb(ft);
  for (int v = 0; v < V; ++v) {
    const T* P = pat + v * pvol;
    int lo[3], hi[3];
    float f[3];
    for (int d = 0; d < 3; ++d) {
      // one rounding, as XLA contracts the JAX expression diag * i + t
      const float pos =
          fmaf(dg[3 * v + d], static_cast<float>(c[d]), tr[3 * v + d]);
      bst::interp_row(pos, 0, ext[d], &lo[d], &hi[d], &f[d]);
    }
    // contract x, then y, then z
    float vz[2];
    for (int cz = 0; cz < 2; ++cz) {
      const int z = cz ? hi[2] : lo[2];
      float vy[2];
      for (int cy = 0; cy < 2; ++cy) {
        const int64_t yz = static_cast<int64_t>(cy ? hi[1] : lo[1]) * pz + z;
        vy[cy] = bst::ldf(P, lo[0] * static_cast<int64_t>(py) * pz + yz) *
                     (1.0f - f[0]) +
                 bst::ldf(P, hi[0] * static_cast<int64_t>(py) * pz + yz) * f[0];
      }
      vz[cz] = vy[0] * (1.0f - f[1]) + vy[1] * f[1];
    }
    const float sample = vz[0] * (1.0f - f[2]) + vz[1] * f[2];
    const float* w = tab + static_cast<int64_t>(2 * v) * S;
    const float* ins = w + S;
    comb.add(sample, ins[i] * ins[bx + j] * ins[bx + by + k],
             w[i] * w[bx + j] * w[bx + by + k], val[v]);
  }
  fused[row * n + idx] = comb.fused();
  wsum[row * n + idx] = comb.wsum;
}

}  // namespace

// patches (B, V, px, py, pz), diags, ts (B, V, 3), tables (B, V, 2,
// bx+by+bz), valid (B, V); fused, wsum (B, bx, by, bz).
extern "C" int bst_fuse_block_sep_batch(
    const void* patches, int in_dtype, int px, int py, int pz,
    const void* diags, const void* ts, const void* tables, const void* valid,
    int B, int V, int bx, int by, int bz, int ft, void* fused, void* wsum,
    void* stream) {
  const int64_t n = static_cast<int64_t>(bx) * by * bz;
  if (n <= 0 || V <= 0 || px <= 0 || py <= 0 || pz <= 0 || B <= 0 ||
      B > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(bst::grid_for(n), B);
#define BST_SEP_LAUNCH(BATCH)                                                \
  fuse_block_sep_kernel<T, BATCH><<<grid, bst::kThreads, 0, s>>>(            \
      static_cast<const T*>(patches), px, py, pz,                           \
      static_cast<const float*>(diags), static_cast<const float*>(ts),      \
      static_cast<const float*>(tables), static_cast<const float*>(valid),  \
      V, bx, by, bz, ft, static_cast<float*>(fused),                        \
      static_cast<float*>(wsum))
  BST_DISPATCH_IN(in_dtype, T,
      if (B > 1) BST_SEP_LAUNCH(true); else BST_SEP_LAUNCH(false));
#undef BST_SEP_LAUNCH
  return static_cast<int>(cudaGetLastError());
}
