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
// Batch form (bst_fuse_block_shift_batch, ops/fusion.py
// fuse_block_shift_batch): the sharded route's batch of B blocks of one
// bucket (parallel/mesh.py:223 vmap of fuse_block_shift_impl) in one
// launch. Grid row blockIdx.y selects the block; each row reads its own
// patches, fracs, tables and valid mask at a row stride and writes its own
// outputs, with the per-block arithmetic unchanged (the per-block launch is
// the batch of one), so a row is bitwise the per-block launch's output.
// Padding rows (valid all 0) read their zero patches and write zeros.
//
// Bound: bytes. Per voxel it reads V patch values (8 taps that hit L1/L2
// mostly once from device memory) and writes two floats; ~30 flops per
// view-voxel stay far below the card's float32 rate.
//
// K27: whole-volume translation fusion from device-resident tiles, the
// port of fuse_volume_scan (ops/fusion.py:379 fuse_volume_scan_impl, jit
// :426; per view _one_view_device :367 and _realign :356). The JAX program
// scans the B output blocks in order; here one launch covers them all, a
// thread owning one output voxel of one block (blocks must not overlap).
// Per view slot it reads the resident tile directly where JAX slices and
// rolls a patch: patch voxel p along an axis is tile voxel
// clamp + ((p + delta) mod ps), clamp = clip(floor_off, 0, tshape - ps),
// delta = floor_off - clamp (the wrapper passes delta mod ps). Wrapped taps
// stand where the zero-padded patch of K2's route has zeros; the inside
// test weighs them 0 when the tiles are the images (no padding) and there
// is no --maskOffset, so the two routes then agree bit for bit. The sample,
// blend and combine are K2's device function. The float32 fused value, or
// wsum > 0 for masks, lands at block_offsets[b] + (i, j, k) of the volume
// (64-bit index); the wrapper converts the volume afterwards (K4).
//
// Bound: bytes, the tile sectors the views' windows cover (each read once
// from device memory, the taps of neighbouring voxels hit L1/L2) plus 4 B
// written a voxel. Simple first: no shared-memory staging of the windows.
#include "fusion_common.cuh"

namespace {

// Patch voxel (x, y, z) of a staged (bx+1, by+1, bz+1) patch (K2).
struct PatchIndex {
  int py, pz;
  __device__ int64_t operator()(int x, int y, int z) const {
    return (static_cast<int64_t>(x) * py + y) * pz + z;
  }
};

// Patch voxel (x, y, z) of a view's window in its resident tile (K27):
// clamp + ((p + d) mod ps) per axis, with d in [0, ps) and p in [0, ps).
struct TileIndex {
  int c[3], d[3], ps[3], ty, tz;
  __device__ static int wrap(int u, int n) { return u >= n ? u - n : u; }
  __device__ int64_t operator()(int x, int y, int z) const {
    const int64_t tx0 = c[0] + wrap(x + d[0], ps[0]);
    const int ty0 = c[1] + wrap(y + d[1], ps[1]);
    const int tz0 = c[2] + wrap(z + d[2], ps[2]);
    return (tx0 * ty + ty0) * tz + tz0;
  }
};

// One translated view at output voxel (i, j, k) into the combiner: the 8
// taps with constant corner weights in JAX's order, then the separable
// inside and blend weights from the view's table row (2, bx+by+bz).
template <typename T, typename Index>
__device__ __forceinline__ void add_shifted_view(
    bst::Combiner& comb, const T* P, Index at, const float* f,
    const float* table, int bx, int by, int bz, int i, int j, int k,
    float valid) {
  float val = 0.0f;
  for (int cx = 0; cx < 2; ++cx) {
    const float wx = cx ? f[0] : 1.0f - f[0];
    for (int cy = 0; cy < 2; ++cy) {
      const float wy = cy ? f[1] : 1.0f - f[1];
      for (int cz = 0; cz < 2; ++cz) {
        const float wz = cz ? f[2] : 1.0f - f[2];
        val = val + (wx * wy * wz) * bst::ldf(P, at(i + cx, j + cy, k + cz));
      }
    }
  }
  const int S = bx + by + bz;
  const float* w = table;
  const float* ins = table + S;
  comb.add(val, ins[i] * ins[bx + j] * ins[bx + by + k],
           w[i] * w[bx + j] * w[bx + by + k], valid);
}

// kBatch: grid row blockIdx.y selects the batch row (the batch form); the
// per-block launch takes the instantiation without it, the parent's code.
template <typename T, bool kBatch>
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
  const PatchIndex at{by + 1, bz + 1};
  const int64_t pvol = static_cast<int64_t>(bx + 1) * (by + 1) * (bz + 1);
  const int S = bx + by + bz;
  // the batch row: its views' patches and parameters, its outputs
  const int64_t row = kBatch ? blockIdx.y : 0;
  const T* __restrict__ pat = patches + row * V * pvol;
  const float* __restrict__ fr = fracs + row * V * 3;
  const float* __restrict__ tab = tables + row * V * 2 * S;
  const float* __restrict__ val = valid + row * V;

  bst::Combiner comb(ft);
  for (int v = 0; v < V; ++v)
    add_shifted_view(comb, pat + v * pvol, at, fr + 3 * v,
                     tab + static_cast<int64_t>(2 * v) * S, bx, by, bz, i,
                     j, k, val[v]);
  fused[row * n + idx] = comb.fused();
  wsum[row * n + idx] = comb.wsum;
}

// starts (B, K, 6): clamp x, y, z then delta mod ps x, y, z of each slot.
template <typename T>
__global__ void fuse_volume_scan_kernel(
    const T* __restrict__ tiles, int tx, int ty, int tz,
    const int* __restrict__ view_idx, const int* __restrict__ starts,
    const float* __restrict__ fracs, const float* __restrict__ tables,
    const float* __restrict__ valid, const int* __restrict__ block_offsets,
    int B, int K, int bx, int by, int bz, int oy, int oz, int ft, int masks,
    float* __restrict__ out) {
  const int64_t nb = static_cast<int64_t>(bx) * by * bz;
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= nb * B) return;
  const int b = static_cast<int>(idx / nb);
  const int64_t e = idx - b * nb;
  const int k = static_cast<int>(e % bz);
  const int64_t r = e / bz;
  const int j = static_cast<int>(r % by);
  const int i = static_cast<int>(r / by);
  const int64_t tvol = static_cast<int64_t>(tx) * ty * tz;
  const int S = bx + by + bz;

  bst::Combiner comb(ft);
  for (int s = 0; s < K; ++s) {
    const int bs = b * K + s;
    const int* st = starts + 6 * bs;
    const TileIndex at{{st[0], st[1], st[2]}, {st[3], st[4], st[5]},
                       {bx + 1, by + 1, bz + 1}, ty, tz};
    add_shifted_view(comb, tiles + view_idx[bs] * tvol, at, fracs + 3 * bs,
                     tables + static_cast<int64_t>(2 * bs) * S, bx, by, bz,
                     i, j, k, valid[bs]);
  }
  const int* o = block_offsets + 3 * b;
  const int64_t q =
      (static_cast<int64_t>(o[0] + i) * oy + (o[1] + j)) * oz + (o[2] + k);
  out[q] = masks ? (comb.wsum > 0.0f ? 1.0f : 0.0f) : comb.fused();
}

}  // namespace

// patches (B, V, bx+1, by+1, bz+1), fracs (B, V, 3), tables (B, V, 2,
// bx+by+bz), valid (B, V); fused, wsum (B, bx, by, bz).
extern "C" int bst_fuse_block_shift_batch(
    const void* patches, int in_dtype, const void* fracs, const void* tables,
    const void* valid, int B, int V, int bx, int by, int bz, int ft,
    void* fused, void* wsum, void* stream) {
  const int64_t n = static_cast<int64_t>(bx) * by * bz;
  if (n <= 0 || V <= 0 || B <= 0 || B > 65535) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(bst::grid_for(n), B);
#define BST_SHIFT_LAUNCH(BATCH)                                              \
  fuse_block_shift_kernel<T, BATCH><<<grid, bst::kThreads, 0, s>>>(          \
      static_cast<const T*>(patches), static_cast<const float*>(fracs),     \
      static_cast<const float*>(tables), static_cast<const float*>(valid),  \
      V, bx, by, bz, ft, static_cast<float*>(fused),                        \
      static_cast<float*>(wsum))
  BST_DISPATCH_IN(in_dtype, T,
      if (B > 1) BST_SHIFT_LAUNCH(true); else BST_SHIFT_LAUNCH(false));
#undef BST_SHIFT_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bst_fuse_volume_scan(
    const void* tiles, int in_dtype, int tx, int ty, int tz,
    const void* view_idx, const void* starts, const void* fracs,
    const void* tables, const void* valid, const void* block_offsets, int B,
    int K, int bx, int by, int bz, int oy, int oz, int ft, int masks,
    void* out, void* stream) {
  const int64_t n = static_cast<int64_t>(B) * bx * by * bz;
  if (n <= 0 || K <= 0 || tx <= bx || ty <= by || tz <= bz)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  BST_DISPATCH_IN(in_dtype, T,
      fuse_volume_scan_kernel<T><<<bst::grid_for(n), bst::kThreads, 0, s>>>(
          static_cast<const T*>(tiles), tx, ty, tz,
          static_cast<const int*>(view_idx), static_cast<const int*>(starts),
          static_cast<const float*>(fracs), static_cast<const float*>(tables),
          static_cast<const float*>(valid),
          static_cast<const int*>(block_offsets), B, K, bx, by, bz, oy, oz,
          ft, masks, static_cast<float*>(out)));
  return static_cast<int>(cudaGetLastError());
}
