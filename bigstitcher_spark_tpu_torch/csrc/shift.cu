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
// [v][0] blend, [v][1] inside, x then y then z.
//
// Launch (ops/fusion.py shift_launch_plan): a thread owns kResampleR = 4
// consecutive z outputs of one (i, j) column, lanes_z threads a column
// (K3's choice), a block of 256 threads a tile of one i (tile_j columns x
// tile_z outputs); grid index blockIdx.z is the batch row. No division
// runs per voxel: a thread finds its place once, 32-bit.
//   * Staging. A block copies each view's window, the 2 x (tile_j + 1)
//     patch rows of tile_z + 1 values its taps read, into shared memory
//     with asynchronous 16-byte copies (cp.async), every copy of the stage
//     in flight at once, from each row's z0 value's aligned-down address
//     (the plan's row_bytes a row); up to 8 views a stage, as the 47 KB a
//     block may hold allow (4 at the main path's 256x256x64 uint16 block,
//     all of its views). Beside it the block stages what is constant over
//     a block, a column or a z: the 8 corner weights (wx wy) wz, computed
//     once a view (the fractions are the view's), a column's ins[i]
//     ins[bx+j] and w[i] w[bx+j], and the z tables of the tile's ks.
//   * Combining. A thread reads its run's 5 values of each of its 4 (cx,
//     cy) rows from the window (20 reads a view where one thread a voxel
//     read 32 taps from L1), converts them (exact: integers below 2^24),
//     and combines the views in order; the z tables come as one float4.
//   * The fusion type is a template parameter (K3's dispatch; read at run
//     time in the int64 instantiation only); 5 blocks an SM (48
//     registers a thread).
// Tried on the card and not kept (each slower at the main path's block):
// taps loaded from L1 into registers with the next view's loads in flight
// (the issue's first choice); aligned 8-byte loads of a run cut out with
// funnel shifts; windows converted to float32 while staged through
// registers; and one block an SM walking the tiles with two buffers, the
// next tile's copies in flight while one is combined (PERF.md, slice 19).
//
// Bits: each voxel sums its 8 taps in JAX's order (cx, then cy, then cz),
// val = val + w P from val = 0, and combines view by view with
// ((ins_x ins_y) ins_z) and ((w_x w_y) w_z), the products the parent
// computed per voxel (the JAX expression multiplies left to right, so the
// column's x-y products are the ones every voxel of it formed), with every
// operation rounded on its own (-fmad=false): the outputs are bitwise the
// first form's and the twin's.
//
// Batch form (bst_fuse_block_shift_batch, ops/fusion.py
// fuse_block_shift_batch): the sharded route's batch of B blocks of one
// bucket (parallel/mesh.py:223 vmap of fuse_block_shift_impl) in one
// launch. Each row reads its own patches, fracs, tables and valid mask at a
// row stride and writes its own outputs; the per-block launch is the batch
// of one, so a row is bitwise the per-block launch's output. Padding rows
// (valid all 0) read their zero patches and write zeros.
//
// Bound: bytes, each patch value read once from device memory (the next
// plane's block reads it again from L2) and two floats written a voxel. At
// the main path's block the kernel issues ~40 instructions a view-voxel
// (16 for the 8 taps' products and sums, 7 for the combine), so the issue
// rate, not the bytes, sets its time.
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
// blend and combine are add_shifted_view below, one thread a voxel (the
// arithmetic K2's first form took, and its bits). The float32 fused value, or
// wsum > 0 for masks, lands at block_offsets[b] + (i, j, k) of the volume
// (64-bit index); the wrapper converts the volume afterwards (K4).
//
// Bound: bytes, the tile sectors the views' windows cover (each read once
// from device memory, the taps of neighbouring voxels hit L1/L2) plus 4 B
// written a voxel. Not redesigned yet (ROADMAP Queue 2 Part B): one
// thread a voxel, 8 tap loads a view-voxel, the fusion type read at run
// time.
#include "fusion_common.cuh"

namespace {

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

using bst::kResampleR;
static_assert(kResampleR == 4, "a run's z tables are read as one float4");

// 16 bytes from global to shared memory, asynchronously: the first
// `bytes` (0 to 16) of src, zeros after them.
__device__ __forceinline__ void copy16_async(void* dst, const void* src,
                                             int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void copies_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until this thread's committed copies landed.
__device__ __forceinline__ void copies_wait() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// Dynamic shared memory a block may take without opting in, less the
// static constants (ops/fusion.py SHIFT_SMEM).
constexpr int kShiftSmemBytes = 48 * 1024 - 1024;

// One view's corner weights (wx wy) wz, corner n = 4 cx + 2 cy + cz, and
// valid flag, computed once a view and block.
struct __align__(16) ShiftView {
  float c[8];
  float valid;
};

// A column's x-y products of one view: ins[i] ins[bx+j], w[i] w[bx+j].
struct ColumnXY {
  float ins, blend;
};

// Threads a block (ops/fusion.py SHIFT_THREADS), and blocks an SM the
// register budget is set for: 48 registers a thread, with no spills.
constexpr int kShiftThreads = 256;
constexpr int kShiftBlocksPerSM = 5;

// Grid: (bx n_jt, z tiles, B); ops/fusion.py shift_launch_plan, which
// also gives nvs (views staged at once) and row_bytes (a staged row's
// pitch). Dynamic shared memory, per stage: the nvs views' windows (2
// planes x tile_j + 1 rows x row_bytes, a row's bytes from its z0 value's
// 16-byte aligned-down address), their column products (tile_j each) and
// z tables (tile_z each, inside then blend).
template <typename T, typename Idx, int FT>
__global__ void __launch_bounds__(kShiftThreads, kShiftBlocksPerSM)
    fuse_block_shift_kernel(
    const T* __restrict__ patches, const float* __restrict__ fracs,
    const float* __restrict__ tables, const float* __restrict__ valid, int V,
    int bx, int by, int bz, int ft, int lanes_z, int n_jt, int nvs,
    int row_bytes, int vec4, float* __restrict__ fused,
    float* __restrict__ wsum) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ ShiftView sv[bst::kResampleViewChunk];
  const int tile_j = kShiftThreads / lanes_z;
  const int tile_z = kResampleR * lanes_z;
  const int rows_v = 2 * (tile_j + 1);   // staged rows a view
  const int win = rows_v * row_bytes;    // a view's window
  ColumnXY* col = reinterpret_cast<ColumnXY*>(smem + nvs * win);
  float* zin = reinterpret_cast<float*>(col + nvs * tile_j);
  float* zbl = zin + nvs * tile_z;
  const int S = bx + by + bz;
  const int64_t pvol = static_cast<int64_t>(bx + 1) * (by + 1) * (bz + 1);
  const int64_t n = static_cast<int64_t>(bx) * by * bz;
  const char* pend =
      reinterpret_cast<const char*>(patches + gridDim.z * V * pvol);
  {
    // the batch row: its views' patches and parameters, its outputs
    const int64_t row = blockIdx.z;
    patches += row * V * pvol;
    fracs += row * V * 3;
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
  const int k0 = z0 + lz * kResampleR;
  const int nk = j < by ? max(0, min(kResampleR, bz - k0)) : 0;
  // staged row rr of a view: plane i + rr / (tile_j + 1), patch row
  // min(j0 + rr mod (tile_j + 1), by), from z0; e / d as umulhi(e, M) with
  // M = ceil(2^32 / d), exact for e below 2^32 / d
  const int nch = row_bytes / 16;
  const unsigned m_nch = 0xFFFFFFFFu / nch + 1;
  const unsigned m_rows = 0xFFFFFFFFu / rows_v + 1;
  // this thread's four rows (cx, cy) = (q >> 1, q & 1): the run's byte
  // offset in a window, and the row's z0 value's address mod 16 in view 0
  // (in view v, plus v pvol sizeof(T), mod 16)
  int srow[4], lead0[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    srow[q] = ((q >> 1) * (tile_j + 1) + jj + (q & 1)) * row_bytes +
              (k0 - z0) * static_cast<int>(sizeof(T));
    lead0[q] = static_cast<int>(
        reinterpret_cast<uintptr_t>(
            patches + (static_cast<Idx>(i + (q >> 1)) * (by + 1) +
                       min(j + (q & 1), by)) * (bz + 1) + z0) & 15);
  }
  const int vstep = static_cast<int>((pvol * sizeof(T)) & 15);

  bst::CombinerT<FT> comb[kResampleR];
#pragma unroll
  for (int r = 0; r < kResampleR; ++r) comb[r] = bst::CombinerT<FT>(ft);
  const bool blended = comb[0].kind() == bst::AVG_BLEND;

  for (int c0 = 0; c0 < V; c0 += nvs) {
    const int nv = min(nvs, V - c0);
    __syncthreads();  // the previous stage is read
    // the views' windows: each staged row in 16-byte copies from its z0
    // value's aligned-down address (the patches are 16-byte aligned)
    const unsigned total = nv * rows_v * nch;
    for (unsigned e = threadIdx.x; e < total; e += kShiftThreads) {
      const unsigned rw = __umulhi(e, m_nch), m = e - rw * nch;
      const unsigned vv = __umulhi(rw, m_rows), rr = rw - vv * rows_v;
      const int cx = rr >= static_cast<unsigned>(tile_j + 1);
      const int u = rr - cx * (tile_j + 1);
      const T* rp = patches + static_cast<int64_t>(c0 + vv) * pvol +
                    (static_cast<Idx>(i + cx) * (by + 1) + min(j0 + u, by)) *
                        (bz + 1) + z0;
      const char* g = reinterpret_cast<const char*>(
                          reinterpret_cast<uintptr_t>(rp) & ~uintptr_t{15}) +
                      16 * m;
      const int64_t left = pend - g;  // the patches end within 16 bytes
      const int bytes = left <= 0 ? 0 : left >= 16 ? 16 : static_cast<int>(left);
      copy16_async(smem + vv * win + rr * row_bytes + 16 * m,
                   bytes > 0 ? g : reinterpret_cast<const char*>(patches),
                   bytes);
    }
    copies_commit();
    // the views' constants
    if (threadIdx.x < nv) {
      const int v = c0 + threadIdx.x;
      const float* f = fracs + 3 * v;
      ShiftView s;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float wx = c & 4 ? f[0] : 1.0f - f[0];
        const float wy = c & 2 ? f[1] : 1.0f - f[1];
        const float wz = c & 1 ? f[2] : 1.0f - f[2];
        s.c[c] = wx * wy * wz;
      }
      s.valid = valid[v];
      sv[threadIdx.x] = s;
    }
    for (int t = threadIdx.x; t < nv * tile_j; t += kShiftThreads) {
      const int vv = t / tile_j, u = t - vv * tile_j;
      const float* tb = tables + static_cast<int64_t>(2 * (c0 + vv)) * S;
      const int jc = min(j0 + u, by - 1);  // a column past the block: unused
      col[t] = ColumnXY{tb[S + i] * tb[S + bx + jc],
                        blended ? tb[i] * tb[bx + jc] : 0.0f};
    }
    for (int t = threadIdx.x; t < nv * tile_z; t += kShiftThreads) {
      const int vv = t / tile_z, u = t - vv * tile_z;
      const float* tb = tables + static_cast<int64_t>(2 * (c0 + vv)) * S;
      const int k = z0 + u;
      zin[t] = k < bz ? tb[S + bx + by + k] : 0.0f;
      zbl[t] = k < bz && blended ? tb[bx + by + k] : 0.0f;
    }
    copies_wait();
    __syncthreads();
    if (nk == 0) continue;
    for (int vv = 0; vv < nv; ++vv) {
      // the run's taps: 5 values of each row from the view's window, each
      // converted exactly (past a partial run's end: unused values)
      const int vlead = ((c0 + vv) * vstep) & 15;
      float c[4][kResampleR + 1];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const T* rp = reinterpret_cast<const T*>(
            smem + vv * win + srow[q] + ((lead0[q] + vlead) & 15));
#pragma unroll
        for (int r = 0; r <= kResampleR; ++r)
          c[q][r] = static_cast<float>(rp[r]);
      }
      const ShiftView& s = sv[vv];
      float w[8];
#pragma unroll
      for (int m = 0; m < 8; ++m) w[m] = s.c[m];
      const ColumnXY xy = col[vv * tile_j + jj];
      const float4 zi = *reinterpret_cast<const float4*>(
          zin + vv * tile_z + lz * kResampleR);
      const float4 zb = *reinterpret_cast<const float4*>(
          zbl + vv * tile_z + lz * kResampleR);
      const float zir[4] = {zi.x, zi.y, zi.z, zi.w};
      const float zbr[4] = {zb.x, zb.y, zb.z, zb.w};
#pragma unroll
      for (int r = 0; r < kResampleR; ++r) {
        float val = 0.0f;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          val = val + w[2 * q] * c[q][r];
          val = val + w[2 * q + 1] * c[q][r + 1];
        }
        comb[r].add(val, xy.ins * zir[r], xy.blend * zbr[r], s.valid);
      }
    }
  }
  if (nk == 0) return;
  const int64_t at = (static_cast<int64_t>(i) * by + j) * bz + k0;
  if (vec4 && nk == kResampleR) {
    *reinterpret_cast<float4*>(fused + at) = make_float4(
        comb[0].fused(), comb[1].fused(), comb[2].fused(), comb[3].fused());
    *reinterpret_cast<float4*>(wsum + at) = make_float4(
        comb[0].wsum, comb[1].wsum, comb[2].wsum, comb[3].wsum);
  } else {
    for (int r = 0; r < nk; ++r) {
      fused[at + r] = comb[r].fused();
      wsum[at + r] = comb[r].wsum;
    }
  }
}

template <typename T, typename Idx, int FT>
cudaError_t launch_shift(dim3 grid, cudaStream_t s, int smem, const T* patches,
                         const float* fracs, const float* tables,
                         const float* valid, int V, int bx, int by, int bz,
                         int ft, int lanes_z, int n_jt, int nvs, int row_bytes,
                         int vec4, float* fused, float* wsum) {
  fuse_block_shift_kernel<T, Idx, FT><<<grid, kShiftThreads, smem, s>>>(
      patches, fracs, tables, valid, V, bx, by, bz, ft, lanes_z, n_jt, nvs,
      row_bytes, vec4, fused, wsum);
  return cudaGetLastError();
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

// lanes_z, n_jt, grid_x, grid_y, nvs, row_bytes, smem: ops/fusion.py
// shift_launch_plan; idx64: a patch of 2^31 elements or more. patches (B,
// V, bx+1, by+1, bz+1), 16-byte aligned; fracs (B, V, 3), tables (B, V, 2,
// bx+by+bz), valid (B, V); fused, wsum (B, bx, by, bz).
extern "C" int bst_fuse_block_shift_batch(
    const void* patches, int in_dtype, const void* fracs, const void* tables,
    const void* valid, int B, int V, int bx, int by, int bz, int ft,
    int lanes_z, int n_jt, int grid_x, int grid_y, int nvs, int row_bytes,
    int smem, int idx64, void* fused, void* wsum, void* stream) {
  const int64_t n = static_cast<int64_t>(bx) * by * bz;
  if (n <= 0 || V <= 0 || B <= 0 || B > 65535) return cudaErrorInvalidValue;
  const int tile_j = kShiftThreads / lanes_z;
  const int tile_z = kResampleR * lanes_z;
  if (lanes_z < 1 || lanes_z > 32 || (lanes_z & (lanes_z - 1)) != 0 ||
      n_jt != (by + tile_j - 1) / tile_j ||
      static_cast<int64_t>(grid_x) != static_cast<int64_t>(bx) * n_jt ||
      static_cast<int64_t>(grid_y) * tile_z < bz ||
      static_cast<int64_t>(grid_y - 1) * tile_z >= bz || grid_y > 65535)
    return cudaErrorInvalidValue;
  const int isz = in_dtype == bst::IN_U8 ? 1 : in_dtype == bst::IN_F32 ? 4 : 2;
  const int64_t need = static_cast<int64_t>(nvs) *
                       (2 * (tile_j + 1) * static_cast<int64_t>(row_bytes) +
                        8 * tile_j + 8 * tile_z);
  if (nvs < 1 || nvs > bst::kResampleViewChunk || row_bytes % 16 != 0 ||
      row_bytes < (16 - isz) + (tile_z + 1) * isz || smem < need ||
      smem > kShiftSmemBytes)
    return cudaErrorInvalidValue;
  const int64_t pvol = static_cast<int64_t>(bx + 1) * (by + 1) * (bz + 1);
  if (!idx64 && pvol >= (int64_t{1} << 31)) return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(patches) % 16 != 0)
    return cudaErrorMisalignedAddress;
  const int vec4 = bz % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(fused) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(wsum) % 16 == 0;
  const dim3 grid(grid_x, grid_y, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
#define BST_SHIFT_ARGS(T)                                                    \
  grid, s, smem, static_cast<const T*>(patches),                            \
      static_cast<const float*>(fracs), static_cast<const float*>(tables),  \
      static_cast<const float*>(valid), V, bx, by, bz, ft, lanes_z, n_jt,   \
      nvs, row_bytes, vec4, static_cast<float*>(fused),                     \
      static_cast<float*>(wsum)
  if (idx64) {
    BST_DISPATCH_IN(in_dtype, T,
        err = (launch_shift<T, int64_t, bst::kRuntimeFT>(BST_SHIFT_ARGS(T))));
  } else {
    BST_DISPATCH_IN(in_dtype, T,
        BST_DISPATCH_FT(ft, FT,
            err = (launch_shift<T, int, FT>(BST_SHIFT_ARGS(T)))));
  }
#undef BST_SHIFT_ARGS
  return static_cast<int>(err);
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
