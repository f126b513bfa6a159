// K4: intensity conversion, the port of convert_intensity
// (bigstitcher_spark_tpu/ops/fusion.py:638 _convert_intensity_expr, jit
// :648): map [min, max] onto the full uint8 / uint16 range, round half to
// even, clip, cast; float32 passes through.
//
// One thread per voxel over a flat int64 index. Bound: bytes (4 read, 1-4
// written per voxel, four flops).
#include "fusion_common.cuh"

namespace {

template <typename O>
__global__ void convert_intensity_kernel(const float* __restrict__ in,
                                         int64_t n, float mn, float mx,
                                         O* __restrict__ out) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  out[idx] = bst::convert_value<O>(in[idx], mn, mx);
}

}  // namespace

extern "C" int bst_convert_intensity(const void* in, int64_t n, float mn,
                                     float mx, int out_dtype, void* out,
                                     void* stream) {
  if (n <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  BST_DISPATCH_OUT(out_dtype, O,
      convert_intensity_kernel<O><<<bst::grid_for(n), bst::kThreads, 0, s>>>(
          static_cast<const float*>(in), n, mn, mx, static_cast<O*>(out)));
  return static_cast<int>(cudaGetLastError());
}
