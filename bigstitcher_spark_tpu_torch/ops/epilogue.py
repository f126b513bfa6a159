"""The sharded fusion route's per-block epilogue: one CUDA kernel (K28) and
its plain-torch twin.

Port of the epilogue of ``_build_sharded_fuser``'s per-block program
(``bigstitcher_spark_tpu/parallel/mesh.py:223-242``): a batch of fused
float32 blocks becomes the block in its storage type (the intensity
conversion, or the coverage mask) and every eligible pyramid level, each
the float32 mean of the previous stored level over its relative factors,
converted back to the storage type (``convert_storage``). The levels are
what the container-reread downsample stage makes from the written level
below, bit for bit, as long as each level's absolute factors divide the
block (``models.affine_fusion.eligible_epilogue_levels`` checks that).

:func:`block_epilogue` launches ``csrc/epilogue.cu`` on CUDA tensors and
takes :func:`block_epilogue_plain` only because its tensors lie on the
CPU; it counts its launches in its ``launches`` attribute.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _cuda
from .downsample import convert_storage, downsample_block_plain
from .fusion import _F32, _out_spec, _require, _stream, convert_intensity_plain

MAX_LEVELS = 8  # csrc/epilogue.cu kMaxLevels


def _rels(pyramid_rels) -> list[tuple[int, int, int]]:
    rels = [tuple(int(v) for v in r) for r in (pyramid_rels or ())]
    if any(len(r) != 3 or min(r) < 1 for r in rels):
        raise ValueError(f"relative factors must be three ints >= 1: {rels}")
    return rels


def _level_dims(shape, rels) -> list[tuple[int, int, int]]:
    """Each level's extent of a (X, Y, Z) block; raises where a level's
    absolute factor does not divide the block."""
    dims, cur = [], tuple(int(s) for s in shape)
    for r in rels:
        if any(c % f for c, f in zip(cur, r)):
            raise ValueError(f"pyramid factors {rels} do not divide the "
                             f"block {tuple(shape)}")
        cur = tuple(c // f for c, f in zip(cur, r))
        dims.append(cur)
    return dims


def block_epilogue_plain(fused: torch.Tensor, wsum: torch.Tensor | None,
                         min_i: float, max_i: float, out_dtype: str,
                         masks: bool = False, pyramid_rels=()):
    """Plain-torch K28: ``fused`` (B, X, Y, Z) float32 -> [s0, level 1,
    ...], s0 (B, X, Y, Z) and each level (B, X / a_x, Y / a_y, Z / a_z) in
    ``out_dtype``. s0 is ``convert_intensity_plain`` of ``fused``, or in
    ``masks`` mode (wsum > 0) times the storage type's maximum (1 for
    float32); each level ``convert_storage(downsample_block_plain(...))``
    of the level before (JAX ``parallel/mesh.py:223-242``)."""
    rels = _rels(pyramid_rels)
    _level_dims(fused.shape[-3:], rels)
    _code, dtype, imax = _out_spec(out_dtype)
    if masks:
        s0 = (wsum > 0).to(torch.float32)
        if imax is not None:
            s0 = (s0 * imax).to(dtype)
    else:
        s0 = convert_intensity_plain(fused, min_i, max_i, out_dtype)
    out = [s0]
    for r in rels:
        out.append(convert_storage(downsample_block_plain(out[-1], r),
                                   out_dtype))
    return out


def block_epilogue(fused: torch.Tensor, wsum: torch.Tensor | None,
                   min_i: float, max_i: float, out_dtype: str,
                   masks: bool = False, pyramid_rels=()):
    """K28 (``csrc/epilogue.cu``) on CUDA, the plain version on the CPU.

    fused (B, X, Y, Z) float32; wsum the same (read in ``masks`` mode
    only); ``pyramid_rels`` each level's relative factors (at most 8
    levels), whose products must divide (X, Y, Z). Returns [s0, level 1,
    ...] in ``out_dtype`` (uint8, uint16 or float32), one launch."""
    if fused.device.type == "cpu":
        return block_epilogue_plain(fused, wsum, min_i, max_i, out_dtype,
                                    masks, pyramid_rels)
    dev = fused.device
    if fused.dim() != 4:
        raise ValueError("fused must be (B, X, Y, Z)")
    _require(fused, "fused", dev, _F32)
    if masks:
        _require(wsum, "wsum", dev, _F32, tuple(fused.shape))
    rels = _rels(pyramid_rels)
    if len(rels) > MAX_LEVELS:
        raise ValueError(f"at most {MAX_LEVELS} epilogue levels, got "
                         f"{len(rels)}")
    B = int(fused.shape[0])
    dims = _level_dims(fused.shape[1:], rels)
    code, dtype, _imax = _out_spec(out_dtype)
    s0 = torch.empty(tuple(fused.shape), dtype=dtype, device=dev)
    levels = [torch.empty((B, *d), dtype=dtype, device=dev) for d in dims]
    ptrs = (ctypes.c_void_p * max(1, len(levels)))(
        *[t.data_ptr() for t in levels])
    flat = (ctypes.c_int * max(3, 3 * len(rels)))(
        *[f for r in rels for f in r])
    lib = _cuda.load("epilogue")
    ret = lib.bst_block_epilogue(
        fused.data_ptr(), wsum.data_ptr() if masks else None, B,
        *(int(s) for s in fused.shape[1:]), float(np.float32(min_i)),
        float(np.float32(max_i)), int(bool(masks)), code, len(levels), ptrs,
        flat, s0.data_ptr(), _stream(dev))
    _cuda.check(lib, ret, "block_epilogue")
    block_epilogue.launches += 1
    return [s0, *levels]


block_epilogue.launches = 0


KERNEL_WRAPPERS = {"block_epilogue": block_epilogue}

