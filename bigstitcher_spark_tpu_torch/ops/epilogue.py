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

:func:`block_epilogue` launches ``csrc/epilogue.cu`` on CUDA tensors, as
:func:`epilogue_plan` lays it out (a block of threads a tile of the last
level and its footprint in every level below, kept in shared memory), and
takes :func:`block_epilogue_plain` only because its tensors lie on the
CPU; it counts its launches in its ``launches`` attribute.
"""

from __future__ import annotations

import ctypes
import math
from collections import namedtuple

import numpy as np
import torch

from . import _cuda
from .downsample import convert_storage, downsample_block_plain
from .fusion import (_F32, _cdiv, _out_spec, _require, _stream,
                     convert_intensity_plain)

MAX_LEVELS = 8  # csrc/epilogue.cu kMaxLevels
# K28's launch (csrc/epilogue.cu): EPILOGUE_THREADS threads a block, which
# owns a tile of the last level and keeps its footprint in the levels below
# in at most EPILOGUE_SMEM bytes of shared memory; a tile's footprint in
# the input aims at EPILOGUE_TILE_VOXELS voxels, whole z rows up to
# EPILOGUE_MAX_Z long.
EPILOGUE_THREADS = 256
EPILOGUE_SMEM = 48 * 1024
EPILOGUE_TILE_VOXELS = 4096
EPILOGUE_MAX_Z = 128

# A level's box in a block's tile: ``dims`` its extents at a whole tile,
# ``steps`` the threads' split (x rows, y rows, z items of ``width``
# voxels), ``smem_off`` its byte offset in shared memory (-1: not kept).
EpilogueBox = namedtuple("EpilogueBox", "dims steps width smem_off")
# One launch: it reads level ``first`` (0: the fused block, converted and
# stored as s0) and makes the levels first+1 .. first+len(rels); ``tile``
# in the last of them, ``ntiles`` per block, grid (prod(ntiles), B).
EpilogueSegment = namedtuple(
    "EpilogueSegment", "first rels dims tile ntiles boxes smem vec")


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


def _scales(rels):
    """Each box's voxels per last-level voxel: [prod(rels), ..., (1,1,1)]."""
    out = [(1, 1, 1)]
    for r in reversed(rels):
        out.insert(0, tuple(a * f for a, f in zip(out[0], r)))
    return out


def _split(dims, width: int):
    """Threads over a box of ``dims`` in items of ``width`` z voxels: z
    items fastest, then y rows, then x planes, at most EPILOGUE_THREADS."""
    nq = _cdiv(dims[2], width)
    qs = min(nq, EPILOGUE_THREADS)
    ys = min(dims[1], EPILOGUE_THREADS // qs)
    return (min(dims[0], EPILOGUE_THREADS // (qs * ys)), ys, qs)


def _boxes(tile, rels, itemsize: int, vec: int):
    """The boxes of a segment (its input, then each level) at ``tile``; the
    last is not kept in shared memory. Returns (boxes, smem bytes)."""
    boxes, off = [], 0
    for l, sc in enumerate(_scales(rels)):
        dims = tuple(t * a for t, a in zip(tile, sc))
        width = vec if l == 0 else 1
        kept = l < len(rels)
        boxes.append(EpilogueBox(dims, _split(dims, width), width,
                                 off if kept else -1))
        if kept:
            off += _cdiv(math.prod(dims) * itemsize, 16) * 16
    return boxes, off


def _segment_tile(last, scale0, rels, itemsize):
    """The last level's tile: whole z rows of the input up to
    EPILOGUE_MAX_Z, then y rows and x planes up to EPILOGUE_TILE_VOXELS
    input voxels; halved along its longest input extent while its boxes
    pass EPILOGUE_SMEM."""
    ax, ay, az = scale0
    tz = min(last[2], max(1, EPILOGUE_MAX_Z // az))
    ty = min(last[1], max(1, EPILOGUE_TILE_VOXELS // (tz * az * ay * ax)))
    tx = min(last[0], max(1, EPILOGUE_TILE_VOXELS // (tz * az * ty * ay * ax)))
    tile = [tx, ty, tz]
    while _boxes(tile, rels, itemsize, 1)[1] > EPILOGUE_SMEM:
        d = max((d for d in range(3) if tile[d] > 1),
                key=lambda d: tile[d] * scale0[d])
        tile[d] = _cdiv(tile[d], 2)
    return tuple(tile)


def epilogue_plan(block_shape, pyramid_rels, itemsize: int,
                  aligned: bool = True) -> list:
    """K28's launches for a (X, Y, Z) block, the levels' relative factors
    and the storage type's ``itemsize``: a list of :data:`EpilogueSegment`,
    one on every block whose levels' footprint fits shared memory (the
    main path's). A segment takes as many levels as a one-voxel tile's
    boxes fit EPILOGUE_SMEM; the next reads the last level made. Phase 1
    reads vectors of 4 (``vec``) where the block's z extent and the tile's
    allow it and ``aligned`` (the fused, wsum and s0 pointers)."""
    rels = _rels(pyramid_rels)
    if len(rels) > MAX_LEVELS:
        raise ValueError(f"at most {MAX_LEVELS} epilogue levels, got "
                         f"{len(rels)}")
    dims = [tuple(int(s) for s in block_shape)] + _level_dims(block_shape,
                                                              rels)
    segs, first = [], 0
    while True:
        take = len(rels) - first
        while take > 0 and _boxes((1, 1, 1), rels[first:first + take],
                                  itemsize, 1)[1] > EPILOGUE_SMEM:
            take -= 1
        if take == 0 and first < len(rels):
            raise ValueError(f"level {first + 1}'s window {rels[first]} "
                             f"exceeds K28's shared memory")
        srels = rels[first:first + take]
        last = dims[first + take]
        tile = _segment_tile(last, _scales(srels)[0], srels, itemsize)
        vec = 4 if (first == 0 and aligned and dims[0][2] % 4 == 0
                    and tile[2] * _scales(srels)[0][2] % 4 == 0) else 1
        boxes, smem = _boxes(tile, srels, itemsize, vec)
        ntiles = tuple(_cdiv(n, t) for n, t in zip(last, tile))
        if math.prod(ntiles) >= 2 ** 31:
            raise ValueError(f"block {tuple(block_shape)} exceeds the grid")
        segs.append(EpilogueSegment(first, tuple(srels),
                                    tuple(dims[first:first + take + 1]),
                                    tile, ntiles, tuple(boxes), smem, vec))
        first += take
        if first >= len(rels):
            return segs


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
    B = int(fused.shape[0])
    dims = _level_dims(fused.shape[1:], rels)
    code, dtype, _imax = _out_spec(out_dtype)
    s0 = torch.empty(tuple(fused.shape), dtype=dtype, device=dev)
    levels = [torch.empty((B, *d), dtype=dtype, device=dev) for d in dims]
    itemsize = s0.element_size()
    aligned = (fused.data_ptr() % 16 == 0 and s0.data_ptr() % (4 * itemsize)
               == 0 and (not masks or wsum.data_ptr() % 16 == 0))
    lib = _cuda.load("epilogue")
    outs = [s0, *levels]
    for seg in epilogue_plan(fused.shape[1:], rels, itemsize, aligned):
        n = len(seg.rels)
        ints = lambda vals: (ctypes.c_int * max(1, len(vals)))(*vals)
        ptrs = (ctypes.c_void_p * (n + 1))(
            outs[0].data_ptr() if seg.first == 0 else None,
            *[t.data_ptr() for t in outs[seg.first + 1:seg.first + n + 1]])
        src = None if seg.first == 0 else outs[seg.first].data_ptr()
        ret = lib.bst_block_epilogue(
            fused.data_ptr() if seg.first == 0 else None,
            wsum.data_ptr() if masks and seg.first == 0 else None, src, B,
            *seg.dims[0], float(np.float32(min_i)), float(np.float32(max_i)),
            int(bool(masks)), code, n, ptrs,
            ints([f for r in seg.rels for f in r]), ints(seg.tile),
            ints([v for bx in seg.boxes for v in bx.steps]),
            ints([bx.smem_off for bx in seg.boxes]), seg.smem, seg.vec,
            _stream(dev))
        _cuda.check(lib, ret, "block_epilogue")
        block_epilogue.launches += 1
    return outs


block_epilogue.launches = 0


KERNEL_WRAPPERS = {"block_epilogue": block_epilogue}

