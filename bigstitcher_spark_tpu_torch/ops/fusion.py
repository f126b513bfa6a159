"""Affine-fusion device programs: six CUDA kernels and their plain-torch twins.

Port of ``bigstitcher_spark_tpu/ops/fusion.py``. Each JAX device program
of the fusion path is a hand-written CUDA kernel for ``sm_90a`` (sources in
``csrc/``, built at first launch by :mod:`._cuda`), and beside it a
plain-torch version of the same function:

========================  ===========================  ====================
wrapper                   kernel (csrc/)               JAX program
========================  ===========================  ====================
:func:`composite_fuse`    ``composite.cu`` (K1)        make_translation_composite
:func:`fuse_block_shift`  ``shift.cu`` (K2)            fuse_block_shift
:func:`fuse_block`        ``gather.cu`` (K3)           fuse_block
:func:`convert_intensity` ``convert.cu`` (K4)          convert_intensity
:func:`fuse_block_sep`    ``sep.cu`` (K5)              fuse_block_sep
:func:`fuse_volume_scan`  ``shift.cu`` (K27)           fuse_volume_scan
========================  ===========================  ====================

K2, K3 and K5 also have a batch form (:func:`fuse_block_shift_batch`,
:func:`fuse_block_batch`, :func:`fuse_block_sep_batch`): one launch fuses
every block of a batch of one bucket, as the JAX sharded fuser's vmap does
(``parallel/mesh.py:223``), each row bitwise the per-block launch's. Their
plain twins loop the per-block plain functions over the rows.

Launch plans are Python functions the CPU tests hold: K3 and K26 take
:func:`resample_plan` (a thread a run of RESAMPLE_R z outputs of one
column, a block a tile of one i); K2 takes :func:`shift_launch_plan`, the
same runs and tiles, with each view's window of patch rows staged in
shared memory by asynchronous copies before a block combines its views.

K1 and K3 also apply per-view intensity-correction grids (Cx, Cy, Cz, 2)
of [scale, offset] when given them (``so[0] * val + so[1]`` before the
blend, as the JAX programs do): K1 by separable interpolation rows over
each window (:func:`composite_coeff_tables`), K3 by a trilinear sample at
each voxel's grid coordinate (:func:`_trilinear_vec`).

A wrapper takes the plain version only because its tensors lie on the
CPU; on CUDA tensors it launches the kernel or raises. Each wrapper counts
its kernel launches in its ``launches`` attribute (an int), so a run can
show that it went through the kernels.

Arrays are indexed (x, y, z) with z contiguous, as in the JAX package.
Fusion types: AVG, AVG_BLEND, MAX_INTENSITY, FIRST_WINS (lowest view
wins), LAST_WINS (highest view wins).
"""

from __future__ import annotations

import ctypes
import math
from collections import namedtuple
from typing import Sequence

import numpy as np
import torch

from . import _cuda

FUSION_TYPES = ("AVG", "AVG_BLEND", "MAX_INTENSITY", "FIRST_WINS", "LAST_WINS")
_FT_CODE = {name: i for i, name in enumerate(FUSION_TYPES)}

# input element types the kernels read, and the storage types they write
_IN_CODE = {torch.uint8: 0, torch.uint16: 1, torch.int16: 2, torch.float32: 3}
_OUT = {  # name -> (kernel code, torch dtype, integer max or None)
    "uint8": (0, torch.uint8, 255.0),
    "uint16": (1, torch.uint16, 65535.0),
    "float32": (2, torch.float32, None),
}


def _out_spec(out_dtype: str):
    try:
        return _OUT[str(out_dtype)]
    except KeyError:
        raise ValueError(f"unsupported output dtype {out_dtype!r}") from None


def _ft_code(fusion_type: str) -> int:
    try:
        return _FT_CODE[fusion_type]
    except KeyError:
        raise ValueError(f"unknown fusion type {fusion_type}") from None


def _require(t: torch.Tensor, name: str, device: torch.device, dtypes,
             shape: tuple | None = None) -> None:
    """The kernels' input contract: device, dtype, shape, contiguity."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name} has dtype {t.dtype}, expected one of "
                         f"{sorted(str(d) for d in dtypes)}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream



_F32 = (torch.float32,)


# ---------------------------------------------------------------------------
# Shared plain-torch helpers
# ---------------------------------------------------------------------------


def _axis_blend_at(pos, dim, border, blend_range, inside_off=0.0):
    """1-D blend weight + inside mask at float positions ``pos``."""
    lo = border
    hi = dim - 1.0 - border
    d = torch.minimum(pos - lo, hi - pos)
    r = torch.clamp(torch.as_tensor(blend_range, dtype=torch.float32), min=1e-6)
    ramp = 0.5 * (torch.cos((1.0 - d / r) * math.pi) + 1.0)
    w = torch.where(d < 0, 0.0, torch.where(d < r, ramp, 1.0))
    inside = ((pos >= -inside_off) & (pos <= dim - 1.0 + inside_off)).to(
        torch.float32)
    return w, inside


def _outer3(v):
    return v[0][:, None, None] * v[1][None, :, None] * v[2][None, None, :]


def _combine_views(vals, insides, wblends, valid, fusion_type: str):
    """Combine per-view samples (V, ...) by fusion type -> (fused, wsum)."""
    extra = (1,) * (vals.dim() - 1)
    vmask = valid.reshape(valid.shape + extra)
    if fusion_type == "AVG":
        w = insides * vmask
    elif fusion_type == "AVG_BLEND":
        w = insides * wblends * vmask
    elif fusion_type == "MAX_INTENSITY":
        w = insides * vmask
        fused = torch.where(w > 0, vals, -torch.inf).amax(dim=0)
        wsum = w.sum(dim=0)
        return torch.where(wsum > 0, fused, 0.0), wsum
    elif fusion_type in ("FIRST_WINS", "LAST_WINS"):
        inside = insides * vmask
        V = vals.shape[0]
        order = torch.arange(V, dtype=torch.float32, device=vals.device)
        order = order.reshape((V,) + extra)
        if fusion_type == "FIRST_WINS":
            sel = torch.where(inside > 0, order, torch.inf).argmin(dim=0)
        else:
            sel = torch.where(inside > 0, order, -torch.inf).argmax(dim=0)
        fused = torch.take_along_dim(vals, sel[None], dim=0)[0]
        wsum = inside.sum(dim=0)
        return torch.where(wsum > 0, fused, 0.0), wsum
    else:
        raise ValueError(f"unknown fusion type {fusion_type}")
    wsum = w.sum(dim=0)
    acc = (vals * w).sum(dim=0)
    fused = torch.where(wsum > 0, acc / torch.clamp(wsum, min=1e-20), 0.0)
    return fused, wsum


def _separable_interp_matrix(pos, c: int):
    """(L, c) edge-clamped linear-interpolation matrix for 1-D coords ``pos``:
    row i holds (1-f) at floor(pos_i) and f at floor+1."""
    p = torch.clamp(pos, 0.0, float(c - 1))
    lo = torch.clamp(torch.floor(p), 0, max(c - 2, 0)).to(torch.int32)
    f = p - lo
    cols = torch.arange(c, dtype=torch.int32, device=pos.device)[None, :]
    return (torch.where(cols == lo[:, None], 1.0 - f[:, None], 0.0)
            + torch.where(cols == torch.clamp(lo + 1, max=c - 1)[:, None],
                          f[:, None], 0.0))


# ---------------------------------------------------------------------------
# K4: convert_intensity
# ---------------------------------------------------------------------------


def convert_intensity_plain(block: torch.Tensor, min_i: float, max_i: float,
                            out_dtype: str) -> torch.Tensor:
    """Map [min,max] onto the full uint8/uint16 range, round half to even,
    clip; float32 passes through (ops/fusion.py _convert_intensity_expr)."""
    _code, dtype, imax = _out_spec(out_dtype)
    if imax is None:
        return block.to(torch.float32)
    mn = torch.tensor(min_i, dtype=torch.float32, device=block.device)
    mx = torch.tensor(max_i, dtype=torch.float32, device=block.device)
    scaled = (block - mn) / (mx - mn) * imax
    return torch.clamp(torch.round(scaled), 0, imax).to(dtype)


def convert_intensity(block: torch.Tensor, min_i: float, max_i: float,
                      out_dtype: str) -> torch.Tensor:
    """K4 (``csrc/convert.cu``) on CUDA, the plain version on the CPU."""
    if block.device.type == "cpu":
        return convert_intensity_plain(block, min_i, max_i, out_dtype)
    _require(block, "block", block.device, _F32)
    code, dtype, _imax = _out_spec(out_dtype)
    out = torch.empty(block.shape, dtype=dtype, device=block.device)
    lib = _cuda.load("convert")
    ret = lib.bst_convert_intensity(
        block.data_ptr(), block.numel(), float(np.float32(min_i)),
        float(np.float32(max_i)), code, out.data_ptr(),
        _stream(block.device))
    _cuda.check(lib, ret, "convert_intensity")
    convert_intensity.launches += 1
    return out


convert_intensity.launches = 0


# ---------------------------------------------------------------------------
# K2: fuse_block_shift (translation views, per block)
# ---------------------------------------------------------------------------


def _block_axes(block_shape, device):
    """For the bx+by+bz entries of a per-block axis table: the axis of each
    entry and its float32 index along that axis, (1, bx+by+bz)."""
    bx, by, bz = (int(n) for n in block_shape)
    idx = torch.arange(bx + by + bz, device=device)
    ax = (idx >= bx).long() + (idx >= bx + by).long()
    step = (idx - torch.where(ax == 0, 0, torch.where(ax == 1, bx, bx + by))
            ).to(torch.float32)[None, :]
    return ax, step


def _block_tables(pos, ax, img_dims, borders, blend_ranges, inside_offs):
    # elementwise, so each entry gets the value a per-axis pass would
    w, ins = _axis_blend_at(pos, img_dims[:, ax], borders[:, ax],
                            blend_ranges[:, ax], inside_offs[:, ax])
    return torch.stack([w, ins], 1).contiguous()


def shift_axis_tables(lpos0, img_dims, borders, blend_ranges, inside_offs,
                      block_shape) -> torch.Tensor:
    """Per-view 1-D blend weights and inside masks of a translation block,
    (V, 2, bx+by+bz) float32: [v, 0] blend, [v, 1] inside, x then y then z
    (ops/fusion.py _axis_blend, evaluated at lpos0 + [0..n)). K2 and its
    plain twin both read this one tensor, so they weight views identically."""
    ax, step = _block_axes(block_shape, lpos0.device)
    return _block_tables(step + lpos0[:, ax], ax, img_dims, borders,
                         blend_ranges, inside_offs)


def _split3(t, lengths):
    a, b, _c = lengths
    return [t[:a], t[a:a + b], t[a + b:]]


def fuse_block_shift_plain(patches, fracs, lpos0, img_dims, borders,
                           blend_ranges, valid, block_shape,
                           fusion_type="AVG_BLEND", inside_offs=None):
    """Plain-torch ``fuse_block_shift``: per view, 8 shifted slices of the
    (bx+1, by+1, bz+1) patch with constant corner weights and a separable
    blend; then the per-type combine. Returns (fused, wsum) float32."""
    if inside_offs is None:
        inside_offs = torch.zeros_like(borders)
    tables = shift_axis_tables(lpos0, img_dims, borders, blend_ranges,
                               inside_offs, block_shape)
    return _fuse_block_shift_tables(patches, fracs, tables, valid,
                                    block_shape, fusion_type)


def _fuse_block_shift_tables(patches, fracs, tables, valid, block_shape,
                             fusion_type):
    patches = patches.to(torch.float32)
    bx, by, bz = block_shape
    vals, insides, blends = [], [], []
    for v in range(patches.shape[0]):
        P, f = patches[v], fracs[v]
        val = torch.zeros(block_shape, dtype=torch.float32,
                          device=patches.device)
        for cx in (0, 1):
            wxc = f[0] if cx else 1.0 - f[0]
            for cy in (0, 1):
                wyc = f[1] if cy else 1.0 - f[1]
                for cz in (0, 1):
                    wzc = f[2] if cz else 1.0 - f[2]
                    sl = P[cx:cx + bx, cy:cy + by, cz:cz + bz]
                    val = val + (wxc * wyc * wzc) * sl
        vals.append(val)
        blends.append(_outer3(_split3(tables[v, 0], block_shape)))
        insides.append(_outer3(_split3(tables[v, 1], block_shape)))
    return _combine_views(torch.stack(vals), torch.stack(insides),
                          torch.stack(blends), valid, fusion_type)


def _stack_rows(results):
    """[(fused, wsum), ...] of the rows of a batch -> (fused, wsum), each
    with a leading batch axis."""
    return (torch.stack([r[0] for r in results]),
            torch.stack([r[1] for r in results]))


def _zeros_if_none(inside_offs, like):
    return torch.zeros_like(like) if inside_offs is None else inside_offs


def _rows_of_one(*ts):
    """Per-block inputs as a batch of one (None stays None)."""
    return [None if t is None else t.unsqueeze(0) for t in ts]


def fuse_block_shift(patches, fracs, lpos0, img_dims, borders, blend_ranges,
                     valid, block_shape, fusion_type="AVG_BLEND",
                     inside_offs=None):
    """K2 (``csrc/shift.cu``) on CUDA, the plain version on the CPU.

    patches (V, bx+1, by+1, bz+1) uint8/uint16/int16/float32; fracs, lpos0,
    img_dims, borders, blend_ranges, inside_offs (V, 3) float32; valid (V,)
    float32. Returns (fused, wsum), both (bx, by, bz) float32. On CUDA it
    is :func:`fuse_block_shift_batch`'s launch on a batch of one (the
    launch: :func:`shift_launch_plan`)."""
    if patches.device.type == "cpu":
        return fuse_block_shift_plain(patches, fracs, lpos0, img_dims, borders,
                                      blend_ranges, valid, block_shape,
                                      fusion_type, inside_offs)
    bs = tuple(int(s) for s in block_shape)
    tables = _shift_batch_tables(*_rows_of_one(
        patches, fracs, lpos0, img_dims, borders, blend_ranges, valid,
        inside_offs), bs)
    return launch_fuse_block_shift(patches, fracs, tables, valid, bs,
                                   fusion_type)


def launch_fuse_block_shift(patches, fracs, tables, valid, block_shape,
                            fusion_type):
    """K2 alone, on inputs :func:`fuse_block_shift` has checked and on the
    weight tables it built (chip_smoke times this and the wrapper apart)."""
    fused, wsum = _launch_shift(*_rows_of_one(patches, fracs), tables,
                                valid.unsqueeze(0), block_shape, fusion_type)
    fuse_block_shift.launches += 1
    return fused[0], wsum[0]


fuse_block_shift.launches = 0


def fuse_block_shift_batch_plain(patches, fracs, lpos0, img_dims, borders,
                                 blend_ranges, valid, block_shape,
                                 fusion_type="AVG_BLEND", inside_offs=None):
    """Plain twin of K2's batch form: :func:`fuse_block_shift_plain` on each
    row."""
    io = _zeros_if_none(inside_offs, borders)
    return _stack_rows([fuse_block_shift_plain(
        patches[b], fracs[b], lpos0[b], img_dims[b], borders[b],
        blend_ranges[b], valid[b], block_shape, fusion_type, io[b])
        for b in range(patches.shape[0])])


def _shift_batch_tables(patches, fracs, lpos0, img_dims, borders,
                        blend_ranges, valid, inside_offs, block_shape):
    """Check K2's batch inputs and build each row's weight tables
    (elementwise per view, so a row's tables are the per-block ones)."""
    dev = patches.device
    B, V = (int(s) for s in patches.shape[:2])
    bx, by, bz = block_shape
    inside_offs = _zeros_if_none(inside_offs, borders)
    _require(patches, "patches", dev, _IN_CODE,
             (B, V, bx + 1, by + 1, bz + 1))
    for name, t in (("fracs", fracs), ("lpos0", lpos0), ("img_dims", img_dims),
                    ("borders", borders), ("blend_ranges", blend_ranges),
                    ("inside_offs", inside_offs)):
        _require(t, name, dev, _F32, (B, V, 3))
    _require(valid, "valid", dev, _F32, (B, V))
    return shift_axis_tables(
        *(t.reshape(B * V, 3) for t in (lpos0, img_dims, borders,
                                        blend_ranges, inside_offs)),
        block_shape)


def _launch_shift(patches, fracs, tables, valid, block_shape, fusion_type):
    """One launch of K2 on a checked batch (B, V, ...), as
    :func:`shift_launch_plan` lays it out (patches not 16-byte aligned are
    copied first: the windows are staged in aligned 16-byte pieces)."""
    bx, by, bz = block_shape
    dev = patches.device
    B, V = (int(s) for s in patches.shape[:2])
    fused = torch.empty((B, bx, by, bz), dtype=torch.float32, device=dev)
    wsum = torch.empty((B, bx, by, bz), dtype=torch.float32, device=dev)
    plan = shift_launch_plan(block_shape, V, B, patches.element_size())
    if patches.data_ptr() % 16:  # the windows are copied in aligned 16 bytes
        patches = patches.clone()
    lib = _cuda.load("shift")
    ret = lib.bst_fuse_block_shift_batch(
        patches.data_ptr(), _IN_CODE[patches.dtype], fracs.data_ptr(),
        tables.data_ptr(), valid.data_ptr(), B, V, bx, by, bz,
        _ft_code(fusion_type), plan.lanes_z, plan.n_jt, *plan.grid[:2],
        plan.nvs, plan.row_bytes, plan.smem, int(plan.idx64),
        fused.data_ptr(), wsum.data_ptr(), _stream(dev))
    _cuda.check(lib, ret, "fuse_block_shift")
    return fused, wsum


def fuse_block_shift_batch(patches, fracs, lpos0, img_dims, borders,
                           blend_ranges, valid, block_shape,
                           fusion_type="AVG_BLEND", inside_offs=None):
    """K2's batch form (``csrc/shift.cu``, one launch) on CUDA, the plain
    version on the CPU: :func:`fuse_block_shift` on each row of a batch of
    B blocks (the sharded route's vmap). patches (B, V, bx+1, by+1, bz+1);
    fracs, lpos0, img_dims, borders, blend_ranges, inside_offs (B, V, 3)
    float32; valid (B, V) float32. Returns (fused, wsum), both (B, bx, by,
    bz) float32, each row bitwise the per-block kernel's."""
    if patches.device.type == "cpu":
        return fuse_block_shift_batch_plain(
            patches, fracs, lpos0, img_dims, borders, blend_ranges, valid,
            block_shape, fusion_type, inside_offs)
    bs = tuple(int(s) for s in block_shape)
    tables = _shift_batch_tables(patches, fracs, lpos0, img_dims, borders,
                                 blend_ranges, valid, inside_offs, bs)
    out = _launch_shift(patches, fracs, tables, valid, bs, fusion_type)
    fuse_block_shift_batch.launches += 1
    return out


fuse_block_shift_batch.launches = 0


# ---------------------------------------------------------------------------
# K27: fuse_volume_scan (translation views from device-resident tiles)
# ---------------------------------------------------------------------------


class VolumeScanInputs:
    """The checked inputs of :func:`fuse_volume_scan` on one device: the
    tiles (V, tx, ty, tz); per (block, slot) the tile index (B, K) int32,
    the window ``clamp`` and ``delta`` (B, K, 3) int64 (``_one_view_device``:
    clamp = clip(floor_off, 0, tshape - ps), delta = floor_off - clamp mod
    ps), the fractions (B, K, 3), K2's weight tables (B, K, 2, bx+by+bz) and
    the valid flags (B, K); the block offsets (B, 3) int64, clipped into
    the volume as ``dynamic_update_slice`` clips them."""

    def __init__(self, tiles, view_idx, floor_offs, fracs, lpos0, img_dims,
                 borders, blend_ranges, valid, block_offsets, out_shape,
                 block_shape, inside_offs=None, device=None):
        from ..utils.device import resolve_device

        dev = (tiles.device if isinstance(tiles, torch.Tensor)
               else resolve_device(device))
        tiles = torch.as_tensor(tiles).to(dev)
        if tiles.dtype not in _IN_CODE:
            tiles = tiles.to(torch.float32)
        self.tiles = tiles.contiguous()
        self.block_shape = tuple(int(s) for s in block_shape)
        self.out_shape = tuple(int(s) for s in out_shape)
        if tiles.dim() != 4 or len(self.block_shape) != 3 \
                or len(self.out_shape) != 3:
            raise ValueError("tiles must be (V, tx, ty, tz); block_shape and "
                             "out_shape three ints")
        ps = [b + 1 for b in self.block_shape]
        tshape = [int(s) for s in tiles.shape[1:]]
        if any(t < p for t, p in zip(tshape, ps)) or any(
                o < b for o, b in zip(self.out_shape, self.block_shape)):
            raise ValueError(f"tiles {tuple(tshape)} must hold a patch {ps} "
                             f"and out_shape {self.out_shape} a block")
        i64 = lambda a: torch.as_tensor(a).to(device=dev, dtype=torch.int64)
        f32 = lambda a: torch.as_tensor(a).to(device=dev,
                                              dtype=torch.float32)
        vi = i64(view_idx)
        B, K = (int(s) for s in vi.shape)
        V = int(tiles.shape[0])
        if vi.numel() and (int(vi.min()) < 0 or int(vi.max()) >= V):
            raise ValueError(f"view_idx must index the {V} tiles")
        self.view_idx = vi.to(torch.int32).contiguous()
        fo = i64(floor_offs).reshape(B, K, 3)
        psv = torch.tensor(ps, dtype=torch.int64, device=dev)
        lim = torch.tensor(tshape, dtype=torch.int64, device=dev) - psv
        self.clamp = torch.minimum(torch.clamp(fo, min=0), lim)
        self.delta = torch.remainder(fo - self.clamp, psv)
        self.fracs = f32(fracs).reshape(B, K, 3).contiguous()
        rows = [f32(a).reshape(B * K, 3) for a in (
            lpos0, img_dims, borders, blend_ranges)]
        io = (torch.zeros_like(rows[2]) if inside_offs is None
              else f32(inside_offs).reshape(B * K, 3))
        self.tables = shift_axis_tables(*rows, io, self.block_shape).reshape(
            B, K, 2, sum(self.block_shape)).contiguous()
        self.valid = f32(valid).reshape(B, K).contiguous()
        top = torch.tensor([o - b for o, b in zip(self.out_shape,
                                                  self.block_shape)],
                           dtype=torch.int64, device=dev)
        self.block_offsets = torch.minimum(
            torch.clamp(i64(block_offsets).reshape(B, 3), min=0), top)
        self.device = dev


def _blocks_overlap(offsets: torch.Tensor, block_shape) -> bool:
    """Whether two of the (B, 3) block offsets place overlapping blocks."""
    size = torch.tensor(block_shape, device=offsets.device)
    B = int(offsets.shape[0])
    for i0 in range(0, B, 1024):
        rows = offsets[i0:i0 + 1024]
        hit = ((rows[:, None, :] - offsets[None]).abs() < size).all(-1)
        hit[torch.arange(len(rows)), torch.arange(i0, i0 + len(rows))] = False
        if bool(hit.any()):
            return True
    return False


def _realign(S: torch.Tensor, delta) -> torch.Tensor:
    """patch[i] = S[(i + delta) mod n] per axis (ops/fusion.py _realign;
    float32 input: torch rolls no uint16 on CUDA)."""
    for ax in range(3):
        S = torch.roll(S, -int(delta[ax]) % S.shape[ax], ax)
    return S


def _scan_convert(out, min_i, max_i, out_dtype, masks, convert):
    _code, dtype, imax = _out_spec(out_dtype)
    if masks:  # JAX's (out * imax).astype: a truncating cast
        return (out * (1.0 if imax is None else imax)).to(dtype)
    return convert(out, float(min_i), float(max_i), out_dtype)


def _volume_scan_plain(sc: VolumeScanInputs, fusion_type, masks):
    bx, by, bz = sc.block_shape
    ps = (bx + 1, by + 1, bz + 1)
    out = torch.zeros(sc.out_shape, dtype=torch.float32, device=sc.device)
    vi, cl, de, bo = (t.tolist() for t in (sc.view_idx, sc.clamp, sc.delta,
                                           sc.block_offsets))
    for b in range(len(vi)):  # the JAX scan's block order
        patches = torch.stack([_realign(sc.tiles[v][
            c[0]:c[0] + ps[0], c[1]:c[1] + ps[1], c[2]:c[2] + ps[2]].to(
                torch.float32), d) for v, c, d in zip(vi[b], cl[b], de[b])])
        fused, wsum = _fuse_block_shift_tables(
            patches, sc.fracs[b], sc.tables[b], sc.valid[b], sc.block_shape,
            fusion_type)
        x, y, z = bo[b]
        out[x:x + bx, y:y + by, z:z + bz] = (
            (wsum > 0).to(torch.float32) if masks else fused)
    return out


def fuse_volume_scan_plain(tiles, view_idx, floor_offs, fracs, lpos0,
                           img_dims, borders, blend_ranges, valid,
                           block_offsets, min_i, max_i, out_shape,
                           block_shape, fusion_type="AVG_BLEND",
                           out_dtype="float32", masks=False, inside_offs=None,
                           device=None):
    """K27's twin, the JAX ``fuse_volume_scan``: per block in order, each
    view's (bx+1, by+1, bz+1) window sliced from its tile at the clamped
    floor offset and rolled by ``delta`` (wrapped voxels are weighed 0 by
    the inside test), K2's plain math, the result (or ``wsum > 0`` with
    ``masks``) written at the block's offset; then the plain conversion
    (or ``(out * imax).astype`` with ``masks``). Blocks written later win
    where they overlap."""
    sc = VolumeScanInputs(tiles, view_idx, floor_offs, fracs, lpos0,
                          img_dims, borders, blend_ranges, valid,
                          block_offsets, out_shape, block_shape, inside_offs,
                          device)
    return _scan_convert(_volume_scan_plain(sc, fusion_type, masks), min_i,
                         max_i, out_dtype, masks, convert_intensity_plain)


def fuse_volume_scan(tiles, view_idx, floor_offs, fracs, lpos0, img_dims,
                     borders, blend_ranges, valid, block_offsets, min_i,
                     max_i, out_shape, block_shape, fusion_type="AVG_BLEND",
                     out_dtype="float32", masks=False, inside_offs=None,
                     device=None):
    """K27 (``csrc/shift.cu``) then K4 on CUDA, the twin on the CPU: the
    JAX ``fuse_volume_scan``, whole-volume translation fusion from
    resident tiles.

    tiles (V, tx, ty, tz) uint8/uint16/int16/float32 (a tensor stays on
    its device; an array goes to ``device``, ``cuda`` unless asked
    otherwise); view_idx (B, K) into tiles; floor_offs (B, K, 3) int;
    fracs, lpos0, img_dims, borders, blend_ranges, inside_offs (B, K, 3)
    float32; valid (B, K) float32; block_offsets (B, 3) into the volume
    ``out_shape`` (padded to whole blocks of ``block_shape``). Returns the
    volume in ``out_dtype``. Unlike the JAX scan, K27 fuses every block at
    once: overlapping blocks (after clipping into the volume) raise."""
    sc = VolumeScanInputs(tiles, view_idx, floor_offs, fracs, lpos0,
                          img_dims, borders, blend_ranges, valid,
                          block_offsets, out_shape, block_shape, inside_offs,
                          device)
    if _blocks_overlap(sc.block_offsets, sc.block_shape):
        raise ValueError("fuse_volume_scan fuses every block at once: the "
                         "blocks must not overlap (fuse_volume_scan_plain "
                         "keeps the JAX scan's last-block-wins)")
    if sc.device.type == "cpu":
        out = _volume_scan_plain(sc, fusion_type, masks)
    else:
        out = launch_fuse_volume_scan(sc, fusion_type, masks)
    return _scan_convert(out, min_i, max_i, out_dtype, masks,
                         convert_intensity)


def launch_fuse_volume_scan(sc: VolumeScanInputs, fusion_type="AVG_BLEND",
                            masks=False) -> torch.Tensor:
    """K27 alone on checked inputs: the float32 volume (fused, or 1 where
    wsum > 0 with ``masks``; 0 where no block writes)."""
    out = torch.zeros(sc.out_shape, dtype=torch.float32, device=sc.device)
    B, K = (int(s) for s in sc.view_idx.shape)
    if B == 0 or K == 0:
        return out
    starts = torch.cat([sc.clamp, sc.delta], 2).to(torch.int32).contiguous()
    offs = sc.block_offsets.to(torch.int32).contiguous()
    _V, tx, ty, tz = (int(s) for s in sc.tiles.shape)
    bx, by, bz = sc.block_shape
    lib = _cuda.load("shift")
    ret = lib.bst_fuse_volume_scan(
        sc.tiles.data_ptr(), _IN_CODE[sc.tiles.dtype], tx, ty, tz,
        sc.view_idx.data_ptr(), starts.data_ptr(), sc.fracs.data_ptr(),
        sc.tables.data_ptr(), sc.valid.data_ptr(), offs.data_ptr(), B, K,
        bx, by, bz, sc.out_shape[1], sc.out_shape[2], _ft_code(fusion_type),
        int(bool(masks)), out.data_ptr(), _stream(sc.device))
    _cuda.check(lib, ret, "fuse_volume_scan")
    fuse_volume_scan.launches += 1
    return out


fuse_volume_scan.launches = 0


# ---------------------------------------------------------------------------
# K3: fuse_block (general affine gather, per block)
# ---------------------------------------------------------------------------


def block_coords(block_shape: Sequence[int], device=None) -> torch.Tensor:
    """(N,3) float32 local voxel indices of a block, N = prod(shape)."""
    axes = [torch.arange(int(n), dtype=torch.float32, device=device)
            for n in block_shape]
    g = torch.meshgrid(*axes, indexing="ij")
    return torch.stack([a.reshape(-1) for a in g], dim=-1)


def _trilinear_sample(patch: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Sample one (Px,Py,Pz) patch at (N,3) float coords; clamped at edges."""
    px, py, pz = patch.shape
    p0 = torch.floor(pts)
    f = pts - p0
    p0 = p0.to(torch.int64)
    x0 = torch.clamp(p0[:, 0], 0, px - 1)
    y0 = torch.clamp(p0[:, 1], 0, py - 1)
    z0 = torch.clamp(p0[:, 2], 0, pz - 1)
    x1 = torch.clamp(p0[:, 0] + 1, 0, px - 1)
    y1 = torch.clamp(p0[:, 1] + 1, 0, py - 1)
    z1 = torch.clamp(p0[:, 2] + 1, 0, pz - 1)
    flat = patch.reshape(-1)
    syz = py * pz

    def g(xi, yi, zi):
        return flat[xi * syz + yi * pz + zi]

    fx, fy, fz = f[:, 0], f[:, 1], f[:, 2]
    c000 = g(x0, y0, z0) * (1 - fx) * (1 - fy) * (1 - fz)
    c100 = g(x1, y0, z0) * fx * (1 - fy) * (1 - fz)
    c010 = g(x0, y1, z0) * (1 - fx) * fy * (1 - fz)
    c110 = g(x1, y1, z0) * fx * fy * (1 - fz)
    c001 = g(x0, y0, z1) * (1 - fx) * (1 - fy) * fz
    c101 = g(x1, y0, z1) * fx * (1 - fy) * fz
    c011 = g(x0, y1, z1) * (1 - fx) * fy * fz
    c111 = g(x1, y1, z1) * fx * fy * fz
    return c000 + c100 + c010 + c110 + c001 + c101 + c011 + c111


def _trilinear_vec(grid: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Sample a vector-valued grid (Gx, Gy, Gz, C) at (N, 3) float grid
    coordinates: floor and fraction, both corner indices clipped to the
    grid (ops/nonrigid.py _trilinear_vec). Returns (N, C)."""
    gx, gy, gz, C = grid.shape
    p0 = torch.floor(pts)
    f = pts - p0
    p0 = p0.to(torch.int64)
    x0 = torch.clamp(p0[:, 0], 0, gx - 1)
    y0 = torch.clamp(p0[:, 1], 0, gy - 1)
    z0 = torch.clamp(p0[:, 2], 0, gz - 1)
    x1 = torch.clamp(p0[:, 0] + 1, 0, gx - 1)
    y1 = torch.clamp(p0[:, 1] + 1, 0, gy - 1)
    z1 = torch.clamp(p0[:, 2] + 1, 0, gz - 1)
    flat = grid.reshape(-1, C)
    syz = gy * gz

    def g(xi, yi, zi):
        return flat[xi * syz + yi * gz + zi]

    fx, fy, fz = f[:, 0:1], f[:, 1:2], f[:, 2:3]
    return (g(x0, y0, z0) * (1 - fx) * (1 - fy) * (1 - fz)
            + g(x1, y0, z0) * fx * (1 - fy) * (1 - fz)
            + g(x0, y1, z0) * (1 - fx) * fy * (1 - fz)
            + g(x1, y1, z0) * fx * fy * (1 - fz)
            + g(x0, y0, z1) * (1 - fx) * (1 - fy) * fz
            + g(x1, y0, z1) * fx * (1 - fy) * fz
            + g(x0, y1, z1) * (1 - fx) * fy * fz
            + g(x1, y1, z1) * fx * fy * fz)


def _apply3(x, y, z, A):
    """((x A[:, 0] + y A[:, 1]) + z A[:, 2]) + A[:, 3], one rounding per op
    in the kernels' order (a matmul on the card may fuse and reorder)."""
    return ((x * A[:, 0] + y * A[:, 1]) + z * A[:, 2]) + A[:, 3]


def fuse_block_plain(patches, affines, patch_offsets, img_dims, borders,
                     blend_ranges, valid, block_shape, fusion_type="AVG_BLEND",
                     inside_offs=None, coeffs=None, coeff_affines=None):
    """Plain-torch ``fuse_block``: per view, map block coords through the
    block->patch affine, sample trilinearly (edge-clamped), apply the
    view's intensity grid if ``coeffs`` (sampled at ``coeff_affines`` @
    level position), weight by the inside test and blend; then the
    per-type combine."""
    patches = patches.to(torch.float32)
    if inside_offs is None:
        inside_offs = torch.zeros_like(borders)
    coords = block_coords(block_shape, patches.device)
    vals, insides, blends = [], [], []
    x, y, z = coords[:, 0:1], coords[:, 1:2], coords[:, 2:3]
    for v in range(patches.shape[0]):
        A = affines[v]
        # coords @ A[:, :3].T + A[:, 3]: one ulp of sample position is a
        # visible step on a steep image
        p = _apply3(x, y, z, A)
        val = _trilinear_sample(patches[v], p)
        lpos = p + patch_offsets[v]
        if coeffs is not None:
            g = _apply3(lpos[:, 0:1], lpos[:, 1:2], lpos[:, 2:3],
                        coeff_affines[v])
            so = _trilinear_vec(coeffs[v], g)
            val = so[:, 0] * val + so[:, 1]
        vals.append(val)
        # cosine border ramp and inside test per axis at the level coords,
        # product over axes (ops/fusion.py _blend_weight)
        w, ins = _axis_blend_at(lpos, img_dims[v], borders[v],
                                blend_ranges[v], inside_offs[v])
        insides.append(ins[:, 0] * ins[:, 1] * ins[:, 2])
        blends.append(w[:, 0] * w[:, 1] * w[:, 2])
    fused, wsum = _combine_views(torch.stack(vals), torch.stack(insides),
                                 torch.stack(blends), valid, fusion_type)
    return fused.reshape(tuple(block_shape)), wsum.reshape(tuple(block_shape))


# K3's and K26's launch (csrc/fusion_common.cuh): a thread owns RESAMPLE_R
# z outputs of one (i, j) column, consecutive in K3, lanes_z apart in K26;
# a block of RESAMPLE_THREADS threads a tile of one i, tile_j columns along
# j and tile_z outputs along z; the views' parameters are staged in shared
# memory RESAMPLE_VIEW_CHUNK at a time; K26's tables of the columns'
# x-y-lerped vertex models hold NONRIGID_TABLE_F4 float4 (3 a column and
# vertex, and one of padding a column), its x-lerped rows NONRIGID_ROWS_F4
# (3 a y and z vertex of the tile), for as many views at once as fit.
RESAMPLE_R = 4
RESAMPLE_THREADS = 256
RESAMPLE_VIEW_CHUNK = 8
NONRIGID_TABLE_F4 = 2048
NONRIGID_ROWS_F4 = 512
ResamplePlan = namedtuple(
    "ResamplePlan", "lanes_z tile n_jt grid view_chunks idx64 table_vertices")


def _cdiv(a: int, b: int) -> int:
    return -(-int(a) // int(b))


def _lanes_z(bz: int) -> int:
    """Threads sharing a column of ``bz`` outputs: the power of two at or
    above its runs of RESAMPLE_R, at most 32 (K2, K3, K26)."""
    return min(32, 1 << (_cdiv(bz, RESAMPLE_R) - 1).bit_length())


def resample_plan(block_shape, V: int, patch_shape) -> ResamplePlan:
    """K3's and K26's launch for a block of ``block_shape`` outputs from V
    views of ``patch_shape`` patches: ``lanes_z`` threads (the power of two
    at or above the block's runs of RESAMPLE_R z outputs, at most 32) share
    a column's z range; a block's ``tile`` (1, tile_j, tile_z) =
    (1, RESAMPLE_THREADS / lanes_z, RESAMPLE_R lanes_z); ``n_jt`` column
    tiles along j; ``grid`` (bx n_jt, z tiles); ``view_chunks`` the shared
    memory stagings of the views; ``idx64`` a patch of 2^31 elements or
    more (then 64-bit patch indices); ``table_vertices`` the z vertices
    K26's table holds a column for one view (a tile reaching more takes
    the per-voxel lerps)."""
    bx, by, bz = (int(s) for s in block_shape)
    if min(bx, by, bz) <= 0 or int(V) <= 0:
        raise ValueError(f"empty resample: block {tuple(block_shape)}, V {V}")
    lanes_z = _lanes_z(bz)
    tile_j = RESAMPLE_THREADS // lanes_z
    tile_z = RESAMPLE_R * lanes_z
    n_jt = _cdiv(by, tile_j)
    grid = (bx * n_jt, _cdiv(bz, tile_z))
    if grid[0] >= 2 ** 31 or grid[1] > 65535:
        raise ValueError(f"block {tuple(block_shape)} exceeds the launch grid")
    idx64 = math.prod(int(s) for s in patch_shape) >= 2 ** 31
    return ResamplePlan(lanes_z, (1, tile_j, tile_z), n_jt, grid,
                        _cdiv(V, RESAMPLE_VIEW_CHUNK), idx64,
                        (NONRIGID_TABLE_F4 // tile_j - 1) // 3)


# K2's launch (csrc/shift.cu): SHIFT_THREADS threads a block; a block's
# staged views take at most SHIFT_SMEM bytes of dynamic shared memory (a
# block may take 48 KB without opting in, less its static weights).
SHIFT_THREADS = 256
SHIFT_SMEM = 48 * 1024 - 1024
ShiftPlan = namedtuple(
    "ShiftPlan", "lanes_z tile n_jt grid nvs row_bytes smem idx64")


def shift_launch_plan(block_shape, V: int, B: int = 1,
                      itemsize: int = 2) -> ShiftPlan:
    """K2's launch for B rows of a block of ``block_shape`` outputs from V
    views of (bx+1, by+1, bz+1) patches of ``itemsize``-byte values: a
    thread owns RESAMPLE_R consecutive z outputs of one column, ``lanes_z``
    threads a column (:func:`resample_plan`'s), a block of SHIFT_THREADS
    threads a ``tile`` of one i, tile_j columns and tile_z outputs along
    z; ``grid`` (bx n_jt, z tiles, B), the batch row in the third index.
    A block stages ``nvs`` views at a time in ``smem`` bytes of shared
    memory: each view's window, 2 planes of tile_j + 1 rows of the tile_z
    + 1 values from z0, copied in 16-byte pieces from the z0 value's
    aligned-down address (``row_bytes`` a row), and its column products
    and z tables. ``idx64``: a patch of 2^31 elements or more (then 64-bit
    patch indices, the fusion type read at run time)."""
    bx, by, bz = (int(s) for s in block_shape)
    if min(bx, by, bz) <= 0 or int(V) <= 0:
        raise ValueError(f"empty fusion: block {tuple(block_shape)}, V {V}")
    if not 1 <= int(B) <= 65535:
        raise ValueError(f"K2 takes 1 to 65535 batch rows, got {B}")
    lanes_z = _lanes_z(bz)
    tile_j = SHIFT_THREADS // lanes_z
    tile_z = RESAMPLE_R * lanes_z
    n_jt = _cdiv(by, tile_j)
    grid = (bx * n_jt, _cdiv(bz, tile_z), int(B))
    if grid[0] >= 2 ** 31 or grid[1] > 65535:
        raise ValueError(f"block {tuple(block_shape)} exceeds the launch grid")
    row_bytes = _cdiv(16 - int(itemsize) + (tile_z + 1) * int(itemsize),
                      16) * 16
    per_view = 2 * (tile_j + 1) * row_bytes + 8 * tile_j + 8 * tile_z
    nvs = min(RESAMPLE_VIEW_CHUNK, int(V), SHIFT_SMEM // per_view)
    idx64 = (bx + 1) * (by + 1) * (bz + 1) >= 2 ** 31
    return ShiftPlan(lanes_z, (1, tile_j, tile_z), n_jt, grid, nvs, row_bytes,
                     nvs * per_view, idx64)


# K5's launch (csrc/sep.cu): SEP_THREADS threads a block, SEP_R z outputs
# a thread; a block's tabulated views take at most SEP_SMEM bytes of
# dynamic shared memory. Per view of a stage: its x tap (16 bytes), each
# column's y weights and x-y products (16) and 4 patch-row offsets (4 or,
# generic, 8 bytes each), each k's z tap and z tables (16).
SEP_THREADS = 256
SEP_R = 4
SEP_SMEM = 48 * 1024 - 1024
SepPlan = namedtuple("SepPlan", "lanes_z tile n_jt grid nvs smem generic")


def sep_launch_plan(block_shape, V: int, B: int = 1,
                    patch_shape=(2, 2, 2)) -> SepPlan:
    """K5's launch for B rows of a block of ``block_shape`` outputs from V
    views of ``patch_shape`` patches: a thread owns SEP_R z outputs of one
    column, interleaved (k = z0 + lz + lanes_z r), ``lanes_z`` threads a
    column (:func:`resample_plan`'s), a block of SEP_THREADS threads a
    ``tile`` of one i, tile_j columns and tile_z outputs along z; ``grid``
    (bx n_jt, z tiles, B), the batch row in the third index. A block
    tabulates ``nvs`` views' taps at a time in ``smem`` bytes of shared
    memory. ``generic``: patches of 2^31 elements or more, or a z extent
    of 1 (then 64-bit patch indices, hi_z = min(lo_z + 1, pz - 1) and the
    fusion type read at run time)."""
    bx, by, bz = (int(s) for s in block_shape)
    if min(bx, by, bz) <= 0 or int(V) <= 0 or min(patch_shape) <= 0:
        raise ValueError(f"empty fusion: block {tuple(block_shape)}, V {V}, "
                         f"patch {tuple(patch_shape)}")
    if not 1 <= int(B) <= 65535:
        raise ValueError(f"K5 takes 1 to 65535 batch rows, got {B}")
    lanes_z = _lanes_z(bz)
    tile_j = SEP_THREADS // lanes_z
    tile_z = SEP_R * lanes_z
    n_jt = _cdiv(by, tile_j)
    grid = (bx * n_jt, _cdiv(bz, tile_z), int(B))
    if grid[0] >= 2 ** 31 or grid[1] > 65535:
        raise ValueError(f"block {tuple(block_shape)} exceeds the launch grid")
    generic = (math.prod(int(s) for s in patch_shape) >= 2 ** 31
               or int(patch_shape[2]) < 2)
    per_view = 16 + tile_j * (16 + 4 * (8 if generic else 4)) + 16 * tile_z
    nvs = min(RESAMPLE_VIEW_CHUNK, int(V), SEP_SMEM // per_view)
    return SepPlan(lanes_z, (1, tile_j, tile_z), n_jt, grid, nvs,
                   nvs * per_view, generic)


def fuse_block(patches, affines, patch_offsets, img_dims, borders,
               blend_ranges, valid, block_shape, fusion_type="AVG_BLEND",
               inside_offs=None, coeffs=None, coeff_affines=None):
    """K3 (``csrc/gather.cu``) on CUDA, the plain version on the CPU.

    patches (V, Px, Py, Pz) uint8/uint16/int16/float32; affines (V, 3, 4)
    float32 (block index -> patch coords); patch_offsets, img_dims, borders,
    blend_ranges, inside_offs (V, 3) float32; valid (V,) float32; optional
    intensity grids ``coeffs`` (V, Cx, Cy, Cz, 2) float32 and their (V, 3,
    4) float32 level position -> grid coordinate affines. Returns (fused,
    wsum), both ``block_shape`` float32. The launch: :func:`resample_plan`;
    on CUDA it is :func:`fuse_block_batch`'s on a batch of one."""
    if (coeffs is None) != (coeff_affines is None):
        raise ValueError("coeffs and coeff_affines go together")
    if patches.device.type == "cpu":
        return fuse_block_plain(patches, affines, patch_offsets, img_dims,
                                borders, blend_ranges, valid, block_shape,
                                fusion_type, inside_offs, coeffs,
                                coeff_affines)
    if patches.dim() != 4:
        raise ValueError("patches must be (V, Px, Py, Pz)")
    fused, wsum = _launch_gather(*_rows_of_one(
        patches, affines, patch_offsets, img_dims, borders, blend_ranges,
        valid), block_shape, fusion_type, *_rows_of_one(
            inside_offs, coeffs, coeff_affines))
    fuse_block.launches += 1
    fuse_block.coeff_launches += coeffs is not None
    return fused[0], wsum[0]


fuse_block.launches = 0
fuse_block.coeff_launches = 0


def fuse_block_batch_plain(patches, affines, patch_offsets, img_dims, borders,
                           blend_ranges, valid, block_shape,
                           fusion_type="AVG_BLEND", inside_offs=None,
                           coeffs=None, coeff_affines=None):
    """Plain twin of K3's batch form: :func:`fuse_block_plain` on each
    row."""
    io = _zeros_if_none(inside_offs, borders)
    return _stack_rows([fuse_block_plain(
        patches[b], affines[b], patch_offsets[b], img_dims[b], borders[b],
        blend_ranges[b], valid[b], block_shape, fusion_type, io[b],
        None if coeffs is None else coeffs[b],
        None if coeff_affines is None else coeff_affines[b])
        for b in range(patches.shape[0])])


def _launch_gather(patches, affines, patch_offsets, img_dims, borders,
                   blend_ranges, valid, block_shape, fusion_type, inside_offs,
                   coeffs, coeff_affines):
    """Check K3's batch inputs (B, V, ...) and launch it once."""
    dev = patches.device
    if patches.dim() != 5:
        raise ValueError("patches must be (B, V, Px, Py, Pz)")
    B, V, px, py, pz = (int(s) for s in patches.shape)
    bx, by, bz = (int(s) for s in block_shape)
    inside_offs = _zeros_if_none(inside_offs, borders)
    _require(patches, "patches", dev, _IN_CODE)
    _require(affines, "affines", dev, _F32, (B, V, 3, 4))
    for name, t in (("patch_offsets", patch_offsets), ("img_dims", img_dims),
                    ("borders", borders), ("blend_ranges", blend_ranges),
                    ("inside_offs", inside_offs)):
        _require(t, name, dev, _F32, (B, V, 3))
    _require(valid, "valid", dev, _F32, (B, V))
    cdims, cptr, captr = (0, 0, 0), None, None
    if coeffs is not None:
        _require(coeffs, "coeffs", dev, _F32)
        if (coeffs.dim() != 6 or tuple(coeffs.shape[:2]) != (B, V)
                or coeffs.shape[5] != 2):
            raise ValueError(f"coeffs has shape {tuple(coeffs.shape)}, "
                             f"expected ({B}, {V}, Cx, Cy, Cz, 2)")
        _require(coeff_affines, "coeff_affines", dev, _F32, (B, V, 3, 4))
        cdims = tuple(int(c) for c in coeffs.shape[2:5])
        cptr, captr = coeffs.data_ptr(), coeff_affines.data_ptr()
    plan = resample_plan((bx, by, bz), V, (px, py, pz))
    fused = torch.empty((B, bx, by, bz), dtype=torch.float32, device=dev)
    wsum = torch.empty((B, bx, by, bz), dtype=torch.float32, device=dev)
    lib = _cuda.load("gather")
    ret = lib.bst_fuse_block_batch(
        patches.data_ptr(), _IN_CODE[patches.dtype], px, py, pz,
        affines.data_ptr(), patch_offsets.data_ptr(), img_dims.data_ptr(),
        borders.data_ptr(), blend_ranges.data_ptr(), valid.data_ptr(),
        inside_offs.data_ptr(), B, V, bx, by, bz, _ft_code(fusion_type),
        cptr, captr, *cdims, plan.lanes_z, plan.n_jt, *plan.grid,
        int(plan.idx64), fused.data_ptr(), wsum.data_ptr(), _stream(dev))
    _cuda.check(lib, ret, "fuse_block")
    return fused, wsum


def fuse_block_batch(patches, affines, patch_offsets, img_dims, borders,
                     blend_ranges, valid, block_shape, fusion_type="AVG_BLEND",
                     inside_offs=None, coeffs=None, coeff_affines=None):
    """K3's batch form (``csrc/gather.cu``, one launch) on CUDA, the plain
    version on the CPU: :func:`fuse_block` on each row of a batch of B
    blocks that share the patch shape and view count (a bucket of the
    sharded route). patches (B, V, Px, Py, Pz); affines (B, V, 3, 4);
    patch_offsets, img_dims, borders, blend_ranges, inside_offs (B, V, 3);
    valid (B, V); optional coeffs (B, V, Cx, Cy, Cz, 2) and coeff_affines
    (B, V, 3, 4); all float32 but the patches. Returns (fused, wsum), both
    (B, bx, by, bz) float32, each row bitwise the per-block kernel's (the
    same launch plan, :func:`resample_plan`)."""
    if (coeffs is None) != (coeff_affines is None):
        raise ValueError("coeffs and coeff_affines go together")
    if patches.device.type == "cpu":
        return fuse_block_batch_plain(
            patches, affines, patch_offsets, img_dims, borders, blend_ranges,
            valid, block_shape, fusion_type, inside_offs, coeffs,
            coeff_affines)
    out = _launch_gather(patches, affines, patch_offsets, img_dims, borders,
                         blend_ranges, valid, block_shape, fusion_type,
                         inside_offs, coeffs, coeff_affines)
    fuse_block_batch.launches += 1
    fuse_block_batch.coeff_launches += coeffs is not None
    return out


fuse_block_batch.launches = 0
fuse_block_batch.coeff_launches = 0


# ---------------------------------------------------------------------------
# K5: fuse_block_sep (diagonal block->patch affines, per block)
# ---------------------------------------------------------------------------


def sep_axis_tables(diags, ts, patch_offsets, img_dims, borders, blend_ranges,
                    inside_offs, block_shape) -> torch.Tensor:
    """Per-view 1-D blend weights and inside masks of a diagonal-affine
    block, (V, 2, bx+by+bz) float32 in :func:`shift_axis_tables`' layout,
    evaluated at the level position ``(diag * i + t) + patch_offset`` of each
    index i (ops/fusion.py _one_view_sep; ``diag * i + t`` rounded once, see
    :func:`_fma`). K5 and its plain twin both read this one tensor."""
    ax, step = _block_axes(block_shape, diags.device)
    pos = _fma(diags[:, ax], step, ts[:, ax]) + patch_offsets[:, ax]
    return _block_tables(pos, ax, img_dims, borders, blend_ranges, inside_offs)


def _fma(a, b, c) -> torch.Tensor:
    """``a * b + c`` of float32 operands rounded once to float32: one fused
    multiply-add, as K5's ``fmaf`` and XLA's contraction of the JAX
    expression ``diag * i + t`` round it (evaluated in float64, where the
    product of a float32 and a block index and its sum with a float32 are
    exact)."""
    return (a.double() * b.double() + c.double()).to(torch.float32)


def _interp_taps(pos, c: int):
    """The two taps and weight of each row of _separable_interp_matrix over
    an extent ``c``, as K5's interp_row computes them: (lo, hi, f)."""
    p = torch.clamp(pos, 0.0, float(c - 1))
    lo = torch.clamp(torch.floor(p), 0, max(c - 2, 0))
    f = p - lo
    lo = lo.to(torch.int64)
    return lo, torch.clamp(lo + 1, max=c - 1), f


def fuse_block_sep_plain(patches, diags, ts, patch_offsets, img_dims, borders,
                         blend_ranges, valid, block_shape,
                         fusion_type="AVG_BLEND", inside_offs=None):
    """Plain-torch ``fuse_block_sep``: per view, linear interpolation along
    x, then y, then z at ``diag * i + t`` (one rounding, see
    :func:`_fma`; edge-clamped taps of
    _separable_interp_matrix, evaluated elementwise in K5's order, not as
    a matmul, which the card would reorder), the separable blend; then the
    per-type combine. Returns (fused, wsum) float32 of ``block_shape``."""
    if inside_offs is None:
        inside_offs = torch.zeros_like(borders)
    block_shape = tuple(int(s) for s in block_shape)
    tables = sep_axis_tables(diags, ts, patch_offsets, img_dims, borders,
                             blend_ranges, inside_offs, block_shape)
    patches = patches.to(torch.float32)
    vals, insides, blends = [], [], []
    for v in range(patches.shape[0]):
        so = patches[v]
        for d in range(3):
            i = torch.arange(block_shape[d], device=patches.device)
            lo, hi, f = _interp_taps(_fma(diags[v, d], i, ts[v, d]),
                                     so.shape[d])
            shape = [1, 1, 1]
            shape[d] = -1
            f = f.reshape(shape)
            so = (so.index_select(d, lo) * (1.0 - f)
                  + so.index_select(d, hi) * f)
        vals.append(so)
        blends.append(_outer3(_split3(tables[v, 0], block_shape)))
        insides.append(_outer3(_split3(tables[v, 1], block_shape)))
    return _combine_views(torch.stack(vals), torch.stack(insides),
                          torch.stack(blends), valid, fusion_type)


def fuse_block_sep(patches, diags, ts, patch_offsets, img_dims, borders,
                   blend_ranges, valid, block_shape, fusion_type="AVG_BLEND",
                   inside_offs=None):
    """K5 (``csrc/sep.cu``) on CUDA, the plain version on the CPU.

    patches (V, Px, Py, Pz) uint8/uint16/int16/float32; diags, ts (the
    diagonal and translation of each block->patch affine), patch_offsets,
    img_dims, borders, blend_ranges, inside_offs (V, 3) float32; valid (V,)
    float32. Returns (fused, wsum), both ``block_shape`` float32. On CUDA
    it is :func:`fuse_block_sep_batch`'s launch on a batch of one."""
    if patches.device.type == "cpu":
        return fuse_block_sep_plain(patches, diags, ts, patch_offsets,
                                    img_dims, borders, blend_ranges, valid,
                                    block_shape, fusion_type, inside_offs)
    if patches.dim() != 4:
        raise ValueError("patches must be (V, Px, Py, Pz)")
    bs = tuple(int(s) for s in block_shape)
    tables = _sep_batch_tables(*_rows_of_one(
        patches, diags, ts, patch_offsets, img_dims, borders, blend_ranges,
        valid, inside_offs), bs)
    return launch_fuse_block_sep(patches, diags, ts, tables, valid, bs,
                                 fusion_type)


def launch_fuse_block_sep(patches, diags, ts, tables, valid, block_shape,
                          fusion_type):
    """K5 alone, on inputs :func:`fuse_block_sep` has checked and on the
    weight tables it built (chip_smoke times this and the wrapper apart)."""
    fused, wsum = _launch_sep(*_rows_of_one(patches, diags, ts), tables,
                              valid.unsqueeze(0), block_shape, fusion_type)
    fuse_block_sep.launches += 1
    return fused[0], wsum[0]


fuse_block_sep.launches = 0


def fuse_block_sep_batch_plain(patches, diags, ts, patch_offsets, img_dims,
                               borders, blend_ranges, valid, block_shape,
                               fusion_type="AVG_BLEND", inside_offs=None):
    """Plain twin of K5's batch form: :func:`fuse_block_sep_plain` on each
    row."""
    io = _zeros_if_none(inside_offs, borders)
    return _stack_rows([fuse_block_sep_plain(
        patches[b], diags[b], ts[b], patch_offsets[b], img_dims[b],
        borders[b], blend_ranges[b], valid[b], block_shape, fusion_type,
        io[b]) for b in range(patches.shape[0])])


def _sep_batch_tables(patches, diags, ts, patch_offsets, img_dims, borders,
                      blend_ranges, valid, inside_offs, block_shape):
    """Check K5's batch inputs and build each row's weight tables."""
    dev = patches.device
    if patches.dim() != 5:
        raise ValueError("patches must be (B, V, Px, Py, Pz)")
    B, V = (int(s) for s in patches.shape[:2])
    inside_offs = _zeros_if_none(inside_offs, borders)
    _require(patches, "patches", dev, _IN_CODE)
    for name, t in (("diags", diags), ("ts", ts),
                    ("patch_offsets", patch_offsets), ("img_dims", img_dims),
                    ("borders", borders), ("blend_ranges", blend_ranges),
                    ("inside_offs", inside_offs)):
        _require(t, name, dev, _F32, (B, V, 3))
    _require(valid, "valid", dev, _F32, (B, V))
    return sep_axis_tables(
        *(t.reshape(B * V, 3) for t in (diags, ts, patch_offsets, img_dims,
                                        borders, blend_ranges, inside_offs)),
        block_shape)


def _launch_sep(patches, diags, ts, tables, valid, block_shape, fusion_type):
    """One launch of K5 on a checked batch (B, V, ...), as
    :func:`sep_launch_plan` lays it out."""
    bx, by, bz = block_shape
    dev = patches.device
    B, V, px, py, pz = (int(s) for s in patches.shape)
    fused = torch.empty((B, bx, by, bz), dtype=torch.float32, device=dev)
    wsum = torch.empty((B, bx, by, bz), dtype=torch.float32, device=dev)
    plan = sep_launch_plan(block_shape, V, B, (px, py, pz))
    lib = _cuda.load("sep")
    ret = lib.bst_fuse_block_sep_batch(
        patches.data_ptr(), _IN_CODE[patches.dtype], px, py, pz,
        diags.data_ptr(), ts.data_ptr(), tables.data_ptr(), valid.data_ptr(),
        B, V, bx, by, bz, _ft_code(fusion_type), plan.lanes_z, plan.n_jt,
        *plan.grid[:2], plan.nvs, plan.smem, int(plan.generic),
        fused.data_ptr(), wsum.data_ptr(), _stream(dev))
    _cuda.check(lib, ret, "fuse_block_sep")
    return fused, wsum


def fuse_block_sep_batch(patches, diags, ts, patch_offsets, img_dims, borders,
                         blend_ranges, valid, block_shape,
                         fusion_type="AVG_BLEND", inside_offs=None):
    """K5's batch form (``csrc/sep.cu``, one launch) on CUDA, the plain
    version on the CPU: :func:`fuse_block_sep` on each row of a batch of B
    blocks sharing the patch shape and view count. patches (B, V, Px, Py,
    Pz); diags, ts, patch_offsets, img_dims, borders, blend_ranges,
    inside_offs (B, V, 3) float32; valid (B, V) float32. Returns (fused,
    wsum), both (B, bx, by, bz) float32, each row bitwise the per-block
    kernel's."""
    if patches.device.type == "cpu":
        return fuse_block_sep_batch_plain(
            patches, diags, ts, patch_offsets, img_dims, borders,
            blend_ranges, valid, block_shape, fusion_type, inside_offs)
    bs = tuple(int(s) for s in block_shape)
    tables = _sep_batch_tables(patches, diags, ts, patch_offsets, img_dims,
                               borders, blend_ranges, valid, inside_offs, bs)
    out = _launch_sep(patches, diags, ts, tables, valid, bs, fusion_type)
    fuse_block_sep_batch.launches += 1
    return out


fuse_block_sep_batch.launches = 0


# ---------------------------------------------------------------------------
# K1: whole-volume composite fusion
# ---------------------------------------------------------------------------


def _composite_view_order(V: int, fusion_type: str):
    return range(V - 1, -1, -1) if fusion_type == "FIRST_WINS" else range(V)


def composite_axis_tables(windows, n_offs, kinds, fracs, diags, offs,
                          img_dims, borders, ranges, inside_offs, device):
    """Per-view 1-D blend weights and inside masks over each view's output
    window (ops/fusion.py:472-481 for "shift", _axis_blend_at for "sep"),
    packed into one float32 tensor on ``device``: for view v at
    ``starts[v]``, blend x, y, z then inside x, y, z. ``starts[v]`` is None
    for an empty window. K1 and its plain twin both read this one tensor.

    Positions are ``base * mul + add`` rounded once (:func:`_fma`):
    "shift" has base = a + n + i, mul = 1 (exact), add = frac; "sep" has
    base = a + i, mul = diag, add = off, as XLA contracts the JAX
    expression."""
    host = lambda x: np.asarray(torch.as_tensor(x, dtype=torch.float32).cpu(),
                                np.float32)
    fracs, diags, offs, img_dims, borders, ranges, inside_offs = (
        host(x) for x in (fracs, diags, offs, img_dims, borders, ranges,
                          inside_offs))
    cols, starts, at = [], [], 0
    for v, ((a, b), n) in enumerate(zip(windows, n_offs)):
        L = [int(b[d]) - int(a[d]) for d in range(3)]
        if any(s <= 0 for s in L):
            starts.append(None)
            continue
        for d in range(3):
            sep = kinds[v] == "sep"
            base = np.arange(L[d]) + int(a[d]) + (0 if sep else int(n[d]))
            k = np.full(L[d], 1.0, np.float32)
            params = [diags[v, d] if sep else 1.0,
                      offs[v, d] if sep else fracs[v, d], img_dims[v, d],
                      borders[v, d], ranges[v, d], inside_offs[v, d]]
            cols.append(np.stack([base.astype(np.float32)]
                                 + [k * p for p in params]))
        starts.append(at)
        at += 2 * sum(L)
    if not cols:
        return torch.zeros(1, dtype=torch.float32, device=device), starts
    # one upload, one elementwise pass; then regroup per view as
    # blend x, y, z, inside x, y, z
    base, mul, add, *axis = torch.from_numpy(np.concatenate(cols, 1)).to(device)
    w, ins = _axis_blend_at(_fma(base, mul, add), *axis)
    parts, pos = [], 0
    for v, st in enumerate(starts):
        if st is None:
            continue
        (a, b) = windows[v]
        n_v = sum(int(b[d]) - int(a[d]) for d in range(3))
        parts += [w[pos:pos + n_v], ins[pos:pos + n_v]]
        pos += n_v
    return torch.cat(parts).contiguous(), starts


def composite_coeff_tables(windows, n_offs, fracs, coeff_affs, cdims,
                           starts, device):
    """Per-view interpolation rows of the intensity grid over each "shift"
    view's window (make_translation_composite :580-591), packed into one
    float32 tensor on ``device``: for view v at ``offs[v]``, the low taps of
    x, y, z, then the high taps, then the weights (3 * (L0 + L1 + L2)
    floats). The grid coordinate of window index i along axis d is
    ``lpos * s + t`` rounded once (:func:`_fma`, as XLA contracts it), with
    lpos = ((a + n) + i) + frac and (s, t) the diagonal and translation of
    the view's level position -> grid affine; the taps follow
    _separable_interp_matrix (:func:`_interp_taps`). K1 and its plain twin
    both read this one tensor. ``offs[v]`` is None where ``starts[v]`` is."""
    host = lambda x: np.asarray(torch.as_tensor(x, dtype=torch.float32).cpu(),
                                np.float32)
    fracs, caffs = host(fracs), host(coeff_affs)
    base, mul, add, size, offs, at = [], [], [], [], [], 0
    for v, ((a, b), n) in enumerate(zip(windows, n_offs)):
        if starts[v] is None:
            offs.append(None)
            continue
        for d in range(3):
            L = int(b[d]) - int(a[d])
            lpos = (np.float32(int(a[d]) + int(n[d]))
                    + np.arange(L, dtype=np.float32)) + fracs[v, d]
            base.append(lpos.astype(np.float32))
            mul.append(np.full(L, caffs[v, d, d], np.float32))
            add.append(np.full(L, caffs[v, d, 3], np.float32))
            size.append(np.full(L, int(cdims[d]), np.int64))
        offs.append(at)
        at += 3 * sum(int(b[d]) - int(a[d]) for d in range(3))
    if not base:
        return torch.zeros(1, dtype=torch.float32, device=device), offs
    t = lambda xs: torch.from_numpy(np.concatenate(xs)).to(device)
    gc = _fma(t(base), t(mul), t(add))
    c = t(size)
    p = torch.minimum(torch.clamp(gc, min=0.0), (c - 1).to(torch.float32))
    lo = torch.minimum(torch.floor(p), torch.clamp(c - 2, min=0).to(
        torch.float32))
    f = p - lo
    hi = torch.minimum(lo + 1, (c - 1).to(torch.float32))
    parts, pos = [], 0
    for v, o in enumerate(offs):
        if o is None:
            continue
        (a, b) = windows[v]
        m = sum(int(b[d]) - int(a[d]) for d in range(3))
        parts += [lo[pos:pos + m], hi[pos:pos + m], f[pos:pos + m]]
        pos += m
    return torch.cat(parts).contiguous(), offs


def _composite_coeff_view(grid, ct, L):
    """One view's (scale, offset) over its window, (L0, L1, L2, 2): the grid
    interpolated along x, then y, then z with the rows of
    :func:`composite_coeff_tables` (``ct``: this view's slice)."""
    S = sum(L)
    lo, hi, f = ct[:S], ct[S:2 * S], ct[2 * S:]
    so = grid
    at = 0
    for d in range(3):
        sl = slice(at, at + L[d])
        shape = [1] * 4
        shape[d] = -1
        w = f[sl].reshape(shape)
        so = (so.index_select(d, lo[sl].long()) * (1.0 - w)
              + so.index_select(d, hi[sl].long()) * w)
        at += L[d]
    return so


def _composite_one_view(P, frac, a, L, n, pad):
    """One "shift" view's samples over its window: 8 shifted slices of the
    zero-padded tile ``P`` with constant corner weights."""
    val = torch.zeros(L, dtype=torch.float32, device=P.device)
    for cx in (0, 1):
        wxc = frac[0] if cx else 1.0 - frac[0]
        for cy in (0, 1):
            wyc = frac[1] if cy else 1.0 - frac[1]
            for cz in (0, 1):
                wzc = frac[2] if cz else 1.0 - frac[2]
                s = [a[d] + n[d] + pad[d] + c for d, c in enumerate((cx, cy, cz))]
                sl = P[s[0]:s[0] + L[0], s[1]:s[1] + L[1], s[2]:s[2] + L[2]]
                val = val + (wxc * wyc * wzc) * sl
    return val


def _composite_one_view_sep(P, diag, off, a, L, pad):
    """One "sep" (diagonal affine) view's samples: three separable
    interpolation contractions over the padded tile, x then y then z."""
    so = P
    for d in range(3):
        i = a[d] + torch.arange(L[d], dtype=torch.float32, device=P.device)
        pos = _fma(diag[d], i, off[d])
        m = _separable_interp_matrix(pos + pad[d], P.shape[d])
        so = torch.tensordot(so, m, dims=([0], [1]))
    return so


def _check_composite_coeffs(kinds, coeffs, coeff_affs, V):
    if (coeffs is None) != (coeff_affs is None):
        raise ValueError("coeffs and coeff_affs go together")
    if coeffs is None:
        return
    if any(k == "sep" for k in kinds):
        # the grid rows assume unit-step level positions, as in the JAX
        # program; the planner sends such volumes to the per-block route
        raise ValueError("intensity coefficients with diagonal views are "
                         "handled by the per-block kernels")
    if coeffs.dim() != 5 or coeffs.shape[0] != V or coeffs.shape[4] != 2:
        raise ValueError(f"coeffs has shape {tuple(coeffs.shape)}, expected "
                         f"({V}, Cx, Cy, Cz, 2)")


def composite_fuse_plain(tiles, fracs, img_dims, borders, ranges, inside_offs,
                         min_i, max_i, diags, offs, *, out_shape, windows,
                         n_offs, pad, fusion_type="AVG_BLEND",
                         out_dtype="float32", masks=False, kinds=(),
                         coeffs=None, coeff_affs=None):
    """Plain-torch whole-volume composite fusion (the JAX program ``impl``
    of make_translation_composite); ``coeffs`` (V, Cx, Cy, Cz, 2) and
    ``coeff_affs`` (V, 3, 4): the intensity grids and their level position
    -> grid affines ("shift" views only)."""
    dev = tiles[0].device
    V = len(windows)
    kinds = kinds or ("shift",) * V
    _check_composite_coeffs(kinds, coeffs, coeff_affs, V)
    tables, starts = composite_axis_tables(
        windows, n_offs, kinds, fracs, diags, offs, img_dims, borders,
        ranges, inside_offs, dev)
    if coeffs is not None:
        ctab, coffs = composite_coeff_tables(
            windows, n_offs, fracs, coeff_affs, coeffs.shape[1:4], starts,
            dev)
    cast = lambda x: torch.as_tensor(x, dtype=torch.float32).to(dev)
    fracs, diags, offs = cast(fracs), cast(diags), cast(offs)
    out_shape = tuple(int(s) for s in out_shape)
    acc = torch.full(out_shape, -torch.inf if fusion_type == "MAX_INTENSITY"
                     else 0.0, dtype=torch.float32, device=dev)
    wsum = torch.zeros(out_shape, dtype=torch.float32, device=dev)
    pd = tuple(int(p) for p in pad)
    for v in _composite_view_order(V, fusion_type):
        if starts[v] is None:
            continue
        (a, b), n = windows[v], n_offs[v]
        L = tuple(b[d] - a[d] for d in range(3))
        P = torch.nn.functional.pad(
            tiles[v].to(torch.float32), (pd[2], pd[2], pd[1], pd[1], pd[0], pd[0]))
        if kinds[v] == "sep":
            val = _composite_one_view_sep(P, diags[v], offs[v], a, L, pd)
        else:
            val = _composite_one_view(P, fracs[v], a, L, n, pd)
        if coeffs is not None:
            so = _composite_coeff_view(
                coeffs[v].to(torch.float32),
                ctab[coffs[v]:coffs[v] + 3 * sum(L)], L)
            val = so[..., 0] * val + so[..., 1]
        t = tables[starts[v]:starts[v] + 2 * sum(L)]
        blend = _outer3(_split3(t[:sum(L)], L))
        inside = _outer3(_split3(t[sum(L):], L))
        win = tuple(slice(a[d], b[d]) for d in range(3))
        if fusion_type == "AVG":
            w = inside
        elif fusion_type == "AVG_BLEND":
            w = inside * blend
        elif fusion_type == "MAX_INTENSITY":
            acc[win] = torch.maximum(acc[win],
                                     torch.where(inside > 0, val, -torch.inf))
            wsum[win] = wsum[win] + inside
            continue
        elif fusion_type in ("FIRST_WINS", "LAST_WINS"):
            acc[win] = torch.where(inside > 0, val, acc[win])
            wsum[win] = wsum[win] + inside
            continue
        else:
            raise ValueError(f"unknown fusion type {fusion_type}")
        acc[win] = acc[win] + val * w
        wsum[win] = wsum[win] + w
    if fusion_type in ("MAX_INTENSITY", "FIRST_WINS", "LAST_WINS"):
        fused = torch.where(wsum > 0, acc, 0.0)
    else:
        fused = torch.where(wsum > 0, acc / torch.clamp(wsum, min=1e-20), 0.0)
    if masks:
        _code, dtype, imax = _out_spec(out_dtype)
        return ((wsum > 0).to(torch.float32) * (imax or 1.0)).to(dtype)
    return convert_intensity_plain(fused, min_i, max_i, out_dtype)


def composite_fuse(tiles, fracs, img_dims, borders, ranges, inside_offs,
                   min_i, max_i, diags, offs, *, out_shape, windows, n_offs,
                   pad, fusion_type="AVG_BLEND", out_dtype="float32",
                   masks=False, kinds=(), coeffs=None, coeff_affs=None):
    """K1 (``csrc/composite.cu``) on CUDA, the plain version on the CPU.

    ``tiles``: per-view unpadded tiles (x, y, z) on one device; the per-view
    parameter arrays (V, 3) are numpy or tensors; windows, n_offs, pad and
    kinds come from the composite plan; ``coeffs`` (V, Cx, Cy, Cz, 2)
    float32 on the tiles' device and ``coeff_affs`` (V, 3, 4): optional
    intensity grids ("shift" views only). Returns the fused volume of
    ``out_shape`` in the storage dtype."""
    dev = tiles[0].device
    if dev.type == "cpu":
        return composite_fuse_plain(
            tiles, fracs, img_dims, borders, ranges, inside_offs, min_i, max_i,
            diags, offs, out_shape=out_shape, windows=windows, n_offs=n_offs,
            pad=pad, fusion_type=fusion_type, out_dtype=out_dtype,
            masks=masks, kinds=kinds, coeffs=coeffs, coeff_affs=coeff_affs)
    V = len(windows)
    kinds = kinds or ("shift",) * V
    for v, t in enumerate(tiles):
        _require(t, f"tiles[{v}]", dev, _IN_CODE)
        if t.dim() != 3:
            raise ValueError(f"tiles[{v}] must be 3-D (x, y, z)")
    _check_composite_coeffs(kinds, coeffs, coeff_affs, V)
    tables, starts = composite_axis_tables(
        windows, n_offs, kinds, fracs, diags, offs, img_dims, borders,
        ranges, inside_offs, dev)
    ctab = coffs = None
    if coeffs is not None:
        _require(coeffs, "coeffs", dev, _F32)
        ctab, coffs = composite_coeff_tables(
            windows, n_offs, fracs, coeff_affs, coeffs.shape[1:4], starts,
            dev)
    return launch_composite(tiles, tables, starts, fracs, diags, offs,
                            min_i, max_i, out_shape=out_shape,
                            windows=windows, n_offs=n_offs, pad=pad,
                            fusion_type=fusion_type, out_dtype=out_dtype,
                            masks=masks, kinds=kinds, coeffs=coeffs,
                            ctab=ctab, coffs=coffs)


# K1's launch (csrc/composite.cu): a thread owns COMPOSITE_R consecutive z
# outputs of one (i, j) column, a run; a block owns tile_j columns of
# tile_i consecutive i, whole where a column has at most COMPOSITE_MAX_RUNS
# runs (tile_runs = a column's runs), else cut into z tiles of
# COMPOSITE_MAX_RUNS runs; at most COMPOSITE_THREADS threads; grid (x
# tiles n_jt, z tiles). tile_i is the largest power of two up to
# COMPOSITE_MAX_TILE_I that leaves COMPOSITE_MIN_BLOCKS blocks (4 waves of
# 5 blocks an SM on 132 SMs): long x tiles share a block's staging, short
# ones fill the card on a small volume.
COMPOSITE_R = 8
COMPOSITE_THREADS = 128
COMPOSITE_MAX_RUNS = 32
COMPOSITE_MAX_TILE_I = 16
COMPOSITE_MIN_BLOCKS = 4 * 5 * 132
CompositeLaunch = namedtuple("CompositeLaunch",
                             "tile_i tile_j tile_runs n_jt grid")


def composite_plan(out_shape) -> CompositeLaunch:
    """K1's launch over a volume of ``out_shape``: ``tile_runs`` runs of
    COMPOSITE_R z outputs along z, ``tile_j`` columns along j and
    ``tile_i`` x slices a block, ``n_jt`` column tiles along j, ``grid`` (x
    tiles n_jt, z tiles). Whole columns where they hold at most
    COMPOSITE_MAX_RUNS runs (no idle z tail: route A's 132 planes are 17
    runs, 7 columns a block); longer columns in z tiles of
    COMPOSITE_MAX_RUNS runs, 4 columns a block."""
    X, Y, Z = (int(s) for s in out_shape)
    if min(X, Y, Z) <= 0:
        raise ValueError(f"empty composite volume {tuple(out_shape)}")
    runs = _cdiv(Z, COMPOSITE_R)
    tile_runs = min(runs, COMPOSITE_MAX_RUNS)
    tile_j = min(COMPOSITE_THREADS // tile_runs, Y)
    n_jt = _cdiv(Y, tile_j)
    n_zt = _cdiv(runs, tile_runs)
    tile_i = COMPOSITE_MAX_TILE_I
    while tile_i > 1 and _cdiv(X, tile_i) * n_jt * n_zt < COMPOSITE_MIN_BLOCKS:
        tile_i //= 2
    grid = (_cdiv(X, tile_i) * n_jt, n_zt)
    if grid[0] >= 2 ** 31 or grid[1] > 65535:
        raise ValueError(f"volume {tuple(out_shape)} exceeds the launch grid")
    return CompositeLaunch(tile_i, tile_j, tile_runs, n_jt, grid)


def composite_block_boxes(plan: CompositeLaunch, out_shape) -> np.ndarray:
    """Each block's box of output voxels, (blocks, 2, 3) [start, end) in
    (x, y, z), block b = (b % grid_x, b // grid_x), as K1 derives it from
    its block index: the views whose window misses the box at an x slice
    are skipped there by the whole block."""
    X, Y, Z = (int(s) for s in out_shape)
    bx = np.arange(plan.grid[0], dtype=np.int64)
    by = np.arange(plan.grid[1], dtype=np.int64)
    it = bx // plan.n_jt
    jlo = (bx - it * plan.n_jt) * plan.tile_j
    zn = COMPOSITE_R * plan.tile_runs
    box = np.empty((plan.grid[1], plan.grid[0], 2, 3), np.int64)
    box[:, :, 0, 0] = it * plan.tile_i
    box[:, :, 1, 0] = np.minimum(X, (it + 1) * plan.tile_i)
    box[:, :, 0, 1], box[:, :, 1, 1] = jlo, np.minimum(Y, jlo + plan.tile_j)
    box[:, :, 0, 2] = (by * zn)[:, None]
    box[:, :, 1, 2] = np.minimum(Z, (by + 1) * zn)[:, None]
    return box.reshape(-1, 2, 3)


def composite_records(tiles, starts, windows, n_offs, pad, kinds, fracs,
                      diags, offs, fusion_type, coeffs=None, coffs=None):
    """K1's view records (``struct BstCompositeView``), in the order the
    views are combined (:func:`_composite_view_order`: reversed for
    FIRST_WINS), views with an empty window left out. Returns (the records'
    bytes, the view index of each record). ``starts`` and ``coffs``: the
    views' offsets in the tables of :func:`composite_axis_tables` and
    :func:`composite_coeff_tables`; ``coeffs`` (V, Cx, Cy, Cz, 2): the grids,
    each record pointing at its view's."""
    host = lambda x: np.asarray(torch.as_tensor(x, dtype=torch.float32).cpu(),
                                np.float32)
    fracs, diags, offs = host(fracs), host(diags), host(offs)
    order = [v for v in _composite_view_order(len(windows), fusion_type)
             if starts[v] is not None]
    recs = (_cuda.BstCompositeView * max(len(order), 1))()
    for rec, v in zip(recs, order):
        (a, b), nv = windows[v], n_offs[v]
        rec.tile = tiles[v].data_ptr()
        rec.grid = None if coeffs is None else coeffs[v].data_ptr()
        rec.a[:] = [int(x) for x in a]
        rec.b[:] = [int(x) for x in b]
        rec.n[:] = [int(x) for x in nv]
        rec.pad[:] = [int(x) for x in pad]
        rec.tshape[:] = [int(x) for x in tiles[v].shape]
        rec.kind = 1 if kinds[v] == "sep" else 0
        rec.table_off = starts[v]
        rec.ctab_off = 0 if coffs is None else coffs[v]
        rec.frac[:] = [float(x) for x in fracs[v]]
        rec.diag[:] = [float(x) for x in diags[v]]
        rec.off[:] = [float(x) for x in offs[v]]
    return bytes(recs)[:len(order) * ctypes.sizeof(_cuda.BstCompositeView)], order


def launch_composite(tiles, tables, starts, fracs, diags, offs, min_i, max_i,
                     *, out_shape, windows, n_offs, pad, fusion_type,
                     out_dtype, masks, kinds, coeffs=None, ctab=None,
                     coffs=None):
    """K1 alone (one launch: :func:`composite_plan`, the records of
    :func:`composite_records`) on checked tiles and the tables
    :func:`composite_axis_tables` (and, with ``coeffs``,
    :func:`composite_coeff_tables`) built. Tiles of mixed element types are
    widened to float32 first (exactly: every input type converts to
    float32 without rounding)."""
    dev = tiles[0].device
    if len({t.dtype for t in tiles}) > 1:
        tiles = [t.to(torch.float32) for t in tiles]
    X, Y, Z = (int(s) for s in out_shape)
    for v, st in enumerate(starts):
        a, b = windows[v]
        if st is not None and any(int(a[d]) < 0 or int(b[d]) > (X, Y, Z)[d]
                                  for d in range(3)):
            raise ValueError(f"view {v}'s window {windows[v]} leaves the "
                             f"volume {(X, Y, Z)}")
    code, dtype, _imax = _out_spec(out_dtype)
    plan = composite_plan((X, Y, Z))
    recs, order = composite_records(tiles, starts, windows, n_offs, pad,
                                    kinds, fracs, diags, offs, fusion_type,
                                    coeffs, coffs)
    views = (torch.frombuffer(bytearray(recs), dtype=torch.uint8).to(dev)
             if order else None)
    out = torch.empty((X, Y, Z), dtype=dtype, device=dev)
    cdims = (0, 0, 0) if coeffs is None else tuple(int(c) for c in
                                                  coeffs.shape[1:4])
    lib = _cuda.load("composite")
    ret = lib.bst_composite(
        None if views is None else views.data_ptr(), len(order),
        _IN_CODE[tiles[0].dtype], int(coeffs is not None), tables.data_ptr(),
        None if ctab is None else ctab.data_ptr(), cdims[1], cdims[2], X, Y,
        Z, _ft_code(fusion_type), int(bool(masks)), code,
        float(np.float32(min_i)), float(np.float32(max_i)), plan.tile_i,
        plan.tile_j, plan.tile_runs, plan.n_jt, *plan.grid, out.data_ptr(),
        _stream(dev))
    _cuda.check(lib, ret, "composite")
    composite_fuse.launches += 1
    composite_fuse.coeff_launches += coeffs is not None
    return out


composite_fuse.launches = 0
composite_fuse.coeff_launches = 0


KERNEL_WRAPPERS = {
    "composite_fuse": composite_fuse,
    "fuse_block_shift": fuse_block_shift,
    "fuse_block": fuse_block,
    "convert_intensity": convert_intensity,
    "fuse_block_sep": fuse_block_sep,
    "fuse_volume_scan": fuse_volume_scan,
    "fuse_block_shift_batch": fuse_block_shift_batch,
    "fuse_block_batch": fuse_block_batch,
    "fuse_block_sep_batch": fuse_block_sep_batch,
}


def bucket_shape(shape: Sequence[int], quantum: int = 32) -> tuple[int, ...]:
    """Round patch shapes up to a multiple of ``quantum`` (the JAX package
    bounds recompiles this way; the port keeps it so both packages stage
    identical patches)."""
    return tuple(int(np.ceil(max(int(s), 1) / quantum)) * quantum for s in shape)


def bucket_views(n: int) -> int:
    """Pad view count to the next power of two (>=1)."""
    return 1 << max(0, int(np.ceil(np.log2(max(n, 1)))))
