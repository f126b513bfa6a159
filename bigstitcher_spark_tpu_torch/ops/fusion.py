"""Affine-fusion device programs: five CUDA kernels and their plain-torch twins.

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
========================  ===========================  ====================

A wrapper takes the plain version only because its tensors lie on the
CPU; on CUDA tensors it launches the kernel or raises. Each wrapper counts
its kernel launches in its ``launches`` attribute (an int), so a run can
show that it went through the kernels.

Arrays are indexed (x, y, z) with z contiguous, as in the JAX package.
Fusion types: AVG, AVG_BLEND, MAX_INTENSITY, FIRST_WINS (lowest view
wins), LAST_WINS (highest view wins).
"""

from __future__ import annotations

import math
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


def fuse_block_shift(patches, fracs, lpos0, img_dims, borders, blend_ranges,
                     valid, block_shape, fusion_type="AVG_BLEND",
                     inside_offs=None):
    """K2 (``csrc/shift.cu``) on CUDA, the plain version on the CPU.

    patches (V, bx+1, by+1, bz+1) uint8/uint16/int16/float32; fracs, lpos0,
    img_dims, borders, blend_ranges, inside_offs (V, 3) float32; valid (V,)
    float32. Returns (fused, wsum), both (bx, by, bz) float32."""
    if patches.device.type == "cpu":
        return fuse_block_shift_plain(patches, fracs, lpos0, img_dims, borders,
                                      blend_ranges, valid, block_shape,
                                      fusion_type, inside_offs)
    dev = patches.device
    V = patches.shape[0]
    bx, by, bz = (int(s) for s in block_shape)
    if inside_offs is None:
        inside_offs = torch.zeros_like(borders)
    _require(patches, "patches", dev, _IN_CODE, (V, bx + 1, by + 1, bz + 1))
    for name, t in (("fracs", fracs), ("lpos0", lpos0), ("img_dims", img_dims),
                    ("borders", borders), ("blend_ranges", blend_ranges),
                    ("inside_offs", inside_offs)):
        _require(t, name, dev, _F32, (V, 3))
    _require(valid, "valid", dev, _F32, (V,))
    tables = shift_axis_tables(lpos0, img_dims, borders, blend_ranges,
                               inside_offs, (bx, by, bz))
    return launch_fuse_block_shift(patches, fracs, tables, valid,
                                   (bx, by, bz), fusion_type)


def launch_fuse_block_shift(patches, fracs, tables, valid, block_shape,
                            fusion_type):
    """K2 alone, on inputs :func:`fuse_block_shift` has checked and on the
    weight tables it built (chip_smoke times this and the wrapper apart)."""
    bx, by, bz = block_shape
    dev = patches.device
    fused = torch.empty((bx, by, bz), dtype=torch.float32, device=dev)
    wsum = torch.empty((bx, by, bz), dtype=torch.float32, device=dev)
    lib = _cuda.load("shift")
    ret = lib.bst_fuse_block_shift(
        patches.data_ptr(), _IN_CODE[patches.dtype], fracs.data_ptr(),
        tables.data_ptr(), valid.data_ptr(), patches.shape[0], bx, by, bz,
        _ft_code(fusion_type), fused.data_ptr(), wsum.data_ptr(),
        _stream(dev))
    _cuda.check(lib, ret, "fuse_block_shift")
    fuse_block_shift.launches += 1
    return fused, wsum


fuse_block_shift.launches = 0


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


def fuse_block_plain(patches, affines, patch_offsets, img_dims, borders,
                     blend_ranges, valid, block_shape, fusion_type="AVG_BLEND",
                     inside_offs=None):
    """Plain-torch ``fuse_block``: per view, map block coords through the
    block->patch affine, sample trilinearly (edge-clamped), weight by the
    inside test and blend; then the per-type combine."""
    patches = patches.to(torch.float32)
    if inside_offs is None:
        inside_offs = torch.zeros_like(borders)
    coords = block_coords(block_shape, patches.device)
    vals, insides, blends = [], [], []
    x, y, z = coords[:, 0:1], coords[:, 1:2], coords[:, 2:3]
    for v in range(patches.shape[0]):
        A = affines[v]
        # coords @ A[:, :3].T + A[:, 3], one rounding per op in the kernel's
        # order: a matmul (cuBLAS on the card) may fuse and reorder, and one
        # ulp of sample position is a visible step on a steep image
        p = ((x * A[:, 0] + y * A[:, 1]) + z * A[:, 2]) + A[:, 3]
        vals.append(_trilinear_sample(patches[v], p))
        # cosine border ramp and inside test per axis at the level coords,
        # product over axes (ops/fusion.py _blend_weight)
        w, ins = _axis_blend_at(p + patch_offsets[v], img_dims[v], borders[v],
                                blend_ranges[v], inside_offs[v])
        insides.append(ins[:, 0] * ins[:, 1] * ins[:, 2])
        blends.append(w[:, 0] * w[:, 1] * w[:, 2])
    fused, wsum = _combine_views(torch.stack(vals), torch.stack(insides),
                                 torch.stack(blends), valid, fusion_type)
    return fused.reshape(tuple(block_shape)), wsum.reshape(tuple(block_shape))


def fuse_block(patches, affines, patch_offsets, img_dims, borders,
               blend_ranges, valid, block_shape, fusion_type="AVG_BLEND",
               inside_offs=None):
    """K3 (``csrc/gather.cu``) on CUDA, the plain version on the CPU.

    patches (V, Px, Py, Pz) uint8/uint16/int16/float32; affines (V, 3, 4)
    float32 (block index -> patch coords); patch_offsets, img_dims, borders,
    blend_ranges, inside_offs (V, 3) float32; valid (V,) float32. Returns
    (fused, wsum), both ``block_shape`` float32."""
    if patches.device.type == "cpu":
        return fuse_block_plain(patches, affines, patch_offsets, img_dims,
                                borders, blend_ranges, valid, block_shape,
                                fusion_type, inside_offs)
    dev = patches.device
    V, px, py, pz = (int(s) for s in patches.shape)
    bx, by, bz = (int(s) for s in block_shape)
    if inside_offs is None:
        inside_offs = torch.zeros_like(borders)
    _require(patches, "patches", dev, _IN_CODE)
    _require(affines, "affines", dev, _F32, (V, 3, 4))
    for name, t in (("patch_offsets", patch_offsets), ("img_dims", img_dims),
                    ("borders", borders), ("blend_ranges", blend_ranges),
                    ("inside_offs", inside_offs)):
        _require(t, name, dev, _F32, (V, 3))
    _require(valid, "valid", dev, _F32, (V,))
    fused = torch.empty((bx, by, bz), dtype=torch.float32, device=dev)
    wsum = torch.empty((bx, by, bz), dtype=torch.float32, device=dev)
    lib = _cuda.load("gather")
    ret = lib.bst_fuse_block(
        patches.data_ptr(), _IN_CODE[patches.dtype], px, py, pz,
        affines.data_ptr(), patch_offsets.data_ptr(), img_dims.data_ptr(),
        borders.data_ptr(), blend_ranges.data_ptr(), valid.data_ptr(),
        inside_offs.data_ptr(), V, bx, by, bz, _ft_code(fusion_type),
        fused.data_ptr(), wsum.data_ptr(), _stream(dev))
    _cuda.check(lib, ret, "fuse_block")
    fuse_block.launches += 1
    return fused, wsum


fuse_block.launches = 0


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
    float32. Returns (fused, wsum), both ``block_shape`` float32."""
    if patches.device.type == "cpu":
        return fuse_block_sep_plain(patches, diags, ts, patch_offsets,
                                    img_dims, borders, blend_ranges, valid,
                                    block_shape, fusion_type, inside_offs)
    dev = patches.device
    V = patches.shape[0]
    bs = tuple(int(s) for s in block_shape)
    if inside_offs is None:
        inside_offs = torch.zeros_like(borders)
    _require(patches, "patches", dev, _IN_CODE)
    if patches.dim() != 4:
        raise ValueError("patches must be (V, Px, Py, Pz)")
    for name, t in (("diags", diags), ("ts", ts),
                    ("patch_offsets", patch_offsets), ("img_dims", img_dims),
                    ("borders", borders), ("blend_ranges", blend_ranges),
                    ("inside_offs", inside_offs)):
        _require(t, name, dev, _F32, (V, 3))
    _require(valid, "valid", dev, _F32, (V,))
    tables = sep_axis_tables(diags, ts, patch_offsets, img_dims, borders,
                             blend_ranges, inside_offs, bs)
    return launch_fuse_block_sep(patches, diags, ts, tables, valid, bs,
                                 fusion_type)


def launch_fuse_block_sep(patches, diags, ts, tables, valid, block_shape,
                          fusion_type):
    """K5 alone, on inputs :func:`fuse_block_sep` has checked and on the
    weight tables it built (chip_smoke times this and the wrapper apart)."""
    bx, by, bz = block_shape
    dev = patches.device
    V, px, py, pz = (int(s) for s in patches.shape)
    fused = torch.empty((bx, by, bz), dtype=torch.float32, device=dev)
    wsum = torch.empty((bx, by, bz), dtype=torch.float32, device=dev)
    lib = _cuda.load("sep")
    ret = lib.bst_fuse_block_sep(
        patches.data_ptr(), _IN_CODE[patches.dtype], px, py, pz,
        diags.data_ptr(), ts.data_ptr(), tables.data_ptr(), valid.data_ptr(),
        V, bx, by, bz, _ft_code(fusion_type), fused.data_ptr(),
        wsum.data_ptr(), _stream(dev))
    _cuda.check(lib, ret, "fuse_block_sep")
    fuse_block_sep.launches += 1
    return fused, wsum


fuse_block_sep.launches = 0


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


def composite_fuse_plain(tiles, fracs, img_dims, borders, ranges, inside_offs,
                         min_i, max_i, diags, offs, *, out_shape, windows,
                         n_offs, pad, fusion_type="AVG_BLEND",
                         out_dtype="float32", masks=False, kinds=()):
    """Plain-torch whole-volume composite fusion (the JAX program ``impl``
    of make_translation_composite without intensity coefficients)."""
    dev = tiles[0].device
    V = len(windows)
    kinds = kinds or ("shift",) * V
    tables, starts = composite_axis_tables(
        windows, n_offs, kinds, fracs, diags, offs, img_dims, borders,
        ranges, inside_offs, dev)
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
                   masks=False, kinds=()):
    """K1 (``csrc/composite.cu``) on CUDA, the plain version on the CPU.

    ``tiles``: per-view unpadded tiles (x, y, z) on one device; the per-view
    parameter arrays (V, 3) are numpy or tensors; windows, n_offs, pad and
    kinds come from the composite plan. Returns the fused volume of
    ``out_shape`` in the storage dtype."""
    dev = tiles[0].device
    if dev.type == "cpu":
        return composite_fuse_plain(
            tiles, fracs, img_dims, borders, ranges, inside_offs, min_i, max_i,
            diags, offs, out_shape=out_shape, windows=windows, n_offs=n_offs,
            pad=pad, fusion_type=fusion_type, out_dtype=out_dtype,
            masks=masks, kinds=kinds)
    V = len(windows)
    kinds = kinds or ("shift",) * V
    for v, t in enumerate(tiles):
        _require(t, f"tiles[{v}]", dev, _IN_CODE)
        if t.dim() != 3:
            raise ValueError(f"tiles[{v}] must be 3-D (x, y, z)")
    tables, starts = composite_axis_tables(
        windows, n_offs, kinds, fracs, diags, offs, img_dims, borders,
        ranges, inside_offs, dev)
    return launch_composite(tiles, tables, starts, fracs, diags, offs,
                            min_i, max_i, out_shape=out_shape,
                            windows=windows, n_offs=n_offs, pad=pad,
                            fusion_type=fusion_type, out_dtype=out_dtype,
                            masks=masks, kinds=kinds)


def launch_composite(tiles, tables, starts, fracs, diags, offs, min_i, max_i,
                     *, out_shape, windows, n_offs, pad, fusion_type,
                     out_dtype, masks, kinds):
    """K1 alone (init, one launch per view, finalize) on checked tiles and
    the tables :func:`composite_axis_tables` built."""
    dev = tiles[0].device
    host = lambda x: np.asarray(torch.as_tensor(x, dtype=torch.float32).cpu(),
                                np.float32)
    fracs, diags, offs = host(fracs), host(diags), host(offs)
    ft = _ft_code(fusion_type)
    code, dtype, _imax = _out_spec(out_dtype)
    X, Y, Z = (int(s) for s in out_shape)
    n = X * Y * Z
    acc = torch.empty((X, Y, Z), dtype=torch.float32, device=dev)
    wsum = torch.empty((X, Y, Z), dtype=torch.float32, device=dev)
    out = torch.empty((X, Y, Z), dtype=dtype, device=dev)
    lib = _cuda.load("composite")
    stream = _stream(dev)
    _cuda.check(lib, lib.bst_composite_init(acc.data_ptr(), wsum.data_ptr(),
                                            n, ft, stream), "composite init")
    composite_fuse.launches += 1
    for v in _composite_view_order(len(windows), fusion_type):
        if starts[v] is None:
            continue
        (a, b), nv = windows[v], n_offs[v]
        vp = _cuda.BstCompositeView()
        vp.a[:] = [int(x) for x in a]
        vp.L[:] = [int(b[d]) - int(a[d]) for d in range(3)]
        vp.n[:] = [int(x) for x in nv]
        vp.pad[:] = [int(x) for x in pad]
        vp.tshape[:] = [int(s) for s in tiles[v].shape]
        vp.kind = 1 if kinds[v] == "sep" else 0
        vp.table_off = starts[v]
        vp.frac[:] = [float(x) for x in fracs[v]]
        vp.diag[:] = [float(x) for x in diags[v]]
        vp.off[:] = [float(x) for x in offs[v]]
        ret = lib.bst_composite_view(
            tiles[v].data_ptr(), _IN_CODE[tiles[v].dtype], vp,
            tables.data_ptr(), ft, acc.data_ptr(), wsum.data_ptr(), X, Y, Z,
            stream)
        _cuda.check(lib, ret, f"composite view {v}")
        composite_fuse.launches += 1
    ret = lib.bst_composite_finalize(
        acc.data_ptr(), wsum.data_ptr(), n, ft, int(bool(masks)), code,
        float(np.float32(min_i)), float(np.float32(max_i)), out.data_ptr(),
        stream)
    _cuda.check(lib, ret, "composite finalize")
    composite_fuse.launches += 1
    return out


composite_fuse.launches = 0


KERNEL_WRAPPERS = {
    "composite_fuse": composite_fuse,
    "fuse_block_shift": fuse_block_shift,
    "fuse_block": fuse_block,
    "convert_intensity": convert_intensity,
    "fuse_block_sep": fuse_block_sep,
}


def bucket_shape(shape: Sequence[int], quantum: int = 32) -> tuple[int, ...]:
    """Round patch shapes up to a multiple of ``quantum`` (the JAX package
    bounds recompiles this way; the port keeps it so both packages stage
    identical patches)."""
    return tuple(int(np.ceil(max(int(s), 1) / quantum)) * quantum for s in shape)


def bucket_views(n: int) -> int:
    """Pad view count to the next power of two (>=1)."""
    return 1 << max(0, int(np.ceil(np.log2(max(n, 1)))))
