"""Non-rigid fusion device program: one CUDA kernel and its plain-torch twin.

Port of ``bigstitcher_spark_tpu/ops/nonrigid.py``. Each view carries a
regular grid of control points whose per-vertex affine models are fitted
on the host from corresponding interest points
(:func:`fit_control_grid`, float64 numpy, copied from the JAX package).
Per output voxel the 12 model coefficients are interpolated across the
grid, the world coordinate is deformed into the view's world frame, and
the view's static world -> patch affine maps it into the staged patch,
which is sampled and blended as affine fusion does.

=================================  ======================  ==================
wrapper                            kernel (csrc/)          JAX program
=================================  ======================  ==================
:func:`nonrigid_fuse_block`        ``nonrigid.cu`` (K26)   nonrigid_fuse_block
:func:`nonrigid_fuse_block_batch`  ``nonrigid.cu`` (K26,   the sharded
                                   batch form)             route's vmap
=================================  ======================  ==================

A wrapper takes the plain version only because its tensors lie on the
CPU; on CUDA tensors it launches the kernel or raises. Each counts its
launches in its ``launches`` attribute.

Rounding follows the JAX program's order, and kernel and twin round at
the same places: the grid coordinate ``((origin + i) - grid_origin) /
spacing``; the separable interpolation taps of _separable_interp_matrix
(clamp rule); the coefficient lerps along x, then y, then z, each
``fma(b, f, a * (1 - f))``; the deform ``A0 wx + A1 wy + A2 wz + A3`` and
then the view affine, each row as XLA contracts it on the CPU (two fused
multiply-adds, :func:`_apply_row`). The twin writes each 2-tap lerp out
elementwise (no tensordot or matmul, which the card may fuse and
reorder).
"""

from __future__ import annotations

import numpy as np
import torch

from . import _cuda
from .fusion import (
    _F32,
    _IN_CODE,
    _axis_blend_at,
    _combine_views,
    _fma,
    _ft_code,
    _interp_taps,
    _require,
    _rows_of_one,
    _stream,
    _trilinear_sample,
    resample_plan,
)


def _lerp_axis(so, d: int, pos):
    """Linear interpolation of ``so`` along axis ``d`` at the grid
    coordinates ``pos`` (L,): the two nonzero terms of a row of
    _separable_interp_matrix, accumulated as XLA's dot accumulates them on
    the CPU at the main path's shapes, ``fma(so[hi], f, so[lo] * (1 -
    f))`` (at small shapes XLA rounds the two products apart)."""
    lo, hi, f = _interp_taps(pos, so.shape[d])
    shape = [1] * so.dim()
    shape[d] = -1
    f = f.reshape(shape)
    return _fma(so.index_select(d, hi), f, so.index_select(d, lo) * (1.0 - f))


def _apply_row(c, x, y, z):
    """``c0 x + c1 y + c2 z + c3`` rounded as XLA contracts the JAX
    expression on the CPU, fma(c2, z, fma(c0, x, c1 y)) + c3 (K26's
    fmaf calls; :func:`_fma` rounds each fused multiply-add once)."""
    return _fma(c[2], z, _fma(c[0], x, c[1] * y)) + c[3]


def _sample_one_view_nonrigid(patch, grid, view_affine, patch_offset, img_dim,
                              border, blend_range, block_origin, grid_origin,
                              grid_spacing, block_shape):
    """One view: interpolate the vertex models at every output voxel, deform
    the world coordinates, map into the patch, sample and blend. Returns
    (val, inside, w_blend), each (N,)."""
    L = tuple(int(s) for s in block_shape)
    dev = patch.device
    so = grid
    for d in range(3):
        i = torch.arange(L[d], dtype=torch.float32, device=dev)
        pos = ((block_origin[d] + i) - grid_origin[d]) / grid_spacing[d]
        so = _lerp_axis(so, d, pos)
    A = so.reshape(-1, 12)  # (N, 12): row-major (3, 4) per voxel
    w = [block_origin[d] + torch.arange(L[d], dtype=torch.float32, device=dev)
         for d in range(3)]
    wx = w[0][:, None, None].expand(L).reshape(-1)
    wy = w[1][None, :, None].expand(L).reshape(-1)
    wz = w[2][None, None, :].expand(L).reshape(-1)
    deformed = [_apply_row(A[:, 4 * r:4 * r + 4].T, wx, wy, wz)
                for r in range(3)]
    p = torch.stack([_apply_row(view_affine[i], *deformed) for i in range(3)],
                    dim=-1)
    val = _trilinear_sample(patch, p)
    lpos = p + patch_offset
    wb, ins = _axis_blend_at(lpos, img_dim, border, blend_range)
    return (val, ins[:, 0] * ins[:, 1] * ins[:, 2],
            wb[:, 0] * wb[:, 1] * wb[:, 2])


def nonrigid_fuse_block_plain(patches, grids, view_affines, patch_offsets,
                              img_dims, borders, blend_ranges, valid,
                              block_origin, grid_origin, grid_spacing,
                              block_shape, fusion_type="AVG_BLEND"):
    """Plain-torch ``nonrigid_fuse_block``: per view
    :func:`_sample_one_view_nonrigid`, then the per-type combine. Returns
    (fused, wsum), both ``block_shape`` float32."""
    patches = patches.to(torch.float32)
    vals, insides, blends = [], [], []
    for v in range(patches.shape[0]):
        val, ins, wb = _sample_one_view_nonrigid(
            patches[v], grids[v], view_affines[v], patch_offsets[v],
            img_dims[v], borders[v], blend_ranges[v], block_origin,
            grid_origin, grid_spacing, block_shape)
        vals.append(val)
        insides.append(ins)
        blends.append(wb)
    fused, wsum = _combine_views(torch.stack(vals), torch.stack(insides),
                                 torch.stack(blends), valid, fusion_type)
    shape = tuple(int(s) for s in block_shape)
    return fused.reshape(shape), wsum.reshape(shape)


def nonrigid_fuse_block(patches, grids, view_affines, patch_offsets,
                        img_dims, borders, blend_ranges, valid, block_origin,
                        grid_origin, grid_spacing, block_shape,
                        fusion_type="AVG_BLEND"):
    """K26 (``csrc/nonrigid.cu``) on CUDA, the plain version on the CPU.

    patches (V, Px, Py, Pz) uint8/uint16/int16/float32; grids (V, Gx, Gy,
    Gz, 12) float32 vertex models (target world -> view world, row-major
    3x4); view_affines (V, 3, 4) float32 (view world -> patch coords);
    patch_offsets, img_dims, borders, blend_ranges (V, 3) float32; valid
    (V,) float32; block_origin, grid_origin, grid_spacing (3,) float32.
    Returns (fused, wsum), both ``block_shape`` float32. The launch is
    K3's (:func:`.fusion.resample_plan`); on CUDA it is
    :func:`nonrigid_fuse_block_batch`'s on a batch of one."""
    if patches.device.type == "cpu":
        return nonrigid_fuse_block_plain(
            patches, grids, view_affines, patch_offsets, img_dims, borders,
            blend_ranges, valid, block_origin, grid_origin, grid_spacing,
            block_shape, fusion_type)
    if patches.dim() != 4:
        raise ValueError("patches must be (V, Px, Py, Pz)")
    fused, wsum = _launch_nonrigid(*_rows_of_one(
        patches, grids, view_affines, patch_offsets, img_dims, borders,
        blend_ranges, valid, block_origin, grid_origin, grid_spacing),
        block_shape, fusion_type)
    nonrigid_fuse_block.launches += 1
    return fused[0], wsum[0]


nonrigid_fuse_block.launches = 0


def _launch_nonrigid(patches, grids, view_affines, patch_offsets, img_dims,
                     borders, blend_ranges, valid, block_origin, grid_origin,
                     grid_spacing, block_shape, fusion_type):
    """Check K26's batch inputs (B, V, ...) and launch it once."""
    dev = patches.device
    _require(patches, "patches", dev, _IN_CODE)
    if patches.dim() != 5:
        raise ValueError("patches must be (B, V, Px, Py, Pz)")
    B, V, px, py, pz = (int(s) for s in patches.shape)
    _require(grids, "grids", dev, _F32)
    if (grids.dim() != 6 or tuple(grids.shape[:2]) != (B, V)
            or grids.shape[5] != 12):
        raise ValueError(f"grids has shape {tuple(grids.shape)}, expected "
                         f"({B}, {V}, Gx, Gy, Gz, 12)")
    _require(view_affines, "view_affines", dev, _F32, (B, V, 3, 4))
    for name, t in (("patch_offsets", patch_offsets), ("img_dims", img_dims),
                    ("borders", borders), ("blend_ranges", blend_ranges)):
        _require(t, name, dev, _F32, (B, V, 3))
    _require(valid, "valid", dev, _F32, (B, V))
    for name, t in (("block_origin", block_origin),
                    ("grid_origin", grid_origin),
                    ("grid_spacing", grid_spacing)):
        _require(t, name, dev, _F32, (B, 3))
    gx, gy, gz = (int(s) for s in grids.shape[2:5])
    bx, by, bz = (int(s) for s in block_shape)
    plan = resample_plan((bx, by, bz), V, (px, py, pz))
    fused = torch.empty((B, bx, by, bz), dtype=torch.float32, device=dev)
    wsum = torch.empty((B, bx, by, bz), dtype=torch.float32, device=dev)
    lib = _cuda.load("nonrigid")
    ret = lib.bst_nonrigid_fuse_batch(
        patches.data_ptr(), _IN_CODE[patches.dtype], px, py, pz,
        grids.data_ptr(), gx, gy, gz, view_affines.data_ptr(),
        patch_offsets.data_ptr(), img_dims.data_ptr(), borders.data_ptr(),
        blend_ranges.data_ptr(), valid.data_ptr(), block_origin.data_ptr(),
        grid_origin.data_ptr(), grid_spacing.data_ptr(), B, V, bx, by, bz,
        _ft_code(fusion_type), plan.lanes_z, plan.n_jt, *plan.grid,
        int(plan.idx64), fused.data_ptr(), wsum.data_ptr(), _stream(dev))
    _cuda.check(lib, ret, "nonrigid_fuse")
    return fused, wsum


def nonrigid_fuse_block_batch_plain(patches, grids, view_affines,
                                    patch_offsets, img_dims, borders,
                                    blend_ranges, valid, block_origin,
                                    grid_origin, grid_spacing, block_shape,
                                    fusion_type="AVG_BLEND"):
    """Plain :func:`nonrigid_fuse_block_batch`:
    :func:`nonrigid_fuse_block_plain` row by row; a padding row (valid all
    0) is zeros. Returns (fused, wsum), both (B, *block_shape) float32."""
    shape = tuple(int(s) for s in block_shape)
    B = int(patches.shape[0])
    fused = torch.zeros((B, *shape), dtype=torch.float32,
                        device=patches.device)
    wsum = torch.zeros_like(fused)
    for b in range(B):
        if not bool((valid[b] != 0).any()):
            continue
        fused[b], wsum[b] = nonrigid_fuse_block_plain(
            patches[b], grids[b], view_affines[b], patch_offsets[b],
            img_dims[b], borders[b], blend_ranges[b], valid[b],
            block_origin[b], grid_origin[b], grid_spacing[b], shape,
            fusion_type)
    return fused, wsum


def nonrigid_fuse_block_batch(patches, grids, view_affines, patch_offsets,
                              img_dims, borders, blend_ranges, valid,
                              block_origin, grid_origin, grid_spacing,
                              block_shape, fusion_type="AVG_BLEND"):
    """K26's batch form (``csrc/nonrigid.cu``) on CUDA, the plain version
    on the CPU: B blocks of one bucket (one patch shape, view count and
    grid shape) in one launch, the JAX sharded route's vmap of
    nonrigid_fuse_block (models/nonrigid_fusion.py:263-273).

    The arguments are :func:`nonrigid_fuse_block`'s with a leading batch
    axis: patches (B, V, Px, Py, Pz), grids (B, V, Gx, Gy, Gz, 12),
    view_affines (B, V, 3, 4), the per-view arrays (B, V, 3), valid (B, V),
    block_origin, grid_origin, grid_spacing (B, 3). Returns (fused, wsum),
    both (B, *block_shape) float32; row b is bitwise the per-block
    kernel's on row b's inputs, a padding row (valid all 0) zeros."""
    if patches.device.type == "cpu":
        return nonrigid_fuse_block_batch_plain(
            patches, grids, view_affines, patch_offsets, img_dims, borders,
            blend_ranges, valid, block_origin, grid_origin, grid_spacing,
            block_shape, fusion_type)
    out = _launch_nonrigid(patches, grids, view_affines, patch_offsets,
                           img_dims, borders, blend_ranges, valid,
                           block_origin, grid_origin, grid_spacing,
                           block_shape, fusion_type)
    nonrigid_fuse_block_batch.launches += 1
    return out


nonrigid_fuse_block_batch.launches = 0

KERNEL_WRAPPERS = {"nonrigid_fuse": nonrigid_fuse_block,
                   "nonrigid_fuse_batch": nonrigid_fuse_block_batch}


# ---------------------------------------------------------------------------
# host-side control-grid fitting (moving least squares, IDW weights)
# ---------------------------------------------------------------------------

def fit_control_grid(
    targets: np.ndarray,         # (M,3) averaged world positions of unique IPs
    view_world: np.ndarray,      # (M,3) same IPs in this view's world frame
    grid_origin: np.ndarray,     # (3,)
    grid_dims: tuple[int, int, int],
    spacing: float,
    alpha: float = 1.0,
    reg_eps: float = 1e-6,
) -> np.ndarray:
    """Per-vertex affine models mapping target-world -> view-world.

    Weighted least squares per vertex with inverse-distance weights
    w_i = 1/(d^alpha + eps) (the MLS/IDW scheme of NonRigidTools, alpha=1.0,
    SparkNonRigidFusion.java:373-402). Falls back to the global affine (or
    translation) fit when points are scarce. Returns (Gx,Gy,Gz,12) float32.
    """
    gx, gy, gz = grid_dims
    G = gx * gy * gz
    m = len(targets)
    idx = np.indices((gx, gy, gz)).reshape(3, -1).T  # (G,3)
    verts = grid_origin + idx * spacing

    out = np.zeros((G, 3, 4))
    out[:, :, :3] = np.eye(3)
    if m == 0:
        return out.reshape(gx, gy, gz, 12).astype(np.float32)
    if m < 4:
        # translation-only fallback: mean displacement
        t = (view_world - targets).mean(axis=0)
        out[:, :, 3] = t
        return out.reshape(gx, gy, gz, 12).astype(np.float32)

    d = np.linalg.norm(verts[:, None, :] - targets[None, :, :], axis=2)  # (G,M)
    w = 1.0 / (d**alpha + 0.5)

    # solve in vertex-centered coordinates (both sides), which keeps the
    # normal equations well-conditioned and makes the tiny identity
    # regularizer scale-free: fit maps (p - vert) -> (q - vert)
    pc = targets[None, :, :] - verts[:, None, :]          # (G,M,3)
    qc = view_world[None, :, :] - verts[:, None, :]
    ph = np.concatenate([pc, np.ones((G, m, 1))], axis=2)  # (G,M,4)
    A = np.einsum("gm,gmi,gmj->gij", w, ph, ph)
    B = np.einsum("gm,gmi,gmk->gik", w, ph, qc)
    lam = reg_eps * w.sum(axis=1)[:, None, None]
    x_id = np.zeros((4, 3))
    x_id[:3, :3] = np.eye(3)
    sol = np.linalg.solve(A + lam * np.eye(4), B + lam * x_id)  # (G,4,3)
    lin = np.swapaxes(sol[:, :3, :], 1, 2)                # (G,3,3)
    t = sol[:, 3, :] + verts - np.einsum("gij,gj->gi", lin, verts)
    out[:, :, :3] = lin
    out[:, :, 3] = t
    return out.reshape(gx, gy, gz, 12).astype(np.float32)
