"""Difference-of-Gaussians blob detection: four CUDA kernels (K15-K18),
their plain-torch twins, and the host-side helpers.

Port of ``bigstitcher_spark_tpu/ops/dog.py`` (reference
``DoGImgLib2.computeDoG``, SparkInterestPointDetection.java:552-568): two
Gaussian blurs (sigma, sigma * 2^(1/4)) with mirror edges, their
difference scaled by ``1 / (k - 1)`` and the folded ``1 / (max - min)``
normalisation, 3x3x3 extrema against a threshold, and a quadratic subpixel
fit. The JAX device program ``dog_block_topk_batch`` (and the dense
``dog_block`` / ``dog_block_batch``) is split into four hand-written
kernels for ``sm_90a`` (``csrc/dog.cu``), with a batch dimension written
out instead of ``vmap``:

==========================  =====================  ==============================
wrapper                     kernel                 step of the JAX program
==========================  =====================  ==============================
:func:`dog_blur`            K15                    one 1-D pass of ``_blur_separable``
:func:`dog_extrema`         K16                    response, ``_tiebreak``, extrema,
                                                   halo core, candidates, count
:func:`dog_topk`            K17                    ``lax.top_k`` of the candidates
:func:`dog_localize`        K18                    ``_localize_quadratic_device``
==========================  =====================  ==============================

The residual pooling of ``rel != 1`` blocks is K6
(:func:`..ops.downsample.downsample_batch`). The JAX package blurs with
Toeplitz matrix products (``BST_DOG_BLUR=gemm``, its TPU default) or with
one FFT (circular edges, its CPU default); the port implements the
former's semantics, mirrored edges, as separable passes.

A wrapper takes its plain twin only because its tensor lies on the CPU;
on CUDA tensors it launches its kernel or raises. Each wrapper counts its
calls that launch its kernel in its ``launches`` attribute. The twins
repeat the kernels' float32 operations in the same order, one rounding
each, so kernel and twin agree bit for bit on the card. Against the JAX
package (whose matrix products and LU sum in other orders) the response
agrees to float32 rounding.

:func:`dog_detect_extract_batch` follows it with K19's masked form
(:func:`..ops.descriptors.block_descriptors_batch`) on each block's
candidate slots: the JAX package's fused detect-and-describe program, as
a composition of kernels that adds none.

:func:`dog_block_topk_batch` returns ``(idx, sub, val, valid, count)`` as
the JAX function does. Rows past a block's candidates are invalid and hold
flat index 0: ``idx`` (0, 0, 0), ``sub`` (0, 0, 0), ``val`` 0 (the JAX
program leaves other voxels there; callers drop invalid rows).
"""

from __future__ import annotations

import functools
from collections import namedtuple
from typing import Sequence

import numpy as np
import torch

from . import _cuda
from .descriptors import _sms, block_descriptors_batch, knn_descriptors_plain
from .downsample import downsample_batch, downsample_block_plain
from .fusion import _IN_CODE, _require, _stream

DOG_K = float(2.0 ** (1.0 / 4.0))
# K17 keeps at most this many candidates per block (its shared array);
# its launch plan (csrc/dog.cu): a block of TOPK_THREADS threads ranks that
# many of the answer's rows
MAX_TOPK = 8192
TOPK_THREADS = 256
TopkPlan = namedtuple("TopkPlan", "grid smem")
# K15's launch plan (csrc/dog.cu): the run form walks BLUR_RUN outputs a
# thread along a line (BLUR_RUN_THREADS threads a block), x and y, and z
# where the radius exceeds BLUR_CHUNK; the row form stages at most
# BLUR_CHUNK z outputs of a row a warp (BLUR_ROW_WARPS warps a block; a
# multiple of the 96 outputs a warp computes at a time, 3 a lane)
BLUR_RUN = 16
BLUR_RUN_THREADS = 128
BLUR_CHUNK = 480
BLUR_ROW_WARPS = 8
_BLUR_ROUTES = {"run": 0, "row": 1}
BlurPlan = namedtuple("BlurPlan", "route grid chunk")
# K16's launch plan (csrc/dog.cu): threads a block, loads a thread a plane
# at most, blocks an SM (its __launch_bounds__), the ring's planes of dog,
# the warps' queues' bytes (512 16-bit offsets a warp), the shared memory
# of the ring and the queues at most (three blocks an SM,
# the rest of the SM's 256 KB left to L1, which holds the loads in flight),
# the widest z tile (float4 and scalar loads), the tallest y tile, the most
# and the fewest planes a chunk of x (H100 80GB HBM3 at 700 W, 8a's bucket:
# 12 rows and 24-30 planes were the fastest of 6-26 and 16-59)
EXTREMA_THREADS = 256
EXTREMA_ITEMS = 4
EXTREMA_BLOCKS_PER_SM = 3
EXTREMA_RING = 4
EXTREMA_QUEUES = 8 * 512 * 2
EXTREMA_SMEM = 75 * 1024
EXTREMA_MAX_TZ = (128, 256)
EXTREMA_MAX_TY = 12
EXTREMA_PLANES = 30
EXTREMA_MIN_PLANES = 8
ExtremaPlan = namedtuple("ExtremaPlan", "vec ty tz xc grid")
_TB_SCALE = 2.0 ** -30
_F32 = (torch.float32,)
_I32 = (torch.int32,)


def gaussian_kernel_1d(sigma: float) -> np.ndarray:
    """Normalized 1-D Gaussian, radius 3*sigma (imglib2 Gauss3-style support)."""
    r = max(1, int(np.ceil(3.0 * float(sigma))))
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-(x**2) / (2.0 * float(sigma) ** 2))
    return (k / k.sum()).astype(np.float32)


def dog_halo(sigma: float) -> int:
    """Halo needed so core+1-ring response values are padding-free: the larger
    blur radius plus one voxel for the extremum neighborhood."""
    r2 = max(1, int(np.ceil(3.0 * float(sigma) * DOG_K)))
    return r2 + 1


def reflect_index(n: int, r: int) -> np.ndarray:
    """Source indices of an axis of length ``n`` padded by ``r`` on each
    side as ``np.pad(mode="reflect")`` does (the mirror repeats while out of
    range; a single voxel repeats itself)."""
    out = np.empty(n + 2 * r, np.int64)
    for q in range(n + 2 * r):
        i = q - r
        if n == 1:
            i = 0
        while i < 0 or i >= n:
            if i < 0:
                i = -i
            if i >= n:
                i = 2 * n - 2 - i
        out[q] = i
    return out


def dog_scale(min_i: torch.Tensor, max_i: torch.Tensor) -> torch.Tensor:
    """Per-block response scale ``(1 / (k - 1)) * inv_range`` in float32,
    with ``inv_range = 1 / max(max - min, 1e-20)`` gated to 0 when
    ``max <= min`` (a flat view detects nothing)."""
    lo = min_i.to(torch.float32)
    hi = max_i.to(torch.float32)
    inv = torch.where(hi > lo, 1.0 / torch.clamp(hi - lo, min=1e-20),
                      torch.zeros_like(hi))
    return torch.tensor(1.0 / (DOG_K - 1.0), dtype=torch.float32,
                        device=inv.device) * inv


# ---------------------------------------------------------------------------
# Plain twins
# ---------------------------------------------------------------------------


def blur_plain(x: torch.Tensor, taps: np.ndarray, axis: int) -> torch.Tensor:
    """One mirrored 1-D pass of ``taps`` along ``axis`` (0, 1, 2) of a
    (B, X, Y, Z) batch, in K15's order: acc = w[0] x[i-r], then
    acc = acc + w[q] x[i-r+q]."""
    x = x.to(torch.float32)
    taps = np.asarray(taps, np.float32)
    r = taps.size // 2
    ax = x.dim() - 3 + axis
    n = x.shape[ax]
    src = torch.from_numpy(reflect_index(n, r)).to(x.device)
    xp = x.index_select(ax, src)
    acc = xp.narrow(ax, 0, n) * float(taps[0])
    for q in range(1, taps.size):
        acc = acc + xp.narrow(ax, q, n) * float(taps[q])
    return acc


def _tiebreak(shape, origins: torch.Tensor) -> torch.Tensor:
    """(B, X, Y, Z) float32 offsets hashed from absolute coordinates: the
    low 10 bits of the JAX package's wrapping int32 hash (int64 here), times
    2^-30."""
    B, X, Y, Z = shape
    o = origins.to(torch.int64)
    dev = origins.device
    ix = torch.arange(X, device=dev).view(1, X, 1, 1) + o[:, 0].view(B, 1, 1, 1)
    iy = torch.arange(Y, device=dev).view(1, 1, Y, 1) + o[:, 1].view(B, 1, 1, 1)
    iz = torch.arange(Z, device=dev).view(1, 1, 1, Z) + o[:, 2].view(B, 1, 1, 1)
    h = (ix * 73856093 + iy * 19349663 + iz * 83492791) & 1023
    return h.to(torch.float32) * _TB_SCALE


def _window3(d: torch.Tensor, op, fill: float) -> torch.Tensor:
    """3x3x3 maximum or minimum of a (B, X, Y, Z) volume, ``fill`` outside
    (exact in any order)."""
    for ax in range(1, 4):
        n = d.shape[ax]
        pad_shape = list(d.shape)
        pad_shape[ax] = 1
        edge = torch.full(pad_shape, fill, dtype=d.dtype, device=d.device)
        dp = torch.cat([edge, d, edge], dim=ax)
        d = op(op(dp.narrow(ax, 0, n), dp.narrow(ax, 1, n)),
               dp.narrow(ax, 2, n))
    return d


def _core_mask(shape, halo: int, device) -> torch.Tensor:
    B, X, Y, Z = shape
    core = torch.ones((1, X, Y, Z), dtype=torch.bool, device=device)
    for ax, n in enumerate((X, Y, Z), start=1):
        i = torch.arange(n, device=device)
        m = (i >= halo) & (i < n - halo)
        view = [1, 1, 1, 1]
        view[ax] = n
        core = core & m.view(view)
    return core


def extrema_plain(b1, b2, scale, threshold, origins, find_max=True,
                  find_min=False, halo=0, candidates=False):
    """K16's twin: ``dog = (b1 - b2) * scale``, the tie-broken 3x3x3
    extrema past the threshold inside the halo core. Returns (dog, mask),
    or with ``candidates`` (dog, cand_idx, cand_score, count): each block's
    flat indices in ascending order and their |dog|, zero past ``count``."""
    B = b1.shape[0]
    dog = (b1 - b2) * scale.view(B, 1, 1, 1)
    tb = _tiebreak(tuple(dog.shape), origins)
    thr = threshold.to(torch.float32).view(B, 1, 1, 1)
    mask = torch.zeros(dog.shape, dtype=torch.bool, device=dog.device)
    if find_max:
        d = dog + tb
        mask = mask | ((d >= _window3(d, torch.maximum, -np.inf))
                       & (dog > thr))
    if find_min:
        d = dog - tb
        mask = mask | ((d <= _window3(d, torch.minimum, np.inf))
                       & (dog < -thr))
    mask = mask & _core_mask(tuple(dog.shape), int(halo), dog.device)
    if not candidates:
        return dog, mask
    vol = dog[0].numel()
    cand_idx = torch.zeros((B, vol), dtype=torch.int32, device=dog.device)
    cand_score = torch.zeros((B, vol), dtype=torch.float32, device=dog.device)
    count = torch.zeros(B, dtype=torch.int32, device=dog.device)
    for b in range(B):
        flat = torch.nonzero(mask[b].reshape(-1)).reshape(-1)
        n = int(flat.numel())
        cand_idx[b, :n] = flat.to(torch.int32)
        cand_score[b, :n] = dog[b].reshape(-1)[flat].abs()
        count[b] = n
    return dog, cand_idx, cand_score, count


def topk_plain(cand_idx, cand_score, count, k: int, shape):
    """K17's twin: the ``k`` best candidates of each block by (|dog|
    descending, flat index ascending), whatever the order of the list.
    Returns idx (B, k, 3) int32 and valid (B, k) bool; invalid rows hold
    flat index 0."""
    B = cand_idx.shape[0]
    X, Y, Z = (int(s) for s in shape)
    flat = torch.zeros((B, k), dtype=torch.int64, device=cand_idx.device)
    valid = torch.zeros((B, k), dtype=torch.bool, device=cand_idx.device)
    for b, n in enumerate(count.tolist()):
        ci = cand_idx[b, :n].to(torch.int64)
        cs = cand_score[b, :n]
        o = torch.argsort(ci)
        ci, cs = ci[o], cs[o]
        best = torch.sort(cs, descending=True, stable=True).indices[:k]
        m = int(best.numel())
        flat[b, :m] = ci[best]
        valid[b, :m] = True
    idx = torch.stack([flat // (Y * Z), (flat // Z) % Y, flat % Z], dim=-1)
    return idx.to(torch.int32), valid


def _lu_solve3(h, g):
    """LU with partial pivoting of the 3x3 matrices ``h`` (a list of rows of
    tensors) with the same row swaps on ``g``, in K18's order; returns
    (det, the solution x)."""
    a = [[h[r][c].clone() for c in range(3)] for r in range(3)]
    y = [gi.clone() for gi in g]
    sgn = torch.ones_like(y[0])
    for j in range(3):
        best = a[j][j].abs()
        piv = torch.full_like(best, j, dtype=torch.int64)
        for r in range(j + 1, 3):
            better = a[r][j].abs() > best
            best = torch.where(better, a[r][j].abs(), best)
            piv = torch.where(better, torch.full_like(piv, r), piv)
        for r in range(j + 1, 3):
            sw = piv == r
            for c in range(3):
                top = a[j][c]
                a[j][c] = torch.where(sw, a[r][c], top)
                a[r][c] = torch.where(sw, top, a[r][c])
            top = y[j]
            y[j] = torch.where(sw, y[r], top)
            y[r] = torch.where(sw, top, y[r])
            sgn = torch.where(sw, -sgn, sgn)
        for r in range(j + 1, 3):
            nz = a[j][j] != 0
            lr = torch.where(nz, a[r][j] / torch.where(nz, a[j][j], 1.0),
                             torch.zeros_like(a[r][j]))
            a[r][j] = lr
            for c in range(j + 1, 3):
                a[r][c] = a[r][c] - lr * a[j][c]
    det = ((a[0][0] * a[1][1]) * a[2][2]) * sgn
    y[1] = y[1] - a[1][0] * y[0]
    y[2] = (y[2] - a[2][0] * y[0]) - a[2][1] * y[1]
    x2 = y[2] / a[2][2]
    x1 = (y[1] - a[1][2] * x2) / a[1][1]
    x0 = ((y[0] - a[0][1] * x1) - a[0][2] * x2) / a[0][0]
    return det, (x0, x1, x2)


def localize_plain(dog: torch.Tensor, idx: torch.Tensor,
                   valid: torch.Tensor, max_moves: int = 4):
    """K18's twin: the quadratic subpixel fit of ``idx`` (B, K, 3) in the
    blocks ``dog`` (B, X, Y, Z). Returns sub (B, K, 3) float32 and val
    (B, K) float32, both 0 on invalid rows."""
    B, X, Y, Z = (int(s) for s in dog.shape)
    flat = dog.reshape(B, -1)
    dims = [X, Y, Z]

    def gat(q):
        x = q[0].clamp(0, X - 1)
        y_ = q[1].clamp(0, Y - 1)
        z = q[2].clamp(0, Z - 1)
        return torch.gather(flat, 1, (x * Y + y_) * Z + z)

    p = [idx[..., d].to(torch.int64) for d in range(3)]
    res = [pd.to(torch.float32) for pd in p]
    value = gat(p)
    active = valid.clone()
    for _ in range(max_moves):
        ok = torch.ones_like(active)
        for d in range(3):
            ok = ok & (p[d] >= 1) & (p[d] <= dims[d] - 2)
        elig = active & ok
        c = gat(p)

        def shifted(*moves):
            q = list(p)
            for d, s in moves:
                q[d] = q[d] + s
            return gat(q)

        g, h = [], [[None] * 3 for _ in range(3)]
        for d in range(3):
            plus, minus = shifted((d, 1)), shifted((d, -1))
            g.append(0.5 * (plus - minus))
            h[d][d] = (plus - 2.0 * c) + minus
        for d in range(3):
            for e in range(d + 1, 3):
                v = 0.25 * (((shifted((d, 1), (e, 1)) - shifted((d, 1), (e, -1)))
                             - shifted((d, -1), (e, 1)))
                            + shifted((d, -1), (e, -1)))
                h[d][e] = v
                h[e][d] = v
        det, x = _lu_solve3(h, g)
        det_ok = det.abs() > 1e-12
        off = [torch.where(det_ok, torch.clamp(-xd, -1.0, 1.0),
                           torch.zeros_like(xd)) for xd in x]
        for d in range(3):
            res[d] = torch.where(elig, p[d].to(torch.float32) + off[d], res[d])
        value = torch.where(
            elig, c + 0.5 * ((g[0] * off[0] + g[1] * off[1]) + g[2] * off[2]),
            value)
        moved = [o.abs() > 0.5 for o in off]
        needs = (moved[0] | moved[1] | moved[2]) & det_ok & elig
        for d in range(3):
            step = torch.where(off[d] > 0, 1, -1)
            p[d] = torch.where(needs & moved[d], p[d] + step, p[d])
        active = needs
    zero = torch.zeros_like(value)
    sub = torch.stack([torch.where(valid, r, zero) for r in res], dim=-1)
    return sub, torch.where(valid, value, zero)


# ---------------------------------------------------------------------------
# Kernel wrappers (K15-K18)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=32)
def _taps_on(taps_bytes: bytes, device: str) -> torch.Tensor:
    return torch.from_numpy(np.frombuffer(taps_bytes, np.float32).copy()).to(
        device)


def _batch_shape(t: torch.Tensor, name: str) -> tuple[int, int, int, int]:
    if t.dim() != 4:
        raise ValueError(f"{name} must be (B, X, Y, Z), got {tuple(t.shape)}")
    shape = tuple(int(s) for s in t.shape)
    if shape[1] * shape[2] * shape[3] >= 2 ** 31:
        raise ValueError(f"{name} {shape}: the kernels index a block in 31 bits")
    return shape


def _cdiv(a: int, b: int) -> int:
    return -(-int(a) // int(b))


def blur_plan(B: int, X: int, Y: int, Z: int, axis: int, r: int) -> BlurPlan:
    """K15's launch for one pass of radius ``r`` along ``axis`` of a (B, X,
    Y, Z) batch: the form ("run" or "row"), its grid and, for the row
    form, the z chunk a warp stages. Run: a thread per line of the other
    two axes (the later one fastest), a block per BLUR_RUN_THREADS lines,
    grid (lines / threads, runs of BLUR_RUN along the axis, B). Row (z,
    r <= BLUR_CHUNK): a warp per chunk of a row, grid (rows x chunks /
    BLUR_ROW_WARPS, 1, 1)."""
    if axis == 2 and r <= BLUR_CHUNK:
        chunk = min(int(Z), BLUR_CHUNK)
        items = B * X * Y * _cdiv(Z, chunk)
        return BlurPlan("row", (_cdiv(items, BLUR_ROW_WARPS), 1, 1), chunk)
    lines, n = ((Y * Z, X), (X * Z, Y), (X * Y, Z))[axis]
    return BlurPlan("run", (_cdiv(lines, BLUR_RUN_THREADS),
                            _cdiv(n, BLUR_RUN), B), 0)


def extrema_plan(B: int, X: int, Y: int, Z: int, sms: int = 132,
                 addr: int = 0) -> ExtremaPlan:
    """K16's launch for a (B, X, Y, Z) batch on a card of ``sms``
    multiprocessors. ``vec``: float4 loads along z (Z a multiple of 4 and
    the arrays 16-byte aligned: ``addr``, their addresses or'd together).
    A block owns a (y, z) tile of ``ty`` x ``tz`` voxels of one batch entry
    (z whole up to EXTREMA_MAX_TZ, else cut into near-equal tiles, whole
    float4s with ``vec``; y as tall as EXTREMA_ITEMS loads a thread and
    EXTREMA_SMEM of ring and queues allow for the tile and its one-voxel
    halo, at most EXTREMA_MAX_TY, evened out) and a chunk of ``xc`` x
    planes: x is cut into chunks of at most EXTREMA_PLANES planes, and into
    more where the blocks would not fill the card's EXTREMA_BLOCKS_PER_SM x
    ``sms`` block slots, none shorter than EXTREMA_MIN_PLANES (a chunk
    computes the plane on each side again). ``grid``: (y tiles x z tiles,
    chunks, B)."""
    B, X, Y, Z = (int(v) for v in (B, X, Y, Z))
    if min(B, X, Y, Z) < 1:
        raise ValueError(f"K16 needs a non-empty batch, got {(B, X, Y, Z)}")
    vec = Z % 4 == 0 and int(addr) % 16 == 0
    V = 4 if vec else 1
    nz = _cdiv(Z, EXTREMA_MAX_TZ[vec])
    tz = _cdiv(_cdiv(Z, nz), V) * V
    nz = _cdiv(Z, tz)
    rows = EXTREMA_ITEMS * EXTREMA_THREADS // (tz // V) - 2
    sp = _cdiv(tz, 4) * 4 + 8
    fits = (EXTREMA_SMEM - EXTREMA_QUEUES) // (4 * EXTREMA_RING * sp) - 2
    ny = _cdiv(Y, min(EXTREMA_MAX_TY, rows, fits))
    ty = _cdiv(Y, ny)
    ny = _cdiv(Y, ty)
    slots = EXTREMA_BLOCKS_PER_SM * int(sms)
    chunks = max(_cdiv(X, EXTREMA_PLANES), slots // (ny * nz * B))
    chunks = max(1, min(chunks, X // EXTREMA_MIN_PLANES))
    xc = _cdiv(X, chunks)
    return ExtremaPlan(vec, ty, tz, xc, (ny * nz, _cdiv(X, xc), B))


def dog_blur(x: torch.Tensor, taps: np.ndarray, axis: int) -> torch.Tensor:
    """K15 (``csrc/dog.cu``) on CUDA, :func:`blur_plain` on the CPU: one
    mirrored 1-D Gaussian pass along ``axis`` of a (B, X, Y, Z) batch of
    uint8, uint16, int16 or float32 -> float32."""
    if x.device.type == "cpu":
        return blur_plain(x, taps, axis)
    _require(x, "x", x.device, _IN_CODE)
    B, X, Y, Z = _batch_shape(x, "x")
    taps = np.ascontiguousarray(taps, np.float32)
    if taps.ndim != 1 or taps.size % 2 != 1 or axis not in (0, 1, 2):
        raise ValueError("taps must be an odd-length 1-D kernel, axis 0-2")
    w = _taps_on(taps.tobytes(), str(x.device))
    r = taps.size // 2
    plan = blur_plan(B, X, Y, Z, int(axis), r)
    out = torch.empty((B, X, Y, Z), dtype=torch.float32, device=x.device)
    lib = _cuda.load("dog")
    ret = lib.bst_dog_blur(x.data_ptr(), _IN_CODE[x.dtype], B, X, Y, Z,
                           int(axis), w.data_ptr(), r,
                           _BLUR_ROUTES[plan.route], *plan.grid, plan.chunk,
                           out.data_ptr(), _stream(x.device))
    _cuda.check(lib, ret, "dog_blur")
    dog_blur.launches += 1
    return out


dog_blur.launches = 0


def dog_extrema(b1, b2, scale, threshold, origins, find_max=True,
                find_min=False, halo=0, candidates=False):
    """K16 on CUDA, :func:`extrema_plain` on the CPU. ``b1``, ``b2`` (B, X,
    Y, Z) float32 blurs, ``scale`` and ``threshold`` (B,) float32,
    ``origins`` (B, 3) int32 absolute voxel offsets of the blocks. Returns
    (dog, mask) or, with ``candidates``, (dog, cand_idx, cand_score,
    count): the extrema inside the halo core in arbitrary order, with
    |dog|, and their exact count per block. One launch over
    :func:`extrema_plan`'s grid."""
    if b1.device.type == "cpu":
        return extrema_plain(b1, b2, scale, threshold, origins, find_max,
                             find_min, halo, candidates)
    dev = b1.device
    B, X, Y, Z = _batch_shape(b1, "b1")
    _require(b1, "b1", dev, _F32)
    _require(b2, "b2", dev, _F32, (B, X, Y, Z))
    _require(scale, "scale", dev, _F32, (B,))
    _require(threshold, "threshold", dev, _F32, (B,))
    _require(origins, "origins", dev, _I32, (B, 3))
    dog = torch.empty((B, X, Y, Z), dtype=torch.float32, device=dev)
    if candidates:
        mask = None
        cand_idx = torch.empty((B, X * Y * Z), dtype=torch.int32, device=dev)
        cand_score = torch.empty((B, X * Y * Z), dtype=torch.float32,
                                 device=dev)
        count = torch.zeros(B, dtype=torch.int32, device=dev)
    else:
        mask = torch.empty((B, X, Y, Z), dtype=torch.bool, device=dev)
        cand_idx = cand_score = count = None
    ptr = lambda t: None if t is None else t.data_ptr()
    addr = b1.data_ptr() | b2.data_ptr() | dog.data_ptr()
    if mask is not None and mask.data_ptr() % 4:
        addr |= 1  # the mask's 4-byte stores need 4-byte alignment
    plan = extrema_plan(B, X, Y, Z, _sms(dev), addr)
    lib = _cuda.load("dog")
    ret = lib.bst_dog_extrema(
        b1.data_ptr(), b2.data_ptr(), B, X, Y, Z, scale.data_ptr(),
        threshold.data_ptr(), origins.data_ptr(), int(bool(find_max)),
        int(bool(find_min)), int(halo), int(plan.vec), plan.ty, plan.tz,
        plan.xc, dog.data_ptr(), ptr(mask), ptr(cand_idx), ptr(cand_score),
        ptr(count), _stream(dev))
    _cuda.check(lib, ret, "dog_extrema")
    dog_extrema.launches += 1
    if candidates:
        return dog, cand_idx, cand_score, count
    return dog, mask


dog_extrema.launches = 0


def topk_plan(B: int, k: int) -> TopkPlan:
    """K17's launch for a batch of ``B`` candidate lists and ``k``: a block
    of TOPK_THREADS threads for every TOPK_THREADS rows of the answer,
    ``grid`` (blocks a list, B), each holding ``smem`` bytes of keys (k of
    8 bytes). The count is not known here: the same plan serves any count,
    which the kernel reads on the device."""
    B, k = int(B), int(k)
    if not 1 <= B <= 65535:
        raise ValueError(f"K17 takes 1 to 65535 lists, got {B}")
    if not 1 <= k <= MAX_TOPK:
        raise ValueError(f"k={k}: K17 keeps 1 to {MAX_TOPK} candidates")
    return TopkPlan((_cdiv(k, TOPK_THREADS), B), 8 * k)


def dog_topk(cand_idx, cand_score, count, k: int, shape):
    """K17 on CUDA, :func:`topk_plain` on the CPU: the ``k`` best of each
    block's candidates (|dog| descending, then the lower flat index) as
    idx (B, k, 3) int32 and valid (B, k) bool. ``shape`` is the block's
    (X, Y, Z); ``k`` is at most :data:`MAX_TOPK`. One launch over
    :func:`topk_plan`'s grid; ``count`` stays on the device."""
    X, Y, Z = (int(s) for s in shape)
    k = int(k)
    if not 1 <= k <= min(MAX_TOPK, X * Y * Z):
        raise ValueError(f"k={k}: K17 keeps 1 to min({MAX_TOPK}, block "
                         "voxels) candidates")
    if cand_idx.device.type == "cpu":
        return topk_plain(cand_idx, cand_score, count, k, shape)
    dev = cand_idx.device
    B = int(cand_idx.shape[0])
    _require(cand_idx, "cand_idx", dev, _I32, (B, X * Y * Z))
    _require(cand_score, "cand_score", dev, _F32, (B, X * Y * Z))
    _require(count, "count", dev, _I32, (B,))
    plan = topk_plan(B, k)
    idx = torch.empty((B, k, 3), dtype=torch.int32, device=dev)
    valid = torch.empty((B, k), dtype=torch.bool, device=dev)
    lib = _cuda.load("dog")
    ret = lib.bst_dog_topk(cand_idx.data_ptr(), cand_score.data_ptr(),
                           count.data_ptr(), B, X, Y, Z, k, plan.grid[0],
                           idx.data_ptr(), valid.data_ptr(), _stream(dev))
    _cuda.check(lib, ret, "dog_topk")
    dog_topk.launches += 1
    return idx, valid


dog_topk.launches = 0


def dog_localize(dog: torch.Tensor, idx: torch.Tensor, valid: torch.Tensor):
    """K18 on CUDA, :func:`localize_plain` on the CPU: the quadratic
    subpixel fit of each valid candidate (4 rounds) -> sub (B, K, 3) and
    val (B, K) float32."""
    if dog.device.type == "cpu":
        return localize_plain(dog, idx, valid)
    dev = dog.device
    B, X, Y, Z = _batch_shape(dog, "dog")
    K = int(idx.shape[1])
    _require(dog, "dog", dev, _F32)
    _require(idx, "idx", dev, _I32, (B, K, 3))
    _require(valid, "valid", dev, (torch.bool,), (B, K))
    sub = torch.empty((B, K, 3), dtype=torch.float32, device=dev)
    val = torch.empty((B, K), dtype=torch.float32, device=dev)
    lib = _cuda.load("dog")
    ret = lib.bst_dog_localize(dog.data_ptr(), B, X, Y, Z, idx.data_ptr(),
                               valid.data_ptr(), K, sub.data_ptr(),
                               val.data_ptr(), _stream(dev))
    _cuda.check(lib, ret, "dog_localize")
    dog_localize.launches += 1
    return sub, val


dog_localize.launches = 0


KERNEL_WRAPPERS = {
    "dog_blur": dog_blur,
    "dog_extrema": dog_extrema,
    "dog_topk": dog_topk,
    "dog_localize": dog_localize,
}


# ---------------------------------------------------------------------------
# The JAX package's entry points, composed from the wrappers or the twins
# ---------------------------------------------------------------------------


def _describe_plain(points, valid, n, r, rot):
    _, desc, dv = knn_descriptors_plain(points, valid, n, r, rot)
    return desc, dv


# the steps of the DoG program: K6 and K15-K18, or their twins; and of the
# detect-and-extract program, K19's masked form or its twin
_Stages = namedtuple("_Stages", "pool blur extrema topk localize describe")
KERNELS = _Stages(downsample_batch, dog_blur, dog_extrema, dog_topk,
                  dog_localize, block_descriptors_batch)
PLAIN = _Stages(downsample_block_plain, blur_plain, extrema_plain, topk_plain,
                localize_plain, _describe_plain)


def _per_block(v, B: int, dtype, device) -> torch.Tensor:
    """A scalar or per-block value as a contiguous (B, ...) tensor."""
    t = torch.as_tensor(v).to(device=device, dtype=dtype)
    if t.dim() == 0:
        t = t.expand(B)
    return t.reshape(B, *t.shape[1:]).contiguous()


def _blurs(st: _Stages, x: torch.Tensor, sigma: float):
    """The two mirrored Gaussian blurs of ``x`` (three passes each)."""
    out = []
    for s in (float(sigma), float(sigma) * DOG_K):
        taps = gaussian_kernel_1d(s)
        b = x
        for ax in range(3):
            b = st.blur(b, taps, ax)
        out.append(b)
    return out


def _response(st, blocks, min_i, max_i, threshold, origins, sigma):
    B = int(blocks.shape[0])
    dev = blocks.device
    lo = _per_block(min_i, B, torch.float32, dev)
    hi = _per_block(max_i, B, torch.float32, dev)
    thr = _per_block(threshold, B, torch.float32, dev)
    if origins is None:
        org = torch.zeros((B, 3), dtype=torch.int32, device=dev)
    else:
        org = _per_block(origins, B, torch.int32, dev)
    b1, b2 = _blurs(st, blocks.contiguous(), sigma)
    return b1, b2, dog_scale(lo, hi), thr, org


def dog_block_batch(blocks, min_i, max_i, threshold, sigma, find_max=True,
                    find_min=False, origins=None, stages: _Stages = KERNELS):
    """The JAX ``dog_block_batch``: DoG response and extrema mask of each
    (X, Y, Z) block of ``blocks`` (B, X, Y, Z) -> (dog float32, mask bool),
    both (B, X, Y, Z). ``min_i``, ``max_i``, ``threshold``: (B,) or scalars;
    ``origins`` (B, 3) absolute voxel offsets (tie-breaking only)."""
    b1, b2, scale, thr, org = _response(stages, blocks, min_i, max_i,
                                        threshold, origins, sigma)
    return stages.extrema(b1, b2, scale, thr, org, find_max, find_min, 0,
                          False)


def dog_block(block, min_intensity, max_intensity, threshold, sigma,
              find_max=True, find_min=False, origin=None,
              stages: _Stages = KERNELS):
    """The JAX ``dog_block``: one (X, Y, Z) block -> (dog, mask)."""
    dog, mask = dog_block_batch(
        block[None], min_intensity, max_intensity, threshold, sigma,
        find_max, find_min,
        None if origin is None else torch.as_tensor(origin).reshape(1, 3),
        stages)
    return dog[0], mask[0]


def dog_block_topk_batch(blocks, min_i, max_i, threshold, origins, sigma,
                         find_max=True, find_min=False, k=2048, halo=0,
                         rel: Sequence[int] = (1, 1, 1),
                         stages: _Stages = KERNELS):
    """The JAX ``dog_block_topk_batch``: pool by ``rel`` (K6), DoG, extrema
    in the halo core, the ``k`` strongest by |dog| and their subpixel fit.
    Returns (idx (B, k, 3) int32, sub (B, k, 3) float32, val (B, k)
    float32, valid (B, k) bool, count (B,) int32: every core extremum, so
    count > k means truncation)."""
    x = blocks.contiguous()
    if any(int(r) != 1 for r in rel):
        x = stages.pool(x, tuple(int(r) for r in rel))
    b1, b2, scale, thr, org = _response(stages, x, min_i, max_i, threshold,
                                        origins, sigma)
    del x
    dog, cand_idx, cand_score, count = stages.extrema(
        b1, b2, scale, thr, org, find_max, find_min, int(halo), True)
    del b1, b2
    shape = tuple(int(s) for s in dog.shape[1:])
    k = int(min(int(k), int(np.prod(shape))))
    idx, valid = stages.topk(cand_idx, cand_score, count, k, shape)
    del cand_idx, cand_score
    sub, val = stages.localize(dog, idx, valid)
    return idx, sub, val, valid, count


def dog_detect_extract_batch(blocks, min_i, max_i, threshold, origins, sigma,
                             find_max=True, find_min=False, k=2048, halo=0,
                             rel: Sequence[int] = (1, 1, 1), n_neighbors=3,
                             redundancy=1, rotation_invariant=True,
                             stages: _Stages = KERNELS):
    """The JAX ``dog_detect_extract_batch``: :func:`dog_block_topk_batch`,
    then the kNN-frame descriptors of each block's ``k`` candidate slots
    (K19's masked form, ``descriptors.block_descriptors_batch``) on the
    block-local subpixel coordinates ``sub`` (halo offset not removed:
    descriptors are neighbour offsets) and ``valid``. The candidates stay
    on the device, on one stream, with no host synchronisation between the
    two. Returns (idx, sub, val, valid, count, desc (B, k, S, 3n) float32,
    dvalid (B, k) bool); invalid slots and points without a full pool of
    valid neighbours have all-zero descriptors."""
    idx, sub, val, valid, count = dog_block_topk_batch(
        blocks, min_i, max_i, threshold, origins, sigma, find_max, find_min,
        k, halo, rel, stages)
    desc, dvalid = stages.describe(sub, valid, int(n_neighbors),
                                   int(redundancy), bool(rotation_invariant))
    return idx, sub, val, valid, count, desc, dvalid


def localize_quadratic(
    dog: np.ndarray, coords: np.ndarray, max_moves: int = 4
) -> tuple[np.ndarray, np.ndarray]:
    """3-D quadratic subpixel refinement of integer extrema (host-side).

    Fits the local paraboloid via central differences: offset = -H^{-1} g;
    if any |offset_d| > 0.5 the base voxel moves one step and the fit repeats
    (imglib2 SubpixelLocalization behavior, up to ``max_moves``).
    Returns (subpixel coords (N,3) float64, refined values (N,)).
    """
    if len(coords) == 0:
        return np.zeros((0, 3)), np.zeros(0)
    p = np.asarray(coords, np.int64).copy()
    shape = np.array(dog.shape)
    result = p.astype(np.float64)
    value = dog[tuple(p.T)].astype(np.float64)
    active = np.ones(len(p), bool)
    for _ in range(max_moves):
        idx = np.where(active)[0]
        if idx.size == 0:
            break
        q = p[idx]
        ok = np.all((q >= 1) & (q <= shape - 2), axis=1)
        idx = idx[ok]
        if idx.size == 0:
            break
        q = p[idx]
        g = np.empty((len(q), 3))
        H = np.empty((len(q), 3, 3))
        c = dog[tuple(q.T)].astype(np.float64)
        plus, minus = [], []
        for d in range(3):
            e = np.zeros(3, np.int64)
            e[d] = 1
            plus.append(dog[tuple((q + e).T)].astype(np.float64))
            minus.append(dog[tuple((q - e).T)].astype(np.float64))
            g[:, d] = 0.5 * (plus[d] - minus[d])
            H[:, d, d] = plus[d] - 2.0 * c + minus[d]
        for d in range(3):
            for e_ in range(d + 1, 3):
                ed = np.zeros(3, np.int64)
                ee = np.zeros(3, np.int64)
                ed[d] = 1
                ee[e_] = 1
                v = 0.25 * (
                    dog[tuple((q + ed + ee).T)] - dog[tuple((q + ed - ee).T)]
                    - dog[tuple((q - ed + ee).T)] + dog[tuple((q - ed - ee).T)]
                ).astype(np.float64)
                H[:, d, e_] = v
                H[:, e_, d] = v
        det_ok = np.abs(np.linalg.det(H)) > 1e-12
        off = np.zeros((len(q), 3))
        if det_ok.any():
            off[det_ok] = -np.linalg.solve(H[det_ok], g[det_ok][..., None])[..., 0]
        off = np.clip(off, -1.0, 1.0)
        # keep this fit as the current best answer; a base move only refits
        # (never discards), so an oscillating half-sample tie still converges
        result[idx] = q + off
        value[idx] = c + 0.5 * np.einsum("ij,ij->i", g, off)
        moved = np.abs(off) > 0.5
        needs_move = moved.any(axis=1) & det_ok
        active[:] = False
        active[idx[needs_move]] = True
        step = np.where(moved, np.sign(off).astype(np.int64), 0)
        p[idx[needs_move]] += step[needs_move]
    return result, value


def sample_trilinear(vol: np.ndarray, points: np.ndarray) -> np.ndarray:
    """n-linear interpolation of ``vol`` at float ``points`` (N,3) (host-side;
    the reference samples detection intensities the same way,
    SparkInterestPointDetection.java:581-606)."""
    if len(points) == 0:
        return np.zeros(0)
    p = np.asarray(points, np.float64)
    lo = np.clip(np.floor(p).astype(np.int64), 0,
                 np.array(vol.shape) - 2)
    f = np.clip(p - lo, 0.0, 1.0)
    out = np.zeros(len(p))
    for corner in range(8):
        d = np.array([(corner >> i) & 1 for i in range(3)])
        w = np.prod(np.where(d, f, 1.0 - f), axis=1)
        out += w * vol[tuple((lo + d).T)].astype(np.float64)
    return out
