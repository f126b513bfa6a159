"""Global tile relaxation on the device: four CUDA kernels, their plain-torch
twins, and the loop that drives them.

Port of the relax part of ``bigstitcher_spark_tpu/ops/solve.py``: the JAX
program ``_relax_core`` (one ``lax.while_loop``, jitted at :410) becomes four
hand-written ``sm_90a`` kernels in float64 (``csrc/solve.cu``), one
iteration being K11 -> K12 -> K13 -> K14, launched as three: K14 runs in
the last block of K13 (:func:`relax_error_converge`, the JAX program's
``mean_error`` and rules in one loop body as well):

=========================  =======================  ==============================
wrapper                    kernel (csrc/solve.cu)   step of ``_relax_core``
=========================  =======================  ==============================
:func:`relax_moments`      K11                      ``apply_batch`` + segment moments
:func:`relax_fit`          K12                      ``_fit_from_moments_jnp``, blend,
                                                    fixed / empty tiles, damping
:func:`relax_error`        K13                      ``mean_error`` partial sums; the
                                                    per-link errors (``by_link``)
:func:`relax_converge`     K14                      error history, stall / plateau /
                                                    max-iterations rules
=========================  =======================  ==============================

:func:`relax_on_device` launches iterations in chunks and reads 16 bytes of
state once per chunk, so there is no per-iteration host transfer, as in the
``while_loop``. :func:`relax_plain` runs the same loop through the twins. A
wrapper takes its plain version only because its tensors lie on the CPU; on
CUDA tensors it launches its kernel or raises. Each wrapper counts its
kernel launches in its ``launches`` attribute.

Rows are grouped by owner tile (``prepare_relax``), so each tile's sums have
one fixed order on the card (no atomics): a rerun repeats bit for bit. The
twins sum with ``torch.segment_reduce`` over the same groups, which is
deterministic on the card too.

One change of formulation against the JAX program: each tile's moments are
taken about the tile's own origin (:func:`tile_origin`, the mean of its
active rows' points, fixed for a solve), and the fit is shifted back to
world coordinates. The JAX program sums about the world origin: at a grid of
2048-pixel tiles the points lie ~30,000 px out, and the 4x4 normal
equations of an AFFINE fit reach condition numbers of 1e11-1e13, so a
different summation order alone moves a fitted translation by ~1e-4
relative (the JAX package's own numpy and device paths disagree there by
the same amount). About the tile's origin the same fits are exact in real
arithmetic (the AFFINE fit's 1e-9 ridge is carried to the tile's origin
with it, :func:`ridge_terms`) and well conditioned.

The sharded relaxation (the JAX ``shard_map`` program of
``_build_relax_fn``, :428) runs when :func:`solve_layout` says so
(``BST_SOLVE_SHARD`` point rows and a mesh of more than one device): the
rows are split by owner tile over the shards (:class:`ShardedRelaxProblem`),
each shard runs K11 and K13 on its own rows with every tile's entry (zeros
for the tiles it does not own), and K12 and K14, once a distinct device of
the mesh on the replicated state, add the shards' moments and error sums
as they load them, in the order of the shard sum K29 (``ops/shard.py``, the
``lax.psum``), which adds the tile origins and the link errors. The
sharded result is bitwise the one-device one. The intensity CG shards the same way
(:class:`ShardedCGSystem`, ``shard_map`` at :600). A mesh that spans several
processes (the JAX package's ``BST_SOLVE_GLOBAL``) and the compile-bucket
telemetry are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import contextlib
import functools
import time
from collections import namedtuple
from dataclasses import dataclass

import numpy as np
import torch

from .. import config
from . import _cuda
from . import models as M
from .fusion import _require, _stream
from .shard import check_parts, part_pointers, shard_sum, shard_sum_plain

_EPS_FIT = 1e-9
N_MOMENTS = 36
# csrc/solve.cu's Model codes; NONE only as a regulariser
_KIND = {M.NONE: -1, M.IDENTITY: 0, M.TRANSLATION: 1, M.RIGID: 2,
         M.AFFINE: 3}
_F64 = (torch.float64,)
_I32 = (torch.int32,)
# iterations per chunk between two reads of the state: 8, doubling to 64
FIRST_CHUNK, MAX_CHUNK = 8, 64


def resolve_backend(explicit: str | None = None) -> str:
    """``device`` (the relax kernels on the torch device, the default) or
    ``numpy`` (the host reference path): an explicit request wins, else the
    ``BST_SOLVE_DEVICE`` knob."""
    if explicit:
        return explicit.lower()
    return "device" if config.get("BST_SOLVE_DEVICE") else "numpy"


def solve_mesh(device=None, devices=None) -> list[torch.device]:
    """The 1-D solve mesh: ``devices`` (repeats allowed, e.g. ``["cpu"] *
    4``), else every card of the host for a CUDA ``device`` (the JAX
    package's local devices; ``device`` first), else ``[device]``. A solve
    that does not shard runs on ``mesh[0]``."""
    from ..utils.device import resolve_device

    if devices is not None:
        mesh = [resolve_device(d) for d in devices]
        if not mesh:
            raise ValueError("an empty solve mesh")
        return mesh
    dev = resolve_device(device)
    if dev.type == "cuda":
        return [dev] + [torch.device("cuda", i)
                        for i in range(torch.cuda.device_count())
                        if i != dev.index]
    return [dev]


def solve_layout(n_rows: int, mesh: list) -> int:
    """Shard count of a solve of ``n_rows`` point rows on ``mesh``: above
    the ``BST_SOLVE_SHARD`` threshold (0 = never) the links axis spans
    every device of the mesh; else one device. Shared by the relax and CG
    layouts."""
    thr = config.get("BST_SOLVE_SHARD") or 0
    if thr > 0 and n_rows >= thr and len(mesh) > 1:
        return len(mesh)
    return 1


# ---------------------------------------------------------------------------
# problem layout
# ---------------------------------------------------------------------------


@dataclass
class RelaxProblem:
    """The flattened link graph on one device, built once per link list;
    every solve, masked re-solves included, reuses it.

    Every point match appears twice (once per side, like the numpy
    ``_flatten``); rows are grouped by owner tile, in flattened order within
    each tile."""

    n_tiles: int              # T
    n_links: int              # L
    n_rows: int               # N (both sides)
    local: torch.Tensor       # (N, 3) f64
    target: torch.Tensor      # (N, 3) f64
    own: torch.Tensor         # (N,) int32 owner tile (non-decreasing)
    other: torch.Tensor       # (N,) int32 counterpart tile
    w: torch.Tensor           # (N,) f64 row weight
    link_id: torch.Tensor     # (N,) int32
    tile_ptr: torch.Tensor    # (T + 1,) int32 CSR of the tile groups
    tile_len: torch.Tensor    # (T,) int64 rows per tile
    link_rows: torch.Tensor   # (N / 2,) int32 A-side rows, grouped by link
    link_ptr: torch.Tensor    # (L + 1,) int32
    link_len: torch.Tensor    # (L,) int64
    link_own: torch.Tensor    # (L,) int32 the A tile of each link
    wpt_tile: int             # warps a K11 / K13 tile segment takes
    wpt_link: int             # warps a K13 link segment takes

    @property
    def device(self) -> torch.device:
        return self.local.device


def _warps_per_segment(rows: int, segments: int) -> int:
    """1, 2, 4 or 8 warps: about 256 rows a warp on average."""
    avg = rows / max(segments, 1)
    wpt = 1
    while wpt < 8 and avg >= 256 * 2 * wpt:
        wpt *= 2
    return wpt


@dataclass
class ShardedRelaxProblem:
    """The link graph split over the shards of a solve mesh (the JAX
    package's sharded ``RelaxProblem``): shard d holds the rows of the
    tiles placed on it (:func:`prepare_relax`), in single-device order, as a
    :class:`RelaxProblem` with every tile's and every link's entry, on
    ``mesh[d]``. Each shard takes the one-device layout's warps a segment,
    so K11 and K13 sum a tile's rows in the one-device order."""

    n_tiles: int
    n_links: int
    n_rows: int               # both sides, all shards
    shards: list[RelaxProblem]

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    @property
    def mesh(self) -> list[torch.device]:
        return [sh.device for sh in self.shards]

    @property
    def device(self) -> torch.device:
        return self.shards[0].device


def distinct_devices(mesh) -> list[torch.device]:
    """The mesh's devices, each once, in order of first appearance."""
    out: list[torch.device] = []
    for d in mesh:
        if d not in out:
            out.append(d)
    return out


def _guard(multi: bool):
    """``dev -> context``: the CUDA device's context where the mesh spans
    several cards (a kernel launches on the current device's streams),
    else nothing."""
    def on(dev):
        if multi and dev.type == "cuda":
            return torch.cuda.device(dev)
        return contextlib.nullcontext()
    return on


def prepare_relax(
    link_rows: list[tuple[int, int, np.ndarray, np.ndarray, np.ndarray]],
    n_tiles: int,
    device: torch.device | str,
    n_shards: int = 1,
    tile_shard: np.ndarray | None = None,
    mesh: list | None = None,
) -> RelaxProblem | ShardedRelaxProblem:
    """Flatten ``(ia, ib, p, q, w)`` links into device arrays grouped by
    owner tile (a stable sort of the flattened rows).

    With ``n_shards > 1``, ``tile_shard`` (T,) assigns each tile's rows to
    a shard (default ``arange(T) % n_shards``, the JAX package's; the
    solver places tiles cost-weighted with ``pairsched.assign_tasks``) and
    shard d lies on ``mesh[d]`` (default: ``device`` for every shard)."""
    loc, tgt, own, other, w, lid, side = [], [], [], [], [], [], []
    for l, (ia, ib, p, q, wl) in enumerate(link_rows):
        n = len(p)
        loc.append(p); tgt.append(q)
        own.append(np.full(n, ia)); other.append(np.full(n, ib))
        w.append(wl); lid.append(np.full(n, l)); side.append(np.ones(n, bool))
        loc.append(q); tgt.append(p)
        own.append(np.full(n, ib)); other.append(np.full(n, ia))
        w.append(wl); lid.append(np.full(n, l)); side.append(np.zeros(n, bool))
    rows = [np.concatenate(a) for a in (loc, tgt, own, other, w, lid, side)]
    L = len(link_rows)
    if n_shards <= 1:
        return _layout(*rows, n_tiles, L, device)
    if mesh is None:
        mesh = [device] * n_shards
    if len(mesh) != n_shards:
        raise ValueError(f"{n_shards} shards on a mesh of {len(mesh)}")
    if tile_shard is None:
        tile_shard = np.arange(n_tiles) % n_shards
    tile_shard = np.asarray(tile_shard, np.int64)
    n_rows = len(rows[0])
    # the one-device layout's warps a segment (K11 / K13 sum a segment's
    # rows in an order that depends on them)
    wpt = (_warps_per_segment(n_rows, n_tiles),
           _warps_per_segment(n_rows // 2, L))
    row_shard = tile_shard[rows[2].astype(np.int64)]
    shards = []
    for d in range(n_shards):
        sel = row_shard == d  # stable: single-device row order
        shards.append(_layout(*(a[sel] for a in rows), n_tiles, L, mesh[d],
                              wpt))
    return ShardedRelaxProblem(n_tiles, L, n_rows, shards)


def relax_problem_from_reference(fields: dict, device: torch.device | str
                                 ) -> RelaxProblem:
    """The port's problem from the JAX package's ``RelaxProblem`` arrays
    (a single-device layout, as numpy: ``n_tiles``, ``n_links``,
    ``n_rows``, ``local``, ``target``, ``own``, ``other``, ``w``,
    ``link_id``, ``side_a``; the bucket padding past ``n_rows`` is
    dropped), so one graph feeds both packages."""
    n = int(fields["n_rows"])
    rows = [np.asarray(fields[k])[:n] for k in ("local", "target", "own",
                                               "other", "w", "link_id")]
    side = np.asarray(fields["side_a"])[:n] > 0
    return _layout(*rows, side, int(fields["n_tiles"]),
                   int(fields["n_links"]), device)


def _layout(local, target, own, other, w, link_id, side, n_tiles: int,
            n_links: int, device, wpt: tuple[int, int] | None = None
            ) -> RelaxProblem:
    """Rows in flattened order -> the device layout: grouped by owner tile
    (stable), the tile CSR, and the CSR of each link's A-side rows.
    ``wpt``: the (tile, link) warps a segment, else chosen from the rows."""
    own_a = np.asarray(own).astype(np.int32)
    order = np.argsort(own_a, kind="stable")
    local = np.asarray(local, np.float64).reshape(-1, 3)[order]
    target = np.asarray(target, np.float64).reshape(-1, 3)[order]
    other_a = np.asarray(other).astype(np.int32)[order]
    w_a = np.asarray(w, np.float64)[order]
    lid_a = np.asarray(link_id).astype(np.int32)[order]
    side_a = np.asarray(side, bool)[order]
    own_a = own_a[order]
    n_rows = len(local)
    if n_rows >= 2 ** 31:
        raise ValueError(f"{n_rows} rows: the relax kernels index rows "
                         "with int32")
    tile_len = np.bincount(own_a, minlength=n_tiles)
    a_rows = np.flatnonzero(side_a)
    a_rows = a_rows[np.argsort(lid_a[a_rows], kind="stable")]
    link_len = np.bincount(lid_a[a_rows], minlength=n_links)
    link_own = np.zeros(n_links, np.int32)
    link_own[lid_a[a_rows]] = own_a[a_rows]

    def ptr(lengths):
        return np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    if wpt is None:
        wpt = (_warps_per_segment(n_rows, n_tiles),
               _warps_per_segment(len(a_rows), n_links))
    return RelaxProblem(
        n_tiles, n_links, n_rows, dev(local), dev(target), dev(own_a),
        dev(other_a), dev(w_a), dev(lid_a), dev(ptr(tile_len)),
        dev(tile_len.astype(np.int64)), dev(a_rows.astype(np.int32)),
        dev(ptr(link_len)), dev(link_len.astype(np.int64)), dev(link_own),
        *wpt)


def _finished(state: torch.Tensor | None) -> bool:
    return state is not None and bool(state[2])


def _apply_rows(m: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Per-row models (R, 3, 4) applied to points (R, 3), in the kernels'
    order: ((m0 x0 + m1 x1) + m2 x2) + m3."""
    return (((m[:, :, 0] * x[:, 0:1] + m[:, :, 1] * x[:, 1:2])
             + m[:, :, 2] * x[:, 2:3]) + m[:, :, 3])


def _w_eff(pr: RelaxProblem, link_w: torch.Tensor) -> torch.Tensor:
    return pr.w * link_w[pr.link_id.long()]


def tile_origin(pr: RelaxProblem, link_w: torch.Tensor) -> torch.Tensor:
    """Each tile's moment origin (T, 3): the mean of the local points of its
    rows whose link weight is nonzero (0 for a tile without any). Masked
    rows add exact zeros, so a masked solve and a solve of the rebuilt link
    list take the same origin. Plain torch, once per solve."""
    act = (link_w[pr.link_id.long()] != 0).to(pr.local.dtype)
    s = torch.segment_reduce(pr.local * act[:, None], "sum",
                             lengths=pr.tile_len, axis=0)
    n = torch.segment_reduce(act, "sum", lengths=pr.tile_len, axis=0)
    return (s / torch.clamp(n, min=1.0)[:, None]).contiguous()


# ---------------------------------------------------------------------------
# K11: per-tile moments
# ---------------------------------------------------------------------------


def relax_moments_plain(pr: RelaxProblem, cur: torch.Tensor,
                        link_w: torch.Tensor, origin: torch.Tensor,
                        state: torch.Tensor | None = None,
                        out: torch.Tensor | None = None) -> torch.Tensor:
    """Per-tile moments (T, 36) under the models ``cur`` (T, 3, 4): sw, swp
    (4), swq (3), spp (4x4 row-major), spq (4x3) of w_eff, w_eff [p;1],
    w_eff tw, (w_eff [p;1]) [p;1]^T and (w_eff [p;1]) tw^T, with tw =
    M_other [q;1] - o and p the local point - o, o the tile's ``origin``.
    Returns ``out`` untouched once ``state`` says done."""
    if _finished(state):
        return out
    we = _w_eff(pr, link_w)
    o = origin[pr.own.long()]
    tw = _apply_rows(cur[pr.other.long()], pr.target) - o
    ph = torch.cat([pr.local - o, torch.ones_like(pr.local[:, :1])], dim=1)
    wp = we[:, None] * ph
    n = pr.n_rows
    rows = torch.cat([we[:, None], wp, we[:, None] * tw,
                      (wp[:, :, None] * ph[:, None, :]).reshape(n, 16),
                      (wp[:, :, None] * tw[:, None, :]).reshape(n, 12)], dim=1)
    mom = torch.segment_reduce(rows, "sum", lengths=pr.tile_len, axis=0)
    if out is None:
        return mom
    return out.copy_(mom)


def moment_scale(pr: RelaxProblem, cur: torch.Tensor, link_w: torch.Tensor,
                 origin: torch.Tensor) -> torch.Tensor:
    """The sum of the absolute values of the terms of each moment (T, 36):
    the scale a summation error is measured against. Moments about a
    tile's origin cancel (the first moments are ~0 by construction), so an
    elementwise relative tolerance would measure the rounding of terms of
    1e6 against a result of 1e-3."""
    we = _w_eff(pr, link_w)
    o = origin[pr.own.long()]
    tw = (_apply_rows(cur[pr.other.long()], pr.target) - o).abs()
    ph = torch.cat([(pr.local - o).abs(), torch.ones_like(pr.local[:, :1])],
                   dim=1)
    wp = we[:, None] * ph
    n = pr.n_rows
    rows = torch.cat([we[:, None], wp, we[:, None] * tw,
                      (wp[:, :, None] * ph[:, None, :]).reshape(n, 16),
                      (wp[:, :, None] * tw[:, None, :]).reshape(n, 12)], dim=1)
    return torch.segment_reduce(rows, "sum", lengths=pr.tile_len, axis=0)


def fit_scale(models: torch.Tensor, origin: torch.Tensor) -> torch.Tensor:
    """The magnitude of the terms of each world-frame model entry (T, 3, 4):
    |entry| for the linear part; for the translation, t = (t' + o) - A o
    also sums |o| and |A| |o| (at 30,000 px from the world origin a
    1e-14 change of A moves t by 3e-10)."""
    a = models[:, :, :3].abs()
    lever = origin.abs() + (a * origin.abs()[:, None, :]).sum(dim=2)
    return torch.cat([a, (models[:, :, 3].abs() + lever)[:, :, None]], dim=2)


def relax_moments(pr: RelaxProblem, cur: torch.Tensor, link_w: torch.Tensor,
                  origin: torch.Tensor, state: torch.Tensor | None = None,
                  out: torch.Tensor | None = None) -> torch.Tensor:
    """K11 (``csrc/solve.cu``) on CUDA, :func:`relax_moments_plain` on the
    CPU."""
    if cur.device.type == "cpu":
        return relax_moments_plain(pr, cur, link_w, origin, state, out)
    dev, T = cur.device, pr.n_tiles
    _require(cur, "cur", dev, _F64, (T, 3, 4))
    _require(link_w, "link_w", dev, _F64, (pr.n_links,))
    _require(origin, "origin", dev, _F64, (T, 3))
    if out is None:
        out = torch.empty((T, N_MOMENTS), dtype=torch.float64, device=dev)
    _require(out, "out", dev, _F64, (T, N_MOMENTS))
    lib = _cuda.load("solve")
    ret = lib.bst_relax_moments(
        pr.local.data_ptr(), pr.target.data_ptr(), pr.other.data_ptr(),
        pr.w.data_ptr(), pr.link_id.data_ptr(), link_w.data_ptr(),
        pr.tile_ptr.data_ptr(), origin.data_ptr(), T, pr.wpt_tile,
        cur.data_ptr(), _ptr(state), out.data_ptr(), _stream(dev))
    _cuda.check(lib, ret, "relax_moments")
    relax_moments.launches += 1
    return out


relax_moments.launches = 0


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


# ---------------------------------------------------------------------------
# K12: per-tile fits, blend, damped update
# ---------------------------------------------------------------------------


def ridge_terms(origin: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The AFFINE fit's ``eps`` ridge about each tile's origin o: the JAX
    program solves (spp + eps I) X = spq about the world origin; about o
    (ph' = C ph, C = [[I, -o], [0, 1]]) the same solution solves
    (spp' + eps C C^T) X' = spq' + eps D, D = [[o o^T], [-o^T]]. Returns
    (C C^T (T, 4, 4), D (T, 4, 3)); o = 0 gives (I, 0)."""
    T = origin.shape[0]
    oo = origin[:, :, None] * origin[:, None, :]
    cc = torch.zeros((T, 4, 4), dtype=origin.dtype, device=origin.device)
    cc[:, :3, :3] = torch.eye(3, dtype=origin.dtype, device=origin.device) + oo
    cc[:, :3, 3] = -origin
    cc[:, 3, :3] = -origin
    cc[:, 3, 3] = 1.0
    return cc, torch.cat([oo, -origin[:, None, :]], dim=1)


def fit_from_moments_plain(kind: str, mom: torch.Tensor,
                           eps: float = _EPS_FIT,
                           origin: torch.Tensor | None = None
                           ) -> torch.Tensor:
    """Batched per-tile model fit (T, 3, 4) from moments (T, 36): the torch
    form of the JAX package's ``_fit_from_moments_jnp``. With ``origin``
    (moments taken about each tile's o), the AFFINE ridge is the JAX
    program's carried to o (:func:`ridge_terms`); the fit stays about o."""
    T = mom.shape[0]
    sw, swp, swq = mom[:, 0], mom[:, 1:5], mom[:, 5:8]
    spp = mom[:, 8:24].reshape(T, 4, 4)
    spq = mom[:, 24:36].reshape(T, 4, 3)
    sw_safe = torch.clamp(sw, min=eps)
    identity = torch.zeros((T, 3, 4), dtype=mom.dtype, device=mom.device)
    identity[:, :, :3] = torch.eye(3, dtype=mom.dtype, device=mom.device)
    if kind == M.IDENTITY:
        return identity
    if kind == M.TRANSLATION:
        identity[:, :, 3] = (swq - swp[:, :3]) / sw_safe[:, None]
        return identity
    if kind == M.AFFINE:
        if origin is None:
            a = spp + eps * torch.eye(4, dtype=mom.dtype, device=mom.device)
            return torch.linalg.solve(a, spq).transpose(1, 2)
        cc, d = ridge_terms(origin)
        return torch.linalg.solve(spp + eps * cc,
                                  spq + eps * d).transpose(1, 2)
    if kind == M.RIGID:
        pc = swp[:, :3] / sw_safe[:, None]
        qc = swq / sw_safe[:, None]
        h = (spq[:, :3, :]
             - pc[:, :, None] * swq[:, None, :]
             - swp[:, :3, None] * qc[:, None, :]
             + sw_safe[:, None, None] * pc[:, :, None] * qc[:, None, :])
        u, _, vt = torch.linalg.svd(h)
        d = torch.linalg.det(vt.transpose(1, 2) @ u.transpose(1, 2))
        sign = torch.stack([torch.ones_like(d), torch.ones_like(d), d], dim=1)
        r = vt.transpose(1, 2) @ (sign[:, :, None] * u.transpose(1, 2))
        t = qc - torch.einsum("nij,nj->ni", r, pc)
        return torch.cat([r, t[:, :, None]], dim=2)
    raise ValueError(kind)


def unshift_plain(m: torch.Tensor, origin: torch.Tensor) -> torch.Tensor:
    """Models fitted about each tile's origin o -> world coordinates:
    t = (t' + o) - A o, in K12's order."""
    a = m[:, :, :3]
    ao = ((a[:, :, 0] * origin[:, 0:1] + a[:, :, 1] * origin[:, 1:2])
          + a[:, :, 2] * origin[:, 2:3])
    return torch.cat([a, ((m[:, :, 3] + origin) - ao)[:, :, None]], dim=2)


def _folded(parts, dev: torch.device) -> torch.Tensor:
    """A tensor as it is; a sequence of the shards' partials summed on
    ``dev`` in K29's order (:func:`shard_sum_plain`), as the sharded forms
    of K12 and K14 add them as they load them."""
    if isinstance(parts, torch.Tensor):
        return parts
    return shard_sum_plain(parts, torch.empty(
        parts[0].shape, dtype=torch.float64, device=dev))


def relax_fit_plain(mom, fixed: torch.Tensor, origin: torch.Tensor,
                    model: str, reg: str, lam: float, damping: float,
                    state: torch.Tensor | None,
                    cur: torch.Tensor) -> torch.Tensor:
    """The models fitted to the moments (taken about ``origin`` (T, 3);
    ``mom`` (T, 36), or the shards' partials of them, summed first),
    blended with the regulariser's ((1 - lam) m + lam r unless ``reg`` is
    NONE) and shifted back to world coordinates; identity where sw <= 0 or
    ``fixed`` (T,) uint8 is set; then ``cur = (1 - damping) cur + damping
    new`` in place."""
    if _finished(state):
        return cur
    mom = _folded(mom, cur.device)
    new = fit_from_moments_plain(model, mom, origin=origin)
    if reg != M.NONE:
        new = ((1 - lam) * new
               + lam * fit_from_moments_plain(reg, mom, origin=origin))
    new = unshift_plain(new, origin)
    keep = (mom[:, 0] <= 0) | fixed.bool()
    new = torch.where(keep[:, None, None],
                      fit_from_moments_plain(M.IDENTITY, mom), new)
    return cur.copy_((1 - damping) * cur + damping * new)


# K12's compiled (model, regulariser) pairs: each model with each regulariser
FIT_MODELS = (M.IDENTITY, M.TRANSLATION, M.RIGID, M.AFFINE)
FIT_REGS = (M.NONE,) + FIT_MODELS


def fit_pair(model: str, reg: str) -> tuple[int, int]:
    """K12's instantiation for a (model, regulariser) pair: the codes its
    launcher dispatches on (``csrc/solve.cu`` bst_relax_fit)."""
    if model == M.NONE:
        raise ValueError("NONE is a regulariser, not a model")
    if model not in FIT_MODELS or reg not in FIT_REGS:
        raise ValueError(f"no relax fit for model {model!r} regularised by "
                         f"{reg!r}")
    return _KIND[model], _KIND[reg]


def relax_fit(mom, fixed: torch.Tensor, origin: torch.Tensor, model: str,
              reg: str, lam: float, damping: float,
              state: torch.Tensor | None, cur: torch.Tensor) -> torch.Tensor:
    """K12 (``csrc/solve.cu``) on CUDA, :func:`relax_fit_plain` on the CPU;
    updates ``cur`` in place. ``mom``: the (T, 36) moments, or a sequence
    of the S shards' partials of them (the sharded form: each moment their
    sum in K29's order, taken as K12 loads it; partials on other devices
    are copied to ``cur``'s first)."""
    if cur.device.type == "cpu":
        return relax_fit_plain(mom, fixed, origin, model, reg, lam, damping,
                               state, cur)
    dev, T = cur.device, int(cur.shape[0])
    model_code, reg_code = fit_pair(model, reg)
    if isinstance(mom, torch.Tensor):
        _require(mom, "moments", dev, _F64, (T, N_MOMENTS))
        dense, parts, ptrs, S = mom.data_ptr(), (), None, 0
    else:
        check_parts(mom, T * N_MOMENTS, dev)
        parts, ptrs = part_pointers(mom, dev)
        dense, S = None, len(parts)
    _require(fixed, "fixed", dev, (torch.uint8,), (T,))
    _require(origin, "origin", dev, _F64, (T, 3))
    _require(cur, "cur", dev, _F64, (T, 3, 4))
    lib = _cuda.load("solve")
    ret = lib.bst_relax_fit(dense, ptrs, S, fixed.data_ptr(),
                            origin.data_ptr(), T, model_code, reg_code,
                            float(lam), float(damping),
                            _ptr(state), cur.data_ptr(), _stream(dev))
    _cuda.check(lib, ret, "relax_fit")
    relax_fit.launches += 1
    return cur


relax_fit.launches = 0


# ---------------------------------------------------------------------------
# K13: weighted displacement sums per tile, or per link
# ---------------------------------------------------------------------------


def relax_error_plain(pr: RelaxProblem, cur: torch.Tensor,
                      link_w: torch.Tensor,
                      state: torch.Tensor | None = None,
                      by_link: bool = False, out=None):
    """(num, den): sums of ||M_own p - M_other q|| w_eff and of w_eff over
    each tile's rows, or with ``by_link`` over each link's A-side rows.
    Returns ``out`` untouched once ``state`` says done."""
    if _finished(state):
        return out
    if by_link:
        rows, lengths = pr.link_rows.long(), pr.link_len
        own = pr.own.long()[rows]
    else:
        rows, own, lengths = None, pr.own.long(), pr.tile_len

    def pick(t):
        return t if rows is None else t[rows]

    we = _w_eff(pr, link_w)
    a = _apply_rows(cur[own], pick(pr.local))
    b = _apply_rows(cur[pick(pr.other).long()], pick(pr.target))
    dd = a - b
    d = torch.sqrt((dd[:, 0] * dd[:, 0] + dd[:, 1] * dd[:, 1])
                   + dd[:, 2] * dd[:, 2])
    we = pick(we)
    sums = torch.segment_reduce(torch.stack([d * we, we], dim=1), "sum",
                                lengths=lengths, axis=0)
    num, den = sums[:, 0].contiguous(), sums[:, 1].contiguous()
    if out is None:
        return num, den
    out[0].copy_(num)
    out[1].copy_(den)
    return out


def relax_error(pr: RelaxProblem, cur: torch.Tensor, link_w: torch.Tensor,
                state: torch.Tensor | None = None, by_link: bool = False,
                out=None):
    """K13 (``csrc/solve.cu``) on CUDA, :func:`relax_error_plain` on the
    CPU; ``out`` an optional (num, den) pair to write."""
    if cur.device.type == "cpu":
        return relax_error_plain(pr, cur, link_w, state, by_link, out)
    dev = cur.device
    _require(cur, "cur", dev, _F64, (pr.n_tiles, 3, 4))
    _require(link_w, "link_w", dev, _F64, (pr.n_links,))
    S = pr.n_links if by_link else pr.n_tiles
    if out is None:
        out = (torch.empty(S, dtype=torch.float64, device=dev),
               torch.empty(S, dtype=torch.float64, device=dev))
    for t, name in zip(out, ("num", "den")):
        _require(t, name, dev, _F64, (S,))
    if by_link:
        ptr, idx, seg_own, wpt = (pr.link_ptr, pr.link_rows.data_ptr(),
                                  pr.link_own.data_ptr(), pr.wpt_link)
    else:
        ptr, idx, seg_own, wpt = pr.tile_ptr, None, None, pr.wpt_tile
    lib = _cuda.load("solve")
    ret = lib.bst_relax_error(
        pr.local.data_ptr(), pr.target.data_ptr(), pr.other.data_ptr(),
        pr.w.data_ptr(), pr.link_id.data_ptr(), link_w.data_ptr(),
        ptr.data_ptr(), idx, seg_own, S, wpt, cur.data_ptr(), _ptr(state),
        out[0].data_ptr(), out[1].data_ptr(), _stream(dev))
    _cuda.check(lib, ret, "relax_error")
    relax_error.launches += 1
    return out


relax_error.launches = 0


# ---------------------------------------------------------------------------
# K14: error history and the convergence rules; K13 + K14 in one launch
# ---------------------------------------------------------------------------


def relax_converge_plain(num, den, hist: torch.Tensor, state: torch.Tensor,
                         pw: int, max_error: float,
                         max_iter: int) -> torch.Tensor:
    """err = sum(num) / max(sum(den), 1e-12) into ``hist[i]``, then
    ``_relax_core``'s stall, plateau and max-iterations rules on ``state``
    (int32: iterations, stall count, done, 0), in place. ``num`` and
    ``den`` (T,), or the shards' partials of them, summed first."""
    if _finished(state):
        return state
    num, den = _folded(num, hist.device), _folded(den, hist.device)
    i = int(state[0])
    it = i + 1
    err_t = num.sum() / torch.clamp(den.sum(), min=1e-12)
    hist[i] = err_t
    err = float(err_t)
    stall = int(state[1])
    if i > 0:
        stall = stall + 1 if float(hist[i - 1]) - err < 1e-9 * max(err, 1.0) \
            else 0
    plateau = False
    if it > pw and err < max_error:
        improvement = float(hist[it - pw - 1]) - float(hist[it - pw:it].min())
        plateau = improvement < 1e-4 * max(err, 1e-12) or err < 1e-9
    done = stall >= 5 or plateau or it >= max_iter
    state.copy_(torch.tensor([it, stall, int(done), 0], dtype=torch.int32))
    return state


def _check_converge(hist, state, dev, pw, max_iter):
    _require(hist, "hist", dev, _F64)
    _require(state, "state", dev, _I32, (4,))
    if int(hist.shape[0]) < max_iter:
        raise ValueError(f"hist holds {int(hist.shape[0])} < {max_iter} "
                         "iterations")


def relax_converge(num, den, hist: torch.Tensor, state: torch.Tensor,
                   pw: int, max_error: float, max_iter: int) -> torch.Tensor:
    """K14 (``csrc/solve.cu``) on CUDA, :func:`relax_converge_plain` on the
    CPU. ``num`` and ``den``: the (T,) error sums, or sequences of the S
    shards' partials of them (the sharded relax: each tile's sums added in
    K29's order as K14 loads them; partials on other devices are copied to
    ``hist``'s first)."""
    if hist.device.type == "cpu":
        return relax_converge_plain(num, den, hist, state, pw, max_error,
                                    max_iter)
    dev = hist.device
    if isinstance(num, torch.Tensor):
        num, den = [num], [den]
    T = int(num[0].numel())
    if len(den) != len(num):
        raise ValueError(f"{len(num)} num partials, {len(den)} den")
    check_parts(num, T, dev)
    check_parts(den, T, dev)
    _check_converge(hist, state, dev, pw, max_iter)
    nums, num_ptrs = part_pointers(num, dev)
    dens, den_ptrs = part_pointers(den, dev)
    lib = _cuda.load("solve")
    ret = lib.bst_relax_converge(num_ptrs, den_ptrs, len(nums), T,
                                 hist.data_ptr(), int(pw), float(max_error),
                                 int(max_iter), state.data_ptr(), _stream(dev))
    _cuda.check(lib, ret, "relax_converge")
    relax_converge.launches += 1
    return state


relax_converge.launches = 0


def relax_error_converge_plain(pr: RelaxProblem, cur: torch.Tensor,
                               link_w: torch.Tensor, state: torch.Tensor,
                               out, hist: torch.Tensor,
                               ticket: torch.Tensor | None, pw: int,
                               max_error: float,
                               max_iter: int) -> torch.Tensor:
    """:func:`relax_error_plain` over the tiles into ``out`` (num, den),
    then :func:`relax_converge_plain`; ``ticket`` is the kernel's and
    unused here."""
    relax_error_plain(pr, cur, link_w, state, out=out)
    return relax_converge_plain(out[0], out[1], hist, state, pw, max_error,
                                max_iter)


def relax_error_converge(pr: RelaxProblem, cur: torch.Tensor,
                         link_w: torch.Tensor, state: torch.Tensor, out,
                         hist: torch.Tensor, ticket: torch.Tensor | None,
                         pw: int, max_error: float,
                         max_iter: int) -> torch.Tensor:
    """K13 over the tiles with K14 in its last block (``csrc/solve.cu``
    error_converge_kernel) on CUDA: one launch writes ``out`` (num, den) and
    the history and state, bitwise K13 then K14;
    :func:`relax_error_converge_plain` on the CPU. ``ticket``: one int32
    that is 0 (the launch leaves it 0)."""
    if cur.device.type == "cpu":
        return relax_error_converge_plain(pr, cur, link_w, state, out, hist,
                                          ticket, pw, max_error, max_iter)
    dev, T = cur.device, pr.n_tiles
    _require(cur, "cur", dev, _F64, (T, 3, 4))
    _require(link_w, "link_w", dev, _F64, (pr.n_links,))
    for t, name in zip(out, ("num", "den")):
        _require(t, name, dev, _F64, (T,))
    if ticket is None:
        raise ValueError("K13 + K14 takes a ticket: one int32 that is 0")
    _require(ticket, "ticket", dev, _I32, (1,))
    _check_converge(hist, state, dev, pw, max_iter)
    lib = _cuda.load("solve")
    ret = lib.bst_relax_error_converge(
        pr.local.data_ptr(), pr.target.data_ptr(), pr.other.data_ptr(),
        pr.w.data_ptr(), pr.link_id.data_ptr(), link_w.data_ptr(),
        pr.tile_ptr.data_ptr(), T, pr.wpt_tile, cur.data_ptr(),
        state.data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
        hist.data_ptr(), int(pw), float(max_error), int(max_iter),
        ticket.data_ptr(), _stream(dev))
    _cuda.check(lib, ret, "relax_error_converge")
    relax_error_converge.launches += 1
    return state


relax_error_converge.launches = 0


KERNEL_WRAPPERS = {
    "relax_moments": relax_moments,
    "relax_fit": relax_fit,
    "relax_error": relax_error,
    "relax_converge": relax_converge,
    "relax_error_converge": relax_error_converge,
}
# a relaxation's functions (:class:`RelaxRun`): the kernels, or the twins
_RelaxFns = namedtuple("_RelaxFns",
                       "moments fit error converge shard_sum error_converge")
PLAIN = _RelaxFns(relax_moments_plain, relax_fit_plain, relax_error_plain,
                  relax_converge_plain, shard_sum_plain,
                  relax_error_converge_plain)
KERNELS = _RelaxFns(relax_moments, relax_fit, relax_error, relax_converge,
                    shard_sum, relax_error_converge)


# ---------------------------------------------------------------------------
# the loop
# ---------------------------------------------------------------------------


@dataclass
class RelaxOutput:
    models: np.ndarray        # (T, 3, 4)
    history: np.ndarray       # (iterations,)
    iterations: int
    link_errors: np.ndarray   # (L,) under the final models (0 where masked)
    seconds: float = 0.0      # host wall of the sweeps' launches and reads
    card_seconds: float = 0.0  # CUDA events around each chunk's launches
    #                            (on the CPU: ``seconds``)


def relax_on_device(
    problem: RelaxProblem | ShardedRelaxProblem,
    link_mask: np.ndarray,
    fixed_mask: np.ndarray,
    warm_t: np.ndarray,
    lam: float,
    damping: float,
    max_error: float,
    max_iterations: int,
    model: str,
    reg: str,
    plateau_width: int,
) -> RelaxOutput:
    """Run the relaxation from identity models with translations ``warm_t``
    (T, 3): K11, K12 and K13 + K14 per iteration (their twins where the
    problem lies on the CPU), until K14 sets done. Iterations go in chunks
    of 8 doubling to 64 between two reads of the state; kernels launched
    after done return at once. A :class:`ShardedRelaxProblem` takes K11
    and K13 on each shard and the sharded forms of K12 and K14 to add
    their sums (:class:`RelaxRun`)."""
    return RelaxRun(KERNELS, problem, link_mask, fixed_mask, warm_t, lam,
                    damping, max_error, max_iterations, model, reg,
                    plateau_width).run()


def relax_plain(*args) -> RelaxOutput:
    """:func:`relax_on_device` through the plain twins, on any device."""
    return RelaxRun(PLAIN, *args).run()


class _Replica:
    """The replicated state of a relaxation on one device of the mesh:
    link weights, fixed tiles, models, history, K14's state, the moments
    and error sums (one device), the fused K13's ticket, the tiles'
    origins."""

    def __init__(self, dev, T, link_mask, fixed_mask, warm_t, max_iterations):
        f64 = dict(dtype=torch.float64, device=dev)
        self.link_w = torch.as_tensor(np.asarray(link_mask, np.float64), **f64)
        self.fixed = torch.as_tensor(
            np.asarray(fixed_mask, bool).astype(np.uint8), device=dev)
        self.cur = torch.zeros((T, 3, 4), **f64)
        self.cur[:, :, :3] = torch.eye(3, **f64)
        self.cur[:, :, 3] = torch.as_tensor(np.asarray(warm_t, np.float64),
                                            **f64)
        self.hist = torch.zeros(max(int(max_iterations), 1), **f64)
        self.state = torch.zeros(4, dtype=torch.int32, device=dev)
        self.done = self.state[2:3]
        self.mom = torch.empty((T, N_MOMENTS), **f64)
        self.nd = torch.empty((2, T), **f64)
        self.num, self.den = self.nd[0], self.nd[1]
        self.ticket = torch.zeros(1, dtype=torch.int32, device=dev)
        self.origin = None


class RelaxRun:
    """One relaxation through ``fns`` (K11-K14, K29 and K13 + K14,
    :data:`KERNELS`, or their twins, :data:`PLAIN`): its state and buffers,
    one :meth:`sweep` and the chunked loop :meth:`run`. One device: K11 ->
    K12 -> K13 + K14 a sweep, the three calls bound once (the loop is bound
    by the host's launch time). Sharded: K11 on each shard, K12 adding the
    shards' moments as it loads them, K13 on each shard, K14 adding the
    shards' error sums as it loads them; the replicated state (and K12,
    K14) once a distinct device of the mesh, the state read from the
    first. K29 adds the shards' tile origins once a solve and their link
    errors once at the end."""

    def __init__(self, fns, problem, link_mask, fixed_mask, warm_t, lam,
                 damping, max_error, max_iterations, model, reg,
                 plateau_width):
        if model == M.NONE:
            raise ValueError("NONE is a regulariser, not a model")
        if plateau_width < 1:
            raise ValueError(f"--maxPlateauwidth {plateau_width}: must be "
                             ">= 1")
        self.fns = fns
        self.sharded = isinstance(problem, ShardedRelaxProblem)
        self.shards = problem.shards if self.sharded else [problem]
        self.T, self.L = problem.n_tiles, problem.n_links
        self.args = (model, reg, lam, damping, plateau_width, max_error,
                     int(max_iterations))
        T = self.T
        self.reps = {dev: _Replica(dev, T, link_mask, fixed_mask, warm_t,
                                   max_iterations)
                     for dev in distinct_devices(
                         [sh.device for sh in self.shards])}
        self.first = self.reps[self.shards[0].device]
        self.on = _guard(len(self.reps) > 1)
        if self.sharded:
            f64 = [dict(dtype=torch.float64, device=sh.device)
                   for sh in self.shards]
            self.mom_out = [torch.empty((T, N_MOMENTS), **f) for f in f64]
            self.nd_out = [torch.empty((2, T), **f) for f in f64]
            self.num_out = [nd[0] for nd in self.nd_out]
            self.den_out = [nd[1] for nd in self.nd_out]
            origins = [tile_origin(sh, self.reps[sh.device].link_w)
                       for sh in self.shards]
            for dev, rp in self.reps.items():
                rp.origin = torch.empty((T, 3), dtype=torch.float64,
                                        device=dev)
                with self.on(dev):
                    fns.shard_sum(origins, rp.origin)
            self.calls = ()
        else:
            rp = self.first
            rp.origin = tile_origin(problem, rp.link_w)
            model, reg, lam, damping, pw, max_error, max_iter = self.args
            bind = functools.partial
            self.calls = (
                bind(fns.moments, problem, rp.cur, rp.link_w, rp.origin,
                     rp.state, out=rp.mom),
                bind(fns.fit, rp.mom, rp.fixed, rp.origin, model, reg, lam,
                     damping, rp.state, rp.cur),
                bind(fns.error_converge, problem, rp.cur, rp.link_w,
                     rp.state, (rp.num, rp.den), rp.hist, rp.ticket, pw,
                     max_error, max_iter))

    def sweep(self) -> None:
        """One iteration's launches (each returns at once after done)."""
        if self.calls:
            for call in self.calls:
                call()
            return
        fns = self.fns
        model, reg, lam, damping, pw, max_error, max_iter = self.args
        reps, on = self.reps.items(), self.on
        for sh, mom in zip(self.shards, self.mom_out):
            rp = self.reps[sh.device]
            with on(sh.device):
                fns.moments(sh, rp.cur, rp.link_w, rp.origin, rp.state,
                            out=mom)
        for dev, rp in reps:
            with on(dev):
                fns.fit(self.mom_out, rp.fixed, rp.origin, model, reg, lam,
                        damping, rp.state, rp.cur)
        for sh, num, den in zip(self.shards, self.num_out, self.den_out):
            rp = self.reps[sh.device]
            with on(sh.device):
                fns.error(sh, rp.cur, rp.link_w, rp.state, out=(num, den))
        for dev, rp in reps:
            with on(dev):
                fns.converge(self.num_out, self.den_out, rp.hist, rp.state,
                             pw, max_error, max_iter)

    def link_errors(self) -> torch.Tensor:
        """The per-link errors under the current models: K13 on each
        shard's A-side rows (a link's lie on its A tile's shard), then
        K29."""
        error_fn, sum_fn = self.fns.error, self.fns.shard_sum
        links = []
        for sh in self.shards:
            rp = self.reps[sh.device]
            nd = torch.empty((2, self.L), dtype=torch.float64,
                             device=sh.device)
            with self.on(sh.device):
                error_fn(sh, rp.cur, rp.link_w, None, by_link=True,
                         out=(nd[0], nd[1]))
            links.append(nd)
        nd = links[0]
        if self.sharded:
            dev = self.first.cur.device
            nd = torch.empty((2, self.L), dtype=torch.float64, device=dev)
            with self.on(dev):
                sum_fn(links, nd)
        return nd[0] / torch.clamp(nd[1], min=1e-12)

    def run(self) -> RelaxOutput:
        """Sweeps in chunks of 8 doubling to 64 between two reads of the
        first device's state, until done or the cap."""
        max_iterations = self.args[6]
        dev = self.first.cur.device
        stream = torch.cuda.current_stream(dev) if dev.type == "cuda" \
            else None
        events = []
        t0 = time.perf_counter()
        iters, chunk = 0, FIRST_CHUNK
        while max_iterations > 0:
            if stream is not None:
                events.append(torch.cuda.Event(enable_timing=True))
                events[-1].record(stream)
            for _ in range(min(chunk, max_iterations - iters)):
                self.sweep()
            if stream is not None:
                events.append(torch.cuda.Event(enable_timing=True))
                events[-1].record(stream)
            iters, _stall, done, _ = self.first.state.tolist()
            if done:
                break
            chunk = min(2 * chunk, MAX_CHUNK)
        secs = time.perf_counter() - t0
        card = (sum(a.elapsed_time(b)
                    for a, b in zip(events[::2], events[1::2])) / 1e3
                if events else secs)
        link_err = self.link_errors()
        return RelaxOutput(self.first.cur.cpu().numpy(),
                           self.first.hist[:iters].cpu().numpy(), iters,
                           link_err.cpu().numpy(), secs, card)


# ---------------------------------------------------------------------------
# intensity coefficient solve: conjugate gradients (K24, K25)
# ---------------------------------------------------------------------------
#
# The JAX program ``_build_cg_fn`` (ops/solve.py:527, jit :587) is one
# float64 ``while_loop`` of matrix-free CG. Here one iteration is two
# launches on one stream:
#   K24 cg_spmv    p <- r + beta p (into the other buffer of a pair) and
#                  Ap = A p from fixed-order per-unknown lists (CSR); the
#                  last block sums the per-block partials of p.Ap
#   K25 cg_update  alpha = rs / p.Ap, x += alpha p, r -= alpha Ap; the last
#                  block sums the partials of r.r, sets beta, rs, the
#                  iteration count and the done flag
# Every later launch of a chunk reads the done flag and returns at once;
# the host reads the state once a chunk (8 iterations, doubling to 64), as
# in the relax loop. The JAX stop rule and cap are kept: stop when
# r.r <= (1e-11 |rhs|)^2 or after min(4 n + 64, 20000) iterations, n the
# padded unknowns 2 * bucket(C, 16). Padded unknowns solve to 0 and touch
# nothing, so the system holds the 2C real ones only.

# dstate: rs, beta, tol2, p.Ap; istate: iterations, done, cap, two tickets
_CG_D, _CG_I = 4, 5


def bucket(n: int, minimum: int = 8) -> int:
    """Next power of two >= ``minimum`` (the JAX package's shape buckets)."""
    n = max(int(n), minimum)
    return 1 << int(np.ceil(np.log2(n)))


def cg_shapes(n_cells: int, n_rows: int, n_smooth: int
              ) -> tuple[int, int, int, int]:
    """The JAX CG's one-device compile-bucket shapes (unknowns, row pad,
    smooth pad, iteration cap): the cap derives from the padded unknowns."""
    n_unknowns = 2 * bucket(n_cells, 16)
    M_pad = bucket(n_rows, 8)
    S_pad = bucket(max(n_smooth, 1), 8)
    max_iter = min(4 * n_unknowns + 64, 20000)
    return n_unknowns, M_pad, S_pad, max_iter


@dataclass
class CGSystem:
    """The intensity normal equations on one device as CSR lists: row u
    holds every term of unknown u's matvec, merged per column, each merged
    sum taken on the host in one fixed order (the diagonal, the match
    rows', then the smoothness pairs'). A shard of a
    :class:`ShardedCGSystem` holds its match rows' terms only, its
    replicated part the smoothness pairs' and the diagonal."""

    n: int                    # unknowns (2C)
    row_ptr: torch.Tensor     # (n + 1,) int32
    row_len: torch.Tensor     # (n,) int64
    cols: torch.Tensor        # (nnz,) int32
    vals: torch.Tensor        # (nnz,) f64
    rhs: torch.Tensor         # (n,) f64
    x0: torch.Tensor          # (n,) f64, rhs / diag
    tol2: float
    max_iter: int

    @property
    def device(self) -> torch.device:
        return self.vals.device


@dataclass
class ShardedCGSystem:
    """The intensity normal equations split over a solve mesh (the JAX
    ``shard_map`` CG, ops/solve.py:600): shard d holds the data term of the
    match rows ``rows[d::S]`` on ``mesh[d]``; ``reps`` hold the smoothness
    pairs and the diagonal (and rhs, x0), once a distinct device. Ap =
    (sum over shards of A_d p) + A_rep p, as JAX adds psum(data), then the
    smoothness, then the diagonal."""

    n: int
    shards: list[CGSystem]
    reps: list[CGSystem]
    tol2: float
    max_iter: int

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    @property
    def mesh(self) -> list[torch.device]:
        return [sh.device for sh in self.shards]

    @property
    def device(self) -> torch.device:
        return self.reps[0].device


def _data_triplets(rows):
    """(rows, cols, values) lists of the 4x4 block of each match row."""
    rows = np.asarray(rows, np.float64).reshape(-1, 8)
    ia = 2 * rows[:, 0].astype(np.int64)
    ib = 2 * rows[:, 1].astype(np.int64)
    n, sx, sy, sxx, syy, sxy = (rows[:, k] for k in range(2, 8))
    u = [ia, ia + 1, ib, ib + 1]
    block = [[sxx, sx, -sxy, -sx], [sx, n, -sy, -n],
             [-sxy, -sy, syy, sy], [-sx, -n, sy, n]]
    return ([u[i] for i in range(4) for _ in range(4)],
            [u[j] for _ in range(4) for j in range(4)],
            [block[i][j] for i in range(4) for j in range(4)])


def _smooth_triplets(sidx, sw):
    """(rows, cols, values) lists of (w, -w; -w, w) of each flattened
    smoothness pair."""
    si = np.asarray(sidx, np.int64).reshape(-1, 2)
    w = np.asarray(sw, np.float64)
    return ([si[:, 0], si[:, 0], si[:, 1], si[:, 1]],
            [si[:, 0], si[:, 1], si[:, 0], si[:, 1]], [w, -w, -w, w])


def cg_triplets(n_cells, rows, diag, sidx, sw):
    """(row, col, value) of every term of the quadratic form's matvec, in
    the JAX ``data_term`` / smoothness / diagonal meaning: the diagonal,
    the 4x4 block of each match row and (w, -w; -w, w) of each flattened
    smoothness pair, in that order."""
    d = np.arange(2 * n_cells, dtype=np.int64)
    rd, cd, vd = _data_triplets(rows)
    rs, cs, vs = _smooth_triplets(sidx, sw)
    return (np.concatenate([d, *rd, *rs]), np.concatenate([d, *cd, *cs]),
            np.concatenate([np.asarray(diag, np.float64), *vd, *vs]))


def _csr(n: int, r, c, v, device):
    """Triplets -> (row_ptr, row lengths, cols, vals) on ``device``, each
    (row, col)'s values merged on the host in their order."""
    order = np.argsort(r * n + c, kind="stable")
    key = (r * n + c)[order]
    starts = np.flatnonzero(np.r_[True, key[1:] != key[:-1]]) if len(key) \
        else np.zeros(0, np.int64)
    vals = np.add.reduceat(v[order], starts) if len(key) else np.zeros(0)
    ur, uc = r[order][starts], c[order][starts]
    counts = np.bincount(ur, minlength=n)
    row_ptr = np.zeros(n + 1, np.int64)
    np.cumsum(counts, out=row_ptr[1:])
    if row_ptr[-1] >= 2 ** 31:
        raise ValueError(f"{row_ptr[-1]} terms: the CG indexes them in 31 bits")
    t = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a, dt)).to(device)
    return (t(row_ptr, np.int32), t(counts, np.int64), t(uc, np.int32),
            t(vals, np.float64))


def assemble_cg(n_cells: int, rows, diag, rhs, sidx, sw, device,
                rtol: float = 1e-11, n_shards: int = 1, mesh=None
                ) -> CGSystem | ShardedCGSystem:
    """The :class:`CGSystem` of the intensity solve on ``device``; the stop
    threshold and cap are the JAX package's (``solve_intensity_device``).
    With ``n_shards > 1`` a :class:`ShardedCGSystem` over ``mesh``
    (default ``device`` for every shard): shard d takes the JAX package's
    strided rows ``rows[d::n_shards]``."""
    n = 2 * int(n_cells)
    rows = np.asarray(rows, np.float64).reshape(-1, 8)
    _, _, _, max_iter = cg_shapes(n_cells, len(rows), len(sidx))
    diag = np.asarray(diag, np.float64)
    rhs = np.asarray(rhs, np.float64)
    # the padded rhs of the JAX package holds zeros past 2C: the same norm
    tol2 = (rtol * float(np.linalg.norm(rhs))) ** 2
    x0 = rhs / np.maximum(diag, 1e-300)
    t = lambda a, dev: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    if n_shards <= 1:
        return CGSystem(n, *_csr(n, *cg_triplets(n_cells, rows, diag, sidx,
                                                 sw), device),
                        t(rhs, device), t(x0, device), tol2, max_iter)
    if mesh is None:
        mesh = [device] * n_shards
    if len(mesh) != n_shards:
        raise ValueError(f"{n_shards} shards on a mesh of {len(mesh)}")
    d = np.arange(n, dtype=np.int64)
    rs, cs, vs = _smooth_triplets(sidx, sw)
    rep_t = (np.concatenate([*rs, d]), np.concatenate([*cs, d]),
             np.concatenate([*vs, diag]))
    reps = {dev: CGSystem(n, *_csr(n, *rep_t, dev), t(rhs, dev), t(x0, dev),
                          tol2, max_iter)
            for dev in distinct_devices(mesh)}
    shards = []
    for k, dev in enumerate(mesh):
        rd, cd, vd = _data_triplets(rows[k::n_shards])
        shards.append(CGSystem(
            n, *_csr(n, np.concatenate(rd), np.concatenate(cd),
                     np.concatenate(vd), dev),
            reps[dev].rhs, reps[dev].x0, tol2, max_iter))
    return ShardedCGSystem(n, shards, list(reps.values()), tol2, max_iter)


def cg_state(sysm: CGSystem, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Fresh (dstate, istate): rs 0, beta 0, the stop threshold; 0
    iterations, not done, the cap, tickets 0."""
    dstate = torch.tensor([0.0, 0.0, sysm.tol2, 0.0], dtype=torch.float64,
                          device=device)
    istate = torch.tensor([0, 0, sysm.max_iter, 0, 0], dtype=torch.int32,
                          device=device)
    return dstate, istate


def _cg_done(istate: torch.Tensor) -> bool:
    return bool(int(istate[1]))


def cg_spmv_plain(sysm: CGSystem, r, p_old, p_new, ap, dstate, istate):
    """K24's twin: p_new = r + beta p_old, ap = A p_new (per-row sums over
    the CSR lists), dstate[3] = p_new . ap; nothing once done."""
    if _cg_done(istate):
        return
    p_new.copy_(r + dstate[1] * p_old)
    terms = sysm.vals * p_new[sysm.cols.long()]
    ap.copy_(torch.segment_reduce(terms, "sum", lengths=sysm.row_len))
    dstate[3] = torch.dot(p_new, ap)


def cg_spmv_partial_plain(sysm: CGSystem, r, p_old, p_new, ap, dstate,
                          istate):
    """K24's partial form's twin: ap = A p over the CSR lists with p = r +
    beta p_old, and p_new = p unless ``p_new`` is None; no p.Ap; nothing
    once done."""
    if _cg_done(istate):
        return
    p = r + dstate[1] * p_old
    if p_new is not None:
        p_new.copy_(p)
    terms = sysm.vals * p[sysm.cols.long()]
    ap.copy_(torch.segment_reduce(terms, "sum", lengths=sysm.row_len))


def cg_update_plain(sysm: CGSystem, x, r, p, ap, dstate, istate,
                    init: bool = False):
    """K25's twin. ``init``: r = rhs - ap (ap = A x0), rs = r.r, the done
    flag. Else alpha = rs / max(p.Ap, 1e-300), x += alpha p, r -= alpha
    ap, then beta = rs_new / max(rs, 1e-300), rs = rs_new, one more
    iteration, done when rs <= tol2 or at the cap; nothing once done."""
    if _cg_done(istate):
        return
    if init:
        r.copy_(sysm.rhs - ap)
        k = 0
        beta = torch.zeros((), dtype=torch.float64, device=r.device)
    else:
        alpha = dstate[0] / torch.clamp(dstate[3], min=1e-300)
        x.copy_(x + alpha * p)
        r.copy_(r - alpha * ap)
        k = int(istate[0]) + 1
    rs_new = torch.dot(r, r)
    if not init:
        beta = rs_new / torch.clamp(dstate[0], min=1e-300)
    dstate[0] = rs_new
    dstate[1] = beta
    istate[0] = k
    istate[1] = int(not (float(rs_new) > float(dstate[2])
                         and k < int(istate[2])))


def _check_cg(sysm: CGSystem, vecs: dict, dstate, istate):
    dev = sysm.device
    for name, v in vecs.items():
        _require(v, name, dev, _F64, (sysm.n,))
    _require(dstate, "dstate", dev, _F64, (_CG_D,))
    _require(istate, "istate", dev, _I32, (_CG_I,))


CG_THREADS = 256       # K24/K25's block
CG_UPDATE_BLOCKS = 1024  # K25's grid at most
CG_LANES = (1, 2, 4, 8, 16, 32)  # K24's lanes a row
CG_SWEEPS = 8          # K24's groups of 256 / lanes rows a block


def cg_lanes(n: int, nnz: int) -> int:
    """K24's lanes a row for ``n`` rows of ``nnz`` terms: the power of two
    nearest a quarter of the mean row length (ties up), 1 to 32, so a lane
    sums about four terms (two at once, then two)."""
    quarter = nnz / max(int(n), 1) / 4
    lanes = 1
    while lanes < 32 and quarter >= 1.5 * lanes:
        lanes *= 2
    return lanes


def cg_blocks(n: int, lanes: int) -> int:
    """K24's grid: a block per ``CG_SWEEPS`` x 256 / ``lanes`` rows."""
    return -(-int(n) // (CG_THREADS // lanes * CG_SWEEPS))


def _cg_partials(n_blocks: int, dev) -> torch.Tensor:
    """The kernels' per-block partial sums: ``n_blocks`` and at least K25's
    grid."""
    return torch.empty(max(n_blocks, CG_UPDATE_BLOCKS), dtype=torch.float64,
                       device=dev)


def launch_cg_spmv(sysm: CGSystem, r, p_old, p_new, ap, dstate, istate,
                   lanes: int | None = None, partial: bool = False) -> None:
    """One K24 launch, ``lanes`` a row (default :func:`cg_lanes`'s
    choice), its full form or with ``partial`` its partial form (``p_new``
    may then be None); no checks."""
    if lanes is None:
        lanes = cg_lanes(sysm.n, int(sysm.cols.numel()))
    if lanes not in CG_LANES:
        raise ValueError(f"K24 takes {CG_LANES} lanes a row, not {lanes}")
    partials = (None if partial else
                _cg_partials(cg_blocks(sysm.n, lanes), r.device))
    lib = _cuda.load("cg")
    ret = lib.bst_cg_spmv(
        sysm.n, int(lanes), int(bool(partial)), sysm.row_ptr.data_ptr(),
        sysm.cols.data_ptr(), sysm.vals.data_ptr(), r.data_ptr(),
        p_old.data_ptr(), _ptr(p_new), ap.data_ptr(), dstate.data_ptr(),
        istate.data_ptr(), _ptr(partials),
        0 if partials is None else int(partials.numel()), _stream(r.device))
    _cuda.check(lib, ret, "cg_spmv")


def cg_spmv(sysm: CGSystem, r, p_old, p_new, ap, dstate, istate):
    """K24 (``csrc/cg.cu``) on CUDA, :func:`cg_spmv_plain` on the CPU."""
    if r.device.type == "cpu":
        return cg_spmv_plain(sysm, r, p_old, p_new, ap, dstate, istate)
    _check_cg(sysm, {"r": r, "p_old": p_old, "p_new": p_new, "ap": ap},
              dstate, istate)
    launch_cg_spmv(sysm, r, p_old, p_new, ap, dstate, istate)
    cg_spmv.launches += 1


cg_spmv.launches = 0


def cg_spmv_partial(sysm: CGSystem, r, p_old, p_new, ap, dstate, istate):
    """K24's partial form (``csrc/cg.cu``, a shard's Ap_d and p_new unless
    None, no p.Ap) on CUDA, :func:`cg_spmv_partial_plain` on the CPU."""
    if r.device.type == "cpu":
        return cg_spmv_partial_plain(sysm, r, p_old, p_new, ap, dstate,
                                     istate)
    vecs = {"r": r, "p_old": p_old, "ap": ap}
    if p_new is not None:
        vecs["p_new"] = p_new
    _check_cg(sysm, vecs, dstate, istate)
    launch_cg_spmv(sysm, r, p_old, p_new, ap, dstate, istate, partial=True)
    cg_spmv_partial.launches += 1


cg_spmv_partial.launches = 0


def cg_update(sysm: CGSystem, x, r, p, ap, dstate, istate, init=False):
    """K25 (``csrc/cg.cu``) on CUDA, :func:`cg_update_plain` on the CPU."""
    if r.device.type == "cpu":
        return cg_update_plain(sysm, x, r, p, ap, dstate, istate, init)
    _check_cg(sysm, {"x": x, "r": r, "p": p, "ap": ap}, dstate, istate)
    partials = _cg_partials(CG_UPDATE_BLOCKS, r.device)
    lib = _cuda.load("cg")
    ret = lib.bst_cg_update(
        sysm.n, int(bool(init)), sysm.rhs.data_ptr(), x.data_ptr(),
        r.data_ptr(), p.data_ptr(), ap.data_ptr(), dstate.data_ptr(),
        istate.data_ptr(), partials.data_ptr(), _stream(r.device))
    _cuda.check(lib, ret, "cg_update")
    cg_update.launches += 1


cg_update.launches = 0

KERNEL_WRAPPERS.update({"cg_spmv": cg_spmv, "cg_update": cg_update,
                        "cg_spmv_partial": cg_spmv_partial})


@dataclass
class CGOutput:
    x: torch.Tensor           # (2C,) f64 on the system's device
    iterations: int
    seconds: float = 0.0      # host wall of the launches and state reads
    card_seconds: float = 0.0  # CUDA events around each chunk's launches
    #                            (on the CPU: ``seconds``)


class _CGState:
    """The CG's vectors and state on one device (replicated on a mesh)."""

    def __init__(self, sysm: CGSystem, sharded: bool):
        dev, n = sysm.device, sysm.n
        f64 = dict(dtype=torch.float64, device=dev)
        self.dstate, self.istate = cg_state(sysm, dev)
        self.x = sysm.x0.clone()
        self.r = torch.zeros(n, **f64)
        self.ap = torch.empty(n, **f64)
        # the replicated part's Ap, which K29 adds to the shards'
        self.ap_rep = torch.empty(n, **f64) if sharded else None
        self.p = [torch.zeros(n, **f64), torch.zeros(n, **f64)]


def _cg(fns, sysm: CGSystem | ShardedCGSystem) -> CGOutput:
    """The CG loop through ``fns`` (K24, its partial form, K29, K25, or
    their twins). One device: K24 then K25 an iteration. Sharded, on each
    device of the mesh: K24's partial form on the replicated CSR (writing
    p_new) and on each of the device's shards, K29 adding Ap = sum of the
    shards' Ap_d + Ap_rep and taking p.Ap, then K25; the state read from
    the first device."""
    spmv, spmv_partial, ssum, update = fns
    sharded = isinstance(sysm, ShardedCGSystem)
    reps = sysm.reps if sharded else [sysm]
    st = {rep.device: _CGState(rep, sharded) for rep in reps}
    first = st[reps[0].device]
    dev = reps[0].device
    on = _guard(len(reps) > 1)
    if sharded:
        ap_parts = [torch.empty(sysm.n, dtype=torch.float64, device=sh.device)
                    for sh in sysm.shards]
    t0 = time.perf_counter()
    stream = torch.cuda.current_stream(dev) if dev.type == "cuda" else None
    events = []

    def mark():
        # one CUDA event pair around each chunk's launches: the card's
        # seconds without the host's state reads between chunks
        if stream is not None:
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record(stream)

    def iterate(old, new, init=False):
        """p[new] = src + beta p[old] (src x at init, else r), Ap, p.Ap,
        then K25."""
        if not sharded:
            s = first
            spmv(sysm, s.x if init else s.r, s.p[old], s.p[new], s.ap,
                 s.dstate, s.istate)
            update(sysm, s.x, s.r, s.p[new], s.ap, s.dstate, s.istate,
                   init=init)
            return
        for rep in reps:
            s = st[rep.device]
            with on(rep.device):
                spmv_partial(rep, s.x if init else s.r, s.p[old], s.p[new],
                             s.ap_rep, s.dstate, s.istate)
        for sh, ap in zip(sysm.shards, ap_parts):
            s = st[sh.device]
            with on(sh.device):
                spmv_partial(sh, s.x if init else s.r, s.p[old], None, ap,
                             s.dstate, s.istate)
        for d, s in st.items():
            with on(d):
                ssum(ap_parts, s.ap, rep=s.ap_rep, v=s.p[new],
                     dot=s.dstate[3:4], done=s.istate[1:2],
                     ticket=s.istate[3:4])
        for rep in reps:
            s = st[rep.device]
            with on(rep.device):
                update(rep, s.x, s.r, s.p[new], s.ap, s.dstate, s.istate,
                       init=init)

    mark()
    # r0 = rhs - A x0: K24 on x0 (beta 0), then K25 in its init form
    iterate(1, 0, init=True)
    cur, chunk = 1, FIRST_CHUNK
    while True:
        for _ in range(chunk):
            iterate(1 - cur, cur)
            cur = 1 - cur
        mark()
        iters, done = first.istate[:2].tolist()
        if done:
            break
        chunk = min(2 * chunk, MAX_CHUNK)
        mark()
    secs = time.perf_counter() - t0
    card = (sum(a.elapsed_time(b) for a, b in zip(events[::2], events[1::2]))
            / 1e3 if events else secs)
    return CGOutput(first.x, int(iters), secs, card)


def cg_on_device(sysm: CGSystem | ShardedCGSystem) -> CGOutput:
    """CG through K24/K25 (their twins where the system lies on the CPU);
    a :class:`ShardedCGSystem` through K24's partial form, K29 and K25."""
    return _cg((cg_spmv, cg_spmv_partial, shard_sum, cg_update), sysm)


def cg_plain(sysm: CGSystem | ShardedCGSystem) -> CGOutput:
    """The same loop through the plain twins, on any device."""
    return _cg((cg_spmv_plain, cg_spmv_partial_plain, shard_sum_plain,
                cg_update_plain), sysm)


def solve_intensity_device(n_cells, rows, diag, rhs, sidx, sw, device,
                           n_shards: int = 1, mesh=None) -> CGOutput:
    """CG-solve the intensity normal equations (``rows`` (M, 8) match
    statistics, ``diag`` / ``rhs`` (2C,), flattened smoothness pairs
    ``sidx`` (S, 2) with weights ``sw``) on ``device``, or sharded over
    ``mesh`` with ``n_shards > 1``: the solution (2C,) on the (first)
    device, the iteration count and the loop's seconds."""
    return cg_on_device(assemble_cg(n_cells, rows, diag, rhs, sidx, sw,
                                    device, n_shards=n_shards, mesh=mesh))
