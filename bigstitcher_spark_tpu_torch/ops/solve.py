"""Global tile relaxation on the device: four CUDA kernels, their plain-torch
twins, and the loop that drives them.

Port of the relax part of ``bigstitcher_spark_tpu/ops/solve.py``: the JAX
program ``_relax_core`` (one ``lax.while_loop``, jitted at :410) becomes four
hand-written ``sm_90a`` kernels in float64 (``csrc/solve.cu``), one
iteration being K11 -> K12 -> K13 -> K14:

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

Not here yet (ROADMAP.md): the sharded layout over several devices, the
compile-bucket telemetry, and the intensity solve's conjugate gradients.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from .. import config
from . import _cuda
from . import models as M
from .fusion import _require, _stream

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


def prepare_relax(
    link_rows: list[tuple[int, int, np.ndarray, np.ndarray, np.ndarray]],
    n_tiles: int,
    device: torch.device | str,
) -> RelaxProblem:
    """Flatten ``(ia, ib, p, q, w)`` links into device arrays grouped by
    owner tile (a stable sort of the flattened rows)."""
    loc, tgt, own, other, w, lid, side = [], [], [], [], [], [], []
    for l, (ia, ib, p, q, wl) in enumerate(link_rows):
        n = len(p)
        loc.append(p); tgt.append(q)
        own.append(np.full(n, ia)); other.append(np.full(n, ib))
        w.append(wl); lid.append(np.full(n, l)); side.append(np.ones(n, bool))
        loc.append(q); tgt.append(p)
        own.append(np.full(n, ib)); other.append(np.full(n, ia))
        w.append(wl); lid.append(np.full(n, l)); side.append(np.zeros(n, bool))
    return _layout(*(np.concatenate(a) for a in (loc, tgt, own, other, w, lid,
                                                 side)),
                   n_tiles, len(link_rows), device)


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
            n_links: int, device) -> RelaxProblem:
    """Rows in flattened order -> the device layout: grouped by owner tile
    (stable), the tile CSR, and the CSR of each link's A-side rows."""
    own_a = np.asarray(own).astype(np.int32)
    order = np.argsort(own_a, kind="stable")
    local = np.asarray(local, np.float64)[order]
    target = np.asarray(target, np.float64)[order]
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

    return RelaxProblem(
        n_tiles, n_links, n_rows, dev(local), dev(target), dev(own_a),
        dev(other_a), dev(w_a), dev(lid_a), dev(ptr(tile_len)),
        dev(tile_len.astype(np.int64)), dev(a_rows.astype(np.int32)),
        dev(ptr(link_len)), dev(link_len.astype(np.int64)), dev(link_own),
        _warps_per_segment(n_rows, n_tiles),
        _warps_per_segment(len(a_rows), n_links))


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


def relax_fit_plain(mom: torch.Tensor, fixed: torch.Tensor,
                    origin: torch.Tensor, model: str, reg: str, lam: float,
                    damping: float, state: torch.Tensor | None,
                    cur: torch.Tensor) -> torch.Tensor:
    """The models fitted to the moments (taken about ``origin`` (T, 3)),
    blended with the regulariser's ((1 - lam) m + lam r unless ``reg`` is
    NONE) and shifted back to world coordinates; identity where sw <= 0 or
    ``fixed`` (T,) uint8 is set; then ``cur = (1 - damping) cur + damping
    new`` in place."""
    if _finished(state):
        return cur
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


def relax_fit(mom: torch.Tensor, fixed: torch.Tensor, origin: torch.Tensor,
              model: str, reg: str, lam: float, damping: float,
              state: torch.Tensor | None, cur: torch.Tensor) -> torch.Tensor:
    """K12 (``csrc/solve.cu``) on CUDA, :func:`relax_fit_plain` on the CPU;
    updates ``cur`` in place."""
    if cur.device.type == "cpu":
        return relax_fit_plain(mom, fixed, origin, model, reg, lam, damping,
                               state, cur)
    dev, T = cur.device, int(cur.shape[0])
    model_code, reg_code = fit_pair(model, reg)
    _require(mom, "moments", dev, _F64, (T, N_MOMENTS))
    _require(fixed, "fixed", dev, (torch.uint8,), (T,))
    _require(origin, "origin", dev, _F64, (T, 3))
    _require(cur, "cur", dev, _F64, (T, 3, 4))
    lib = _cuda.load("solve")
    ret = lib.bst_relax_fit(mom.data_ptr(), fixed.data_ptr(),
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
# K14: error history and the convergence rules
# ---------------------------------------------------------------------------


def relax_converge_plain(num: torch.Tensor, den: torch.Tensor,
                         hist: torch.Tensor, state: torch.Tensor, pw: int,
                         max_error: float, max_iter: int) -> torch.Tensor:
    """err = sum(num) / max(sum(den), 1e-12) into ``hist[i]``, then
    ``_relax_core``'s stall, plateau and max-iterations rules on ``state``
    (int32: iterations, stall count, done, 0), in place."""
    if _finished(state):
        return state
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


def relax_converge(num: torch.Tensor, den: torch.Tensor, hist: torch.Tensor,
                   state: torch.Tensor, pw: int, max_error: float,
                   max_iter: int) -> torch.Tensor:
    """K14 (``csrc/solve.cu``) on CUDA, :func:`relax_converge_plain` on the
    CPU."""
    if num.device.type == "cpu":
        return relax_converge_plain(num, den, hist, state, pw, max_error,
                                    max_iter)
    dev, T = num.device, int(num.shape[0])
    _require(num, "num", dev, _F64, (T,))
    _require(den, "den", dev, _F64, (T,))
    _require(hist, "hist", dev, _F64)
    _require(state, "state", dev, _I32, (4,))
    if int(hist.shape[0]) < max_iter:
        raise ValueError(f"hist holds {int(hist.shape[0])} < {max_iter} "
                         "iterations")
    lib = _cuda.load("solve")
    ret = lib.bst_relax_converge(num.data_ptr(), den.data_ptr(), T,
                                 hist.data_ptr(), int(pw), float(max_error),
                                 int(max_iter), state.data_ptr(), _stream(dev))
    _cuda.check(lib, ret, "relax_converge")
    relax_converge.launches += 1
    return state


relax_converge.launches = 0


KERNEL_WRAPPERS = {
    "relax_moments": relax_moments,
    "relax_fit": relax_fit,
    "relax_error": relax_error,
    "relax_converge": relax_converge,
}
_PLAIN = (relax_moments_plain, relax_fit_plain, relax_error_plain,
          relax_converge_plain)
_KERNELS = (relax_moments, relax_fit, relax_error, relax_converge)


# ---------------------------------------------------------------------------
# the loop
# ---------------------------------------------------------------------------


@dataclass
class RelaxOutput:
    models: np.ndarray        # (T, 3, 4)
    history: np.ndarray       # (iterations,)
    iterations: int
    link_errors: np.ndarray   # (L,) under the final models (0 where masked)


def relax_on_device(
    problem: RelaxProblem,
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
    (T, 3): K11-K14 per iteration (their twins where the problem lies on
    the CPU), until K14 sets done. Iterations go in chunks of 8 doubling to
    64 between two reads of the state; kernels launched after done return
    at once."""
    return _relax(_KERNELS, problem, link_mask, fixed_mask, warm_t, lam,
                  damping, max_error, max_iterations, model, reg,
                  plateau_width)


def relax_plain(*args) -> RelaxOutput:
    """:func:`relax_on_device` through the plain twins, on any device."""
    return _relax(_PLAIN, *args)


def _relax(fns, problem, link_mask, fixed_mask, warm_t, lam, damping,
           max_error, max_iterations, model, reg, plateau_width
           ) -> RelaxOutput:
    if model == M.NONE:
        raise ValueError("NONE is a regulariser, not a model")
    if plateau_width < 1:
        raise ValueError(f"--maxPlateauwidth {plateau_width}: must be >= 1")
    dev, T = problem.device, problem.n_tiles
    f64 = dict(dtype=torch.float64, device=dev)
    link_w = torch.as_tensor(np.asarray(link_mask, np.float64), **f64)
    fixed = torch.as_tensor(np.asarray(fixed_mask, bool).astype(np.uint8),
                            device=dev)
    cur = torch.zeros((T, 3, 4), **f64)
    cur[:, :, :3] = torch.eye(3, **f64)
    cur[:, :, 3] = torch.as_tensor(np.asarray(warm_t, np.float64), **f64)
    hist = torch.zeros(max(int(max_iterations), 1), **f64)
    state = torch.zeros(4, dtype=torch.int32, device=dev)
    mom = torch.empty((T, N_MOMENTS), **f64)
    nd = (torch.empty(T, **f64), torch.empty(T, **f64))
    moments_fn, fit_fn, error_fn, converge_fn = fns
    origin = tile_origin(problem, link_w)
    iters, chunk = 0, FIRST_CHUNK
    while max_iterations > 0:
        for _ in range(min(chunk, max_iterations - iters)):
            moments_fn(problem, cur, link_w, origin, state, out=mom)
            fit_fn(mom, fixed, origin, model, reg, lam, damping, state, cur)
            error_fn(problem, cur, link_w, state, out=nd)
            converge_fn(*nd, hist, state, plateau_width, max_error,
                        max_iterations)
        iters, _stall, done, _ = state.tolist()
        if done:
            break
        chunk = min(2 * chunk, MAX_CHUNK)
    num, den = error_fn(problem, cur, link_w, None, by_link=True)
    link_err = num / torch.clamp(den, min=1e-12)
    return RelaxOutput(cur.cpu().numpy(), hist[:iters].cpu().numpy(), iters,
                       link_err.cpu().numpy())



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
    rows', then the smoothness pairs')."""

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


def cg_triplets(n_cells, rows, diag, sidx, sw):
    """(row, col, value) of every term of the quadratic form's matvec, in
    the JAX ``data_term`` / smoothness / diagonal meaning: the 4x4 block
    of each match row, (w, -w; -w, w) of each flattened smoothness pair,
    and the diagonal."""
    rows = np.asarray(rows, np.float64).reshape(-1, 8)
    ia = 2 * rows[:, 0].astype(np.int64)
    ib = 2 * rows[:, 1].astype(np.int64)
    n, sx, sy, sxx, syy, sxy = (rows[:, k] for k in range(2, 8))
    u = [ia, ia + 1, ib, ib + 1]
    block = [[sxx, sx, -sxy, -sx], [sx, n, -sy, -n],
             [-sxy, -sy, syy, sy], [-sx, -n, sy, n]]
    r_d = [u[i] for i in range(4) for _ in range(4)]
    c_d = [u[j] for _ in range(4) for j in range(4)]
    v_d = [block[i][j] for i in range(4) for j in range(4)]
    si = np.asarray(sidx, np.int64).reshape(-1, 2)
    w = np.asarray(sw, np.float64)
    d = np.arange(2 * n_cells, dtype=np.int64)
    r = np.concatenate([d, *r_d, si[:, 0], si[:, 0], si[:, 1], si[:, 1]])
    c = np.concatenate([d, *c_d, si[:, 0], si[:, 1], si[:, 0], si[:, 1]])
    v = np.concatenate([np.asarray(diag, np.float64), *v_d, w, -w, -w, w])
    return r, c, v


def assemble_cg(n_cells: int, rows, diag, rhs, sidx, sw, device,
                rtol: float = 1e-11) -> CGSystem:
    """The :class:`CGSystem` of the intensity solve on ``device``; the stop
    threshold and cap are the JAX package's (``solve_intensity_device``)."""
    n = 2 * int(n_cells)
    r, c, v = cg_triplets(n_cells, rows, diag, sidx, sw)
    order = np.argsort(r * n + c, kind="stable")
    key = (r * n + c)[order]
    starts = np.flatnonzero(np.r_[True, key[1:] != key[:-1]])
    vals = np.add.reduceat(v[order], starts)
    ur, uc = r[order][starts], c[order][starts]
    counts = np.bincount(ur, minlength=n)
    row_ptr = np.zeros(n + 1, np.int64)
    np.cumsum(counts, out=row_ptr[1:])
    if row_ptr[-1] >= 2 ** 31:
        raise ValueError(f"{row_ptr[-1]} terms: the CG indexes them in 31 bits")
    _, _, _, max_iter = cg_shapes(n_cells, len(np.asarray(rows).reshape(-1, 8)),
                                  len(sidx))
    diag = np.asarray(diag, np.float64)
    rhs = np.asarray(rhs, np.float64)
    # the padded rhs of the JAX package holds zeros past 2C: the same norm
    tol2 = (rtol * float(np.linalg.norm(rhs))) ** 2
    t = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a, dt)).to(device)
    return CGSystem(n, t(row_ptr, np.int32), t(counts, np.int64),
                    t(uc, np.int32), t(vals, np.float64), t(rhs, np.float64),
                    t(rhs / np.maximum(diag, 1e-300), np.float64), tol2,
                    max_iter)


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
                   lanes: int | None = None) -> None:
    """One K24 launch, ``lanes`` a row (default :func:`cg_lanes`'s
    choice); no checks."""
    if lanes is None:
        lanes = cg_lanes(sysm.n, int(sysm.cols.numel()))
    if lanes not in CG_LANES:
        raise ValueError(f"K24 takes {CG_LANES} lanes a row, not {lanes}")
    partials = _cg_partials(cg_blocks(sysm.n, lanes), r.device)
    lib = _cuda.load("cg")
    ret = lib.bst_cg_spmv(
        sysm.n, int(lanes), sysm.row_ptr.data_ptr(), sysm.cols.data_ptr(),
        sysm.vals.data_ptr(), r.data_ptr(), p_old.data_ptr(),
        p_new.data_ptr(), ap.data_ptr(), dstate.data_ptr(),
        istate.data_ptr(), partials.data_ptr(), int(partials.numel()),
        _stream(r.device))
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

KERNEL_WRAPPERS.update({"cg_spmv": cg_spmv, "cg_update": cg_update})


@dataclass
class CGOutput:
    x: torch.Tensor           # (2C,) f64 on the system's device
    iterations: int
    seconds: float = 0.0      # host wall of the launches and state reads
    card_seconds: float = 0.0  # CUDA events around each chunk's launches
    #                            (on the CPU: ``seconds``)


def _cg(spmv, update, sysm: CGSystem) -> CGOutput:
    dev, n = sysm.device, sysm.n
    f64 = dict(dtype=torch.float64, device=dev)
    t0 = time.perf_counter()
    stream = torch.cuda.current_stream(dev) if dev.type == "cuda" else None
    events = []

    def mark():
        # one CUDA event pair around each chunk's launches: the card's
        # seconds without the host's state reads between chunks
        if stream is not None:
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record(stream)

    dstate, istate = cg_state(sysm, dev)
    x = sysm.x0.clone()
    r = torch.zeros(n, **f64)
    ap = torch.empty(n, **f64)
    p = [torch.zeros(n, **f64), torch.zeros(n, **f64)]
    mark()
    # r0 = rhs - A x0: K24 on x0 (beta 0), then K25 in its init form
    spmv(sysm, x, p[1], p[0], ap, dstate, istate)
    update(sysm, x, r, p[0], ap, dstate, istate, init=True)
    cur, chunk = 1, FIRST_CHUNK
    while True:
        for _ in range(chunk):
            spmv(sysm, r, p[1 - cur], p[cur], ap, dstate, istate)
            update(sysm, x, r, p[cur], ap, dstate, istate)
            cur = 1 - cur
        mark()
        iters, done = istate[:2].tolist()
        if done:
            break
        chunk = min(2 * chunk, MAX_CHUNK)
        mark()
    secs = time.perf_counter() - t0
    card = (sum(a.elapsed_time(b) for a, b in zip(events[::2], events[1::2]))
            / 1e3 if events else secs)
    return CGOutput(x, int(iters), secs, card)


def cg_on_device(sysm: CGSystem) -> CGOutput:
    """CG through K24/K25 (their twins where the system lies on the CPU)."""
    return _cg(cg_spmv, cg_update, sysm)


def cg_plain(sysm: CGSystem) -> CGOutput:
    """The same loop through the plain twins, on any device."""
    return _cg(cg_spmv_plain, cg_update_plain, sysm)


def solve_intensity_device(n_cells, rows, diag, rhs, sidx, sw, device
                           ) -> CGOutput:
    """CG-solve the intensity normal equations (``rows`` (M, 8) match
    statistics, ``diag`` / ``rhs`` (2C,), flattened smoothness pairs
    ``sidx`` (S, 2) with weights ``sw``) on ``device``: the device
    solution (2C,), the iteration count and the loop's seconds."""
    return cg_on_device(assemble_cg(n_cells, rows, diag, rhs, sidx, sw,
                                    device))
