"""Global registration solver: tile-graph relaxation over point matches.

Port of ``bigstitcher_spark_tpu/models/solver.py`` (the reference ``solver``
tool, Solver.java:161-396, and the mvrecon/mpicbg global-optimization stack
it calls: GlobalOpt, GlobalOptIterative, GlobalOptTwoRound, mpicbg
TileConfiguration, Solver.java:297-338). Each relaxation sweep is
vectorized: segment-sum the weighted point moments per tile, then fit every
tile's model at once. The ``device`` backend (the default) runs the sweeps
in the relax kernels K11-K14 of :mod:`..ops.solve` on the card, or in their
plain twins when the device is the CPU; ``numpy`` is the JAX package's host
reference path, kept as it is.

Sources of matches (Solver.java:96):
  * STITCHING — pairwise translation links from phase correlation, expanded
    into 8 corner point matches of the overlap bbox weighted by correlation
    (role of ImageCorrelationPointMatchCreator); stale links whose stored
    registration hash no longer matches are skipped (Solver.java:398-432).
  * IP — corresponding interest points of selected labels, transformed to
    world coordinates under current registrations (Solver.java:434-673).

The solved per-tile correction is preconcatenated to every member view's
transform chain (TransformationTools.storeTransformation role,
Solver.java:351-369).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from ..io.interestpoints import InterestPointStore
from ..io.spimdata import SpimData, ViewId, ViewTransform, registration_hash
from ..ops import models as M
from ..ops import solve as _dsolve
from ..utils.geometry import (
    Interval,
    apply_affine,
    transformed_interval,
)

Key = tuple  # canonical tile key: sorted tuple of member ViewIds


@dataclass
class SolverParams:
    """Defaults match Solver.java:104-149 + AbstractRegistration.java:62-77."""

    source: str = "STITCHING"              # STITCHING | IP
    method: str = "ONE_ROUND_SIMPLE"       # ONE_ROUND_{SIMPLE,ITERATIVE} | TWO_ROUND_{SIMPLE,ITERATIVE}
    model: str = M.TRANSLATION             # TRANSLATION | RIGID | AFFINE
    regularization: str = M.NONE           # NONE | IDENTITY | TRANSLATION | RIGID | AFFINE
    lam: float = 0.1
    max_error: float = 5.0
    max_iterations: int = 10000
    max_plateau_width: int = 200
    relative_threshold: float = 3.5
    absolute_threshold: float = 7.0
    damping: float = 1.0                   # Jacobi under-relaxation factor
    backend: str | None = None             # device | numpy | None (knob)
    device: str | None = None              # torch device of the device backend (None: cuda)
    devices: list | None = None            # solve mesh (repeats allowed; None: every card, or [cpu])
    fixed_views: list[ViewId] = field(default_factory=list)
    disable_fixed_views: bool = False
    labels: list[str] = field(default_factory=list)
    label_weights: list[float] = field(default_factory=list)
    group_illums: bool | None = None       # default: True for STITCHING
    group_channels: bool | None = None
    group_tiles: bool = False
    split_timepoints: bool = False

    def resolved_grouping(self) -> tuple[bool, bool]:
        stitch = self.source.upper() == "STITCHING"
        gi = self.group_illums if self.group_illums is not None else stitch
        gc = self.group_channels if self.group_channels is not None else stitch
        return gi, gc


@dataclass
class MatchLink:
    """All point matches of one tile pair (one graph edge)."""

    key_a: Key
    key_b: Key
    p: np.ndarray  # (N,3) world coords on A's side
    q: np.ndarray  # (N,3) world coords on B's side
    w: np.ndarray  # (N,)


@dataclass
class SolveResult:
    corrections: dict[Key, np.ndarray]  # tile key -> 3x4 world correction
    error: float
    iterations: int
    removed_links: list[tuple[Key, Key]]
    link_errors: dict[tuple[Key, Key], float]
    history: np.ndarray | None = None   # per-iteration mean error
    # host seconds: "matches" (assembly), "warm_start", "relax"
    timings: dict[str, float] = field(default_factory=dict)
    shards: int = 1   # the most shards a relaxation took (1: one device)


def links_from_reference(links) -> list[MatchLink]:
    """The port's links from the JAX package's ``MatchLink`` list (its
    points as float64 numpy, its tile keys as the port's ViewIds), so one
    graph feeds both packages."""
    def key(k):
        return tuple(ViewId(int(v.timepoint), int(v.setup)) for v in k)

    return [MatchLink(key(lk.key_a), key(lk.key_b),
                      np.asarray(lk.p, np.float64), np.asarray(lk.q, np.float64),
                      np.asarray(lk.w, np.float64)) for lk in links]


def _add_time(timings: dict, key: str, seconds: float) -> None:
    timings[key] = timings.get(key, 0.0) + seconds


# ---------------------------------------------------------------------------
# tile grouping
# ---------------------------------------------------------------------------

def build_tiles(sd: SpimData, views: list[ViewId], params: SolverParams) -> list[Key]:
    """Group views into solver tiles (Solver.java:108-119 grouping flags)."""
    gi, gc = params.resolved_grouping()
    by_key: dict[tuple, list[ViewId]] = {}
    for v in views:
        s = sd.setups[v.setup]
        if params.split_timepoints:
            key: tuple = (v.timepoint,)
        else:
            key = (
                v.timepoint,
                s.attributes.get("angle", 0),
                None if params.group_tiles else s.attributes.get("tile", 0),
                None if gc else s.attributes.get("channel", 0),
                None if gi else s.attributes.get("illumination", 0),
            )
        by_key.setdefault(key, []).append(v)
    return [tuple(sorted(vs)) for _, vs in sorted(by_key.items())]


def _tile_of_view(tiles: list[Key]) -> dict[ViewId, Key]:
    out = {}
    for t in tiles:
        for v in t:
            out[v] = t
    return out


# ---------------------------------------------------------------------------
# match assembly
# ---------------------------------------------------------------------------

def matches_from_stitching(
    sd: SpimData, tiles: list[Key], verbose: bool = True
) -> list[MatchLink]:
    """Expand each non-stale pairwise shift into 8 corner matches of its
    overlap bbox: with corrections c, the stored shift S demands
    c_A - c_B = S, i.e. match (x, x + S) (models.stitching shift semantics)."""
    lookup = _tile_of_view(tiles)
    links: dict[tuple[Key, Key], list[tuple[np.ndarray, np.ndarray, float]]] = {}
    n_stale = 0
    for res in sd.stitching_results.values():
        ka = lookup.get(res.views_a[0])
        kb = lookup.get(res.views_b[0])
        if ka is None or kb is None or ka == kb:
            continue
        cur = registration_hash(
            [sd.model(v) for v in res.views_a], [sd.model(v) for v in res.views_b]
        )
        if not np.isclose(cur, res.hash, rtol=1e-9, atol=1e-6):
            n_stale += 1
            continue
        if res.bbox is not None:
            box = res.bbox
        else:
            box = None
            for v in res.views_a:
                iv = transformed_interval(
                    sd.model(v), Interval.from_shape(sd.view_size(v))
                )
                box = iv if box is None else box.union(iv)
        corners = _corners(box)
        S = res.transform[:, 3]
        links.setdefault((ka, kb), []).append(
            (corners, corners + S, float(res.correlation))
        )
    if n_stale and verbose:
        print(f"solver: skipped {n_stale} stale stitching links "
              "(registration hash changed)")
    out = []
    for (ka, kb), items in sorted(links.items()):
        p = np.concatenate([i[0] for i in items])
        q = np.concatenate([i[1] for i in items])
        w = np.concatenate([np.full(len(i[0]), i[2]) for i in items])
        out.append(MatchLink(ka, kb, p, q, w))
    return out


def _corners(box: Interval) -> np.ndarray:
    mn = np.asarray(box.min, np.float64)
    mx = np.asarray(box.max, np.float64) + 1.0
    return np.array(
        [[(mn[0], mx[0])[(i >> 0) & 1], (mn[1], mx[1])[(i >> 1) & 1],
          (mn[2], mx[2])[(i >> 2) & 1]] for i in range(8)]
    )


def matches_from_interest_points(
    sd: SpimData,
    tiles: list[Key],
    store: InterestPointStore,
    labels: list[str],
    label_weights: list[float] | None = None,
    verbose: bool = True,
) -> list[MatchLink]:
    """World-transformed corresponding interest points per tile pair
    (Solver.java:434-673: points under current registrations; the solve
    computes a correction on top)."""
    weights = {
        lab: (label_weights[i] if label_weights and i < len(label_weights) else 1.0)
        for i, lab in enumerate(labels)
    }
    lookup = _tile_of_view(tiles)
    cache: dict[tuple[ViewId, str], dict[int, np.ndarray]] = {}

    def world_points(view: ViewId, label: str) -> dict[int, np.ndarray]:
        k = (view, label)
        if k not in cache:
            ids, locs = store.load_points(view, label)
            w = apply_affine(sd.model(view), locs) if len(locs) else locs
            cache[k] = dict(zip(ids.astype(int).tolist(), w))
        return cache[k]

    links: dict[tuple[Key, Key], list[tuple[np.ndarray, np.ndarray, float]]] = {}
    n_pts = 0
    for view in sorted(lookup):
        for label in labels:
            if label not in sd.interest_points.get(view, {}):
                continue
            mine = world_points(view, label)
            for c in store.load_correspondences(view, label):
                ka = lookup.get(view)
                kb = lookup.get(c.other_view)
                if kb is None or ka == kb:
                    continue
                if (view, label) > (c.other_view, c.other_label):
                    continue  # each correspondence is stored on both sides
                theirs = world_points(c.other_view, c.other_label)
                if c.id not in mine or c.other_id not in theirs:
                    continue
                links.setdefault((ka, kb), []).append(
                    (mine[c.id], theirs[c.other_id], weights.get(label, 1.0))
                )
                n_pts += 1
    if verbose:
        print(f"solver: {n_pts} corresponding interest points over "
              f"{len(links)} pairs")
    out = []
    for (ka, kb), items in sorted(links.items()):
        p = np.stack([i[0] for i in items])
        q = np.stack([i[1] for i in items])
        w = np.array([i[2] for i in items])
        out.append(MatchLink(ka, kb, p, q, w))
    return out


# ---------------------------------------------------------------------------
# the numpy reference relaxation (--solverBackend numpy)
# ---------------------------------------------------------------------------

def _flatten(links: list[MatchLink], index: dict[Key, int]):
    """Incidence arrays: every point match appears once per side."""
    loc, tgt_pts, own, other, w = [], [], [], [], []
    for lk in links:
        ia, ib = index[lk.key_a], index[lk.key_b]
        n = len(lk.p)
        loc.append(lk.p); tgt_pts.append(lk.q)
        own.append(np.full(n, ia)); other.append(np.full(n, ib)); w.append(lk.w)
        loc.append(lk.q); tgt_pts.append(lk.p)
        own.append(np.full(n, ib)); other.append(np.full(n, ia)); w.append(lk.w)
    return (
        np.concatenate(loc), np.concatenate(tgt_pts),
        np.concatenate(own), np.concatenate(other), np.concatenate(w),
    )


def _apply_batch(models: np.ndarray, pts: np.ndarray, idx: np.ndarray) -> np.ndarray:
    m = models[idx]
    return np.einsum("nij,nj->ni", m[:, :, :3], pts) + m[:, :, 3]


def _segment_moments(local, target, own, w, T):
    """Per-tile weighted moments for all three model fits in one pass."""
    ph = np.concatenate([local, np.ones((len(local), 1))], axis=1)  # (N,4)
    sw = np.zeros(T)
    np.add.at(sw, own, w)
    swp = np.zeros((T, 4))
    np.add.at(swp, own, w[:, None] * ph)
    swq = np.zeros((T, 3))
    np.add.at(swq, own, w[:, None] * target)
    spp = np.zeros((T, 4, 4))
    np.add.at(spp, own, w[:, None, None] * ph[:, :, None] * ph[:, None, :])
    spq = np.zeros((T, 4, 3))
    np.add.at(spq, own, w[:, None, None] * ph[:, :, None] * target[:, None, :])
    return sw, swp, swq, spp, spq


def _fit_from_moments(kind: str, sw, swp, swq, spp, spq, eps=1e-9):
    """Batched per-tile model fit from accumulated moments."""
    T = len(sw)
    sw_safe = np.maximum(sw, eps)
    if kind == M.IDENTITY:
        out = np.zeros((T, 3, 4))
        out[:, :, :3] = np.eye(3)
        return out
    if kind == M.TRANSLATION:
        t = (swq - swp[:, :3]) / sw_safe[:, None]
        out = np.zeros((T, 3, 4))
        out[:, :, :3] = np.eye(3)
        out[:, :, 3] = t
        return out
    if kind == M.AFFINE:
        a = spp + eps * np.eye(4)
        sol = np.linalg.solve(a, spq)  # (T,4,3)
        return np.swapaxes(sol, 1, 2)
    if kind == M.RIGID:
        pc = swp[:, :3] / sw_safe[:, None]
        qc = swq / sw_safe[:, None]
        # H = Σw p qᵀ - Σw pc qᵀ - Σw p qcᵀ + Σw pc qcᵀ = spq[:3] - pc (swq)ᵀ ...
        h = (spq[:, :3, :]
             - pc[:, :, None] * swq[:, None, :]
             - swp[:, :3, None] * qc[:, None, :]
             + sw_safe[:, None, None] * pc[:, :, None] * qc[:, None, :])
        u, _, vt = np.linalg.svd(h)
        d = np.linalg.det(np.swapaxes(vt, 1, 2) @ np.swapaxes(u, 1, 2))
        sign = np.stack([np.ones_like(d), np.ones_like(d), d], axis=1)
        r = np.swapaxes(vt, 1, 2) @ (sign[:, :, None] * np.swapaxes(u, 1, 2))
        t = qc - np.einsum("nij,nj->ni", r, pc)
        return np.concatenate([r, t[:, :, None]], axis=2)
    raise ValueError(kind)


def _resolve_backend(params: SolverParams) -> str:
    """``device`` (the relax kernels, the default) or ``numpy`` (the host
    reference path): explicit params.backend wins, else the
    BST_SOLVE_DEVICE knob (policy owned by ops.solve)."""
    return _dsolve.resolve_backend(params.backend)


def relax(
    links: list[MatchLink],
    tiles: list[Key],
    fixed: set[Key],
    params: SolverParams,
) -> SolveResult:
    """One global relaxation: the device backend (default) runs the Jacobi
    iteration in the relax kernels (ops/solve.py), the numpy backend is the
    host reference both share their convergence semantics with."""
    if _resolve_backend(params) == "device" and links:
        return _DeviceRelax(links, tiles, fixed, params).solve()
    return _relax_numpy(links, tiles, fixed, params)


def _relax_numpy(
    links: list[MatchLink],
    tiles: list[Key],
    fixed: set[Key],
    params: SolverParams,
) -> SolveResult:
    """Vectorized Jacobi tile relaxation with mpicbg-style convergence
    (maxError / maxIterations / maxPlateauwidth, ConvergenceStrategy role)."""
    index = {k: i for i, k in enumerate(tiles)}
    T = len(tiles)
    identity = np.zeros((T, 3, 4))
    identity[:, :, :3] = np.eye(3)
    if not links:
        return SolveResult({k: identity[0].copy() for k in tiles}, 0.0, 0, [], {})
    timings: dict[str, float] = {}
    t0 = time.perf_counter()
    local, target_pts, own, other, w = _flatten(links, index)
    fixed_idx = np.array(sorted(index[k] for k in fixed if k in index), int)
    cur = identity.copy()
    # warm start: exact weighted-Laplacian solve of the translation part
    # (exact optimum for TRANSLATION/NONE; a good basin for the rest)
    cur[:, :, 3] = _direct_translations(links, index, fixed_idx, T)
    t1 = time.perf_counter()
    damping = params.damping
    history: list[float] = []
    it = 0
    stall = 0
    for it in range(1, params.max_iterations + 1):
        tgt_world = _apply_batch(cur, target_pts, other)
        sw, swp, swq, spp, spq = _segment_moments(local, tgt_world, own, w, T)
        new = _fit_from_moments(params.model, sw, swp, swq, spp, spq)
        if params.regularization != M.NONE and params.lam > 0:
            reg = _fit_from_moments(params.regularization, sw, swp, swq, spp, spq)
            new = (1 - params.lam) * new + params.lam * reg
        # tiles with no matches keep identity
        new[sw <= 0] = identity[sw <= 0]
        if len(fixed_idx):
            new[fixed_idx] = identity[fixed_idx]
        cur = (1 - damping) * cur + damping * new
        # weighted mean point-match displacement (mpicbg mean error)
        err = _mean_error(cur, local, target_pts, own, other, w)
        history.append(err)
        if len(history) > 1:
            stall = stall + 1 if history[-2] - err < 1e-9 * max(err, 1.0) else 0
            if stall >= 5:
                break  # exact fixed point — no further progress possible
        pw = params.max_plateau_width
        if it > pw and history[-1] < params.max_error:
            # plateau ends the solve only once below the target error
            # (mpicbg ConvergenceStrategy: maxAllowedError + maxPlateauwidth)
            window = history[-pw:]
            improvement = history[-pw - 1] - min(window)
            if improvement < 1e-4 * max(history[-1], 1e-12) or history[-1] < 1e-9:
                break
    err = history[-1] if history else 0.0
    link_errors = _per_link_errors(cur, links, index)
    _add_time(timings, "warm_start", t1 - t0)
    _add_time(timings, "relax", time.perf_counter() - t1)
    return SolveResult(
        {k: cur[i].copy() for k, i in index.items()}, err, it, [],
        link_errors, history=np.asarray(history), timings=timings,
    )


def _direct_translations(links, index, fixed_idx, T) -> np.ndarray:
    """Closed-form weighted least squares over link mean shifts (graph
    Laplacian); fixed tiles pinned at zero.

    Assembled SPARSELY from the link incidence (4 entries per link + the
    anchor/isolated diagonal) and solved with a sparse LU: a tile graph
    has O(T) links, so a dense (T, T) build would allocate O(T²) purely
    for structure."""
    import scipy.sparse as sp
    from scipy.sparse.linalg import splu

    if not links:
        return np.zeros((T, 3))
    ia = np.fromiter((index[lk.key_a] for lk in links), int, len(links))
    ib = np.fromiter((index[lk.key_b] for lk in links), int, len(links))
    wsum = np.array([float(lk.w.sum()) for lk in links])
    s = np.stack([((lk.q - lk.p) * lk.w[:, None]).sum(0)
                  / max(float(lk.w.sum()), 1e-12) for lk in links])
    anchor = fixed_idx if len(fixed_idx) else np.arange(1)
    anchored = np.zeros(T, bool)
    anchored[anchor] = True
    B = np.zeros((T, 3))
    np.add.at(B, ia, wsum[:, None] * s)
    np.add.at(B, ib, -wsum[:, None] * s)
    B[anchored] = 0.0
    # Laplacian entries, with anchored ROWS replaced by identity rows
    rows = np.concatenate([ia, ib, ia, ib])
    cols = np.concatenate([ia, ib, ib, ia])
    vals = np.concatenate([wsum, wsum, -wsum, -wsum])
    keep = ~anchored[rows]
    rows, cols, vals = rows[keep], cols[keep], vals[keep]
    diag = np.zeros(T)
    np.add.at(diag, ia[~anchored[ia]], wsum[~anchored[ia]])
    np.add.at(diag, ib[~anchored[ib]], wsum[~anchored[ib]])
    # anchors and isolated tiles (zero diagonal) get a bare 1.0 diagonal
    unit = anchored | (diag == 0)
    off = vals != 0
    A = sp.coo_matrix(
        (np.concatenate([vals[off], np.ones(int(unit.sum()))]),
         (np.concatenate([rows[off], np.flatnonzero(unit)]),
          np.concatenate([cols[off], np.flatnonzero(unit)]))),
        shape=(T, T)).tocsc()
    try:
        return splu(A).solve(B)
    except RuntimeError:
        return np.zeros((T, 3))


def _mean_error(models, local, target_pts, own, other, w) -> float:
    a = _apply_batch(models, local, own)
    b = _apply_batch(models, target_pts, other)
    d = np.linalg.norm(a - b, axis=1)
    return float((d * w).sum() / max(w.sum(), 1e-12))


def _per_link_errors(models, links, index) -> dict[tuple[Key, Key], float]:
    out = {}
    for lk in links:
        ma, mb = models[index[lk.key_a]], models[index[lk.key_b]]
        a = lk.p @ ma[:, :3].T + ma[:, 3]
        b = lk.q @ mb[:, :3].T + mb[:, 3]
        d = np.linalg.norm(a - b, axis=1)
        out[(lk.key_a, lk.key_b)] = float((d * lk.w).sum() / max(lk.w.sum(), 1e-12))
    return out


# ---------------------------------------------------------------------------
# the device relaxation (the relax kernels, or their twins on the CPU)
# ---------------------------------------------------------------------------

class _DeviceRelax:
    """Runs :func:`..ops.solve.relax_on_device`: flattens the link
    graph ONCE onto the device, then every solve — the first and every
    masked re-solve of the iterative drop-worst-link loop — reuses those
    arrays with a per-link weight mask. Above ``BST_SOLVE_SHARD`` point
    rows, on a solve mesh of more than one device
    (:func:`..ops.solve.solve_layout`), the rows are laid out per mesh
    device, tiles placed cost-weighted by their rows with
    ``pairsched.assign_tasks``, and each sweep's sums added by K29."""

    def __init__(self, links: list[MatchLink], tiles: list[Key],
                 fixed: set[Key], params: SolverParams):
        self.links = list(links)
        self.tiles = tiles
        self.params = params
        self.index = {k: i for i, k in enumerate(tiles)}
        self.fixed_idx = np.array(
            sorted(self.index[k] for k in fixed if k in self.index), int)
        T = len(tiles)
        rows = [(self.index[lk.key_a], self.index[lk.key_b],
                 np.asarray(lk.p, np.float64), np.asarray(lk.q, np.float64),
                 np.asarray(lk.w, np.float64)) for lk in self.links]
        mesh = _dsolve.solve_mesh(params.device, params.devices)
        n_shards = _dsolve.solve_layout(
            2 * sum(len(p) for _, _, p, _, _ in rows), mesh)
        if n_shards > 1:
            from ..parallel.pairsched import PairTask, assign_tasks

            # rows per tile drive placement: the per-device row counts are
            # the load of the sharded segment sums
            per_tile = np.zeros(T)
            for ia, ib, p, _, _ in rows:
                per_tile[ia] += len(p)
                per_tile[ib] += len(p)
            bins = assign_tasks([PairTask(index=t, cost=float(per_tile[t]))
                                 for t in range(T)], n_shards)
            tile_shard = np.zeros(T, np.int32)
            for d, bin_tasks in enumerate(bins):
                for t in bin_tasks:
                    tile_shard[t.index] = d
            self.problem = _dsolve.prepare_relax(rows, T, mesh[0], n_shards,
                                                 tile_shard, mesh)
        else:
            self.problem = _dsolve.prepare_relax(rows, T, mesh[0])
        self.n_shards = n_shards
        self.fixed_mask = np.zeros(T, bool)
        if len(self.fixed_idx):
            self.fixed_mask[self.fixed_idx] = True

    def solve(self, link_mask: np.ndarray | None = None) -> SolveResult:
        p = self.params
        identity = np.zeros((3, 4))
        identity[:, :3] = np.eye(3)
        if link_mask is None:
            link_mask = np.ones(len(self.links))
        active = [lk for lk, m in zip(self.links, link_mask) if m]
        if not active:
            return SolveResult({k: identity.copy() for k in self.tiles},
                               0.0, 0, [], {}, history=np.zeros(0))
        t0 = time.perf_counter()
        # warm start on the ACTIVE links only, so a masked re-solve equals
        # a rebuilt-link-list solve exactly
        warm_t = _direct_translations(active, self.index, self.fixed_idx,
                                      len(self.tiles))
        t1 = time.perf_counter()
        reg = p.regularization if (p.regularization != M.NONE
                                   and p.lam > 0) else M.NONE
        out = _dsolve.relax_on_device(
            self.problem, link_mask, self.fixed_mask, warm_t, p.lam,
            p.damping, p.max_error, p.max_iterations, p.model, reg,
            p.max_plateau_width)
        timings = {"warm_start": t1 - t0,
                   "relax": time.perf_counter() - t1}
        err = float(out.history[-1]) if out.iterations else 0.0
        link_errors = {
            (lk.key_a, lk.key_b): float(out.link_errors[l])
            for l, lk in enumerate(self.links) if link_mask[l]
        }
        return SolveResult(
            {k: out.models[i].copy() for k, i in self.index.items()},
            err, out.iterations, [], link_errors, history=out.history,
            timings=timings, shards=self.n_shards,
        )


def _worst_link(res: SolveResult, params: SolverParams, verbose: bool):
    """The link to drop (SimpleIterativeConvergenceStrategy): the worst,
    when it is BOTH many times worse than the average AND above the
    absolute floor; else None."""
    avg = float(np.mean(list(res.link_errors.values())))
    worst_key = max(res.link_errors, key=res.link_errors.get)
    worst = res.link_errors[worst_key]
    if not (worst > params.relative_threshold * avg
            and worst > params.absolute_threshold):
        return None
    if verbose:
        print(f"solver: dropping link {worst_key[0][0]}<->"
              f"{worst_key[1][0]} error {worst:.2f} (avg {avg:.2f})")
    return worst_key


def solve_iterative(
    links: list[MatchLink], tiles: list[Key], fixed: set[Key], params: SolverParams,
    verbose: bool = True,
) -> SolveResult:
    """GlobalOptIterative: re-solve dropping the worst link while it exceeds
    max(relThresh × avg, absThresh) (Solver.java:310-318; defaults
    relative 3.5 / absolute 7.0, Solver.java:131-134).

    On the device backend the link list is flattened ONCE and every
    re-solve re-enters the relaxation with a zeroed entry in the link-weight
    mask — no array rebuild."""
    links = list(links)
    removed: list[tuple[Key, Key]] = []
    timings: dict[str, float] = {}
    if _resolve_backend(params) == "device" and links:
        state = _DeviceRelax(links, tiles, fixed, params)
        key_to_l = {(lk.key_a, lk.key_b): l for l, lk in enumerate(links)}
        mask = np.ones(len(links))
        while True:
            res = state.solve(mask)
            for k, v in res.timings.items():
                _add_time(timings, k, v)
            if not res.link_errors or int(mask.sum()) <= 1:
                break
            worst_key = _worst_link(res, params, verbose)
            if worst_key is None:
                break
            mask[key_to_l[worst_key]] = 0.0
            removed.append(worst_key)
    else:
        while True:
            res = _relax_numpy(links, tiles, fixed, params)
            for k, v in res.timings.items():
                _add_time(timings, k, v)
            if not res.link_errors or len(links) <= 1:
                break
            worst_key = _worst_link(res, params, verbose)
            if worst_key is None:
                break
            links = [lk for lk in links if (lk.key_a, lk.key_b) != worst_key]
            removed.append(worst_key)
    res.removed_links.extend(removed)
    res.timings = timings
    return res


# ---------------------------------------------------------------------------
# subsets, fixed views, two-round
# ---------------------------------------------------------------------------

def connected_components(tiles: list[Key], links: list[MatchLink]) -> list[list[Key]]:
    parent = {k: k for k in tiles}

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for lk in links:
        if lk.key_a in parent and lk.key_b in parent:
            parent[find(lk.key_a)] = find(lk.key_b)
    comps: dict[Key, list[Key]] = {}
    for k in tiles:
        comps.setdefault(find(k), []).append(k)
    return sorted(comps.values(), key=lambda c: c[0])


def pick_fixed(tiles: list[Key], params: SolverParams) -> set[Key]:
    """User-specified fixed views, else the first tile per timepoint subset
    (Solver.java:675-718)."""
    if params.disable_fixed_views:
        return set()
    if params.fixed_views:
        fixed = set()
        for t in tiles:
            if any(v in params.fixed_views for v in t):
                fixed.add(t)
        return fixed
    first_per_tp: dict[int, Key] = {}
    for t in tiles:
        tp = t[0].timepoint
        first_per_tp.setdefault(tp, t)
    return set(first_per_tp.values())


def solve(
    sd: SpimData,
    views: list[ViewId],
    params: SolverParams,
    store: InterestPointStore | None = None,
    verbose: bool = True,
) -> SolveResult:
    """Full solve: assemble matches, pick fixed tiles, run the requested
    method, return per-tile corrections (not yet stored into the XML)."""
    t0 = time.perf_counter()
    tiles = build_tiles(sd, views, params)
    if params.source.upper() == "STITCHING":
        links = matches_from_stitching(sd, tiles, verbose)
    else:
        if store is None:
            store = InterestPointStore.for_project(sd)
        labels = params.labels or _all_labels(sd, views)
        links = matches_from_interest_points(
            sd, tiles, store, labels, params.label_weights, verbose
        )
    timings = {"matches": time.perf_counter() - t0}
    if verbose:
        print(f"solver: {len(tiles)} tiles, {len(links)} links, "
              f"method {params.method}, model {params.model}"
              + (f" reg {params.regularization} λ={params.lam}"
                 if params.regularization != M.NONE else ""))

    fixed = pick_fixed(tiles, params)
    iterative = params.method.endswith("ITERATIVE")
    two_round = params.method.startswith("TWO_ROUND")

    comps = connected_components(tiles, links)
    corrections: dict[Key, np.ndarray] = {}
    total_err, total_it, shards = 0.0, 0, 1
    removed: list[tuple[Key, Key]] = []
    link_errors: dict[tuple[Key, Key], float] = {}
    for comp in comps:
        comp_set = set(comp)
        comp_links = [lk for lk in links
                      if lk.key_a in comp_set and lk.key_b in comp_set]
        comp_fixed = fixed & comp_set
        if not comp_fixed:
            comp_fixed = {comp[0]}  # per-subset anchor (round-1 of two-round)
        if iterative:
            res = solve_iterative(comp_links, comp, comp_fixed, params,
                                  verbose)
        else:
            res = relax(comp_links, comp, comp_fixed, params)
        corrections.update(res.corrections)
        total_err = max(total_err, res.error)
        total_it += res.iterations
        shards = max(shards, res.shards)
        removed.extend(res.removed_links)
        link_errors.update(res.link_errors)
        for k, v in res.timings.items():
            _add_time(timings, k, v)

    if two_round and len(comps) > 1:
        _align_components_to_metadata(comps, corrections, fixed, verbose)
    elif not two_round and len(comps) > 1 and verbose:
        print(f"solver: WARNING {len(comps)} unconnected subsets solved "
              "independently (use TWO_ROUND_* to place them via metadata)")

    if verbose:
        print(f"solver: done, max subset error {total_err:.3f} px "
              f"({total_it} iterations total"
              + (f", {len(removed)} links removed" if removed else "") + ")")
        if total_err > params.max_error:
            print(f"solver: WARNING did not reach --maxError "
                  f"{params.max_error} px (best {total_err:.3f} px)")
    return SolveResult(corrections, total_err, total_it, removed, link_errors,
                       timings=timings, shards=shards)


def _align_components_to_metadata(comps, corrections, fixed, verbose):
    """Round 2 of GlobalOptTwoRound (Solver.java:324-338), simplified: each
    component without a globally fixed tile gets a rigid-free translation
    removing its mean correction, so unconnected groups stay where the
    metadata (current registrations) places them — the role of
    MetaDataWeakLinkFactory weak links."""
    for comp in comps:
        if any(k in fixed for k in comp):
            continue
        mean_t = np.mean([corrections[k][:, 3] for k in comp], axis=0)
        for k in comp:
            corrections[k] = corrections[k].copy()
            corrections[k][:, 3] -= mean_t
        if verbose:
            print(f"solver: re-anchored unconnected subset of {len(comp)} "
                  f"tile(s) to metadata (Δ={np.round(mean_t, 2)})")


def _all_labels(sd: SpimData, views: list[ViewId]) -> list[str]:
    labels = []
    for v in views:
        for lab in sd.interest_points.get(v, {}):
            if lab not in labels:
                labels.append(lab)
    return labels


def store_corrections(
    sd: SpimData, result: SolveResult, params: SolverParams
) -> None:
    """Preconcatenate each tile's correction to all member views
    (TransformationTools.storeTransformation, Solver.java:351-369)."""
    name = f"{params.model.capitalize()}Model3D"
    if params.regularization != M.NONE:
        name += f" regularized by {params.regularization.capitalize()} (λ={params.lam})"
    name += f" on [{params.source.lower()}]"
    for key, corr in result.corrections.items():
        for v in key:
            sd.preconcatenate_transform(v, ViewTransform(name, corr.copy()))
