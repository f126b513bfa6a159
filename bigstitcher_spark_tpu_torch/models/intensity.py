"""Intensity matching and solving driver: per-pair cell sampling, RANSAC
line fits (K23), the global coefficient solve (K24/K25), the coefficients
store.

Port of ``bigstitcher_spark_tpu/models/intensity.py`` (SparkIntensityMatching
and IntensitySolver roles). Every view gets a coarse coefficient grid
(default 8x8x8 cells, ``--renderScale 0.25``); each overlapping view pair
contributes co-located intensity samples per cell pair; the pairwise line
fits of a pair run in one K23 launch (:mod:`..ops.intensity`), pairs
pipelined through :mod:`..parallel.pairsched` (dispatch samples on the host
and launches K23, drain fetches the fits and trims them on the host); the
global solve assembles the fits' sufficient statistics into one quadratic
form and solves it by CG on the device. Coefficients persist to an N5
(``coefficients/setup{s}/timepoint{t}/coefficients``, shape (2, cx, cy, cz))
that ``affine-fusion --intensityN5`` applies per view inside K1 / K3.
The store is byte-compatible with the JAX package's.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..io.chunkstore import ChunkStore, StorageFormat
from ..io.dataset_io import ViewLoader, best_mipmap_level
from ..io.spimdata import SpimData, ViewId
from ..ops import intensity as OI
from ..ops.descriptors import StageTimes
from ..ops.dog import sample_trilinear
from ..parallel.pairsched import PairTask, run_pair_tasks
from ..utils.device import resolve_device
from ..utils.geometry import Interval, invert_affine, transformed_interval


@dataclass
class IntensityParams:
    """Defaults follow the reference CLI (SparkIntensityMatching.java)."""

    coefficients: tuple[int, int, int] = (8, 8, 8)
    render_scale: float = 0.25
    method: str = "RANSAC"            # RANSAC | HISTOGRAM
    ransac_epsilon: float = 0.02      # relative to [0,1]-normalized intensity
    ransac_iterations: int = 1000
    min_samples_per_cell: int = 10
    lam: float = 0.1                  # solve regularization toward identity
    max_samples_per_cell: int = 2000
    # reference candidate/inlier filters (SparkIntensityMatching.java:51-77)
    min_threshold: float = 1.0        # --minThreshold: discard samples below
    max_threshold: float = float("nan")  # --maxThreshold: discard above
    min_num_candidates: int = 1000    # --minNumCandidates per cell pair
    min_inlier_ratio: float = 0.1     # --minInlierRatio (RANSAC)
    min_num_inliers: int = 10         # --minNumInliers (RANSAC)
    max_trust: float = 3.0            # --maxTrust: drop inliers with residual
    #                                   > maxTrust * median residual


@dataclass
class CellMatch:
    view_a: ViewId
    view_b: ViewId
    cell_a: int                # flat cell index within view A's grid
    cell_b: int
    stats: tuple[float, ...]   # (n, Sx, Sy, Sxx, Syy, Sxy) of inlier samples
    fit: tuple[float, float]   # (a, b): i_b ~= a*i_a + b


@dataclass
class IntensityStats:
    """What one matching run did: view pairs, cell pairs fitted (those
    with enough candidates), cell matches kept, wall seconds, and
    ``timings``: host seconds of sampling the views and grouping the
    samples (``sample``), of the K23 calls and the wait for their fits
    (``ransac``), of the trim and float64 refit (``trim``), of saving
    (``store``, filled by the command). ``kernel``: the card's seconds of
    K23 (CUDA events; on the CPU the twin's host seconds)."""

    pairs: int = 0
    cell_pairs: int = 0
    matches: int = 0
    seconds: float = 0.0
    timings: dict = field(default_factory=lambda: dict.fromkeys(
        ("sample", "ransac", "trim", "store"), 0.0))
    kernel: float = 0.0


def _cell_index(px: np.ndarray, view_size: np.ndarray, dims) -> np.ndarray:
    """Flat coefficient-cell index for full-res pixel coords (N,3)."""
    cell = np.floor(px / (view_size / np.asarray(dims, np.float64))).astype(int)
    cell = np.clip(cell, 0, np.asarray(dims) - 1)
    return (cell[:, 0] * dims[1] + cell[:, 1]) * dims[2] + cell[:, 2]


def _sample_view(sd, loader, view, world_pts):
    """Intensities + full-res px coords of world points inside the view
    (NaN outside)."""
    inv = invert_affine(sd.model(view))
    px = world_pts @ inv[:, :3].T + inv[:, 3]
    size = np.array(sd.view_size(view), np.float64)
    inside = np.all((px >= 0) & (px <= size - 1), axis=1)
    vals = np.full(len(px), np.nan)
    if inside.any():
        ds_factors = loader.downsampling_factors(view.setup)
        lvl = best_mipmap_level(ds_factors, (2, 2, 2))
        f = np.asarray(ds_factors[lvl], np.float64)
        lpx = (px[inside] - (f - 1) / 2.0) / f
        lo = np.maximum(np.floor(lpx.min(axis=0)).astype(int) - 1, 0)
        hi = np.ceil(lpx.max(axis=0)).astype(int) + 2
        patch = loader.read_block(view, lvl, lo, hi - lo).astype(np.float32)
        vals[inside] = sample_trilinear(patch, lpx - lo)
    return vals, px, inside


@dataclass
class _PairWork:
    """One view pair between dispatch and drain."""

    va: ViewId
    vb: ViewId
    xa: np.ndarray = None        # kept samples, original units
    xb: np.ndarray = None
    scale: float = 1.0
    pairs: list = field(default_factory=list)  # (cell_a, cell_b, sel)
    fits: object = None          # ops.intensity.LineFit or host fits


def _collect_samples(sd, loader, va, vb, params) -> _PairWork:
    """Co-located samples in the pair overlap on a renderScale grid,
    thresholded, normalised to [0, 1] and grouped by cell pair (lexsort),
    strided down to ``max_samples_per_cell``."""
    work = _PairWork(va, vb)
    box_a = transformed_interval(sd.model(va), Interval.from_shape(sd.view_size(va)))
    box_b = transformed_interval(sd.model(vb), Interval.from_shape(sd.view_size(vb)))
    ov = box_a.intersect(box_b)
    if ov.is_empty():
        return work
    step = max(1.0 / params.render_scale, 1.0)
    axes = [np.arange(ov.min[d], ov.max[d] + 1, step) for d in range(3)]
    gx, gy, gz = np.meshgrid(*axes, indexing="ij")
    world = np.stack([gx.ravel(), gy.ravel(), gz.ravel()], axis=-1)

    ia, pa, in_a = _sample_view(sd, loader, va, world)
    ib, pb, in_b = _sample_view(sd, loader, vb, world)
    both = in_a & in_b & np.isfinite(ia) & np.isfinite(ib)
    both &= (ia >= params.min_threshold) & (ib >= params.min_threshold)
    if np.isfinite(params.max_threshold):
        both &= (ia <= params.max_threshold) & (ib <= params.max_threshold)
    if not both.any():
        return work
    dims = params.coefficients
    ca = _cell_index(pa[both], np.array(sd.view_size(va), np.float64), dims)
    cb = _cell_index(pb[both], np.array(sd.view_size(vb), np.float64), dims)
    work.xa, work.xb = ia[both], ib[both]
    # normalize to [0,1] for a scale-free RANSAC epsilon
    work.scale = max(float(np.max(work.xa)), float(np.max(work.xb)), 1e-9)

    order = np.lexsort((cb, ca))
    keys = np.stack([ca[order], cb[order]], axis=1)
    uniq, starts = np.unique(keys, axis=0, return_index=True)
    bounds = list(starts) + [len(order)]
    min_cand = max(params.min_samples_per_cell, params.min_num_candidates)
    for i, (cell_a, cell_b) in enumerate(uniq):
        sel = order[bounds[i]:bounds[i + 1]]
        if len(sel) < min_cand:
            continue
        if len(sel) > params.max_samples_per_cell:
            sel = sel[:: len(sel) // params.max_samples_per_cell + 1]
        work.pairs.append((int(cell_a), int(cell_b), sel))
    return work


def _dispatch_pair(sd, loader, va, vb, params, seed, dev,
                   timer: StageTimes) -> _PairWork:
    """Sample the pair on the host, then launch K23 on its cell pairs (or
    fit histograms on the host); the fits stay on the device."""
    t0 = time.perf_counter()
    work = _collect_samples(sd, loader, va, vb, params)
    if not work.pairs:
        timer.host["sample"] += time.perf_counter() - t0
        return work
    sa = [work.xa[sel] / work.scale for _, _, sel in work.pairs]
    sb = [work.xb[sel] / work.scale for _, _, sel in work.pairs]
    if params.method.upper() == "HISTOGRAM":
        work.fits = OI.match_cells_histogram(sa, sb,
                                             params.min_samples_per_cell)
        timer.host["sample"] += time.perf_counter() - t0
        return work
    x, y, v = OI.pack_samples(sa, sb, dev)
    hyp = OI.draw_hypotheses(seed, x.shape[0], x.shape[1],
                             params.ransac_iterations, dev)
    timer.host["sample"] += time.perf_counter() - t0
    with timer.stage("ransac", dev):
        work.fits = OI.linefit_ransac(x, y, v, hyp, params.ransac_epsilon)
    return work


def _finish_pair(work: _PairWork, params, timer: StageTimes
                 ) -> list[CellMatch]:
    """Fetch the pair's fits, then trim each cell pair's inliers by
    ``--maxTrust`` with float64 refits and keep those that pass the
    inlier filters; stats in original intensity units."""
    if not work.pairs:
        return []
    fits = work.fits
    if params.method.upper() != "HISTOGRAM":
        t0 = time.perf_counter()
        fits = OI.finish_cells_ransac(
            fits, [sel for _, _, sel in work.pairs],
            params.min_samples_per_cell)
        timer.host["ransac"] += time.perf_counter() - t0
    t0 = time.perf_counter()
    out = []
    scale = work.scale
    for (cell_a, cell_b, sel), fit in zip(work.pairs, fits):
        if fit is None:
            continue
        a, b, _ = fit
        x, y = work.xa[sel], work.xb[sel]
        xn, yn = x / scale, y / scale
        resid = np.abs(yn - (a * xn + b))
        inl = resid < 2.0 * params.ransac_epsilon
        # --maxTrust: iterative trim + refit (mpicbg filterRansac: drop
        # candidates with residual > maxTrust * median, refit, repeat)
        for _ in range(10):
            if inl.sum() < 2:
                break
            A = np.stack([xn[inl], np.ones(int(inl.sum()))], axis=1)
            (a, b), *_ = np.linalg.lstsq(A, yn[inl], rcond=None)
            resid = np.abs(yn - (a * xn + b))
            med = float(np.median(resid[inl]))
            new_inl = inl & (resid <= max(params.max_trust * med, 1e-12))
            if (new_inl == inl).all():
                break
            inl = new_inl
        if inl.sum() < max(params.min_samples_per_cell,
                           params.min_num_inliers):
            continue
        if inl.sum() < params.min_inlier_ratio * len(sel):
            continue
        out.append(CellMatch(work.va, work.vb, int(cell_a), int(cell_b),
                             OI.match_stats(x[inl], y[inl]),
                             (float(a), float(b * scale))))
    timer.host["trim"] += time.perf_counter() - t0
    return out


def match_pair_intensities(sd: SpimData, loader: ViewLoader, va: ViewId,
                           vb: ViewId, params: IntensityParams,
                           seed: int = 5, device=None) -> list[CellMatch]:
    """Collect co-located samples in the pair overlap on a renderScale grid
    and fit per-cell-pair linear maps (on ``device``, default ``cuda``)."""
    dev = resolve_device(device)
    timer = StageTimes()
    return _finish_pair(_dispatch_pair(sd, loader, va, vb, params, seed, dev,
                                       timer), params, timer)


def _overlapping_pairs(sd, views, params):
    """[(va, vb, overlap sample count)] of same-timepoint overlapping view
    pairs, views sorted (SparkIntensityMatching.java:146-166)."""
    boxes = {v: transformed_interval(sd.model(v),
                                     Interval.from_shape(sd.view_size(v)))
             for v in views}
    step = max(1.0 / params.render_scale, 1.0)
    out = []
    for i in range(len(views)):
        for j in range(i + 1, len(views)):
            va, vb = views[i], views[j]
            if va.timepoint != vb.timepoint or not boxes[va].overlaps(boxes[vb]):
                continue
            ov = boxes[va].intersect(boxes[vb])
            n = float(np.prod([max(1.0, (ov.shape[d] - 1) / step + 1)
                               for d in range(3)]))
            out.append((va, vb, n))
    return out


def match_intensities(sd: SpimData, loader: ViewLoader, views: list[ViewId],
                      params: IntensityParams | None = None,
                      progress: bool = True, device=None,
                      stats: IntensityStats | None = None
                      ) -> list[CellMatch]:
    """Cell matches of all overlapping pairs on ``device`` (default
    ``cuda``). Pair k gets seed 5 + k, so placement never changes a fit;
    pairs run through the pair scheduler (dispatch: sample and launch K23;
    drain: fetch and trim). ``stats`` is filled if given."""
    dev = resolve_device(device)
    params = params or IntensityParams()
    stats = stats if stats is not None else IntensityStats()
    t_start = time.perf_counter()
    views = sorted(views)
    pairs = _overlapping_pairs(sd, views, params)
    timer = StageTimes()
    tasks = [PairTask(index=k, nbytes=int(12 * n), tag=(k, va, vb))
             for k, (va, vb, n) in enumerate(pairs)]

    def dispatch(task):
        k, va, vb = task.tag
        return _dispatch_pair(sd, loader, va, vb, params, 5 + k, dev, timer)

    def drain(_tasks, handles):
        out = []
        for work in handles:
            stats.cell_pairs += len(work.pairs)
            out.append(_finish_pair(work, params, timer))
        return out

    outs = run_pair_tasks(tasks, dispatch, drain, device=dev)
    timer.resolve()
    matches: list[CellMatch] = []
    for (va, vb, _n), m in zip(pairs, outs):
        matches.extend(m)
        if progress:
            print(f"  {va} <-> {vb}: {len(m)} cell matches", flush=True)
    stats.pairs += len(pairs)
    stats.matches += len(matches)
    for k in ("sample", "ransac", "trim"):
        stats.timings[k] += timer.host[k]
    stats.kernel += timer.device["ransac"]
    stats.seconds += time.perf_counter() - t_start
    return matches


# --------------------------------------------------------------------------
# persistence (matches + coefficients N5)
# --------------------------------------------------------------------------

MATCH_GROUP = "matches"
COEFF_GROUP = "coefficients"


class IntensityStore:
    """N5 store for pairwise cell matches and solved coefficients
    (ViewPairCoefficientMatchesIO + Coefficients persistence role): the
    JAX package's layout, readable by either package."""

    def __init__(self, root: str):
        self.root = str(root)
        if os.path.isdir(self.root):
            self.store = ChunkStore.open(self.root)
        else:
            self.store = ChunkStore.create(self.root, StorageFormat.N5)

    @staticmethod
    def for_project(sd: SpimData, name: str = "intensity.n5") -> "IntensityStore":
        base = os.path.dirname(sd.xml_path or ".")
        return IntensityStore(os.path.join(base, name))

    @staticmethod
    def _pair_path(va: ViewId, vb: ViewId) -> str:
        return (f"{MATCH_GROUP}/tpId_{va.timepoint}_viewSetupId_{va.setup}"
                f"__tpId_{vb.timepoint}_viewSetupId_{vb.setup}")

    def save_matches(self, matches: list[CellMatch],
                     dims: tuple[int, int, int]) -> None:
        """One (M, 10) float64 dataset per view pair: cell_a, cell_b, the
        six statistics, the fit (a, b); ``coefficientDims`` on the group."""
        by_pair: dict[tuple[ViewId, ViewId], list[CellMatch]] = {}
        for m in matches:
            by_pair.setdefault((m.view_a, m.view_b), []).append(m)
        if self.store.exists(MATCH_GROUP):
            self.store.remove(MATCH_GROUP)
        for (va, vb), ms in by_pair.items():
            rows = np.array([[m.cell_a, m.cell_b, *m.stats, *m.fit]
                             for m in ms], np.float64)
            ds = self.store.create_dataset(
                f"{self._pair_path(va, vb)}/data", rows.shape,
                (max(len(ms), 1), 10), "float64")
            ds.write(rows, (0, 0))
        self.store.set_attribute(MATCH_GROUP, "coefficientDims", list(dims))

    def load_all_matches(self) -> list[CellMatch]:
        out = []
        if not self.store.exists(MATCH_GROUP):
            return out
        for name in self.store.list_children(MATCH_GROUP):
            a, b = name.split("__")
            va = ViewId(int(a.split("_")[1]), int(a.split("_")[3]))
            vb = ViewId(int(b.split("_")[1]), int(b.split("_")[3]))
            rows = self.store.open_dataset(
                f"{MATCH_GROUP}/{name}/data").read_full()
            for r in rows:
                out.append(CellMatch(va, vb, int(r[0]), int(r[1]),
                                     tuple(r[2:8]), (r[8], r[9])))
        return out

    def coefficient_dims(self) -> tuple[int, int, int] | None:
        d = self.store.get_attribute(MATCH_GROUP, "coefficientDims", None)
        return tuple(int(v) for v in d) if d else None

    @staticmethod
    def _coeff_path(view: ViewId, group, dataset) -> str:
        return (f"{group or COEFF_GROUP}/setup{view.setup}"
                f"/timepoint{view.timepoint}/{dataset or 'coefficients'}")

    def save_coefficients(self, view: ViewId, coeffs: np.ndarray,
                          group: str | None = None,
                          dataset: str | None = None) -> None:
        """coeffs (cx,cy,cz,2) -> dataset (2,cx,cy,cz) float64. ``group`` /
        ``dataset`` override the default layout (--intensityN5Group /
        --intensityN5Dataset, IntensitySolver.java)."""
        path = self._coeff_path(view, group, dataset)
        arr = np.moveaxis(np.asarray(coeffs), -1, 0).astype(np.float64)
        if self.store.exists(path):
            self.store.remove(path)
        ds = self.store.create_dataset(path, arr.shape, arr.shape, "float64")
        ds.write(arr, (0,) * arr.ndim)

    def load_coefficients(self, view: ViewId, group: str | None = None,
                          dataset: str | None = None) -> np.ndarray | None:
        path = self._coeff_path(view, group, dataset)
        if not self.store.is_dataset(path):
            return None
        return np.moveaxis(self.store.open_dataset(path).read_full(), 0, -1)


def smoothness_pairs(dims: tuple[int, int, int], n_views: int) -> np.ndarray:
    """Intra-view adjacent-cell pairs of every view's coefficient grid, a
    (P, 2) array of global flat cell indices, axis-major order."""
    ncell = int(np.prod(dims))
    idx = np.arange(ncell).reshape(dims)
    per_axis = []
    for d in range(3):
        lo = [slice(None)] * 3
        hi = [slice(None)] * 3
        lo[d] = slice(0, dims[d] - 1)
        hi[d] = slice(1, dims[d])
        per_axis.append(np.stack(
            [idx[tuple(lo)].ravel(), idx[tuple(hi)].ravel()], axis=1))
    base = np.concatenate(per_axis, axis=0)
    offs = (np.arange(n_views) * ncell)[:, None, None]
    return (base[None, :, :] + offs).reshape(-1, 2)


def solve_intensities(matches: list[CellMatch], views: list[ViewId],
                      dims: tuple[int, int, int], lam: float = 0.1,
                      progress: bool = True, device=None,
                      backend: str | None = None,
                      devices=None) -> dict[ViewId, np.ndarray]:
    """Global solve -> per-view (cx,cy,cz,2) [scale, offset] grids, on
    ``device`` (default ``cuda``), or over the solve mesh ``devices``
    (``ops.intensity.solve_intensity_coefficients``). The quadratic form is
    normalised by the mean matched intensity so ``lam`` is scale-free; a
    solve on the device also registers its grids with the fusion
    coefficient table there (a sharded solve: the first mesh device's
    replicated solution)."""
    from .affine_fusion import register_coefficient_table

    dev = resolve_device(device)
    views = sorted(views)
    ncell = int(np.prod(dims))
    base = {v: i * ncell for i, v in enumerate(views)}
    stats_rows = [(base[m.view_a] + m.cell_a, base[m.view_b] + m.cell_b,
                   *m.stats) for m in matches
                  if m.view_a in base and m.view_b in base]
    if progress:
        print(f"solve-intensities: {len(views)} views x {ncell} cells, "
              f"{len(stats_rows)} matches, λ={lam}", flush=True)
    mean_i = (np.mean([r[3] / max(r[2], 1) for r in stats_rows])
              if stats_rows else 1.0)
    s = 1.0 / max(mean_i, 1e-9)
    norm = [(int(ca), int(cb), n, sx * s, sy * s, sxx * s * s, syy * s * s,
             sxy * s * s) for ca, cb, n, sx, sy, sxx, syy, sxy in stats_rows]
    smooth = smoothness_pairs(dims, len(views))
    dev_sol: list = []
    sol = OI.solve_intensity_coefficients(
        ncell * len(views), norm, lam, smooth_pairs=smooth, backend=backend,
        on_device_solution=dev_sol.append, device=dev, devices=devices)
    out = {}
    for v in views:
        c = sol[base[v]: base[v] + ncell].copy()
        c[:, 1] /= s
        out[v] = c.reshape(*dims, 2)
    if dev_sol:
        # the host un-normalisation, repeated on the device (the same
        # float64 operations): the table equals one built from ``out``
        d = dev_sol[0][: 2 * ncell * len(views)].reshape(-1, 2)
        per = {}
        for v in views:
            c = d[base[v]: base[v] + ncell]
            c = torch.cat([c[:, :1], c[:, 1:] / s], dim=1)
            per[v] = c.reshape(*dims, 2).to(torch.float32)
        register_coefficient_table(out, per)
    return out
