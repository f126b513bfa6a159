"""Pairwise interest-point matching driver: pair planning per timepoint
policy, descriptor matching + RANSAC (or ICP), correspondence storage.

Port of ``bigstitcher_spark_tpu/models/matching.py`` (SparkGeometricDescriptorMatching,
reference call stack SURVEY.md §3.4) on one device: the work list is the
overlapping view pairs; per pair, interest points are world-transformed
under the current registrations, candidate correspondences come from the
descriptor kernels (K19, K20) and are verified by hypothesis-parallel
RANSAC (K21, K22) (``ops/descriptors.py``). Inliers are stored
symmetrically into interestpoints.n5 ``correspondences`` datasets, the
format the ported solver's IP source reads.

Pairs run through the pair scheduler (``parallel/pairsched.py``): a
pair's dispatch uploads its two clouds and enqueues K19 and K20; its drain
fetches the candidates and runs RANSAC or ICP, which wait on the card.
The next segment's pairs are dispatched before the previous one drains.

Grouped matching (--groupChannels/--groupTiles/--groupIllums/
--splitTimepoints): member views' interest points are pooled in world space,
near-duplicates across views are merged within ``merge_distance`` px
(InterestPointGroupingMinDistance role), the pooled clouds are matched as one
pair, and the inliers are split back per original view pair — per-view lists
smaller than the model's minimum match count are dropped
(SparkGeometricDescriptorMatching.java:343-503).
"""

from __future__ import annotations

import time
import warnings
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import NotYetPorted
from ..io.interestpoints import CorrespondingPoint, InterestPointStore
from ..io.spimdata import SpimData, ViewId
from ..ops import descriptors as D
from ..ops import models as M
from ..parallel.pairsched import PairTask, run_pair_tasks
from ..utils.device import resolve_device
from ..utils.geometry import Interval, apply_affine, transformed_interval

INDIVIDUAL_TIMEPOINTS = "TIMEPOINTS_INDIVIDUALLY"
ALL_TO_ALL = "ALL_TO_ALL"
ALL_TO_ALL_RANGE = "ALL_TO_ALL_WITH_RANGE"
REFERENCE_TIMEPOINT = "REFERENCE_TIMEPOINT"


@dataclass
class MatchingParams:
    """Defaults follow the reference CLI
    (SparkGeometricDescriptorMatching.java:82,180-189; AbstractRegistration.java:59-108)."""

    label: str = "beads"
    labels: tuple = ()                   # extra labels (-l repeatable)
    match_across_labels: bool = False    # --matchAcrossLabels
    method: str = D.GEOMETRIC_HASHING   # FAST_ROTATION|FAST_TRANSLATION|PRECISE_TRANSLATION|ICP
    model: str = M.AFFINE
    regularization: str = M.RIGID
    lam: float = 0.1
    n_neighbors: int = 3
    redundancy: int = 1
    ratio_of_distance: float = 3.0
    ransac_iterations: int = 10000
    ransac_max_epsilon: float = 5.0
    ransac_min_inlier_ratio: float = 0.1
    ransac_min_inliers: int = 12
    ransac_multi_consensus: bool = False  # --ransacMultiConsensus (-rmc)
    search_radius: float | None = None   # -sr: world-space candidate limit
    icp_max_distance: float = 2.5
    icp_max_iterations: int = 200
    icp_use_ransac: bool = False         # --icpUseRANSAC
    registration_tp: str = INDIVIDUAL_TIMEPOINTS
    reference_tp: int = 0
    range_tp: int = 5
    overlap_filter: bool = True          # SimpleBoundingBoxOverlap vs all-against-all
    interest_points_for_overlap_only: bool = False
    clear_correspondences: bool = False
    # grouping (SparkGeometricDescriptorMatching.java:115-129)
    group_tiles: bool = False
    group_channels: bool = False
    group_illums: bool = False
    split_timepoints: bool = False
    merge_distance: float = 5.0          # --interestPointMergeDistance

    @property
    def all_labels(self) -> tuple:
        out = [self.label]
        for l in self.labels:
            if l not in out:
                out.append(l)
        return tuple(out)

    def label_pairs(self):
        """(label_a, label_b) matching tasks: same-label always; with
        --matchAcrossLabels BOTH directions of every cross-label combo,
        because each view pair is planned once unordered — (beads of A vs
        nuclei of B) and (nuclei of A vs beads of B) are distinct pairings
        (MatcherPairwiseTools.getTasksList role)."""
        ls = self.all_labels
        out = [(l, l) for l in ls]
        if self.match_across_labels:
            for i in range(len(ls)):
                for j in range(len(ls)):
                    if i != j:
                        out.append((ls[i], ls[j]))
        return out

    @property
    def grouped(self) -> bool:
        return (self.group_tiles or self.group_channels or self.group_illums
                or self.split_timepoints)


@dataclass
class PairMatchResult:
    view_a: ViewId
    view_b: ViewId
    ids_a: np.ndarray        # (K,) interest-point ids on A
    ids_b: np.ndarray
    model: np.ndarray | None
    n_candidates: int
    label_a: str = "beads"
    label_b: str = "beads"


@dataclass
class MatchingStats:
    """What one matching run did: pairs (tasks) matched, candidate and
    inlier counts, wall seconds, and ``timings``: host seconds of loading
    and transforming the points (``load``), of the calls of each device
    stage (``descriptors``: K19, ``ratio``: K20, ``ransac``: draws, K21,
    K22 and the final float64 refit), of waiting for and copying the
    candidates (``fetch``), of the rest of the host work (``host``:
    candidate dedup, filters, ICP's host loop, split-back), and of saving
    (``store``, filled by the command). ``kernels`` holds the card's
    seconds of the device stages (CUDA events; on the CPU the twins' host
    seconds)."""

    pairs: int = 0
    candidates: int = 0
    inliers: int = 0
    seconds: float = 0.0
    timings: dict = field(default_factory=lambda: dict.fromkeys(
        ("load", "descriptors", "ratio", "ransac", "fetch", "host", "store"),
        0.0))
    kernels: dict = field(default_factory=lambda: dict.fromkeys(
        ("descriptors", "ratio", "ransac"), 0.0))


def _tp_allowed(policy: str, ta: int, tb: int, params: MatchingParams) -> bool:
    if policy == INDIVIDUAL_TIMEPOINTS:
        return ta == tb
    if policy == ALL_TO_ALL_RANGE:
        return abs(ta - tb) <= params.range_tp
    if policy == REFERENCE_TIMEPOINT:
        # each timepoint registers against the reference timepoint
        return ta == tb or params.reference_tp in (ta, tb)
    return True  # ALL_TO_ALL: no timepoint restriction


def plan_match_pairs(
    sd: SpimData, views: list[ViewId], params: MatchingParams
) -> list[tuple[ViewId, ViewId]]:
    """Enumerate view pairs per timepoint policy + overlap filter
    (PairwiseSetup constellation, AbstractRegistration.java:143-179)."""
    views = sorted(views)
    boxes = {
        v: transformed_interval(sd.model(v), Interval.from_shape(sd.view_size(v)))
        for v in views
    }
    policy = params.registration_tp.upper()
    out = []
    for i in range(len(views)):
        for j in range(i + 1, len(views)):
            a, b = views[i], views[j]
            if not _tp_allowed(policy, a.timepoint, b.timepoint, params):
                continue
            if params.overlap_filter and not boxes[a].overlaps(boxes[b]):
                continue
            out.append((a, b))
    return out


def _in_box(world: np.ndarray, box: Interval) -> np.ndarray:
    if not len(world):
        return np.zeros(0, bool)
    return np.all((world >= np.array(box.min)) & (world <= np.array(box.max)),
                  axis=1)


def _filter_to_overlap(
    sd: SpimData, ids, world, view: ViewId, other: ViewId
) -> tuple[np.ndarray, np.ndarray]:
    """Keep only points inside the pair's world overlap bbox (+epsilon)
    (filterForOverlappingInterestPoints, SparkGeometricDescriptorMatching.java:294-305)."""
    box_a = transformed_interval(sd.model(view), Interval.from_shape(sd.view_size(view)))
    box_b = transformed_interval(sd.model(other), Interval.from_shape(sd.view_size(other)))
    ov = box_a.intersect(box_b).expand(2)
    if ov.is_empty() or not len(world):
        return ids[:0], world[:0]
    keep = _in_box(world, ov)
    return ids[keep], world[keep]


_NO_PAIRS = np.zeros((0, 2), np.int32)


def _launch_pair(wa, wb, params: MatchingParams, device, timer):
    """A pair's device work that needs no host decision: the descriptors
    and the ratio test (nothing for ICP)."""
    if params.method == D.ICP:
        return None
    return D.candidates_launch(wa, wb, params.method, params.n_neighbors,
                               params.redundancy, params.ratio_of_distance,
                               device, timer)


def _finish_pair(wa, wb, params: MatchingParams, seed: int, handle, device,
                 timer):
    """The rest of :func:`match_pair` once :func:`_launch_pair` ran."""
    ransac_kw = dict(model_kind=params.model, reg_kind=params.regularization,
                     lam=params.lam, epsilon=params.ransac_max_epsilon,
                     min_inlier_ratio=params.ransac_min_inlier_ratio,
                     min_inliers=params.ransac_min_inliers,
                     iterations=params.ransac_iterations, seed=seed,
                     device=device, timer=timer)
    if params.method == D.ICP:
        res = D.icp(
            wa, wb, params.model, params.regularization, params.lam,
            params.icp_max_distance, params.icp_max_iterations,
            use_ransac=params.icp_use_ransac,
            ransac_epsilon=params.ransac_max_epsilon,
            ransac_iterations=params.ransac_iterations, seed=seed,
            device=device, timer=timer,
        )
        if res is None:
            return _NO_PAIRS, None, 0
        model, pairs = res
        return pairs, model, len(pairs)

    cand = D.candidates_finish(handle, timer)
    if len(cand) == 0:
        return _NO_PAIRS, None, 0
    if params.search_radius is not None:
        # -sr limits corresponding points in global coordinate space
        # (SparkGeometricDescriptorMatching.java:93-94)
        d = np.linalg.norm(wa[cand[:, 0]] - wb[cand[:, 1]], axis=1)
        cand = cand[d <= float(params.search_radius)]
        if len(cand) == 0:
            return _NO_PAIRS, None, 0
    if params.ransac_multi_consensus:
        sets = D.ransac_multi(wa[cand[:, 0]], wb[cand[:, 1]], **ransac_kw)
        if not sets:
            return _NO_PAIRS, None, len(cand)
        union = np.zeros(len(cand), bool)
        for _, mask in sets:
            union |= mask
        # the dominant model represents the pair; correspondences keep
        # every consensus set (reference multiconsensus semantics)
        return cand[union], sets[0][0], len(cand)
    res = D.ransac(wa[cand[:, 0]], wb[cand[:, 1]], **ransac_kw)
    if res is None:
        return _NO_PAIRS, None, len(cand)
    model, inliers = res
    return cand[inliers], model, len(cand)


def match_pair(
    wa: np.ndarray, wb: np.ndarray, params: MatchingParams, seed: int = 17,
    device=None, timer: D.StageTimes | None = None,
) -> tuple[np.ndarray, np.ndarray | None, int]:
    """Match two world-space point clouds on ``device``.

    Returns (inlier index pairs (K,2) into wa/wb, model 3x4 a->b or None,
    n_candidates)."""
    dev = resolve_device(device)
    return _finish_pair(wa, wb, params, seed,
                        _launch_pair(wa, wb, params, dev, timer), dev, timer)


def build_match_groups(
    sd: SpimData, views: list[ViewId], params: MatchingParams
) -> list[tuple[ViewId, ...]]:
    """Partition views into match groups: a view's group key keeps every
    attribute EXCEPT the grouped ones (groups always stay within one
    timepoint; --splitTimepoints merges everything per timepoint)."""
    by_key: dict[tuple, list[ViewId]] = {}
    for v in sorted(views):
        s = sd.setups[v.setup]
        if params.split_timepoints:
            key = (v.timepoint,)
        else:
            key = (
                v.timepoint,
                s.attributes.get("angle", 0),
                None if params.group_channels else s.attributes.get("channel", 0),
                None if params.group_illums else s.attributes.get("illumination", 0),
                None if params.group_tiles else s.attributes.get("tile", 0),
            )
        by_key.setdefault(key, []).append(v)
    return [tuple(vs) for _, vs in sorted(by_key.items())]


def _group_bbox(sd: SpimData, group: tuple[ViewId, ...]) -> Interval:
    box = None
    for v in group:
        iv = transformed_interval(sd.model(v), Interval.from_shape(sd.view_size(v)))
        box = iv if box is None else box.union(iv)
    return box


def plan_group_pairs(
    sd: SpimData, groups: list[tuple[ViewId, ...]], params: MatchingParams
) -> list[tuple[tuple[ViewId, ...], tuple[ViewId, ...]]]:
    """Group-pair enumeration under the same timepoint policy + overlap
    filter as the ungrouped path."""
    boxes = [_group_bbox(sd, g) for g in groups]
    policy = params.registration_tp.upper()
    out = []
    for i in range(len(groups)):
        for j in range(i + 1, len(groups)):
            ta, tb = groups[i][0].timepoint, groups[j][0].timepoint
            if not _tp_allowed(policy, ta, tb, params):
                continue
            if params.overlap_filter and not boxes[i].overlaps(boxes[j]):
                continue
            out.append((groups[i], groups[j]))
    if (not out and len(groups) > 1 and params.split_timepoints
            and policy == INDIVIDUAL_TIMEPOINTS):
        warnings.warn(
            "--splitTimepoints merges each timepoint into one group, and the "
            "default TIMEPOINTS_INDIVIDUALLY policy only pairs groups within "
            "a timepoint — no pairs to match. Use -rtp ALL_TO_ALL(_RANGE) or "
            "REFERENCE_TIMEPOINT with --splitTimepoints.",
            stacklevel=2)
    return out


def merge_min_distance(
    view_of: np.ndarray, world: np.ndarray, radius: float
) -> np.ndarray:
    """Keep-mask for pooled group points: a point is dropped when a point of
    an EARLIER member view lies within ``radius`` (the near-duplicate beads
    that views of one group see in their mutual overlap —
    InterestPointGroupingMinDistance semantics, merge radius default 5 px)."""
    from scipy.spatial import cKDTree

    keep = np.ones(len(world), bool)
    if len(world) == 0 or radius <= 0:
        return keep
    kept_pts: list[np.ndarray] = []
    for uv in sorted(set(view_of.tolist())):
        sel = view_of == uv
        if kept_pts:
            tree = cKDTree(np.concatenate(kept_pts))
            d, _ = tree.query(world[sel], k=1)
            keep[sel] = d > radius
        if np.any(keep & sel):
            kept_pts.append(world[keep & sel])
    return keep


def _pair_bytes(na: int, nb: int, params: MatchingParams) -> int:
    """Device bytes a dispatched pair holds until its drain: both clouds,
    their descriptors and owners, and the ratio test's outputs."""
    s = len(D.subset_combinations(params.n_neighbors + params.redundancy,
                                  params.n_neighbors))
    per_desc = 4 * (3 * params.n_neighbors + 1 + 3)
    return int(12 * (na + nb) + per_desc * s * (na + nb))


def _say(progress: bool, msg: str) -> None:
    if progress:
        print(msg, flush=True)


def _run_pairs(jobs, params: MatchingParams, dev, stats: MatchingStats,
               timer: D.StageTimes):
    """Run ``jobs`` [(wa, wb, seed, payload)] through the pair scheduler;
    returns [(inlier pairs, model, n_candidates, payload)] in job order."""
    tasks = [PairTask(index=k, nbytes=_pair_bytes(len(job[0]), len(job[1]),
                                                   params), tag=job)
             for k, job in enumerate(jobs)]

    def dispatch(task):
        wa, wb, _, _ = task.tag
        return _launch_pair(wa, wb, params, dev, timer)

    def drain(tasks, handles):
        outs = []
        for task, handle in zip(tasks, handles):
            wa, wb, seed, payload = task.tag
            t0 = time.perf_counter()
            before = sum(timer.host.values())
            inl, model, n_cand = _finish_pair(wa, wb, params, seed, handle,
                                              dev, timer)
            stats.timings["host"] += ((time.perf_counter() - t0)
                                      - (sum(timer.host.values()) - before))
            outs.append((inl, model, n_cand, payload))
        return outs

    return run_pair_tasks(tasks, dispatch, drain, device=dev)


def _match_grouped(
    sd: SpimData,
    views: list[ViewId],
    params: MatchingParams,
    store: InterestPointStore,
    progress: bool,
    dev: torch.device,
    stats: MatchingStats,
    timer: D.StageTimes,
) -> list[PairMatchResult]:
    """Grouped matching: pool member views' points, merge near-duplicates,
    match once per group pair, split inliers back per view pair
    (SparkGeometricDescriptorMatching.java:343-503)."""
    groups = build_match_groups(sd, views, params)
    pairs = plan_group_pairs(sd, groups, params)
    _say(progress, f"matching (grouped): {len(groups)} groups, {len(pairs)} "
                   f"group pairs, merge distance {params.merge_distance}")

    cache: dict[ViewId, tuple[np.ndarray, np.ndarray]] = {}

    def world(view: ViewId):
        if view not in cache:
            ids, locs = store.load_points(view, params.label)
            w = apply_affine(sd.model(view), locs) if len(locs) else locs
            cache[view] = (ids, w)
        return cache[view]

    def pooled(group: tuple[ViewId, ...]):
        view_of, ids, pts = [], [], []
        for k, v in enumerate(group):
            i, w = world(v)
            view_of.append(np.full(len(i), k, np.int32))
            ids.append(i)
            pts.append(w)
        view_of = np.concatenate(view_of) if view_of else np.zeros(0, np.int32)
        ids = np.concatenate(ids) if ids else np.zeros(0, np.uint64)
        pts = (np.concatenate(pts) if pts else np.zeros((0, 3), np.float64))
        keep = merge_min_distance(view_of, pts, params.merge_distance)
        return view_of[keep], ids[keep], pts[keep]

    min_matches = M.MIN_POINTS[params.model]
    jobs, kept = [], []
    t0 = time.perf_counter()
    for k, (ga, gb) in enumerate(pairs):
        va_of, ids_a, wa = pooled(ga)
        vb_of, ids_b, wb = pooled(gb)
        if params.interest_points_for_overlap_only:
            # group = one unit: filter to the GROUP overlap bbox, never
            # within a group (SparkGeometricDescriptorMatching.java:404-411)
            ov = _group_bbox(sd, ga).intersect(_group_bbox(sd, gb)).expand(2)
            if ov.is_empty():
                continue  # empty group-overlap bbox: nothing to match
            ka, kb = _in_box(wa, ov), _in_box(wb, ov)
            va_of, ids_a, wa = va_of[ka], ids_a[ka], wa[ka]
            vb_of, ids_b, wb = vb_of[kb], ids_b[kb], wb[kb]
        jobs.append((wa, wb, 17 + k, (ga, gb, va_of, ids_a, vb_of, ids_b)))
    stats.timings["load"] += time.perf_counter() - t0

    results: list[PairMatchResult] = []
    for inl, model, n_cand, payload in _run_pairs(jobs, params, dev, stats,
                                                  timer):
        ga, gb, va_of, ids_a, vb_of, ids_b = payload
        stats.candidates += n_cand
        _say(progress, f"  group {ga[0]}x{len(ga)} <-> {gb[0]}x{len(gb)}: "
                       f"{len(inl)} inliers / {n_cand} candidates")
        # split grouped inliers per original (viewA, viewB) pair
        per_pair: dict[tuple[ViewId, ViewId], list[tuple[int, int]]] = {}
        for ia, ib in inl:
            pair = (ga[va_of[ia]], gb[vb_of[ib]])
            per_pair.setdefault(pair, []).append((int(ids_a[ia]), int(ids_b[ib])))
        for (va, vb), id_pairs in sorted(per_pair.items()):
            if len(id_pairs) < min_matches:
                _say(progress, f"    {va} <-> {vb}: {len(id_pairs)} "
                               "correspondences (omitted: fewer than the "
                               "model minimum)")
                continue
            arr = np.array(id_pairs, np.uint64)
            results.append(PairMatchResult(
                va, vb, arr[:, 0], arr[:, 1], model, n_cand,
                label_a=params.label, label_b=params.label))
            stats.inliers += len(id_pairs)
            _say(progress, f"    {va} <-> {vb}: {len(id_pairs)} "
                           "correspondences")
    stats.pairs = len(jobs)
    return results


def match_interest_points(
    sd: SpimData,
    views: list[ViewId],
    params: MatchingParams | None = None,
    store: InterestPointStore | None = None,
    progress: bool = True,
    devices: int | None = None,
    device: str | torch.device | None = None,
    stats: MatchingStats | None = None,
) -> list[PairMatchResult]:
    """Run pairwise matching over all planned pairs on ``device`` (``cuda``
    unless asked otherwise); results are NOT yet persisted (use
    ``save_matches``).

    Point clouds load once; each pair's seed is ``17 + its task index``, as
    in the JAX package."""
    params = params or MatchingParams()
    if devices is not None and int(devices) > 1:
        raise NotYetPorted(f"matching on {devices} devices")
    if params.grouped and (len(params.all_labels) > 1
                           or params.match_across_labels):
        raise ValueError(
            "grouped matching (--groupTiles/--groupChannels/"
            "--groupIllums/--splitTimepoints) supports a single label; "
            "run ungrouped for multi-label / --matchAcrossLabels")
    dev = resolve_device(device)
    stats = stats if stats is not None else MatchingStats()
    timer = D.StageTimes()
    t_start = time.perf_counter()
    store = store or InterestPointStore.for_project(sd)
    if params.grouped:
        results = _match_grouped(sd, views, params, store, progress, dev,
                                 stats, timer)
    else:
        results = _match_pairs(sd, views, params, store, progress, dev,
                               stats, timer)
    timer.resolve()
    for name in ("descriptors", "ratio", "ransac"):
        stats.timings[name] += timer.host[name]
        stats.kernels[name] += timer.device[name]
    stats.timings["load"] += timer.host["load"]
    stats.timings["fetch"] += timer.host["fetch"]
    stats.seconds += time.perf_counter() - t_start
    return results


def _match_pairs(sd, views, params, store, progress, dev, stats, timer):
    pairs = plan_match_pairs(sd, views, params)
    _say(progress, f"matching: {len(pairs)} view pairs, method "
                   f"{params.method}, model {params.model} reg "
                   f"{params.regularization} λ={params.lam}")
    cache: dict[tuple, tuple[np.ndarray, np.ndarray]] = {}

    def world(view: ViewId, label: str):
        key = (view, label)
        if key not in cache:
            ids, locs = store.load_points(view, label)
            w = apply_affine(sd.model(view), locs) if len(locs) else locs
            cache[key] = (ids, w)
        return cache[key]

    t0 = time.perf_counter()
    tasks = [(va, vb, la, lb) for va, vb in pairs
             for la, lb in params.label_pairs()]
    jobs = []
    for k, (va, vb, la, lb) in enumerate(tasks):
        ids_a, wa = world(va, la)
        ids_b, wb = world(vb, lb)
        if params.interest_points_for_overlap_only:
            ids_a, wa = _filter_to_overlap(sd, ids_a, wa, va, vb)
            ids_b, wb = _filter_to_overlap(sd, ids_b, wb, vb, va)
        jobs.append((wa, wb, 17 + k, (ids_a, ids_b)))
    stats.timings["load"] += time.perf_counter() - t0

    results = []
    outs = _run_pairs(jobs, params, dev, stats, timer)
    for (va, vb, la, lb), (inl, model, n_cand, (ids_a, ids_b)) in zip(tasks,
                                                                       outs):
        sel_a = ids_a[inl[:, 0]] if len(inl) else np.zeros(0, np.uint64)
        sel_b = ids_b[inl[:, 1]] if len(inl) else np.zeros(0, np.uint64)
        results.append(PairMatchResult(va, vb, sel_a, sel_b, model, n_cand,
                                       label_a=la, label_b=lb))
        stats.candidates += n_cand
        stats.inliers += len(inl)
        _say(progress, f"  {va} <-> {vb}: {len(inl)} inliers / {n_cand} "
                       "candidates")
    stats.pairs = len(tasks)
    return results


def save_matches(
    sd: SpimData,
    store: InterestPointStore,
    results: list[PairMatchResult],
    params: MatchingParams,
    views: list[ViewId],
) -> None:
    """Persist correspondences symmetrically per view
    (MatcherPairwiseTools.addCorrespondences + save,
    SparkGeometricDescriptorMatching.java:509-545). Existing correspondences
    of re-matched views are kept and merged unless clear_correspondences."""
    new: dict[tuple, list[CorrespondingPoint]] = {
        (v, l): [] for v in views for l in params.all_labels}
    for r in results:
        for ia, ib in zip(r.ids_a.astype(int), r.ids_b.astype(int)):
            new.setdefault((r.view_a, r.label_a), []).append(
                CorrespondingPoint(ia, r.view_b, r.label_b, ib))
            new.setdefault((r.view_b, r.label_b), []).append(
                CorrespondingPoint(ib, r.view_a, r.label_a, ia))
    for (v, label), corrs in new.items():
        if not params.clear_correspondences:
            existing = store.load_correspondences(v, label)
            seen = {(c.id, c.other_view, c.other_label, c.other_id)
                    for c in corrs}
            corrs = corrs + [
                c for c in existing
                if (c.id, c.other_view, c.other_label, c.other_id) not in seen
            ]
        store.save_correspondences(v, label, corrs)
