"""Pairwise stitching driver: plan overlap pairs, extract + aggregate crops,
run the batched phase correlation on the device, refine on the host,
filter, store results.

Port of ``bigstitcher_spark_tpu/models/stitching.py`` on one device
(reference: SparkPairwiseStitching). The work list is the set of
overlapping grouped-view pairs; pairs are bucketed by padded crop shape
(next power of two per axis) so one batch of kernel launches serves every
pair of a bucket (K7-K10, :func:`..ops.phasecorr.pcm_peaks_batch`); the
downsampling of crops read at a finer level runs on K6
(:func:`..ops.downsample.downsample_block`), and pairs whose views differ
in their linear parts are rendered over the overlap by the fusion
kernels (:func:`.affine_fusion.fuse_grid_block`). Results are filtered
(minR / maxShift) and written into the XML with a registration hash for
the solver's staleness checks.

Shift semantics (used by the solver): a stored result with shift S means
the per-view correction translations must satisfy ``c_A - c_B = S``.

Not yet ported: several devices, the multi-process split, the chunk
prefetch feed and the observability counters and spans.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np
import torch

from ..io.dataset_io import ViewLoader, best_mipmap_level
from ..io.spimdata import (
    PairwiseStitchingResult,
    SpimData,
    ViewId,
    registration_hash,
)
from ..ops.downsample import downsample_block
from ..ops.phasecorr import pad_to, pcm_peaks_batch, refine_peaks
from ..utils.device import resolve_device
from ..utils.geometry import (
    Interval,
    concatenate,
    invert_affine,
    transformed_interval,
    translation_affine,
)


@dataclass
class StitchingParams:
    """Defaults match the reference CLI (SparkPairwiseStitching.java:76-106)."""

    downsampling: tuple[int, int, int] = (2, 2, 1)
    peaks_to_check: int = 5
    subpixel: bool = True
    min_r: float = 0.3
    max_r: float = 1.0
    max_shift: tuple[float, float, float] = (np.inf, np.inf, np.inf)
    max_shift_total: float = np.inf
    channel_combine: str = "AVERAGE"        # AVERAGE | PICK_BRIGHTEST
    illum_combine: str = "PICK_BRIGHTEST"   # AVERAGE | PICK_BRIGHTEST
    min_overlap_px: int = 32
    # candidate shifts must keep at least this fraction of the overlap crop
    # in play: a near-total shift can score a HIGHER Pearson r than the true
    # one by chance over a few thousand background voxels
    min_overlap_frac: float = 0.25
    batch_size: int = 16
    # ceiling on dispatched-but-undrained PCM bytes (padded float32 crop
    # stacks x the FFT workspace multiplier below); None derives it from the
    # card's free memory (utils.devicemem; BST_PAIR_INFLIGHT_BYTES overrides)
    inflight_bytes: int | None = None


@dataclass
class StitchingStats:
    """What one stitching run did: pairs and shape buckets, the padded FFT
    voxels (2 x prod(fft shape) per pair), wall seconds, and ``timings``:
    the host seconds of its parts — ``extract`` (crops), ``stage`` (pad,
    stack and send a bucket; the pageable copy queues behind the kernels
    already on the stream), ``launch`` (enqueue the kernels), ``wait``
    (fetch the peaks), ``refine`` — and ``device``, the card's seconds from
    each bucket's first kernel to its last (CUDA events; on the CPU the
    launch's own seconds). ``1 - device / seconds`` is the card's idle
    share."""

    pairs: int = 0
    buckets: int = 0
    fft_voxels: int = 0
    seconds: float = 0.0
    timings: dict = field(default_factory=lambda: dict.fromkeys(
        ("extract", "stage", "launch", "wait", "refine", "device"), 0.0))


@dataclass
class ViewGroup:
    """Views of one tile grouped over channel+illumination
    (reference grouping: group {Channel, Illumination}, compare {Tile},
    SparkPairwiseStitching.java:146-160)."""

    timepoint: int
    angle: int
    tile: int
    views: tuple[ViewId, ...]

    @property
    def key(self):
        return (self.timepoint, self.angle, self.tile)


def build_groups(sd: SpimData, views: list[ViewId]) -> list[ViewGroup]:
    by_key: dict[tuple, list[ViewId]] = {}
    for v in views:
        s = sd.setups[v.setup]
        key = (v.timepoint, s.attributes.get("angle", 0),
               s.attributes.get("tile", 0))
        by_key.setdefault(key, []).append(v)
    return [
        ViewGroup(k[0], k[1], k[2], tuple(sorted(vs)))
        for k, vs in sorted(by_key.items())
    ]


def group_bbox(sd: SpimData, g: ViewGroup) -> Interval:
    """World-space bbox of a group (union over member views)."""
    box = None
    for v in g.views:
        iv = transformed_interval(sd.model(v),
                                  Interval.from_shape(sd.view_size(v)))
        box = iv if box is None else box.union(iv)
    return box


def plan_pairs(sd: SpimData, groups: list[ViewGroup]
               ) -> list[tuple[ViewGroup, ViewGroup, Interval]]:
    """All overlapping group pairs within one (timepoint, angle) slice
    (compare {Tile}, apply over {TimePoint, Angle};
    TransformationTools.filterNonOverlappingPairs role)."""
    out = []
    boxes = {g.key: group_bbox(sd, g) for g in groups}
    for i in range(len(groups)):
        for j in range(i + 1, len(groups)):
            a, b = groups[i], groups[j]
            if (a.timepoint, a.angle) != (b.timepoint, b.angle):
                continue
            if not boxes[a.key].overlaps(boxes[b.key]):
                continue
            ov = boxes[a.key].intersect(boxes[b.key])
            if ov.is_empty():
                continue
            out.append((a, b, ov))
    return out


def _aggregate(sd: SpimData, crops: dict[ViewId, np.ndarray],
               group: ViewGroup, params: StitchingParams) -> np.ndarray:
    """GroupedViewAggregator: combine channels (AVERAGE default) then
    illuminations (PICK_BRIGHTEST default) of one tile
    (SparkPairwiseStitching.java:204-208)."""
    def combine(imgs: list[np.ndarray], how: str) -> np.ndarray:
        if len(imgs) == 1:
            return imgs[0]
        if how == "AVERAGE":
            return np.mean(imgs, axis=0)
        if how == "PICK_BRIGHTEST":
            return imgs[int(np.argmax([np.sum(i, dtype=np.float64)
                                       for i in imgs]))]
        raise ValueError(f"unknown aggregation {how}")

    by_illum: dict[int, list[np.ndarray]] = {}
    for v in group.views:
        illum = sd.setups[v.setup].attributes.get("illumination", 0)
        by_illum.setdefault(illum, []).append(crops[v])
    per_illum = [combine(imgs, params.channel_combine)
                 for _, imgs in sorted(by_illum.items())]
    return combine(per_illum, params.illum_combine)


def _downsample_crop(crop: np.ndarray, ds: Sequence[int],
                     device: torch.device) -> np.ndarray:
    """Float32 mean over ``ds`` windows (edge-padded to whole windows) by
    K6 on ``device``; a copy as float32 when ``ds`` is all ones."""
    if all(int(f) == 1 for f in ds):
        return crop.astype(np.float32)
    pad = [(0, (-crop.shape[d]) % int(ds[d])) for d in range(3)]
    if any(p[1] for p in pad):
        crop = np.pad(crop, pad, mode="edge")
    t = torch.from_numpy(np.ascontiguousarray(crop, np.float32)).to(device)
    return downsample_block(t, tuple(int(f) for f in ds)).cpu().numpy()


@dataclass
class _PairJob:
    group_a: ViewGroup
    group_b: ViewGroup
    overlap: Interval
    crop_a: np.ndarray       # downsampled, float32
    crop_b: np.ndarray
    # shift post-processing: S = linear @ (p0b - p0a + residual_ds*s)
    # - (t_a - t_b) with linear/t from the LEVEL model (model o mipmap), or
    # S = ds*s for the rendered (non-equal-transform) path
    linear: np.ndarray | None
    p0_delta: np.ndarray | None
    t_delta: np.ndarray | None
    models_a: list[np.ndarray] = field(default_factory=list)
    models_b: list[np.ndarray] = field(default_factory=list)
    residual_ds: tuple[int, int, int] = (1, 1, 1)


def _equal_linear(models: list[np.ndarray]) -> bool:
    return all(np.allclose(m[:, :3], models[0][:, :3], atol=1e-9)
               for m in models)


def _pick_common_level(loader, views, ds
                       ) -> tuple[dict, tuple[int, int, int]] | None:
    """Coarsest stored mipmap level usable by every view of the pair whose
    factors exactly divide the requested downsampling. Views may store the
    same factors at different level indexes, so the per-view LEVEL is
    returned alongside the common factors. None -> read s0."""
    levels: dict = {}
    common_f = None
    for v in views:
        factors = loader.downsampling_factors(v.setup)
        lvl = best_mipmap_level(factors, ds)
        f = tuple(int(x) for x in factors[lvl])
        if any(int(ds[d]) % f[d] != 0 for d in range(3)):
            return None
        if common_f is None:
            common_f = f
        elif f != common_f:
            return None
        levels[v] = lvl
    return levels, common_f


def _extract_pair_job(sd, loader, ga, gb, overlap, params,
                      device: torch.device) -> _PairJob | None:
    models_a = [sd.model(v) for v in ga.views]
    models_b = [sd.model(v) for v in gb.views]
    ds = params.downsampling

    if _equal_linear(models_a + models_b):
        # read at the coarsest stored level that divides the requested
        # downsampling; the rest is averaged on the device
        all_views = list(ga.views) + list(gb.views)
        common = _pick_common_level(loader, all_views, ds)
        if common is None:
            levels, f = {v: 0 for v in all_views}, (1, 1, 1)
        else:
            levels, f = common
        rel = tuple(int(ds[d]) // f[d] for d in range(3))
        mip = loader.mipmap_transform(ga.views[0].setup, levels[ga.views[0]])

        # raster the overlap into each view's LEVEL pixel space; exact
        # integer offsets enter the shift formula so rounding costs no
        # accuracy (model' = model o mipmap: level px -> world)
        lvl_shape = tuple(
            int(np.ceil(overlap.shape[d] / f[d])) for d in range(3)
        )

        def crops_for(group, models):
            crops = {}
            p0 = None
            for v, m in zip(group.views, models):
                inv = invert_affine(concatenate(m, mip))
                p0v = np.round(inv[:, :3] @ np.array(overlap.min, np.float64)
                               + inv[:, 3]).astype(np.int64)
                if p0 is None:
                    p0 = p0v
                crops[v] = loader.read_block(v, levels[v], tuple(p0v),
                                             lvl_shape).astype(np.float32)
            return crops, p0

        crops_a, p0a = crops_for(ga, models_a)
        crops_b, p0b = crops_for(gb, models_b)
        agg_a = _aggregate(sd, crops_a, ga, params)
        agg_b = _aggregate(sd, crops_b, gb, params)
        total_a = concatenate(models_a[0], mip)
        total_b = concatenate(models_b[0], mip)
        return _PairJob(
            ga, gb, overlap,
            _downsample_crop(agg_a, rel, device),
            _downsample_crop(agg_b, rel, device),
            linear=total_a[:, :3].copy(),
            p0_delta=(p0b - p0a).astype(np.float64),
            t_delta=(total_a[:, 3] - total_b[:, 3]).copy(),
            models_a=models_a, models_b=models_b,
            residual_ds=rel,
        )

    # non-equal transforms: render each group virtually over the overlap
    # (computeStitchingNonEqualTransformations,
    # SparkPairwiseStitching.java:259-267)
    from ..utils.grid import GridBlock
    from .affine_fusion import fuse_grid_block

    o_ds = Interval(
        tuple(int(np.floor(overlap.min[d] / ds[d])) for d in range(3)),
        tuple(int(np.ceil((overlap.max[d] + 1) / ds[d])) - 1
              for d in range(3)),
    )
    scale = np.diag([1.0 / f for f in ds])
    pre = np.hstack([scale, np.zeros((3, 1))])

    def render(group):
        block = GridBlock((0, 0, 0), o_ds.shape, (0, 0, 0))
        res = fuse_grid_block(sd, loader, list(group.views), block, o_ds,
                              fusion_type="AVG", anisotropy=pre,
                              device=device)
        if res is None:
            return None
        return res[0].cpu().numpy()

    ra, rb = render(ga), render(gb)
    if ra is None or rb is None:
        return None
    return _PairJob(ga, gb, overlap, ra, rb,
                    linear=None, p0_delta=None, t_delta=None,
                    models_a=models_a, models_b=models_b)


def _fft_shape(shape: Sequence[int]) -> tuple[int, ...]:
    """Next power of two per axis (K8 takes powers of two; wrap ambiguity is
    resolved by the host correlation check, ops/phasecorr.refine_peaks)."""
    return tuple(1 << max(0, int(np.ceil(np.log2(max(int(s), 1)))))
                 for s in shape)


def stitch_all_pairs(
    sd: SpimData,
    loader: ViewLoader,
    views: list[ViewId],
    params: StitchingParams | None = None,
    progress: bool = True,
    device=None,
    stats: StitchingStats | None = None,
) -> list[PairwiseStitchingResult]:
    """Compute pairwise shifts for every overlapping tile pair on ``device``
    (default ``cuda``).

    Returns unfiltered results; apply ``filter_results`` + store into
    ``sd.stitching_results`` (the driver-side collect of the reference).
    ``stats``, when given, receives the run's counts and seconds."""
    params = params or StitchingParams()
    dev = resolve_device(device)
    stats = stats if stats is not None else StitchingStats()
    t_start = time.perf_counter()
    groups = build_groups(sd, views)
    pairs = plan_pairs(sd, groups)
    if progress:
        print(f"stitching: {len(groups)} groups, {len(pairs)} overlapping "
              "pairs", flush=True)

    jobs: list[_PairJob] = []
    t0 = time.perf_counter()
    for ga, gb, ov in pairs:
        job = _extract_pair_job(sd, loader, ga, gb, ov, params, dev)
        if job is not None:
            jobs.append(job)
    stats.timings["extract"] += time.perf_counter() - t0
    out = stitch_jobs(sd, jobs, params, dev, stats)
    stats.seconds = time.perf_counter() - t_start
    return out


# device bytes one PCM dispatch holds beyond its a+b float32 input stacks
# (S = 2 B X Y Z 4 bytes): the inputs as sent (uint16: S/2, float32: S),
# the two windowed crops (S), the two rfftn spectra (Z/2+1 complex bins per
# line: ~S), the cross-power spectrum (~S/2), the PCM (S/2) and K10's
# candidates (< S/100) -> at most ~4 S while every buffer is alive
_FFT_WORKSPACE_MULT = 4.0


def stitch_jobs(sd, jobs: list[_PairJob], params: StitchingParams,
                device: torch.device, stats: StitchingStats | None = None
                ) -> list[PairwiseStitchingResult]:
    """Run the device PCM + host refinement pipeline over prepared jobs:
    shape buckets of up to ``params.batch_size`` pairs become pair tasks
    of one pipelined loop (parallel.pairsched), whose in-flight window
    charges each bucket its input stacks times the FFT workspace
    multiplier, so host refinement of one segment overlaps the kernels of
    the next."""
    from ..parallel.pairsched import PairTask, run_pair_tasks

    stats = stats if stats is not None else StitchingStats()
    buckets: dict[tuple, list[_PairJob]] = {}
    for j in jobs:
        shp = _fft_shape(np.maximum(j.crop_a.shape, j.crop_b.shape))
        buckets.setdefault(shp, []).append(j)

    chunks = []
    for shp, bjobs in sorted(buckets.items()):
        for i in range(0, len(bjobs), params.batch_size):
            chunks.append((shp, bjobs[i:i + params.batch_size]))

    tasks = []
    for i, (shp, chunk) in enumerate(chunks):
        vol = int(np.prod(shp))
        stack_bytes = 2 * len(chunk) * vol * 4  # a+b stacks as float32
        tasks.append(PairTask(index=i,
                              nbytes=int(stack_bytes * _FFT_WORKSPACE_MULT),
                              tag=(shp, chunk)))
        stats.pairs += len(chunk)
        stats.fft_voxels += 2 * len(chunk) * vol
    stats.buckets += len(chunks)

    timings = stats.timings
    on_card = device.type == "cuda"

    def dispatch(task):
        shp, chunk = task.tag
        t0 = time.perf_counter()
        stacks = _stage_bucket(chunk, shp, device)
        t1 = time.perf_counter()
        events = None
        if on_card:
            events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
            events[0].record()
        peaks = pcm_peaks_batch(*stacks, params.peaks_to_check, 0.25)
        if on_card:
            events[1].record()
        t2 = time.perf_counter()
        timings["stage"] += t1 - t0
        timings["launch"] += t2 - t1
        if not on_card:
            timings["device"] += t2 - t1
        return peaks, events

    def drain(seg_tasks, handles):
        t0 = time.perf_counter()
        peaks_list = [p.cpu().numpy() for p, _ev in handles]
        timings["wait"] += time.perf_counter() - t0
        for _p, ev in handles:
            if ev is not None:
                timings["device"] += ev[0].elapsed_time(ev[1]) / 1e3
        t0 = time.perf_counter()
        out = []
        for task, peaks in zip(seg_tasks, peaks_list):
            shp, chunk = task.tag
            out.append(_refine_bucket(sd, chunk, shp, peaks, params))
        timings["refine"] += time.perf_counter() - t0
        return out

    per_chunk = run_pair_tasks(tasks, dispatch, drain, device=device,
                               budget_bytes=params.inflight_bytes)
    return [r for chunk_results in per_chunk
            if chunk_results is not None for r in chunk_results]


def _as_uint16_lossless(stack: np.ndarray) -> np.ndarray | None:
    """uint16 copy of the stack when every value survives the round-trip
    exactly (integral, in range — single-channel stored-level crops), else
    None. NaN/inf/out-of-range values are rejected by a min/max pre-check
    BEFORE the cast (casting them to uint16 is implementation-defined);
    fractional in-range values cast quietly and fail the equality check."""
    if stack.dtype == np.uint16:
        return stack
    if stack.dtype.kind in "iu":
        if stack.size == 0:
            return stack.astype(np.uint16)
        mn, mx = stack.min(), stack.max()
        if mn < 0 or mx > np.iinfo(np.uint16).max:
            return None
        return stack.astype(np.uint16)
    if stack.dtype.kind != "f":
        return None
    if stack.size == 0:
        return stack.astype(np.uint16)
    mn, mx = stack.min(), stack.max()  # min/max propagate NaN
    if (not np.isfinite(mn) or not np.isfinite(mx)
            or mn < 0 or mx > np.iinfo(np.uint16).max):
        return None
    u = stack.astype(np.uint16)
    return u if np.array_equal(stack, u) else None


def _stage_bucket(jobs: list[_PairJob], shp, device: torch.device):
    """Pad and stack one bucket's crops and send them to ``device`` (as
    uint16 when both stacks are integral: half the bytes, and K7 reads
    uint16 exactly); returns the a, b stacks and their true extents."""
    a = np.stack([pad_to(j.crop_a, shp) for j in jobs])
    b = np.stack([pad_to(j.crop_b, shp) for j in jobs])
    ua = _as_uint16_lossless(a)
    ub = _as_uint16_lossless(b) if ua is not None else None
    if ua is not None and ub is not None:
        a, b = ua, ub
    ext_a = np.stack([np.array(j.crop_a.shape, np.int32) for j in jobs])
    ext_b = np.stack([np.array(j.crop_b.shape, np.int32) for j in jobs])
    return tuple(torch.from_numpy(x).to(device) for x in (a, b, ext_a, ext_b))


def _refine_bucket(sd, jobs: list[_PairJob], shp, peaks,
                   params) -> list[PairwiseStitchingResult]:
    """Per-peak true-correlation scoring + subpixel on the overlap slices
    (host, float64 — see ops/phasecorr.refine_peaks); numpy reductions
    release the GIL, so pairs refine in parallel."""
    shifts = np.zeros((len(jobs), 3))
    rs = np.zeros(len(jobs))

    def _refine(k):
        j = jobs[k]
        min_ov = max(
            params.min_overlap_px,
            params.min_overlap_frac
            * min(int(np.prod(j.crop_a.shape)),
                  int(np.prod(j.crop_b.shape))))
        shifts[k], rs[k] = refine_peaks(
            j.crop_a, j.crop_b, peaks[k], shp,
            min_overlap=min_ov, subpixel=params.subpixel)

    # bound concurrent scorers by their summed-area-table footprint: each
    # refine builds 4 float64 tables (~32 B per crop voxel) within a 2e9
    # host budget (one device drains at a time)
    sat_bytes = 32 * max(int(np.prod(j.crop_a.shape))
                         + int(np.prod(j.crop_b.shape)) for j in jobs)
    budget = max(1, int(2e9 // max(sat_bytes, 1)))
    workers = min(8, len(jobs), budget)
    if workers > 1:
        with ThreadPoolExecutor(max_workers=workers) as pool:
            list(pool.map(_refine, range(len(jobs))))
    else:
        for k in range(len(jobs)):
            _refine(k)

    ds = np.array(params.downsampling, np.float64)
    out = []
    for j, s, r in zip(jobs, shifts, rs):
        if j.linear is not None:
            # S = L (p0b - p0a + rel*s) - (t_a - t_b): c_A - c_B = S
            rel = np.array(j.residual_ds, np.float64)
            S = j.linear @ (j.p0_delta + rel * s.astype(np.float64)) - j.t_delta
        else:
            S = ds * s.astype(np.float64)
        out.append(PairwiseStitchingResult(
            views_a=j.group_a.views,
            views_b=j.group_b.views,
            transform=translation_affine(S),
            correlation=float(r),
            hash=registration_hash(j.models_a, j.models_b),
            bbox=j.overlap,
        ))
    return out


def filter_results(
    results: list[PairwiseStitchingResult], params: StitchingParams,
    verbose: bool = True,
) -> list[PairwiseStitchingResult]:
    """Link filters (FilteredStitchingResults: Correlation, AbsoluteShift,
    ShiftMagnitude — SparkPairwiseStitching.java:347-382)."""
    out = []
    for res in results:
        shift = res.transform[:, 3]
        ok = (params.min_r <= res.correlation <= params.max_r
              and all(abs(shift[d]) <= params.max_shift[d] for d in range(3))
              and float(np.linalg.norm(shift)) <= params.max_shift_total)
        if ok:
            out.append(res)
        elif verbose:
            print(f"  dropped pair {res.views_a[0]}<->{res.views_b[0]}: "
                  f"r={res.correlation:.3f} shift={np.round(shift, 2)}",
                  flush=True)
    return out


def store_results(
    sd: SpimData,
    results: list[PairwiseStitchingResult],
    computed: list[PairwiseStitchingResult] | None = None,
) -> None:
    """Store kept results; entries for every RECOMPUTED pair (``computed``,
    default = ``results``) are cleared first so links the user just filtered
    out don't survive from a previous run."""
    for res in computed if computed is not None else results:
        sd.stitching_results.pop(res.pair_key, None)
    for res in results:
        sd.stitching_results[res.pair_key] = res
