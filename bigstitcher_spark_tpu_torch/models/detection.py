"""Interest-point detection: per-view block grid with halo, batched
DoG program on the device, subpixel localization, brightest-N filtering,
interestpoints.n5.

Port of ``bigstitcher_spark_tpu/models/detection.py`` on one device
(reference: SparkInterestPointDetection, SURVEY.md §3.3). The work list is
(view, block) tuples at detection resolution, each block read with a halo
of ``dog_halo(sigma)`` (mirror-padded at the image border) at its stored
level, in its native type. Blocks are bucketed by (shape, residual
factors ``rel``, type), and each bucket runs in batches of
``max(1, batch_size // prod(rel))`` through
:func:`..ops.dog.dog_block_topk_batch`: K6 pools by ``rel``, K15-K18
blur, find the extrema, keep the K strongest and fit them. Only the K
candidates of each block come back to the host, where they are re-checked
against the core, moved to view coordinates, filtered (overlap boxes,
``--maxSpots``), corrected to full resolution and optionally sampled for
intensities. Detections restricted to overlap regions use one pass over
the union of the overlap boxes, as the JAX package does.

With ``DetectionParams.extract_descriptors`` each batch runs
:func:`..ops.dog.dog_detect_extract_batch` instead: after K15-K18, K19's
masked form computes the kNN-frame descriptors of each block's K
candidate slots (block-local, rotation invariant) before anything leaves
the device, and the descriptors and their validity ride with the points
through the core re-check, the ordering and the filters
(``ViewDetections.descriptors``, ``descriptor_valid``). The JAX package
also has a staged form of that program (``BST_FUSED_DETECT=0``, two
dispatches, the same bits); the port runs the composition only, on one
stream, and has no such switch.

While one batch computes, the reads of the next run on a thread pool.
:class:`DetectionStats` splits the wall into the min/max estimate, the
waits for reads, H2D, the kernels (CUDA events), D2H and the host tail.

With ``devices`` above 1 the sharded route (JAX detection.py:459-460,
:521-551) runs every bucket's batches of ``devices x per_dev`` blocks,
``per_dev = max(1, max(1, batch_size // devices) // prod(rel))``, in one
loop over a mesh (:func:`..parallel.mesh.run_sharded_batches`): each
device runs the same program on its rows
(:func:`..parallel.mesh.shard_batch`), its drain worker copies the
candidates back and the writer pool's threads run the same per-block
tail. Every block's result depends on that block alone, so the points,
values and descriptors are bitwise the one-device route's.

Not yet ported (raise :class:`~bigstitcher_spark_tpu_torch.NotYetPorted`):
the streamed device-resident producer of the stage DAG.
"""

from __future__ import annotations

import threading
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import NotYetPorted
from ..io.dataset_io import ViewLoader, best_mipmap_level, mipmap_transform
from ..io.interestpoints import InterestPointStore, register_points_in_xml
from ..io.spimdata import SpimData, ViewId
from ..ops.descriptors import check_pool, subset_combinations
from ..ops.dog import (
    dog_block_topk_batch,
    dog_detect_extract_batch,
    dog_halo,
    sample_trilinear,
)
from ..ops.downsample import downsample_block, to_kernel_dtype
from ..parallel.mesh import (
    add_time,
    group_items,
    make_mesh,
    run_sharded_batches,
    shard_batch,
)
from ..utils.device import resolve_device
from ..utils.geometry import (
    Interval,
    apply_affine,
    invert_affine,
    transformed_interval,
)
from ..utils.grid import create_grid


@dataclass
class DetectionParams:
    """Defaults match the reference CLI (SparkInterestPointDetection.java:116-170)."""

    label: str = "beads"
    sigma: float = 1.8
    threshold: float = 0.008
    downsample_xy: int = 2
    downsample_z: int = 1
    min_intensity: float | None = None
    max_intensity: float | None = None
    find_max: bool = True
    find_min: bool = False
    overlapping_only: bool = False
    max_spots: int = 0
    max_spots_per_overlap: bool = False
    store_intensities: bool = False
    median_radius: int = 0          # 0 = off (LazyBackgroundSubtract role)
    median_exact: bool = False      # exact per-slice radius-r median
    localization: str = "QUADRATIC"  # NONE | QUADRATIC subpixel
    only_compare_overlap_tiles: bool = False  # --onlyCompareOverlapTiles
    block_size: tuple[int, int, int] = (512, 512, 128)
    batch_size: int = 8
    # device-side compaction budget: K strongest candidates per block leave
    # the device (count is returned, so truncation is detected and warned)
    max_candidates_per_block: int = 4096
    # geometric descriptor extraction riding the detection pass: each
    # block's candidates get kNN-frame descriptors on the device (K19's
    # masked form after K15-K18), n + r <= 8 neighbours a point
    extract_descriptors: bool = False
    descriptor_neighbors: int = 3
    descriptor_redundancy: int = 1

    @property
    def downsampling(self) -> tuple[int, int, int]:
        return (self.downsample_xy, self.downsample_xy, self.downsample_z)

    def params_string(self) -> str:
        return (f"DOG (TPU) s={self.sigma} t={self.threshold} "
                f"overlappingOnly={self.overlapping_only} min={self.min_intensity} "
                f"max={self.max_intensity} ds={','.join(map(str, self.downsampling))}")


@dataclass
class ViewDetections:
    view: ViewId
    points: np.ndarray            # (N,3) float64, full-res view-local px
    values: np.ndarray            # (N,) DoG response at the detection
    intensities: np.ndarray | None = None
    # extract_descriptors riders: per-point kNN-frame descriptors (N, S, 3n)
    # float32, block-local at detection resolution, and their validity
    # (points near block borders may lack a full pool)
    descriptors: np.ndarray | None = None
    descriptor_valid: np.ndarray | None = None


@dataclass
class DetectionStats:
    """What one detection run did: views, blocks, shape buckets, batches,
    detection-resolution core voxels, points kept, blocks whose extrema
    exceeded the candidate budget, wall seconds, and ``timings``: the
    seconds of the min/max estimate (``minmax``), of waiting for block
    reads (``read``; reads run ahead on a pool), of ``h2d``, of the kernels
    (``kernels``: CUDA events around each batch; on the CPU the twins' host
    seconds), of ``d2h``, and of the host tail (``tail``: core re-check,
    filters, intensities). ``store`` is filled by the command that saves.
    The sharded route also fills ``mesh`` (device names, in row order) and
    ``per_dev`` (each bucket's); its ``read`` sums the reader threads'
    seconds and its ``tail`` the writer threads' per-block tails."""

    views: int = 0
    blocks: int = 0
    buckets: int = 0
    batches: int = 0
    core_voxels: int = 0
    points: int = 0
    truncated: int = 0
    seconds: float = 0.0
    timings: dict = field(default_factory=lambda: dict.fromkeys(
        ("minmax", "read", "h2d", "kernels", "d2h", "tail", "store"), 0.0))
    mesh: tuple = ()
    per_dev: list = field(default_factory=list)


@dataclass
class _BlockJob:
    view_idx: int
    core: Interval                # detection-res block (core, no halo)
    result: tuple | None = None   # (subpixel pts, values) after extraction


class _ViewPlan:
    """Per-view read geometry: stored level + residual in-memory downsampling."""

    def __init__(self, loader: ViewLoader, view: ViewId, ds: tuple[int, int, int]):
        factors = loader.downsampling_factors(view.setup)
        lvl = best_mipmap_level(factors, ds)
        f = tuple(int(x) for x in factors[lvl])
        if any(int(ds[d]) % f[d] != 0 for d in range(3)):
            lvl, f = 0, (1, 1, 1)
        self.view = view
        self.level = lvl
        self.rel = tuple(int(ds[d]) // f[d] for d in range(3))
        lvl_dims = loader.open(view, lvl).shape
        self.det_dims = tuple(int(s) // r for s, r in zip(lvl_dims, self.rel))

    def read_raw_block(self, loader: ViewLoader, offset, shape) -> np.ndarray:
        """Read the LEVEL-resolution voxels backing a detection-res box
        (mirror-padded outside the image), native dtype: level voxels
        [o*rel, (o+s)*rel)."""
        lvl_off = [int(o) * r for o, r in zip(offset, self.rel)]
        lvl_shape = [int(s) * r for s, r in zip(shape, self.rel)]
        return _read_mirror(loader, self.view, self.level, lvl_off, lvl_shape)

    def read_det_block(self, loader: ViewLoader, offset, shape,
                       device: torch.device) -> np.ndarray:
        """Read a detection-res box (mirror-padded outside the image): level
        voxels [o*rel, (o+s)*rel) average-pooled by ``rel`` on ``device``
        (K6 or its twin; openAndDownsample,
        SparkInterestPointDetection.java:998-1118)."""
        raw = self.read_raw_block(loader, offset, shape)
        if all(r == 1 for r in self.rel):
            return raw.astype(np.float32)
        x = torch.from_numpy(np.ascontiguousarray(to_kernel_dtype(raw)))
        return downsample_block(x.to(device), self.rel).cpu().numpy()


def _read_mirror(loader: ViewLoader, view, level, offset, shape) -> np.ndarray:
    """read_block with mirror (reflect) padding outside the image — matches
    the reference's extended images so borders don't produce edge extrema."""
    ds = loader.open(view, level)
    if getattr(ds, "read_device", None) is not None:
        raise NotYetPorted("device-resident block reads from a streamed "
                           "producer (read_device)")
    full = ds.shape
    lo = [max(0, int(o)) for o in offset]
    hi = [min(int(f), int(o) + int(s)) for f, o, s in zip(full, offset, shape)]
    if not all(h > l for l, h in zip(lo, hi)):
        return np.zeros(tuple(int(s) for s in shape), dtype=np.dtype(ds.dtype))
    data = ds.read(lo, [h - l for l, h in zip(lo, hi)])
    pad = [(l - int(o), int(o) + int(s) - h)
           for l, h, o, s in zip(lo, hi, offset, shape)]
    if any(p != (0, 0) for p in pad):
        capped = [(min(p0, data.shape[d] - 1), min(p1, data.shape[d] - 1))
                  for d, (p0, p1) in enumerate(pad)]
        extra = [(p[0] - c[0], p[1] - c[1]) for p, c in zip(pad, capped)]
        data = np.pad(data, capped, mode="reflect")
        if any(e != (0, 0) for e in extra):
            data = np.pad(data, extra, mode="edge")
    return data


def _median_background_divide(block: np.ndarray, radius: int,
                              exact: bool = False) -> np.ndarray:
    """Per-z-slice 2-D median background divide (LazyBackgroundSubtract role,
    SparkInterestPointDetection.java:536-543; median at
    LazyBackgroundSubtract.java:74-140).

    ``exact=True`` computes the true radius-r median over a circular
    footprint per slice (ImageJ RankFilters semantics). The default is a
    4x-decimated estimate bilinearly upsampled — a cheap stand-in at equal
    purpose (flat-field normalization)."""
    if exact:
        from scipy.ndimage import median_filter

        r = int(radius)
        yy, xx = np.mgrid[-r:r + 1, -r:r + 1]
        # ImageJ RankFilters circular kernel: include when d^2 <= r^2 + 1
        footprint = (yy * yy + xx * xx) <= (r * r + 1)
        out = np.empty_like(block, dtype=np.float32)
        for z in range(block.shape[2]):
            sl = block[:, :, z].astype(np.float32)
            bg = median_filter(sl, footprint=footprint, mode="nearest")
            out[:, :, z] = sl / np.maximum(bg, 1e-6)
        return out
    from numpy.lib.stride_tricks import sliding_window_view

    dec = 4
    r = max(1, radius // dec)
    out = np.empty_like(block, dtype=np.float32)
    for z in range(block.shape[2]):
        sl = block[:, :, z].astype(np.float32)
        small = sl[::dec, ::dec]
        padded = np.pad(small, r, mode="edge")
        win = sliding_window_view(padded, (2 * r + 1, 2 * r + 1))
        med = np.median(win, axis=(-2, -1))
        # bilinear upsample back to the slice grid
        yi = np.minimum(np.arange(sl.shape[0]) / dec, med.shape[0] - 1)
        xi = np.minimum(np.arange(sl.shape[1]) / dec, med.shape[1] - 1)
        y0 = np.floor(yi).astype(int)
        x0 = np.floor(xi).astype(int)
        y1 = np.minimum(y0 + 1, med.shape[0] - 1)
        x1 = np.minimum(x0 + 1, med.shape[1] - 1)
        fy = (yi - y0)[:, None]
        fx = (xi - x0)[None, :]
        bg = (med[np.ix_(y0, x0)] * (1 - fy) * (1 - fx)
              + med[np.ix_(y1, x0)] * fy * (1 - fx)
              + med[np.ix_(y0, x1)] * (1 - fy) * fx
              + med[np.ix_(y1, x1)] * fy * fx)
        out[:, :, z] = sl / np.maximum(bg, 1e-6)
    return out


def _overlap_boxes_det(
    sd: SpimData, view: ViewId, others: list[ViewId],
    det_dims, ds, expand_px: int = 2, only_tiles: bool = False,
) -> list[Interval]:
    """Overlap regions of ``view`` with each other view, in detection-res
    view-local px (the --overlappingOnly pre-pass,
    SparkInterestPointDetection.java:291-367). ``only_tiles``: compare only
    same-timepoint same-channel views, i.e. overlap across TILES only
    (--onlyCompareOverlapTiles, :263-270)."""
    model = sd.model(view)
    inv = invert_affine(model)
    my_box = transformed_interval(model, Interval.from_shape(sd.view_size(view)))
    my_channel = sd.setups[view.setup].attributes.get("channel", 0)
    out = []
    for o in others:
        if o == view:
            continue
        if only_tiles and (
                o.timepoint != view.timepoint
                or sd.setups[o.setup].attributes.get("channel", 0) != my_channel):
            continue
        ob = transformed_interval(
            sd.model(o), Interval.from_shape(sd.view_size(o)))
        if not my_box.overlaps(ob):
            continue
        world = my_box.intersect(ob)
        local = transformed_interval(inv, world).expand(expand_px)
        det = Interval(
            tuple(int(np.floor(local.min[d] / ds[d])) for d in range(3)),
            tuple(int(np.ceil(local.max[d] / ds[d])) for d in range(3)),
        ).intersect(Interval.from_shape(det_dims))
        if not det.is_empty():
            out.append(det)
    return out


def _estimate_min_max(loader: ViewLoader, view: ViewId) -> tuple[float, float]:
    """Image min/max from the coarsest stored level (the reference scans the
    downsampled image when min/maxIntensity are absent)."""
    lvl = loader.num_levels(view.setup) - 1
    img = loader.open(view, lvl).read_full()
    return float(img.min()), float(img.max())


def _batch_seconds(dev: torch.device, fn):
    """Run ``fn``; its seconds on the card (CUDA events) or on the host."""
    if dev.type != "cuda":
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return out, a.elapsed_time(b) / 1e3


def detect_interest_points(
    sd: SpimData,
    loader: ViewLoader,
    views: list[ViewId],
    params: DetectionParams | None = None,
    progress: bool = True,
    devices: int | None = None,
    device: str | torch.device | None = None,
    stats: DetectionStats | None = None,
) -> list[ViewDetections]:
    """Run DoG detection over all ``views`` on ``device`` (``cuda`` unless
    asked otherwise); returns per-view detections in FULL-RES view-local
    pixel coordinates (correctForDownsampling applied,
    SparkInterestPointDetection.java:611)."""
    params = params or DetectionParams()
    want_desc = bool(params.extract_descriptors)
    if want_desc:
        check_pool(int(params.descriptor_neighbors),
                   int(params.descriptor_redundancy))
    dev = resolve_device(device)
    stats = stats if stats is not None else DetectionStats()
    t_start = time.perf_counter()
    timings = stats.timings
    ds = params.downsampling
    halo = dog_halo(params.sigma)
    bs = tuple(int(b) for b in params.block_size)

    plans = {v: _ViewPlan(loader, v, ds) for v in views}
    t0 = time.perf_counter()
    need = [v for v in views
            if params.min_intensity is None or params.max_intensity is None]
    ests: dict[ViewId, tuple[float, float]] = {}
    if need:  # estimation reads are independent -> overlap them
        with ThreadPoolExecutor(max_workers=min(8, len(need))) as mpool:
            ests = dict(zip(need, mpool.map(
                lambda v: _estimate_min_max(loader, v), need)))
    minmax = {}
    for v in views:
        lo, hi = ests.get(v, (0.0, 0.0))
        minmax[v] = (
            params.min_intensity if params.min_intensity is not None else lo,
            params.max_intensity if params.max_intensity is not None else hi)
    timings["minmax"] += time.perf_counter() - t0

    overlap_boxes: dict[ViewId, list[Interval]] = {}
    jobs: list[_BlockJob] = []
    view_list = list(views)
    for vi, v in enumerate(view_list):
        plan = plans[v]
        region = Interval.from_shape(plan.det_dims)
        boxes = None
        if params.overlapping_only:
            boxes = _overlap_boxes_det(
                sd, v, view_list, plan.det_dims, ds,
                only_tiles=params.only_compare_overlap_tiles)
            overlap_boxes[v] = boxes
            if not boxes:
                continue
            region = boxes[0]
            for b in boxes[1:]:
                region = region.union(b)
        for blk in create_grid(region.shape, bs):
            core = Interval.from_shape(blk.size, blk.offset).translate(region.min)
            if boxes is not None and not any(core.overlaps(b) for b in boxes):
                continue
            jobs.append(_BlockJob(vi, core))
    stats.views += len(view_list)
    stats.blocks += len(jobs)
    stats.core_voxels += sum(j.core.num_elements for j in jobs)
    if progress:
        print(f"detection: {len(view_list)} views, {len(jobs)} blocks "
              f"(block {bs}, halo {halo}, ds {ds}) on {dev}", flush=True)

    def build(job: _BlockJob):
        v = view_list[job.view_idx]
        plan = plans[v]
        off = [m - halo for m in job.core.min]
        shape = [s + 2 * halo for s in job.core.shape]
        if params.median_radius > 0:
            raw = plan.read_det_block(loader, off, shape, dev)
            raw = _median_background_divide(raw, params.median_radius,
                                            exact=params.median_exact)
            raw = raw.astype(np.float32)
        else:
            # ship the LEVEL-resolution block in its native dtype; the
            # device pools by ``rel`` (K6) before the DoG
            raw = plan.read_raw_block(loader, off, shape)
            if raw.dtype.byteorder == ">":
                raw = raw.astype(raw.dtype.newbyteorder("="))
            raw = to_kernel_dtype(raw)
        lo, hi = minmax[v]
        return (np.ascontiguousarray(raw), np.float32(lo), np.float32(hi),
                np.float32(params.threshold),
                np.array([m - halo for m in job.core.min], np.int32))

    truncated_lock = threading.Lock()

    def consume(job: _BlockJob, idx, sub, vals, valid, count, *extra):
        shape = job.core.shape
        k = len(idx)
        if int(count) > k:
            with truncated_lock:
                stats.truncated += 1
            warnings.warn(
                f"detection block {job.core.min} found {int(count)} extrema, "
                f"keeping the {k} strongest (raise max_candidates_per_block "
                "or lower the threshold noise)", stacklevel=2)
        # the kernels pre-mask to the core slab; re-check as a safety net
        # (halo detections belong to the neighboring block)
        keep = valid.astype(bool)
        for d in range(3):
            keep &= (idx[:, d] >= halo) & (idx[:, d] < halo + shape[d])
        if not keep.any():
            return
        # block-local (with halo) -> view detection-res coords; lexsorted by
        # position so output order is deterministic
        src = (sub if params.localization.upper() == "QUADRATIC"
               else idx)  # --localization NONE keeps integer extrema
        pts = (src[keep].astype(np.float64) - halo
               + np.array(job.core.min, np.float64))
        vv = vals[keep].astype(np.float64)
        order = np.lexsort(pts.T[::-1])
        job.result = (pts[order], vv[order])
        if extra:  # (desc, dvalid) riders of the detect-and-extract program
            dsc, dvalid = extra
            job.result += (dsc[keep][order], dvalid[keep][order].astype(bool))

    def run_batch(inputs, batch, rel):
        t0 = time.perf_counter()
        cols = [np.stack([it[j] for it in inputs]) for j in range(5)]
        x = torch.from_numpy(cols[0]).to(dev)
        lo, hi, thr, org = (torch.from_numpy(c).to(dev) for c in cols[1:])
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        timings["h2d"] += time.perf_counter() - t0
        args = (x, lo, hi, thr, org, params.sigma, params.find_max,
                params.find_min, int(params.max_candidates_per_block), halo,
                rel)
        if want_desc:
            outs, secs = _batch_seconds(dev, lambda: dog_detect_extract_batch(
                *args, int(params.descriptor_neighbors),
                int(params.descriptor_redundancy), True))
        else:
            outs, secs = _batch_seconds(
                dev, lambda: dog_block_topk_batch(*args))
        timings["kernels"] += secs
        t0 = time.perf_counter()
        host = [o.cpu().numpy() for o in outs]
        timings["d2h"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        for i, job in enumerate(batch):
            consume(job, *(h[i] for h in host))
        timings["tail"] += time.perf_counter() - t0

    # bucket by (det-res block shape, residual factors, input dtype); the
    # median path pre-pools on the host side, so its program sees
    # rel=(1,1,1) float32 det-res blocks
    buckets: dict[tuple, list[_BlockJob]] = {}
    for job in jobs:
        plan = plans[view_list[job.view_idx]]
        if params.median_radius > 0:
            rel, dt = (1, 1, 1), "<f4"
        else:
            rel = plan.rel
            dt = np.dtype(loader.open(plan.view, plan.level).dtype
                          ).newbyteorder("=").str
        shp = tuple(s + 2 * halo for s in job.core.shape)
        buckets.setdefault((shp, rel, dt), []).append(job)
    stats.buckets += len(buckets)
    if devices is not None and int(devices) > 1:
        _detect_sharded(buckets, build, consume, params, halo, int(devices),
                        make_mesh(int(devices), platform=dev.type), stats)
        return _assemble(view_list, jobs, plans, overlap_boxes, params, ds,
                         loader, dev, stats, progress, t_start)
    # level-res inputs are prod(rel) x larger per det-voxel than the pooled
    # float32 blocks batch_size was tuned for: scale the batch down
    batches = []
    for (shp, rel, dt), bjobs in sorted(buckets.items()):
        n = max(1, int(params.batch_size) // int(np.prod(rel)))
        batches += [(bjobs[i:i + n], rel) for i in range(0, len(bjobs), n)]
    stats.batches += len(batches)
    with ThreadPoolExecutor(max_workers=8) as pool:
        futs = [pool.submit(build, j) for j in batches[0][0]] if batches else []
        for bi, (batch, rel) in enumerate(batches):
            t0 = time.perf_counter()
            inputs = [f.result() for f in futs]
            timings["read"] += time.perf_counter() - t0
            futs = ([pool.submit(build, j) for j in batches[bi + 1][0]]
                    if bi + 1 < len(batches) else [])
            run_batch(inputs, batch, rel)
            del inputs
    return _assemble(view_list, jobs, plans, overlap_boxes, params, ds,
                     loader, dev, stats, progress, t_start)


def _detect_sharded(buckets, build, consume, params: DetectionParams, halo,
                    n_dev: int, mesh, stats: DetectionStats) -> None:
    """The sharded route (JAX detection.py:459-460, :521-551): each
    bucket's blocks in batches of ``n_dev x per_dev``, every bucket's
    batches in one loop over ``mesh``; a device runs the one-device
    route's program (:func:`..ops.dog.dog_block_topk_batch`, or
    :func:`..ops.dog.dog_detect_extract_batch` with descriptors) on its
    rows, and ``consume`` takes each real row on the writer pool."""
    want_desc = bool(params.extract_descriptors)
    k = int(params.max_candidates_per_block)
    per_dev = max(1, int(params.batch_size) // max(n_dev, 1))
    stats.mesh = tuple(str(d) for d in mesh.devices)
    kernels, batches, wmult = {}, [], 8.0
    for key, bjobs in sorted(buckets.items()):
        shp, rel, dt = key
        pd = max(1, per_dev // int(np.prod(rel)))
        stats.per_dev.append(pd)
        batches += group_items([(key, j) for j in bjobs], n_dev, pd)

        def program(x, lo, hi, thr, org, rel=rel):
            args = (x, lo, hi, thr, org, params.sigma, params.find_max,
                    params.find_min, k, halo, rel)
            if want_desc:
                return dog_detect_extract_batch(
                    *args, int(params.descriptor_neighbors),
                    int(params.descriptor_redundancy), True)
            return dog_block_topk_batch(*args)

        kernels[key] = shard_batch(program, mesh)
        # the DoG expands the native-type input to several pooled float32
        # volumes on the device; with descriptors the (K, K) distances of
        # the extract half dominate (JAX detection.py:539-546). One loop
        # runs every bucket: it is charged at the largest multiplier
        if want_desc:
            wmult = max(wmult, 8.0 + k * k * 4 / max(
                1, int(np.prod(shp)) * np.dtype(dt).itemsize))
    stats.batches += len(batches)
    timings: dict = {}

    def build_timed(entry):
        t0 = time.perf_counter()
        out = build(entry[1])
        add_time(stats.timings, "read", time.perf_counter() - t0)
        return out

    def kernel(batch, *stacked):
        return kernels[batch[0][0]](batch, *stacked)

    def consume_timed(entry, *rows):
        t0 = time.perf_counter()
        consume(entry[1], *rows)
        add_time(stats.timings, "tail", time.perf_counter() - t0)

    with ThreadPoolExecutor(max_workers=8,
                            thread_name_prefix="bst-det-read") as pool:
        run_sharded_batches(batches, build_timed, kernel, consume_timed,
                            pool, mesh, label="detection batch",
                            timings=timings, workspace_mult=wmult)
    for ours, theirs in (("h2d", "h2d"), ("kernels", "kernel"),
                         ("d2h", "d2h")):
        stats.timings[ours] += timings.get(theirs, 0.0)


def _assemble(view_list, jobs, plans, overlap_boxes, params, ds, loader,
              dev, stats, progress, t_start):
    """The host tail after every block's ``consume``: each view's points in
    job order, filtered, moved to full resolution, optionally sampled."""
    want_desc = bool(params.extract_descriptors)
    timings = stats.timings
    t0 = time.perf_counter()
    per_view: dict[int, list[tuple[np.ndarray, np.ndarray]]] = {
        i: [] for i in range(len(view_list))}
    for job in jobs:  # original job order => deterministic concatenation
        if job.result is not None:
            per_view[job.view_idx].append(job.result)

    out = []
    for vi, v in enumerate(view_list):
        plan = plans[v]
        res = per_view[vi]
        if res:
            pts = np.concatenate([r[0] for r in res])
            vals = np.concatenate([r[1] for r in res])
            riders = tuple(np.concatenate([r[i] for r in res])
                           for i in range(2, len(res[0])))
        else:
            pts, vals = np.zeros((0, 3)), np.zeros(0)
            riders = _empty_riders(params) if want_desc else ()
        pts, vals, riders = _filter_spots(pts, vals, overlap_boxes.get(v),
                                          params, riders)
        # detection-res -> full-res: average downsampling by f maps level
        # voxel p to full-res f*p + (f-1)/2 (DownsampleTools.correctForDownsampling)
        T = mipmap_transform(ds)
        full = apply_affine(T, pts) if len(pts) else pts
        det = ViewDetections(v, full, vals)
        if want_desc:
            det.descriptors, det.descriptor_valid = riders
        if params.store_intensities and len(pts):
            det.intensities = _sample_intensities(loader, plan, pts, dev)
        out.append(det)
        stats.points += len(full)
        if progress:
            print(f"  {v}: {len(full)} interest points", flush=True)
    timings["tail"] += time.perf_counter() - t0
    stats.seconds += time.perf_counter() - t_start
    return out


def _empty_riders(params: DetectionParams):
    """The riders of a view without points: (0, S, 3n) float32 and (0,)
    bool."""
    n = int(params.descriptor_neighbors)
    s = len(subset_combinations(n + int(params.descriptor_redundancy), n))
    return np.zeros((0, s, n * 3), np.float32), np.zeros(0, bool)


def _filter_spots(pts, vals, boxes, params: DetectionParams, riders=()):
    """overlappingOnly final crop + brightest-N filters
    (filterPoints / maxSpotsPerOverlap, SparkInterestPointDetection.java:745-806,973-995).
    ``riders``: extra per-point arrays (descriptors, validity) that follow
    every mask and reordering of ``pts`` and ``vals``."""
    riders = tuple(riders)
    if boxes is not None and len(pts):
        keep = np.zeros(len(pts), bool)
        for b in boxes:
            inside = np.all(
                (pts >= np.array(b.min)) & (pts <= np.array(b.max)), axis=1
            )
            keep |= inside
        pts, vals = pts[keep], vals[keep]
        riders = tuple(r[keep] for r in riders)
    if params.max_spots > 0 and len(pts):
        if params.max_spots_per_overlap and boxes:
            total_vol = sum(b.num_elements for b in boxes)
            keep = np.zeros(len(pts), bool)
            assigned = np.zeros(len(pts), bool)
            for b in boxes:
                budget = max(1, int(round(params.max_spots * b.num_elements / total_vol)))
                inside = np.all(
                    (pts >= np.array(b.min)) & (pts <= np.array(b.max)), axis=1
                ) & ~assigned
                idx = np.where(inside)[0]
                assigned[idx] = True
                if len(idx) > budget:
                    order = np.argsort(-np.abs(vals[idx]))[:budget]
                    idx = idx[order]
                keep[idx] = True
            pts, vals = pts[keep], vals[keep]
            riders = tuple(r[keep] for r in riders)
        elif len(pts) > params.max_spots:
            order = np.argsort(-np.abs(vals))[: params.max_spots]
            pts, vals = pts[order], vals[order]
            riders = tuple(r[order] for r in riders)
    return pts, vals, riders


def _sample_intensities(loader, plan: _ViewPlan, det_pts: np.ndarray,
                        device: torch.device, cell: int = 64) -> np.ndarray:
    """Sample image intensity at each detection (detection-res coords) via
    trilinear interpolation. Points are binned into ``cell``-sized spatial
    cells and each occupied cell is read once (+1 px margin), so memory is
    bounded by the cell size instead of the detections' bounding box
    (SparkInterestPointDetection.java:581-606)."""
    if len(det_pts) == 0:
        return np.zeros(0)
    out = np.zeros(len(det_pts))
    cells = np.floor(det_pts / cell).astype(np.int64)
    order = np.lexsort(cells.T[::-1])
    uniq, starts = np.unique(cells[order], axis=0, return_index=True)
    bounds = np.append(starts, len(order))
    for k, c in enumerate(uniq):
        idx = order[bounds[k]:bounds[k + 1]]
        lo = np.maximum(c * cell - 1, 0)
        hi = np.minimum((c + 1) * cell + 2, np.asarray(plan.det_dims))
        vol = plan.read_det_block(loader, lo, hi - lo, device)
        out[idx] = sample_trilinear(vol, det_pts[idx] - lo)
    return out


def save_detections(
    sd: SpimData,
    store: InterestPointStore,
    detections: list[ViewDetections],
    params: DetectionParams,
) -> None:
    """Persist to interestpoints.n5 + register in the XML
    (InterestPointTools.addInterestPoints role)."""
    for det in detections:
        grp = store.save_points(
            det.view, params.label, det.points,
            intensities=det.intensities,
        )
        register_points_in_xml(sd, det.view, params.label,
                               params.params_string(), grp)
