"""Non-rigid fusion driver: unique points, per-block control grids, K26,
K4, block writes.

Port of ``bigstitcher_spark_tpu/models/nonrigid_fusion.py``
(SparkNonRigidFusion, SparkNonRigidFusion.java:313-435): per output block, the views to fuse are
those overlapping the block (+50 px margin), and the deformation of each
view comes from corresponding interest points near the block (+25 px and
two grid spacings of margin), merged into "unique points" (the average
world position of each correspondence group). Each view's control grid maps
the averaged position back to the view's own world frame, so all views
agree at the control points.

Per compute block a thread pool plans (the host fits of
:func:`..ops.nonrigid.fit_control_grid`, float64) and reads the source
patches ahead, while the main thread uploads a block, fuses it with K26
(:func:`..ops.nonrigid.nonrigid_fuse_block`), converts it with K4
(:func:`..ops.fusion.convert_intensity`), copies it back and hands it to a
writer pool. The JAX driver plans every block up front and converts in the
same program; each block's result depends on that block alone, so the
output is the same.

With ``devices`` above 1, the sharded route (:func:`_fuse_nonrigid_sharded`,
JAX ``fuse_nonrigid_volume`` :176-256): every block is planned first on the
pool, the blocks are bucketed by (patch shape, view count), and each
bucket's batches of ``devices`` blocks go through one launch of K26's
batch form and one of K4 a device (:func:`..parallel.mesh.shard_batch`);
the drain workers copy the rows back and the writer pool writes them. Its
output is bitwise the one-device route's.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch

from .. import config
from ..io.chunkstore import Dataset
from ..io.dataset_io import ViewLoader
from ..io.interestpoints import InterestPointStore
from ..io.spimdata import SpimData, ViewId
from ..ops import fusion as F
from ..ops.nonrigid import (
    fit_control_grid,
    nonrigid_fuse_block,
    nonrigid_fuse_block_batch,
)
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
    concatenate,
    invert_affine,
    translation_affine,
    transformed_interval,
)
from ..utils.grid import GridBlock, create_grid
from .affine_fusion import (
    BlendParams,
    FusionStats,
    _write,
    anisotropy_transform,
    patch_dtype,
    run_block_pipeline,
)

FUSE_MARGIN = 50.0   # px margin for view selection (SparkNonRigidFusion.java:326-371)
IP_MARGIN = 25.0     # px margin for deformation-defining points


@dataclass
class UniquePoints:
    """Per-view correspondence-averaged control points."""

    targets: dict[ViewId, np.ndarray]      # (M,3) averaged world positions
    view_world: dict[ViewId, np.ndarray]   # (M,3) the view's own world position


def build_unique_points(
    sd: SpimData,
    store: InterestPointStore,
    views: list[ViewId],
    labels: list[str],
) -> UniquePoints:
    """Union-find over correspondences -> groups; target = mean world position
    of the group (NonRigidTools 'unique interest points')."""
    keys: list[tuple[ViewId, str, int]] = []
    index: dict[tuple[ViewId, str, int], int] = {}
    world: dict[tuple[ViewId, str], dict[int, np.ndarray]] = {}
    vset = set(views)

    def load(view: ViewId, label: str):
        k = (view, label)
        if k not in world:
            ids, locs = store.load_points(view, label)
            w = apply_affine(sd.model(view), locs) if len(locs) else locs
            world[k] = dict(zip(ids.astype(int).tolist(), w))
        return world[k]

    def key_id(k):
        if k not in index:
            index[k] = len(keys)
            keys.append(k)
        return index[k]

    parent: list[int] = []

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    edges = []
    for v in views:
        for label in labels:
            if label not in sd.interest_points.get(v, {}):
                continue
            mine = load(v, label)
            for c in store.load_correspondences(v, label):
                if c.other_view not in vset:
                    continue
                theirs = load(c.other_view, c.other_label)
                if c.id not in mine or c.other_id not in theirs:
                    continue
                edges.append(((v, label, c.id),
                              (c.other_view, c.other_label, c.other_id)))
    for a, b in edges:
        ia, ib = key_id(a), key_id(b)
        while len(parent) < len(keys):
            parent.append(len(parent))
        ra, rb = find(ia), find(ib)
        if ra != rb:
            parent[ra] = rb
    while len(parent) < len(keys):
        parent.append(len(parent))

    groups: dict[int, list[tuple[ViewId, str, int]]] = {}
    for i, k in enumerate(keys):
        groups.setdefault(find(i), []).append(k)

    targets: dict[ViewId, list[np.ndarray]] = {v: [] for v in views}
    vw: dict[ViewId, list[np.ndarray]] = {v: [] for v in views}
    for members in groups.values():
        pos = np.array([world[(v, lab)][i] for v, lab, i in members])
        tgt = pos.mean(axis=0)
        for (v, lab, i), p in zip(members, pos):
            if v in targets:
                targets[v].append(tgt)
                vw[v].append(p)
    return UniquePoints(
        {v: (np.array(t) if t else np.zeros((0, 3))) for v, t in targets.items()},
        {v: (np.array(t) if t else np.zeros((0, 3))) for v, t in vw.items()},
    )


_TIMINGS = ("plan", "read", "h2d", "kernel", "d2h", "write")


def fuse_nonrigid_volume(
    sd: SpimData,
    loader: ViewLoader,
    views: list[ViewId],
    unique: UniquePoints,
    out_ds: Dataset,
    bbox: Interval,
    block_size: tuple[int, ...],
    block_scale: tuple[int, ...] = (2, 2, 1),
    cpd: float = 10.0,
    alpha: float = 1.0,
    fusion_type: str = "AVG_BLEND",
    blend: BlendParams | None = None,
    anisotropy_factor: float = float("nan"),
    out_dtype: str = "float32",
    min_intensity: float | None = None,
    max_intensity: float | None = None,
    zarr_ct: tuple[int, int] | None = None,
    io_threads: int = 4,
    device: str | torch.device | None = None,
    devices: int | None = None,
) -> FusionStats:
    """Fuse ``views`` non-rigidly into ``out_ds`` over ``bbox`` on
    ``device``: ``cuda`` (the default; raises without a card) or ``cpu``
    (the plain-torch twins). ``devices``: above 1, the sharded route over
    the first ``devices`` cards (``[cpu] * devices`` with ``device="cpu"``;
    one card for ``devices=4`` on a one-card host, as in JAX); None or 1:
    one device.

    ``stats.timings`` holds seconds per phase: ``plan`` (view selection and
    control-grid fits) and ``read`` (patch staging), summed over the reader
    threads; ``h2d``, ``kernel`` (K26 and K4, synchronised), ``d2h`` on
    the main thread; ``write`` summed over the writer threads; on a card
    also ``card``, the seconds K26 and K4 kept it busy (CUDA events)."""
    dev = resolve_device(device)
    stats = FusionStats(path="nonrigid", kernel_blocks={"nonrigid": 0},
                        timings=dict.fromkeys(_TIMINGS, 0.0))
    t0 = time.time()
    blend = blend or BlendParams()
    aniso = anisotropy_transform(anisotropy_factor)
    compute_block = tuple(b * s for b, s in zip(block_size, block_scale))
    grid_blocks = create_grid(bbox.shape, compute_block, block_size)
    if min_intensity is None or max_intensity is None:
        min_intensity, max_intensity = {
            "uint8": (0.0, 255.0), "uint16": (0.0, 65535.0)}.get(
                out_dtype, (0.0, 1.0))
    threads = config.get("BST_WRITE_THREADS") or 1
    if devices is not None and int(devices) > 1:
        stats.path = "sharded"
        _fuse_nonrigid_sharded(
            sd, loader, views, unique, out_ds, bbox, grid_blocks,
            compute_block, cpd, alpha, fusion_type, blend, aniso, out_dtype,
            min_intensity, max_intensity, zarr_ct, io_threads, stats,
            int(devices), make_mesh(int(devices), platform=dev.type))
        stats.seconds = time.time() - t0
        return stats

    def stage(block):
        return block, stage_nonrigid_block(
            sd, loader, views, unique, block, bbox, compute_block, cpd,
            alpha, aniso, blend)

    events = []

    def finish(result, writer):
        block, (arrays, _nv, plan_s, read_s) = result
        stats.timings["plan"] += plan_s
        stats.timings["read"] += read_s
        stats.blocks += 1
        if arrays is None:
            stats.skipped_empty += 1
            return
        th = time.perf_counter()
        inputs = [torch.from_numpy(a).to(dev) for a in arrays]
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        tk = time.perf_counter()
        if dev.type == "cuda":
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
        fused, _wsum = nonrigid_fuse_block(*inputs, block_shape=compute_block,
                                           fusion_type=fusion_type)
        conv = F.convert_intensity(fused, min_intensity, max_intensity,
                                   out_dtype)
        if dev.type == "cuda":
            ev[1].record()
            events.append(ev)
            torch.cuda.synchronize(dev)
        td = time.perf_counter()
        sl = tuple(slice(0, s) for s in block.size)
        data = np.ascontiguousarray(conv.cpu().numpy()[sl])
        stats.timings["h2d"] += tk - th
        stats.timings["kernel"] += td - tk
        stats.timings["d2h"] += time.perf_counter() - td
        writer.submit(_write, out_ds, data, block.offset, zarr_ct)
        stats.kernel_blocks["nonrigid"] += 1
        stats.voxels += int(np.prod(block.size))

    run_block_pipeline(grid_blocks, stage, finish, io_threads, threads,
                       stats.timings)
    if events:
        stats.timings["card"] = sum(a.elapsed_time(b) for a, b in events) / 1e3
    stats.seconds = time.time() - t0
    return stats


def _fuse_nonrigid_sharded(
    sd, loader, views, unique, out_ds, bbox, grid_blocks, compute_block,
    cpd, alpha, fusion_type, blend, aniso, out_dtype, min_intensity,
    max_intensity, zarr_ct, io_threads, stats, n_dev, mesh,
):
    """The multi-device route (JAX ``fuse_nonrigid_volume`` :176-256 and
    ``_make_nonrigid_kernel`` :259-275): every block planned on the pool
    (view selection and control-grid fits; each plan depends on its block
    alone), the planned blocks bucketed by (patch shape, view count) and
    cut into batches of ``n_dev`` blocks (per_dev 1, the JAX default); a
    batch's rows go over ``mesh``, each device's through one launch of
    K26's batch form and one of K4 with the intensity range replicated;
    the writer pool writes each block's rows."""
    gdims = control_grid_dims(compute_block, cpd)
    pool = ThreadPoolExecutor(max_workers=max(1, io_threads),
                              thread_name_prefix="bst-stage")

    def plan(block):
        t0 = time.perf_counter()
        res = _plan_nonrigid_block(sd, views, unique, block, bbox,
                                   compute_block, gdims, cpd, alpha, aniso)
        add_time(stats.timings, "plan", time.perf_counter() - t0)
        return block, res

    try:
        planned = []
        for block, res in pool.map(plan, grid_blocks):
            stats.blocks += 1
            if res is None:
                stats.skipped_empty += 1
                continue
            planned.append((block, *res))

        buckets: dict[tuple, list] = {}
        for item in planned:
            plans = item[3]
            vb = F.bucket_views(len(plans))
            pshape = F.bucket_shape(
                np.max([p[3].shape for p in plans], axis=0), 32)
            buckets.setdefault((pshape, vb), []).append(item)
        stats.mesh = tuple(str(d) for d in mesh.devices)
        batches = []
        for key, items in sorted(buckets.items(), key=lambda kv: str(kv[0])):
            groups = group_items([(key, it) for it in items], n_dev, 1)
            batches += groups
            stats.buckets.append(dict(key=("nonrigid", *key),
                                      blocks=len(items), per_dev=1,
                                      batches=len(groups)))
        stats.batches = len(batches)
        stats.kernel_blocks["nonrigid"] = len(planned)
        stats.compile_keys.add((tuple(compute_block), fusion_type, out_dtype,
                                "nonrigid", "sharded"))

        def build(entry):
            t0 = time.perf_counter()
            (pshape, vb), (_block, block_global, grid_origin, plans) = entry
            arrs = (*_stage_nonrigid(loader, plans, pshape, vb, blend, gdims),
                    np.asarray(block_global.min, np.float32),
                    np.asarray(grid_origin, np.float32),
                    np.full(3, cpd, np.float32))
            add_time(stats.timings, "read", time.perf_counter() - t0)
            return arrs

        def one(mi, ma, *arrays):
            fused, _wsum = nonrigid_fuse_block_batch(
                *arrays, block_shape=compute_block, fusion_type=fusion_type)
            return F.convert_intensity(fused, mi, ma, out_dtype)

        sharded = shard_batch(one, mesh, n_repl=2)

        def kernel(batch, *stacked):
            return sharded(batch, min_intensity, max_intensity, *stacked)

        written: dict[tuple, int] = {}

        def consume(entry, data):
            block = entry[1][0]
            _write(out_ds, data[tuple(slice(0, s) for s in block.size)],
                   block.offset, zarr_ct)
            written[tuple(block.offset)] = int(np.prod(block.size))

        item_out = int(np.prod(compute_block)) * np.dtype(out_dtype).itemsize
        run_sharded_batches(batches, build, kernel, consume, pool, mesh,
                            label="nonrigid batch",
                            out_bytes=lambda entry: item_out,
                            timings=stats.timings, workspace_mult=4.0)
    finally:
        pool.shutdown(wait=True)
    stats.voxels += sum(written.values())


def control_grid_dims(compute_block, cpd: float) -> tuple[int, ...]:
    """Vertices a compute block's control grid has along each axis: the
    grid starts one spacing before the block and covers it with margins."""
    return tuple(int(np.ceil(c / cpd)) + 3 for c in compute_block)


def stage_nonrigid_block(sd, loader, views, unique: UniquePoints,
                         block: GridBlock, bbox: Interval, compute_block,
                         cpd: float = 10.0, alpha: float = 1.0, aniso=None,
                         blend: BlendParams | None = None):
    """One compute block's K26 inputs as host arrays, in
    :func:`..ops.nonrigid.nonrigid_fuse_block`'s argument order: the views
    are selected and fitted (:func:`_plan_nonrigid_block`) and their
    patches read (:func:`_stage_nonrigid`). Returns ``(arrays, views,
    plan_s, read_s)``: ``arrays`` is None when no view covers the block,
    ``views`` counts the views before padding, and the two times are the
    seconds of each step."""
    ts = time.perf_counter()
    gdims = control_grid_dims(compute_block, cpd)
    res = _plan_nonrigid_block(sd, views, unique, block, bbox, compute_block,
                               gdims, cpd, alpha, aniso)
    tp = time.perf_counter()
    if res is None:
        return None, 0, tp - ts, 0.0
    block_global, grid_origin, plans = res
    pshape = F.bucket_shape(np.max([p[3].shape for p in plans], axis=0), 32)
    arrays = (*_stage_nonrigid(loader, plans, pshape,
                               F.bucket_views(len(plans)),
                               blend or BlendParams(), gdims),
              np.asarray(block_global.min, np.float32),
              np.asarray(grid_origin, np.float32),
              np.full(3, cpd, np.float32))
    return arrays, len(plans), tp - ts, time.perf_counter() - tp


def _plan_nonrigid_block(
    sd, views, unique: UniquePoints, block: GridBlock, bbox: Interval,
    compute_block, gdims, cpd, alpha, aniso,
):
    """Select + fit the views contributing to one block; returns
    (block_global, grid_origin, plans) or None when nothing overlaps."""
    block_global = Interval.from_shape(compute_block, block.offset
                                       ).translate(bbox.min)
    grid_origin = np.asarray(block_global.min, np.float64) - cpd
    sel_box = block_global.expand(int(FUSE_MARGIN))
    ip_box = block_global.expand(int(IP_MARGIN + 2 * cpd))

    plans = []
    for v in views:
        model = sd.model(v)
        if aniso is not None:
            model = concatenate(aniso, model)
        vbox = transformed_interval(
            model, Interval.from_shape(sd.view_size(v)))
        if not vbox.overlaps(sel_box):
            continue

        # deformation grid from unique points near the block
        tgt = unique.targets.get(v, np.zeros((0, 3)))
        vw = unique.view_world.get(v, np.zeros((0, 3)))
        if len(tgt):
            keep = np.all(
                (tgt >= np.array(ip_box.min)) & (tgt <= np.array(ip_box.max)),
                axis=1,
            )
            tgt, vw = tgt[keep], vw[keep]
        grid = fit_control_grid(tgt, vw, grid_origin, gdims, cpd, alpha)

        # source patch must cover the DEFORMED block under every vertex model
        corners = np.array(
            [[(block_global.min[d], block_global.max[d] + 1)[(i >> d) & 1]
              for d in range(3)] for i in range(8)], np.float64,
        )
        A = grid.reshape(-1, 3, 4).astype(np.float64)
        warped = np.einsum("gij,cj->gci", A[:, :, :3], corners) + A[:, None, :, 3]
        inv_total = invert_affine(model)  # world -> full-res view px (level 0)
        lo = warped.reshape(-1, 3) @ inv_total[:, :3].T + inv_total[:, 3]
        src = Interval(
            tuple(np.floor(lo.min(axis=0)).astype(np.int64) - 1),
            tuple(np.ceil(lo.max(axis=0)).astype(np.int64) + 1),
        )
        img_iv = Interval.from_shape(sd.view_size(v))
        clipped = src.intersect(img_iv)
        if clipped.is_empty():
            continue
        plans.append((v, grid, inv_total, clipped,
                      np.array(sd.view_size(v), np.float64)))

    if not plans:
        return None
    return block_global, grid_origin, plans


def _stage_nonrigid(loader, plans, pshape, vb, blend: BlendParams, gdims):
    """Host-side input staging for one block's nonrigid kernel inputs."""
    # stored integer dtype when every view shares one (<=16-bit): ships at
    # native width, the kernel casts to float32 on the device
    patches = np.zeros(
        (vb, *pshape), patch_dtype(loader, [(v, 0) for v, *_ in plans]))
    grids = np.zeros((vb, *gdims, 12), np.float32)
    grids[..., 0] = 1.0
    grids[..., 5] = 1.0
    grids[..., 10] = 1.0
    vaffines = np.zeros((vb, 3, 4), np.float32)
    offsets = np.zeros((vb, 3), np.float32)
    img_dims = np.ones((vb, 3), np.float32)
    borders = np.zeros((vb, 3), np.float32)
    ranges = np.ones((vb, 3), np.float32)
    valid = np.zeros((vb,), np.float32)
    for i, (v, grid, inv_total, clipped, dim) in enumerate(plans):
        patches[i] = loader.read_block(v, 0, tuple(clipped.min), pshape)
        grids[i] = grid
        vaffines[i] = concatenate(
            translation_affine(-np.asarray(clipped.min, np.float64)), inv_total
        )
        offsets[i] = clipped.min
        img_dims[i] = dim
        borders[i] = blend.border
        ranges[i] = blend.range
        valid[i] = 1.0
    return (patches, grids, vaffines, offsets, img_dims, borders, ranges,
            valid)
