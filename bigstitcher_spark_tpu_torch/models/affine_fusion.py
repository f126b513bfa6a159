"""Affine fusion driver on one device: plan, stage, launch, drain, write.

Port of the single-device part of
``bigstitcher_spark_tpu/models/affine_fusion.py``. :func:`fuse_volume`
takes one of two routes, as the JAX driver does with one device:

* **composite**: when every view is translation- or diagonal-registered at
  stored level 0 and tiles plus the full-volume float32 accumulators fit
  ``BST_DEVICE_TILE_BUDGET``, the tiles go to the device once and K1
  (:func:`..ops.fusion.composite_fuse`) fuses and converts the whole
  volume; x-slabs then drain to host and a thread pool writes them.
* **per-block**: otherwise, per compute block the host stages the source
  patches (a thread pool reads ahead), and K2
  (:func:`..ops.fusion.fuse_block_shift`, all views translations), K5
  (:func:`..ops.fusion.fuse_block_sep`, all views diagonal affines, e.g.
  under ``--preserveAnisotropy``) or K3 (:func:`..ops.fusion.fuse_block`,
  general affine) fuses them; K4 (:func:`..ops.fusion.convert_intensity`)
  converts on the device and a thread pool writes the block.

With a ``pyramid``, the composite route also computes the container's
downsample levels on the device from the converted volume (K6,
:func:`..ops.downsample.downsample_level`) and drains them with it; on the
per-block route the downsample stage
(:func:`.downsample_driver.downsample_pyramid_level`) makes every level.

Intensity coefficients, the sharded multi-device route (and its per-block
epilogue, ``eligible_epilogue_levels``) and the device tile cache are not
yet ported.
"""

from __future__ import annotations

import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import NotYetPorted, config
from ..io.chunkstore import Dataset
from ..io.dataset_io import ViewLoader, best_mipmap_level
from ..io.spimdata import SpimData, ViewId
from ..ops import fusion as F
from ..ops.downsample import downsample_level
from ..utils.device import resolve_device
from ..utils.geometry import (
    Interval,
    concatenate,
    invert_affine,
    scale_affine,
    translation_affine,
    transformed_interval,
)
from ..utils.grid import GridBlock, create_grid
from ..utils.writer import WriterPool


@dataclass
class BlendParams:
    """Cosine blending configuration (mvrecon FusionTools defaults)."""

    border: tuple[float, float, float] = (0.0, 0.0, 0.0)
    range: tuple[float, float, float] = (40.0, 40.0, 40.0)


@dataclass
class FusionStats:
    """What one :func:`fuse_volume` call did. ``path`` is the route
    ("composite" or "per-block"); ``kernel_blocks`` counts per-block
    kernels by kind; ``timings`` holds seconds per phase (host read, H2D,
    kernel, D2H, write), summed over worker threads where they overlap.
    Pyramid levels made by the composite epilogue are counted apart from
    ``voxels`` (``pyramid_levels``, ``pyramid_voxels``), so full-res and
    pyramid-inclusive rates stay distinguishable."""

    voxels: int = 0
    blocks: int = 0
    skipped_empty: int = 0
    seconds: float = 0.0
    path: str = ""
    kernel_blocks: dict = field(default_factory=lambda: {"shift": 0,
                                                         "sep": 0,
                                                         "gather": 0})
    timings: dict = field(default_factory=lambda: dict.fromkeys(
        ("read", "h2d", "kernel", "d2h", "write"), 0.0))
    pyramid_voxels: int = 0
    pyramid_levels: int = 0


@dataclass(frozen=True)
class PyramidLevel:
    """One downsample pyramid level the composite route may compute on the
    device from the fused volume instead of the downsample stage rereading
    the full-res container. ``rel`` is the factor from the PREVIOUS level,
    ``abs_factor`` from full resolution, ``dims`` the 3-D level extent, all
    from the container's ``MultiResolutionLevelInfo``."""

    ds: Dataset
    rel: tuple[int, int, int]
    abs_factor: tuple[int, int, int]
    dims: tuple[int, int, int]


def pyramid_from_mr(store, mr_levels) -> list[PyramidLevel]:
    """The epilogue levels of a container slot's ``MultiResolutionLevelInfo``
    list (levels 1..n; level 0 is the fusion target itself)."""
    return [PyramidLevel(
        ds=store.open_dataset(m.dataset.strip("/")),
        rel=tuple(int(v) for v in m.relativeDownsampling[:3]),
        abs_factor=tuple(int(v) for v in m.absoluteDownsampling[:3]),
        dims=tuple(int(v) for v in m.dimensions[:3]),
    ) for m in mr_levels[1:]]


def anisotropy_transform(factor: float) -> np.ndarray | None:
    """Concatenate (1,1,1/f) scaling into all view models
    (TransformVirtual.adjustAllTransforms, SparkAffineFusion.java:487-491)."""
    if not np.isfinite(factor) or factor == 1.0:
        return None
    return scale_affine((1.0, 1.0, 1.0 / factor))


@dataclass
class _ViewPlan:
    patch_offset: np.ndarray  # (3,) int, level coords
    patch_interval: Interval
    affine: np.ndarray        # (3,4) block idx -> patch coords
    inv_total: np.ndarray     # (3,4) world -> level coords
    img_dim: np.ndarray       # (3,) level image dims
    level: int
    view: ViewId

    @property
    def is_translation(self) -> bool:
        """Sampling is a pure (sub-pixel) shift: K2 / K1 "shift"."""
        return bool(np.allclose(self.inv_total[:, :3], np.eye(3), atol=1e-7))

    @property
    def is_diagonal(self) -> bool:
        """The linear part is axis-aligned: separable sampling (K1 "sep",
        K5)."""
        lin = self.inv_total[:, :3]
        return bool(np.allclose(lin, np.diag(np.diagonal(lin)), atol=1e-7))


def plan_block(
    sd: SpimData,
    loader: ViewLoader,
    views: list[ViewId],
    block_global: Interval,
    anisotropy: np.ndarray | None,
) -> list[_ViewPlan]:
    """Find views overlapping this output block and their needed source boxes."""
    plans: list[_ViewPlan] = []
    for v in views:
        model = sd.model(v)
        if anisotropy is not None:
            model = concatenate(anisotropy, model)
        factors = loader.downsampling_factors(v.setup)
        level = best_mipmap_level(factors, (1.0, 1.0, 1.0))
        mip = loader.mipmap_transform(v.setup, level)
        total = concatenate(model, mip)  # level coords -> world
        inv_total = invert_affine(total)
        src = transformed_interval(inv_total, block_global).expand(1)
        img_shape = loader.open(v, level).shape
        img_iv = Interval.from_shape(img_shape)
        # +2 px tolerance like OverlappingViews (fusion/OverlappingViews.java:28-47)
        if not src.overlaps(img_iv.expand(2)):
            continue
        clipped = src.intersect(img_iv)
        if clipped.is_empty():
            continue
        patch_offset = np.array(clipped.min, dtype=np.float64)
        aff = concatenate(
            translation_affine(-patch_offset),
            concatenate(inv_total, translation_affine(block_global.min)),
        )
        plans.append(
            _ViewPlan(
                patch_offset=np.array(clipped.min, dtype=np.int64),
                patch_interval=clipped,
                affine=aff,
                inv_total=inv_total,
                img_dim=np.array(img_shape, dtype=np.float64),
                level=level,
                view=v,
            )
        )
    return plans


def patch_dtype(loader, view_levels) -> np.dtype:
    """The staged patch dtype: the stored dtype when every view shares
    uint8, uint16 or int16 (the kernels cast to float32 on the device),
    float32 otherwise."""
    dts = {np.dtype(loader.open(*key).dtype).newbyteorder("=")
           for key in view_levels}
    if len(dts) == 1:
        d = dts.pop()
        if d in (np.dtype(np.uint8), np.dtype(np.uint16), np.dtype(np.int16)):
            return d
    return np.dtype(np.float32)


def _blend_per_view(loader, p, blend):
    factors = np.asarray(loader.downsampling_factors(p.view.setup)[p.level],
                         dtype=np.float64)
    return (np.asarray(blend.border) / factors,
            np.asarray(blend.range) / factors)


def _gather_inputs(loader, plans, pshape, vb, blend, inside_offset):
    """Host staging for K3: the clipped source boxes (zero-padded to the
    bucketed patch shape) and the per-view parameter arrays."""
    patches = np.zeros((vb, *pshape), dtype=patch_dtype(
        loader, [(p.view, p.level) for p in plans]))
    affines = np.zeros((vb, 3, 4), dtype=np.float32)
    offsets = np.zeros((vb, 3), dtype=np.float32)
    img_dims = np.ones((vb, 3), dtype=np.float32)
    borders = np.zeros((vb, 3), dtype=np.float32)
    ranges = np.ones((vb, 3), dtype=np.float32)
    valid = np.zeros((vb,), dtype=np.float32)
    for i, p in enumerate(plans):
        patches[i] = loader.read_block(
            p.view, p.level, tuple(p.patch_offset), pshape)
        affines[i] = p.affine
        offsets[i] = p.patch_offset
        img_dims[i] = p.img_dim
        borders[i], ranges[i] = _blend_per_view(loader, p, blend)
        valid[i] = 1.0
    ioffs = np.tile(np.asarray(inside_offset, np.float32), (vb, 1))
    return patches, affines, offsets, img_dims, borders, ranges, valid, ioffs


def _sep_inputs(loader, plans, pshape, vb, blend, inside_offset):
    """Host staging for K5: the gather route's clipped patches, plus the
    diagonal and translation of each view's block->patch affine."""
    (patches, affines, offsets, img_dims, borders, ranges, valid,
     ioffs) = _gather_inputs(loader, plans, pshape, vb, blend, inside_offset)
    diags = np.ascontiguousarray(
        np.stack([np.diagonal(affines[i, :, :3]) for i in range(vb)]))
    ts = np.ascontiguousarray(affines[:, :, 3])
    return patches, diags, ts, offsets, img_dims, borders, ranges, valid, ioffs


def _shift_inputs(loader, plans, block_global, bshape, vb, blend,
                  inside_offset):
    """Host staging for K2: (bx+1, by+1, bz+1) patches at the floor of each
    view's level position of the block origin, plus fractions."""
    pshape = tuple(s + 1 for s in bshape)
    patches = np.zeros((vb, *pshape), dtype=patch_dtype(
        loader, [(p.view, p.level) for p in plans]))
    fracs = np.zeros((vb, 3), dtype=np.float32)
    lpos0 = np.zeros((vb, 3), dtype=np.float32)
    img_dims = np.ones((vb, 3), dtype=np.float32)
    borders = np.zeros((vb, 3), dtype=np.float32)
    ranges = np.ones((vb, 3), dtype=np.float32)
    valid = np.zeros((vb,), dtype=np.float32)
    bg_min = np.asarray(block_global.min, dtype=np.float64)
    for i, p in enumerate(plans):
        tlevel = p.inv_total[:, :3] @ bg_min + p.inv_total[:, 3]
        floor_off = np.floor(tlevel).astype(np.int64)
        patches[i] = loader.read_block(
            p.view, p.level, tuple(floor_off), pshape)
        fracs[i] = tlevel - floor_off
        lpos0[i] = tlevel
        img_dims[i] = p.img_dim
        borders[i], ranges[i] = _blend_per_view(loader, p, blend)
        valid[i] = 1.0
    ioffs = np.tile(np.asarray(inside_offset, np.float32), (vb, 1))
    return patches, fracs, lpos0, img_dims, borders, ranges, valid, ioffs


@dataclass
class StagedBlock:
    """One compute block's host-staged kernel inputs."""

    block: GridBlock
    kind: str          # "shift" (K2), "sep" (K5) or "gather" (K3)
    shape: tuple       # compute block shape the kernel fuses
    arrays: tuple      # numpy kernel inputs, in the wrapper's order


def stage_block(sd, loader, views, block, bbox, compute_block, blend,
                anisotropy, inside_offset):
    """Plan one compute block and read its source patches on the host.
    None when no view overlaps it (the block is left empty)."""
    bshape = tuple(int(s) for s in compute_block)
    block_global = Interval.from_shape(bshape, block.offset).translate(bbox.min)
    plans = plan_block(sd, loader, views, block_global, anisotropy)
    if not plans:
        return None
    vb = F.bucket_views(len(plans))
    if all(p.is_translation for p in plans):
        return StagedBlock(block, "shift", bshape, _shift_inputs(
            loader, plans, block_global, bshape, vb, blend, inside_offset))
    pshape = F.bucket_shape(
        np.max([p.patch_interval.shape for p in plans], axis=0))
    if all(p.is_diagonal for p in plans):
        return StagedBlock(block, "sep", bshape, _sep_inputs(
            loader, plans, pshape, vb, blend, inside_offset))
    return StagedBlock(block, "gather", bshape, _gather_inputs(
        loader, plans, pshape, vb, blend, inside_offset))


_BLOCK_KERNELS = {"shift": F.fuse_block_shift, "sep": F.fuse_block_sep,
                  "gather": F.fuse_block}


def run_staged_block(staged: StagedBlock, fusion_type: str,
                     device: torch.device, timings: dict | None = None):
    """Upload a staged block and fuse it with K2, K5 or K3 (or their plain
    twins on the CPU). Returns device (fused, wsum) of the compute shape."""
    t0 = time.perf_counter()
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in staged.arrays]
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t1 = time.perf_counter()
    *inputs, ioffs = args
    fused, wsum = _BLOCK_KERNELS[staged.kind](
        *inputs, block_shape=staged.shape, fusion_type=fusion_type,
        inside_offs=ioffs)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    if timings is not None:
        timings["h2d"] += t1 - t0
        timings["kernel"] += time.perf_counter() - t1
    return fused, wsum


def fuse_grid_block(sd, loader, views, block, bbox, fusion_type="AVG_BLEND",
                    blend=None, anisotropy=None, compute_block_shape=None,
                    inside_offset=(0.0, 0.0, 0.0), device=None):
    """Fuse one grid block. Returns (fused, wsum) float32 tensors of
    ``block.size`` on ``device`` (default ``cuda``), or None when no view
    overlaps the block."""
    dev = resolve_device(device)
    staged = stage_block(sd, loader, views, block, bbox,
                         compute_block_shape or block.size,
                         blend or BlendParams(), anisotropy, inside_offset)
    if staged is None:
        return None
    fused, wsum = run_staged_block(staged, fusion_type, dev)
    sl = tuple(slice(0, s) for s in block.size)
    return fused[sl], wsum[sl]


@dataclass
class CompositePlan:
    """Host-side plan of the whole-volume composite route: per-view output
    windows, integer tile offsets and pads (runtime arguments of K1) and
    the per-view parameter tensors (float32, CPU)."""

    plans: list
    out_shape: tuple
    windows: tuple
    n_offs: tuple
    pad: tuple
    fracs: torch.Tensor
    img_dims: torch.Tensor
    borders: torch.Tensor
    ranges: torch.Tensor
    inside_offs: torch.Tensor
    kinds: tuple = ()
    diags: torch.Tensor | None = None
    offs: torch.Tensor | None = None


def plan_composite_volume(sd, loader, views, bbox, anisotropy, blend,
                          masks=False, mask_offset=(0.0, 0.0, 0.0)):
    """Plan the composite route. None when a view is neither a translation
    nor a positive diagonal at stored level 0, or when tiles + float32
    accumulators exceed the device budget."""
    vol_iv = Interval.from_shape(bbox.shape).translate(bbox.min)
    plans = plan_block(sd, loader, views, vol_iv, anisotropy)
    if not plans:
        return None
    if any(not (p.is_translation or p.is_diagonal) or p.level != 0
           for p in plans):
        return None
    if any(not p.is_translation
           and np.any(np.diagonal(p.inv_total[:, :3]) <= 0) for p in plans):
        return None  # mirrored axes: keep the general gather path
    shapes = [tuple(int(s) for s in p.img_dim) for p in plans]
    itemsizes = [np.dtype(loader.open(p.view, 0).dtype).itemsize
                 for p in plans]
    nbytes = sum(int(np.prod(s)) * isz for s, isz in zip(shapes, itemsizes))
    # tiles + the full-volume accumulators (acc + wsum + converted output
    # ~= 3 float32 volumes) must fit, as in the JAX planner
    nbytes += 3 * int(np.prod(bbox.shape)) * 4
    if nbytes > config.get("BST_DEVICE_TILE_BUDGET"):
        return None

    out_shape = tuple(bbox.shape)
    io_ceil = tuple(int(np.ceil(max(0.0, o))) for o in
                    (mask_offset if masks else (0.0, 0.0, 0.0)))
    pad = tuple(1 + io_ceil[d] for d in range(3))
    windows, n_offs, kinds = [], [], []
    V = len(plans)
    fracs = np.zeros((V, 3), np.float32)
    diags = np.ones((V, 3), np.float32)
    offs = np.zeros((V, 3), np.float32)
    img_dims = np.ones((V, 3), np.float32)
    borders = np.zeros((V, 3), np.float32)
    ranges = np.ones((V, 3), np.float32)
    inside_offs = np.zeros((V, 3), np.float32)
    if masks:
        inside_offs[:] = np.asarray(mask_offset, np.float32)
    bb_min = np.asarray(bbox.min, np.float64)
    for i, p in enumerate(plans):
        # tile coord of output voxel (0,0,0): g = inv_total @ bbox.min
        g = p.inv_total[:, :3] @ bb_min + p.inv_total[:, 3]
        S = shapes[i]
        if p.is_translation:
            kinds.append("shift")
            n = np.floor(g).astype(np.int64)
            a = tuple(int(max(0, -n[d] - 1 - io_ceil[d])) for d in range(3))
            b = tuple(int(min(out_shape[d], S[d] - n[d] + io_ceil[d]))
                      for d in range(3))
            n_offs.append(tuple(int(v) for v in n))
            fracs[i] = g - n
        else:
            kinds.append("sep")
            dg = np.diagonal(p.inv_total[:, :3]).astype(np.float64)
            a = tuple(int(max(0, np.floor((-1.0 - io_ceil[d] - g[d]) / dg[d])))
                      for d in range(3))
            b = tuple(int(min(out_shape[d],
                              np.ceil((S[d] + io_ceil[d] - g[d]) / dg[d]) + 1))
                      for d in range(3))
            n_offs.append((0, 0, 0))
            diags[i] = dg
            offs[i] = g
        windows.append((a, b))
        img_dims[i] = p.img_dim
        borders[i], ranges[i] = _blend_per_view(loader, p, blend)
    t = torch.from_numpy
    return CompositePlan(plans, out_shape, tuple(windows), tuple(n_offs), pad,
                         t(fracs), t(img_dims), t(borders), t(ranges),
                         t(inside_offs), tuple(kinds), t(diags), t(offs))


def composite_plan_from_reference(fields) -> CompositePlan | list[_ViewPlan]:
    """The port's plan built from the numpy fields of a JAX ``CompositePlan``
    (an object or a mapping), or from a list of JAX ``_ViewPlan``s. Tests
    use it to feed both packages identical kernel inputs and to compare the
    port's own planner with the JAX one."""
    from ..io.spimdata import ViewId as _ViewId

    if isinstance(fields, (list, tuple)):
        return [_ViewPlan(
            patch_offset=np.asarray(p.patch_offset, np.int64),
            patch_interval=Interval(p.patch_interval.min, p.patch_interval.max),
            affine=np.asarray(p.affine, np.float64),
            inv_total=np.asarray(p.inv_total, np.float64),
            img_dim=np.asarray(p.img_dim, np.float64),
            level=int(p.level),
            view=_ViewId(int(p.view.timepoint), int(p.view.setup)),
        ) for p in fields]
    get = (fields.get if isinstance(fields, dict)
           else lambda k, d=None: getattr(fields, k, d))
    if get("coeffs") is not None:
        raise NotYetPorted("intensity coefficients in the composite plan")
    V = len(get("windows"))
    f32 = lambda k, fill: torch.from_numpy(np.ascontiguousarray(
        get(k) if get(k) is not None else np.full((V, 3), fill), np.float32))
    plans = composite_plan_from_reference(list(get("plans") or []))
    return CompositePlan(
        plans=plans,
        out_shape=tuple(int(s) for s in get("out_shape")),
        windows=tuple((tuple(int(x) for x in a), tuple(int(x) for x in b))
                      for a, b in get("windows")),
        n_offs=tuple(tuple(int(x) for x in n) for n in get("n_offs")),
        pad=tuple(int(x) for x in get("pad")),
        fracs=f32("fracs", 0.0), img_dims=f32("img_dims", 1.0),
        borders=f32("borders", 0.0), ranges=f32("ranges", 1.0),
        inside_offs=f32("inside_offs", 0.0),
        kinds=tuple(get("kinds") or ("shift",) * V),
        diags=f32("diags", 1.0), offs=f32("offs", 0.0),
    )


def staged_from_reference(block: GridBlock, block_shape, arrays,
                          kind: str) -> StagedBlock:
    """A port :class:`StagedBlock` of ``kind`` from the numpy kernel inputs
    the JAX per-block staging returns (``_sep_inputs``, ``_shift_inputs``
    or ``_gather_inputs`` without its coefficient arrays), which are in the
    order the port's wrappers take."""
    return StagedBlock(
        GridBlock(tuple(block.offset), tuple(block.size),
                  tuple(block.grid_pos)), kind,
        tuple(int(s) for s in block_shape),
        tuple(np.ascontiguousarray(a) for a in arrays))


def pyramid_from_reference(levels) -> list[PyramidLevel]:
    """The port's epilogue levels from a JAX ``PyramidLevel`` list: the same
    factors and dims, each dataset opened by the port's own store."""
    from ..io.chunkstore import ChunkStore

    return [PyramidLevel(
        ds=ChunkStore.open(lv.ds.store.root).open_dataset(lv.ds.path),
        rel=tuple(int(v) for v in lv.rel),
        abs_factor=tuple(int(v) for v in lv.abs_factor),
        dims=tuple(int(v) for v in lv.dims),
    ) for lv in levels]


def upload_composite_tiles(loader, cp: CompositePlan, device, timings=None):
    """Read every planned tile in full on the host and copy it to the device."""
    tiles = []
    for p in cp.plans:
        t0 = time.perf_counter()
        arr = loader.open(p.view, 0).read_full()
        t1 = time.perf_counter()
        tiles.append(torch.from_numpy(arr).to(device))
        if timings is not None:
            timings["read"] += t1 - t0
            timings["h2d"] += time.perf_counter() - t1
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return tiles


def dispatch_composite(cp: CompositePlan, tiles, fusion_type, out_dtype,
                       masks, min_intensity, max_intensity):
    """K1 over the whole volume; returns the converted device volume."""
    return F.composite_fuse(
        tiles, cp.fracs, cp.img_dims, cp.borders, cp.ranges, cp.inside_offs,
        min_intensity, max_intensity, cp.diags, cp.offs,
        out_shape=cp.out_shape, windows=cp.windows, n_offs=cp.n_offs,
        pad=cp.pad, fusion_type=fusion_type, out_dtype=out_dtype,
        masks=masks, kinds=cp.kinds)


def _write(out_ds: Dataset, data: np.ndarray, offset, zarr_ct) -> None:
    if zarr_ct is not None:
        c, t = zarr_ct
        out_ds.write(data[..., None, None], (*offset, c, t))
    else:
        out_ds.write(data, offset)


def _epilogue_pyramid_device(vol: torch.Tensor, pyramid, out_dtype):
    """The downsample pyramid chained on the device from the converted
    full-res volume: each level is K6's float32 mean of the previous one,
    converted back to the storage type between steps, which is what the
    container-reread path sees when it reads the stored previous level; so
    the levels equal ``downsample_pyramid_level`` output bit for bit.
    Returns [(PyramidLevel, device tensor), ...]."""
    levels = []
    prev = vol
    for lv in pyramid:
        prev = downsample_level(prev, lv.rel, lv.dims, str(out_dtype))
        levels.append((lv, prev))
    return levels


def _slab_step(vol: torch.Tensor, ds: Dataset) -> int:
    """x-slab thickness: whole storage chunks, about 8 MB or more."""
    step = max(int(ds.block_size[0]), 1)
    row_bytes = int(np.prod(vol.shape[1:])) * vol.element_size()
    if row_bytes * step < (8 << 20):
        step *= int(np.ceil((8 << 20) / max(row_bytes * step, 1)))
    return step


def _drain_device_volume(out: torch.Tensor, out_ds: Dataset, zarr_ct,
                         threads: int, timings: dict, pyramid=(),
                         out_dtype: str = "float32") -> list:
    """Copy the fused volume to host in x-slabs and write them from a
    thread pool while later slabs copy; then compute the ``pyramid``
    levels on the device (queued behind the full-res copies on the same
    stream, so s0 lands first and the reductions overlap its writes) and
    drain them the same way. Returns [(PyramidLevel, device tensor), ...]."""
    writer = WriterPool(threads, timings)

    def drain(vol, ds):
        step = _slab_step(vol, ds)
        for x0 in range(0, vol.shape[0], step):
            t0 = time.perf_counter()
            data = vol[x0:x0 + step].cpu().numpy()
            timings["d2h"] += time.perf_counter() - t0
            writer.submit(_write, ds, data, (x0, 0, 0), zarr_ct)

    try:
        drain(out, out_ds)
        tk = time.perf_counter()
        levels = _epilogue_pyramid_device(out, pyramid, out_dtype)
        if out.device.type == "cuda":
            torch.cuda.synchronize(out.device)
        timings["kernel"] += time.perf_counter() - tk
        for lv, lvol in levels:
            drain(lvol, lv.ds)
    finally:
        writer.close()
    return levels


def fuse_volume(
    sd: SpimData,
    loader: ViewLoader,
    views: list[ViewId],
    out_ds: Dataset,
    bbox: Interval,
    block_size: tuple[int, ...],
    block_scale: tuple[int, ...] = (2, 2, 1),
    fusion_type: str = "AVG_BLEND",
    blend: BlendParams | None = None,
    anisotropy_factor: float = float("nan"),
    out_dtype: str = "float32",
    min_intensity: float | None = None,
    max_intensity: float | None = None,
    masks: bool = False,
    mask_offset: tuple[float, float, float] = (0.0, 0.0, 0.0),
    zarr_ct: tuple[int, int] | None = None,
    io_threads: int = 4,
    device: str | torch.device | None = None,
    pyramid: list[PyramidLevel] | None = None,
) -> FusionStats:
    """Fuse ``views`` into ``out_ds`` over ``bbox`` on one device.

    ``zarr_ct``: (channel, timepoint) indices when out_ds is a 5-D OME-ZARR
    dataset. ``device``: ``cuda`` (the default; raises without a card) or
    ``cpu`` (the plain-torch twins). The composite route is taken when
    the tiles and the volume fit ``BST_DEVICE_TILE_BUDGET``, else the
    per-block route. ``pyramid``: downsample levels the composite route
    computes on the device and drains with the volume (bit-identical to
    the downsample stage); the per-block route makes none.
    ``stats.pyramid_levels`` says how many were made: the rest are the
    downsample stage's job."""
    dev = resolve_device(device)
    stats = FusionStats()
    t0 = time.time()
    blend = blend or BlendParams()
    aniso = anisotropy_transform(anisotropy_factor)
    compute_block = tuple(b * s for b, s in zip(block_size, block_scale))
    grid = create_grid(bbox.shape, compute_block, block_size)
    if min_intensity is None or max_intensity is None:
        min_intensity, max_intensity = {
            "uint8": (0.0, 255.0), "uint16": (0.0, 65535.0)}.get(
                out_dtype, (0.0, 1.0))
    threads = config.get("BST_WRITE_THREADS") or 1

    cp = plan_composite_volume(sd, loader, views, bbox, aniso, blend, masks,
                               mask_offset)
    if cp is not None:
        stats.path = "composite"
        tiles = upload_composite_tiles(loader, cp, dev, stats.timings)
        tk = time.perf_counter()
        vol = dispatch_composite(cp, tiles, fusion_type, out_dtype, masks,
                                 min_intensity, max_intensity)
        del tiles
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        stats.timings["kernel"] += time.perf_counter() - tk
        levels = _drain_device_volume(vol, out_ds, zarr_ct, threads,
                                      stats.timings, pyramid or (),
                                      out_dtype)
        stats.blocks = len(grid)
        stats.voxels = bbox.num_elements
        stats.pyramid_levels = len(levels)
        stats.pyramid_voxels = sum(int(np.prod(lv.dims)) for lv, _ in levels)
        stats.seconds = time.time() - t0
        return stats

    stats.path = "per-block"
    inside_offset = mask_offset if masks else (0.0, 0.0, 0.0)
    imax = (1.0 if out_dtype == "float32"
            else float(np.iinfo(np.dtype(out_dtype)).max))

    def stage(block):
        ts = time.perf_counter()
        staged = stage_block(sd, loader, views, block, bbox, compute_block,
                             blend, aniso, inside_offset)
        return staged, time.perf_counter() - ts

    readers = ThreadPoolExecutor(max_workers=max(1, io_threads),
                                 thread_name_prefix="bst-read")
    writer = WriterPool(threads, stats.timings)
    pending: deque = deque()
    blocks = iter(grid)
    try:
        for block in blocks:  # read ahead by 2 x io_threads blocks
            pending.append(readers.submit(stage, block))
            if len(pending) < 2 * max(1, io_threads):
                continue
            _finish_block(pending.popleft().result(), stats, fusion_type,
                          dev, masks, imax, out_dtype, min_intensity,
                          max_intensity, writer, out_ds, zarr_ct)
        while pending:
            _finish_block(pending.popleft().result(), stats, fusion_type,
                          dev, masks, imax, out_dtype, min_intensity,
                          max_intensity, writer, out_ds, zarr_ct)
    finally:
        for f in pending:
            f.cancel()
        readers.shutdown(wait=True)
        writer.close()
    stats.seconds = time.time() - t0
    return stats


def _finish_block(result, stats, fusion_type, dev, masks, imax, out_dtype,
                  min_intensity, max_intensity, writer, out_ds,
                  zarr_ct) -> None:
    staged, read_s = result
    stats.timings["read"] += read_s
    stats.blocks += 1
    if staged is None:
        stats.skipped_empty += 1
        return
    block = staged.block
    fused, wsum = run_staged_block(staged, fusion_type, dev, stats.timings)
    stats.kernel_blocks[staged.kind] += 1
    sl = tuple(slice(0, s) for s in block.size)
    if masks:
        t0 = time.perf_counter()
        data = ((wsum.cpu().numpy()[sl] > 0).astype(np.float32)
                * imax).astype(out_dtype)
    else:
        tk = time.perf_counter()
        conv = F.convert_intensity(fused, min_intensity, max_intensity,
                                   out_dtype)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        stats.timings["kernel"] += t0 - tk
        data = conv.cpu().numpy()[sl]
    stats.timings["d2h"] += time.perf_counter() - t0
    writer.submit(_write, out_ds, np.ascontiguousarray(data), block.offset,
                  zarr_ct)
    stats.voxels += int(np.prod(block.size))
