"""Pyramid-level writer: block-parallel average downsampling of an existing
level (SparkAffineFusion.java:703-782 and SparkDownsample.java:141-177
equivalent).

Port of ``bigstitcher_spark_tpu/models/downsample_driver.py``. The level's
block grid is the work list. Jobs are grouped by source-box shape; reader
threads read each source box (edge-padded past the source extent), up to
four boxes of one shape go to the device stacked into one K6 launch
(:func:`..ops.downsample.downsample_batch`, the JAX ``vmap`` of
``downsample_block`` with ``per_dev=4``), and a writer pool converts and
writes the float32 means while the next batch is read
(:func:`run_downsample`). With ``devices`` above 1,
:func:`run_sharded_downsample` takes batches of ``devices x 4`` boxes over
a mesh (JAX ``run_sharded_downsample``), one K6 launch a device; its
levels are bitwise the one-device route's.
"""

from __future__ import annotations

import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..io.chunkstore import ChunkStore
from ..io.container import MultiResolutionLevelInfo, epilogue_written
from ..ops.downsample import downsample_batch, to_kernel_dtype
from ..parallel.mesh import (
    add_time,
    group_items,
    make_mesh,
    run_sharded_batches,
    shard_batch,
)
from ..utils.device import resolve_device
from ..utils.grid import GridBlock, create_grid
from ..utils.writer import WriterPool

PER_LAUNCH = 4  # boxes stacked into one K6 launch (the JAX per_dev=4)
IO_THREADS = 8  # reader and writer threads of the downsample stage


def read_padded(src_read, src_shape, src_off, src_size) -> np.ndarray:
    """Read ``src_size`` voxels at ``src_off``, edge-replicating past the
    source extent (thin axes whose level dim was clamped to 1).
    ``src_read(off, size)`` is the raw reader."""
    clamped = [min(int(s), int(e) - int(o)) for s, e, o in
               zip(src_size, src_shape, src_off)]
    data = src_read([int(o) for o in src_off], clamped)
    if clamped != [int(s) for s in src_size]:
        pad = [(0, int(s) - c) for s, c in zip(src_size, clamped)]
        data = np.pad(data, pad, mode="edge")
    return data


def _convert_to_dtype(out: np.ndarray, dtype) -> np.ndarray:
    if np.issubdtype(np.dtype(dtype), np.integer):
        info = np.iinfo(np.dtype(dtype))
        out = np.clip(np.round(out), info.min, info.max)
    return out.astype(dtype)


def read_shape(block: GridBlock, rel):
    """Source-box shape of a block: out block size * relative factor."""
    return [int(s) * int(f) for s, f in zip(block.size, rel)]


def validate_pyramid(absolute: list[list[int]]) -> None:
    """Each absolute factor must be an exact multiple of the previous one,
    starting at 1,1,1 — otherwise relative steps floor-divide and levels
    would be silently corrupt."""
    if list(absolute[0]) != [1, 1, 1]:
        raise ValueError(f"pyramid must start with 1,1,1, got {absolute[0]}")
    for prev, cur in zip(absolute, absolute[1:]):
        if any(int(c) % int(p) != 0 for p, c in zip(prev, cur)):
            raise ValueError(
                f"pyramid step {cur} is not an exact multiple of {prev}"
            )


def run_downsample(jobs, read_job, write_job, rel, device=None,
                   io_threads: int = IO_THREADS) -> int:
    """Downsample every job on one device. ``read_job(job)`` returns the
    raw source box (size = out block * ``rel``, edge-padded);
    ``write_job(job, data)`` converts and writes the float32 means. Jobs
    are grouped by source shape, read ahead by ``io_threads`` reader
    threads, stacked ``PER_LAUNCH`` at a time into one K6 launch and
    written by a writer pool. Returns the number of K6 launches (or plain
    batches on the CPU)."""
    dev = resolve_device(device)
    rel = tuple(int(f) for f in rel)
    buckets: dict[tuple, list] = {}
    for job in jobs:
        buckets.setdefault(tuple(read_shape(job, rel)), []).append(job)
    batches = [items[i:i + PER_LAUNCH]
               for _shape, items in sorted(buckets.items())
               for i in range(0, len(items), PER_LAUNCH)]

    readers = ThreadPoolExecutor(max_workers=max(1, io_threads),
                                 thread_name_prefix="bst-ds-read")
    writer = WriterPool(io_threads, {"write": 0.0})
    pending: deque = deque()
    it = iter(batches)
    try:
        def fill():  # keep two batches of reads in flight
            while len(pending) < 2:
                batch = next(it, None)
                if batch is None:
                    return
                pending.append((batch, [readers.submit(read_job, j)
                                        for j in batch]))

        fill()
        while pending:
            batch, futures = pending.popleft()
            fill()
            boxes = np.stack([to_kernel_dtype(f.result()) for f in futures])
            host = downsample_batch(torch.from_numpy(boxes).to(dev),
                                    rel).cpu().numpy()
            for job, data in zip(batch, host):
                writer.submit(write_job, job, data)
    finally:
        for _batch, futures in pending:
            for f in futures:
                f.cancel()
        readers.shutdown(wait=True)
        writer.close()
    return len(batches)


def run_sharded_downsample(jobs, read_job, write_job, rel, devices,
                           io_threads: int = IO_THREADS,
                           per_dev: int = PER_LAUNCH, device=None,
                           stats: dict | None = None) -> int:
    """Downsample every job over a mesh of the first ``devices`` cards
    (``[cpu] * devices`` with ``device="cpu"``; one card for 4 on a
    one-card host), the JAX ``run_sharded_downsample``
    (models/downsample_driver.py:112-160). ``read_job`` and ``write_job``
    are :func:`run_downsample`'s. Jobs are bucketed by source shape and cut
    into batches of ``devices x per_dev`` boxes, read by ``io_threads``
    reader threads; each device averages its rows in one K6 launch
    (:func:`..parallel.mesh.shard_batch` over
    :func:`..ops.downsample.downsample_batch`), its drain worker copies
    them back and the writer pool of every sharded route
    (:func:`..parallel.mesh.run_sharded_batches`, ``BST_WRITE_THREADS``
    threads) converts and writes them. Returns the
    number of batches; ``stats`` (a dict) gets the ``mesh``, each source
    shape's ``buckets`` (blocks, per_dev, batches) and the ``timings``
    (read, h2d, kernel: CUDA events, d2h, write; summed over threads)."""
    dev = resolve_device(device)
    n_dev = int(devices)
    rel = tuple(int(f) for f in rel)
    mesh = make_mesh(n_dev, platform=dev.type)
    buckets: dict[tuple, list] = {}
    for job in jobs:
        buckets.setdefault(tuple(read_shape(job, rel)), []).append(job)
    groups = {shape: group_items(items, n_dev, per_dev)
              for shape, items in sorted(buckets.items())}
    batches = [g for gs in groups.values() for g in gs]
    out_vox = {shape: int(np.prod([s // f for s, f in zip(shape, rel)]))
               for shape in buckets}

    timings = {"read": 0.0}

    def build(job):
        t0 = time.perf_counter()
        raw = np.ascontiguousarray(to_kernel_dtype(read_job(job)))
        add_time(timings, "read", time.perf_counter() - t0)
        return (raw,)

    kernel = shard_batch(lambda raws: downsample_batch(raws, rel), mesh)
    pool = ThreadPoolExecutor(max_workers=max(1, io_threads),
                              thread_name_prefix="bst-ds-read")
    try:
        n = run_sharded_batches(
            batches, build, kernel, write_job, pool, mesh,
            label="downsample batch",
            # float32 device output; the float32 cast of the input
            out_bytes=lambda job: out_vox[tuple(read_shape(job, rel))] * 4,
            timings=timings, workspace_mult=3.0)
    finally:
        pool.shutdown(wait=True)
    if stats is not None:
        stats.update(mesh=tuple(str(d) for d in mesh.devices), batches=n,
                     timings=timings, buckets=[
                         dict(shape=shape, blocks=len(buckets[shape]),
                              per_dev=per_dev, batches=len(gs))
                         for shape, gs in groups.items()])
    return n


def downsample_pyramid_level(
    store: ChunkStore,
    src_info: MultiResolutionLevelInfo,
    dst_info: MultiResolutionLevelInfo,
    is_zarr5d: bool = False,
    ct: tuple[int, int] = (0, 0),
    device=None,
    skip_existing: bool = False,
    devices: int | None = None,
    stats: dict | None = None,
) -> int:
    """Fill ``dst_info`` from ``src_info`` by relative-factor averaging
    (SparkDownsample.java:141-177) on one device, or with ``devices``
    above 1 over a mesh (:func:`run_sharded_downsample`, which fills
    ``stats``). Returns the number of level blocks written.

    ``skip_existing``: return 0 at once when the fusion epilogue already
    wrote this level for this (channel, timepoint) slot (the container
    records that per level; epilogue output is bit-identical to this path,
    so there is nothing to redo and no full-res container reread)."""
    if skip_existing and epilogue_written(store, dst_info.dataset, ct):
        return 0
    src = store.open_dataset(src_info.dataset.strip("/"))
    dst = store.open_dataset(dst_info.dataset.strip("/"))
    rel = [int(v) for v in dst_info.relativeDownsampling[:3]]
    dims3 = [int(v) for v in dst_info.dimensions[:3]]
    block3 = [int(v) for v in dst_info.blockSize[:3]]
    grid = create_grid(dims3, block3)

    if is_zarr5d:
        c, t = ct

        def read3d(off, size):
            return src.read((*off, c, t), (*size, 1, 1))[..., 0, 0]

        def write3d(data, off):
            dst.write(data[..., None, None], (*off, c, t))

        src_shape = src.shape[:3]
    else:
        read3d, write3d, src_shape = src.read, dst.write, src.shape

    def read_job(block: GridBlock):
        src_off = [o * f for o, f in zip(block.offset, rel)]
        src_size = [s * f for s, f in zip(block.size, rel)]
        return read_padded(read3d, src_shape, src_off, src_size)

    def write_job(block: GridBlock, out):
        write3d(_convert_to_dtype(out, dst.dtype), block.offset)

    if devices is not None and int(devices) > 1:
        run_sharded_downsample(grid, read_job, write_job, rel, int(devices),
                               device=device, stats=stats)
    else:
        run_downsample(grid, read_job, write_job, rel, device=device)
    return len(grid)
