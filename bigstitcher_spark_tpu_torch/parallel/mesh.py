"""Sharding of the block work list over a mesh of devices.

Port of ``bigstitcher_spark_tpu/parallel/mesh.py``: a batch of work items
(output blocks, detection blocks, pyramid boxes) becomes the leading axis
of the stacked kernel inputs, row range ``i`` of it placed on mesh device
``i``. :func:`shard_batch` is the counterpart of JAX ``shard_jit``: it
runs any per-device program on its rows, with some arguments replicated
to every device; :func:`make_sharded_fuser` is the affine-fusion route's
(``affine-fusion --devices N``: one launch of a batch kernel, K2, K5 or
K3, then K28 converts and makes the pyramid levels), and detection,
nonrigid fusion and the downsample stage have theirs in their drivers.
One drain worker a device copies its rows back, and a writer pool writes
them. No collective is needed: block writes are disjoint (the reference's
no-shuffle property, the Spark map at SparkAffineFusion.java:480-482).

A :class:`Mesh` is a tuple of torch devices. :func:`make_mesh` takes the
first ``min(n, torch.cuda.device_count())`` cards, as the JAX package keeps
the first ``n`` local devices: on a one-card host ``--devices 4`` runs on a
one-device mesh, in batches of ``4 x per_dev`` items. An explicit device
list may repeat a device (the CPU tests use ``[cpu] * 4``, the analogue of
the JAX suite's 8 virtual devices).

The JAX package's handoff, prefetch, multi-process and telemetry hooks are
not ported.
"""

from __future__ import annotations

import threading
import time
from collections import namedtuple
from concurrent.futures import ThreadPoolExecutor, wait
from contextlib import nullcontext
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from .. import config
from ..ops import epilogue as E
from ..ops import fusion as F

_TIMING_LOCK = threading.Lock()


def add_time(timings: dict | None, key: str, seconds: float) -> None:
    """Add ``seconds`` to ``timings[key]`` (thread-safe; None: nothing)."""
    if timings is not None:
        with _TIMING_LOCK:
            timings[key] = timings.get(key, 0.0) + seconds


@dataclass(frozen=True)
class Mesh:
    """The devices a batch's rows are spread over, in row order."""

    devices: tuple

    def __len__(self) -> int:
        return len(self.devices)


def make_mesh(n_devices: int | None = None, devices=None,
              platform: str = "cuda") -> Mesh:
    """The first ``min(n_devices, torch.cuda.device_count())`` cards (all
    of them for None), or ``devices`` as given (repeats allowed); with
    ``platform="cpu"``, ``n_devices`` CPU devices (default 1)."""
    if devices is not None:
        devs = tuple(torch.device(d) for d in devices)
    elif platform == "cuda":
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError("no CUDA device for the mesh; pass "
                               "platform='cpu' to run on the CPU")
        n = count if n_devices is None else min(int(n_devices), count)
        devs = tuple(torch.device("cuda", i) for i in range(n))
    elif platform == "cpu":
        devs = (torch.device("cpu"),) * max(1, int(n_devices or 1))
    else:
        raise ValueError(f"unsupported mesh platform {platform}")
    if not devs:
        raise ValueError("an empty mesh")
    return Mesh(devs)


def pad_batch(arrays: Sequence, batch: int) -> list:
    """Pad each stacked input along axis 0 to ``batch`` rows of zeros
    (valid mask 0: no-op blocks); a device tensor pads on its device."""
    out = []
    for a in arrays:
        n = int(a.shape[0])
        if n == batch:
            out.append(a)
        elif isinstance(a, torch.Tensor):
            pad = torch.zeros((batch - n, *a.shape[1:]), dtype=a.dtype,
                              device=a.device)
            out.append(torch.cat([a, pad]))
        else:
            pad = np.zeros((batch - n, *a.shape[1:]), a.dtype)
            out.append(np.concatenate([a, pad]))
    return out


def stack_inputs(inputs: Sequence, j: int):
    """Input ``j`` of every build result stacked along a new batch axis:
    on the host for numpy inputs, on the device where an item's input is a
    device tensor (the intensity grids gathered from the device table)."""
    parts = [inp[j] for inp in inputs]
    tensors = [p for p in parts if isinstance(p, torch.Tensor)]
    if tensors:
        dev = tensors[0].device
        return torch.stack([p.to(dev) if isinstance(p, torch.Tensor)
                            else torch.from_numpy(np.asarray(p)).to(dev)
                            for p in parts])
    return np.stack(parts)


# one device's rows of a dispatched batch: its first row, its outputs
# (device tensors: s0 and each epilogue level), the CUDA events around its
# launches (None on the CPU), and the host seconds of its upload and (on
# the CPU) of its kernels
Shard = namedtuple("Shard", "device row0 outs start end h2d host_kernel")

_BATCH_KERNELS = {"shift": F.fuse_block_shift_batch,
                  "sep": F.fuse_block_sep_batch,
                  "gather": F.fuse_block_batch}


def _rows_of(n_rows: int, n_dev: int) -> list[tuple[int, int]]:
    """Contiguous row ranges of ``n_rows`` over ``n_dev`` devices."""
    cuts = np.linspace(0, n_rows, n_dev + 1).round().astype(int)
    return [(int(a), int(b)) for a, b in zip(cuts[:-1], cuts[1:])]


def group_items(items: Sequence, n_dev: int, per_dev: int) -> list[list]:
    """``items`` cut into batches of ``n_dev x per_dev`` (the last one
    shorter), the JAX loop's grouping (parallel/mesh.py:387)."""
    group = max(1, int(n_dev)) * max(1, int(per_dev))
    items = list(items)
    return [items[i:i + group] for i in range(0, len(items), group)]


def _upload(a, dev: torch.device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(dev).contiguous()
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def _replica(a, dev: torch.device):
    """A replicated argument on ``dev``: arrays and tensors uploaded, Python
    and numpy scalars passed as they are."""
    if isinstance(a, torch.Tensor) or (isinstance(a, np.ndarray)
                                       and a.ndim > 0):
        return _upload(a, dev)
    return a


def _event(dev: torch.device):
    if dev.type != "cuda":
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(dev))
    return ev


def shard_batch(fn, mesh: Mesh, n_repl: int = 0):
    """The counterpart of JAX ``shard_jit`` (parallel/mesh.py:660): returns
    ``kernel(batch, *args) -> [Shard, ...]``. The first ``n_repl`` of
    ``args`` are replicated to every device (scalars as they are, arrays
    uploaded once to each device); the rest are batch-leading (numpy or
    tensors), row range ``i`` uploaded to mesh device ``i``, where
    ``fn(*replicated, *rows)`` runs under that device's context and
    returns one output tensor or a tuple of them (``batch``, the items,
    is not read). Nothing is synchronised or copied back: each device's
    outputs stay on it, with CUDA events around its launches (the host's
    seconds on the CPU)."""

    def kernel(batch, *args):
        repl, stacked = args[:n_repl], args[n_repl:]
        n_rows = int(stacked[0].shape[0])
        shards, replicas = [], {}
        for dev, (r0, r1) in zip(mesh.devices,
                                 _rows_of(n_rows, len(mesh))):
            if r1 == r0:
                continue
            ctx = torch.cuda.device(dev) if dev.type == "cuda" \
                else nullcontext()
            with ctx:
                t0 = time.perf_counter()
                if dev not in replicas:
                    replicas[dev] = [_replica(a, dev) for a in repl]
                rows = [_upload(a[r0:r1], dev) for a in stacked]
                t1 = time.perf_counter()
                start = _event(dev)
                outs = fn(*replicas[dev], *rows)
                end = _event(dev)
                host_kernel = (time.perf_counter() - t1
                               if dev.type != "cuda" else 0.0)
            outs = tuple(outs) if isinstance(outs, (tuple, list)) \
                else (outs,)
            shards.append(Shard(dev, r0, outs, start, end, t1 - t0,
                                host_kernel))
        return shards

    return kernel


def make_sharded_fuser(
    mesh: Mesh,
    block_shape: tuple[int, int, int],
    fusion_type: str = "AVG_BLEND",
    kernel: str = "gather",           # gather | sep | shift
    with_coeffs: bool = False,
    out_dtype: str = "float32",
    masks: bool = False,
    pyramid: tuple = (),              # each level's relative factors
):
    """A fuser for a batch of blocks spread over ``mesh``:
    ``fn(min_i, max_i, *stacked) -> [Shard, ...]``. ``stacked`` are the
    bucket's kernel inputs with a leading batch axis (numpy or device
    tensors, in the batch wrapper's order: K2's, K5's or K3's, K3's with
    the grids and their affines last when ``with_coeffs``; the inside
    offsets last of the eight or nine). Through :func:`shard_batch`, row
    range ``i`` goes to mesh device ``i``, where one launch of the batch
    kernel fuses it and one launch of K28
    (:func:`..ops.epilogue.block_epilogue`) converts it (``out_dtype``;
    coverage masks with ``masks``) and makes the ``pyramid`` levels."""
    if kernel not in _BATCH_KERNELS:
        raise ValueError(f"unknown kernel {kernel}")
    run = _BATCH_KERNELS[kernel]
    bshape = tuple(int(s) for s in block_shape)
    rels = tuple(tuple(int(v) for v in r) for r in pyramid)

    def one(min_i, max_i, *args):
        kw = {}
        if with_coeffs:
            *args, grids, grid_affs = args
            kw = dict(coeffs=grids, coeff_affines=grid_affs)
        *ins, ioffs = args
        fused, wsum = run(*ins, bshape, fusion_type, inside_offs=ioffs, **kw)
        return E.block_epilogue(fused, wsum, min_i, max_i, out_dtype, masks,
                                rels)

    sharded = shard_batch(one, mesh, n_repl=2)

    def fuser(min_i, max_i, *stacked):
        return sharded(None, min_i, max_i, *stacked)

    return fuser


_COPY_STREAMS = threading.local()


def _copy_stream(dev: torch.device):
    """This drain thread's side stream on ``dev`` for its copies, so a copy
    does not queue behind batches dispatched after its own."""
    streams = getattr(_COPY_STREAMS, "by_device", None)
    if streams is None:
        streams = _COPY_STREAMS.by_device = {}
    if dev not in streams:
        streams[dev] = torch.cuda.Stream(dev)
    return streams[dev]


def _fetch(shard: Shard, timings=None) -> list[np.ndarray]:
    """A shard's outputs on the host: a drain worker waits on its device's
    event and copies on its own stream, off later batches' queue."""
    t0 = time.perf_counter()
    if shard.device.type != "cuda":
        datas = [o.numpy() for o in shard.outs]
    else:
        shard.end.synchronize()
        with torch.cuda.stream(_copy_stream(shard.device)):
            datas = [o.cpu().numpy() for o in shard.outs]
    add_time(timings, "d2h", time.perf_counter() - t0)
    add_time(timings, "h2d", shard.h2d)
    add_time(timings, "kernel", shard.host_kernel if shard.end is None
             else shard.start.elapsed_time(shard.end) / 1e3)
    return datas


def _start_drain(shards, drain_pool, timings=None) -> list:
    """One drain worker a shard (:func:`_fetch`); the futures of their
    host copies, in shard order."""
    return [drain_pool.submit(_fetch, sh, timings) for sh in shards]


def _drain_per_device(shards, fetches, batch, consume, writer):
    """Consume one dispatched batch: once every drain worker of
    ``fetches`` has copied its device's rows, hand ``consume(item,
    *rows)`` of each real row to ``writer`` (a :class:`WriterPool`:
    disjoint chunks, no locks) and wait for those writes. Padding rows
    carry no work and are never consumed. Errors propagate to the caller
    once every worker and write has ended (the retry layer re-runs the
    whole batch; chunk writes are idempotent, and no write of a failed
    attempt is still running when the retry writes)."""
    wait(fetches)
    datas = [f.result() for f in fetches]
    for shard, rows in zip(shards, datas):
        for li in range(int(rows[0].shape[0])):
            gi = shard.row0 + li
            if gi >= len(batch):
                break    # batch-axis padding rows carry no work
            writer.submit(consume, batch[gi], *(d[li] for d in rows))
    writer.flush()


def run_sharded_batches(
    batches: Sequence[Sequence],
    build,
    kernel,
    consume,
    pool,
    mesh: Mesh,
    label: str = "batch",
    out_bytes=None,
    timings: dict | None = None,
    workspace_mult: float = 3.0,
) -> int:
    """The multi-device work loop, the reference's
    ``sc.parallelize(workItems).map`` (JAX ``run_sharded_batches``).

    ``batches`` are lists of work items whose kernel inputs share their
    shapes (a bucket's ``n_dev x per_dev`` blocks); ``build(item)`` stages
    one item's kernel inputs (a tuple of arrays) on ``pool``; the stacked
    batch, padded with zero rows to a multiple of ``len(mesh)``, goes
    through ``kernel(batch, *stacked) -> [Shard, ...]`` (a
    :func:`shard_batch` program over ``mesh``, such as the batch's
    bucket's :func:`make_sharded_fuser` fuser); the drain
    workers, one per shard, copy their device's rows to the host, and
    ``consume(item, *rows)`` of each real row runs on a writer pool of
    ``BST_WRITE_THREADS`` threads (disjoint chunk writes: no locks). One
    loop runs every bucket's batches, so staging, dispatch and writes
    overlap across buckets too.

    Host staging of the next batches overlaps device work, and staged
    batches are dispatched AHEAD of the current batch's drain as far as a
    byte budget allows (:class:`..utils.devicemem.InflightWindow` of the
    mesh's first device): each dispatch is charged its stacked inputs x
    ``workspace_mult`` (the upload and the kernels' workspace; JAX charges
    3 to its fuser and downsample stage, 4 to nonrigid fusion, 8 and more
    to detection) plus ``out_bytes(item)`` for each item (the device
    outputs; None: 0). The current batch always dispatches, so progress
    never blocks;
    ``BST_EARLY_DISPATCH=0`` keeps one batch in flight. The next batch's
    copies start before the current batch's writes, so the writer pool
    finds its rows on the host. A failed batch is
    re-run by :func:`.retry.run_with_retry`; finished batches are never
    re-run and a retried batch stages its items again. Returns the number
    of batches."""
    from ..utils.devicemem import InflightWindow
    from ..utils.writer import WriterPool
    from .retry import run_with_retry

    batches = [list(b) for b in batches if len(b)]
    if not batches:
        return 0
    window = InflightWindow(device=mesh.devices[0])
    drain_pool = ThreadPoolExecutor(max_workers=len(mesh),
                                    thread_name_prefix="bst-dev-drain")
    timings = timings if timings is not None else {}
    timings.setdefault("write", 0.0)
    writer = WriterPool(config.get("BST_WRITE_THREADS") or 1, timings)
    prefetched = {0: [pool.submit(build, it) for it in batches[0]]}
    dispatched: dict[int, tuple] = {}   # bi -> (shards, charged bytes)
    fetching: dict[int, list] = {}      # bi -> its drain workers' futures
    completed: set[int] = set()

    def batch_cost(input_bytes: int, batch) -> int:
        return (int(input_bytes * workspace_mult)
                + sum(int(out_bytes(it)) for it in batch if out_bytes))

    def stage(bi):
        if (bi < len(batches) and bi not in prefetched
                and bi not in dispatched and bi not in completed):
            prefetched[bi] = [pool.submit(build, it) for it in batches[bi]]

    def stack_and_dispatch(inputs, batch):
        # pad to a multiple of the mesh, not to the full group: a tail
        # batch of 4 must not run as 16 blocks of which 12 are zero work
        rows = -(-len(inputs) // len(mesh)) * len(mesh)
        stacked = pad_batch(
            [stack_inputs(inputs, j) for j in range(len(inputs[0]))], rows)
        nbytes = sum(int(a.nbytes) for a in stacked)
        shards = kernel(batch, *stacked)
        cost = batch_cost(nbytes, batch)
        window.charge(cost)
        return shards, cost

    def dispatch_ahead(bi):
        """Dispatch every staged later batch that fits the byte budget, so
        the devices compute ahead while batch ``bi`` drains; keep staging
        one batch past the dispatch frontier."""
        if not config.get("BST_EARLY_DISPATCH"):
            stage(bi + 1)
            return
        for j in range(bi + 1, len(batches)):
            if j in completed or j in dispatched:
                continue
            futs = prefetched.get(j)
            if futs is None:
                # stage two batches deep, or the window never grows past one
                stage(j)
                stage(j + 1)
                return
            if not all(f.done() for f in futs):
                return
            if any(f.exception() is not None for f in futs):
                return   # batch j's own turn re-stages and raises
            est = batch_cost(sum(sum(int(a.nbytes) for a in f.result())
                                 for f in futs), batches[j])
            if not window.fits(est):
                return
            del prefetched[j]
            try:
                dispatched[j] = stack_and_dispatch(
                    [f.result() for f in futs], batches[j])
            except Exception:  # noqa: BLE001 - batch j's own turn raises
                return
            stage(j + 1)

    def process_batch(bi_batch):
        bi, batch = bi_batch
        if bi in completed:
            return
        ent = dispatched.pop(bi, None)
        if ent is None:
            futs = prefetched.pop(bi, None)
            if futs is None:  # a retry round stages again
                futs = [pool.submit(build, it) for it in batch]
            ent = stack_and_dispatch([f.result() for f in futs], batch)
        shards, cost = ent
        dispatch_ahead(bi)
        fetches = fetching.pop(bi, None) or _start_drain(shards, drain_pool,
                                                         timings)
        # the next batch's copies queue behind this one's, ahead of its
        # writes
        nxt = dispatched.get(bi + 1)
        if nxt is not None and bi + 1 not in fetching:
            fetching[bi + 1] = _start_drain(nxt[0], drain_pool, timings)
        try:
            _drain_per_device(shards, fetches, batch, consume, writer)
        finally:
            window.release(cost)
        completed.add(bi)

    try:
        run_with_retry(list(enumerate(batches)), process_batch, label=label)
    finally:
        for futs in prefetched.values():
            for f in futs:
                f.cancel()
        drain_pool.shutdown(wait=True)
        writer.close()
        for _shards, cost in dispatched.values():
            window.release(cost)
    return len(batches)
