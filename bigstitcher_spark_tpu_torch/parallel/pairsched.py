"""Pair-work scheduler on one device: a pipelined dispatch/drain loop.

Port of the single-device part of
``bigstitcher_spark_tpu/parallel/pairsched.py`` (``_run_local``'s one-device
branch and ``_run_queue``). Tasks (shape buckets of pair crops) are
dispatched in order; a dispatch enqueues device work and returns handles
without waiting. Dispatches accumulate into
SEGMENTS of up to half the in-flight byte budget; the next segment is
always dispatched before the previous one is drained, so the host refines
one segment's results while the card computes the next, and at most two
segments (about the budget) are in flight.

:func:`assign_tasks` is the JAX package's cost-weighted placement; the
sharded solve places tiles on its mesh with it. Dispatch over several
devices, re-dispatch of failed tasks, the multi-process split and the
scheduler's metrics are not yet ported: a failing task raises.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Sequence

import torch

from ..utils.devicemem import pair_budget_bytes


@dataclass
class PairTask:
    """One schedulable unit of pair work: ``index`` is its result slot,
    ``cost`` drives placement (:func:`assign_tasks`), ``nbytes`` the device
    bytes it holds from dispatch until drain."""

    index: int
    cost: float = 1.0
    nbytes: int = 0
    tag: Any = None


_MIN_COST = 1e-9


def assign_tasks(tasks: Sequence[PairTask], n_bins: int) -> list[list[PairTask]]:
    """Cost-weighted greedy (LPT) placement: heaviest task first onto the
    least-loaded bin; deterministic (ties by bin index, stable task order).
    Guarantees ``max_load - min_load <= max task cost``."""
    bins: list[list[PairTask]] = [[] for _ in range(max(n_bins, 1))]
    loads = [0.0] * len(bins)
    for t in sorted(tasks, key=lambda t: (-max(t.cost, 0.0), t.index)):
        b = min(range(len(bins)), key=lambda i: (loads[i], i))
        bins[b].append(t)
        loads[b] += max(t.cost, _MIN_COST)
    return bins


def _run_queue(queue: Sequence[PairTask], dispatch, drain, budget: int,
               results: list) -> None:
    """One device's pipelined loop (see the module docstring)."""
    half = max(1, budget // 2)
    seg: list[tuple[PairTask, Any]] = []
    seg_bytes = 0
    prev: list[tuple[PairTask, Any]] | None = None

    def flush(group):
        tasks = [t for t, _ in group]
        outs = drain(tasks, [h for _, h in group])
        for t, r in zip(tasks, outs):
            results[t.index] = r

    for t in queue:
        if seg and seg_bytes + t.nbytes > half:
            if prev is not None:
                flush(prev)
            prev, seg, seg_bytes = seg, [], 0
        seg.append((t, dispatch(t)))
        seg_bytes += t.nbytes
    if prev is not None:
        flush(prev)
    if seg:
        flush(seg)


def run_pair_tasks(tasks: Sequence[PairTask],
                   dispatch: Callable[[PairTask], Any],
                   drain: Callable[[list, list], list], *,
                   device: torch.device,
                   budget_bytes: int | None = None) -> list:
    """Run pair tasks on ``device``; results in task-index order.
    ``dispatch(task)`` returns un-fetched device handles;
    ``drain(tasks, handles)`` fetches and post-processes a segment. The
    byte budget is ``budget_bytes`` or :func:`pair_budget_bytes`."""
    tasks = list(tasks)
    results: list = [None] * (max((t.index for t in tasks), default=-1) + 1)
    if not tasks:
        return results
    budget = (budget_bytes if budget_bytes is not None
              else pair_budget_bytes(device))
    _run_queue(tasks, dispatch, drain, budget, results)
    return results
