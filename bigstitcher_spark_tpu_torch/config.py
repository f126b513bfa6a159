"""The ``BST_*`` runtime knobs this slice of the port reads.

Same names, types and defaults as the JAX package's registry
(``bigstitcher_spark_tpu/config.py``), read from the environment at call
time; an unparseable value falls back to the default.
"""

from __future__ import annotations

import os

_FALSY = frozenset({"0", "false", "no", "off"})

# name -> (kind, default, doc)
KNOBS = {
    "BST_DEVICE_TILE_BUDGET": (
        "bytes", int(4e9),
        "Device-residency budget for the whole-volume composite fusion "
        "path (tiles + f32 accumulators must fit or the driver falls back "
        "to the per-block path)."),
    "BST_INFLIGHT_BYTES": (
        "bytes", None,
        "Process-wide byte budget for dispatched-but-undrained device work "
        "of the sharded work loop (utils/devicemem.py). Default: 60% of the "
        "card's free memory, 2e9 on the CPU."),
    "BST_PER_DEV_BUDGET": (
        "bytes", int(1e9),
        "Per-device staging budget the sharded fusion driver uses to pack "
        "several blocks per dispatch (per_dev)."),
    "BST_EARLY_DISPATCH": (
        "bool", True,
        "Allow the sharded work loop to dispatch batches ahead of the one "
        "currently draining; 0 forces strict one-batch-at-a-time."),
    "BST_PAIR_INFLIGHT_BYTES": (
        "bytes", None,
        "Byte budget for a pair stage's dispatched-but-undrained device "
        "work (the stitching phase correlation; utils/devicemem.py). "
        "Default: 60% of the card's free memory, 2e9 on the CPU."),
    "BST_SOLVE_DEVICE": (
        "bool", True,
        "Run the global registration relaxation on the torch device (the "
        "relax kernels K11-K14 on the card, their plain twins on the CPU); "
        "0 selects the host numpy reference path. An explicit "
        "--solverBackend wins."),
    "BST_SOLVE_SHARD": (
        "int", 500000,
        "Point-row threshold above which a device solve shards its link "
        "rows across every device of the solve mesh (rows grouped by owner "
        "tile via pairsched cost-weighted placement, each sweep's segment "
        "moments reduced by the shard-sum kernel K29). Sharded and "
        "single-device relaxations are bit-identical. 0 disables "
        "sharding."),
    "BST_WRITE_THREADS": (
        "int", 8,
        "Concurrent writer threads for the fused-volume drain and the "
        "per-block writes."),
}


def get(name: str):
    kind, default, _doc = KNOBS[name]
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    try:
        if kind == "bool":
            return raw.strip().lower() not in _FALSY
        if kind == "bytes":
            return max(0, int(float(raw)))
        return int(raw)
    except ValueError:
        return default
