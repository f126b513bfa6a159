"""The ``BST_*`` runtime knobs this slice of the port reads.

Same names, types and defaults as the JAX package's registry
(``bigstitcher_spark_tpu/config.py``), read from the environment at call
time; an unparseable value falls back to the default.
"""

from __future__ import annotations

import os

# name -> (kind, default, doc)
KNOBS = {
    "BST_DEVICE_TILE_BUDGET": (
        "bytes", int(4e9),
        "Device-residency budget for the whole-volume composite fusion "
        "path (tiles + f32 accumulators must fit or the driver falls back "
        "to the per-block path)."),
    "BST_PAIR_INFLIGHT_BYTES": (
        "bytes", None,
        "Byte budget for a pair stage's dispatched-but-undrained device "
        "work (the stitching phase correlation; utils/devicemem.py). "
        "Default: 60% of the card's free memory, 2e9 on the CPU."),
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
        if kind == "bytes":
            return max(0, int(float(raw)))
        return int(raw)
    except ValueError:
        return default
