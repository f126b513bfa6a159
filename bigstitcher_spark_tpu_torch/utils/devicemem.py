"""Device-memory budget for in-flight dispatch windows.

Port of the single-device part of ``bigstitcher_spark_tpu/utils/devicemem.py``.
A driver that keeps several device programs in flight (the stitching
pair loop) bounds them by BYTES, not by a count. The budget is
``BST_PAIR_INFLIGHT_BYTES`` when set, else 60 % of the memory the card
reports free (``torch.cuda.mem_get_info``), else 2e9 on the CPU.
"""

from __future__ import annotations

import torch

from .. import config

# CPU budget: two batches at the historical 1e9 staging budget, as in JAX
DEFAULT_BUDGET = int(2e9)

# of the device memory the driver reports free, keep this fraction for
# in-flight work; the rest covers what the estimate cannot see
_FREE_FRACTION = 0.6


def pair_budget_bytes(device: torch.device | None = None) -> int:
    """In-flight byte budget of a pair stage on ``device``."""
    env = config.get("BST_PAIR_INFLIGHT_BYTES")
    if env is not None:
        return env
    if device is not None and device.type == "cuda":
        free, _total = torch.cuda.mem_get_info(device)
        return max(256 << 20, int(_FREE_FRACTION * free))
    return DEFAULT_BUDGET

