"""Device-memory budget for in-flight dispatch windows.

Port of ``bigstitcher_spark_tpu/utils/devicemem.py``. A driver that keeps
several device programs in flight (the stitching pair loop, the sharded
work loop of ``parallel/mesh.py``) bounds them by BYTES, not by a count.
The budget is the knob when set (``BST_PAIR_INFLIGHT_BYTES`` for a pair
stage, ``BST_INFLIGHT_BYTES`` for the sharded loop), else 60 % of the
memory the card reports free (``torch.cuda.mem_get_info``), else 2e9 on
the CPU.
"""

from __future__ import annotations

import torch

from .. import config

# CPU budget: two batches at the historical 1e9 staging budget, as in JAX
DEFAULT_BUDGET = int(2e9)

# of the device memory the driver reports free, keep this fraction for
# in-flight work; the rest covers what the estimate cannot see
_FREE_FRACTION = 0.6


def _budget(knob: str, device: torch.device | None) -> int:
    env = config.get(knob)
    if env is not None:
        return env
    if device is not None and device.type == "cuda":
        free, _total = torch.cuda.mem_get_info(device)
        return max(256 << 20, int(_FREE_FRACTION * free))
    return DEFAULT_BUDGET


def pair_budget_bytes(device: torch.device | None = None) -> int:
    """In-flight byte budget of a pair stage on ``device``."""
    return _budget("BST_PAIR_INFLIGHT_BYTES", device)


def dispatch_budget_bytes(device: torch.device | None = None) -> int:
    """Byte budget for the sharded work loop's dispatched-but-not-drained
    batches on ``device``."""
    return _budget("BST_INFLIGHT_BYTES", device)


class InflightWindow:
    """Byte ledger of one driver's in-flight dispatches against the
    :func:`dispatch_budget_bytes` of ``device``."""

    def __init__(self, device: torch.device | None = None):
        self.budget = dispatch_budget_bytes(device)
        self.inflight = 0

    def fits(self, nbytes: int) -> bool:
        """Whether one more dispatch of ``nbytes`` stays inside the budget.
        An empty window always fits (forward progress must never block)."""
        return self.inflight == 0 or self.inflight + nbytes <= self.budget

    def charge(self, nbytes: int) -> None:
        self.inflight += nbytes

    def release(self, nbytes: int) -> None:
        self.inflight = max(0, self.inflight - nbytes)
