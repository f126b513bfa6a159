"""App-level retry of failed work items (port of
``bigstitcher_spark_tpu/parallel/retry.py``, the reference's
RetryTrackerSpark).

The reference resubmits failed grid blocks at most 5 times with a 2 s
delay, then gives up (RetryTrackerSpark.java:28-61; loops at
SparkAffineFusion.java:467-479,682-696). Block writes are idempotent, so
resubmission is always safe. The JAX package's telemetry (events,
counters, heartbeats) is not ported.
"""

from __future__ import annotations

import time
import traceback
from typing import Callable, Sequence, TypeVar

T = TypeVar("T")


class RetryError(RuntimeError):
    pass


def run_with_retry(
    items: Sequence[T],
    process: Callable[[T], None],
    max_retries: int = 5,
    delay_s: float = 2.0,
    label: str = "block",
    verbose: bool = True,
) -> int:
    """Process every item in turn; collect the failures and resubmit only
    those. Returns the number of retry rounds used. Raises RetryError when
    items still fail after ``max_retries`` rounds, with the failures
    counted by exception class over all rounds and the first traceback."""
    pending: list[T] = list(items)
    rounds = 0
    err_counts: dict[str, int] = {}
    while pending:

        def attempt(it: T):
            try:
                process(it)
                return None
            except Exception as e:  # noqa: BLE001 - any failure is retryable
                return (it, e)

        failed = [r for r in map(attempt, pending) if r is not None]
        for _, e in failed:
            name = type(e).__name__
            err_counts[name] = err_counts.get(name, 0) + 1
        if not failed:
            break
        rounds += 1
        if rounds > max_retries:
            tb = "".join(traceback.format_exception(failed[0][1]))
            breakdown = ", ".join(
                f"{k} x{v}" for k, v in sorted(err_counts.items(),
                                               key=lambda kv: -kv[1]))
            raise RetryError(
                f"{len(failed)} {label}(s) still failing after "
                f"{max_retries} retries; failure breakdown across rounds: "
                f"{breakdown}; first error:\n{tb}")
        if verbose:
            print(f"[retry] {len(failed)} {label}(s) failed (round "
                  f"{rounds}/{max_retries}), resubmitting in {delay_s}s: "
                  f"{failed[0][1]!r}")
        time.sleep(delay_s)
        pending = [it for it, _ in failed]
    return rounds
