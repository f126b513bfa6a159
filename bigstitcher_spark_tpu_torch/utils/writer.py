"""Thread pool for container writes, shared by the fusion and downsample
drivers."""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor, wait


class WriterPool:
    """Runs ``fn(*args)`` writes on ``threads`` threads. ``flush`` and
    ``close`` read every future submitted so far, so a failed write raises
    in the caller, and add the seconds each write took to
    ``timings['write']`` (thread time)."""

    def __init__(self, threads: int, timings: dict):
        self._timings = timings
        self._pool = ThreadPoolExecutor(max_workers=max(1, int(threads)),
                                        thread_name_prefix="bst-write")
        self._futures = []

    @staticmethod
    def _one(fn, args):
        t0 = time.perf_counter()
        fn(*args)
        return time.perf_counter() - t0

    def submit(self, fn, *args) -> None:
        self._futures.append(self._pool.submit(self._one, fn, args))

    def flush(self) -> None:
        """Wait for every write submitted so far, add their seconds, and
        raise the first failure."""
        futures, self._futures = self._futures, []
        wait(futures)
        for f in futures:
            self._timings["write"] += f.result()

    def close(self) -> None:
        try:
            self.flush()
        finally:
            self._pool.shutdown(wait=True)
