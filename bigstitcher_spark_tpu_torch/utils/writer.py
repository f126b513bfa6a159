"""Thread pool for container writes, shared by the fusion and downsample
drivers."""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor


class WriterPool:
    """Runs ``fn(*args)`` writes on ``threads`` threads. ``close`` reads
    every future, so a failed write raises in the caller, and adds the
    seconds each write took to ``timings['write']`` (thread time)."""

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

    def close(self) -> None:
        try:
            for f in self._futures:
                self._timings["write"] += f.result()
        finally:
            self._pool.shutdown(wait=True)
