"""Wall-clock timing.

The reference prints a single ``clock()`` delta — CPU time, which under
OpenMP overcounts by the thread count (RayTracingOnCPU/main.cpp:60-61,
116-117). This is a real wall-clock timer with explicit device
synchronization, so device work is counted to its end.
"""

from __future__ import annotations

import time


class Timer:
    def __init__(self, sync=None):
        self._sync = sync  # callable, e.g. lambda: arr.block_until_ready()

    def __enter__(self):
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._sync is not None:
            self._sync()
        self.elapsed = time.perf_counter() - self.start
        return False
