"""Named per-stage wall-clock aggregation (port of ``StageTimer`` in ``cvml_goalnet_tpu/utils/profiling.py``).

The streaming scorer times stages in three threads at once, so the totals
are updated under a lock.  Host wall clock only: a stage that launches
device work measures the launches, not the device's time.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict


class StageTimer:
    """Accumulates wall-clock seconds per named stage; ``summary()`` → ``{name: {total_s, count, mean_s}}``."""

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        yield
        dt = time.perf_counter() - t0
        with self._lock:
            self.totals[name] += dt
            self.counts[name] += 1

    def summary(self) -> dict[str, dict[str, float]]:
        with self._lock:
            return {k: {"total_s": self.totals[k], "count": self.counts[k],
                        "mean_s": self.totals[k] / max(self.counts[k], 1)} for k in self.totals}
