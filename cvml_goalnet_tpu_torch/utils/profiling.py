"""Tracing and profiling hooks (port of ``cvml_goalnet_tpu/utils/profiling.py``).

* :class:`StageTimer` — named per-stage wall-clock aggregation.  The
  streaming scorer times stages in three threads at once, so the totals are
  updated under a lock.  Host wall clock only: a stage that launches device
  work measures the launches unless it synchronizes the card before it ends
  (``cli.py::cmd_profile`` does).
* :func:`trace_annotation` — a named region (``torch.profiler.record_function``)
  that shows in a trace; each stage of a :class:`StageTimer` is one.
* :func:`start_trace` / :func:`stop_trace` — one ``torch.profiler.profile`` at a
  time (CPU activities, and CUDA ones where there is a card), whose Chrome
  trace is written into ``log_dir`` at :func:`stop_trace`.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict

import torch

TRACE_FILE = "trace.json"

_trace_lock = threading.Lock()
_trace: "tuple[torch.profiler.profile, str] | None" = None


class StageTimer:
    """Accumulates wall-clock seconds per named stage; ``summary()`` → ``{name: {total_s, count, mean_s}}``."""

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        with trace_annotation(name):
            yield
        dt = time.perf_counter() - t0
        with self._lock:
            self.totals[name] += dt
            self.counts[name] += 1

    def summary(self) -> dict[str, dict[str, float]]:
        with self._lock:
            return {k: {"total_s": self.totals[k], "count": self.counts[k],
                        "mean_s": self.totals[k] / max(self.counts[k], 1)} for k in self.totals}


def trace_annotation(name: str):
    """A named region of a trace (little cost when nothing is tracing)."""
    return torch.profiler.record_function(name)


def start_trace(log_dir: str) -> None:
    """Start tracing the host, and the card where there is one; raises if a trace is running already."""
    global _trace
    with _trace_lock:
        if _trace is not None:
            raise RuntimeError("a trace is running already: stop_trace() first")
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities)
        prof.__enter__()
        _trace = (prof, log_dir)


def stop_trace() -> str:
    """Stop the running trace and write it as ``<log_dir>/trace.json`` (Chrome trace format) → the file's path."""
    global _trace
    with _trace_lock:
        if _trace is None:
            raise RuntimeError("no trace is running: start_trace() first")
        prof, log_dir = _trace
        _trace = None
        prof.__exit__(None, None, None)
        os.makedirs(log_dir, exist_ok=True)
        path = os.path.join(log_dir, TRACE_FILE)
        prof.export_chrome_trace(path)
        return path
