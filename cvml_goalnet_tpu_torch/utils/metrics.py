"""Structured metrics/event logging (jsonl) — observability subsystem.

The port's copy of ``cvml_goalnet_tpu/utils/metrics.py``, kept here because
the port imports nothing of the JAX package.

The reference's only observability was ANSI stdout prints and per-epoch pngs
(SURVEY.md §5 "Metrics / logging — PRESENT (minimal)... no structured
logging, no event files").  This logger emits one JSON object per event to an
append-only ``events.jsonl``, so training runs are machine-parseable
(dashboards, regression tracking) without a heavyweight dependency.
"""

from __future__ import annotations

import json
import os
import time


class MetricsLogger:
    """Append-only jsonl event log with wall-clock timestamps."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.path = path
        self._t0 = time.time()

    def log(self, event: str, **fields) -> None:
        # ts: absolute wall clock — a resumed run appending to the same file
        # stays monotonic and runs stay distinguishable; t: seconds since
        # THIS logger started (human-friendly per-run offsets)
        record = {
            "ts": round(time.time(), 3),
            "t": round(time.time() - self._t0, 3),
            "event": event,
            **fields,
        }
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")

    def log_epoch(self, epoch: int, train: tuple, val: tuple | None, dt: float | None = None) -> None:
        val_fields = (
            {"val_loss": val[0], "val_f_avg": val[1], "val_f_max": val[2]}
            if val is not None else {}
        )
        self.log(
            "epoch",
            epoch=epoch,
            train_loss=train[0], train_f_avg=train[1], train_f_max=train[2],
            **val_fields,
            **({"dt_s": round(dt, 2)} if dt is not None else {}),
        )

    @staticmethod
    def read(path: str) -> list[dict]:
        out = []
        with open(path) as f:
            for line in f:
                if line.strip():
                    out.append(json.loads(line))
        return out
