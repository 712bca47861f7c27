"""Failure detection + crash recovery for training runs.

Port of ``cvml_goalnet_tpu/train/resilience.py``: the same restart policy
over the port's ``train_importance_model`` and npz checkpoints, on the
device the state lives on.

The reference's only recovery story was its every-epoch checkpoint plus a
manual ``--checkpoint`` restart (SURVEY.md §5 "Failure detection / elastic
recovery — ABSENT … no retry, no elasticity").  This wrapper makes recovery
automatic:

* every-epoch checkpoints come from the train loop (atomic writes);
* on an exception mid-training (device OOM, preemption-style interruption,
  transient runtime failure) the run restores the last rolling checkpoint and
  resumes from the epoch counter it carries, up to ``max_restarts`` times;
* each failure is recorded to the structured metrics log.

Single-host by design: preemption recovery across hosts is an orchestrator
concern; in-process restart-from-checkpoint is the part a framework owns.
"""

from __future__ import annotations

import traceback

from cvml_goalnet_tpu_torch.config import PipelineConfig
from cvml_goalnet_tpu_torch.train.checkpoint import load_checkpoint
from cvml_goalnet_tpu_torch.train.loop import train_importance_model
from cvml_goalnet_tpu_torch.train.state import TrainState


def train_with_recovery(
    cfg: PipelineConfig,
    train_ds,
    val_ds,
    state: TrainState,
    checkpoint_dir: str,
    max_restarts: int = 3,
    metrics_logger=None,
    **train_kwargs,
):
    """Run ``train_importance_model`` with automatic restore-and-resume.

    Returns (best_state, history, n_restarts).  Raises only after the restart
    budget is exhausted.
    """
    restarts = 0
    while True:
        try:
            best, history = train_importance_model(
                cfg, train_ds, val_ds, state,
                checkpoint_dir=checkpoint_dir,
                metrics_logger=metrics_logger,
                **train_kwargs,
            )
            return best, history, restarts
        except KeyboardInterrupt:
            raise
        except Exception as err:  # transient device/runtime failure
            restarts += 1
            if metrics_logger is not None:
                metrics_logger.log(
                    "train_failure",
                    restart=restarts,
                    error=repr(err),
                    trace=traceback.format_exc(limit=5),
                )
            if restarts > max_restarts:
                raise
            try:
                state = load_checkpoint(checkpoint_dir, state, tag="ckp")
            except FileNotFoundError:
                pass  # failed before the first checkpoint: retry from scratch


class PreemptionGuard:
    """Graceful-preemption hook: catch SIGTERM (the maintenance / spot
    preemption signal of a cloud VM) and let the train loop checkpoint + exit cleanly
    instead of dying mid-epoch.

    Use as a context manager; pass to ``train_importance_model`` via
    ``preemption_guard=`` — the loop checks :attr:`requested` after every
    epoch, writes a final rolling checkpoint and returns early with
    ``history["preempted"] = True``, so a restart with ``--checkpoint``
    resumes at the right epoch with the optimizer state intact.
    """

    def __init__(self, signals=None):
        import signal as _signal

        self._signal = _signal
        self.signals = tuple(signals) if signals else (_signal.SIGTERM,)
        self.requested = False
        self._prev = {}

    def _handler(self, signum, frame):
        self.requested = True

    def __enter__(self):
        for s in self.signals:
            self._prev[s] = self._signal.signal(s, self._handler)
        return self

    def __exit__(self, *exc):
        for s, prev in self._prev.items():
            self._signal.signal(s, prev)
        return False
