"""Training of the port (counterparts of ``cvml_goalnet_tpu/train``): optimisers, the state, the
summarization loop, checkpoints and the spotting head.

The names of the JAX package's ``__all__`` are exported here, imported at first use, so importing the package
stays cheap.
"""

from __future__ import annotations

import importlib

_EXPORTS = {
    "adam_init": "optim",
    "adam_update": "optim",
    "schedule_from_config": "optim",
    "schedule_lr": "optim",
    "sgd_init": "optim",
    "sgd_update": "optim",
    "TrainState": "state",
    "create_train_state": "state",
    "eval_video": "loop",
    "make_train_video_fn": "loop",
    "train_importance_model": "loop",
    "load_checkpoint": "checkpoint",
    "save_checkpoint": "checkpoint",
}

__all__ = list(_EXPORTS)


def __getattr__(name: str):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"), name)
