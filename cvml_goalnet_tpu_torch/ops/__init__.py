"""Per-frame and postprocessing ops of the port (counterparts of ``cvml_goalnet_tpu/ops``).

The names of the JAX package's ``__all__`` are exported here, imported at first use, so importing the package
stays cheap.
"""

from __future__ import annotations

import importlib

_EXPORTS = {
    "expand_scores": "expand",
    "expand_scores_host": "expand",
    "clip_stats": "clips",
    "clip_stats_host": "clips",
    "knapsack_select": "knapsack",
    "knapsack_table_device": "knapsack",
    "knapsack_table_host": "knapsack",
    "fscore_against_users": "fscore",
    "fscore_against_users_host": "fscore",
    "normalize_frames": "preprocess",
    "preprocess_frames": "preprocess",
    "resize_bilinear": "preprocess",
    "resize_matrices": "preprocess",
}

__all__ = list(_EXPORTS)


def __getattr__(name: str):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"), name)
