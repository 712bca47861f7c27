"""Cross-cutting utilities of the port: stage timing, console logging, the jsonl metrics log, and
:func:`tree_cast`.

The names of the JAX package's ``__all__`` are exported here, those of the submodules imported at first use,
except the names in :data:`NOT_PORTED`, each with the reason the port does not take it.
"""

from __future__ import annotations

import importlib

import torch

_EXPORTS = {
    "Color": "logging",
    "log_epoch_header": "logging",
    "log_metrics": "logging",
    "log_val_delta": "logging",
    "StageTimer": "profiling",
    "trace_annotation": "profiling",
}

NOT_PORTED = {
    "apply_platform_override": "it pins JAX's jax_platforms and its persistent compile cache, and the port has "
                               "neither: its entry points read GOALNET_PLATFORM=cpu themselves "
                               "(cli._device) and its kernels are built by nvcc at first use",
}

__all__ = [*_EXPORTS, "tree_cast"]


def __getattr__(name: str):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"), name)


def tree_cast(tree, dtype: torch.dtype):
    """Cast every floating-point tensor leaf of a tree of dicts, lists and tuples to ``dtype``; integer leaves
    (and anything else) pass through.  Port of ``cvml_goalnet_tpu/utils/__init__.py:10-24``: the one
    mixed-precision cast of the bf16 ``fuse``, stream and train programs.  Lists and tuples come back as
    lists; a leaf already of ``dtype`` comes back as itself."""
    if isinstance(tree, dict):
        return {k: tree_cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_cast(v, dtype) for v in tree]
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return tree.to(dtype)
    return tree


def compute_dtype(name: str) -> torch.dtype:
    """``ModelConfig.dtype`` / ``TrainConfig.compute_dtype`` → the torch dtype: bf16 for ``"bfloat16"``, float32
    otherwise, as the JAX package maps them."""
    return torch.bfloat16 if name == "bfloat16" else torch.float32


def bf16_rounded(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bf16 (ties to even) and back to float32: where the plain bf16 forms round, as the JAX
    package's bf16 ops do after each float32 computation."""
    return t.to(torch.bfloat16).to(torch.float32)
