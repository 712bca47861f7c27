"""The models of the port (counterparts of ``cvml_goalnet_tpu/models``).

The names of the JAX package's ``__all__`` are exported here, imported at first use, so importing the package
stays cheap.  Each ``*_init`` draws its module's numpy tree in the JAX layout from a seed (``weights.py``).
"""

from __future__ import annotations

import importlib

_EXPORTS = {
    "avm_apply": "avm",
    "avm_init": "avm",
    "audio_encoder_apply": "audio",
    "audio_encoder_init": "audio",
    "visual_encoder_apply": "visual",
    "visual_encoder_init": "visual",
    "text_encoder_apply": "text",
    "text_encoder_init": "text",
    "temporal_scorer_apply": "temporal",
    "temporal_scorer_init": "temporal",
}

__all__ = list(_EXPORTS)


def __getattr__(name: str):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"), name)
