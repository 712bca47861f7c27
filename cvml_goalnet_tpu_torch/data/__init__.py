"""Input data helpers of the port (counterparts of ``cvml_goalnet_tpu/data``).

The names of the JAX package's ``__all__`` are exported here, imported at first use, so importing the package
stays cheap.
"""

from __future__ import annotations

import importlib

_EXPORTS = {
    "AnnotationStore": "annotations",
    "load_tvsum_annotations": "annotations",
    "VideoDataset": "dataset",
    "build_datasets": "dataset",
    "synthetic_dataset_dir": "synthetic",
    "synthetic_video_frames": "synthetic",
    "synthetic_waveform": "synthetic",
    "decode_condensed_frames": "video",
    "decode_all_frames": "video",
    "load_waveform": "audio_io",
}

__all__ = list(_EXPORTS)


def __getattr__(name: str):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"), name)
