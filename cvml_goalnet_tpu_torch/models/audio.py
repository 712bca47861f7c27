"""Audio branch encoder.

Port of ``cvml_goalnet_tpu/models/audio.py`` (reference ``AudBl``,
``utils.py:197-227``): Conv1d(k3, s2, p1) → ReLU, twice, → flatten →
Linear → ReLU, on (N, B, n_mfcc) NWC input.  The flatten is time-major
(channel-last), as in the JAX package.  Plain PyTorch: there is no Pallas
kernel on this branch.
"""

from __future__ import annotations

import torch

from cvml_goalnet_tpu_torch.config import AudioConfig
from cvml_goalnet_tpu_torch.models import layers as L

GEOM = (3, 2, 1)  # kernel, stride, padding for both convs — utils.py:203,206


def audio_temporal_trace(length: int, n_stages: int) -> list[int]:
    k, s, p = GEOM
    out = []
    for _ in range(n_stages):
        length = L.conv_out_size(length, k, s, p)
        out.append(length)
    return out


def audio_feature_channels(aud: AudioConfig) -> int:
    """Input channel count: n_mels for the log-mel variant, else n_mfcc."""
    return aud.n_mels if aud.log_mel else aud.n_mfcc


def audio_encoder_init(seed: int, cfg, aud: AudioConfig) -> dict:
    """The audio branch's numpy tree in the JAX layout (``conv0``, ``conv1``, ``head``), drawn from ``seed`` as
    ``weights.init_params`` draws it (JAX's ``audio_encoder_init`` takes a key; the draws differ)."""
    import numpy as np

    from cvml_goalnet_tpu_torch.weights import _audio_encoder

    return _audio_encoder(np.random.default_rng(seed), cfg, aud)


def audio_encoder_apply(params, x: torch.Tensor) -> torch.Tensor:
    """x (N, B, n_mfcc) MFCC features → (N, aud_feature_dim)."""
    n = x.shape[0]
    i = 0
    while f"conv{i}" in params:
        x = torch.relu(L.conv1d_apply(params[f"conv{i}"], x, stride=GEOM[1], padding=GEOM[2]))
        i += 1
    x = x.reshape(n, x.shape[1] * x.shape[2])
    return torch.relu(L.linear_apply(params["head"], x))
