"""Hybrid GRU + transformer temporal scorer.

Port of ``cvml_goalnet_tpu/models/temporal_hybrid.py`` (``:70-95``): the
bidirectional GRU's hidden states are concatenated onto the features,
``[features ‖ h_fwd ‖ h_bwd]``, and the transformer (full or banded) scores
the widened timeline.  Params: ``{"gru": {"fwd", "bwd"}, "transformer": ...}``.
"""

from __future__ import annotations

import torch

from cvml_goalnet_tpu_torch.models.temporal import _gru_scan
from cvml_goalnet_tpu_torch.models.temporal_attention import temporal_transformer_apply


def temporal_hybrid_apply(params, features: torch.Tensor, hidden: int, num_heads: int = 1, window: int = 0,
                          pos_offset: int = 0) -> torch.Tensor:
    """features (T, D) → (T,) scores, or (T, C) for a C-class head."""
    aug = torch.cat([features,
                     _gru_scan(params["gru"]["fwd"], features, hidden),
                     _gru_scan(params["gru"]["bwd"], features, hidden, reverse=True)], dim=-1)
    return temporal_transformer_apply(params["transformer"], aug, num_heads, window, pos_offset)
