"""The text (commentary) branch: a small pre-LN transformer encoder over token ids.

Port of ``cvml_goalnet_tpu/models/text.py``: learned embeddings plus
sinusoidal positions, ``text_num_layers`` blocks of multi-head attention
(``layers.multihead_attention``, the (T, T) logits materialised: T is
``text_max_len``, 64) and a GELU MLP of width 4·d, then the mean over the
valid tokens, a linear head and ReLU → (N, ``text_feature_dim``) features
that the fusion head takes after [audio ‖ visual].

A frame with no commentary (all-zero ids) attends uniformly over its
padding, pools to 0 and gives ``relu(head.b)``.  The encoder runs in the
dtype of its parameters (float32, or bf16 after ``tree_cast`` as in the bf16
``fuse``), rounding where the JAX package's bf16 encoder rounds.  It is
plain PyTorch on the card as on the CPU: the JAX package computes it in XLA,
with no Pallas kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from cvml_goalnet_tpu_torch.config import ModelConfig
from cvml_goalnet_tpu_torch.device import strict_f32
from cvml_goalnet_tpu_torch.models import layers as L


def _sinusoidal_positions(length: int, dim: int) -> np.ndarray:
    pos = np.arange(length)[:, None]
    i = np.arange(dim // 2)[None, :]
    angle = pos / np.power(10000.0, 2 * i / dim)
    out = np.zeros((length, dim), dtype=np.float32)
    out[:, 0::2] = np.sin(angle)
    out[:, 1::2] = np.cos(angle)
    return out


def check_text_config(cfg: ModelConfig) -> None:
    """Raise where the config is at fault: an odd width breaks the sinusoidal table and a width the heads
    do not divide breaks the attention's reshape."""
    d = cfg.text_embed_dim
    if d % 2 or d % cfg.text_num_heads:
        raise ValueError(
            f"text_embed_dim ({d}) must be even and divisible by "
            f"text_num_heads ({cfg.text_num_heads})"
        )


def text_encoder_init(seed: int, cfg: ModelConfig) -> dict:
    """The text branch's numpy tree in the JAX layout (``embed``, ``head``, ``layers``), drawn from ``seed`` as
    ``weights.init_params`` draws it; a config the encoder cannot take raises JAX's ``ValueError`` (JAX's
    ``text_encoder_init`` takes a key; the draws differ)."""
    from cvml_goalnet_tpu_torch.weights import _text_encoder

    return _text_encoder(np.random.default_rng(seed), cfg)


def text_encoder_apply(params, token_ids: torch.Tensor, *, cfg: ModelConfig) -> torch.Tensor:
    """token_ids (N, T) integers (0 = padding) → (N, text_feature_dim) in the embedding's dtype."""
    ids = torch.as_tensor(token_ids).to(device=params["embed"].device, dtype=torch.long)
    mask = ids > 0
    x = params["embed"][ids]
    # the float32 table is cast to the activation dtype before the add, as in the JAX package
    pos = torch.from_numpy(_sinusoidal_positions(ids.shape[1], x.shape[-1]))
    x = x + pos.to(device=x.device, dtype=x.dtype)
    with strict_f32():
        for layer in params["layers"]:
            h = L.layernorm_apply(layer["ln1"], x)
            x = x + L.multihead_attention(layer, h, cfg.text_num_heads, mask=mask)
            h = L.layernorm_apply(layer["ln2"], x)
            x = x + L.linear_apply(layer["mlp_out"], L.gelu_tanh(L.linear_apply(layer["mlp_in"], h)))
        # masked mean in the activation dtype: the sum in float32 rounded once, the count at least 1
        denom = torch.clamp(mask.sum(dim=1, keepdim=True), min=1).to(x.dtype)
        pooled = (x * mask[:, :, None].to(x.dtype)).to(torch.float32).sum(dim=1).to(x.dtype) / denom
        return torch.relu(L.linear_apply(params["head"], pooled))
