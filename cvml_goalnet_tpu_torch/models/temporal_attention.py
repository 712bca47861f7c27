"""Temporal transformer scorer over a (T, D) frame-feature timeline.

Port of the single-device forward of
``cvml_goalnet_tpu/models/temporal_attention.py`` (``:76-163``): ``proj_in``,
learned positions ``pos[(pos_offset + t) mod max_len]`` or rotary positions
on q/k, pre-LN blocks (attention, then a GELU MLP of width 4·D with the tanh
approximation of ``jax.nn.gelu``), and a per-frame head → (T,) scores, or
(T, C) for a C-class head.  Attention is the flash kernels of
``ops/cuda/flash_attention.py``: banded when ``window > 0``, full otherwise,
differentiable through their backward kernels, so the scorer trains as is.
The context-parallel variants are multi-GPU work and not ported yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from cvml_goalnet_tpu_torch.models import layers as L
from cvml_goalnet_tpu_torch.ops.cuda.flash_attention import flash_attention, flash_attention_local


def rope_rotate(x: torch.Tensor, positions: torch.Tensor, base: float = 10000.0) -> torch.Tensor:
    """Rotary embedding on (H, T, hd): split halves ``[x1·cos − x2·sin, x1·sin + x2·cos]``;
    an odd head dim passes its last lane through."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = base ** (-torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = positions.to(torch.float32)[:, None] * freqs[None, :]   # (T, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half : 2 * half]
    rot = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    if hd % 2:
        rot = torch.cat([rot, x[..., 2 * half :]], dim=-1)
    return rot.to(x.dtype)


def _attend(layer, x: torch.Tensor, num_heads: int, window: int = 0, rope_pos=None) -> torch.Tensor:
    t, d = x.shape
    hd = d // num_heads

    def split(h):  # (T, D) → (H, T, hd)
        return h.reshape(t, num_heads, hd).permute(1, 0, 2).contiguous()

    q = split(L.linear_apply(layer["wq"], x))
    k = split(L.linear_apply(layer["wk"], x))
    v = split(L.linear_apply(layer["wv"], x))
    if rope_pos is not None:
        q = rope_rotate(q, rope_pos)
        k = rope_rotate(k, rope_pos)
    attn = flash_attention_local(q, k, v, window) if window > 0 else flash_attention(q, k, v)
    return L.linear_apply(layer["wo"], attn.permute(1, 0, 2).reshape(t, d))


def temporal_transformer_apply(params, features: torch.Tensor, num_heads: int = 1, window: int = 0,
                               pos_offset: int = 0) -> torch.Tensor:
    """(T, D) → (T,) scores, or (T, C) for a C-class head.

    ``window``: attention band radius, 0 for full attention.  ``pos_offset``:
    the global timeline index of ``features[0]`` (streamed windows keep the
    offline positions).
    """
    t = features.shape[0]
    x = L.linear_apply(params["proj_in"], features)
    pos = pos_offset + torch.arange(t, device=features.device)
    rope_pos = None
    if "pos" in params:
        # learned positions, tiled past max_len
        x = x + params["pos"][pos % params["pos"].shape[0]]
    else:
        rope_pos = pos
    for layer in params["layers"]:
        h = L.layernorm_apply(layer["ln1"], x)
        x = x + _attend(layer, h, num_heads, window, rope_pos)
        h = L.layernorm_apply(layer["ln2"], x)
        x = x + L.linear_apply(layer["mlp_out"], F.gelu(L.linear_apply(layer["mlp_in"], h), approximate="tanh"))
    out = L.linear_apply(params["head"], x)
    return out[:, 0] if out.shape[-1] == 1 else out
