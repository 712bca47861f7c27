"""ViT visual backbone (``ModelConfig.vis_backbone = "vit"``): the eval, int8 and train forwards.

Port of ``cvml_goalnet_tpu/models/vit.py``.  The frame is cut into
``patch × patch`` patches (one reshape chain, :func:`_patchify`), embedded
by a linear layer, given learned positions (``pos``, one row a token), run
through pre-LN blocks (``layers.multihead_attention`` and a GELU MLP of
width 4·d, the tanh GELU that ``jax.nn.gelu`` defaults to), then
``ln_out``, the mean over tokens, the head and ReLU.  At the
``ModelConfig`` defaults on 40×40 frames: patch 8, 25 tokens, d = 192,
depth 4, 4 heads.  There is no batchnorm: ``state`` is ``{}`` and ``mask``
changes nothing (LayerNorm has no statistics across frames).

With ``quant`` (eval only) every block linear (the q/k/v/o projections and
both MLP layers) runs through ``ops/quant.py::quantized_linear``, one
activation scale over the whole batch each; the patch embedding and the
head stay float.  The forward runs in the input's dtype, rounding per
operation on bf16 as the JAX package's eager bf16 forward does.  Every op is
a library call (cuBLAS and cuBLAS's int8 GEMM on the card, TF32 off): the
JAX package computes this backbone in XLA, with no Pallas kernel.
"""

from __future__ import annotations

import torch

from cvml_goalnet_tpu_torch.models import layers as L
from cvml_goalnet_tpu_torch.ops.quant import quantized_linear


def vit_grid(cfg, pre) -> tuple[int, int, int]:
    """→ ``(grid_h, grid_w, n_tokens)``; raises on a patch that does not tile the frame."""
    p = cfg.vit_patch_size
    h, w = pre.frame_size
    if p <= 0 or h % p or w % p:
        raise ValueError(
            f"vit_patch_size ({p}) must evenly divide frame_size "
            f"({pre.frame_size}) — got a ragged patch grid"
        )
    return h // p, w // p, (h // p) * (w // p)


def check_vit_config(cfg) -> None:
    """Raise, with the JAX package's words, on a width the heads do not divide."""
    if cfg.vit_embed_dim % cfg.vit_num_heads:
        raise ValueError(
            f"vit_embed_dim ({cfg.vit_embed_dim}) must be divisible by vit_num_heads "
            f"({cfg.vit_num_heads})"
        )


def _patchify(x: torch.Tensor, patch: int) -> torch.Tensor:
    """(N, H, W, C) → (N, (H/p)·(W/p), p·p·C), patches in row-major grid order, each row-major within."""
    n, h, w, c = x.shape
    gh, gw = h // patch, w // patch
    return x.reshape(n, gh, patch, gw, patch, c).permute(0, 1, 3, 2, 4, 5).reshape(n, gh * gw, patch * patch * c)


def _forward(params, x: torch.Tensor, num_heads: int, patch: int, lin) -> torch.Tensor:
    """The encoder up to the head's ReLU; ``lin`` is the block linears' function."""
    h = L.linear_apply(params["patch"], _patchify(x, patch))
    h = h + params["pos"].to(h.dtype)
    for blk in params["blocks"]:
        a = L.layernorm_apply(blk["ln1"], h)
        h = h + L.multihead_attention(blk, a, num_heads, linear_fn=lin)
        m = L.layernorm_apply(blk["ln2"], h)
        h = h + lin(blk["mlp_out"], L.gelu_tanh(lin(blk["mlp_in"], m)))
    h = L.layernorm_apply(params["ln_out"], h)
    return torch.relu(L.linear_apply(params["head"], L.mean(h, 1)))


def vit_encoder_apply(params, state, x: torch.Tensor, *, num_heads: int, patch: int,
                      quant: bool = False) -> torch.Tensor:
    """x (N, S, S, C) normalised frames → (N, vis_feature_dim) in x's dtype, eval mode; ``quant`` takes every
    block linear through int8.  ``state`` is ``{}``."""
    return _forward(params, x, num_heads, patch, quantized_linear if quant else L.linear_apply)


def vit_encoder_train_apply(params, state, x: torch.Tensor, *, num_heads: int, patch: int,
                            generator: torch.Generator | None, dropout_rate: float,
                            mask: torch.Tensor | None = None, bn_group=None):
    """x → ``((N, vis_feature_dim) features, state)`` in train mode: the head's dropout from ``generator``;
    ``mask`` and ``bn_group`` are taken for the backbones' common signature (the vit has no batchnorm) and
    change nothing."""
    del mask, bn_group
    return L.dropout(_forward(params, x, num_heads, patch, L.linear_apply), dropout_rate, True, generator), state
