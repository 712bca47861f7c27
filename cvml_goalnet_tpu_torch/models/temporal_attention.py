"""Temporal transformer scorer over a (T, D) frame-feature timeline.

Port of the single-device forward of
``cvml_goalnet_tpu/models/temporal_attention.py`` (``:76-163``): ``proj_in``,
learned positions ``pos[(pos_offset + t) mod max_len]`` or rotary positions
on q/k, pre-LN blocks (attention, then a GELU MLP of width 4·D with the tanh
approximation of ``jax.nn.gelu``), and a per-frame head → (T,) scores, or
(T, C) for a C-class head.  Attention is the flash kernels of
``ops/cuda/flash_attention.py``: banded when ``window > 0``, full otherwise,
differentiable through their backward kernels, so the scorer trains as is.

The context-parallel forms (JAX ``:166-585``) run on the ranks of
``parallel/launch.py``, each with its ``parallel.mesh.CpGroups``: the
timeline splits along the ctx axis (padded to a multiple of it), positions
are global (learned ``pos[(me·Tl + t) mod max_len]``, rotary at ``me·Tl +
t``), and attention crosses shards through ``parallel/ring_attention.py``
(full) or ``parallel/halo_attention.py`` (banded).  ``_cp_local_body`` is one
rank's shard; ``_tp_cp_local_body`` also splits each block's heads and MLP
over the model axis (Megatron's column and row slices, two model-axis
reductions a layer).  The applies take the whole input on every rank and
return the whole output on every rank (gathered, no autograd: the train
steps of ``train/spotting.py`` take the bodies).  A batch of timelines
(``dp_cp``, ``3d``) splits along the data axis, each timeline with its own
true length, clamped to at least 1.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from cvml_goalnet_tpu_torch.device import strict_f32
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
    """Self-attention of a (T, D) timeline, or of each timeline of a (B, T, D) batch (its timelines' heads side
    by side in one kernel call)."""
    *lead, t, d = x.shape
    b, hd = math.prod(lead), d // num_heads   # explicit sizes: a timeline may have no frames

    def split(h):  # (..., T, D) → (B·H, T, hd)
        return h.reshape(b, t, num_heads, hd).transpose(1, 2).reshape(b * num_heads, t, hd).contiguous()

    q = split(L.linear_apply(layer["wq"], x))
    k = split(L.linear_apply(layer["wk"], x))
    v = split(L.linear_apply(layer["wv"], x))
    if rope_pos is not None:
        q = rope_rotate(q, rope_pos)
        k = rope_rotate(k, rope_pos)
    attn = flash_attention_local(q, k, v, window) if window > 0 else flash_attention(q, k, v)
    attn = attn.reshape(b, num_heads, t, hd).transpose(1, 2).reshape(*lead, t, d)
    return L.linear_apply(layer["wo"], attn)


def _block_apply(layer, x: torch.Tensor, num_heads: int, window: int = 0, rope_pos=None) -> torch.Tensor:
    """One pre-LN block on a (T, D) timeline or a (B, T, D) batch of them: attention, then the GELU MLP."""
    h = L.layernorm_apply(layer["ln1"], x)
    x = x + _attend(layer, h, num_heads, window, rope_pos)
    h = L.layernorm_apply(layer["ln2"], x)
    return x + L.linear_apply(layer["mlp_out"], _mlp_gelu(L.linear_apply(layer["mlp_in"], h)))


def _mlp_gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


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
        x = _block_apply(layer, x, num_heads, window, rope_pos)
    out = L.linear_apply(params["head"], x)
    return out[:, 0] if out.shape[-1] == 1 else out


# ------------------------------------------------------------------ context parallel (JAX :166-585)


def _positions(params, x: torch.Tensor, me: int, tl: int):
    """Global positions of shard ``me``: learned added to ``x``, or the rotary positions → (x, rope_pos)."""
    gpos = me * tl + torch.arange(tl, device=x.device)
    if "pos" in params:
        return x + params["pos"][gpos % params["pos"].shape[0]], None
    return x, gpos


def _cp_attention(q, k, v, ctx, window: int, t: int):
    from cvml_goalnet_tpu_torch.parallel.halo_attention import halo_attention_local
    from cvml_goalnet_tpu_torch.parallel.ring_attention import ring_attention_local

    return halo_attention_local(q, k, v, ctx, window, t) if window > 0 else ring_attention_local(q, k, v, ctx, t)


def _cp_local_body(params, feats_l: torch.Tensor, *, ctx, num_heads: int, t: int, window: int, n_out: int):
    """One rank's shard of the context-parallel transformer: ``feats_l`` (T/n, D) → (T/n,) or (T/n, C).

    ``ctx`` is the rank's ctx axis (``parallel.mesh.Axis``); ``t`` the timeline's true length, whose padded
    key columns attention masks."""
    tl = feats_l.shape[0]
    x, rope_pos = _positions(params, L.linear_apply(params["proj_in"], feats_l), ctx.index, tl)
    d = x.shape[-1]
    hd = d // num_heads

    def split(h):  # (Tl, D) → (H, Tl, hd)
        return h.reshape(tl, num_heads, hd).permute(1, 0, 2).contiguous()

    for layer in params["layers"]:
        h = L.layernorm_apply(layer["ln1"], x)
        q, k, v = (split(L.linear_apply(layer[n], h)) for n in ("wq", "wk", "wv"))
        if rope_pos is not None:
            q, k = rope_rotate(q, rope_pos), rope_rotate(k, rope_pos)
        attn = _cp_attention(q, k, v, ctx, window, t)
        x = x + L.linear_apply(layer["wo"], attn.permute(1, 0, 2).reshape(tl, d))
        h = L.layernorm_apply(layer["ln2"], x)
        x = x + L.linear_apply(layer["mlp_out"], _mlp_gelu(L.linear_apply(layer["mlp_in"], h)))
    out = L.linear_apply(params["head"], x)
    return out[:, 0] if n_out == 1 else out


def _tp_cp_local_body(params, feats_l: torch.Tensor, *, model, ctx, num_heads: int, t: int, window: int,
                      n_out: int):
    """One rank's shard of the tensor × context parallel transformer: its H/n_model heads of its T/n_ctx frames.

    The rank's slice of each block is ``parallel/sharding.py::transformer_param_shardings`` at its model index
    (wq, wk, wv and mlp_in by output columns, wo and mlp_out by input rows); the block's input enters through ``copy_to_axis`` (its gradient summed over the model axis) and
    the two row-split products leave through ``reduce_from_axis``: Megatron's two all-reduces a layer.  The
    layer norms, ``proj_in``, the positions, the biases of wo and mlp_out and the head run replicated."""
    from cvml_goalnet_tpu_torch.parallel.collectives import copy_to_axis, reduce_from_axis
    from cvml_goalnet_tpu_torch.parallel.sharding import model_shard, transformer_param_shardings

    tl = feats_l.shape[0]
    x, rope_pos = _positions(params, L.linear_apply(params["proj_in"], feats_l), ctx.index, tl)
    d = x.shape[-1]
    hd = d // num_heads
    h_loc, d_loc = num_heads // model.size, d // model.size
    mine = model_shard(params, transformer_param_shardings(params), model.index, model.size)

    def rows(w, y):     # y @ this rank's input rows of w: a partial sum of the whole product
        with strict_f32():
            return torch.matmul(y, w)

    for layer in mine["layers"]:
        h = copy_to_axis(L.layernorm_apply(layer["ln1"], x), model)
        q, k, v = (L.linear_apply(layer[n], h).reshape(tl, h_loc, hd).permute(1, 0, 2).contiguous()
                   for n in ("wq", "wk", "wv"))
        if rope_pos is not None:
            q, k = rope_rotate(q, rope_pos), rope_rotate(k, rope_pos)
        attn = _cp_attention(q, k, v, ctx, window, t)
        part = rows(layer["wo"]["w"], attn.permute(1, 0, 2).reshape(tl, d_loc))
        x = x + reduce_from_axis(part, model) + layer["wo"]["b"]
        h = copy_to_axis(L.layernorm_apply(layer["ln2"], x), model)
        part = rows(layer["mlp_out"]["w"], _mlp_gelu(L.linear_apply(layer["mlp_in"], h)))
        x = x + reduce_from_axis(part, model) + layer["mlp_out"]["b"]
    out = L.linear_apply(params["head"], x)
    return out[:, 0] if n_out == 1 else out


def check_tp_divisibility(params, num_heads: int, nm: int) -> None:
    """JAX's ``_check_tp_divisibility``: the model axis must divide the heads, the model width and the MLP."""
    d = params["proj_in"]["w"].shape[1]
    m = params["layers"][0]["mlp_in"]["w"].shape[1] if params["layers"] else nm
    if num_heads % nm or d % nm or m % nm:
        raise ValueError(
            f"tensor-parallel axis width {nm} must divide num_heads "
            f"({num_heads}), model_dim ({d}), and the MLP hidden ({m})"
        )


def head_classes(params) -> int:
    return int(params["head"]["w"].shape[-1])


def padded_length(t: int, n: int) -> int:
    """``t`` rounded up to a multiple of ``n``."""
    return -(-t // n) * n


def _time_shard(x: torch.Tensor, ctx, t_axis: int = 0) -> torch.Tensor:
    """This rank's contiguous shard of ``x`` along ``t_axis``, zero-padded to a multiple of the ctx axis."""
    t = x.shape[t_axis]
    pad = padded_length(t, ctx.size) - t
    if pad:
        shape = list(x.shape)
        shape[t_axis] = pad
        x = torch.cat([x, x.new_zeros(shape)], dim=t_axis)
    tl = x.shape[t_axis] // ctx.size
    return x.narrow(t_axis, ctx.index * tl, tl)


def _check_batch(b: int, groups) -> int:
    nd = groups.data.size
    if b % nd:
        raise ValueError(f"batch {b} must divide over data axis 'data' ({nd} devices)")
    return b // nd


def clamped_lengths(lengths, b: int, t: int) -> list[int]:
    """Each timeline's true length (``t`` for all when None), at least 1: an all-pad dummy timeline must leave
    attention a valid key (its rows carry no loss)."""
    if lengths is None:
        return [t] * b
    return [max(int(n), 1) for n in (lengths.tolist() if isinstance(lengths, torch.Tensor) else lengths)]


def batch_local_logits(params, features: torch.Tensor, groups, body, lengths) -> torch.Tensor:
    """This rank's logits of its timelines of the batch ``features`` (B, T, D) on its shard of time →
    (B/n_data, T/n_ctx[, C]); ``body(params, feats_l, t)`` is one timeline's shard."""
    b, t = features.shape[0], features.shape[1]
    bl = _check_batch(b, groups)
    lens = clamped_lengths(lengths, b, t)
    d0 = groups.data.index * bl
    return torch.stack([body(params, _time_shard(features[i], groups.ctx), lens[i]) for i in range(d0, d0 + bl)])


def _gather_batch(local: torch.Tensor, groups, t: int) -> torch.Tensor:
    from cvml_goalnet_tpu_torch.parallel.collectives import all_gather_cat

    return all_gather_cat(all_gather_cat(local, groups.ctx, dim=1), groups.data, dim=0)[:, :t]


def cp_body(groups, num_heads: int, window: int, tp: bool = False):
    """``body(params, feats_l, t)``: one timeline's shard on this rank, through ``_cp_local_body`` or (``tp``)
    ``_tp_cp_local_body``, which first checks the model axis divides the blocks."""
    def body(params, feats_l, t):
        kw = {"ctx": groups.ctx, "num_heads": num_heads, "t": t, "window": window, "n_out": head_classes(params)}
        if not tp:
            return _cp_local_body(params, feats_l, **kw)
        check_tp_divisibility(params, num_heads, groups.model.size)
        return _tp_cp_local_body(params, feats_l, model=groups.model, **kw)

    return body


def temporal_transformer_sharded_apply(params, features: torch.Tensor, groups, num_heads: int = 1,
                                       window: int = 0) -> torch.Tensor:
    """Context-parallel scoring of one timeline (T, D) over the ctx axis of ``groups`` → (T,) or (T, C) on every
    rank, equal to :func:`temporal_transformer_apply`; ``window > 0`` takes the halo form."""
    from cvml_goalnet_tpu_torch.parallel.collectives import all_gather_cat

    t = features.shape[0]
    body = cp_body(groups, num_heads, window)
    return all_gather_cat(body(params, _time_shard(features, groups.ctx), t), groups.ctx)[:t]


def temporal_transformer_dp_cp_apply(params, features: torch.Tensor, groups, num_heads: int = 1, window: int = 0,
                                     lengths=None) -> torch.Tensor:
    """Data × context parallel scoring of a batch (B, T, D): timelines over the data axis, time over the ctx axis →
    (B, T) or (B, T, C) on every rank.  ``lengths`` (B,): each timeline's true length (None: T)."""
    body = cp_body(groups, num_heads, window)
    return _gather_batch(batch_local_logits(params, features, groups, body, lengths), groups, features.shape[1])


def temporal_transformer_tp_cp_apply(params, features: torch.Tensor, groups, num_heads: int = 1,
                                     window: int = 0) -> torch.Tensor:
    """Tensor × context parallel scoring of one timeline (T, D): heads over the model axis, time over the ctx
    axis → (T,) or (T, C) on every rank."""
    from cvml_goalnet_tpu_torch.parallel.collectives import all_gather_cat

    check_tp_divisibility(params, num_heads, groups.model.size)
    t = features.shape[0]
    body = cp_body(groups, num_heads, window, tp=True)
    return all_gather_cat(body(params, _time_shard(features, groups.ctx), t), groups.ctx)[:t]


def temporal_transformer_3d_apply(params, features: torch.Tensor, groups, num_heads: int = 1, window: int = 0,
                                  lengths=None) -> torch.Tensor:
    """Data × tensor × context parallel scoring of a batch (B, T, D) → (B, T) or (B, T, C) on every rank."""
    check_tp_divisibility(params, num_heads, groups.model.size)
    body = cp_body(groups, num_heads, window, tp=True)
    return _gather_batch(batch_local_logits(params, features, groups, body, lengths), groups, features.shape[1])
