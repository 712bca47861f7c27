"""Ring attention: full attention over a timeline split along the ctx axis of the rank grid.

Port of ``cvml_goalnet_tpu/parallel/ring_attention.py`` (its flash form,
``:76-115``).  Each rank keeps its query shard; the key and value shards go
round the ring (:func:`parallel.collectives.ring_shift`), and after n hops
every query shard has met every key shard.  Each hop is the full-attention
kernel with its log-sum-exp (``flash_attention_with_lse``: kernel 5 forward,
kernel 6 backward with the lse cotangent), valid below the hop's share of the
timeline's true length, and the hops merge by the log-sum-exp rule, so the
result is monolithic attention.  A hop with no valid key (the ring's padded
tail) reports lse 0; it merges as ``NEG_INF``, as JAX's does, so it weighs
nothing and its gradient is 0.

The ring's loop (:func:`ring_attention_lanes`: :func:`hop_valid`,
:func:`ring_hop`, :func:`merge`) runs on a lock-step view of the axis:
:func:`ring_attention_local` on a rank's ``parallel.mesh.Axis``, whose shift
is the collective, :func:`ring_attention_shards` on a
``parallel.mesh.VirtualAxis`` of every shard in one process (the one-card
check of ``chip_smoke.py``), whose shift rotates a list.  Both devices run
this one formulation; on the CPU the kernels' wrappers take their plain
versions.
"""

from __future__ import annotations

import numpy as np
import torch

from cvml_goalnet_tpu_torch.ops.cuda.flash_attention import flash_attention_with_lse
from cvml_goalnet_tpu_torch.parallel.mesh import VirtualAxis

NEG_INF = -0.7 * float(np.finfo(np.float32).max)


def hop_valid(t_valid: int | None, src: int, tl: int) -> int:
    """The valid keys of the shard of ring index ``src`` (``tl`` frames a shard) under a true length
    ``t_valid`` (None: every key)."""
    return tl if t_valid is None else min(max(int(t_valid) - src * tl, 0), tl)


def ring_hop(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, valid: int) -> tuple[torch.Tensor, torch.Tensor]:
    """One hop: q (H, Tl, d) over the keys k, v below ``valid`` → (out (H, Tl, d), lse (H, Tl, 1)); a hop with no
    valid key takes lse ``NEG_INF``."""
    out, lse = flash_attention_with_lse(q, k, v, valid)
    if valid <= 0:
        lse = torch.full_like(lse, NEG_INF)
    return out, lse


def merge(out, lse, out_i, lse_i) -> tuple[torch.Tensor, torch.Tensor]:
    """Two normalised partials of one softmax merged by their log-sum-exps → (out, lse), float32."""
    m = torch.maximum(lse, lse_i)
    w, w_i = torch.exp(lse - m), torch.exp(lse_i - m)
    tot = w + w_i
    return (out * w + out_i.to(torch.float32) * w_i) / tot, m + torch.log(tot)


def ring_attention_lanes(qs: list, ks: list, vs: list, axis, t_valid: int | None = None) -> tuple[list, list]:
    """The ring's loop over the shards ``axis`` holds (a lock-step view, ``parallel.mesh.Axis`` or
    ``VirtualAxis``): shard ``me``'s q (H, Tl, d) meets its own keys and values, then at hop i those of shard
    ``(me − i) mod n``, shifted one lane on at each hop, keys of global index ``>= t_valid`` masked → (outs
    (H, Tl, d) in q's dtype, merged lses float32 (H, Tl, 1)), one a lane held; differentiable."""
    n, (h, tl, d) = axis.size, qs[0].shape
    kvs = [torch.stack(kv) for kv in zip(ks, vs)]
    outs = [torch.zeros((h, tl, d), dtype=torch.float32, device=q.device) for q in qs]
    lses = [torch.full((h, tl, 1), NEG_INF, dtype=torch.float32, device=q.device) for q in qs]
    for i in range(n):
        if i:
            kvs = axis.shift(kvs)
        for j, (me, q, kv) in enumerate(zip(axis.lanes, qs, kvs)):
            out_i, lse_i = ring_hop(q, kv[0], kv[1], hop_valid(t_valid, (me - i) % n, tl))
            outs[j], lses[j] = merge(outs[j], lses[j], out_i, lse_i)
    return [out.to(q.dtype) for out, q in zip(outs, qs)], lses


def ring_attention_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, axis,
                         t_valid: int | None = None) -> torch.Tensor:
    """This rank's shard of full attention over the timeline split along ``axis`` (a ``parallel.mesh.Axis``):
    q, k, v (H, T/n, d), keys of global index ``>= t_valid`` masked → (H, T/n, d), differentiable."""
    return ring_attention_lanes([q], [k], [v], axis, t_valid)[0][0]


def ring_attention_shards(qs: list, ks: list, vs: list, t_valid: int | None = None) -> tuple[list, list]:
    """:func:`ring_attention_local` of every shard, in one process → (outs, merged lses (H, Tl, 1))."""
    return ring_attention_lanes(qs, ks, vs, VirtualAxis(len(qs)), t_valid)
