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

The ring's loop (:func:`ring_attention_hops`: :func:`hop_valid`,
:func:`ring_hop`, :func:`merge`) takes the key/value source as an argument:
:func:`ring_attention_local` gives it the shift on a rank,
:func:`ring_attention_shards` indexing into a list of shards in one process
(the one-card check of ``chip_smoke.py``), so both run the one loop.  Both
devices run this one formulation; on the CPU the kernels' wrappers take their
plain versions.
"""

from __future__ import annotations

import numpy as np
import torch

from cvml_goalnet_tpu_torch.ops.cuda.flash_attention import flash_attention_with_lse
from cvml_goalnet_tpu_torch.parallel.collectives import ring_shift

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


def ring_attention_hops(q: torch.Tensor, kv: torch.Tensor, me: int, n: int, next_kv,
                        t_valid: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """The ring's loop for shard ``me`` of ``n``: q (H, Tl, d) against ``kv`` = stack(k, v) (2, H, Tl, d) of its
    own shard, then, at hop i ≥ 1, against ``next_kv(kv, i)``, the stacked keys and values of shard
    ``(me − i) mod n`` given the previous hop's → (out float32 (H, Tl, d), merged lse (H, Tl, 1))."""
    h, tl, d = q.shape
    out = torch.zeros((h, tl, d), dtype=torch.float32, device=q.device)
    lse = torch.full((h, tl, 1), NEG_INF, dtype=torch.float32, device=q.device)
    for i in range(n):
        if i:
            kv = next_kv(kv, i)
        out_i, lse_i = ring_hop(q, kv[0], kv[1], hop_valid(t_valid, (me - i) % n, tl))
        out, lse = merge(out, lse, out_i, lse_i)
    return out, lse


def ring_attention_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, axis,
                         t_valid: int | None = None) -> torch.Tensor:
    """This rank's shard of full attention over the timeline split along ``axis`` (a ``parallel.mesh.Axis``):
    q, k, v (H, T/n, d), keys of global index ``>= t_valid`` masked → (H, T/n, d), differentiable."""
    out, _ = ring_attention_hops(q, torch.stack((k, v)), axis.index, axis.size,
                                 lambda kv, _: ring_shift(kv, axis, 1), t_valid)
    return out.to(q.dtype)


def ring_attention_shards(qs: list, ks: list, vs: list, t_valid: int | None = None) -> tuple[list, list]:
    """:func:`ring_attention_local` of every shard, in one process: shard ``me`` meets shard ``(me − i) mod n`` at
    hop i, as on the ring → (outs, merged lses (H, Tl, 1))."""
    n, kvs = len(qs), [torch.stack(kv) for kv in zip(ks, vs)]
    hops = [ring_attention_hops(q, kvs[me], me, n, lambda _, i, me=me: kvs[(me - i) % n], t_valid)
            for me, q in enumerate(qs)]
    return [out.to(q.dtype) for (out, _), q in zip(hops, qs)], [lse for _, lse in hops]
