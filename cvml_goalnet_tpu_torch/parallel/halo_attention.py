"""Halo attention: banded attention over a timeline split along the ctx axis of the rank grid.

Port of ``cvml_goalnet_tpu/parallel/halo_attention.py:32-99``.  A band
``|i − j| ≤ W`` reaches at most W frames into each neighbour's shard, so
each rank takes one W-frame halo from each side (two
:func:`parallel.collectives.ring_shift` s, no ring) and runs the banded
kernel (``flash_attention_local_bounded``: kernel 7 forward, kernel 8
backward) with its own query rows against the extended keys ``left halo ‖
own ‖ right halo``, the band shifted by ``q_offset = W``.  Keys outside the
timeline (the halos that wrap round at its two ends, and the padded tail) lie
outside the ``[lo, hi)`` bounds of :func:`halo_bounds`, so the result is
monolithic banded attention.

The one form, :func:`halo_attention_lanes`, runs on a lock-step view of the
axis: :func:`halo_attention_local` on a rank's ``parallel.mesh.Axis``, whose
two shifts are collectives, :func:`halo_attention_shards` on a
``parallel.mesh.VirtualAxis`` of every shard in one process (the one-card
check of ``chip_smoke.py``), whose shifts rotate a list.
"""

from __future__ import annotations

import torch

from cvml_goalnet_tpu_torch.ops.cuda.flash_attention import flash_attention_local_bounded
from cvml_goalnet_tpu_torch.parallel.mesh import VirtualAxis


def check_window(window: int, tl: int) -> None:
    if window > tl:
        raise ValueError(
            f"halo banded attention needs window ({window}) <= per-device "
            f"shard length ({tl}): halos come from immediate neighbors only. "
            f"Use fewer devices on the sequence axis or a smaller window."
        )


def halo_bounds(me: int, n: int, tl: int, window: int, t_valid: int | None) -> tuple[int, int]:
    """``[lo, hi)`` of the valid keys in shard ``me``'s extended coordinates (key j is global frame
    ``me·tl − W + j``): the global ``[0, t_valid)``."""
    ext_len = tl + 2 * window
    g0 = me * tl - window
    tv = n * tl if t_valid is None else int(t_valid)
    return min(max(-g0, 0), ext_len), min(max(tv - g0, 0), ext_len)


def halo_attend(q, ext_k, ext_v, lo: int, hi: int, window: int) -> torch.Tensor:
    """The local query rows against the extended keys, the band shifted by ``q_offset = window``."""
    return flash_attention_local_bounded(q, ext_k, ext_v, lo, hi, window, q_offset=window)


def halo_attention_lanes(qs: list, ks: list, vs: list, axis, window: int, t_valid: int | None = None) -> list:
    """The shards ``axis`` holds (a lock-step view, ``parallel.mesh.Axis`` or ``VirtualAxis``): each q (H, Tl,
    d) against its keys and values extended to the previous shard's last ``window`` frames ‖ its own ‖ the
    next one's first (wrapping round at the two ends, outside the bounds) → (H, Tl, d) a lane held,
    differentiable.  Raises ``ValueError`` when ``window`` exceeds the shard."""
    tl, w = qs[0].shape[1], window
    check_window(w, tl)
    kvs = [torch.stack(kv) for kv in zip(ks, vs)]
    if w > 0:
        tails = axis.shift([kv[:, :, tl - w:] for kv in kvs], 1)
        heads = axis.shift([kv[:, :, :w] for kv in kvs], -1)
        kvs = [torch.cat(parts, dim=2) for parts in zip(tails, kvs, heads)]
    return [halo_attend(q, kv[0], kv[1], *halo_bounds(me, axis.size, tl, w, t_valid), w).to(q.dtype)
            for me, q, kv in zip(axis.lanes, qs, kvs)]


def halo_attention_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, axis, window: int,
                         t_valid: int | None = None) -> torch.Tensor:
    """This rank's shard of banded attention over the timeline split along ``axis``: q, k, v (H, T/n, d) →
    (H, T/n, d), differentiable.  Raises ``ValueError`` when ``window`` exceeds the shard."""
    return halo_attention_lanes([q], [k], [v], axis, window, t_valid)[0]


def halo_attention_shards(qs: list, ks: list, vs: list, window: int, t_valid: int | None = None) -> list:
    """:func:`halo_attention_local` of every shard, in one process."""
    return halo_attention_lanes(qs, ks, vs, VirtualAxis(len(qs)), window, t_valid)
