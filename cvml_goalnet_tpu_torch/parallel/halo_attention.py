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

The one form, :func:`halo_attention_with`, takes the halos' source as an
argument: :func:`halo_attention_local` gives it the two shifts on a rank,
:func:`halo_attention_shards` slices of the neighbouring shards of a list in
one process (:func:`halo_extended`; the one-card check of ``chip_smoke.py``).
"""

from __future__ import annotations

import torch

from cvml_goalnet_tpu_torch.ops.cuda.flash_attention import flash_attention_local_bounded
from cvml_goalnet_tpu_torch.parallel.collectives import ring_shift


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


def halo_attention_with(q: torch.Tensor, kv: torch.Tensor, me: int, n: int, window: int, extend,
                        t_valid: int | None = None) -> torch.Tensor:
    """Shard ``me`` of ``n``: q (H, Tl, d) against ``kv`` = stack(k, v) (2, H, Tl, d) of its own shard, extended by
    ``extend(kv)`` to the previous shard's last ``window`` frames ‖ its own ‖ the next one's first (2, H,
    Tl + 2W, d) → (H, Tl, d), differentiable.  Raises ``ValueError`` when ``window`` exceeds the shard."""
    tl, w = q.shape[1], window
    check_window(w, tl)
    if w > 0:
        kv = extend(kv)
    lo, hi = halo_bounds(me, n, tl, w, t_valid)
    return halo_attend(q, kv[0], kv[1], lo, hi, w).to(q.dtype)


def halo_attention_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, axis, window: int,
                         t_valid: int | None = None) -> torch.Tensor:
    """This rank's shard of banded attention over the timeline split along ``axis``: q, k, v (H, T/n, d) →
    (H, T/n, d), differentiable.  Raises ``ValueError`` when ``window`` exceeds the shard."""
    tl, w = q.shape[1], window

    def shifted(kv):   # the previous shard's tail, its own, the next shard's head
        return torch.cat([ring_shift(kv[:, :, tl - w:], axis, 1), kv, ring_shift(kv[:, :, :w], axis, -1)], dim=2)

    return halo_attention_with(q, torch.stack((k, v)), axis.index, axis.size, w, shifted, t_valid)


def halo_extended(xs: list, me: int, window: int) -> torch.Tensor:
    """Shard ``me``'s extended keys (or values) from a list of shards: the previous shard's last ``window``
    frames, its own, the next shard's first ``window`` (wrapping round at the two ends, as on the ring)."""
    n, tl, w = len(xs), xs[me].shape[1], window
    if w == 0:
        return xs[me]
    return torch.cat([xs[(me - 1) % n][:, tl - w:], xs[me], xs[(me + 1) % n][:, :w]], dim=1)


def halo_attention_shards(qs: list, ks: list, vs: list, window: int, t_valid: int | None = None) -> list:
    """:func:`halo_attention_local` of every shard, in one process."""
    def extended(me):
        return lambda _: torch.stack((halo_extended(ks, me, window), halo_extended(vs, me, window)))

    return [halo_attention_with(q, torch.stack((ks[me], vs[me])), me, len(qs), window, extended(me), t_valid)
            for me, q in enumerate(qs)]
