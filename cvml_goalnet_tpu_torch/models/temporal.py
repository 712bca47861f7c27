"""Bidirectional-GRU temporal scorer and the local-peak event detector.

Port of ``cvml_goalnet_tpu/models/temporal.py``: per-frame features (T, D) →
a forward and a backward GRU (gates split z, r, n; ``n = tanh(nx + r·nh)``
with ``wh``'s bias inside ``nh``; ``h' = (1 − z)·n + z·h`` from h0 = 0) →
a linear head over ``[h_fwd ‖ h_bwd]`` → (T,) scores, or (T, C) for a
C-class head.  The JAX package runs the recurrence under ``lax.scan`` and has
no Pallas kernel here: the port computes the input projection of every step
in one product and runs only the recurrence step by step.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from cvml_goalnet_tpu_torch.device import strict_f32
from cvml_goalnet_tpu_torch.models import layers as L


def _gru_scan(params, xs: torch.Tensor, hidden: int, reverse: bool = False) -> torch.Tensor:
    """xs (T, D) or (B, T, D) → hidden states (T, H) or (B, T, H); ``reverse`` scans from the end."""
    batched = xs.dim() == 3
    xb = xs if batched else xs[None]
    gx = L.linear_apply(params["wx"], xb)                      # (B, T, 3H): every step's input projection
    wh, bh = params["wh"]["w"], params["wh"]["b"]
    t = xb.shape[1]
    h = xb.new_zeros((xb.shape[0], hidden))
    hs = [None] * t
    with strict_f32():
        for i in range(t - 1, -1, -1) if reverse else range(t):
            g = gx[:, i]
            gh = torch.addmm(bh, h, wh)
            zr = torch.sigmoid(g[:, : 2 * hidden] + gh[:, : 2 * hidden])
            z, r = zr[:, :hidden], zr[:, hidden:]
            n = torch.tanh(torch.addcmul(g[:, 2 * hidden :], r, gh[:, 2 * hidden :]))
            h = torch.lerp(n, h, z)                              # (1 − z)·n + z·h
            hs[i] = h
    out = torch.stack(hs, dim=1) if t else xb.new_zeros((xb.shape[0], 0, hidden))
    return out if batched else out[0]


def temporal_scorer_init(seed: int, in_dim: int, hidden: int, n_classes: int = 1) -> dict:
    """The bidirectional GRU scorer's numpy tree in the JAX layout (``fwd``, ``bwd``: ``{"wx", "wh"}``, and
    ``head``), drawn from ``seed`` as ``weights.init_temporal_params`` draws a GRU head (JAX's
    ``temporal_scorer_init`` takes a key; the draws differ)."""
    import numpy as np

    from cvml_goalnet_tpu_torch.weights import _gru, _layer

    rng = np.random.default_rng(seed)
    return {"fwd": _gru(rng, in_dim, hidden), "bwd": _gru(rng, in_dim, hidden),
            "head": _layer(rng, (2 * hidden, n_classes), 2 * hidden)}


def temporal_scorer_apply(params, features: torch.Tensor, hidden: int) -> torch.Tensor:
    """features (T, D) → (T,) event scores, or (T, C) for a C-class head; a leading batch axis passes through."""
    hs = torch.cat([_gru_scan(params["fwd"], features, hidden),
                    _gru_scan(params["bwd"], features, hidden, reverse=True)], dim=-1)
    out = L.linear_apply(params["head"], hs)
    return out[..., 0] if out.shape[-1] == 1 else out


def detect_peaks(scores, window: int = 5, threshold: float = 0.0) -> torch.Tensor:
    """(T,) scores → (T,) bool: a frame is an event iff it is the max of its ±window neighbourhood
    (−inf past the ends) and exceeds ``threshold``."""
    s = torch.as_tensor(scores)
    if s.numel() == 0:
        return torch.zeros(s.shape, dtype=torch.bool, device=s.device)
    neighborhood = F.max_pool1d(s[None, None], 2 * window + 1, 1, padding=window)[0, 0]
    return (s >= neighborhood) & (s > threshold)


def detect_peaks_multi(scores, window: int = 5, threshold: float = 0.0) -> torch.Tensor:
    """(T, C) multi-class scores → (T, C) boolean event masks, one detector per class."""
    s = torch.as_tensor(scores)
    if s.numel() == 0:
        return torch.zeros(s.shape, dtype=torch.bool, device=s.device)
    neighborhood = F.max_pool1d(s.t()[None], 2 * window + 1, 1, padding=window)[0].t()
    return (s >= neighborhood) & (s > threshold)
