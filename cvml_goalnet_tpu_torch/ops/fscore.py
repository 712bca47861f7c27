"""Summary-mask F-score against per-annotator ground-truth masks.

Port of ``cvml_goalnet_tpu/ops/fscore.py`` (reference ``get_fscore``,
``utils.py:552-580``): per user precision |S∧G|/|S|, recall |S∧G|/|G| and F1,
with the reference's 0 for empty masks; returns (mean, max) over users.
:func:`fscore_against_users_host` is the NumPy loop of the JAX package's
host mirror, which the training loop's F-scores use.
"""

from __future__ import annotations

import numpy as np
import torch


def fscore_against_users(pred_mask: torch.Tensor, user_masks: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(N,) binary prediction and (U, N) binary user masks → (mean F1, max F1)."""
    S = pred_mask.to(torch.float32)
    G = user_masks.to(torch.float32)
    overlap = (S[None, :] * G).sum(dim=1)
    s_sum = S.sum()
    g_sum = G.sum(dim=1)
    zero = torch.zeros_like(overlap)
    precision = torch.where(s_sum > 0, overlap / torch.clamp(s_sum, min=1.0), zero)
    recall = torch.where(g_sum > 0, overlap / torch.clamp(g_sum, min=1.0), zero)
    denom = precision + recall
    f1 = torch.where(denom > 0, 2.0 * precision * recall / torch.clamp(denom, min=1e-30), zero)
    return f1.mean(), f1.max()


def fscore_against_users_host(pred_mask: np.ndarray, user_masks: np.ndarray) -> tuple[float, float]:
    """NumPy loop over users, as the reference's: (mean F1, max F1) as Python floats."""
    S = np.asarray(pred_mask)
    fs = []
    for G in np.asarray(user_masks):
        overlap = np.logical_and(S, G).sum()
        p = overlap / S.sum() if S.sum() != 0 else 0.0
        r = overlap / G.sum() if G.sum() != 0 else 0.0
        fs.append(2 * p * r / (p + r) if (p + r) != 0 else 0.0)
    return float(np.mean(fs)), float(np.max(fs))
