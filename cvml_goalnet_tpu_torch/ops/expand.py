"""Importance-score expansion from condensed (decimated) to raw frame rate.

Port of ``cvml_goalnet_tpu/ops/expand.py`` (reference ``expand_array``,
``utils.py:396-410``): ``expanded[i] = scores[min(i // skip, n − 1)]``, and the
scores back unchanged when they are already at the raw length.
"""

from __future__ import annotations

import numpy as np
import torch


def expand_scores(scores: torch.Tensor, skip_frames: int, full_n_frames: int) -> torch.Tensor:
    """Expand (n,) condensed scores to (full_n_frames,) raw-rate scores, on their device."""
    scores = scores.reshape(-1)
    n = scores.shape[0]
    if n == full_n_frames:
        return scores
    idx = torch.clamp(torch.arange(full_n_frames, device=scores.device) // skip_frames, max=n - 1)
    return scores[idx]


def expand_scores_host(scores: np.ndarray, skip_frames: int, full_n_frames: int) -> np.ndarray:
    """The same gather in NumPy: a copy of the scores when they are already at the raw length."""
    scores = np.asarray(scores).reshape(-1)
    if scores.shape[0] == full_n_frames:
        return scores.copy()
    return scores[np.minimum(np.arange(full_n_frames) // skip_frames, scores.shape[0] - 1)]
