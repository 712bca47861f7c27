"""Per-clip importance sums and lengths from clip intervals.

Port of ``cvml_goalnet_tpu/ops/clips.py`` (reference ``get_clip_information``,
``utils.py:445-464``): one exclusive prefix sum and two gathers, with Python
slice clamping (ends past N clamp to N; a start past its end gives an empty
clip; a negative start clamps to 0).
"""

from __future__ import annotations

import numpy as np
import torch


def clip_stats(intervals: torch.Tensor, importances: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(K, 2) ``[start, end)`` intervals and (N,) importances → (clip sums (K,), clip lengths (K,))."""
    n = importances.shape[0]
    prefix = torch.cat([importances.new_zeros(1), torch.cumsum(importances, 0)])
    start = torch.clamp(intervals[:, 0], 0, n)
    end = torch.clamp(intervals[:, 1], 0, n)
    end = torch.maximum(end, start)
    return prefix[end] - prefix[start], (end - start).to(torch.int32)


def clip_stats_host(intervals: np.ndarray, importances: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """:func:`clip_stats` in NumPy, clip by clip, with the same clamps (a negative start clamps to 0, where a
    Python slice would wrap from the tail)."""
    importances = np.asarray(importances)
    n = len(importances)
    sums, lens = [], []
    for a, b in np.asarray(intervals):
        a = min(max(int(a), 0), n)
        b = max(min(max(int(b), 0), n), a)
        sums.append(importances[a:b].sum())
        lens.append(b - a)
    return np.asarray(sums), np.asarray(lens, dtype=np.int32)
