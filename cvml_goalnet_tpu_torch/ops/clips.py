"""Per-clip importance sums and lengths from clip intervals.

Port of ``cvml_goalnet_tpu/ops/clips.py`` (reference ``get_clip_information``,
``utils.py:445-464``): one exclusive prefix sum and two gathers, with Python
slice clamping (ends past N clamp to N; a start past its end gives an empty
clip; a negative start clamps to 0).
"""

from __future__ import annotations

import torch


def clip_stats(intervals: torch.Tensor, importances: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(K, 2) ``[start, end)`` intervals and (N,) importances → (clip sums (K,), clip lengths (K,))."""
    n = importances.shape[0]
    prefix = torch.cat([importances.new_zeros(1), torch.cumsum(importances, 0)])
    start = torch.clamp(intervals[:, 0], 0, n)
    end = torch.clamp(intervals[:, 1], 0, n)
    end = torch.maximum(end, start)
    return prefix[end] - prefix[start], (end - start).to(torch.int32)
