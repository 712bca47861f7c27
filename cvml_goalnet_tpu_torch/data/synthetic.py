"""Deterministic synthetic inputs: frames, waveforms and clip intervals.

The port's own copies of the generators in ``cvml_goalnet_tpu/data/synthetic.py``
(same seeds give the same arrays), so ``chip_smoke.py`` and the tests can build
inputs without importing the JAX package.
"""

from __future__ import annotations

import numpy as np


def synthetic_video_frames(
    n_frames: int, h: int = 72, w: int = 96, seed: int = 0
) -> np.ndarray:
    """Deterministic moving-gradient frames (n_frames, h, w, 3) uint8."""
    rng = np.random.default_rng(seed)
    t = np.arange(n_frames)[:, None, None, None]
    yy = np.arange(h)[None, :, None, None]
    xx = np.arange(w)[None, None, :, None]
    c = np.arange(3)[None, None, None, :]
    base = 127.5 + 80 * np.sin(0.1 * t + 0.05 * yy + 0.07 * xx + 2.0 * c)
    noise = rng.normal(0, 8, size=(n_frames, h, w, 3))
    return np.clip(base + noise, 0, 255).astype(np.uint8)


def synthetic_waveform(n_samples: int, sr: int = 22050, seed: int = 0) -> np.ndarray:
    """Deterministic chirp+noise mono waveform in [-1, 1]."""
    rng = np.random.default_rng(seed)
    t = np.arange(n_samples) / sr
    y = 0.5 * np.sin(2 * np.pi * (220 + 40 * t) * t) + 0.05 * rng.standard_normal(n_samples)
    return np.clip(y, -1, 1).astype(np.float32)


def synthetic_change_points(full_n_frames: int, n_clips: int, seed: int = 0) -> np.ndarray:
    """(K, 2) contiguous clip intervals covering [0, full_n_frames)."""
    rng = np.random.default_rng(seed)
    cuts = np.sort(rng.choice(np.arange(1, full_n_frames), size=n_clips - 1, replace=False))
    starts = np.concatenate([[0], cuts])
    ends = np.concatenate([cuts, [full_n_frames]])
    return np.stack([starts, ends], axis=1).astype(np.int64)
