"""Frame preprocessing: per-frame min-max normalisation + bilinear resize.

Port of ``cvml_goalnet_tpu/ops/preprocess.py``.  The contract is the
reference's normalise-then-resize (``utils.py:283-292``): each frame is
min-max normalised over ALL pixels and channels jointly, then resized with
cv2/INTER_LINEAR's half-pixel, edge-clamped taps.  Bilinear rows sum to one,
so the port computes it as resize-then-normalise, ``(resize(f) − lo) / (hi −
lo + eps)``, exactly as the JAX ``preprocess_frames`` does; min and max come
from the raw (uint8) frame.

On the card :func:`preprocess_frames` is one launch of the hand-written kernel
(``ops/cuda/fused_preprocess.py``); on the CPU it is that kernel's plain
version.  :func:`preprocess_frames_host` is the host mirror (cv2, else NumPy).
The two halves of the contract apart, :func:`normalize_frames` and
:func:`resize_bilinear`, are plain PyTorch, as JAX computes them in XLA.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from cvml_goalnet_tpu_torch.device import strict_f32
from cvml_goalnet_tpu_torch.ops.cuda.fused_preprocess import fused_preprocess_frames


@lru_cache(maxsize=64)
def resize_taps(src: int, dst: int) -> tuple[np.ndarray, np.ndarray]:
    """One bilinear axis as two taps per output: ((2, dst) int32 indices, (2, dst) f32 weights).

    Half-pixel source coordinate ``x = (i + 0.5)·src/dst − 0.5``, clipped to
    ``[0, src − 1]``; taps ``floor(x)`` and ``min(floor(x) + 1, src − 1)`` with
    weights ``1 − frac`` and ``frac``.
    """
    x = (np.arange(dst) + 0.5) * (src / dst) - 0.5
    x = np.clip(x, 0.0, src - 1.0)
    lo = np.floor(x).astype(np.int64)
    hi = np.minimum(lo + 1, src - 1)
    frac = x - lo
    idx = np.stack([lo, hi]).astype(np.int32)
    wts = np.stack([1.0 - frac, frac]).astype(np.float32)
    return idx, wts


@lru_cache(maxsize=64)
def resize_matrices(src_h: int, src_w: int, dst_h: int, dst_w: int) -> tuple[np.ndarray, np.ndarray]:
    """Bilinear interpolation matrices (dst_h, src_h) and (dst_w, src_w) from :func:`resize_taps`."""

    def axis_matrix(src: int, dst: int) -> np.ndarray:
        idx, wts = resize_taps(src, dst)
        m = np.zeros((dst, src), dtype=np.float32)
        rows = np.arange(dst)
        np.add.at(m, (rows, idx[0]), wts[0])
        np.add.at(m, (rows, idx[1]), wts[1])
        return m

    return axis_matrix(src_h, dst_h), axis_matrix(src_w, dst_w)


@lru_cache(maxsize=64)
def resize_taps_on(src: int, dst: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`resize_taps` as tensors on ``device``, made once per (src, dst, device)."""
    idx, wts = resize_taps(src, dst)
    return torch.as_tensor(idx, device=device), torch.as_tensor(wts, device=device)


def preprocess_frames(
    frames: torch.Tensor, out_hw: tuple[int, int] = (40, 40), eps: float = 1e-7
) -> torch.Tensor:
    """(N, H, W, C) uint8 or float32 frames → (N, h, w, C) float32, on the frames' device."""
    _, h, w, _ = frames.shape
    dev = frames.device
    return fused_preprocess_frames(frames, resize_taps_on(h, out_hw[0], dev), resize_taps_on(w, out_hw[1], dev), eps)


def normalize_frames(frames: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Per-frame joint min-max normalisation over (H, W, C) of (N, H, W, C) frames → float32 (reference
    ``utils.py:284``)."""
    f = frames.to(torch.float32)
    lo = f.amin(dim=(1, 2, 3), keepdim=True)
    hi = f.amax(dim=(1, 2, 3), keepdim=True)
    return (f - lo) / (hi - lo + eps)


def resize_bilinear(frames: torch.Tensor, out_hw: tuple[int, int], compute_dtype=torch.float32) -> torch.Tensor:
    """Bilinear resize of (N, H, W, C) → (N, out_h, out_w, C) float32 by two contractions with
    :func:`resize_matrices`: the operands in ``compute_dtype`` (bf16 for JAX's MXU path), float32 sums, the
    first product rounded to ``compute_dtype`` between them, as JAX's ``preferred_element_type`` does."""
    _, h, w, _ = frames.shape
    rh, rw = (torch.as_tensor(m, device=frames.device).to(compute_dtype).to(torch.float32)
              for m in resize_matrices(h, w, *out_hw))
    with strict_f32():
        x = torch.einsum("ah,nhwc->nawc", rh, frames.to(compute_dtype).to(torch.float32))
        return torch.einsum("bw,nawc->nabc", rw, x.to(compute_dtype).to(torch.float32))


def preprocess_frames_host(
    frames: np.ndarray, out_hw: tuple[int, int] = (40, 40), eps: float = 1e-7
) -> np.ndarray:
    """NumPy mirror of :func:`preprocess_frames` (resize then normalise), as the JAX package's host mirror:
    ``cv2.resize`` (INTER_LINEAR, the same taps) frame by frame where cv2 imports, on 8 threads from 64 frames
    (cv2 releases the GIL), else two BLAS products with :func:`resize_matrices`.  Both give the JAX package's
    values bit for bit."""
    frames = np.asarray(frames)
    n, h, w, c = frames.shape
    lo = frames.min(axis=(1, 2, 3)).astype(np.float32)
    hi = frames.max(axis=(1, 2, 3)).astype(np.float32)
    small = np.empty((n, *out_hw, c), np.float32)
    try:
        import cv2

        def one(i):
            r = cv2.resize(frames[i].astype(np.float32), (out_hw[1], out_hw[0]), interpolation=cv2.INTER_LINEAR)
            small[i] = r[..., None] if r.ndim == 2 else r   # cv2 drops the channel axis when C = 1

        if n >= 64:
            import os
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
                list(pool.map(one, range(n)))
        else:
            for i in range(n):
                one(i)
    except ImportError:
        rh, rw = resize_matrices(h, w, *out_hw)
        x = np.matmul(rh, frames.astype(np.float32).reshape(n, h, w * c))
        x = x.reshape(n, out_hw[0], w, c).transpose(0, 1, 3, 2)
        small = np.ascontiguousarray(np.matmul(x, rw.T).transpose(0, 1, 3, 2))
    scale = (hi - lo + eps)[:, None, None, None]
    return ((small - lo[:, None, None, None]) / scale).astype(np.float32)
