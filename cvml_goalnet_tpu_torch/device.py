"""Device choice and float32 numerics for the port's entry points.

Entry points run on the card unless the caller asks for the CPU with
``device="cpu"``.  With no card and no explicit device they raise: a run that
silently continued on the CPU would report CPU numbers under a GPU's name.
"""

from __future__ import annotations

import contextlib
import threading

import torch


def resolve_device(device: str | torch.device | None) -> torch.device:
    """``None`` → ``cuda`` (raises without a card); anything else as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the card by default; pass "
                "device='cpu' to run the plain PyTorch path on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


_strict_lock = threading.Lock()
_strict_depth = 0          # scopes of strict_f32 open in any thread
_strict_saved = (False, False)


@contextlib.contextmanager
def strict_f32():
    """Full-float32 matmuls and convolutions on the card (TF32 off), restored on exit.

    cuDNN runs float32 convolutions in TF32 by default, which keeps about three
    decimal digits; the port holds its float32 results to the JAX package at
    1e-4, so every library convolution and product of the port runs inside
    this scope.  The flags are global, so the scope counts its holders across
    threads: the first in saves them and turns TF32 off, the last out restores
    them, and while any thread is inside both stay off.
    """
    global _strict_depth, _strict_saved
    with _strict_lock:
        if _strict_depth == 0:
            _strict_saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        _strict_depth += 1
    try:
        yield
    finally:
        with _strict_lock:
            _strict_depth -= 1
            if _strict_depth == 0:
                torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = _strict_saved
