"""Flash-attention forwards, full and banded: CUDA kernels, their plain versions and the public functions.

Counterpart of ``cvml_goalnet_tpu/ops/pallas/flash_attention.py`` (forward
only; the backward kernels come with the training path).  q, k and v are
(H, T, d) float32 as in the JAX package.

* :func:`flash_fwd` (``_flash_fwd``) and :func:`flash_local_fwd`
  (``_flash_local_fwd``) are the kernel wrappers; each returns ``(out, lse)``
  with ``lse`` (H, Tq) float32, a row's log-sum-exp of its scaled scores.  A
  CPU tensor takes the plain version beside it; a CUDA tensor launches the
  kernel (``csrc/flash_attention.cu``) or raises.
* :func:`flash_attention`, :func:`flash_attention_with_lse`,
  :func:`flash_attention_local` and :func:`flash_attention_local_bounded`
  keep the JAX names and return values.

Masking, in both kernel and plain version: keys at ``j >= t_valid``
(``t_valid`` clamped to [0, Tk]) for the full form; outside
``|i + q_offset − j| ≤ window`` or outside ``[lo, hi)`` for the banded form.
A row with no valid key gives out 0 and lse 0, as the TPU kernels do.
"""

from __future__ import annotations

import ctypes
import math

import torch

from cvml_goalnet_tpu_torch.device import strict_f32
from cvml_goalnet_tpu_torch.ops.cuda import _build

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "flash_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P],
    "flash_local_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _I, _I, _P],
}
HEAD_DIMS = (32, 64, 128)  # the head widths the kernels are built for


def _default_scale(q: torch.Tensor, scale: float | None) -> float:
    return 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)


def _masked_attention(q, k, v, scale: float, valid: torch.Tensor):
    """Softmax attention over the keys ``valid`` marks (broadcast to (H, Tq, Tk)) → (out, lse)."""
    with strict_f32():
        s = torch.matmul(q, k.transpose(1, 2)) * scale
    s = s.masked_fill(~valid, float("-inf"))
    lse = torch.logsumexp(s, dim=-1)
    dead = torch.isneginf(lse)
    p = torch.softmax(s, dim=-1).masked_fill(dead[..., None], 0.0)  # dead rows: NaN → 0
    with strict_f32():
        out = torch.matmul(p, v)
    return out, lse.masked_fill(dead, 0.0)


def flash_fwd_plain(q, k, v, scale: float, t_valid=None):
    """The full forward in plain PyTorch: the whole (H, Tq, Tk) score matrix at once."""
    tk = k.shape[1]
    tv = tk if t_valid is None else min(max(int(t_valid), 0), tk)
    valid = (torch.arange(tk, device=q.device) < tv)[None, None, :]
    return _masked_attention(q, k, v, scale, valid)


def flash_local_fwd_plain(q, k, v, scale: float, window: int, lo=None, hi=None, q_offset: int = 0):
    """The banded forward in plain PyTorch: the full score matrix under the band and bounds mask."""
    tq, tk = q.shape[1], k.shape[1]
    lo = 0 if lo is None else int(lo)
    hi = tk if hi is None else int(hi)
    i = torch.arange(tq, device=q.device) + q_offset
    j = torch.arange(tk, device=q.device)
    valid = ((i[:, None] - j[None, :]).abs() <= window) & (j >= lo)[None, :] & (j < hi)[None, :]
    return _masked_attention(q, k, v, scale, valid[None])


def _check_qkv(what: str, q, k, v) -> None:
    if q.dim() != 3 or k.dim() != 3 or v.shape != k.shape or q.shape[0] != k.shape[0] or q.shape[2] != k.shape[2]:
        raise ValueError(
            f"{what}: q (H, Tq, d) and k, v (H, Tk, d) expected, got q {tuple(q.shape)}, "
            f"k {tuple(k.shape)}, v {tuple(v.shape)}"
        )


def _launch(entry: str, q, k, v, *args) -> tuple[torch.Tensor, torch.Tensor]:
    """Check what the kernels take, allocate out and lse, launch ``entry``."""
    h, tq, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"{entry}: the kernel is built for head dims {HEAD_DIMS}, got {d}")
    _build.require_f32(entry, q.device, q=q, k=k, v=v)
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError(f"{entry}: q, k and v must start on 16-byte boundaries")
    out = torch.empty_like(q)
    lse = torch.empty((h, tq), dtype=torch.float32, device=q.device)
    if h * tq == 0:
        return out, lse
    lib = _build.load("flash_attention", _SIGNATURES)
    code = getattr(lib, entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(), h, tq, k.shape[1], d, *args,
        _build.stream_of(q),
    )
    _build.check(lib, code, entry)
    return out, lse


def flash_fwd(q, k, v, scale: float, t_valid=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Full attention of q (H, Tq, d) over k, v (H, Tk, d), keys valid below ``t_valid`` → (out, lse)."""
    _check_qkv("flash_fwd", q, k, v)
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, scale, t_valid)
    if q.device.type != "cuda":
        raise ValueError(f"flash_fwd: unsupported device {q.device}")
    tk = k.shape[1]
    tv = tk if t_valid is None else min(max(int(t_valid), 0), tk)
    res = _launch("flash_fwd", q, k, v, float(scale), tv)
    flash_fwd.launches += 1
    return res


flash_fwd.launches = 0


def flash_local_fwd(q, k, v, scale: float, window: int, lo=None, hi=None,
                    q_offset: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """Banded attention ``|i + q_offset − j| ≤ window``, keys valid in ``[lo, hi)`` → (out, lse).

    Tq and Tk may differ; ``lo``/``hi`` default to 0 and Tk.
    """
    _check_qkv("flash_local_fwd", q, k, v)
    if window < 0:
        raise ValueError(f"flash_local_fwd: window must be ≥ 0, got {window}")
    if q.device.type == "cpu":
        return flash_local_fwd_plain(q, k, v, scale, window, lo, hi, q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_local_fwd: unsupported device {q.device}")
    tq, tk = q.shape[1], k.shape[1]
    lo = 0 if lo is None else int(lo)
    hi = tk if hi is None else int(hi)
    # a window past every (row, key) distance is full attention; the cap keeps the kernel's arithmetic in int
    window = min(int(window), tq + tk + abs(int(q_offset)))
    res = _launch("flash_local_fwd", q, k, v, float(scale), window, lo, hi, int(q_offset))
    flash_local_fwd.launches += 1
    return res


flash_local_fwd.launches = 0


def flash_attention(q, k, v, scale: float | None = None) -> torch.Tensor:
    """Full (non-causal) attention: q (H, Tq, d) × k, v (H, Tk, d) → (H, Tq, d)."""
    return flash_fwd(q, k, v, _default_scale(q, scale))[0]


def flash_attention_with_lse(q, k, v, t_valid) -> tuple[torch.Tensor, torch.Tensor]:
    """Full attention with keys valid below ``t_valid`` → (out (H, Tq, d), lse (H, Tq, 1))."""
    out, lse = flash_fwd(q, k, v, _default_scale(q, None), t_valid)
    return out, lse[..., None]


def flash_attention_local(q, k, v, window: int, scale: float | None = None) -> torch.Tensor:
    """Sliding-window self-attention ``|i − j| ≤ window``; q, k, v (H, T, d) with one T."""
    if k.shape[1] != q.shape[1]:
        raise ValueError(f"flash_attention_local is a self-attention band: Tq={q.shape[1]} != Tk={k.shape[1]}")
    return flash_local_fwd(q, k, v, _default_scale(q, scale), window)[0]


def flash_attention_local_bounded(q, k, v, lo, hi, window: int, q_offset: int = 0) -> torch.Tensor:
    """Banded attention ``|(i + q_offset) − j| ≤ window`` with keys valid in ``[lo, hi)``; Tq and Tk may differ."""
    return flash_local_fwd(q, k, v, _default_scale(q, None), window, lo, hi, q_offset)[0]
