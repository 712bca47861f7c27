"""Flash attention, full and banded: CUDA kernels, their plain versions and the differentiable public functions.

Counterpart of ``cvml_goalnet_tpu/ops/pallas/flash_attention.py``.  q, k and
v are (H, T, d) float32 as in the JAX package.

* :func:`flash_fwd` (``_flash_fwd``) and :func:`flash_local_fwd`
  (``_flash_local_fwd``) are the forward kernel wrappers; each returns
  ``(out, lse)`` with ``lse`` (H, Tq) float32, a row's log-sum-exp of its
  scaled scores.
* :func:`flash_bwd` (``_flash_bwd``) and :func:`flash_local_bwd`
  (``_flash_local_bwd``) are the backward kernel wrappers: ``(dq, dk, dv)``
  from q, k, v, the forward's out and lse, the cotangent of out and, for the
  full form, that of lse (``di = rowsum(dout·out) − g_lse``, torch ops before
  the launch, as XLA outside Pallas in the JAX package).
* A CPU tensor takes each wrapper's plain version; a CUDA tensor launches the
  kernel (``csrc/flash_attention.cu``) or raises.  The forward wrappers keep
  no graph: called on CUDA tensors that require grad with grad mode on, they
  raise rather than cut the gradient.
* :func:`flash_attention` (also under the JAX name
  :func:`flash_attention_trainable`), :func:`flash_attention_with_lse`,
  :func:`flash_attention_local` and :func:`flash_attention_local_bounded`
  keep the JAX names and return values, and are differentiable on both
  devices: ``torch.autograd.Function`` s whose forward is the forward wrapper
  and whose backward is the backward wrapper, saving ``q, k, v, out, lse``.
  ``t_valid``, ``lo``, ``hi``, ``window`` and ``q_offset`` get no gradient, as
  the JAX VJPs return zeros for them.

Masking, in kernels and plain versions alike: keys at ``j >= t_valid``
(``t_valid`` clamped to [0, Tk]) for the full form; outside
``|i + q_offset − j| ≤ window`` or outside ``[lo, hi)`` for the banded form.
A row with no valid key gives out 0 and lse 0, as the TPU kernels do; in the
backward its probabilities are exactly 0, so it gets dq = 0 and adds nothing
to dk and dv.
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
    "flash_bwd": [_P] * 9 + [_I, _I, _I, _I, _F, _I, _P],
    "flash_local_bwd": [_P] * 9 + [_I, _I, _I, _I, _F, _I, _I, _I, _I, _P],
}
HEAD_DIMS = (32, 64, 128)  # the head widths the kernels are built for


def _default_scale(q: torch.Tensor, scale: float | None) -> float:
    return 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)


def _t_valid(tk: int, t_valid) -> int:
    return tk if t_valid is None else min(max(int(t_valid), 0), tk)


def _full_valid(q, k, t_valid) -> torch.Tensor:
    """(1, 1, Tk) mask of the keys below ``t_valid``."""
    tk = k.shape[1]
    return (torch.arange(tk, device=q.device) < _t_valid(tk, t_valid))[None, None, :]


def _band_valid(q, k, window: int, lo, hi, q_offset: int) -> torch.Tensor:
    """(1, Tq, Tk) mask of ``|i + q_offset − j| ≤ window`` with keys in ``[lo, hi)``."""
    tq, tk = q.shape[1], k.shape[1]
    lo = 0 if lo is None else int(lo)
    hi = tk if hi is None else int(hi)
    i = torch.arange(tq, device=q.device) + q_offset
    j = torch.arange(tk, device=q.device)
    return (((i[:, None] - j[None, :]).abs() <= window) & (j >= lo)[None, :] & (j < hi)[None, :])[None]


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


def _masked_attention_bwd(q, k, v, lse, dout, di, scale: float, valid: torch.Tensor):
    """The kernels' backward in whole matrices: P from lse, exactly 0 where masked, then dq, dk, dv."""
    with strict_f32():
        s = torch.matmul(q, k.transpose(1, 2)) * scale
    p = torch.where(valid, torch.exp(s - lse[..., None]), 0.0)
    with strict_f32():
        dv = torch.matmul(p.transpose(1, 2), dout)
        dp = torch.matmul(dout, v.transpose(1, 2))
    ds = p * (dp - di[..., None])
    with strict_f32():
        dq = torch.matmul(ds, k) * scale
        dk = torch.matmul(ds.transpose(1, 2), q) * scale
    return dq, dk, dv


def _di(out, dout, g_lse) -> torch.Tensor:
    """rowsum(dout·out) − g_lse: the lse cotangent folds into ``ds = p·(dp − di)`` since ∂lse/∂s = p."""
    di = (dout * out).sum(-1)
    return di if g_lse is None else di - g_lse


def flash_fwd_plain(q, k, v, scale: float, t_valid=None):
    """The full forward in plain PyTorch: the whole (H, Tq, Tk) score matrix at once."""
    return _masked_attention(q, k, v, scale, _full_valid(q, k, t_valid))


def flash_local_fwd_plain(q, k, v, scale: float, window: int, lo=None, hi=None, q_offset: int = 0):
    """The banded forward in plain PyTorch: the full score matrix under the band and bounds mask."""
    return _masked_attention(q, k, v, scale, _band_valid(q, k, window, lo, hi, q_offset))


def flash_bwd_plain(q, k, v, out, lse, dout, scale: float, t_valid=None, g_lse=None):
    """The full backward in plain PyTorch → (dq, dk, dv)."""
    return _masked_attention_bwd(q, k, v, lse, dout, _di(out, dout, g_lse), scale, _full_valid(q, k, t_valid))


def flash_local_bwd_plain(q, k, v, out, lse, dout, scale: float, window: int, lo=None, hi=None,
                          q_offset: int = 0):
    """The banded backward in plain PyTorch → (dq, dk, dv)."""
    return _masked_attention_bwd(q, k, v, lse, dout, _di(out, dout, None), scale,
                                 _band_valid(q, k, window, lo, hi, q_offset))


def _check_qkv(what: str, q, k, v) -> None:
    if q.dim() != 3 or k.dim() != 3 or v.shape != k.shape or q.shape[0] != k.shape[0] or q.shape[2] != k.shape[2]:
        raise ValueError(
            f"{what}: q (H, Tq, d) and k, v (H, Tk, d) expected, got q {tuple(q.shape)}, "
            f"k {tuple(k.shape)}, v {tuple(v.shape)}"
        )


def _check_device(what: str, q) -> bool:
    """True for a CPU tensor (the plain version), False for CUDA (the kernel); raises for anything else."""
    if q.device.type == "cpu":
        return True
    if q.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {q.device}")
    return False


def _check_kernel_inputs(what: str, q, k, v, **more) -> None:
    if q.shape[2] not in HEAD_DIMS:
        raise ValueError(f"{what}: the kernel is built for head dims {HEAD_DIMS}, got {q.shape[2]}")
    _build.require_f32(what, q.device, q=q, k=k, v=v, **more)
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError(f"{what}: q, k and v must start on 16-byte boundaries")


def _launch(entry: str, q, k, v, *args) -> tuple[torch.Tensor, torch.Tensor]:
    """Check what the forward kernels take, allocate out and lse, launch ``entry``."""
    _build.refuse_grad(entry, q, k, v)
    _check_kernel_inputs(entry, q, k, v)
    h, tq, d = q.shape
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


def _launch_bwd(entry: str, q, k, v, out, lse, dout, g_lse, *args) -> tuple[torch.Tensor, ...]:
    """Compute di, check what the backward kernels take, allocate dq, dk, dv, launch ``entry`` (two kernels)."""
    dout = dout.contiguous()
    di = _di(out, dout, g_lse).contiguous()
    _check_kernel_inputs(entry, q, k, v, dout=dout, lse=lse, di=di)
    if lse.shape != q.shape[:2] or di.shape != q.shape[:2] or dout.shape != q.shape:
        raise ValueError(f"{entry}: lse {tuple(lse.shape)}, dout {tuple(dout.shape)} do not match q {tuple(q.shape)}")
    h, tq, d = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    lib = _build.load("flash_attention", _SIGNATURES)
    code = getattr(lib, entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(), di.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), h, tq, k.shape[1], d, *args, _build.stream_of(q),
    )
    _build.check(lib, code, entry)
    return dq, dk, dv


def _band_args(q, k, window: int, lo, hi, q_offset: int) -> tuple[int, int, int, int]:
    """(window, lo, hi, q_offset) as the banded kernels take them."""
    tq, tk = q.shape[1], k.shape[1]
    lo = 0 if lo is None else int(lo)
    hi = tk if hi is None else int(hi)
    # a window past every (row, key) distance is full attention; the cap keeps the kernel's arithmetic in int
    return min(int(window), tq + tk + abs(int(q_offset))), lo, hi, int(q_offset)


def flash_fwd(q, k, v, scale: float, t_valid=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Full attention of q (H, Tq, d) over k, v (H, Tk, d), keys valid below ``t_valid`` → (out, lse)."""
    _check_qkv("flash_fwd", q, k, v)
    if _check_device("flash_fwd", q):
        return flash_fwd_plain(q, k, v, scale, t_valid)
    res = _launch("flash_fwd", q, k, v, float(scale), _t_valid(k.shape[1], t_valid))
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
    if _check_device("flash_local_fwd", q):
        return flash_local_fwd_plain(q, k, v, scale, window, lo, hi, q_offset)
    res = _launch("flash_local_fwd", q, k, v, float(scale), *_band_args(q, k, window, lo, hi, q_offset))
    flash_local_fwd.launches += 1
    return res


flash_local_fwd.launches = 0


def flash_bwd(q, k, v, out, lse, dout, scale: float, t_valid=None, g_lse=None) -> tuple[torch.Tensor, ...]:
    """Gradients (dq, dk, dv) of full attention, from the forward's (out, lse (H, Tq)) and the cotangents
    ``dout`` (H, Tq, d) of out and ``g_lse`` (H, Tq) of lse (None: 0)."""
    _check_qkv("flash_bwd", q, k, v)
    if _check_device("flash_bwd", q):
        return flash_bwd_plain(q, k, v, out, lse, dout, scale, t_valid, g_lse)
    res = _launch_bwd("flash_bwd", q, k, v, out, lse, dout, g_lse, float(scale), _t_valid(k.shape[1], t_valid))
    flash_bwd.launches += 1
    return res


flash_bwd.launches = 0


def flash_local_bwd(q, k, v, out, lse, dout, scale: float, window: int, lo=None, hi=None,
                    q_offset: int = 0) -> tuple[torch.Tensor, ...]:
    """Gradients (dq, dk, dv) of banded attention, from the forward's (out, lse) and the cotangent ``dout``."""
    _check_qkv("flash_local_bwd", q, k, v)
    if window < 0:
        raise ValueError(f"flash_local_bwd: window must be ≥ 0, got {window}")
    if _check_device("flash_local_bwd", q):
        return flash_local_bwd_plain(q, k, v, out, lse, dout, scale, window, lo, hi, q_offset)
    res = _launch_bwd("flash_local_bwd", q, k, v, out, lse, dout, None, float(scale),
                      *_band_args(q, k, window, lo, hi, q_offset))
    flash_local_bwd.launches += 1
    return res


flash_local_bwd.launches = 0


class _FullAttention(torch.autograd.Function):
    """(out, lse) of :func:`flash_fwd`, differentiable in q, k, v through :func:`flash_bwd`."""

    @staticmethod
    def forward(ctx, q, k, v, scale, t_valid):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, lse = flash_fwd(q, k, v, scale, t_valid)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale, ctx.t_valid = scale, t_valid
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, g_out, g_lse):
        q, k, v, out, lse = ctx.saved_tensors
        if g_out is None:
            g_out = torch.zeros_like(out)
        dq, dk, dv = flash_bwd(q, k, v, out, lse, g_out, ctx.scale, ctx.t_valid, g_lse)
        return dq, dk, dv, None, None


class _BandedAttention(torch.autograd.Function):
    """out of :func:`flash_local_fwd`, differentiable in q, k, v through :func:`flash_local_bwd`."""

    @staticmethod
    def forward(ctx, q, k, v, scale, window, lo, hi, q_offset):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, lse = flash_local_fwd(q, k, v, scale, window, lo, hi, q_offset)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.band = (scale, window, lo, hi, q_offset)
        return out

    @staticmethod
    def backward(ctx, g_out):
        q, k, v, out, lse = ctx.saved_tensors
        scale, window, lo, hi, q_offset = ctx.band
        dq, dk, dv = flash_local_bwd(q, k, v, out, lse, g_out, scale, window, lo, hi, q_offset)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q, k, v, scale: float | None = None) -> torch.Tensor:
    """Full (non-causal) attention: q (H, Tq, d) × k, v (H, Tk, d) → (H, Tq, d), differentiable."""
    return _FullAttention.apply(q, k, v, _default_scale(q, scale), None)[0]


flash_attention_trainable = flash_attention  # the JAX package's name for the differentiable form


def flash_attention_with_lse(q, k, v, t_valid) -> tuple[torch.Tensor, torch.Tensor]:
    """Full attention with keys valid below ``t_valid`` → (out (H, Tq, d), lse (H, Tq, 1)), both differentiable."""
    out, lse = _FullAttention.apply(q, k, v, _default_scale(q, None), t_valid)
    return out, lse[..., None]


def flash_attention_local(q, k, v, window: int, scale: float | None = None) -> torch.Tensor:
    """Sliding-window self-attention ``|i − j| ≤ window``; q, k, v (H, T, d) with one T."""
    if k.shape[1] != q.shape[1]:
        raise ValueError(f"flash_attention_local is a self-attention band: Tq={q.shape[1]} != Tk={k.shape[1]}")
    return _BandedAttention.apply(q, k, v, _default_scale(q, scale), window, None, None, 0)


def flash_attention_local_bounded(q, k, v, lo, hi, window: int, q_offset: int = 0) -> torch.Tensor:
    """Banded attention ``|(i + q_offset) − j| ≤ window`` with keys valid in ``[lo, hi)``; Tq and Tk may differ."""
    return _BandedAttention.apply(q, k, v, _default_scale(q, None), window, int(lo), int(hi), q_offset)
