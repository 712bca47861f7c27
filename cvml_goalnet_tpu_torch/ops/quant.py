"""Int8 quantization of the eval forward: symmetric scales, int8 values, exact int32 products.

Port of ``cvml_goalnet_tpu/ops/quant.py``, with its semantics kept to the bit:
scales ``max(amax / 127, 1e-12)`` in float32 (per output channel for weights,
one per tensor for activations), values ``clip(round(x / s), −127, 127)``
(a division, and rounding half to even, as ``jnp.round`` and
``torch.round`` do), and dequantization ``acc_f32 · (s_x · s_w)`` with the
scale product formed first, then a cast to the activation dtype.

On the reference backbone these are the plain versions: on the card conv1
and conv2 take the int8 form of kernel 2
(``ops/cuda/fused_stage.py::fused_conv_pool_stage_int8``), which computes
the scales and quantizes the activations and the weights in kernels and
sums in int32 on the tensor cores.  The resnet and vit backbones' int8
paths run these functions themselves (the JAX package computes them in XLA,
with no Pallas kernel): on a CUDA tensor :func:`conv2d_int8` and
:func:`quantized_linear` sum in int32 through cuBLAS's int8 GEMM
(``torch._int_mm``, over an im2col of the int8 activations for the
convolution); on the CPU they sum in float64, which is as exact: a sum of at
most 2^53 / 127² products (float32 is not: conv2's K = 2304 sums reach
2304 · 127² > 2^24).

Where JAX runs a data-parallel batch as one GSPMD program, each activation
scale is the whole batch's.  The port runs a block of the batch on each
device, each in a thread of its own inside :func:`batch_scales`: there every
activation scale (:func:`act_scale`, and the 2-int8 kernel's on the card)
goes through the block's ``reduce``, which hands back the largest scale of
all blocks at that point.  ``max(amax / 127, 1e-12)`` grows with ``amax``, so
that is the scale of the batch's ``amax``.
"""

from __future__ import annotations

import contextlib
import threading

import torch
import torch.nn.functional as F

_SHARED = threading.local()


@contextlib.contextmanager
def batch_scales(reduce):
    """On this thread, pass every activation scale through ``reduce(s) -> s`` (a float32 scalar on ``s``'s
    device) until the block ends."""
    prev = getattr(_SHARED, "reduce", None)
    _SHARED.reduce = reduce
    try:
        yield
    finally:
        _SHARED.reduce = prev


def sharing_scales() -> bool:
    """Whether this thread is inside :func:`batch_scales`."""
    return getattr(_SHARED, "reduce", None) is not None


def shared_scale(s: torch.Tensor) -> torch.Tensor:
    """``s`` as this thread's :func:`batch_scales` reduces it (``s`` itself outside one)."""
    reduce = getattr(_SHARED, "reduce", None)
    return s if reduce is None else reduce(s)


def amax_scale(amax: torch.Tensor) -> torch.Tensor:
    """``max(amax / 127, 1e-12)`` in float32, the quotient correctly rounded on every device: PyTorch divides a
    CUDA tensor by a Python scalar as a product with the scalar's reciprocal, one bit off the quotient that the
    JAX package and the CPU give, so the divisor is a tensor on ``amax``'s device."""
    return torch.clamp_min(amax / amax.new_full((), 127.0), 1e-12)


def quantize_weights_per_channel(w: torch.Tensor, axis: int = -1) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 per-channel quantization → ``(w_q int8, scales float32)``; ``scales`` keeps ``w``'s rank
    with size 1 everywhere but ``axis``."""
    axis %= w.dim()
    dims = tuple(i for i in range(w.dim()) if i != axis)
    wf = w.to(torch.float32)
    s = amax_scale(wf.abs().amax(dim=dims, keepdim=True))
    return torch.clamp(torch.round(wf / s), -127, 127).to(torch.int8), s


def act_scale(x: torch.Tensor) -> torch.Tensor:
    """The per-tensor activation scale ``max(max|x| / 127, 1e-12)``, a float32 scalar on ``x``'s device (the
    batch's inside :func:`batch_scales`)."""
    return shared_scale(amax_scale(x.abs().amax().to(torch.float32)))


def quantize_act_per_tensor(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Dynamic symmetric int8 per-tensor quantization → ``(x_q int8, scale float32 scalar)``."""
    s = act_scale(x)
    return torch.clamp(torch.round(x.to(torch.float32) / s), -127, 127).to(torch.int8), s


def _pad_to(t: torch.Tensor, dim: int, size: int) -> torch.Tensor:
    """``t`` zero-padded at the end of ``dim`` to ``size`` (itself when already that long)."""
    if t.shape[dim] >= size:
        return t
    pad = [0, 0] * (t.dim() - 1 - dim) + [0, size - t.shape[dim]]
    return F.pad(t, pad)


def int8_matmul(a_q: torch.Tensor, b_q: torch.Tensor) -> torch.Tensor:
    """int8 (M, K) × int8 (K, N) → the exact int32 (M, N) product: ``torch._int_mm`` (cuBLAS's int8 GEMM) on a
    CUDA tensor, a float64 product on the CPU.

    ``torch._int_mm`` takes more than 16 rows and K and N each a multiple of 8, so the operands are
    zero-padded to that (zero rows and columns add nothing to the sums) and the product is cut back."""
    m, k = a_q.shape
    n = b_q.shape[1]
    if a_q.device.type != "cuda":
        return torch.matmul(a_q.to(torch.float64), b_q.to(torch.float64)).to(torch.int32)
    kp, np_ = -(-k // 8) * 8, -(-n // 8) * 8
    a = _pad_to(_pad_to(a_q, 1, kp), 0, max(m, 17)).contiguous()
    b = _pad_to(_pad_to(b_q, 0, kp), 1, np_).contiguous()
    return torch._int_mm(a, b)[:m, :n]


def _im2col(x_q: torch.Tensor, kh: int, kw: int, stride: int, padding: int) -> torch.Tensor:
    """NHWC (N, H, W, C) → (N, Ho, Wo, kh·kw·C) patches in HWIO's (kh, kw, C) order, zero-padded borders."""
    xp = F.pad(x_q, (0, 0, padding, padding, padding, padding))
    cols = xp.unfold(1, kh, stride).unfold(2, kw, stride)          # (N, Ho, Wo, C, kh, kw)
    n, ho, wo = cols.shape[:3]
    return cols.permute(0, 1, 2, 4, 5, 3).reshape(n, ho, wo, kh * kw * x_q.shape[3])


def conv2d_int8(x_q: torch.Tensor, w_q: torch.Tensor, stride: int, padding: int) -> torch.Tensor:
    """int8 NHWC × int8 HWIO → the exact int32 NHWC convolution."""
    if x_q.device.type == "cuda":
        kh, kw, ci, co = w_q.shape
        cols = _im2col(x_q, kh, kw, stride, padding)
        y = int8_matmul(cols.reshape(-1, kh * kw * ci), w_q.reshape(kh * kw * ci, co))
        return y.reshape(*cols.shape[:3], co)
    y = F.conv2d(x_q.to(torch.float64).permute(0, 3, 1, 2), w_q.to(torch.float64).permute(3, 2, 0, 1),
                 stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1).to(torch.int32)


def quantized_conv2d(x: torch.Tensor, w_f32: torch.Tensor, stride: int, padding: int, out_dtype=None) -> torch.Tensor:
    """Float in, float out, through int8: ``conv(x_q, w_q) · (s_x · s_w)`` cast to ``out_dtype`` (default
    ``x.dtype``).  ``w_f32``: (H, W, I, O) float weights, typically batchnorm-folded."""
    w_q, s_w = quantize_weights_per_channel(w_f32, axis=3)
    x_q, s_x = quantize_act_per_tensor(x)
    y = conv2d_int8(x_q, w_q, stride, padding).to(torch.float32) * (s_x * s_w.reshape(1, 1, 1, -1))
    return y.to(x.dtype if out_dtype is None else out_dtype)


def quantized_linear(params, x: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """``linear_apply(params, x)`` through int8: per-output-channel weight scales, one activation scale, the
    float32 dequantization plus the bias, cast to ``out_dtype`` (default ``x.dtype``)."""
    w_q, s_w = quantize_weights_per_channel(params["w"], axis=1)
    x_q, s_x = quantize_act_per_tensor(x)
    y = int8_matmul(x_q.reshape(-1, x_q.shape[-1]), w_q).reshape(*x_q.shape[:-1], w_q.shape[1]).to(torch.float32)
    y = y * (s_x * s_w.reshape(-1)) + params["b"].to(torch.float32)
    return y.to(x.dtype if out_dtype is None else out_dtype)
