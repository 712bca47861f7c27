"""Int8 quantization of the eval forward: symmetric scales, int8 values, exact int32 products.

Port of ``cvml_goalnet_tpu/ops/quant.py``, with its semantics kept to the bit:
scales ``max(amax / 127, 1e-12)`` in float32 (per output channel for weights,
one per tensor for activations), values ``clip(round(x / s), −127, 127)``
(a division, and rounding half to even, as ``jnp.round`` and
``torch.round`` do), and dequantization ``acc_f32 · (s_x · s_w)`` with the
scale product formed first, then a cast to the activation dtype.

These are the plain versions.  On the card conv1 and conv2 take the int8
form of kernel 2 (``ops/cuda/fused_stage.py::fused_conv_pool_stage_int8``),
which computes the scales and quantizes the activations and the weights in
kernels (none of these ops runs there) and sums in int32 on the tensor
cores; :func:`conv2d_int8` here sums in float64, which is exact: a sum of at
most 2^53 / 127² products (float32 is not: conv2's K = 2304 sums reach
2304 · 127² > 2^24).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


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
    """The per-tensor activation scale ``max(max|x| / 127, 1e-12)``, a float32 scalar on ``x``'s device."""
    return amax_scale(x.abs().amax().to(torch.float32))


def quantize_act_per_tensor(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Dynamic symmetric int8 per-tensor quantization → ``(x_q int8, scale float32 scalar)``."""
    s = act_scale(x)
    return torch.clamp(torch.round(x.to(torch.float32) / s), -127, 127).to(torch.int8), s


def conv2d_int8(x_q: torch.Tensor, w_q: torch.Tensor, stride: int, padding: int) -> torch.Tensor:
    """int8 NHWC × int8 HWIO → the exact int32 NHWC convolution."""
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
    y = torch.matmul(x_q.to(torch.float64), w_q.to(torch.float64)).to(torch.float32)
    y = y * (s_x * s_w.reshape(-1)) + params["b"].to(torch.float32)
    return y.to(x.dtype if out_dtype is None else out_dtype)
