"""Functional layers in the JAX package's layouts (NHWC / NWC activations).

Port of the primitives of ``cvml_goalnet_tpu/models/layers.py``: conv2d
(HWIO weights), conv1d (WIO), maxpool2d, the eval batchnorm as a per-channel
affine, linear (``(in, out)`` weights), layernorm, and the train-time
batchnorm (batch statistics, an optional mask of valid rows) and dropout
(masks drawn from an explicit ``torch.Generator``), and the text branch's
``multihead_attention`` with its ``softmax`` and ``gelu_tanh``.  Each takes and returns
the JAX layout and permutes to PyTorch's channel-first layout only around the
library call.  Library convolutions and products run with TF32 off.

On bf16 inputs conv2d, conv1d and linear round where the JAX package's bf16
forward rounds: the weights and bias are cast to bf16, the contraction runs
on the upcast operands in strict float32 and is rounded to bf16, and the
bias is added in bf16 (rounded again).  Every cast is differentiable, so the
bf16 train forward uses the same functions.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from cvml_goalnet_tpu_torch.device import strict_f32


def conv_out_size(size: int, kernel: int, stride: int, padding: int) -> int:
    return (size + 2 * padding - kernel) // stride + 1


def _bf16_sum(y: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A float32 contraction of bf16 operands rounded to bf16, + ``b`` in bf16 (rounded again)."""
    return y.to(torch.bfloat16) + b.to(torch.bfloat16)


def conv2d_apply(params, x: torch.Tensor, stride: int = 1, padding: int = 0) -> torch.Tensor:
    """x (N, H, W, C) NHWC, params ``{"w": HWIO, "b": (O,)}`` → NHWC, in x's dtype (float32 or bf16)."""
    if x.dtype == torch.bfloat16:
        w = params["w"].to(torch.bfloat16).to(torch.float32)
        with strict_f32():
            y = F.conv2d(x.to(torch.float32).permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), stride=stride,
                         padding=padding)
        return _bf16_sum(y, params["b"][:, None, None]).permute(0, 2, 3, 1)
    with strict_f32():
        y = F.conv2d(x.permute(0, 3, 1, 2), params["w"].permute(3, 2, 0, 1), params["b"],
                     stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1)


def conv1d_apply(params, x: torch.Tensor, stride: int = 1, padding: int = 0) -> torch.Tensor:
    """x (N, W, C) NWC, params ``{"w": WIO, "b": (O,)}`` → NWC, in x's dtype (float32 or bf16)."""
    if x.dtype == torch.bfloat16:
        w = params["w"].to(torch.bfloat16).to(torch.float32)
        with strict_f32():
            y = F.conv1d(x.to(torch.float32).permute(0, 2, 1), w.permute(2, 1, 0), stride=stride, padding=padding)
        return _bf16_sum(y, params["b"][:, None]).permute(0, 2, 1)
    with strict_f32():
        y = F.conv1d(x.permute(0, 2, 1), params["w"].permute(2, 1, 0), params["b"],
                     stride=stride, padding=padding)
    return y.permute(0, 2, 1)


def maxpool2d(x: torch.Tensor, kernel: int = 3, stride: int = 1, padding: int = 0) -> torch.Tensor:
    """NHWC max pool; ``padding`` pads with −inf, so the border never wins (JAX ``reduce_window``'s init)."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), kernel, stride, padding).permute(0, 2, 3, 1)


def bn_affine(bn_params, bn_state, eps: float = 1e-5) -> tuple[torch.Tensor, torch.Tensor]:
    """Eval batchnorm as per-channel float32 (s, t) with y = s·x + t (from bf16 statistics upcast, as in the
    JAX package)."""
    f32 = torch.float32
    s = bn_params["scale"].to(f32) * torch.rsqrt(bn_state["var"].to(f32) + eps)
    return s, bn_params["bias"].to(f32) - bn_state["mean"].to(f32) * s


def linear_apply(params, x: torch.Tensor) -> torch.Tensor:
    """x (N, in) @ w (in, out) + b, in x's dtype (float32 or bf16)."""
    if x.dtype == torch.bfloat16:
        with strict_f32():
            y = torch.matmul(x.to(torch.float32), params["w"].to(torch.bfloat16).to(torch.float32))
        return _bf16_sum(y, params["b"])
    with strict_f32():
        return torch.matmul(x, params["w"]) + params["b"]


def _const(v: float, like: torch.Tensor) -> torch.Tensor:
    """A Python constant as a 0-d tensor of ``like``'s dtype: rounded to bf16 first for bf16, as the JAX
    package's weakly typed constants are, before the operation that takes them."""
    return torch.tensor(v, dtype=like.dtype, device=like.device)


def _rsqrt(x: torch.Tensor) -> torch.Tensor:
    """``rsqrt``; on bf16 taken in float32 and rounded once, as XLA's bf16 ``rsqrt`` (PyTorch's own bf16
    ``rsqrt`` on the CPU is one bf16 step off it for a few inputs in 10^4)."""
    if x.dtype != torch.bfloat16:
        return torch.rsqrt(x)
    return torch.rsqrt(x.to(torch.float32)).to(x.dtype)


def mean(x: torch.Tensor, dim) -> torch.Tensor:
    """``jnp.mean``: on bf16 the mean taken in float32 and rounded once."""
    if x.dtype != torch.bfloat16:
        return x.mean(dim=dim)
    return x.to(torch.float32).mean(dim=dim).to(x.dtype)


def layernorm_apply(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis: biased variance, ``(x − mean)·rsqrt(var + eps)·scale + bias``.

    On bf16 it rounds where the JAX package's bf16 layernorm does: the mean and the variance are computed in
    float32 and rounded to bf16, then each of the five operations rounds to bf16."""
    if x.dtype != torch.bfloat16:
        return F.layer_norm(x, (x.shape[-1],), params["scale"], params["bias"], eps)
    xf = x.to(torch.float32)
    mean = xf.mean(dim=-1, keepdim=True)
    var = torch.square(xf - mean).mean(dim=-1, keepdim=True)
    y = (x - mean.to(x.dtype)) * _rsqrt(var.to(x.dtype) + _const(eps, x))
    return y * params["scale"].to(x.dtype) + params["bias"].to(x.dtype)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (the tanh approximation); on bf16 each operation of its formula
    ``x·0.5·(1 + tanh(√(2/π)·(x + 0.044715·x·x²)))`` rounds to bf16, as in the JAX package."""
    if x.dtype != torch.bfloat16:
        return F.gelu(x, approximate="tanh")
    inner = _const(math.sqrt(2.0 / math.pi), x) * (x + _const(0.044715, x) * (x * (x * x)))
    return x * (_const(0.5, x) * (_const(1.0, x) + torch.tanh(inner)))


def softmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``jax.nn.softmax``; on bf16 ``exp(x − max)`` rounds per operation and the sum is taken in float32 and
    rounded, as in the JAX package."""
    if x.dtype != torch.bfloat16:
        return torch.softmax(x, dim=dim)
    e = torch.exp(x - x.amax(dim=dim, keepdim=True))
    return e / e.to(torch.float32).sum(dim=dim, keepdim=True).to(x.dtype)


def _contract(equation: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``einsum`` in strict float32, rounded once to bf16 when the operands are bf16 (as the JAX package's
    bf16 einsum)."""
    with strict_f32():
        y = torch.einsum(equation, a.to(torch.float32), b.to(torch.float32))
    return y.to(a.dtype)


def multihead_attention(layer, x: torch.Tensor, num_heads: int, mask: torch.Tensor | None = None,
                        linear_fn=None) -> torch.Tensor:
    """Multi-head self-attention over (N, T, D) token sequences with the (T, T) logits materialised.

    Port of ``cvml_goalnet_tpu/models/layers.py:188-218`` (the text
    branch's and the ViT's attention; the timeline scorer uses the flash
    kernels): ``layer`` holds ``wq/wk/wv/wo``; ``mask`` (N, T) marks the
    valid key positions; ``linear_fn`` takes the place of
    :func:`linear_apply` for the four projections (the ViT's int8 path
    passes ``ops/quant.py::quantized_linear``).  Masked logits are −1e30,
    not −inf, so a row with no valid key (empty commentary) is a uniform
    average over its padding, never NaN.
    In x's dtype; on bf16 every step rounds where the JAX package's does
    (the logits are divided by ``bf16(√hd)``).
    """
    n, t, d = x.shape
    hd = d // num_heads
    lin = linear_apply if linear_fn is None else linear_fn

    def split(h):
        return h.reshape(n, t, num_heads, hd).permute(0, 2, 1, 3)

    q = split(lin(layer["wq"], x))
    k = split(lin(layer["wk"], x))
    v = split(lin(layer["wv"], x))
    scale = torch.tensor(math.sqrt(hd), dtype=torch.float32).to(device=x.device, dtype=x.dtype)
    logits = _contract("nhqd,nhkd->nhqk", q, k) / scale
    if mask is not None:
        logits = torch.where(mask[:, None, None, :], logits, _const(-1e30, logits))
    out = _contract("nhqk,nhkd->nhqd", softmax(logits), v)
    return lin(layer["wo"], out.permute(0, 2, 1, 3).reshape(n, t, d))


def _group_stats(x: torch.Tensor, dims, mask: torch.Tensor | None, group):
    """(mean, biased variance, count) over ``dims`` of the valid rows of every rank of ``group``: the per-channel
    sums and the row count, then the sums of squared deviations, each all-reduced through an all-reduce that
    autograd passes through, so each rank's gradient carries the statistics' share of every rank's loss."""
    from cvml_goalnet_tpu_torch.parallel.collectives import all_reduce_sum

    per_frame = x.numel() // x.shape[-1] // max(x.shape[0], 1)
    if mask is None:
        m = None
        rows = torch.tensor(float(x.shape[0]), device=x.device)
    else:
        m = mask.reshape(mask.shape[:1] + (1,) * (x.dim() - 1)).to(x.dtype)
        rows = mask.to(torch.float32).sum()
    sums = (x if m is None else x * m).sum(dim=dims)
    total = all_reduce_sum(torch.cat([sums.to(torch.float32), (rows * per_frame).reshape(1)]), group)
    count = total[-1]
    mean = (total[:-1] / count).to(x.dtype)
    dev = torch.square(x - mean)
    var = all_reduce_sum((dev if m is None else m * dev).sum(dim=dims), group) / count
    return mean, var, count


def batchnorm_apply(params, state, x: torch.Tensor, train: bool, momentum: float = 0.1, eps: float = 1e-5,
                    mask: torch.Tensor | None = None, group=None):
    """BatchNorm over every axis but the last (channel) → ``(y, new_state)``.

    Train mode normalises by the biased batch statistics and moves the
    running ones toward the unbiased variance, as PyTorch's batchnorm does;
    eval mode normalises by the running statistics.  ``mask`` (N,) marks the
    valid leading rows of a zero-padded batch: the statistics count only
    those (``count = Σmask · per_frame``, the unbiased variance over
    ``max(count − 1, 1)``), while padded rows are still normalised.  With
    ``group`` (a ``torch.distributed`` group) the statistics are those of
    every rank's rows together, as one device's over the global batch
    (JAX's GSPMD data-parallel step); without it nothing is communicated.
    Every result is a new tensor: ``state`` is left as it was.  In eval mode on
    bf16 (the resnet backbone's unfolded batchnorms) each operation rounds
    to bf16 as the JAX package's do, ``eps`` rounded first.
    """
    dims = tuple(range(x.dim() - 1))
    if train:
        if group is not None:
            mean, var, count = _group_stats(x, dims, mask, group)
            unbiased = var * (count / torch.clamp(count - 1.0, min=1.0))
        elif mask is None:
            mean = x.mean(dim=dims)
            var = torch.square(x - mean).mean(dim=dims)
            count = x.numel() // x.shape[-1]
            unbiased = var * (count / max(count - 1, 1))
        else:
            m = mask.reshape(mask.shape[:1] + (1,) * (x.dim() - 1)).to(x.dtype)
            per_frame = x.numel() // x.shape[-1] // x.shape[0]
            count = mask.to(torch.float32).sum() * per_frame
            mean = (x * m).sum(dim=dims) / count
            var = (m * torch.square(x - mean)).sum(dim=dims) / count
            unbiased = var * (count / torch.clamp(count - 1.0, min=1.0))
        new_state = {
            "mean": (1 - momentum) * state["mean"] + momentum * mean,
            "var": (1 - momentum) * state["var"] + momentum * unbiased,
        }
    else:
        mean, var = state["mean"], state["var"]
        new_state = state
    y = (x - mean) * _rsqrt(var + _const(eps, var)) * params["scale"] + params["bias"]
    return y, new_state


def dropout_keep(shape, rate: float, generator: torch.Generator | None, device, dtype) -> torch.Tensor:
    """The keep mask of an inverted dropout of ``shape``: a uniform draw from ``generator`` below ``1 − rate``."""
    return torch.rand(shape, generator=generator, device=device, dtype=dtype) < 1.0 - rate


def apply_keep(x: torch.Tensor, kept: torch.Tensor, rate: float) -> torch.Tensor:
    """``x`` scaled by ``1/(1 − rate)`` where ``kept``, 0 elsewhere."""
    return torch.where(kept, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


def dropout(x: torch.Tensor, rate: float, train: bool, generator: torch.Generator | None) -> torch.Tensor:
    """Inverted dropout: keep each entry with probability ``1 − rate`` (a uniform draw from ``generator``, a
    generator on ``x``'s device) and scale the kept ones by ``1/keep``; ``x`` itself when not training or
    ``rate <= 0``."""
    if not train or rate <= 0.0:
        return x
    return apply_keep(x, dropout_keep(x.shape, rate, generator, x.device, x.dtype), rate)
