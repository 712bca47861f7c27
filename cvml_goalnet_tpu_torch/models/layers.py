"""Functional layers in the JAX package's layouts (NHWC / NWC activations).

Port of the eval-time primitives of ``cvml_goalnet_tpu/models/layers.py``:
conv2d (HWIO weights), conv1d (WIO), maxpool2d, the eval batchnorm as a
per-channel affine, linear (``(in, out)`` weights) and layernorm.  Each takes and returns
the JAX layout and permutes to PyTorch's channel-first layout only around the
library call.  Library convolutions and products run with TF32 off.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from cvml_goalnet_tpu_torch.device import strict_f32


def conv_out_size(size: int, kernel: int, stride: int, padding: int) -> int:
    return (size + 2 * padding - kernel) // stride + 1


def conv2d_apply(params, x: torch.Tensor, stride: int = 1, padding: int = 0) -> torch.Tensor:
    """x (N, H, W, C) NHWC, params ``{"w": HWIO, "b": (O,)}`` → NHWC."""
    with strict_f32():
        y = F.conv2d(x.permute(0, 3, 1, 2), params["w"].permute(3, 2, 0, 1), params["b"],
                     stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1)


def conv1d_apply(params, x: torch.Tensor, stride: int = 1, padding: int = 0) -> torch.Tensor:
    """x (N, W, C) NWC, params ``{"w": WIO, "b": (O,)}`` → NWC."""
    with strict_f32():
        y = F.conv1d(x.permute(0, 2, 1), params["w"].permute(2, 1, 0), params["b"],
                     stride=stride, padding=padding)
    return y.permute(0, 2, 1)


def maxpool2d(x: torch.Tensor, kernel: int = 3, stride: int = 1) -> torch.Tensor:
    """NHWC max pool, no padding."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), kernel, stride).permute(0, 2, 3, 1)


def bn_affine(bn_params, bn_state, eps: float = 1e-5) -> tuple[torch.Tensor, torch.Tensor]:
    """Eval batchnorm as per-channel (s, t) with y = s·x + t."""
    s = bn_params["scale"] * torch.rsqrt(bn_state["var"] + eps)
    return s, bn_params["bias"] - bn_state["mean"] * s


def linear_apply(params, x: torch.Tensor) -> torch.Tensor:
    """x (N, in) @ w (in, out) + b."""
    with strict_f32():
        return torch.matmul(x, params["w"]) + params["b"]


def layernorm_apply(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis: biased variance, ``(x − mean)·rsqrt(var + eps)·scale + bias``."""
    return F.layer_norm(x, (x.shape[-1],), params["scale"], params["bias"], eps)
