"""conv(3×3, s1, p1) + spatial bias → ReLU → maxpool(3×3, s1): CUDA kernel and its plain version.

Counterpart of ``cvml_goalnet_tpu/ops/pallas/fused_stage.py``; conv1 and conv2
of the folded visual trunk run through it.  The kernel
(``csrc/fused_stage.cu``) keeps the pre-pool conv tile in shared memory and
writes only the pooled tile; its note says what bounds it.

The kernel has no backward (the JAX package's has no VJP either): on CUDA
tensors that require grad with grad mode on, the wrapper raises rather than
return an output that would cut the gradient.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from cvml_goalnet_tpu_torch.device import strict_f32
from cvml_goalnet_tpu_torch.ops.cuda import _build

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"fused_conv_pool_stage": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P]}


def fused_conv_pool_stage_plain(x: torch.Tensor, w: torch.Tensor, b_spatial: torch.Tensor) -> torch.Tensor:
    """The same function in plain PyTorch (``F.conv2d`` + bias map + ReLU + ``F.max_pool2d``), NHWC in and out."""
    with strict_f32():
        y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), padding=1)
    y = torch.relu(y + b_spatial.permute(2, 0, 1)[None])
    return F.max_pool2d(y, 3, 1).permute(0, 2, 3, 1).contiguous()


def fused_conv_pool_stage(x: torch.Tensor, w: torch.Tensor, b_spatial: torch.Tensor) -> torch.Tensor:
    """x (N, H, W, C), w (3, 3, C, Co) HWIO, b_spatial (H, W, Co) → (N, H−2, W−2, Co).

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel.
    """
    if x.device.type == "cpu":
        return fused_conv_pool_stage_plain(x, w, b_spatial)
    if x.device.type != "cuda":
        raise ValueError(f"fused_conv_pool_stage: unsupported device {x.device}")
    n, h, wd, cin = x.shape
    if w.shape[:3] != (3, 3, cin) or b_spatial.shape != (h, wd, w.shape[3]):
        raise ValueError(
            f"fused_conv_pool_stage: shapes x {tuple(x.shape)}, w {tuple(w.shape)}, "
            f"b_spatial {tuple(b_spatial.shape)} do not match"
        )
    if h < 3 or wd < 3 or h * wd > 256:
        raise ValueError(f"fused_conv_pool_stage: the kernel takes 3 ≤ H, W and H·W ≤ 256, got {h}×{wd}")
    _build.refuse_grad("fused_conv_pool_stage", x, w, b_spatial)
    _build.require_f32("fused_conv_pool_stage", x.device, x=x, w=w, b_spatial=b_spatial)
    cout = w.shape[3]
    out = torch.empty((n, h - 2, wd - 2, cout), dtype=torch.float32, device=x.device)
    if n == 0:
        return out
    lib = _build.load("fused_stage", _SIGNATURES)
    with _build.on_device(x):
        code = lib.fused_conv_pool_stage(
            x.data_ptr(), w.data_ptr(), b_spatial.data_ptr(), out.data_ptr(), n, h, wd, cin, cout,
            _build.stream_of(x),
        )
    _build.check(lib, code, "fused_conv_pool_stage")
    fused_conv_pool_stage.launches += 1
    return out


fused_conv_pool_stage.launches = 0
