"""The eval fusion MLP in one launch: CUDA kernel and its plain version.

Counterpart of ``cvml_goalnet_tpu/ops/pallas/fused_mlp.py``.  The kernel
(``csrc/fused_mlp.cu``) keeps each 8-row tile's activations in shared memory
through all layers and streams the weights from L2; its note says what
bounds it.  ``layers`` is the fusion list of ``{"w": (in, out), "b": (out,)}``.

The kernel has no backward (the JAX package's has no VJP either): on CUDA
tensors that require grad with grad mode on, the wrapper raises rather than
return an output that would cut the gradient.
"""

from __future__ import annotations

import ctypes

import torch

from cvml_goalnet_tpu_torch.device import strict_f32
from cvml_goalnet_tpu_torch.ops.cuda import _build

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"fused_mlp": [_P, _P, _I, _I, _P, _P, _P, _I, ctypes.c_float, ctypes.c_float, _P]}
MAX_LAYERS = 8


def fused_fusion_mlp_plain(x: torch.Tensor, layers, out_lo: float = 1.0, out_hi: float = 5.0, squash: bool = True) -> torch.Tensor:
    """The same chain in plain PyTorch: linears with ReLU between, then ``(hi − lo)·σ + lo``."""
    with strict_f32():
        for i, lp in enumerate(layers):
            x = torch.matmul(x, lp["w"]) + lp["b"]
            if i < len(layers) - 1:
                x = torch.relu(x)
    return (out_hi - out_lo) * torch.sigmoid(x) + out_lo if squash else x


def fused_fusion_mlp(x: torch.Tensor, layers, out_lo: float = 1.0, out_hi: float = 5.0, squash: bool = True) -> torch.Tensor:
    """(N, D) fused features → (N, out) scores in [out_lo, out_hi], or the raw logits without ``squash``.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel.
    """
    if x.device.type == "cpu":
        return fused_fusion_mlp_plain(x, layers, out_lo, out_hi, squash)
    if x.device.type != "cuda":
        raise ValueError(f"fused_fusion_mlp: unsupported device {x.device}")
    if not 1 <= len(layers) <= MAX_LAYERS:
        raise ValueError(f"fused_fusion_mlp: the kernel takes 1 to {MAX_LAYERS} layers, got {len(layers)}")
    dims = [x.shape[1]]
    for i, lp in enumerate(layers):
        w, b = lp["w"], lp["b"]
        if w.shape[0] != dims[-1] or b.shape != (w.shape[1],):
            raise ValueError(f"fused_fusion_mlp: layer {i} w {tuple(w.shape)} b {tuple(b.shape)} does not chain from {dims[-1]}")
        dims.append(w.shape[1])
    _build.refuse_grad("fused_fusion_mlp", x, *(t for lp in layers for t in (lp["w"], lp["b"])))
    _build.require_f32("fused_fusion_mlp", x.device, x=x,
                       **{f"layer{i}.{k}": lp[k] for i, lp in enumerate(layers) for k in ("w", "b")})
    m = x.shape[0]
    y = torch.empty((m, dims[-1]), dtype=torch.float32, device=x.device)
    if m == 0:
        return y
    n_layers = len(layers)
    w_ptrs = (ctypes.c_void_p * n_layers)(*[lp["w"].data_ptr() for lp in layers])
    b_ptrs = (ctypes.c_void_p * n_layers)(*[lp["b"].data_ptr() for lp in layers])
    c_dims = (ctypes.c_int * (n_layers + 1))(*dims)
    lib = _build.load("fused_mlp", _SIGNATURES)
    code = lib.fused_mlp(
        x.data_ptr(), y.data_ptr(), m, n_layers, ctypes.cast(w_ptrs, _P), ctypes.cast(b_ptrs, _P),
        ctypes.cast(c_dims, _P), int(squash), out_lo, out_hi, _build.stream_of(x),
    )
    _build.check(lib, code, "fused_fusion_mlp")
    fused_fusion_mlp.launches += 1
    return y


fused_fusion_mlp.launches = 0
