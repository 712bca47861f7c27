"""``ReLU?(x @ w + b)`` for the visual head: split-K CUDA kernel and its plain version.

Counterpart of ``cvml_goalnet_tpu/ops/pallas/matmul.py``.  The kernel
(``csrc/matmul.cu``) splits K across blocks, writes float32 partial sums to a
workspace this wrapper allocates, and reduces them in a fixed order in a
second pass, so results repeat exactly; its note says what bounds it.

The kernel has no backward (the JAX package's has no VJP either): on CUDA
tensors that require grad with grad mode on, the wrapper raises rather than
return an output that would cut the gradient.
"""

from __future__ import annotations

import ctypes
import math

import torch

from cvml_goalnet_tpu_torch.device import strict_f32
from cvml_goalnet_tpu_torch.ops.cuda import _build

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"head_matmul": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]}

_BLOCK, _BK = 64, 16      # output tile edge and K step of the kernel
_TARGET_BLOCKS = 132 * 8  # about 8 blocks on each of the H100's 132 SMs
_MIN_STEPS = 16           # K steps per split, so a block does real work


def split_plan(m: int, k: int, n: int) -> tuple[int, int]:
    """(splits, k_chunk): enough blocks to fill the card, k_chunk a multiple of the K step."""
    tiles = math.ceil(m / _BLOCK) * math.ceil(n / _BLOCK)
    steps = math.ceil(k / _BK)
    splits = max(1, min(math.ceil(_TARGET_BLOCKS / tiles), steps // _MIN_STEPS))
    k_chunk = math.ceil(steps / splits) * _BK
    return math.ceil(k / k_chunk), k_chunk


def head_matmul_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, relu: bool = True) -> torch.Tensor:
    """The same function in plain PyTorch."""
    with strict_f32():
        y = torch.matmul(x, w) + b
    return torch.relu(y) if relu else y


def head_matmul(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, relu: bool = True) -> torch.Tensor:
    """x (M, K) @ w (K, N) + b (N,), then ReLU when ``relu``; float32.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel.
    """
    m, k = x.shape
    kw, n = w.shape
    if k != kw:
        raise ValueError(f"contraction mismatch: x K={k}, w K={kw}")
    if b.shape != (n,):
        raise ValueError(f"bias shape {tuple(b.shape)} does not match N={n}")
    if x.device.type == "cpu":
        return head_matmul_plain(x, w, b, relu)
    if x.device.type != "cuda":
        raise ValueError(f"head_matmul: unsupported device {x.device}")
    _build.refuse_grad("head_matmul", x, w, b)
    _build.require_f32("head_matmul", x.device, x=x, w=w, b=b)
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0:
        return y
    splits, k_chunk = split_plan(m, k, n)
    part = torch.empty((splits, m, n), dtype=torch.float32, device=x.device)
    lib = _build.load("matmul", _SIGNATURES)
    with _build.on_device(x):
        code = lib.head_matmul(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), part.data_ptr(), y.data_ptr(),
            m, k, n, splits, k_chunk, int(relu), _build.stream_of(x),
        )
    _build.check(lib, code, "head_matmul")
    head_matmul.launches += 1
    return y


head_matmul.launches = 0
