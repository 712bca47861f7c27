"""``ReLU?(x @ w + b)`` for the visual head: split-K tensor-core CUDA kernel and its plain version.

Counterpart of ``cvml_goalnet_tpu/ops/pallas/matmul.py``.  The kernel
(``csrc/matmul.cu``) computes float32 products in 3xTF32 on the tensor
cores, splits K across blocks by :func:`card_head_plan`, writes float32
partial sums to a workspace this wrapper allocates, and reduces them in a
fixed order in a second pass, so results repeat exactly; its note says what
bounds it.

The kernel takes K and N that are multiples of 4 and 16-byte aligned
operands; other operands (only ever small ones here) are copied zero-padded
into scratch first, and the output is sliced back.

The bf16 form (:func:`head_matmul_bf16`, the same source) runs the products
on ``wgmma`` fed by TMA (128 × 256 tiles, split over K by
:func:`head_bf16_plan`) with float32 partial sums, reduced in the same fixed
order, and rounds as the JAX package's bf16 forward does: the sum to bf16, +
the bf16 bias to bf16, ReLU.  TMA takes 16-byte-aligned bases and row
strides: K and N are zero-padded to multiples of 8 and an operand off a
16-byte boundary is copied to an aligned buffer first.  :func:`head_matmul`
dispatches by dtype; a CUDA tensor of a dtype no form takes raises.

The kernel has no backward (the JAX package's has no VJP either): on CUDA
tensors that require grad with grad mode on, the wrapper raises rather than
return an output that would cut the gradient.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from cvml_goalnet_tpu_torch.device import strict_f32
from cvml_goalnet_tpu_torch.ops.cuda import _build
from cvml_goalnet_tpu_torch.utils import bf16_rounded

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "head_matmul": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "head_matmul_blocks_per_sm": [_P],
    "head_matmul_bf16": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "head_matmul_bf16_blocks_per_sm": [_P],
}

BLOCK_M, BLOCK_N, BLOCK_K = 128, 128, 32   # the kernel's output tile and K step (csrc/matmul.cu)
FILL_STEPS = 8     # the plan's fixed cost of a block (pipeline fill, partial write) in K steps
MAX_SPLITS = 64    # the most splits the plan tries

# the bf16 form's wgmma kernel (csrc/matmul.cu, head_bf16_wgmma_kernel): its output tile, its K step (one ring
# stage: 64 of K, an x box of 128 rows x 128 bytes and four w boxes of 64 x 64, each box one 128-byte swizzle
# span wide), its ring and its shared memory
BF16_BLOCK_M, BF16_BLOCK_N, BF16_BLOCK_K = 128, 256, 64
BF16_STAGES = 4
BF16_STAGE_BYTES = 2 * BF16_BLOCK_K * (BF16_BLOCK_M + BF16_BLOCK_N)
BF16_SMEM = 1024 + BF16_STAGES * BF16_STAGE_BYTES + 2 * BF16_STAGES * 8   # + alignment slack and the barriers
BF16_FILL_STEPS = 4   # the plan's fixed cost of a block in K steps


class HeadPlan(NamedTuple):
    """How the kernel splits K: ``splits`` blocks per output tile, each over ``k_chunk`` of K."""
    splits: int
    k_chunk: int   # a multiple of the kernel's K step; splits · k_chunk ≥ K > (splits − 1) · k_chunk


@functools.lru_cache(maxsize=1024)   # a pure function of its ints, asked on every call
def head_plan(m: int, k: int, n: int, sms: int, blocks_per_sm: int) -> HeadPlan:
    """The split of K for (m, k) @ (k, n) on a card of ``sms`` SMs that keeps ``blocks_per_sm`` blocks each.

    Each of the ⌈m/128⌉·⌈n/128⌉ output tiles gets s blocks of ⌈steps/s⌉ K steps; the blocks run in rounds
    of sms · blocks_per_sm.  The plan takes the s of least rounds · (steps per block + FILL_STEPS), the
    smallest on a tie.
    """
    tiles = math.ceil(m / BLOCK_M) * math.ceil(n / BLOCK_N)
    return _split_plan(tiles, k, BLOCK_K, sms * blocks_per_sm, FILL_STEPS)


@functools.lru_cache(maxsize=1024)
def head_bf16_plan(m: int, k: int, n: int, sms: int, blocks_per_sm: int = 1) -> HeadPlan:
    """The split of K for the bf16 form's (m, k) @ (k, n): :func:`head_plan`'s rule over its 128 × 256 tiles
    and 64-deep steps, with :data:`BF16_FILL_STEPS`; one block an SM (its ring takes most of the shared memory).
    At M = 1050 on 132 SMs: 9 × 2 tiles × 7 splits = 126 blocks, one wave."""
    tiles = math.ceil(m / BF16_BLOCK_M) * math.ceil(n / BF16_BLOCK_N)
    return _split_plan(tiles, k, BF16_BLOCK_K, sms * blocks_per_sm, BF16_FILL_STEPS)


def _split_plan(tiles: int, k: int, block_k: int, slots: int, fill: int) -> HeadPlan:
    """Each of ``tiles`` output tiles gets s blocks of ⌈steps/s⌉ K steps of ``block_k``; blocks run in rounds of
    ``slots``.  The s of least rounds · (steps per block + ``fill``), the smallest on a tie; every split
    non-empty."""
    steps = max(1, math.ceil(k / block_k))
    best = None
    for s in range(1, min(steps, MAX_SPLITS) + 1):
        per = math.ceil(steps / s)
        used = math.ceil(steps / per)   # splits that get any K
        cost = math.ceil(tiles * used / slots) * (per + fill)
        if best is None or cost < best[0]:
            best = (cost, used, per)
    return HeadPlan(best[1], best[2] * block_k)


def card_head_plan(m: int, k: int, n: int, device: torch.device) -> HeadPlan:
    """:func:`head_plan` with the SMs and resident blocks of the card ``device`` (the input's)."""
    return head_plan(m, k, n, *head_slots(device))


def head_slots(device: torch.device) -> tuple[int, int]:
    """(SMs, resident blocks of the GEMM pass per SM by the CUDA occupancy calculator) of the card ``device``."""
    return _slots_on_card(_build.device_index(device))


@functools.lru_cache(maxsize=None)
def _slots_on_card(device: int) -> tuple[int, int]:
    lib = _build.load("matmul", _SIGNATURES)
    out = ctypes.c_int(0)
    with torch.cuda.device(device):
        _build.check(lib, lib.head_matmul_blocks_per_sm(ctypes.byref(out)), "head_matmul: occupancy")
    return torch.cuda.get_device_properties(device).multi_processor_count, out.value


def head_matmul_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, relu: bool = True) -> torch.Tensor:
    """The same function in plain PyTorch."""
    with strict_f32():
        y = torch.matmul(x, w) + b
    return torch.relu(y) if relu else y


def _aligned(t: torch.Tensor, *shape: int) -> torch.Tensor:
    """``t`` zero-padded to ``shape`` on a 16-byte boundary: ``t`` itself when it already is."""
    if tuple(t.shape) == shape and t.data_ptr() % 16 == 0:
        return t
    out = t.new_zeros(shape)
    out[tuple(slice(0, s) for s in t.shape)] = t
    return out


def head_matmul(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, relu: bool = True) -> torch.Tensor:
    """x (M, K) @ w (K, N) + b (N,), then ReLU when ``relu``; float32, or bf16 through :func:`head_matmul_bf16`.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel.
    """
    m, k = x.shape
    kw, n = w.shape
    if k != kw:
        raise ValueError(f"contraction mismatch: x K={k}, w K={kw}")
    if b.shape != (n,):
        raise ValueError(f"bias shape {tuple(b.shape)} does not match N={n}")
    if x.dtype == torch.bfloat16:
        return head_matmul_bf16(x, w, b, relu)
    if x.device.type == "cpu":
        return head_matmul_plain(x, w, b, relu)
    if x.device.type != "cuda":
        raise ValueError(f"head_matmul: unsupported device {x.device}")
    _build.refuse_grad("head_matmul", x, w, b)
    _build.require_dtype("head_matmul", x.device, torch.float32, x=x, w=w, b=b)
    if m == 0 or n == 0:
        return torch.empty((m, n), dtype=torch.float32, device=x.device)
    k4, n4 = -(-k // 4) * 4, -(-n // 4) * 4
    x, w, b = _aligned(x, m, k4), _aligned(w, k4, n4), _aligned(b, n4)
    y = torch.empty((m, n4), dtype=torch.float32, device=x.device)
    plan = card_head_plan(m, k4, n4, x.device)
    part = torch.empty((plan.splits, m, n4), dtype=torch.float32, device=x.device)
    lib = _build.load("matmul", _SIGNATURES)
    with _build.on_device(x):
        code = lib.head_matmul(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), part.data_ptr(), y.data_ptr(),
            m, k4, n4, plan.splits, plan.k_chunk, int(relu), _build.stream_of(x),
        )
    _build.check(lib, code, "head_matmul")
    head_matmul.launches += 1
    return y if n4 == n else y[:, :n].contiguous()


head_matmul.launches = 0


# ---------------------------------------------------------------- the bf16 form


def head_matmul_bf16_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, relu: bool = True) -> torch.Tensor:
    """The bf16 form in plain PyTorch: the bf16 operands upcast, the product in strict float32, rounded to bf16,
    + the bias rounded again, ReLU; bf16 out."""
    with strict_f32():
        y = torch.matmul(x.to(torch.float32), w.to(torch.float32))
    y = (bf16_rounded(y) + b.to(torch.float32)).to(torch.bfloat16)
    return torch.relu(y) if relu else y


def card_head_bf16_plan(m: int, k: int, n: int, device: torch.device) -> HeadPlan:
    """:func:`head_bf16_plan` with the SMs and resident blocks of the bf16 GEMM pass on the card ``device``."""
    return head_bf16_plan(m, k, n, *head_bf16_slots(device))


def head_bf16_slots(device: torch.device) -> tuple[int, int]:
    """(SMs, resident blocks of the bf16 GEMM pass per SM by the CUDA occupancy calculator) of the card."""
    return _bf16_slots_on_card(_build.device_index(device))


@functools.lru_cache(maxsize=None)
def _bf16_slots_on_card(device: int) -> tuple[int, int]:
    lib = _build.load("matmul", _SIGNATURES)
    out = ctypes.c_int(0)
    with torch.cuda.device(device):
        _build.check(lib, lib.head_matmul_bf16_blocks_per_sm(ctypes.byref(out)), "head_matmul_bf16: occupancy")
    return torch.cuda.get_device_properties(device).multi_processor_count, out.value


def head_matmul_bf16(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, relu: bool = True) -> torch.Tensor:
    """The bf16 form: x (M, K) @ w (K, N) + b (N,), ReLU when ``relu``; all bf16.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel (K and N zero-padded to
    multiples of 8 where they are not, and an operand off a 16-byte boundary copied, as TMA needs).
    """
    m, k = x.shape
    n = w.shape[1]
    if x.device.type == "cpu":
        return head_matmul_bf16_plain(x, w, b, relu)
    if x.device.type != "cuda":
        raise ValueError(f"head_matmul_bf16: unsupported device {x.device}")
    _build.refuse_grad("head_matmul_bf16", x, w, b)
    _build.require_dtype("head_matmul_bf16", x.device, torch.bfloat16, x=x, w=w, b=b)
    if m == 0 or n == 0:
        return torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    k8, n8 = -(-k // 8) * 8, -(-n // 8) * 8
    x, w, b = _aligned(x, m, k8), _aligned(w, k8, n8), _aligned(b, n8)
    y = torch.empty((m, n8), dtype=torch.bfloat16, device=x.device)
    plan = card_head_bf16_plan(m, k8, n8, x.device)
    part = torch.empty((plan.splits, m, n8), dtype=torch.float32, device=x.device)
    lib = _build.load("matmul", _SIGNATURES)
    with _build.on_device(x):
        code = lib.head_matmul_bf16(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), part.data_ptr(), y.data_ptr(),
            m, k8, n8, plan.splits, plan.k_chunk, int(relu), _build.stream_of(x),
        )
    _build.check(lib, code, "head_matmul_bf16")
    head_matmul_bf16.launches += 1
    return y if n8 == n else y[:, :n].contiguous()


head_matmul_bf16.launches = 0
