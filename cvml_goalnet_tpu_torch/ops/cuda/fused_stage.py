"""conv(3×3, s1, p1) + spatial bias → ReLU → maxpool(3×3, s1): CUDA kernel, its plan and its plain version.

Counterpart of ``cvml_goalnet_tpu/ops/pallas/fused_stage.py``; conv1 and conv2
of the folded visual trunk run through it.  The kernel
(``csrc/fused_stage.cu``) is an implicit GEMM on the tensor cores in 3xTF32:
a block computes the conv tile that the pool of its R × C tile of pooled
positions reads (with a recomputed halo when a frame is cut into tiles), for
one or more frames and a slice of 64 output channels, keeps it in shared
memory and writes only the pooled tile; its note says what bounds it.
:func:`stage_plan` picks the tile for a shape and a card, so any H, W ≥ 3
runs.

Two low-precision forms run on the tensor cores too (``csrc/fused_stage_lowp.cu``):
:func:`fused_conv_pool_stage_bf16` (bf16 in and out, float32 sums rounded where
the JAX package's bf16 forward rounds) and :func:`fused_conv_pool_stage_int8`
(the ``quantized_inference`` stage: int8 activations and weights, exact int32
sums, dequantized to float32 or bf16).  Both run one kernel template on
``wgmma`` with the weights streamed by TMA (the bf16 form's straight from w as
stored), tiled by :func:`bf16_stage_plan` and :func:`int8_stage_plan`; the activation
scale, the activations' and the weights' quantization are kernels of the same
call (:func:`act_scale_int8` and :func:`pack_weights_int8` run the last two
passes alone), so no op of ``ops/quant.py`` runs on the card.
:func:`fused_conv_pool_stage` dispatches by dtype: float32 takes the float32
kernel, bf16 the bf16 form.
Each form has its own plain version and launch count; a CUDA tensor of a
dtype no form takes raises, and nothing is cast for a kernel.

The kernels have no backward (the JAX package's has no VJP either): on CUDA
tensors that require grad with grad mode on, the wrappers raise rather than
return an output that would cut the gradient.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from cvml_goalnet_tpu_torch.device import strict_f32
from cvml_goalnet_tpu_torch.ops import quant
from cvml_goalnet_tpu_torch.ops.cuda import _build
from cvml_goalnet_tpu_torch.utils import bf16_rounded

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "fused_conv_pool_stage": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "fused_conv_pool_stage_blocks_per_sm": [_I, _I, _I, _P],
}
_LOWP_SIGNATURES = {
    "fused_conv_pool_stage_bf16": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "fused_conv_pool_stage_int8": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P],
    "int8_pack_weights": [_P, _P, _P, _I, _I, _P],
    "int8_act_scale": [_P, _P, _P, ctypes.c_longlong, _I, _P],
}

# the kernel's geometry (csrc/fused_stage.cu)
BLOCK_N = 64                   # output channels per block
CHUNK = 8                      # input channels per pipeline stage: one k-step at each of the 9 taps
M_TILES = (2, 3, 4)            # built m16 tiles per warp; 4 warps along M hold 64 · m_tiles conv positions
STAGE_COUNTS = (2, 3)          # built ring depths
_W_STAGE = 9 * CHUNK * (BLOCK_N + 4)   # floats of one stage's weights (rows padded by 4)
_C_PITCH = BLOCK_N + 4                 # floats per conv position in the epilogue's tile
SM_SMEM = 233_472              # shared memory of an H100 SM (228 KB)
BLOCK_SMEM = 232_448           # the most one block may take (227 KB)
SMEM_PER_BLOCK = 1_024         # what the SM reserves for each resident block
FIXED_MI = 1.0                 # a block's cost besides its MMAs (weight copies and splits, fill, epilogue),
                               # in units of one m16 tile per warp


class StagePlan(NamedTuple):
    """How the kernel tiles (N, H, W): ``frames`` per block, each cut into tiles of ``rows`` × ``cols`` pooled
    positions (the whole frame when they are H − 2 and W − 2), ``m_tiles`` m16 tiles per warp, and a ring of
    ``stages``.  Each block takes one slice of :data:`BLOCK_N` output channels."""
    frames: int
    rows: int
    cols: int
    m_tiles: int
    stages: int


def block_positions(plan: StagePlan) -> tuple[int, int]:
    """(conv positions, input positions) of one block: its conv tile carries the pool's halo of 2, its input
    tile the conv's halo of 1 more on each side."""
    f, r, c = plan.frames, plan.rows, plan.cols
    return f * (r + 2) * (c + 2), f * (r + 4) * (c + 4)


def smem_bytes(plan: StagePlan) -> int:
    """Dynamic shared memory of a block: the ring (weights and raw input per stage), the split input
    tile and the input offset table; the epilogue's conv tile reuses it."""
    m, p = block_positions(plan)
    ring = plan.stages * (_W_STAGE + p * CHUNK) + 2 * p * CHUNK + p
    return 4 * max(ring, m * _C_PITCH)


def blocks_per_sm(plan: StagePlan, reg_blocks: dict[int, int]) -> int:
    """Resident blocks of ``plan`` on an SM: the register limit of its kernel (``reg_blocks[m_tiles]``, from
    the occupancy calculator) or the shared-memory limit, whichever is lower."""
    return min(reg_blocks[plan.m_tiles], SM_SMEM // (smem_bytes(plan) + SMEM_PER_BLOCK))


def workspace_floats(cin: int, cout: int) -> int:
    """Floats of the packed weights (zero-padded to whole stages and channel slices)."""
    return math.ceil(cout / BLOCK_N) * math.ceil(cin / CHUNK) * 9 * CHUNK * BLOCK_N


def block_count(plan: StagePlan, n: int, h: int, w: int, cout: int) -> int:
    """Blocks of a launch: frame groups × tiles per frame × channel slices."""
    tiles = math.ceil((h - 2) / plan.rows) * math.ceil((w - 2) / plan.cols)
    return math.ceil(n / plan.frames) * tiles * math.ceil(cout / BLOCK_N)


def _tiles(n: int, h: int, w: int, m_tiles: int):
    """(frames, rows, cols) a block of ``m_tiles`` can hold: whole frames when one fits, else one frame's tiles
    of every conv height from 3 up with the widest conv width that fits beside it."""
    cap = 64 * m_tiles
    if h * w <= cap:
        for f in range(1, min(n, cap // (h * w)) + 1):
            yield f, h - 2, w - 2
        return
    for rc in range(3, min(h, cap // 3) + 1):
        yield 1, rc - 2, min(w, cap // rc) - 2


def plan_cost(plan: StagePlan, n: int, h: int, w: int, cout: int, sms: int, reg_blocks: dict[int, int]) -> float:
    """The plan model's time of ``plan``, in rounds of one m16 tile per warp: its blocks run c at a time on
    each SM (c the resident blocks, or fewer when the blocks do not reach every SM), so it takes
    ⌈blocks / (sms · c)⌉ · c rounds of (m_tiles + FIXED_MI)."""
    blocks = block_count(plan, n, h, w, cout)
    conc = min(blocks_per_sm(plan, reg_blocks), math.ceil(blocks / sms))
    return math.ceil(blocks / (sms * conc)) * conc * (plan.m_tiles + FIXED_MI)


@functools.lru_cache(maxsize=1024)   # a pure function of its ints, asked on every call
def stage_plan(n: int, h: int, w: int, cout: int, sms: int, reg_blocks: tuple[int, ...]) -> StagePlan:
    """The plan for x (n, h, w, ·) → (n, h − 2, w − 2, cout) on a card of ``sms`` SMs, where the kernel of
    ``m_tiles = M_TILES[i]`` keeps ``reg_blocks[i]`` blocks per SM by its registers.

    Every candidate tile of every built ``m_tiles`` gets the deepest ring that costs no resident block; the
    plan takes the least :func:`plan_cost`, then the fewest blocks, then the smallest ``m_tiles``.
    """
    regs = dict(zip(M_TILES, reg_blocks))
    best = None
    for mi in M_TILES:
        for f, r, c in _tiles(n, h, w, mi):
            plans = [StagePlan(f, r, c, mi, s) for s in STAGE_COUNTS if smem_bytes(StagePlan(f, r, c, mi, s)) <= BLOCK_SMEM]
            if not plans:
                continue
            plan = max(plans, key=lambda p: (blocks_per_sm(p, regs), p.stages))
            if blocks_per_sm(plan, regs) < 1:
                continue
            key = (plan_cost(plan, n, h, w, cout, sms, regs), block_count(plan, n, h, w, cout), mi)
            if best is None or key < best[0]:
                best = (key, plan)
    return best[1]


def card_stage_plan(n: int, h: int, w: int, cout: int, device: torch.device) -> StagePlan:
    """:func:`stage_plan` with the SMs and register-limited resident blocks of the card ``device``."""
    return stage_plan(n, h, w, cout, *stage_slots(device))


def stage_slots(device: torch.device) -> tuple[int, tuple[int, ...]]:
    """(SMs, blocks per SM of the kernel of each ``M_TILES`` by the CUDA occupancy calculator with no
    dynamic shared memory, i.e. by registers and threads) of the card ``device``."""
    index = _build.device_index(device)
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return sms, tuple(card_blocks_per_sm(mi, STAGE_COUNTS[0], 0, index) for mi in M_TILES)


@functools.lru_cache(maxsize=None)
def card_blocks_per_sm(m_tiles: int, stages: int, smem: int, device: int) -> int:
    """Resident blocks per SM of the kernel of (``m_tiles``, ``stages``) at ``smem`` bytes of dynamic shared
    memory, by the CUDA occupancy calculator of card ``device``."""
    lib = _build.load("fused_stage", _SIGNATURES)
    out = ctypes.c_int(0)
    with torch.cuda.device(device):
        code = lib.fused_conv_pool_stage_blocks_per_sm(m_tiles, stages, smem, ctypes.byref(out))
    _build.check(lib, code, "fused_conv_pool_stage: occupancy")
    return out.value


def fused_conv_pool_stage_plain(x: torch.Tensor, w: torch.Tensor, b_spatial: torch.Tensor) -> torch.Tensor:
    """The same function in plain PyTorch (``F.conv2d`` + bias map + ReLU + ``F.max_pool2d``), NHWC in and out."""
    with strict_f32():
        y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), padding=1)
    y = torch.relu(y + b_spatial.permute(2, 0, 1)[None])
    return F.max_pool2d(y, 3, 1).permute(0, 2, 3, 1).contiguous()


def _check_shapes(x: torch.Tensor, w: torch.Tensor, b_spatial: torch.Tensor) -> None:
    n, h, wd, cin = x.shape
    if w.shape[:3] != (3, 3, cin) or b_spatial.shape != (h, wd, w.shape[3]):
        raise ValueError(
            f"fused_conv_pool_stage: shapes x {tuple(x.shape)}, w {tuple(w.shape)}, "
            f"b_spatial {tuple(b_spatial.shape)} do not match"
        )
    if h < 3 or wd < 3:
        raise ValueError(f"fused_conv_pool_stage: the pool needs 3 ≤ H, W, got {h}×{wd}")


def fused_conv_pool_stage(x: torch.Tensor, w: torch.Tensor, b_spatial: torch.Tensor) -> torch.Tensor:
    """x (N, H, W, C), w (3, 3, C, Co) HWIO, b_spatial (H, W, Co) → (N, H−2, W−2, Co), in x's dtype.

    float32 takes this kernel, bf16 :func:`fused_conv_pool_stage_bf16`.  A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel with :func:`card_stage_plan`.
    """
    if x.dtype == torch.bfloat16:
        return fused_conv_pool_stage_bf16(x, w, b_spatial)
    if x.device.type == "cpu":
        return fused_conv_pool_stage_plain(x, w, b_spatial)
    if x.device.type != "cuda":
        raise ValueError(f"fused_conv_pool_stage: unsupported device {x.device}")
    _check_shapes(x, w, b_spatial)
    n, h, wd, _ = x.shape
    return _launch(x, w, b_spatial, card_stage_plan(max(n, 1), h, wd, w.shape[3], x.device))


def fused_conv_pool_stage_planned(x: torch.Tensor, w: torch.Tensor, b_spatial: torch.Tensor,
                                  plan: StagePlan) -> torch.Tensor:
    """The kernel with a given plan (the card tests and the plan sweep); CUDA tensors only."""
    if x.device.type != "cuda":
        raise ValueError(f"fused_conv_pool_stage_planned: CUDA tensors only, got {x.device}")
    _check_shapes(x, w, b_spatial)
    return _launch(x, w, b_spatial, plan)


def _launch(x: torch.Tensor, w: torch.Tensor, b_spatial: torch.Tensor, plan: StagePlan) -> torch.Tensor:
    _build.refuse_grad("fused_conv_pool_stage", x, w, b_spatial)
    _build.require_dtype("fused_conv_pool_stage", x.device, torch.float32, x=x, w=w, b_spatial=b_spatial)
    n, h, wd, cin = x.shape
    cout = w.shape[3]
    out = torch.empty((n, h - 2, wd - 2, cout), dtype=torch.float32, device=x.device)
    if n == 0 or cout == 0:
        return out
    wp = torch.empty(workspace_floats(cin, cout), dtype=torch.float32, device=x.device)
    lib = _build.load("fused_stage", _SIGNATURES)
    with _build.on_device(x):
        code = lib.fused_conv_pool_stage(
            x.data_ptr(), w.data_ptr(), b_spatial.data_ptr(), wp.data_ptr(), out.data_ptr(), n, h, wd, cin, cout,
            plan.frames, plan.rows, plan.cols, plan.m_tiles, plan.stages, _build.stream_of(x),
        )
    _build.check(lib, code, "fused_conv_pool_stage")
    fused_conv_pool_stage.launches += 1
    return out


fused_conv_pool_stage.launches = 0


# ---------------------------------------------------------------- the bf16 and int8 forms (csrc/fused_stage_lowp.cu)


def _relu_pool(y: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(torch.relu(y), 3, 1).permute(0, 2, 3, 1)


def fused_conv_pool_stage_bf16_plain(x: torch.Tensor, w: torch.Tensor, b_spatial: torch.Tensor) -> torch.Tensor:
    """The bf16 form in plain PyTorch: the bf16 operands upcast, the convolution in strict float32, rounded to
    bf16, + the bias rounded again (the JAX package's bf16 conv then ``+ corr``), ReLU, pool; bf16 out."""
    with strict_f32():
        y = F.conv2d(x.to(torch.float32).permute(0, 3, 1, 2), w.to(torch.float32).permute(3, 2, 0, 1), padding=1)
    y = bf16_rounded(bf16_rounded(y) + b_spatial.to(torch.float32).permute(2, 0, 1)[None])
    return _relu_pool(y).to(torch.bfloat16).contiguous()


def fused_conv_pool_stage_int8_plain(x: torch.Tensor, w: torch.Tensor, b_spatial: torch.Tensor) -> torch.Tensor:
    """The int8 form in plain PyTorch: ``quantized_conv2d(x, w) + b_spatial`` in x's dtype (float32 or bf16),
    ReLU, pool.  ``w`` is the float32 (folded) weight: the form quantizes it per output channel."""
    n, h, wd, _ = x.shape
    if n == 0:   # no activation scale without activations
        return x.new_empty((0, h - 2, wd - 2, w.shape[3]))
    y = quant.quantized_conv2d(x, w, 1, 1) + b_spatial.to(x.dtype)
    return _relu_pool(y.permute(0, 3, 1, 2)).contiguous()


def _check_lowp(what: str, x: torch.Tensor, w: torch.Tensor, b_spatial: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    _check_shapes(x, w, b_spatial)
    _build.refuse_grad(what, x, w, b_spatial)


# ---------------------------------------------------------------- the wgmma plans: 2-int8 and 2-bf16

WGMMA_SHAPES = ((2, 128), (4, 64))  # built (m_tiles, block_n): m64 tiles per consumer warpgroup, channels a block
INT8_SHAPES = WGMMA_SHAPES
INT8_K_BYTES = 64                   # Cin is padded to a multiple of this many int8 channels (a weight stage's least)
INT8_RING_BYTES = 64 * 1024         # int8 weights in flight: stages of 64 or 128 input channels at one tap
BF16_K = 64                         # bf16: Cin a multiple of this (a stage's box of K stays inside its tap)
BF16_RING_BYTES = 96 * 1024         # bf16 weights in flight
WGMMA_FIXED = 64                    # a block's cost besides its MMAs and weight bytes (input tile, epilogue), in
                                    # units of one wgmma m64n128 of 32 bytes of K
WGMMA_BYTES_PER_UNIT = 1024         # L2 bytes of weights a block takes in the time of one such unit


class Int8Plan(NamedTuple):
    """How a wgmma conv-pool kernel (either form) tiles (N, H, W): ``frames`` per block, each cut into tiles of
    ``rows`` × ``cols`` pooled positions (the whole frame when they are H − 2 and W − 2); two consumer
    warpgroups of ``m_tiles`` m64 tiles each, so frames · (rows + 2) · (cols + 2) ≤ 128 · m_tiles conv
    positions; ``block_n`` output channels a block."""
    frames: int
    rows: int
    cols: int
    m_tiles: int
    block_n: int



def int8_cin(cin: int) -> int:
    """Input channels as the int8 kernel lays them out: ``cin`` rounded up to :data:`INT8_K_BYTES`."""
    return -(-cin // INT8_K_BYTES) * INT8_K_BYTES


def bf16_cin(cin: int) -> int:
    """Input channels as the bf16 kernel takes them: ``cin`` rounded up to :data:`BF16_K` (the wrapper pads x
    and w only off that multiple)."""
    return -(-cin // BF16_K) * BF16_K


def wgmma_k_bytes(plan: Int8Plan, cin_p: int, elem_bytes: int) -> int:
    """Bytes of input channels a stage of the kernel takes (KB): 128 on (2, 128) where the channels' bytes are a
    multiple of 128, else 64 (four m64 tiles' two A register sets take no more)."""
    return 128 if plan.m_tiles == 2 and (elem_bytes * cin_p) % 128 == 0 else 64


def _wgmma_smem(plan: Int8Plan, ring: int, row_bytes: int, kb: int, staged_bias: bool) -> int:
    """csrc/fused_stage_lowp.cu::wg_smem: 1024 bytes of alignment slack; the weight ring and the input ring (one
    or two buffers of one kb-byte chunk of the input tile, each a multiple of 1024), which the epilogue's float32
    conv tile reuses; one frame's bias tile: the int8 form's (rows of 4 · block_n + 16 bytes) and its block_n
    scales, or the bf16 form's block_n / 64 TMA boxes of 128 bytes a position (each a multiple of 1024, from a
    1024-byte boundary); the barriers (the weight ring's, room for the most stages, the input ring's and the
    bias tile's)."""
    m, p = block_positions(plan)
    input_buf = -(-kb * p // 1024) * 1024
    body = -(-max(ring + (1 if row_bytes // kb < 2 else 2) * input_buf, 4 * m * (plan.block_n + 4)) // 16) * 16
    per_frame = (plan.rows + 2) * (plan.cols + 2)
    barriers = 8 * (2 * (ring // (plan.block_n * 64)) + 5)
    if staged_bias:
        return 1024 + body + per_frame * (4 * plan.block_n + 16) + 4 * plan.block_n + barriers
    return 1024 + -(-body // 1024) * 1024 + plan.block_n // 64 * -(-per_frame * 128 // 1024) * 1024 + barriers


def int8_smem_bytes(plan: Int8Plan, cin_p: int) -> int:
    """Dynamic shared memory of an int8 block: the ring of :data:`INT8_RING_BYTES`, the input ring of ``cin_p``
    bytes a position, the staged bias tile and scales (:func:`_wgmma_smem`)."""
    return _wgmma_smem(plan, INT8_RING_BYTES, cin_p, wgmma_k_bytes(plan, cin_p, 1), True)


def bf16_smem_bytes(plan: Int8Plan, cin_p: int) -> int:
    """Dynamic shared memory of a bf16 block: the ring of :data:`BF16_RING_BYTES`, the input ring of 2 · ``cin_p``
    bytes a position and the bias tile's TMA boxes (:func:`_wgmma_smem`)."""
    return _wgmma_smem(plan, BF16_RING_BYTES, 2 * cin_p, wgmma_k_bytes(plan, cin_p, 2), False)


def int8_block_count(plan: Int8Plan, n: int, h: int, w: int, cout: int) -> int:
    """Blocks of a launch: frame groups × tiles per frame × channel slices."""
    tiles = math.ceil((h - 2) / plan.rows) * math.ceil((w - 2) / plan.cols)
    return math.ceil(n / plan.frames) * tiles * math.ceil(cout / plan.block_n)


def int8_plan_cost(plan: Int8Plan, n: int, h: int, w: int, cin: int, cout: int, sms: int) -> float:
    """The int8 plan model's time: blocks run one an SM (256 threads at over 128 registers each), each its m64 tiles'
    wgmma (in m64n128k32 units: 2 k-steps at each of 9 taps per 64 input channels) plus :data:`WGMMA_FIXED`."""
    m, _ = block_positions(plan)
    mma = math.ceil(m / 64) * plan.block_n / 128 * 2 * 9 * int8_cin(cin) // INT8_K_BYTES
    return math.ceil(int8_block_count(plan, n, h, w, cout) / sms) * (mma + WGMMA_FIXED)


def bf16_plan_cost(plan: Int8Plan, n: int, h: int, w: int, cin: int, cout: int, sms: int) -> float:
    """The bf16 plan model's time: blocks run one an SM, each the larger of its wgmma (every m64 tile of both
    warpgroups, in m64n128k16 units: 4 k-steps at each of 9 taps per 64 input channels) and its weight bytes
    through L2 (9 · Cin · block_n · 2, at :data:`WGMMA_BYTES_PER_UNIT` a unit), plus :data:`WGMMA_FIXED`: so a
    block of more rows pays its weights over more products."""
    cin_p = bf16_cin(cin)
    mma = 2 * plan.m_tiles * plan.block_n / 128 * 9 * cin_p / 16
    weight_units = 9 * cin_p * plan.block_n * 2 / WGMMA_BYTES_PER_UNIT
    return math.ceil(int8_block_count(plan, n, h, w, cout) / sms) * (max(mma, weight_units) + WGMMA_FIXED)


def _wgmma_plan(what: str, n: int, h: int, w: int, cin: int, cout: int, sms: int, smem, cost) -> Int8Plan:
    best = None
    for mt, bn in WGMMA_SHAPES:
        for f, r, c in _tiles(n, h, w, 2 * mt):
            plan = Int8Plan(f, r, c, mt, bn)
            if smem(plan) > BLOCK_SMEM:
                continue
            key = (cost(plan, n, h, w, cin, cout, sms), int8_block_count(plan, n, h, w, cout), mt)
            if best is None or key < best[0]:
                best = (key, plan)
    if best is None:
        raise ValueError(f"{what}: no tile of {cin} input channels fits a block's {BLOCK_SMEM} bytes of shared memory")
    return best[1]


@functools.lru_cache(maxsize=1024)
def int8_stage_plan(n: int, h: int, w: int, cin: int, cout: int, sms: int) -> Int8Plan:
    """The int8 kernel's plan for x (n, h, w, cin) → (n, h − 2, w − 2, cout) on a card of ``sms`` SMs: every
    tile of every built shape that fits a block's shared memory, by :func:`int8_plan_cost`, then the fewest
    blocks, then the smaller ``m_tiles``."""
    cin_p = int8_cin(cin)
    return _wgmma_plan("fused_conv_pool_stage_int8", n, h, w, cin, cout, sms,
                       lambda p: int8_smem_bytes(p, cin_p), int8_plan_cost)


@functools.lru_cache(maxsize=1024)
def bf16_stage_plan(n: int, h: int, w: int, cin: int, cout: int, sms: int) -> Int8Plan:
    """The bf16 kernel's plan, as :func:`int8_stage_plan` with :func:`bf16_smem_bytes` (two bytes a channel, no
    staged bias) and :func:`bf16_plan_cost` (which weighs a block's rows against its weight bytes); a
    ``ValueError`` when no tile fits."""
    cin_p = bf16_cin(cin)
    return _wgmma_plan("fused_conv_pool_stage_bf16", n, h, w, cin, cout, sms,
                       lambda p: bf16_smem_bytes(p, cin_p), bf16_plan_cost)


def stage_sms(device: torch.device) -> int:
    """SMs of the card ``device`` (the wgmma plans' one card input)."""
    return torch.cuda.get_device_properties(_build.device_index(device)).multi_processor_count


def card_bf16_stage_plan(n: int, h: int, w: int, cin: int, cout: int, device: torch.device) -> Int8Plan:
    """:func:`bf16_stage_plan` with the SMs of the card ``device``."""
    return bf16_stage_plan(n, h, w, cin, cout, stage_sms(device))


def _aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t`` (contiguous) itself on a 16-byte boundary, else a copy that is: the kernels read x in 16-byte words."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def fused_conv_pool_stage_bf16(x: torch.Tensor, w: torch.Tensor, b_spatial: torch.Tensor) -> torch.Tensor:
    """The bf16 form: x (N, H, W, C), w (3, 3, C, Co) HWIO, b_spatial (H, W, Co), all bf16 → (N, H−2, W−2, Co) bf16.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel once with
    :func:`card_bf16_stage_plan`, its weights read by TMA from w as stored.  Only off the kernel's multiples is
    anything copied: C off a multiple of 64 (x and w zero-padded), Co off a multiple of 8 (w's and b_spatial's
    channels), a tensor off a 16-byte boundary.  More than 2^31 positions raise ``ValueError`` before any
    launch; any C fits (the input tile arrives a chunk of channels at a time).
    """
    if x.device.type == "cpu":
        return fused_conv_pool_stage_bf16_plain(x, w, b_spatial)
    _check_shapes(x, w, b_spatial)
    n, h, wd, cin = x.shape
    cout = w.shape[3]
    if n * h * wd >= 2**31:
        raise ValueError(f"fused_conv_pool_stage_bf16: {n}×{h}×{wd} positions pass the kernel's 32-bit offsets")
    plan = card_bf16_stage_plan(max(n, 1), h, wd, cin, cout, x.device)
    _check_lowp("fused_conv_pool_stage_bf16", x, w, b_spatial)
    _build.require_dtype("fused_conv_pool_stage_bf16", x.device, torch.bfloat16, x=x, w=w, b_spatial=b_spatial)
    out = torch.empty((n, h - 2, wd - 2, cout), dtype=torch.bfloat16, device=x.device)
    if n == 0 or cout == 0:
        return out
    cin_p, c_cols = bf16_cin(cin), -(-cout // 8) * 8
    xk = _aligned16(_padded(x, (n, h, wd, cin_p)))
    wk = _aligned16(_padded(w, (3, 3, cin_p, c_cols)))
    bk = _aligned16(_padded(b_spatial, (h, wd, c_cols)))
    lib = _build.load("fused_stage_lowp", _LOWP_SIGNATURES)
    with _build.on_device(xk):
        code = lib.fused_conv_pool_stage_bf16(
            xk.data_ptr(), wk.data_ptr(), bk.data_ptr(), out.data_ptr(), n, h, wd, cin_p, cout, c_cols,
            plan.frames, plan.rows, plan.cols, plan.m_tiles, plan.block_n, _build.stream_of(xk),
        )
    _build.check(lib, code, "fused_conv_pool_stage_bf16")
    fused_conv_pool_stage_bf16.launches += 1
    return out


fused_conv_pool_stage_bf16.launches = 0


def _padded(t: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """``t`` zero-padded at the end of each axis to ``shape``, contiguous; ``t`` itself when it is contiguous at
    that shape already."""
    if tuple(t.shape) == shape and t.is_contiguous():
        return t
    out = t.new_zeros(shape)
    out[tuple(slice(0, d) for d in t.shape)] = t
    return out


def card_int8_stage_plan(n: int, h: int, w: int, cin: int, cout: int, device: torch.device) -> Int8Plan:
    """:func:`int8_stage_plan` with the SMs of the card ``device``."""
    sms = torch.cuda.get_device_properties(_build.device_index(device)).multi_processor_count
    return int8_stage_plan(n, h, w, cin, cout, sms)


def int8_workspace_bytes(n: int, h: int, w: int, cin: int, cout: int) -> int:
    """Bytes of one call's workspace (csrc/fused_stage_lowp.cu::int8_workspace), each part at a 256-byte
    boundary: the packed weights (cout, 3, 3, cin_p) int8, their scales (cout,) float32, the quantized
    activations (n, h, w, cin_p) int8, and 16 bytes for the amax bits, a block count and s_x."""
    cin_p = int8_cin(cin)

    def r(b):
        return -(-b // 256) * 256

    return r(cout * 9 * cin_p) + r(4 * cout) + r(n * h * w * cin_p) + 16


def pack_weights_int8_plain(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The weight pass in plain PyTorch, computed as the kernel computes it: per output channel the largest bit
    pattern of |w| (non-negative floats order as their bits), s = max(amax / 127, 1e-12) and q = clip(round(w / s),
    −127, 127) in float32, written into (Cout, 3, 3, Cin_p) with zeros in the padded channels; and s (Cout,)."""
    cin, cout = w.shape[2], w.shape[3]
    wf = w.to(torch.float32).permute(3, 0, 1, 2).contiguous()   # (Cout, 3, 3, Cin)
    s = quant.amax_scale(wf.abs().view(torch.int32).reshape(cout, -1).amax(dim=1).view(torch.float32))
    wq = torch.zeros((cout, 3, 3, int8_cin(cin)), dtype=torch.int8, device=w.device)
    wq[..., :cin] = torch.clamp(torch.round(wf / s.reshape(-1, 1, 1, 1)), -127, 127).to(torch.int8)
    return wq, s


def act_scale_int8_plain(x: torch.Tensor) -> torch.Tensor:
    """The activation scale in plain PyTorch, computed as the kernel computes it: the largest bit pattern of |x|
    in float32, then max(amax / 127, 1e-12); a float32 scalar."""
    return quant.amax_scale(x.abs().to(torch.float32).contiguous().view(torch.int32).amax().view(torch.float32))


def pack_weights_int8(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The int8 form's weight pass alone (the card tests and the timing of its own device time): w (3, 3, Cin,
    Cout) float32 → (wq (Cout, 3, 3, Cin_p) int8, s_w (Cout,) float32).  A CPU tensor takes the plain version; a
    CUDA tensor launches the kernel."""
    if w.device.type == "cpu":
        return pack_weights_int8_plain(w)
    _build.require_dtype("pack_weights_int8", w.device, torch.float32, w=w)
    cin, cout = w.shape[2], w.shape[3]
    wq = torch.empty((cout, 3, 3, int8_cin(cin)), dtype=torch.int8, device=w.device)
    s_w = torch.empty((cout,), dtype=torch.float32, device=w.device)
    lib = _build.load("fused_stage_lowp", _LOWP_SIGNATURES)
    with _build.on_device(w):
        code = lib.int8_pack_weights(w.data_ptr(), wq.data_ptr(), s_w.data_ptr(), cin, cout, _build.stream_of(w))
    _build.check(lib, code, "pack_weights_int8")
    pack_weights_int8.launches += 1
    return wq, s_w


pack_weights_int8.launches = 0


def act_scale_int8(x: torch.Tensor) -> torch.Tensor:
    """The int8 form's activation scale alone: max(max|x| / 127, 1e-12) for float32 or bf16 x, a float32 scalar.
    A CPU tensor takes the plain version; a CUDA tensor launches the kernel."""
    if x.device.type == "cpu":
        return act_scale_int8_plain(x)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"act_scale_int8: x must be float32 or bfloat16, got {x.dtype}")
    _build.require_dtype("act_scale_int8", x.device, x.dtype, x=x)
    x = _aligned16(x)
    scratch = torch.empty(2, dtype=torch.int32, device=x.device)
    s_x = torch.empty((), dtype=torch.float32, device=x.device)
    lib = _build.load("fused_stage_lowp", _LOWP_SIGNATURES)
    with _build.on_device(x):
        code = lib.int8_act_scale(x.data_ptr(), scratch.data_ptr(), s_x.data_ptr(), x.numel(),
                                  int(x.dtype == torch.bfloat16), _build.stream_of(x))
    _build.check(lib, code, "act_scale_int8")
    act_scale_int8.launches += 1
    return s_x


act_scale_int8.launches = 0


def fused_conv_pool_stage_int8(x: torch.Tensor, w: torch.Tensor, b_spatial: torch.Tensor) -> torch.Tensor:
    """The int8 form: x (N, H, W, C) float32 or bf16, w (3, 3, C, Co) float32 (folded, quantized here per output
    channel), b_spatial (H, W, Co) in x's dtype → (N, H−2, W−2, Co) in x's dtype.

    The activation scale is one ``amax`` over the whole batch tensor, so every frame's output depends on the
    batch.  A CPU tensor takes the plain version; a CUDA tensor runs one C entry: the scale, the activations'
    and the weights' quantization (C zero-padded to a multiple of 64) and the conv kernel with
    :func:`card_int8_stage_plan`, in a workspace allocated here (x off a 16-byte boundary is copied first).

    The launch sequence depends on the calling thread, not only on the arguments: on a thread inside
    ``ops/quant.py::batch_scales`` the scale is the batch's (this block's from :func:`act_scale_int8`, passed
    through the thread's reduction, and the C entry quantizes with the result), on any other thread the C
    entry's own.  Only ``parallel/serving.py::_run_blocks`` enters ``batch_scales``, on the block threads it
    starts and for the length of one block's forward; the mode is thread-local and ends with the block, so a
    single-device call on any other thread takes its own scale
    (``tests/test_torch_dp.py::TestDpFuse::test_batch_scales_stay_on_their_block_threads``).
    """
    if x.device.type == "cpu":
        return fused_conv_pool_stage_int8_plain(x, w, b_spatial)
    _check_lowp("fused_conv_pool_stage_int8", x, w, b_spatial)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"fused_conv_pool_stage_int8: x must be float32 or bfloat16, got {x.dtype}")
    _build.require_dtype("fused_conv_pool_stage_int8", x.device, x.dtype, x=x, b_spatial=b_spatial)
    _build.require_dtype("fused_conv_pool_stage_int8", x.device, torch.float32, w=w)
    n, h, wd, cin = x.shape
    cout = w.shape[3]
    out = torch.empty((n, h - 2, wd - 2, cout), dtype=x.dtype, device=x.device)
    if n == 0 or cout == 0:
        return out
    x = _aligned16(x)
    s_x = quant.shared_scale(act_scale_int8(x)) if quant.sharing_scales() else None
    plan = card_int8_stage_plan(n, h, wd, cin, cout, x.device)
    ws = torch.empty(int8_workspace_bytes(n, h, wd, cin, cout), dtype=torch.uint8, device=x.device)
    lib = _build.load("fused_stage_lowp", _LOWP_SIGNATURES)
    with _build.on_device(x):
        code = lib.fused_conv_pool_stage_int8(
            x.data_ptr(), w.data_ptr(), b_spatial.data_ptr(), out.data_ptr(), ws.data_ptr(), n, h, wd, cin, cout,
            int(x.dtype == torch.bfloat16), plan.frames, plan.rows, plan.cols, plan.m_tiles, plan.block_n,
            None if s_x is None else s_x.data_ptr(), _build.stream_of(x),
        )
    _build.check(lib, code, "fused_conv_pool_stage_int8")
    fused_conv_pool_stage_int8.launches += 1
    return out


fused_conv_pool_stage_int8.launches = 0
