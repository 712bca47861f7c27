"""The eval fusion MLP in one launch: CUDA kernel, its tile plan and its plain version.

Counterpart of ``cvml_goalnet_tpu/ops/pallas/fused_mlp.py`` (``_kernel``: the
whole chain per 256-row tile, held in VMEM).  ``layers`` is the fusion list of
``{"w": (in, out), "b": (out,)}``: 1 to 8 layers of any widths, ReLU between,
then ``(hi − lo)·σ + lo`` or the raw logits.

The kernel (``csrc/fused_mlp.cu``) is bound by arithmetic: 753,792 FMAs per
row at the reference widths 640 → 512 → 512 → 256 → 128 → 1, so 1.583 GFLOP at
M = 1050, 23.6 µs at the H100's 67 TFLOP/s float32 rate; the 3.02 MB of
weights cost 0.9 µs from HBM.  A cluster of C blocks owns each tile of BM
rows; each block computes about 1/C of every layer's columns from its own
slice of the weights, in 8 × 8 register tiles fed by a cp.async ring (K split
over thread groups where a slice is narrow), and hands its slice to every
block of the cluster through distributed shared memory.  :func:`tile_plan`
picks (BM, C) from M, the widths and how many clusters the card runs at once:
16 rows by 2 blocks (132 blocks) at M = 1050, where the kernel took
0.08–0.10 ms on an H100 (``chip_smoke.py``'s kernel phase; ``PERF.md``).

The bf16 form (:func:`fused_fusion_mlp_bf16`, the same source) runs the
chain on ``wgmma`` in bf16 on the float32 form's clusters (the weights by TMA
as stored, one launch a call, :func:`bf16_mlp_plan` picking rows per tile and
the cluster) and rounds each layer and the squash as the JAX package's bf16
forward does, so its scores lie on the bf16 grid; :func:`fused_fusion_mlp`
dispatches by dtype, and a CUDA tensor of a dtype no form takes raises.

The kernel has no backward (the JAX package's has no VJP either): on CUDA
tensors that require grad with grad mode on, the wrapper raises rather than
return an output that would cut the gradient.
"""

from __future__ import annotations

import ctypes
import functools
from collections.abc import Sequence

import torch

from cvml_goalnet_tpu_torch.device import strict_f32
from cvml_goalnet_tpu_torch.ops.cuda import _build
from cvml_goalnet_tpu_torch.utils import bf16_rounded

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "fused_mlp": [_P, _P, _I, _I, _P, _P, _P, _I, ctypes.c_float, ctypes.c_float, _I, _I, _P],
    "fused_mlp_max_clusters": [_I, _P, _I, _I, _P],
    "fused_mlp_bf16": [_P, _P, _I, _I, _I, _P, _P, _P, _P, _I, _I, _I, ctypes.c_float, ctypes.c_float, _P],
    "fused_mlp_bf16_max_clusters": [_I, _P, _I, _I, _P],
}
MAX_LAYERS = 8
SMEM_LIMIT = 232_448             # shared memory one block may use on Hopper
BLOCK_ROWS = (32, 24, 16, 8)     # the kernel's row tiles, as instantiated in csrc/fused_mlp.cu
MAX_CLUSTER = 8                  # the portable cluster size
THREADS, CHUNK_K, PASS_COLS, STAGES = 256, 32, 256, 3   # csrc/fused_mlp.cu: kThreads, kChunkK, kPassCols, kStages
RING_BYTES = STAGES * CHUNK_K * PASS_COLS * 4
# Clusters of C blocks an H100 SXM runs at once when one block fills an SM's shared memory
# (cudaOccupancyMaxActiveClusters in chip_smoke.py, PERF.md): a cluster lives in one GPC,
# so 33 clusters of 4 take two rounds.  The wrapper asks the card instead.
H100_CLUSTERS_AT_ONCE = {1: 132, 2: 66, 3: 39, 4: 30, 5: 22, 6: 17, 7: 15, 8: 15}
# The plan's cost model, per round of clusters: a fixed part, the busiest block's FMAs per thread and
# the weight bytes it copies into shared memory.  Least squares over every plan that fits at the
# summarization path's M on an H100 SXM (chip_smoke.py's plan sweep, PERF.md).
PLAN_FIXED_S = 41.4e-6
PLAN_S_PER_THREAD_FMA = 1.574e-9
PLAN_S_PER_WEIGHT_BYTE = 9.55e-12


def smem_bytes(block_rows: int, dims: Sequence[int]) -> int:
    """Shared memory of one block: two k-major activation buffers (the widest input of the even and of
    the odd layers) and the weight ring."""
    n_layers = len(dims) - 1
    even = max(dims[l] for l in range(0, n_layers, 2))
    odd = max((dims[l] for l in range(1, n_layers, 2)), default=0)
    return 4 * block_rows * (even + odd) + RING_BYTES


def cols_per_block(n: int, cluster: int) -> int:
    """Columns of an N-wide layer that each block of a cluster computes: ⌈N / C⌉ rounded up to 4."""
    return (-(-n // cluster) + 3) // 4 * 4


def block_work(dims: Sequence[int], block_rows: int, cluster: int) -> tuple[int, int]:
    """(FMAs per thread, weight bytes) of a cluster's first block, the busiest, as the kernel runs it:
    passes of up to 256 columns in 8 × 8 tiles, K split over G = 2^j thread groups."""
    fmas, weight_bytes = 0, 0
    for k, n in zip(dims[:-1], dims[1:]):
        mine = min(cols_per_block(n, cluster), n)
        for c0 in range(0, mine, PASS_COLS):
            tiles = block_rows // 8 * -(-min(PASS_COLS, mine - c0) // 8)
            g = 1
            while g < CHUNK_K and 2 * g * tiles <= THREADS:
                g *= 2
            fmas += -(-k // CHUNK_K) * (CHUNK_K // g) * 64
        weight_bytes += 4 * k * mine
    return fmas, weight_bytes


def plan_terms(m: int, dims: Sequence[int], block_rows: int, cluster: int, clusters_at_once: int) -> tuple[int, int, int]:
    """The cost model's inputs for a plan: rounds of at most ``clusters_at_once`` clusters, and the
    busiest block's FMAs per thread and weight bytes (:func:`block_work`)."""
    return (-(-(-(-m // block_rows)) // clusters_at_once), *block_work(dims, block_rows, cluster))


def plan_seconds(m: int, dims: Sequence[int], block_rows: int, cluster: int, clusters_at_once: int) -> float:
    """The cost model's time for a plan: each round the fixed part plus the busiest block's FMAs per
    thread and weight bytes at the fitted rates."""
    rounds, fmas, weight_bytes = plan_terms(m, dims, block_rows, cluster, clusters_at_once)
    return rounds * (PLAN_FIXED_S + fmas * PLAN_S_PER_THREAD_FMA + weight_bytes * PLAN_S_PER_WEIGHT_BYTE)


def tile_plan(m: int, dims: Sequence[int], clusters_at_once=None) -> tuple[int, int]:
    """(BM, C): rows per tile and blocks per cluster for ``m`` rows through layers of widths ``dims``.

    ``clusters_at_once(bm, c)`` says how many clusters of that plan the card
    runs at once; by default the H100 SXM's counts at one block per SM (the
    wrapper asks the card).  The plan of least :func:`plan_seconds` whose
    shared memory fits wins; ties go to fewer blocks, then a smaller cluster.
    """
    best = None
    for bm in BLOCK_ROWS:
        if smem_bytes(bm, dims) > SMEM_LIMIT:
            continue
        for c in range(1, MAX_CLUSTER + 1):
            at_once = clusters_at_once(bm, c) if clusters_at_once else H100_CLUSTERS_AT_ONCE[c]
            key = (plan_seconds(m, dims, bm, c, at_once), -(-m // bm) * c, c)
            if best is None or key < best[0]:
                best = (key, bm, c)
    if best is None:
        raise ValueError(f"fused_fusion_mlp: widths {list(dims)} need more than {SMEM_LIMIT} bytes of shared "
                         f"memory even at {min(BLOCK_ROWS)} rows per block")
    return best[1], best[2]


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

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel with :func:`tile_plan`'s
    plan for its M and widths on this card.
    """
    if x.dtype == torch.bfloat16:
        return fused_fusion_mlp_bf16(x, layers, out_lo, out_hi, squash)
    if x.device.type == "cpu":
        return fused_fusion_mlp_plain(x, layers, out_lo, out_hi, squash)
    if x.device.type != "cuda":
        raise ValueError(f"fused_fusion_mlp: unsupported device {x.device}")
    dims = _dims_of(x, layers)
    if x.shape[0] == 0:
        return torch.empty((0, dims[-1]), dtype=torch.float32, device=x.device)
    return _launch(x, layers, dims, *card_plan(x.shape[0], dims, x.device), out_lo, out_hi, squash)


def fused_fusion_mlp_planned(x: torch.Tensor, layers, block_rows: int, cluster: int, out_lo: float = 1.0,
                             out_hi: float = 5.0, squash: bool = True) -> torch.Tensor:
    """The kernel on CUDA tensors with a given plan (BM in ``BLOCK_ROWS``, 1 ≤ C ≤ 8), for the plan
    sweep of ``chip_smoke.py``; :func:`fused_fusion_mlp` picks the plan itself."""
    if x.device.type != "cuda":
        raise ValueError(f"fused_fusion_mlp_planned: the kernel runs on CUDA tensors, got {x.device}")
    return _launch(x, layers, _dims_of(x, layers), block_rows, cluster, out_lo, out_hi, squash)


def _launch(x, layers, dims, block_rows, cluster, out_lo, out_hi, squash) -> torch.Tensor:
    m = x.shape[0]
    y = torch.empty((m, dims[-1]), dtype=torch.float32, device=x.device)
    if m == 0:
        return y
    n_layers = len(layers)
    w_ptrs = (ctypes.c_void_p * n_layers)(*[lp["w"].data_ptr() for lp in layers])
    b_ptrs = (ctypes.c_void_p * n_layers)(*[lp["b"].data_ptr() for lp in layers])
    c_dims = (ctypes.c_int * (n_layers + 1))(*dims)
    lib = _build.load("fused_mlp", _SIGNATURES)
    with _build.on_device(x):
        code = lib.fused_mlp(
            x.data_ptr(), y.data_ptr(), m, n_layers, ctypes.cast(w_ptrs, _P), ctypes.cast(b_ptrs, _P),
            ctypes.cast(c_dims, _P), int(squash), out_lo, out_hi, block_rows, cluster, _build.stream_of(x),
        )
    _build.check(lib, code, "fused_fusion_mlp")
    fused_fusion_mlp.launches += 1
    return y


def _dims_of(x: torch.Tensor, layers) -> list[int]:
    """The chain's widths, after the checks of what the kernel takes."""
    if not 1 <= len(layers) <= MAX_LAYERS:
        raise ValueError(f"fused_fusion_mlp: the kernel takes 1 to {MAX_LAYERS} layers, got {len(layers)}")
    dims = [x.shape[1]]
    for i, lp in enumerate(layers):
        w, b = lp["w"], lp["b"]
        if w.shape[0] != dims[-1] or b.shape != (w.shape[1],):
            raise ValueError(f"fused_fusion_mlp: layer {i} w {tuple(w.shape)} b {tuple(b.shape)} does not chain from {dims[-1]}")
        dims.append(w.shape[1])
    _build.refuse_grad("fused_fusion_mlp", x, *(t for lp in layers for t in (lp["w"], lp["b"])))
    _build.require_dtype("fused_fusion_mlp", x.device, torch.float32, x=x,
                       **{f"layer{i}.{k}": lp[k] for i, lp in enumerate(layers) for k in ("w", "b")})
    return dims


def card_plan(m: int, dims: Sequence[int], device: torch.device) -> tuple[int, int]:
    """:func:`tile_plan` with the cluster occupancy of the card ``device`` (the input's): the plan
    ``fused_fusion_mlp`` launches."""
    return _plan_on_card(_build.device_index(device), m, tuple(dims))


@functools.lru_cache(maxsize=1024)
def _plan_on_card(device: int, m: int, dims: tuple[int, ...]) -> tuple[int, int]:
    return tile_plan(m, dims, lambda bm, c: _clusters_at_once(device, dims, bm, c))


def max_active_clusters(dims: Sequence[int], block_rows: int, cluster: int, device: torch.device) -> int:
    """How many clusters of the plan (block_rows, cluster) the card ``device`` runs at once, by the CUDA
    occupancy calculator."""
    return _clusters_at_once(_build.device_index(device), tuple(dims), block_rows, cluster)


@functools.lru_cache(maxsize=1024)
def _clusters_at_once(device: int, dims: tuple[int, ...], block_rows: int, cluster: int) -> int:
    lib = _build.load("fused_mlp", _SIGNATURES)
    c_dims = (ctypes.c_int * len(dims))(*dims)
    out = ctypes.c_int(0)
    with torch.cuda.device(device):
        code = lib.fused_mlp_max_clusters(len(dims) - 1, ctypes.cast(c_dims, _P), block_rows, cluster,
                                          ctypes.byref(out))
    _build.check(lib, code, "fused_fusion_mlp: occupancy")
    return out.value


fused_fusion_mlp.launches = 0


# ---------------------------------------------------------------- the bf16 form


def squash_bf16(x: torch.Tensor, out_lo: float, out_hi: float) -> torch.Tensor:
    """``(hi − lo)·σ(x) + lo`` on float32 tensors of bf16 values, rounded to bf16 after each operation as the
    JAX package's bf16 forward computes it: e = exp(−x), d = 1 + e, s = 1 / d, then bf16(hi − lo)·s and + lo."""
    scale, lo = _bf16_value(out_hi - out_lo), _bf16_value(out_lo)
    e = bf16_rounded(torch.exp(-x))
    s = bf16_rounded(1.0 / bf16_rounded(1.0 + e))
    return bf16_rounded(bf16_rounded(scale * s) + lo)


def fused_fusion_mlp_bf16_plain(x: torch.Tensor, layers, out_lo: float = 1.0, out_hi: float = 5.0,
                                squash: bool = True) -> torch.Tensor:
    """The bf16 form in plain PyTorch: each layer bf16(bf16(x·w in strict float32) + b), ReLU between, then
    :func:`squash_bf16`; bf16 out."""
    h = x.to(torch.float32)
    for i, lp in enumerate(layers):
        with strict_f32():
            h = torch.matmul(h, lp["w"].to(torch.float32))
        h = bf16_rounded(bf16_rounded(h) + lp["b"].to(torch.float32))
        if i < len(layers) - 1:
            h = torch.relu(h)
    return (squash_bf16(h, out_lo, out_hi) if squash else h).to(torch.bfloat16)


# the bf16 kernel's geometry (csrc/fused_mlp.cu): rows per tile (wgmma's N), the weight ring, the last layer
BF16_ROWS = (64, 32, 16)
# Clusters of the bf16 kernel an H100 SXM runs at once at the fusion widths, by rows per tile
# (cudaOccupancyMaxActiveClusters on the card, PERF.md): 64 and 32 rows take one CTA an SM, 16 two.
H100_BF16_CLUSTERS_AT_ONCE = {64: H100_CLUSTERS_AT_ONCE, 32: H100_CLUSTERS_AT_ONCE,
                              16: {1: 264, 2: 132, 3: 79, 4: 62, 5: 47, 6: 39, 7: 32, 8: 30}}
BF16_STAGES, BF16_STAGE_BYTES = 8, 64 * 64 * 2
BF16_MAX_LAST = 16                 # the widest last layer (it runs on the CUDA cores)
# The plan's cost model, per round of clusters: a fixed part, the busiest CTA's weight bytes (each crosses
# L2 by TMA) and its m64nRk16 wgmma (in units of m64n64k16).  Least squares over every plan at the
# summarization path's M and each video's on an H100 SXM (chip_smoke.py's bf16 plan sweep, PERF.md).
BF16_PLAN_FIXED_S = 15.5e-6
BF16_PLAN_S_PER_WEIGHT_BYTE = 4.21e-11
BF16_PLAN_S_PER_MMA = 3.58e-8


def bf16_panels(width: int) -> int:
    """64-wide K panels that hold ``width`` activations in the kernel's shared memory."""
    return -(-width // 64)


def bf16_smem_bytes(rows: int, dims: Sequence[int]) -> int:
    """Shared memory of a CTA (csrc/fused_mlp.cu::bf16_smem_bytes): 1024 bytes of alignment slack, the two
    activation buffers (panels of ``rows`` × 128 bytes for the widest input of the even and of the odd
    layers), the weight ring and its barriers with the input's."""
    n_layers = len(dims) - 1
    even = max(bf16_panels(dims[l]) for l in range(0, n_layers, 2))
    odd = max((bf16_panels(dims[l]) for l in range(1, n_layers, 2)), default=0)
    return 1024 + (even + odd) * rows * 128 + BF16_STAGES * BF16_STAGE_BYTES + 8 * (2 * BF16_STAGES + 1)


def bf16_dims(dims: Sequence[int]) -> list[int]:
    """The chain's widths after the checks of what the bf16 kernel takes (a ``ValueError`` otherwise, before
    any launch): 1 to 8 layers, a last layer at most :data:`BF16_MAX_LAST` wide (it runs on the CUDA cores),
    and activations that fit a CTA's shared memory at 16 rows."""
    dims = list(dims)
    if not 1 <= len(dims) - 1 <= MAX_LAYERS:
        raise ValueError(f"fused_fusion_mlp_bf16: the kernel takes 1 to {MAX_LAYERS} layers, got {len(dims) - 1}")
    if dims[-1] > BF16_MAX_LAST:
        raise ValueError(f"fused_fusion_mlp_bf16: the last layer is {dims[-1]} wide; the kernel takes at most "
                         f"{BF16_MAX_LAST} (its last layer runs on the CUDA cores)")
    if bf16_smem_bytes(min(BF16_ROWS), dims) > SMEM_LIMIT:
        raise ValueError(f"fused_fusion_mlp_bf16: widths {dims} need more than {SMEM_LIMIT} bytes of shared memory "
                         f"even at {min(BF16_ROWS)} rows per tile")
    return dims


def bf16_cta_work(dims: Sequence[int], rows: int, cluster: int) -> tuple[int, int]:
    """(weight bytes, wgmma in m64n64k16 units) of a cluster's busiest CTA, rank 0: the 64-column tiles
    0, C, 2C, ... of every layer but the last, each ⌈K / 64⌉ stages of 8 KB and ⌈K / 16⌉ m64nRk16."""
    weight_bytes, mma = 0, 0.0
    for k, n in zip(dims[:-2], dims[1:-1]):
        mine = -(-bf16_panels(n) // cluster)
        weight_bytes += mine * bf16_panels(k) * BF16_STAGE_BYTES
        mma += mine * 4 * bf16_panels(k) * rows / 64
    return weight_bytes, mma


def bf16_plan_seconds(m: int, dims: Sequence[int], rows: int, cluster: int, clusters_at_once: int) -> float:
    """The cost model's time for a plan: rounds of at most ``clusters_at_once`` clusters, each the fixed part
    plus the busiest CTA's weight bytes and wgmma at the model's rates."""
    rounds = -(-(-(-m // rows)) // clusters_at_once)
    weight_bytes, mma = bf16_cta_work(dims, rows, cluster)
    return rounds * (BF16_PLAN_FIXED_S + weight_bytes * BF16_PLAN_S_PER_WEIGHT_BYTE + mma * BF16_PLAN_S_PER_MMA)


def bf16_mlp_plan(m: int, dims: Sequence[int], clusters_at_once=None) -> tuple[int, int]:
    """(R, C): rows per tile and CTAs per cluster of the bf16 kernel for ``m`` rows through widths ``dims``.

    ``clusters_at_once(r, c)`` says how many clusters of that plan the card runs at once; by default an
    H100 SXM's at the fusion widths (:data:`H100_BF16_CLUSTERS_AT_ONCE`; the wrapper asks the card).  The plan of least
    :func:`bf16_plan_seconds` whose shared memory fits wins; ties go to fewer CTAs, then a smaller cluster.
    """
    dims = bf16_dims(dims)
    best = None
    for r in BF16_ROWS:
        if bf16_smem_bytes(r, dims) > SMEM_LIMIT:
            continue
        for c in range(1, MAX_CLUSTER + 1):
            at_once = clusters_at_once(r, c) if clusters_at_once else H100_BF16_CLUSTERS_AT_ONCE[r][c]
            key = (bf16_plan_seconds(m, dims, r, c, at_once), -(-m // r) * c, c)
            if best is None or key < best[0]:
                best = (key, r, c)
    return best[1], best[2]


def fused_fusion_mlp_bf16(x: torch.Tensor, layers, out_lo: float = 1.0, out_hi: float = 5.0,
                          squash: bool = True) -> torch.Tensor:
    """The bf16 form: (N, D) bf16 features and bf16 layers → (N, out) bf16 scores (or logits).

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel once with
    :func:`card_bf16_mlp_plan`'s plan.  A shape the kernel cannot take raises ``ValueError`` before any launch
    (:func:`bf16_dims`); an input or hidden width off a multiple of 8 (TMA's 16-byte rows) is zero-padded.
    """
    if x.device.type == "cpu":
        return fused_fusion_mlp_bf16_plain(x, layers, out_lo, out_hi, squash)
    dims = _bf16_chain(x, layers)
    if x.device.type != "cuda":
        raise ValueError(f"fused_fusion_mlp_bf16: unsupported device {x.device}")
    return _launch_bf16(x, layers, dims, *card_bf16_mlp_plan(max(x.shape[0], 1), dims, x.device), out_lo, out_hi,
                        squash)


def fused_fusion_mlp_bf16_planned(x: torch.Tensor, layers, rows: int, cluster: int, out_lo: float = 1.0,
                                  out_hi: float = 5.0, squash: bool = True) -> torch.Tensor:
    """The bf16 kernel on CUDA tensors with a given plan (R in ``BF16_ROWS``, 1 ≤ C ≤ 8), for the card tests
    and ``chip_smoke.py``'s plan sweep; :func:`fused_fusion_mlp_bf16` picks the plan itself."""
    if x.device.type != "cuda":
        raise ValueError(f"fused_fusion_mlp_bf16_planned: the kernel runs on CUDA tensors, got {x.device}")
    return _launch_bf16(x, layers, _bf16_chain(x, layers), rows, cluster, out_lo, out_hi, squash)


def _bf16_chain(x: torch.Tensor, layers) -> list[int]:
    """The chain's widths after the shape checks (:func:`bf16_dims`), then the dtype and grad checks."""
    if not 1 <= len(layers) <= MAX_LAYERS:
        raise ValueError(f"fused_fusion_mlp_bf16: the kernel takes 1 to {MAX_LAYERS} layers, got {len(layers)}")
    dims = [x.shape[1]]
    for i, lp in enumerate(layers):
        if lp["w"].shape[0] != dims[-1] or lp["b"].shape != (lp["w"].shape[1],):
            raise ValueError(f"fused_fusion_mlp_bf16: layer {i} w {tuple(lp['w'].shape)} b {tuple(lp['b'].shape)} "
                             f"does not chain from {dims[-1]}")
        dims.append(lp["w"].shape[1])
    dims = bf16_dims(dims)
    _build.refuse_grad("fused_fusion_mlp_bf16", x, *(t for lp in layers for t in (lp["w"], lp["b"])))
    _build.require_dtype("fused_fusion_mlp_bf16", x.device, torch.bfloat16, x=x,
                         **{f"layer{i}.{k}": lp[k] for i, lp in enumerate(layers) for k in ("w", "b")})
    return dims


def _tma_ready(t: torch.Tensor, cols: int) -> torch.Tensor:
    """``t`` (2-D, contiguous) with ``cols`` columns on a 16-byte boundary, as TMA reads it: itself when it is
    already, else a zero-padded copy."""
    if t.shape[1] == cols and t.data_ptr() % 16 == 0:
        return t
    out = t.new_zeros((t.shape[0], cols))
    out[:, :t.shape[1]] = t
    return out


def _launch_bf16(x, layers, dims, rows, cluster, out_lo, out_hi, squash) -> torch.Tensor:
    m, n_layers = x.shape[0], len(layers)
    y = torch.empty((m, dims[-1]), dtype=torch.bfloat16, device=x.device)
    if m == 0:
        return y
    xk = _tma_ready(x, -(-dims[0] // 8) * 8)
    ws = [_tma_ready(lp["w"], -(-lp["w"].shape[1] // 8) * 8) for lp in layers[:-1]] + [layers[-1]["w"]]
    w_ptrs = (ctypes.c_void_p * n_layers)(*[w.data_ptr() for w in ws])
    cols = (ctypes.c_int * n_layers)(*[w.shape[1] for w in ws])
    b_ptrs = (ctypes.c_void_p * n_layers)(*[lp["b"].data_ptr() for lp in layers])
    c_dims = (ctypes.c_int * (n_layers + 1))(*dims)
    lib = _build.load("fused_mlp", _SIGNATURES)
    scale, lo = _bf16_value(out_hi - out_lo), _bf16_value(out_lo)
    with _build.on_device(x):
        code = lib.fused_mlp_bf16(
            xk.data_ptr(), y.data_ptr(), m, xk.shape[1], n_layers, ctypes.cast(w_ptrs, _P), ctypes.cast(cols, _P),
            ctypes.cast(b_ptrs, _P), ctypes.cast(c_dims, _P), rows, cluster, int(squash), scale, lo,
            _build.stream_of(x),
        )
    _build.check(lib, code, "fused_fusion_mlp_bf16")
    fused_fusion_mlp_bf16.launches += 1
    return y


def card_bf16_mlp_plan(m: int, dims: Sequence[int], device: torch.device) -> tuple[int, int]:
    """:func:`bf16_mlp_plan` with the cluster occupancy of the card ``device``: the plan
    ``fused_fusion_mlp_bf16`` launches."""
    return _bf16_plan_on_card(_build.device_index(device), m, tuple(dims))


@functools.lru_cache(maxsize=1024)
def _bf16_plan_on_card(device: int, m: int, dims: tuple[int, ...]) -> tuple[int, int]:
    return bf16_mlp_plan(m, dims, lambda r, c: bf16_clusters_at_once(device, dims, r, c))


@functools.lru_cache(maxsize=1024)
def bf16_clusters_at_once(device: int, dims: tuple[int, ...], rows: int, cluster: int) -> int:
    """How many clusters of the bf16 plan (rows, cluster) card ``device`` runs at once (CUDA's occupancy
    calculator)."""
    lib = _build.load("fused_mlp", _SIGNATURES)
    c_dims = (ctypes.c_int * len(dims))(*dims)
    out = ctypes.c_int(0)
    with torch.cuda.device(device):
        code = lib.fused_mlp_bf16_max_clusters(len(dims) - 1, ctypes.cast(c_dims, _P), rows, cluster,
                                               ctypes.byref(out))
    _build.check(lib, code, "fused_fusion_mlp_bf16: occupancy")
    return out.value


fused_fusion_mlp_bf16.launches = 0


@functools.lru_cache(maxsize=64)
def _bf16_value(v: float) -> float:
    """``v`` rounded to bf16 (the squash's constants, as the JAX package's bf16 forward casts them)."""
    return float(torch.tensor(v).to(torch.bfloat16))
