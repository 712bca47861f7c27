"""Flash attention, full and banded: CUDA kernels, their plain versions and the differentiable public functions.

Counterpart of ``cvml_goalnet_tpu/ops/pallas/flash_attention.py``.  q, k and
v are (H, T, d) float32 as in the JAX package.

* :func:`flash_fwd` (``_flash_fwd``) and :func:`flash_local_fwd`
  (``_flash_local_fwd``) are the forward kernel wrappers; each returns
  ``(out, lse)`` with ``lse`` (H, Tq) float32, a row's log-sum-exp of its
  scaled scores.
* :func:`flash_bwd` (``_flash_bwd``) and :func:`flash_local_bwd`
  (``_flash_local_bwd``) are the backward kernel wrappers: ``(dq, dk, dv)``
  from q, k, v, the forward's out and lse, the cotangent of out and, for the
  full form, that of lse (``di = rowsum(dout·out) − g_lse``, torch ops before
  the launch, as XLA outside Pallas in the JAX package).
* A CPU tensor takes each wrapper's plain version; a CUDA tensor launches the
  kernel (``csrc/flash_attention.cu``) on the tensor's card or raises.  The
  forward wrappers keep no graph: called on CUDA tensors that require grad
  with grad mode on, they raise rather than cut the gradient.
* The kernels are built for head widths 32, 64, 128 and 256; any other head
  up to 256 runs zero-padded to the next of them (:func:`pad_head_dim`) with
  the scale of its true width, and its outputs are sliced back.  Past 256 a
  head runs zero-padded to a multiple of :data:`WIDE_CHUNK` on the wide path
  of the FP32-core kernels, which walk d in chunks of that width and write
  one column slice of the outputs per block (:func:`padded_head_dim`).
* :func:`flash_fwd` runs on the tensor cores in 3xTF32 (kernel 5) at widths
  up to 128, with the plan of :func:`card_fwd_plan`, and
  :func:`flash_local_fwd` (kernel 7, kernel 5's template with the band) with
  that of :func:`card_local_fwd_plan`; :func:`flash_bwd` too (kernel 6), with
  the plan of :func:`card_bwd_plan`, and :func:`flash_local_bwd` (kernel 8,
  kernel 6's template with the band), with the plan of
  :func:`card_local_bwd_plan`.  The banded kernels' tiles walk only the
  chunks that meet their band (:func:`local_fwd_chunks`,
  :func:`local_bwd_chunks`).  When one head's tiles leave the card's
  resident blocks (its occupancy calculator's) unfilled, each block's walk
  is split and float32 partials (scratch allocated here) are combined in
  split order by the entry's last kernel.  At 256 and on the wide path all
  four run FP32-core kernels, unsplit.
* :func:`flash_attention` (also under the JAX name
  :func:`flash_attention_trainable`), :func:`flash_attention_with_lse`,
  :func:`flash_attention_local` and :func:`flash_attention_local_bounded`
  keep the JAX names and return values, and are differentiable on both
  devices: ``torch.autograd.Function`` s whose forward is the forward wrapper
  and whose backward is the backward wrapper, saving ``q, k, v, out, lse``.
  ``t_valid``, ``lo``, ``hi``, ``window`` and ``q_offset`` get no gradient, as
  the JAX VJPs return zeros for them.

Masking, in kernels and plain versions alike: keys at ``j >= t_valid``
(``t_valid`` clamped to [0, Tk]) for the full form; outside
``|i + q_offset − j| ≤ window`` or outside ``[lo, hi)`` for the banded form.
A row with no valid key gives out 0 and lse 0, as the TPU kernels do; in the
backward its probabilities are exactly 0, so it gets dq = 0 and adds nothing
to dk and dv.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from cvml_goalnet_tpu_torch.device import strict_f32
from cvml_goalnet_tpu_torch.ops.cuda import _build

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "flash_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _P, _P, _P],
    "flash_fwd_blocks_per_sm": [_I, _I, _P],
    "flash_local_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _I, _I, _I, _P, _P, _P],
    "flash_bwd": [_P] * 9 + [_I, _I, _I, _I, _F, _I, _I, _I, _P, _P, _P],
    "flash_local_bwd": [_P] * 9 + [_I, _I, _I, _I, _F, _I, _I, _I, _I, _I, _I, _P, _P, _P],
    "flash_bwd_blocks_per_sm": [_I, _I, _P],
}
HEAD_DIMS = (32, 64, 128, 256)  # the head widths the kernels are built for; other heads are zero-padded
WIDE_CHUNK = 128                 # past 256: the wide path's chunk of d and column slice (csrc kDC)
# The full and banded forwards (kernels 5 and 7) on the tensor cores, at the widths FWD_STREAM names: a block
# owns 64 query rows and streams the keys and values in chunks of FWD_STREAM[d].
FWD_TILE = 64
FWD_STREAM = {32: 64, 64: 64, 128: 32}
# The full and banded backwards (csrc/flash_attention.cu, kernels 6 and 8) on the tensor cores, at the
# widths BWD_STREAM names: a block owns 64 rows (keys for dK/dV, queries for dQ) and streams the other side
# through shared memory in chunks of BWD_STREAM[d] rows.
BWD_TILE = FWD_TILE   # csrc kTcTile, the stationary tile of all four (local_chunk_range serves kernels 7 and 8)
BWD_STREAM = {32: 32, 64: 32, 128: 16}
MAX_SPLIT = 8   # splits of a block's walk, kernels 5 to 8


def _default_scale(q: torch.Tensor, scale: float | None) -> float:
    return 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)


def _t_valid(tk: int, t_valid) -> int:
    return tk if t_valid is None else min(max(int(t_valid), 0), tk)


def _full_valid(q, k, t_valid) -> torch.Tensor:
    """(1, 1, Tk) mask of the keys below ``t_valid``."""
    tk = k.shape[1]
    return (torch.arange(tk, device=q.device) < _t_valid(tk, t_valid))[None, None, :]


def _band_valid(q, k, window: int, lo, hi, q_offset: int) -> torch.Tensor:
    """(1, Tq, Tk) mask of ``|i + q_offset − j| ≤ window`` with keys in ``[lo, hi)``."""
    tq, tk = q.shape[1], k.shape[1]
    lo = 0 if lo is None else int(lo)
    hi = tk if hi is None else int(hi)
    i = torch.arange(tq, device=q.device) + q_offset
    j = torch.arange(tk, device=q.device)
    return (((i[:, None] - j[None, :]).abs() <= window) & (j >= lo)[None, :] & (j < hi)[None, :])[None]


def _masked_attention(q, k, v, scale: float, valid: torch.Tensor):
    """Softmax attention over the keys ``valid`` marks (broadcast to (H, Tq, Tk)) → (out, lse)."""
    with strict_f32():
        s = torch.matmul(q, k.transpose(1, 2)) * scale
    s = s.masked_fill(~valid, float("-inf"))
    lse = torch.logsumexp(s, dim=-1)
    dead = torch.isneginf(lse)
    p = torch.softmax(s, dim=-1).masked_fill(dead[..., None], 0.0)  # dead rows: NaN → 0
    with strict_f32():
        out = torch.matmul(p, v)
    return out, lse.masked_fill(dead, 0.0)


def _masked_attention_bwd(q, k, v, lse, dout, di, scale: float, valid: torch.Tensor):
    """The kernels' backward in whole matrices: P from lse, exactly 0 where masked, then dq, dk, dv."""
    with strict_f32():
        s = torch.matmul(q, k.transpose(1, 2)) * scale
    p = torch.where(valid, torch.exp(s - lse[..., None]), 0.0)
    with strict_f32():
        dv = torch.matmul(p.transpose(1, 2), dout)
        dp = torch.matmul(dout, v.transpose(1, 2))
    ds = p * (dp - di[..., None])
    with strict_f32():
        dq = torch.matmul(ds, k) * scale
        dk = torch.matmul(ds.transpose(1, 2), q) * scale
    return dq, dk, dv


def _di(out, dout, g_lse) -> torch.Tensor:
    """rowsum(dout·out) − g_lse: the lse cotangent folds into ``ds = p·(dp − di)`` since ∂lse/∂s = p."""
    di = (dout * out).sum(-1)
    return di if g_lse is None else di - g_lse


def flash_fwd_plain(q, k, v, scale: float, t_valid=None):
    """The full forward in plain PyTorch: the whole (H, Tq, Tk) score matrix at once."""
    return _masked_attention(q, k, v, scale, _full_valid(q, k, t_valid))


def flash_local_fwd_plain(q, k, v, scale: float, window: int, lo=None, hi=None, q_offset: int = 0):
    """The banded forward in plain PyTorch: the full score matrix under the band and bounds mask."""
    return _masked_attention(q, k, v, scale, _band_valid(q, k, window, lo, hi, q_offset))


def flash_bwd_plain(q, k, v, out, lse, dout, scale: float, t_valid=None, g_lse=None):
    """The full backward in plain PyTorch → (dq, dk, dv)."""
    return _masked_attention_bwd(q, k, v, lse, dout, _di(out, dout, g_lse), scale, _full_valid(q, k, t_valid))


def flash_local_bwd_plain(q, k, v, out, lse, dout, scale: float, window: int, lo=None, hi=None,
                          q_offset: int = 0):
    """The banded backward in plain PyTorch → (dq, dk, dv)."""
    return _masked_attention_bwd(q, k, v, lse, dout, _di(out, dout, None), scale,
                                 _band_valid(q, k, window, lo, hi, q_offset))


def _check_qkv(what: str, q, k, v) -> None:
    if q.dim() != 3 or k.dim() != 3 or v.shape != k.shape or q.shape[0] != k.shape[0] or q.shape[2] != k.shape[2]:
        raise ValueError(
            f"{what}: q (H, Tq, d) and k, v (H, Tk, d) expected, got q {tuple(q.shape)}, "
            f"k {tuple(k.shape)}, v {tuple(v.shape)}"
        )


def _check_device(what: str, q) -> bool:
    """True for a CPU tensor (the plain version), False for CUDA (the kernel); raises for anything else."""
    if q.device.type == "cpu":
        return True
    if q.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {q.device}")
    return False


def padded_head_dim(d: int) -> int:
    """The width a head of ``d`` runs at: the next of :data:`HEAD_DIMS`, or past 256 the next multiple of
    :data:`WIDE_CHUNK` (the wide path)."""
    for width in HEAD_DIMS:
        if d <= width:
            return width
    return -(-d // WIDE_CHUNK) * WIDE_CHUNK


def pad_head_dim(t: torch.Tensor, width: int) -> torch.Tensor:
    """``t`` (..., d) with zero columns up to ``width``, contiguous.  Zero columns of q, k, v and dout add
    nothing to any score q·k, to lse or to ``di = rowsum(dout·out)``, so the padded call's first d columns
    of out, dq, dk and dv are the unpadded call's."""
    return torch.nn.functional.pad(t, (0, width - t.shape[-1])).contiguous() if t.shape[-1] < width else t


def _check_kernel_inputs(what: str, q, k, v, **more) -> None:
    _build.require_dtype(what, q.device, torch.float32, q=q, k=k, v=v, **more)
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError(f"{what}: q, k and v must start on 16-byte boundaries")


def _launch(entry: str, q, k, v, *args, splits: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Check what the forward kernels take, pad the head to a built width, allocate out, lse and the split
    partials, launch ``entry``; out is sliced back to the true width.  ``args`` are the full form's
    ``(scale, t_valid)`` or the band's ``(scale, window, lo, hi, q_offset)``; ``splits`` (None: the card's
    plan, :func:`card_fwd_plan` or :func:`card_local_fwd_plan`) splits kernel 5's or 7's walk."""
    _build.refuse_grad(entry, q, k, v)
    _check_kernel_inputs(entry, q, k, v)
    h, tq, d = q.shape
    width = padded_head_dim(d)
    q, k, v = (pad_head_dim(t, width) for t in (q, k, v))
    out = torch.empty_like(q)
    lse = torch.empty((h, tq), dtype=torch.float32, device=q.device)
    if h * tq == 0:
        return out[..., :d], lse
    if splits is None:   # kernel 5's or 7's plan at the tensor-core widths; past them the FP32-core kernels, unsplit
        if width not in FWD_STREAM:
            splits = 1
        elif entry == "flash_fwd":
            splits = card_fwd_plan(h, tq, args[-1], width, q.device).splits
        else:
            splits = card_local_fwd_plan(h, tq, k.shape[1], width, *args[1:], q.device).splits
    # each split's unnormalised out and its row max and sum, combined in split order by the entry's last kernel
    part_o = torch.empty((splits, h, tq, width), device=q.device) if splits > 1 else None
    part_ml = torch.empty((splits, h, tq, 2), device=q.device) if splits > 1 else None
    args = (*args, splits, _ptr(part_o), _ptr(part_ml))
    lib = _build.load("flash_attention", _SIGNATURES)
    with _build.on_device(q):
        code = getattr(lib, entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(), h, tq, k.shape[1], width,
            *args, _build.stream_of(q),
        )
    _build.check(lib, code, entry)
    return (out if width == d else out[..., :d].contiguous()), lse


def split_ranges(n: int, s: int) -> list[tuple[int, int]]:
    """The chunks ``[i·n // s, (i + 1)·n // s)`` that split i of s walks, as the kernels compute them."""
    return [(i * n // s, (i + 1) * n // s) for i in range(s)]


class FwdPlan(NamedTuple):
    """How kernel 5 or 7 runs: 64-row query tiles, keys streamed in chunks of ``stream``, each walk cut in
    splits."""
    tile: int       # query rows per block
    stream: int     # keys per streamed chunk
    splits: int     # splits of a block's walk over the key chunks


def full_fwd_plan(h: int, tq: int, kv_end: int, d: int, slots: int) -> FwdPlan:
    """Kernel 5's plan for (h, tq, d) queries over ``kv_end`` valid keys (``d`` a tensor-core width) on a
    card that keeps ``slots`` of its blocks resident at once: h·⌈tq/64⌉ blocks, each walk split (as
    :func:`_splits` decides) when they leave the slots unfilled."""
    stream = FWD_STREAM[d]
    return FwdPlan(FWD_TILE, stream, _splits(h * -(-tq // FWD_TILE), -(-kv_end // stream), slots))


def card_fwd_plan(h: int, tq: int, kv_end: int, d: int, device: torch.device) -> FwdPlan:
    """:func:`full_fwd_plan` with the resident slots of the card ``device``: the plan ``flash_fwd`` launches."""
    return full_fwd_plan(h, tq, kv_end, d, fwd_slots(d, device))


def fwd_slots(d: int, device: torch.device, band: bool = False) -> int:
    """Blocks of kernel 5's tile kernel, or with ``band`` of kernel 7's, the card ``device`` keeps resident at
    once: its SMs × :func:`fwd_blocks_per_sm`."""
    return _fwd_slots_on_card(_build.device_index(device), d, band)


@functools.lru_cache(maxsize=None)
def _fwd_slots_on_card(device: int, d: int, band: bool) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count * fwd_blocks_per_sm(d, device, band)


def fwd_blocks_per_sm(d: int, device: torch.device, band: bool = False) -> int:
    """Blocks of kernel 5's tile kernel, or with ``band`` of kernel 7's, the card ``device`` keeps resident
    per SM, by the CUDA occupancy calculator (``d`` a tensor-core width)."""
    lib = _build.load("flash_attention", _SIGNATURES)
    out = ctypes.c_int(0)
    with torch.cuda.device(device):
        _build.check(lib, lib.flash_fwd_blocks_per_sm(d, int(band), ctypes.byref(out)), "flash_fwd: occupancy")
    return out.value


class BwdPlan(NamedTuple):
    """How kernel 6 or 8 runs: 64-row tiles, streamed in chunks of ``stream`` rows, each walk cut in splits."""
    tile_q: int     # query rows per dQ block
    tile_k: int     # keys per dK/dV block
    stream: int     # rows per streamed chunk (queries for dK/dV, keys for dQ)
    s_dkv: int      # splits of a dK/dV block's walk over the query chunks
    s_dq: int       # splits of a dQ block's walk over the key chunks


def _splits(tiles: int, chunks: int, slots: int) -> int:
    """Splits of each of ``tiles`` blocks' walk over ``chunks`` streamed chunks.

    1 once the tiles alone fill the ``slots`` the card keeps resident; below that, the s of least
    rounds/s (rounds of ``slots`` blocks, each split doing 1/s of the walk), a larger s only for a gain
    of a tenth or more, with at least two chunks per split and at most MAX_SPLIT.
    """
    if tiles >= slots:
        return 1
    best, best_cost = 1, 1.0
    for s in range(2, min(chunks // 2, MAX_SPLIT) + 1):
        cost = -(-tiles * s // slots) / s
        if cost < 0.9 * best_cost:
            best, best_cost = s, cost
    return best


def full_bwd_plan(h: int, tq: int, tk: int, d: int, slots: tuple[int, int]) -> BwdPlan:
    """Kernel 6's plan for (h, tq, d) queries over (h, tk, d) keys (``d`` a built width) on a card that
    keeps ``slots`` = (dK/dV, dQ) blocks resident at once.

    Each kernel gets h·⌈T/64⌉ blocks; when they leave its slots unfilled, each block's walk is split
    so the grid fills whole rounds, and the splits' float32 partial sums are added in split order
    afterwards.
    """
    stream = BWD_STREAM[d]
    s_dkv = _splits(h * -(-tk // BWD_TILE), -(-tq // stream), slots[0])
    s_dq = _splits(h * -(-tq // BWD_TILE), -(-tk // stream), slots[1])
    return BwdPlan(BWD_TILE, BWD_TILE, stream, s_dkv, s_dq)


def card_bwd_plan(h: int, tq: int, tk: int, d: int, device: torch.device) -> BwdPlan:
    """:func:`full_bwd_plan` with the resident slots of the card ``device`` (the input's): the plan
    ``flash_bwd`` launches."""
    return full_bwd_plan(h, tq, tk, d, bwd_slots(d, device))


def bwd_slots(d: int, device: torch.device, band: bool = False) -> tuple[int, int]:
    """Blocks of kernel 6's (dK/dV, dQ) kernels, or with ``band`` of kernel 8's, the card ``device`` keeps
    resident at once: its SMs × :func:`bwd_blocks_per_sm`."""
    return _slots_on_card(_build.device_index(device), d, band)


@functools.lru_cache(maxsize=None)
def _slots_on_card(device: int, d: int, band: bool) -> tuple[int, int]:
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    per_sm_dkv, per_sm_dq = bwd_blocks_per_sm(d, device, band)
    return sms * per_sm_dkv, sms * per_sm_dq


def bwd_blocks_per_sm(d: int, device: torch.device, band: bool = False) -> tuple[int, int]:
    """Blocks of kernel 6's (dK/dV, dQ) kernels, or with ``band`` of kernel 8's, the card ``device`` keeps
    resident per SM, by the CUDA occupancy calculator (``d`` a tensor-core width)."""
    lib = _build.load("flash_attention", _SIGNATURES)
    got = []
    for which in ((2, 3) if band else (0, 1)):
        out = ctypes.c_int(0)
        with torch.cuda.device(device):
            _build.check(lib, lib.flash_bwd_blocks_per_sm(d, which, ctypes.byref(out)), "flash_bwd: occupancy")
        got.append(out.value)
    return got[0], got[1]


def band_limits(tq: int, tk: int, window: int, lo: int, hi: int, q_offset: int) -> tuple[int, int, int, int]:
    """Kernel 7's and 8's band as (k_lo, k_hi, d_lo, d_hi): keys valid in ``[k_lo, k_hi)`` and key − query in
    ``[d_lo, d_hi]``, i.e. ``|query + q_offset − key| ≤ window`` with keys in ``[lo, hi) ∩ [0, tk)``.  The
    differences are clamped to [−tq, tk], past which no pair's lies, as the kernel keeps them in an int."""
    diff = lambda x: min(max(x, -tq), tk)
    return max(lo, 0), min(max(hi, 0), tk), diff(q_offset - window), diff(q_offset + window)


def local_chunk_range(dkv: bool, r0: int, tq: int, tk: int, limits: tuple[int, int, int, int],
                      stream: int) -> tuple[int, int]:
    """The streamed chunks ``[first, end)`` of ``stream`` rows that the stationary 64-row tile at ``r0`` of
    kernel 8 (or, with ``dkv`` False, of kernel 7) walks, as ``TcBand::chunks`` computes them: for a tile of
    keys (``dkv``) the query chunks its valid keys' bands reach, for a tile of query rows the key chunks within
    their bands and ``[k_lo, k_hi)``; (0, 0) when there are none.  ``limits`` is :func:`band_limits`'s."""
    k_lo, k_hi, d_lo, d_hi = limits
    if dkv:
        kb, ke = max(r0, k_lo), min(r0 + BWD_TILE, k_hi) - 1
        first, last = max(kb - d_hi, 0), (min(ke - d_lo, tq - 1) if kb <= ke else -1)
    else:
        first, last = max(r0 + d_lo, k_lo), min(min(r0 + BWD_TILE, tq) - 1 + d_hi, k_hi - 1)
    return (0, 0) if first > last else (first // stream, last // stream + 1)


def local_bwd_chunks(tq: int, tk: int, window: int, lo: int, hi: int, q_offset: int,
                     stream: int) -> tuple[list[tuple[int, int]], list[tuple[int, int]]]:
    """Kernel 8's walk: for each 64-key tile (dK/dV) and each 64-row tile (dQ), the streamed chunks
    ``[first, end)`` it walks (:func:`local_chunk_range`); split i of s walks chunks
    ``first + [i·n // s, (i + 1)·n // s)`` of its tile's n (:func:`split_ranges`)."""
    limits = band_limits(tq, tk, window, lo, hi, q_offset)
    dkv = [local_chunk_range(True, r0, tq, tk, limits, stream) for r0 in range(0, tk, BWD_TILE)]
    dq = [local_chunk_range(False, r0, tq, tk, limits, stream) for r0 in range(0, tq, BWD_TILE)]
    return dkv, dq


@functools.lru_cache(maxsize=256)
def local_bwd_plan(h: int, tq: int, tk: int, d: int, window: int, lo: int, hi: int, q_offset: int,
                   slots: tuple[int, int]) -> BwdPlan:
    """Kernel 8's plan for the band ``|i + q_offset − j| ≤ window``, keys in ``[lo, hi)``, of (h, tq, d)
    queries over (h, tk, d) keys (``d`` a tensor-core width) on a card that keeps ``slots`` = (dK/dV, dQ)
    blocks resident at once: :func:`full_bwd_plan`'s rule with the band's chunks, the most any tile walks,
    in place of T's."""
    stream = BWD_STREAM[d]
    dkv, dq = local_bwd_chunks(tq, tk, window, lo, hi, q_offset, stream)
    most = lambda ranges: max((end - first for first, end in ranges), default=0)
    return BwdPlan(BWD_TILE, BWD_TILE, stream, _splits(h * len(dkv), most(dkv), slots[0]),
                   _splits(h * len(dq), most(dq), slots[1]))


def card_local_bwd_plan(h: int, tq: int, tk: int, d: int, window: int, lo: int, hi: int, q_offset: int,
                        device: torch.device) -> BwdPlan:
    """:func:`local_bwd_plan` with kernel 8's resident slots on the card ``device`` (the input's): the plan
    ``flash_local_bwd`` launches."""
    return local_bwd_plan(h, tq, tk, d, window, lo, hi, q_offset, bwd_slots(d, device, band=True))


def local_fwd_chunks(tq: int, tk: int, window: int, lo: int, hi: int, q_offset: int,
                     stream: int) -> list[tuple[int, int]]:
    """Kernel 7's walk: for each 64-row query tile, the key chunks ``[first, end)`` it walks
    (:func:`local_chunk_range`); split i of s walks chunks ``first + [i·n // s, (i + 1)·n // s)`` of its
    tile's n (:func:`split_ranges`)."""
    limits = band_limits(tq, tk, window, lo, hi, q_offset)
    return [local_chunk_range(False, r0, tq, tk, limits, stream) for r0 in range(0, tq, FWD_TILE)]


@functools.lru_cache(maxsize=256)
def local_fwd_plan(h: int, tq: int, tk: int, d: int, window: int, lo: int, hi: int, q_offset: int,
                   slots: int) -> FwdPlan:
    """Kernel 7's plan for the band ``|i + q_offset − j| ≤ window``, keys in ``[lo, hi)``, of (h, tq, d)
    queries over (h, tk, d) keys (``d`` a tensor-core width) on a card that keeps ``slots`` of its blocks
    resident at once: :func:`full_fwd_plan`'s rule with the most chunks any tile of the band walks in place
    of the valid keys'."""
    stream = FWD_STREAM[d]
    ranges = local_fwd_chunks(tq, tk, window, lo, hi, q_offset, stream)
    most = max((end - first for first, end in ranges), default=0)
    return FwdPlan(FWD_TILE, stream, _splits(h * len(ranges), most, slots))


def card_local_fwd_plan(h: int, tq: int, tk: int, d: int, window: int, lo: int, hi: int, q_offset: int,
                        device: torch.device) -> FwdPlan:
    """:func:`local_fwd_plan` with kernel 7's resident slots on the card ``device`` (the input's): the plan
    ``flash_local_fwd`` launches."""
    return local_fwd_plan(h, tq, tk, d, window, lo, hi, q_offset, fwd_slots(d, device, band=True))


def _launch_bwd(entry: str, q, k, v, out, lse, dout, g_lse, *args,
                splits: tuple[int, int] | None = None) -> tuple[torch.Tensor, ...]:
    """Compute di, check what the backward kernels take, pad the head to a built width, allocate dq, dk,
    dv and the split partials, launch ``entry``; the gradients are sliced back.  ``args`` are the full
    form's ``(scale, t_valid)`` or the band's ``(scale, window, lo, hi, q_offset)``; ``splits`` (None: the
    card's plan) forces (s_dkv, s_dq) of kernel 6 or 8."""
    dout = dout.contiguous()
    di = _di(out, dout, g_lse).contiguous()
    _check_kernel_inputs(entry, q, k, v, dout=dout, lse=lse, di=di)
    if lse.shape != q.shape[:2] or di.shape != q.shape[:2] or dout.shape != q.shape:
        raise ValueError(f"{entry}: lse {tuple(lse.shape)}, dout {tuple(dout.shape)} do not match q {tuple(q.shape)}")
    h, tq, d = q.shape
    tk = k.shape[1]
    width = padded_head_dim(d)
    q, k, v, dout = (pad_head_dim(t, width) for t in (q, k, v, dout))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if splits is None:   # the plans of kernels 6 and 8 at the tensor-core widths; past them FP32-core kernels, unsplit
        if width not in BWD_STREAM:
            splits = (1, 1)
        elif entry == "flash_bwd":
            splits = card_bwd_plan(h, tq, tk, width, q.device)[3:]
        else:
            splits = card_local_bwd_plan(h, tq, tk, width, *args[1:], q.device)[3:]
    s_dkv, s_dq = splits
    # float32 partials of each split, added in split order by the entry's last kernel
    part_kv = torch.empty((s_dkv, 2, h, tk, width), device=q.device) if s_dkv > 1 else None
    part_q = torch.empty((s_dq, h, tq, width), device=q.device) if s_dq > 1 else None
    args = (*args, s_dkv, s_dq, _ptr(part_kv), _ptr(part_q))
    lib = _build.load("flash_attention", _SIGNATURES)
    with _build.on_device(q):
        code = getattr(lib, entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(), di.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), h, tq, tk, width, *args, _build.stream_of(q),
        )
    _build.check(lib, code, entry)
    if width == d:
        return dq, dk, dv
    return tuple(g[..., :d].contiguous() for g in (dq, dk, dv))


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def _band_args(q, k, window: int, lo, hi, q_offset: int) -> tuple[int, int, int, int]:
    """(window, lo, hi, q_offset) as the banded kernels take them."""
    tq, tk = q.shape[1], k.shape[1]
    lo = 0 if lo is None else int(lo)
    hi = tk if hi is None else int(hi)
    # a window past every (row, key) distance is full attention; the cap keeps the kernel's arithmetic in int
    return min(int(window), tq + tk + abs(int(q_offset))), lo, hi, int(q_offset)


def flash_fwd(q, k, v, scale: float, t_valid=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Full attention of q (H, Tq, d) over k, v (H, Tk, d), keys valid below ``t_valid`` → (out, lse)."""
    _check_qkv("flash_fwd", q, k, v)
    if _check_device("flash_fwd", q):
        return flash_fwd_plain(q, k, v, scale, t_valid)
    res = _launch("flash_fwd", q, k, v, float(scale), _t_valid(k.shape[1], t_valid))
    flash_fwd.launches += 1
    return res


flash_fwd.launches = 0


def flash_fwd_planned(q, k, v, scale: float, splits: int, t_valid=None) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`flash_fwd` on CUDA tensors with kernel 5's walk cut in ``splits`` (1 to :data:`MAX_SPLIT`)
    instead of the plan's, at head widths up to 128: for holding every split count to the plain version.
    Counts no launch."""
    _check_qkv("flash_fwd_planned", q, k, v)
    if q.device.type != "cuda" or padded_head_dim(q.shape[-1]) not in FWD_STREAM or not 1 <= splits <= MAX_SPLIT:
        raise ValueError(f"flash_fwd_planned: CUDA tensors with head dims up to 128 and 1 to {MAX_SPLIT} splits, "
                         f"got {q.device}, d = {q.shape[-1]}, {splits} splits")
    return _launch("flash_fwd", q, k, v, float(scale), _t_valid(k.shape[1], t_valid), splits=splits)


def flash_local_fwd(q, k, v, scale: float, window: int, lo=None, hi=None,
                    q_offset: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """Banded attention ``|i + q_offset − j| ≤ window``, keys valid in ``[lo, hi)`` → (out, lse).

    Tq and Tk may differ; ``lo``/``hi`` default to 0 and Tk.
    """
    _check_qkv("flash_local_fwd", q, k, v)
    if window < 0:
        raise ValueError(f"flash_local_fwd: window must be ≥ 0, got {window}")
    if _check_device("flash_local_fwd", q):
        return flash_local_fwd_plain(q, k, v, scale, window, lo, hi, q_offset)
    res = _launch("flash_local_fwd", q, k, v, float(scale), *_band_args(q, k, window, lo, hi, q_offset))
    flash_local_fwd.launches += 1
    return res


flash_local_fwd.launches = 0


def flash_local_fwd_planned(q, k, v, scale: float, window: int, splits: int, lo=None, hi=None,
                            q_offset: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`flash_local_fwd` on CUDA tensors with kernel 7's walk cut in ``splits`` (1 to :data:`MAX_SPLIT`)
    instead of the plan's, at head widths up to 128: for holding every split count to the plain version.
    Counts no launch."""
    _check_qkv("flash_local_fwd_planned", q, k, v)
    if (q.device.type != "cuda" or padded_head_dim(q.shape[-1]) not in FWD_STREAM or window < 0
            or not 1 <= splits <= MAX_SPLIT):
        raise ValueError(f"flash_local_fwd_planned: CUDA tensors with head dims up to 128, a window ≥ 0 and 1 to "
                         f"{MAX_SPLIT} splits, got {q.device}, d = {q.shape[-1]}, window {window}, {splits} splits")
    return _launch("flash_local_fwd", q, k, v, float(scale), *_band_args(q, k, window, lo, hi, q_offset),
                   splits=splits)


def flash_bwd(q, k, v, out, lse, dout, scale: float, t_valid=None, g_lse=None) -> tuple[torch.Tensor, ...]:
    """Gradients (dq, dk, dv) of full attention, from the forward's (out, lse (H, Tq)) and the cotangents
    ``dout`` (H, Tq, d) of out and ``g_lse`` (H, Tq) of lse (None: 0)."""
    _check_qkv("flash_bwd", q, k, v)
    if _check_device("flash_bwd", q):
        return flash_bwd_plain(q, k, v, out, lse, dout, scale, t_valid, g_lse)
    res = _launch_bwd("flash_bwd", q, k, v, out, lse, dout, g_lse, float(scale), _t_valid(k.shape[1], t_valid))
    flash_bwd.launches += 1
    return res


flash_bwd.launches = 0


def flash_local_bwd(q, k, v, out, lse, dout, scale: float, window: int, lo=None, hi=None,
                    q_offset: int = 0) -> tuple[torch.Tensor, ...]:
    """Gradients (dq, dk, dv) of banded attention, from the forward's (out, lse) and the cotangent ``dout``."""
    _check_qkv("flash_local_bwd", q, k, v)
    if window < 0:
        raise ValueError(f"flash_local_bwd: window must be ≥ 0, got {window}")
    if _check_device("flash_local_bwd", q):
        return flash_local_bwd_plain(q, k, v, out, lse, dout, scale, window, lo, hi, q_offset)
    res = _launch_bwd("flash_local_bwd", q, k, v, out, lse, dout, None, float(scale),
                      *_band_args(q, k, window, lo, hi, q_offset))
    flash_local_bwd.launches += 1
    return res


flash_local_bwd.launches = 0


def flash_local_bwd_planned(q, k, v, out, lse, dout, scale: float, window: int, s_dkv: int, s_dq: int, lo=None,
                            hi=None, q_offset: int = 0) -> tuple[torch.Tensor, ...]:
    """:func:`flash_local_bwd` on CUDA tensors with kernel 8's walks cut in ``s_dkv`` and ``s_dq`` splits
    (1 to :data:`MAX_SPLIT`) instead of the plan's, at head widths up to 128: for holding every split count
    to the plain version.  Counts no launch."""
    _check_qkv("flash_local_bwd_planned", q, k, v)
    if (q.device.type != "cuda" or padded_head_dim(q.shape[-1]) not in BWD_STREAM or window < 0
            or not (1 <= s_dkv <= MAX_SPLIT and 1 <= s_dq <= MAX_SPLIT)):
        raise ValueError(f"flash_local_bwd_planned: CUDA tensors with head dims up to 128, a window ≥ 0 and 1 to "
                         f"{MAX_SPLIT} splits, got {q.device}, d = {q.shape[-1]}, window {window}, splits "
                         f"({s_dkv}, {s_dq})")
    return _launch_bwd("flash_local_bwd", q, k, v, out, lse, dout, None, float(scale),
                       *_band_args(q, k, window, lo, hi, q_offset), splits=(s_dkv, s_dq))


class _FullAttention(torch.autograd.Function):
    """(out, lse) of :func:`flash_fwd`, differentiable in q, k, v through :func:`flash_bwd`."""

    @staticmethod
    def forward(ctx, q, k, v, scale, t_valid):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, lse = flash_fwd(q, k, v, scale, t_valid)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale, ctx.t_valid = scale, t_valid
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, g_out, g_lse):
        q, k, v, out, lse = ctx.saved_tensors
        if g_out is None:
            g_out = torch.zeros_like(out)
        dq, dk, dv = flash_bwd(q, k, v, out, lse, g_out, ctx.scale, ctx.t_valid, g_lse)
        return dq, dk, dv, None, None


class _BandedAttention(torch.autograd.Function):
    """out of :func:`flash_local_fwd`, differentiable in q, k, v through :func:`flash_local_bwd`."""

    @staticmethod
    def forward(ctx, q, k, v, scale, window, lo, hi, q_offset):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, lse = flash_local_fwd(q, k, v, scale, window, lo, hi, q_offset)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.band = (scale, window, lo, hi, q_offset)
        return out

    @staticmethod
    def backward(ctx, g_out):
        q, k, v, out, lse = ctx.saved_tensors
        scale, window, lo, hi, q_offset = ctx.band
        dq, dk, dv = flash_local_bwd(q, k, v, out, lse, g_out, scale, window, lo, hi, q_offset)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q, k, v, scale: float | None = None) -> torch.Tensor:
    """Full (non-causal) attention: q (H, Tq, d) × k, v (H, Tk, d) → (H, Tq, d), differentiable."""
    return _FullAttention.apply(q, k, v, _default_scale(q, scale), None)[0]


flash_attention_trainable = flash_attention  # the JAX package's name for the differentiable form


def flash_attention_with_lse(q, k, v, t_valid) -> tuple[torch.Tensor, torch.Tensor]:
    """Full attention with keys valid below ``t_valid`` → (out (H, Tq, d), lse (H, Tq, 1)), both differentiable."""
    out, lse = _FullAttention.apply(q, k, v, _default_scale(q, None), t_valid)
    return out, lse[..., None]


def flash_attention_local(q, k, v, window: int, scale: float | None = None) -> torch.Tensor:
    """Sliding-window self-attention ``|i − j| ≤ window``; q, k, v (H, T, d) with one T."""
    if k.shape[1] != q.shape[1]:
        raise ValueError(f"flash_attention_local is a self-attention band: Tq={q.shape[1]} != Tk={k.shape[1]}")
    return _BandedAttention.apply(q, k, v, _default_scale(q, scale), window, None, None, 0)


def flash_attention_local_bounded(q, k, v, lo, hi, window: int, q_offset: int = 0) -> torch.Tensor:
    """Banded attention ``|(i + q_offset) − j| ≤ window`` with keys valid in ``[lo, hi)``; Tq and Tk may differ."""
    return _BandedAttention.apply(q, k, v, _default_scale(q, None), window, int(lo), int(hi), q_offset)
