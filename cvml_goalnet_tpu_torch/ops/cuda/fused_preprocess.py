"""Per-frame min-max normalise + bilinear resize: CUDA kernel, its plan and its plain version.

Counterpart of ``cvml_goalnet_tpu/ops/pallas/fused_preprocess.py``.  The
kernel (``csrc/fused_preprocess.cu``) gives each frame a thread-block cluster
of S CTAs; each CTA streams a band of the frame's rows through a ring in
shared memory, takes their min/max and, while a row is there, the horizontal
taps of every tap slot that reads it; the cluster then reduces lo/hi and
combines the slots into output rows through distributed shared memory.  Its
note says what bounds it and why it is built so.

The functions below are the specification of that walk, and the CPU tests
hold an emulation built from them to the plain version bit for bit:
:func:`preprocess_bands` (rows, and output rows, per CTA),
:func:`slot_owners` (the CTA that computes each tap slot), :func:`stage_chunks`
(a band's rows per ring stage), :func:`cluster_frames` (the frames a cluster
loops over), :func:`preprocess_layout` (rows per ring stage, where the slots
live, shared memory) and :func:`preprocess_plan` (S and the count of
clusters from the frame count and the clusters the card runs at once).

``taps_h`` / ``taps_w`` are the ``(indices (2, out) int32, weights (2, out)
float32)`` pairs of ``ops/preprocess.py::resize_taps``, as tensors on the
frames' device; indices must lie inside the frame (``resize_taps`` clamps
them there).

The kernel has no backward (the JAX package's has no VJP either): on CUDA
tensors that require grad with grad mode on, the wrapper raises rather than
return an output that would cut the gradient.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from cvml_goalnet_tpu_torch.ops.cuda import _build

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "fused_preprocess": [_P, _I, _P, _L, _I, _I, _I, _I, _I, _P, _P, _P, _P, ctypes.c_float, _I, _I, _I, _P, _P],
    "fused_preprocess_clusters_at_once": [_I, _L, _I, _P],
}

CLUSTER_SIZES = (1, 2, 4, 8)   # CTAs per frame the kernel takes (8: the portable cluster limit)
STAGES = 2                     # ring stages of the kernel: one chunk lands while the other is read
STAGE_BYTES = 16384            # bytes of whole rows the plan puts in one ring stage (fitted on an H100, PERF.md §6)
SMEM_LIMIT = 232448 - 256      # dynamic shared memory of a CTA: Hopper's 227 KB less the kernel's static
FILL = 1                       # the plan's CTAs per resident CTA of the card (fitted on an H100, PERF.md §6)

Taps = tuple[torch.Tensor, torch.Tensor]


class PreprocessLayout(NamedTuple):
    """A CTA's shared memory: ``rows_per_stage`` rows in each of the :data:`STAGES` ring stages, the slots in
    shared memory (else in a global workspace), ``smem_bytes`` in all."""
    rows_per_stage: int
    cols_in_smem: bool
    smem_bytes: int


class PreprocessPlan(NamedTuple):
    """``clusters`` clusters of ``cluster`` CTAs per frame (cluster q takes :func:`cluster_frames`), each CTA
    with ``layout``."""
    cluster: int
    clusters: int
    layout: PreprocessLayout


def preprocess_bands(extent: int, parts: int) -> list[tuple[int, int]]:
    """``extent`` rows cut into ``parts`` bands, [⌊s·extent/parts⌋, ⌊(s+1)·extent/parts⌋) for CTA s: the source
    rows each CTA streams, and the output rows each writes.  A band is empty when extent < parts."""
    return [(s * extent // parts, (s + 1) * extent // parts) for s in range(parts)]


def band_owner(row: int, extent: int, parts: int) -> int:
    """The CTA whose band of :func:`preprocess_bands` holds ``row``: the last whose first row is ≤ row."""
    s = parts - 1
    while s * extent // parts > row:
        s -= 1
    return s


def slot_owners(ih, h: int, parts: int) -> list[int]:
    """For each tap slot j of the (2, oh) row indices ``ih`` flattened (j < oh: (0, j); else (1, j − oh)), the
    CTA that computes it: the one holding its source row.  Two slots of one row (an upscale, or a clamped
    edge where ih[0][a] == ih[1][a]) have one owner and are computed separately."""
    return [band_owner(int(r), h, parts) for r in torch.as_tensor(ih).reshape(-1).tolist()]


def stage_chunks(band: tuple[int, int], rows_per_stage: int) -> list[tuple[int, int]]:
    """A band's rows in ring-stage order: chunks of ``rows_per_stage`` rows, the last one short."""
    r0, r1 = band
    return [(c0, min(c0 + rows_per_stage, r1)) for c0 in range(r0, r1, rows_per_stage)]


def smem_bytes(h: int, rows_per_stage: int, row_bytes: int, oh: int, owc: int, cols_in_smem: bool) -> int:
    """The kernel's dynamic shared memory (``smem_bytes`` in ``csrc/fused_preprocess.cu``): the ring of 16-byte
    aligned stages, the 2·oh slots of ``owc`` floats unless they live in the workspace, tables of 16 bytes per
    column element and 20 per slot, and the starts of the chunks' slot lists."""
    stage = -(-rows_per_stage * row_bytes // 16) * 16
    return (STAGES * stage + (4 * 2 * oh * owc if cols_in_smem else 0) + 16 * owc + 20 * 2 * oh
            + 4 * (h // rows_per_stage + 2))


@functools.lru_cache(maxsize=256)
def preprocess_layout(h: int, w: int, c: int, oh: int, ow: int, elem_bytes: int) -> PreprocessLayout:
    """Rows per ring stage: about :data:`STAGE_BYTES` of whole rows, so float32 frames, whose rows are four
    times wider, take a quarter of the rows.  The slots stay in shared memory where they fit beside the ring
    within :data:`SMEM_LIMIT`, else they move to the workspace; a ring of two rows past the limit raises."""
    row_bytes = w * c * elem_bytes
    rows = max(1, min(h, STAGE_BYTES // row_bytes))
    for cols_in_smem in (True, False):
        smem = smem_bytes(h, rows, row_bytes, oh, ow * c, cols_in_smem)
        if smem <= SMEM_LIMIT:
            return PreprocessLayout(rows, cols_in_smem, smem)
    raise ValueError(f"fused_preprocess_frames: rows of {row_bytes} bytes do not fit two ring stages in shared memory")


def cluster_frames(q: int, n: int, clusters: int) -> range:
    """The frames cluster q of ``clusters`` processes, in order: q, q + clusters, …  Its CTAs stream their bands
    of these frames as one run of ring stages, so a frame's epilogue overlaps the next frame's loads."""
    return range(q, n, clusters)


@functools.lru_cache(maxsize=1024)   # a pure function of its ints, asked on every call
def preprocess_plan(n: int, h: int, w: int, c: int, oh: int, ow: int, elem_bytes: int,
                    at_once: tuple[int, ...]) -> PreprocessPlan:
    """The plan for n frames (h, w, c) of ``elem_bytes`` → (oh, ow) on a card that runs ``at_once[i]`` clusters
    of ``CLUSTER_SIZES[i]`` CTAs of this layout at once (``at_once[0]``: its resident CTAs).

    S is the largest cluster size, at most h, whose n·S CTAs stay within :data:`FILL` times the resident CTAs:
    a small batch gets more CTAs a frame, so more bytes in flight, and all of them run in one round (a single
    frame gets eight).  The launch takes the fewest clusters that
    keep each at ⌈n / at_once[S]⌉ frames, so every cluster runs at once and the grid never outgrows the card,
    whatever n is."""
    layout = preprocess_layout(h, w, c, oh, ow, elem_bytes)
    allowed = [i for i, s in enumerate(CLUSTER_SIZES) if s <= h] or [0]
    i = max((i for i in allowed if n * CLUSTER_SIZES[i] <= FILL * at_once[0]), default=0)
    per = -(-n // at_once[i])
    return PreprocessPlan(CLUSTER_SIZES[i], -(-n // per), layout)


def card_preprocess_plan(n: int, h: int, w: int, c: int, oh: int, ow: int, elem_bytes: int,
                         device: torch.device) -> PreprocessPlan:
    """:func:`preprocess_plan` with the clusters the card ``device`` runs at once at the layout."""
    return _card_plan(n, h, w, c, oh, ow, elem_bytes, _build.device_index(device))


@functools.lru_cache(maxsize=1024)   # one lookup per call on the wrapper's path
def _card_plan(n: int, h: int, w: int, c: int, oh: int, ow: int, elem_bytes: int, device: int) -> PreprocessPlan:
    layout = preprocess_layout(h, w, c, oh, ow, elem_bytes)
    return preprocess_plan(n, h, w, c, oh, ow, elem_bytes, _clusters_on_card(device, elem_bytes == 1, layout.smem_bytes))


def clusters_at_once(device: torch.device, is_u8: bool, smem: int) -> tuple[int, ...]:
    """For each of :data:`CLUSTER_SIZES`, the clusters of the kernel with ``smem`` bytes of shared memory a CTA
    that the card ``device`` runs at once (``cudaOccupancyMaxActiveClusters``)."""
    return _clusters_on_card(_build.device_index(device), is_u8, smem)


@functools.lru_cache(maxsize=None)
def _clusters_on_card(device: int, is_u8: bool, smem: int) -> tuple[int, ...]:
    lib = _build.load("fused_preprocess", _SIGNATURES)
    out, found = ctypes.c_int(0), []
    with torch.cuda.device(device):
        for s in CLUSTER_SIZES:
            code = lib.fused_preprocess_clusters_at_once(int(is_u8), smem, s, ctypes.byref(out))
            _build.check(lib, code, "fused_preprocess: occupancy")
            found.append(out.value)
    if not found[0]:
        raise RuntimeError(f"fused_preprocess: the card runs no CTA of {smem} bytes of shared memory")
    return tuple(found)


def fused_preprocess_frames_plain(frames: torch.Tensor, taps_h: Taps, taps_w: Taps, eps: float = 1e-7) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: columns, then rows, then ``(v − lo) / (hi − lo + eps)``.

    No frames (a stream's empty tail) give an empty (0, h, w, C) float32 tensor, as the kernel's wrapper
    returns."""
    n = frames.shape[0]
    (ih, wh), (iw, ww) = taps_h, taps_w
    if n == 0:
        return torch.empty((0, ih.shape[1], iw.shape[1], frames.shape[3]), dtype=torch.float32, device=frames.device)
    flat = frames.reshape(n, -1)
    lo = flat.amin(dim=1).to(torch.float32)[:, None, None, None]
    hi = flat.amax(dim=1).to(torch.float32)[:, None, None, None]
    ih, iw = ih.long(), iw.long()
    cols = ww[0][:, None] * frames[:, :, iw[0]].to(torch.float32) + ww[1][:, None] * frames[:, :, iw[1]].to(torch.float32)
    v = wh[0][:, None, None] * cols[:, ih[0]] + wh[1][:, None, None] * cols[:, ih[1]]
    return (v - lo) / (hi - lo + eps)


def _check(what: str, frames: torch.Tensor, taps_h: Taps, taps_w: Taps) -> None:
    if frames.dim() != 4 or frames.dtype not in (torch.uint8, torch.float32) or not frames.is_contiguous():
        raise ValueError(
            f"{what}: frames must be a contiguous (N, H, W, C) uint8 or float32 tensor, got "
            f"{tuple(frames.shape)} {frames.dtype}"
        )
    _build.refuse_grad(what, frames)
    (ih, wh), (iw, ww) = taps_h, taps_w
    oh, ow = ih.shape[1], iw.shape[1]
    for t, dtype, cols in ((ih, torch.int32, oh), (wh, torch.float32, oh), (iw, torch.int32, ow), (ww, torch.float32, ow)):
        if t.dtype != dtype or t.shape != (2, cols) or not t.is_contiguous() or t.device != frames.device:
            raise ValueError(f"{what}: taps must be contiguous (2, out) {dtype} on {frames.device}")


def _launch(frames: torch.Tensor, taps_h: Taps, taps_w: Taps, eps: float, plan: PreprocessPlan) -> torch.Tensor:
    n, h, w, c = frames.shape
    (ih, wh), (iw, ww) = taps_h, taps_w
    oh, ow = ih.shape[1], iw.shape[1]
    out = torch.empty((n, oh, ow, c), dtype=torch.float32, device=frames.device)
    layout = plan.layout
    ws = None if layout.cols_in_smem else torch.empty((plan.clusters, 2 * oh, ow * c), dtype=torch.float32,
                                                      device=frames.device)
    lib = _build.load("fused_preprocess", _SIGNATURES)
    with _build.on_device(frames):
        code = lib.fused_preprocess(
            frames.data_ptr(), int(frames.dtype == torch.uint8), out.data_ptr(), n, h, w, c, oh, ow,
            ih.data_ptr(), wh.data_ptr(), iw.data_ptr(), ww.data_ptr(), eps, plan.cluster, plan.clusters,
            layout.rows_per_stage, None if ws is None else ws.data_ptr(), _build.stream_of(frames),
        )
    _build.check(lib, code, "fused_preprocess")
    return out


def fused_preprocess_frames(frames: torch.Tensor, taps_h: Taps, taps_w: Taps, eps: float = 1e-7) -> torch.Tensor:
    """(N, H, W, C) uint8 or float32 frames → (N, h, w, C) float32 normalised and resized.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel with :func:`card_preprocess_plan`.
    """
    if frames.device.type == "cpu":
        return fused_preprocess_frames_plain(frames, taps_h, taps_w, eps)
    if frames.device.type != "cuda":
        raise ValueError(f"fused_preprocess_frames: unsupported device {frames.device}")
    _check("fused_preprocess_frames", frames, taps_h, taps_w)
    n, h, w, c = frames.shape
    oh, ow = taps_h[0].shape[1], taps_w[0].shape[1]
    if n == 0:
        return torch.empty((0, oh, ow, c), dtype=torch.float32, device=frames.device)
    out = _launch(frames, taps_h, taps_w, eps, card_preprocess_plan(n, h, w, c, oh, ow, frames.element_size(),
                                                                    frames.device))
    fused_preprocess_frames.launches += 1
    return out


fused_preprocess_frames.launches = 0


def fused_preprocess_frames_planned(frames: torch.Tensor, taps_h: Taps, taps_w: Taps, eps: float,
                                    plan: PreprocessPlan) -> torch.Tensor:
    """:func:`fused_preprocess_frames` on CUDA tensors with a forced plan (any S of :data:`CLUSTER_SIZES`, any
    count of clusters): for holding every plan to the plain version, and for plan sweeps.  Counts no launch."""
    if frames.device.type != "cuda" or plan.cluster not in CLUSTER_SIZES or plan.clusters < 1:
        raise ValueError(f"fused_preprocess_frames_planned: CUDA frames, S in {CLUSTER_SIZES} and clusters ≥ 1, "
                         f"got {frames.device}, {plan.cluster}, {plan.clusters}")
    _check("fused_preprocess_frames_planned", frames, taps_h, taps_w)
    if frames.shape[0] == 0:
        raise ValueError("fused_preprocess_frames_planned: no frames")
    return _launch(frames, taps_h, taps_w, eps, plan)
