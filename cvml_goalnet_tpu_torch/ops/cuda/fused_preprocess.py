"""Per-frame min-max normalise + bilinear resize: CUDA kernel and its plain version.

Counterpart of ``cvml_goalnet_tpu/ops/pallas/fused_preprocess.py``.  The
kernel (``csrc/fused_preprocess.cu``) runs one block per frame and reads the
uint8 frame directly; its note says what bounds it and why it is built so.

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

import torch

from cvml_goalnet_tpu_torch.ops.cuda import _build

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"fused_preprocess": [_P, _I, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, ctypes.c_float, _P]}

Taps = tuple[torch.Tensor, torch.Tensor]


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


def fused_preprocess_frames(frames: torch.Tensor, taps_h: Taps, taps_w: Taps, eps: float = 1e-7) -> torch.Tensor:
    """(N, H, W, C) uint8 or float32 frames → (N, h, w, C) float32 normalised and resized.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel.
    """
    if frames.device.type == "cpu":
        return fused_preprocess_frames_plain(frames, taps_h, taps_w, eps)
    if frames.device.type != "cuda":
        raise ValueError(f"fused_preprocess_frames: unsupported device {frames.device}")
    if frames.dim() != 4 or frames.dtype not in (torch.uint8, torch.float32) or not frames.is_contiguous():
        raise ValueError(
            "fused_preprocess_frames: frames must be a contiguous (N, H, W, C) uint8 or "
            f"float32 tensor, got {tuple(frames.shape)} {frames.dtype}"
        )
    _build.refuse_grad("fused_preprocess_frames", frames)
    n, h, w, c = frames.shape
    (ih, wh), (iw, ww) = taps_h, taps_w
    oh, ow = ih.shape[1], iw.shape[1]
    for t, dtype, cols in ((ih, torch.int32, oh), (wh, torch.float32, oh), (iw, torch.int32, ow), (ww, torch.float32, ow)):
        if t.dtype != dtype or t.shape != (2, cols) or not t.is_contiguous() or t.device != frames.device:
            raise ValueError(f"fused_preprocess_frames: taps must be contiguous (2, out) {dtype} on {frames.device}")
    out = torch.empty((n, oh, ow, c), dtype=torch.float32, device=frames.device)
    if n == 0:
        return out
    lib = _build.load("fused_preprocess", _SIGNATURES)
    with _build.on_device(frames):
        code = lib.fused_preprocess(
            frames.data_ptr(), int(frames.dtype == torch.uint8), out.data_ptr(), n, h, w, c, oh, ow,
            ih.data_ptr(), wh.data_ptr(), iw.data_ptr(), ww.data_ptr(), eps, _build.stream_of(frames),
        )
    _build.check(lib, code, "fused_preprocess")
    fused_preprocess_frames.launches += 1
    return out


fused_preprocess_frames.launches = 0
