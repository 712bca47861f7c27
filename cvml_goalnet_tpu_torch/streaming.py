"""Streaming summarization: decode, host work, host→device copies and device compute overlapped.

Port of ``cvml_goalnet_tpu/streaming.py``.  Three threads:

* thread A (``produce``) pulls raw frame chunks from the decoder
  (``stage_decode``) and, with ``host_preprocess``, normalises and resizes
  them on the host (``ops/preprocess.preprocess_frames_host``) and casts
  them to ``transfer_dtype`` (``stage_produce``);
* thread B (``upload``) copies each chunk into a page-locked staging buffer
  and from there to the card with ``non_blocking=True`` on a side copy
  stream, recording an event after the copy (:class:`_Uploader`);
* the calling thread makes its own compute stream current, waits on each
  chunk's event, and scores it: kernel 1 (``preprocess_frames``) unless the
  host preprocessed, then the trunk (kernels 2, 3) and the fusion MLP (kernel
  4); the (k,) scores go back into pinned host memory with ``non_blocking``
  and an event, read once the event has completed.

Copies and compute overlap because they run on two streams and the host
memory is pinned: a copy from pageable memory goes through a bounce buffer
of the CUDA runtime and holds the host thread.  A staging buffer is written
again only after the event of its last copy has completed, so a chunk in
flight is never overwritten.  The chunk tensor is made on the copy stream and read on the
compute stream, so it is marked with ``record_stream``: the caching allocator
then does not hand its memory out again until the compute stream is past it.
At most ``max_inflight`` chunks are pending: the host waits on the event of
the oldest beyond that, as the JAX scorer blocks on its oldest program.

Only the ``k`` real rows of a chunk are scored, unless
``quantized_inference`` is on.  The JAX scorer pads every chunk to
``chunk_size`` so that one compiled program serves the run; the port compiles
nothing per shape, and its eval forward treats rows independently (batchnorm
folded), so the real rows' scores are the same without the pad.  Under int8
they are not: the activation scale is one maximum over the whole chunk, pad
rows included (zero frames become ReLU(bias) after conv0), so there a chunk
is zero-padded to ``chunk_size`` as the JAX scorer pads it, and the scores of
its real rows are kept.

The chunk scorer runs in ``cfg.model.dtype`` as the JAX one does: for bf16,
params and state are cast once, kernel 1 stays float32 and its output is
rounded to bf16 (the JAX scorer resizes in bf16: the two differ by about one
bf16 ulp of a [0, 1] pixel, 0.0039), host-preprocessed frames are cast to bf16,
and uint8 ones rescaled by bf16(1/255) in bf16.

On the CPU (``device="cpu"``) the same threads run, without streams or pinned
memory, and the kernels' plain versions score the chunks.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field

import numpy as np
import torch

from cvml_goalnet_tpu_torch.config import PipelineConfig
from cvml_goalnet_tpu_torch.data.dataset import Prefetcher
from cvml_goalnet_tpu_torch.device import resolve_device
from cvml_goalnet_tpu_torch.models.avm import avm_apply
from cvml_goalnet_tpu_torch.ops.preprocess import preprocess_frames, preprocess_frames_host
from cvml_goalnet_tpu_torch.pipeline import SummaryResult, summarize
from cvml_goalnet_tpu_torch.utils import compute_dtype, tree_cast
from cvml_goalnet_tpu_torch.utils.profiling import StageTimer

STAGING_BUFFERS = 3   # page-locked buffers per modality that thread B cycles through


@dataclass
class StreamStats:
    chunks: int = 0
    frames: int = 0
    stage_seconds: dict = field(default_factory=dict)


class _Uploader:
    """Host arrays → tensors on ``dev`` through a ring of page-locked staging buffers and a side copy stream.

    Each call returns ``(tensor, event)``: the tensor is filled once the event has completed on the copy
    stream (``event`` is None on the CPU, where the tensor shares the array's memory).  Called from one
    thread only.
    """

    def __init__(self, dev: torch.device, n_buffers: int):
        self.dev = dev
        self.stream = torch.cuda.Stream(device=dev) if dev.type == "cuda" else None
        self.slots: list[tuple[torch.Tensor, torch.cuda.Event] | None] = [None] * n_buffers
        self.next = 0

    def __call__(self, array: np.ndarray) -> tuple[torch.Tensor, torch.cuda.Event | None]:
        host = torch.from_numpy(np.ascontiguousarray(array))
        if self.stream is None:
            return host, None
        i = self.next
        self.next = (i + 1) % len(self.slots)
        buf = None
        if self.slots[i] is not None:
            buf, done = self.slots[i]
            done.synchronize()   # the last copy out of this buffer has landed: it may be written again
            if buf.numel() < host.numel() or buf.dtype != host.dtype:
                buf = None
        if buf is None:
            buf = torch.empty((host.numel(),), dtype=host.dtype, pin_memory=True)
        staged = buf[: host.numel()].view(host.shape)
        staged.copy_(host)
        with torch.cuda.device(self.dev), torch.cuda.stream(self.stream):
            out = torch.empty(host.shape, dtype=host.dtype, device=self.dev)
            out.copy_(staged, non_blocking=True)
            done = torch.cuda.Event(blocking=True)
            done.record(self.stream)
        self.slots[i] = (buf, done)
        return out, done


def _on_compute(t: torch.Tensor | None, event, stream) -> torch.Tensor | None:
    """Order a chunk tensor made on the copy stream before the compute stream's use of it."""
    if t is not None and stream is not None:
        stream.wait_event(event)
        t.record_stream(stream)
    return t


def _zero_padded(a: np.ndarray, rows: int) -> np.ndarray:
    return np.concatenate([a, np.zeros((rows - len(a),) + a.shape[1:], a.dtype)])


def score_video_stream(
    params,
    state,
    frame_chunks,
    cfg: PipelineConfig,
    chunk_size: int = 256,
    audio_chunks=None,
    prefetch_depth: int = 2,
    host_preprocess: bool = False,
    transfer_dtype=None,
    max_inflight: int = 8,
    text_chunks=None,
    device=None,
) -> tuple[np.ndarray, StreamStats]:
    """Score a stream of raw frame chunks → ((N,) importance scores, :class:`StreamStats`).

    ``frame_chunks`` yields (k, H, W, C) arrays (k ≤ ``chunk_size``);
    ``audio_chunks`` (optional) yields the matching (k, B, n_mfcc) MFCC
    blocks; ``text_chunks`` the matching (k, text_max_len) commentary tokens,
    required when ``cfg.model.text_included`` (copied to the card by the
    scoring thread: 256 bytes a frame).  ``params`` and ``state`` are the
    port's tensors on ``device`` (``None``: the card).

    ``chunk_size`` bounds k: a longer chunk raises ``ValueError`` (the JAX
    scorer fails padding it).  Chunks are padded only under int8 (see the module's notes).

    ``host_preprocess=True`` normalises and resizes on the host in thread A
    and ships the (h, w, C) float32 frames (at 40×40 from 180×320 uint8, 9×
    fewer bytes than the raw frames; 36× with uint8); kernel 1 then does not
    run.  ``transfer_dtype``
    (``np.float16`` or ``np.uint8``, only with ``host_preprocess``) casts
    those frames before the copy: float16 keeps about 3.3 decimal digits on
    [0, 1]; uint8 ships round(x·255) and the device rescales by 1/255 (≤ 1/510
    a pixel).  The device casts either back to float32.
    """
    if cfg.model.text_included and text_chunks is None:
        raise ValueError(
            "cfg.model.text_included=True but score_video_stream got no "
            "text_chunks — yield (k, text_max_len) token chunks on the same "
            "boundaries as frame_chunks (data.text.tokenize), or stream with "
            "a trunk trained without --commentary"
        )
    dev = resolve_device(device)
    timer = StageTimer()
    audio_iter = iter(audio_chunks) if audio_chunks is not None else None
    text_iter = iter(text_chunks) if text_chunks is not None else None
    quantized = transfer_dtype is not None and np.dtype(transfer_dtype) == np.uint8
    pad_chunks = cfg.model.quantized_inference   # the int8 scale spans the chunk: pad it as the JAX scorer does
    dt = compute_dtype(cfg.model.dtype)

    def _next_aligned(it, name, k):
        """Pull one modality chunk and hold it to the frame chunk's boundary."""
        try:
            a = next(it)
        except StopIteration:
            # PEP 479 would otherwise surface this as an opaque
            # "generator raised StopIteration" RuntimeError from the
            # prefetch thread
            raise ValueError(
                f"{name} exhausted before frame_chunks — the stream must "
                "yield one chunk per frame chunk"
            ) from None
        if len(a) != k:
            # a mismatched chunking boundary would silently pair frames
            # with the wrong modality rows downstream
            raise ValueError(
                f"{name} chunk has {len(a)} rows but the frame chunk has "
                f"{k} — chunk the modalities on the same boundaries as "
                "frame_chunks"
            )
        return a

    def produce():
        # thread A: decode, host preprocess and cast, pipelined with thread B's copies
        chunks = iter(frame_chunks)
        while True:
            with timer.stage("stage_decode"):
                chunk = next(chunks, None)
            if chunk is None:
                return
            with timer.stage("stage_produce"):
                k = len(chunk)
                if k > chunk_size:
                    raise ValueError(f"a frame chunk of {k} rows exceeds chunk_size={chunk_size}")
                if host_preprocess:
                    chunk = preprocess_frames_host(chunk, cfg.preprocess.frame_size, cfg.preprocess.eps)
                    if quantized:
                        chunk = np.clip(np.rint(chunk * 255.0), 0, 255).astype(np.uint8)
                    elif transfer_dtype is not None:
                        chunk = chunk.astype(transfer_dtype)
                audio = _next_aligned(audio_iter, "audio_chunks", k) if audio_iter is not None else None
                text = _next_aligned(text_iter, "text_chunks", k) if text_iter is not None else None
                if pad_chunks and 0 < k < chunk_size:
                    chunk = _zero_padded(chunk, chunk_size)
                    audio = None if audio is None else _zero_padded(np.asarray(audio, np.float32), chunk_size)
                    text = None if text is None else _zero_padded(np.asarray(text, np.int32), chunk_size)
            yield chunk, audio, text, k

    frames_up = _Uploader(dev, STAGING_BUFFERS)
    audio_up = _Uploader(dev, STAGING_BUFFERS) if audio_iter is not None else None

    def upload(produced):
        # thread B: page-locked staging and the copy on the side stream
        for chunk, audio, text, k in produced:
            with timer.stage("stage_upload"):
                frames = frames_up(chunk)
                audio = audio_up(np.asarray(audio, np.float32)) if audio is not None else (None, None)
            yield frames, audio, text, k

    params, state = tree_cast(params, dt), tree_cast(state, dt)
    compute = torch.cuda.Stream(device=dev) if dev.type == "cuda" else None
    if compute is not None:
        compute.wait_stream(torch.cuda.current_stream(dev))   # the weights were written on the caller's stream
    pending: list[tuple[torch.Tensor, torch.cuda.Event | None]] = []
    n_total = n_chunks = 0
    staged = Prefetcher(upload(Prefetcher(produce(), depth=prefetch_depth)), depth=prefetch_depth)
    it = iter(staged)
    with torch.no_grad(), (torch.cuda.stream(compute) if compute is not None else contextlib.nullcontext()), \
            contextlib.closing(it):
        while True:
            with timer.stage("stage_wait_input"):
                nxt = next(it, None)
            if nxt is None:
                break
            (chunk_dev, chunk_ev), (audio_dev, audio_ev), text, k = nxt
            n_total += k
            n_chunks += 1
            if k == 0:
                continue
            with timer.stage("stage_dispatch"):
                chunk_dev = _on_compute(chunk_dev, chunk_ev, compute)
                audio_dev = _on_compute(audio_dev, audio_ev, compute)
                if host_preprocess:
                    visual = chunk_dev.to(dt)
                    if quantized:
                        visual = visual * torch.tensor(1.0 / 255.0, dtype=dt, device=visual.device)
                else:
                    visual = preprocess_frames(chunk_dev, cfg.preprocess.frame_size, cfg.preprocess.eps).to(dt)
                audio_dev = None if audio_dev is None else audio_dev.to(dt)
                text_dev = None if text is None else torch.as_tensor(np.asarray(text, np.int32)).to(dev)
                out = avm_apply(params, state, visual, audio_dev, text_dev, cfg=cfg.model)[:k, 0].to(torch.float32)
                host = torch.empty((k,), dtype=torch.float32, pin_memory=compute is not None)
                host.copy_(out, non_blocking=compute is not None)
                done = None
                if compute is not None:
                    done = torch.cuda.Event(blocking=True)
                    done.record(compute)
            pending.append((host, done))
            if len(pending) > max_inflight and pending[-max_inflight - 1][1] is not None:
                # bound the queue of launched chunks: the host waits for the oldest beyond max_inflight
                with timer.stage("stage_backpressure"):
                    pending[-max_inflight - 1][1].synchronize()

    with timer.stage("stage_drain"):
        scores = []
        for host, done in pending:
            if done is not None:
                done.synchronize()
            scores.append(host.numpy())
    stats = StreamStats(chunks=n_chunks, frames=n_total, stage_seconds=timer.summary())
    return (np.concatenate(scores) if scores else np.zeros((0,), np.float32)), stats


def summarize_video_stream(
    params,
    state,
    frame_chunks,
    clip_intervals,
    full_n_frames: int,
    cfg: PipelineConfig,
    chunk_size: int = 256,
    audio_chunks=None,
    host_preprocess: bool = False,
    transfer_dtype=None,
    text_chunks=None,
    device=None,
) -> tuple[SummaryResult, StreamStats]:
    """Full streaming pipeline: decode chunks → device scoring → knapsack."""
    scores, stats = score_video_stream(
        params, state, frame_chunks, cfg, chunk_size, audio_chunks,
        host_preprocess=host_preprocess, transfer_dtype=transfer_dtype,
        text_chunks=text_chunks, device=device,
    )
    res = summarize(scores, clip_intervals, cfg.preprocess.skip_frames, full_n_frames, cfg.knapsack,
                    device=device)
    return res, stats
