"""Serving: a long-lived Summarizer and Spotter, cross-request batching, and a JSON-over-HTTP server.

Port of ``cvml_goalnet_tpu/serve.py`` for one device, the card by default
(``device="cpu"`` runs the plain PyTorch versions of the kernels):

* :class:`Summarizer` holds the trunk once and scores many videos (a file
  path or frames in memory): decode, ``extract_features`` (kernel 1 and the
  MFCC frontend on the card), ``fuse`` (kernels 2–4) under its lock, and the
  knapsack in one call of the C++ runtime (``"native-full"``);
* :class:`Spotter` is its event-spotting twin (trunk and temporal head held
  once, the serving form of ``goalnet-torch spot``): ``encode_timeline``
  (kernels 2 and 3) and ``score_timeline_auto`` (kernel 5 or 7 for the
  transformer and hybrid heads), and ``spot_stream`` over a file or a live
  segment directory;
* :class:`DynamicBatcher` concatenates the frames of concurrent requests
  into one bucket-sized ``fuse`` call (the model is per frame, so batching
  changes no score); requests are preprocessed on the host, so kernel 1 does
  not run there;
* :func:`serve_http` answers ``POST /summarize``, ``/spot``, ``/spot-stream``
  (ndjson, one line per final event) and ``/reload``, and ``GET /metrics``
  and ``/healthz``, on the standard library's ``ThreadingHTTPServer``.

HTTP handler threads and the batcher's worker launch kernels at the same
time.  Every launch goes to the card's current stream, so the card runs them
in the order they were issued; the kernels and the native runtime are built
once however many threads ask first (``ops/cuda/_build.py``, ``runtime.py``),
and ``warmup`` builds them before the first request.  A kernel that fails to
build or launch raises, and the request that hit it answers 500: nothing
falls back to the plain version or the CPU.

Trunks with the text branch read each video's ``<video>.commentary.jsonl``
sidecar (``""`` for every frame without one, as in training); the text
encoder runs in plain PyTorch.  ``/spot-stream`` refuses them, as the JAX
package does: there is no live ingest protocol for commentary.

``mesh=`` (``parallel.mesh.serving_mesh``, the CLI's ``serve --dp N``) serves
data-parallel over several cards: the Summarizer's ``fuse`` and the
Spotter's trunk split the frames of a batch over the mesh
(``parallel/serving.py``), with the weights copied to every card once per
checkpoint (re)load, and the batcher's batches take the same path.  Frames
are decoded and preprocessed, and the temporal head scores, on the mesh's
first card.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import queue
import threading
import time
import weakref
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass

import numpy as np
import torch

from cvml_goalnet_tpu_torch import runtime
from cvml_goalnet_tpu_torch.config import PipelineConfig
from cvml_goalnet_tpu_torch.data.dataset import _load_frames, uniform_clip_intervals
from cvml_goalnet_tpu_torch.data.text import commentary_sidecar, tokenize
from cvml_goalnet_tpu_torch.device import resolve_device
from cvml_goalnet_tpu_torch.models.audio import audio_feature_channels
from cvml_goalnet_tpu_torch.ops.audio import extract_audio_features
from cvml_goalnet_tpu_torch.ops.preprocess import preprocess_frames_host
from cvml_goalnet_tpu_torch.pipeline import extract_features, fuse, summarize
from cvml_goalnet_tpu_torch.spotting import (
    encode_timeline,
    score_timeline_auto,
    scores_to_importance,
    spot_events,
    spot_events_multi,
    spot_stream,
)
from cvml_goalnet_tpu_torch.train.checkpoint import CheckpointMismatchError, load_checkpoint
from cvml_goalnet_tpu_torch.train.state import create_train_state
from cvml_goalnet_tpu_torch.weights import init_temporal_params, load_spotting_checkpoint, tree_from_jax

# the CUDA sources each service launches (ops/cuda/_build.KERNELS names), built by warmup() before any request
SUMMARIZER_SOURCES = ("fused_preprocess", "fused_stage", "fused_stage_lowp", "matmul", "fused_mlp")
BATCHER_SOURCES = ("fused_stage", "fused_stage_lowp", "matmul", "fused_mlp")
SPOTTER_SOURCES = ("fused_preprocess", "fused_stage", "fused_stage_lowp", "matmul", "flash_attention")


def _build_sources(device: torch.device, sources) -> None:
    """On the card: build the kernels of ``sources`` (one ``nvcc`` each, at once) and the native runtime, so a
    warmed service never compiles on a request.  On the CPU only the runtime (the plain versions need none)."""
    if device.type == "cuda":
        from cvml_goalnet_tpu_torch.ops.cuda import _build

        _build.build(sources)
    runtime.load()


@dataclass
class SummarizeResponse:
    video_id: str
    scores: np.ndarray
    frame_mask: np.ndarray
    clips: np.ndarray


def _load_wav_sidecar(video_fp: str, cfg: PipelineConfig):
    """The ``<video>.wav`` sidecar's waveform, or None without one or for a ``--no-audio`` trunk: the one
    sidecar rule of the unbatched and the batched request paths."""
    if not cfg.model.audio_included:
        return None
    wav_fp = video_fp.rsplit(".", 1)[0] + ".wav"
    if not os.path.exists(wav_fp):
        return None
    from cvml_goalnet_tpu_torch.data.audio_io import load_waveform

    waveform, _ = load_waveform(wav_fp, cfg.audio.sample_rate)
    return waveform


def load_media(video_fp: str, cfg: PipelineConfig):
    """→ (video_id, decimated frames, full_n_frames, waveform or None): the one decode, id and sidecar
    sequence of every serving path."""
    video_id = os.path.basename(video_fp).rsplit(".", 1)[0]
    frames, full_n = _load_frames(video_fp, cfg.preprocess.skip_frames)
    return video_id, frames, full_n, _load_wav_sidecar(video_fp, cfg)


def _load_commentary_sidecar(video_fp: str, cfg: PipelineConfig, n_condensed: int) -> "list[str] | None":
    """Per-frame commentary from ``<video>.commentary.jsonl`` (the convention of ``build_video_item``), or None
    without one or for a trunk without the text branch."""
    if not cfg.model.text_included:
        return None
    return commentary_sidecar(video_fp, n_condensed, cfg.preprocess.skip_frames)


def _silent_audio(n: int, cfg: PipelineConfig, device: torch.device) -> torch.Tensor:
    """Audio features of silence, for an audio trunk serving a video without a waveform."""
    return torch.zeros((n, cfg.audio.bin_length, audio_feature_channels(cfg.audio)), dtype=torch.float32,
                       device=device)


def _fresh_state(cfg: PipelineConfig, checkpoint: tuple, device: torch.device):
    """A fresh trunk state on ``device``, loaded from ``checkpoint`` = (directory or None, tag)."""
    ckp_dir, tag = checkpoint
    state = create_train_state(cfg.train.seed, cfg, device=device)
    return state if ckp_dir is None else load_checkpoint(ckp_dir, state, tag=tag)


def _service_device(device, mesh) -> torch.device:
    """The device a service decodes, preprocesses and scores on: ``device``, or the mesh's first one."""
    return resolve_device(device if device is not None or not mesh else mesh[0])


def _mesh_copies(state, mesh):
    """With a mesh: (params, model_state) copied to each of its devices (``parallel.serving.replicate``), once
    per checkpoint load so no request copies weights; None without one, where ``state`` is read directly."""
    if mesh is None:
        return None
    from cvml_goalnet_tpu_torch.parallel.serving import replicate

    return replicate(state.params, mesh), replicate(state.model_state, mesh)


class Summarizer:
    """Trunk loaded once; thread-safe scoring of many videos on one device, or split over ``mesh``."""

    def __init__(
        self,
        cfg: PipelineConfig,
        checkpoint_dir: str | None = None,
        checkpoint_tag: str = "opt",
        store=None,
        state=None,
        reloader=None,
        device=None,
        mesh=None,
    ):
        self.cfg = cfg
        self.store = store
        self.device = _service_device(device, mesh)
        self._checkpoint = (checkpoint_dir, checkpoint_tag)
        # a zero-argument callable → a fresh state: lets a launcher with its own checkpoint discovery make an
        # in-memory `state=` service reloadable without ever taking a path from a request
        self._reloader = reloader
        self.state = state if state is not None else _fresh_state(cfg, self._checkpoint, self.device)
        self.reload_count = 0
        self._lock = threading.Lock()
        self.mesh = mesh
        self._dp_fuse = None
        if mesh is not None:
            from cvml_goalnet_tpu_torch.parallel.serving import make_dp_fuse

            self._dp_fuse = make_dp_fuse(cfg.model, mesh)
        self._placed = _mesh_copies(self.state, mesh)

    def _score(self, features: dict) -> np.ndarray:
        """Features → (N,) scores, on the service's device or split over the mesh (the batcher calls this too).
        The caller holds ``self._lock``: :meth:`reload`'s swap is the only writer of ``state`` and
        ``_placed``, and an in-flight call keeps the references it read."""
        if self._dp_fuse is not None:
            return self._dp_fuse(*self._placed, features)
        return fuse(self.state.params, self.state.model_state, features, self.cfg, device=self.device)

    def reload(self) -> int:
        """Swap in the trunk from the location the service was built with (never a path from the caller).

        The candidate is loaded outside the lock and only the swap holds it:
        requests in flight finish on the old weights, and the old weights keep
        serving when the load fails.  The old tensors are never written in
        place.  → the new reload count.
        """
        ckp_dir, _ = self._checkpoint
        if self._reloader is not None:
            candidate = self._reloader()  # may raise
        elif ckp_dir is None:
            raise ValueError(
                "this Summarizer was constructed from an in-memory state — there is no checkpoint directory "
                "to reload from")
        else:
            candidate = _fresh_state(self.cfg, self._checkpoint, self.device)  # may raise
        placed = _mesh_copies(candidate, self.mesh)   # the copies to the mesh, outside the lock
        with self._lock:
            self.state = candidate
            self._placed = placed
            self.reload_count += 1
            return self.reload_count

    def warmup(self, shapes: "tuple[tuple[int, int, int], ...] | None" = None) -> None:
        """Build every kernel the path launches and run it once per production ``(N, H, W)`` shape.

        Default: 256-frame chunks at ``cfg.preprocess.serving_raw_hw``.  On the
        card the kernels are built first, all at once, so a warmed server
        never runs ``nvcc`` on a request.
        """
        _build_sources(self.device, SUMMARIZER_SOURCES)
        if shapes is None:
            h, w = self.cfg.preprocess.serving_raw_hw
            shapes = ((256, h, w),)
        rng = np.random.default_rng(0)
        for n_frames, h, w in shapes:
            frames = rng.integers(0, 255, (n_frames, h, w, 3), dtype=np.uint8)
            self.summarize_frames("warmup", frames, np.array([[0, n_frames]]), n_frames)

    def summarize_frames(
        self,
        video_id: str,
        frames: np.ndarray,
        clip_intervals: np.ndarray | None = None,
        full_n_frames: int | None = None,
        waveform: np.ndarray | None = None,
        commentary: "list[str] | None" = None,
    ) -> SummarizeResponse:
        cfg = self.cfg
        full_n = full_n_frames or len(frames) * cfg.preprocess.skip_frames
        if clip_intervals is None:
            if self.store is not None:
                clip_intervals = np.asarray(self.store.change_points(video_id))
            else:
                clip_intervals = uniform_clip_intervals(cfg, full_n)
        if cfg.model.text_included and commentary is None:
            commentary = [""] * len(frames)   # no sidecar: the 3-modality trunk still expects the modality
        feats = extract_features(frames, waveform, cfg, commentary=commentary, device=self.device)   # outside the lock
        if cfg.model.audio_included and feats["audio"] is None:
            feats["audio"] = _silent_audio(len(frames), cfg, self.device)   # no audio track: silence
        with self._lock:
            scores = self._score(feats)
        res = summarize(scores, clip_intervals, cfg.preprocess.skip_frames, full_n, cfg.knapsack,
                        knapsack_engine="native-full", device=self.device)
        return SummarizeResponse(video_id=video_id, scores=scores, frame_mask=res.frame_mask,
                                 clips=np.asarray(res.clip_intervals))

    def summarize_path(self, video_fp: str) -> SummarizeResponse:
        video_id, frames, full_n, waveform = load_media(video_fp, self.cfg)
        return self.summarize_frames(video_id, frames, None, full_n, waveform,
                                     commentary=_load_commentary_sidecar(video_fp, self.cfg, len(frames)))


@dataclass
class SpotResponse:
    video_id: str
    scores: np.ndarray                 # (T,) single-class or (T, C)
    events: "np.ndarray | dict[str, np.ndarray]"  # condensed frame indices
    summary_clips: np.ndarray
    summary_frames: int
    fps: "float | None" = None         # container-reported raw frame rate


def trunk_feature_dim(cfg: PipelineConfig) -> int:
    """Width of ``encode_timeline``'s features: the temporal head's input."""
    return (cfg.model.vis_feature_dim + (cfg.model.aud_feature_dim if cfg.model.audio_included else 0)
            + (cfg.model.text_feature_dim if cfg.model.text_included else 0))


class Spotter:
    """Event-spotting service: trunk and temporal head loaded once, thread-safe scoring of many timelines.

    ``temporal_checkpoint`` is the head ``spot-train`` saved; ``classes`` must
    name its ``--classes`` (the loader refuses a structural mismatch).
    """

    def __init__(
        self,
        cfg: PipelineConfig,
        checkpoint_dir: str | None = None,
        checkpoint_tag: str = "opt",
        temporal_checkpoint: str | None = None,
        classes: "list[str] | None" = None,
        state=None,
        reloader=None,
        device=None,
        mesh=None,
    ):
        self.cfg = cfg
        self.classes = list(classes) if classes else None
        self.device = _service_device(device, mesh)
        self._checkpoint = (checkpoint_dir, checkpoint_tag)
        self._temporal_checkpoint = temporal_checkpoint
        self._reloader = reloader  # the same contract as Summarizer's
        self.state = state if state is not None else _fresh_state(cfg, self._checkpoint, self.device)
        self.temporal_params = self._build_temporal(temporal_checkpoint)
        self.reload_count = 0
        self._lock = threading.Lock()
        # with a mesh the trunk's encode (the bulk of /spot) is split over it; the temporal head, cross-frame,
        # scores the gathered (T, D) features on the first device
        self.mesh = mesh
        self._dp_encode = None
        if mesh is not None:
            from cvml_goalnet_tpu_torch.parallel.serving import make_dp_encode

            self._dp_encode = make_dp_encode(cfg.model, mesh)
        self._placed = _mesh_copies(self.state, mesh)

    def _build_temporal(self, temporal_checkpoint: "str | None"):
        """The configured temporal head, seeded, with the checkpoint loaded into it when one is given."""
        n_classes = len(self.classes) if self.classes else 1
        tparams = init_temporal_params(self.cfg.model, trunk_feature_dim(self.cfg), seed=1, n_classes=n_classes)
        if temporal_checkpoint is not None:
            tparams = load_spotting_checkpoint(temporal_checkpoint, tparams, classes=self.classes)
        return tree_from_jax(tparams, device=self.device)

    def reload(self) -> int:
        """Swap in the trunk and the head from their configured locations (the contract of
        :meth:`Summarizer.reload`)."""
        ckp_dir, _ = self._checkpoint
        if ckp_dir is None and self._reloader is None and self._temporal_checkpoint is None:
            raise ValueError(
                "this Spotter was constructed from in-memory weights — there is no checkpoint to reload from")
        new_state = self.state
        if self._reloader is not None:
            new_state = self._reloader()
        elif ckp_dir is not None:
            new_state = _fresh_state(self.cfg, self._checkpoint, self.device)
        # the head is rebuilt only from its own file: without one, rebuilding would replace an in-memory
        # (assigned) head with a fresh random one
        new_tparams = (self._build_temporal(self._temporal_checkpoint)
                       if self._temporal_checkpoint is not None else self.temporal_params)
        placed = _mesh_copies(new_state, self.mesh)
        with self._lock:
            self.state = new_state
            self.temporal_params = new_tparams
            self._placed = placed
            self.reload_count += 1
            return self.reload_count

    def warmup(self, n_frames: int | None = None) -> None:
        """Build the kernels of the path, then encode and score one production timeline."""
        _build_sources(self.device, SPOTTER_SOURCES)
        n = n_frames or 256
        h, w = self.cfg.preprocess.serving_raw_hw
        frames = np.random.default_rng(0).integers(0, 255, (n, h, w, 3), dtype=np.uint8)
        self.spot_frames("warmup", frames)

    def spot_frames(
        self,
        video_id: str,
        frames: np.ndarray,
        full_n_frames: int | None = None,
        waveform: np.ndarray | None = None,
        peak_window: int = 5,
        peak_threshold: float = 0.0,
        commentary: "list[str] | None" = None,
    ) -> SpotResponse:
        cfg = self.cfg
        full_n = full_n_frames or len(frames) * cfg.preprocess.skip_frames
        if cfg.model.text_included and commentary is None:
            commentary = [""] * len(frames)   # no sidecar: empty strings, the trained "no commentary" pattern
        feats_in = extract_features(frames, waveform, cfg, commentary=commentary, device=self.device)
        if cfg.model.audio_included and feats_in["audio"] is None:
            feats_in["audio"] = _silent_audio(len(frames), cfg, self.device)
        with self._lock:
            if self._dp_encode is not None:
                feats = self._dp_encode(*self._placed, feats_in["visual"], feats_in["audio"], feats_in["text"])
            else:
                feats = encode_timeline(self.state.params, self.state.model_state, feats_in["visual"],
                                        feats_in["audio"], cfg, device=self.device, text=feats_in["text"])
            scores = score_timeline_auto(self.temporal_params, feats, cfg).cpu().numpy()

        if self.classes:
            if scores.ndim == 1:
                scores = scores[:, None]
            per_class = spot_events_multi(scores, peak_window, peak_threshold)
            events = {c: ev for c, ev in zip(self.classes, per_class)}
            eventness = scores.max(axis=1)
        else:
            events = spot_events(scores, peak_window, peak_threshold)
            eventness = scores

        res = summarize(scores_to_importance(eventness), uniform_clip_intervals(cfg, full_n),
                        cfg.preprocess.skip_frames, full_n, cfg.knapsack, knapsack_engine="native-full",
                        device=self.device)
        return SpotResponse(video_id=video_id, scores=scores, events=events,
                            summary_clips=np.asarray(res.clip_intervals),
                            summary_frames=int(res.frame_mask.sum()))

    def spot_path(self, video_fp: str, **kw) -> SpotResponse:
        from cvml_goalnet_tpu_torch.data.video import probe_video_fps

        video_id, frames, full_n, waveform = load_media(video_fp, self.cfg)
        if "commentary" not in kw:
            side = _load_commentary_sidecar(video_fp, self.cfg, len(frames))
            if side is not None:
                kw["commentary"] = side
        resp = self.spot_frames(video_id, frames, full_n, waveform, **kw)
        return dataclasses.replace(resp, fps=probe_video_fps(video_fp))

    def spot_stream_path(
        self,
        video_fp: str,
        chunk: int = 256,
        halo: int = 64,
        peak_window: int = 5,
        peak_threshold: float = 0.0,
        follow: bool = False,
        follow_timeout: float = 60.0,
    ):
        """Live spotting over a file decoded in chunks, or with ``follow=True`` over a segment directory a
        producer is still writing (``data/follow.py``) → ``spotting.SpotStreamUpdate`` s, with the finality
        contract of ``goalnet-torch spot --stream``: bounded memory, events final when reported.

        The weights are read under the lock at the stream's start: a reload
        mid-stream serves the next request, never half a timeline.  Audio
        trunks stream only in follow mode, where each segment ships its own
        ``.wav``.  Contract violations raise ``ValueError`` here, before the
        generator runs, so the server answers 400 before any byte streams.
        """
        cfg = self.cfg
        if cfg.model.text_included:
            raise ValueError(
                "spot-stream supports trunks without commentary — there is "
                "no live ingest protocol for commentary tokens; serve a "
                "trunk without --commentary or POST /spot")
        if cfg.model.audio_included and not follow:
            raise ValueError(
                "audio trunks spot-stream via follow mode (a live segment directory where each segment ships "
                'its .wav span) — pass "follow": true with a directory, serve a --no-audio trunk, or POST /spot')
        if cfg.model.temporal_model in ("transformer", "hybrid") and cfg.model.temporal_window <= 0:
            raise ValueError(
                "spot-stream needs a banded attention window (temporal_window > 0): full attention has an "
                "unbounded receptive field, so streamed scores could never be final")
        if chunk < 1 or halo < 0:
            raise ValueError(f"chunk must be >=1 and halo >=0 (got {chunk}, {halo})")
        if follow and not os.path.isdir(video_fp):
            raise ValueError(
                f"follow mode streams a segment DIRECTORY; {video_fp!r} is not one (see data/follow.py for the "
                "producer protocol)")
        with self._lock:
            params, model_state = self.state.params, self.state.model_state
            tparams = self.temporal_params
        if follow:
            chunks, audio_chunks = follow_chunks(video_fp, cfg, chunk, timeout=follow_timeout)
        else:
            chunks, audio_chunks = file_chunks(video_fp, cfg, chunk), None
        return spot_stream(params, model_state, tparams, chunks, cfg, halo=halo, peak_window=peak_window,
                           peak_threshold=peak_threshold, audio_chunks=audio_chunks, device=self.device)


def file_chunks(video_fp: str, cfg: PipelineConfig, chunk: int):
    """A video file decoded in chunks of ``chunk`` condensed frames, each preprocessed on the host (the
    timeline encoder takes normalised, resized frames)."""
    from cvml_goalnet_tpu_torch.data.video import stream_condensed_frames

    for raw in stream_condensed_frames(video_fp, cfg.preprocess.skip_frames, chunk):
        yield preprocess_frames_host(raw, cfg.preprocess.frame_size, cfg.preprocess.eps)


def follow_chunks(directory: str, cfg: PipelineConfig, chunk: int, *, poll_interval: float = 0.25,
                  timeout: float = 60.0, end_sentinel: str = "END"):
    """A live segment directory → (frame chunks preprocessed on the host, audio chunks or None): the two
    iterators ``spot_stream`` takes, in lockstep.  ``spot_stream`` pulls a frame chunk, then its audio chunk,
    so each audio chunk is queued before its frames are yielded."""
    from cvml_goalnet_tpu_torch.data.follow import follow_condensed_chunks

    pairs = follow_condensed_chunks(
        directory, cfg.preprocess.skip_frames, chunk,
        audio_cfg=cfg.audio if cfg.model.audio_included else None,
        poll_interval=poll_interval, timeout=timeout, end_sentinel=end_sentinel)
    aq: deque = deque()

    def frames():
        for raw, audio in pairs:
            if audio is not None:
                aq.append(audio)
            yield preprocess_frames_host(raw, cfg.preprocess.frame_size, cfg.preprocess.eps)

    def audio():
        while aq:
            yield aq.popleft()

    return frames(), (audio() if cfg.model.audio_included else None)


# close()'s sentinel, and a weak registry so an embedding process (or a test) can close every worker at
# shutdown: a worker left running pins its Summarizer's device tensors for the life of the process
_BATCHER_CLOSE = object()
_live_batchers: "weakref.WeakSet" = weakref.WeakSet()


class DynamicBatcher:
    """Cross-request batching for the serving path.

    The importance model is per frame (reference ``utils.py:260-272``), so the
    frames of concurrent requests can be concatenated into one ``fuse`` call
    and every request still gets its own scores exactly:

    * ``submit`` preprocesses a request on the host and queues it with a future;
    * a worker drains the queue, waiting up to ``max_wait_ms`` for co-riders
      (never delaying a batch that already fills ``max_batch_frames``, and
      never growing one past it);
    * the joined frame axis is zero-padded to a bucket size, so the kernels
      see a bounded set of shapes (``warmup`` runs each once);
    * scores are split back per request and each request's knapsack runs as
      in the unbatched path.
    """

    def __init__(
        self,
        summarizer: Summarizer,
        max_batch_frames: int = 2048,
        max_wait_ms: float = 5.0,
        buckets: tuple[int, ...] = (256, 512, 1024, 2048),
    ):
        self.summarizer = summarizer
        self.max_batch_frames = max_batch_frames
        self.max_wait_ms = max_wait_ms
        self.buckets = tuple(sorted(buckets))
        self._q: "queue.Queue" = queue.Queue()
        self.stats = {"requests": 0, "batches": 0, "batched_frames": 0}
        self._closed = False
        # serialises submit()'s closed-check and enqueue against close()'s flag and sentinel: without it a
        # submit that passed the check could enqueue behind the sentinel, and its future would never resolve
        self._submit_lock = threading.Lock()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()
        _live_batchers.add(self)

    def close(self, timeout: float = 10.0) -> None:
        """Stop the worker.  Requests already queued are still served first; ``submit()`` after ``close()``
        raises.  Idempotent."""
        with self._submit_lock:
            if self._closed:
                return
            self._closed = True
            self._q.put(_BATCHER_CLOSE)
        # wait until the worker is dead before touching the queue: a batch in _process can outlast any fixed
        # timeout (a first kernel build), and draining while it lives could steal the sentinel and fail
        # requests this contract promises to serve
        self._worker.join(timeout)
        while self._worker.is_alive():
            logging.getLogger("cvml_goalnet_tpu_torch.serve").warning(
                "DynamicBatcher.close(): worker still processing after %.1fs; waiting for it to drain the queue",
                timeout)
            self._worker.join(timeout)
        # the submit lock makes an item behind the sentinel impossible; a stranded future still fails loudly
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is not _BATCHER_CLOSE and not item[-1].done():
                item[-1].set_exception(RuntimeError("DynamicBatcher is closed"))

    def __enter__(self) -> "DynamicBatcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]   # a larger batch is scored in chunks of the largest bucket

    def warmup(self) -> None:
        """Build the kernels of the batched path and run ``fuse`` once at every bucket size."""
        s = self.summarizer
        cfg = s.cfg
        _build_sources(s.device, BATCHER_SOURCES)
        rng = np.random.default_rng(0)
        for b in self.buckets:
            feats = {
                "visual": rng.random((b, *cfg.preprocess.frame_size, 3)).astype(np.float32),
                "audio": (torch.as_tensor(rng.random((b, cfg.audio.bin_length, audio_feature_channels(cfg.audio)))
                                          .astype(np.float32), device=s.device)
                          if cfg.model.audio_included else None),
                "text": (tokenize([""] * b, cfg.model.text_vocab_size, cfg.model.text_max_len)
                         if cfg.model.text_included else None),
            }
            with s._lock:
                s._score(feats)

    def submit(
        self,
        video_id: str,
        frames: np.ndarray,
        clip_intervals: np.ndarray | None = None,
        full_n_frames: int | None = None,
        waveform: np.ndarray | None = None,
        commentary: "list[str] | None" = None,
    ) -> Future:
        """→ ``Future[SummarizeResponse]``.  ``commentary``: one string per frame for a trunk with the text
        branch (tokenised here, on the host; ``""`` for every frame without it)."""
        s = self.summarizer
        cfg = s.cfg
        # the frames are preprocessed on the host (the batch is one upload of small frames, no per-request
        # device round trip); the MFCCs are computed here, in the caller's thread, on the summarizer's device:
        # their FFTs are per request (slots of their own lengths) and would gain nothing from the batch, and a
        # request with a waveform then costs the worker no host FFT
        feats = {"visual": preprocess_frames_host(frames, cfg.preprocess.frame_size, cfg.preprocess.eps),
                 "audio": None, "text": None}
        if waveform is not None:
            feats["audio"] = extract_audio_features(waveform, len(frames), cfg.audio, s.device)
        if cfg.model.audio_included and feats["audio"] is None:
            feats["audio"] = _silent_audio(len(frames), cfg, s.device)
        if cfg.model.text_included:
            feats["text"] = tokenize(commentary if commentary is not None else [""] * len(frames),
                                     cfg.model.text_vocab_size, cfg.model.text_max_len)
        fut: Future = Future()
        with self._submit_lock:   # once close() has queued the sentinel, nothing lands behind it
            if self._closed:
                raise RuntimeError("DynamicBatcher is closed")
            self.stats["requests"] += 1
            self._q.put((video_id, feats, clip_intervals, full_n_frames, len(frames), fut))
        return fut

    def _run(self) -> None:
        carry = None  # the item that would have overflowed the last batch
        while True:
            first = carry if carry is not None else self._q.get()
            carry = None
            if first is _BATCHER_CLOSE:
                return
            batch = [first]
            total = first[4]
            deadline = time.monotonic() + self.max_wait_ms / 1e3
            while total < self.max_batch_frames:
                timeout = deadline - time.monotonic()
                if timeout <= 0:
                    break
                try:
                    item = self._q.get(timeout=timeout)
                except queue.Empty:
                    break
                if item is _BATCHER_CLOSE:
                    carry = item  # finish this batch, exit on the next turn
                    break
                if total + item[4] > self.max_batch_frames:
                    carry = item  # rides the next batch: no overshoot
                    break
                batch.append(item)
                total += item[4]
            try:
                self._process(batch, total)
            except BaseException as e:
                # the worker survives any failure: a dead worker leaves every pending and later submit()
                # waiting forever on .result()
                for *_, fut in batch:
                    if not fut.done():
                        fut.set_exception(e if isinstance(e, Exception) else RuntimeError(repr(e)))

    def _scores_chunked(self, visual: np.ndarray, audio: "torch.Tensor | None",
                        text: "np.ndarray | None" = None) -> np.ndarray:
        """Score an assembled batch through bucket-padded ``fuse`` calls, in chunks of the largest bucket, so
        no mix of requests makes a shape ``warmup`` did not run."""
        if len(visual) == 0:
            # a 0-frame rider (or an all-empty batch) answers as the unbatched path: empty scores
            return np.zeros((0,), np.float32)
        s = self.summarizer
        cap = self.buckets[-1]
        outs = []
        for i in range(0, len(visual), cap):
            v = visual[i:i + cap]
            a = audio[i:i + cap] if audio is not None else None
            t = text[i:i + cap] if text is not None else None
            n = len(v)
            pad = self._bucket(n) - n
            if pad:
                v = np.concatenate([v, np.zeros((pad,) + v.shape[1:], v.dtype)])
                if a is not None:
                    a = torch.cat([a, a.new_zeros((pad,) + tuple(a.shape[1:]))])
                if t is not None:   # padded rows hold token 0, empty commentary
                    t = np.concatenate([t, np.zeros((pad,) + t.shape[1:], t.dtype)])
            with s._lock:
                scores = s._score({"visual": v, "audio": a, "text": t})
            outs.append(scores[:n])
        return np.concatenate(outs)

    def _process(self, batch, total: int) -> None:
        cfg = self.summarizer.cfg
        try:
            # assembly inside the try: one grayscale or misshapen rider fails its batch's futures, not the worker
            visual = np.concatenate([b[1]["visual"] for b in batch])
            audio = torch.cat([b[1]["audio"] for b in batch]) if cfg.model.audio_included else None
            text = np.concatenate([b[1]["text"] for b in batch]) if cfg.model.text_included else None
            scores = self._scores_chunked(visual, audio, text)
            self.stats["batches"] += 1
            self.stats["batched_frames"] += total
            off = 0
            for video_id, _, clip_intervals, full_n, n, fut in batch:
                s = scores[off:off + n]
                off += n
                full = full_n or n * cfg.preprocess.skip_frames
                if clip_intervals is None:
                    clip_intervals = uniform_clip_intervals(cfg, full)
                res = summarize(s, clip_intervals, cfg.preprocess.skip_frames, full, cfg.knapsack,
                                knapsack_engine="native-full", device=self.summarizer.device)
                fut.set_result(SummarizeResponse(video_id=video_id, scores=s, frame_mask=res.frame_mask,
                                                 clips=np.asarray(res.clip_intervals)))
        except Exception as e:  # fail every rider, not just the first
            for *_, fut in batch:
                if not fut.done():
                    fut.set_exception(e)


class ServerMetrics:
    """Thread-safe per-endpoint request counts, error counts and latency quantiles.

    Each endpoint keeps its count, its errors (status ≥ 400) and its wall
    latencies in a ring of the last ``window`` requests, from which
    ``/metrics`` reports p50, p95 and max.
    """

    def __init__(self, window: int = 512):
        self._lock = threading.Lock()
        self._window = window
        self._lat: dict[str, deque] = {}
        self._counts: dict[str, int] = {}
        self._errors: dict[str, int] = {}
        self.started = time.time()

    def observe(self, endpoint: str, seconds: float, error: bool) -> None:
        with self._lock:
            self._counts[endpoint] = self._counts.get(endpoint, 0) + 1
            if error:
                self._errors[endpoint] = self._errors.get(endpoint, 0) + 1
            self._lat.setdefault(endpoint, deque(maxlen=self._window)).append(seconds)

    def snapshot(self, batcher: "DynamicBatcher | None" = None) -> dict:
        with self._lock:
            out: dict = {"uptime_s": round(time.time() - self.started, 3), "endpoints": {}}
            for ep, count in self._counts.items():
                lats = sorted(self._lat.get(ep, ()))
                entry = {"requests": count, "errors": self._errors.get(ep, 0)}
                if lats:
                    entry["latency_ms"] = {
                        "p50": round(1e3 * lats[len(lats) // 2], 3),
                        "p95": round(1e3 * lats[min(len(lats) - 1, int(len(lats) * 0.95))], 3),
                        "max": round(1e3 * lats[-1], 3),
                        "window": len(lats),
                    }
                out["endpoints"][ep] = entry
        if batcher is not None:
            st = dict(batcher.stats)
            if st.get("batches"):
                st["mean_batch_frames"] = round(st["batched_frames"] / st["batches"], 1)
            out["batcher"] = st
        return out


def event_seconds(frames, skip: int, fps: float) -> list[float]:
    """Condensed event frames → seconds at the container's raw frame rate, to the hundredth."""
    return [round(float(e * skip) / fps, 2) for e in frames]


def stream_lines(updates, names: list, skip: int, fps: float):
    """``spot_stream`` updates → the jsonl payloads of ``spot --stream`` and ``/spot-stream``: one
    ``{"event_condensed_frame", "event_seconds"[, "class"]}`` per event as it becomes final, and last
    ``{"streamed_frames", "events_condensed_frames", "events_seconds"[, "classes"]}``, each as (kind, payload);
    each update itself follows its events as ``("update", u)``, so a caller may emit its scores."""
    all_events: dict[int, list[int]] = {c: [] for c in range(len(names))}
    n_scores = 0
    for u in updates:
        n_scores += len(u.scores)
        per_class = u.events if isinstance(u.events, dict) else {0: u.events}
        for c, ev in sorted(per_class.items()):
            all_events[c].extend(int(e) for e in ev)
            for e in ev:
                line = {"event_condensed_frame": int(e), "event_seconds": round(float(e * skip) / fps, 2)}
                if names[c] is not None:
                    line["class"] = names[c]
                yield "event", line
        yield "update", u
    summary = {"streamed_frames": n_scores}
    if names[0] is None:
        summary["events_condensed_frames"] = all_events[0]
        summary["events_seconds"] = event_seconds(all_events[0], skip, fps)
    else:
        summary["classes"] = list(names)
        summary["events_condensed_frames"] = {c: all_events[i] for i, c in enumerate(names)}
        summary["events_seconds"] = {c: event_seconds(all_events[i], skip, fps) for i, c in enumerate(names)}
    yield "summary", summary


def serve_http(
    summarizer: Summarizer,
    host: str = "127.0.0.1",
    port: int = 8765,
    media_root: str | None = None,
    batcher: "DynamicBatcher | None" = None,
    spotter: "Spotter | None" = None,
):
    """The JSON-over-HTTP server (not started: call ``serve_forever`` or :func:`start_http_background`).

    ``media_root`` confines the video paths of requests to one directory
    (resolved, symlinks included); it is required for a non-loopback
    ``host``, where the server would otherwise read any path on the host for
    a remote caller.
    """
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    from cvml_goalnet_tpu_torch.data.video import probe_video_fps

    if media_root is None and host not in ("127.0.0.1", "localhost", "::1"):
        raise ValueError(
            f"serve_http(host={host!r}) binds a non-loopback interface; pass media_root to confine which files "
            "requests may read")
    root = os.path.realpath(media_root) if media_root is not None else None
    metrics = ServerMetrics()

    def resolve(requested: str) -> str:
        if root is None:
            return requested
        p = os.path.realpath(os.path.join(root, requested.lstrip("/")))
        if p != root and not p.startswith(root + os.sep):
            raise PermissionError(f"path escapes media root: {requested!r}")
        return p

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # quiet
            pass

        def _reply(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            self._status = code

        def _request(self) -> dict:
            length = int(self.headers.get("Content-Length", 0))
            return json.loads(self.rfile.read(length) or b"{}")

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, {"status": "ok"})
            elif self.path == "/metrics":
                self._reply(200, metrics.snapshot(batcher))
            else:
                self._reply(404, {"error": "unknown path"})

        def do_POST(self):
            t0 = time.perf_counter()
            self._status = 500
            # metrics key on the known endpoints only: a raw path would let a client mint one ring per path
            endpoint = self.path if self.path in ("/spot", "/spot-stream", "/summarize", "/reload") else "(other)"
            try:
                if self.path == "/spot":
                    self._do_spot()
                elif self.path == "/spot-stream":
                    self._do_spot_stream()
                elif self.path == "/summarize":
                    self._do_summarize()
                elif self.path == "/reload":
                    self._do_reload()
                else:
                    self._reply(404, {"error": "unknown path"})
            finally:
                metrics.observe(endpoint, time.perf_counter() - t0, self._status >= 400)

        def _do_reload(self):
            """POST /reload → swap in the weights from the services' configured locations (never a path from
            the request).  On any load failure the previous weights keep serving."""
            out, skipped = {}, {}
            for name, svc in (("summarizer", summarizer), ("spotter", spotter)):
                if svc is None:
                    continue
                try:
                    out[name] = svc.reload()
                except CheckpointMismatchError as e:
                    self._reply(500, {"error": str(e), "note": "previous weights still serving"})
                    return
                except ValueError as e:
                    skipped[name] = str(e)  # an in-memory service: nothing to reload
                except Exception as e:  # a missing or corrupt file: keep serving
                    self._reply(500, {"error": repr(e), "note": "previous weights still serving"})
                    return
            if not out:
                self._reply(400, {"error": "nothing reloadable", "detail": skipped})
                return
            self._reply(200, {"reloaded": out, "skipped": skipped})

        def _do_spot_stream(self):
            """POST /spot-stream {"video", "chunk"?, "halo"?, "peak_window"?, "peak_threshold"?,
            "emit_scores"?, "follow"?, "follow_timeout"?} → a streamed ``application/x-ndjson`` response: one
            ``{"event_condensed_frame", "event_seconds"[, "class"]}`` line per event the moment it is final
            (the lines ``spot --stream`` prints), with ``emit_scores`` one ``{"scores"}`` line per emission,
            then one closing summary line; the connection closes after it.  Contract violations are 400s
            before any byte streams; a failure mid-stream ends with an ``{"error"}`` line."""
            if spotter is None:
                self._reply(404, {"error": "spotting not enabled on this server"})
                return
            try:
                req = self._request()
                path = resolve(req["video"])
                if not os.path.exists(path):
                    raise FileNotFoundError(path)
                updates = spotter.spot_stream_path(
                    path,
                    chunk=int(req.get("chunk", 256)),
                    halo=int(req.get("halo", 64)),
                    peak_window=int(req.get("peak_window", 5)),
                    peak_threshold=float(req.get("peak_threshold", 0.0)),
                    follow=bool(req.get("follow", False)),
                    follow_timeout=float(req.get("follow_timeout", 60.0)),
                )
            except PermissionError as e:
                self._reply(403, {"error": str(e)})
                return
            except FileNotFoundError as e:
                self._reply(404, {"error": f"video not found: {e}"})
                return
            except (KeyError, ValueError, TypeError) as e:
                self._reply(400, {"error": repr(e)})
                return

            skip = spotter.cfg.preprocess.skip_frames
            fps = probe_video_fps(path) or 30.0   # the same fallback as /spot
            names = spotter.classes or [None]
            emit_scores = bool(req.get("emit_scores", False))

            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson")
            self.send_header("Cache-Control", "no-store")
            self.send_header("Connection", "close")
            self.end_headers()
            self._status = 200

            def line(payload: dict):
                self.wfile.write(json.dumps(payload).encode() + b"\n")
                self.wfile.flush()

            video_id = os.path.basename(path).rsplit(".", 1)[0]
            try:
                for kind, item in stream_lines(updates, names, skip, fps):
                    if kind == "event":
                        line(item)
                    elif kind == "summary":
                        line({"video_id": video_id, **item})
                    elif emit_scores:   # the update's scores, after its events
                        line({"scores": np.round(np.asarray(item.scores, np.float64), 6).tolist()})
            except BrokenPipeError:
                self._status = 499  # the client went away; nothing to write
            except Exception as e:
                self._status = 500   # the headers are gone: the error rides the stream
                try:
                    line({"error": repr(e)})
                except Exception:
                    pass

        def _do_summarize(self):
            try:
                path = resolve(self._request()["video"])
                if batcher is not None:
                    # concurrent requests share fuse calls; load_media is the sequence summarize_path runs
                    video_id, frames, full_n, waveform = load_media(path, summarizer.cfg)
                    resp = batcher.submit(
                        video_id, frames, None, full_n, waveform=waveform,
                        commentary=_load_commentary_sidecar(path, summarizer.cfg, len(frames))).result()
                else:
                    resp = summarizer.summarize_path(path)
                self._reply(200, {
                    "video_id": resp.video_id,
                    "mask_frames": int(resp.frame_mask.sum()),
                    "clips": resp.clips.tolist(),
                    "scores": np.round(resp.scores, 4).tolist(),
                })
            except PermissionError as e:
                self._reply(403, {"error": str(e)})
            except FileNotFoundError as e:
                self._reply(404, {"error": f"video not found: {e}"})
            except Exception as e:  # a 500 with its message
                self._reply(500, {"error": repr(e)})

        def _do_spot(self):
            """POST /spot {"video", "peak_window"?, "peak_threshold"?} → event frames (per class when the
            Spotter has classes) and the eventness-driven knapsack summary: ``spot`` over HTTP."""
            if spotter is None:
                self._reply(404, {"error": "spotting not enabled on this server"})
                return
            try:
                req = self._request()
                path = resolve(req["video"])
                resp = spotter.spot_path(path, peak_window=int(req.get("peak_window", 5)),
                                         peak_threshold=float(req.get("peak_threshold", 0.0)))
                skip = spotter.cfg.preprocess.skip_frames
                # the container's fps (production footage is 25 fps); 30.0 only for fps-less npz archives, the
                # reference's export convention (utils.py:523)
                fps = resp.fps or 30.0
                if isinstance(resp.events, dict):
                    events = {c: ev.tolist() for c, ev in resp.events.items()}
                    seconds = {c: event_seconds(ev, skip, fps) for c, ev in resp.events.items()}
                else:
                    events = resp.events.tolist()
                    seconds = event_seconds(resp.events, skip, fps)
                self._reply(200, {
                    "video_id": resp.video_id,
                    "classes": spotter.classes,
                    "fps": resp.fps,
                    "events_condensed_frames": events,
                    "events_seconds": seconds,
                    "summary_clips": resp.summary_clips.tolist(),
                    "summary_frames": resp.summary_frames,
                })
            except PermissionError as e:
                self._reply(403, {"error": str(e)})
            except FileNotFoundError as e:
                self._reply(404, {"error": f"video not found: {e}"})
            except Exception as e:
                self._reply(500, {"error": repr(e)})

    return ThreadingHTTPServer((host, port), Handler)


def start_http_background(summarizer: Summarizer, host="127.0.0.1", port=8765, media_root=None, batcher=None,
                          spotter=None):
    """:func:`serve_http` serving from a daemon thread → the server (``shutdown()`` and ``server_close()`` it)."""
    server = serve_http(summarizer, host, port, media_root, batcher, spotter)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server
