"""Temporal event spotting over long timelines: the port's spotting entry points.

Port of ``cvml_goalnet_tpu/spotting.py``:

* :func:`encode_timeline` — the trunk (audio, visual and text encoders, no
  fusion head) over all frames → (T, D) per-frame features, ``[audio ‖
  visual ‖ text]``;
* :func:`score_timeline_auto` — dispatch on ``ModelConfig.temporal_model``:
  the bidirectional GRU (chunked with halos past
  ``temporal_chunk_threshold``), the transformer (full or banded flash
  attention) or the GRU + transformer hybrid;
* :func:`score_timeline_sharded` — the same over the ranks of a
  context-parallel grid (``parallel/mesh.py::cp_groups``);
* :func:`spot_events` / :func:`spot_events_multi` — local-peak event frames;
* :func:`summarize_match` — frames → features → scores → events and a
  knapsack highlight summary over ``pipeline.summarize``;
* :func:`spot_stream` — the same over a live stream of frame chunks, with
  final scores and events per update.

Entry points take ``device``: ``None`` is the card (raising without one),
``device="cpu"`` runs the plain versions of the kernels.  Features stay on
the device as tensors; scores and events come back as NumPy.
"""

from __future__ import annotations

import json
import warnings
from dataclasses import dataclass

import numpy as np
import torch

from cvml_goalnet_tpu_torch.config import KnapsackConfig, PipelineConfig
from cvml_goalnet_tpu_torch.device import resolve_device
from cvml_goalnet_tpu_torch.models.audio import audio_encoder_apply
from cvml_goalnet_tpu_torch.models.avm import visual_apply
from cvml_goalnet_tpu_torch.models.temporal import detect_peaks, detect_peaks_multi, temporal_scorer_apply
from cvml_goalnet_tpu_torch.models.temporal_attention import temporal_transformer_apply
from cvml_goalnet_tpu_torch.models.temporal_hybrid import temporal_hybrid_apply
from cvml_goalnet_tpu_torch.models.text import text_encoder_apply
from cvml_goalnet_tpu_torch.pipeline import SummaryResult, _on, _tokens, summarize


def encode_timeline(params, state, visual, audio, cfg: PipelineConfig, device=None, text=None) -> torch.Tensor:
    """(T, h, w, C) normalised frames (+ (T, B, n_mfcc) audio, + (T, text_max_len) commentary tokens) →
    (T, D) features on the device, ``[audio ‖ visual ‖ text]``.

    ``params``/``state`` are the port's tensors (``weights.from_jax``).  The
    audio features lead when ``cfg.model.audio_included`` and audio is given;
    ``text`` is required when ``cfg.model.text_included``: a 3-modality
    trunk's features include the text branch's.  The trunk runs in float32
    whatever ``cfg.model.dtype`` says, as the JAX package's ``trunk_fn``
    casts nothing; ``quantized_inference`` takes conv1 and conv2 through
    int8, with one activation scale over all T frames.
    """
    if cfg.model.text_included and text is None:
        raise ValueError(
            "cfg.model.text_included=True but encode_timeline got no text "
            "tokens — pass the commentary tokens (VideoItem.text / "
            "data.text.tokenize) or use a trunk trained without --commentary"
        )
    dev = resolve_device(device)
    return encode_on_device(params, state, _on(visual, dev), None if audio is None else _on(audio, dev),
                            _tokens(text, dev) if cfg.model.text_included else None, cfg.model)


def encode_on_device(params, state, visual: torch.Tensor, audio: torch.Tensor | None, text: torch.Tensor | None,
                     cfg_model) -> torch.Tensor:
    """The trunk of :func:`encode_timeline` (JAX ``spotting.trunk_fn``) on tensors already on one device → (T, D)
    features there (the data-parallel encode runs one per device)."""
    apply, _ = visual_apply(cfg_model)
    with torch.no_grad():
        feats = apply(params["visual"], state["visual"], visual, quant=cfg_model.quantized_inference)
        if cfg_model.audio_included and audio is not None:
            feats = torch.cat([audio_encoder_apply(params["audio"], audio), feats], dim=-1)
        if cfg_model.text_included:
            feats = torch.cat([feats, text_encoder_apply(params["text"], text, cfg=cfg_model)], dim=-1)
    return feats


def score_timeline(temporal_params, features: torch.Tensor, hidden: int) -> torch.Tensor:
    """(T, D) features → (T,) event scores from the bidirectional GRU."""
    return temporal_scorer_apply(temporal_params, features, hidden)


def head_out_dim(temporal_params) -> int:
    """Output arity (class count) of a temporal head of any family."""
    p = temporal_params.get("transformer", temporal_params)
    return int(p["head"]["w"].shape[-1])


def score_timeline_auto(temporal_params, features: torch.Tensor, cfg: PipelineConfig) -> torch.Tensor:
    """Dispatch on ``cfg.model.temporal_model`` → (T,) scores, or (T, C) for a C-class head.

    GRU timelines longer than ``temporal_chunk_threshold`` (when it is not 0)
    are scored chunked with halos, as in the JAX package.
    """
    mc = cfg.model
    if mc.temporal_model == "transformer":
        return temporal_transformer_apply(temporal_params, features, mc.temporal_num_heads, mc.temporal_window)
    if mc.temporal_model == "hybrid":
        return temporal_hybrid_apply(temporal_params, features, mc.temporal_hidden, mc.temporal_num_heads,
                                     mc.temporal_window)
    if mc.temporal_chunk_threshold and features.shape[0] > mc.temporal_chunk_threshold:
        return score_timeline_chunked(temporal_params, features, mc.temporal_hidden, mc.temporal_chunk,
                                      mc.temporal_halo)
    return temporal_scorer_apply(temporal_params, features, mc.temporal_hidden)


def score_timeline_chunked(temporal_params, features: torch.Tensor, hidden: int, chunk: int = 512,
                           overlap: int = 64) -> torch.Tensor:
    """GRU scores chunk by chunk, each chunk with up to ``overlap`` frames of real context per side.

    Windows of ``chunk + 2·overlap`` frames are clamped into the timeline
    (never zero-padded) and scored together as one batch; halo scores are
    discarded.
    """
    t = features.shape[0]
    window = chunk + 2 * overlap
    if t <= window:
        return temporal_scorer_apply(temporal_params, features, hidden)
    n_out = int(temporal_params["head"]["w"].shape[-1])
    starts = np.arange(-(-t // chunk)) * chunk
    win_starts = np.clip(starts - overlap, 0, t - window)
    wins = torch.stack([features[ws : ws + window] for ws in win_starts])
    s = temporal_scorer_apply(temporal_params, wins, hidden).reshape(len(win_starts), window, n_out)
    keep = starts - win_starts
    scores = torch.cat([s[i, k : k + chunk] for i, k in enumerate(keep)])[:t]
    return scores[:, 0] if n_out == 1 else scores


def score_timeline_sharded(temporal_params, features: torch.Tensor, groups, cfg: PipelineConfig) -> torch.Tensor:
    """Context-parallel scoring of a (T, D) timeline over the ctx axis of ``groups`` (every rank of it calls this
    with the whole timeline) → (T,) or (T, C) on every rank.

    The transformer runs ``temporal_transformer_sharded_apply`` (ring or halo
    attention, equal to the monolithic scorer); the GRU and the hybrid score
    their chunks with halos (``score_timeline_chunked``'s windows, clamped
    into the timeline) with the chunk list split over the ranks and gathered.
    A timeline no longer than one window goes to :func:`score_timeline_auto`.
    """
    from cvml_goalnet_tpu_torch.models.temporal_attention import temporal_transformer_sharded_apply
    from cvml_goalnet_tpu_torch.parallel.collectives import all_gather_cat

    mc = cfg.model
    if mc.temporal_model == "transformer":
        return temporal_transformer_sharded_apply(temporal_params, features, groups, mc.temporal_num_heads,
                                                  mc.temporal_window)
    t = features.shape[0]
    chunk, overlap = mc.temporal_chunk, mc.temporal_halo
    window = chunk + 2 * overlap
    if t <= window:
        return score_timeline_auto(temporal_params, features, cfg)
    n_out = head_out_dim(temporal_params)
    n = groups.ctx.size
    n_pad = -(-(-(-t // chunk)) // n) * n
    starts = np.arange(n_pad) * chunk
    win_starts = np.clip(starts - overlap, 0, t - window)
    keep = np.minimum(starts - win_starts, window)   # a pad chunk's slice clamped in, as dynamic_slice does
    mine = range(groups.ctx.index * (n_pad // n), (groups.ctx.index + 1) * (n_pad // n))
    wins = torch.stack([features[win_starts[i]:win_starts[i] + window] for i in mine])
    if mc.temporal_model == "hybrid":
        s = torch.stack([temporal_hybrid_apply(temporal_params, w, mc.temporal_hidden, mc.temporal_num_heads,
                                               mc.temporal_window) for w in wins])
    else:
        s = temporal_scorer_apply(temporal_params, wins, mc.temporal_hidden)
    s = s.reshape(len(mine), window, n_out)
    s = torch.cat([s, s.new_zeros((len(mine), chunk, n_out))], dim=1)
    local = torch.stack([s[j, keep[i]:keep[i] + chunk] for j, i in enumerate(mine)])
    scores = all_gather_cat(local, groups.ctx).reshape(-1, n_out)[:t]
    return scores[:, 0] if n_out == 1 else scores


def load_event_labels(path: str, n_condensed: int, skip_frames: int, classes=None) -> np.ndarray:
    """An event sidecar (``<video>.events.json``) → per-frame labels.

    A JSON list of raw frame indices, or of ``{"frame": i}`` /
    ``{"frame": i, "label": name}`` objects.  Each event marks the condensed
    frame containing it (``raw // skip_frames``); events past the timeline
    are ignored.  ``classes=None`` → (T,) binary labels; a list of names →
    (T, C) labels, dropping entries whose label is missing or unknown (with
    a warning when none matched).
    """
    with open(path) as f:
        raw = json.load(f)
    if classes is None:
        labels = np.zeros((n_condensed,), np.float32)
    else:
        labels = np.zeros((n_condensed, len(classes)), np.float32)
        index = {name: i for i, name in enumerate(classes)}
    for e in raw:
        frame = int(e["frame"]) if isinstance(e, dict) else int(e)
        idx = frame // skip_frames
        if not 0 <= idx < n_condensed:
            continue
        if classes is None:
            labels[idx] = 1.0
        else:
            name = e.get("label") if isinstance(e, dict) else None
            if name in index:
                labels[idx, index[name]] = 1.0
    if classes is not None and len(raw) > 0 and labels.sum() == 0:
        warnings.warn(
            f"{path}: {len(raw)} events but NONE matched classes {list(classes)} "
            "(plain frame indices carry no label; use {\"frame\": i, "
            "\"label\": name} entries) — training on these labels would "
            "supervise all-negative",
            stacklevel=2,
        )
    return labels


def scores_to_importance(scores: np.ndarray) -> np.ndarray:
    """Map temporal scores affinely onto the [1, 5] importance scale of the summarization path."""
    scores = np.asarray(scores)
    lo, hi = scores.min(), scores.max()
    return 1.0 + 4.0 * (scores - lo) / max(hi - lo, 1e-7)


def spot_events(scores, window: int = 5, threshold: float = 0.0) -> np.ndarray:
    """Event frame indices from (T,) temporal scores."""
    return np.nonzero(detect_peaks(torch.as_tensor(scores), window, threshold).cpu().numpy())[0]


def spot_events_multi(scores, window: int = 5, threshold: float = 0.0) -> list[np.ndarray]:
    """(T, C) scores → per-class event frame-index arrays; (T,) counts as C = 1."""
    s = torch.as_tensor(scores)
    if s.dim() == 1:
        s = s[:, None]
    mask = detect_peaks_multi(s, window, threshold).cpu().numpy()
    return [np.nonzero(mask[:, c])[0] for c in range(mask.shape[1])]


@dataclass
class MatchSummary:
    events: np.ndarray                # spotted event frame indices
    scores: np.ndarray                # (T,) temporal event scores
    summary: SummaryResult            # knapsack highlight selection


def summarize_match(
    params,
    state,
    temporal_params,
    visual,
    audio,
    clip_intervals,
    cfg: PipelineConfig,
    skip_frames: int | None = None,
    full_n_frames: int | None = None,
    peak_window: int = 5,
    peak_threshold: float = 0.0,
    kcfg: KnapsackConfig | None = None,
    device=None,
    text=None,
) -> MatchSummary:
    """Frames → features → temporal scores → events and a knapsack highlight summary.

    Scores are mapped onto the [1, 5] importance scale, so the knapsack stage
    is the summarization path's own.  Single-class heads only.
    """
    dev = resolve_device(device)
    skip = cfg.preprocess.skip_frames if skip_frames is None else skip_frames
    full_n = len(visual) * skip if full_n_frames is None else full_n_frames
    feats = encode_timeline(params, state, visual, audio, cfg, device=dev, text=text)
    scores = score_timeline_auto(temporal_params, feats, cfg).cpu().numpy()
    if scores.ndim != 1:
        raise ValueError(
            "summarize_match expects a single-class temporal head; for multi-class heads use "
            "spot_events_multi + pipeline.summarize"
        )
    events = spot_events(scores, peak_window, peak_threshold)
    res = summarize(scores_to_importance(scores), clip_intervals, skip, full_n, kcfg or cfg.knapsack, device=dev)
    return MatchSummary(events=events, scores=scores, summary=res)


@dataclass
class SpotStreamUpdate:
    """One emission of :func:`spot_stream`.

    ``scores``: the newly emitted (k,) or (k, C) scores (their concatenation
    over all updates is the streamed timeline).  ``events``: global frame
    indices that became stable with this emission (their ±peak_window
    neighbourhood is emitted), an array for a single-class head, else a
    ``{class_idx: array}`` dict.
    """

    scores: np.ndarray
    events: "np.ndarray | dict[int, np.ndarray]"


def _stable_new_events(scores: np.ndarray, stable_upto: int, prev_stable: int, window: int,
                       threshold: float) -> np.ndarray:
    """Host peak scan over [prev_stable, stable_upto) of the emitted prefix (``detect_peaks``' rule)."""
    lo, hi = prev_stable, stable_upto
    if hi <= lo:
        return np.empty((0,), np.int64)
    out = []
    for i in range(lo, hi):
        a, b = max(0, i - window), min(len(scores), i + window + 1)
        s = scores[i]
        if s > threshold and s >= scores[a:b].max():
            out.append(i)
    return np.asarray(out, np.int64)


def spot_stream(
    params,
    state,
    temporal_params,
    frame_chunks,
    cfg: PipelineConfig,
    *,
    halo: int = 64,
    peak_window: int = 5,
    peak_threshold: float = 0.0,
    audio_chunks=None,
    text_chunks=None,
    device=None,
):
    """Online event spotting over a live stream of frame chunks → :class:`SpotStreamUpdate` s.

    The emission contract of the JAX package's ``spot_stream``:

    * the first chunk never emits on arrival (a one-chunk stream yields
      exactly one update, scored like the offline timeline);
    * from the second chunk on, an update is yielded whenever more than
      ``halo`` frames are buffered, at most one per chunk; each is scored
      with the ≤ ``halo`` emitted frames before it as left context;
    * the banded transformer's receptive field is ``num_layers·window``, so
      ``halo`` is raised to that floor and its streamed scores equal the
      offline ones; the GRU and the hybrid agree up to state decay across
      the halo; full attention (``temporal_window == 0``) is refused;
    * at the end one update flushes what is buffered; with nothing buffered
      (possible with ``halo=0``) but events within ``peak_window`` of the end
      unreported, a final update with empty scores delivers them.

    ``audio_chunks``: (k, B, n_mfcc) blocks on the same boundaries as
    ``frame_chunks``, required when the trunk includes audio;
    ``text_chunks``: (k, text_max_len) token ids likewise, when it includes
    the text branch.
    """
    mc = cfg.model
    if mc.temporal_model in ("transformer", "hybrid") and mc.temporal_window <= 0:
        raise ValueError(
            f"spot_stream with the {mc.temporal_model} scorer needs a banded window "
            "(cfg.model.temporal_window > 0): full attention has an unbounded receptive field, "
            "so no finite halo can make streamed scores final — score with a band or spot offline"
        )
    if mc.audio_included and audio_chunks is None:
        raise ValueError(
            "cfg.model.audio_included=True but spot_stream got no audio_chunks — yield "
            "(k, B, n_mfcc) blocks on the frame-chunk boundaries, or stream with a trunk trained --no-audio"
        )
    if mc.text_included and text_chunks is None:
        raise ValueError(
            "cfg.model.text_included=True but spot_stream got no "
            "text_chunks — yield (k, text_max_len) token chunks on the "
            "frame-chunk boundaries, or stream with a trunk trained "
            "without --commentary")
    dev = resolve_device(device)
    n_out = head_out_dim(temporal_params)
    audio_iter = iter(audio_chunks) if audio_chunks is not None else None
    text_iter = iter(text_chunks) if text_chunks is not None else None

    def next_aligned(it, name, k):
        try:
            a = next(it)
        except StopIteration:
            raise ValueError(
                f"{name} exhausted before frame_chunks — the stream must yield one chunk per "
                "frame chunk") from None
        if len(a) != k:
            raise ValueError(
                f"{name} chunk has {len(a)} rows but the frame chunk has {k} — chunk "
                "the modalities on the same boundaries as frame_chunks")
        return a

    def encode(chunk):
        audio = next_aligned(audio_iter, "audio_chunks", len(chunk)) if audio_iter is not None else None
        text = next_aligned(text_iter, "text_chunks", len(chunk)) if text_iter is not None else None
        return encode_timeline(params, state, chunk, audio, cfg, device=dev, text=text)

    if mc.temporal_model == "transformer":
        # exactness floor: a score depends on inputs within num_layers·W frames
        halo = max(halo, len(temporal_params["layers"]) * mc.temporal_window)

        def score(feats, global_start):
            return temporal_transformer_apply(temporal_params, feats, mc.temporal_num_heads, mc.temporal_window,
                                              global_start)
    elif mc.temporal_model == "hybrid":
        halo = max(halo, len(temporal_params["transformer"]["layers"]) * mc.temporal_window)

        def score(feats, global_start):
            return temporal_hybrid_apply(temporal_params, feats, mc.temporal_hidden, mc.temporal_num_heads,
                                         mc.temporal_window, global_start)
    else:
        def score(feats, global_start):  # the GRU has no positions
            return temporal_scorer_apply(temporal_params, feats, mc.temporal_hidden)

    def score_window(feats, global_start):
        s = score(feats, global_start).cpu().numpy()
        return s[:, None] if s.ndim == 1 else s

    emitted = np.empty((0, n_out), np.float32)
    prev_stable = 0

    def drain(new_scores, final: bool):
        """Append an emission, collect the events it made stable, build the update."""
        nonlocal emitted, prev_stable
        emitted = np.concatenate([emitted, new_scores.astype(np.float32)])
        stable_upto = len(emitted) if final else max(0, len(emitted) - peak_window)
        per_class = {c: _stable_new_events(emitted[:, c], stable_upto, prev_stable, peak_window, peak_threshold)
                     for c in range(n_out)}
        prev_stable = stable_upto
        return SpotStreamUpdate(scores=new_scores[:, 0] if n_out == 1 else new_scores,
                                events=per_class[0] if n_out == 1 else per_class)

    left = None          # the ≤ halo emitted frames before `buf`
    buf = None           # encoded features not emitted yet
    emitted_n = 0        # frames emitted so far
    first = True
    for chunk in frame_chunks:
        feats = encode(chunk)
        buf = feats if buf is None else torch.cat([buf, feats])
        if left is None:
            left = feats[:0]
        if first:
            first = False
            continue
        emit_n = len(buf) - halo
        if emit_n > 0:
            s = score_window(torch.cat([left, buf]), emitted_n - len(left))[len(left) : len(left) + emit_n]
            tail = torch.cat([left, buf[:emit_n]])
            # the last ≤ halo frames; a negative start would keep only the last halo − len(tail)
            left = tail[max(len(tail) - halo, 0) :]
            emitted_n += emit_n
            buf = buf[emit_n:]
            yield drain(s, final=False)
    if buf is not None and len(buf):
        s = score_window(torch.cat([left, buf]), emitted_n - len(left))[len(left) :]
        yield drain(s, final=True)
    elif emitted_n and prev_stable < len(emitted):
        yield drain(np.empty((0, n_out), np.float32), final=True)
