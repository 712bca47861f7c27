"""Public entry points of the port: ``extract_features`` → ``fuse`` / ``fuse_many`` → ``summarize``.

Port of ``cvml_goalnet_tpu/pipeline.py`` (``:37-252``):

* ``extract_features`` — raw frames, waveform and commentary in, model-ready
  tensors out (reference ``utils.py:274-292`` and ``:313-349``; the
  commentary's token ids, ``data/text.py``);
* ``fuse`` — features in, per-frame importance scores in [1, 5] out
  (reference ``AVM.forward``, ``utils.py:260-272``); ``fuse_many`` batches
  several videos into one forward;
* ``summarize`` — scores in, knapsack keyshot mask out (reference
  ``postprocess``, ``utils.py:606-643``), staged or, with
  ``knapsack_engine="native-full"``, in one call of the C++ runtime.

Every entry point takes ``device``: ``None`` means the card, and raises when
there is none; ``device="cpu"`` runs the plain PyTorch versions of the
kernels.  Features stay on the device as tensors; scores come back as NumPy.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from cvml_goalnet_tpu_torch import runtime
from cvml_goalnet_tpu_torch.config import KnapsackConfig, PipelineConfig
from cvml_goalnet_tpu_torch.data.text import tokenize
from cvml_goalnet_tpu_torch.device import resolve_device
from cvml_goalnet_tpu_torch.models.avm import avm_apply
from cvml_goalnet_tpu_torch.ops.audio import extract_audio_features
from cvml_goalnet_tpu_torch.ops.clips import clip_stats
from cvml_goalnet_tpu_torch.ops.expand import expand_scores
from cvml_goalnet_tpu_torch.ops.knapsack import knapsack_select
from cvml_goalnet_tpu_torch.ops.preprocess import preprocess_frames
from cvml_goalnet_tpu_torch.utils import compute_dtype, tree_cast


def extract_features(frames, waveform, cfg: PipelineConfig, commentary=None, device=None) -> dict:
    """Decimated frames (N, H, W, C) + waveform (+ commentary) → ``{"visual", "audio", "text"}`` on the device.

    ``visual`` is (N, h, w, C) float32, ``audio`` (N, B, n_mfcc) float32 or
    None without a waveform, ``text`` the (N, text_max_len) int32 token ids
    of ``commentary`` (one string per frame, ``data/text.py::tokenize``) or
    None without it.
    """
    dev = resolve_device(device)
    frames = np.asarray(frames)
    if frames.dtype != np.uint8:
        frames = frames.astype(np.float32)
    visual = preprocess_frames(torch.from_numpy(np.ascontiguousarray(frames)).to(dev),
                               cfg.preprocess.frame_size, cfg.preprocess.eps)
    audio = None
    if waveform is not None:
        audio = extract_audio_features(waveform, len(frames), cfg.audio, dev)
    text = None
    if commentary is not None:
        if len(commentary) != len(frames):
            raise ValueError(f"one commentary string per frame: {len(commentary)} strings for {len(frames)} frames")
        text = torch.from_numpy(tokenize(commentary, cfg.model.text_vocab_size, cfg.model.text_max_len)).to(dev)
    return {"visual": visual, "audio": audio, "text": text}


def _on(x, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32).to(dev)


def _tokens(x, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(x).to(device=dev, dtype=torch.int32)


def fuse(params, state, features: dict, cfg: PipelineConfig, device=None, text=None) -> np.ndarray:
    """Modality features → (N,) per-frame importance scores in [out_lo, out_hi].

    ``params`` and ``state`` are the port's tensors (``weights.from_jax``) on
    the same device.  [audio ‖ visual ‖ text] are fused as the model was
    trained; ``text`` (token ids) takes the place of ``features["text"]``
    when given.  As the JAX package's ``_jitted_fuse`` does, the forward
    runs in ``cfg.model.dtype``: for bf16, params, state and features are
    cast to bf16 first (token ids stay integers) and the scores come back as
    float32 of the bf16 outputs; ``quantized_inference`` takes conv1 and
    conv2 through int8, with one activation scale over the whole batch.
    """
    dev = resolve_device(device)
    if len(features["visual"]) == 0:
        # a zero-length stream tail or empty request gives an empty score vector
        return np.zeros((0,), np.float32)
    audio = None
    if cfg.model.audio_included:
        if features.get("audio") is None:
            raise ValueError(
                "cfg.model.audio_included=True but features['audio'] is None — "
                "pass a waveform to extract_features, or substitute silent-"
                "audio features (zeros of (N, bin_length, n_mfcc)) as "
                "serve.Summarizer does"
            )
        audio = _on(features["audio"], dev)
    if text is None and cfg.model.text_included:
        if features.get("text") is None:
            raise ValueError(
                "cfg.model.text_included=True but features['text'] is None — "
                "pass commentary to extract_features (the model's text branch "
                "cannot run on a missing modality)"
            )
        text = features["text"]
    text = _tokens(text, dev) if cfg.model.text_included else None
    return fuse_on_device(params, state, _on(features["visual"], dev), audio, text, cfg.model).cpu().numpy()


def fuse_on_device(params, state, visual: torch.Tensor, audio: torch.Tensor | None, text: torch.Tensor | None,
                   cfg_model) -> torch.Tensor:
    """The forward of :func:`fuse` on tensors already on one device → (N,) float32 scores there, not waited for
    (the data-parallel fuse issues one of these per device)."""
    dt = compute_dtype(cfg_model.dtype)
    with torch.no_grad():
        out = avm_apply(tree_cast(params, dt), tree_cast(state, dt), visual.to(dt),
                        None if audio is None else audio.to(dt), text, cfg=cfg_model)
    return out[:, 0].to(torch.float32)


def fuse_many(params, state, features_list: list[dict], cfg: PipelineConfig, device=None) -> list[np.ndarray]:
    """Several videos in one forward: frame axes concatenated, scores split back per video."""
    if not features_list:
        return []
    dev = resolve_device(device)

    def stack(key, to=_on):
        vals = [f.get(key) for f in features_list]
        missing = [i for i, v in enumerate(vals) if v is None]
        if missing:
            raise ValueError(
                f"cfg.model.{key}_included=True but features_list"
                f"[{missing[0]}]['{key}'] is None — every batched video "
                f"needs the {key} modality (substitute silence/empty "
                "commentary explicitly if intended)"
            )
        return torch.cat([to(v, dev) for v in vals])

    visual = stack("visual")
    audio = stack("audio") if cfg.model.audio_included else None
    text = stack("text", _tokens) if cfg.model.text_included else None
    scores = fuse(params, state, {"visual": visual, "audio": audio, "text": text}, cfg, device=dev)
    out, off = [], 0
    for f in features_list:
        n = len(f["visual"])
        out.append(scores[off : off + n])
        off += n
    return out


@dataclass
class SummaryResult:
    frame_mask: np.ndarray              # (full_n_frames,) uint8 inclusion mask
    selected_clips: list[int]           # knapsack-chosen clip indices
    clip_intervals: np.ndarray          # the selected [start, end] intervals
    summary_frames: np.ndarray | None   # concatenated raw frames (if provided)


def summarize(
    importances,
    clip_intervals: np.ndarray,
    skip_frames: int,
    full_n_frames: int,
    kcfg: KnapsackConfig = KnapsackConfig(),
    full_frames: np.ndarray | None = None,
    knapsack_engine: str = "auto",
    device=None,
) -> SummaryResult:
    """Importance scores → keyshot summary: round → expand to the raw rate →
    per-clip sums → 0/1 knapsack at ``summary_ratio``·full_n_frames → frame mask.

    Expansion and clip sums run on the device, then ``knapsack_engine`` picks
    the knapsack (``ops/knapsack.py``: ``"auto"``, ``"host"``, ``"native"`` or
    ``"device"``, the last on this device).  ``"native-full"`` runs the whole
    postprocess in one C++ call (``runtime/postprocess.cc``), the same
    semantics; it raises when the runtime cannot be built, and takes the
    staged path with ``"auto"`` when the call refuses its arguments (no scores
    or no frames), as the JAX package does.
    """
    dev = resolve_device(device)
    imp = importances.cpu().numpy() if isinstance(importances, torch.Tensor) else np.asarray(importances)
    if imp.ndim == 2:
        if imp.shape[1] != 1:
            raise ValueError(f"importances must be (N,) or (N, 1), got {imp.shape}")
        imp = imp[:, 0]
    if knapsack_engine == "native-full":
        res = runtime.summarize_native(imp, clip_intervals, skip_frames, full_n_frames, kcfg.summary_ratio,
                                       kcfg.inclusive_mask)
        if res is not None:
            selected, mask = res
            iv = np.asarray(clip_intervals)
            chosen = iv[selected] if selected else np.zeros((0, 2), iv.dtype)
            summary_frames = None
            if full_frames is not None and len(chosen):
                summary_frames = np.concatenate([full_frames[int(a) : int(b)] for a, b in chosen], axis=0)
            return SummaryResult(frame_mask=mask, selected_clips=selected, clip_intervals=chosen,
                                 summary_frames=summary_frames)
        knapsack_engine = "auto"
    imp = np.round(imp).astype(np.int8)  # round-half-even, like torch.round → int8

    expanded = expand_scores(torch.as_tensor(imp.astype(np.int64), device=dev), skip_frames, full_n_frames)
    intervals = torch.as_tensor(np.asarray(clip_intervals, np.int64), device=dev)
    clip_imps, clip_lens = clip_stats(intervals, expanded)

    capacity = int(kcfg.summary_ratio * full_n_frames)
    selected = knapsack_select(clip_imps.cpu().numpy(), clip_lens.cpu().numpy(), capacity, kcfg.scale_factor,
                               engine=knapsack_engine, device=dev)

    iv = np.asarray(clip_intervals)
    chosen = iv[selected] if selected else np.zeros((0, 2), iv.dtype)
    mask = np.zeros((full_n_frames,), dtype=np.uint8)
    for a, b in chosen:
        end = int(b) + (1 if kcfg.inclusive_mask else 0)
        mask[int(a) : min(end, full_n_frames)] = 1

    summary_frames = None
    if full_frames is not None and len(chosen):
        summary_frames = np.concatenate([full_frames[int(a) : int(b)] for a, b in chosen], axis=0)
    return SummaryResult(frame_mask=mask, selected_clips=list(selected), clip_intervals=chosen,
                         summary_frames=summary_frames)
