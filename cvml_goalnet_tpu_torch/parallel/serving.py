"""Data-parallel serving: the eval ``fuse`` and the Spotter's trunk split over a device mesh.

Port of ``cvml_goalnet_tpu/parallel/serving.py``.  The importance model is
strictly per frame at eval (batchnorm uses running statistics, reference
``utils.py:260-272``), so a batch splits exactly along its frame axis: it is
zero-padded to a multiple of the mesh size, cut into contiguous blocks, each
block scored on its own device with the weights replicated there once per
checkpoint (re)load (:func:`replicate`), and the results concatenated in
order.  Each block's forward is the single-device one (``pipeline.fuse``'s,
``spotting.encode_timeline``'s), so on the card each block launches kernels
1–4 on its own card.  Without int8 the blocks are issued one after another
without a wait, so the cards run them at once; the host waits when it
gathers them.

Where JAX compiles one GSPMD program, reductions over the batch see the
whole batch.  The port's one such reduction is the int8 activation scale of
``quantized_inference`` (conv1 and conv2 of the reference backbone, the 12
convs of the resnet, the 24 linears of the vit).  Under it the blocks run in
lockstep, one thread each (:func:`_run_blocks`): at every quantized point
each block computes its own scale (on the card, the 2-int8 kernels' amax),
waits at a barrier for the others, and quantizes with the largest, so every
block takes the padded batch's scale, as JAX's program does (its zero rows
included, as JAX counts them).
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from cvml_goalnet_tpu_torch.config import ModelConfig
from cvml_goalnet_tpu_torch.ops import quant
from cvml_goalnet_tpu_torch.train.optim import tree_map


class Replicas(tuple):
    """One copy of a tree per mesh entry (entries on the same device share one copy)."""


def replicate(tree, mesh) -> Replicas:
    """``tree`` (tensors) copied to every device of ``mesh`` once; a tree already replicated is returned as is."""
    if isinstance(tree, Replicas):
        return tree
    copies: dict = {}
    for dev in mesh:
        if dev not in copies:
            copies[dev] = tree_map(lambda t, d=dev: t.to(d), tree)
    return Replicas(copies[dev] for dev in mesh)


def _padded(x, rows: int, dtype=None) -> torch.Tensor:
    """``x`` (array or tensor) as a tensor with ``rows`` zero rows appended."""
    x = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x)
    if dtype is not None:
        x = x.to(dtype)
    if rows == 0:
        return x
    return torch.cat([x, x.new_zeros((rows,) + tuple(x.shape[1:]))])


def _blocks(mesh, visual, audio, text):
    """(device, visual, audio, text) per mesh entry: the batch zero-padded to a multiple of the mesh size and
    cut into contiguous blocks, each on its device."""
    n = len(visual)
    pad = (-n) % len(mesh)
    b = (n + pad) // len(mesh)
    parts = [None if x is None else _padded(x, pad, dtype) for x, dtype in
             ((visual, torch.float32), (audio, torch.float32), (text, torch.int32))]
    for i, dev in enumerate(mesh):
        sl = slice(i * b, (i + 1) * b)
        yield (dev, *(None if x is None else x[sl].to(dev, non_blocking=True).contiguous() for x in parts))


class _BatchScale:
    """The batch's activation scale at each quantized point of ``n`` blocks running in lockstep."""

    def __init__(self, n: int):
        self.barrier = threading.Barrier(n)
        self.slots = [0.0] * n

    def reducer(self, i: int):
        def reduce(s: torch.Tensor) -> torch.Tensor:
            self.slots[i] = float(s)
            self.barrier.wait()
            batch = max(self.slots)
            self.barrier.wait()   # every block has read the slots before any writes the next point's
            return torch.tensor(batch, dtype=torch.float32, device=s.device)

        return reduce


def _run_blocks(fn, blocks: list, batch_scales: bool) -> list:
    """``[fn(i, *block) for i, block in enumerate(blocks)]``; with ``batch_scales`` each block in a thread of its
    own inside ``quant.batch_scales``, so every activation scale is the batch's."""
    if not batch_scales:
        return [fn(i, *b) for i, b in enumerate(blocks)]
    shared, out, errors = _BatchScale(len(blocks)), [None] * len(blocks), []

    def run(i, b):
        try:
            with quant.batch_scales(shared.reducer(i)):
                out[i] = fn(i, *b)
        except BaseException as e:   # a failed block releases the others from the barrier
            errors.append(e)
            shared.barrier.abort()

    threads = [threading.Thread(target=run, args=(i, b), name=f"dp-block-{i}") for i, b in enumerate(blocks)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise next((e for e in errors if not isinstance(e, threading.BrokenBarrierError)), errors[0])
    return out


def make_dp_fuse(cfg_model: ModelConfig, mesh):
    """Build ``fuse_dp(params, model_state, features) -> (N,) float32`` over ``mesh`` (a list of devices).

    The forward of ``pipeline.fuse`` (bf16 or float32, scores in column 0)
    on each block; ``params``/``model_state`` are trees (copied to every
    device on the call) or :func:`replicate`'s copies, which a server makes
    once per load.  An empty batch gives ``(0,)``; a missing modality raises,
    as in JAX.
    """
    from cvml_goalnet_tpu_torch.pipeline import fuse_on_device

    def fuse_dp(params, model_state, features: dict) -> np.ndarray:
        visual = features["visual"]
        n = len(visual)
        if n == 0:
            return np.zeros((0,), np.float32)
        audio = features.get("audio") if cfg_model.audio_included else None
        text = features.get("text") if cfg_model.text_included else None
        if cfg_model.audio_included and audio is None:
            raise ValueError(
                "cfg.model.audio_included=True but features['audio'] is None "
                "— substitute silent-audio features as serve.Summarizer does")
        if cfg_model.text_included and text is None:
            raise ValueError(
                "cfg.model.text_included=True but features['text'] is None "
                "— tokenize commentary (or [''] rows) first")
        p, s = replicate(params, mesh), replicate(model_state, mesh)
        outs = _run_blocks(lambda i, _, v, a, t: fuse_on_device(p[i], s[i], v, a, t, cfg_model),
                           list(_blocks(mesh, visual, audio, text)), cfg_model.quantized_inference)
        return torch.cat([o.cpu() for o in outs]).numpy()[:n]

    return fuse_dp


def _trunk_dim(cfg_model: ModelConfig, audio: bool) -> int:
    """Width of the trunk's features: visual, audio (when given to an audio trunk) and text."""
    return (cfg_model.vis_feature_dim + (cfg_model.aud_feature_dim if cfg_model.audio_included and audio else 0)
            + (cfg_model.text_feature_dim if cfg_model.text_included else 0))


def make_dp_encode(cfg_model: ModelConfig, mesh):
    """Build ``encode_dp(params, model_state, visual, audio=None, text=None) -> (T, D)`` features on the mesh's
    first device: the Spotter's timeline encode (``spotting.encode_timeline``) split on the frame axis.

    The temporal head runs after it on the first device (its scan and
    attention are cross-frame).  An empty timeline gives ``(0, D)``, where the
    JAX package gives ``(0, 0)`` (ROADMAP.md §3): the head's input width
    does not depend on the timeline's length.
    """
    from cvml_goalnet_tpu_torch.spotting import encode_on_device

    lead = mesh[0]

    def encode_dp(params, model_state, visual, audio=None, text=None) -> torch.Tensor:
        if not cfg_model.audio_included:
            audio = None
        if not cfg_model.text_included:
            text = None
        elif text is None:
            raise ValueError(
                "cfg.model.text_included=True but encode_timeline got no text "
                "tokens — pass the commentary tokens (VideoItem.text / "
                "data.text.tokenize) or use a trunk trained without --commentary")
        if len(visual) == 0:
            return torch.zeros((0, _trunk_dim(cfg_model, audio is not None)), dtype=torch.float32, device=lead)
        t = len(visual)
        p, s = replicate(params, mesh), replicate(model_state, mesh)
        outs = _run_blocks(lambda i, _, v, a, tx: encode_on_device(p[i], s[i], v, a, tx, cfg_model),
                           list(_blocks(mesh, visual, audio, text)), cfg_model.quantized_inference)
        return torch.cat([o.to(lead) for o in outs])[:t]

    return encode_dp
