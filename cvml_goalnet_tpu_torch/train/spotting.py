"""Training the temporal spotting head: on one device, and context parallel over the ranks of a grid.

Port of ``cvml_goalnet_tpu/train/spotting.py``: per-frame event labels over a
timeline, weighted binary cross-entropy, and Adam over the head's tree (GRU,
transformer or hybrid).  Where the JAX step takes
``use_flash``/``flash_interpret``, here the device decides: on the card the
transformer's attention runs the flash kernels forward and backward
(``ops/cuda/flash_attention.py``), on the CPU their plain versions.

The context-parallel steps (JAX ``:135-284``: the sharded, DP×CP and 3-D
steps) run on every rank of a ``parallel.mesh.CpGroups`` grid with the whole
batch on each: a rank takes the logits of its timelines on its shard of
time (``models/temporal_attention.py``'s bodies), and its loss is its share
of the global weighted BCE, its numerator over the global denominator
(summed over the ctx and data axes; padded rows weigh 0).  Its gradients,
which take in what its keys and values gave the other ranks' losses through
the ring's reverse shifts, are summed over the ctx and data axes, and the
model-split slices also over the model axis, so that every rank ends the step
with the global gradient, the monolithic step's.  Clipping, the schedule and
Adam then run on every rank on the same numbers.  The pipeline-parallel step
(JAX's ``parallel/pp.py``) is ``parallel/pp.py::make_pp_spotting_train_step``.
"""

from __future__ import annotations

import os

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from cvml_goalnet_tpu_torch.device import strict_f32
from cvml_goalnet_tpu_torch.models.temporal import temporal_scorer_apply
from cvml_goalnet_tpu_torch.models.temporal_attention import (
    batch_local_logits,
    cp_body,
    padded_length,
    temporal_transformer_apply,
)
from cvml_goalnet_tpu_torch.models.temporal_hybrid import temporal_hybrid_apply
from cvml_goalnet_tpu_torch.parallel.collectives import psum, tree_psum
from cvml_goalnet_tpu_torch.parallel.sharding import partition_leaves, transformer_param_shardings
from cvml_goalnet_tpu_torch.train.optim import (
    adam_init,
    adam_update,
    clip_by_global_norm,
    schedule_lr,
    tree_leaves,
    tree_unflatten,
)
from cvml_goalnet_tpu_torch.weights import _map_with_paths

SCORERS = ("gru", "transformer", "hybrid")


def bce_weights(labels: torch.Tensor, pos_weight: float) -> torch.Tensor:
    """The weight of each label: ``pos_weight`` on the positive class, 1 on the negative, 0 on padding (< 0)."""
    return torch.where(labels > 0.5, torch.full_like(labels, pos_weight), torch.ones_like(labels)) * (labels >= 0)


def weighted_bce_sum(logits: torch.Tensor, labels: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Σ w·BCE(logits, labels): the numerator of :func:`weighted_bce` (padded rows kept finite, w is 0 there)."""
    lab = labels.clamp_min(0.0)
    per = logits.clamp_min(0.0) - logits * lab + torch.log1p(torch.exp(-logits.abs()))
    return torch.sum(w * per)


def weighted_bce(logits: torch.Tensor, labels: torch.Tensor, pos_weight: float) -> torch.Tensor:
    """Weighted binary cross-entropy on logits, the one loss of every spotting step.

    Labels < 0 mark padding and get weight 0; real labels get ``pos_weight``
    on the positive class.  The mean is over the weights.  The parallel steps
    take its numerator on their share of the rows over the whole batch's
    denominator.
    """
    w = bce_weights(labels, pos_weight)
    return weighted_bce_sum(logits, labels, w) / torch.sum(w)


def timeline_lengths(labels: torch.Tensor) -> torch.Tensor:
    """True length of each timeline in a (B, T[, C]) label batch padded with −1 at the tail → (B,) int32."""
    valid = labels >= 0
    if valid.dim() == 3:
        valid = valid.any(dim=-1)
    return valid.sum(dim=1, dtype=torch.int32)


def _lr_at(opt_state, lr: float, lr_schedule):
    """This step's learning rate: ``lr``, or ``schedule_lr(step, lr, *lr_schedule)`` for a
    (schedule, warmup, decay, min_ratio) tuple."""
    return lr if lr_schedule is None else schedule_lr(opt_state.step, lr, *lr_schedule)


def make_spotting_train_step(
    hidden: int,
    lr: float = 1e-3,
    pos_weight: float = 10.0,
    remat: bool = False,
    scorer: str = "gru",
    num_heads: int = 1,
    window: int = 0,
    lr_schedule: "tuple | None" = None,
    grad_clip_norm: float = 0.0,
):
    """→ ``step(params, opt_state, features (T, D), labels (T,) or (T, C)) → (params, opt_state, loss)``.

    ``scorer``: "gru" (bidirectional GRU), "transformer" (full attention for
    ``window == 0``, else the ``|i − j| ≤ window`` band) or "hybrid" (GRU
    states concatenated onto the features, then the transformer; ``hidden``
    is the GRU width).  ``remat=True`` recomputes the scorer's activations in
    the backward (``torch.utils.checkpoint``) instead of keeping them.  The
    logits are reshaped to the labels' layout, so a (T, 1)-labelled run can
    never broadcast to a (T, T) loss.  The parameters, optimiser state,
    features and labels share one device; the step returns new trees.

    The returned ``step`` also carries ``step.value_and_grad(params, features,
    labels) → (loss, grads)``, the loss and gradient tree it descends on.
    """
    if scorer not in SCORERS:
        raise ValueError(f"unknown scorer {scorer!r} — expected one of {SCORERS}")

    def scorer_fn(params, features):
        if scorer == "transformer":
            return temporal_transformer_apply(params, features, num_heads, window)
        if scorer == "hybrid":
            return temporal_hybrid_apply(params, features, hidden, num_heads, window)
        return temporal_scorer_apply(params, features, hidden)

    def value_and_grad(params, features, labels):
        with torch.enable_grad(), strict_f32():  # TF32 off in the backward's products too
            leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
            tracked = tree_unflatten(params, leaves)
            if remat:
                logits = checkpoint(scorer_fn, tracked, features, use_reentrant=False)
            else:
                logits = scorer_fn(tracked, features)
            loss = weighted_bce(logits.reshape(labels.shape), labels, pos_weight)
            grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), tree_unflatten(params, grads)

    def step(params, opt_state, features, labels):
        loss, grads = value_and_grad(params, features, labels)
        params, opt_state = adam_update(clip_by_global_norm(grads, grad_clip_norm), opt_state, params,
                                        _lr_at(opt_state, lr, lr_schedule))
        return params, opt_state, loss

    step.value_and_grad = value_and_grad
    return step


def init_spotting_opt(params):
    return adam_init(params)


def validation_loss(tparams, val_pairs, cfg, pos_weight: float) -> float:
    """The mean over the val timelines ``(video_id, features, labels)`` of the weighted BCE of the single-device
    scores: the objective the steps train (a one-name ``--classes`` head scores (T,) against (T, 1) labels:
    reshaped, never broadcast to (T, T))."""
    from cvml_goalnet_tpu_torch.spotting import score_timeline_auto

    with torch.no_grad():
        return float(np.mean([float(weighted_bce(score_timeline_auto(tparams, f, cfg).reshape(l.shape), l,
                                                 pos_weight)) for _, f, l in val_pairs]))


def validation_map(tparams, val_pairs, cfg, peak_window: int, peak_threshold: float) -> float:
    """The mean over the val timelines of the average-mAP of their peaks (at the window and threshold ``spot``
    deploys with) against the labelled events; classes without any are excluded."""
    from cvml_goalnet_tpu_torch.ops.spotting_metrics import multiclass_average_map
    from cvml_goalnet_tpu_torch.spotting import score_timeline_auto, spot_events_multi

    maps = []
    with torch.no_grad():
        for _, f, l in val_pairs:
            l2 = l.cpu().numpy()
            if l2.ndim == 1:
                l2 = l2[:, None]
            s2 = score_timeline_auto(tparams, f, cfg).cpu().numpy().reshape(l2.shape)
            pred = spot_events_multi(s2, peak_window, peak_threshold)
            gt = [np.nonzero(l2[:, c] > 0.5)[0] for c in range(l2.shape[1])]
            sc = [s2[ev, c] if len(ev) else np.zeros((0,)) for c, ev in enumerate(pred)]
            maps.append(multiclass_average_map(pred, sc, gt)["average_map"])
    return float(np.mean(maps))


def save_spotting_checkpoint(path: str, params, classes=None) -> None:
    """Atomic npz checkpoint of a temporal head, in the JAX package's keys.

    Keys are the jax key paths (``['layers']/[0]/['wq']/['w']``), so both
    ``cvml_goalnet_tpu.train.spotting.load_spotting_checkpoint`` and the
    port's ``weights.load_spotting_checkpoint`` read it.  ``classes`` (event
    names in channel order) is stored as ``__classes__``: a multi-class head's
    channels are positional, and the loaders check the names.
    """
    arrays = {}
    _map_with_paths(lambda key, t: arrays.__setitem__(key, t.detach().cpu().numpy()), params)
    if classes:
        arrays["__classes__"] = np.asarray(list(classes), dtype=np.str_)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)



# ------------------------------------------------------------------ context parallel (JAX :135-284)

def _pad_time(x: torch.Tensor, t_pad: int, value: float) -> torch.Tensor:
    """``x`` (B, T, ...) padded along T to ``t_pad`` with ``value``."""
    pad = t_pad - x.shape[1]
    if pad == 0:
        return x
    return torch.cat([x, x.new_full((x.shape[0], pad) + tuple(x.shape[2:]), value)], dim=1)


def _cp_step(groups, body, pos_weight: float, lr: float, lr_schedule, grad_clip_norm: float, batched: bool):
    """The step of a context-parallel layout: ``body(params, feats_l, t)`` is one timeline's shard."""

    sum_axes = (groups.ctx, groups.data)

    def value_and_grad(params, features, labels):
        if not batched:   # one timeline, valid over its whole length (JAX's static t)
            features, labels, lengths = features[None], labels[None], None
        else:
            lengths = timeline_lengths(labels)
        t_pad = padded_length(features.shape[1], groups.ctx.size)
        bl = features.shape[0] // groups.data.size
        tl = t_pad // groups.ctx.size
        d0, c0 = groups.data.index * bl, groups.ctx.index * tl
        lab = _pad_time(labels, t_pad, -1.0)[d0:d0 + bl, c0:c0 + tl]
        w = bce_weights(lab, pos_weight)
        den = w.sum()
        for axis in sum_axes:
            den = psum(den, axis.group)
        with torch.enable_grad(), strict_f32():
            leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
            logits = batch_local_logits(tree_unflatten(params, leaves), features, groups, body, lengths)
            loss = weighted_bce_sum(logits.reshape(lab.shape), lab, w) / den
            grads = list(torch.autograd.grad(loss, leaves))
        loss = loss.detach()
        for axis in sum_axes:
            loss, grads = tree_psum([loss, grads], axis.group)
        grads = tree_unflatten(params, grads)
        if groups.model.size > 1:   # a split leaf's gradient is nonzero in this rank's slice only
            _, split = partition_leaves(grads, transformer_param_shardings(grads))
            for g, summed in zip(split, tree_psum(split, groups.model.group)):
                g.copy_(summed)
        return loss, grads

    def step(params, opt_state, features, labels):
        loss, grads = value_and_grad(params, features, labels)
        params, opt_state = adam_update(clip_by_global_norm(grads, grad_clip_norm), opt_state, params,
                                        _lr_at(opt_state, lr, lr_schedule))
        return params, opt_state, loss

    step.value_and_grad = value_and_grad
    return step


def make_sharded_spotting_train_step(groups, num_heads: int = 1, lr: float = 1e-3, pos_weight: float = 10.0,
                                     window: int = 0, lr_schedule: "tuple | None" = None,
                                     grad_clip_norm: float = 0.0):
    """The context-parallel step of one timeline → ``step(params, opt_state, features (T, D), labels (T,) or
    (T, C)) → (params, opt_state, global loss)`` on every rank of the ctx axis of ``groups``; ``window > 0``
    takes the halo form.  ``step.value_and_grad`` gives the global loss and gradients alone."""
    return _cp_step(groups, cp_body(groups, num_heads, window), pos_weight, lr, lr_schedule, grad_clip_norm,
                    batched=False)


def make_dp_cp_spotting_train_step(groups, num_heads: int = 1, lr: float = 1e-3, pos_weight: float = 10.0,
                                   window: int = 0, lr_schedule: "tuple | None" = None,
                                   grad_clip_norm: float = 0.0):
    """The data × context parallel step → ``step(params, opt_state, features (B, T, D), labels (B, T[, C]))``:
    timelines over the data axis, time over the ctx axis; a group padded to its longest timeline carries −1
    labels on its pad rows, which weigh nothing and are no attention keys (each timeline's true length comes
    from its labels)."""
    return _cp_step(groups, cp_body(groups, num_heads, window), pos_weight, lr, lr_schedule, grad_clip_norm,
                    batched=True)


def make_3d_spotting_train_step(groups, num_heads: int = 1, lr: float = 1e-3, pos_weight: float = 10.0,
                                window: int = 0, lr_schedule: "tuple | None" = None, grad_clip_norm: float = 0.0):
    """The data × tensor × context parallel step, with :func:`make_dp_cp_spotting_train_step`'s signature and
    padding contract: each block's heads and MLP over the model axis as well."""
    return _cp_step(groups, cp_body(groups, num_heads, window, tp=True), pos_weight, lr, lr_schedule,
                    grad_clip_norm, batched=True)
