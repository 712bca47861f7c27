"""Training the temporal spotting head on one device.

Port of the single-device part of ``cvml_goalnet_tpu/train/spotting.py``:
per-frame event labels over a timeline, weighted binary cross-entropy, and
Adam over the head's tree (GRU, transformer or hybrid).  Where the JAX step
takes ``use_flash``/``flash_interpret``, here the device decides: on the card
the transformer's attention runs the flash kernels forward and backward
(``ops/cuda/flash_attention.py``), on the CPU their plain versions.  The
context-parallel, DP×CP, 3-D and pipeline-parallel steps are multi-GPU work
and not ported yet.
"""

from __future__ import annotations

import os

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from cvml_goalnet_tpu_torch.device import strict_f32
from cvml_goalnet_tpu_torch.models.temporal import temporal_scorer_apply
from cvml_goalnet_tpu_torch.models.temporal_attention import temporal_transformer_apply
from cvml_goalnet_tpu_torch.models.temporal_hybrid import temporal_hybrid_apply
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


def weighted_bce(logits: torch.Tensor, labels: torch.Tensor, pos_weight: float) -> torch.Tensor:
    """Weighted binary cross-entropy on logits, the one loss of every spotting step.

    Labels < 0 mark padding and get weight 0; real labels get ``pos_weight``
    on the positive class.  The mean is over the weights.
    """
    w = torch.where(labels > 0.5, torch.full_like(labels, pos_weight), torch.ones_like(labels)) * (labels >= 0)
    lab = labels.clamp_min(0.0)  # keep padded rows finite; w is 0 there
    per = logits.clamp_min(0.0) - logits * lab + torch.log1p(torch.exp(-logits.abs()))
    return torch.sum(w * per) / torch.sum(w)


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

