"""Optimisers as plain functions over the port's parameter trees.

Port of ``cvml_goalnet_tpu/train/optim.py``.  A tree is the JAX layout the
port keeps (``weights.py``): dicts and lists whose leaves are tensors.  Every
update returns new trees and leaves its inputs as they were, as the JAX
functions do.  Adam is PyTorch's: bias-corrected moments and eps outside the
square root of v̂; ``weight_decay > 0`` decays decoupled (AdamW).  The step
count is a Python int, so a learning-rate schedule is host arithmetic and
costs the card nothing.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


def tree_map(fn, tree, *rest):
    """Map ``fn`` over the leaves of ``tree`` and the same leaves of ``rest``; dicts and lists keep their shape."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of a tree in ``tree_map``'s order."""
    out = []
    tree_map(out.append, tree)
    return out


def tree_unflatten(like, leaves):
    """A tree shaped like ``like`` whose leaves are ``leaves`` (in ``tree_leaves`` order)."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


class AdamState(NamedTuple):
    step: int
    mu: dict
    nu: dict


def adam_init(params) -> AdamState:
    return AdamState(step=0, mu=tree_map(torch.zeros_like, params), nu=tree_map(torch.zeros_like, params))


def adam_update(grads, state: AdamState, params, lr=1e-3, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                weight_decay: float = 0.0):
    """One Adam step → (new_params, new_state).

    ``weight_decay > 0`` is decoupled decay (AdamW, Loshchilov & Hutter):
    ``p −= lr·wd·p`` beside the Adam step, not added to the gradient, so it is
    not rescaled by 1/√v̂.  ``lr`` may be a float or a 0-d tensor.
    """
    step = state.step + 1
    mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state.mu, grads)
    nu = tree_map(lambda v, g: b2 * v + (1 - b2) * g * g, state.nu, grads)
    bc1, bc2 = 1 - b1**step, 1 - b2**step

    def leaf(p, m, v):
        new_p = p - lr * (m / bc1) / (torch.sqrt(v / bc2) + eps)
        if weight_decay:
            new_p = new_p - lr * weight_decay * p
        return new_p

    return tree_map(leaf, params, mu, nu), AdamState(step=step, mu=mu, nu=nu)


def global_norm(tree) -> torch.Tensor:
    """ℓ2 norm over every leaf of a gradient tree, accumulated in float32."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in tree_leaves(tree)))


def clip_by_global_norm(grads, max_norm: float, norm: torch.Tensor | None = None):
    """Scale ``grads`` so their global ℓ2 norm is at most ``max_norm``; ``max_norm <= 0`` disables.

    The scale is ``min(1, max_norm / (norm + 1e-6))``, a tensor on the
    gradients' device: no host sync, and the 1e-6 keeps an all-zero tree finite.
    ``norm`` is the norm to clip by when ``grads`` is one rank's part of a
    larger tree (its pipeline stage, its model slice); default theirs.
    """
    if max_norm <= 0:
        return grads
    scale = torch.clamp(max_norm / ((global_norm(grads) if norm is None else norm) + 1e-6), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads)


def schedule_lr(step, base_lr: float, schedule: str = "constant", warmup_steps: int = 0, decay_steps: int = 0,
                min_ratio: float = 0.0) -> float:
    """Learning rate at optimiser ``step`` (0-indexed).

    * ``"constant"``: ``base_lr`` (after warmup);
    * ``"cosine"``: cosine decay from ``base_lr`` to ``min_ratio·base_lr`` over
      ``decay_steps`` steps after warmup;
    * ``"linear"``: linear decay over the same span.

    ``warmup_steps > 0`` ramps linearly from ``base_lr/warmup_steps`` (never an
    exact-zero first step) to ``base_lr``; ``decay_steps == 0`` means no decay.
    """
    if schedule not in ("constant", "cosine", "linear"):
        raise ValueError(f"unknown lr schedule {schedule!r} (constant | cosine | linear)")
    step = float(step)
    lr = float(base_lr)
    if schedule != "constant" and decay_steps > 0:
        floor = min_ratio * base_lr
        t = min(max((step - warmup_steps) / decay_steps, 0.0), 1.0)
        frac = 0.5 * (1.0 + math.cos(math.pi * t)) if schedule == "cosine" else 1.0 - t
        lr = floor + (base_lr - floor) * frac
    if warmup_steps > 0:
        lr = lr * min((step + 1.0) / warmup_steps, 1.0)
    return lr


def schedule_from_config(tc):
    """``TrainConfig`` → ``step -> lr`` (the schedule's name is checked now)."""
    schedule_lr(0, tc.learning_rate, tc.lr_schedule, tc.lr_warmup_steps, tc.lr_decay_steps, tc.lr_min_ratio)

    def fn(step):
        return schedule_lr(step, tc.learning_rate, tc.lr_schedule, tc.lr_warmup_steps, tc.lr_decay_steps,
                           tc.lr_min_ratio)

    return fn


class SgdState(NamedTuple):
    momentum: dict


def sgd_init(params) -> SgdState:
    return SgdState(momentum=tree_map(torch.zeros_like, params))


def sgd_update(grads, state: SgdState, params, lr: float = 1e-2, momentum: float = 0.9):
    mom = tree_map(lambda m, g: momentum * m + g, state.momentum, grads)
    return tree_map(lambda p, m: p - lr * m, params, mom), SgdState(momentum=mom)
