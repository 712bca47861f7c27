"""Pipeline parallelism (the GPipe schedule) for the temporal transformer scorer.

Port of ``cvml_goalnet_tpu/parallel/pp.py``.  The transformer's blocks split
into S stages of consecutive layers, one a rank on the ``pipe`` axis of the
rank grid (:func:`stack_pipeline_stages`; a rank holds its stage's layers and
the shared ``proj_in``, ``pos`` and ``head``: :func:`stage_params`).  A batch
of B timelines splits into M microbatches that drain through the stages in
M + S − 1 ticks: at each tick every rank posts one ``ring_shift`` of its last
output one stage down the pipe (``parallel/collectives.py``), stage 0 reads
microbatch t instead, and microbatch m leaves the last stage at tick
m + S − 1.  Each stage's blocks are ``models/temporal_attention.py``'s
``_block_apply`` on the whole microbatch (the flash kernels 5 and 6, or 7 and
8 banded, on the card).

The schedule is JAX's, with one difference that changes no number: a stage
computes only at its M busy ticks (stage s at ticks s … s + M − 1) and passes
what it received on at the others, whose values JAX computes and masks out.
Every rank still posts the same shift at every tick, and autograd runs the
reverse shifts in reverse tick order on every rank: the rank's ticks form one
chain through the shifts (stage 0 keeps what it received in its graph with a
zero gradient), so the backward is the reverse pipeline, as ``jax.grad`` of
JAX's scan derives it.

Gradients are JAX's, the monolithic scorer's.  The cotangent enters at the
last stage's valid outputs only: its head and its share of the loss (its
numerator over the batch's whole denominator); the other stages start their
backward from a zero cotangent.  A shared leaf's gradient is nonzero on the
one stage that uses it (``proj_in`` and ``pos`` on stage 0, ``head`` on the
last) and is summed over the pipe; a stage's layers are its own.  With a
``data`` axis (DP×PP) each pipeline replica drains its 1/n_data of every
microbatch and every gradient is also summed over the data axis.  Clipping
takes the global norm of the whole tree (every stage's layers and the shared
leaves once), so Adam moves every rank's copy of a shared leaf alike.

The step runs on a lock-step view of the pipe axis: a rank's
``parallel.mesh.Axis``, whose shift, sums and gather are collectives, or a
``parallel.mesh.VirtualAxis`` of every stage in one process (the one-card
check of ``chip_smoke.py``), whose combines are arithmetic on a list of
stages.  Both run every line of the tick loop, the reductions, the clipping
norm and the gathering of the stages.
"""

from __future__ import annotations

import torch

from cvml_goalnet_tpu_torch.device import strict_f32
from cvml_goalnet_tpu_torch.models import layers as L
from cvml_goalnet_tpu_torch.models.temporal_attention import _block_apply, head_classes
from cvml_goalnet_tpu_torch.parallel.collectives import tree_psum
from cvml_goalnet_tpu_torch.train.optim import (
    adam_update,
    clip_by_global_norm,
    global_norm,
    tree_leaves,
    tree_unflatten,
)
from cvml_goalnet_tpu_torch.train.spotting import _lr_at, bce_weights, weighted_bce_sum


def stack_pipeline_stages(layer_list, n_stages: int) -> list[list]:
    """The ``n_layers`` block trees in ``n_stages`` stages of consecutive layers → one list of layers a
    stage."""
    n_layers = len(layer_list)
    if n_layers % n_stages:
        raise ValueError(
            f"{n_layers} transformer layers not divisible into {n_stages} "
            "pipeline stages — num_layers must be a multiple of the pipe axis"
        )
    per = n_layers // n_stages
    return [list(layer_list[s * per:(s + 1) * per]) for s in range(n_stages)]


def stage_params(params, stage: int, n_stages: int) -> dict:
    """Stage ``stage``'s tree: the shared leaves and its layers (the same tensors, not copies)."""
    layers = stack_pipeline_stages(params["layers"], n_stages)[stage]
    return {k: layers if k == "layers" else v for k, v in params.items()}


def gather_stages(trees: list, pipe) -> dict:
    """The whole tree, layers in order, from the stage trees of the lanes ``pipe`` holds (on a rank, ``[its
    stage tree]``), the shared leaves the first's: one gather of every stage's layers, no autograd.  On a rank
    it is a collective: every rank of ``pipe`` calls it."""
    like = trees[0]["layers"]
    flats = [torch.cat([t.detach().reshape(-1) for t in tree_leaves(tree["layers"])]) for tree in trees]
    whole, per, layers = pipe.gather(flats, dim=0)[0], flats[0].numel(), []
    for s in range(pipe.size):
        leaves, off = [], s * per
        for t in tree_leaves(like):
            leaves.append(whole[off:off + t.numel()].reshape(t.shape))
            off += t.numel()
        layers += tree_unflatten(like, leaves)
    return {k: layers if k == "layers" else v for k, v in trees[0].items()}


def microbatches(b: int, n_stages: int, n_micro: int = 0, data=None) -> int:
    """The microbatch count of a batch of ``b`` (``n_micro``, 0: ``min(b, n_stages)``), with JAX's checks."""
    m = n_micro or min(b, n_stages)
    if b % m:
        raise ValueError(f"batch {b} not divisible into {m} microbatches")
    if data is not None and (b // m) % data.size:
        raise ValueError(
            f"microbatch size {b // m} must divide over data axis "
            f"'data' ({data.size} devices)"
        )
    return m


def _rows(b: int, m: int, data) -> torch.Tensor:
    """The batch rows a data rank drains, microbatch by microbatch: (M, mb/n_data) indices."""
    mb = b // m
    nd, di = (1, 0) if data is None else (data.size, data.index)
    mbl = mb // nd
    return (torch.arange(m)[:, None] * mb + di * mbl + torch.arange(mbl)[None, :])


def _gpipe(trees: list, features: torch.Tensor, rows: torch.Tensor, pipe, num_heads: int, window: int, init=None):
    """The tick loop over the stages ``pipe`` holds (``trees[i]`` the tree of stage ``pipe.lanes[i]``):
    ``features`` (B, T, D_in), ``rows`` (M, mbl) the batch rows drained → (for each held stage, the M outputs
    (mbl, T, D) of the last stage, None for the others; each held stage's activation after the last tick).

    ``init`` is every stage's activation before tick 0 (zeros); a train step passes one that requires grad
    and asks autograd for its gradient too, so that every rank's shifts, its idle ticks' included, lie on one
    chain the backward walks in reverse tick order on every rank."""
    n, m = pipe.size, rows.shape[0]
    t_len = features.shape[1]
    positions = torch.arange(t_len, device=features.device)
    rotary = "pos" not in trees[0]
    rope_pos = positions if rotary else None
    d = trees[0]["proj_in"]["w"].shape[1]

    def embed(tree, j):   # microbatch j's input to stage 0
        x = L.linear_apply(tree["proj_in"], features[rows[j]])
        return x if rotary else x + tree["pos"][positions % tree["pos"].shape[0]]

    def stage(tree, x):
        for layer in tree["layers"]:
            x = _block_apply(layer, x, num_heads, window, rope_pos)
        return x

    keep = torch.ones((), dtype=torch.bool, device=features.device)
    if init is None:
        init = features.new_zeros((rows.shape[1], t_len, d))
    acts = [init for _ in pipe.lanes]
    outs = [[] if s == n - 1 else None for s in pipe.lanes]
    for t in range(m + n - 1):
        recvs = pipe.shift(acts) if t else acts
        acts = []
        for tree, s, recv, out in zip(trees, pipe.lanes, recvs, outs):
            if not s <= t <= s + m - 1:   # idle: nothing of it reaches a valid output; pass on what came
                acts.append(recv)
                continue
            # stage 0 reads microbatch t, keeping what it received in its graph (its gradient 0) so that its
            # reverse shift runs in step with the others'
            x = torch.where(keep, embed(tree, t - s), recv) if s == 0 else recv
            acts.append(stage(tree, x))
            if out is not None:
                out.append(acts[-1])
    return outs, acts


def _head(tree, ys: list) -> torch.Tensor:
    out = L.linear_apply(tree["head"], torch.stack(ys))   # (M, mbl, T, C)
    return out[..., 0] if head_classes(tree) == 1 else out


def _rows_of(features, pipe, n_micro, data) -> torch.Tensor:
    """The (M, mbl) batch rows this process drains, on the features' device."""
    m = microbatches(features.shape[0], pipe.size, n_micro, data)
    return _rows(features.shape[0], m, data).to(features.device)


def pipeline_transformer_apply(params, features: torch.Tensor, pipe, num_heads: int = 1, n_micro: int = 0,
                               window: int = 0, data=None) -> torch.Tensor:
    """GPipe-scheduled scoring of a batch of timelines (B, T, D_in) → (B, T) or (B, T, C), equal to the
    monolithic scorer on each timeline; no autograd.

    ``pipe`` is a lock-step view of the pipe axis: on a rank its ``parallel.mesh.Axis``, ``params`` its
    :func:`stage_params`; a ``parallel.mesh.VirtualAxis(S)`` runs all S stages in this process on the whole
    ``params``.  Every stage returns the whole result, the last stage's outputs summed over the pipe.
    ``data`` (DP×PP) splits each microbatch over a data axis.  ``n_micro`` 0 takes ``min(B, S)`` microbatches.
    """
    from cvml_goalnet_tpu_torch.parallel.collectives import all_gather_cat

    rows = _rows_of(features, pipe, n_micro, data)
    b, t_len = features.shape[0], features.shape[1]
    trees = pipe.split(params, stage_params)
    with torch.no_grad():
        ys, _ = _gpipe(trees, features, rows, pipe, num_heads, window)
        n_out = head_classes(params)
        shape = tuple(rows.shape) + (t_len,) + (() if n_out == 1 else (n_out,))
        mine = [features.new_zeros(shape) if y is None else _head(tree, y) for tree, y in zip(trees, ys)]
        out = pipe.sum(mine)[0]   # the last stage's, on every stage
        if data is not None:
            out = all_gather_cat(out, data, dim=1)
        return out.reshape(b, t_len, *(() if n_out == 1 else (n_out,)))


def make_pp_spotting_train_step(pipe, num_heads: int = 1, lr: float = 1e-3, pos_weight: float = 10.0,
                                n_micro: int = 0, window: int = 0, data=None, lr_schedule: "tuple | None" = None,
                                grad_clip_norm: float = 0.0):
    """The pipeline-parallel spotting step → ``step(params, opt_state, features (B, T, D), labels (B, T[, C]))
    → (params, opt_state, loss)``: ``train/spotting.make_spotting_train_step``'s weighted BCE over the batch,
    the scorer's forward and backward on the GPipe schedule, then clipping, the schedule and Adam.

    On a rank ``pipe`` is its ``parallel.mesh.Axis`` and ``params`` its :func:`stage_params` (and
    ``opt_state`` Adam's over it); every rank holds the whole batch and returns the global loss.  With a
    ``parallel.mesh.VirtualAxis(S)`` the whole tree goes in and out.  ``step.value_and_grad(params, features,
    labels) → (loss, grads)`` gives the global loss and the reduced gradients alone.  Labels < 0 weigh
    nothing, but attention does not mask pad rows: feed equal-length timelines, as the CLI checks.
    """

    def lane_grads(params, features, labels):
        """→ (the global loss, the reduced gradient tree of each stage ``pipe`` holds)."""
        rows = _rows_of(features, pipe, n_micro, data)
        w_all = bce_weights(labels, pos_weight)
        den = w_all.sum()
        with torch.enable_grad(), strict_f32():
            held = pipe.split(params, stage_params)
            leaves = [[p.detach().requires_grad_() for p in tree_leaves(tree)] for tree in held]
            trees = [tree_unflatten(tree, lv) for tree, lv in zip(held, leaves)]
            d = params["proj_in"]["w"].shape[1]
            init = features.new_zeros((rows.shape[1], features.shape[1], d)).requires_grad_()
            ys, acts = _gpipe(trees, features, rows, pipe, num_heads, window, init)
            lab, w = labels[rows], w_all[rows]
            losses = [den.new_zeros(()) if y is None else weighted_bce_sum(_head(tree, y).reshape(lab.shape), lab, w)
                      / den for tree, y in zip(trees, ys)]
            # the cotangent enters at the last stage's share of the loss; every stage's last activation takes a
            # zero one, so that the reverse shifts of every rank run in step
            heads = [x for x in losses if x.requires_grad]
            flat = [p for lv in leaves for p in lv]
            grads = torch.autograd.grad(heads + acts, [*flat, init],
                                        grad_outputs=[torch.ones_like(x) for x in heads]
                                        + [torch.zeros_like(a) for a in acts], allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(flat, grads)]
        per, off = [], 0
        for tree, lv in zip(held, leaves):
            per.append(tree_unflatten(tree, grads[off:off + len(lv)]))
            off += len(lv)
        # a shared leaf's gradient and the loss are one stage's each: summed over the pipe
        sums = pipe.tree_sum([[x.detach(), {k: v for k, v in g.items() if k != "layers"}] for x, g in zip(losses, per)])
        per = [{k: g["layers"] if k == "layers" else shared[k] for k in g} for g, (_, shared) in zip(per, sums)]
        loss = sums[0][0]
        if data is not None:
            loss, per = tree_psum([loss, per], data.group)
        return loss, per

    def joined(per):   # the caller's tree of gradients
        return pipe.join(per, lambda trees: gather_stages(trees, pipe))

    def whole_norm(per) -> torch.Tensor:   # the shared leaves once, every stage's layers
        shared = [v for k, v in per[0].items() if k != "layers"]
        layers = pipe.sum([global_norm(g["layers"]) ** 2 for g in per])[0]
        return torch.sqrt(global_norm(shared) ** 2 + layers)

    def value_and_grad(params, features, labels):
        loss, per = lane_grads(params, features, labels)
        return loss, joined(per)

    def step(params, opt_state, features, labels):
        loss, per = lane_grads(params, features, labels)
        norm = whole_norm(per) if grad_clip_norm > 0 else None
        params, opt_state = adam_update(clip_by_global_norm(joined(per), grad_clip_norm, norm), opt_state, params,
                                        _lr_at(opt_state, lr, lr_schedule))
        return params, opt_state, loss

    step.value_and_grad = value_and_grad
    return step
