"""The two data-parallel train steps: one optimiser step per global batch, every rank on its block of it.

Port of ``cvml_goalnet_tpu/parallel/dp.py``.  Each rank holds the same
replicated parameters and its contiguous block of the global batch, runs the
train forward and backward on its device (plain differentiable PyTorch, as
the single-device loop; JAX computes it outside Pallas) inside
``device.strict_f32``, and the gradients are reduced over the data group
(``parallel/collectives.py``).  Then ``clip_by_global_norm``, the schedule
and one Adam update run on every rank on identical numbers, so the
parameters stay identical.

* :func:`make_dp_train_step` has the GSPMD step's semantics: batchnorm takes
  the statistics of the global batch (each rank all-reduces its per-channel
  sums through an all-reduce autograd passes through), each rank's loss is
  its share of the global mean squared error (its sum over the global batch
  size), and the gradients are summed: the gradient of the global mean loss.
* :func:`make_dp_train_step_shardmap` is the explicit-collectives step:
  batchnorm on each rank's own rows, and the mean over ranks of the
  gradients, the loss and the new batchnorm state.

Each data rank draws its own dropout masks from its own generator (JAX's
GSPMD step draws one mask for the global batch; the distribution is the
same); the ranks of one data index share theirs.

On a multi-slice ``(slice, data, model)`` grid the batch splits over the
flattened (slice × data) product and every sum runs over the data axis
(inside a host), then over the slice axis (across hosts), as JAX's
``grad_reduce_axes`` orders them: ``group`` is then that list of groups.

On a ``(data, model)`` grid the batch splits over the data axis only.
Without ``tensor_parallel`` the model axis holds replicas (JAX's GSPMD step
on a mesh with ``model > 1`` and replicated parameters).  With it
(:func:`make_dp_train_step` with ``model``) each rank holds its slice of the
fusion MLP's Megatron layout (``parallel/sharding.py``) and the fusion runs
tensor parallel (``models/avm.py::fusion_train_apply``): a split leaf's
gradient is the rank's own and is summed over the data axis, a whole leaf's
is the same on every model rank and is summed over the data axis alone, and
clipping takes the global norm of the whole tree (the split leaves' squares
summed over the model axis once).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from cvml_goalnet_tpu_torch.config import PipelineConfig
from cvml_goalnet_tpu_torch.device import strict_f32
from cvml_goalnet_tpu_torch.models.avm import avm_train_apply
from cvml_goalnet_tpu_torch.parallel.collectives import group_size, pmean, psum, tree_psum
from cvml_goalnet_tpu_torch.parallel.sharding import fusion_param_shardings, partition_leaves
from cvml_goalnet_tpu_torch.train.optim import (
    adam_update,
    clip_by_global_norm,
    global_norm,
    schedule_from_config,
    tree_leaves,
    tree_map,
    tree_unflatten,
)


def rank_generator(seed: int, rank: int, device) -> torch.Generator:
    """The dropout generator of data index ``rank``: seeded from (seed, rank), so data ranks draw independent
    masks and the model ranks of one data index the same ones."""
    return torch.Generator(device=device).manual_seed(int(np.random.SeedSequence([seed, rank]).generate_state(1)[0]))


def _check_text(cfg: PipelineConfig, text) -> None:
    if cfg.model.text_included and text is None:
        raise ValueError(
            "cfg.model.text_included=True but the DP step got no text "
            "tokens — pool VideoItem.text into the global batch (what "
            "train_data_parallel does)"
        )


def _loss_and_grads(params, model_state, visual, audio, labels, generator, text, cfg, bn_group, denominator,
                    tp=None):
    """This rank's ``Σ (pred − label)² / denominator``, its new batchnorm state and its gradients."""
    with torch.enable_grad(), strict_f32():   # TF32 off in the backward's convolutions and products too
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        preds, new_ms = avm_train_apply(tree_unflatten(params, leaves), model_state, visual, audio, text,
                                        cfg=cfg.model, generator=generator, bn_group=bn_group, tp=tp)
        d = preds[:, 0] - labels
        loss = torch.sum(d * d) / denominator
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    return loss.detach(), tree_map(torch.Tensor.detach, new_ms), tree_unflatten(params, grads)


def _with_update(cfg: PipelineConfig, loss_and_grads, norm_of=None):
    tc = cfg.train
    lr_fn = schedule_from_config(tc)

    def step(params, model_state, opt_state, visual, audio, labels, generator=None, text=None):
        loss, new_ms, grads = loss_and_grads(params, model_state, visual, audio, labels, generator, text)
        norm = norm_of(grads) if norm_of is not None and tc.grad_clip_norm > 0 else None
        new_params, new_opt = adam_update(clip_by_global_norm(grads, tc.grad_clip_norm, norm), opt_state, params,
                                          lr_fn(opt_state.step), tc.b1, tc.b2, tc.eps, tc.weight_decay)
        return new_params, new_ms, new_opt, loss

    step.loss_and_grads = loss_and_grads
    return step


def _split_norm(model):
    """The global norm of a tree of which this rank holds its slice of the fusion layout over ``model``."""
    def norm_of(grads):
        whole, split = partition_leaves(grads, fusion_param_shardings(grads))
        sq_split = global_norm(split) ** 2 if split else torch.zeros((), device=whole[0].device)
        return torch.sqrt(global_norm(whole) ** 2 + psum(sq_split, model.group))

    return norm_of


def make_dp_train_step(cfg: PipelineConfig, group=None, tensor_parallel: bool = False, model=None):
    """The GSPMD step → ``step(params, model_state, opt_state, visual, audio, labels, generator=None,
    text=None) -> (params, model_state, opt_state, loss)`` on this rank's block of the global batch (every
    rank's block the same size), the loss the global batch's.  ``step.loss_and_grads`` gives the global loss,
    the new state and the reduced gradients alone.  ``group`` is the data group (None: the world), or an
    ordered list of groups whose ranks together hold the global batch: the batchnorm sums, the loss and the
    gradients are reduced over each in turn (a multi-slice grid's ``data`` then ``slice``,
    ``parallel/multislice.py``).

    ``tensor_parallel`` needs ``model``, the rank's model axis (a ``parallel.mesh.Axis``): ``params`` and the
    optimiser state are then the rank's slice of the fusion layout (``parallel.sharding.place_params``)."""
    if tensor_parallel and model is None:
        raise ValueError("tensor_parallel=True needs the rank's model axis (model=parallel.mesh.Axis)")
    tp = model if tensor_parallel else None

    def loss_and_grads(params, model_state, visual, audio, labels, generator=None, text=None):
        _check_text(cfg, text)
        g = group if group is not None else dist.group.WORLD
        global_n = visual.shape[0] * group_size(g)
        loss, new_ms, grads = _loss_and_grads(params, model_state, visual, audio, labels, generator, text, cfg,
                                              g, global_n, tp)
        return psum(loss, g), new_ms, tree_psum(grads, g)

    return _with_update(cfg, loss_and_grads, _split_norm(model) if tensor_parallel else None)


def make_dp_train_step_shardmap(cfg: PipelineConfig, group=None):
    """The explicit-collectives step, with :func:`make_dp_train_step`'s signature: per-rank batchnorm
    statistics, then the mean over ranks of the gradients, the loss and the new batchnorm state."""

    def loss_and_grads(params, model_state, visual, audio, labels, generator=None, text=None):
        _check_text(cfg, text)
        loss, new_ms, grads = _loss_and_grads(params, model_state, visual, audio, labels, generator, text, cfg,
                                              None, visual.shape[0])
        return pmean(loss, group), tree_psum(new_ms, group, mean=True), tree_psum(grads, group, mean=True)

    return _with_update(cfg, loss_and_grads)
