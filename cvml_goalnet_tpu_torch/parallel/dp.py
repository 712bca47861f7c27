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

Each rank draws its own dropout masks from its own generator (JAX's GSPMD
step draws one mask for the global batch; the distribution is the same).
Tensor parallelism (``tensor_parallel=True``, ``mesh.model > 1``) is not
ported: ROADMAP.md §1 item 6.6.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from cvml_goalnet_tpu_torch.config import PipelineConfig
from cvml_goalnet_tpu_torch.device import strict_f32
from cvml_goalnet_tpu_torch.models.avm import avm_train_apply
from cvml_goalnet_tpu_torch.parallel.collectives import pmean, psum, tree_psum
from cvml_goalnet_tpu_torch.parallel.mesh import TP_NOT_PORTED
from cvml_goalnet_tpu_torch.train.optim import (
    adam_update,
    clip_by_global_norm,
    schedule_from_config,
    tree_leaves,
    tree_map,
    tree_unflatten,
)


def rank_generator(seed: int, rank: int, device) -> torch.Generator:
    """The dropout generator of ``rank``: seeded from (seed, rank), so ranks draw independent masks."""
    return torch.Generator(device=device).manual_seed(int(np.random.SeedSequence([seed, rank]).generate_state(1)[0]))


def _check(cfg: PipelineConfig, tensor_parallel: bool = False) -> None:
    if tensor_parallel or cfg.mesh.model > 1:
        raise NotImplementedError(TP_NOT_PORTED)


def _check_text(cfg: PipelineConfig, text) -> None:
    if cfg.model.text_included and text is None:
        raise ValueError(
            "cfg.model.text_included=True but the DP step got no text "
            "tokens — pool VideoItem.text into the global batch (what "
            "train_data_parallel does)"
        )


def _loss_and_grads(params, model_state, visual, audio, labels, generator, text, cfg, bn_group, denominator):
    """This rank's ``Σ (pred − label)² / denominator``, its new batchnorm state and its gradients."""
    with torch.enable_grad(), strict_f32():   # TF32 off in the backward's convolutions and products too
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        preds, new_ms = avm_train_apply(tree_unflatten(params, leaves), model_state, visual, audio, text,
                                        cfg=cfg.model, generator=generator, bn_group=bn_group)
        d = preds[:, 0] - labels
        loss = torch.sum(d * d) / denominator
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    return loss.detach(), tree_map(torch.Tensor.detach, new_ms), tree_unflatten(params, grads)


def _with_update(cfg: PipelineConfig, loss_and_grads):
    tc = cfg.train
    lr_fn = schedule_from_config(tc)

    def step(params, model_state, opt_state, visual, audio, labels, generator=None, text=None):
        loss, new_ms, grads = loss_and_grads(params, model_state, visual, audio, labels, generator, text)
        new_params, new_opt = adam_update(clip_by_global_norm(grads, tc.grad_clip_norm), opt_state, params,
                                          lr_fn(opt_state.step), tc.b1, tc.b2, tc.eps, tc.weight_decay)
        return new_params, new_ms, new_opt, loss

    step.loss_and_grads = loss_and_grads
    return step


def make_dp_train_step(cfg: PipelineConfig, group=None, tensor_parallel: bool = False):
    """The GSPMD step → ``step(params, model_state, opt_state, visual, audio, labels, generator=None,
    text=None) -> (params, model_state, opt_state, loss)`` on this rank's block of the global batch (every
    rank's block the same size), the loss the global batch's.  ``step.loss_and_grads`` gives the global loss,
    the new state and the reduced gradients alone.  ``group`` is the data group (None: the world)."""
    _check(cfg, tensor_parallel)

    def loss_and_grads(params, model_state, visual, audio, labels, generator=None, text=None):
        _check_text(cfg, text)
        g = group if group is not None else dist.group.WORLD
        global_n = visual.shape[0] * dist.get_world_size(g)
        loss, new_ms, grads = _loss_and_grads(params, model_state, visual, audio, labels, generator, text, cfg,
                                              g, global_n)
        return psum(loss, g), new_ms, tree_psum(grads, g)

    return _with_update(cfg, loss_and_grads)


def make_dp_train_step_shardmap(cfg: PipelineConfig, group=None):
    """The explicit-collectives step, with :func:`make_dp_train_step`'s signature: per-rank batchnorm
    statistics, then the mean over ranks of the gradients, the loss and the new batchnorm state."""
    _check(cfg)

    def loss_and_grads(params, model_state, visual, audio, labels, generator=None, text=None):
        _check_text(cfg, text)
        loss, new_ms, grads = _loss_and_grads(params, model_state, visual, audio, labels, generator, text, cfg,
                                              None, visual.shape[0])
        return pmean(loss, group), tree_psum(new_ms, group, mean=True), tree_psum(grads, group, mean=True)

    return _with_update(cfg, loss_and_grads)
