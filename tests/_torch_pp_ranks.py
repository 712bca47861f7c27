"""Rank functions for ``tests/test_torch_pp.py`` and ``tests/test_torch_tp_ep.py``, run in processes spawned by
the port's ``parallel.launch.spawn_ranks``.  This module imports the port only (no JAX, no ``cvml_goalnet_tpu``),
as a rank of ``spot-train --pp`` or ``train --dp`` does.

:func:`run_cases` takes a list of cases (plain dicts of numpy arrays, numbers and configs), lays the ranks out
as each case's ``axes`` (``parallel.mesh.grid_groups``), runs every case on every rank in order and returns
rank 0's results, each a dict of numpy arrays and floats; the other ranks return their ``imports`` cases
only."""

from __future__ import annotations

import numpy as np
import torch

from _torch_cp_ranks import _host, _t, forbidden_modules


def _tree(tree, device):
    from cvml_goalnet_tpu_torch import weights

    return weights.tree_from_jax(tree, device=device)


def _pp_apply(case, axes, device):
    from cvml_goalnet_tpu_torch.parallel.pp import pipeline_transformer_apply, stage_params

    pipe = axes["pipe"]
    params = stage_params(_tree(case["params"], device), pipe.index, pipe.size)
    out = pipeline_transformer_apply(params, _t(case["features"], device), pipe, case["heads"],
                                     n_micro=case.get("n_micro", 0), window=case.get("window", 0),
                                     data=axes.get("data"))
    return {"out": out.cpu().numpy()}


def _pp_step(case, axes, device):
    """The PP step's loss and gradients, the whole tree after one step, and the losses of ``steps`` steps."""
    from cvml_goalnet_tpu_torch.parallel.pp import gather_stages, make_pp_spotting_train_step, stage_params
    from cvml_goalnet_tpu_torch.train.optim import adam_init

    pipe = axes["pipe"]
    params = stage_params(_tree(case["params"], device), pipe.index, pipe.size)
    step = make_pp_spotting_train_step(pipe, case["heads"], lr=case.get("lr", 1e-3), n_micro=case.get("n_micro", 0),
                                       window=case.get("window", 0), data=axes.get("data"),
                                       **case.get("opt_kw", {}))
    f, lab = _t(case["features"], device), _t(case["labels"], device)
    loss, grads = step.value_and_grad(params, f, lab)
    opt, losses, p = adam_init(params), [], params
    for _ in range(case.get("steps", 1)):
        p, opt, step_loss = step(p, opt, f, lab)
        losses.append(float(step_loss))
        if len(losses) == 1:
            first = gather_stages([p], pipe)
    return {"loss": float(loss), "grads": _host(gather_stages([grads], pipe)), "params": _host(first),
            "losses": losses, "opt_step": opt.step}


def _tp_forward(case, axes, device):
    """The train forward with the fusion MLP tensor parallel, each data rank on its block; gathered."""
    from cvml_goalnet_tpu_torch.models.avm import avm_train_apply
    from cvml_goalnet_tpu_torch.parallel.collectives import all_gather_cat
    from cvml_goalnet_tpu_torch.parallel.sharding import place_params, shard_batch

    data, model = axes["data"], axes["model"]
    params = place_params(case["params"], model, tensor_parallel=True, device=device)
    state = _tree(case["model_state"], device)
    vis, aud = (_t(shard_batch(case[k], data), device) for k in ("visual", "audio"))
    with torch.no_grad():
        preds, _ = avm_train_apply(params, state, vis, aud, cfg=case["cfg"].model, bn_group=data.group,
                                   tp=model)
    return {"out": all_gather_cat(preds, data).cpu().numpy()}


def _tp_step(case, axes, device):
    """``make_dp_train_step(tensor_parallel=True)`` once on this rank's block: the global loss, the whole
    gradient tree and the whole tree after Adam (gathered from the model ranks' slices)."""
    from cvml_goalnet_tpu_torch.parallel.dp import make_dp_train_step
    from cvml_goalnet_tpu_torch.parallel.sharding import fusion_param_shardings, gather_model_shards
    from cvml_goalnet_tpu_torch.parallel.sharding import place_params, shard_batch
    from cvml_goalnet_tpu_torch.train.optim import adam_init

    data, model = axes["data"], axes["model"]
    params = place_params(case["params"], model, tensor_parallel=True, device=device)
    state = _tree(case["model_state"], device)
    vis, aud, lab = (_t(shard_batch(case[k], data), device) for k in ("visual", "audio", "labels"))
    step = make_dp_train_step(case["cfg"], group=data.group, tensor_parallel=True, model=model)
    loss, _, grads = step.loss_and_grads(params, state, vis, aud, lab)
    p, _, opt, loss2 = step(params, state, adam_init(params), vis, aud, lab)
    layout = fusion_param_shardings(params)
    return {"loss": float(loss), "loss_step": float(loss2), "grads": _host(gather_model_shards(grads, layout, model)),
            "params": _host(gather_model_shards(p, layout, model)), "opt_step": opt.step}


def _ep(case, axes, device):
    """The expert-parallel layer and the gradients of a loss whose share each rank holds (summed over the
    axis)."""
    from cvml_goalnet_tpu_torch.parallel.collectives import tree_psum
    from cvml_goalnet_tpu_torch.parallel.ep import moe_apply_expert_parallel
    from cvml_goalnet_tpu_torch.train.optim import tree_leaves, tree_unflatten

    model = axes["model"]
    params = _tree(case["params"], device)
    x, tgt = _t(case["x"], device), _t(case["tgt"], device)
    with torch.enable_grad():
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        out = moe_apply_expert_parallel(tree_unflatten(params, leaves), x, model, case["top_k"])
        loss = torch.mean((out - tgt) ** 2) / model.size
        grads = torch.autograd.grad(loss, leaves)
    return {"out": out.detach().cpu().numpy(), "grads": _host(tree_psum(tree_unflatten(params, list(grads)),
                                                                        model.group))}


def _imports(case, axes, device):
    import cvml_goalnet_tpu_torch.parallel.ep  # noqa: F401  (the modules a --pp or tensor-parallel rank runs)
    import cvml_goalnet_tpu_torch.parallel.pp  # noqa: F401
    import cvml_goalnet_tpu_torch.train.cp_loop  # noqa: F401
    import cvml_goalnet_tpu_torch.train.dp_loop  # noqa: F401

    return {"forbidden": forbidden_modules()}


KINDS = {"pp_apply": _pp_apply, "pp_step": _pp_step, "tp_forward": _tp_forward, "tp_step": _tp_step, "ep": _ep,
         "imports": _imports}


def run_cases(rank: int, world: int, device, cases: list) -> list:
    from cvml_goalnet_tpu_torch.parallel.mesh import grid_groups

    grids, out = {}, []
    for case in cases:
        axes = tuple(tuple(a) for a in case.get("axes", (("pipe", world),)))
        if axes not in grids:
            grids[axes] = grid_groups(list(axes))
        out.append(KINDS[case["kind"]](case, grids[axes], device))
    if rank == 0:
        return out
    return [r if c["kind"] == "imports" else None for c, r in zip(cases, out)]   # every rank reports its imports
