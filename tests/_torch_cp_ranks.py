"""Rank functions for ``tests/test_torch_context_parallel.py``, run in processes spawned by the port's
``parallel.launch.spawn_ranks``.  This module imports the port only (no JAX, no ``cvml_goalnet_tpu``), as a rank
of ``spot-train --cp`` does.

:func:`run_cases` takes a list of cases (plain dicts of numpy arrays and numbers), runs each on every rank in
order (each case's collectives in one order everywhere) and returns rank 0's results, each a dict of numpy
arrays and floats (the other ranks return their ``imports`` cases only)."""

from __future__ import annotations

import sys

import numpy as np
import torch


def forbidden_modules() -> list[str]:
    return sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.") or m == "cvml_goalnet_tpu"
                  or m.startswith("cvml_goalnet_tpu."))


def _t(x, device, grad: bool = False):
    t = torch.as_tensor(np.ascontiguousarray(x)).to(device)
    return t.requires_grad_() if grad else t


def _host(tree):
    from cvml_goalnet_tpu_torch.train.optim import tree_map

    return tree_map(lambda t: t.detach().cpu().numpy(), tree)


def _shard(x: np.ndarray, ctx, axis: int) -> np.ndarray:
    tl = x.shape[axis] // ctx.size
    return np.take(x, np.arange(ctx.index * tl, (ctx.index + 1) * tl), axis=axis)


def _attention(case, groups, device):
    """Ring or halo attention of the whole (H, T, d) q, k, v split over the ctx axis, and its gradients for the
    cotangent ``g`` → the gathered out, dq, dk, dv."""
    from cvml_goalnet_tpu_torch.parallel.collectives import all_gather_cat
    from cvml_goalnet_tpu_torch.parallel.halo_attention import halo_attention_local
    from cvml_goalnet_tpu_torch.parallel.ring_attention import ring_attention_local

    ctx = groups.ctx
    q, k, v = (_t(_shard(case[n], ctx, 1), device, grad=True) for n in ("q", "k", "v"))
    with torch.enable_grad():
        if case["kind"] == "ring":
            out = ring_attention_local(q, k, v, ctx, case.get("t_valid"))
        else:
            out = halo_attention_local(q, k, v, ctx, case["window"], case.get("t_valid"))
        grads = torch.autograd.grad((out * _t(_shard(case["g"], ctx, 1), device)).sum(), (q, k, v))
    res = {"out": all_gather_cat(out, ctx, dim=1)}
    res.update({n: all_gather_cat(g, ctx, dim=1) for n, g in zip(("dq", "dk", "dv"), grads)})
    return {n: t.cpu().numpy() for n, t in res.items()}


def _apply(case, groups, device):
    from cvml_goalnet_tpu_torch import weights
    from cvml_goalnet_tpu_torch.models import temporal_attention as TA

    params = weights.tree_from_jax(case["params"], device=device)
    f = _t(case["features"], device)
    fn = {"sharded": TA.temporal_transformer_sharded_apply, "tp_cp": TA.temporal_transformer_tp_cp_apply,
          "dp_cp": TA.temporal_transformer_dp_cp_apply, "3d": TA.temporal_transformer_3d_apply}[case["apply"]]
    kw = {"lengths": case["lengths"]} if case["apply"] in ("dp_cp", "3d") else {}
    with torch.no_grad():
        return {"out": fn(params, f, groups, case["heads"], case["window"], **kw).cpu().numpy()}


def _step(case, groups, device):
    from cvml_goalnet_tpu_torch import weights
    from cvml_goalnet_tpu_torch.train import spotting as TS

    params = weights.tree_from_jax(case["params"], device=device)
    make = {"sharded": TS.make_sharded_spotting_train_step, "dp_cp": TS.make_dp_cp_spotting_train_step,
            "3d": TS.make_3d_spotting_train_step}[case["step"]]
    step = make(groups, case["heads"], lr=case.get("lr", 1e-3), pos_weight=case.get("pos_weight", 10.0),
                window=case["window"])
    f, lab = _t(case["features"], device), _t(case["labels"], device)
    loss, grads = step.value_and_grad(params, f, lab)
    new, opt, loss2 = step(params, TS.init_spotting_opt(params), f, lab)
    return {"loss": float(loss), "loss_step": float(loss2), "grads": _host(grads), "params": _host(new),
            "opt_step": opt.step}


def _score(case, groups, device):
    from cvml_goalnet_tpu_torch import weights
    from cvml_goalnet_tpu_torch.spotting import score_timeline_sharded

    params = weights.tree_from_jax(case["params"], device=device)
    with torch.no_grad():
        return {"out": score_timeline_sharded(params, _t(case["features"], device), groups, case["cfg"]).cpu().numpy()}


def _window_error(case, groups, device):
    from cvml_goalnet_tpu_torch.parallel.halo_attention import halo_attention_local

    q = torch.zeros((1, case["tl"], 8))
    try:
        halo_attention_local(q, q, q, groups.ctx, case["window"])
    except ValueError as e:
        return {"error": str(e)}
    return {"error": None}


def _imports(case, groups, device):
    import cvml_goalnet_tpu_torch.train.cp_loop  # noqa: F401  (the modules a spot-train --cp rank runs)
    import cvml_goalnet_tpu_torch.train.spotting  # noqa: F401

    return {"forbidden": forbidden_modules()}


KINDS = {"ring": _attention, "halo": _attention, "apply": _apply, "step": _step, "score": _score,
         "window_error": _window_error, "imports": _imports}


def run_cases(rank: int, world: int, device, cases: list) -> list:
    from cvml_goalnet_tpu_torch.parallel.mesh import cp_groups

    grids, out = {}, []
    for case in cases:
        grid = tuple(case.get("grid", (1, 1, world)))
        if grid not in grids:
            grids[grid] = cp_groups(*grid)
        out.append(KINDS[case["kind"]](case, grids[grid], device))
    if rank == 0:
        return out
    return [r if c["kind"] == "imports" else None for c, r in zip(cases, out)]   # every rank reports its imports
