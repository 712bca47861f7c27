"""Rank functions for ``tests/test_torch_dp.py``, run in processes spawned by the port's
``parallel.launch.spawn_ranks``.  This module imports the port only (no JAX, no ``cvml_goalnet_tpu``), as a
rank of ``train --dp`` does, and every function reports the forbidden modules its process holds."""

from __future__ import annotations

import sys

import torch


def forbidden_modules() -> list[str]:
    return sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.") or m == "cvml_goalnet_tpu"
                  or m.startswith("cvml_goalnet_tpu."))


def report_imports(rank: int, world: int, device) -> dict:
    import cvml_goalnet_tpu_torch.parallel.dp  # noqa: F401  (the modules a training rank runs)
    import cvml_goalnet_tpu_torch.train.dp_loop  # noqa: F401

    return {"rank": rank, "world": world, "device": str(device), "forbidden": forbidden_modules()}


def _host(tree):
    from cvml_goalnet_tpu_torch.train.optim import tree_map

    return tree_map(lambda t: t.detach().cpu().numpy(), tree)


def step_parity(rank: int, world: int, device, job: dict) -> dict:
    """Both data-parallel steps once from the same state on this rank's block of the global batch → the
    reduced loss, gradients, new batchnorm state and parameters after Adam of each."""
    from cvml_goalnet_tpu_torch.parallel.dp import make_dp_train_step, make_dp_train_step_shardmap
    from cvml_goalnet_tpu_torch.train.optim import adam_init, tree_map

    cfg = job["cfg"]
    params = tree_map(lambda a: torch.as_tensor(a).to(device), job["params"])
    model_state = tree_map(lambda a: torch.as_tensor(a).to(device), job["model_state"])
    b = len(job["visual"]) // world
    mine = slice(rank * b, (rank + 1) * b)
    vis, aud, lab = (torch.as_tensor(job[k][mine]).to(device) for k in ("visual", "audio", "labels"))
    out = {"forbidden": forbidden_modules()}
    for name, make in (("gspmd", make_dp_train_step), ("shardmap", make_dp_train_step_shardmap)):
        step = make(cfg)
        loss, new_ms, grads = step.loss_and_grads(params, model_state, vis, aud, lab)
        p, ms, opt, loss2 = step(params, model_state, adam_init(params), vis, aud, lab)
        out[name] = {"loss": float(loss), "loss_step": float(loss2), "grads": _host(grads),
                     "model_state": _host(ms), "params": _host(p), "opt_step": opt.step}
    return out
