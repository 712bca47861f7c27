"""Context- and pipeline-parallel training of the spotting head: the ranks of ``spot-train --cp`` and ``--pp``.

Port of the ``--cp`` and ``--pp`` branches of ``cvml_goalnet_tpu/cli.py:943-1150``.  The
lead has encoded each timeline once (kernels 1–3 on the card);
:func:`train_spotting_cp` then spawns one rank per mesh entry, once for the
whole run (``parallel/launch.py``: NCCL on the cards, gloo on the CPU), laid
out as the ``ndp × ntp × nctx`` grid of ``parallel/mesh.py::cp_groups``.
Every rank holds every timeline and runs the step of its layout
(``train/spotting.py``): ``make_sharded_spotting_train_step`` over the ctx
axis alone, ``make_dp_cp_spotting_train_step`` with ``--dp-timelines N``,
``make_3d_spotting_train_step`` with ``--tp N``.  The batched layouts take
groups of N timelines padded to their longest (labels −1 on the pad) and
filled with all-pad dummy timelines (:func:`group_timelines`, JAX
``:1054-1080``).  With ``npp > 1`` the ranks are the ``pipe`` axis of a
GPipe pipeline instead (``parallel/pp.py``): each holds its stage's layers and
steps on one batch of every timeline; the stages are gathered back into the
whole head, in layer order, for the validation and the save.  Rank 0 runs
the per-epoch validation on its own device (val loss, val mAP, best head,
early stop, which it hands to the others) and saves the head.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from cvml_goalnet_tpu_torch.parallel.launch import spawn_ranks
from cvml_goalnet_tpu_torch.train.optim import tree_map


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def group_timelines(pairs, n: int) -> list[tuple[np.ndarray, np.ndarray]]:
    """``(video_id, features (T, D), labels (T[, C]))`` in groups of ``n`` → ``(features (n, Tmax, D), labels (n,
    Tmax[, C]))`` each: padded to the group's longest timeline with zero features and −1 labels, a short last
    group filled with all-pad dummy timelines."""
    groups = []
    for i in range(0, len(pairs), n):
        chunk = pairs[i:i + n]
        tmax = max(int(f.shape[0]) for _, f, _ in chunk)
        fs, ls = [], []
        for _, f, lab in chunk:
            f, lab = _host(f), _host(lab)
            pad = tmax - f.shape[0]
            fs.append(np.pad(f, ((0, pad), (0, 0))))
            ls.append(np.pad(lab, ((0, pad),) + ((0, 0),) * (lab.ndim - 1), constant_values=-1.0))
        while len(fs) < n:
            fs.append(np.zeros_like(fs[0]))
            ls.append(np.full_like(ls[0], -1.0))
        groups.append((np.stack(fs), np.stack(ls)))
    return groups


def _step_of(groups, layout: dict):
    from cvml_goalnet_tpu_torch.train import spotting as TS

    kw = {"num_heads": layout["num_heads"], "lr": layout["lr"], "pos_weight": layout["pos_weight"],
          "window": layout["window"], **layout["opt_kw"]}
    if layout["npp"] > 1:
        from cvml_goalnet_tpu_torch.parallel.pp import make_pp_spotting_train_step

        return make_pp_spotting_train_step(groups["pipe"], n_micro=layout["n_micro"], **kw)
    if groups.model.size > 1:
        return TS.make_3d_spotting_train_step(groups, **kw)
    if layout["batched"]:
        return TS.make_dp_cp_spotting_train_step(groups, **kw)
    return TS.make_sharded_spotting_train_step(groups, **kw)


def _layout_groups(layout: dict, world: int):
    """This rank's axes → (the groups its step takes, its part of the whole head, the whole head from every
    rank's part: a collective under PP, so every rank calls it)."""
    from cvml_goalnet_tpu_torch.parallel.mesh import cp_groups, grid_groups
    from cvml_goalnet_tpu_torch.parallel.pp import gather_stages, stage_params

    if layout["npp"] > 1:
        groups = grid_groups([("pipe", world)])
        pipe = groups["pipe"]
        return groups, (lambda p: stage_params(p, pipe.index, pipe.size)), (lambda p: gather_stages([p], pipe))
    groups = cp_groups(layout["ndp"], layout["ntp"], world // (layout["ndp"] * layout["ntp"]))
    return groups, (lambda p: p), (lambda p: p)


def _cp_rank(rank: int, world: int, device, job: dict):
    """One rank's whole run → rank 0's per-epoch and per-step losses, best epoch and best val loss; None
    elsewhere."""
    from cvml_goalnet_tpu_torch.train.spotting import (
        init_spotting_opt,
        save_spotting_checkpoint,
        validation_loss,
        validation_map,
    )

    cfg, layout = job["cfg"], job["layout"]
    groups, part, whole = _layout_groups(layout, world)
    step = _step_of(groups, layout)

    def on_device(x):
        return torch.as_tensor(x).to(device)

    batches = [(on_device(f), on_device(lab)) for f, lab in job["batches"]]
    val_pairs = [(vid, on_device(f), on_device(lab)) for vid, f, lab in job["val"]] if rank == 0 else []
    start = tree_map(on_device, job["tparams"])
    tparams = part(start)
    opt = init_spotting_opt(tparams)
    best = {"val": float("inf"), "params": start, "epoch": -1}
    epoch_losses, step_losses = [], []
    for epoch in range(job["epochs"]):
        losses = []
        for f, lab in batches:
            tparams, opt, loss = step(tparams, opt, f, lab)
            losses.append(float(loss))
        step_losses.append(losses)
        epoch_losses.append(float(np.mean(losses)))
        stop = False
        full = whole(tparams) if job["val"] else None
        if rank == 0:
            if job["val"]:
                vloss = validation_loss(full, val_pairs, cfg, layout["pos_weight"])
                vmap = validation_map(full, val_pairs, cfg, job["peak_window"], job["peak_threshold"])
                print(f"epoch {epoch}: loss {epoch_losses[-1]:.4f} val-loss {vloss:.4f} val-mAP {vmap:.4f}",
                      flush=True)
                if vloss < best["val"]:
                    best = {"val": vloss, "params": full, "epoch": epoch}
                elif job["early_stop"] and epoch - best["epoch"] >= job["early_stop"]:
                    print(f"Early stop: no val-loss improvement in {job['early_stop']} epochs (best epoch "
                          f"{best['epoch']}).", flush=True)
                    stop = True
            else:
                print(f"epoch {epoch}: loss {epoch_losses[-1]:.4f}", flush=True)
        if job["val"] and job["early_stop"]:
            flag = [stop]
            dist.broadcast_object_list(flag, src=0)
            stop = flag[0]
        if stop:
            break
    final = whole(tparams)
    if rank != 0:
        return None
    if job["val"]:
        final = best["params"]   # held-out selection: the best-val head, not the last
        print(f"best val-loss {best['val']:.4f} at epoch {best['epoch']}", flush=True)
    save_spotting_checkpoint(job["out"], final, classes=job["classes"])
    return {"epoch_losses": epoch_losses, "step_losses": step_losses, "best_epoch": best["epoch"],
            "best_val": best["val"]}


def train_spotting_cp(cfg, pairs, val_pairs, tparams, mesh, *, ndp: int, ntp: int, lr: float, pos_weight: float,
                      epochs: int, out: str, classes=None, early_stop: int = 0, peak_window: int = 5,
                      peak_threshold: float = 0.0, opt_kw: dict | None = None, npp: int = 1,
                      n_micro: int = 0) -> dict:
    """Train the transformer head context parallel over ``mesh`` (a device list, one rank each; ``ndp·ntp``
    divides its length), or with ``npp > 1`` pipeline parallel over its ``npp`` entries in ``n_micro``
    microbatches, from ``tparams``; rank 0 saves the head to ``out`` → rank 0's record (per-epoch and per-step
    global losses, best epoch and val loss)."""
    mc = cfg.model
    batched = ndp > 1 or ntp > 1 or npp > 1
    batches = (group_timelines(pairs, len(pairs) if npp > 1 else ndp) if batched
               else [(_host(f), _host(lab)) for _, f, lab in pairs])
    layout = {"ndp": ndp, "ntp": ntp, "npp": npp, "n_micro": n_micro, "batched": batched,
              "num_heads": mc.temporal_num_heads, "window": mc.temporal_window, "lr": lr, "pos_weight": pos_weight,
              "opt_kw": opt_kw or {}}
    job = {"cfg": cfg, "layout": layout, "batches": batches, "tparams": tree_map(_host, tparams),
           "val": [(vid, _host(f), _host(lab)) for vid, f, lab in val_pairs], "epochs": epochs, "out": out,
           "classes": classes, "early_stop": early_stop, "peak_window": peak_window, "peak_threshold": peak_threshold}
    return spawn_ranks(_cp_rank, mesh, (job,))[0]
