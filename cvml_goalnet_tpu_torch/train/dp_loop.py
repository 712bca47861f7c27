"""Data-parallel training: global batches over the cards of the mesh, one rank per card.

Port of ``cvml_goalnet_tpu/train/dp_loop.py`` (the scaling path beside the
single-device loop of ``train/loop.py``, which keeps the reference's
per-video sub-batches):

* every video's frames, audio, labels and commentary tokens pool into one
  sample set, which every rank holds;
* each step takes the next global batch of the epoch's permutation
  (``np.random.default_rng(cfg.train.seed)``, so the batches are the JAX
  package's own), each rank its contiguous block of it, as ``shard_batch``
  lays a batch over the data axis; the GSPMD step
  (``parallel/dp.py::make_dp_train_step``) applies one Adam update;
* rank 0 evaluates the val set after each epoch with the single-device eval
  (``train/loop.py``'s ``eval_video`` and ``_video_fscores``: kernels 2–4 on
  its card), prints ``[dp epoch N] …`` and alone writes the checkpoints.

One epoch is one pass over the pooled frames in global batches.  The ranks
are processes of their own (``parallel/launch.py``): NCCL between cards,
gloo on the CPU.  A mesh of ``data × model`` entries lays them out as JAX's
``(data, model)`` mesh (``parallel/mesh.py::grid_groups``): the batch splits
over the data axis, and the model axis holds replicas, or with
``tensor_parallel`` each its slice of the fusion MLP (``parallel/dp.py``),
gathered whole for the evaluation and the checkpoints.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cvml_goalnet_tpu_torch.config import PipelineConfig
from cvml_goalnet_tpu_torch.parallel.launch import spawn_ranks
from cvml_goalnet_tpu_torch.parallel.mesh import build_mesh
from cvml_goalnet_tpu_torch.train.optim import AdamState, tree_map
from cvml_goalnet_tpu_torch.train.state import TrainState


def _host(x):
    """A tensor (any device) or array as a numpy array; None stays None."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def pool_dataset(ds) -> dict:
    """Every video's tensors concatenated into one sample pool of numpy arrays."""
    visual = np.concatenate([_host(item.visual) for item in ds])
    labels = np.concatenate([np.asarray(item.labels, np.float32) for item in ds])
    audio = None
    if ds[0].audio is not None:
        audio = np.concatenate([_host(item.audio) for item in ds])
    text = None
    if ds[0].text is not None:
        text = np.concatenate([_host(item.text) for item in ds])
    return {"visual": visual, "audio": audio, "labels": labels, "text": text}


def _host_state(state: TrainState) -> dict:
    opt = state.opt_state
    return {"params": tree_map(_host, state.params), "model_state": tree_map(_host, state.model_state),
            "step": int(opt.step), "mu": tree_map(_host, opt.mu), "nu": tree_map(_host, opt.nu), "epoch": state.epoch}


def _state_on(host: dict, device) -> TrainState:
    def put(tree):
        return tree_map(lambda a: torch.as_tensor(a).to(device), tree)

    return TrainState(put(host["params"]), put(host["model_state"]),
                      AdamState(step=host["step"], mu=put(host["mu"]), nu=put(host["nu"])), host["epoch"])


def _on_host(item):
    """A VideoItem whose tensors are numpy arrays (what a spawned rank is handed)."""
    return dataclasses.replace(item, visual=_host(item.visual), audio=_host(item.audio),
                               text=_host(getattr(item, "text", None)))


def _train_rank(rank: int, world: int, device, job: dict):
    """One rank's whole run → rank 0's final state and history (as host arrays), None elsewhere."""
    from cvml_goalnet_tpu_torch.parallel.dp import make_dp_train_step, rank_generator
    from cvml_goalnet_tpu_torch.parallel.mesh import grid_groups
    from cvml_goalnet_tpu_torch.parallel.sharding import (
        fusion_param_shardings,
        gather_model_shards,
        place_params,
        shard_batch,
    )
    from cvml_goalnet_tpu_torch.train.loop import _video_fscores, eval_video

    cfg, pool, val_items = job["cfg"], job["pool"], job["val"]
    gb, num_epochs, n = job["global_batch"], job["num_epochs"], len(pool["visual"])
    nm, tp = job["n_model"], job["tensor_parallel"]
    grid = grid_groups([("data", world // nm), ("model", nm)])
    data, model = grid["data"], grid["model"]
    host = job["state"]
    model_state = tree_map(lambda a: torch.as_tensor(a).to(device), host["model_state"])
    final_epoch = num_epochs or host["epoch"]
    layout = fusion_param_shardings(host["params"])
    params, mu, nu = (place_params(host[k], model, tp, device) for k in ("params", "mu", "nu"))
    opt_state = AdamState(host["step"], mu, nu)

    def whole(tree):  # the whole tree from every model rank's slice (a collective under tensor parallelism)
        return gather_model_shards(tree, layout, model) if tp else tree

    step_fn = make_dp_train_step(cfg, group=data.group, tensor_parallel=tp, model=model if tp else None)
    generator = rank_generator(cfg.train.seed, data.index, device)
    rng = np.random.default_rng(cfg.train.seed)
    history = {"train_loss": [], "val_loss": [], "val_f_avg": [], "val_f_max": []}

    def block(key, idx, dtype=torch.float32):
        x = pool[key]
        return None if x is None else torch.as_tensor(x[idx]).to(device=device, dtype=dtype)

    def whole_state(epoch):
        opt = AdamState(opt_state.step, whole(opt_state.mu), whole(opt_state.nu))
        return TrainState(whole(params), model_state, opt, epoch)

    steps_per_epoch = max(1, n // gb)
    for epoch in range(num_epochs):
        perm = rng.permutation(n)
        losses = []
        for s in range(steps_per_epoch):
            idx = perm[s * gb:(s + 1) * gb]
            if len(idx) < gb:
                break
            rows = shard_batch(idx, data)
            params, model_state, opt_state, loss = step_fn(
                params, model_state, opt_state, block("visual", rows), block("audio", rows),
                block("labels", rows), generator, text=block("text", rows, torch.int32))
            losses.append(float(loss))
        history["train_loss"].append(float(np.mean(losses)))
        if val_items:
            state = whole_state(epoch + 1)
        if rank != 0:
            continue
        if val_items:   # an empty val set must not np.mean([]) into NaN rows
            val_losses, favg, fmax = [], [], []
            for item in val_items:
                preds, vloss = eval_video(state, item, cfg)
                fa, fm = _video_fscores(item, preds, cfg, device)
                val_losses.append(vloss)
                favg.append(fa)
                fmax.append(fm)
            history["val_loss"].append(float(np.mean(val_losses)))
            history["val_f_avg"].append(float(np.mean(favg)))
            history["val_f_max"].append(float(np.mean(fmax)))
        if job["verbose"]:
            val = (f"val loss {history['val_loss'][-1]:.4f} "
                   f"F-avg {history['val_f_avg'][-1]:.4f}" if val_items else "no val set")
            print(f"[dp epoch {epoch}] train loss {history['train_loss'][-1]:.4f} {val}", flush=True)
    state = whole_state(final_epoch)
    if rank != 0:
        return None
    if job["checkpoint_dir"]:
        from cvml_goalnet_tpu_torch.train.checkpoint import save_checkpoint

        for tag in ("ckp", "opt"):
            save_checkpoint(job["checkpoint_dir"], state, cfg, tag=tag)
    return {"state": _host_state(state), "history": history}


def train_data_parallel(
    cfg: PipelineConfig,
    train_ds,
    val_ds,
    state: TrainState,
    num_epochs: int | None = None,
    global_batch: int | None = None,
    mesh=None,
    tensor_parallel: bool = False,
    verbose: bool = True,
    device=None,
    checkpoint_dir: str | None = None,
):
    """Data-parallel training over ``mesh`` (a device list; default ``parallel.mesh.build_mesh(cfg.mesh,
    device)``) → (final TrainState on the mesh's first device, history dict).

    ``cfg.mesh.model`` is the model axis of the mesh's ``data × model``
    grid; ``tensor_parallel`` splits the fusion MLP over it
    (JAX's ``place_params(tensor_parallel=True)``), else its ranks are
    replicas.  With ``checkpoint_dir`` rank 0 writes the final state there as
    ``ckp`` and ``opt``, as the JAX CLI's ``train --dp`` does after the loop.
    """
    mesh = mesh or build_mesh(cfg.mesh, device)
    n_model = max(1, cfg.mesh.model)
    if len(mesh) % n_model:
        raise ValueError(f"{len(mesh)} devices not divisible by model axis {n_model}")
    n_data = len(mesh) // n_model
    pool = pool_dataset(train_ds)
    n = len(pool["visual"])
    if n < n_data:
        # every step would break before running: the run would train nothing while the history filled with NaN
        raise ValueError(
            f"dataset pools only {n} frames but the data axis spans {n_data} "
            "devices — add videos or shrink the mesh"
        )
    if global_batch is None:
        global_batch = max(n_data, (cfg.train.subbatch_size * n_data))
    global_batch = min(global_batch, (n // n_data) * n_data)
    if global_batch % n_data:
        raise ValueError(f"a global batch of {global_batch} does not split over the {n_data} devices of the data "
                         "axis — give a multiple of the mesh size")
    job = {"cfg": cfg, "pool": pool, "val": [_on_host(item) for item in val_ds], "state": _host_state(state),
           "global_batch": global_batch, "verbose": verbose, "checkpoint_dir": checkpoint_dir,
           "n_model": n_model, "tensor_parallel": tensor_parallel,
           "num_epochs": cfg.train.num_epochs if num_epochs is None else num_epochs}
    result = spawn_ranks(_train_rank, mesh, (job,))[0]
    return _state_on(result["state"], mesh[0]), result["history"]
