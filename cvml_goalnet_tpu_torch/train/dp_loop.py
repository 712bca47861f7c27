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
gloo on the CPU.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cvml_goalnet_tpu_torch.config import PipelineConfig
from cvml_goalnet_tpu_torch.parallel.launch import spawn_ranks
from cvml_goalnet_tpu_torch.parallel.mesh import TP_NOT_PORTED, build_mesh
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
    from cvml_goalnet_tpu_torch.train.loop import _video_fscores, eval_video

    cfg, pool, val_items = job["cfg"], job["pool"], job["val"]
    gb, num_epochs, n = job["global_batch"], job["num_epochs"], len(pool["visual"])
    b = gb // world
    state = _state_on(job["state"], device)
    params, model_state, opt_state = state.params, state.model_state, state.opt_state
    step_fn = make_dp_train_step(cfg)
    generator = rank_generator(cfg.train.seed, rank, device)
    rng = np.random.default_rng(cfg.train.seed)
    history = {"train_loss": [], "val_loss": [], "val_f_avg": [], "val_f_max": []}

    def block(key, idx, dtype=torch.float32):
        x = pool[key]
        return None if x is None else torch.as_tensor(x[idx]).to(device=device, dtype=dtype)

    steps_per_epoch = max(1, n // gb)
    for epoch in range(num_epochs):
        perm = rng.permutation(n)
        losses = []
        for s in range(steps_per_epoch):
            idx = perm[s * gb:(s + 1) * gb]
            if len(idx) < gb:
                break
            mine = idx[rank * b:(rank + 1) * b]
            params, model_state, opt_state, loss = step_fn(
                params, model_state, opt_state, block("visual", mine), block("audio", mine),
                block("labels", mine), generator, text=block("text", mine, torch.int32))
            losses.append(float(loss))
        state = TrainState(params, model_state, opt_state, epoch + 1)
        history["train_loss"].append(float(np.mean(losses)))
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

    With ``checkpoint_dir`` rank 0 writes the final state there as ``ckp``
    and ``opt``, as the JAX CLI's ``train --dp`` does after the loop.
    """
    if tensor_parallel:
        raise NotImplementedError(TP_NOT_PORTED)
    mesh = mesh or build_mesh(cfg.mesh, device)
    n_data = len(mesh)
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
           "num_epochs": cfg.train.num_epochs if num_epochs is None else num_epochs}
    result = spawn_ranks(_train_rank, mesh, (job,))[0]
    return _state_on(result["state"], mesh[0]), result["history"]
