"""Training of the importance model: the per-video sub-batch loop, evaluation and the epoch driver.

Port of ``cvml_goalnet_tpu/train/loop.py`` (reference
``train_importance_model``, ``main.py:26-298``).  A video is cut into
sub-batches of ``subbatch_size`` frames, zero-padded to a whole number of
them with a ``valid`` mask that keeps the padding out of the loss and the
batchnorm statistics; each sub-batch is one forward in train mode, one
``torch.autograd.grad``, clipping and one Adam step (or, with
``grad_accum_steps = K > 1``, one step per K sub-batches and one for the
tail).  JAX runs a video as one ``lax.scan``; here it is a host loop whose
losses and predictions stay on the device until the video ends, so the host
waits for the card once a video.

The forward and the backward run inside one :func:`device.strict_f32`
scope: the backward's convolutions and products run outside the forward's
own scopes, where cuDNN would otherwise take TF32.  Every update is
functional (new trees, nothing written in place), so the ``nan_guard``
rollback can keep the last good state by reference, as JAX does.

Evaluation runs under ``torch.no_grad()`` on the eval forward
(``models/avm.py::avm_apply``), so kernels 2–4 run there; with
``eval_train_mode_compat`` it runs the train forward with batch statistics
and discards the new state, as the reference's forwards without ``.eval()``.

Loss: the masked MSE; ``broadcast_loss_compat`` restores the reference's
``MSELoss((n, 1), (n,))`` broadcast to (n, n) (``main.py:191``); the
classifier (CAVM/CVM) variants use cross-entropy on grade − 1.

The JAX loop seeds a ``PRNGKey`` from ``cfg.train.seed`` and splits it per
video and sub-batch; the port draws every dropout mask from one
``torch.Generator`` on the state's device, seeded from the same number, so
each sub-batch and each video gets fresh masks (not JAX's).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from cvml_goalnet_tpu_torch.config import PipelineConfig
from cvml_goalnet_tpu_torch.device import strict_f32
from cvml_goalnet_tpu_torch.models.avm import avm_apply, avm_train_apply
from cvml_goalnet_tpu_torch.models.moe import moe_load_balance_loss
from cvml_goalnet_tpu_torch.ops.fscore import fscore_against_users_host
from cvml_goalnet_tpu_torch.pipeline import summarize
from cvml_goalnet_tpu_torch.train.optim import (
    adam_update,
    clip_by_global_norm,
    schedule_from_config,
    tree_leaves,
    tree_map,
    tree_unflatten,
)
from cvml_goalnet_tpu_torch.train.state import TrainState
from cvml_goalnet_tpu_torch.utils import compute_dtype, tree_cast
from cvml_goalnet_tpu_torch.utils.logging import log_epoch_header, log_metrics, log_val_delta

def _loss_fn(preds, labels, mask, *, broadcast_compat: bool, classifier: bool) -> torch.Tensor:
    if classifier:
        targets = (labels - 1).to(torch.int64)
        ll = -torch.log_softmax(preds, dim=-1)[torch.arange(preds.shape[0], device=preds.device), targets]
        return torch.sum(ll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    if broadcast_compat:
        # the reference's bug: (n, 1) against (n,) broadcasts to a pairwise (n, n) MSE
        d = preds - labels[None, :]
        m = mask[:, None] * mask[None, :]
        return torch.sum(d * d * m) / torch.clamp(torch.sum(m), min=1.0)
    d = preds[:, 0] - labels
    return torch.sum(d * d * mask) / torch.clamp(torch.sum(mask), min=1.0)


def _outputs(preds: torch.Tensor, classifier: bool) -> torch.Tensor:
    """Per-frame outputs: the score, or the classifier's grade (argmax + 1)."""
    return torch.argmax(preds, dim=1).to(torch.float32) + 1.0 if classifier else preds[:, 0]


def _device_of(state: TrainState) -> torch.device:
    return tree_leaves(state.params)[0].device


def make_train_video_fn(cfg: PipelineConfig, classifier: bool = False):
    """Build the per-video training function.

    ``fn(params, model_state, opt_state, visual (N, h, w, C), audio (N, B, M) | None, labels (N,), valid (N,),
    generator, text (N, text_max_len) | None)``, with N a multiple of ``subbatch_size`` and every tensor on the
    state's device, → ``(params, model_state, opt_state, preds (N,), mean sub-batch loss)``, the last two
    tensors on that device.

    ``fn.value_and_grad(params, model_state, visual, audio, labels, valid, generator, text)`` is one
    sub-batch's ``(loss, preds, new_model_state, grads)``, the step ``fn`` takes.  With MoE (and
    ``fusion_moe_aux_weight > 0``) the loss carries ``aux_weight · moe_load_balance_loss`` of the gate's
    float32 combine weights, as the JAX package's does.

    With ``compute_dtype = "bfloat16"`` it trains in mixed precision as the JAX package does: params, model
    state and inputs are cast to bf16 inside the loss, the forward and backward run in bf16, the loss in
    float32, and the gradients come back to the float32 master params through the casts; the new
    batchnorm statistics are cast back to float32.
    """
    tc, mc = cfg.train, cfg.model
    dt = compute_dtype(tc.compute_dtype)
    S, K = tc.subbatch_size, tc.grad_accum_steps
    lr_fn = schedule_from_config(tc)

    moe = mc.fusion_moe_experts > 0 and mc.fusion_moe_aux_weight > 0

    def value_and_grad(params, model_state, vis, aud, lab, msk, generator, txt=None):
        with torch.enable_grad(), strict_f32():   # TF32 off in the backward's convolutions and products too
            leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
            fwd = avm_train_apply(tree_cast(tree_unflatten(params, leaves), dt), tree_cast(model_state, dt),
                                  vis.to(dt), None if aud is None else aud.to(dt), txt, cfg=mc,
                                  generator=generator, classifier=classifier, valid=msk, return_moe_probs=moe)
            preds, new_ms = fwd[0].to(torch.float32), fwd[1]
            loss = _loss_fn(preds, lab, msk, broadcast_compat=tc.broadcast_loss_compat, classifier=classifier)
            if moe:
                # the Switch-style load-balance penalty keeps the top-k gate from collapsing onto one expert
                loss = loss + mc.fusion_moe_aux_weight * moe_load_balance_loss(fwd[2].to(torch.float32))
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        return (loss.detach(), preds.detach(), tree_cast(tree_map(torch.Tensor.detach, new_ms), torch.float32),
                tree_unflatten(params, grads))

    def apply(grads, opt_state, params, scale: float = 1.0):
        if scale != 1.0:
            grads = tree_map(lambda g: g / scale, grads)
        return adam_update(clip_by_global_norm(grads, tc.grad_clip_norm), opt_state, params,
                           lr_fn(opt_state.step), tc.b1, tc.b2, tc.eps, tc.weight_decay)

    def fn(params, model_state, opt_state, visual, audio, labels, valid, generator, text=None):
        n_sub = visual.shape[0] // S
        outs, losses, gacc = [], [], None
        for idx in range(n_sub):
            sl = slice(idx * S, (idx + 1) * S)
            loss, preds, model_state, grads = value_and_grad(
                params, model_state, visual[sl], None if audio is None else audio[sl], labels[sl], valid[sl],
                generator, None if text is None else text[sl])
            if K <= 1:
                params, opt_state = apply(grads, opt_state, params)
            else:
                # true accumulation: the mean of K sub-batches' gradients, one Adam step per K; the sum is a
                # new tree each time (never added in place), as the rollback keeps old trees by reference
                gacc = grads if gacc is None else tree_map(torch.add, gacc, grads)
                if idx % K == K - 1:
                    params, opt_state = apply(gacc, opt_state, params, K)
                    gacc = None
            outs.append(_outputs(preds, classifier))
            losses.append(loss)
        if K > 1 and gacc is not None:
            # flush the short tail (the reference trains its last short sub-batch rather than drop it)
            params, opt_state = apply(gacc, opt_state, params, n_sub % K)
        return params, model_state, opt_state, torch.cat(outs), torch.stack(losses).mean()

    fn.value_and_grad = value_and_grad
    return fn


def _pad_video(item, S: int, device: torch.device):
    """A video's tensors on ``device``, zero-padded to a multiple of the sub-batch size →
    ``(visual, audio | None, labels, valid, n)``."""
    visual = torch.as_tensor(item.visual, dtype=torch.float32).to(device)
    n = visual.shape[0]
    pad = (-n) % S
    valid = torch.cat([torch.ones(n, device=device), torch.zeros(pad, device=device)])

    def pad_arr(x):
        if x is None:
            return None
        x = torch.as_tensor(x, dtype=torch.float32).to(device)
        return torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))]) if pad else x

    labels = item.labels if item.labels is not None else np.zeros((n,), np.float32)
    return pad_arr(visual), pad_arr(item.audio), pad_arr(np.asarray(labels, np.float32)), valid, n


def _pad_text(item, rows: int, device: torch.device, cfg: PipelineConfig) -> torch.Tensor | None:
    """A video's commentary token ids on ``device``, zero-padded (token 0, padding) to ``rows``; None without
    the text branch."""
    if not cfg.model.text_included or getattr(item, "text", None) is None:
        return None
    text = torch.as_tensor(item.text).to(device=device, dtype=torch.int32)
    return torch.cat([text, text.new_zeros((rows - text.shape[0],) + tuple(text.shape[1:]))])


def eval_video(state: TrainState, item, cfg: PipelineConfig, classifier: bool = False):
    """Eval-mode forward and loss of one whole video (reference ``main.py:93-118``) → ``(preds (n,), loss)``.

    Runs under ``torch.no_grad()``: the eval forward reaches kernels 2–4 on the card.  With
    ``eval_train_mode_compat`` it runs the train forward with batch statistics over the real frames and
    discards the new state.
    """
    tc, mc = cfg.train, cfg.model
    visual, audio, labels, valid, n = _pad_video(item, tc.subbatch_size, _device_of(state))
    audio = audio if mc.audio_included else None
    text = _pad_text(item, len(visual), visual.device, cfg)
    with torch.no_grad():
        if tc.eval_train_mode_compat:
            preds, _ = avm_train_apply(state.params, state.model_state, visual, audio, text, cfg=mc,
                                       classifier=classifier, valid=valid)
        else:
            preds = avm_apply(state.params, state.model_state, visual.contiguous(), audio, text, cfg=mc,
                              classifier=classifier)
        loss = _loss_fn(preds, labels, valid, broadcast_compat=tc.broadcast_loss_compat, classifier=classifier)
        out = _outputs(preds, classifier)
    return out[:n].cpu().numpy(), float(loss)


def _video_fscores(item, preds, cfg: PipelineConfig, device=None):
    """summarize + F-score against the annotators' masks (reference ``utils.py:587-604``)."""
    res = summarize(preds, item.clip_intervals, cfg.preprocess.skip_frames, item.full_n_frames, cfg.knapsack,
                    device=device)
    return fscore_against_users_host(res.frame_mask, item.gd_summary_masks)


def evaluate_dataset(state: TrainState, ds, cfg: PipelineConfig, classifier: bool = False):
    """Eval-mode (loss, F-avg, F-max) means over a dataset, or None when it is empty (the train loop's
    initial and per-epoch evaluations, reference ``main.py:82-146``, and the ``eval`` verb)."""
    if len(ds) == 0:
        return None
    dev = _device_of(state)
    losses, favgs, fmaxs = [], [], []
    for item in ds:
        preds, loss = eval_video(state, item, cfg, classifier)
        fa, fm = _video_fscores(item, preds, cfg, dev)
        losses.append(loss)
        favgs.append(fa)
        fmaxs.append(fm)
    return float(np.mean(losses)), float(np.mean(favgs)), float(np.mean(fmaxs))


def train_importance_model(
    cfg: PipelineConfig,
    train_ds,
    val_ds,
    state: TrainState,
    num_epochs: int | None = None,
    classifier: bool = False,
    checkpoint_dir: str | None = None,
    on_epoch_end=None,
    verbose: bool = True,
    metrics_logger=None,
    async_checkpoint: bool = False,
    preemption_guard=None,
    checkpoint_backend: str = "npz",
):
    """The training driver (reference ``train_importance_model``, ``main.py:26-298``) → ``(best_state, history)``.

    It trains on the device of ``state`` (the items' tensors are moved there).
    Per epoch: train each video, evaluate the val set, keep the best state by
    ``cfg.train.optimum_metric`` (``train_f_avg``, the reference's, or
    ``val_f_avg`` / ``val_loss``), write ``opt`` on a new best and ``ckp``
    every ``checkpoint_every`` epochs, stop after ``early_stop_patience``
    epochs without a new best or when ``preemption_guard`` asks.
    ``nan_guard`` is ``off``, ``raise`` or ``rollback`` (a video with a
    non-finite loss loses its own updates, at most ``nan_guard_limit`` times).
    ``checkpoint_backend`` is ``"npz"`` (the portable default, ``train/checkpoint.py``) or ``"orbax"`` (the
    ``<tag>_orbax/`` layout JAX's orbax backend reads, ``train/orbax_io.py``).
    """
    if checkpoint_backend == "orbax":
        from cvml_goalnet_tpu_torch.train.orbax_io import save_checkpoint_orbax as save_checkpoint
    elif checkpoint_backend == "npz":
        from cvml_goalnet_tpu_torch.train.checkpoint import save_checkpoint
    else:
        raise ValueError(f"unknown checkpoint_backend {checkpoint_backend!r}")

    if async_checkpoint:
        if checkpoint_backend != "npz":
            raise ValueError("async_checkpoint currently supports the npz backend only")
        from cvml_goalnet_tpu_torch.train.checkpoint import AsyncCheckpointer

        _ck = AsyncCheckpointer()
        save_checkpoint = _ck.save  # noqa: F811 — same signature, off-thread

    train_fn = make_train_video_fn(cfg, classifier)
    _lr_of = schedule_from_config(cfg.train)
    num_epochs = cfg.train.num_epochs if num_epochs is None else num_epochs
    dev = _device_of(state)
    generator = torch.Generator(device=dev).manual_seed(cfg.train.seed)

    history: dict[str, list] = {
        "train_loss": [], "train_f_avg": [], "train_f_max": [],
        "val_loss": [], "val_f_avg": [], "val_f_max": [],
    }

    if len(train_ds) == 0:
        raise ValueError("train_ds is empty — nothing to train on")
    metric = cfg.train.optimum_metric
    if metric not in ("train_f_avg", "val_f_avg", "val_loss"):
        raise ValueError(f"unknown optimum_metric {metric!r} (train_f_avg | val_f_avg | val_loss)")
    if metric.startswith("val") and len(val_ds) == 0:
        raise ValueError(
            f"optimum_metric={metric!r} needs a non-empty val split — "
            "this dataset's split left none (train_ratio / video count)")
    guard = cfg.train.nan_guard
    if guard not in ("off", "raise", "rollback"):
        raise ValueError(f"unknown nan_guard {guard!r} (off | raise | rollback)")
    nan_rollbacks = 0

    def policy_value(tr, vl):
        # larger = better (val_loss is negated)
        if metric == "train_f_avg":
            return tr[1]
        return vl[1] if metric == "val_f_avg" else -vl[0]

    for ds_name, ds in (("train_ds", train_ds), ("val_ds", val_ds)):
        for item in ds:
            # fail up front: training toward the zero-label fallback of label-free inference items would
            # learn to predict 0, and a missing mask set would fail mid-eval
            if item.labels is None:
                raise ValueError(
                    f"{ds_name} item {item.video_id!r} has no labels — build "
                    "the dataset with annotation_fp so training has targets"
                )
            if item.gd_summary_masks is None:
                raise ValueError(
                    f"{ds_name} item {item.video_id!r} has no annotator "
                    "ground-truth masks — F-score evaluation needs the "
                    "mat/h5 annotation files"
                )

    def evaluate(ds):
        return evaluate_dataset(state, ds, cfg, classifier)

    def record(tr, vl):
        for k, v in zip(("train_loss", "train_f_avg", "train_f_max"), tr):
            history[k].append(v)
        if vl is not None:
            for k, v in zip(("val_loss", "val_f_avg", "val_f_max"), vl):
                history[k].append(v)

    # the initial (epoch -1) evaluation, reference main.py:82-146
    tr = evaluate(train_ds)
    vl = evaluate(val_ds)
    record(tr, vl)
    if verbose:
        log_metrics("initial", tr, vl)
    if metrics_logger is not None:
        metrics_logger.log_epoch(-1, tr, vl)

    best = {"state": state, "epoch": -1, "value": policy_value(tr, vl), "metrics": (tr, vl)}
    # the lr series aligns with the others (index 0 = initial)
    history["lr"] = [float(_lr_of(state.opt_state.step))]
    if checkpoint_dir:
        # an "opt" checkpoint exists even when no epoch beats the initial eval (the reference wrote opt_*
        # only on improvement, main.py:255-263, leaving inference without a trunk after a flat run)
        save_checkpoint(checkpoint_dir, state, cfg, tag="opt")
    prev_val_loss = vl[0] if vl is not None else None

    for epoch in range(state.epoch, num_epochs):
        t0 = time.time()
        if verbose:
            log_epoch_header(epoch, num_epochs)
        ep_losses, ep_favg, ep_fmax = [], [], []
        params, model_state, opt_state = state.params, state.model_state, state.opt_state
        last_good = (params, model_state, opt_state)  # references: every update makes new trees
        for item in train_ds:
            visual, audio, labels, valid, n = _pad_video(item, cfg.train.subbatch_size, dev)
            audio = audio if cfg.model.audio_included else None
            params, model_state, opt_state, preds, loss = train_fn(
                params, model_state, opt_state, visual, audio, labels, valid, generator,
                _pad_text(item, len(visual), dev, cfg))
            loss_f = float(loss)
            if guard != "off" and not np.isfinite(loss_f):
                # this video's updates (params, batchnorm state, Adam moments) are poisoned
                if guard == "raise" or nan_rollbacks >= cfg.train.nan_guard_limit:
                    raise FloatingPointError(
                        f"non-finite training loss ({loss_f}) on video "
                        f"{item.video_id!r} at epoch {epoch}"
                        + ("" if guard == "raise" else
                           f" after {nan_rollbacks} rollbacks "
                           f"(nan_guard_limit={cfg.train.nan_guard_limit})")
                    )
                nan_rollbacks += 1
                history["nan_rollbacks"] = nan_rollbacks
                params, model_state, opt_state = last_good
                if verbose:
                    print(f"W: non-finite loss on {item.video_id!r}; rolled "
                          f"back its updates ({nan_rollbacks}/"
                          f"{cfg.train.nan_guard_limit})")
                continue  # skip this video's metrics; its updates are gone
            last_good = (params, model_state, opt_state)
            fa, fm = _video_fscores(item, preds.cpu().numpy()[:n], cfg, dev)
            ep_losses.append(loss_f)
            ep_favg.append(fa)
            ep_fmax.append(fm)
        state = TrainState(params, model_state, opt_state, epoch + 1)
        # the lr the next optimiser step will use
        history["lr"].append(float(_lr_of(state.opt_state.step)))

        if not ep_losses:
            raise FloatingPointError(
                f"epoch {epoch}: every training video produced a non-finite "
                "loss (all rolled back) — the data or config is bad, not one "
                "video"
            )
        tr = (float(np.mean(ep_losses)), float(np.mean(ep_favg)), float(np.mean(ep_fmax)))
        vl = evaluate(val_ds)
        record(tr, vl)

        if verbose:
            if vl is not None and prev_val_loss is not None:
                log_val_delta(vl[0], prev_val_loss)
            log_metrics(f"epoch {epoch}", tr, vl, time.time() - t0)
        if metrics_logger is not None:
            metrics_logger.log_epoch(epoch, tr, vl, time.time() - t0)
        if vl is not None:
            prev_val_loss = vl[0]

        if policy_value(tr, vl) > best["value"]:
            best = {"state": state, "epoch": epoch, "value": policy_value(tr, vl), "metrics": (tr, vl)}
            if checkpoint_dir:
                save_checkpoint(checkpoint_dir, state, cfg, tag="opt")
        if checkpoint_dir and (epoch + 1) % cfg.train.checkpoint_every == 0:
            save_checkpoint(checkpoint_dir, state, cfg, tag="ckp")
        if on_epoch_end is not None:
            on_epoch_end(epoch, history, best)
        patience = cfg.train.early_stop_patience
        if patience and epoch - best["epoch"] >= patience:
            # early stop on the metric the best-state policy tracks; the initial eval is the first baseline
            history["early_stopped"] = True
            if verbose:
                print(f"Early stop: no {metric} improvement in "
                      f"{patience} epochs (best epoch {best['epoch']}).")
            break
        if preemption_guard is not None and preemption_guard.requested:
            # graceful preemption: write the rolling state and stop; --checkpoint resumes with Adam intact
            if checkpoint_dir:
                save_checkpoint(checkpoint_dir, state, cfg, tag="ckp")
            history["preempted"] = True
            if verbose:
                print(f"Preemption requested; checkpointed at epoch {epoch} and stopping.")
            break

    if async_checkpoint and checkpoint_dir:
        _ck.wait()  # every queued write durable before returning

    history["best_epoch"] = best["epoch"]
    return best["state"], history
