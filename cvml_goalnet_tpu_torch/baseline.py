"""Random-init chance baseline.

Port of ``cvml_goalnet_tpu/baseline.py`` (reference ``baseline.py:12-135``):
evaluate N freshly initialised models on the train and val sets (the eval
forward, kernels 2–4 on the card, then knapsack F-scores) and report the
mean and the best ("opt") loss and F-scores, the chance-level floor a
trained model must clear.  Sample ``s`` is ``create_train_state(seed + s,
cfg)``: a numpy draw, where the JAX package draws ``PRNGKey(seed + s)``, so
the two packages' samples differ by design (``train/state.py``).
"""

from __future__ import annotations

import numpy as np

from cvml_goalnet_tpu_torch.config import PipelineConfig
from cvml_goalnet_tpu_torch.data.dataset import build_datasets
from cvml_goalnet_tpu_torch.train.loop import _video_fscores, eval_video
from cvml_goalnet_tpu_torch.train.state import create_train_state


def evaluate_random_models(cfg: PipelineConfig, train_ds, val_ds, n_samples: int = 10, seed: int = 0,
                           device=None):
    """Evaluate ``n_samples`` random models on ``device`` (``None``: the card) → per-sample metric lists.

    The items need labels and annotator masks, as for training; an empty val
    set is skipped rather than reported as NaN.
    """
    for ds_name, ds in (("train_ds", train_ds), ("val_ds", val_ds)):
        for item in ds:
            if item.labels is None:
                raise ValueError(f"{ds_name} item {item.video_id!r} has no labels")
            if item.gd_summary_masks is None:
                raise ValueError(
                    f"{ds_name} item {item.video_id!r} has no annotator masks")
    metrics = {k: [] for k in ("train_loss", "train_f_avg", "train_f_max", "val_loss", "val_f_avg", "val_f_max")}
    for s in range(n_samples):
        state = create_train_state(seed + s, cfg, device=device)

        def run(ds):
            losses, favg, fmax = [], [], []
            for item in ds:
                preds, loss = eval_video(state, item, cfg)
                fa, fm = _video_fscores(item, preds, cfg, device)
                losses.append(loss)
                favg.append(fa)
                fmax.append(fm)
            if not losses:
                return None
            return float(np.mean(losses)), float(np.mean(favg)), float(np.mean(fmax))

        tr = run(train_ds)
        vl = run(val_ds)
        for k, v in zip(("train_loss", "train_f_avg", "train_f_max"), tr):
            metrics[k].append(v)
        if vl is not None:
            for k, v in zip(("val_loss", "val_f_avg", "val_f_max"), vl):
                metrics[k].append(v)
    return metrics


def summarize_baseline(metrics: dict) -> dict:
    """Mean and opt aggregation (reference ``baseline.py:131-135``): opt is the least loss, the largest F."""
    out = {}
    for k, vals in metrics.items():
        if not vals:  # e.g. an empty val set: skipped, not reported as NaN
            continue
        out[f"mean_{k}"] = float(np.mean(vals))
        out[f"opt_{k}"] = float(np.min(vals) if "loss" in k else np.max(vals))
    return out


def run_random_baseline(
    cfg: PipelineConfig,
    video_fps,
    annotation_fp,
    mat_fp,
    h5_fp,
    n_samples: int = 10,
    device=None,
) -> dict:
    """Build the datasets on ``device`` (``None``: the card), evaluate ``n_samples`` random models, aggregate."""
    train_ds, val_ds = build_datasets(
        video_fps, cfg, annotation_fp, mat_fp, h5_fp,
        audio_included=cfg.model.audio_included, device=device,
    )
    metrics = evaluate_random_models(cfg, train_ds, val_ds, n_samples, device=device)
    return summarize_baseline(metrics)
