"""Training-curve plots and the summary-mask image.

Port of ``cvml_goalnet_tpu/viz.py`` (reference ``visualization.py:5-41``,
``generate_metric_plots``: the two-panel loss / F-score figure redrawn each
epoch; ``export_indices``, ``utils.py:582-585``: annotator masks above the
prediction).  Host only; matplotlib is imported at the first call, on the
headless Agg backend.
"""

from __future__ import annotations

import numpy as np


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def generate_metric_plots(history: dict, out_fp: str, opt_val_loss: float | None = None) -> None:
    """2-panel figure: losses (left), the four F-score curves (right)."""
    plt = _plt()
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(12, 4.5))
    epochs = np.arange(len(history["train_loss"])) - 1  # epoch -1 = initial eval

    ax1.plot(epochs, history["train_loss"], label="train loss")
    if history.get("val_loss"):
        # empty-val-set runs (one-video datasets) record no val history —
        # plotting an empty series against E+1 epochs would crash the
        # training run at the end of epoch 0
        ax1.plot(epochs, history["val_loss"], label="val loss")
    if opt_val_loss is not None:
        ax1.axhline(opt_val_loss, ls="--", lw=0.8, color="gray", label="opt val loss")
    ax1.set_xlabel("epoch")
    ax1.set_ylabel("MSE loss")
    ax1.legend()
    ax1.set_title("Loss")

    ax2.plot(epochs, history["train_f_avg"], label="train F avg")
    ax2.plot(epochs, history["train_f_max"], label="train F max")
    if history.get("val_f_avg"):
        ax2.plot(epochs, history["val_f_avg"], label="val F avg")
        ax2.plot(epochs, history["val_f_max"], label="val F max")
    ax2.set_xlabel("epoch")
    ax2.set_ylabel("F-score")
    ax2.legend()
    ax2.set_title("F-scores vs annotators")

    fig.tight_layout()
    fig.savefig(out_fp, dpi=110)
    plt.close(fig)


def export_indices(pred_mask: np.ndarray, gd_masks: np.ndarray, out_fp: str) -> None:
    """Annotator masks stacked above the prediction row (``utils.py:582-585``)."""
    plt = _plt()
    stack = np.concatenate([gd_masks, pred_mask[None, :]], axis=0)
    fig, ax = plt.subplots(figsize=(12, 3))
    ax.imshow(stack, aspect=150, interpolation="nearest")
    ax.set_ylabel("annotators | prediction")
    fig.tight_layout()
    fig.savefig(out_fp, dpi=110)
    plt.close(fig)
