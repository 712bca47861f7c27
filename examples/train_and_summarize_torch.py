"""End-to-end walkthrough with the PyTorch port: synthetic dataset → train → summarize.

The port's counterpart of ``examples/train_and_summarize.py``, with its
config, seeds, step counts and printed lines.  On the CPU (about a minute):

    GOALNET_PLATFORM=cpu python examples/train_and_summarize_torch.py

On the card (the kernels are built by nvcc at first use):

    python examples/train_and_summarize_torch.py

It makes a TVSum-format dataset of two videos (``synthetic_dataset_dir``,
which needs h5py), builds the datasets, trains three epochs with
checkpoints, draws the training curves (matplotlib) and summarizes the
first validation video.  A missing h5py or matplotlib raises the
``ImportError`` that names it.
"""

import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from cvml_goalnet_tpu_torch.config import (  # noqa: E402
    AudioConfig, ModelConfig, PipelineConfig, PreprocessConfig, TrainConfig)
from cvml_goalnet_tpu_torch.data.dataset import build_datasets  # noqa: E402
from cvml_goalnet_tpu_torch.data.synthetic import synthetic_dataset_dir  # noqa: E402
from cvml_goalnet_tpu_torch.device import resolve_device  # noqa: E402
from cvml_goalnet_tpu_torch.pipeline import fuse, summarize  # noqa: E402
from cvml_goalnet_tpu_torch.train.loop import train_importance_model  # noqa: E402
from cvml_goalnet_tpu_torch.train.state import create_train_state  # noqa: E402
from cvml_goalnet_tpu_torch.viz import generate_metric_plots  # noqa: E402

EPOCHS = 3
RAW_FRAMES = 300


def example_config() -> PipelineConfig:
    """The JAX example's tiny config (24×24 frames, VisBl 8/16/16, fusion 32/16, sub-batches of 5)."""
    return PipelineConfig(
        preprocess=PreprocessConfig(frame_size=(24, 24)),
        audio=AudioConfig(n_fft=512, hop_length=128, n_mels=40, n_mfcc=13, bin_length=12),
        model=ModelConfig(vis_channels=(8, 16, 16), vis_feature_dim=32, aud_channels=(8, 16), aud_feature_dim=16,
                          fusion_hidden=(32, 16)),
        train=TrainConfig(num_epochs=EPOCHS, subbatch_size=5),
    )


def main(device=None, state=None, cfg: PipelineConfig | None = None, work: str | None = None) -> dict:
    """The walkthrough on ``device`` (``None``: the card; raises without one).

    ``state``: the initial ``TrainState`` (default ``create_train_state(cfg.train.seed, cfg)``, the port's
    draw); ``cfg``: the config (default :func:`example_config`); ``work``: the working directory (default a
    fresh temporary one).  → the datasets, the history, the best state, the summarized item's scores and its
    ``SummaryResult``, and the working directory.
    """
    device = resolve_device(device)
    cfg = cfg or example_config()
    work = work or tempfile.mkdtemp(prefix="goalnet_example_")
    print(f"workdir: {work}")
    meta = synthetic_dataset_dir(os.path.join(work, "data"), full_n_frames=RAW_FRAMES)

    train_ds, val_ds = build_datasets(
        meta["video_fps"], cfg, meta["annotation_fp"],
        meta["mat_file_path"], meta["h5_file_path"], meta["info_fp"], device=device,
    )
    if state is None:
        state = create_train_state(cfg.train.seed, cfg, device=device)
    best, history = train_importance_model(
        cfg, train_ds, val_ds, state,
        checkpoint_dir=os.path.join(work, "ckpt"), num_epochs=EPOCHS,
    )
    generate_metric_plots(history, os.path.join(work, "curves.png"))

    item = val_ds[0]
    scores = fuse(best.params, best.model_state, {"visual": item.visual, "audio": item.audio}, cfg, device=device)
    res = summarize(scores, item.clip_intervals, cfg.preprocess.skip_frames, item.full_n_frames, cfg.knapsack,
                    device=device)
    print(f"\nsummary: {res.frame_mask.sum()} of {item.full_n_frames} frames "
          f"({100 * res.frame_mask.mean():.1f}%), clips {res.selected_clips}")
    print(f"artifacts in {work}: ckpt/, curves.png")
    return {"train_ds": train_ds, "val_ds": val_ds, "history": history, "best": best, "scores": scores,
            "summary": res, "work": work}


if __name__ == "__main__":
    main("cpu" if os.environ.get("GOALNET_PLATFORM", "").lower() == "cpu" else None)
