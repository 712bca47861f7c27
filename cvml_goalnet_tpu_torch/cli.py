"""CLI of the port: ``goalnet-torch {train,eval,baseline,infer}``.

Port of the ``train``, ``eval``, ``baseline`` and ``infer`` verbs of
``cvml_goalnet_tpu/cli.py`` (reference ``main.py:351-373``) with the JAX
parser's flags:

* ``train``: ``build_datasets`` (kernel 1 once a video on the card), then
  ``train/loop.py::train_importance_model`` with the ``opt`` and ``ckp``
  checkpoints under ``<workdir>/models/importance[_no_audio]``, the curves
  and the summary-mask image redrawn under ``<workdir>/tmp`` each epoch, and
  ``<workdir>/tmp/events.jsonl``; ``--checkpoint`` resumes from ``ckp``;
* ``eval``: a trained trunk's loss and F-scores on the train and val splits
  (kernels 2–4 on the card); no trunk, or one of another structure, exits 2;
* ``baseline``: the random-init chance floor over ``--samples`` models;
* ``infer``: offline, decode, ``extract_features`` (kernel 1 and the MFCC
  frontend on the card), ``fuse`` (kernels 2–4), ``summarize``, then the
  selected raw frames exported as ``<workdir>/tmp/<title>.mp4``;
  ``--stream``: chunked decode → ``streaming.score_video_stream`` (decode,
  host work, copies and compute overlapped) → knapsack → one more pass that
  writes only the selected clips, visual-only trunks; ``--host-preprocess``
  / ``--transfer-dtype``: normalise and resize on the host and ship small
  frames (kernel 1 does not run); ``--follow``: VIDEO is a live segment
  directory (``data/follow.py``).

The trunk is the npz checkpoint the JAX package's ``train`` writes (the
same layout both ways, ``train/checkpoint.py``).  Flags for what the port
does not run yet exit 2 before any decode, naming the ROADMAP item that
brings it: the orbax backend and ``--dp`` (item 6), ``--commentary`` and
``--moe-experts`` (item 5).  The JAX CLI's other verbs are later slices.

Runs on the card; ``GOALNET_PLATFORM=cpu`` (the JAX package's variable)
runs the plain PyTorch path on the CPU.  With neither a card nor that
variable it raises.

    python -m cvml_goalnet_tpu_torch.cli train --videos A.npz B.npz --annotation-fp anno.tsv ...
    python -m cvml_goalnet_tpu_torch.cli infer VIDEO [--no-audio] [--stream] ...
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import os
import sys

import numpy as np

from cvml_goalnet_tpu_torch.config import PipelineConfig

ORBAX_NOT_PORTED = (
    "the orbax checkpoint backend is not ported yet (ROADMAP.md §1 item 6, with the multi-GPU "
    "paths); the port reads the npz layout (<tag>_state.npz + <tag>_manifest.json) that "
    "`goalnet train` writes by default"
)
DP_NOT_PORTED = (
    "--dp (mesh data-parallel training, train/dp_loop.py) is not ported yet (ROADMAP.md §1 item 6, with the "
    "multi-GPU paths); the port trains on one device"
)


class CheckpointBackendError(RuntimeError):
    """The checkpoint is in a layout the port does not read."""


def _device():
    """``"cpu"`` when ``GOALNET_PLATFORM=cpu``, else None: the card (raises without one)."""
    return "cpu" if os.environ.get("GOALNET_PLATFORM", "").lower() == "cpu" else None


def _load_cfg(args) -> PipelineConfig:
    cfg = PipelineConfig.load(args.config) if args.config else PipelineConfig()
    if getattr(args, "no_audio", False):
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, audio_included=False))
    if getattr(args, "commentary", False):
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, text_included=True))
    if getattr(args, "moe_experts", None):
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, fusion_moe_experts=args.moe_experts))
    return cfg


def _artifact_paths(root: str, audio_included: bool) -> dict:
    suffix = "" if audio_included else "_no_audio"
    return {
        "ckp_dir": os.path.join(root, "models", f"importance{suffix}"),
        "curves": os.path.join(root, "tmp", f"train_states{suffix}.png"),
        "indices": os.path.join(root, "tmp", f"indices{suffix}.png"),
    }


def _checkpoint_present(ckp_dir: str, tag: str, backend: str) -> bool:
    if backend == "orbax":
        base = os.path.join(ckp_dir, f"{tag}_orbax")
        return os.path.isdir(base) or os.path.isdir(base + ".old")
    return os.path.exists(os.path.join(ckp_dir, f"{tag}_state.npz"))


def _load_tag(ckp_dir: str, state, tag: str, backend: str):
    if backend == "orbax":
        raise CheckpointBackendError(f"checkpoint '{tag}' under {ckp_dir!r} is an orbax checkpoint: {ORBAX_NOT_PORTED}")
    from cvml_goalnet_tpu_torch.train.checkpoint import load_checkpoint

    return load_checkpoint(ckp_dir, state, tag=tag)


def _load_trunk(paths: dict, state, args, tags=("opt", "ckp")):
    """Load the trunk checkpoint, probing the npz layout, then orbax's (which raises
    :class:`CheckpointBackendError`).  Raises ``FileNotFoundError`` when there is none; a checkpoint that
    exists but does not load fails hard (never a random trunk)."""
    from cvml_goalnet_tpu_torch.train.checkpoint import CheckpointMismatchError

    requested = getattr(args, "checkpoint_backend", None)
    backends = [requested] if requested else ["npz", "orbax"]
    for tag in tags:
        for backend in backends:
            if _checkpoint_present(paths["ckp_dir"], tag, backend):
                if tag != tags[0]:
                    print(f"W: no {tags[0]} checkpoint found, falling back to rolling {tag}")
                try:
                    return _load_tag(paths["ckp_dir"], state, tag, backend)
                except FileNotFoundError as e:
                    # the checkpoint exists but a piece (the manifest) is missing: fail hard
                    raise CheckpointMismatchError(
                        f"{backend} checkpoint '{tag}' under {paths['ckp_dir']!r} is incomplete ({e})"
                    ) from e
    raise FileNotFoundError(f"no {'/'.join(tags)} checkpoint (npz or orbax) under {paths['ckp_dir']!r}")


def _add_data_args(p: argparse.ArgumentParser):
    p.add_argument("--data-root", default="./ydata-tvsum50-v1_1")
    p.add_argument("--videos", nargs="*", default=None, help="explicit video paths")
    p.add_argument("--annotation-fp", default=None)
    p.add_argument("--mat-fp", default=None)
    p.add_argument("--h5-fp", default=None)
    p.add_argument("--info-fp", default=None)
    p.add_argument("--config", default=None, help="PipelineConfig JSON path")
    p.add_argument("--workdir", default=".", help="artifact root (tmp/, models/)")


def _resolve_data(args) -> dict:
    root = args.data_root
    return {
        "videos": args.videos or sorted(glob.glob(os.path.join(root, "video", "*.mp4"))),
        "annotation_fp": args.annotation_fp or os.path.join(root, "data", "ydata-tvsum50-anno.tsv"),
        "mat_fp": args.mat_fp or os.path.join(root, "ground_truth", "ydata-tvsum50.mat"),
        "h5_fp": args.h5_fp or os.path.join(root, "ground_truth", "eccv16_dataset_tvsum_google_pool5.h5"),
        "info_fp": args.info_fp or os.path.join(root, "data", "ydata-tvsum50-info.tsv"),
    }


def _unported(args, cfg) -> str | None:
    """Why the port cannot run these flags or this config yet (naming the ROADMAP item), or None."""
    from cvml_goalnet_tpu_torch.models.avm import check_supported

    if getattr(args, "dp", False):
        return DP_NOT_PORTED
    if getattr(args, "checkpoint_backend", None) == "orbax":
        return ORBAX_NOT_PORTED
    try:
        check_supported(cfg.model)
    except NotImplementedError as e:
        return str(e)
    return None


def _refusal(args, cfg) -> str | None:
    """Why these ``infer`` flags cannot run together, before any decode or checkpoint discovery; None when
    they can."""
    if args.follow and not args.stream:
        return ("--follow is a --stream mode (a live segment directory "
                "cannot be summarized offline — the footage isn't finished)")
    if args.stream and (cfg.model.audio_included or cfg.model.text_included):
        return ("infer --stream supports visual-only trunks — audio MFCC "
                "slotting and commentary alignment need the timeline length up "
                "front; run offline infer or use a --no-audio trunk")
    if args.follow and not os.path.isdir(args.video):
        return (f"--follow takes a live segment DIRECTORY and {args.video!r} is not one — "
                "stream a finished file without --follow")
    if args.transfer_dtype and not args.host_preprocess:
        return "--transfer-dtype only applies with --host-preprocess (device preprocess ships raw frames)"
    return _unported(args, cfg)


def _refused(message: str | None) -> bool:
    if message is None:
        return False
    print(f"E: {message}", file=sys.stderr)
    return True


def cmd_train(args) -> int:
    from cvml_goalnet_tpu_torch import viz
    from cvml_goalnet_tpu_torch.data.dataset import build_datasets
    from cvml_goalnet_tpu_torch.pipeline import summarize
    from cvml_goalnet_tpu_torch.train.checkpoint import CheckpointMismatchError, load_checkpoint
    from cvml_goalnet_tpu_torch.train.loop import eval_video, train_importance_model
    from cvml_goalnet_tpu_torch.train.state import create_train_state
    from cvml_goalnet_tpu_torch.utils.metrics import MetricsLogger

    cfg = _load_cfg(args)
    if _refused(_unported(args, cfg)):
        return 2
    data = _resolve_data(args)
    paths = _artifact_paths(args.workdir, cfg.model.audio_included)
    os.makedirs(os.path.dirname(paths["curves"]), exist_ok=True)
    device = _device()

    train_ds, val_ds = build_datasets(
        data["videos"], cfg, data["annotation_fp"], data["mat_fp"], data["h5_fp"],
        data["info_fp"], audio_included=cfg.model.audio_included, device=device,
    )
    print(f"Number of train videos: {len(train_ds)}")
    print(f"Number of val videos: {len(val_ds)}")

    state = create_train_state(cfg.train.seed, cfg, device=device)
    if args.checkpoint:
        try:
            state = load_checkpoint(paths["ckp_dir"], state, tag="ckp")
        except CheckpointMismatchError as e:
            print(f"E: {e}\nE: pass the matching --config/--no-audio combination", file=sys.stderr)
            return 2
        print(f"Resumed from epoch {state.epoch}")

    metrics_logger = MetricsLogger(os.path.join(args.workdir, "tmp", "events.jsonl"))

    def on_epoch_end(epoch, history, best):
        # the curves each epoch (reference visualization.py:5-41), the summary-mask image on each new optimum
        # (main.py:265-280); both need matplotlib, as the JAX package's do
        viz.generate_metric_plots(history, paths["curves"])
        if best["epoch"] == epoch and len(train_ds):
            item = train_ds[len(train_ds) - 1]
            preds, _ = eval_video(best["state"], item, cfg)
            res = summarize(preds, item.clip_intervals, cfg.preprocess.skip_frames, item.full_n_frames,
                            cfg.knapsack, device=device)
            viz.export_indices(res.frame_mask, item.gd_summary_masks, paths["indices"])

    _, history = train_importance_model(
        cfg, train_ds, val_ds, state,
        num_epochs=args.epochs, checkpoint_dir=paths["ckp_dir"],
        on_epoch_end=on_epoch_end, metrics_logger=metrics_logger,
    )
    print(f"Optimal epoch: {history['best_epoch']}")
    print("Operation completed")
    return 0


def cmd_eval(args) -> int:
    """A trained trunk's eval-mode loss and F-scores per split, no training; never a random trunk."""
    from cvml_goalnet_tpu_torch.data.dataset import build_datasets
    from cvml_goalnet_tpu_torch.train.checkpoint import CheckpointMismatchError
    from cvml_goalnet_tpu_torch.train.loop import evaluate_dataset
    from cvml_goalnet_tpu_torch.train.state import create_train_state

    cfg = _load_cfg(args)
    if _refused(_unported(args, cfg)):
        return 2
    data = _resolve_data(args)
    paths = _artifact_paths(args.workdir, cfg.model.audio_included)
    device = _device()

    train_ds, val_ds = build_datasets(
        data["videos"], cfg, data["annotation_fp"], data["mat_fp"], data["h5_fp"],
        data["info_fp"], audio_included=cfg.model.audio_included, device=device,
    )
    state = create_train_state(cfg.train.seed, cfg, device=device)
    try:
        state = _load_trunk(paths, state, args)
    except (FileNotFoundError, CheckpointBackendError) as e:
        print(f"E: {e}", file=sys.stderr)
        return 2
    except CheckpointMismatchError as e:
        print(f"E: {e}\nE: pass the matching --config/--no-audio/--commentary combination", file=sys.stderr)
        return 2

    for name, ds in (("train", train_ds), ("val", val_ds)):
        res = evaluate_dataset(state, ds, cfg)
        if res is None:
            print(f"[eval] {name:5s} - (empty split)")
        else:
            print(f"[eval] {name:5s} - loss: {res[0]:.4f} - F-avg: {res[1]:.4f} - F-max: {res[2]:.4f}")
    print("Operation completed")
    return 0


def cmd_baseline(args) -> int:
    from cvml_goalnet_tpu_torch.baseline import run_random_baseline

    cfg = _load_cfg(args)
    if _refused(_unported(args, cfg)):
        return 2
    data = _resolve_data(args)
    report = run_random_baseline(cfg, data["videos"], data["annotation_fp"], data["mat_fp"], data["h5_fp"],
                                 n_samples=args.samples, device=_device())
    for k, v in report.items():
        print(f"{k}: {v:.4f}")
    return 0


def cmd_infer(args) -> int:
    from cvml_goalnet_tpu_torch.data import video
    from cvml_goalnet_tpu_torch.data.annotations import AnnotationStore
    from cvml_goalnet_tpu_torch.data.dataset import build_video_item
    from cvml_goalnet_tpu_torch.pipeline import fuse, summarize
    from cvml_goalnet_tpu_torch.train.checkpoint import CheckpointMismatchError
    from cvml_goalnet_tpu_torch.train.state import create_train_state

    cfg = _load_cfg(args)
    data = _resolve_data(args)
    paths = _artifact_paths(args.workdir, cfg.model.audio_included)
    store = (AnnotationStore(data["mat_fp"], data["h5_fp"])
             if os.path.exists(data["mat_fp"]) and os.path.exists(data["h5_fp"]) else None)

    print("Input video:\n", args.video)
    if _refused(_refusal(args, cfg)):
        return 2
    device = _device()
    item = None
    if not args.stream:
        item = build_video_item(args.video, cfg, None, store, cfg.model.audio_included, device=device)

    state = create_train_state(cfg.train.seed, cfg, device=device)
    try:
        state = _load_trunk(paths, state, args)
    except CheckpointMismatchError as e:
        print(f"E: {e}\nE: re-train with the current flags or pass the matching "
              "--config/--no-audio/--commentary/--moe-experts combination", file=sys.stderr)
        return 2
    except CheckpointBackendError as e:
        print(f"E: {e}", file=sys.stderr)
        return 2

    if args.stream:
        return _run_infer_stream(args, cfg, state, store, device)

    scores = fuse(state.params, state.model_state, {"visual": item.visual, "audio": item.audio, "text": item.text},
                  cfg, device=device)
    full_frames = (np.load(args.video)["frames"] if args.video.endswith(".npz")
                   else video.decode_all_frames(args.video))
    res = summarize(scores, item.clip_intervals, cfg.preprocess.skip_frames, item.full_n_frames, cfg.knapsack,
                    full_frames=full_frames, device=device)
    if res.summary_frames is None or not len(res.summary_frames):
        print("W: knapsack selected no clips within the budget; nothing to export")
        return 0
    out_fp = os.path.join(args.workdir, "tmp", f"{item.title}.mp4")
    os.makedirs(os.path.dirname(out_fp), exist_ok=True)
    video.export_video(res.summary_frames, out_fp, fps=30)
    print(f"\n[Exported video details]\n\nID: {item.video_id}\nTitle: {item.title}\nOutput: {out_fp}")
    return 0


def _run_infer_stream(args, cfg, state, store, device) -> int:
    """``infer --stream``: bounded memory.  Chunked decode → ``score_video_stream`` → knapsack → a second
    single pass that writes only the selected clips; nothing holds the whole timeline but the (N,) scores.
    With ``--follow`` the chunks come from a live segment directory, scored while the producer writes; the
    knapsack and the export run at the end sentinel."""
    from cvml_goalnet_tpu_torch.data.dataset import uniform_clip_intervals
    from cvml_goalnet_tpu_torch.data.video import export_selected_clips_stream, stream_condensed_frames
    from cvml_goalnet_tpu_torch.pipeline import summarize
    from cvml_goalnet_tpu_torch.streaming import score_video_stream

    counter: dict = {}
    if args.follow:
        from cvml_goalnet_tpu_torch.data.follow import stream_condensed_frames_follow

        chunks = stream_condensed_frames_follow(
            args.video, cfg.preprocess.skip_frames, args.stream_chunk, counter=counter,
            poll_interval=args.follow_poll, timeout=args.follow_timeout, end_sentinel=args.follow_end)
    else:
        chunks = stream_condensed_frames(args.video, cfg.preprocess.skip_frames, args.stream_chunk, counter=counter)
    tdtype = {"float16": np.float16, "uint8": np.uint8}.get(args.transfer_dtype or "")
    scores, stats = score_video_stream(
        state.params, state.model_state, chunks, cfg, chunk_size=args.stream_chunk,
        host_preprocess=args.host_preprocess, transfer_dtype=tdtype, device=device)
    full_n = counter["full_n"]
    video_id = os.path.basename(os.path.normpath(args.video)).rsplit(".", 1)[0]
    intervals = (np.asarray(store.change_points(video_id)) if store is not None
                 else uniform_clip_intervals(cfg, full_n))
    res = summarize(scores, intervals, cfg.preprocess.skip_frames, full_n, cfg.knapsack, device=device)
    print(f"streamed {stats.frames} condensed frames in {stats.chunks} chunks")
    if not len(res.clip_intervals):
        print("W: knapsack selected no clips within the budget; nothing to export")
        return 0
    out_fp = os.path.join(args.workdir, "tmp", f"{video_id}.mp4")
    os.makedirs(os.path.dirname(out_fp), exist_ok=True)
    if args.follow:
        from cvml_goalnet_tpu_torch.data.follow import export_selected_clips_from_segments

        written = export_selected_clips_from_segments(args.video, res.clip_intervals, out_fp,
                                                      end_sentinel=args.follow_end)
    else:
        written = export_selected_clips_stream(args.video, res.clip_intervals, out_fp)
    print(f"\n[Exported video details]\n\nID: {video_id}\nTitle: {video_id}\nOutput: {out_fp}\nFrames: {written}")
    return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="goalnet-torch", description=__doc__.split("\n\n")[0])
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("train", help="train the importance model")
    _add_data_args(p)
    p.add_argument("--no-audio", action="store_true")
    p.add_argument("--commentary", action="store_true",
                   help="enable the text branch (reads <video>.commentary.jsonl sidecars)")
    p.add_argument("--checkpoint", action="store_true", help="resume from rolling ckp")
    p.add_argument("--checkpoint-backend", choices=["npz", "orbax"], default="npz",
                   help="npz (portable default) or orbax (sharded-aware "
                        "save/restore for multi-chip jobs)")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--dp", action="store_true", help="mesh data-parallel training")
    p.add_argument("--global-batch", type=int, default=None)
    p.add_argument("--moe-experts", type=int, default=None,
                   help="swap the first fusion hidden layer for a top-k "
                        "gated mixture of this many experts")
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("eval", help="evaluate a trained checkpoint (no training)")
    _add_data_args(p)
    p.add_argument("--no-audio", action="store_true")
    p.add_argument("--commentary", action="store_true",
                   help="the checkpoint was trained with the text branch")
    p.add_argument("--checkpoint-backend", choices=["npz", "orbax"], default=None,
                   help="pin the checkpoint layout (default: auto-detect)")
    p.set_defaults(fn=cmd_eval)

    p = sub.add_parser("infer", help="summarize one video")
    _add_data_args(p)
    p.add_argument("video")
    p.add_argument("--no-audio", action="store_true")
    p.add_argument("--commentary", action="store_true",
                   help="enable the text branch (reads <video>.commentary.jsonl sidecars)")
    p.add_argument("--checkpoint-backend", choices=["npz", "orbax"], default=None,
                   help="pin the checkpoint layout (default: auto-detect)")
    p.add_argument("--moe-experts", type=int, default=None,
                   help="match a trunk trained with --moe-experts N")
    p.add_argument("--stream", action="store_true",
                   help="bounded-memory summarization: chunked decode → "
                        "streaming device scoring → knapsack → single-pass "
                        "masked export (visual-only trunks)")
    p.add_argument("--stream-chunk", type=int, default=256,
                   help="condensed frames per chunk in --stream mode")
    p.add_argument("--host-preprocess", action="store_true",
                   help="--stream: normalize+resize on the host and ship "
                        "small frames (the right trade on tunnel links)")
    p.add_argument("--transfer-dtype", choices=["float16", "uint8"], default=None,
                   help="--stream + --host-preprocess: quantize the H2D "
                        "transfer (uint8 = 4x less traffic, drift <= 1/510)")
    p.add_argument("--follow", action="store_true",
                   help="--stream: VIDEO is a LIVE segment DIRECTORY still "
                        "being written (data/follow.py protocol) — scores "
                        "stream during the footage; the knapsack + export "
                        "run at the END sentinel")
    p.add_argument("--follow-timeout", type=float, default=60.0,
                   help="--follow: seconds without a new segment or "
                        "sentinel before failing loudly")
    p.add_argument("--follow-poll", type=float, default=0.25,
                   help="--follow: directory poll interval in seconds")
    p.add_argument("--follow-end", default="END",
                   help="--follow: end-of-stream sentinel filename")
    p.set_defaults(fn=cmd_infer)

    p = sub.add_parser("baseline", help="random-init chance baseline")
    _add_data_args(p)
    p.add_argument("--no-audio", action="store_true")
    p.add_argument("--samples", type=int, default=10)
    p.set_defaults(fn=cmd_baseline)
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return args.fn(args)
    except FileNotFoundError as e:
        print(f"E: file not found: {e.filename or e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
