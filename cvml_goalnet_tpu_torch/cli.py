"""CLI of the port: ``goalnet-torch {train,eval,baseline,infer,profile,spot,spot-train,serve,import-torch,export-torch}``.

Port of every verb of ``cvml_goalnet_tpu/cli.py`` (reference
``main.py:351-373``) with the JAX parser's flags:

* ``train``: ``build_datasets`` (kernel 1 once a video on the card), then
  ``train/loop.py::train_importance_model`` with the ``opt`` and ``ckp``
  checkpoints under ``<workdir>/models/importance[_no_audio]``, the curves
  and the summary-mask image redrawn under ``<workdir>/tmp`` each epoch, and
  ``<workdir>/tmp/events.jsonl``; ``--checkpoint`` resumes from ``ckp``;
  ``--dp`` (with ``--global-batch``) trains data-parallel instead
  (``train/dp_loop.py``): one spawned rank per card of ``mesh.data`` (-1:
  every visible card; gloo with ``mesh.data`` ranks under
  ``GOALNET_PLATFORM=cpu``), rank 0 evaluating and writing ``ckp`` and ``opt``;
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
  directory (``data/follow.py``);
* ``profile``: the summarize path's stages (decode, audio_load, features,
  score, postprocess) timed over ``--repeats`` passes, each stage ending on
  ``torch.cuda.synchronize()`` on the card; ``--trace-dir`` writes a
  ``torch.profiler`` trace whose regions carry the stage names;
* ``spot``: event spotting over one video with a ``spot-train`` head
  (``--temporal-checkpoint``): the trunk (kernels 1–3), the GRU,
  transformer (kernel 5, or 7 banded) or hybrid head, peaks, and a knapsack
  highlight summary; ``--classes`` per class; ``--eval-events`` against the
  ``.events.json`` sidecar; ``--stream`` emits each event as a jsonl line the
  moment it is final, ``--follow`` over a live segment directory;
* ``spot-train``: trains the temporal head on ``.events.json`` labels on one
  device (kernels 5 and 6, or 7 and 8 banded, for the transformer), with
  ``--val-videos`` and ``--early-stop``; saves the head for ``spot``;
  ``--cp`` trains the transformer context parallel on one spawned rank per
  card (ring attention on kernels 5 and 6, or halo attention on 7 and 8),
  ``--dp-timelines N`` batching timelines and ``--tp N`` splitting heads
  (``train/cp_loop.py``);
* ``serve``: the HTTP service of ``serve.py`` (``/summarize``, ``/spot``,
  ``/spot-stream``, ``/reload``, ``/metrics``, ``/healthz``), ``--batch``
  for cross-request batching, ``--warmup`` to build every kernel first,
  ``--max-requests N`` to exit after N requests, ``--dp N`` to split
  ``/summarize``'s scoring and ``/spot``'s trunk over N cards (-1: all);
* ``import-torch``: a reference-format ``.pt`` (``torch.save(state_dict)``)
  → ``opt`` and ``ckp`` (or ``--tag``) npz checkpoints with Adam at step 0;
* ``export-torch``: the trunk checkpoint → a reference-format ``.pt``
  (reference backbone, no MoE).

The trunk is the npz checkpoint the JAX package's ``train`` writes (the
same layout both ways, ``train/checkpoint.py``).  Every model option of the
config runs in every verb: the reference, resnet and vit backbones
(``vis_backbone``), float32, bf16 (``dtype``) and int8
(``quantized_inference``).  ``--commentary`` (the text branch, reading
``<video>.commentary.jsonl`` sidecars) and ``--moe-experts N`` (the
mixture-of-experts fusion) run in every verb that takes them; ``infer
--stream`` and ``spot --stream`` refuse ``--commentary`` as the JAX CLI
does.  ``spot-train --cp`` and ``--pp`` and ``train --dp`` (a config's
``mesh.model > 1`` gives its model axis replicas, as in JAX) run on spawned
ranks.  ``--checkpoint-backend orbax`` reads and writes JAX's ``<tag>_orbax/``
layout (``train/orbax_io.py``); without the flag an orbax-only checkpoint is
found after the npz one, as in the JAX CLI.

Runs on the card; ``GOALNET_PLATFORM=cpu`` (the JAX package's variable)
runs the plain PyTorch path on the CPU.  With neither a card nor that
variable it raises.

    python -m cvml_goalnet_tpu_torch.cli train --videos A.npz B.npz --annotation-fp anno.tsv ...
    python -m cvml_goalnet_tpu_torch.cli infer VIDEO [--no-audio] [--stream] ...
    python -m cvml_goalnet_tpu_torch.cli spot VIDEO --temporal-checkpoint head.npz [--stream] ...
    python -m cvml_goalnet_tpu_torch.cli serve --workdir work [--batch] [--spot] [--warmup] [--dp N] ...
    python -m cvml_goalnet_tpu_torch.cli train ... --dp [--global-batch G]
    python -m cvml_goalnet_tpu_torch.cli import-torch opt_model.pt --workdir work
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import os
import sys

import numpy as np

from cvml_goalnet_tpu_torch.config import PipelineConfig

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
        from cvml_goalnet_tpu_torch.train.orbax_io import load_checkpoint_orbax

        return load_checkpoint_orbax(ckp_dir, state, tag=tag)
    from cvml_goalnet_tpu_torch.train.checkpoint import load_checkpoint

    return load_checkpoint(ckp_dir, state, tag=tag)


def _load_trunk(paths: dict, state, args, tags=("opt", "ckp")):
    """Load the trunk checkpoint: the backend ``--checkpoint-backend`` pins, else the npz layout, then a
    ``<tag>_orbax`` directory, so a trunk trained with ``train --checkpoint-backend orbax`` is found without the
    flag.  Raises ``FileNotFoundError`` when there is none; a checkpoint that exists but does not load (a piece
    missing, another config) fails hard (never a random trunk)."""
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
    return None


def _refused(message: str | None) -> bool:
    if message is None:
        return False
    print(f"E: {message}", file=sys.stderr)
    return True


def cmd_train(args) -> int:
    from cvml_goalnet_tpu_torch import viz
    from cvml_goalnet_tpu_torch.data.dataset import build_datasets
    from cvml_goalnet_tpu_torch.pipeline import summarize
    from cvml_goalnet_tpu_torch.train.checkpoint import CheckpointMismatchError
    from cvml_goalnet_tpu_torch.train.loop import eval_video, train_importance_model
    from cvml_goalnet_tpu_torch.train.state import create_train_state
    from cvml_goalnet_tpu_torch.utils.metrics import MetricsLogger

    cfg = _load_cfg(args)
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

    backend = getattr(args, "checkpoint_backend", "npz")
    state = create_train_state(cfg.train.seed, cfg, device=device)
    if args.checkpoint:
        try:
            state = _load_tag(paths["ckp_dir"], state, "ckp", backend)
        except CheckpointMismatchError as e:
            print(f"E: {e}\nE: pass the matching --config/--no-audio combination", file=sys.stderr)
            return 2
        print(f"Resumed from epoch {state.epoch}")

    if args.dp:
        # global-batch training over the cards of the mesh, one spawned rank per card (train/dp_loop.py); rank 0
        # writes the ckp and opt checkpoints in the npz layout whatever the backend, as the JAX CLI does (it
        # resumes from orbax with --checkpoint-backend orbax but saves npz)
        from cvml_goalnet_tpu_torch.train.dp_loop import train_data_parallel

        train_data_parallel(cfg, train_ds, val_ds, state, num_epochs=args.epochs, global_batch=args.global_batch,
                            device=device, checkpoint_dir=paths["ckp_dir"])
        print("Operation completed")
        return 0

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
        on_epoch_end=on_epoch_end, metrics_logger=metrics_logger, checkpoint_backend=backend,
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
    except FileNotFoundError as e:
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


def _sync(device) -> None:
    """Wait for the card's queued work, so a stage's wall is the card's work and not its launches."""
    if device is None or str(device).startswith("cuda"):
        import torch

        torch.cuda.synchronize()


def cmd_profile(args) -> int:
    """Per-stage wall-clock profile of the summarize path on one video.

    decode → audio_load → features (kernel 1 and the MFCC frontend) → score
    (kernels 2–4) → postprocess (the knapsack), each timed over ``--repeats``
    passes; the first pass, which carries the kernels' first loads, is
    reported apart when ``--repeats > 1``.  On the card every stage ends with
    ``torch.cuda.synchronize()``, so a stage's wall is the card's work and not
    only its launches.  ``--trace-dir`` also writes a ``torch.profiler`` trace
    (``<dir>/trace.json``, Chrome format) whose regions carry the stage names.
    """
    import json

    import torch

    from cvml_goalnet_tpu_torch.data.annotations import AnnotationStore
    from cvml_goalnet_tpu_torch.data.audio_io import demux_audio, load_waveform
    from cvml_goalnet_tpu_torch.data.dataset import _load_frames, uniform_clip_intervals
    from cvml_goalnet_tpu_torch.data.text import commentary_sidecar
    from cvml_goalnet_tpu_torch.device import resolve_device
    from cvml_goalnet_tpu_torch.pipeline import extract_features, fuse, summarize
    from cvml_goalnet_tpu_torch.train.checkpoint import CheckpointMismatchError
    from cvml_goalnet_tpu_torch.train.state import create_train_state
    from cvml_goalnet_tpu_torch.utils.profiling import StageTimer, start_trace, stop_trace

    cfg = _load_cfg(args)
    data = _resolve_data(args)
    paths = _artifact_paths(args.workdir, cfg.model.audio_included)
    device = _device()
    dev = resolve_device(device)
    state = create_train_state(cfg.train.seed, cfg, device=device)
    try:
        state = _load_trunk(paths, state, args)
    except FileNotFoundError:
        print("W: no trained importance checkpoint; profiling a random-init trunk")
    except CheckpointMismatchError as e:
        print(f"E: {e}", file=sys.stderr)
        return 2

    video_id = os.path.basename(args.video).rsplit(".", 1)[0]
    store = (AnnotationStore(data["mat_fp"], data["h5_fp"])
             if os.path.exists(data["mat_fp"]) and os.path.exists(data["h5_fp"]) else None)
    repeats = max(1, args.repeats)
    if args.trace_dir:
        start_trace(args.trace_dir)
    timer = StageTimer()
    first = StageTimer()  # pass 0 carries the kernels' first loads: reported apart
    try:
        for rep in range(repeats):
            t = first if (rep == 0 and repeats > 1) else timer
            with t.stage("decode"):
                frames, full_n = _load_frames(args.video, cfg.preprocess.skip_frames)
            waveform = None
            if cfg.model.audio_included:
                with t.stage("audio_load"):
                    audio_fp = args.video.rsplit(".", 1)[0] + ".wav"
                    if not os.path.exists(audio_fp):
                        demux_audio(args.video, audio_fp)
                    waveform, _ = load_waveform(audio_fp, cfg.audio.sample_rate)
            commentary = None
            if cfg.model.text_included:
                commentary = (commentary_sidecar(args.video, len(frames), cfg.preprocess.skip_frames)
                              or [""] * len(frames))
            with t.stage("features"):
                feats = extract_features(frames, waveform, cfg, commentary=commentary, device=device)
                _sync(device)
            with t.stage("score"):
                scores = fuse(state.params, state.model_state, feats, cfg, device=device)
                _sync(device)
            with t.stage("postprocess"):
                intervals = (np.asarray(store.change_points(video_id)) if store is not None
                             else uniform_clip_intervals(cfg, full_n))
                res = summarize(scores, intervals, cfg.preprocess.skip_frames, full_n, cfg.knapsack, device=device)
                _sync(device)
    finally:
        trace_file = stop_trace() if args.trace_dir else None

    summary = timer.summary()
    total_s = sum(v["mean_s"] for v in summary.values())
    payload = {
        "video_id": video_id,
        "backend": dev.type,
        "device_name": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "repeats": repeats,
        "condensed_frames": int(len(scores)),
        "full_n_frames": int(full_n),
        "stages_mean_s": {k: round(v["mean_s"], 4) for k, v in summary.items()},
        "total_mean_s": round(total_s, 4),
        "condensed_fps": round(len(scores) / total_s, 1) if total_s else None,
        "selected_clips": int(len(res.clip_intervals)),
    }
    if repeats > 1:
        payload["first_pass_s"] = {k: round(v["mean_s"], 4) for k, v in first.summary().items()}
    if args.trace_dir:
        payload["trace_dir"] = args.trace_dir
        payload["trace_file"] = trace_file
    print(json.dumps(payload, indent=2))
    return 0


def _apply_temporal_overrides(cfg, args):
    """Fold --temporal-model / --attn-window / --heads into the config."""
    mc = cfg.model
    if getattr(args, "temporal_model", None):
        mc = dataclasses.replace(mc, temporal_model=args.temporal_model)
    if getattr(args, "attn_window", None) is not None:
        mc = dataclasses.replace(mc, temporal_window=args.attn_window)
    if getattr(args, "heads", None) is not None:
        mc = dataclasses.replace(mc, temporal_num_heads=args.heads)
    return dataclasses.replace(cfg, model=mc)


def _classes(args) -> "list[str] | None":
    return args.classes.split(",") if getattr(args, "classes", None) else None


def _spot_refusal(args, cfg) -> str | None:
    """Why these ``spot`` flags cannot run together, before any decode; None when they can."""
    if args.follow and not args.stream:
        return ("--follow is a --stream mode (a live segment directory "
                "cannot be spotted offline — the footage isn't finished)")
    if not args.stream:
        return None
    if args.follow and not os.path.isdir(args.video):
        return (f"--follow takes a live segment DIRECTORY and {args.video!r} is not one — "
                "stream a finished file without --follow")
    if args.eval_events:
        return ("--eval-events is an offline option (it compares against "
                "a complete sidecar); run spot without --stream to evaluate")
    if cfg.model.temporal_model in ("transformer", "hybrid") and cfg.model.temporal_window <= 0:
        return (f"--stream with the {cfg.model.temporal_model} scorer needs "
                "a banded window (--attn-window N): full attention has an "
                "unbounded receptive field so streamed scores could never be "
                "final; band it or spot offline")
    if cfg.model.text_included:
        return ("--stream supports trunks without --commentary — there is "
                "no live ingest protocol for commentary tokens (documented "
                "contract, docs/ARCHITECTURE.md); use a visual(/audio) trunk "
                "or spot offline")
    if cfg.model.audio_included and not args.follow:
        return ("audio trunks stream via --follow (a live segment directory "
                "where each segment ships its .wav span) — a single complete "
                "file has no per-chunk audio contract; use --follow, a "
                "--no-audio trunk, or spot offline")
    return None


def _load_spot_trunk(cfg, args, device, what: str):
    """The trunk for spotting (tag ``opt``; a random one, with a warning, when there is none) → (state, exit
    code or None)."""
    from cvml_goalnet_tpu_torch.train.checkpoint import CheckpointMismatchError
    from cvml_goalnet_tpu_torch.train.state import create_train_state

    paths = _artifact_paths(args.workdir, cfg.model.audio_included)
    state = create_train_state(cfg.train.seed, cfg, device=device)
    try:
        return _load_trunk(paths, state, args, tags=("opt",)), None
    except FileNotFoundError:
        print(f"W: no trained importance checkpoint; {what} a random-init trunk")
        return state, None
    except CheckpointMismatchError as e:
        # a checkpoint exists but does not fit the flags: scoring with a random trunk would mean nothing
        print(f"E: {e}\nE: re-train with the current flags or pass the matching "
              "--config/--no-audio/--commentary/--moe-experts combination", file=sys.stderr)
        return None, 2


def _temporal_head(cfg, classes):
    """The configured temporal head as a numpy tree, seeded (``weights.init_temporal_params``, seed 1)."""
    from cvml_goalnet_tpu_torch import weights
    from cvml_goalnet_tpu_torch.serve import trunk_feature_dim

    return weights.init_temporal_params(cfg.model, trunk_feature_dim(cfg), seed=1,
                                        n_classes=len(classes) if classes else 1)


def cmd_spot(args) -> int:
    """Temporal event spotting over one video: offline, or ``--stream`` (``--follow``) with events as jsonl."""
    import json

    from cvml_goalnet_tpu_torch import weights
    from cvml_goalnet_tpu_torch.data.annotations import AnnotationStore
    from cvml_goalnet_tpu_torch.data.dataset import build_video_item
    from cvml_goalnet_tpu_torch.data.video import probe_video_fps
    from cvml_goalnet_tpu_torch.pipeline import summarize
    from cvml_goalnet_tpu_torch.serve import event_seconds
    from cvml_goalnet_tpu_torch.spotting import (
        encode_timeline,
        load_event_labels,
        score_timeline_auto,
        scores_to_importance,
        spot_events_multi,
        summarize_match,
    )

    cfg = _apply_temporal_overrides(_load_cfg(args), args)
    if _refused(_spot_refusal(args, cfg)):
        return 2
    data = _resolve_data(args)
    store = (AnnotationStore(data["mat_fp"], data["h5_fp"])
             if os.path.exists(data["mat_fp"]) and os.path.exists(data["h5_fp"]) else None)
    device = _device()
    # --stream never holds the whole timeline (that is its point), so it skips the one-shot decode
    item = None
    if not args.stream:
        item = build_video_item(args.video, cfg, None, store, cfg.model.audio_included, device=device)
    state, rc = _load_spot_trunk(cfg, args, device, "using")
    if rc is not None:
        return rc

    classes = _classes(args)
    tparams = _temporal_head(cfg, classes)
    if args.temporal_checkpoint:
        tparams = weights.load_spotting_checkpoint(args.temporal_checkpoint, tparams, classes=classes)
    else:
        print("W: no --temporal-checkpoint; scoring with a random-init temporal head")
    tparams = weights.tree_from_jax(tparams, device=device)

    # frame → seconds at the container's fps (production footage is 25 fps); 30.0 only for fps-less archives
    fps = probe_video_fps(args.video) or 30.0
    if args.stream:
        return _run_spot_stream(args, cfg, state, tparams, classes, fps, device)

    skip = cfg.preprocess.skip_frames
    events_fp = args.video.rsplit(".", 1)[0] + ".events.json"
    evaluate = args.eval_events and os.path.exists(events_fp)
    if classes:
        # per-class events; the knapsack summary takes the class-agnostic eventness (the max over classes)
        feats = encode_timeline(state.params, state.model_state, item.visual, item.audio, cfg, device=device,
                                text=item.text)
        scores_mc = score_timeline_auto(tparams, feats, cfg).cpu().numpy()
        if scores_mc.ndim == 1:   # a one-channel head (--classes with one name)
            scores_mc = scores_mc[:, None]
        events_by_class = spot_events_multi(scores_mc, args.peak_window, args.peak_threshold)
        summary = summarize(scores_to_importance(scores_mc.max(axis=1)), item.clip_intervals, skip,
                            item.full_n_frames, cfg.knapsack, device=device)
        payload = {
            "video_id": item.video_id,
            "classes": classes,
            "events_condensed_frames": {c: ev.tolist() for c, ev in zip(classes, events_by_class)},
            "events_seconds": {c: event_seconds(ev, skip, fps) for c, ev in zip(classes, events_by_class)},
            "summary_clips": np.asarray(summary.clip_intervals).tolist(),
            "summary_frames": int(summary.frame_mask.sum()),
        }
        if evaluate:
            from cvml_goalnet_tpu_torch.ops.spotting_metrics import multiclass_average_map, spotting_pr

            gt_mc = load_event_labels(events_fp, len(item.visual), skip, classes)
            gt_by_class = [np.nonzero(gt_mc[:, c])[0] for c in range(len(classes))]
            score_by_class = [scores_mc[ev, c] if len(ev) else np.zeros((0,)) for c, ev in enumerate(events_by_class)]
            mm = multiclass_average_map(events_by_class, score_by_class, gt_by_class)
            per_class = {}
            for i, c in enumerate(classes):
                pr, rc, f1 = spotting_pr(events_by_class[i], score_by_class[i], gt_by_class[i],
                                         tolerance=args.eval_tolerance)
                per_class[c] = {"precision": round(pr, 4), "recall": round(rc, 4), "f1": round(f1, 4),
                                **mm["per_class"][i]}
            payload["eval"] = {
                "gt_events": {c: g.tolist() for c, g in zip(classes, gt_by_class)},
                "tolerance": args.eval_tolerance,
                "average_map": mm["average_map"],
                "per_class": per_class,
            }
        print(json.dumps(payload, indent=2))
        return 0

    result = summarize_match(state.params, state.model_state, tparams, item.visual, item.audio,
                             item.clip_intervals, cfg, full_n_frames=item.full_n_frames,
                             peak_window=args.peak_window, peak_threshold=args.peak_threshold, device=device,
                             text=item.text)
    payload = {
        "video_id": item.video_id,
        "events_condensed_frames": result.events.tolist(),
        "events_seconds": event_seconds(result.events, skip, fps),
        "summary_clips": np.asarray(result.summary.clip_intervals).tolist(),
        "summary_frames": int(result.summary.frame_mask.sum()),
    }
    if evaluate:   # against the events sidecar: tolerance P/R and average-mAP
        from cvml_goalnet_tpu_torch.ops.spotting_metrics import average_map, spotting_pr

        gt = np.nonzero(load_event_labels(events_fp, len(item.visual), skip))[0]
        pred = result.events
        scores = np.asarray(result.scores)[pred] if len(pred) else np.zeros((0,))
        p, r, f1 = spotting_pr(pred, scores, gt, tolerance=args.eval_tolerance)
        payload["eval"] = {
            "gt_events": gt.tolist(),
            "tolerance": args.eval_tolerance,
            "precision": round(p, 4), "recall": round(r, 4), "f1": round(f1, 4),
            **average_map(pred, scores, gt),
        }
    print(json.dumps(payload, indent=2))
    return 0


def _run_spot_stream(args, cfg, state, tparams, classes, fps, device) -> int:
    """``spot --stream``: bounded-latency live spotting.  One jsonl line per event the moment it is final
    (``spotting.spot_stream``: scores wait for a halo of right context, events for their peak window), then a
    closing summary.  The input is a finished file decoded in chunks (visual-only trunks), or with
    ``--follow`` a live segment directory, where each segment's ``.wav`` lets audio trunks stream too."""
    import json

    from cvml_goalnet_tpu_torch.serve import file_chunks, follow_chunks, stream_lines
    from cvml_goalnet_tpu_torch.spotting import spot_stream

    skip = cfg.preprocess.skip_frames
    if args.follow:
        chunks, audio_chunks = follow_chunks(args.video, cfg, args.stream_chunk, poll_interval=args.follow_poll,
                                             timeout=args.follow_timeout, end_sentinel=args.follow_end)
    else:
        chunks, audio_chunks = file_chunks(args.video, cfg, args.stream_chunk), None

    updates = spot_stream(state.params, state.model_state, tparams, chunks, cfg, halo=args.stream_halo,
                          peak_window=args.peak_window, peak_threshold=args.peak_threshold,
                          audio_chunks=audio_chunks, device=device)
    video_id = os.path.basename(args.video).rsplit(".", 1)[0]
    for kind, item in stream_lines(updates, classes or [None], skip, fps):
        if kind == "event":
            print(json.dumps(item), flush=True)
        elif kind == "summary":
            print(json.dumps({"video_id": video_id, **item}, indent=2))
    return 0


def _spot_opt_kwargs(tc) -> dict:
    """Schedule and clip arguments of the spotting step from ``TrainConfig``, so ``spot-train`` honours the
    optimizer controls ``train`` does (the base lr stays ``--lr``; the schedule scales it)."""
    kw = {}
    if tc.lr_schedule != "constant" or tc.lr_warmup_steps or tc.lr_decay_steps:
        kw["lr_schedule"] = (tc.lr_schedule, tc.lr_warmup_steps, tc.lr_decay_steps, tc.lr_min_ratio)
    if tc.grad_clip_norm:
        kw["grad_clip_norm"] = tc.grad_clip_norm
    return kw


def _spot_train_refusal(args, cfg, world: int) -> str | None:
    """Why these ``spot-train`` flags cannot run on ``world`` ranks, before any decode; None when they can.
    The JAX CLI's refusals in its order (its ``--pp`` ones at ``cli.py:912-936``), bar the equal-length
    timelines of ``--pp``, which :func:`_unequal_timelines` checks once the videos are known."""
    ndp, ntp, npp = max(1, args.dp_timelines or 1), max(1, args.tp or 1), max(1, args.pp or 1)
    if not args.cp and (ndp > 1 or ntp > 1):
        # these flags only pick mesh axes of the CP layouts: ignoring them would train on one device while the
        # user believes the run is parallel
        return "--dp-timelines/--tp require --cp"
    if args.early_stop and not args.val_videos:
        return "--early-stop needs --val-videos (a held-out metric to stop on)"
    if args.cp and cfg.model.temporal_model != "transformer":
        return "--cp needs the transformer scorer (--temporal-model transformer)"
    if npp > 1:
        if cfg.model.temporal_model != "transformer":
            return "--pp needs the transformer scorer (--temporal-model transformer)"
        if args.cp:
            return ("--pp and --cp are mutually exclusive (pipeline stages and context shards lay the mesh out "
                    "differently)")
        if cfg.model.temporal_num_layers % npp:
            return (f"--pp {npp} must divide temporal_num_layers ({cfg.model.temporal_num_layers}) — one stage "
                    "per device needs an even split of blocks")
        if world < npp:
            return f"--pp {npp} needs {npp} devices, have {world}"
    if not args.cp:
        return None
    if ntp > 1:
        if world % (ndp * ntp):
            return f"--dp-timelines {ndp} × --tp {ntp} does not divide the {world}-device mesh"
        if cfg.model.temporal_num_heads % ntp:
            return f"--tp {ntp} must divide the head count ({cfg.model.temporal_num_heads}); pass --heads"
    elif ndp > 1 and world % ndp:
        return f"--dp-timelines {ndp} does not divide the {world}-device mesh"
    return None


PP_UNEQUAL = ("--pp requires equal-length timelines (the GPipe path does not mask pad rows out of attention) — "
              "use --cp for variable lengths")


def _unequal_timelines(fps, skip: int) -> bool:
    """Whether the labelled videos of ``fps`` give timelines of more than one length, from the exact frame
    counts of ``.npz`` headers (``data.dataset.condensed_length``: no decode); a video container, whose count
    is an estimate, is left to the check after encoding."""
    from cvml_goalnet_tpu_torch.data.dataset import condensed_length

    lengths = {condensed_length(fp, skip) for fp in fps if os.path.exists(fp.rsplit(".", 1)[0] + ".events.json")}
    lengths.discard(None)
    return len(lengths) > 1


def _cp_layout_line(ndp: int, ntp: int, world: int) -> str:
    """The JAX CLI's line naming the context-parallel layout."""
    if ntp > 1:
        return f"DP×TP×CP: {ndp} timelines × {ntp}-way tensor × {world // (ndp * ntp)}-way context parallel"
    if ndp > 1:
        return f"DP×CP: {ndp} timelines × {world // ndp}-way context parallel"
    return f"context-parallel over {world} devices"


def cmd_spot_train(args) -> int:
    """Train the temporal spotting head on event-labelled videos, on one device or context parallel.

    Each video's labels are its ``<video>.events.json`` sidecar (raw frame
    indices of events).  The trunk encodes each timeline once (kernels 1–3
    on the card); the GRU, transformer (kernels 5 and 6, or 7 and 8 banded)
    or hybrid head trains on weighted BCE
    (``train/spotting.make_spotting_train_step``); with ``--val-videos`` the
    best-val head is kept, and ``--early-stop N`` stops after N epochs
    without a better val loss.  The head is saved with
    ``save_spotting_checkpoint`` for ``spot --temporal-checkpoint``.
    ``--cp`` (with ``--dp-timelines N`` and ``--tp N``) trains the
    transformer on one spawned rank per card (``train/cp_loop.py``): every
    visible card, as the JAX CLI takes every device; on the CPU the
    config's ``mesh.data`` gloo ranks.  ``--pp N`` trains it pipeline
    parallel on the first N of them (``parallel/pp.py``, one stage a rank),
    one batch of every (equal-length) timeline a step.
    """
    import torch

    from cvml_goalnet_tpu_torch import weights
    from cvml_goalnet_tpu_torch.data.annotations import AnnotationStore
    from cvml_goalnet_tpu_torch.data.dataset import build_video_item
    from cvml_goalnet_tpu_torch.parallel.mesh import cp_world
    from cvml_goalnet_tpu_torch.spotting import encode_timeline, load_event_labels
    from cvml_goalnet_tpu_torch.train.spotting import (
        init_spotting_opt,
        make_spotting_train_step,
        save_spotting_checkpoint,
        validation_loss,
        validation_map,
    )

    cfg = _apply_temporal_overrides(_load_cfg(args), args)
    npp = max(1, args.pp or 1)
    mesh = cp_world(_device(), cfg.mesh.data) if args.cp or npp > 1 else None
    if _refused(_spot_train_refusal(args, cfg, len(mesh) if mesh else 1)):
        return 2
    data = _resolve_data(args)
    val_fps = list(args.val_videos or [])
    # held out by resolved path, not by the string: `--videos data/vidA.npz --val-videos ./data/vidA.npz` must
    # not train on the val video
    val_real = {os.path.realpath(fp) for fp in val_fps}
    train_fps = [fp for fp in data["videos"] if os.path.realpath(fp) not in val_real]
    if val_fps and not train_fps:
        print("E: every --videos path is held out by --val-videos; nothing left to train on", file=sys.stderr)
        return 2
    for fp in val_fps:
        if not os.path.exists(fp.rsplit(".", 1)[0] + ".events.json"):
            # a val video without labels validates nothing; skipping it would select on less than was asked
            print(f"E: val video {fp}: no .events.json sidecar", file=sys.stderr)
            return 2
    if npp > 1 and _unequal_timelines(train_fps, cfg.preprocess.skip_frames):
        _refused(PP_UNEQUAL)
        return 2
    device = _device()
    store = (AnnotationStore(data["mat_fp"], data["h5_fp"])
             if os.path.exists(data["mat_fp"]) and os.path.exists(data["h5_fp"]) else None)
    state, rc = _load_spot_trunk(cfg, args, device, "encoding with")
    if rc is not None:
        return rc
    classes = _classes(args)

    def encode_pairs(video_fps):
        out = []
        for fp in video_fps:
            events_fp = fp.rsplit(".", 1)[0] + ".events.json"
            if not os.path.exists(events_fp):
                print(f"W: {fp}: no events sidecar, skipping")
                continue
            item = build_video_item(fp, cfg, None, store, cfg.model.audio_included, device=device)
            feats = encode_timeline(state.params, state.model_state, item.visual, item.audio, cfg, device=device,
                                    text=item.text)
            labels = load_event_labels(events_fp, len(item.visual), cfg.preprocess.skip_frames, classes)
            out.append((item.video_id, feats, torch.as_tensor(labels, device=feats.device)))
        return out

    pairs = encode_pairs(train_fps)
    val_pairs = encode_pairs(val_fps)
    if not pairs:
        print("E: no videos with .events.json sidecars", file=sys.stderr)
        return 2

    tparams = weights.tree_from_jax(_temporal_head(cfg, classes), device=device)
    mc = cfg.model
    opt_kw = _spot_opt_kwargs(cfg.train)
    out_fp = args.out or os.path.join(args.workdir, "models", "spotting_head.npz")
    if args.cp or npp > 1:
        # context parallel: every timeline over every rank, its attention a ring (a halo hop each side when
        # banded); --dp-timelines batches timelines over a data axis, --tp splits heads over a model axis.
        # Pipeline parallel: the blocks in --pp stages over the first --pp ranks, one batch of every timeline
        from cvml_goalnet_tpu_torch.train.cp_loop import train_spotting_cp

        ndp, ntp, n_micro = max(1, args.dp_timelines or 1), max(1, args.tp or 1), 0
        if npp > 1:
            if len({int(f.shape[0]) for _, f, _ in pairs}) > 1:   # a container that miscounted its frames
                _refused(PP_UNEQUAL)
                return 2
            b = len(pairs)
            n_micro = max(k for k in range(1, min(b, npp) + 1) if b % k == 0)
            mesh = mesh[:npp]
            print(f"pipeline-parallel: {npp} stages x {n_micro} microbatches")
        else:
            print(_cp_layout_line(ndp, ntp, len(mesh)))
        train_spotting_cp(cfg, pairs, val_pairs, tparams, mesh, ndp=ndp, ntp=ntp, npp=npp, n_micro=n_micro,
                          lr=args.lr, pos_weight=args.pos_weight, epochs=args.epochs, out=out_fp, classes=classes,
                          early_stop=args.early_stop, peak_window=args.peak_window,
                          peak_threshold=args.peak_threshold, opt_kw=opt_kw)
        print(f"Saved temporal head: {out_fp}")
        print("Operation completed")
        return 0
    if mc.temporal_model == "transformer":
        step = make_spotting_train_step(0, lr=args.lr, pos_weight=args.pos_weight, scorer="transformer",
                                        num_heads=mc.temporal_num_heads, window=mc.temporal_window, **opt_kw)
    elif mc.temporal_model == "hybrid":
        step = make_spotting_train_step(mc.temporal_hidden, lr=args.lr, pos_weight=args.pos_weight, scorer="hybrid",
                                        num_heads=mc.temporal_num_heads, window=mc.temporal_window, **opt_kw)
    else:
        step = make_spotting_train_step(mc.temporal_hidden, lr=args.lr, pos_weight=args.pos_weight, **opt_kw)

    opt = init_spotting_opt(tparams)
    best = {"val": float("inf"), "params": tparams, "epoch": -1}
    for epoch in range(args.epochs):
        losses = []
        for _, feats, labels in pairs:
            tparams, opt, loss = step(tparams, opt, feats, labels)
            losses.append(float(loss))
        if val_pairs:
            vloss = validation_loss(tparams, val_pairs, cfg, args.pos_weight)
            vmap = validation_map(tparams, val_pairs, cfg, args.peak_window, args.peak_threshold)
            print(f"epoch {epoch}: loss {np.mean(losses):.4f} val-loss {vloss:.4f} val-mAP {vmap:.4f}")
            if vloss < best["val"]:
                best = {"val": vloss, "params": tparams, "epoch": epoch}
            elif args.early_stop and epoch - best["epoch"] >= args.early_stop:
                print(f"Early stop: no val-loss improvement in {args.early_stop} epochs (best epoch {best['epoch']}).")
                break
        else:
            print(f"epoch {epoch}: loss {np.mean(losses):.4f}")

    if val_pairs:
        tparams = best["params"]   # held-out selection: the best-val head, not the last
        print(f"best val-loss {best['val']:.4f} at epoch {best['epoch']}")
    save_spotting_checkpoint(out_fp, tparams, classes=classes)
    print(f"Saved temporal head: {out_fp}")
    print("Operation completed")
    return 0


def cmd_serve(args) -> int:
    """The long-lived HTTP service (``serve.py``): /summarize, /reload, /metrics, /healthz, and with ``--spot``
    /spot and /spot-stream.  The trunk loads once (npz auto-detected as ``infer`` does); ``--batch`` adds
    cross-request batching; ``--warmup`` builds every kernel and runs each production shape before the first
    request."""
    import zipfile

    from cvml_goalnet_tpu_torch.serve import DynamicBatcher, Spotter, Summarizer, serve_http
    from cvml_goalnet_tpu_torch.train.checkpoint import CheckpointMismatchError
    from cvml_goalnet_tpu_torch.train.state import create_train_state

    cfg = _apply_temporal_overrides(_load_cfg(args), args)
    paths = _artifact_paths(args.workdir, cfg.model.audio_included)
    device = _device()
    mesh = None
    if args.dp:
        from cvml_goalnet_tpu_torch.parallel.mesh import serving_mesh

        try:
            mesh = serving_mesh(None if args.dp == -1 else args.dp, device=device)
        except ValueError as e:
            print(f"E: {e}", file=sys.stderr)
            return 2
    state = create_train_state(cfg.train.seed, cfg, device=device)
    try:
        state = _load_trunk(paths, state, args, tags=("opt", "ckp"))
    except FileNotFoundError:
        print("W: no trained importance checkpoint; serving a random-init trunk")
    except CheckpointMismatchError as e:
        print(f"E: {e}", file=sys.stderr)
        return 2

    def trunk_reloader():
        # POST /reload runs the same auto-detecting load the server booted with (never a path from a request);
        # a random-init boot picks up the first opt_* a training job writes
        template = create_train_state(cfg.train.seed, cfg, device=device)
        return _load_trunk(paths, template, args, tags=("opt", "ckp"))

    summarizer = Summarizer(cfg, state=state, reloader=trunk_reloader, device=device, mesh=mesh)
    spotter = None
    if args.spot:
        if not args.temporal_checkpoint:
            print("W: /spot will use a random-init temporal head (pass --temporal-checkpoint)")
        try:
            spotter = Spotter(cfg, state=state, temporal_checkpoint=args.temporal_checkpoint,
                              classes=_classes(args), reloader=trunk_reloader, device=device, mesh=mesh)
        except (ValueError, OSError, zipfile.BadZipFile) as e:
            # a missing, unreadable or corrupt --temporal-checkpoint is a configuration error, not a traceback
            print(f"E: {e}", file=sys.stderr)
            return 2
    batcher = DynamicBatcher(summarizer) if args.batch else None
    try:
        if args.warmup:
            summarizer.warmup()
            if batcher is not None:
                batcher.warmup()
            if spotter is not None:
                spotter.warmup()
        try:
            server = serve_http(summarizer, args.host, args.port, media_root=args.media_root, batcher=batcher,
                                spotter=spotter)
        except ValueError as e:  # a non-loopback host without --media-root
            print(f"E: {e}", file=sys.stderr)
            return 2
        print(f"serving on http://{args.host}:{server.server_address[1]}"
              f" (spot={'on' if spotter else 'off'}, batch={'on' if batcher else 'off'},"
              f" dp={len(mesh) if mesh is not None else 'off'})", flush=True)
        if args.max_requests:
            # handle_request() returns once it has handed the request to a handler thread, and
            # ThreadingHTTPServer does not join daemon handlers on close: non-daemon handlers are joined by
            # server_close(), so the last response is written before this returns
            server.daemon_threads = False
            try:
                for _ in range(args.max_requests):
                    server.handle_request()
            finally:
                server.server_close()
        else:  # pragma: no cover - interactive mode
            server.serve_forever()
    finally:
        if batcher is not None:
            batcher.close()
    return 0


def cmd_import_torch(args) -> int:
    """A reference-format PyTorch checkpoint → the port's npz checkpoint.

    The reference writes ``torch.save(model.state_dict())`` (``main.py:263,282``); this writes
    ``models/importance*/{opt,ckp}_state.npz`` (or only ``--tag``) with Adam at step 0 and epoch 0, in the
    layout both packages read, so ``infer``, ``spot`` and ``serve`` find the weights with no further flag.
    """
    import torch

    from cvml_goalnet_tpu_torch.compat import import_reference_state_dict
    from cvml_goalnet_tpu_torch.train.checkpoint import save_checkpoint
    from cvml_goalnet_tpu_torch.train.optim import adam_init
    from cvml_goalnet_tpu_torch.train.state import TrainState

    cfg = _load_cfg(args)
    paths = _artifact_paths(args.workdir, cfg.model.audio_included)
    sd = torch.load(args.pt_file, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    try:
        params, model_state = import_reference_state_dict(sd, cfg.model, cfg.preprocess, cfg.audio,
                                                          device=_device())
    except (ValueError, KeyError) as e:
        print(f"E: {e}", file=sys.stderr)
        return 2
    state = TrainState(params=params, model_state=model_state, opt_state=adam_init(params), epoch=0)
    for tag in (args.tag,) if args.tag else ("opt", "ckp"):
        save_checkpoint(paths["ckp_dir"], state, cfg, tag=tag)
    print(f"Imported {args.pt_file} -> {paths['ckp_dir']}")
    print("Operation completed")
    return 0


def cmd_export_torch(args) -> int:
    """The trunk checkpoint → a reference-format PyTorch ``.pt`` the reference's own ``AVM.load_state_dict``
    loads (``main.py:65-66,326``); ``--tag`` picks the checkpoint (default ``opt``, then ``ckp``)."""
    import torch

    from cvml_goalnet_tpu_torch.compat import export_reference_state_dict
    from cvml_goalnet_tpu_torch.train.checkpoint import CheckpointMismatchError
    from cvml_goalnet_tpu_torch.train.state import create_train_state

    cfg = _load_cfg(args)
    paths = _artifact_paths(args.workdir, cfg.model.audio_included)
    state = create_train_state(cfg.train.seed, cfg, device=_device())
    try:
        state = _load_trunk(paths, state, args, tags=(args.tag,) if args.tag else ("opt", "ckp"))
    except (FileNotFoundError, CheckpointMismatchError) as e:
        print(f"E: {e}", file=sys.stderr)
        return 2
    try:
        sd = export_reference_state_dict(state.params, state.model_state, cfg.model, cfg.preprocess, cfg.audio)
    except ValueError as e:   # an MoE fusion head has no reference-format counterpart
        print(f"E: {e}", file=sys.stderr)
        return 2
    os.makedirs(os.path.dirname(os.path.abspath(args.out_pt)), exist_ok=True)
    torch.save({k: torch.as_tensor(v) for k, v in sd.items()}, args.out_pt)
    print(f"Exported {paths['ckp_dir']} -> {args.out_pt}")
    print("Operation completed")
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

    p = sub.add_parser("profile", help="per-stage wall-clock profile of the summarize pipeline on one video")
    _add_data_args(p)
    p.add_argument("video")
    p.add_argument("--no-audio", action="store_true")
    p.add_argument("--commentary", action="store_true",
                   help="enable the text branch (reads <video>.commentary.jsonl)")
    p.add_argument("--checkpoint-backend", choices=["npz", "orbax"], default=None,
                   help="pin the checkpoint layout (default: auto-detect)")
    p.add_argument("--moe-experts", type=int, default=None,
                   help="match a trunk trained with --moe-experts N")
    p.add_argument("--repeats", type=int, default=3,
                   help="timed passes; the first carries the kernels' first loads and is "
                        "reported separately when repeats > 1")
    p.add_argument("--trace-dir", default=None,
                   help="write a torch.profiler trace (trace.json, Chrome format) here, "
                        "its regions named by the stages")
    p.set_defaults(fn=cmd_profile)

    p = sub.add_parser("spot", help="temporal event spotting over one video")
    _add_data_args(p)
    p.add_argument("video")
    p.add_argument("--no-audio", action="store_true")
    p.add_argument("--commentary", action="store_true",
                   help="3-modality trunk (trained with train --commentary); "
                        "reads <video>.commentary.jsonl sidecars")
    p.add_argument("--temporal-checkpoint", default=None)
    p.add_argument("--temporal-model", choices=["gru", "transformer", "hybrid"], default=None)
    p.add_argument("--attn-window", type=int, default=None,
                   help="transformer attention band radius in condensed frames "
                        "(sliding-window flash kernel; 0/default = full attention)")
    p.add_argument("--heads", type=int, default=None,
                   help="override temporal_num_heads (must match the trained head)")
    p.add_argument("--classes", default=None,
                   help="comma-separated event classes (goal,card,...) for "
                        "multi-class spotting; requires a head trained with "
                        "the same classes")
    p.add_argument("--peak-window", type=int, default=5)
    p.add_argument("--peak-threshold", type=float, default=0.0)
    p.add_argument("--stream", action="store_true",
                   help="LIVE bounded-latency spotting: decode in chunks and "
                        "emit each event as a jsonl line the moment it is "
                        "final (GRU or banded-transformer scorer)")
    p.add_argument("--stream-chunk", type=int, default=256,
                   help="condensed frames per decoded chunk in --stream mode")
    p.add_argument("--stream-halo", type=int, default=64,
                   help="right-context frames an emission waits for "
                        "(--stream; bounds the streamed-vs-offline drift for "
                        "the GRU; the banded transformer raises it to its "
                        "layers*window exactness floor)")
    p.add_argument("--follow", action="store_true",
                   help="--stream: VIDEO is a LIVE segment DIRECTORY still "
                        "being written (finalized lexicographic segments, "
                        ".part scratch names, END sentinel — data/follow.py);"
                        " audio trunks stream here via per-segment .wav "
                        "sidecars")
    p.add_argument("--follow-timeout", type=float, default=60.0,
                   help="--follow: seconds without a new segment or sentinel "
                        "before failing loudly")
    p.add_argument("--follow-poll", type=float, default=0.25,
                   help="--follow: directory poll interval in seconds")
    p.add_argument("--follow-end", default="END",
                   help="--follow: end-of-stream sentinel filename")
    p.add_argument("--eval-events", action="store_true",
                   help="evaluate vs <video>.events.json (tolerance P/R + average-mAP)")
    p.add_argument("--eval-tolerance", type=int, default=5,
                   help="matching tolerance in condensed frames")
    p.add_argument("--checkpoint-backend", choices=["npz", "orbax"], default=None,
                   help="pin the trunk checkpoint layout (default: auto-detect)")
    p.add_argument("--moe-experts", type=int, default=None,
                   help="match a trunk trained with --moe-experts N")
    p.set_defaults(fn=cmd_spot)

    p = sub.add_parser("spot-train", help="train the temporal spotting head on event labels")
    _add_data_args(p)
    p.add_argument("--no-audio", action="store_true")
    p.add_argument("--commentary", action="store_true",
                   help="3-modality trunk (trained with train --commentary); "
                        "reads <video>.commentary.jsonl sidecars")
    p.add_argument("--temporal-model", choices=["gru", "transformer", "hybrid"], default=None)
    p.add_argument("--attn-window", type=int, default=None,
                   help="transformer attention band radius in condensed frames")
    p.add_argument("--cp", action="store_true",
                   help="context-parallel training over all devices: one rank per card (on the CPU, the "
                        "config's mesh.data gloo ranks); the transformer scorer only")
    p.add_argument("--dp-timelines", type=int, default=1, metavar="N",
                   help="with --cp: compose DP×CP — batch N timelines over a 'data' mesh axis (N must divide "
                        "the device count)")
    p.add_argument("--tp", type=int, default=1, metavar="N",
                   help="with --cp: split attention heads and the MLP N-way over a 'model' mesh axis (N must "
                        "divide the head count (--heads) and, with --dp-timelines, the device count)")
    p.add_argument("--pp", type=int, default=1, metavar="N",
                   help="pipeline-parallel training (GPipe): the transformer's blocks one stage a device over the "
                        "first N devices; N must divide temporal_num_layers; needs equal-length timelines")
    p.add_argument("--heads", type=int, default=None,
                   help="override temporal_num_heads for the transformer scorer")
    p.add_argument("--classes", default=None,
                   help="comma-separated event classes (goal,card,...) — "
                        "trains a multi-class head from labelled sidecars")
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--pos-weight", type=float, default=10.0)
    p.add_argument("--val-videos", nargs="*", default=None,
                   help="held-out videos (with .events.json sidecars): "
                        "per-epoch val loss, best-val head selection; any "
                        "path also in --videos is removed from training")
    p.add_argument("--early-stop", type=int, default=0, metavar="N",
                   help="stop after N epochs without val-loss improvement "
                        "(needs --val-videos); 0 = off")
    p.add_argument("--peak-window", type=int, default=5,
                   help="val-mAP peak detection window (match the value "
                        "`spot` will deploy with)")
    p.add_argument("--peak-threshold", type=float, default=0.0,
                   help="val-mAP peak detection threshold on the logit scores")
    p.add_argument("--out", default=None, help="output npz for the temporal head")
    p.add_argument("--checkpoint-backend", choices=["npz", "orbax"], default=None,
                   help="pin the trunk checkpoint layout (default: auto-detect)")
    p.add_argument("--moe-experts", type=int, default=None,
                   help="match a trunk trained with --moe-experts N")
    p.set_defaults(fn=cmd_spot_train)

    p = sub.add_parser("serve", help="HTTP serving: /summarize, /reload, /metrics, /healthz (+ /spot, /spot-stream)")
    p.add_argument("--config", default=None, help="PipelineConfig JSON path")
    p.add_argument("--workdir", default=".", help="artifact root with models/")
    p.add_argument("--no-audio", action="store_true")
    p.add_argument("--commentary", action="store_true")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8765, help="0 = OS-assigned")
    p.add_argument("--media-root", default=None,
                   help="confine requested video paths to this directory "
                        "(REQUIRED for non-loopback --host)")
    p.add_argument("--batch", action="store_true",
                   help="cross-request dynamic batching (serve.DynamicBatcher)")
    p.add_argument("--dp", type=int, default=0, metavar="N",
                   help="shard /summarize scoring AND the /spot timeline "
                        "encode data-parallel over N local devices (-1 = "
                        "all); composes with --batch")
    p.add_argument("--spot", action="store_true",
                   help="also serve POST /spot and /spot-stream (event spotting)")
    p.add_argument("--temporal-checkpoint", default=None,
                   help="spot-train head npz for /spot")
    p.add_argument("--temporal-model", choices=["gru", "transformer", "hybrid"], default=None)
    p.add_argument("--attn-window", type=int, default=None)
    p.add_argument("--classes", default=None,
                   help="comma-separated event classes for /spot")
    p.add_argument("--checkpoint-backend", choices=["npz", "orbax"], default=None,
                   help="pin the trunk checkpoint layout (default: auto-detect)")
    p.add_argument("--warmup", action="store_true",
                   help="build every kernel and run the production shapes before accepting requests")
    p.add_argument("--max-requests", type=int, default=0,
                   help="serve N requests then exit (0 = forever)")
    p.add_argument("--moe-experts", type=int, default=None,
                   help="match a trunk trained with --moe-experts N")
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("import-torch", help="import a reference-format .pt as our checkpoint")
    p.add_argument("pt_file")
    p.add_argument("--config", default=None, help="PipelineConfig JSON path")
    p.add_argument("--workdir", default=".", help="artifact root (models/)")
    p.add_argument("--no-audio", action="store_true",
                   help="the .pt is a no-audio (VM) checkpoint")
    p.add_argument("--tag", choices=["opt", "ckp"], default=None,
                   help="write only this tag (default: both)")
    p.set_defaults(fn=cmd_import_torch)

    p = sub.add_parser("export-torch", help="export our checkpoint as a reference-format .pt")
    p.add_argument("out_pt")
    p.add_argument("--config", default=None, help="PipelineConfig JSON path")
    p.add_argument("--workdir", default=".", help="artifact root (models/)")
    p.add_argument("--no-audio", action="store_true")
    p.add_argument("--tag", choices=["opt", "ckp"], default=None,
                   help="export this tag (default: opt, falling back to ckp)")
    p.add_argument("--checkpoint-backend", choices=["npz", "orbax"], default=None,
                   help="pin the checkpoint layout (default: auto-detect)")
    p.set_defaults(fn=cmd_export_torch)

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
