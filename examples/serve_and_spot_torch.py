"""Production-surface walkthrough with the PyTorch port: serving (with dynamic batching) and spotting.

The port's counterpart of ``examples/serve_and_spot.py``, with its config,
seeds, step counts and printed lines.  On the CPU (about a minute):

    GOALNET_PLATFORM=cpu python examples/serve_and_spot_torch.py

On the card (the kernels are built by nvcc at first use):

    python examples/serve_and_spot_torch.py

1. builds the tiny no-audio config and six synthetic 12×48×64 clips;
2. serves them concurrently through :class:`Summarizer` behind a
   :class:`DynamicBatcher` (concurrent requests share device dispatches);
3. trains the temporal spotting head (a bidirectional GRU) on event labels
   for 250 steps and evaluates the spotted events with tolerance
   precision/recall and average-mAP.
"""

import os
import sys
from concurrent.futures import ThreadPoolExecutor

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from cvml_goalnet_tpu_torch.config import (  # noqa: E402
    AudioConfig, ModelConfig, PipelineConfig, PreprocessConfig, TrainConfig)
from cvml_goalnet_tpu_torch.device import resolve_device  # noqa: E402
from cvml_goalnet_tpu_torch.models.temporal import temporal_scorer_init  # noqa: E402
from cvml_goalnet_tpu_torch.ops.spotting_metrics import average_map, spotting_pr  # noqa: E402
from cvml_goalnet_tpu_torch.serve import DynamicBatcher, Summarizer  # noqa: E402
from cvml_goalnet_tpu_torch.spotting import encode_timeline, score_timeline, spot_events  # noqa: E402
from cvml_goalnet_tpu_torch.train.spotting import init_spotting_opt, make_spotting_train_step  # noqa: E402
from cvml_goalnet_tpu_torch.train.state import create_train_state  # noqa: E402
from cvml_goalnet_tpu_torch.weights import tree_from_jax  # noqa: E402

CLIPS = 6
CLIP_SHAPE = (12, 48, 64, 3)
TIMELINE = 120
EVENTS = (10, 47, 88)
STEPS = 250


def example_config() -> PipelineConfig:
    """The JAX example's tiny no-audio config (24×24 frames, VisBl 8/16/16, GRU width 8)."""
    return PipelineConfig(
        preprocess=PreprocessConfig(skip_frames=30, frame_size=(24, 24)),
        audio=AudioConfig(n_fft=512, hop_length=128, n_mels=40, n_mfcc=13, bin_length=12),
        model=ModelConfig(vis_channels=(8, 16, 16), vis_feature_dim=32, aud_channels=(8, 16), aud_feature_dim=16,
                          fusion_hidden=(32, 16), temporal_hidden=8, audio_included=False),
        train=TrainConfig(num_epochs=2, subbatch_size=5),
    )


def example_inputs() -> dict:
    """The seeded clips and the labelled timeline, drawn in the JAX example's order from one generator."""
    rng = np.random.default_rng(0)
    clips = [rng.integers(0, 255, CLIP_SHAPE, dtype=np.uint8) for _ in range(CLIPS)]
    events = np.array(EVENTS)
    labels = np.zeros((TIMELINE,), np.float32)
    labels[events] = 1.0
    frames = rng.random((TIMELINE, 24, 24, 3)).astype(np.float32)
    frames[events] += 0.8  # events are visually brighter
    return {"clips": clips, "events": events, "labels": labels, "frames": frames}


def main(device=None, summarizer_state=None, trunk_state=None, tparams=None) -> dict:
    """The walkthrough on ``device`` (``None``: the card; raises without one).

    ``summarizer_state``: the served trunk (default ``create_train_state(cfg.train.seed, cfg)``, as the
    ``Summarizer`` draws it); ``trunk_state``: the spotting trunk (default seed 0); ``tparams``: the GRU head
    as a numpy tree (default ``temporal_scorer_init(1, ...)``).  → the responses, the batcher's stats, the
    losses of every step, the scores, the events and their metrics.
    """
    dev = resolve_device(device)
    cfg = example_config()
    inputs = example_inputs()

    # ------------------------------------------------------------ serving
    summarizer = Summarizer(cfg, state=summarizer_state, device=dev)
    with DynamicBatcher(summarizer, max_wait_ms=200.0, buckets=(64, 128)) as batcher:
        batcher.warmup()
        with ThreadPoolExecutor(max_workers=CLIPS) as pool:
            futs = list(pool.map(lambda iv: batcher.submit(f"clip{iv[0]}", iv[1]), enumerate(inputs["clips"])))
        responses = [f.result(timeout=300) for f in futs]
        stats = dict(batcher.stats)
    for r in responses[:2]:
        print(f"[serve] {r.video_id}: {int(r.frame_mask.sum())} summary frames, {len(r.clips)} clips")
    print(f"[serve] {stats['requests']} requests in {stats['batches']} device batches (dynamic batching)")

    # ----------------------------------------------------------- spotting
    events_gt = inputs["events"]
    state = trunk_state if trunk_state is not None else create_train_state(0, cfg, device=dev)
    feats = encode_timeline(state.params, state.model_state, inputs["frames"], None, cfg, device=dev)
    if tparams is None:
        tparams = temporal_scorer_init(1, feats.shape[-1], cfg.model.temporal_hidden)
    tparams = tree_from_jax(tparams, device=dev)
    opt = init_spotting_opt(tparams)
    step = make_spotting_train_step(cfg.model.temporal_hidden, lr=1e-2, pos_weight=20.0)
    labels = torch.as_tensor(inputs["labels"], device=dev)
    losses = []
    for _ in range(STEPS):
        tparams, opt, loss = step(tparams, opt, feats, labels)
        losses.append(loss)
    losses = [float(x) for x in losses]
    print(f"[spot] final training loss: {losses[-1]:.4f}")

    with torch.no_grad():
        scores = score_timeline(tparams, feats, cfg.model.temporal_hidden).cpu().numpy()
    pred = spot_events(scores, window=5, threshold=0.0)
    p, r, f1 = spotting_pr(pred, scores[pred], events_gt, tolerance=3)
    print(f"[spot] events {pred.tolist()} vs gt {events_gt.tolist()} → P={p:.2f} R={r:.2f} F1={f1:.2f}")
    amap = average_map(pred, scores[pred], events_gt)["average_map"]
    print(f"[spot] average-mAP: {amap:.3f}")
    return {"responses": responses, "batcher_stats": stats, "features": feats, "losses": losses,
            "tparams": tparams, "scores": scores, "events": pred, "prf": (p, r, f1), "average_map": amap}


if __name__ == "__main__":
    main("cpu" if os.environ.get("GOALNET_PLATFORM", "").lower() == "cpu" else None)
