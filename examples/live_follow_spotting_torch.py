"""Live audio-visual spotting with the PyTorch port: follow footage that is still being produced.

The port's counterpart of ``examples/live_follow_spotting.py``, with its
config, seeds, segment sizes and printed lines.  On the CPU (under a minute):

    GOALNET_PLATFORM=cpu python examples/live_follow_spotting_torch.py

On the card (the kernels are built by nvcc at first use):

    python examples/live_follow_spotting_torch.py

1. a producer thread drops finalized audio+video segments into a directory
   (the ``data/follow.py`` protocol: the ``.wav`` sidecar, then
   ``<name>.npz.part`` renamed atomically; an ``END`` sentinel closes the
   stream);
2. the consumer follows the directory with :func:`follow_condensed_chunks`
   and scores an audio-included trunk through :func:`spotting.spot_stream`:
   every event prints the moment it is final, while later segments are
   still being written;
3. the streamed scores are checked against offline scoring of the final
   footage (the halo-decay bound of the emission contract).

This is the ``goalnet-torch spot --stream --follow DIR`` journey as a
library walkthrough.
"""

import os
import sys
import tempfile
import threading
import time
from collections import deque

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from cvml_goalnet_tpu_torch.config import (  # noqa: E402
    AudioConfig, ModelConfig, PipelineConfig, PreprocessConfig, TrainConfig)
from cvml_goalnet_tpu_torch.data.audio_io import load_waveform, write_wav  # noqa: E402
from cvml_goalnet_tpu_torch.data.follow import follow_condensed_chunks  # noqa: E402
from cvml_goalnet_tpu_torch.device import resolve_device  # noqa: E402
from cvml_goalnet_tpu_torch.ops.audio import extract_audio_features  # noqa: E402
from cvml_goalnet_tpu_torch.ops.preprocess import preprocess_frames_host  # noqa: E402
from cvml_goalnet_tpu_torch.spotting import encode_timeline, score_timeline_auto, spot_stream  # noqa: E402
from cvml_goalnet_tpu_torch.train.state import create_train_state  # noqa: E402
from cvml_goalnet_tpu_torch.weights import init_temporal_params, tree_from_jax  # noqa: E402

SEGMENTS = (45, 36, 39)   # raw frames per segment (uneven on purpose)
SAMPLES_PER_FRAME = 300
HALO = 24
PEAK_WINDOW = 3
MAX_DRIFT = 2e-2


def example_config() -> PipelineConfig:
    """The JAX example's tiny audio-included config (skip 3, 24×24 frames, GRU width 8)."""
    return PipelineConfig(
        preprocess=PreprocessConfig(skip_frames=3, frame_size=(24, 24)),
        audio=AudioConfig(n_fft=512, hop_length=128, n_mels=40, n_mfcc=13, bin_length=12),
        model=ModelConfig(vis_channels=(8, 16, 16), vis_feature_dim=32, aud_channels=(8, 16), aud_feature_dim=16,
                          fusion_hidden=(32, 16), temporal_hidden=8, audio_included=True),
        train=TrainConfig(num_epochs=2, subbatch_size=5),
    )


def example_segments() -> tuple[list[np.ndarray], list[np.ndarray]]:
    """The seeded raw frames and waveforms of each segment, drawn in the JAX example's order."""
    rng = np.random.default_rng(0)
    raw_parts = [rng.integers(0, 255, (m, 24, 24, 3), dtype=np.uint8) for m in SEGMENTS]
    wav_parts = [rng.standard_normal(m * SAMPLES_PER_FRAME).astype(np.float32) * 0.2 for m in SEGMENTS]
    return raw_parts, wav_parts


def producer(live_dir: str, raw_parts, wav_parts, sample_rate: int) -> None:
    for i, (part, wav) in enumerate(zip(raw_parts, wav_parts)):
        time.sleep(0.3)  # footage takes time to happen
        # the sidecar first, then the atomic rename publishes the pair
        write_wav(os.path.join(live_dir, f"{i:05d}.wav"), wav, sample_rate)
        tmp = os.path.join(live_dir, f"{i:05d}.npz.part")
        with open(tmp, "wb") as f:
            np.savez(f, frames=part)
        os.replace(tmp, os.path.join(live_dir, f"{i:05d}.npz"))
        print(f"[producer] segment {i} finalized ({len(part)} raw frames)")
    open(os.path.join(live_dir, "END"), "w").close()
    print("[producer] END sentinel written")


def main(device=None, state=None, tparams=None, live_dir: str | None = None) -> dict:
    """The walkthrough on ``device`` (``None``: the card; raises without one).

    ``state``: the trunk (default ``create_train_state(0, cfg)``); ``tparams``: the GRU head as a numpy tree
    (default ``weights.init_temporal_params(cfg.model, 48, 2)``, the port's draw of JAX's
    ``temporal_head_init_auto``); ``live_dir``: the segment directory (default a fresh temporary one).  → the
    streamed scores and events, the offline scores and their drift, and the segment directory.
    """
    dev = resolve_device(device)
    cfg = example_config()
    raw_parts, wav_parts = example_segments()
    live_dir = live_dir or tempfile.mkdtemp(prefix="goalnet_live_")

    # ------------------------------------------------------------ the consumer
    if state is None:
        state = create_train_state(0, cfg, device=dev)
    if tparams is None:
        tparams = init_temporal_params(cfg.model, cfg.model.vis_feature_dim + cfg.model.aud_feature_dim, 2)
    tparams = tree_from_jax(tparams, device=dev)

    pairs = follow_condensed_chunks(live_dir, cfg.preprocess.skip_frames, chunk=10, audio_cfg=cfg.audio,
                                    timeout=10.0, poll_interval=0.05)
    aq: deque = deque()

    def frame_chunks():
        for raw, audio in pairs:
            aq.append(audio)
            yield preprocess_frames_host(raw, cfg.preprocess.frame_size, cfg.preprocess.eps)

    def audio_chunks():
        while aq:
            yield aq.popleft()

    w = threading.Thread(target=producer, args=(live_dir, raw_parts, wav_parts, cfg.audio.sample_rate))
    w.start()
    updates = []
    try:
        for u in spot_stream(state.params, state.model_state, tparams, frame_chunks(), cfg, halo=HALO,
                             peak_window=PEAK_WINDOW, audio_chunks=audio_chunks(), device=dev):
            updates.append(u)
            for e in np.asarray(u.events).ravel():
                print(f"[consumer] event FINAL at condensed frame {int(e)} (stream still live)")
    finally:
        w.join()

    # ------------------------------------------------- the offline cross-check
    streamed = np.concatenate([u.scores for u in updates])
    raw = np.concatenate(raw_parts)
    vis = preprocess_frames_host(raw[::cfg.preprocess.skip_frames], cfg.preprocess.frame_size, cfg.preprocess.eps)
    pos, aud = 0, []
    for i, part in enumerate(raw_parts):
        n_cond = len(range((-pos) % cfg.preprocess.skip_frames, len(part), cfg.preprocess.skip_frames))
        y, _ = load_waveform(os.path.join(live_dir, f"{i:05d}.wav"), target_sr=cfg.audio.sample_rate)
        aud.append(extract_audio_features(y, n_cond, cfg.audio, dev))
        pos += len(part)
    feats = encode_timeline(state.params, state.model_state, vis, torch.cat(aud), cfg, device=dev)
    with torch.no_grad():
        offline = score_timeline_auto(tparams, feats, cfg).cpu().numpy()
    drift = float(np.abs(streamed - offline).max())
    if streamed.shape != offline.shape or not drift < MAX_DRIFT:
        raise AssertionError(f"streamed {streamed.shape} vs offline {offline.shape}: drift {drift}")
    print(f"[check] streamed {len(streamed)} condensed frames over {len(SEGMENTS)} live AV segments; max drift vs "
          f"offline {drift:.2e} (halo-decay bound)")
    print("live follow spotting: done")
    return {"streamed": streamed, "events": [np.asarray(u.events) for u in updates], "offline": offline,
            "drift": drift, "live_dir": live_dir, "updates": len(updates)}


if __name__ == "__main__":
    main("cpu" if os.environ.get("GOALNET_PLATFORM", "").lower() == "cpu" else None)
