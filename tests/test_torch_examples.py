"""PyTorch port: the three walkthroughs of ``examples/*_torch.py`` against the JAX package's, on the CPU.

The JAX examples are scripts that do their work when run, so each test repeats the JAX example's steps
through the JAX API (its config, seeds and step counts) and runs the port example's ``main("cpu", ...)``
in-process with the JAX example's initial weights carried across (``weights.from_jax`` /
``tree_from_jax``).  Tolerances (PERF.md §2):

* ``train_and_summarize``: each epoch's losses and F-scores ≤ 1e-5 relative (the training-history bound),
  the summary's mask and clips equal.  Dropout cannot draw JAX's masks and Adam at eps 1e-8 moves an
  entry by ``lr·sign(g)`` where ``g`` is rounding noise, so both sides run the example's config at dropout
  0 and Adam eps 1e-4, as ``tests/test_torch_summarization_train.py`` runs its histories;
* ``serve_and_spot``: the batcher's masks and clips equal to JAX's ``Summarizer`` on each clip; the first
  10 free-running spotting losses ≤ 1e-5 relative; the port's loss from JAX's parameters at every 25th of
  the 250 steps and at the last ≤ 1e-5 relative (past about step 100 the float32 trajectory is chaotic:
  the port's own float32 and float64 runs part by 60 % at the last step); events, P/R/F1 and average-mAP
  equal;
* ``live_follow_spotting``: the streamed scores ≤ 1e-5·max(1, max|s|) of ``spot_stream``'s emission loop
  written here (:func:`_stream_through_jax`) through JAX's encoder and scorer, over the same segment
  directory with the same weights, and the events equal.  The loop keeps the port's left context: JAX's
  own ``spot_stream`` drops some of it when halo/2 < len(tail) < halo (ROADMAP §3), so it is held to
  JAX's ``spot_stream`` only on its first two updates (the first 16 frames), at the same tolerance.

Also: importing the three examples loads neither ``jax`` nor ``cvml_goalnet_tpu`` (a subprocess), and each
example runs as its docstring says, with the banner lines ``tests/test_examples.py`` checks (``slow``, as
that file's runs are).
"""

from __future__ import annotations

import dataclasses
import importlib
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvml_goalnet_tpu.config import AudioConfig as JAudio
from cvml_goalnet_tpu.config import ModelConfig as JModel
from cvml_goalnet_tpu.config import PipelineConfig as JPipelineConfig
from cvml_goalnet_tpu.config import PreprocessConfig as JPre
from cvml_goalnet_tpu.config import TrainConfig as JTrain
from cvml_goalnet_tpu_torch import weights as W
from cvml_goalnet_tpu_torch.config import PipelineConfig
from cvml_goalnet_tpu_torch import serve as TV
from cvml_goalnet_tpu_torch.train.optim import adam_init
from cvml_goalnet_tpu_torch.train.state import TrainState

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples")
if EXAMPLES not in sys.path:
    sys.path.insert(0, EXAMPLES)


@pytest.fixture(autouse=True)
def _close_port_batchers():
    yield
    for b in list(TV._live_batchers):
        b.close()


def _example(name: str):
    return importlib.import_module(name)


def _port_state(js) -> TrainState:
    """The port's copy of a fresh JAX TrainState (Adam at step 0)."""
    params, model_state = W.from_jax(js.params, js.model_state, device="cpu")
    return TrainState(params, model_state, adam_init(params), int(js.epoch))


FORCED_EVERY = 25   # serve_and_spot: the port's loss from JAX's parameters at every 25th step and the last


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) / np.abs(want)))


# ------------------------------------------------------------------------------------------- train_and_summarize


def test_train_and_summarize_matches_jax(tmp_path):
    from cvml_goalnet_tpu.data.dataset import build_datasets
    from cvml_goalnet_tpu.data.synthetic import synthetic_dataset_dir
    from cvml_goalnet_tpu.pipeline import fuse, summarize
    from cvml_goalnet_tpu.train.loop import train_importance_model
    from cvml_goalnet_tpu.train.state import create_train_state

    ex = _example("train_and_summarize_torch")
    base = JPipelineConfig(
        preprocess=JPre(frame_size=(24, 24)),
        audio=JAudio(n_fft=512, hop_length=128, n_mels=40, n_mfcc=13, bin_length=12),
        model=JModel(vis_channels=(8, 16, 16), vis_feature_dim=32, aud_channels=(8, 16), aud_feature_dim=16,
                     fusion_hidden=(32, 16)),
        train=JTrain(num_epochs=3, subbatch_size=5),
    )
    assert ex.example_config().to_json() == base.to_json()   # the JAX example's config, field for field
    cfg = dataclasses.replace(base, model=dataclasses.replace(base.model, dropout_rate=0.0),
                              train=dataclasses.replace(base.train, eps=1e-4))

    meta = synthetic_dataset_dir(str(tmp_path / "jax" / "data"), full_n_frames=ex.RAW_FRAMES)
    train_ds, val_ds = build_datasets(meta["video_fps"], cfg, meta["annotation_fp"], meta["mat_file_path"],
                                      meta["h5_file_path"], meta["info_fp"])
    js = create_train_state(jax.random.PRNGKey(cfg.train.seed), cfg)
    best, history = train_importance_model(cfg, train_ds, val_ds, js, checkpoint_dir=str(tmp_path / "jax" / "ckpt"),
                                           num_epochs=ex.EPOCHS, verbose=False)
    item = val_ds[0]
    scores = np.asarray(fuse(best.params, best.model_state, {"visual": item.visual, "audio": item.audio}, cfg))
    res = summarize(scores, item.clip_intervals, cfg.preprocess.skip_frames, item.full_n_frames, cfg.knapsack)

    out = ex.main("cpu", state=_port_state(js), cfg=PipelineConfig.from_json(cfg.to_json()),
                  work=str(tmp_path / "port"))
    got = out["history"]
    for key in ("train_loss", "train_f_avg", "train_f_max", "val_loss", "val_f_avg", "val_f_max"):
        assert len(got[key]) == len(history[key]) == ex.EPOCHS + 1, key
        np.testing.assert_allclose(got[key], history[key], rtol=1e-5, atol=0, err_msg=key)
    assert got["best_epoch"] == history["best_epoch"]
    assert sorted(os.listdir(tmp_path / "port" / "ckpt")) == sorted(os.listdir(tmp_path / "jax" / "ckpt"))
    assert os.path.getsize(tmp_path / "port" / "curves.png") > 0
    np.testing.assert_allclose(out["scores"], scores, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(out["summary"].frame_mask, res.frame_mask)
    assert list(out["summary"].selected_clips) == list(res.selected_clips)
    np.testing.assert_array_equal(out["summary"].clip_intervals, np.asarray(res.clip_intervals))


# ------------------------------------------------------------------------------------------------ serve_and_spot


def test_serve_and_spot_matches_jax():
    from cvml_goalnet_tpu.models.temporal import temporal_scorer_init
    from cvml_goalnet_tpu.ops.spotting_metrics import average_map, spotting_pr
    from cvml_goalnet_tpu.serve import Summarizer
    from cvml_goalnet_tpu.spotting import encode_timeline, score_timeline, spot_events
    from cvml_goalnet_tpu.train.spotting import init_spotting_opt, make_spotting_train_step
    from cvml_goalnet_tpu.train.state import create_train_state
    from cvml_goalnet_tpu_torch.train.spotting import make_spotting_train_step as make_port_step

    ex = _example("serve_and_spot_torch")
    cfg = JPipelineConfig.from_json(ex.example_config().to_json())
    inputs = ex.example_inputs()

    # the JAX example's weights: the Summarizer's trunk, the spotting trunk (key 0) and the GRU head (key 1)
    served = create_train_state(jax.random.PRNGKey(cfg.train.seed), cfg)
    trunk = create_train_state(jax.random.PRNGKey(0), cfg)
    feats = encode_timeline(trunk.params, trunk.model_state, jnp.asarray(inputs["frames"]), None, cfg)
    tparams = temporal_scorer_init(jax.random.PRNGKey(1), feats.shape[-1], cfg.model.temporal_hidden)

    out = ex.main("cpu", summarizer_state=_port_state(served), trunk_state=_port_state(trunk),
                  tparams=_numpy(tparams))

    summarizer = Summarizer(cfg, state=served)
    assert out["batcher_stats"]["requests"] == ex.CLIPS
    for i, (clip, got) in enumerate(zip(inputs["clips"], out["responses"])):
        want = summarizer.summarize_frames(f"clip{i}", clip)
        assert got.video_id == want.video_id
        np.testing.assert_allclose(got.scores, np.asarray(want.scores), rtol=0, atol=1e-5)
        np.testing.assert_array_equal(got.frame_mask, want.frame_mask)
        np.testing.assert_array_equal(np.asarray(got.clips), np.asarray(want.clips))

    np.testing.assert_allclose(out["features"].numpy(), np.asarray(feats), rtol=0,
                               atol=1e-5 * max(1.0, float(np.abs(feats).max())))
    opt = init_spotting_opt(tparams)
    step = make_spotting_train_step(cfg.model.temporal_hidden, lr=1e-2, pos_weight=20.0)
    labels = jnp.asarray(inputs["labels"])
    losses, visited = [], {}
    for k in range(ex.STEPS):
        if k % FORCED_EVERY == 0 or k == ex.STEPS - 1:
            visited[k] = _numpy(tparams)
        tparams, opt, loss = step(tparams, opt, feats, labels)
        losses.append(loss)
    losses = [float(x) for x in losses]
    assert len(out["losses"]) == len(losses) == ex.STEPS
    assert _rel(out["losses"][:10], losses[:10]) <= 1e-5
    # Past about step 100 the trajectory is chaotic in float32: the port's float32 and float64 runs of these
    # steps part by more than 1e-3 relative at step 119 and by 60 % at the last, so no float32 run holds JAX's
    # last loss to 1e-3.  The port's step is held instead from JAX's own parameters along the whole trajectory.
    port_step = make_port_step(cfg.model.temporal_hidden, lr=1e-2, pos_weight=20.0)
    tfeats, tlabels = torch.as_tensor(np.array(feats)), torch.as_tensor(inputs["labels"])
    for k, p in visited.items():
        loss, _ = port_step.value_and_grad(W.tree_from_jax(p, device="cpu"), tfeats, tlabels)
        assert _rel(float(loss), losses[k]) <= 1e-5, k

    scores = np.asarray(score_timeline(tparams, feats, cfg.model.temporal_hidden))
    pred = spot_events(scores, window=5, threshold=0.0)
    np.testing.assert_array_equal(out["events"], pred)
    assert out["prf"] == spotting_pr(pred, scores[pred], inputs["events"], tolerance=3)
    assert out["average_map"] == average_map(pred, scores[pred], inputs["events"])["average_map"]


# ------------------------------------------------------------------------------------------ live_follow_spotting


def _stream_through_jax(state, tparams, chunks, cfg, halo: int) -> np.ndarray:
    """The streamed scores of ``spot_stream``'s emission loop over ``chunks`` = [(frames, audio)], each window
    encoded and scored through the JAX API, keeping the last ``min(halo, len(tail))`` emitted frames as left
    context (ROADMAP §3: JAX's own loop keeps ``tail[len(tail) - halo:]``, which drops frames when
    halo/2 < len(tail) < halo, as this stream's second emission has)."""
    from cvml_goalnet_tpu.models.temporal import temporal_scorer_apply
    from cvml_goalnet_tpu.ops.preprocess import preprocess_frames_host
    from cvml_goalnet_tpu.spotting import encode_timeline

    hidden = cfg.model.temporal_hidden
    score = lambda f: np.asarray(temporal_scorer_apply(tparams, jnp.asarray(f), hidden))   # noqa: E731
    left = buf = None
    out = []
    for i, (raw, aud) in enumerate(chunks):
        vis = preprocess_frames_host(raw, cfg.preprocess.frame_size, cfg.preprocess.eps)
        feats = np.asarray(encode_timeline(state.params, state.model_state, jnp.asarray(vis), jnp.asarray(aud), cfg))
        buf = feats if buf is None else np.concatenate([buf, feats])
        left = feats[:0] if left is None else left
        emit_n = len(buf) - halo
        if i == 0 or emit_n <= 0:
            continue
        out.append(score(np.concatenate([left, buf]))[len(left):len(left) + emit_n])
        tail = np.concatenate([left, buf[:emit_n]])
        left, buf = tail[max(len(tail) - halo, 0):], buf[emit_n:]
    out.append(score(np.concatenate([left, buf]))[len(left):])
    return np.concatenate(out)


def test_live_follow_spotting_matches_jax(tmp_path):
    from cvml_goalnet_tpu.data.follow import follow_condensed_chunks
    from cvml_goalnet_tpu.spotting import spot_events, spot_stream, temporal_head_init_auto
    from cvml_goalnet_tpu.train.state import create_train_state

    ex = _example("live_follow_spotting_torch")
    cfg = JPipelineConfig.from_json(ex.example_config().to_json())
    state = create_train_state(jax.random.PRNGKey(0), cfg)
    tparams = temporal_head_init_auto(jax.random.PRNGKey(2), cfg.model.vis_feature_dim + cfg.model.aud_feature_dim,
                                      cfg.model)
    p, ms = W.from_jax(state.params, state.model_state, device="cpu")
    out = ex.main("cpu", state=TrainState(p, ms, adam_init(p), 0), tparams=_numpy(tparams),
                  live_dir=str(tmp_path))

    # JAX's follower over the same directory, now complete: its chunks of 10 cut across segments as they did live
    chunks = list(follow_condensed_chunks(str(tmp_path), cfg.preprocess.skip_frames, chunk=10, audio_cfg=cfg.audio,
                                          timeout=10.0, poll_interval=0.05))
    want = _stream_through_jax(state, tparams, chunks, cfg, ex.HALO)
    assert out["streamed"].shape == want.shape == (sum(ex.SEGMENTS) // cfg.preprocess.skip_frames,)
    np.testing.assert_allclose(out["streamed"], want, rtol=0, atol=1e-5 * max(1.0, float(np.abs(want).max())))
    # the streamed events are the peaks of the streamed scores (the emission contract)
    np.testing.assert_array_equal(np.sort(np.concatenate(out["events"])), spot_events(want, window=ex.PEAK_WINDOW))

    # JAX's own spot_stream: the same updates, and the same scores up to the first emission that drops context
    from cvml_goalnet_tpu.ops.preprocess import preprocess_frames_host

    audio = [a for _, a in chunks]
    updates = list(spot_stream(state.params, state.model_state, tparams,
                               (preprocess_frames_host(f, cfg.preprocess.frame_size, cfg.preprocess.eps)
                                for f, _ in chunks), cfg, halo=ex.HALO, peak_window=ex.PEAK_WINDOW,
                               audio_chunks=audio))
    assert [len(u.scores) for u in updates] == [6, 10, 24] and out["updates"] == len(updates)
    np.testing.assert_allclose(out["streamed"][:16], np.concatenate([u.scores for u in updates[:2]]), rtol=0,
                               atol=1e-5 * max(1.0, float(np.abs(want).max())))
    assert out["drift"] < ex.MAX_DRIFT


# --------------------------------------------------------------------------------------------- imports and runs


def test_examples_import_neither_jax_nor_the_jax_package():
    code = ("import sys; sys.path.insert(0, 'examples'); import train_and_summarize_torch, serve_and_spot_torch, "
            "live_follow_spotting_torch; "
            "bad = [m for m in sys.modules if m in ('jax', 'cvml_goalnet_tpu') or m.startswith(('jax.', "
            "'cvml_goalnet_tpu.'))]; assert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("name", ["train_and_summarize_torch", "serve_and_spot_torch", "live_follow_spotting_torch"])
def test_main_needs_a_card_or_the_cpu(name, monkeypatch):
    """With no card and no ``device="cpu"`` the entry point raises before any work."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _example(name).main()


def _run_example(name: str, timeout: int = 900) -> str:
    env = dict(os.environ, GOALNET_PLATFORM="cpu")
    proc = subprocess.run([sys.executable, os.path.join(EXAMPLES, name)], capture_output=True, text=True,
                          timeout=timeout, env=env, cwd=REPO)
    assert proc.returncode == 0, f"{name} failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
    return proc.stdout


@pytest.mark.slow
def test_train_and_summarize_example_runs():
    out = _run_example("train_and_summarize_torch.py")
    assert "summary:" in out and "artifacts in" in out


@pytest.mark.slow
def test_serve_and_spot_example_runs():
    out = _run_example("serve_and_spot_torch.py")
    assert "dynamic batching" in out and "average-mAP" in out


@pytest.mark.slow
def test_live_follow_spotting_example_runs():
    out = _run_example("live_follow_spotting_torch.py")
    assert "segment 0 finalized" in out and "live follow spotting: done" in out
