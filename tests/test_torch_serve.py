"""PyTorch port: the serving services against the JAX package's, on the CPU.

``Summarizer``, ``Spotter``, ``DynamicBatcher`` and ``ServerMetrics`` of
``cvml_goalnet_tpu_torch/serve.py`` with ``device="cpu"`` beside those of
``cvml_goalnet_tpu/serve.py``, on the suite's ``small_cfg``, the same trunk
(the JAX package's state, carried over with ``weights.from_jax``) and the
same temporal heads (the JAX package's ``temporal_head_init_auto``, carried
over with ``weights.tree_from_jax``).  Tolerances are those of the port's
tests of the functions underneath: scores within 1e-4 of the JAX package's
(``test_torch_pipeline.py``'s for ``fuse``, ``test_torch_spotting.py``'s where
the trunk feeds the temporal head); masks, clips, events and counts exact.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from concurrent.futures import Future

import jax
import numpy as np
import pytest

import cvml_goalnet_tpu.serve as JV
from cvml_goalnet_tpu.spotting import temporal_head_init_auto
from cvml_goalnet_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from cvml_goalnet_tpu.train.state import create_train_state as jax_train_state
import cvml_goalnet_tpu_torch.serve as TV
from cvml_goalnet_tpu_torch import weights as W
from cvml_goalnet_tpu_torch.config import PipelineConfig
from cvml_goalnet_tpu_torch.data.audio_io import write_wav
from cvml_goalnet_tpu_torch.data.dataset import uniform_clip_intervals
from cvml_goalnet_tpu_torch.ops.audio import extract_audio_features
from cvml_goalnet_tpu_torch.train.state import TrainState

CPU = "cpu"
RAW = (32, 40)


@pytest.fixture(autouse=True)
def _close_port_batchers():
    """Close every batcher of the port a test left open (the suite's conftest closes only the JAX package's)."""
    yield
    for b in list(TV._live_batchers):
        b.close()


def _jcfg(small_cfg, audio=True, **model):
    return dataclasses.replace(small_cfg, model=dataclasses.replace(small_cfg.model, audio_included=audio, **model))


def _port(jcfg) -> PipelineConfig:
    return PipelineConfig.from_json(jcfg.to_json())


def _port_state(jstate) -> TrainState:
    params, model_state = W.from_jax(jstate.params, jstate.model_state, device=CPU)
    return TrainState(params=params, model_state=model_state, opt_state=None, epoch=0)


@pytest.fixture(scope="module")
def trunks(small_cfg):
    """The JAX state of the audio and the no-audio trunk, and the port's of each."""
    out = {}
    for audio in (True, False):
        js = jax_train_state(jax.random.PRNGKey(11 + audio), _jcfg(small_cfg, audio))
        out[audio] = (js, _port_state(js))
    return out


def _frames(n, seed=0):
    return np.random.default_rng(seed).integers(0, 255, (n, *RAW, 3), dtype=np.uint8)


def _wave(n, cfg, seed=0):
    return np.random.default_rng(seed).uniform(-0.5, 0.5, n * cfg.audio.sample_rate).astype(np.float32)


def _services(small_cfg, trunks, audio=True, **model):
    jcfg = _jcfg(small_cfg, audio, **model)
    js, ts = trunks[audio]
    return jcfg, JV.Summarizer(jcfg, state=js), TV.Summarizer(_port(jcfg), state=ts, device=CPU)


def _assert_summaries(got, want):
    assert got.video_id == want.video_id
    assert got.scores.shape == want.scores.shape
    np.testing.assert_allclose(got.scores, np.asarray(want.scores), atol=1e-4)
    np.testing.assert_array_equal(got.frame_mask, want.frame_mask)
    np.testing.assert_array_equal(got.clips, want.clips)


class TestSummarizer:
    @pytest.mark.parametrize("audio,waveform", [(True, True), (True, False), (False, False)])
    def test_summarize_frames_matches_jax(self, small_cfg, trunks, audio, waveform):
        jcfg, js, ts = _services(small_cfg, trunks, audio)
        frames = _frames(12, seed=1)
        wave = _wave(12, jcfg) if waveform else None
        _assert_summaries(ts.summarize_frames("v", frames, waveform=wave),
                          js.summarize_frames("v", frames, waveform=wave))

    def test_summarize_path_matches_jax(self, small_cfg, trunks, tmp_path):
        jcfg, js, ts = _services(small_cfg, trunks, True)
        raw = _frames(330, seed=2)
        fp = str(tmp_path / "clip.npz")
        np.savez(fp, frames=raw)
        write_wav(str(tmp_path / "clip.wav"), _wave(11, jcfg, seed=3), jcfg.audio.sample_rate)
        got, want = ts.summarize_path(fp), js.summarize_path(fp)
        _assert_summaries(got, want)
        assert got.frame_mask.shape == (330,)
        # the sidecar is read: without it the scores differ
        os.remove(str(tmp_path / "clip.wav"))
        assert not np.allclose(ts.summarize_path(fp).scores, got.scores, atol=1e-4)

    @pytest.mark.parametrize("full_n", [1, 29, 30, 330, 4500, 10_001])
    @pytest.mark.parametrize("ratio", [0.005, 0.15, 0.5])
    def test_uniform_clips_are_the_jax_fallback(self, small_cfg, full_n, ratio):
        jcfg = dataclasses.replace(small_cfg, knapsack=dataclasses.replace(small_cfg.knapsack, summary_ratio=ratio))
        np.testing.assert_array_equal(uniform_clip_intervals(_port(jcfg), full_n),
                                      JV._uniform_clip_intervals(jcfg, full_n))

    def test_store_change_points_are_used(self, small_cfg, trunks):
        class Store:
            def change_points(self, video_id):
                return np.array([[0, 90], [90, 200], [200, 360]])

        jcfg, _, _ = _services(small_cfg, trunks, False)
        js = JV.Summarizer(jcfg, state=trunks[False][0], store=Store())
        ts = TV.Summarizer(_port(jcfg), state=trunks[False][1], store=Store(), device=CPU)
        frames = _frames(12, seed=4)
        _assert_summaries(ts.summarize_frames("v", frames), js.summarize_frames("v", frames))

    def test_warmup_and_fresh_state(self, small_cfg):
        ts = TV.Summarizer(_port(_jcfg(small_cfg, False)), device=CPU)
        ts.warmup(((3, 24, 24),))
        assert ts.summarize_frames("v", _frames(3)).scores.shape == (3,)

    def test_unported_options_raise_naming_their_item(self, small_cfg, trunks):
        """Every option now serves: a mesh (the port's CPU mesh of 2 entries against the JAX package's 2
        virtual devices; more in test_torch_dp.py), and trunks of the vit and resnet backbones, as the JAX
        package serves them (scores within 1e-4, masks and events equal; more in test_torch_backbones.py), and
        trunks with the text branch and the MoE fusion (held to the JAX package in TestCommentary)."""
        from cvml_goalnet_tpu.parallel.serving import serving_mesh as jax_serving_mesh
        from cvml_goalnet_tpu_torch.parallel.mesh import serving_mesh

        jcfg = _jcfg(small_cfg, False)
        cfg = _port(jcfg)
        js, ts = trunks[False]
        frames = _frames(9, seed=5)
        mesh, jmesh = serving_mesh(2, device=CPU), jax_serving_mesh(2)
        _assert_summaries(TV.Summarizer(cfg, state=ts, device=CPU, mesh=mesh).summarize_frames("m", frames),
                          JV.Summarizer(jcfg, state=js, mesh=jmesh).summarize_frames("m", frames))
        jspot, tspot = JV.Spotter(jcfg, state=js, mesh=jmesh), TV.Spotter(cfg, state=ts, device=CPU, mesh=mesh)
        head = _jax_head(jcfg, 5, 1)
        jspot.temporal_params, tspot.temporal_params = head, W.tree_from_jax(head, device=CPU)
        got, want = tspot.spot_frames("m", frames, peak_window=3), jspot.spot_frames("m", frames, peak_window=3)
        np.testing.assert_allclose(got.scores, np.asarray(want.scores), atol=1e-4)
        _assert_events(got.events, want.events)
        for backbone in ("vit", "resnet"):
            jcfg = _jcfg(small_cfg, False, vis_backbone=backbone, vit_embed_dim=16, vit_depth=2, vit_num_heads=2)
            js = jax_train_state(jax.random.PRNGKey(7), jcfg)
            frames = _frames(9, seed=3)
            _assert_summaries(TV.Summarizer(_port(jcfg), state=_port_state(js), device=CPU).summarize_frames(
                "b", frames), JV.Summarizer(jcfg, state=js).summarize_frames("b", frames))
            jspot, tspot = JV.Spotter(jcfg, state=js), TV.Spotter(_port(jcfg), state=_port_state(js), device=CPU)
            head = _jax_head(jcfg, 5, 1)
            jspot.temporal_params, tspot.temporal_params = head, W.tree_from_jax(head, device=CPU)
            got, want = tspot.spot_frames("m", frames, peak_window=3), jspot.spot_frames("m", frames, peak_window=3)
            np.testing.assert_allclose(got.scores, np.asarray(want.scores), atol=1e-4)
            _assert_events(got.events, want.events)
        text = _port(_jcfg(small_cfg, False, text_included=True, fusion_moe_experts=4))
        assert TV.Summarizer(text, device=CPU).summarize_frames("t", _frames(3)).scores.shape == (3,)
        assert TV.Spotter(text, device=CPU).spot_frames("t", _frames(3)).scores.shape == (3,)

    def test_without_a_card_the_service_raises(self, small_cfg, monkeypatch):
        import torch

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TV.Summarizer(_port(_jcfg(small_cfg, False)))


class TestZeroFrames:
    def test_zero_frames_with_audio(self, small_cfg, trunks):
        """A 0-frame request with a waveform answers as one without: empty scores and mask.  The JAX package
        divides by zero in its slot arithmetic there; the port does not copy that."""
        jcfg, js, ts = _services(small_cfg, trunks, True)
        empty, wave = _frames(0), _wave(2, jcfg)
        got = ts.summarize_frames("e", empty, waveform=wave)
        assert got.scores.shape == (0,) and got.frame_mask.shape == (0,)
        bare = ts.summarize_frames("e", empty)
        assert bare.scores.shape == (0,) and bare.frame_mask.shape == (0,)
        feats = extract_audio_features(wave, 0, _port(jcfg).audio, CPU)
        assert tuple(feats.shape) == (0, jcfg.audio.bin_length, jcfg.audio.n_mfcc)
        with pytest.raises(ZeroDivisionError):
            js.summarize_frames("e", empty, waveform=wave)
        want = js.summarize_frames("e", empty)
        assert want.scores.shape == (0,) and want.frame_mask.shape == (0,)

    @pytest.mark.parametrize("scorer", ["gru", "transformer", "hybrid"])
    def test_zero_frame_spotter_raises_as_jax(self, small_cfg, trunks, scorer):
        """A 0-frame ``spot_frames`` raises JAX's ``ValueError`` (``scores_to_importance`` takes the minimum of
        no scores) in both packages, for every head: the port keeps the reference's behaviour and adds no
        empty answer of its own."""
        _, js, ts = _spotters(small_cfg, trunks, scorer)
        for spotter in (js, ts):
            with pytest.raises(ValueError, match="zero-size array"):
                spotter.spot_frames("e", _frames(0))


def _jax_head(jcfg, seed, n_classes):
    d = jcfg.model.vis_feature_dim + (jcfg.model.aud_feature_dim if jcfg.model.audio_included else 0)
    return temporal_head_init_auto(jax.random.PRNGKey(seed), d, jcfg.model, n_classes=n_classes)


SCORERS = {
    "gru": {},
    "transformer": {"temporal_model": "transformer", "temporal_num_heads": 2, "temporal_window": 4},
    "hybrid": {"temporal_model": "hybrid", "temporal_num_heads": 2, "temporal_window": 4},
}


def _spotters(small_cfg, trunks, scorer="gru", audio=False, classes=None, seed=5):
    jcfg = _jcfg(small_cfg, audio, **SCORERS[scorer])
    js_state, ts_state = trunks[audio]
    js = JV.Spotter(jcfg, state=js_state, classes=classes)
    ts = TV.Spotter(_port(jcfg), state=ts_state, classes=classes, device=CPU)
    head = _jax_head(jcfg, seed, len(classes) if classes else 1)
    js.temporal_params = head
    ts.temporal_params = W.tree_from_jax(head, device=CPU)
    return jcfg, js, ts


def _assert_events(got, want):
    if isinstance(want, dict):
        assert list(got) == list(want)
        for c in want:
            np.testing.assert_array_equal(got[c], want[c])
    else:
        np.testing.assert_array_equal(got, want)


class TestSpotter:
    @pytest.mark.parametrize("scorer", list(SCORERS))
    @pytest.mark.parametrize("classes", [None, ["goal", "card"]])
    def test_spot_frames_matches_jax(self, small_cfg, trunks, scorer, classes):
        jcfg, js, ts = _spotters(small_cfg, trunks, scorer, classes=classes)
        frames = _frames(40, seed=6)
        got, want = ts.spot_frames("m", frames, peak_window=3), js.spot_frames("m", frames, peak_window=3)
        np.testing.assert_allclose(got.scores, np.asarray(want.scores), atol=1e-4)
        _assert_events(got.events, want.events)
        np.testing.assert_array_equal(got.summary_clips, want.summary_clips)
        assert got.summary_frames == want.summary_frames

    def test_spot_frames_with_audio_matches_jax(self, small_cfg, trunks):
        jcfg, js, ts = _spotters(small_cfg, trunks, "transformer", audio=True)
        frames, wave = _frames(30, seed=7), _wave(30, jcfg, seed=7)
        got, want = ts.spot_frames("m", frames, waveform=wave), js.spot_frames("m", frames, waveform=wave)
        np.testing.assert_allclose(got.scores, np.asarray(want.scores), atol=1e-4)
        _assert_events(got.events, want.events)

    def test_spot_path_and_seeded_head(self, small_cfg, trunks, tmp_path):
        """``spot_path`` reports no fps for an npz archive; the default head is ``init_temporal_params``'
        seed-1 draw, as ``spot`` builds it."""
        jcfg, _, ts = _spotters(small_cfg, trunks, "gru")
        fp = str(tmp_path / "m.npz")
        np.savez(fp, frames=_frames(600, seed=8))
        fresh = TV.Spotter(_port(jcfg), state=trunks[False][1], device=CPU)
        want = W.init_temporal_params(_port(jcfg).model, jcfg.model.vis_feature_dim, seed=1)
        np.testing.assert_array_equal(fresh.temporal_params["head"]["w"].numpy(), want["head"]["w"])
        resp = ts.spot_path(fp)
        assert resp.fps is None and resp.video_id == "m" and resp.scores.shape == (20,)

    def test_spot_stream_path_on_a_file_matches_jax(self, small_cfg, trunks, tmp_path):
        _, js, ts = _spotters(small_cfg, trunks, "transformer")
        fp = str(tmp_path / "live.npz")
        np.savez(fp, frames=_frames(40 * 30, seed=9))
        kw = dict(chunk=16, halo=8, peak_window=3)
        got, want = list(ts.spot_stream_path(fp, **kw)), list(js.spot_stream_path(fp, **kw))
        assert len(got) == len(want) > 1
        for g, w_ in zip(got, want):
            np.testing.assert_allclose(g.scores, np.asarray(w_.scores), atol=1e-4)
            _assert_events(g.events, w_.events)

    def test_spot_stream_path_follows_a_directory_with_audio(self, small_cfg, trunks, tmp_path):
        jcfg, js, ts = _spotters(small_cfg, trunks, "transformer", audio=True)
        d = tmp_path / "live"
        d.mkdir()
        for i, n in enumerate((400, 350, 260)):
            np.savez(str(d / f"{i:05d}.npz"), frames=_frames(n, seed=10 + i))
            write_wav(str(d / f"{i:05d}.wav"), _wave(1, jcfg, seed=i)[: n * jcfg.audio.sample_rate // 30],
                      jcfg.audio.sample_rate)
        (d / "END").touch()
        kw = dict(chunk=8, halo=4, peak_window=3, follow=True, follow_timeout=10)
        got, want = list(ts.spot_stream_path(str(d), **kw)), list(js.spot_stream_path(str(d), **kw))
        assert len(got) == len(want) > 1
        assert sum(len(u.scores) for u in got) == len(range(0, 1010, 30))
        for g, w_ in zip(got, want):
            np.testing.assert_allclose(g.scores, np.asarray(w_.scores), atol=1e-4)
            _assert_events(g.events, w_.events)

    def test_spot_stream_path_refuses_eagerly(self, small_cfg, trunks, tmp_path):
        """Each contract violation raises when the call is made, before a generator runs (what turns it into
        a 400 before any byte streams)."""
        fp = str(tmp_path / "x.npz")
        np.savez(fp, frames=_frames(60))
        _, _, audio = _spotters(small_cfg, trunks, "gru", audio=True)
        with pytest.raises(ValueError, match="follow mode"):
            audio.spot_stream_path(fp)
        _, _, full = _spotters(small_cfg, trunks, "transformer")
        full.cfg = dataclasses.replace(full.cfg, model=dataclasses.replace(full.cfg.model, temporal_window=0))
        with pytest.raises(ValueError, match="banded attention window"):
            full.spot_stream_path(fp)
        _, _, gru = _spotters(small_cfg, trunks, "gru")
        with pytest.raises(ValueError, match="chunk must be"):
            gru.spot_stream_path(fp, chunk=0)
        with pytest.raises(ValueError, match="chunk must be"):
            gru.spot_stream_path(fp, halo=-1)
        with pytest.raises(ValueError, match="segment DIRECTORY"):
            gru.spot_stream_path(fp, follow=True)


def _write_trunk(directory, jcfg, seed):
    js = jax_train_state(jax.random.PRNGKey(seed), jcfg)
    jax_save_checkpoint(str(directory), js, jcfg, tag="opt")
    return js


class TestReload:
    def test_summarizer_reload_swaps_and_survives_a_corrupt_checkpoint(self, small_cfg, tmp_path):
        jcfg = _jcfg(small_cfg, False)
        ckp = tmp_path / "ckp"
        _write_trunk(ckp, jcfg, 1)
        ts = TV.Summarizer(_port(jcfg), checkpoint_dir=str(ckp), device=CPU)
        frames = _frames(6, seed=11)
        before = ts.summarize_frames("v", frames).scores
        new = _write_trunk(ckp, jcfg, 2)
        assert ts.reload() == 1
        after = ts.summarize_frames("v", frames)
        _assert_summaries(after, JV.Summarizer(jcfg, state=new).summarize_frames("v", frames))
        assert not np.allclose(before, after.scores, atol=1e-4)
        (ckp / "opt_state.npz").write_bytes(b"not an npz")
        with pytest.raises(Exception):
            ts.reload()
        assert ts.reload_count == 1
        np.testing.assert_array_equal(ts.summarize_frames("v", frames).scores, after.scores)

    def test_in_memory_summarizer_is_not_reloadable(self, small_cfg, trunks):
        _, _, ts = _services(small_cfg, trunks, False)
        with pytest.raises(ValueError, match="in-memory"):
            ts.reload()
        calls = []
        ts._reloader = lambda: calls.append(1) or trunks[False][1]
        assert ts.reload() == 1 and calls == [1]

    def test_spotter_reload_keeps_an_in_memory_head(self, small_cfg, trunks):
        jcfg, _, ts = _spotters(small_cfg, trunks, "gru")
        with pytest.raises(ValueError, match="in-memory"):
            ts.reload()
        head = ts.temporal_params
        ts._reloader = lambda: trunks[False][1]
        assert ts.reload() == 1
        assert ts.temporal_params is head

    def test_spotter_reload_rebuilds_the_head_from_its_file(self, small_cfg, trunks, tmp_path):
        from cvml_goalnet_tpu.train.spotting import save_spotting_checkpoint

        jcfg = _jcfg(small_cfg, False)
        fp = str(tmp_path / "head.npz")
        save_spotting_checkpoint(fp, _jax_head(jcfg, 3, 1))
        ts = TV.Spotter(_port(jcfg), state=trunks[False][1], temporal_checkpoint=fp, device=CPU)
        np.testing.assert_array_equal(ts.temporal_params["head"]["w"].numpy(),
                                      np.asarray(_jax_head(jcfg, 3, 1)["head"]["w"]))
        save_spotting_checkpoint(fp, _jax_head(jcfg, 4, 1))
        assert ts.reload() == 1
        np.testing.assert_array_equal(ts.temporal_params["head"]["w"].numpy(),
                                      np.asarray(_jax_head(jcfg, 4, 1)["head"]["w"]))


def _batched(small_cfg, trunks, audio=False, **kw):
    jcfg, js, ts = _services(small_cfg, trunks, audio)
    return jcfg, js, ts, TV.DynamicBatcher(ts, **kw)


class TestDynamicBatcher:
    @pytest.mark.parametrize("audio", [False, True])
    def test_batched_equals_unbatched_and_jax(self, small_cfg, trunks, audio):
        jcfg, js, ts, batcher = _batched(small_cfg, trunks, audio, max_batch_frames=64, max_wait_ms=500.0,
                                         buckets=(16, 32, 64))
        batcher.warmup()
        reqs = [_frames(n, seed=20 + n) for n in (10, 7, 16, 5)]
        waves = [_wave(len(r), jcfg, seed=i) if audio and i % 2 == 0 else None for i, r in enumerate(reqs)]
        wants = [ts.summarize_frames(f"v{i}", fr, waveform=w_) for i, (fr, w_) in enumerate(zip(reqs, waves))]
        futs = [batcher.submit(f"v{i}", fr, waveform=w_) for i, (fr, w_) in enumerate(zip(reqs, waves))]
        got = [f.result(timeout=120) for f in futs]
        for g, w_ in zip(got, wants):
            np.testing.assert_allclose(g.scores, w_.scores, atol=1e-4)
            np.testing.assert_array_equal(g.frame_mask, w_.frame_mask)
        assert batcher.stats["requests"] == 4 and batcher.stats["batches"] < 4
        assert batcher.stats["batched_frames"] == sum(len(r) for r in reqs)
        with JV.DynamicBatcher(js, max_batch_frames=64, max_wait_ms=500.0, buckets=(16, 32, 64)) as jb:
            jfuts = [jb.submit(f"v{i}", fr, waveform=w_) for i, (fr, w_) in enumerate(zip(reqs, waves))]
            for g, f in zip(got, jfuts):
                _assert_summaries(g, f.result(timeout=120))

    def test_empty_rider_answers_as_unbatched(self, small_cfg, trunks):
        jcfg, _, ts, batcher = _batched(small_cfg, trunks, True, max_batch_frames=64, max_wait_ms=20.0,
                                        buckets=(64,))
        empty = _frames(0)
        want = ts.summarize_frames("e", empty)
        for wave in (None, _wave(1, jcfg)):
            got = batcher.submit("e", empty, waveform=wave).result(timeout=120)
            assert got.scores.shape == want.scores.shape == (0,)
            assert got.frame_mask.shape == want.frame_mask.shape == (0,)
        assert batcher.submit("v", _frames(4)).result(timeout=120).scores.shape == (4,)

    def test_worker_survives_a_bad_rider_and_an_oversized_request(self, small_cfg, trunks):
        _, _, ts, batcher = _batched(small_cfg, trunks, False, max_batch_frames=4096, max_wait_ms=30.0,
                                     buckets=(16, 32))
        rng = np.random.default_rng(2)
        bad = batcher.submit("bad", rng.integers(0, 255, (4, 24, 24, 1), dtype=np.uint8))   # one channel
        with pytest.raises(Exception):
            bad.result(timeout=120)
        evil: Future = Future()
        batcher._q.put(("evil", {"visual": np.zeros((4, 3, 3, 3), np.float32), "audio": None, "text": None},
                        None, None, 4, evil))
        with pytest.raises(Exception):
            evil.result(timeout=60)
        good = _frames(10, seed=3)
        np.testing.assert_allclose(batcher.submit("g", good).result(timeout=120).scores,
                                   ts.summarize_frames("g", good).scores, atol=1e-4)
        big = _frames(70, seed=4)   # past the largest bucket: scored in chunks of 32
        got, want = batcher.submit("big", big).result(timeout=120), ts.summarize_frames("big", big)
        np.testing.assert_allclose(got.scores, want.scores, atol=1e-4)
        np.testing.assert_array_equal(got.frame_mask, want.frame_mask)

    def test_one_error_fails_every_rider(self, small_cfg, trunks):
        _, _, ts, batcher = _batched(small_cfg, trunks, False, max_wait_ms=200.0, buckets=(64,))
        ts.state = None   # fuse raises for the whole batch
        futs = [batcher.submit(f"x{i}", _frames(4, seed=i)) for i in range(3)]
        for f in futs:
            with pytest.raises(Exception):
                f.result(timeout=60)
        ts.state = trunks[False][1]
        assert batcher.submit("ok", _frames(4)).result(timeout=60).scores.shape == (4,)

    def test_no_overshoot_carries_the_next_request(self, small_cfg, trunks):
        _, _, ts, batcher = _batched(small_cfg, trunks, False, max_batch_frames=16, max_wait_ms=300.0,
                                     buckets=(16,))
        sizes = []
        real = batcher._process

        def spy(batch, total):
            sizes.append(total)
            real(batch, total)

        batcher._process = spy
        futs = [batcher.submit(f"r{i}", _frames(n, seed=i)) for i, n in enumerate((10, 10, 6))]
        for f in futs:
            f.result(timeout=60)
        assert max(sizes) <= 16 and sum(sizes) == 26

    def test_close_drains_and_serves_pending(self, small_cfg, trunks):
        _, _, ts, batcher = _batched(small_cfg, trunks, False, max_wait_ms=20.0, buckets=(64,))
        frames = _frames(6, seed=2)
        want = ts.summarize_frames("w", frames)
        fut = batcher.submit("w", frames)
        batcher.close()
        np.testing.assert_allclose(fut.result(timeout=120).scores, want.scores, atol=1e-4)
        assert not batcher._worker.is_alive()
        with pytest.raises(RuntimeError, match="closed"):
            batcher.submit("late", frames)
        batcher.close()  # idempotent

    def test_close_waits_for_a_slow_worker(self, small_cfg, trunks, monkeypatch):
        _, _, ts, batcher = _batched(small_cfg, trunks, False, max_wait_ms=20.0, buckets=(64,))
        real = batcher._process

        def slow(batch, total):
            time.sleep(0.8)   # longer than the close timeout below
            real(batch, total)

        monkeypatch.setattr(batcher, "_process", slow)
        frames = _frames(6, seed=3)
        want = ts.summarize_frames("w", frames)
        fut = batcher.submit("w", frames)
        batcher.close(timeout=0.1)
        assert not batcher._worker.is_alive()
        np.testing.assert_allclose(fut.result(timeout=1).scores, want.scores, atol=1e-4)

    def test_submit_close_race_never_strands_a_future(self, small_cfg, trunks):
        _, _, ts, _ = _batched(small_cfg, trunks, False, max_wait_ms=5.0, buckets=(64,))
        frames = _frames(4, seed=4)
        for _ in range(3):
            batcher = TV.DynamicBatcher(ts, max_wait_ms=5.0, buckets=(64,))
            outcomes = [None] * 8
            start = threading.Barrier(9)

            def worker(i):
                start.wait()
                try:
                    outcomes[i] = ("fut", batcher.submit(f"r{i}", frames))
                except RuntimeError:
                    outcomes[i] = ("closed", None)

            threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
            for t in threads:
                t.start()
            start.wait()
            batcher.close()
            for t in threads:
                t.join(timeout=30)
            assert not batcher._worker.is_alive()
            for kind, fut in outcomes:
                assert kind in ("fut", "closed")
                if kind == "fut":
                    assert fut.result(timeout=60).scores is not None

    def test_context_manager_closes_and_registry_holds_it(self, small_cfg, trunks):
        _, _, ts, _ = _batched(small_cfg, trunks, False, buckets=(64,))
        with TV.DynamicBatcher(ts, max_wait_ms=20.0, buckets=(64,)) as batcher:
            assert batcher in TV._live_batchers
        assert batcher._closed and not batcher._worker.is_alive()

    def test_buckets(self, small_cfg, trunks):
        _, _, _, batcher = _batched(small_cfg, trunks, False, buckets=(512, 256))
        assert batcher.buckets == (256, 512)
        assert [batcher._bucket(n) for n in (1, 256, 257, 512, 9000)] == [256, 256, 512, 512, 512]


class TestServerMetrics:
    def test_snapshot_matches_jax(self):
        samples = [("/summarize", 0.010 * i, i % 4 == 0) for i in range(1, 30)] + [("/spot", 0.5, False)]
        got_m, want_m = TV.ServerMetrics(window=16), JV.ServerMetrics(window=16)
        for ep, s, err in samples:
            got_m.observe(ep, s, err)
            want_m.observe(ep, s, err)

        class Stats:
            stats = {"requests": 9, "batches": 4, "batched_frames": 1001}

        got, want = got_m.snapshot(Stats()), want_m.snapshot(Stats())
        got.pop("uptime_s"), want.pop("uptime_s")
        assert got == want
        assert got["endpoints"]["/summarize"] == {
            "requests": 29, "errors": 7,
            "latency_ms": {"p50": 220.0, "p95": 290.0, "max": 290.0, "window": 16}}
        assert got["batcher"]["mean_batch_frames"] == 250.2
        assert "batcher" not in TV.ServerMetrics().snapshot()


# ------------------------------------------------------------------ commentary (the text branch) and MoE


COMMENTARY = [(0, "kick off"), (95, "a long ball forward"), (200, "GOAL! 1-0"), (400, "corner")]


@pytest.fixture(scope="module")
def text_trunk(small_cfg):
    """A JAX trunk with the text branch and the MoE fusion (no audio), and the port's copy."""
    jcfg = _jcfg(small_cfg, False, text_included=True, fusion_moe_experts=4)
    js = jax_train_state(jax.random.PRNGKey(21), jcfg)
    return jcfg, js, _port_state(js)


def _commentary(n, skip=30):
    from cvml_goalnet_tpu.data.text import commentary_per_frame

    return commentary_per_frame(COMMENTARY, n, skip)


def _write_sidecar(video_fp):
    import json

    with open(video_fp.rsplit(".", 1)[0] + ".commentary.jsonl", "w") as f:
        for frame, line in COMMENTARY:
            f.write(json.dumps({"frame": frame, "text": line}) + "\n")


class TestCommentary:
    def test_summarizer_with_commentary_matches_jax(self, text_trunk, tmp_path):
        """Frames with per-frame commentary, without it (every frame ""), and a path with and without its
        sidecar: the JAX package's masks, scores within 1e-4."""
        jcfg, js, ts = text_trunk
        jsum, tsum = JV.Summarizer(jcfg, state=js), TV.Summarizer(_port(jcfg), state=ts, device=CPU)
        frames = _frames(16, seed=30)
        for commentary in (_commentary(16), None):
            _assert_summaries(tsum.summarize_frames("v", frames, commentary=commentary),
                              jsum.summarize_frames("v", frames, commentary=commentary))
        with_text = tsum.summarize_frames("v", frames, commentary=_commentary(16))
        assert not np.array_equal(with_text.scores, tsum.summarize_frames("v", frames).scores)
        for sidecar in (True, False):
            fp = str(tmp_path / f"clip{int(sidecar)}.npz")
            np.savez(fp, frames=_frames(16 * 30, seed=31))
            if sidecar:
                _write_sidecar(fp)
            _assert_summaries(tsum.summarize_path(fp), jsum.summarize_path(fp))

    def test_batcher_with_commentary_matches_jax(self, text_trunk):
        """Riders with and without commentary in one bucket-padded batch (padded rows hold token 0): the
        unbatched summaries and the JAX package's batcher's."""
        jcfg, js, ts = text_trunk
        tsum = TV.Summarizer(_port(jcfg), state=ts, device=CPU)
        reqs = [_frames(n, seed=40 + n) for n in (10, 7, 12)]
        texts = [_commentary(10), None, _commentary(12, skip=11)]
        with TV.DynamicBatcher(tsum, max_batch_frames=64, max_wait_ms=500.0, buckets=(16, 32, 64)) as tb:
            tb.warmup()
            got = [f.result(timeout=120) for f in [tb.submit(f"v{i}", fr, commentary=c)
                                                   for i, (fr, c) in enumerate(zip(reqs, texts))]]
            assert tb.stats["batches"] < 3
        for i, (g, fr, c) in enumerate(zip(got, reqs, texts)):
            want = tsum.summarize_frames(f"v{i}", fr, commentary=c)
            np.testing.assert_allclose(g.scores, want.scores, atol=1e-5)
            np.testing.assert_array_equal(g.frame_mask, want.frame_mask)
        with JV.DynamicBatcher(JV.Summarizer(jcfg, state=js), max_batch_frames=64, max_wait_ms=500.0,
                               buckets=(16, 32, 64)) as jb:
            jfuts = [jb.submit(f"v{i}", fr, commentary=c) for i, (fr, c) in enumerate(zip(reqs, texts))]
            for g, f in zip(got, jfuts):
                _assert_summaries(g, f.result(timeout=120))

    def test_spotter_on_a_three_modality_trunk_matches_jax(self, text_trunk, tmp_path):
        """A banded transformer head on [visual ‖ text] features, frames with commentary and a path with its
        sidecar; /spot-stream refuses the trunk with the JAX package's words, before any generator runs."""
        jcfg, js, ts = text_trunk
        jcfg = dataclasses.replace(jcfg, model=dataclasses.replace(jcfg.model, **SCORERS["transformer"]))
        jsp, tsp = JV.Spotter(jcfg, state=js), TV.Spotter(_port(jcfg), state=ts, device=CPU)
        d = jcfg.model.vis_feature_dim + jcfg.model.text_feature_dim
        assert TV.trunk_feature_dim(_port(jcfg)) == d
        head = temporal_head_init_auto(jax.random.PRNGKey(7), d, jcfg.model)
        jsp.temporal_params, tsp.temporal_params = head, W.tree_from_jax(head, device=CPU)
        frames = _frames(24, seed=50)
        got = tsp.spot_frames("m", frames, peak_window=2, commentary=_commentary(24))
        want = jsp.spot_frames("m", frames, peak_window=2, commentary=_commentary(24))
        np.testing.assert_allclose(got.scores, np.asarray(want.scores), atol=1e-4)
        _assert_events(got.events, want.events)
        fp = str(tmp_path / "m.npz")
        np.savez(fp, frames=_frames(24 * 30, seed=51))
        _write_sidecar(fp)
        got, want = tsp.spot_path(fp, peak_window=2), jsp.spot_path(fp, peak_window=2)
        np.testing.assert_allclose(got.scores, np.asarray(want.scores), atol=1e-4)
        np.testing.assert_array_equal(got.summary_clips, want.summary_clips)
        messages = []
        for sp in (tsp, jsp):
            with pytest.raises(ValueError) as e:
                sp.spot_stream_path(fp)
            messages.append(str(e.value))
        assert messages[0] == messages[1] and "no live ingest protocol for commentary" in messages[0]
