"""PyTorch port: event spotting against the JAX package, on the CPU.

The same numpy inputs and weights go through ``cvml_goalnet_tpu`` and
``cvml_goalnet_tpu_torch`` with ``device="cpu"``.  Temporal heads come from
``weights.init_temporal_params`` (layernorm scale and bias away from 1 and 0)
and are fed to both packages.  Tolerances: 1e-5 on scores for the scorers
alone at small widths (float32 sums in another order), 1e-4 where the trunk
or the full widths of ``configs/tpu_spotting.json`` feed them; events, masks
and update counts exact.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cvml_goalnet_tpu.spotting as JS
from cvml_goalnet_tpu.config import PipelineConfig as JaxPipelineConfig
from cvml_goalnet_tpu.models import temporal as JT
from cvml_goalnet_tpu.models.avm import avm_init
from cvml_goalnet_tpu.models.temporal_attention import temporal_transformer_apply as jax_transformer
from cvml_goalnet_tpu.models.temporal_hybrid import temporal_hybrid_apply as jax_hybrid
from cvml_goalnet_tpu.ops import spotting_metrics as JM
from cvml_goalnet_tpu.train.spotting import save_spotting_checkpoint
import cvml_goalnet_tpu_torch.spotting as TS
from cvml_goalnet_tpu_torch import weights as W
from cvml_goalnet_tpu_torch.config import PipelineConfig
from cvml_goalnet_tpu_torch.models import temporal as TT
from cvml_goalnet_tpu_torch.models.temporal_attention import temporal_transformer_apply
from cvml_goalnet_tpu_torch.models.temporal_hybrid import temporal_hybrid_apply
from cvml_goalnet_tpu_torch.ops import spotting_metrics as TM

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"


def _model(small_cfg, **kw):
    return dataclasses.replace(small_cfg.model, **kw)


def _head(mc, in_dim, seed=0, n_classes=1):
    """One numpy head for both packages, and the port's tensors of it."""
    p = W.init_temporal_params(mc, in_dim, seed, n_classes)
    return p, W.tree_from_jax(p, device=CPU)


def _feats(t, d, seed=0):
    return np.random.default_rng(seed).standard_normal((t, d)).astype(np.float32)


class TestGru:
    @pytest.mark.parametrize("n_classes", [1, 3])
    def test_scorer_matches_jax(self, small_cfg, n_classes):
        mc = _model(small_cfg, temporal_hidden=8)
        p, tp = _head(mc, 16, seed=1, n_classes=n_classes)
        x = _feats(37, 16, seed=2)
        want = np.asarray(JT.temporal_scorer_apply(p, jnp.asarray(x), 8))
        got = TT.temporal_scorer_apply(tp, torch.as_tensor(x), 8).numpy()
        assert got.shape == want.shape == ((37,) if n_classes == 1 else (37, 3))
        np.testing.assert_allclose(got, want, atol=1e-5)

    @pytest.mark.parametrize("n_classes", [1, 3])
    def test_chunked_matches_jax(self, small_cfg, n_classes):
        mc = _model(small_cfg, temporal_hidden=8)
        p, tp = _head(mc, 16, seed=3, n_classes=n_classes)
        x = _feats(50, 16, seed=4)
        want = np.asarray(JS.score_timeline_chunked(p, jnp.asarray(x), 8, 8, 3))
        got = TS.score_timeline_chunked(tp, torch.as_tensor(x), 8, 8, 3).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-5)

    def test_auto_dispatches_long_timelines_to_chunks(self, small_cfg):
        jcfg = dataclasses.replace(small_cfg, model=_model(small_cfg, temporal_chunk_threshold=40,
                                                           temporal_chunk=16, temporal_halo=4))
        p, tp = _head(jcfg.model, 16, seed=5)
        x = _feats(70, 16, seed=6)
        want = np.asarray(JS.score_timeline_auto(p, jnp.asarray(x), jcfg))
        got = TS.score_timeline_auto(tp, torch.as_tensor(x), PipelineConfig.from_json(jcfg.to_json())).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5)


class TestPeaks:
    SCORES = np.array([3, 3, 1, 0, 5, 5, 5, 2, -1, 4, 4.5, 0.2, 7], np.float32)

    @pytest.mark.parametrize("window,threshold", [(0, 0.0), (1, 0.0), (2, 2.5), (3, -10.0), (20, 0.0)])
    def test_detect_peaks_matches_jax(self, window, threshold):
        want = np.asarray(JT.detect_peaks(jnp.asarray(self.SCORES), window, threshold))
        got = TT.detect_peaks(torch.as_tensor(self.SCORES), window, threshold).numpy()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(TS.spot_events(self.SCORES, window, threshold),
                                      JS.spot_events(self.SCORES, window, threshold))

    @pytest.mark.parametrize("window,threshold", [(1, 0.0), (2, 1.0)])
    def test_detect_peaks_multi_matches_jax(self, window, threshold):
        s = np.stack([self.SCORES, self.SCORES[::-1], np.full_like(self.SCORES, 2.0)], axis=1)
        want = np.asarray(JT.detect_peaks_multi(jnp.asarray(s), window, threshold))
        np.testing.assert_array_equal(TT.detect_peaks_multi(torch.as_tensor(s), window, threshold).numpy(), want)
        for a, b in zip(TS.spot_events_multi(s, window, threshold), JS.spot_events_multi(s, window, threshold)):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(TS.spot_events_multi(self.SCORES, window), JS.spot_events_multi(self.SCORES, window)):
            np.testing.assert_array_equal(a, b)


# (positions, heads, window, pos_offset, n_classes, T, max_len)
TRANSFORMER_CASES = [
    ("learned", 1, 0, 0, 1, 40, 64),
    ("learned", 2, 8, 37, 3, 40, 64),
    ("learned", 2, 64, 0, 1, 40, 64),       # window ≥ T
    ("learned", 1, 8, 37, 1, 40, 16),       # T > max_len: the table tiles
    ("rotary", 1, 8, 0, 1, 40, 64),
    ("rotary", 2, 0, 37, 3, 40, 64),
    ("rotary", 2, 64, 37, 1, 40, 64),
]


class TestTransformer:
    @pytest.mark.parametrize("pos,heads,window,offset,n_classes,t,max_len", TRANSFORMER_CASES)
    def test_matches_jax(self, small_cfg, pos, heads, window, offset, n_classes, t, max_len):
        mc = _model(small_cfg, temporal_model="transformer", temporal_hidden=32, temporal_num_heads=heads,
                    temporal_max_len=max_len, temporal_pos_encoding=pos)
        p, tp = _head(mc, 16, seed=7, n_classes=n_classes)
        assert ("pos" in tp) == (pos == "learned")
        x = _feats(t, 16, seed=8)
        want = np.asarray(jax_transformer(p, jnp.asarray(x), heads, False, False, window, offset))
        got = temporal_transformer_apply(tp, torch.as_tensor(x), heads, window, offset).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-5)

    @pytest.mark.parametrize("window", [0, 8])
    def test_matches_jax_through_pallas_interpret(self, small_cfg, window):
        mc = _model(small_cfg, temporal_model="transformer", temporal_hidden=32, temporal_max_len=64)
        p, tp = _head(mc, 16, seed=9)
        x = _feats(40, 16, seed=10)
        want = np.asarray(jax_transformer(p, jnp.asarray(x), 1, True, True, window))
        got = temporal_transformer_apply(tp, torch.as_tensor(x), 1, window).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5)

    def test_rope_odd_head_dim_passes_the_last_lane(self):
        from cvml_goalnet_tpu.models.temporal_attention import rope_rotate as jax_rope
        from cvml_goalnet_tpu_torch.models.temporal_attention import rope_rotate

        x = np.random.default_rng(11).standard_normal((2, 30, 7)).astype(np.float32)
        pos = np.arange(30) + 1000
        want = np.asarray(jax_rope(jnp.asarray(x), jnp.asarray(pos)))
        got = rope_rotate(torch.as_tensor(x), torch.as_tensor(pos)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5)
        np.testing.assert_array_equal(got[..., 6], x[..., 6])

    @pytest.mark.parametrize("config", ["tpu_spotting.json", "tpu_spotting_quality.json"])
    def test_full_width_of_the_spotting_configs(self, config):
        path = os.path.join(REPO, "configs", config)
        jcfg, tcfg = JaxPipelineConfig.load(path), PipelineConfig.load(path)
        p, tp = _head(tcfg.model, 640, seed=12)
        x = _feats(64, 640, seed=13)
        want = np.asarray(JS.score_timeline_auto(p, jnp.asarray(x), jcfg))
        got = TS.score_timeline_auto(tp, torch.as_tensor(x), tcfg).numpy()
        assert got.shape == (64,)
        np.testing.assert_allclose(got, want, atol=1e-4)


class TestHybrid:
    @pytest.mark.parametrize("pos,heads,window,offset,n_classes", [
        ("rotary", 2, 8, 0, 1), ("learned", 1, 0, 5, 3),
    ])
    def test_matches_jax(self, small_cfg, pos, heads, window, offset, n_classes):
        mc = _model(small_cfg, temporal_model="hybrid", temporal_hidden=16, temporal_num_heads=heads,
                    temporal_max_len=64, temporal_pos_encoding=pos)
        p, tp = _head(mc, 12, seed=14, n_classes=n_classes)
        x = _feats(33, 12, seed=15)
        want = np.asarray(jax_hybrid(p, jnp.asarray(x), 16, heads, False, False, window, offset))
        got = temporal_hybrid_apply(tp, torch.as_tensor(x), 16, heads, window, offset).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5)


def _trunk(jcfg, seed=0):
    params, state = avm_init(jax.random.PRNGKey(seed), jcfg.model, jcfg.preprocess, jcfg.audio)
    return params, state, W.from_jax(params, state, device=CPU)


def _frames(cfg, t, seed=0):
    h, w = cfg.preprocess.frame_size
    return np.random.default_rng(seed).random((t, h, w, 3)).astype(np.float32)


class TestTrunkAndMatch:
    @pytest.mark.parametrize("audio", [True, False])
    def test_encode_timeline_matches_jax(self, small_cfg, audio):
        jcfg = dataclasses.replace(small_cfg, model=_model(small_cfg, audio_included=audio))
        params, state, (tp, ts) = _trunk(jcfg)
        visual = _frames(jcfg, 9, seed=1)
        aud = np.random.default_rng(2).standard_normal((9, jcfg.audio.bin_length, jcfg.audio.n_mfcc)).astype(np.float32)
        want = np.asarray(JS.encode_timeline(params, state, jnp.asarray(visual), jnp.asarray(aud), jcfg))
        got = TS.encode_timeline(tp, ts, visual, aud, PipelineConfig.from_json(jcfg.to_json()), device=CPU)
        assert got.shape == want.shape == (9, 48 if audio else 32)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5 * np.abs(want).max())
        assert TS.encode_timeline(tp, ts, visual[:0], aud[:0], PipelineConfig.from_json(jcfg.to_json()),
                                  device=CPU).shape == (0, want.shape[1])

    @pytest.mark.parametrize("family", ["gru", "transformer", "hybrid"])
    def test_summarize_match_matches_jax(self, small_cfg, family):
        from cvml_goalnet_tpu_torch.data.synthetic import synthetic_change_points

        jcfg = dataclasses.replace(small_cfg, model=_model(
            small_cfg, temporal_model=family, temporal_hidden=16, temporal_window=6, temporal_max_len=64))
        params, state, (tp, ts) = _trunk(jcfg, seed=3)
        p, thp = _head(jcfg.model, 48, seed=4)
        t = 40
        visual = _frames(jcfg, t, seed=5)
        aud = np.random.default_rng(6).standard_normal((t, jcfg.audio.bin_length, jcfg.audio.n_mfcc)).astype(np.float32)
        iv = synthetic_change_points(t * 30, 12, seed=7)
        want = JS.summarize_match(params, state, p, jnp.asarray(visual), jnp.asarray(aud), iv, jcfg, peak_window=2)
        got = TS.summarize_match(tp, ts, thp, visual, aud, iv, PipelineConfig.from_json(jcfg.to_json()),
                                 peak_window=2, device=CPU)
        np.testing.assert_allclose(got.scores, want.scores, atol=1e-4)
        np.testing.assert_array_equal(got.events, want.events)
        np.testing.assert_array_equal(got.summary.frame_mask, want.summary.frame_mask)
        assert got.summary.selected_clips == want.summary.selected_clips

    def test_multiclass_head_raises_and_a_text_trunk_matches_jax(self, small_cfg):
        """A multi-class head raises in summarize_match; a 3-modality trunk (the text branch) spots as the JAX
        package does, its features [audio ‖ visual ‖ text] and the match summary."""
        from cvml_goalnet_tpu.data.text import tokenize
        from cvml_goalnet_tpu_torch.data.synthetic import synthetic_change_points

        cfg = PipelineConfig.from_json(small_cfg.to_json())
        params, state, (tp, ts) = _trunk(small_cfg)
        _, thp = _head(cfg.model, 32, n_classes=2)
        with pytest.raises(ValueError, match="single-class"):
            TS.summarize_match(tp, ts, thp, _frames(cfg, 5), None, np.array([[0, 150]]),
                               dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, audio_included=False)),
                               device=CPU)
        jcfg = dataclasses.replace(small_cfg, model=_model(small_cfg, audio_included=False, text_included=True))
        params, state, (tp, ts) = _trunk(jcfg, seed=3)
        t = 12
        visual = _frames(jcfg, t, seed=4)
        text = tokenize(["", "kick off", "", "shot", "GOAL!", "goal replay", "", "", "corner", "save", "", "end"],
                        128, 12)
        want = JS.encode_timeline(params, state, jnp.asarray(visual), None, jcfg, text=jnp.asarray(text))
        got = TS.encode_timeline(tp, ts, visual, None, PipelineConfig.from_json(jcfg.to_json()), device=CPU,
                                 text=text)
        assert got.shape == (t, 32 + 16)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5 * max(1.0, float(np.abs(want).max())))
        p, thp = _head(jcfg.model, 32 + 16, seed=5)
        iv = synthetic_change_points(t * 30, 4, seed=6)
        want = JS.summarize_match(params, state, p, jnp.asarray(visual), None, iv, jcfg, peak_window=2,
                                  text=jnp.asarray(text))
        got = TS.summarize_match(tp, ts, thp, visual, None, iv, PipelineConfig.from_json(jcfg.to_json()),
                                 peak_window=2, device=CPU, text=text)
        np.testing.assert_allclose(got.scores, want.scores, atol=1e-4)
        np.testing.assert_array_equal(got.events, want.events)
        np.testing.assert_array_equal(got.summary.frame_mask, want.summary.frame_mask)

    def test_entry_points_without_card_raise(self, small_cfg, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        cfg = PipelineConfig.from_json(small_cfg.to_json())
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TS.encode_timeline({}, {}, _frames(cfg, 2), None, cfg)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TS.summarize_match({}, {}, {}, _frames(cfg, 2), None, np.array([[0, 60]]), cfg)
        nogru = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, audio_included=False))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            next(TS.spot_stream({}, {}, {"head": {"w": np.zeros((2, 1))}}, iter([_frames(cfg, 2)]), nogru))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            W.tree_from_jax({"w": np.zeros(2, np.float32)})


class TestSpotStream:
    """``spot_stream`` against the JAX package: update count, events and scores."""

    def _setup(self, small_cfg, family):
        jcfg = dataclasses.replace(small_cfg, model=_model(
            small_cfg, audio_included=False, temporal_model=family, temporal_hidden=16, temporal_window=4,
            temporal_max_len=64, temporal_pos_encoding="rotary" if family == "hybrid" else "learned"))
        params, state, (tp, ts) = _trunk(jcfg, seed=1)
        p, thp = _head(jcfg.model, 32, seed=2)
        return jcfg, params, state, tp, ts, p, thp

    @staticmethod
    def _chunks(frames, chunk):
        return [frames[i : i + chunk] for i in range(0, len(frames), chunk)]

    @pytest.mark.parametrize("family", ["gru", "transformer", "hybrid"])
    @pytest.mark.parametrize("t,chunk,halo", [(60, 16, 8), (30, 6, 8), (20, 64, 8), (40, 10, 0)],
                             ids=["chunk>halo", "chunk<halo", "single-chunk", "halo0"])
    def test_matches_jax(self, small_cfg, family, t, chunk, halo):
        jcfg, params, state, tp, ts, p, thp = self._setup(small_cfg, family)
        frames = _frames(jcfg, t, seed=3)
        want = list(JS.spot_stream(params, state, p, self._chunks(frames, chunk), jcfg, halo=halo, peak_window=3))
        got = list(TS.spot_stream(tp, ts, thp, self._chunks(frames, chunk), PipelineConfig.from_json(jcfg.to_json()),
                                  halo=halo, peak_window=3, device=CPU))
        assert [len(u.scores) for u in got] == [len(u.scores) for u in want]
        for g, w_ in zip(got, want):
            np.testing.assert_allclose(g.scores, w_.scores, atol=1e-4)
            np.testing.assert_array_equal(g.events, w_.events)

    @pytest.mark.parametrize("pos", ["learned", "rotary"])
    @pytest.mark.parametrize("chunk,halo", [(10, 12), (6, 0), (7, 11)])
    def test_banded_stream_equals_offline(self, small_cfg, pos, chunk, halo):
        """The band's receptive field is num_layers·W frames, so streamed scores equal the offline
        ones; the chunk and halo here leave fewer than halo but more than halo/2 emitted frames of
        left context after an emission, where keeping tail[len(tail) − halo:] would drop some."""
        jcfg, _, _, tp, ts, _, thp = self._setup(small_cfg, "transformer")
        cfg = PipelineConfig.from_json(jcfg.to_json())
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, temporal_pos_encoding=pos))
        _, thp = _head(cfg.model, 32, seed=6)
        frames = _frames(cfg, 60, seed=7)
        offline = TS.score_timeline_auto(thp, TS.encode_timeline(tp, ts, frames, None, cfg, device=CPU), cfg)
        updates = list(TS.spot_stream(tp, ts, thp, self._chunks(frames, chunk), cfg, halo=halo, peak_window=3,
                                      device=CPU))
        streamed = np.concatenate([u.scores for u in updates])
        np.testing.assert_allclose(streamed, offline.numpy(), atol=1e-5)
        np.testing.assert_array_equal(np.sort(np.concatenate([u.events for u in updates])),
                                      TS.spot_events(streamed, 3))

    def test_multiclass_updates(self, small_cfg):
        jcfg, params, state, tp, ts, _, _ = self._setup(small_cfg, "gru")
        p, thp = _head(jcfg.model, 32, seed=4, n_classes=3)
        frames = _frames(jcfg, 40, seed=5)
        want = list(JS.spot_stream(params, state, p, self._chunks(frames, 16), jcfg, halo=8, peak_window=2))
        got = list(TS.spot_stream(tp, ts, thp, self._chunks(frames, 16), PipelineConfig.from_json(jcfg.to_json()),
                                  halo=8, peak_window=2, device=CPU))
        assert len(got) == len(want)
        for g, w_ in zip(got, want):
            assert g.scores.shape == w_.scores.shape and set(g.events) == {0, 1, 2}
            np.testing.assert_allclose(g.scores, w_.scores, atol=1e-4)
            for c in range(3):
                np.testing.assert_array_equal(g.events[c], w_.events[c])

    def test_value_errors(self, small_cfg):
        jcfg, _, _, tp, ts, _, thp = self._setup(small_cfg, "transformer")
        cfg = PipelineConfig.from_json(jcfg.to_json())
        frames = self._chunks(_frames(cfg, 32), 16)
        for family in ("transformer", "hybrid"):
            full = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, temporal_model=family,
                                                                      temporal_window=0))
            with pytest.raises(ValueError, match="banded"):
                list(TS.spot_stream(tp, ts, thp, frames, full, device=CPU))
        audio_cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, audio_included=True,
                                                                       temporal_model="gru"))
        with pytest.raises(ValueError, match="audio_chunks"):
            list(TS.spot_stream(tp, ts, thp, frames, audio_cfg, device=CPU))
        params, state = avm_init(jax.random.PRNGKey(0), audio_cfg.model, audio_cfg.preprocess, audio_cfg.audio)
        ap, ast = W.from_jax(params, state, device=CPU)
        _, gru = _head(audio_cfg.model, 48)
        b, c = audio_cfg.audio.bin_length, audio_cfg.audio.n_mfcc
        with pytest.raises(ValueError, match="same boundaries"):
            list(TS.spot_stream(ap, ast, gru, frames, audio_cfg, audio_chunks=[np.zeros((7, b, c), np.float32)] * 2,
                                device=CPU))
        with pytest.raises(ValueError, match="exhausted"):
            list(TS.spot_stream(ap, ast, gru, frames, audio_cfg, audio_chunks=[np.zeros((16, b, c), np.float32)],
                                device=CPU))


class TestWeights:
    @pytest.mark.parametrize("family,pos", [("gru", "learned"), ("transformer", "learned"),
                                            ("transformer", "rotary"), ("hybrid", "rotary")])
    @pytest.mark.parametrize("n_classes", [1, 3])
    def test_init_temporal_params_tree_matches_jax(self, small_cfg, family, pos, n_classes):
        mc = _model(small_cfg, temporal_model=family, temporal_hidden=16, temporal_num_heads=2,
                    temporal_max_len=32, temporal_pos_encoding=pos)
        want = JS.temporal_head_init_auto(jax.random.PRNGKey(0), 24, mc, n_classes)
        got = W.init_temporal_params(mc, 24, seed=0, n_classes=n_classes)
        paths = lambda tree: {jax.tree_util.keystr(k): np.shape(v)
                              for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
        assert paths(got) == paths(want)
        if family != "gru":
            ln = (got.get("transformer", got))["layers"][0]["ln1"]
            assert not np.allclose(ln["scale"], 1.0) and not np.allclose(ln["bias"], 0.0)

    def test_load_spotting_checkpoint_from_jax(self, small_cfg, tmp_path):
        mc = _model(small_cfg, temporal_model="transformer", temporal_hidden=16, temporal_max_len=32)
        params = JS.temporal_head_init_auto(jax.random.PRNGKey(1), 24, mc, 2)
        path = str(tmp_path / "head.npz")
        save_spotting_checkpoint(path, params, classes=["goal", "card"])
        template = W.init_temporal_params(mc, 24, seed=0, n_classes=2)
        got = W.load_spotting_checkpoint(path, template, classes=["goal", "card"])
        want = jax.tree_util.tree_flatten_with_path(params)[0]
        flat = {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_flatten_with_path(got)[0]}
        assert len(flat) == len(want)
        for k, v in want:
            np.testing.assert_array_equal(flat[jax.tree_util.keystr(k)], np.asarray(v))
        tp = W.tree_from_jax(got, device=CPU)
        assert isinstance(tp["layers"], list) and tp["layers"][0]["wq"]["w"].dtype == torch.float32
        with pytest.raises(ValueError, match="channel order is positional"):
            W.load_spotting_checkpoint(path, template, classes=["card", "goal"])
        with pytest.raises(ValueError, match="channel order is positional"):
            W.load_spotting_checkpoint(path, template)
        rotary = W.init_temporal_params(dataclasses.replace(mc, temporal_pos_encoding="rotary"), 24, 0, 2)
        with pytest.raises(ValueError, match="not in template"):
            W.load_spotting_checkpoint(path, rotary, classes=["goal", "card"])
        wide = W.init_temporal_params(dataclasses.replace(mc, temporal_hidden=8), 24, 0, 2)
        with pytest.raises(ValueError, match="shape mismatch"):
            W.load_spotting_checkpoint(path, wide, classes=["goal", "card"])


class TestHostHelpers:
    def test_load_event_labels_matches_jax(self, tmp_path):
        path = str(tmp_path / "v.events.json")
        with open(path, "w") as f:
            json.dump([{"frame": 35, "label": "goal"}, {"frame": 400, "label": "card"}, 61,
                       {"frame": 9000, "label": "goal"}, {"frame": 95}], f)
        np.testing.assert_array_equal(TS.load_event_labels(path, 20, 30), JS.load_event_labels(path, 20, 30))
        np.testing.assert_array_equal(TS.load_event_labels(path, 20, 30, ["goal", "card"]),
                                      JS.load_event_labels(path, 20, 30, ["goal", "card"]))
        with pytest.warns(UserWarning, match="NONE matched"):
            TS.load_event_labels(path, 20, 30, ["sub"])

    def test_scores_to_importance_matches_jax(self):
        s = np.random.default_rng(0).standard_normal(30).astype(np.float32)
        np.testing.assert_allclose(TS.scores_to_importance(s), JS.scores_to_importance(s), rtol=1e-6)
        np.testing.assert_allclose(TS.scores_to_importance(np.ones(4)), JS.scores_to_importance(np.ones(4)))

    def test_spotting_metrics_match_jax(self):
        rng = np.random.default_rng(1)
        pred, score, gt = rng.integers(0, 500, 25), rng.random(25), np.sort(rng.integers(0, 500, 12))
        np.testing.assert_array_equal(TM.match_events(pred, score, gt, 10), JM.match_events(pred, score, gt, 10))
        for tol in (0, 5, 40):
            assert TM.spotting_pr(pred, score, gt, tol) == JM.spotting_pr(pred, score, gt, tol)
            assert TM.average_precision(pred, score, gt, tol) == JM.average_precision(pred, score, gt, tol)
        assert TM.spotting_pr([], [], [], 5) == JM.spotting_pr([], [], [], 5) == (1.0, 1.0, 1.0)
        assert TM.average_map(pred, score, gt) == JM.average_map(pred, score, gt)
        by_class = ([pred, pred[:3], []], [score, score[:3], []], [gt, [], []])
        assert TM.multiclass_average_map(*by_class) == JM.multiclass_average_map(*by_class)
