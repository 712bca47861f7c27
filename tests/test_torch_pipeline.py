"""PyTorch port: the summarization path against the JAX package, on the CPU.

Same numpy inputs and weights through ``cvml_goalnet_tpu.pipeline`` and
``cvml_goalnet_tpu_torch.pipeline`` with ``device="cpu"`` (the plain
versions of the port's kernels), plus the frozen goldens.
"""

import itertools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cvml_goalnet_tpu.pipeline as JP
from cvml_goalnet_tpu.config import AudioConfig as JaxAudioConfig
from cvml_goalnet_tpu.config import PipelineConfig as JaxPipelineConfig
from cvml_goalnet_tpu.models.audio import audio_encoder_apply as jax_audio_encoder
from cvml_goalnet_tpu.models.avm import avm_init
from cvml_goalnet_tpu.models.visual import visual_encoder_apply as jax_visual_encoder
from cvml_goalnet_tpu.ops.audio import extract_audio_features as jax_extract_audio
from cvml_goalnet_tpu.ops.clips import clip_stats as jax_clip_stats
from cvml_goalnet_tpu.ops.expand import expand_scores as jax_expand_scores
from cvml_goalnet_tpu.ops.fscore import fscore_against_users as jax_fscore
from cvml_goalnet_tpu.ops.knapsack import knapsack_select as jax_knapsack_select
import cvml_goalnet_tpu_torch.pipeline as TP
from cvml_goalnet_tpu_torch import weights as W
from cvml_goalnet_tpu_torch.config import AudioConfig, PipelineConfig
from cvml_goalnet_tpu_torch.data.synthetic import synthetic_video_frames, synthetic_waveform
from cvml_goalnet_tpu_torch.models.audio import audio_encoder_apply
from cvml_goalnet_tpu_torch.models.visual import visual_encoder_apply
from cvml_goalnet_tpu_torch.ops.audio import extract_audio_features, mfcc_slots
from cvml_goalnet_tpu_torch.ops.clips import clip_stats
from cvml_goalnet_tpu_torch.ops.expand import expand_scores
from cvml_goalnet_tpu_torch.ops.fscore import fscore_against_users
from cvml_goalnet_tpu_torch.ops.knapsack import knapsack_select

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDENS = os.path.join(REPO, "tests", "goldens", "goldens.npz")
CPU = "cpu"


def _port_cfg(jcfg) -> PipelineConfig:
    return PipelineConfig.from_json(jcfg.to_json())


@pytest.fixture(scope="module")
def goldens():
    return np.load(GOLDENS)


@pytest.fixture(scope="module")
def golden_cfg():
    from tests.goldens.generate import golden_cfg

    return golden_cfg()


def _random_features(cfg, n, seed):
    rng = np.random.default_rng(seed)
    h, w = cfg.preprocess.frame_size
    visual = rng.random((n, h, w, cfg.preprocess.channels)).astype(np.float32)
    audio = rng.standard_normal((n, cfg.audio.bin_length, cfg.audio.n_mfcc)).astype(np.float32)
    return {"visual": visual, "audio": audio}


def _assert_encoders_match(params, state, feats, rtol):
    """The scores of random weights sit near the sigmoid's middle; the encoder
    features are the sharper comparison."""
    tp, ts = W.from_jax(params, state, device=CPU)
    want_v, _ = jax_visual_encoder(params["visual"], state["visual"], jnp.asarray(feats["visual"]),
                                   train=False, rng=None, dropout_rate=0.0)
    got_v = visual_encoder_apply(tp["visual"], ts["visual"], torch.as_tensor(feats["visual"]))
    want_v = np.asarray(want_v)
    np.testing.assert_allclose(got_v.numpy(), want_v, atol=rtol * np.abs(want_v).max())
    want_a = np.asarray(jax_audio_encoder(params["audio"], jnp.asarray(feats["audio"])))
    got_a = audio_encoder_apply(tp["audio"], torch.as_tensor(feats["audio"]))
    np.testing.assert_allclose(got_a.numpy(), want_a, atol=rtol * np.abs(want_a).max())


class TestFuse:
    def test_small_cfg_matches_jax(self, small_cfg):
        params, state = avm_init(jax.random.PRNGKey(3), small_cfg.model, small_cfg.preprocess, small_cfg.audio)
        feats = _random_features(small_cfg, 11, seed=0)
        want = JP.fuse(params, state, feats, small_cfg)
        tp, ts = W.from_jax(params, state, device=CPU)
        got = TP.fuse(tp, ts, feats, _port_cfg(small_cfg), device=CPU)
        assert got.shape == (11,) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=1e-4)
        _assert_encoders_match(params, state, feats, rtol=1e-5)

    def test_golden_scores(self, goldens, golden_cfg):
        params, state = avm_init(jax.random.PRNGKey(11), golden_cfg.model, golden_cfg.preprocess, golden_cfg.audio)
        tp, ts = W.from_jax(params, state, device=CPU)
        feats = {"visual": goldens["visual"], "audio": goldens["audio"]}
        got = TP.fuse(tp, ts, feats, _port_cfg(golden_cfg), device=CPU)
        np.testing.assert_allclose(got, goldens["scores"], atol=1e-4)

    def test_reference_parity_width(self):
        path = os.path.join(REPO, "configs", "reference_parity.json")
        jcfg, tcfg = JaxPipelineConfig.load(path), PipelineConfig.load(path)
        params, state = W.init_params(tcfg, seed=5)
        feats = _random_features(tcfg, 3, seed=1)
        want = JP.fuse(params, state, feats, jcfg)
        tp, ts = W.from_jax(params, state, device=CPU)
        got = TP.fuse(tp, ts, feats, tcfg, device=CPU)
        np.testing.assert_allclose(got, want, atol=1e-4)
        _assert_encoders_match(params, state, feats, rtol=1e-5)

    def test_no_audio_and_fuse_many(self, small_cfg):
        import dataclasses

        jcfg = dataclasses.replace(small_cfg, model=dataclasses.replace(small_cfg.model, audio_included=False))
        params, state = avm_init(jax.random.PRNGKey(4), jcfg.model, jcfg.preprocess, jcfg.audio)
        tp, ts = W.from_jax(params, state, device=CPU)
        parts = [_random_features(jcfg, n, seed=n) for n in (5, 2, 7)]
        for p in parts:
            p["audio"] = None
        want = JP.fuse_many(params, state, parts, jcfg)
        got = TP.fuse_many(tp, ts, parts, _port_cfg(jcfg), device=CPU)
        assert [g.shape for g in got] == [(5,), (2,), (7,)]
        for g, w_ in zip(got, want):
            np.testing.assert_allclose(g, w_, atol=1e-4)

    def test_empty_batch(self, small_cfg):
        params, state = avm_init(jax.random.PRNGKey(0), small_cfg.model, small_cfg.preprocess, small_cfg.audio)
        tp, ts = W.from_jax(params, state, device=CPU)
        feats = _random_features(small_cfg, 0, seed=0)
        out = TP.fuse(tp, ts, feats, _port_cfg(small_cfg), device=CPU)
        assert out.shape == (0,) and out.dtype == np.float32
        assert TP.fuse_many(tp, ts, [], _port_cfg(small_cfg), device=CPU) == []

    def test_missing_modality_errors(self, small_cfg):
        params, state = avm_init(jax.random.PRNGKey(0), small_cfg.model, small_cfg.preprocess, small_cfg.audio)
        tp, ts = W.from_jax(params, state, device=CPU)
        cfg = _port_cfg(small_cfg)
        feats = _random_features(small_cfg, 3, seed=0)
        with pytest.raises(ValueError, match="features\\['audio'\\] is None"):
            TP.fuse(tp, ts, {"visual": feats["visual"], "audio": None}, cfg, device=CPU)
        with pytest.raises(ValueError, match="features_list\\[1\\]\\['audio'\\] is None"):
            TP.fuse_many(tp, ts, [feats, {"visual": feats["visual"], "audio": None}], cfg, device=CPU)

    @pytest.mark.parametrize("config", ["tpu_serving.json", "vit", "text", "moe"])
    def test_later_slices_raise(self, small_cfg, config):
        """No model option raises any more.  The serving preset (bf16 with int8 conv1 and conv2) runs, its
        scores on the bf16 grid in [1, 5] (held to the JAX package in test_torch_bf16.py); the vit backbone,
        the text branch and the MoE fusion run and match the JAX package's ``fuse`` within 1e-5 (the
        backbones, both together, the layers and training: test_torch_backbones.py, test_torch_text.py and
        test_torch_moe.py)."""
        import dataclasses

        if config.endswith(".json"):
            cfg = PipelineConfig.load(os.path.join(REPO, "configs", config))
            jcfg = JaxPipelineConfig.load(os.path.join(REPO, "configs", config))
            params, state = avm_init(jax.random.PRNGKey(0), jcfg.model, jcfg.preprocess, jcfg.audio)
            tp, ts = W.from_jax(params, state, device=CPU)
            out = TP.fuse(tp, ts, _random_features(cfg, 2, seed=0), cfg, device=CPU)
            assert out.shape == (2,) and ((out >= 1) & (out <= 5)).all()
            assert np.array_equal(torch.from_numpy(out).to(torch.bfloat16).to(torch.float32).numpy(), out)
            return
        field = {"vit": {"vis_backbone": "vit", "vit_embed_dim": 16, "vit_depth": 2, "vit_num_heads": 2},
                 "text": {"text_included": True}, "moe": {"fusion_moe_experts": 4}}[config]
        jcfg = dataclasses.replace(small_cfg, model=dataclasses.replace(small_cfg.model, **field))
        cfg = _port_cfg(jcfg)
        feats = _random_features(cfg, 6, seed=0)
        if config == "text":
            from cvml_goalnet_tpu.data.text import tokenize

            feats["text"] = tokenize(["", "goal", "a long ball", "", "save", "corner"], 128, 12)
        params, state = avm_init(jax.random.PRNGKey(0), jcfg.model, jcfg.preprocess, jcfg.audio)
        want = JP.fuse(params, state, feats, jcfg)
        np.testing.assert_allclose(TP.fuse(*W.from_jax(params, state, device=CPU), feats, cfg, device=CPU), want,
                                   atol=1e-5, rtol=0)


class TestExtractFeatures:
    def test_goldens(self, goldens, golden_cfg):
        frames = synthetic_video_frames(10, 48, 64, seed=3)
        wav = synthetic_waveform(22050 * 2, seed=3)
        feats = TP.extract_features(frames, wav, _port_cfg(golden_cfg), device=CPU)
        np.testing.assert_allclose(feats["visual"].numpy(), goldens["visual"], atol=1e-5)
        np.testing.assert_allclose(feats["audio"].numpy(), goldens["audio"], rtol=1e-3, atol=2e-3)
        assert feats["text"] is None

    @pytest.mark.parametrize("dtype", [np.uint8, np.float32])
    def test_zero_frames_match_jax(self, dtype):
        # a stream's empty tail: no frames and no waveform give an empty (0, h, w, C) float32 visual
        frames = np.zeros((0, 180, 320, 3), dtype)
        want = JP.extract_features(frames, None, JaxPipelineConfig())
        got = TP.extract_features(frames, None, PipelineConfig(), device=CPU)
        assert tuple(got["visual"].shape) == want["visual"].shape == (0, 40, 40, 3)
        assert got["visual"].dtype == torch.float32 and want["visual"].dtype == np.float32
        assert got["audio"] is None and want["audio"] is None

    def test_synthetic_generators_match_jax_package(self):
        from cvml_goalnet_tpu.data import synthetic as S

        np.testing.assert_array_equal(synthetic_video_frames(3, 8, 9, seed=4), S.synthetic_video_frames(3, 8, 9, seed=4))
        np.testing.assert_array_equal(synthetic_waveform(500, seed=4), S.synthetic_waveform(500, seed=4))

    @pytest.mark.parametrize("pad_mode,n_samples,n_frames", [
        ("reflect", 22050, 25),      # full-rate 882-sample slots: shorter than n_fft//2
        ("reflect", 22050 * 3, 4),   # long slots, reflect padding
        ("constant", 22050 * 2 + 7, 9),  # uneven slots (banker's rounding)
    ])
    def test_audio_matches_jax(self, pad_mode, n_samples, n_frames):
        jcfg = JaxAudioConfig(stft_pad_mode=pad_mode)
        y = synthetic_waveform(n_samples, seed=9)
        want = jax_extract_audio(y, n_frames, jcfg)
        got = extract_audio_features(y, n_frames, AudioConfig(stft_pad_mode=pad_mode), torch.device(CPU))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=2e-3)

    @pytest.mark.parametrize("pad_mode", ["reflect", "constant"])
    @pytest.mark.parametrize("name", ["two_tone", "chirp", "click", "short_slot"])
    def test_mfcc_matches_librosa_goldens(self, name, pad_mode):
        sys.path.insert(0, os.path.join(REPO, "tests", "goldens"))
        from make_librosa_goldens import golden_waveforms

        want = np.load(os.path.join(REPO, "tests", "goldens", "librosa_mfcc_goldens.npz"))[f"mfcc_{name}_{pad_mode}"]
        y = golden_waveforms()[name]
        got = mfcc_slots(torch.as_tensor(y)[None], AudioConfig(stft_pad_mode=pad_mode))[0].numpy().T
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-3)


class TestSummarize:
    def test_goldens(self, goldens, golden_cfg):
        cfg = _port_cfg(golden_cfg)
        res = TP.summarize(goldens["scores"], goldens["intervals"], cfg.preprocess.skip_frames,
                           10 * cfg.preprocess.skip_frames, cfg.knapsack, device=CPU)
        np.testing.assert_array_equal(res.frame_mask, goldens["frame_mask"])
        np.testing.assert_array_equal(res.selected_clips, goldens["selected_clips"])

    @pytest.mark.parametrize("inclusive", [True, False])
    def test_matches_jax(self, inclusive):
        from cvml_goalnet_tpu.config import KnapsackConfig as JK
        from cvml_goalnet_tpu_torch.config import KnapsackConfig as TK
        from cvml_goalnet_tpu_torch.data.synthetic import synthetic_change_points

        rng = np.random.default_rng(int(inclusive))
        scores = (rng.random(40) * 4 + 1).astype(np.float32)
        full_n = 40 * 30 + 13
        iv = synthetic_change_points(full_n, 15, seed=2)
        frames = np.arange(full_n)[:, None]
        want = JP.summarize(scores, iv, 30, full_n, JK(inclusive_mask=inclusive), full_frames=frames, knapsack_engine="host")
        got = TP.summarize(torch.as_tensor(scores)[:, None], iv, 30, full_n, TK(inclusive_mask=inclusive),
                           full_frames=frames, device=CPU)
        np.testing.assert_array_equal(got.frame_mask, want.frame_mask)
        assert got.selected_clips == want.selected_clips
        np.testing.assert_array_equal(got.clip_intervals, want.clip_intervals)
        np.testing.assert_array_equal(got.summary_frames, want.summary_frames)


def _brute_force_best(values, weights, capacity):
    best = 0.0
    for r in range(len(values) + 1):
        for combo in itertools.combinations(range(len(values)), r):
            if sum(weights[i] for i in combo) <= capacity:
                best = max(best, sum(values[i] for i in combo))
    return best


class TestOps:
    @pytest.mark.parametrize("seed", range(5))
    def test_knapsack_optimal_vs_brute_force(self, seed):
        rng = np.random.default_rng(seed)
        values = rng.integers(1, 30, 9).astype(float).tolist()
        weights = rng.integers(1, 8, 9).astype(int).tolist()
        cap = int(rng.integers(5, 20))
        sel = knapsack_select(values, weights, cap, scale_factor=1, engine="host")
        assert sum(weights[i] for i in sel) <= cap
        assert sum(values[i] for i in sel) == _brute_force_best(values, weights, cap)

    @pytest.mark.parametrize("seed", range(4))
    def test_knapsack_matches_jax_host(self, seed):
        rng = np.random.default_rng(seed)
        n = int(rng.integers(5, 40))
        values = rng.integers(0, 6, n).astype(float)
        weights = (rng.integers(1, 40, n) / (4 if seed % 2 else 1)).astype(float)
        cap = int(rng.integers(1, 60))
        assert knapsack_select(values, weights, cap) == jax_knapsack_select(values, weights, cap, engine="host")

    def test_knapsack_reference_rules(self):
        # weights ×5 and capacity ×5 (utils.py:477-479): only one item fits
        assert len(knapsack_select([10.0, 10.0], [1.2, 1.4], 2.0, scale_factor=5, engine="host")) == 1
        # equal items: the row for item 1 inherits item 0's value → take item 0
        assert knapsack_select([5.0, 5.0], [3, 3], 3, engine="host") == [0]
        assert knapsack_select([], [], 10, engine="host") == []
        assert knapsack_select([1.0], [1.0], 0, engine="host") == []

    def test_expand_clips_fscore_match_jax(self):
        rng = np.random.default_rng(0)
        s = rng.integers(1, 6, 17).astype(np.int32)
        for full in (17, 17 * 30 + 4, 100):
            np.testing.assert_array_equal(expand_scores(torch.as_tensor(s), 30, full).numpy(),
                                          np.asarray(jax_expand_scores(jnp.asarray(s), 30, full)))
        imp = rng.integers(0, 5, 90).astype(np.int32)
        iv = np.array([[0, 10], [10, 45], [45, 200], [-3, 5], [60, 50]], np.int64)
        got = clip_stats(torch.as_tensor(iv), torch.as_tensor(imp))
        want = jax_clip_stats(jnp.asarray(iv), jnp.asarray(imp))
        for g, w_ in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w_))
        pred = rng.integers(0, 2, 50)
        users = rng.integers(0, 2, (6, 50))
        users[2] = 0
        for g, w_ in zip(fscore_against_users(torch.as_tensor(pred), torch.as_tensor(users)),
                         jax_fscore(jnp.asarray(pred), jnp.asarray(users))):
            np.testing.assert_allclose(g.item(), float(w_), rtol=1e-6)


class TestDevicePolicy:
    def test_entry_points_without_card_raise(self, monkeypatch, small_cfg):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        cfg = _port_cfg(small_cfg)
        frames = synthetic_video_frames(2, 16, 16, seed=0)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TP.extract_features(frames, None, cfg)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TP.fuse({}, {}, _random_features(cfg, 2, seed=0), cfg)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TP.summarize(np.ones(2), np.array([[0, 30], [30, 60]]), 30, 60)

    def test_port_imports_no_jax(self):
        """A fresh interpreter: every module of the port (the training modules,
        the native runtime's loader, the data layer, the streaming scorer, the
        serving layer, the reference checkpoint verbs, the data-parallel
        modules, the context-parallel modules, the orbax checkpoint modules and
        the CLI with its serving and spotting verbs among them) and
        chip_smoke.py's imports leave jax, cvml_goalnet_tpu, orbax,
        tensorstore, zarr and zstandard out of sys.modules, and the optional media, HDF5
        and plotting packages too (imported only when a call needs them); and
        so do two ranks spawned by ``parallel.launch.spawn_ranks`` that import
        the data-parallel training modules, and two that import the
        context-parallel ones."""
        code = (
            "import importlib, pkgutil, sys\n"
            "import cvml_goalnet_tpu_torch as pkg\n"
            "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
            "    importlib.import_module(m.name)\n"
            "import chip_smoke\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in"
            " ('jax', 'cvml_goalnet_tpu', 'orbax', 'tensorstore', 'zarr', 'zstandard'))\n"
            "assert not bad, bad\n"
            "lazy = sorted(m for m in ('cv2', 'h5py', 'imageio', 'matplotlib') if m in sys.modules)\n"
            "assert not lazy, lazy\n"
            "for m in ('train.optim', 'train.spotting', 'runtime', 'ops.knapsack', 'cli', 'streaming',\n"
            "          'data.audio_io', 'data.video', 'data.annotations', 'data.dataset', 'data.follow',\n"
            "          'data.synthetic', 'train.checkpoint', 'train.state', 'viz', 'utils.profiling', 'serve',\n"
            "          'models.resnet', 'models.vit', 'compat.torch_import', 'parallel.mesh', 'parallel.serving',\n"
            "          'parallel.collectives', 'parallel.dp', 'parallel.launch', 'train.dp_loop',\n"
            "          'parallel.ring_attention', 'parallel.halo_attention', 'train.cp_loop',\n"
            "          'compat.zstd', 'compat.ocdbt', 'compat.zarr2', 'train.orbax_io'):\n"
            "    assert 'cvml_goalnet_tpu_torch.' + m in sys.modules, m\n"
            "from cvml_goalnet_tpu_torch import cli\n"
            "verbs = set(cli.build_parser()._subparsers._group_actions[0].choices)\n"
            "assert verbs >= {'train', 'eval', 'baseline', 'infer', 'serve', 'spot', 'spot-train', 'profile',\n"
            "                 'import-torch', 'export-torch'}, verbs\n"
            "import torch\n"
            "from cvml_goalnet_tpu_torch.parallel.launch import spawn_ranks\n"
            "from tests._torch_dp_ranks import report_imports\n"
            "ranks = spawn_ranks(report_imports, [torch.device('cpu')] * 2)\n"
            "assert [r['forbidden'] for r in ranks] == [[], []], ranks\n"
            "assert [r['rank'] for r in ranks] == [0, 1] and ranks[0]['world'] == 2, ranks\n"
            "from tests._torch_cp_ranks import run_cases\n"
            "ranks = spawn_ranks(run_cases, [torch.device('cpu')] * 2, ([{'kind': 'imports'}],))\n"
            "assert ranks == [[{'forbidden': []}]] * 2, ranks\n"
            "print(len([m for m in sys.modules if m.startswith('cvml_goalnet_tpu_torch')]))\n"
        )
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                             text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        assert int(out.stdout.strip().splitlines()[-1]) >= 20
