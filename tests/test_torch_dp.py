"""PyTorch port: data-parallel serving (``parallel/serving.py``, ``Summarizer``/``Spotter(mesh=)``) and
data-parallel training (``parallel/dp.py``, ``train/dp_loop.py``, ``train --dp``) against the JAX package's,
on the CPU.

Serving runs on a CPU mesh of 8 entries (``serving_mesh(8, device="cpu")``)
against the JAX package's ``serving_mesh(8)`` on the suite's 8 virtual CPU
devices: scores within 1e-5 of the port's single-device path (the split is
exact: the eval trunk is per frame) and within 1e-4 of the JAX package's
(the port's ``fuse`` tolerance), masks and events equal.

Training spawns ``gloo`` ranks (2 and 4) that import the port only
(``tests/_torch_dp_ranks.py``) and holds them to the JAX package's
``make_dp_train_step`` and ``make_dp_train_step_shardmap`` on ``cpu_mesh(n)``
with the same global batch and dropout off: loss within 1e-5, gradients
within 1e-5·max|g|, parameters after one Adam step within JAX's own 5e-3,
``model_state`` within 1e-5.  ``train_data_parallel`` and ``train --dp`` are
held to the JAX package's over two epochs (histories within 1e-4 relative).
The card cases (the shards' launches on their own cards, a one-rank step on
NCCL) are in ``tests/test_torch_cuda_kernels.py``, which runs where there is
no JAX.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvml_goalnet_tpu.parallel.serving import make_dp_encode as jax_make_dp_encode
from cvml_goalnet_tpu.parallel.serving import make_dp_fuse as jax_make_dp_fuse
from cvml_goalnet_tpu.parallel.serving import serving_mesh as jax_serving_mesh
from cvml_goalnet_tpu.serve import Spotter as JaxSpotter
from cvml_goalnet_tpu.serve import Summarizer as JaxSummarizer
from cvml_goalnet_tpu.spotting import temporal_head_init_auto
from cvml_goalnet_tpu.train.state import create_train_state as jax_train_state
import cvml_goalnet_tpu_torch.serve as TV
from cvml_goalnet_tpu_torch import weights as W
from cvml_goalnet_tpu_torch.config import PipelineConfig
from cvml_goalnet_tpu_torch.parallel.mesh import build_mesh, serving_mesh
from cvml_goalnet_tpu_torch.parallel.serving import make_dp_encode, make_dp_fuse, replicate
from cvml_goalnet_tpu_torch.pipeline import fuse
from cvml_goalnet_tpu_torch.spotting import encode_timeline
from cvml_goalnet_tpu_torch.train.state import TrainState

CPU = "cpu"
RAW = (48, 64)


@pytest.fixture(autouse=True)
def _close_port_batchers():
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


def _frames(n, seed=0):
    return np.random.default_rng(seed).integers(0, 255, (n, *RAW, 3), dtype=np.uint8)


@pytest.fixture(scope="module")
def jax_mesh8():
    return jax_serving_mesh(8)


@pytest.fixture(scope="module")
def mesh8():
    return serving_mesh(8, device=CPU)


@pytest.fixture(scope="module")
def trunk(small_cfg):
    js = jax_train_state(jax.random.PRNGKey(0), small_cfg)
    return js, _port_state(js)


def _features(cfg, n, seed=1, text=False):
    rng = np.random.default_rng(seed)
    out = {"visual": rng.random((n, *cfg.preprocess.frame_size, 3)).astype(np.float32),
           "audio": rng.random((n, cfg.audio.bin_length, cfg.audio.n_mfcc)).astype(np.float32), "text": None}
    if text:
        out["text"] = rng.integers(0, cfg.model.text_vocab_size, (n, cfg.model.text_max_len)).astype(np.int32)
    return out


def _int8_codes(run):
    """``run()`` and the int8 activation codes of every quantized point it passed, in order: each a numpy array
    with frames first, a data-parallel run's blocks concatenated in block order (padded rows included)."""
    import threading

    from cvml_goalnet_tpu_torch.ops import quant

    seen: dict = {}
    inner = quant.quantize_act_per_tensor

    def recording(x):
        x_q, s = inner(x)
        seen.setdefault(threading.current_thread().name, []).append(x_q.numpy().copy())
        return x_q, s

    quant.quantize_act_per_tensor = recording
    try:
        out = run()
    finally:
        quant.quantize_act_per_tensor = inner
    threads = sorted(seen, key=lambda name: int(name.rsplit("-", 1)[1]) if name.startswith("dp-block-") else -1)
    return out, [np.concatenate(per_point) for per_point in zip(*(seen[t] for t in threads))]


# ------------------------------------------------------------------ Part B: serving


class TestServingMesh:
    def test_cpu_mesh_repeats_the_cpu(self):
        assert serving_mesh(8, device=CPU) == [torch.device("cpu")] * 8
        assert serving_mesh(-1, device=CPU) == [torch.device("cpu")]
        assert serving_mesh(None, device=CPU) == [torch.device("cpu")]

    def test_cards_in_order_and_too_many_refused_as_jax(self, monkeypatch, jax_mesh8):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
        assert serving_mesh(-1) == [torch.device("cuda", 0), torch.device("cuda", 1)]
        assert serving_mesh(1) == [torch.device("cuda", 0)]
        with pytest.raises(ValueError) as got:
            serving_mesh(3)
        with pytest.raises(ValueError) as want:
            jax_serving_mesh(9)
        assert str(got.value) == "--dp 3 requested but only 2 device(s) are visible"
        assert str(want.value) == "--dp 9 requested but only 8 device(s) are visible"
        with pytest.raises(ValueError, match="positive device count"):
            serving_mesh(0)

    def test_train_mesh_axis(self, monkeypatch):
        from cvml_goalnet_tpu_torch.config import MeshConfig

        assert build_mesh(MeshConfig(data=-1), CPU) == [torch.device("cpu")]
        assert build_mesh(MeshConfig(data=4), CPU) == [torch.device("cpu")] * 4
        # a model axis (once refused): data × model entries in the JAX mesh's order
        assert build_mesh(MeshConfig(data=2, model=2), CPU) == [torch.device("cpu")] * 4
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
        assert build_mesh(MeshConfig(data=-1)) == [torch.device("cuda", i) for i in range(4)]
        assert build_mesh(MeshConfig(data=-1, model=2)) == [torch.device("cuda", i) for i in range(4)]
        with pytest.raises(ValueError, match="only 4 are visible"):
            build_mesh(MeshConfig(data=8))
        with pytest.raises(ValueError, match="4 devices not divisible by model axis 3"):
            build_mesh(MeshConfig(data=-1, model=3))

    def test_replicate_copies_once_per_device(self, trunk):
        _, ts = trunk
        rep = replicate(ts.params, serving_mesh(3, device=CPU))
        assert len(rep) == 3 and rep[0] is rep[1] is rep[2]
        assert replicate(rep, serving_mesh(3, device=CPU)) is rep


class TestDpFuse:
    @pytest.mark.parametrize("n", [48, 37, 5, 8])
    def test_matches_single_device_and_jax(self, small_cfg, mesh8, jax_mesh8, trunk, n):
        """Divisible (48, 8) and padded (37, 5) batches."""
        js, ts = trunk
        cfg = _port(small_cfg)
        feats = _features(cfg, n)
        want = fuse(ts.params, ts.model_state, feats, cfg, device=CPU)
        got = make_dp_fuse(cfg.model, mesh8)(ts.params, ts.model_state, feats)
        assert got.shape == (n,) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=1e-5)
        jax_got = jax_make_dp_fuse(small_cfg.model, jax_mesh8)(js.params, js.model_state, feats)
        np.testing.assert_allclose(got, jax_got, atol=1e-4)

    @pytest.mark.parametrize("model", [{"dtype": "bfloat16"}, {"text_included": True, "fusion_moe_experts": 4}])
    def test_other_model_options_split_exactly(self, small_cfg, mesh8, model):
        """bf16 and the text branch with MoE are per frame too: the split changes no score."""
        jcfg = _jcfg(small_cfg, True, **model)
        cfg = _port(jcfg)
        ts = _port_state(jax_train_state(jax.random.PRNGKey(2), jcfg))
        feats = _features(cfg, 21, seed=3, text=cfg.model.text_included)
        want = fuse(ts.params, ts.model_state, feats, cfg, device=CPU)
        got = make_dp_fuse(cfg.model, mesh8)(replicate(ts.params, mesh8), replicate(ts.model_state, mesh8), feats)
        np.testing.assert_allclose(got, want, atol=1e-5)

    def test_int8_blocks_take_their_own_activation_scale(self, small_cfg, mesh8, jax_mesh8):
        """Under ``quantized_inference`` every block computes its own activation scale and quantizes with the
        batch's, the largest of them (the name records the fault this test once held, ROADMAP.md §3): on 37
        frames of spread ranges over 8 blocks the port's data-parallel scores are within 1e-6 of the JAX
        package's, and the int8 codes at conv1 and conv2 equal the single-device fuse's."""
        jcfg = _jcfg(small_cfg, True, quantized_inference=True)
        cfg = _port(jcfg)
        js = jax_train_state(jax.random.PRNGKey(0), jcfg)
        ts = _port_state(js)
        feats = _features(cfg, 37)
        feats["visual"] *= np.linspace(0.2, 1.0, 37, dtype=np.float32)[:, None, None, None]
        got, codes = _int8_codes(lambda: make_dp_fuse(cfg.model, mesh8)(ts.params, ts.model_state, feats))
        want = np.asarray(jax_make_dp_fuse(jcfg.model, jax_mesh8)(js.params, js.model_state, feats))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        single, single_codes = _int8_codes(lambda: fuse(ts.params, ts.model_state, feats, cfg, device=CPU))
        assert len(codes) == len(single_codes) == 2
        for point, (a, b) in enumerate(zip(codes, single_codes)):
            np.testing.assert_array_equal(a[:37], b, err_msg=f"quantized point {point}")
        np.testing.assert_array_equal(single, want)

    def test_batch_scales_stay_on_their_block_threads(self, small_cfg, mesh8, monkeypatch):
        """The batch scale is a thread-local mode (``ops/quant.py::batch_scales``) that only the data-parallel
        fuse's block threads enter: a single-device int8 fuse on another thread while a stray mode is held is
        bit-equal to one without, and no mode outlives its block, whether the block ends, raises, or the
        data-parallel fuse fails in one block."""
        import threading

        from cvml_goalnet_tpu_torch import pipeline
        from cvml_goalnet_tpu_torch.ops import quant

        jcfg = _jcfg(small_cfg, True, quantized_inference=True)
        cfg = _port(jcfg)
        ts = _port_state(jax_train_state(jax.random.PRNGKey(0), jcfg))
        feats = _features(cfg, 9)
        want = fuse(ts.params, ts.model_state, feats, cfg, device=CPU)
        inside, release = threading.Event(), threading.Event()

        def stray():
            with quant.batch_scales(lambda s: torch.full_like(s, 1e3)):
                assert quant.sharing_scales()
                inside.set()
                release.wait(120)

        holder = threading.Thread(target=stray)
        holder.start()
        try:
            assert inside.wait(120)
            assert not quant.sharing_scales()
            np.testing.assert_array_equal(fuse(ts.params, ts.model_state, feats, cfg, device=CPU), want)
        finally:
            release.set()
            holder.join()
        with pytest.raises(RuntimeError, match="inside"):
            with quant.batch_scales(lambda s: s):
                raise RuntimeError("inside")
        assert not quant.sharing_scales()
        make_dp_fuse(cfg.model, mesh8)(ts.params, ts.model_state, feats)
        assert not quant.sharing_scales()
        real = pipeline.fuse_on_device
        calls = []

        def third_block_fails(*a, **kw):
            calls.append(None)
            if len(calls) == 3:
                raise RuntimeError("block failed")
            return real(*a, **kw)

        monkeypatch.setattr(pipeline, "fuse_on_device", third_block_fails)
        with pytest.raises(RuntimeError, match="block failed"):
            make_dp_fuse(cfg.model, mesh8)(ts.params, ts.model_state, feats)
        monkeypatch.undo()
        assert not quant.sharing_scales()
        np.testing.assert_array_equal(fuse(ts.params, ts.model_state, feats, cfg, device=CPU), want)

    @pytest.mark.parametrize("backbone,points", [("resnet", 12), ("vit", 24)])
    def test_int8_backbone_blocks_take_the_batch_scale(self, small_cfg, mesh8, jax_mesh8, backbone, points):
        """The same at each of the resnet's 12 and the vit's 24 quantized points: the data-parallel scores
        within 1e-6 of the single-device fuse's and the codes equal; against the JAX package's data-parallel
        scores the backbones' own port tolerance, 1e-4 (the vit's float32 forward is 2.6e-5 from JAX's on one
        device too)."""
        extra = {"vit_embed_dim": 16, "vit_depth": 4, "vit_num_heads": 2, "vit_patch_size": 8} \
            if backbone == "vit" else {}
        jcfg = _jcfg(small_cfg, True, quantized_inference=True, vis_backbone=backbone, **extra)
        cfg = _port(jcfg)
        js = jax_train_state(jax.random.PRNGKey(3), jcfg)
        ts = _port_state(js)
        feats = _features(cfg, 21, seed=4)
        feats["visual"] *= np.linspace(0.3, 1.0, 21, dtype=np.float32)[:, None, None, None]
        got, codes = _int8_codes(lambda: make_dp_fuse(cfg.model, mesh8)(ts.params, ts.model_state, feats))
        want = np.asarray(jax_make_dp_fuse(jcfg.model, jax_mesh8)(js.params, js.model_state, feats))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
        single, single_codes = _int8_codes(lambda: fuse(ts.params, ts.model_state, feats, cfg, device=CPU))
        np.testing.assert_allclose(got, single, rtol=0, atol=1e-6)
        assert len(codes) == len(single_codes) == points
        for point, (a, b) in enumerate(zip(codes, single_codes)):
            np.testing.assert_array_equal(a[:21], b, err_msg=f"quantized point {point}")

    def test_empty_batch(self, small_cfg, mesh8, trunk):
        _, ts = trunk
        out = make_dp_fuse(_port(small_cfg).model, mesh8)(ts.params, ts.model_state,
                                                          {"visual": np.zeros((0, 24, 24, 3), np.float32)})
        assert out.shape == (0,)

    def test_missing_modality_is_loud(self, small_cfg, mesh8, trunk):
        _, ts = trunk
        with pytest.raises(ValueError, match="audio"):
            make_dp_fuse(_port(small_cfg).model, mesh8)(ts.params, ts.model_state,
                                                        {"visual": np.zeros((4, 24, 24, 3), np.float32)})


class TestDpServices:
    def test_summarize_frames_parity(self, small_cfg, mesh8, jax_mesh8, trunk):
        js, ts = trunk
        cfg = _port(small_cfg)
        frames = _frames(37)
        base = TV.Summarizer(cfg, state=ts, device=CPU).summarize_frames("v", frames)
        dp = TV.Summarizer(cfg, state=ts, device=CPU, mesh=mesh8).summarize_frames("v", frames)
        np.testing.assert_allclose(dp.scores, base.scores, atol=1e-5)
        np.testing.assert_array_equal(dp.frame_mask, base.frame_mask)
        want = JaxSummarizer(small_cfg, state=js, mesh=jax_mesh8).summarize_frames("v", frames)
        np.testing.assert_allclose(dp.scores, np.asarray(want.scores), atol=1e-4)
        np.testing.assert_array_equal(dp.frame_mask, want.frame_mask)

    def test_reload_replaces_served_weights(self, small_cfg, mesh8):
        cfg = _port(small_cfg)
        first = _port_state(jax_train_state(jax.random.PRNGKey(99), small_cfg))
        later = jax_train_state(jax.random.PRNGKey(123), small_cfg)

        def reloader():
            return _port_state(later)

        frames = _frames(16)
        before = TV.Summarizer(cfg, state=first, device=CPU).summarize_frames("v", frames).scores
        dp = TV.Summarizer(cfg, state=first, reloader=reloader, device=CPU, mesh=mesh8)
        np.testing.assert_allclose(dp.summarize_frames("v", frames).scores, before, atol=1e-5)
        assert dp.reload() == 1
        after = dp.summarize_frames("v", frames).scores
        assert not np.allclose(after, before, atol=1e-5)
        np.testing.assert_allclose(after, TV.Summarizer(cfg, state=reloader(), device=CPU).summarize_frames(
            "v", frames).scores, atol=1e-5)
        np.testing.assert_allclose(after, np.asarray(JaxSummarizer(small_cfg, state=later).summarize_frames(
            "v", frames).scores), atol=1e-4)

    @pytest.mark.parametrize("n", [40, 37])
    def test_dp_encode_matches_single_device(self, small_cfg, mesh8, jax_mesh8, trunk, n):
        js, ts = trunk
        cfg = _port(small_cfg)
        feats = _features(cfg, n, seed=3)
        want = encode_timeline(ts.params, ts.model_state, feats["visual"], feats["audio"], cfg, device=CPU)
        got = make_dp_encode(cfg.model, mesh8)(ts.params, ts.model_state, feats["visual"], feats["audio"])
        assert got.shape == want.shape and got.device.type == "cpu"
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)
        jax_got = jax_make_dp_encode(small_cfg.model, jax_mesh8)(js.params, js.model_state, feats["visual"],
                                                                 feats["audio"])
        np.testing.assert_allclose(got.numpy(), jax_got, atol=1e-4)

    @pytest.mark.parametrize("audio", [True, False])
    def test_dp_encode_of_an_empty_timeline_keeps_its_width(self, small_cfg, mesh8, jax_mesh8, audio):
        """(0, D), where the JAX package's gives (0, 0): a decision recorded in ROADMAP.md §3."""
        jcfg = _jcfg(small_cfg, audio)
        cfg = _port(jcfg)
        js = jax_train_state(jax.random.PRNGKey(0), jcfg)
        ts = _port_state(js)
        empty = np.zeros((0, *cfg.preprocess.frame_size, 3), np.float32)
        aud = np.zeros((0, cfg.audio.bin_length, cfg.audio.n_mfcc), np.float32) if audio else None
        got = make_dp_encode(cfg.model, mesh8)(ts.params, ts.model_state, empty, aud)
        d = cfg.model.vis_feature_dim + (cfg.model.aud_feature_dim if audio else 0)
        assert tuple(got.shape) == (0, d) and d == TV.trunk_feature_dim(cfg)
        assert jax_make_dp_encode(jcfg.model, jax_mesh8)(js.params, js.model_state, empty, aud).shape == (0, 0)

    def _spotters(self, small_cfg, js, mesh, jax_mesh, reloader=None):
        cfg = _port(small_cfg)
        head = temporal_head_init_auto(jax.random.PRNGKey(5), TV.trunk_feature_dim(cfg), small_cfg.model)
        base = TV.Spotter(cfg, state=_port_state(js), device=CPU)
        dp = TV.Spotter(cfg, state=_port_state(js), device=CPU, mesh=mesh, reloader=reloader)
        jdp = JaxSpotter(small_cfg, state=js, mesh=jax_mesh)
        base.temporal_params = dp.temporal_params = W.tree_from_jax(head, device=CPU)
        jdp.temporal_params = head
        return base, dp, jdp

    def test_spot_frames_parity(self, small_cfg, mesh8, jax_mesh8, trunk):
        js, _ = trunk
        base, dp, jdp = self._spotters(small_cfg, js, mesh8, jax_mesh8)
        frames = _frames(37)
        a, b, j = base.spot_frames("v", frames), dp.spot_frames("v", frames), jdp.spot_frames("v", frames)
        np.testing.assert_allclose(b.scores, a.scores, atol=1e-5)
        np.testing.assert_array_equal(b.events, a.events)
        np.testing.assert_array_equal(b.summary_clips, a.summary_clips)
        assert b.summary_frames == a.summary_frames
        np.testing.assert_allclose(b.scores, np.asarray(j.scores), atol=1e-4)
        np.testing.assert_array_equal(b.events, j.events)
        np.testing.assert_array_equal(b.summary_clips, j.summary_clips)

    def test_spotter_reload_replaces_placed_weights(self, small_cfg, mesh8, jax_mesh8):
        later = jax_train_state(jax.random.PRNGKey(123), small_cfg)
        _, dp, _ = self._spotters(small_cfg, jax_train_state(jax.random.PRNGKey(0), small_cfg), mesh8, jax_mesh8,
                                  reloader=lambda: _port_state(later))
        frames = _frames(16)
        before = dp.spot_frames("v", frames).scores
        dp.reload()
        after = dp.spot_frames("v", frames).scores
        assert not np.allclose(after, before, atol=1e-5)
        ref = TV.Spotter(_port(small_cfg), state=_port_state(later), device=CPU)
        ref.temporal_params = dp.temporal_params
        np.testing.assert_allclose(after, ref.spot_frames("v", frames).scores, atol=1e-5)

    def test_dynamic_batcher_composes_with_dp(self, small_cfg, mesh8, jax_mesh8):
        jcfg = _jcfg(small_cfg, False)
        cfg = _port(jcfg)
        js = jax_train_state(jax.random.PRNGKey(0), jcfg)
        base = TV.Summarizer(cfg, state=_port_state(js), device=CPU)
        dp = TV.Summarizer(cfg, state=_port_state(js), device=CPU, mesh=mesh8)
        jdp = JaxSummarizer(jcfg, state=js, mesh=jax_mesh8)
        batcher = TV.DynamicBatcher(dp, max_wait_ms=20.0, buckets=(64, 128))
        rng = np.random.default_rng(7)
        reqs = {f"v{i}": rng.integers(0, 255, (10 + 7 * i, *RAW, 3), dtype=np.uint8) for i in range(4)}
        futs = {vid: batcher.submit(vid, fr) for vid, fr in reqs.items()}
        for vid, fut in futs.items():
            res = fut.result(timeout=60)
            want = base.summarize_frames(vid, reqs[vid])
            np.testing.assert_allclose(res.scores, want.scores, atol=1e-5)
            np.testing.assert_array_equal(res.frame_mask, want.frame_mask)
            np.testing.assert_allclose(res.scores, np.asarray(jdp.summarize_frames(vid, reqs[vid]).scores),
                                       atol=1e-4)
        assert batcher.stats["requests"] == 4
        batcher.close()


# ------------------------------------------------------------------ Part C: training

import _torch_dp_ranks as RANKS  # noqa: E402  (tests/ is on the path; the spawned ranks import it by this name)
import _torch_pp_ranks as RANKS_PP  # noqa: E402

from cvml_goalnet_tpu.models.avm import avm_apply as jax_avm_apply  # noqa: E402
from cvml_goalnet_tpu.parallel.dp import make_dp_train_step as jax_dp_step  # noqa: E402
from cvml_goalnet_tpu.parallel.dp import make_dp_train_step_shardmap as jax_dp_step_shardmap  # noqa: E402
from cvml_goalnet_tpu.parallel.mesh import cpu_mesh  # noqa: E402
from cvml_goalnet_tpu.parallel.sharding import shard_batch  # noqa: E402
from cvml_goalnet_tpu_torch.parallel.launch import spawn_ranks  # noqa: E402

GLOBAL_BATCH = 16
KINDS = ("gspmd", "shardmap")


def _train_cfg(small_cfg, **train):
    return dataclasses.replace(small_cfg, model=dataclasses.replace(small_cfg.model, dropout_rate=0.0),
                               train=dataclasses.replace(small_cfg.train, **train))


def _batch(cfg, n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.random((n, *cfg.preprocess.frame_size, 3)).astype(np.float32),
            rng.random((n, cfg.audio.bin_length, cfg.audio.n_mfcc)).astype(np.float32),
            rng.integers(1, 6, n).astype(np.float32))


def _jax_grads(jcfg, js, vis, aud, lab, blocks: int):
    """The mean over ``blocks`` contiguous blocks of each block's gradient of its mean squared error, batchnorm
    on the block's own rows (blocks=1: the global batch's gradient, the GSPMD step's)."""
    def loss_fn(p, v, a, y):
        preds, _ = jax_avm_apply(p, js.model_state, v, a, None, cfg=jcfg.model, train=True,
                                 rng=jax.random.PRNGKey(0))
        return jnp.mean((preds[:, 0] - y) ** 2)

    b = len(vis) // blocks
    gs = [jax.grad(loss_fn)(js.params, *(jnp.asarray(x[i * b:(i + 1) * b]) for x in (vis, aud, lab)))
          for i in range(blocks)]
    return jax.tree.map(lambda *g: np.mean(np.stack([np.asarray(x) for x in g]), axis=0), *gs)


@pytest.fixture(scope="module")
def step_runs(small_cfg):
    """world → (the JAX package's outputs per step kind, the port's ranks' outputs); each world spawned once."""
    jcfg = _train_cfg(small_cfg)
    js = jax_train_state(jax.random.PRNGKey(0), jcfg)
    vis, aud, lab = _batch(jcfg, GLOBAL_BATCH)
    runs: dict = {}

    def run(world: int):
        if world in runs:
            return runs[world]
        mesh = cpu_mesh(world)
        want = {}
        for kind, make in (("gspmd", jax_dp_step), ("shardmap", jax_dp_step_shardmap)):
            args = ((shard_batch(mesh, jnp.asarray(x)) for x in (vis, aud, lab)) if kind == "gspmd"
                    else (jnp.asarray(x) for x in (vis, aud, lab)))
            p, ms, _, loss = make(jcfg, mesh)(js.params, js.model_state, js.opt_state, *args,
                                              jax.random.PRNGKey(1))
            want[kind] = {"loss": float(loss), "params": jax.tree.map(np.asarray, p),
                          "model_state": jax.tree.map(np.asarray, ms),
                          "grads": _jax_grads(jcfg, js, vis, aud, lab, 1 if kind == "gspmd" else world)}
        job = {"cfg": _port(jcfg), "params": jax.tree.map(np.asarray, js.params),
               "model_state": jax.tree.map(np.asarray, js.model_state), "visual": vis, "audio": aud, "labels": lab}
        got = spawn_ranks(RANKS.step_parity, serving_mesh(world, device=CPU), (job,))
        runs[world] = (want, got)
        return runs[world]

    return run


def _pairs(got_tree, want_tree):
    from test_torch_reference_checkpoints import _leaves

    g, w = dict(_leaves(got_tree)), dict(_leaves(want_tree))
    assert g.keys() == w.keys()
    return [(k, np.asarray(g[k]), np.asarray(w[k])) for k in g]


class TestDpSteps:
    @pytest.mark.parametrize("world", [2, 4])
    @pytest.mark.parametrize("kind", KINDS)
    def test_loss_matches_jax(self, step_runs, kind, world):
        want, got = step_runs(world)
        for rank_out in got:   # every rank holds the reduced loss
            assert abs(rank_out[kind]["loss"] - want[kind]["loss"]) <= 1e-5
            assert rank_out[kind]["loss_step"] == rank_out[kind]["loss"]

    @pytest.mark.parametrize("world", [2, 4])
    @pytest.mark.parametrize("kind", KINDS)
    def test_gradients_match_jax(self, step_runs, kind, world):
        want, got = step_runs(world)
        for k, g, w in _pairs(got[0][kind]["grads"], want[kind]["grads"]):
            np.testing.assert_allclose(g, w, atol=1e-5 * float(np.abs(w).max()) + 1e-12, rtol=0, err_msg=k)
        for rank_out in got[1:]:   # the reduced gradients are the same bits on every rank
            for k, g, w in _pairs(rank_out[kind]["grads"], got[0][kind]["grads"]):
                np.testing.assert_array_equal(g, w, err_msg=k)

    @pytest.mark.parametrize("world", [2, 4])
    @pytest.mark.parametrize("kind", KINDS)
    def test_params_after_adam_match_jax(self, step_runs, kind, world):
        """Within JAX's own 5e-3 (``tests/test_parallel.py``): Adam moves an entry whose gradient is rounding
        noise by up to lr; the ranks' parameters stay bit-identical."""
        want, got = step_runs(world)
        for k, g, w in _pairs(got[0][kind]["params"], want[kind]["params"]):
            np.testing.assert_allclose(g, w, atol=5e-3, err_msg=k)
        assert all(r[kind]["opt_step"] == 1 for r in got)
        for rank_out in got[1:]:
            for k, g, w in _pairs(rank_out[kind]["params"], got[0][kind]["params"]):
                np.testing.assert_array_equal(g, w, err_msg=k)

    @pytest.mark.parametrize("world", [2, 4])
    @pytest.mark.parametrize("kind", KINDS)
    def test_model_state_matches_jax(self, step_runs, kind, world):
        want, got = step_runs(world)
        for rank_out in got:
            for k, g, w in _pairs(rank_out[kind]["model_state"], want[kind]["model_state"]):
                np.testing.assert_allclose(g, w, atol=1e-5, rtol=0, err_msg=k)

    @pytest.mark.parametrize("world", [2, 4])
    def test_spawned_ranks_import_no_jax(self, step_runs, world):
        _, got = step_runs(world)
        assert [r["forbidden"] for r in got] == [[]] * world

    def test_tensor_parallel_step_matches_jax_on_a_grid(self, small_cfg):
        """The tensor-parallel step on a 2 × 2 grid of gloo ranks against JAX's on ``cpu_mesh(4, model=2)``: the loss
        within 1e-5 relative, the parameters after Adam within 1e-5·max(1, max|p|) where the gradient is not rounding
        noise, every leaf moved (``test_torch_pp.adam_close``); without the rank's model axis it raises."""
        from test_torch_pp import adam_close
        from test_torch_tp_ep import _cases, jax_tp_step

        from cvml_goalnet_tpu_torch.parallel.dp import make_dp_train_step

        with pytest.raises(ValueError, match="needs the rank's model axis"):
            make_dp_train_step(_port(small_cfg), tensor_parallel=True)
        case = {**_cases(small_cfg)["tp_step"], "axes": (("data", 2), ("model", 2))}
        got = spawn_ranks(RANKS_PP.run_cases, serving_mesh(4, device=CPU), ([case],))[0][0]
        jcfg = _train_cfg(small_cfg)
        js = jax_train_state(jax.random.PRNGKey(0), jcfg)
        start = jax.tree.map(np.asarray, js.params)
        grads, p, loss = jax_tp_step(jcfg, js, case, cpu_mesh(4, model=2))
        assert abs(got["loss"] - loss) <= 1e-5 * abs(loss)
        adam_close(got["params"], p, start, grads, jcfg.train.learning_rate)


def _items(small_cfg, lengths, text=False):
    """The JAX package's VideoItems (tests/test_train.py's seeded ones) and the port's copies of them."""
    from test_train import _make_item

    from cvml_goalnet_tpu.data.dataset import VideoItem as JItem
    from cvml_goalnet_tpu_torch.data.dataset import VideoItem as TItem

    jitems = []
    for seed, n in enumerate(lengths):
        it = _make_item(small_cfg, n=n, seed=seed)
        if text:
            rng = np.random.default_rng(100 + seed)
            it = dataclasses.replace(it, text=rng.integers(0, small_cfg.model.text_vocab_size,
                                                           (n, small_cfg.model.text_max_len)).astype(np.int32))
        jitems.append(it)
    return jitems, [TItem(**{f.name: getattr(it, f.name) for f in dataclasses.fields(JItem)}) for it in jitems]


class TestDpLoop:
    @pytest.mark.parametrize("text", [False, True])
    def test_train_data_parallel_matches_jax(self, small_cfg, capfd, text):
        """Two epochs at 2 ranks against the JAX package's loop on ``cpu_mesh(2)``: every history entry within
        1e-4 relative, the final parameters within 5e-3 (JAX's step tolerance), the epoch count equal."""
        from cvml_goalnet_tpu.data.dataset import VideoDataset as JDS
        from cvml_goalnet_tpu.train.dp_loop import train_data_parallel as jax_train_dp
        from cvml_goalnet_tpu_torch.data.dataset import VideoDataset as TDS
        from cvml_goalnet_tpu_torch.train.dp_loop import train_data_parallel

        jcfg = _train_cfg(_jcfg(small_cfg, True, text_included=text), eps=1e-4)
        jtrain, ttrain = _items(jcfg, (16, 16), text)
        jval, tval = _items(jcfg, (12,), text)
        js = jax_train_state(jax.random.PRNGKey(0), jcfg)
        jfinal, jhist = jax_train_dp(jcfg, JDS(jtrain), JDS(jval), js, num_epochs=2, global_batch=8,
                                     mesh=cpu_mesh(2), verbose=False)
        from cvml_goalnet_tpu_torch.train.optim import adam_init

        params, model_state = W.from_jax(js.params, js.model_state, device=CPU)
        state = TrainState(params, model_state, adam_init(params), 0)
        final, hist = train_data_parallel(_port(jcfg), TDS(ttrain), TDS(tval[:1]), state, num_epochs=2,
                                          global_batch=8, mesh=serving_mesh(2, device=CPU))
        out = capfd.readouterr().out
        assert [line.split("]")[0] for line in out.splitlines() if line.startswith("[dp epoch")] == \
            ["[dp epoch 0", "[dp epoch 1"]
        assert final.epoch == jfinal.epoch == 2 and final.opt_state.step == int(jfinal.opt_state.step) == 8
        for k in ("train_loss", "val_loss", "val_f_avg", "val_f_max"):
            assert len(hist[k]) == 2, k
            np.testing.assert_allclose(hist[k], jhist[k], rtol=1e-4, err_msg=k)
        for k, g, w in _pairs(final.params, jax.tree.map(np.asarray, jfinal.params)):
            np.testing.assert_allclose(g, w, atol=5e-3, err_msg=k)

    def test_refusals_as_jax(self, small_cfg):
        from cvml_goalnet_tpu_torch.config import MeshConfig
        from cvml_goalnet_tpu_torch.data.dataset import VideoDataset as TDS
        from cvml_goalnet_tpu_torch.train.dp_loop import train_data_parallel
        from cvml_goalnet_tpu_torch.train.state import create_train_state

        cfg = _port(small_cfg)
        state = create_train_state(0, cfg, device=CPU)
        _, six = _items(small_cfg, (6,))
        with pytest.raises(ValueError, match="pools only 6 frames"):
            train_data_parallel(cfg, TDS(six), TDS(six), state, mesh=serving_mesh(8, device=CPU), verbose=False)
        _, ten = _items(small_cfg, (10,))
        with pytest.raises(ValueError, match="does not split over the 4 devices"):
            train_data_parallel(cfg, TDS(ten), TDS([]), state, global_batch=6, mesh=serving_mesh(4, device=CPU))
        with pytest.raises(ValueError, match="3 devices not divisible by model axis 2"):   # once: TP refused
            train_data_parallel(dataclasses.replace(cfg, mesh=MeshConfig(data=-1, model=2)), TDS(ten), TDS([]),
                                state, tensor_parallel=True, mesh=serving_mesh(3, device=CPU))
