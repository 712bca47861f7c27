"""PyTorch port: bf16 and int8 inference (``configs/tpu_serving.json``) and bf16 training against the JAX
package, on the CPU.

The same seeded numpy inputs and weights (``weights.from_jax``) go through
``cvml_goalnet_tpu`` and the port's plain versions (``device="cpu"``).

Random weights on random frames score every frame alike (at the preset's
full width all 64 bf16 scores of uniform noise are one value), so a
comparison of such scores would pass a port that printed a constant.  So
every score test first makes its inputs spread and asserts it: structured
frames (sinusoid gratings of random frequency, phase and contrast), audio of
per-frame loudness, and the seeded last fusion layer rescaled so that the
JAX package's float32 logits have a standard deviation of 1.5, then centred
on their median.  Asserted: the JAX float32 scores span at least 1.0, and
its bf16 scores take at least 16 distinct values over 64 frames.

Tolerances:

* int8 at float32: scores within 1e-4 of the JAX package's (the int32 sums
  are exact on both sides; the float32 layers around them sum in another
  order);
* bf16, and bf16 + int8: every score within 0.0625 (2 bf16 ulps on [4, 5])
  and on the bf16 grid; both packages within 0.1 of their float32 scores
  (the drift gate of ``tests/test_precision.py``);
* the plain bf16 forms of kernels 2 and 3 against JAX's XLA chain and the
  Pallas kernels (interpret mode): 2 bf16 ulps of max(|out|, 2·|bias|) (a
  float32 sum that lands on a bf16 tie may round either way, and the bias
  may cancel the sum it was added to); the fusion MLP against the XLA chain
  within 2 ulps of the scores, against the Pallas kernel (float32 between
  layers, one rounding at the end) within 0.0625;
* the bf16 stream with kernel 1 in float32 rounded to bf16 (the JAX scorer
  resizes in bf16): the inputs within 1/128 (about one bf16 ulp of a [0, 1]
  pixel, 0.0039, on either side), the scores within 0.125; host-preprocessed
  uint8 frames (the same bf16 rescale) within 0.0625;
* the spotting trunk under int8: features within 1e-4 of max|JAX|;
* bf16 training, five Adam steps on one sub-batch: the first loss within
  1e-2 relative of the JAX package's, the loss falling, the master params
  float32.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cvml_goalnet_tpu.pipeline as JP
import cvml_goalnet_tpu.serve as JV
import cvml_goalnet_tpu.spotting as JS
import cvml_goalnet_tpu.streaming as JStream
import cvml_goalnet_tpu.train.loop as JL
from cvml_goalnet_tpu.config import PipelineConfig as JaxPipelineConfig
from cvml_goalnet_tpu.models import layers as JLy
from cvml_goalnet_tpu.models.avm import avm_init
from cvml_goalnet_tpu.ops.pallas.fused_mlp import fused_fusion_mlp as pallas_mlp
from cvml_goalnet_tpu.ops.pallas.fused_stage import fused_conv_pool_stage as pallas_stage
from cvml_goalnet_tpu.ops.pallas.fused_stage import reference_stage
from cvml_goalnet_tpu.ops.pallas.matmul import head_matmul_pallas
from cvml_goalnet_tpu.ops.preprocess import preprocess_frames as jax_preprocess
from cvml_goalnet_tpu.train.state import create_train_state as jax_train_state
import cvml_goalnet_tpu_torch.pipeline as TP
import cvml_goalnet_tpu_torch.serve as TV
import cvml_goalnet_tpu_torch.spotting as TS
import cvml_goalnet_tpu_torch.streaming as TStream
from cvml_goalnet_tpu_torch import weights as W
from cvml_goalnet_tpu_torch.config import PipelineConfig
from cvml_goalnet_tpu_torch.ops.cuda.fused_mlp import fused_fusion_mlp
from cvml_goalnet_tpu_torch.ops.cuda.fused_stage import fused_conv_pool_stage
from cvml_goalnet_tpu_torch.ops.cuda.matmul import head_matmul
from cvml_goalnet_tpu_torch.ops.preprocess import preprocess_frames
from cvml_goalnet_tpu_torch.train import loop as TL
from cvml_goalnet_tpu_torch.train.optim import tree_leaves
from cvml_goalnet_tpu_torch.train.state import TrainState

CPU = "cpu"
PRESET = "configs/tpu_serving.json"
MODES = {"bf16": ("bfloat16", False), "int8": ("float32", True), "bf16_int8": ("bfloat16", True)}
N_FRAMES = 64


@pytest.fixture(autouse=True)
def _close_port_batchers():
    yield
    for b in list(TV._live_batchers):
        b.close()


def _with(cfg, dtype="float32", quant=False, **model):
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, dtype=dtype, quantized_inference=quant,
                                                              **model))


def _port(jcfg) -> PipelineConfig:
    return PipelineConfig.from_json(jcfg.to_json())


def _bf16(x) -> np.ndarray:
    return np.array(jnp.asarray(x, jnp.float32).astype(jnp.bfloat16).astype(jnp.float32))


def _on_bf16_grid(x) -> bool:
    return bool(np.array_equal(_bf16(x), np.asarray(x, np.float32)))


def _gratings(n: int, hw, seed: int) -> np.ndarray:
    """(n, h, w, 3) float32 frames in [0, 1]: per channel a sinusoid grating of random frequency, angle and
    phase, at a random contrast and offset, min-max normalised per frame as the preprocess does."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, hw[0]), np.linspace(0, 1, hw[1]), indexing="ij")
    frames = []
    for _ in range(n):
        f, a = rng.uniform(0.5, 6, 3), rng.uniform(0, 2 * np.pi, 3)
        img = np.stack([0.5 + 0.5 * np.sin(2 * np.pi * f[c] * (xx * np.cos(a[c]) + yy * np.sin(a[c])) + a[c])
                        for c in range(3)], -1)
        frames.append(img * rng.uniform(0.1, 1.0) + rng.uniform(0, 0.5))
    v = np.stack(frames).astype(np.float32)
    lo, hi = v.min(axis=(1, 2, 3), keepdims=True), v.max(axis=(1, 2, 3), keepdims=True)
    return ((v - lo) / (hi - lo + 1e-7)).astype(np.float32)


def _features(cfg, n: int, seed: int) -> dict:
    rng = np.random.default_rng(seed + 1)
    audio = rng.standard_normal((n, cfg.audio.bin_length, cfg.audio.n_mfcc)) * rng.uniform(0.1, 30, (n, 1, 1))
    return {"visual": _gratings(n, cfg.preprocess.frame_size, seed), "audio": audio.astype(np.float32)}


def _logits(scores, cfg):
    lo, hi = cfg.model.out_lo, cfg.model.out_hi
    s = np.clip(np.asarray(scores, np.float64), lo + 1e-6, hi - 1e-6)
    return np.log((s - lo) / (hi - s))


def _spread(params, state, feats, jcfg):
    """JAX params whose float32 scores spread: the last fusion layer's w scaled to a logit std of 1.5, then its
    bias centring the logits on their median."""
    f32 = _with(jcfg)
    last = params["fusion"][-1]
    scale = 1.5 / max(float(_logits(JP.fuse(params, state, feats, f32), jcfg).std()), 1e-6)
    out = {**params, "fusion": [*params["fusion"][:-1], {"w": last["w"] * scale, "b": last["b"]}]}
    shift = float(np.median(_logits(JP.fuse(out, state, feats, f32), jcfg)))
    out["fusion"][-1] = {"w": last["w"] * scale, "b": last["b"] - shift}
    return out


def _assert_spread(f32_scores, bf16_scores):
    assert np.ptp(f32_scores) >= 1.0, f"the float32 scores span only {np.ptp(f32_scores)}"
    assert len(np.unique(_bf16(bf16_scores))) >= 16, f"{len(np.unique(_bf16(bf16_scores)))} distinct bf16 scores"


def _tol(dtype: str) -> float:
    return 0.0625 if dtype == "bfloat16" else 1e-4


# ------------------------------------------------------------------ the preset at full width


@pytest.fixture(scope="module")
def preset():
    """The preset's config, spread JAX weights, the port's copy, 64 frames of features split into two videos,
    and the JAX package's ``fuse_many`` scores in float32 and each mode (``fuse`` of the concatenation)."""
    jcfg = JaxPipelineConfig.load(PRESET)
    params, state = avm_init(jax.random.PRNGKey(0), jcfg.model, jcfg.preprocess, jcfg.audio)
    feats = _features(jcfg, N_FRAMES, seed=0)
    params = _spread(params, state, feats, jcfg)
    videos = [{k: v[:40] for k, v in feats.items()}, {k: v[40:] for k, v in feats.items()}]
    want = {name: np.concatenate(JP.fuse_many(params, state, videos, _with(jcfg, *mode)))
            for name, mode in {"f32": ("float32", False), **MODES}.items()}
    tp, ts = W.from_jax(params, state, device=CPU)
    return {"cfg": jcfg, "feats": feats, "videos": videos, "want": want, "port": (tp, ts)}


def test_preset_is_bf16_with_int8():
    cfg = JaxPipelineConfig.load(PRESET)
    assert (cfg.model.dtype, cfg.model.quantized_inference) == ("bfloat16", True)
    assert _port(cfg).model == PipelineConfig.load(PRESET).model


@pytest.mark.parametrize("mode", list(MODES))
def test_preset_fuse_and_fuse_many_match_jax(preset, mode):
    dtype, quant = MODES[mode]
    jcfg = _with(preset["cfg"], dtype, quant)
    want = preset["want"][mode]
    _assert_spread(preset["want"]["f32"], preset["want"]["bf16"])
    tp, ts = preset["port"]
    got = TP.fuse(tp, ts, preset["feats"], _port(jcfg), device=CPU)
    many = TP.fuse_many(tp, ts, preset["videos"], _port(jcfg), device=CPU)
    assert got.dtype == np.float32 and got.shape == (N_FRAMES,)
    assert [len(m) for m in many] == [40, 24] and np.array_equal(np.concatenate(many), got)
    assert np.abs(got - want).max() <= _tol(dtype), np.abs(got - want).max()
    if dtype == "bfloat16":
        assert _on_bf16_grid(got) and _on_bf16_grid(want)
        f32 = preset["want"]["f32"]
        assert np.abs(got - f32).max() <= 0.1 and np.abs(want - f32).max() <= 0.1
    if quant:   # int8 really ran: the scores are not the unquantized ones
        plain = preset["want"]["f32" if dtype == "float32" else "bf16"]
        assert not np.array_equal(got, plain)


def test_preset_runs_through_the_forms_of_its_dtype(preset, monkeypatch):
    """Under the preset conv1 and conv2 take the int8 form at bf16, the head and the MLP their bf16 forms."""
    import cvml_goalnet_tpu_torch.models.visual as TVis
    from cvml_goalnet_tpu_torch.models import avm as TAvm

    seen = []

    def spy(name, fn):
        def wrapped(x, *a, **kw):
            seen.append((name, x.dtype))
            return fn(x, *a, **kw)
        return wrapped

    monkeypatch.setattr(TVis, "fused_conv_pool_stage_int8", spy("stage_int8", TVis.fused_conv_pool_stage_int8))
    monkeypatch.setattr(TVis, "fused_conv_pool_stage", spy("stage", TVis.fused_conv_pool_stage))
    monkeypatch.setattr(TVis, "head_matmul", spy("head", TVis.head_matmul))
    monkeypatch.setattr(TAvm, "fused_fusion_mlp", spy("mlp", TAvm.fused_fusion_mlp))
    tp, ts = preset["port"]
    TP.fuse(tp, ts, {k: v[:4] for k, v in preset["feats"].items()}, _port(preset["cfg"]), device=CPU)
    bf = torch.bfloat16
    assert seen == [("stage_int8", bf), ("stage_int8", bf), ("head", bf), ("mlp", bf)]


# ------------------------------------------------------------------ the plain bf16 forms


def _tie_tol(want: np.ndarray, scale: np.ndarray) -> np.ndarray:
    ref = np.maximum(np.abs(want), scale)
    return 2 * np.exp2(np.floor(np.log2(np.maximum(ref, 2.0 ** -126))) - 7)


def _bias_window(b: np.ndarray) -> np.ndarray:
    """max |b| over each 3×3 pool window, (H − 2, W − 2, C)."""
    a = np.abs(b)
    h, w = a.shape[:2]
    return np.max([a[dy:dy + h - 2, dx:dx + w - 2] for dy in range(3) for dx in range(3)], axis=0)


@pytest.mark.parametrize("n,hh,cin,cout", [(4, 13, 64, 256), (2, 11, 256, 512), (3, 9, 20, 70)])
def test_stage_bf16_plain_matches_xla_and_pallas(n, hh, cin, cout):
    g = np.random.default_rng(6)
    x = _bf16(np.abs(g.standard_normal((n, hh, hh, cin))))
    w = _bf16(g.standard_normal((3, 3, cin, cout)) * 0.05)
    b = _bf16(g.standard_normal((hh, hh, cout)) * 0.1)
    jx, jw, jb = (jnp.asarray(t).astype(jnp.bfloat16) for t in (x, w, b))
    got = fused_conv_pool_stage(*(torch.from_numpy(t).to(torch.bfloat16) for t in (x, w, b)))
    assert got.dtype == torch.bfloat16
    got = got.to(torch.float32).numpy()
    tol = _tie_tol(got, 2 * _bias_window(b)[None])
    for want in (reference_stage(jx, jw, jb), pallas_stage(jx, jw, jb, 4, True)):
        want = np.asarray(want.astype(jnp.float32))
        assert (np.abs(got - want) <= tol).all(), np.abs(got - want).max()
    assert np.mean(got == np.asarray(reference_stage(jx, jw, jb).astype(jnp.float32))) > 0.99


@pytest.mark.parametrize("m,k,n", [(16, 2304, 64), (5, 384, 24)])
def test_head_bf16_plain_matches_xla_and_pallas(m, k, n):
    g = np.random.default_rng(7)
    x = _bf16(np.abs(g.standard_normal((m, k))))
    w = _bf16(g.standard_normal((k, n)) * k ** -0.5)
    b = _bf16(g.standard_normal(n) * 0.1)
    jx, jw, jb = (jnp.asarray(t).astype(jnp.bfloat16) for t in (x, w, b))
    got = head_matmul(*(torch.from_numpy(t).to(torch.bfloat16) for t in (x, w, b)))
    assert got.dtype == torch.bfloat16
    got = got.to(torch.float32).numpy()
    tol = _tie_tol(got, 2 * np.abs(b)[None])
    xla = jax.nn.relu(JLy.linear_apply({"w": jw, "b": jb}, jx))
    for want in (xla, head_matmul_pallas(jx, jw, jb, True, 8, k // 3, True)):
        want = np.asarray(want.astype(jnp.float32))
        assert (np.abs(got - want) <= tol).all(), np.abs(got - want).max()


@pytest.mark.parametrize("squash", [True, False])
def test_mlp_bf16_plain_matches_xla_and_pallas(squash):
    cfg = JaxPipelineConfig.load(PRESET)
    params, _ = avm_init(jax.random.PRNGKey(3), cfg.model, cfg.preprocess, cfg.audio)
    g = np.random.default_rng(8)
    x = _bf16(g.random((37, 640)) * 3)
    fusion = [{k: jnp.asarray(v).astype(jnp.bfloat16) for k, v in lp.items()} for lp in params["fusion"]]
    fusion[-1] = {"w": fusion[-1]["w"] * 40, "b": fusion[-1]["b"]}   # scores across [1, 5]
    h = jnp.asarray(x).astype(jnp.bfloat16)
    for i, lp in enumerate(fusion):
        h = JLy.linear_apply(lp, h)
        if i < len(fusion) - 1:
            h = jax.nn.relu(h)
    xla = np.asarray((4.0 * jax.nn.sigmoid(h) + 1.0 if squash else h).astype(jnp.float32))
    layers = [{k: torch.from_numpy(np.array(v.astype(jnp.float32))).to(torch.bfloat16) for k, v in lp.items()}
              for lp in fusion]
    got = fused_fusion_mlp(torch.from_numpy(x).to(torch.bfloat16), layers, 1.0, 5.0, squash)
    assert got.dtype == torch.bfloat16
    got = got.to(torch.float32).numpy()
    assert _on_bf16_grid(got)
    np.testing.assert_array_less(np.abs(got - xla), _tie_tol(xla, np.zeros(())) + 1e-30)
    if squash:
        assert np.ptp(got) >= 1.0
        pallas = np.asarray(pallas_mlp(jnp.asarray(x).astype(jnp.bfloat16), tuple(fusion), 1.0, 5.0, 8, True))
        assert np.abs(got - pallas).max() <= 0.0625


# ------------------------------------------------------------------ stream, services and spotting at small width


@pytest.fixture(scope="module")
def small_trunk(small_cfg):
    """The suite's small config with audio, a JAX trunk whose scores spread on 64 gratings, and the port's."""
    js = jax_train_state(jax.random.PRNGKey(5), small_cfg)
    feats = _features(small_cfg, N_FRAMES, seed=2)
    params = _spread(js.params, js.model_state, feats, small_cfg)
    js = js._replace(params=params)
    tp, tms = W.from_jax(params, js.model_state, device=CPU)
    return js, TrainState(params=tp, model_state=tms, opt_state=None, epoch=0), feats


def _raw_gratings(n: int, seed: int) -> np.ndarray:
    return np.clip(_gratings(n, (48, 64), seed) * 255, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("host_preprocess", [False, True])
def test_stream_matches_jax(small_cfg, small_trunk, mode, host_preprocess):
    """40 frames in chunks of 16, 16 and 8 (under int8 the JAX scorer's zero-padding of the last chunk to 16
    changes its scale, and the port pads it the same way)."""
    js, ts, feats = small_trunk
    jcfg = _with(small_cfg, *MODES[mode])
    raw = _raw_gratings(40, seed=3)
    chunks = [raw[i:i + 16] for i in range(0, 40, 16)]
    audio = [feats["audio"][i:min(i + 16, 40)] for i in range(0, 40, 16)]

    def run(stream, state, cfg, **more):
        kw = {"host_preprocess": True, "transfer_dtype": np.uint8} if host_preprocess else {}
        return stream.score_video_stream(state.params, state.model_state, iter(chunks), cfg, chunk_size=16,
                                         audio_chunks=iter(audio), **kw, **more)[0]

    want, got = run(JStream, js, jcfg), run(TStream, ts, _port(jcfg), device=CPU)
    f32, bf16 = run(JStream, js, _with(jcfg)), run(JStream, js, _with(jcfg, "bfloat16"))
    assert np.ptp(f32) >= 1.0 and len(np.unique(_bf16(bf16))) >= 16
    tol = _tol(MODES[mode][0]) * (1 if host_preprocess else 2)
    assert got.shape == (40,) and np.abs(got - want).max() <= tol, np.abs(got - want).max()
    if MODES[mode][0] == "bfloat16":
        assert _on_bf16_grid(got)


def test_stream_inputs_differ_by_about_one_bf16_ulp_of_a_pixel():
    """Kernel 1's float32 output rounded to bf16 against the JAX scorer's bf16 resize."""
    raw = _raw_gratings(8, seed=4)
    got = preprocess_frames(torch.from_numpy(raw), (24, 24)).to(torch.bfloat16).to(torch.float32).numpy()
    want = np.asarray(jax_preprocess(jnp.asarray(raw), (24, 24), 1e-7, jnp.bfloat16).astype(jnp.bfloat16)
                      .astype(jnp.float32))
    assert np.abs(got - want).max() <= 1 / 128


def test_summarizer_and_batcher_under_int8_pad_as_jax(small_cfg, small_trunk):
    js, ts, feats = small_trunk
    jcfg = _with(small_cfg, "bfloat16", True)
    raw = _raw_gratings(30, seed=5)
    jsum, tsum = JV.Summarizer(jcfg, state=js), TV.Summarizer(_port(jcfg), state=ts, device=CPU)
    want, got = jsum.summarize_frames("v", raw), tsum.summarize_frames("v", raw)
    assert np.abs(got.scores - np.asarray(want.scores)).max() <= 0.0625 and _on_bf16_grid(got.scores)
    # an assembled batch of 40 frames: a chunk of the largest bucket (32), then 8 frames padded to 16
    jb = JV.DynamicBatcher(jsum, max_batch_frames=64, buckets=(16, 32))
    tb = TV.DynamicBatcher(tsum, max_batch_frames=64, buckets=(16, 32))
    try:
        visual, audio = feats["visual"][:40], feats["audio"][:40]
        want = jb._scores_chunked(visual, audio, None, jcfg)
        got = tb._scores_chunked(visual, torch.from_numpy(audio))
    finally:
        jb.close()
        tb.close()
    assert got.shape == (40,) and np.abs(got - want).max() <= 0.0625
    f32 = JP.fuse(js.params, js.model_state, {"visual": visual, "audio": audio}, _with(small_cfg))
    assert np.ptp(f32) >= 1.0 and len(np.unique(got)) >= 16
    # the tail is scored with its 8 zero rows, as the JAX batcher pads it (the int8 scale spans them)
    padded = TP.fuse(ts.params, ts.model_state, {"visual": np.concatenate([visual[32:], np.zeros_like(visual[:8])]),
                                                 "audio": np.concatenate([audio[32:], np.zeros_like(audio[:8])])},
                     _port(jcfg), device=CPU)[:8]
    np.testing.assert_array_equal(got[32:], padded)


def test_spotting_trunk_under_int8_matches_jax(small_cfg, small_trunk):
    js, ts, feats = small_trunk
    jcfg = _with(small_cfg, "bfloat16", True)   # the trunk casts nothing: float32 with int8 conv1 and conv2
    want = np.asarray(JS.encode_timeline(js.params, js.model_state, feats["visual"], feats["audio"], jcfg))
    got = TS.encode_timeline(ts.params, ts.model_state, feats["visual"], feats["audio"], _port(jcfg), device=CPU)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4 * np.abs(want).max(), rtol=0)
    unquantized = np.asarray(JS.encode_timeline(js.params, js.model_state, feats["visual"], feats["audio"],
                                                _with(small_cfg)))
    assert np.abs(unquantized - want).max() > 1e-4 * np.abs(want).max()


# ------------------------------------------------------------------ bf16 training


def test_five_bf16_train_steps_match_jax(small_cfg):
    jcfg = dataclasses.replace(small_cfg, model=dataclasses.replace(small_cfg.model, dropout_rate=0.0),
                               train=dataclasses.replace(small_cfg.train, compute_dtype="bfloat16"))
    js = jax_train_state(jax.random.PRNGKey(9), jcfg)
    S = jcfg.train.subbatch_size
    g = np.random.default_rng(10)
    visual = _gratings(S, jcfg.preprocess.frame_size, seed=11)
    audio = g.random((S, jcfg.audio.bin_length, jcfg.audio.n_mfcc)).astype(np.float32)
    labels = g.integers(1, 6, S).astype(np.float32)
    valid = np.ones(S, np.float32)
    jfn = JL.make_train_video_fn(jcfg)
    tfn = TL.make_train_video_fn(_port(jcfg))
    tp, tms = W.from_jax(js.params, js.model_state, device=CPU)
    from cvml_goalnet_tpu_torch.train.optim import adam_init

    topt = adam_init(tp)
    jp, jms, jopt = js.params, js.model_state, js.opt_state
    t_in = [torch.from_numpy(a) for a in (visual, audio, labels, valid)]
    j_losses, t_losses = [], []
    for _ in range(5):
        jp, jms, jopt, _, jl = jfn(jp, jms, jopt, jnp.asarray(visual), jnp.asarray(audio), jnp.asarray(labels),
                                   jnp.asarray(valid), jax.random.PRNGKey(0))
        tp, tms, topt, preds, tl = tfn(tp, tms, topt, *t_in, None)
        j_losses.append(float(jl))
        t_losses.append(float(tl))
    assert t_losses[0] == pytest.approx(j_losses[0], rel=1e-2)
    assert t_losses[-1] < t_losses[0] and j_losses[-1] < j_losses[0], (t_losses, j_losses)
    assert all(p.dtype == torch.float32 for p in tree_leaves(tp)) and preds.dtype == torch.float32
    assert all(s.dtype == torch.float32 for s in tree_leaves(tms))
