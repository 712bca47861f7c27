"""PyTorch port: the text (commentary) branch against the JAX package, on the CPU.

The same seeded numpy inputs and weights (JAX's ``avm_init`` through
``weights.from_jax``) go through ``cvml_goalnet_tpu`` and the port with
``device="cpu"``.  Tolerances:

* token ids, the sidecar and its per-frame alignment: exact;
* ``text_encoder_apply`` and ``multihead_attention``: 1e-5·max(1, max|f|)
  in float32, 2 bf16 ulps of each value in bf16 (both on inputs with a row
  of empty commentary);
* ``fuse`` / ``fuse_many`` / ``encode_timeline`` with text: 1e-5 in
  float32; under ``configs/tpu_serving.json`` within 0.0625 and on the bf16
  grid (``tests/test_torch_moe.py`` holds the preset with both flags).
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cvml_goalnet_tpu.pipeline as JP
import cvml_goalnet_tpu.spotting as JS
from cvml_goalnet_tpu.config import ModelConfig as JaxModelConfig
from cvml_goalnet_tpu.config import PipelineConfig as JaxPipelineConfig
from cvml_goalnet_tpu.data import text as JT
from cvml_goalnet_tpu.data.dataset import build_video_item as jax_build_video_item
from cvml_goalnet_tpu.models import layers as JL
from cvml_goalnet_tpu.models.avm import avm_init
from cvml_goalnet_tpu.models.text import _sinusoidal_positions as jax_positions
from cvml_goalnet_tpu.models.text import text_encoder_apply as jax_text_encoder
from cvml_goalnet_tpu.models.text import text_encoder_init
from cvml_goalnet_tpu.utils import tree_cast as jax_cast
import cvml_goalnet_tpu_torch.pipeline as TP
import cvml_goalnet_tpu_torch.spotting as TS
from cvml_goalnet_tpu_torch import weights as W
from cvml_goalnet_tpu_torch.config import ModelConfig, PipelineConfig
from cvml_goalnet_tpu_torch.data import dataset as TD
from cvml_goalnet_tpu_torch.data import text as TT
from cvml_goalnet_tpu_torch.models import layers as L
from cvml_goalnet_tpu_torch.models.text import _sinusoidal_positions, check_text_config, text_encoder_apply
from cvml_goalnet_tpu_torch.utils import tree_cast

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"
LINES = ["", "Goal! What a strike from the edge of the box", "Ça commence: l'arbitre siffle — 1-0 à la 12e",
         "o'neill's cross, it's in", "one two three four five six seven eight nine ten eleven twelve thirteen",
         "", "corner KICK", "  ...  "]


def _port(jcfg) -> PipelineConfig:
    return PipelineConfig.from_json(jcfg.to_json())


def _text_cfg(small_cfg, **model):
    return dataclasses.replace(small_cfg, model=dataclasses.replace(small_cfg.model, text_included=True, **model))


def _ulp(x: np.ndarray) -> np.ndarray:
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126))) - 7)


def _assert_close(got, want, dtype):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    if dtype == "bfloat16":
        assert np.all(np.abs(got - want) <= 2 * _ulp(want)), np.abs(got - want).max()
    else:
        np.testing.assert_allclose(got, want, atol=1e-5 * max(1.0, float(np.abs(want).max())), rtol=0)


# ------------------------------------------------------------------ the tokeniser and the sidecar


@pytest.mark.parametrize("vocab,max_len", [(32768, 64), (128, 12), (2, 5), (7, 1)])
def test_tokenize_ids_equal_jax(vocab, max_len):
    got = TT.tokenize(LINES, vocab, max_len)
    want = JT.tokenize(LINES, vocab, max_len)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert (got[0] == 0).all() and (got[5] == 0).all()
    assert got.max() < vocab
    if vocab == 2:
        assert set(np.unique(got)) <= {0, 1}


def test_tokenize_words_hashes_and_truncation():
    """Lowercased ``[a-z0-9']+`` words (non-ASCII letters split words), FNV-1a over UTF-8, the first max_len."""
    ids = TT.tokenize(["It's O'Neill", "é" * 3, " ".join(map(str, range(70)))], 32768, 64)
    assert list(ids[0, :2]) == [1 + TT._fnv1a(w) % 32767 for w in ("it's", "o'neill")] and ids[0, 2] == 0
    assert (ids[1] == 0).all()
    assert (ids[2] > 0).all() and ids[2, -1] == 1 + TT._fnv1a("63") % 32767
    assert TT._fnv1a("goal") == JT._fnv1a("goal") and TT._fnv1a("ça") == JT._fnv1a("ça")


@pytest.mark.parametrize("vocab", [1, 0, -3])
def test_tokenize_refuses_a_vocab_below_2_as_jax(vocab):
    with pytest.raises(ValueError) as got:
        TT.tokenize(["goal"], vocab, 4)
    with pytest.raises(ValueError) as want:
        JT.tokenize(["goal"], vocab, 4)
    assert str(got.value) == str(want.value)


def test_sidecar_and_alignment_equal_jax(tmp_path):
    path = tmp_path / "m.commentary.jsonl"
    rows = [{"frame": 300, "text": "second"}, {"frame": 0, "text": "kick off"}, {"frame": 95, "text": "shot"},
            {"frame": 95, "text": "same frame"}, {"frame": 1000, "text": "late"}]
    path.write_text("\n".join(json.dumps(r) for r in rows[:2]) + "\n\n" + "\n".join(json.dumps(r) for r in rows[2:]))
    got, want = TT.load_commentary_jsonl(str(path)), JT.load_commentary_jsonl(str(path))
    assert got == want and [f for f, _ in got] == [0, 95, 95, 300, 1000]
    for n, skip in ((12, 30), (40, 7), (0, 30), (3, 1)):
        assert TT.commentary_per_frame(got, n, skip) == JT.commentary_per_frame(want, n, skip)
    assert TT.commentary_per_frame([(60, "x")], 4, 30) == ["", "", "x", "x"]
    assert TT.commentary_sidecar(str(tmp_path / "m.npz"), 4, 30) == JT.commentary_per_frame(want, 4, 30)
    assert TT.commentary_sidecar(str(tmp_path / "absent.npz"), 4, 30) is None


# ------------------------------------------------------------------ the encoder


def test_sinusoidal_positions_equal_jax():
    for t, d in ((64, 128), (12, 16), (1, 2)):
        np.testing.assert_array_equal(_sinusoidal_positions(t, d), jax_positions(t, d))


def _encoder(model_kw, seed=0):
    jm = dataclasses.replace(JaxModelConfig(), text_included=True, **model_kw)
    params = text_encoder_init(jax.random.PRNGKey(seed), jm)
    # layernorms away from the identity, so their scale and shift are exercised
    rng = np.random.default_rng(seed)
    for layer in params["layers"]:
        for ln in ("ln1", "ln2"):
            d = layer[ln]["scale"].shape[0]
            layer[ln] = {"scale": jnp.asarray(1 + 0.2 * rng.standard_normal(d), jnp.float32),
                         "bias": jnp.asarray(0.2 * rng.standard_normal(d), jnp.float32)}
    return jm, ModelConfig(**{k: v for k, v in dataclasses.asdict(jm).items()}), params


WIDTHS = {
    "small": dict(text_vocab_size=128, text_embed_dim=16, text_num_layers=1, text_num_heads=2,
                  text_feature_dim=16, text_max_len=12),
    "full": {},   # ModelConfig's defaults: vocab 32,768, d 128, 2 layers, 4 heads, 128 features, 64 tokens
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("width", list(WIDTHS))
def test_text_encoder_matches_jax(width, dtype):
    jm, tm, params = _encoder(WIDTHS[width])
    ids = JT.tokenize(LINES, jm.text_vocab_size, jm.text_max_len)
    tp = W.tree_from_jax(params, CPU)
    if dtype == "bfloat16":
        params, tp = jax_cast(params, jnp.bfloat16), tree_cast(tp, torch.bfloat16)
    want = np.asarray(jax_text_encoder(params, jnp.asarray(ids), cfg=jm).astype(jnp.float32))
    got = text_encoder_apply(tp, torch.as_tensor(ids), cfg=tm)
    assert got.dtype == (torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    _assert_close(got.to(torch.float32).numpy(), want, dtype)
    assert np.isfinite(want).all() and np.ptp(want[1]) > 0


def test_empty_commentary_row_is_relu_of_the_head_bias():
    """A row of padding attends uniformly (masked logits −1e30, not −inf: never NaN) and pools to 0."""
    jm, tm, params = _encoder(WIDTHS["small"])
    tp = W.tree_from_jax(params, CPU)
    out = text_encoder_apply(tp, torch.zeros((3, jm.text_max_len), dtype=torch.int32), cfg=tm)
    want = torch.relu(tp["head"]["b"]).expand(3, -1)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out, want, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_multihead_attention_matches_jax(dtype):
    rng = np.random.default_rng(3)
    d, heads = 32, 4
    layer = {k: {"w": rng.standard_normal((d, d)).astype(np.float32) / np.sqrt(d),
                 "b": (0.1 * rng.standard_normal(d)).astype(np.float32)} for k in ("wq", "wk", "wv", "wo")}
    x = (2 * rng.standard_normal((5, 9, d))).astype(np.float32)
    mask = rng.random((5, 9)) < 0.6
    mask[2] = False   # a row with no valid key
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (jnp.float32, torch.float32)
    jl = jax_cast(jax.tree.map(jnp.asarray, layer), jdt)
    want = np.asarray(JL.multihead_attention(jl, jnp.asarray(x).astype(jdt), heads,
                                             mask=jnp.asarray(mask)).astype(jnp.float32))
    got = L.multihead_attention(tree_cast(W.tree_from_jax(layer, CPU), tdt), torch.as_tensor(x).to(tdt), heads,
                                mask=torch.as_tensor(mask))
    _assert_close(got.to(torch.float32).numpy(), want, dtype)


@pytest.mark.parametrize("d,heads", [(15, 3), (16, 3), (12, 8)])
def test_bad_widths_raise_as_jax(d, heads):
    jm = dataclasses.replace(JaxModelConfig(), text_embed_dim=d, text_num_heads=heads)
    with pytest.raises(ValueError) as want:
        text_encoder_init(jax.random.PRNGKey(0), jm)
    with pytest.raises(ValueError) as got:
        check_text_config(ModelConfig(text_embed_dim=d, text_num_heads=heads))
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="must be even and divisible"):
        W.init_params(PipelineConfig(model=ModelConfig(text_included=True, text_embed_dim=d, text_num_heads=heads)), 0)


# ------------------------------------------------------------------ the entry points


def _random_features(cfg, n, seed, lines=LINES):
    rng = np.random.default_rng(seed)
    h, w = cfg.preprocess.frame_size
    return {"visual": rng.random((n, h, w, cfg.preprocess.channels)).astype(np.float32),
            "audio": rng.standard_normal((n, cfg.audio.bin_length, cfg.audio.n_mfcc)).astype(np.float32),
            "text": JT.tokenize([lines[i % len(lines)] for i in range(n)], cfg.model.text_vocab_size,
                                cfg.model.text_max_len)}


@pytest.fixture(scope="module")
def trunk(small_cfg):
    jcfg = _text_cfg(small_cfg)
    params, state = avm_init(jax.random.PRNGKey(5), jcfg.model, jcfg.preprocess, jcfg.audio)
    return jcfg, params, state, W.from_jax(params, state, device=CPU)


@pytest.mark.parametrize("audio", [True, False])
def test_fuse_and_fuse_many_with_text_match_jax(trunk, audio):
    jcfg, params, state, (tp, ts) = trunk
    jcfg = dataclasses.replace(jcfg, model=dataclasses.replace(jcfg.model, audio_included=audio))
    if not audio:
        params = {k: v for k, v in params.items() if k != "audio"}
        params["fusion"] = avm_init(jax.random.PRNGKey(5), jcfg.model, jcfg.preprocess, jcfg.audio)[0]["fusion"]
        tp, ts = W.from_jax(params, state, device=CPU)
    feats = _random_features(jcfg, 11, seed=1)
    want = JP.fuse(params, state, feats, jcfg)
    got = TP.fuse(tp, ts, feats, _port(jcfg), device=CPU)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    videos = [{k: v[:4] for k, v in feats.items()}, {k: v[4:] for k, v in feats.items()}]
    many = TP.fuse_many(tp, ts, videos, _port(jcfg), device=CPU)
    np.testing.assert_allclose(np.concatenate(many), np.concatenate(JP.fuse_many(params, state, videos, jcfg)),
                               atol=1e-5, rtol=0)
    # text= takes the place of features["text"], as in the JAX package
    other = JT.tokenize(["a different line"] * 11, jcfg.model.text_vocab_size, jcfg.model.text_max_len)
    np.testing.assert_allclose(TP.fuse(tp, ts, feats, _port(jcfg), device=CPU, text=other),
                               JP.fuse(params, state, feats, jcfg, text=other), atol=1e-5, rtol=0)


def test_missing_text_raises_jax_words(trunk):
    jcfg, params, state, (tp, ts) = trunk
    feats = _random_features(jcfg, 3, seed=2)
    no_text = {**feats, "text": None}
    messages = []
    for fn, p, s, c in ((TP.fuse, tp, ts, _port(jcfg)), (JP.fuse, params, state, jcfg)):
        with pytest.raises(ValueError) as e:
            fn(p, s, no_text, c, **({"device": CPU} if fn is TP.fuse else {}))
        messages.append(str(e.value))
    assert messages[0] == messages[1]
    messages = []
    for fn, p, s, c in ((TP.fuse_many, tp, ts, _port(jcfg)), (JP.fuse_many, params, state, jcfg)):
        with pytest.raises(ValueError) as e:
            fn(p, s, [feats, no_text], c, **({"device": CPU} if fn is TP.fuse_many else {}))
        messages.append(str(e.value))
    assert messages[0] == messages[1] and "features_list[1]['text'] is None" in messages[0]


def test_extract_features_tokenizes_as_jax(small_cfg):
    jcfg = _text_cfg(small_cfg)
    frames = np.random.default_rng(0).integers(0, 255, (len(LINES), 30, 40, 3), dtype=np.uint8)
    got = TP.extract_features(frames, None, _port(jcfg), commentary=LINES, device=CPU)
    want = JP.extract_features(frames, None, jcfg, commentary=LINES)
    assert got["text"].dtype == torch.int32
    np.testing.assert_array_equal(got["text"].numpy(), want["text"])
    assert TP.extract_features(frames, None, _port(jcfg), device=CPU)["text"] is None
    with pytest.raises(ValueError, match="one commentary string per frame"):
        TP.extract_features(frames, None, _port(jcfg), commentary=LINES[:-1], device=CPU)


def test_encode_timeline_with_text_matches_jax(trunk):
    jcfg, params, state, (tp, ts) = trunk
    feats = _random_features(jcfg, 13, seed=3)
    want = np.asarray(JS.encode_timeline(params, state, jnp.asarray(feats["visual"]), jnp.asarray(feats["audio"]),
                                         jcfg, text=jnp.asarray(feats["text"])))
    got = TS.encode_timeline(tp, ts, feats["visual"], feats["audio"], _port(jcfg), device=CPU, text=feats["text"])
    assert got.shape == (13, jcfg.model.aud_feature_dim + jcfg.model.vis_feature_dim + jcfg.model.text_feature_dim)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5 * max(1.0, float(np.abs(want).max())), rtol=0)
    messages = []
    for fn, p, s, c, kw in ((TS.encode_timeline, tp, ts, _port(jcfg), {"device": CPU}),
                            (JS.encode_timeline, params, state, jcfg, {})):
        with pytest.raises(ValueError) as e:
            fn(p, s, feats["visual"], feats["audio"], c, **kw)
        messages.append(str(e.value))
    assert messages[0] == messages[1]


@pytest.mark.parametrize("sidecar", [True, False])
def test_build_video_item_reads_the_sidecar_as_jax(synth_dir, small_cfg, tmp_path, sidecar):
    """The commentary sidecar next to the video, aligned per condensed frame; without one every frame is ""."""
    import shutil

    src = synth_dir["video_fps"][0]
    video = str(tmp_path / os.path.basename(src))
    shutil.copy(src, video)
    if sidecar:
        with open(video.rsplit(".", 1)[0] + ".commentary.jsonl", "w") as f:
            for frame, line in ((0, "kick off"), (45, "a long ball forward"), (150, "GOAL! 1-0")):
                f.write(json.dumps({"frame": frame, "text": line}) + "\n")
    jcfg = _text_cfg(small_cfg)
    want = jax_build_video_item(video, jcfg, None, None, False)
    got = TD.build_video_item(video, _port(jcfg), None, None, False, device=CPU)
    np.testing.assert_array_equal(got.text.numpy(), want.text)
    assert (got.text.numpy()[1:].any(axis=1).all()) == sidecar
    assert TD.build_video_item(video, _port(small_cfg), None, None, False, device=CPU).text is None


def test_new_modules_import_no_jax():
    """A fresh interpreter: the text branch's and MoE's modules leave jax and cvml_goalnet_tpu out of
    sys.modules."""
    code = (
        "import sys\n"
        "import cvml_goalnet_tpu_torch.models.text, cvml_goalnet_tpu_torch.models.moe\n"
        "import cvml_goalnet_tpu_torch.data.text\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'cvml_goalnet_tpu' or m.startswith('cvml_goalnet_tpu.'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
