"""PyTorch port: the mixture-of-experts fusion, alone and with the text branch, against the JAX package, on
the CPU.

The same seeded numpy inputs and weights (JAX's ``avm_init`` /
``moe_init`` through ``weights.from_jax``) go through ``cvml_goalnet_tpu``
and the port with ``device="cpu"``.  Tolerances:

* ``moe_gate_probs`` (with ties and ``top_k >= E``), ``moe_apply`` and
  ``moe_load_balance_loss``: 1e-6 in float32, 2 bf16 ulps in bf16;
* their gradients, the train forward's and a sub-batch's: 1e-5·max(1,
  max|want|) per leaf (the summarization training tests' tolerance);
* ``fuse`` / ``fuse_many`` with MoE, and with MoE and text: 1e-5 in float32;
  ``configs/tpu_serving.json`` with both flags: within 0.0625 and on the
  bf16 grid, after asserting that the scores spread (as
  ``tests/test_torch_bf16.py`` does);
* one epoch of ``train_importance_model`` with both flags: the history 1e-5
  relative, F-scores equal.
"""

from __future__ import annotations

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cvml_goalnet_tpu.pipeline as JP
import cvml_goalnet_tpu.train.loop as JL
from cvml_goalnet_tpu.config import PipelineConfig as JaxPipelineConfig
from cvml_goalnet_tpu.data import text as JT
from cvml_goalnet_tpu.data.dataset import VideoDataset as JDS
from cvml_goalnet_tpu.data.dataset import VideoItem as JItem
from cvml_goalnet_tpu.data.synthetic import synthetic_change_points
from cvml_goalnet_tpu.models import moe as JM
from cvml_goalnet_tpu.models.avm import avm_apply as jax_avm
from cvml_goalnet_tpu.models.avm import avm_init
from cvml_goalnet_tpu.train.checkpoint import load_checkpoint as jax_load_checkpoint
from cvml_goalnet_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from cvml_goalnet_tpu.train.state import create_train_state as jax_state
from cvml_goalnet_tpu.utils import tree_cast as jax_cast
import cvml_goalnet_tpu_torch.pipeline as TP
from cvml_goalnet_tpu_torch import weights as W
from cvml_goalnet_tpu_torch.config import PipelineConfig
from cvml_goalnet_tpu_torch.data.dataset import VideoDataset as TDS
from cvml_goalnet_tpu_torch.data.dataset import VideoItem as TItem
from cvml_goalnet_tpu_torch.models import moe as TM
from cvml_goalnet_tpu_torch.models.avm import _fused_input, avm_apply, avm_train_apply
from cvml_goalnet_tpu_torch.models.visual import visual_encoder_apply
from cvml_goalnet_tpu_torch.train import loop as TL
from cvml_goalnet_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from cvml_goalnet_tpu_torch.train.optim import AdamState
from cvml_goalnet_tpu_torch.train.state import TrainState, create_train_state
from cvml_goalnet_tpu_torch.utils import tree_cast
from tests.test_torch_bf16 import _features as bf16_features
from tests.test_torch_bf16 import _spread as bf16_spread

CPU = "cpu"
E = 4
PRESET = "configs/tpu_serving.json"
LINES = ["", "goal", "a shot from distance", "", "corner to the far post", "free kick", "what a save by the keeper"]


def _port(jcfg) -> PipelineConfig:
    return PipelineConfig.from_json(jcfg.to_json())


def _with(cfg, **model):
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, **model))


def _np(tree):
    return jax.tree.map(lambda x: np.asarray(x.detach() if isinstance(x, torch.Tensor) else x), tree)


def _close(got, want, tol=1e-5):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=tol * max(1.0, float(np.abs(want).max(initial=0))), rtol=0)


def _close_trees(got, want, tol=1e-5):
    g, w = jax.tree.leaves(_np(got)), jax.tree.leaves(_np(want))
    assert len(g) == len(w)
    for a, b in zip(g, w):
        _close(a, b, tol)


def _ulp(x):
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126))) - 7)


def _tied_moe(seed=0, din=24, dout=16):
    """MoE params whose gate has two identical experts' columns (1 and 2): their logits tie on every row."""
    p = JM.moe_init(jax.random.PRNGKey(seed), din, dout, E)
    gw, gb = np.asarray(p["gate"]["w"]).copy(), np.asarray(p["gate"]["b"]).copy()
    gw[:, 2], gb[2] = gw[:, 1], gb[1]
    gw[:, 1] *= 3.0   # make the tied pair win often
    gw[:, 2] = gw[:, 1]
    return {**p, "gate": {"w": jnp.asarray(gw), "b": jnp.asarray(gb)}}


def _x(n=40, din=24, seed=1):
    x = np.random.default_rng(seed).standard_normal((n, din)).astype(np.float32)
    x[0] = 0.0   # every logit is its bias: the tied pair ties at the top here
    return x


# ------------------------------------------------------------------ the layer


@pytest.mark.parametrize("top_k", [1, 2, 3, E, E + 2])
def test_gate_probs_match_jax_with_ties(top_k):
    p, x = _tied_moe(), _x()
    want = np.asarray(JM.moe_gate_probs(p, jnp.asarray(x), top_k))
    got = TM.moe_gate_probs(W.tree_from_jax(p, CPU), torch.as_tensor(x), top_k).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    kept = (got > 0).sum(axis=1)
    if top_k < E:
        # a tie at the k-th logit keeps every tied expert, as JAX's `>=` does (never fewer than k)
        assert kept.min() >= top_k and kept.max() > top_k
    else:
        assert (kept == E).all()   # nothing masked
    np.testing.assert_allclose(got.sum(axis=1), 1.0, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("top_k", [1, 2, E])
def test_moe_apply_and_balance_loss_match_jax(top_k, dtype):
    p, x = _tied_moe(2), _x(seed=3)
    tp = W.tree_from_jax(p, CPU)
    xt = torch.as_tensor(x)
    if dtype == "bfloat16":
        p, tp = jax_cast(p, jnp.bfloat16), tree_cast(tp, torch.bfloat16)
        jx, xt = jnp.asarray(x).astype(jnp.bfloat16), xt.to(torch.bfloat16)
    else:
        jx = jnp.asarray(x)
    want = np.asarray(JM.moe_apply(p, jx, top_k).astype(jnp.float32))
    got = TM.moe_apply(tp, xt, top_k).to(torch.float32).numpy()
    if dtype == "bfloat16":
        assert np.all(np.abs(got - want) <= 2 * _ulp(want)), np.abs(got - want).max()
    else:
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    probs = JM.moe_gate_probs(p, jx, top_k).astype(jnp.float32)
    tprobs = TM.moe_gate_probs(tp, xt, top_k).to(torch.float32)
    np.testing.assert_allclose(float(TM.moe_load_balance_loss(tprobs)), float(JM.moe_load_balance_loss(probs)),
                               atol=1e-6, rtol=0)


def test_balance_loss_takes_the_first_maximum():
    probs = np.array([[0.5, 0.5, 0, 0], [0.25, 0.25, 0.25, 0.25], [0, 0.1, 0.9, 0], [0, 0, 0.5, 0.5]], np.float32)
    got = float(TM.moe_load_balance_loss(torch.as_tensor(probs)))
    assert got == pytest.approx(float(JM.moe_load_balance_loss(jnp.asarray(probs))), abs=1e-6)
    # first maxima: experts 0, 0, 2, 2 → frac (0.5, 0, 0.5, 0)
    assert got == pytest.approx(E * (0.5 * probs[:, 0].mean() + 0.5 * probs[:, 2].mean()), abs=1e-6)
    assert float(TM.moe_load_balance_loss(torch.full((8, E), 1.0 / E))) == pytest.approx(1.0)


@pytest.mark.parametrize("top_k", [1, 2, E])
def test_gradients_match_jax_grad(top_k):
    """Through the kept logits only (the mask, the top-k and the load balance's dispatch share carry none)."""
    p, x = _tied_moe(4), _x(seed=5)
    r = np.random.default_rng(6).standard_normal((x.shape[0], 16)).astype(np.float32)

    def jloss(p, x):
        probs = JM.moe_gate_probs(p, x, top_k)
        return jnp.sum(JM.moe_apply(p, x, top_k, probs=probs) * r) + 0.3 * JM.moe_load_balance_loss(probs)

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(p, jnp.asarray(x))
    leaves, treedef = jax.tree.flatten(W.tree_from_jax(p, CPU))
    leaves = [t.requires_grad_() for t in leaves]
    xt = torch.as_tensor(x).requires_grad_()
    tp = jax.tree.unflatten(treedef, leaves)
    probs = TM.moe_gate_probs(tp, xt, top_k)
    loss = (torch.sum(TM.moe_apply(tp, xt, top_k, probs=probs) * torch.as_tensor(r))
            + 0.3 * TM.moe_load_balance_loss(probs))
    grads = torch.autograd.grad(loss, leaves + [xt])
    _close_trees(jax.tree.unflatten(treedef, list(grads[:-1])), jgp)
    _close(grads[-1], jgx)
    assert float(grads[0].abs().max()) > 0   # the experts' b (first leaf) gets a gradient


# ------------------------------------------------------------------ the model and the entry points


def _features(cfg, n, seed):
    rng = np.random.default_rng(seed)
    h, w = cfg.preprocess.frame_size
    out = {"visual": rng.random((n, h, w, cfg.preprocess.channels)).astype(np.float32),
           "audio": (rng.standard_normal((n, cfg.audio.bin_length, cfg.audio.n_mfcc))
                     * rng.uniform(0.2, 5, (n, 1, 1))).astype(np.float32),
           "text": None}
    if cfg.model.text_included:
        out["text"] = JT.tokenize([LINES[(i * 3) % len(LINES)] for i in range(n)], cfg.model.text_vocab_size,
                                  cfg.model.text_max_len)
    return out


MODELS = {"moe": dict(fusion_moe_experts=E), "text_moe": dict(fusion_moe_experts=E, text_included=True),
          "moe_top1": dict(fusion_moe_experts=E, fusion_moe_top_k=1)}


@pytest.mark.parametrize("model", list(MODELS))
def test_fuse_and_fuse_many_match_jax(small_cfg, model):
    jcfg = _with(small_cfg, **MODELS[model])
    params, state = avm_init(jax.random.PRNGKey(8), jcfg.model, jcfg.preprocess, jcfg.audio)
    feats = _features(jcfg, 12, seed=9)
    tp, ts = W.from_jax(params, state, device=CPU)
    want = JP.fuse(params, state, feats, jcfg)
    got = TP.fuse(tp, ts, feats, _port(jcfg), device=CPU)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    videos = [{k: None if v is None else v[:5] for k, v in feats.items()},
              {k: None if v is None else v[5:] for k, v in feats.items()}]
    np.testing.assert_allclose(np.concatenate(TP.fuse_many(tp, ts, videos, _port(jcfg), device=CPU)),
                               np.concatenate(JP.fuse_many(params, state, videos, jcfg)), atol=1e-5, rtol=0)


def test_classifier_with_moe_ends_in_five_logits(small_cfg):
    jcfg = _with(small_cfg, fusion_moe_experts=E, text_included=True)
    params, state = avm_init(jax.random.PRNGKey(10), jcfg.model, jcfg.preprocess, jcfg.audio, classifier=True)
    feats = _features(jcfg, 7, seed=11)
    want, _ = jax_avm(params, state, jnp.asarray(feats["visual"]), jnp.asarray(feats["audio"]),
                      jnp.asarray(feats["text"]), cfg=jcfg.model, train=False, classifier=True)
    tp, ts = W.from_jax(params, state, device=CPU)
    got = avm_apply(tp, ts, torch.as_tensor(feats["visual"]), torch.as_tensor(feats["audio"]),
                    torch.as_tensor(feats["text"]), cfg=_port(jcfg).model, classifier=True)
    assert got.shape == (7, 5)
    _close(got.numpy(), np.asarray(want))


def test_moe_without_hidden_layers_matches_jax(small_cfg):
    jcfg = _with(small_cfg, fusion_moe_experts=E, fusion_hidden=())
    params, state = avm_init(jax.random.PRNGKey(12), jcfg.model, jcfg.preprocess, jcfg.audio)
    feats = _features(jcfg, 6, seed=13)
    np.testing.assert_allclose(TP.fuse(*W.from_jax(params, state, device=CPU), feats, _port(jcfg), device=CPU),
                               JP.fuse(params, state, feats, jcfg), atol=1e-5, rtol=0)


@pytest.mark.parametrize("model", ["moe", "text_moe"])
def test_train_forward_and_probs_match_jax(small_cfg, model):
    jcfg = _with(small_cfg, dropout_rate=0.0, **MODELS[model])
    params, state = avm_init(jax.random.PRNGKey(14), jcfg.model, jcfg.preprocess, jcfg.audio)
    feats = _features(jcfg, 9, seed=15)
    valid = np.array([1] * 7 + [0] * 2, np.float32)
    text = None if feats["text"] is None else jnp.asarray(feats["text"])
    want, wstate, wprobs = jax_avm(params, state, jnp.asarray(feats["visual"]), jnp.asarray(feats["audio"]), text,
                                   cfg=jcfg.model, train=True, return_moe_probs=True, valid=jnp.asarray(valid))
    tp, ts = W.from_jax(params, state, device=CPU)
    got, gstate, gprobs = avm_train_apply(tp, ts, torch.as_tensor(feats["visual"]), torch.as_tensor(feats["audio"]),
                                          None if text is None else torch.as_tensor(feats["text"]),
                                          cfg=_port(jcfg).model, valid=torch.as_tensor(valid), return_moe_probs=True)
    _close(got.numpy(), np.asarray(want))
    _close(gprobs.numpy(), np.asarray(wprobs), 1e-6)
    _close_trees(gstate, wstate, 1e-6)
    dense = _port(_with(jcfg, fusion_moe_experts=0))
    with pytest.raises(ValueError, match="return_moe_probs requires fusion_moe_experts > 0"):
        avm_train_apply(*W.from_jax(*W.init_params(dense, 0), device=CPU), torch.as_tensor(feats["visual"]),
                        torch.as_tensor(feats["audio"]), None if text is None else torch.as_tensor(feats["text"]),
                        cfg=dense.model, return_moe_probs=True)


@pytest.mark.parametrize("classifier", [False, True])
def test_init_params_has_the_jax_layout(small_cfg, classifier):
    """``weights.init_params`` draws the tree ``avm_init`` builds (text branch and MoE layer included), leaf
    for leaf in key path and shape, so checkpoints move both ways."""
    jcfg = _with(small_cfg, fusion_moe_experts=E, text_included=True)
    jp, jst = avm_init(jax.random.PRNGKey(0), jcfg.model, jcfg.preprocess, jcfg.audio, classifier=classifier)
    tp, tst = W.init_params(_port(jcfg), 0, classifier=classifier)

    def shapes(tree):
        return [(jax.tree_util.keystr(k), np.shape(v)) for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]]

    assert sorted(shapes(tp)) == sorted(shapes(jp)) and sorted(shapes(tst)) == sorted(shapes(jst))
    assert tp["fusion"][0]["experts"]["w"].shape == (E, 32 + 16 + 16, 32)
    assert tp["text"]["embed"].shape == (128, 16) and len(tp["text"]["layers"]) == 1


def test_checkpoints_move_both_ways(small_cfg, tmp_path):
    """A JAX ``save_checkpoint`` of a text + MoE state loads in the port (``load_checkpoint`` against the port's
    template, and ``weights.load_jax_checkpoint``) and scores as JAX does; the port's save loads in JAX."""
    jcfg = _with(small_cfg, fusion_moe_experts=E, text_included=True)
    js = jax_state(jax.random.PRNGKey(16), jcfg)
    jax_save_checkpoint(str(tmp_path / "jax"), js, jcfg, tag="opt")
    feats = _features(jcfg, 8, seed=17)
    want = JP.fuse(js.params, js.model_state, feats, jcfg)
    st = load_checkpoint(str(tmp_path / "jax"), create_train_state(0, _port(jcfg), device=CPU), tag="opt")
    np.testing.assert_allclose(TP.fuse(st.params, st.model_state, feats, _port(jcfg), device=CPU), want, atol=1e-5)
    p, ms = W.load_jax_checkpoint(str(tmp_path / "jax"), tag="opt")
    np.testing.assert_allclose(TP.fuse(*W.from_jax(p, ms, device=CPU), feats, _port(jcfg), device=CPU), want,
                               atol=1e-5)
    save_checkpoint(str(tmp_path / "port"), st, _port(jcfg), tag="ckp")
    back = jax_load_checkpoint(str(tmp_path / "port"), jax_state(jax.random.PRNGKey(0), jcfg), tag="ckp")
    _close_trees(back.params, js.params, 0)


# ------------------------------------------------------------------ training


def _items(cfg, specs):
    j, t = [], []
    for n, seed in specs:
        rng = np.random.default_rng(seed)
        full_n = n * cfg.preprocess.skip_frames
        f = dict(video_id=f"synth{seed}", title=f"synth{seed}",
                 visual=rng.random((n, *cfg.preprocess.frame_size, 3)).astype(np.float32),
                 audio=rng.random((n, cfg.audio.bin_length, cfg.audio.n_mfcc)).astype(np.float32),
                 labels=rng.integers(1, 6, n).astype(np.float32),
                 gd_summary_masks=(rng.random((20, full_n)) < 0.15).astype(np.uint8),
                 full_n_frames=full_n, clip_intervals=synthetic_change_points(full_n, 6, seed=seed),
                 text=JT.tokenize([LINES[(i + seed) % len(LINES)] for i in range(n)], cfg.model.text_vocab_size,
                                  cfg.model.text_max_len))
        j.append(JItem(**f))
        t.append(TItem(**{**f, "visual": torch.as_tensor(f["visual"]), "audio": torch.as_tensor(f["audio"]),
                          "text": torch.as_tensor(f["text"])}))
    return j, t


def _port_state(js) -> TrainState:
    p, ms = W.from_jax(js.params, js.model_state, device=CPU)
    opt = AdamState(step=int(js.opt_state.step), mu=W.tree_from_jax(js.opt_state.mu, device=CPU),
                    nu=W.tree_from_jax(js.opt_state.nu, device=CPU))
    return TrainState(p, ms, opt, int(js.epoch))


def _train_cfg(small_cfg):
    jcfg = _with(small_cfg, fusion_moe_experts=E, text_included=True, dropout_rate=0.0)
    return dataclasses.replace(jcfg, train=dataclasses.replace(jcfg.train, eps=1e-4))


def test_subbatch_gradients_with_the_aux_loss_match_jax(small_cfg):
    """One sub-batch's loss and gradients, the load-balance auxiliary loss included, leaf by leaf."""
    jcfg = _train_cfg(small_cfg)
    js = jax_state(jax.random.PRNGKey(18), jcfg)
    jitems, titems = _items(jcfg, [(7, 19)])
    S = jcfg.train.subbatch_size
    v, a, lab, valid, _, text = JL._pad_video(jitems[0], S)

    def loss_of(p):
        out, _, probs = jax_avm(p, js.model_state, jnp.asarray(v[:S]), jnp.asarray(a[:S]), jnp.asarray(text[:S]),
                                cfg=jcfg.model, train=True, return_moe_probs=True, valid=jnp.asarray(valid[:S]))
        loss = JL._loss_fn(out, jnp.asarray(lab[:S]), jnp.asarray(valid[:S]), broadcast_compat=False,
                           classifier=False)
        return loss + jcfg.model.fusion_moe_aux_weight * JM.moe_load_balance_loss(probs.astype(jnp.float32))

    jloss, jgrads = jax.value_and_grad(loss_of)(js.params)
    ts = _port_state(js)
    tv, ta, tlab, tvalid, _ = TL._pad_video(titems[0], S, torch.device(CPU))
    ttext = TL._pad_text(titems[0], len(tv), torch.device(CPU), _port(jcfg))
    assert ttext.shape == (10, jcfg.model.text_max_len) and not ttext[7:].any()   # padded rows hold token 0
    loss, _, _, grads = TL.make_train_video_fn(_port(jcfg)).value_and_grad(
        ts.params, ts.model_state, tv[:S], ta[:S], tlab[:S], tvalid[:S], None, ttext[:S])
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    _close_trees(grads, jgrads)
    assert float(grads["text"]["embed"].abs().max()) > 0 and float(grads["fusion"][0]["gate"]["w"].abs().max()) > 0


def test_one_epoch_with_both_flags_matches_jax(small_cfg, tmp_path):
    jcfg = _train_cfg(small_cfg)
    js = jax_state(jax.random.PRNGKey(20), jcfg)
    jitems, titems = _items(jcfg, [(13, 21), (11, 22), (9, 23)])
    jbest, jh = JL.train_importance_model(jcfg, JDS(jitems[:2]), JDS(jitems[2:]), js, num_epochs=1,
                                          checkpoint_dir=str(tmp_path / "jax"), verbose=False)
    tbest, th = TL.train_importance_model(_port(jcfg), TDS(titems[:2]), TDS(titems[2:]), _port_state(js),
                                          num_epochs=1, checkpoint_dir=str(tmp_path / "port"), verbose=False)
    assert set(th) == set(jh)
    for k, v in jh.items():
        if isinstance(v, list):
            np.testing.assert_allclose(th[k], v, rtol=1e-5, atol=0, err_msg=k)
        else:
            assert th[k] == v, k
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))


# ------------------------------------------------------------------ the serving preset with both flags


def test_preset_with_both_flags_matches_jax():
    """``configs/tpu_serving.json`` (bf16, int8 conv1 and conv2) with ``--commentary --moe-experts 4`` at full
    width: scores within 0.0625 of the JAX package's and on the bf16 grid, after asserting they spread.

    The inputs and the spread are ``tests/test_torch_bf16.py``'s (structured frames, per-frame loudness, the
    last layer rescaled to a logit std of 1.5), plus a commentary line per frame.  The JAX package's jitted
    ``fuse`` rounds its bf16 trunk otherwise than its own eager ``avm_apply`` (by up to 0.009 here), and a
    gate whose k-th logit ties under one rounding does not under the other: that row routes to another
    expert set.  So the port is held to the eager forward on every row, and to the jitted ``fuse`` on every
    row where the JAX package's two forwards agree; the rows where they part must be few, and each must have
    a tie at the gate's k-th logit in the eager forward (where the port keeps every tied expert, as JAX's
    ``>=`` does)."""
    jcfg = _with(JaxPipelineConfig.load(PRESET), fusion_moe_experts=E, text_included=True)
    params, state = avm_init(jax.random.PRNGKey(0), jcfg.model, jcfg.preprocess, jcfg.audio)
    n = 64
    feats = {**bf16_features(jcfg, n, seed=0),
             "text": JT.tokenize([LINES[i % len(LINES)] + f" minute {i}" for i in range(n)],
                                 jcfg.model.text_vocab_size, jcfg.model.text_max_len)}
    f32 = _with(jcfg, dtype="float32", quantized_inference=False)
    params = bf16_spread(params, state, feats, jcfg)
    want32 = JP.fuse(params, state, feats, f32)
    want = JP.fuse(params, state, feats, jcfg)   # jitted
    bf = jnp.bfloat16
    eager, _ = jax_avm(jax_cast(params, bf), jax_cast(state, bf), jnp.asarray(feats["visual"]).astype(bf),
                       jnp.asarray(feats["audio"]).astype(bf), jnp.asarray(feats["text"]), cfg=jcfg.model)
    eager = np.asarray(eager[:, 0].astype(jnp.float32))
    got = TP.fuse(*W.from_jax(params, state, device=CPU), feats, _port(jcfg), device=CPU)
    on_grid = lambda x: np.array_equal(np.asarray(jnp.asarray(x).astype(bf).astype(jnp.float32)), x)   # noqa: E731
    assert np.ptp(want32) >= 1.0 and len(np.unique(want)) >= 16
    assert on_grid(got) and on_grid(want)
    assert np.abs(got - eager).max() <= 0.0625, np.abs(got - eager).max()
    agree = np.abs(want - eager) <= 0.0625
    assert np.abs(got - want)[agree].max() <= 0.0625, np.abs(got - want)[agree].max()
    parted = np.nonzero(~agree)[0]
    assert len(parted) <= 2, parted
    tp, ts = (tree_cast(t, torch.bfloat16) for t in W.from_jax(params, state, device=CPU))
    vis = visual_encoder_apply(tp["visual"], ts["visual"], torch.as_tensor(feats["visual"]).to(torch.bfloat16),
                               quant=True)
    x = _fused_input(tp, vis, torch.as_tensor(feats["audio"]).to(torch.bfloat16), feats["text"], _port(jcfg).model)
    kept = (TM.moe_gate_probs(tp["fusion"][0], x, jcfg.model.fusion_moe_top_k) > 0).sum(dim=1).numpy()
    assert (kept[parted] > jcfg.model.fusion_moe_top_k).all(), kept[parted]
    assert np.abs(got - want32)[agree].max() <= 0.1   # the drift gate of tests/test_precision.py
