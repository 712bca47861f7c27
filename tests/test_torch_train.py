"""PyTorch port: optimisers and spotting training against the JAX package, on the CPU.

The same numpy weights, features, labels and gradients go through
``cvml_goalnet_tpu.train`` and ``cvml_goalnet_tpu_torch.train``.  Tolerances:

* optimiser updates and norms: 1e-6 (float32 arithmetic in the
  same order; the port's bias corrections are computed in double);
* losses: 1e-5 relative; first-step gradients: 1e-5·max(1, max|g|) per leaf
  (float32 sums over T in another order);
* parameters after Adam steps: 1e-5, on the entries whose JAX gradient is at
  least 1e-3 of the largest gradient entry of the tree at every step.  Adam
  moves an entry by up to ``lr`` whatever the size of its gradient, so where
  the gradient is near zero, float32 noise in it decides the step; those
  entries are left out of the comparison (and checked to be a minority), not
  given a looser tolerance.  The key projection's bias is one: its gradient
  is 0 in exact arithmetic (a row's softmax ignores a shift of all its
  scores), so both packages step it on noise of about 1e-10;
* learning-rate schedules: 1e-5 relative, since the JAX package computes them
  in float32 and the port in double.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cvml_goalnet_tpu.train.optim as JO
import cvml_goalnet_tpu.train.spotting as JS
from cvml_goalnet_tpu.models.temporal import temporal_scorer_apply as jax_gru
from cvml_goalnet_tpu.models.temporal_attention import temporal_transformer_apply as jax_transformer
from cvml_goalnet_tpu.models.temporal_hybrid import temporal_hybrid_apply as jax_hybrid
import cvml_goalnet_tpu_torch.train.optim as TO
import cvml_goalnet_tpu_torch.train.spotting as TS
from cvml_goalnet_tpu_torch import weights as W
from cvml_goalnet_tpu_torch.config import TrainConfig


def _np(tree):
    return jax.tree.map(lambda x: np.asarray(x.detach() if isinstance(x, torch.Tensor) else x), tree)


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"a": {"w": (rng.standard_normal((5, 3)) * scale).astype(np.float32),
                  "b": (rng.standard_normal(3) * scale).astype(np.float32)},
            "layers": [{"w": (rng.standard_normal((4,)) * scale).astype(np.float32)} for _ in range(2)]}


def _assert_trees(got, want, atol):
    g, w = jax.tree.leaves(_np(got)), jax.tree.leaves(_np(want))
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(a, b, atol=atol, rtol=0)


class TestOptim:
    @pytest.mark.parametrize("weight_decay", [0.0, 0.05])
    def test_adam_matches_jax(self, weight_decay):
        p_np = _tree(0)
        jp, jst = jax.tree.map(jnp.asarray, p_np), JO.adam_init(jax.tree.map(jnp.asarray, p_np))
        tp = W.tree_from_jax(p_np, device="cpu")
        tst = TO.adam_init(tp)
        for step in range(5):
            g = _tree(10 + step)
            jp, jst = JO.adam_update(jax.tree.map(jnp.asarray, g), jst, jp, 3e-3, weight_decay=weight_decay)
            tp, tst = TO.adam_update(W.tree_from_jax(g, device="cpu"), tst, tp, 3e-3, weight_decay=weight_decay)
        assert tst.step == int(jst.step) == 5
        _assert_trees(tp, jp, 1e-6)
        _assert_trees(tst.mu, jst.mu, 1e-6)
        _assert_trees(tst.nu, jst.nu, 1e-6)
        assert isinstance(tp["layers"], list)

    def test_adam_leaves_its_inputs(self):
        tp = W.tree_from_jax(_tree(1), device="cpu")
        before = _np(tp)
        st = TO.adam_init(tp)
        TO.adam_update(W.tree_from_jax(_tree(2), device="cpu"), st, tp)
        _assert_trees(tp, before, 0)
        assert st.step == 0 and not any(x.any() for x in TO.tree_leaves(st.mu))

    @pytest.mark.parametrize("max_norm", [0.0, 0.5, 1e3])
    def test_clip_by_global_norm_matches_jax(self, max_norm):
        g = _tree(3, scale=2.0)
        np.testing.assert_allclose(float(TO.global_norm(W.tree_from_jax(g, device="cpu"))),
                                   float(JO.global_norm(jax.tree.map(jnp.asarray, g))), rtol=1e-6)
        got = TO.clip_by_global_norm(W.tree_from_jax(g, device="cpu"), max_norm)
        want = JO.clip_by_global_norm(jax.tree.map(jnp.asarray, g), max_norm)
        _assert_trees(got, want, 1e-6)

    def test_clip_keeps_a_zero_tree_finite(self):
        z = TO.clip_by_global_norm(W.tree_from_jax(_tree(4, scale=0.0), device="cpu"), 1.0)
        assert all(torch.isfinite(x).all() and not x.any() for x in TO.tree_leaves(z))

    @pytest.mark.parametrize("schedule,warmup,decay,min_ratio", [
        ("constant", 0, 0, 0.0), ("constant", 5, 0, 0.0), ("cosine", 0, 20, 0.1), ("cosine", 4, 20, 0.0),
        ("linear", 3, 10, 0.2), ("linear", 0, 0, 0.5),
    ])
    def test_schedule_lr_matches_jax(self, schedule, warmup, decay, min_ratio):
        for step in range(30):
            want = float(JO.schedule_lr(step, 2e-3, schedule, warmup, decay, min_ratio))
            assert TO.schedule_lr(step, 2e-3, schedule, warmup, decay, min_ratio) == pytest.approx(want, rel=1e-5)

    def test_schedule_from_config(self):
        tc = TrainConfig(learning_rate=1e-3, lr_schedule="cosine", lr_warmup_steps=2, lr_decay_steps=8)
        fn = TO.schedule_from_config(tc)
        assert [fn(s) for s in range(12)] == pytest.approx(
            [float(JO.schedule_from_config(tc)(s)) for s in range(12)], rel=1e-5)
        with pytest.raises(ValueError, match="unknown lr schedule"):
            TO.schedule_from_config(dataclasses.replace(tc, lr_schedule="step"))

    def test_sgd_matches_jax(self):
        p_np = _tree(5)
        jp, jst = jax.tree.map(jnp.asarray, p_np), JO.sgd_init(jax.tree.map(jnp.asarray, p_np))
        tp = W.tree_from_jax(p_np, device="cpu")
        tst = TO.sgd_init(tp)
        for step in range(3):
            g = _tree(20 + step)
            jp, jst = JO.sgd_update(jax.tree.map(jnp.asarray, g), jst, jp, 0.05)
            tp, tst = TO.sgd_update(W.tree_from_jax(g, device="cpu"), tst, tp, 0.05)
        _assert_trees(tp, jp, 1e-6)
        _assert_trees(tst.momentum, jst.momentum, 1e-6)


class TestLoss:
    @pytest.mark.parametrize("shape", [(40,), (40, 3)])
    def test_weighted_bce_with_padding_matches_jax(self, shape):
        rng = np.random.default_rng(6)
        logits = (rng.standard_normal(shape) * 3).astype(np.float32)
        labels = (rng.random(shape) < 0.2).astype(np.float32)
        labels[-7:] = -1.0                     # padded tail
        want = float(JS.weighted_bce(jnp.asarray(logits), jnp.asarray(labels), 10.0))
        got = TS.weighted_bce(torch.as_tensor(logits), torch.as_tensor(labels), 10.0)
        assert float(got) == pytest.approx(want, rel=1e-6)
        # padded rows carry no weight: dropping them leaves the loss as it was
        kept = TS.weighted_bce(torch.as_tensor(logits[:-7]), torch.as_tensor(labels[:-7]), 10.0)
        assert float(kept) == pytest.approx(want, rel=1e-6)

    @pytest.mark.parametrize("shape", [(3, 30), (3, 30, 2)])
    def test_timeline_lengths_match_jax(self, shape):
        labels = np.zeros(shape, np.float32)
        labels[1, 21:] = -1.0
        labels[2, 7:] = -1.0
        want = np.asarray(JS.timeline_lengths(jnp.asarray(labels)))
        got = TS.timeline_lengths(torch.as_tensor(labels))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(want, [30, 21, 7])


# (scorer, window, pos_encoding, num_heads, n_classes, use the Pallas kernels in interpret mode)
STEP_CASES = [
    ("gru", 0, "learned", 1, 1, False),
    ("gru", 0, "learned", 1, 3, False),
    ("transformer", 0, "learned", 1, 1, False),
    ("transformer", 0, "rotary", 2, 3, True),
    ("transformer", 9, "learned", 1, 1, True),
    ("transformer", 9, "rotary", 2, 1, False),
    ("hybrid", 9, "learned", 1, 1, False),
    ("hybrid", 0, "rotary", 2, 3, False),
]
T, D, HIDDEN, LR, STEPS = 48, 12, 8, 3e-3, 3


def _setup(small_cfg, scorer, window, pos, heads, n_classes, seed=0):
    """A seeded head (the transformer 16 wide; the GRU, and the hybrid's GRU and transformer, HIDDEN wide),
    features and 0/1 labels."""
    mc = dataclasses.replace(small_cfg.model, temporal_model=scorer,
                             temporal_hidden=16 if scorer == "transformer" else HIDDEN, temporal_num_layers=2,
                             temporal_num_heads=heads, temporal_max_len=64, temporal_pos_encoding=pos,
                             temporal_window=window)
    params = W.init_temporal_params(mc, D, seed, n_classes)
    rng = np.random.default_rng(seed + 7)
    feats = rng.standard_normal((T, D)).astype(np.float32)
    labels = (rng.random((T,) if n_classes == 1 else (T, n_classes)) < 0.15).astype(np.float32)
    return params, feats, labels


def _jax_loss(scorer, window, heads, interpret):
    def scores(p, x):
        if scorer == "transformer":
            return jax_transformer(p, x, heads, interpret, interpret, window)
        if scorer == "hybrid":
            return jax_hybrid(p, x, HIDDEN, heads, False, False, window)
        return jax_gru(p, x, HIDDEN)

    return lambda p, x, y: JS.weighted_bce(scores(p, x).reshape(y.shape), y, 10.0)


def _compare_steps(jstep, tstep, jax_loss, params, feats, labels):
    """STEPS steps of both packages from the same weights: the first gradients leaf by leaf, every loss,
    and the parameters after the last step on the entries whose gradient stayed clear of zero."""
    jloss_grad = jax.grad(jax_loss)
    jp = jax.tree.map(jnp.asarray, params)
    jo = JS.init_spotting_opt(jp)
    tp = W.tree_from_jax(params, device="cpu")
    to = TS.init_spotting_opt(tp)
    x_j, y_j = jnp.asarray(feats), jnp.asarray(labels)
    x_t, y_t = torch.as_tensor(feats), torch.as_tensor(labels)

    _, tg = tstep.value_and_grad(tp, x_t, y_t)
    jg = _np(jloss_grad(jp, x_j, y_j))
    for a, b in zip(jax.tree.leaves(_np(tg)), jax.tree.leaves(jg)):
        np.testing.assert_allclose(a, b, atol=1e-5 * max(1.0, np.abs(b).max()), rtol=0)

    steady = jax.tree.map(lambda g: np.ones(g.shape, bool), jg)
    for _ in range(STEPS):
        g = _np(jloss_grad(jp, x_j, y_j))
        g_max = max(np.abs(x).max() for x in jax.tree.leaves(g))
        steady = jax.tree.map(lambda s, g: s & (np.abs(g) >= 1e-3 * g_max), steady, g)
        jp, jo, jl = jstep(jp, jo, x_j, y_j)
        tp, to, tl = tstep(tp, to, x_t, y_t)
        assert float(tl) == pytest.approx(float(jl), rel=1e-5)
    kept = total = 0
    for a, b, s in zip(jax.tree.leaves(_np(tp)), jax.tree.leaves(_np(jp)), jax.tree.leaves(steady)):
        np.testing.assert_allclose(a[s], b[s], atol=1e-5, rtol=0)
        assert np.abs(a - b).max() <= 2 * LR * STEPS      # the most Adam can move an entry in STEPS steps
        kept, total = kept + s.sum(), total + s.size
    assert kept > 0.5 * total, f"only {kept} of {total} entries compared"
    assert to.step == STEPS


class TestTrainStep:
    @pytest.mark.parametrize("scorer,window,pos,heads,n_classes,interpret", STEP_CASES)
    def test_matches_jax(self, small_cfg, scorer, window, pos, heads, n_classes, interpret):
        params, feats, labels = _setup(small_cfg, scorer, window, pos, heads, n_classes)
        hidden = 0 if scorer == "transformer" else HIDDEN
        kw = dict(lr=LR, pos_weight=10.0, scorer=scorer, num_heads=heads, window=window)
        _compare_steps(JS.make_spotting_train_step(hidden, use_flash=interpret, flash_interpret=interpret, **kw),
                       TS.make_spotting_train_step(hidden, **kw), _jax_loss(scorer, window, heads, interpret),
                       params, feats, labels)

    def test_remat_equals_plain(self, small_cfg):
        params, feats, labels = _setup(small_cfg, "hybrid", 9, "learned", 1, 1)
        x, y = torch.as_tensor(feats), torch.as_tensor(labels)
        out = []
        for remat in (False, True):
            step = TS.make_spotting_train_step(HIDDEN, lr=LR, remat=remat, scorer="hybrid", window=9)
            tp = W.tree_from_jax(params, device="cpu")
            to = TS.init_spotting_opt(tp)
            losses = []
            for _ in range(2):
                tp, to, loss = step(tp, to, x, y)
                losses.append(float(loss))
            out.append((losses, tp))
        assert out[0][0] == pytest.approx(out[1][0], rel=1e-7)
        _assert_trees(out[1][1], out[0][1], 1e-7)

    def test_schedule_and_clip_match_jax(self, small_cfg):
        params, feats, labels = _setup(small_cfg, "gru", 0, "learned", 1, 1, seed=3)
        kw = dict(lr=LR, pos_weight=10.0, lr_schedule=("cosine", 1, 4, 0.1), grad_clip_norm=0.05)
        _compare_steps(JS.make_spotting_train_step(HIDDEN, **kw), TS.make_spotting_train_step(HIDDEN, **kw),
                       _jax_loss("gru", 0, 1, False), params, feats, labels)

    def test_rejects_unknown_scorer(self):
        with pytest.raises(ValueError, match="unknown scorer"):
            TS.make_spotting_train_step(8, scorer="lstm")


class TestCheckpoint:
    @pytest.mark.parametrize("scorer,classes", [("transformer", None), ("hybrid", ["goal", "card", "sub"])])
    def test_round_trips_through_both_loaders(self, small_cfg, tmp_path, scorer, classes):
        params, _, _ = _setup(small_cfg, scorer, 9, "learned", 1, 1 if classes is None else 3)
        tp = W.tree_from_jax(params, device="cpu")
        path = str(tmp_path / "sub" / "head.npz")
        TS.save_spotting_checkpoint(path, tp, classes=classes)
        from_jax = JS.load_spotting_checkpoint(path, jax.tree.map(jnp.asarray, params), classes=classes)
        from_port = W.load_spotting_checkpoint(path, params, classes=classes)
        _assert_trees(from_jax, params, 0)
        _assert_trees(from_port, params, 0)
        if classes:
            with pytest.raises(ValueError, match="trained with classes"):
                W.load_spotting_checkpoint(path, params, classes=classes[::-1])
        assert sorted(p.name for p in (tmp_path / "sub").iterdir()) == ["head.npz"]   # no temporary left

    def test_jax_checkpoint_loads_into_the_port_and_back(self, small_cfg, tmp_path):
        params, _, _ = _setup(small_cfg, "gru", 0, "learned", 1, 1)
        path = str(tmp_path / "jax.npz")
        JS.save_spotting_checkpoint(path, jax.tree.map(jnp.asarray, params))
        again = str(tmp_path / "port.npz")
        TS.save_spotting_checkpoint(again, W.tree_from_jax(W.load_spotting_checkpoint(path, params), device="cpu"))
        with np.load(path) as a, np.load(again) as b:
            assert sorted(a.files) == sorted(b.files)
            for key in a.files:
                np.testing.assert_array_equal(a[key], b[key])


class TestModelGradients:
    @pytest.mark.parametrize("pos,window", [("learned", 0), ("rotary", 5)])
    def test_transformer_grads_match_jax_with_offset_and_wrap(self, small_cfg, pos, window):
        """Gradients of the scores through ``pos[(pos_offset + t) % max_len]`` (40 frames from offset 50 wrap
        a 64-row table: rows 50..63 and 0..25 get gradient, the rest none) or through rotary positions."""
        mc = dataclasses.replace(small_cfg.model, temporal_model="transformer", temporal_hidden=16,
                                 temporal_num_layers=1, temporal_max_len=64, temporal_pos_encoding=pos)
        params = W.init_temporal_params(mc, D, 5)
        x = np.random.default_rng(8).standard_normal((40, D)).astype(np.float32)
        (cot,) = [np.random.default_rng(9).standard_normal(40).astype(np.float32)]
        want = jax.grad(lambda p: jnp.sum(jax_transformer(p, jnp.asarray(x), 1, False, False, window, 50) * cot))(
            jax.tree.map(jnp.asarray, params))
        from cvml_goalnet_tpu_torch.models.temporal_attention import temporal_transformer_apply

        leaves = [t.requires_grad_() for t in TO.tree_leaves(W.tree_from_jax(params, device="cpu"))]
        tp = TO.tree_unflatten(params, leaves)
        (temporal_transformer_apply(tp, torch.as_tensor(x), 1, window, 50) * torch.as_tensor(cot)).sum().backward()
        got = TO.tree_unflatten(params, [t.grad for t in leaves])
        for a, b in zip(jax.tree.leaves(_np(got)), jax.tree.leaves(_np(want))):
            np.testing.assert_allclose(a, b, atol=1e-5 * max(1.0, np.abs(b).max()), rtol=0)
        if pos == "learned":
            used = np.abs(_np(got)["pos"]).sum(axis=1) > 0
            np.testing.assert_array_equal(np.nonzero(used)[0], np.r_[0:26, 50:64])

    def test_gru_grads_match_jax(self, small_cfg):
        """The GRU's step-by-step loop carries gradients into wx, wh and the head as ``lax.scan`` does."""
        mc = dataclasses.replace(small_cfg.model, temporal_model="gru", temporal_hidden=HIDDEN)
        params = W.init_temporal_params(mc, D, 6, 2)
        x = np.random.default_rng(10).standard_normal((30, D)).astype(np.float32)
        cot = np.random.default_rng(11).standard_normal((30, 2)).astype(np.float32)
        want = jax.grad(lambda p: jnp.sum(jax_gru(p, jnp.asarray(x), HIDDEN) * cot))(jax.tree.map(jnp.asarray, params))
        from cvml_goalnet_tpu_torch.models.temporal import temporal_scorer_apply

        leaves = [t.requires_grad_() for t in TO.tree_leaves(W.tree_from_jax(params, device="cpu"))]
        (temporal_scorer_apply(TO.tree_unflatten(params, leaves), torch.as_tensor(x), HIDDEN)
         * torch.as_tensor(cot)).sum().backward()
        got = TO.tree_unflatten(params, [t.grad for t in leaves])
        for a, b in zip(jax.tree.leaves(_np(got)), jax.tree.leaves(_np(want))):
            np.testing.assert_allclose(a, b, atol=1e-5 * max(1.0, np.abs(b).max()), rtol=0)
