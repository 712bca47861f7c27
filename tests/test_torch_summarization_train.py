"""PyTorch port: training of the summarization model against the JAX package, on the CPU.

The same numpy inputs (seeded) and weights (``weights.from_jax`` of a JAX
``create_train_state``) go through ``cvml_goalnet_tpu`` and
``cvml_goalnet_tpu_torch``, at the suite's small config (frame_size 24×24,
vis_channels (8, 16, 16), fusion (32, 16), sub-batches of 5).  Tolerances:

* train batchnorm, outputs and running statistics: 1e-6;
* train forwards and their gradients at dropout 0: 1e-5·max(1, max|want|)
  per output or leaf (float32 sums in another order);
* losses and training histories: 1e-5 relative; F-scores equal (the same
  masks give the same float64 arithmetic) unless a rounded score flipped;
* parameters after Adam: 1e-5 on the entries whose JAX gradient is at least
  1e-3 of its leaf's largest at every Adam step, and 2·lr per Adam step on
  the rest, where Adam moves an entry by about ``lr·sign(g)`` whatever the
  size of its gradient (as ``tests/test_torch_train.py`` holds the spotting
  step); first-sub-batch gradients leaf by leaf as above.

Dropout cannot draw JAX's masks, so parity runs at ``dropout_rate = 0`` and
the dropout is tested on its own: its keep share, the ``1/keep`` scale,
equal masks for equal seeds and fresh masks for each sub-batch and video.
Inputs are uniform floats, so a 3×3 max-pool window holds no tie among its
positive values (ties at 0 after the ReLU carry no gradient in either
package).
"""

from __future__ import annotations

import dataclasses
import functools
import os
import signal
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cvml_goalnet_tpu.train.loop as JL
from cvml_goalnet_tpu import baseline as JB
from cvml_goalnet_tpu.data.dataset import VideoDataset as JDS
from cvml_goalnet_tpu.data.dataset import VideoItem as JItem
from cvml_goalnet_tpu.data.synthetic import synthetic_change_points
from cvml_goalnet_tpu.models import layers as JLy
from cvml_goalnet_tpu.models.audio import audio_encoder_apply as jax_audio
from cvml_goalnet_tpu.models.avm import avm_apply as jax_avm
from cvml_goalnet_tpu.models.visual import visual_encoder_apply as jax_visual
from cvml_goalnet_tpu.train import resilience as JR
from cvml_goalnet_tpu.train.optim import adam_update, clip_by_global_norm, schedule_from_config
from cvml_goalnet_tpu.train.state import create_train_state as jax_state
from cvml_goalnet_tpu.utils import logging as JLog
from cvml_goalnet_tpu.utils.metrics import MetricsLogger as JMetricsLogger
from cvml_goalnet_tpu_torch import baseline as TB
from cvml_goalnet_tpu_torch import cli
from cvml_goalnet_tpu_torch import weights as W
from cvml_goalnet_tpu_torch.config import PipelineConfig
from cvml_goalnet_tpu_torch.data.dataset import VideoDataset as TDS
from cvml_goalnet_tpu_torch.data.dataset import VideoItem as TItem
from cvml_goalnet_tpu_torch.models import layers as TLy
from cvml_goalnet_tpu_torch.models.audio import audio_encoder_apply as torch_audio
from cvml_goalnet_tpu_torch.models.avm import avm_train_apply
from cvml_goalnet_tpu_torch.models.visual import visual_encoder_train_apply
from cvml_goalnet_tpu_torch.train import loop as TL
from cvml_goalnet_tpu_torch.train import resilience as TR
from cvml_goalnet_tpu_torch.train.checkpoint import AsyncCheckpointer, load_checkpoint
from cvml_goalnet_tpu_torch.train.optim import AdamState, tree_leaves, tree_map, tree_unflatten
from cvml_goalnet_tpu_torch.train.state import TrainState, create_train_state
from cvml_goalnet_tpu_torch.utils import logging as TLog
from cvml_goalnet_tpu_torch.utils.metrics import MetricsLogger

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"


def _jcfg(small_cfg, train=None, **model):
    """The suite's small config with dropout 0 (parity), the given model and train fields."""
    m = dataclasses.replace(small_cfg.model, **{"dropout_rate": 0.0, **model})
    return dataclasses.replace(small_cfg, model=m, train=dataclasses.replace(small_cfg.train, **(train or {})))


def _pcfg(jcfg) -> PipelineConfig:
    return PipelineConfig.from_json(jcfg.to_json())


def _fields(cfg, n, seed, audio=True):
    rng = np.random.default_rng(seed)
    full_n = n * cfg.preprocess.skip_frames
    return dict(
        video_id=f"synth{seed}", title=f"synth{seed}",
        visual=rng.random((n, *cfg.preprocess.frame_size, 3)).astype(np.float32),
        audio=rng.random((n, cfg.audio.bin_length, cfg.audio.n_mfcc)).astype(np.float32) if audio else None,
        labels=rng.integers(1, 6, n).astype(np.float32),
        gd_summary_masks=(rng.random((20, full_n)) < 0.15).astype(np.uint8),
        full_n_frames=full_n, clip_intervals=synthetic_change_points(full_n, 6, seed=seed))


def _items(cfg, specs, audio=True):
    """Equal JAX and port items for (frames, seed) pairs; the port's carry tensors."""
    j, t = [], []
    for n, seed in specs:
        f = _fields(cfg, n, seed, audio)
        j.append(JItem(**f))
        t.append(TItem(**{**f, "visual": torch.as_tensor(f["visual"]),
                          "audio": None if f["audio"] is None else torch.as_tensor(f["audio"])}))
    return j, t


def _port_state(js) -> TrainState:
    """The port's copy of a JAX TrainState (params, batchnorm state, Adam's moments and step, epoch)."""
    p, ms = W.from_jax(js.params, js.model_state, device=CPU)
    opt = AdamState(step=int(js.opt_state.step), mu=W.tree_from_jax(js.opt_state.mu, device=CPU),
                    nu=W.tree_from_jax(js.opt_state.nu, device=CPU))
    return TrainState(p, ms, opt, int(js.epoch))


def _np(tree):
    return jax.tree.map(lambda x: np.asarray(x.detach() if isinstance(x, torch.Tensor) else x), tree)


def _close(got, want, scale_tol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=scale_tol * max(1.0, float(np.abs(want).max(initial=0))), rtol=0)


def _close_trees(got, want, scale_tol=1e-5):
    g, w = jax.tree.leaves(_np(got)), jax.tree.leaves(_np(want))
    assert len(g) == len(w)
    for a, b in zip(g, w):
        _close(a, b, scale_tol)


def _history_close(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, list):
            assert len(got[k]) == len(v), k
            np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=0, err_msg=k)
        else:
            assert got[k] == v, k


# ------------------------------------------------------------------ primitives


class TestBatchnorm:
    @pytest.mark.parametrize("masked", [False, True])
    @pytest.mark.parametrize("shape", [(10, 5, 5, 8), (6, 16)])
    def test_train_matches_jax(self, masked, shape):
        rng = np.random.default_rng(sum(shape) + masked)
        c = shape[-1]
        x = (rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)
        params = {"scale": (1 + 0.1 * rng.standard_normal(c)).astype(np.float32),
                  "bias": (0.1 * rng.standard_normal(c)).astype(np.float32)}
        state = {"mean": (0.1 * rng.standard_normal(c)).astype(np.float32),
                 "var": rng.uniform(0.5, 1.5, c).astype(np.float32)}
        mask = (np.arange(shape[0]) < shape[0] - 3).astype(np.float32) if masked else None
        for train in (True, False):
            jy, js = JLy.batchnorm_apply(jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, state),
                                         jnp.asarray(x), train, mask=None if mask is None else jnp.asarray(mask))
            ty, ts = TLy.batchnorm_apply(W.tree_from_jax(params, CPU), W.tree_from_jax(state, CPU),
                                         torch.as_tensor(x), train, mask=None if mask is None else torch.as_tensor(mask))
            np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-6, rtol=0)
            for k in ("mean", "var"):
                np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]), atol=1e-6, rtol=0)

    def test_padding_kept_out_of_the_statistics(self):
        """A short batch zero-padded with its mask equals the short batch alone, on the real rows and the state
        (JAX ``test_train.py``'s padding case); without the mask the padding shows."""
        rng = np.random.default_rng(0)
        params = {"scale": torch.ones(4), "bias": torch.zeros(4)}
        state = {"mean": torch.zeros(4), "var": torch.ones(4)}
        real = torch.as_tensor(rng.random((7, 3, 3, 4)).astype(np.float32))
        padded = torch.cat([real, torch.zeros(3, 3, 3, 4)])
        valid = torch.tensor([1.0] * 7 + [0.0] * 3)
        want, want_state = TLy.batchnorm_apply(params, state, real, True)
        got, got_state = TLy.batchnorm_apply(params, state, padded, True, mask=valid)
        torch.testing.assert_close(got[:7], want, atol=1e-6, rtol=0)
        for k in ("mean", "var"):
            torch.testing.assert_close(got_state[k], want_state[k], atol=1e-6, rtol=0)
        unmasked, _ = TLy.batchnorm_apply(params, state, padded, True)
        assert (unmasked[:7] - want).abs().max() > 1e-4
        assert state["mean"].eq(0).all() and state["var"].eq(1).all()   # the input state is left as it was


class TestDropout:
    def test_keep_share_and_scale(self):
        x = torch.ones(200_000)
        y = TLy.dropout(x, 0.2, True, torch.Generator().manual_seed(0))
        kept = y != 0
        assert abs(kept.float().mean().item() - 0.8) < 0.005
        assert torch.equal(y[kept], torch.full((int(kept.sum()),), 1 / 0.8))

    def test_equal_seeds_equal_masks_and_fresh_draws(self):
        x = torch.ones(4096)
        a = TLy.dropout(x, 0.5, True, torch.Generator().manual_seed(3))
        g = torch.Generator().manual_seed(3)
        b, c = TLy.dropout(x, 0.5, True, g), TLy.dropout(x, 0.5, True, g)
        assert torch.equal(a, b) and not torch.equal(b, c)

    @pytest.mark.parametrize("rate,train", [(0.0, True), (-0.1, True), (0.5, False)])
    def test_identity(self, rate, train):
        x = torch.ones(8)
        assert TLy.dropout(x, rate, train, None) is x

    def test_fresh_masks_per_sub_batch_and_video_and_a_seeded_run_repeats(self, small_cfg, monkeypatch):
        cfg = _pcfg(_jcfg(small_cfg, dropout_rate=0.3))
        masks = []
        real = TLy.dropout

        def spy(x, rate, train, generator):
            y = real(x, rate, train, generator)
            masks.append((y != 0).clone())
            return y

        monkeypatch.setattr(TLy, "dropout", spy)
        _, items = _items(cfg, [(10, 0), (10, 1)])
        js = jax_state(jax.random.PRNGKey(0), _jcfg(small_cfg))
        runs = []
        for _ in range(2):
            masks.clear()
            _, hist = TL.train_importance_model(cfg, TDS(items), TDS([]), _port_state(js), num_epochs=1,
                                                verbose=False)
            runs.append((hist, list(masks)))
        # per sub-batch the visual head's dropout, then the two hidden layers'; 2 videos × 2 sub-batches
        assert len(runs[0][1]) == 12
        head = runs[0][1][0::3]
        assert all(not torch.equal(head[i], head[j]) for i in range(4) for j in range(i + 1, 4))
        assert runs[0][0] == runs[1][0]
        assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))

    def test_train_forward_needs_a_generator_with_dropout(self, small_cfg):
        cfg = _pcfg(_jcfg(small_cfg, dropout_rate=0.2))
        js = jax_state(jax.random.PRNGKey(0), small_cfg)
        p, ms = W.from_jax(js.params, js.model_state, device=CPU)
        x = torch.rand(5, 24, 24, 3)
        a = torch.rand(5, 12, 13)
        with pytest.raises(ValueError, match="requires a generator"):
            avm_train_apply(p, ms, x, a, cfg=cfg.model)
        out, _ = avm_train_apply(p, ms, x, a, cfg=cfg.model, generator=torch.Generator().manual_seed(0))
        assert out.shape == (5, 1)


# ------------------------------------------------------------------- forwards


def _f64(tree):
    return jax.tree.map(lambda x: jnp.asarray(np.asarray(x, np.float64)), tree)


def _port_grads(fn, tree, dtype):
    """``fn(tree) → (output, aux)`` on a copy of ``tree`` in ``dtype`` → (output, aux, gradient tree of
    Σ output)."""
    leaves = [p.detach().to(dtype).requires_grad_() for p in tree_leaves(tree)]
    out, aux = fn(tree_unflatten(tree, leaves))
    return out.detach(), aux, tree_unflatten(tree, torch.autograd.grad(out.sum(), leaves))


class TestForwards:
    """The train forwards and their gradients against the JAX function run in float64 (``jax.enable_x64``):
    the port in float64 within 1e-9·max (the same function), in float32 within 1e-5·max.  The JAX function's
    own float32 gradients are a worse reference: on the masked trunk below its conv0 bias gradient is 2.3e-5
    of its largest entry from float64, the port's float32 one 8e-7."""

    @staticmethod
    def _check(jax_fn, port_fn, tree, args64, port_args):
        with jax.enable_x64(True):
            args64 = [None if a is None else jnp.asarray(a, jnp.float64) for a in args64]
            (_, (jo, jst)), jg = jax.jit(jax.value_and_grad(
                lambda p, *a: (lambda o: (jnp.sum(o[0]), o))(jax_fn(p, *a)), has_aux=True))(_f64(_np(tree)), *args64)
        for dtype, tol in ((torch.float64, 1e-9), (torch.float32, 1e-5)):
            args = [None if a is None else a.to(dtype) for a in port_args]
            out, st, g = _port_grads(lambda t: port_fn(t, *args), tree, dtype)
            _close(out, jo, tol)
            _close_trees(st, jst, tol)
            _close_trees(g, jg, tol)

    @pytest.mark.parametrize("masked", [False, True])
    def test_visual_train_forward_and_grads(self, small_cfg, masked):
        jc = _jcfg(small_cfg)
        js = jax_state(jax.random.PRNGKey(1), jc)
        rng = np.random.default_rng(5)
        x = rng.random((10, 24, 24, 3))
        mask = np.array([1.0] * 7 + [0.0] * 3) if masked else np.ones(10)
        # a padded row's frame is zeros, so its pooling windows tie; the training loss gives it no cotangent
        # (the mask), and neither does this one
        w = rng.standard_normal((10, jc.model.vis_feature_dim)) * mask[:, None]
        tp, tms = W.from_jax(js.params, js.model_state, device=CPU)
        m = None if not masked else mask

        def jax_fn(p, x, w, m):   # called inside the float64 scope
            f, st = jax_visual(p, _f64(js.model_state["visual"]), x, train=True, rng=None, dropout_rate=0.0, mask=m)
            return f * w, st

        def port_fn(p, x, w, m):
            st = tree_map(lambda t: t.to(x.dtype), tms["visual"])
            f, st = visual_encoder_train_apply(p, st, x, generator=None, dropout_rate=0.0, mask=m)
            return f * w, st

        self._check(jax_fn, port_fn, tp["visual"], (x, w, m),
                    [torch.as_tensor(x), torch.as_tensor(w), None if m is None else torch.as_tensor(m)])

    @pytest.mark.parametrize("audio,classifier", [(True, False), (False, False), (True, True)])
    def test_avm_train_forward_and_grads(self, small_cfg, audio, classifier):
        jc = _jcfg(small_cfg, audio_included=audio)
        js = jax_state(jax.random.PRNGKey(2), jc, classifier=classifier)
        rng = np.random.default_rng(6)
        x = rng.random((10, 24, 24, 3))
        a = rng.random((10, 12, 13))
        valid = np.array([1.0] * 8 + [0.0] * 2)
        w = rng.standard_normal((10, 5 if classifier else 1)) * valid[:, None]   # zero on padding, as the loss
        tp, tms = W.from_jax(js.params, js.model_state, device=CPU)
        pcfg = _pcfg(jc).model

        def jax_fn(p, x, a, w, v):   # called inside the float64 scope
            out, st = jax_avm(p, _f64(js.model_state), x, a if audio else None, cfg=jc.model, train=True, classifier=classifier,
                              valid=v)
            return out * w, st

        def port_fn(p, x, a, w, v):
            st = tree_map(lambda t: t.to(x.dtype), tms)
            out, st = avm_train_apply(p, st, x, a if audio else None, cfg=pcfg, classifier=classifier, valid=v)
            return out * w, st

        self._check(jax_fn, port_fn, tp, (x, a, w, valid), [torch.as_tensor(t) for t in (x, a, w, valid)])

    def test_audio_encoder_is_differentiable(self, small_cfg):
        js = jax_state(jax.random.PRNGKey(3), small_cfg)
        x = np.random.default_rng(7).random((6, 12, 13))
        tp = W.tree_from_jax(js.params["audio"], CPU)
        self._check(lambda p, x: (jax_audio(p, x) ** 2, {}), lambda p, x: (torch_audio(p, x) ** 2, {}), tp,
                    (x,), [torch.as_tensor(x)])
        xt = torch.as_tensor(x, dtype=torch.float32).requires_grad_()
        assert torch.autograd.grad(torch_audio(tp, xt).sum(), xt)[0].abs().max() > 0


# ------------------------------------------------------------- the video step


@functools.lru_cache(maxsize=None)
def _jax_subbatch_grad(jc, classifier):
    tc = jc.train

    def loss_of(p, ms, vis, aud, lab, msk):
        out, new_ms = jax_avm(p, ms, vis, aud, cfg=jc.model, train=True, classifier=classifier, valid=msk)
        return JL._loss_fn(out, lab, msk, broadcast_compat=tc.broadcast_loss_compat, classifier=classifier), new_ms

    return jax.jit(jax.value_and_grad(loss_of, has_aux=True))


def _jax_trajectory(jc, js, item, classifier=False):
    """The JAX package's own trajectory through one video, step by step (K = 1 or K > 1) → (each sub-batch's
    gradient, each sub-batch's new batchnorm state, each gradient Adam stepped on)."""
    tc = jc.train
    S, K = tc.subbatch_size, tc.grad_accum_steps
    visual, audio, labels, valid, _, _ = JL._pad_video(item, S)
    lr_fn = schedule_from_config(tc)
    grad_fn = _jax_subbatch_grad(jc, classifier)
    params, ms, opt = js.params, js.model_state, js.opt_state
    grads_seen, states_seen, applied, gacc, n_sub = [], [], [], None, len(visual) // S
    for idx in range(n_sub):
        sl = slice(idx * S, (idx + 1) * S)
        (_, ms), g = grad_fn(params, ms, jnp.asarray(visual[sl]), None if audio is None else jnp.asarray(audio[sl]),
                             jnp.asarray(labels[sl]), jnp.asarray(valid[sl]))
        grads_seen.append(g)
        states_seen.append(ms)
        gacc = g if gacc is None else jax.tree.map(jnp.add, gacc, g)
        count = 1 if K <= 1 else (K if idx % K == K - 1 else (n_sub % K if idx == n_sub - 1 else 0))
        if count:
            mean = jax.tree.map(lambda a: a / count, gacc)
            applied.append(mean)
            params, opt = adam_update(clip_by_global_norm(mean, tc.grad_clip_norm), opt, params, lr_fn(opt.step),
                                      tc.b1, tc.b2, tc.eps, tc.weight_decay)
            gacc = None
    return grads_seen, states_seen, applied


def _steady(grads_seen):
    """Entries whose JAX gradient is at least 1e-3 of its leaf's largest at every Adam step."""
    steady = jax.tree.map(lambda g: np.ones(g.shape, bool), grads_seen[0])
    for g in grads_seen:
        steady = jax.tree.map(lambda s, x: s & (np.abs(x) >= 1e-3 * np.abs(x).max()), steady, _np(g))
    return steady


ACCUM = dict(grad_accum_steps=2, grad_clip_norm=0.5, weight_decay=0.01, lr_schedule="cosine", lr_warmup_steps=1,
             lr_decay_steps=4)
STEP_CASES = [(dict(), False), (ACCUM, False), (dict(grad_accum_steps=8, grad_clip_norm=0.5), False),
              (dict(broadcast_loss_compat=True), False), (dict(), True), (ACCUM, True)]


class TestTrainVideoFn:
    """One 13-frame video (3 sub-batches of 5, the last with 3 real frames) through ``make_train_video_fn``.

    Once Adam has stepped, the entries it moved on gradient noise differ by up to 2·lr between the packages,
    and the batchnorm statistics of later sub-batches move with them, so the running state is held to JAX
    after the first sub-batch, and after the whole video where no step comes before the end (K = 8: the three
    sub-batches all run at the first parameters and the tail of three is applied once)."""

    @pytest.mark.parametrize("train,classifier", STEP_CASES,
                             ids=["k1", "k2_tail_clip_decay_cosine", "k8_tail_only", "broadcast_compat",
                                  "classifier_k1", "classifier_k2"])
    def test_matches_jax(self, small_cfg, train, classifier):
        jc = _jcfg(small_cfg, train)
        js = jax_state(jax.random.PRNGKey(4), jc, classifier=classifier)
        jitems, titems = _items(jc, [(13, 8)])   # 3 sub-batches: K = 2 leaves a tail of 1
        jitem, titem = jitems[0], titems[0]
        S = jc.train.subbatch_size
        v, a, lab, valid, n, _ = JL._pad_video(jitem, S)
        jfn = JL.make_train_video_fn(jc, classifier)
        jp, jms, jo, jpreds, jloss = jfn(js.params, js.model_state, js.opt_state, jnp.asarray(v), jnp.asarray(a),
                                         jnp.asarray(lab), jnp.asarray(valid), jax.random.PRNGKey(0))

        ts = _port_state(js)
        tfn = TL.make_train_video_fn(_pcfg(jc), classifier)
        tv, ta, tlab, tvalid, tn = TL._pad_video(titem, S, torch.device(CPU))
        assert tn == n == 13 and torch.equal(tvalid, torch.as_tensor(valid))
        # the first sub-batch's gradients, leaf by leaf
        grads_seen, states_seen, applied = _jax_trajectory(jc, js, jitem, classifier)
        _, _, ms0, g0 = tfn.value_and_grad(ts.params, ts.model_state, tv[:S], ta[:S], tlab[:S], tvalid[:S], None)
        _close_trees(g0, grads_seen[0])
        _close_trees(ms0, states_seen[0], 1e-6)

        tp, tms, to, tpreds, tloss = tfn(ts.params, ts.model_state, ts.opt_state, tv, ta, tlab, tvalid, None)
        assert float(tloss) == pytest.approx(float(jloss), rel=1e-5)
        # the real frames' outputs (a padded frame's is never read, and lies far outside the batch statistics)
        if classifier:
            assert np.array_equal(tpreds.numpy()[:n], np.asarray(jpreds)[:n])
        else:
            _close(tpreds[:n], np.asarray(jpreds)[:n])
        K = jc.train.grad_accum_steps
        n_steps = len(applied)
        assert to.step == int(jo.step) == n_steps == -(-(len(v) // S) // K)
        if K > len(v) // S:
            _close_trees(tms, jms, 1e-6)
        kept = total = 0
        lr = jc.train.learning_rate
        for a_, b_, s in zip(jax.tree.leaves(_np(tp)), jax.tree.leaves(_np(jp)),
                             jax.tree.leaves(_steady(applied))):
            np.testing.assert_allclose(a_[s], b_[s], atol=1e-5, rtol=0)
            assert np.abs(a_ - b_).max() <= 2 * lr * n_steps
            kept, total = kept + s.sum(), total + s.size
        assert kept > 0.5 * total, f"only {kept} of {total} entries compared"

    def test_bf16_is_refused(self, small_cfg):
        """bf16 mixed precision is no longer refused: one sub-batch's loss and gradients come back float32 for
        the float32 master params (five steps against the JAX package: test_torch_bf16.py)."""
        jc = _jcfg(small_cfg, {"compute_dtype": "bfloat16"})
        ts = _port_state(jax_state(jax.random.PRNGKey(4), jc))
        _, titems = _items(jc, [(5, 8)])
        tv, ta, tlab, tvalid, _ = TL._pad_video(titems[0], jc.train.subbatch_size, torch.device(CPU))
        loss, preds, ms, grads = TL.make_train_video_fn(_pcfg(jc)).value_and_grad(
            ts.params, ts.model_state, tv, ta, tlab, tvalid, None)
        assert loss.dtype == preds.dtype == torch.float32 and torch.isfinite(loss)
        assert all(g.dtype == torch.float32 and torch.isfinite(g).all() for g in tree_leaves(grads))
        assert all(s.dtype == torch.float32 for s in tree_leaves(ms))

    def test_loss_fn_matches_jax(self):
        rng = np.random.default_rng(9)
        labels = rng.integers(1, 6, 7).astype(np.float32)
        mask = np.array([1, 1, 1, 1, 1, 0, 0], np.float32)
        for classifier, compat, width in ((False, False, 1), (False, True, 1), (True, False, 5)):
            preds = (rng.standard_normal((7, width)) + 3).astype(np.float32)
            want = JL._loss_fn(jnp.asarray(preds), jnp.asarray(labels), jnp.asarray(mask), broadcast_compat=compat,
                               classifier=classifier)
            got = TL._loss_fn(torch.as_tensor(preds), torch.as_tensor(labels), torch.as_tensor(mask),
                              broadcast_compat=compat, classifier=classifier)
            assert float(got) == pytest.approx(float(want), rel=1e-6)


# ------------------------------------------------------------------ evaluation


class TestEval:
    @pytest.mark.parametrize("compat", [False, True])
    @pytest.mark.parametrize("classifier", [False, True])
    def test_eval_video_and_evaluate_dataset(self, small_cfg, compat, classifier):
        jc = _jcfg(small_cfg, {"eval_train_mode_compat": compat})
        js = jax_state(jax.random.PRNGKey(5), jc, classifier=classifier)
        ts = _port_state(js)
        jitems, titems = _items(jc, [(7, 10), (12, 11)])
        for ji, ti in zip(jitems, titems):
            jp, jl = JL.eval_video(js, ji, jc, classifier)
            tp, tl = TL.eval_video(ts, ti, _pcfg(jc), classifier)
            assert tp.shape == (ji.visual.shape[0],)
            if classifier:
                assert np.array_equal(tp, jp)
            else:
                _close(tp, jp)
            assert tl == pytest.approx(jl, rel=1e-5)
        if not classifier:
            want = JL.evaluate_dataset(js, JDS(jitems), jc)
            got = TL.evaluate_dataset(ts, TDS(titems), _pcfg(jc))
            assert got[0] == pytest.approx(want[0], rel=1e-5) and got[1:] == want[1:]
            assert TL.evaluate_dataset(ts, TDS([]), _pcfg(jc)) is None

    def test_eval_runs_the_eval_forward_under_no_grad(self, small_cfg, monkeypatch):
        """The eval forward (kernels 2–4 on the card) runs with grad off and state leaves that need none."""
        import cvml_goalnet_tpu_torch.models.avm as TA

        seen = []
        real = TA.avm_apply

        def spy(params, state, *a, **kw):
            seen.append(torch.is_grad_enabled() or any(t.requires_grad for t in tree_leaves((params, state))))
            return real(params, state, *a, **kw)

        monkeypatch.setattr(TL, "avm_apply", spy)
        _, titems = _items(small_cfg, [(6, 0)])
        TL.eval_video(create_train_state(0, _pcfg(small_cfg), device=CPU), titems[0], _pcfg(small_cfg))
        assert seen == [False]


# --------------------------------------------------------------- the driver


# Adam's eps at 1e-4 in the two-epoch runs: at the default 1e-8 Adam moves an entry by about lr·sign(g) even
# where g is rounding noise, and after ten such steps the packages' val losses part by 4e-5 relative; with
# eps above that noise an entry moves by lr·g/eps there, which the noise cannot flip.  The per-video cases
# above run the default eps, with the steady / moved split.
LOOP_EPS = 1e-4
LOOP_CASES = [
    dict(eps=LOOP_EPS),
    dict(eps=LOOP_EPS, optimum_metric="val_loss", early_stop_patience=1, checkpoint_every=2),
    dict(eps=LOOP_EPS, grad_accum_steps=2, grad_clip_norm=1.0, lr_schedule="linear", lr_decay_steps=5,
         optimum_metric="val_f_avg"),
]


class TestTrainImportanceModel:
    @pytest.mark.parametrize("train", LOOP_CASES, ids=["default", "val_loss_early_stop", "accum_val_f"])
    def test_two_epochs_match_jax(self, small_cfg, train, tmp_path):
        jc = _jcfg(small_cfg, train)
        js = jax_state(jax.random.PRNGKey(6), jc)
        jitems, titems = _items(jc, [(13, 20), (11, 21), (9, 22)])
        jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
        jbest, jh = JL.train_importance_model(jc, JDS(jitems[:2]), JDS(jitems[2:]), js, num_epochs=2,
                                              checkpoint_dir=jdir, verbose=False)
        tbest, th = TL.train_importance_model(_pcfg(jc), TDS(titems[:2]), TDS(titems[2:]), _port_state(js),
                                              num_epochs=2, checkpoint_dir=tdir, verbose=False)
        _history_close(th, jh)
        assert th["best_epoch"] == jh["best_epoch"] and th.get("early_stopped") == jh.get("early_stopped")
        assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))
        assert tbest.epoch == jbest.epoch

    def test_verbose_log_matches_jax(self, small_cfg, capsys):
        jc = _jcfg(small_cfg)
        js = jax_state(jax.random.PRNGKey(7), jc)
        jitems, titems = _items(jc, [(10, 30), (10, 31)])
        JL.train_importance_model(jc, JDS(jitems[:1]), JDS(jitems[1:]), js, num_epochs=1)
        want = capsys.readouterr().out
        TL.train_importance_model(_pcfg(jc), TDS(titems[:1]), TDS(titems[1:]), _port_state(js), num_epochs=1)
        got = capsys.readouterr().out
        strip = lambda s: [ln for ln in s.splitlines() if not ln.startswith("Δt")]   # noqa: E731
        assert strip(got) == strip(want)

    def test_requires_labels_masks_and_a_train_set(self, small_cfg):
        cfg = _pcfg(small_cfg)
        state = create_train_state(0, cfg, device=CPU)
        _, (good,) = _items(small_cfg, [(10, 0)])
        for bad, match in ((dataclasses.replace(good, labels=None), "has no labels"),
                           (dataclasses.replace(good, gd_summary_masks=None), "ground-truth masks")):
            with pytest.raises(ValueError, match=match):
                TL.train_importance_model(cfg, TDS([bad]), TDS([]), state, num_epochs=1, verbose=False)
        with pytest.raises(ValueError, match="train_ds is empty"):
            TL.train_importance_model(cfg, TDS([]), TDS([]), state, num_epochs=1, verbose=False)
        val_cfg = _pcfg(_jcfg(small_cfg, {"optimum_metric": "val_loss"}))
        with pytest.raises(ValueError, match="needs a non-empty val split"):
            TL.train_importance_model(val_cfg, TDS([good]), TDS([]), state, num_epochs=1, verbose=False)
        with pytest.raises(ValueError, match="unknown optimum_metric"):
            TL.train_importance_model(_pcfg(_jcfg(small_cfg, {"optimum_metric": "f1"})), TDS([good]), TDS([]),
                                      state, num_epochs=1, verbose=False)

    def test_orbax_backend_is_refused(self, small_cfg, tmp_path):
        """``checkpoint_backend="orbax"`` (the name records the refusal this test once held) writes the rolling
        and optimum checkpoints in the ``<tag>_orbax/`` layout, and the JAX package's ``load_checkpoint_orbax``
        restores them bit-equal to the port's own restore (one epoch: ``ckp`` at epoch 1, Adam at step 2)."""
        from cvml_goalnet_tpu.train import orbax_io as JO
        from cvml_goalnet_tpu.train.optim import AdamState as JAdam
        from cvml_goalnet_tpu.train.state import TrainState as JState
        from cvml_goalnet_tpu_torch.train.orbax_io import _leaves, load_checkpoint_orbax

        cfg = _pcfg(small_cfg)
        _, items = _items(small_cfg, [(10, 0)])
        state = create_train_state(0, cfg, device=CPU)
        TL.train_importance_model(cfg, TDS(items), TDS([]), state, num_epochs=1, checkpoint_dir=str(tmp_path),
                                  verbose=False, checkpoint_backend="orbax")
        to = lambda t: jnp.asarray(t.numpy())   # noqa: E731
        jtpl = JState(params=tree_map(to, state.params), model_state=tree_map(to, state.model_state),
                      opt_state=JAdam(step=jnp.asarray(0, dtype=jnp.int32), mu=tree_map(to, state.opt_state.mu),
                                      nu=tree_map(to, state.opt_state.nu)), epoch=0)
        for tag in ("ckp", "opt"):
            mine = load_checkpoint_orbax(str(tmp_path), state, tag=tag)
            theirs = JO.load_checkpoint_orbax(str(tmp_path), jtpl, tag=tag)
            assert theirs.epoch == mine.epoch and int(theirs.opt_state.step) == mine.opt_state.step
            flat = [{k: np.asarray(v) for k, _, v in _leaves([st.params, st.model_state, st.opt_state.mu,
                                                              st.opt_state.nu])} for st in (mine, theirs)]
            assert flat[0].keys() == flat[1].keys()
            for k in flat[0]:
                np.testing.assert_array_equal(flat[0][k], flat[1][k], err_msg=str(k))
        assert load_checkpoint_orbax(str(tmp_path), state, tag="ckp").epoch == 1

    def test_empty_val_set_and_no_audio(self, small_cfg):
        jc = _jcfg(small_cfg, {"eps": LOOP_EPS}, audio_included=False)
        js = jax_state(jax.random.PRNGKey(8), jc)
        jitems, titems = _items(jc, [(10, 40)], audio=False)
        _, jh = JL.train_importance_model(jc, JDS(jitems), JDS([]), js, num_epochs=2, verbose=False)
        _, th = TL.train_importance_model(_pcfg(jc), TDS(titems), TDS([]), _port_state(js), num_epochs=2,
                                          verbose=False)
        assert th["val_loss"] == [] and len(th["train_loss"]) == 3
        _history_close(th, jh)

    def test_resumed_state_starts_at_its_epoch(self, small_cfg, tmp_path):
        cfg = _pcfg(_jcfg(small_cfg))
        _, items = _items(small_cfg, [(10, 50)])
        state = create_train_state(1, cfg, device=CPU)
        TL.train_importance_model(cfg, TDS(items), TDS([]), state, num_epochs=1, checkpoint_dir=str(tmp_path),
                                  verbose=False)
        resumed = load_checkpoint(str(tmp_path), state, tag="ckp")
        assert resumed.epoch == 1 and resumed.opt_state.step == 2
        _, hist = TL.train_importance_model(cfg, TDS(items), TDS([]), resumed, num_epochs=3, verbose=False)
        assert len(hist["train_loss"]) == 3 and hist["lr"] == [cfg.train.learning_rate] * 3


class TestNanGuard:
    def _cfg(self, small_cfg, guard, limit=3, epochs=1):
        return _pcfg(_jcfg(small_cfg, {"nan_guard": guard, "nan_guard_limit": limit, "num_epochs": epochs}))

    def _poisoned(self, small_cfg, n=10, seed=3):
        _, (item,) = _items(small_cfg, [(n, seed)])
        return dataclasses.replace(item, video_id="poison", labels=np.full(n, np.nan, np.float32))

    def test_rollback_discards_exactly_the_poisoned_updates(self, small_cfg, tmp_path):
        cfg = self._cfg(small_cfg, "rollback", limit=5)
        _, (good,) = _items(small_cfg, [(10, 0)])
        state0 = create_train_state(1, cfg, device=CPU)
        dir_a, dir_b = str(tmp_path / "a"), str(tmp_path / "b")
        _, hist_a = TL.train_importance_model(cfg, TDS([good, self._poisoned(small_cfg)]), TDS([]), state0,
                                              checkpoint_dir=dir_a, verbose=False)
        _, hist_b = TL.train_importance_model(cfg, TDS([good]), TDS([]), state0, checkpoint_dir=dir_b, verbose=False)
        assert hist_a["nan_rollbacks"] == 1 and "nan_rollbacks" not in hist_b
        assert np.isfinite(hist_a["train_loss"][1:]).all()
        sa = load_checkpoint(dir_a, create_train_state(2, cfg, device=CPU), tag="ckp")
        sb = load_checkpoint(dir_b, create_train_state(3, cfg, device=CPU), tag="ckp")
        assert sa.opt_state.step == sb.opt_state.step == 2
        for a, b in zip(tree_leaves((sa.params, sa.model_state, sa.opt_state.mu, sa.opt_state.nu)),
                        tree_leaves((sb.params, sb.model_state, sb.opt_state.mu, sb.opt_state.nu))):
            assert torch.equal(a, b)

    def test_raise_mode_fails_loudly(self, small_cfg):
        cfg = self._cfg(small_cfg, "raise")
        _, (good,) = _items(small_cfg, [(10, 0)])
        with pytest.raises(FloatingPointError, match="poison"):
            TL.train_importance_model(cfg, TDS([good, self._poisoned(small_cfg)]), TDS([]),
                                      create_train_state(1, cfg, device=CPU), verbose=False)

    def test_rollback_limit_exhausted_raises(self, small_cfg):
        cfg = self._cfg(small_cfg, "rollback", limit=1, epochs=3)
        _, (good,) = _items(small_cfg, [(10, 0)])
        with pytest.raises(FloatingPointError, match="after 1 rollbacks"):
            TL.train_importance_model(cfg, TDS([good, self._poisoned(small_cfg)]), TDS([]),
                                      create_train_state(1, cfg, device=CPU), verbose=False)

    def test_all_videos_poisoned_raises(self, small_cfg):
        cfg = self._cfg(small_cfg, "rollback", limit=10)
        with pytest.raises(FloatingPointError, match="every training video"):
            TL.train_importance_model(cfg, TDS([self._poisoned(small_cfg)]), TDS([]),
                                      create_train_state(1, cfg, device=CPU), verbose=False)

    def test_off_records_the_loss(self, small_cfg):
        cfg = self._cfg(small_cfg, "off")
        _, (good,) = _items(small_cfg, [(10, 0)])
        _, hist = TL.train_importance_model(cfg, TDS([good, self._poisoned(small_cfg)]), TDS([]),
                                            create_train_state(1, cfg, device=CPU), verbose=False)
        assert not np.isfinite(hist["train_loss"][-1])

    def test_unknown_guard_rejected(self, small_cfg):
        cfg = self._cfg(small_cfg, "explode")
        _, (good,) = _items(small_cfg, [(10, 0)])
        with pytest.raises(ValueError, match="unknown nan_guard"):
            TL.train_importance_model(cfg, TDS([good]), TDS([]), create_train_state(1, cfg, device=CPU),
                                      verbose=False)


# ------------------------------------------------------------ checkpointing


class TestAsyncCheckpointer:
    def test_supersede_and_roundtrip(self, small_cfg, tmp_path):
        cfg = _pcfg(small_cfg)
        state = create_train_state(0, cfg, device=CPU)
        ck = AsyncCheckpointer()
        ck.save(str(tmp_path), state, cfg, tag="ckp")
        ck.save(str(tmp_path), state._replace(epoch=7), cfg, tag="ckp")
        ck.wait()
        restored = load_checkpoint(str(tmp_path), state, tag="ckp")
        assert restored.epoch == 7
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(restored.params), tree_leaves(state.params)))

    def test_rapid_saves_never_drop_the_last_snapshot(self, small_cfg, tmp_path):
        """A save racing the worker's decision to exit must still be written (thread switches forced often)."""
        cfg = _pcfg(small_cfg)
        state = create_train_state(0, cfg, device=CPU)
        ck = AsyncCheckpointer()
        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            for e in range(30):
                ck.save(str(tmp_path), state._replace(epoch=e), cfg, tag="ckp")
            ck.wait()
            assert load_checkpoint(str(tmp_path), state, tag="ckp").epoch == 29
            for e in range(5):
                ck.save(str(tmp_path), state._replace(epoch=100 + e), cfg, tag="ckp")
                ck.wait()
                assert load_checkpoint(str(tmp_path), state, tag="ckp").epoch == 100 + e
        finally:
            sys.setswitchinterval(interval)

    def test_the_snapshot_is_taken_at_save(self, small_cfg, tmp_path):
        cfg = _pcfg(small_cfg)
        state = create_train_state(0, cfg, device=CPU)
        want = [t.clone() for t in tree_leaves(state.params)]
        ck = AsyncCheckpointer()
        ck.save(str(tmp_path), state, cfg, tag="opt")
        for t in tree_leaves(state.params):   # written in place after save: the file keeps the snapshot
            t.add_(1.0)
        ck.wait()
        got = load_checkpoint(str(tmp_path), create_train_state(1, cfg, device=CPU), tag="opt")
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got.params), want))

    def test_wait_surfaces_write_errors(self, small_cfg, tmp_path):
        cfg = _pcfg(small_cfg)
        bad = tmp_path / "not_a_dir"
        bad.write_text("a file blocks the directory")
        ck = AsyncCheckpointer()
        ck.save(str(bad), create_train_state(0, cfg, device=CPU), cfg, tag="ckp")
        with pytest.raises(OSError):
            ck.wait()

    def test_training_with_async_checkpoint(self, small_cfg, tmp_path):
        cfg = _pcfg(_jcfg(small_cfg))
        _, items = _items(small_cfg, [(10, 0)])
        state = create_train_state(0, cfg, device=CPU)
        _, h_async = TL.train_importance_model(cfg, TDS(items), TDS(items), state, num_epochs=2,
                                               checkpoint_dir=str(tmp_path / "a"), verbose=False,
                                               async_checkpoint=True)
        _, h_sync = TL.train_importance_model(cfg, TDS(items), TDS(items), state, num_epochs=2,
                                              checkpoint_dir=str(tmp_path / "s"), verbose=False)
        assert h_async == h_sync
        for tag in ("ckp", "opt"):
            a = load_checkpoint(str(tmp_path / "a"), state, tag=tag)
            s = load_checkpoint(str(tmp_path / "s"), state, tag=tag)
            assert a.epoch == s.epoch and (tag == "opt" or a.epoch == 2)
            assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a.params), tree_leaves(s.params)))


class TestResilience:
    def test_recovery_restores_the_rolling_checkpoint_as_jax_does(self, small_cfg, tmp_path):
        jc = _jcfg(small_cfg, {"eps": LOOP_EPS})
        js = jax_state(jax.random.PRNGKey(9), jc)
        jitems, titems = _items(jc, [(10, 60), (10, 61)])

        def flaky():
            calls = []

            def hook(epoch, history, best):
                calls.append(epoch)
                if len(calls) == 1:
                    raise RuntimeError("transient failure")
            return hook

        jb, jh, jr = JR.train_with_recovery(jc, JDS(jitems[:1]), JDS(jitems[1:]), js, str(tmp_path / "j"),
                                            num_epochs=2, verbose=False, on_epoch_end=flaky())
        log = str(tmp_path / "events.jsonl")
        tb, th, tr = TR.train_with_recovery(_pcfg(jc), TDS(titems[:1]), TDS(titems[1:]), _port_state(js),
                                            str(tmp_path / "t"), num_epochs=2, verbose=False,
                                            on_epoch_end=flaky(), metrics_logger=MetricsLogger(log))
        assert tr == jr == 1
        _history_close(th, jh)
        events = MetricsLogger.read(log)
        assert [e["event"] for e in events].count("train_failure") == 1
        assert "transient failure" in next(e for e in events if e["event"] == "train_failure")["error"]

    def test_gives_up_after_max_restarts(self, small_cfg, tmp_path):
        cfg = _pcfg(_jcfg(small_cfg))
        _, items = _items(small_cfg, [(10, 62)])

        def always(epoch, history, best):
            raise RuntimeError("persistent failure")

        with pytest.raises(RuntimeError, match="persistent failure"):
            TR.train_with_recovery(cfg, TDS(items), TDS([]), create_train_state(0, cfg, device=CPU),
                                   str(tmp_path), max_restarts=1, num_epochs=2, verbose=False, on_epoch_end=always)

    def test_preemption_guard_checkpoints_and_stops(self, small_cfg, tmp_path):
        """The JAX package's own case: the signal arrives at the end of epoch 1; the loop writes ``ckp`` and
        stops, and a resume finishes the run."""
        cfg = _pcfg(_jcfg(small_cfg))
        _, items = _items(small_cfg, [(10, 63)])
        prev = signal.getsignal(signal.SIGUSR1)

        def on_epoch_end(epoch, history, best):
            if epoch == 1:
                os.kill(os.getpid(), signal.SIGUSR1)

        with TR.PreemptionGuard(signals=(signal.SIGUSR1,)) as guard:
            _, hist = TL.train_importance_model(cfg, TDS(items), TDS(items), create_train_state(0, cfg, device=CPU),
                                                num_epochs=10, checkpoint_dir=str(tmp_path), verbose=False,
                                                on_epoch_end=on_epoch_end, preemption_guard=guard)
        assert signal.getsignal(signal.SIGUSR1) == prev
        assert hist["preempted"] is True and len(hist["train_loss"]) == 3
        restored = load_checkpoint(str(tmp_path), create_train_state(1, cfg, device=CPU), tag="ckp")
        assert restored.epoch == 2 and restored.opt_state.step == 4
        _, hist2 = TL.train_importance_model(cfg, TDS(items), TDS(items), restored, num_epochs=4, verbose=False)
        assert "preempted" not in hist2 and len(hist2["train_loss"]) == 3


# ------------------------------------------------------------- baseline, utils


class TestBaseline:
    def test_summarize_baseline_matches_jax(self):
        rng = np.random.default_rng(11)
        metrics = {k: list(rng.random(4)) for k in ("train_loss", "train_f_avg", "train_f_max")}
        metrics.update(val_loss=[], val_f_avg=[], val_f_max=[])
        assert TB.summarize_baseline(metrics) == JB.summarize_baseline(metrics)

    def test_random_models_are_the_seeded_states(self, small_cfg):
        cfg = _pcfg(small_cfg)
        _, items = _items(small_cfg, [(10, 70), (10, 71)])
        m = TB.evaluate_random_models(cfg, TDS(items[:1]), TDS(items[1:]), n_samples=2, seed=4, device=CPU)
        assert all(len(v) == 2 for v in m.values())
        for s in range(2):
            state = create_train_state(4 + s, cfg, device=CPU)
            tr, vl = (TL.evaluate_dataset(state, TDS(d), cfg) for d in (items[:1], items[1:]))
            assert (m["train_loss"][s], m["train_f_avg"][s], m["val_f_max"][s]) == (tr[0], tr[1], vl[2])
        assert TB.evaluate_random_models(cfg, TDS(items), TDS([]), n_samples=1, device=CPU)["val_loss"] == []
        with pytest.raises(ValueError, match="has no labels"):
            TB.evaluate_random_models(cfg, TDS([dataclasses.replace(items[0], labels=None)]), TDS([]), 1,
                                      device=CPU)


class TestUtils:
    def test_console_lines_match_jax(self, capsys):
        for mod in (JLog, TLog):
            mod.log_epoch_header(3, 10)
            mod.log_val_delta(0.5, 0.7)
            mod.log_val_delta(0.9, 0.7)
            mod.log_metrics("epoch 3", (1.0, 0.5, 0.6), (1.1, 0.4, 0.5), 2.25)
            mod.log_metrics("initial", (1.0, 0.5, 0.6), None)
        out = capsys.readouterr().out
        half = len(out) // 2
        assert out[:half] == out[half:] and "Val ΔL" in out

    def test_metrics_logger_writes_the_jax_records(self, tmp_path):
        recs = []
        for cls, name in ((JMetricsLogger, "j.jsonl"), (MetricsLogger, "t.jsonl")):
            lg = cls(str(tmp_path / "sub" / name))
            lg.log_epoch(-1, (1.0, 0.5, 0.6), None)
            lg.log_epoch(0, (0.9, 0.5, 0.6), (1.1, 0.4, 0.5), 1.234)
            lg.log("train_failure", restart=1, error="x")
            recs.append([{k: v for k, v in r.items() if k not in ("ts", "t")} for r in cls.read(lg.path)])
        assert recs[0] == recs[1] and len(recs[0]) == 3


def test_new_modules_import_no_jax():
    """A fresh interpreter: the training modules of the port leave jax and cvml_goalnet_tpu out of sys.modules
    (and matplotlib, imported only when a plot is drawn)."""
    code = (
        "import importlib, sys\n"
        "for m in ('train.loop', 'train.resilience', 'train.checkpoint', 'baseline', 'utils.logging',\n"
        "          'utils.metrics', 'models.layers', 'models.visual', 'models.avm', 'cli'):\n"
        "    importlib.import_module('cvml_goalnet_tpu_torch.' + m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'cvml_goalnet_tpu' or m.startswith('cvml_goalnet_tpu.') or m == 'matplotlib')\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
