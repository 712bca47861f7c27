"""PyTorch port: the resnet and vit visual backbones against the JAX package, on the CPU.

The same seeded numpy inputs and weights (JAX's ``avm_init`` / ``create_train_state``, carried
over by ``weights.from_jax``; every batchnorm's and layernorm's scale, shift and running
statistics redrawn away from the identity so the folds are exercised) go through
``cvml_goalnet_tpu`` and the port with ``device="cpu"``, at narrow widths: resnet channels
(8, 16, 16) with the CIFAR stem (24×24 frames) and the ImageNet stem (40×40), vit d = 16,
depth 2, 2 heads, patch 8 (9 and 25 tokens).  Tolerances:

* the eval forward in float32: 1e-5·max(1, max|f|);
* in bf16 against JAX's eager bf16 forward: 2 bf16 ulps of max|f| (both round every operation;
  a float32 sum taken in another order can land on the other side of a bf16 rounding boundary);
  scores within 0.0625 (2 bf16 ulps on [4, 5]) and on the bf16 grid;
* int8 at float32: the int8 values and the int32 sums at every quantized convolution and linear
  equal to ``cvml_goalnet_tpu/ops/quant.py``'s, except weights that ``_bn_fold``'s ``rsqrt``
  (one float32 ulp apart in the two libraries for some inputs) moves across a rounding boundary,
  which are counted, one int8 step each; features and scores within 1e-4;
* the train forward and its gradients in float64 (``jax.enable_x64``), with a ``valid`` mask:
  1e-5·max per output, state leaf and gradient leaf;
* trees, checkpoints, selections and masks: exact.
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
import cvml_goalnet_tpu.serve as JV
import cvml_goalnet_tpu.spotting as JS
from cvml_goalnet_tpu.models import resnet as JR
from cvml_goalnet_tpu.models.avm import _visual_init
from cvml_goalnet_tpu.models.avm import avm_apply as jax_avm
from cvml_goalnet_tpu.models.avm import avm_init
from cvml_goalnet_tpu.ops import quant as JQ
from cvml_goalnet_tpu.spotting import temporal_head_init_auto
from cvml_goalnet_tpu.train.checkpoint import load_checkpoint as jax_load_checkpoint
from cvml_goalnet_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from cvml_goalnet_tpu.train.state import create_train_state as jax_train_state
from cvml_goalnet_tpu.utils import tree_cast as jax_cast
import cvml_goalnet_tpu_torch.pipeline as TP
import cvml_goalnet_tpu_torch.serve as TV
import cvml_goalnet_tpu_torch.spotting as TS
from cvml_goalnet_tpu_torch import weights as W
from cvml_goalnet_tpu_torch.config import PipelineConfig
from cvml_goalnet_tpu_torch.models import resnet as TR
from cvml_goalnet_tpu_torch.models import vit as TVit
from cvml_goalnet_tpu_torch.models.avm import avm_train_apply, visual_apply
from cvml_goalnet_tpu_torch.ops import quant as TQ
from cvml_goalnet_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from cvml_goalnet_tpu_torch.train.optim import tree_leaves, tree_map, tree_unflatten
from cvml_goalnet_tpu_torch.train.state import TrainState, create_train_state
from cvml_goalnet_tpu_torch.utils import tree_cast

CPU = "cpu"
VIT = {"vit_embed_dim": 16, "vit_depth": 2, "vit_num_heads": 2, "vit_patch_size": 8}
BACKBONES = [("resnet", 24), ("resnet", 40), ("vit", 24), ("vit", 40)]
IDS = [f"{b}-{s}" for b, s in BACKBONES]


@pytest.fixture(autouse=True)
def _close_port_batchers():
    yield
    for b in list(TV._live_batchers):
        b.close()


def _jcfg(small_cfg, backbone, size=24, audio=True, **model):
    pre = dataclasses.replace(small_cfg.preprocess, frame_size=(size, size))
    m = dataclasses.replace(small_cfg.model, vis_backbone=backbone, audio_included=audio, **VIT, **model)
    return dataclasses.replace(small_cfg, preprocess=pre, model=m)


def _port(jcfg) -> PipelineConfig:
    return PipelineConfig.from_json(jcfg.to_json())


def _perturbed(params, state, seed):
    """Numpy copies of a JAX (params, state) with every normalisation's scale, shift and running statistics
    drawn away from the identity."""
    rng = np.random.default_rng(seed)

    def draw(path, x):
        name = str(path[-1].key) if hasattr(path[-1], "key") else ""
        x = np.asarray(x, np.float32)
        n = x.shape
        if name == "scale":
            return (1.0 + 0.1 * rng.standard_normal(n)).astype(np.float32)
        if name in ("bias", "mean"):
            return (0.1 * rng.standard_normal(n)).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 1.5, n).astype(np.float32)
        return x

    return (jax.tree_util.tree_map_with_path(draw, params), jax.tree_util.tree_map_with_path(draw, state))


def _weights(jcfg, seed=0):
    params, state = avm_init(jax.random.PRNGKey(seed), jcfg.model, jcfg.preprocess, jcfg.audio)
    return _perturbed(params, state, seed + 100)


def _frames(n, size, seed=0):
    """(n, size, size, 3) frames in [0, 1]: gratings of random brightness, frequency, phase and contrast, so
    frames differ (also after a global average pool)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size] / size
    out = np.empty((n, size, size, 3), np.float32)
    for i in range(n):
        for c in range(3):
            f, a, p, m = rng.uniform(1, 6), rng.uniform(0, np.pi), rng.uniform(0, 2 * np.pi), rng.uniform(0.2, 0.8)
            k = rng.uniform(0.3, 1.0) * min(m, 1 - m)
            out[i, :, :, c] = m + k * np.sin(2 * np.pi * f * (np.cos(a) * xx + np.sin(a) * yy) + p)
    return out


def _ulp(x) -> float:
    return float(2.0 ** (np.floor(np.log2(max(float(np.abs(x).max()), 2.0 ** -126))) - 7))


def _close(got, want, tol=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=tol * max(1.0, float(np.abs(want).max(initial=0))), rtol=0)


def _jax_features(jcfg, params, state, x, dtype="float32", quant=False):
    """JAX's eager backbone forward (bf16: params, state and frames cast first, as ``_jitted_fuse`` does)."""
    _, apply = _visual_init(jcfg.model)
    if dtype == "bfloat16":
        params, state, x = jax_cast(params, jnp.bfloat16), jax_cast(state, jnp.bfloat16), jnp.asarray(x, jnp.bfloat16)
    f, _ = apply(params["visual"], state["visual"], jnp.asarray(x), train=False, rng=jax.random.PRNGKey(0),
                 dropout_rate=0.0, quant=quant)
    return np.asarray(f.astype(jnp.float32))


def _port_features(jcfg, params, state, x, dtype="float32", quant=False):
    tp, ts = W.from_jax(params, state, device=CPU)
    x = torch.as_tensor(x)
    if dtype == "bfloat16":
        tp, ts, x = tree_cast(tp, torch.bfloat16), tree_cast(ts, torch.bfloat16), x.to(torch.bfloat16)
    apply, _ = visual_apply(_port(jcfg).model)
    with torch.no_grad():
        return apply(tp["visual"], ts["visual"], x, quant=quant).to(torch.float32).numpy()


def _assert_spread(f):
    """The features vary across frames: a port that printed one row for every frame would not pass."""
    assert float(np.abs(f - f.mean(axis=0)).max()) > 1e-2 * max(float(np.abs(f).max()), 1e-6)


# ------------------------------------------------------------------- trees


class TestTrees:
    @pytest.mark.parametrize("backbone,size", BACKBONES, ids=IDS)
    def test_init_params_match_avm_init(self, small_cfg, backbone, size):
        """``weights.init_params`` gives JAX's keys and shapes (lists as lists): the stem 3×3 below 32 px and
        7×7 from 32 px, projections where the stride or the width changes, an empty vit state."""
        jcfg = _jcfg(small_cfg, backbone, size)
        jp, js = avm_init(jax.random.PRNGKey(0), jcfg.model, jcfg.preprocess, jcfg.audio)
        tp, ts = W.init_params(_port(jcfg), seed=0)
        shapes = lambda t: jax.tree_util.tree_map(lambda x: tuple(np.shape(x)), t)   # noqa: E731
        assert jax.tree_util.tree_structure(tp) == jax.tree_util.tree_structure(jax.tree.map(np.asarray, jp))
        assert shapes(tp) == shapes(jp) and shapes(ts) == shapes(js)
        if backbone == "resnet":
            assert tp["visual"]["stem"]["w"].shape[0] == (7 if size >= 32 else 3)
            assert {k for k in tp["visual"] if "proj" in tp["visual"][k]} == {"s1b0", "s2b0"}
        else:
            assert ts == {"visual": {}} and len(tp["visual"]["blocks"]) == 2

    def test_unknown_backbone_and_ragged_patches_raise_as_jax(self, small_cfg):
        bad = _jcfg(small_cfg, "convnext")
        with pytest.raises(ValueError, match="unknown vis_backbone 'convnext'"):
            avm_init(jax.random.PRNGKey(0), bad.model, bad.preprocess, bad.audio)
        with pytest.raises(ValueError, match="unknown vis_backbone 'convnext'"):
            W.init_params(_port(bad), seed=0)
        with pytest.raises(ValueError, match="unknown vis_backbone 'convnext'"):
            visual_apply(_port(bad).model)
        for field, match in (({"vit_patch_size": 5}, "ragged patch grid"), ({"vit_num_heads": 3}, "divisible by")):
            jc = dataclasses.replace(_jcfg(small_cfg, "vit"), model=dataclasses.replace(
                _jcfg(small_cfg, "vit").model, **field))
            with pytest.raises(ValueError, match=match):
                avm_init(jax.random.PRNGKey(0), jc.model, jc.preprocess, jc.audio)
            with pytest.raises(ValueError, match=match):
                W.init_params(_port(jc), seed=0)

    def test_patchify_and_grid_match_jax(self, small_cfg):
        from cvml_goalnet_tpu.models.vit import _patchify, vit_grid

        x = np.random.default_rng(0).random((3, 24, 40, 3)).astype(np.float32)
        np.testing.assert_array_equal(TVit._patchify(torch.as_tensor(x), 8).numpy(), np.asarray(_patchify(x, 8)))
        jc = dataclasses.replace(_jcfg(small_cfg, "vit"), preprocess=dataclasses.replace(
            small_cfg.preprocess, frame_size=(24, 40)))
        assert TVit.vit_grid(_port(jc).model, _port(jc).preprocess) == vit_grid(jc.model, jc.preprocess) == (3, 5, 15)

    @pytest.mark.parametrize("backbone", ["resnet", "vit"])
    def test_jax_npz_checkpoint_round_trip(self, small_cfg, backbone, tmp_path):
        """A JAX ``save_checkpoint`` read by ``weights.load_jax_checkpoint`` and by the port's template
        ``load_checkpoint`` (a vit's empty state has no key in the npz), and the port's ``save_checkpoint``
        read back by JAX's ``load_checkpoint``: every leaf equal."""
        jcfg = _jcfg(small_cfg, backbone, 40)
        js = jax_train_state(jax.random.PRNGKey(3), jcfg)
        jax_save_checkpoint(str(tmp_path / "j"), js, jcfg, tag="ckp")
        leaves = lambda t: [np.asarray(x) for x in jax.tree.leaves(t)]   # noqa: E731
        params, model_state = W.load_jax_checkpoint(str(tmp_path / "j"))
        for got, want in ((params, js.params), (model_state, js.model_state)):
            assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(jax.tree.map(np.asarray, want))
            for a, b in zip(leaves(got), leaves(want)):
                np.testing.assert_array_equal(a, b)
        template = create_train_state(0, _port(jcfg), device=CPU)
        st = load_checkpoint(str(tmp_path / "j"), template)
        for a, b in zip(leaves(tree_map(lambda t: t.numpy(), st.params)), leaves(js.params)):
            np.testing.assert_array_equal(a, b)
        save_checkpoint(str(tmp_path / "t"), st, _port(jcfg))
        back = jax_load_checkpoint(str(tmp_path / "t"), jax_train_state(jax.random.PRNGKey(4), jcfg))
        for a, b in zip(leaves(back.params), leaves(js.params)):
            np.testing.assert_array_equal(a, b)
        assert back.model_state == js.model_state if backbone == "vit" else True


# ------------------------------------------------------------------- eval


class TestEval:
    @pytest.mark.parametrize("backbone,size", BACKBONES, ids=IDS)
    def test_float32(self, small_cfg, backbone, size):
        jcfg = _jcfg(small_cfg, backbone, size)
        params, state = _weights(jcfg)
        x = _frames(6, size, seed=1)
        want = _jax_features(jcfg, params, state, x)
        _assert_spread(want)
        _close(_port_features(jcfg, params, state, x), want)

    @pytest.mark.parametrize("backbone,size", BACKBONES, ids=IDS)
    def test_bf16_against_jax_eager(self, small_cfg, backbone, size):
        jcfg = _jcfg(small_cfg, backbone, size)
        params, state = _weights(jcfg)
        x = _frames(6, size, seed=2)
        want = _jax_features(jcfg, params, state, x, "bfloat16")
        got = _port_features(jcfg, params, state, x, "bfloat16")
        _assert_spread(want)
        assert np.abs(got - want).max() <= 2 * _ulp(want), np.abs(got - want).max()

    @pytest.mark.parametrize("backbone,size", BACKBONES, ids=IDS)
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_int8(self, small_cfg, backbone, size, dtype):
        jcfg = _jcfg(small_cfg, backbone, size)
        params, state = _weights(jcfg)
        x = _frames(6, size, seed=3)
        want = _jax_features(jcfg, params, state, x, dtype, quant=True)
        got = _port_features(jcfg, params, state, x, dtype, quant=True)
        _assert_spread(want)
        if dtype == "float32":
            _close(got, want, 1e-4)
        else:
            assert np.abs(got - want).max() <= 2 * _ulp(want), np.abs(got - want).max()

    @pytest.mark.parametrize("backbone", ["resnet", "vit"])
    def test_zero_frames(self, small_cfg, backbone):
        jcfg = _jcfg(small_cfg, backbone, 40)
        params, state = _weights(jcfg)
        x = np.zeros((0, 40, 40, 3), np.float32)
        want = _jax_features(jcfg, params, state, x)
        got = _port_features(jcfg, params, state, x)
        assert got.shape == want.shape == (0, jcfg.model.vis_feature_dim)
        tp, ts = W.from_jax(params, state, device=CPU)
        assert TP.fuse(tp, ts, {"visual": x, "audio": np.zeros((0, 12, 13), np.float32)}, _port(jcfg),
                       device=CPU).shape == (0,)
        trunk = TS.encode_timeline(tp, ts, x, None, _port(jcfg), device=CPU)
        assert tuple(trunk.shape) == np.asarray(JS.encode_timeline(params, state, x, None, jcfg)).shape


# ------------------------------------------------------------------- int8 values and sums


def _walk_jax_quant_convs(jparams, jstate, x):
    """JAX's int8 resnet forward, recording (input, folded weight, stride) at every quantized convolution."""
    seen = []
    real = JQ.quantized_conv2d

    def spy(x, w, stride, padding, out_dtype=None):
        seen.append((np.asarray(x), np.asarray(w), stride))
        return real(x, w, stride, padding, out_dtype)

    JQ.quantized_conv2d = spy
    try:
        JR.resnet_encoder_apply(jparams, jstate, jnp.asarray(x), train=False, rng=None, dropout_rate=0.0, quant=True)
    finally:
        JQ.quantized_conv2d = real
    return seen


class TestInt8Sums:
    @pytest.mark.parametrize("size", [24, 40])
    def test_resnet_values_and_sums(self, small_cfg, size):
        """At each of the twelve quantized convolutions, on JAX's own input there: the activation's int8 values
        and scale equal; the folded weight's int8 values equal except the counted boundary flips (one step
        each); the int32 sums of the port's convolution equal JAX's on the same int8 operands; and the im2col
        that the card's int8 GEMM takes (run here on the CPU) gives the same sums."""
        jcfg = _jcfg(small_cfg, "resnet", size)
        params, state = _weights(jcfg)
        x = _frames(6, size, seed=4)
        seen = _walk_jax_quant_convs(params["visual"], state["visual"], x)
        assert len(seen) == 12
        tp, ts = W.from_jax(params, state, device=CPU)
        names = [n for n, _ in TR._blocks(tp["visual"])]
        flips = total = 0
        for i, (xin, wj, stride) in enumerate(seen):
            blk, conv = names[i // 2], ("conv1", "conv2")[i % 2]
            bn = "bn1" if conv == "conv1" else "bn2"
            wt, _ = TR._bn_fold(tp["visual"][blk][conv], tp["visual"][blk][bn], ts["visual"][blk][bn])
            np.testing.assert_allclose(wt.numpy(), wj, rtol=5e-7, atol=0)
            qj, sj = JQ.quantize_weights_per_channel(jnp.asarray(wj), axis=3)
            qt, _ = TQ.quantize_weights_per_channel(wt, axis=3)
            d = np.abs(qt.numpy().astype(np.int32) - np.asarray(qj, np.int32))
            assert d.max() <= 1
            flips, total = flips + int(d.sum()), total + d.size
            xq_j, sx_j = JQ.quantize_act_per_tensor(jnp.asarray(xin))
            xq_t, sx_t = TQ.quantize_act_per_tensor(torch.as_tensor(xin))
            np.testing.assert_array_equal(xq_t.numpy(), np.asarray(xq_j))
            assert float(sx_t) == float(sx_j)
            want = np.asarray(JQ.conv2d_int8(xq_j, qj, stride, 1))
            xq, wq = torch.as_tensor(np.asarray(xq_j)), torch.as_tensor(np.asarray(qj))
            np.testing.assert_array_equal(TQ.conv2d_int8(xq, wq, stride, 1).numpy(), want)
            cols = TQ._im2col(xq, 3, 3, stride, 1)
            sums = TQ.int8_matmul(cols.reshape(-1, cols.shape[-1]), wq.reshape(-1, wq.shape[-1]))
            np.testing.assert_array_equal(sums.reshape(want.shape).numpy(), want)
        print(f"int8 weight flips from _bn_fold's rsqrt: {flips} of {total}")
        assert flips <= max(2, total // 1000)

    @pytest.mark.parametrize("shape", [(6, 9, 16), (2, 25, 64), (40, 24)])
    def test_quantized_linear_values_and_sums(self, shape):
        """``quantized_linear`` on 3-d (the vit's blocks) and 2-d inputs: int8 values, scales and int32 sums
        equal to JAX's, and the outputs within 1e-6 relative."""
        rng = np.random.default_rng(5)
        x = rng.standard_normal(shape).astype(np.float32)
        p = {"w": rng.standard_normal((shape[-1], 24)).astype(np.float32), "b": rng.standard_normal(24).astype(np.float32)}
        jq, _ = JQ.quantize_weights_per_channel(jnp.asarray(p["w"]), axis=1)
        xq, _ = JQ.quantize_act_per_tensor(jnp.asarray(x))
        want = np.asarray(JQ.linear_int8(xq, jq))
        got = TQ.int8_matmul(torch.as_tensor(np.asarray(xq)).reshape(-1, shape[-1]), torch.as_tensor(np.asarray(jq)))
        np.testing.assert_array_equal(got.reshape(want.shape).numpy(), want)
        out = TQ.quantized_linear({k: torch.as_tensor(v) for k, v in p.items()}, torch.as_tensor(x)).numpy()
        _close(out, np.asarray(JQ.quantized_linear(p, jnp.asarray(x))), 1e-6)


# ------------------------------------------------------------------- training


def _f64(tree):
    return jax.tree.map(lambda x: jnp.asarray(np.asarray(x, np.float64)), tree)


def _close_trees(got, want, tol):
    g = jax.tree.leaves(jax.tree.map(lambda t: np.asarray(t.detach() if isinstance(t, torch.Tensor) else t), got))
    w = jax.tree.leaves(jax.tree.map(np.asarray, want))
    assert len(g) == len(w)
    for a, b in zip(g, w):
        _close(a, b, tol)


class TestTrain:
    @pytest.mark.parametrize("backbone,size", BACKBONES, ids=IDS)
    def test_train_forward_and_grads_float64(self, small_cfg, backbone, size):
        """The backbone's train forward with a ``valid`` mask (batch statistics over the real rows) and the
        gradients of Σ f·w, in float64 on both sides: outputs, new running statistics and gradients within
        1e-5·max."""
        jcfg = _jcfg(small_cfg, backbone, size, dropout_rate=0.0)
        params, state = _weights(jcfg)
        rng = np.random.default_rng(6)
        x = _frames(10, size, seed=6).astype(np.float64)
        mask = np.array([1.0] * 7 + [0.0] * 3)
        x[7:] = 0.0   # padded rows are zeros, as the loop pads them; the loss gives them no cotangent
        w = rng.standard_normal((10, jcfg.model.vis_feature_dim)) * mask[:, None]
        _, japply = _visual_init(jcfg.model)
        with jax.enable_x64(True):
            def jfn(p, x, w, m):
                f, st = japply(p, _f64(state["visual"]), x, train=True, rng=None, dropout_rate=0.0, mask=m)
                return jnp.sum(f * w), (f * w, st)

            (_, (jo, jst)), jg = jax.value_and_grad(jfn, has_aux=True)(
                _f64(params["visual"]), *(jnp.asarray(a, jnp.float64) for a in (x, w, mask)))
            jo, jst, jg = (jax.tree.map(np.asarray, t) for t in (jo, jst, jg))
        tp, ts = W.from_jax(params, state, device=CPU)
        _, train_apply = visual_apply(_port(jcfg).model)
        leaves = [t.to(torch.float64).requires_grad_() for t in tree_leaves(tp["visual"])]
        p64 = tree_unflatten(tp["visual"], leaves)
        st64 = tree_map(lambda t: t.to(torch.float64), ts["visual"])
        f, st = train_apply(p64, st64, torch.as_tensor(x), generator=None, dropout_rate=0.0,
                            mask=torch.as_tensor(mask))
        out = f * torch.as_tensor(w)
        grads = tree_unflatten(tp["visual"], torch.autograd.grad(out.sum(), leaves))
        _close(out.detach().numpy(), jo)
        _close_trees(st, jst, 1e-5)
        _close_trees(grads, jg, 1e-5)

    @pytest.mark.parametrize("backbone", ["resnet", "vit"])
    def test_avm_train_forward_matches_jax(self, small_cfg, backbone):
        """``avm_train_apply`` with audio and a ``valid`` mask in float32 against JAX's ``avm_apply(train=True,
        valid=…)``: scores and the new state within 1e-5·max."""
        jcfg = _jcfg(small_cfg, backbone, 40, dropout_rate=0.0)
        params, state = _weights(jcfg)
        x, a = _frames(10, 40, seed=7), np.random.default_rng(7).random((10, 12, 13)).astype(np.float32)
        valid = np.array([1.0] * 8 + [0.0] * 2, np.float32)
        want, wst = jax_avm(params, state, jnp.asarray(x), jnp.asarray(a), cfg=jcfg.model, train=True,
                            valid=jnp.asarray(valid))
        tp, ts = W.from_jax(params, state, device=CPU)
        with torch.no_grad():
            got, gst = avm_train_apply(tp, ts, torch.as_tensor(x), torch.as_tensor(a), cfg=_port(jcfg).model,
                                       valid=torch.as_tensor(valid))
        _close(got.numpy(), np.asarray(want))
        _close_trees(gst, wst, 1e-5)

    def test_dropout_draws_from_the_generator(self, small_cfg):
        jcfg = _jcfg(small_cfg, "vit", 24, dropout_rate=0.5)
        tp, ts = W.from_jax(*_weights(jcfg), device=CPU)
        _, train_apply = visual_apply(_port(jcfg).model)
        x = torch.as_tensor(_frames(4, 24))
        runs = [train_apply(tp["visual"], ts["visual"], x, generator=torch.Generator().manual_seed(s),
                            dropout_rate=0.5)[0] for s in (0, 0, 1)]
        assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])
        assert 0.2 < float((runs[0] == 0).float().mean()) < 0.8


# ------------------------------------------------------------------- entry points


@pytest.fixture(scope="module")
def trunks(small_cfg):
    """JAX ``create_train_state`` trunks (audio and no-audio) for each backbone at 24 px, with the port's."""
    out = {}
    for backbone in ("resnet", "vit"):
        for audio in (True, False):
            jcfg = _jcfg(small_cfg, backbone, 24, audio)
            js = jax_train_state(jax.random.PRNGKey(11 + audio), jcfg)
            p, s = _perturbed(js.params, js.model_state, 21 + audio)
            js = js._replace(params=p, model_state=s)
            tp, ts = W.from_jax(p, s, device=CPU)
            out[backbone, audio] = (jcfg, js, TrainState(params=tp, model_state=ts, opt_state=None, epoch=0))
    return out


def _raw(n, seed):
    return np.random.default_rng(seed).integers(0, 255, (n, 32, 40, 3), dtype=np.uint8)


class TestEntryPoints:
    @pytest.mark.parametrize("backbone", ["resnet", "vit"])
    @pytest.mark.parametrize("mode", ["float32", "int8", "bfloat16"])
    def test_fuse_many_matches_jax(self, trunks, backbone, mode):
        """``fuse_many`` over two videos (one forward: under int8 one activation scale spans both): float32
        and int8 within 1e-4 of JAX's ``fuse_many``; bf16 within 0.0625 of JAX's eager bf16 ``avm_apply``, on
        the bf16 grid."""
        jcfg, js, ts = trunks[backbone, True]
        jcfg = dataclasses.replace(jcfg, model=dataclasses.replace(
            jcfg.model, dtype="bfloat16" if mode == "bfloat16" else "float32", quantized_inference=mode == "int8"))
        rng = np.random.default_rng(8)
        feats = [{"visual": _frames(n, 24, seed=8 + n), "audio": rng.random((n, 12, 13)).astype(np.float32)}
                 for n in (7, 5)]
        got = TP.fuse_many(ts.params, ts.model_state, feats, _port(jcfg), device=CPU)
        if mode == "bfloat16":
            bf = jnp.bfloat16
            out, _ = jax_avm(jax_cast(js.params, bf), jax_cast(js.model_state, bf),
                             jnp.asarray(np.concatenate([f["visual"] for f in feats])).astype(bf),
                             jnp.asarray(np.concatenate([f["audio"] for f in feats])).astype(bf), cfg=jcfg.model)
            want = np.asarray(out[:, 0].astype(jnp.float32))
            got = np.concatenate(got)
            assert np.abs(got - want).max() <= 0.0625
            assert np.array_equal(torch.as_tensor(got).to(torch.bfloat16).float().numpy(), got)
            return
        want = JP.fuse_many(js.params, js.model_state, feats, jcfg)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, np.asarray(w), atol=1e-4, rtol=0)

    @pytest.mark.parametrize("backbone", ["resnet", "vit"])
    @pytest.mark.parametrize("quant", [False, True])
    def test_encode_timeline_and_summarize_match(self, trunks, backbone, quant):
        """The spotting trunk (float32, all T frames at once: one int8 scale over the timeline) and
        ``summarize_match`` with a GRU head: features within 1e-4·max, scores within 1e-4, events equal."""
        jcfg, js, ts = trunks[backbone, True]
        jcfg = dataclasses.replace(jcfg, model=dataclasses.replace(jcfg.model, quantized_inference=quant))
        x = _frames(30, 24, seed=9)
        a = np.random.default_rng(9).random((30, 12, 13)).astype(np.float32)
        want = np.asarray(JS.encode_timeline(js.params, js.model_state, x, a, jcfg))
        got = TS.encode_timeline(ts.params, ts.model_state, x, a, _port(jcfg), device=CPU).numpy()
        _close(got, want, 1e-4)
        head = temporal_head_init_auto(jax.random.PRNGKey(5), want.shape[1], jcfg.model)
        iv = np.array([[0, 299], [300, 599], [600, 899]])
        wres = JS.summarize_match(js.params, js.model_state, head, jnp.asarray(x), jnp.asarray(a), iv, jcfg,
                                  peak_window=3)
        tres = TS.summarize_match(ts.params, ts.model_state, W.tree_from_jax(head, CPU), x, a, iv, _port(jcfg),
                                  peak_window=3, device=CPU)
        np.testing.assert_allclose(tres.scores, np.asarray(wres.scores), atol=1e-4)
        np.testing.assert_array_equal(tres.events, wres.events)
        np.testing.assert_array_equal(tres.summary.frame_mask, wres.summary.frame_mask)

    @pytest.mark.parametrize("backbone", ["resnet", "vit"])
    def test_summarizer_and_spotter_match_jax(self, trunks, backbone):
        jcfg, js, ts = trunks[backbone, False]
        frames = _raw(12, 11)
        got = TV.Summarizer(_port(jcfg), state=ts, device=CPU).summarize_frames("v", frames)
        want = JV.Summarizer(jcfg, state=js).summarize_frames("v", frames)
        np.testing.assert_allclose(got.scores, np.asarray(want.scores), atol=1e-4)
        np.testing.assert_array_equal(got.frame_mask, want.frame_mask)
        scfg = dataclasses.replace(jcfg, model=dataclasses.replace(jcfg.model, temporal_model="transformer",
                                                                     temporal_num_heads=2, temporal_window=0))
        jspot, tspot = JV.Spotter(scfg, state=js), TV.Spotter(_port(scfg), state=ts, device=CPU)
        head = temporal_head_init_auto(jax.random.PRNGKey(6), jcfg.model.vis_feature_dim, scfg.model)
        jspot.temporal_params, tspot.temporal_params = head, W.tree_from_jax(head, device=CPU)
        frames = _raw(40, 12)
        got, want = tspot.spot_frames("m", frames, peak_window=3), jspot.spot_frames("m", frames, peak_window=3)
        np.testing.assert_allclose(got.scores, np.asarray(want.scores), atol=1e-4)
        np.testing.assert_array_equal(got.events, want.events)
        np.testing.assert_array_equal(got.summary_clips, want.summary_clips)


# ------------------------------------------------------------------- the CLI


@pytest.fixture
def on_cpu(monkeypatch):
    monkeypatch.setenv("GOALNET_PLATFORM", "cpu")


def _data_args(meta, cfg_path, work, *extra):
    return ["--videos", *meta["video_fps"], "--annotation-fp", meta["annotation_fp"], "--mat-fp",
            meta["mat_file_path"], "--h5-fp", meta["h5_file_path"], "--info-fp", meta["info_fp"], "--config",
            cfg_path, "--workdir", work, *extra]


class TestVerbs:
    @pytest.mark.parametrize("backbone", ["resnet", "vit"])
    def test_train_eval_infer_as_jax(self, small_cfg, synth_dir, tmp_path, capsys, on_cpu, monkeypatch, backbone):
        """JAX's ``train --epochs 1`` writes a trunk of the backbone; the port's ``train`` resumes it for an
        epoch as JAX's does (losses 1e-5 relative, F-scores equal), ``eval`` prints JAX's lines, and ``infer``
        exports the frames JAX's ``infer`` exports."""
        import shutil

        from cvml_goalnet_tpu import cli as jcli
        from cvml_goalnet_tpu.data import video as JVid
        from cvml_goalnet_tpu_torch import cli
        from cvml_goalnet_tpu_torch.data import video as TVid
        from cvml_goalnet_tpu_torch.utils.metrics import MetricsLogger

        jcfg = _jcfg(small_cfg, backbone, 24, dropout_rate=0.0)
        jcfg = dataclasses.replace(jcfg, train=dataclasses.replace(jcfg.train, eps=1e-4))
        cfg_path = str(tmp_path / "cfg.json")
        jcfg.save(cfg_path)
        first = str(tmp_path / "first")
        assert jcli.main(["train", *_data_args(synth_dir, cfg_path, first, "--epochs", "1")]) == 0
        logs, evals = {}, {}
        for name, main in (("jax", jcli.main), ("port", cli.main)):
            work = str(tmp_path / name)
            shutil.copytree(os.path.join(first, "models"), os.path.join(work, "models"))
            capsys.readouterr()
            assert main(["train", *_data_args(synth_dir, cfg_path, work, "--checkpoint", "--epochs", "2")]) == 0
            assert "Resumed from epoch 1" in capsys.readouterr().out
            logs[name] = [e for e in MetricsLogger.read(os.path.join(work, "tmp", "events.jsonl"))
                          if e["event"] == "epoch"]
            assert main(["eval", *_data_args(synth_dir, cfg_path, work)]) == 0
            evals[name] = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("[eval]")]
        for got, want in zip(logs["port"], logs["jax"]):
            for k in ("train_loss", "val_loss"):
                assert got[k] == pytest.approx(want[k], rel=1e-5), k
            for k in ("train_f_avg", "train_f_max", "val_f_avg", "val_f_max"):
                assert got[k] == want[k], k
        assert len(evals["port"]) == len(evals["jax"]) == 2
        for got, want in zip(evals["port"], evals["jax"]):
            g, w = got.split(" - "), want.split(" - ")
            assert g[0] == w[0] and g[2:] == w[2:]
            assert float(g[1].split(": ")[1]) == pytest.approx(float(w[1].split(": ")[1]), rel=1e-3)
        exported = {}
        for name, mod in (("jax", JVid), ("port", TVid)):
            real = mod.export_video
            monkeypatch.setattr(mod, "export_video", lambda f, o, fps=30, _n=name, _r=real: (
                exported.__setitem__(_n, np.asarray(f).copy()), _r(f, o, fps=fps)))
        args = ["--config", cfg_path, "--workdir", str(tmp_path / "jax"), "--mat-fp", synth_dir["mat_file_path"],
                "--h5-fp", synth_dir["h5_file_path"]]
        video = synth_dir["video_fps"][0]
        assert jcli.main(["infer", video, *args]) == 0
        assert cli.main(["infer", video, *args]) == 0
        np.testing.assert_array_equal(exported["port"], exported["jax"])

    @pytest.mark.parametrize("backbone", ["resnet", "vit"])
    def test_baseline_runs_as_jax(self, small_cfg, synth_dir, tmp_path, capsys, on_cpu, backbone):
        """``baseline`` over random-init trunks of the backbone prints the JAX baseline's report keys, all
        finite (its samples are the port's own draws, so the values differ by design: baseline.py)."""
        from cvml_goalnet_tpu import cli as jcli
        from cvml_goalnet_tpu_torch import cli

        path = str(tmp_path / "cfg.json")
        _jcfg(small_cfg, backbone, 24).save(path)
        keys = []
        for main in (jcli.main, cli.main):
            assert main(["baseline", *_data_args(synth_dir, path, str(tmp_path / "w")), "--samples", "2"]) == 0
            report = dict(ln.split(": ") for ln in capsys.readouterr().out.splitlines() if ": " in ln)
            keys.append(set(report))
            assert all(np.isfinite(float(v)) for v in report.values())
        assert keys[0] == keys[1] and "opt_train_loss" in keys[1]
