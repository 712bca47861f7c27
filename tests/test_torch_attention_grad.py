"""PyTorch port: gradients of the flash-attention functions against the JAX package, on the CPU.

The same numpy q, k, v and cotangents go through the JAX package's
``custom_vjp`` functions (the Pallas backward kernels in interpret mode, for
T ≤ 300) or through ``jax.grad`` of its XLA references (``attention_reference``,
``attention_local_bounded_reference``) at longer T, and through the port's
public functions on CPU tensors, whose ``torch.autograd.Function`` runs the
plain backward (p recomputed from lse, ``di``, dead rows), the math the CUDA
kernels implement.  Tolerance: 1e-4 absolute and relative, what
``tests/test_flash_attention.py`` holds the Pallas backward to.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvml_goalnet_tpu.ops.pallas import flash_attention as JF
from cvml_goalnet_tpu_torch.ops.cuda import flash_attention as TF

TOL = dict(atol=1e-4, rtol=1e-4)


def _arrays(seed, *shapes, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s) * scale).astype(np.float32) for s in shapes]


def _port_grads(fn, q, k, v, *cotangents):
    """Gradients of ``sum(out_i · g_i)`` over the outputs of ``fn`` through the port, on CPU tensors."""
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    outs = fn(tq, tk, tv)
    outs = outs if isinstance(outs, tuple) else (outs,)
    loss = sum((o * torch.as_tensor(g)).sum() for o, g in zip(outs, cotangents))
    loss.backward()
    return [t.grad.numpy() for t in (tq, tk, tv)]


def _jax_grads(fn, q, k, v, *cotangents):
    def loss(q, k, v):
        outs = fn(q, k, v)
        outs = outs if isinstance(outs, tuple) else (outs,)
        return sum(jnp.sum(o * g) for o, g in zip(outs, cotangents))

    return [np.asarray(g) for g in jax.grad(loss, (0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))]


def _close(got, want):
    for g, w in zip(got, want):
        assert g.shape == w.shape and np.isfinite(g).all()
        np.testing.assert_allclose(g, w, **TOL)


class TestFullGrads:
    @pytest.mark.parametrize("h,t,d", [(1, 128, 128), (2, 200, 64), (1, 300, 32)])
    def test_trainable_matches_pallas_bwd(self, h, t, d):
        q, k, v, g = _arrays(t + d, *[(h, t, d)] * 4)
        want = _jax_grads(lambda q, k, v: JF.flash_attention_trainable(q, k, v, None, True), q, k, v, g)
        _close(_port_grads(TF.flash_attention_trainable, q, k, v, g), want)

    def test_unequal_kv_matches_reference(self):
        # the JAX test's 200 queries against 450 keys, two heads
        q, k, v, g = _arrays(11, (2, 200, 128), (2, 450, 128), (2, 450, 128), (2, 200, 128))
        want = _jax_grads(JF.attention_reference, q, k, v, g)
        _close(_port_grads(TF.flash_attention, q, k, v, g), want)

    def test_scale_argument(self):
        q, k, v, g = _arrays(12, *[(1, 96, 32)] * 4)
        want = _jax_grads(lambda q, k, v: JF.attention_reference(q, k, v, 0.3), q, k, v, g)
        _close(_port_grads(lambda q, k, v: TF.flash_attention(q, k, v, 0.3), q, k, v, g), want)

    @pytest.mark.parametrize("t_valid", [300, 97, 0])
    def test_with_lse_and_g_lse_matches_pallas_bwd(self, t_valid):
        q, k, v, g = _arrays(13, (2, 150, 64), (2, 300, 64), (2, 300, 64), (2, 150, 64))
        (g_lse,) = _arrays(14, (2, 150, 1))
        want = _jax_grads(lambda q, k, v: JF.flash_attention_with_lse(q, k, v, jnp.float32(t_valid), True),
                          q, k, v, g, g_lse)
        got = _port_grads(lambda q, k, v: TF.flash_attention_with_lse(q, k, v, t_valid), q, k, v, g, g_lse)
        _close(got, want)
        dq, dk, dv = got
        assert not dk[:, t_valid:].any() and not dv[:, t_valid:].any()   # masked keys: exactly 0
        if t_valid == 0:                                                   # every row dead
            assert not dq.any()

    def test_backward_wrapper_matches_pallas_bwd(self):
        """flash_bwd itself (the kernel's wrapper, plain on the CPU) against ``_flash_bwd`` in interpret mode."""
        q, k, v, g = _arrays(15, (1, 200, 64), (1, 256, 64), (1, 256, 64), (1, 200, 64))
        (g_lse,) = _arrays(16, (1, 200, 1))
        scale = 0.125
        out, lse = TF.flash_fwd(*map(torch.as_tensor, (q, k, v)), scale, 180)
        got = TF.flash_bwd(*map(torch.as_tensor, (q, k, v)), out, lse, torch.as_tensor(g), scale, 180,
                           torch.as_tensor(g_lse[..., 0]))
        o_j, lse_j = JF._flash_fwd(*map(jnp.asarray, (q, k, v)), scale, 128, 128, True, 180)
        want = JF._flash_bwd(*map(jnp.asarray, (q, k, v)), o_j, lse_j, jnp.asarray(g), scale, 128, 128, True,
                             180, jnp.asarray(g_lse))
        _close([x.numpy() for x in got], [np.asarray(x) for x in want])

    def test_extreme_magnitudes_stay_finite(self):
        q, k, v, g = _arrays(17, *[(1, 256, 128)] * 4)
        want = _jax_grads(JF.attention_reference, q * 10, k * 10, v, g)
        got = _port_grads(TF.flash_attention, q * 10, k * 10, v, g)
        for a, b in zip(got, want):
            assert np.isfinite(a).all()
            # scores up to ~1e3: float32 rounding of that size in s, hence 1e-4 relative to the largest entry
            np.testing.assert_allclose(a, b, atol=1e-4 * max(1.0, np.abs(b).max()))


class TestBandedGrads:
    @pytest.mark.parametrize("t,window", [(256, 37), (300, 64)])
    def test_local_matches_pallas_bwd(self, t, window):
        q, k, v, g = _arrays(t + window, *[(2, t, 64)] * 4)
        want = _jax_grads(lambda q, k, v: JF.flash_attention_local(q, k, v, window, None, True), q, k, v, g)
        _close(_port_grads(lambda q, k, v: TF.flash_attention_local(q, k, v, window), q, k, v, g), want)

    def test_local_matches_reference_past_the_interpret_size(self):
        q, k, v, g = _arrays(21, *[(1, 513, 128)] * 4)
        want = _jax_grads(lambda q, k, v: JF.attention_local_reference(q, k, v, 130), q, k, v, g)
        _close(_port_grads(lambda q, k, v: TF.flash_attention_local(q, k, v, 130), q, k, v, g), want)

    def test_window_covering_everything_equals_full(self):
        q, k, v, g = _arrays(22, *[(1, 120, 32)] * 4)
        want = _jax_grads(JF.attention_reference, q, k, v, g)
        _close(_port_grads(lambda q, k, v: TF.flash_attention_local(q, k, v, 10**6), q, k, v, g), want)

    def test_bounded_dead_rows(self):
        q, k, v, g = _arrays(23, *[(1, 256, 64)] * 4)
        window, lo, hi = 16, 64, 200   # rows < 48 and >= 216 have empty bands
        want = _jax_grads(lambda q, k, v: JF.flash_attention_local_bounded(
            q, k, v, jnp.float32(lo), jnp.float32(hi), window, True), q, k, v, g)
        got = _port_grads(lambda q, k, v: TF.flash_attention_local_bounded(q, k, v, lo, hi, window), q, k, v, g)
        _close(got, want)
        dq, dk, dv = got
        assert not dq[:, : lo - window].any() and not dq[:, hi + window :].any()   # dead rows
        assert not dk[:, :lo].any() and not dk[:, hi:].any() and not dv[:, :lo].any() and not dv[:, hi:].any()
        oracle = _jax_grads(lambda q, k, v: JF.attention_local_bounded_reference(q, k, v, lo, hi, window),
                            q, k, v, g)
        _close(got, oracle)

    @pytest.mark.parametrize("lo,hi", [(10, 180), (0, 192)])
    def test_q_offset(self, lo, hi):
        w, tq = 16, 160
        q, k, v, g = _arrays(24 + lo, (2, tq, 32), (2, tq + 2 * w, 32), (2, tq + 2 * w, 32), (2, tq, 32))
        want = _jax_grads(lambda q, k, v: JF.flash_attention_local_bounded(
            q, k, v, jnp.float32(lo), jnp.float32(hi), w, True, w), q, k, v, g)
        got = _port_grads(lambda q, k, v: TF.flash_attention_local_bounded(q, k, v, lo, hi, w, q_offset=w),
                          q, k, v, g)
        _close(got, want)
        oracle = _jax_grads(lambda q, k, v: JF.attention_local_bounded_reference(q, k, v, lo, hi, w, q_offset=w),
                            q, k, v, g)
        _close(got, oracle)

    def test_backward_wrapper_matches_pallas_bwd(self):
        """flash_local_bwd itself against ``_flash_local_bwd`` in interpret mode, with bounds and an offset."""
        w = 20
        q, k, v, g = _arrays(25, (1, 200, 32), (1, 240, 32), (1, 240, 32), (1, 200, 32))
        scale, lo, hi = 32 ** -0.5, 5, 230
        tq, tk, tv, tg = map(torch.as_tensor, (q, k, v, g))
        out, lse = TF.flash_local_fwd(tq, tk, tv, scale, w, lo, hi, w)
        got = TF.flash_local_bwd(tq, tk, tv, out, lse, tg, scale, w, lo, hi, w)
        o_j, lse_j = JF._flash_local_fwd(*map(jnp.asarray, (q, k, v)), scale, w, 128, True, jnp.int32(lo),
                                         jnp.int32(hi), w)
        want = JF._flash_local_bwd(*map(jnp.asarray, (q, k, v)), o_j, lse_j, jnp.asarray(g), scale, w, 128, True,
                                   jnp.int32(lo), jnp.int32(hi), w)
        _close([x.numpy() for x in got], [np.asarray(x) for x in want])


class TestWideHeads:
    """A head of 320, which the card runs on the wide path (zero-padded to 384, d walked in 128-wide chunks):
    out and the gradients of the public functions against the JAX package's Pallas kernels in interpret mode."""

    def test_full_matches_pallas(self):
        q, k, v, g = _arrays(31, *[(1, 128, 320)] * 4)
        want_out = np.asarray(JF.flash_attention(*map(jnp.asarray, (q, k, v)), None, None, None, True))
        got_out = TF.flash_attention(*map(torch.as_tensor, (q, k, v)))
        np.testing.assert_allclose(got_out.numpy(), want_out, atol=3e-5, rtol=0)
        want = _jax_grads(lambda q, k, v: JF.flash_attention_trainable(q, k, v, None, True), q, k, v, g)
        _close(_port_grads(TF.flash_attention, q, k, v, g), want)

    def test_local_matches_pallas(self):
        q, k, v, g = _arrays(32, *[(2, 200, 320)] * 4)
        want_out = np.asarray(JF.flash_attention_local(*map(jnp.asarray, (q, k, v)), 37, None, True))
        got_out = TF.flash_attention_local(*map(torch.as_tensor, (q, k, v)), 37)
        np.testing.assert_allclose(got_out.numpy(), want_out, atol=3e-5, rtol=0)
        want = _jax_grads(lambda q, k, v: JF.flash_attention_local(q, k, v, 37, None, True), q, k, v, g)
        _close(_port_grads(lambda q, k, v: TF.flash_attention_local(q, k, v, 37), q, k, v, g), want)


class TestAutograd:
    def test_public_outputs_carry_the_port_function(self):
        """Each public function records the port's autograd Function, so the gradient never stops at the kernel."""
        q, k, v = (torch.randn(1, 40, 32, requires_grad=True) for _ in range(3))
        outs = {
            "flash_attention": TF.flash_attention(q, k, v),
            "flash_attention_trainable": TF.flash_attention_trainable(q, k, v),
            "flash_attention_local": TF.flash_attention_local(q, k, v, 4),
            "flash_attention_local_bounded": TF.flash_attention_local_bounded(q, k, v, 2, 30, 4),
        }
        out, lse = TF.flash_attention_with_lse(q, k, v, 30)
        outs["flash_attention_with_lse.out"], outs["flash_attention_with_lse.lse"] = out, lse
        for name, o in outs.items():
            fn = o.grad_fn
            while fn is not None and not type(fn).__name__.startswith(("_FullAttention", "_BandedAttention")):
                fn = fn.next_functions[0][0] if fn.next_functions else None
            assert fn is not None, f"{name}: no port Function in the graph"
        assert type(outs["flash_attention"].grad_fn).__name__ == "_FullAttentionBackward"
        assert type(outs["flash_attention_local"].grad_fn).__name__ == "_BandedAttentionBackward"

    def test_transformer_gradients_reach_the_projections(self):
        """Gradients flow from the scores through attention into wq, wk and wv (the silent-detach fault)."""
        from cvml_goalnet_tpu_torch.config import ModelConfig
        from cvml_goalnet_tpu_torch.models.temporal_attention import temporal_transformer_apply
        from cvml_goalnet_tpu_torch.weights import init_temporal_params, tree_from_jax

        mc = ModelConfig(temporal_model="transformer", temporal_hidden=32, temporal_num_layers=1,
                         temporal_max_len=64)
        for window in (0, 5):
            p = tree_from_jax(init_temporal_params(mc, 8, seed=0), device="cpu")
            layer = p["layers"][0]
            for name in ("wq", "wk", "wv"):
                layer[name]["w"].requires_grad_()
            temporal_transformer_apply(p, torch.randn(30, 8), 1, window).sum().backward()
            for name in ("wq", "wk", "wv"):
                assert layer[name]["w"].grad is not None and layer[name]["w"].grad.abs().max() > 0

    def test_forward_wrappers_on_the_cpu_stay_differentiable(self):
        """On a CPU tensor the raw wrappers are the plain version, which autograd records itself."""
        q = torch.randn(1, 16, 32, requires_grad=True)
        out, lse = TF.flash_fwd(q, q, q, 0.2)
        assert out.grad_fn is not None and lse.grad_fn is not None
