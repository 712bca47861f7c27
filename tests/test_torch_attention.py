"""PyTorch port: the flash-attention forwards against the Pallas kernels, on the CPU.

The same numpy q, k, v go through the JAX package's Pallas kernels in
interpret mode and through the port's public functions on CPU tensors (the
kernels' plain versions).  Tolerances are those ``tests/test_flash_attention.py``
holds the Pallas kernels to: 2e-5 for out, 3e-5 where the scores spread over
several magnitudes or a band is masked, 1e-5 for lse.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvml_goalnet_tpu.ops.pallas import flash_attention as JF
from cvml_goalnet_tpu_torch.ops.cuda import flash_attention as TF


def _qkv(h, t, d, seed=0, tk=None):
    rng = np.random.default_rng(seed)
    tk = t if tk is None else tk
    return (rng.standard_normal((h, t, d)).astype(np.float32),
            rng.standard_normal((h, tk, d)).astype(np.float32),
            rng.standard_normal((h, tk, d)).astype(np.float32))


def _jax(*xs):
    return [jnp.asarray(x) for x in xs]


def _torch(*xs):
    return [torch.as_tensor(x) for x in xs]


class TestFullForward:
    @pytest.mark.parametrize("h,t", [(2, 128), (2, 256), (2, 384), (1, 100), (1, 257), (1, 300)])
    def test_matches_pallas(self, h, t):
        q, k, v = _qkv(h, t, 128, seed=t)
        want = np.asarray(JF.flash_attention(*_jax(q, k, v), interpret=True))
        got = TF.flash_attention(*_torch(q, k, v))
        assert got.shape == (h, t, 128) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, atol=2e-5)

    def test_multi_block_magnitudes(self):
        rng = np.random.default_rng(2)
        q = rng.standard_normal((1, 128, 128)).astype(np.float32)
        k = np.concatenate([rng.standard_normal((1, 128, 128)) * 0.1, rng.standard_normal((1, 128, 128)) * 5.0,
                            rng.standard_normal((1, 128, 128)) * 0.1], axis=1).astype(np.float32)
        v = rng.standard_normal((1, 384, 128)).astype(np.float32)
        want = np.asarray(JF.flash_attention(*_jax(q, k, v), interpret=True))
        np.testing.assert_allclose(TF.flash_attention(*_torch(q, k, v)).numpy(), want, atol=3e-5)

    @pytest.mark.parametrize("t_valid", [300, 97, 0])
    def test_lse_and_t_valid(self, t_valid):
        q, k, v = _qkv(2, 300, 64, seed=3)
        scale = 1.0 / 8.0
        o_want, lse_want = JF._flash_fwd(*_jax(q, k, v), scale, 128, 128, True, t_valid)
        o_got, lse_got = TF.flash_fwd(*_torch(q, k, v), scale, t_valid)
        assert lse_got.shape == (2, 300)
        np.testing.assert_allclose(o_got.numpy(), np.asarray(o_want), atol=2e-5)
        np.testing.assert_allclose(lse_got.numpy(), np.asarray(lse_want)[:, :300, 0], atol=1e-5)
        if t_valid == 0:  # every row dead: out 0 and lse 0
            assert not o_got.any() and not lse_got.any()

    def test_with_lse_returns_a_column(self):
        q, k, v = _qkv(1, 150, 32, seed=4, tk=200)
        out, lse = TF.flash_attention_with_lse(*_torch(q, k, v), 180)
        o_want, lse_want = JF._flash_fwd(*_jax(q, k, v), 1 / np.sqrt(32), 128, 128, True, 180)
        assert lse.shape == (1, 150, 1)
        np.testing.assert_allclose(out.numpy(), np.asarray(o_want), atol=2e-5)
        np.testing.assert_allclose(lse[..., 0].numpy(), np.asarray(lse_want)[:, :150, 0], atol=1e-5)


class TestBandedForward:
    @pytest.mark.parametrize("t,window", [(256, 37), (300, 64), (513, 130)])
    def test_matches_pallas(self, t, window):
        q, k, v = _qkv(2, t, 64, seed=t + window)
        want = np.asarray(JF.flash_attention_local(*_jax(q, k, v), window, None, True))
        got = TF.flash_attention_local(*_torch(q, k, v), window)
        np.testing.assert_allclose(got.numpy(), want, atol=3e-5)

    def test_window_covering_everything_equals_full(self):
        q, k, v = _qkv(1, 200, 64, seed=5)
        want = np.asarray(JF.attention_reference(*_jax(q, k, v)))
        np.testing.assert_allclose(TF.flash_attention_local(*_torch(q, k, v), 200).numpy(), want, atol=3e-5)
        np.testing.assert_allclose(TF.flash_attention_local(*_torch(q, k, v), 10**6).numpy(), want, atol=3e-5)

    def test_window_zero_returns_v(self):
        q, k, v = _qkv(1, 160, 64, seed=6)
        np.testing.assert_allclose(TF.flash_attention_local(*_torch(q, k, v), 0).numpy(), v, atol=3e-6)

    def test_lse_matches_pallas(self):
        q, k, v = _qkv(1, 300, 32, seed=7)
        scale = 1 / np.sqrt(32)
        o_want, lse_want = JF._flash_local_fwd(*_jax(q, k, v), scale, 40, 128, True)
        o_got, lse_got = TF.flash_local_fwd(*_torch(q, k, v), scale, 40)
        np.testing.assert_allclose(o_got.numpy(), np.asarray(o_want), atol=3e-5)
        np.testing.assert_allclose(lse_got.numpy(), np.asarray(lse_want)[:, :300, 0], atol=1e-5)

    def test_bounded_dead_rows(self):
        q, k, v = _qkv(1, 256, 64, seed=60)
        window, lo, hi = 16, 64, 200   # rows < 48 and >= 216 have empty bands
        want = np.asarray(JF.flash_attention_local_bounded(*_jax(q, k, v), jnp.float32(lo), jnp.float32(hi),
                                                           window, True))
        got = TF.flash_attention_local_bounded(*_torch(q, k, v), lo, hi, window).numpy()
        np.testing.assert_allclose(got, want, atol=3e-5)
        assert np.all(got[:, : lo - window] == 0.0) and np.all(got[:, hi + window :] == 0.0)
        assert np.abs(got[:, lo:hi]).max() > 0
        _, lse = TF.flash_local_fwd(*_torch(q, k, v), 0.125, window, lo, hi)
        assert not lse[:, : lo - window].any() and not lse[:, hi + window :].any()

    def test_q_offset(self):
        rng = np.random.default_rng(70)
        w, tq = 16, 160
        tk = tq + 2 * w
        q = rng.standard_normal((2, tq, 32)).astype(np.float32)
        k = rng.standard_normal((2, tk, 32)).astype(np.float32)
        v = rng.standard_normal((2, tk, 32)).astype(np.float32)
        lo, hi = 10, 180
        want = np.asarray(JF.flash_attention_local_bounded(*_jax(q, k, v), jnp.float32(lo), jnp.float32(hi),
                                                           w, True, w))
        got = TF.flash_attention_local_bounded(*_torch(q, k, v), lo, hi, w, q_offset=w)
        assert got.shape == (2, tq, 32)
        np.testing.assert_allclose(got.numpy(), want, atol=3e-5)
        oracle = np.asarray(JF.attention_local_bounded_reference(*_jax(q, k, v), lo, hi, w, q_offset=w))
        np.testing.assert_allclose(got.numpy(), oracle, atol=3e-5)

    def test_self_band_rejects_cross_attention_shapes(self):
        q, _, _ = _qkv(1, 128, 64)
        _, k, v = _qkv(1, 256, 64)
        with pytest.raises(ValueError, match="self-attention band"):
            TF.flash_attention_local(*_torch(q, k, v), 16)
        with pytest.raises(ValueError, match="window must be"):
            TF.flash_local_fwd(*_torch(q, q, q), 0.1, -1)


def test_wrappers_launch_or_raise_off_the_cpu():
    """Only a CPU tensor takes the plain version; any other device launches the kernel or raises."""
    q = torch.empty((1, 8, 32), device="meta")
    before = TF.flash_fwd.launches, TF.flash_local_fwd.launches
    with pytest.raises(ValueError, match="unsupported device"):
        TF.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="unsupported device"):
        TF.flash_attention_local(q, q, q, 4)
    assert (TF.flash_fwd.launches, TF.flash_local_fwd.launches) == before
    with pytest.raises(ValueError, match="q \\(H, Tq, d\\)"):
        TF.flash_fwd(torch.zeros(8, 32), torch.zeros(8, 32), torch.zeros(8, 32), 0.1)
