"""PyTorch port: int8 quantization (``ops/quant.py``) and ``tree_cast`` against the JAX package, on the CPU.

The same seeded numpy inputs go through ``cvml_goalnet_tpu/ops/quant.py`` (XLA
on the CPU) and ``cvml_goalnet_tpu_torch/ops/quant.py``.  Tolerances: int8
values and int32 convolutions equal; scales within 1e-6 relative (float32
``amax / 127`` on both sides, so in practice equal); dequantized outputs
within 1e-6 of max|JAX| in float32 (one float32 product per output on both
sides), and within one bf16 ulp where the output is bf16.  The int8 form of
kernel 2's plain version is held to JAX's XLA chain ``quantized_conv2d +
corr → ReLU → pool`` to the same tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvml_goalnet_tpu.ops import quant as JQ
from cvml_goalnet_tpu.utils import tree_cast as jax_tree_cast
from cvml_goalnet_tpu_torch.ops import quant as TQ
from cvml_goalnet_tpu_torch.ops.cuda.fused_stage import fused_conv_pool_stage_int8
from cvml_goalnet_tpu_torch.utils import tree_cast


def _rng(seed):
    return np.random.default_rng(seed)


def _bf16_np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))


@pytest.mark.parametrize("shape,axis", [((3, 3, 64, 256), 3), ((3, 3, 256, 512), -1), ((41, 7), 1), ((5, 9), 0),
                                        ((3, 3, 3, 64), 3)])
def test_weight_quantization_matches_jax(shape, axis):
    w = _rng(0).standard_normal(shape).astype(np.float32) * 0.05
    w[..., 0] = 0.0 if axis in (-1, len(shape) - 1) else w[..., 0]   # an all-zero channel: the 1e-12 floor
    jq, js = JQ.quantize_weights_per_channel(jnp.asarray(w), axis=axis)
    tq, ts = TQ.quantize_weights_per_channel(torch.from_numpy(w), axis=axis)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32 and tuple(ts.shape) == js.shape
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6, atol=0)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_activation_quantization_matches_jax(dtype):
    x = np.abs(_rng(1).standard_normal((4, 13, 13, 64)).astype(np.float32)) * 3
    jx = jnp.asarray(x) if dtype is np.float32 else jnp.asarray(x).astype(jnp.bfloat16)
    tx = torch.from_numpy(x) if dtype is np.float32 else torch.from_numpy(x).to(torch.bfloat16)
    jq, js = JQ.quantize_act_per_tensor(jx)
    tq, ts = TQ.quantize_act_per_tensor(tx)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert ts.dtype == torch.float32 and ts.shape == ()
    np.testing.assert_allclose(float(ts), float(js), rtol=1e-6)


def test_rounding_is_half_to_even_by_division():
    # amax 127 gives the scale 1: x / 1 lands exactly on the halves, which round to even as jnp.round does
    w = np.array([[127.0], [2.5], [-3.5], [0.5], [-0.5], [126.5]], np.float32)
    tq, ts = TQ.quantize_weights_per_channel(torch.from_numpy(w), axis=1)
    jq, _ = JQ.quantize_weights_per_channel(jnp.asarray(w), axis=1)
    assert float(ts) == 1.0
    np.testing.assert_array_equal(tq.numpy()[:, 0], [127, 2, -4, 0, 0, 126])
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    # all zeros: the scale floor, and zeros back
    zq, zs = TQ.quantize_act_per_tensor(torch.zeros(3, 4))
    assert float(zs) == pytest.approx(1e-12) and not zq.any()


@pytest.mark.parametrize("n,hh,cin,cout,stride,pad", [(2, 11, 256, 512, 1, 1), (3, 13, 64, 256, 1, 1),
                                                      (2, 9, 5, 7, 2, 0), (1, 40, 3, 8, 3, 3)])
def test_conv2d_int8_is_exact(n, hh, cin, cout, stride, pad):
    g = _rng(2)
    xq = g.integers(-127, 128, (n, hh, hh, cin)).astype(np.int8)
    wq = g.integers(-127, 128, (3, 3, cin, cout)).astype(np.int8)
    xq[0, 0, 0, :] = 127   # the largest sums: K = 9·Cin products of 127²
    wq[..., 0] = 127
    want = np.asarray(JQ.conv2d_int8(jnp.asarray(xq), jnp.asarray(wq), stride, pad))
    got = TQ.conv2d_int8(torch.from_numpy(xq), torch.from_numpy(wq), stride, pad)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), JQ.conv2d_int8_host(xq, wq, stride, pad))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantized_conv2d_matches_jax(dtype):
    g = _rng(3)
    x = np.abs(g.standard_normal((3, 11, 11, 256))).astype(np.float32)
    w = g.standard_normal((3, 3, 256, 64)).astype(np.float32) * 0.02
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    want = np.asarray(JQ.quantized_conv2d(jnp.asarray(x).astype(jdt), jnp.asarray(w), 1, 1).astype(jnp.float32))
    got = TQ.quantized_conv2d(torch.from_numpy(x).to(tdt), torch.from_numpy(w), 1, 1)
    assert got.dtype == tdt
    np.testing.assert_allclose(got.to(torch.float32).numpy(), want, atol=1e-6 * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantized_linear_matches_jax(dtype):
    g = _rng(4)
    params = {"w": g.standard_normal((96, 40)).astype(np.float32) * 0.1, "b": g.standard_normal(40).astype(np.float32)}
    x = g.standard_normal((17, 96)).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    want = np.asarray(JQ.quantized_linear({k: jnp.asarray(v) for k, v in params.items()},
                                          jnp.asarray(x).astype(jdt)).astype(jnp.float32))
    got = TQ.quantized_linear({k: torch.from_numpy(v) for k, v in params.items()}, torch.from_numpy(x).to(tdt))
    assert got.dtype == tdt
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6 * np.abs(want).max(), rtol=0)
    else:   # float32 results one rounding from bf16: equal, or one ulp apart where the float32 sums tie
        np.testing.assert_allclose(got.to(torch.float32).numpy(), want, rtol=2 ** -8, atol=0)


def _jax_int8_stage(x, w, b):
    y = JQ.quantized_conv2d(x, w, 1, 1) + b.astype(x.dtype)
    y = jax.nn.relu(y)
    return jax.lax.reduce_window(y, -jnp.inf, jax.lax.max, (1, 3, 3, 1), (1, 1, 1, 1), "VALID")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,hh,cin,cout", [(4, 13, 64, 256), (2, 11, 256, 512), (3, 9, 20, 70)])
def test_int8_stage_plain_matches_jax_chain(dtype, n, hh, cin, cout):
    g = _rng(5)
    x = np.abs(g.standard_normal((n, hh, hh, cin))).astype(np.float32)
    w = g.standard_normal((3, 3, cin, cout)).astype(np.float32) * 0.05
    b = g.standard_normal((hh, hh, cout)).astype(np.float32) * 0.1
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    want = np.asarray(_jax_int8_stage(jnp.asarray(x).astype(jdt), jnp.asarray(w),
                                      jnp.asarray(b).astype(jdt)).astype(jnp.float32))
    got = fused_conv_pool_stage_int8(torch.from_numpy(x).to(tdt), torch.from_numpy(w), torch.from_numpy(b).to(tdt))
    assert got.dtype == tdt and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.to(torch.float32).numpy(), want, atol=1e-6 * np.abs(want).max(), rtol=0)


def test_int8_stage_of_no_frames():
    out = fused_conv_pool_stage_int8(torch.zeros((0, 13, 13, 64)), torch.zeros((3, 3, 64, 8)), torch.zeros((13, 13, 8)))
    assert out.shape == (0, 11, 11, 8) and out.dtype == torch.float32


def test_tree_cast_matches_jax():
    tree = {"a": np.ones((2,), np.float32), "b": [np.arange(3, dtype=np.int32), np.full((1,), 0.1, np.float32)],
            "c": {"d": np.zeros((2, 2), np.int8)}}
    want = jax_tree_cast(jax.tree.map(jnp.asarray, tree), jnp.bfloat16)
    got = tree_cast(jax.tree.map(torch.from_numpy, tree), torch.bfloat16)
    assert got["a"].dtype == got["b"][1].dtype == torch.bfloat16
    assert got["b"][0].dtype == torch.int32 and got["c"]["d"].dtype == torch.int8
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(g.to(torch.float32).numpy() if g.is_floating_point() else g.numpy(),
                                      np.asarray(w.astype(jnp.float32) if jnp.issubdtype(w.dtype, jnp.floating) else w))
    same = torch.ones(2)
    assert tree_cast([same], torch.float32)[0] is same
