"""PyTorch port: what the attention kernels' wrappers and the full backward's design rest on, on the CPU.

* Head widths outside the built ones (32, 64, 128, 256) reach the kernels
  zero-padded to the next built width, with the scale of the true width: the
  plain versions on inputs padded by the wrappers' own helper, sliced back,
  equal the unpadded plain versions, and the JAX package's XLA reference.
  Widths past 256 run zero-padded to a multiple of 128, on the wide path.
* ``strict_f32`` holds TF32 off while any thread is inside it.
* ``full_bwd_plan``'s splits walk every streamed chunk exactly once, for an H100's resident slots.
* The full backward (kernel 6) computes its five products in 3xTF32 on the
  tensor cores; a plain PyTorch emulation of those products (TF32 rounding as
  ``cvt.rna`` does it) holds the backward to the card tests' tolerance,
  1e-4·max(1, max|plain|) per gradient, where a single TF32 product does not.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvml_goalnet_tpu.ops.pallas import flash_attention as JF
from cvml_goalnet_tpu_torch.device import strict_f32
from cvml_goalnet_tpu_torch.ops.cuda import flash_attention as FA


def _t(seed, *shapes, scale=1.0):
    rng = np.random.default_rng(seed)
    return [torch.as_tensor((rng.standard_normal(s) * scale).astype(np.float32)) for s in shapes]


def _padded(tensors, d):
    width = FA.padded_head_dim(d)
    return [FA.pad_head_dim(x, width) for x in tensors]


# --- (a) head-dim padding ------------------------------------------------------------------------


@pytest.mark.parametrize("d,width", [(1, 32), (8, 32), (16, 32), (32, 32), (33, 64), (48, 64), (96, 128),
                                     (128, 128), (129, 256), (160, 256), (192, 256), (256, 256), (257, 384),
                                     (320, 384), (512, 512), (1000, 1024)])
def test_padded_head_dim_is_the_next_built_width(d, width):
    assert FA.padded_head_dim(d) == width
    x = torch.ones((2, 3, d))
    got = FA.pad_head_dim(x, width)
    assert got.shape == (2, 3, width) and got.is_contiguous()
    assert torch.equal(got[..., :d], x) and not got[..., d:].any()


def test_head_dims_past_128_raise():
    """Past 128 the heads run on the 256-wide kernels, up to 256; wider ones run on the wide path, zero-padded
    to a multiple of its 128-wide chunk, and no positive width raises."""
    for d in (129, 160, 256):
        assert FA.padded_head_dim(d) == 256
    for d, width in ((257, 384), (320, 384), (384, 384), (512, 512), (1000, 1024)):
        assert FA.padded_head_dim(d) == width and width % FA.WIDE_CHUNK == 0


@pytest.mark.parametrize("d", [8, 16, 48, 96, 160, 192, 256, 320])
@pytest.mark.parametrize("window", [None, 5])
def test_padding_keeps_forward_and_backward(d, window):
    h, tq, tk = 2, 37, 37
    q, k, v, dout = _t(d, (h, tq, d), (h, tk, d), (h, tk, d), (h, tq, d))
    g_lse = _t(d + 1, (h, tq))[0]
    scale = d ** -0.5
    qp, kp, vp, dp = _padded((q, k, v, dout), d)
    if window is None:
        fwd = lambda q, k, v: FA.flash_fwd_plain(q, k, v, scale, 30)
        bwd = lambda q, k, v, o, l, g: FA.flash_bwd_plain(q, k, v, o, l, g, scale, 30, g_lse)
    else:
        fwd = lambda q, k, v: FA.flash_local_fwd_plain(q, k, v, scale, window, 2, 33, 1)
        bwd = lambda q, k, v, o, l, g: FA.flash_local_bwd_plain(q, k, v, o, l, g, scale, window, 2, 33, 1)
    out, lse = fwd(q, k, v)
    out_p, lse_p = fwd(qp, kp, vp)
    torch.testing.assert_close(out_p[..., :d], out, atol=1e-6, rtol=0)
    assert not out_p[..., d:].any()
    torch.testing.assert_close(lse_p, lse, atol=1e-6, rtol=0)
    for got, want in zip(bwd(qp, kp, vp, out_p, lse_p, dp), bwd(q, k, v, out, lse, dout)):
        torch.testing.assert_close(got[..., :d], want, atol=1e-6, rtol=0)
        assert not got[..., d:].any()


@pytest.mark.parametrize("d", [16, 48])
def test_padded_backward_matches_jax_reference(d):
    """The padded path as the kernels take it, against ``jax.grad`` of the JAX package's XLA reference."""
    h, t = 2, 40
    q, k, v, g = _t(d + 7, *[(h, t, d)] * 4)
    scale = d ** -0.5
    qp, kp, vp, gp = _padded((q, k, v, g), d)
    out_p, lse_p = FA.flash_fwd_plain(qp, kp, vp, scale)
    got = [x[..., :d] for x in FA.flash_bwd_plain(qp, kp, vp, out_p, lse_p, gp, scale)]

    def loss(q, k, v):
        return jnp.sum(JF.attention_reference(q, k, v, scale) * jnp.asarray(g.numpy()))

    want_out = np.asarray(JF.attention_reference(*(jnp.asarray(x.numpy()) for x in (q, k, v)), scale))
    want = jax.grad(loss, (0, 1, 2))(*(jnp.asarray(x.numpy()) for x in (q, k, v)))
    np.testing.assert_allclose(out_p[..., :d].numpy(), want_out, atol=2e-5, rtol=0)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4, rtol=1e-4)


# --- (b) strict_f32 across threads ---------------------------------------------------------------


def test_strict_f32_holds_tf32_off_while_any_thread_is_inside():
    flags = lambda: (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    saved = flags()
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = True, True
    both_in, a_out, b_checked = threading.Barrier(2), threading.Barrier(2), threading.Barrier(2)
    seen = {}

    def first():
        with strict_f32():
            both_in.wait()
            seen["a_inside"] = flags()
        a_out.wait()      # A has left; B is still inside
        b_checked.wait()

    def second():
        with strict_f32():
            both_in.wait()
            a_out.wait()
            seen["b_after_a_left"] = flags()
        b_checked.wait()

    try:
        threads = [threading.Thread(target=first), threading.Thread(target=second)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=30)
        assert not any(th.is_alive() for th in threads)
        assert seen == {"a_inside": (False, False), "b_after_a_left": (False, False)}
        assert flags() == (True, True)     # restored after both left
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def test_strict_f32_nests_in_one_thread():
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    with strict_f32():
        with strict_f32():
            pass
        assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
    assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == saved


# --- (c) the full backward's plan ----------------------------------------------------------------


# Resident (dK/dV, dQ) blocks of kernel 6 on an H100 SXM: 132 SMs × the CUDA occupancy calculator's blocks
# per SM for csrc/flash_attention.cu, (3, 3), (2, 3) and (2, 2) by head width; a card test holds them to it.
H100_SLOTS = {32: (396, 396), 64: (264, 396), 128: (264, 264)}


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("t", [1, 63, 5400, 32768])
@pytest.mark.parametrize("h", [1, 2, 4])
def test_full_bwd_plan_walks_every_chunk_once(h, t, d):
    plan = FA.full_bwd_plan(h, t, t, d, H100_SLOTS[d])
    assert (plan.tile_q, plan.tile_k, plan.stream) == (FA.BWD_TILE, FA.BWD_TILE, FA.BWD_STREAM[d])
    chunks = -(-t // plan.stream)
    for s in (plan.s_dkv, plan.s_dq):
        assert 1 <= s <= FA.MAX_SPLIT
        assert s == 1 or chunks // s >= 2
        covered = [c for lo, hi in FA.split_ranges(chunks, s) for c in range(lo, hi)]
        assert covered == list(range(chunks))
    blocks = h * -(-t // FA.BWD_TILE)
    for s, slots in zip((plan.s_dkv, plan.s_dq), H100_SLOTS[d]):
        if blocks >= slots:
            assert s == 1     # the tiles alone fill the card


def test_full_bwd_plan_fills_the_card_at_one_match():
    # one head of 5400 frames at d = 128: 85 tiles of 64 on 132 SMs × 2 resident blocks
    assert FA.full_bwd_plan(1, 5400, 5400, 128, H100_SLOTS[128]) == FA.BwdPlan(64, 64, 16, 3, 3)
    assert FA.full_bwd_plan(1, 32768, 32768, 128, H100_SLOTS[128]).s_dkv == 1
    # a card with twice the slots splits more
    assert FA.full_bwd_plan(1, 5400, 5400, 128, (528, 528)) == FA.BwdPlan(64, 64, 16, 6, 6)


# --- (d) 3xTF32, emulated ------------------------------------------------------------------------


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32 as ``cvt.rna.tf32.f32`` does: add half of the dropped 13 bits' range to the
    int32 view, then clear them."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _tf32_truncated(x: torch.Tensor) -> torch.Tensor:
    """What a TF32 MMA reads of a float32 operand: its top 19 bits."""
    return (x.view(torch.int32) & -0x2000).view(torch.float32)


def _mm3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the kernel forms it: big·big' + big·small' + small·big', with big = tf32(x) and small
    = x − big, of which the MMA reads the top 19 bits."""
    ab, bb = _tf32(a), _tf32(b)
    as_, bs = _tf32_truncated(a - ab), _tf32_truncated(b - bb)
    return ab @ bb + ab @ bs + as_ @ bb


def _mm1(a, b):
    return _tf32(a) @ _tf32(b)


def _bwd_with(mm, q, k, v, out, lse, dout, scale):
    """flash_bwd_plain's math with its five products through ``mm``."""
    di = (dout * out).sum(-1)
    p = torch.exp(mm(q, k.transpose(1, 2)) * scale - lse[..., None])
    dv = mm(p.transpose(1, 2), dout)
    ds = p * (mm(dout, v.transpose(1, 2)) - di[..., None])
    return mm(ds, k) * scale, mm(ds.transpose(1, 2), q) * scale, dv


def _worst_over_tolerance(got, want) -> float:
    return max(((g - w).abs().max() / (1e-4 * max(1.0, w.abs().max().item()))).item() for g, w in zip(got, want))


def _case(h, t, d, qk_scale, seed):
    q, k = _t(seed, (h, t, d), (h, t, d), scale=qk_scale)
    v, dout = _t(seed + 1, (h, t, d), (h, t, d))
    scale = 0.125
    out, lse = FA.flash_fwd_plain(q, k, v, scale)
    return q, k, v, out, lse, dout, scale


@pytest.mark.parametrize("h,t,d,qk_scale", [(1, 1000, 64, 1.0), (2, 300, 64, 1.0), (1, 1000, 64, 10.0)])
def test_three_tf32_products_hold_the_gradient_tolerance(h, t, d, qk_scale):
    q, k, v, out, lse, dout, scale = _case(h, t, d, qk_scale, 150)
    want = FA.flash_bwd_plain(q, k, v, out, lse, dout, scale)
    got = _bwd_with(_mm3, q, k, v, out, lse, dout, scale)
    assert _worst_over_tolerance(got, want) <= 1.0


def test_one_tf32_product_breaks_the_gradient_tolerance():
    q, k, v, out, lse, dout, scale = _case(1, 1000, 64, 1.0, 150)
    want = FA.flash_bwd_plain(q, k, v, out, lse, dout, scale)
    assert _worst_over_tolerance(_bwd_with(_mm1, q, k, v, out, lse, dout, scale), want) > 1.0


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -12, -1.0 - 2 ** -11, -3.0 - 2 ** -9 - 2 ** -11])
    want = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -10, -1.0 - 2 ** -10, -3.0 - 2 ** -9])
    assert torch.equal(_tf32(x), want)    # ties away from zero, as cvt.rna
    assert not (_tf32(x).view(torch.int32) & 0x1FFF).any()
