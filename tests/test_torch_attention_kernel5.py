"""PyTorch port: what the full forward's tensor-core kernel (kernel 5, ``flash_fwd_tc_kernel``) rests on, on the CPU.

* ``full_fwd_plan`` splits each block's walk over the key chunks so that
  every chunk is walked exactly once, and splits only when one head's tiles
  leave the card's resident blocks unfilled: for an H100 SXM's 132 SMs and
  the blocks per SM the CUDA occupancy calculator gives the kernel there (a
  card test holds the card to those values).
* The splits' partials combine to the unsplit result: each split's
  unnormalised out with its row max (log2 units) and sum, merged in split
  order as ``fwd_merge_kernel`` does, equals the plain version, with splits
  that see no valid key (weight exactly 0) and dead rows (out 0, lse 0).
* The kernel computes in 3xTF32 on the tensor cores, and the MMA's float32
  accumulation rounds toward zero.  A numpy emulation of its arithmetic at
  d = 128 (TF32 rounding as ``cvt.rna`` does it, the MMA reading the small
  half's top 19 bits, each MMA's sum rounded toward zero, a fresh accumulator
  per two k-steps of the scores and per chunk of P·V, the online softmax in
  log2 units) holds out and lse to the card tests' 3e-5 and 1e-5 against the
  plain float32 version and the JAX package's Pallas kernel in interpret
  mode, where one TF32 product does not.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvml_goalnet_tpu.ops.pallas import flash_attention as JF
from cvml_goalnet_tpu_torch.device import strict_f32
from cvml_goalnet_tpu_torch.ops.cuda import flash_attention as FA

# Resident blocks of kernel 5's tile kernel on an H100 SXM: 132 SMs × the CUDA occupancy calculator's blocks per
# SM for csrc/flash_attention.cu, by head width; a card test holds them to it.
H100_FWD_SLOTS = {32: 396, 64: 264, 128: 264}
OUT_TOL, LSE_TOL = 3e-5, 1e-5   # tests/test_torch_cuda_kernels.py and chip_smoke.py
LOG2E, LN2 = np.float32(1.4426950408889634), np.float32(0.6931471805599453)


def _t(seed, *shapes, scale=1.0):
    rng = np.random.default_rng(seed)
    return [torch.as_tensor((rng.standard_normal(s) * scale).astype(np.float32)) for s in shapes]


# --- (a) the split plan --------------------------------------------------------------------------


@pytest.mark.parametrize("d", sorted(FA.FWD_STREAM))
@pytest.mark.parametrize("h,t", [(1, 5400), (1, 32768), (4, 300), (1, 1), (2, 63)])
def test_full_fwd_plan_walks_every_chunk_once(h, t, d):
    plan = FA.full_fwd_plan(h, t, t, d, H100_FWD_SLOTS[d])
    assert (plan.tile, plan.stream) == (FA.FWD_TILE, FA.FWD_STREAM[d])
    chunks = -(-t // plan.stream)
    assert 1 <= plan.splits <= FA.MAX_SPLIT and (plan.splits == 1 or chunks // plan.splits >= 2)
    covered = [c for lo, hi in FA.split_ranges(chunks, plan.splits) for c in range(lo, hi)]
    assert covered == list(range(chunks))
    if h * -(-t // FA.FWD_TILE) >= H100_FWD_SLOTS[d]:
        assert plan.splits == 1   # the tiles alone fill the card


def test_planned_forward_takes_cuda_tensors_at_the_tensor_core_widths_only():
    q = torch.zeros((1, 8, 64))
    with pytest.raises(ValueError, match="CUDA tensors"):
        FA.flash_fwd_planned(q, q, q, 0.1, 2)


def test_full_fwd_plan_at_the_paths_shapes():
    # one head of a 5400-frame match at d = 128: 85 tiles of 64 on 264 resident blocks → 3 splits, 255 blocks
    assert FA.full_fwd_plan(1, 5400, 5400, 128, H100_FWD_SLOTS[128]) == FA.FwdPlan(64, 32, 3)
    # T = 32,768: 512 tiles fill the card twice over
    assert FA.full_fwd_plan(1, 32768, 32768, 128, H100_FWD_SLOTS[128]).splits == 1
    # four heads of 300 (20 tiles) over 5 chunks of 64: at most two chunks a split
    assert FA.full_fwd_plan(4, 300, 300, 64, H100_FWD_SLOTS[64]) == FA.FwdPlan(64, 64, 2)
    # the plan walks the valid keys only: t_valid = 0 walks nothing, unsplit
    assert FA.full_fwd_plan(1, 5400, 0, 128, H100_FWD_SLOTS[128]).splits == 1
    # a card with twice the slots splits more
    assert FA.full_fwd_plan(1, 5400, 5400, 128, 528).splits > 3


# --- (b) split partials and their merge ----------------------------------------------------------


def _split_partials(q, k, v, scale, kv_end, stream, splits):
    """Each split's (o, m, l) as kernel 5 leaves them: the split's key chunks of the valid keys, o
    unnormalised, m the row max of the scaled scores in log2 units (-inf where it saw no valid key), l the sum
    of its weights."""
    chunks = -(-kv_end // stream)
    parts = []
    for c0, c1 in FA.split_ranges(chunks, splits):
        lo, hi = c0 * stream, min(c1 * stream, kv_end)
        with strict_f32():
            s = torch.matmul(q, k[:, lo:hi].transpose(1, 2)) * (scale * float(LOG2E))
        m = s.amax(-1) if hi > lo else torch.full(q.shape[:2], float("-inf"))
        p = torch.exp2(s - torch.where(torch.isinf(m), 0.0, m)[..., None])
        with strict_f32():
            parts.append((torch.matmul(p, v[:, lo:hi]), m, p.sum(-1)))
    return parts


def _merge(parts):
    """fwd_merge_kernel: out = Σ 2^(m_i − m)·o_i / Σ 2^(m_i − m)·l_i in split order, lse = m·ln 2 + log l; a row
    no split saw a valid key of gets out 0 and lse 0."""
    mx = torch.stack([m for _, m, _ in parts]).amax(0)
    dead = torch.isinf(mx)
    acc, l = torch.zeros_like(parts[0][0]), torch.zeros_like(mx)
    for o, m, li in parts:
        w = torch.where(torch.isinf(m), 0.0, torch.exp2(m - torch.where(dead, 0.0, mx)))
        acc, l = acc + w[..., None] * o, l + w * li
    out = torch.where(dead[..., None], 0.0, acc / torch.where(dead, 1.0, l)[..., None])
    return out, torch.where(dead, 0.0, mx * float(LN2) + torch.log(torch.where(dead, 1.0, l)))


@pytest.mark.parametrize("t_valid", [None, 97, 0])
@pytest.mark.parametrize("splits", [1, 2, 3, 8])
def test_split_partials_merge_to_the_unsplit_forward(t_valid, splits):
    q, k, v = _t(5, (2, 150, 64), (2, 400, 64), (2, 400, 64))
    scale = 0.125
    kv_end = FA._t_valid(400, t_valid)
    parts = _split_partials(q, k, v, scale, kv_end, FA.FWD_STREAM[64], splits)
    if kv_end == 97 and splits == 8:   # 2 chunks in 8 splits: six see no valid key and weigh exactly 0
        assert sum(bool(torch.isinf(m).all()) for _, m, _ in parts) == 6
    out, lse = _merge(parts)
    want_out, want_lse = FA.flash_fwd_plain(q, k, v, scale, t_valid)
    torch.testing.assert_close(out, want_out, atol=OUT_TOL, rtol=0)
    torch.testing.assert_close(lse, want_lse, atol=LSE_TOL, rtol=0)
    if kv_end == 0:   # every row dead: out 0 and lse 0, never NaN
        assert not out.any() and not lse.any()


# --- (c) 3xTF32 with fresh accumulators, emulated ------------------------------------------------


def _tf32(x: np.ndarray) -> np.ndarray:
    """float32 rounded to TF32 as ``cvt.rna.tf32.f32`` does (ties away from zero)."""
    return ((x.view(np.uint32) + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _tf32_truncated(x: np.ndarray) -> np.ndarray:
    """What a TF32 MMA reads of a float32 operand: its top 19 bits."""
    return (x.view(np.uint32) & np.uint32(0xFFFFE000)).view(np.float32)


def _round_toward_zero(v: np.ndarray) -> np.ndarray:
    """float64 → float32, rounded toward zero."""
    f = v.astype(np.float32)
    return np.where(np.abs(f.astype(np.float64)) > np.abs(v), np.nextafter(f, np.float32(0)), f)


def _terms(a: np.ndarray, b: np.ndarray, three: bool):
    """The MMAs of a product, in mma3's order: small·big', big·small', big·big' (or big·big' alone)."""
    ab, bb = _tf32(a), _tf32(b)
    if not three:
        return [(ab, bb)]
    return [(_tf32_truncated(a - ab), bb), (ab, _tf32_truncated(b - bb)), (ab, bb)]


def _mma_chain(acc: np.ndarray, a_steps, b_steps, three: bool) -> np.ndarray:
    """acc after the MMAs of k-steps of 8: each adds its 8 exact products and rounds toward zero."""
    for a, b in zip(a_steps, b_steps):
        for x, y in _terms(a, b, three):
            acc = _round_toward_zero(acc.astype(np.float64) + x.astype(np.float64) @ y.astype(np.float64))
    return acc


def _emulate_fwd(q, k, v, scale, kv_end, stream, three=True, steps_per_fresh=2):
    """One head's out and lse as kernel 5's arithmetic forms them (no split)."""
    tq, d = q.shape
    out_o = np.zeros((tq, d), np.float32)
    m = np.full(tq, -np.inf, np.float32)
    l = np.zeros(tq, np.float32)
    sl2e = np.float32(scale) * LOG2E
    for c0 in range(0, kv_end, stream):
        kc, vc = k[c0 : min(c0 + stream, kv_end)], v[c0 : min(c0 + stream, kv_end)]
        n = kc.shape[0]
        s = np.zeros((tq, n), np.float32)
        for g0 in range(0, d // 8, steps_per_fresh):   # S over d, a fresh accumulator per steps_per_fresh k-steps
            ks = range(g0, min(d // 8, g0 + steps_per_fresh))
            fresh = _mma_chain(np.zeros((tq, n), np.float32), [q[:, 8 * i : 8 * i + 8] for i in ks],
                               [kc[:, 8 * i : 8 * i + 8].T for i in ks], three)
            s = s + fresh
        s = s * sl2e
        m_new = np.maximum(m, s.max(1))
        base = np.where(np.isinf(m_new), np.float32(0), m_new)
        alpha = np.exp2(m - base).astype(np.float32)
        p = np.exp2(s - base[:, None]).astype(np.float32)
        l = l * alpha + p.sum(1, dtype=np.float32)
        m = m_new
        pad = (-n) % 8   # a chunk's zero-filled keys past kv_end weigh 0
        p8, v8 = np.pad(p, ((0, 0), (0, pad))), np.pad(vc, ((0, pad), (0, 0)))
        fresh = _mma_chain(np.zeros((tq, d), np.float32), [p8[:, 8 * j : 8 * j + 8] for j in range(p8.shape[1] // 8)],
                           [v8[8 * j : 8 * j + 8] for j in range(p8.shape[1] // 8)], three)
        out_o = out_o * alpha[:, None] + fresh
    dead = np.isinf(m)
    out = np.where(dead[:, None], np.float32(0), out_o / np.where(dead, np.float32(1), l)[:, None])
    lse = np.where(dead, np.float32(0), m * LN2 + np.log(np.where(dead, np.float32(1), l)))
    return out.astype(np.float32), lse.astype(np.float32)


@pytest.fixture(scope="module")
def fwd_case():
    """(1, 128, 128) queries over 1000 keys, the card tests' input scale, and the plain float32 forward."""
    q, k, v = (x.numpy() for x in _t(40, (1, 128, 128), (1, 1000, 128), (1, 1000, 128)))
    scale = 128 ** -0.5
    out, lse = FA.flash_fwd_plain(*map(torch.as_tensor, (q, k, v)), scale)
    return q[0], k[0], v[0], scale, out[0].numpy(), lse[0].numpy()


def _shares(got, want_out, want_lse):
    out, lse = got
    return float(np.abs(out - want_out).max() / OUT_TOL), float(np.abs(lse - want_lse).max() / LSE_TOL)


def test_three_tf32_products_with_fresh_accumulators_hold_the_tolerance(fwd_case):
    q, k, v, scale, want_out, want_lse = fwd_case
    got = _emulate_fwd(q, k, v, scale, k.shape[0], FA.FWD_STREAM[128])
    assert max(_shares(got, want_out, want_lse)) <= 0.25


def test_emulated_kernel_matches_the_pallas_kernel(fwd_case):
    q, k, v, scale, _, _ = fwd_case
    o_j, lse_j = JF._flash_fwd(*(jnp.asarray(x[None]) for x in (q, k, v)), scale, 128, 128, True, 700)
    got = _emulate_fwd(q, k, v, scale, 700, FA.FWD_STREAM[128])
    # the Pallas kernel's lse is (H, Tq padded, 128 lanes)
    assert max(_shares(got, np.asarray(o_j)[0], np.asarray(lse_j)[0, : q.shape[0], 0])) <= 0.25


def test_one_tf32_product_breaks_the_tolerance(fwd_case):
    q, k, v, scale, want_out, want_lse = fwd_case
    got = _emulate_fwd(q, k, v, scale, k.shape[0], FA.FWD_STREAM[128], three=False)
    assert max(_shares(got, want_out, want_lse)) > 1.0
