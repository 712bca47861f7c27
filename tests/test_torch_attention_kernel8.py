"""PyTorch port: what the banded backward on the tensor cores (kernel 8) rests on, on the CPU.

* ``local_bwd_plan``'s walk (``local_bwd_chunks``, the specification the
  kernel's ``TcBand::chunks`` follows) covers every valid (query, key) pair of
  the band exactly once on the dK/dV side and on the dQ side, across every
  split count, and no tile walks a chunk that holds none of its pairs: bands
  from 0 to past T, Tq ≠ Tk, key bounds inside a chunk, past the ends and
  crossed (lo > hi), query offsets of either sign, T ragged against the tiles,
  the chunks and the splits.
* The plan at the main path's shapes, for an H100's resident slots.
* Kernel 8 computes its five products in 3xTF32 on the tensor cores, as
  kernel 6 does: a plain PyTorch emulation of those products under the band
  mask holds the backward to the card tests' tolerance, 1e-4·max(1,
  max|plain|) per gradient, also at scores near 1e3 and against the JAX
  package's Pallas kernel in interpret mode, where a single TF32 product does
  not.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvml_goalnet_tpu.ops.pallas import flash_attention as JF
from cvml_goalnet_tpu_torch.ops.cuda import flash_attention as FA
from test_torch_attention_kernel6 import H100_SLOTS, _mm1, _mm3, _t, _worst_over_tolerance

# (h, tq, tk, d, window, lo, hi, q_offset)
BAND_CASES = [
    (1, 200, 200, 64, 0, None, None, 0),        # the diagonal alone
    (2, 300, 250, 32, 37, 5, 233, -20),         # Tq ≠ Tk, bounds inside a chunk, a negative offset
    (1, 1000, 1000, 128, 1024, None, None, 0),  # W ≥ T: every pair
    (2, 777, 451, 64, 37, 13, 400, 16),         # a positive offset, ragged against tiles and chunks
    (1, 130, 200, 32, 10 ** 6, 10, 190, 35),    # W far past T, Tq < Tk
    (2, 200, 200, 64, 16, 150, 40, 0),          # lo > hi: no valid key
    (1, 65, 97, 128, 37, 0, 97, 0),             # one row and one key past a tile
    (1, 129, 63, 32, 5, -10, 1000, -100),       # bounds past both ends, rows whose band misses every key
    (2, 1500, 1100, 128, 100, 70, 1033, 300),   # a band off the diagonal
    (1, 5400, 5400, 64, 1024, None, None, 0),   # the main path's band
]


def _valid(tq, tk, window, lo, hi, q_offset) -> np.ndarray:
    """(tq, tk) mask of the band, from the plain version's own mask."""
    q, k = torch.empty((1, tq, 1)), torch.empty((1, tk, 1))
    return FA._band_valid(q, k, window, lo, hi, q_offset)[0].numpy()


def _walks(ranges, s):
    """(tile index, chunk) of every split of ``s`` of every tile, in walk order."""
    for tile, (first, end) in enumerate(ranges):
        for a, b in FA.split_ranges(end - first, s):
            for c in range(first + a, first + b):
                yield tile, c


@pytest.mark.parametrize("case", BAND_CASES, ids=lambda c: "-".join(map(str, c)))
def test_local_bwd_walk_covers_every_valid_pair_once(case):
    h, tq, tk, d, window, lo, hi, q_offset = case
    stream = FA.BWD_STREAM[d]
    lo_i, hi_i = (0 if lo is None else lo), (tk if hi is None else hi)
    valid = _valid(tq, tk, window, lo, hi, q_offset)
    dkv, dq = FA.local_bwd_chunks(tq, tk, window, lo_i, hi_i, q_offset, stream)
    assert len(dkv) == -(-tk // FA.BWD_TILE) and len(dq) == -(-tq // FA.BWD_TILE)
    plan = FA.local_bwd_plan(h, tq, tk, d, window, lo_i, hi_i, q_offset, H100_SLOTS[d])
    for side, ranges, s_plan in (("dkv", dkv, plan.s_dkv), ("dq", dq, plan.s_dq)):
        assert 1 <= s_plan <= FA.MAX_SPLIT
        tiles = h * len(ranges)
        if tiles >= H100_SLOTS[d][side == "dq"]:
            assert s_plan == 1      # the tiles alone fill the card
        for tile, (first, end) in enumerate(ranges):   # no tile walks a chunk that meets none of its band
            stat = slice(tile * FA.BWD_TILE, (tile + 1) * FA.BWD_TILE)
            for c in range(first, end):
                streamed = slice(c * stream, (c + 1) * stream)
                block = valid[streamed, stat] if side == "dkv" else valid[stat, streamed]
                assert block.any(), f"{side} tile {tile} walks chunk {c}, outside its band"
        for s in sorted({s_plan, *range(1, FA.MAX_SPLIT + 1)}):
            count = np.zeros((tq, tk), dtype=np.int32)
            for tile, c in _walks(ranges, s):
                stat = slice(tile * FA.BWD_TILE, (tile + 1) * FA.BWD_TILE)
                streamed = slice(c * stream, (c + 1) * stream)
                if side == "dkv":
                    count[streamed, stat] += 1
                else:
                    count[stat, streamed] += 1
            assert (count[valid] == 1).all(), f"{side}, {s} splits: a valid pair walked {count[valid].max()} or 0 times"
            assert count.max() <= 1


def test_local_chunk_range_is_empty_without_valid_keys():
    limits = FA.band_limits(200, 200, 16, 150, 40, 0)
    assert limits[:2] == (150, 40)
    for r0 in range(0, 200, FA.BWD_TILE):
        assert FA.local_chunk_range(True, r0, 200, 200, limits, 32) == (0, 0)
        assert FA.local_chunk_range(False, r0, 200, 200, limits, 32) == (0, 0)
    # a band past every key: rows of a q_offset beyond Tk + W see nothing
    limits = FA.band_limits(100, 100, 5, 0, 100, 500)
    assert limits[2:] == (100, 100)
    assert all(FA.local_chunk_range(False, r0, 100, 100, limits, 32) == (0, 0) for r0 in (0, 64))


def test_band_limits_clamp_the_differences():
    # |i + q_offset − j| ≤ W ⇔ j − i ∈ [q_offset − W, q_offset + W], clamped to [−Tq, Tk]
    assert FA.band_limits(300, 250, 37, 5, 233, -20) == (5, 233, -57, 17)
    assert FA.band_limits(130, 200, 10 ** 6, 10, 190, 35) == (10, 190, -130, 200)
    assert FA.band_limits(129, 63, 5, -10, 1000, -100) == (0, 63, -105, -95)
    assert FA.band_limits(129, 63, 5, -10, 1000, -300) == (0, 63, -129, -129)


def test_local_bwd_plan_at_the_main_paths_shapes():
    # one head of 5400 frames at d = 128: 85 tiles, each walking at most 132 chunks of 16, on 264 slots
    assert FA.local_bwd_plan(1, 5400, 5400, 128, 1024, 0, 5400, 0, H100_SLOTS[128]) == FA.BwdPlan(64, 64, 16, 3, 3)
    # two heads of 64 at d = 64: 170 tiles of at most 66 chunks of 32, on 264 (dK/dV) and 396 (dQ) slots
    assert FA.local_bwd_plan(2, 5400, 5400, 64, 1024, 0, 5400, 0, H100_SLOTS[64]) == FA.BwdPlan(64, 64, 32, 3, 2)
    # long timelines fill the card unsplit
    assert FA.local_bwd_plan(1, 32768, 32768, 128, 1024, 0, 32768, 0, H100_SLOTS[128])[3:] == (1, 1)
    assert FA.local_bwd_plan(1, 135000, 135000, 128, 1024, 0, 135000, 0, H100_SLOTS[128])[3:] == (1, 1)
    dkv, dq = FA.local_bwd_chunks(5400, 5400, 1024, 0, 5400, 0, 16)
    assert max(e - f for f, e in dkv) == max(e - f for f, e in dq) == 132
    walked = 64 * 16 * sum(e - f for f, e in dkv)
    pairs = int(_valid(5400, 5400, 1024, None, None, 0).sum())
    assert pairs == 10_015_000 and 0.96 < pairs / walked < 0.97   # about 97 % of the walked entries are in the band


def test_planned_wrapper_takes_cuda_tensors_only():
    q = torch.zeros((1, 8, 32))
    with pytest.raises(ValueError, match="CUDA tensors"):
        FA.flash_local_bwd_planned(q, q, q, q, torch.zeros((1, 8)), q, 0.1, 4, 1, 1)


# --- 3xTF32, emulated, under the band ------------------------------------------------------------


def _local_bwd_with(mm, q, k, v, out, lse, dout, scale, valid):
    """flash_local_bwd_plain's math with its five products through ``mm``; masked pairs get P = dS = 0."""
    di = (dout * out).sum(-1)
    p = torch.where(valid, torch.exp(mm(q, k.transpose(1, 2)) * scale - lse[..., None]), 0.0)
    dv = mm(p.transpose(1, 2), dout)
    ds = p * (mm(dout, v.transpose(1, 2)) - di[..., None])
    return mm(ds, k) * scale, mm(ds.transpose(1, 2), q) * scale, dv


def _band_case(tq, tk, d, window, qk_scale, seed, lo=None, hi=None, q_offset=0):
    q, = _t(seed, (1, tq, d), scale=qk_scale)
    k, = _t(seed + 1, (1, tk, d), scale=qk_scale)
    v, = _t(seed + 2, (1, tk, d))
    dout, = _t(seed + 3, (1, tq, d))
    scale = 0.125
    out, lse = FA.flash_local_fwd_plain(q, k, v, scale, window, lo, hi, q_offset)
    valid = torch.as_tensor(_valid(tq, tk, window, lo, hi, q_offset))[None]
    return q, k, v, out, lse, dout, scale, valid


@pytest.mark.parametrize("qk_scale", [1.0, 10.0])
def test_three_tf32_products_hold_the_banded_gradient_tolerance(qk_scale):
    q, k, v, out, lse, dout, scale, valid = _band_case(1000, 1000, 64, 100, qk_scale, 180)
    want = FA.flash_local_bwd_plain(q, k, v, out, lse, dout, scale, 100)
    got = _local_bwd_with(_mm3, q, k, v, out, lse, dout, scale, valid)
    assert _worst_over_tolerance(got, want) <= 1.0


def test_one_tf32_product_breaks_the_banded_gradient_tolerance():
    q, k, v, out, lse, dout, scale, valid = _band_case(1000, 1000, 64, 100, 1.0, 180)
    want = FA.flash_local_bwd_plain(q, k, v, out, lse, dout, scale, 100)
    assert _worst_over_tolerance(_local_bwd_with(_mm1, q, k, v, out, lse, dout, scale, valid), want) > 1.0


def test_three_tf32_products_match_the_pallas_kernel():
    """The emulation with key bounds and a query offset against ``_flash_local_bwd`` in interpret mode."""
    w, lo, hi = 20, 5, 230
    q, k, v, out, lse, dout, scale, valid = _band_case(200, 240, 32, w, 1.0, 190, lo, hi, w)
    got = _local_bwd_with(_mm3, q, k, v, out, lse, dout, scale, valid)
    qj, kj, vj = (jnp.asarray(x.numpy()) for x in (q, k, v))
    o_j, lse_j = JF._flash_local_fwd(qj, kj, vj, scale, w, 128, True, jnp.int32(lo), jnp.int32(hi), w)
    want = JF._flash_local_bwd(qj, kj, vj, o_j, lse_j, jnp.asarray(dout.numpy()), scale, w, 128, True,
                               jnp.int32(lo), jnp.int32(hi), w)
    assert _worst_over_tolerance(got, [torch.as_tensor(np.array(x)) for x in want]) <= 1.0
    assert not got[1][:, :lo].any() and not got[1][:, hi:].any() and not got[2][:, hi:].any()
