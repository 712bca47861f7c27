"""PyTorch port: what the banded forward on the tensor cores (kernel 7) rests on, on the CPU.

* ``local_fwd_plan``'s walk (``local_fwd_chunks``, the specification the
  kernel's ``TcBand::chunks`` follows on the query side) covers every valid
  (query, key) pair of the band exactly once across every split count, and no
  tile walks a chunk that holds none of its pairs: bands from 0 to past T,
  Tq ≠ Tk, key bounds inside a chunk, past the ends and crossed (lo > hi),
  query offsets of either sign, T ragged against the tiles and the chunks.
* The plan at the main path's shapes, for an H100's resident slots.
* Kernel 7 is kernel 5's arithmetic under the band: 3xTF32 products whose
  float32 accumulation rounds toward zero, a fresh accumulator per two k-steps
  of the scores and per chunk of P·V, the online softmax in log2 units, each
  tile's walk split and the splits merged in split order as
  ``fwd_merge_kernel`` does.  A numpy emulation of that holds out and lse to
  the card tests' 3e-5 and 1e-5 against the plain float32 version and to 2e-5
  and 1e-5 against the JAX package's Pallas kernel in interpret mode, with key
  bounds and a query offset; one TF32 product does not hold them.
* Rows that die inside a live tile (a neighbour sees a key, the row none) and
  splits that walk no chunk give out 0 and lse 0 exactly, never NaN.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvml_goalnet_tpu.ops.pallas import flash_attention as JF
from cvml_goalnet_tpu_torch.ops.cuda import flash_attention as FA
from test_torch_attention_kernel5 import LN2, LOG2E, LSE_TOL, OUT_TOL, _mma_chain, _t
from test_torch_attention_kernel8 import BAND_CASES, _valid

JAX_OUT_TOL = 2e-5   # tests/test_flash_attention.py's tolerance on out against the Pallas kernel
# Resident blocks of kernel 7's tile kernel on an H100 SXM: 132 SMs × the CUDA occupancy calculator's blocks per
# SM, by head width.  The band test takes kernel 5's 155 registers at d = 32 to 180, past the 170 of three blocks
# a SM, so d = 32 keeps two where kernel 5 keeps three.  A card test holds them to the card.
H100_LOCAL_FWD_SLOTS = {32: 264, 64: 264, 128: 264}


def _walks(ranges, s):
    """(tile index, chunk) of every split of ``s`` of every tile, in walk order."""
    for tile, (first, end) in enumerate(ranges):
        for a, b in FA.split_ranges(end - first, s):
            for c in range(first + a, first + b):
                yield tile, c


# --- (a) the walk and the plan -------------------------------------------------------------------


@pytest.mark.parametrize("case", BAND_CASES, ids=lambda c: "-".join(map(str, c)))
def test_local_fwd_walk_covers_every_valid_pair_once(case):
    h, tq, tk, d, window, lo, hi, q_offset = case
    stream = FA.FWD_STREAM[d]
    lo_i, hi_i = (0 if lo is None else lo), (tk if hi is None else hi)
    valid = _valid(tq, tk, window, lo, hi, q_offset)
    ranges = FA.local_fwd_chunks(tq, tk, window, lo_i, hi_i, q_offset, stream)
    assert len(ranges) == -(-tq // FA.FWD_TILE)
    plan = FA.local_fwd_plan(h, tq, tk, d, window, lo_i, hi_i, q_offset, H100_LOCAL_FWD_SLOTS[d])
    assert (plan.tile, plan.stream) == (FA.FWD_TILE, stream) and 1 <= plan.splits <= FA.MAX_SPLIT
    if h * len(ranges) >= H100_LOCAL_FWD_SLOTS[d]:
        assert plan.splits == 1      # the tiles alone fill the card
    for tile, (first, end) in enumerate(ranges):   # no tile walks a chunk that meets none of its band
        rows = slice(tile * FA.FWD_TILE, (tile + 1) * FA.FWD_TILE)
        for c in range(first, end):
            assert valid[rows, c * stream : (c + 1) * stream].any(), f"tile {tile} walks chunk {c}, outside its band"
    for s in sorted({plan.splits, *range(1, FA.MAX_SPLIT + 1)}):
        count = np.zeros((tq, tk), dtype=np.int16)
        for tile, c in _walks(ranges, s):
            count[tile * FA.FWD_TILE : (tile + 1) * FA.FWD_TILE, c * stream : (c + 1) * stream] += 1
        assert (count[valid] == 1).all(), f"{s} splits: a valid pair walked {count[valid].max()} or 0 times"
        assert count.max() <= 1


def test_local_fwd_plan_at_the_main_paths_shapes():
    # one head of 5400 frames at d = 128: 85 tiles, each walking at most 66 chunks of 32, on 264 slots → 3 splits
    assert FA.local_fwd_plan(1, 5400, 5400, 128, 1024, 0, 5400, 0, H100_LOCAL_FWD_SLOTS[128]) == FA.FwdPlan(64, 32, 3)
    # two heads of 64: 170 tiles of at most 33 chunks of 64, on 264 slots → 3 splits
    assert FA.local_fwd_plan(2, 5400, 5400, 64, 1024, 0, 5400, 0, H100_LOCAL_FWD_SLOTS[64]) == FA.FwdPlan(64, 64, 3)
    # long timelines fill the card unsplit
    assert FA.local_fwd_plan(1, 32768, 32768, 128, 1024, 0, 32768, 0, H100_LOCAL_FWD_SLOTS[128]).splits == 1
    assert FA.local_fwd_plan(1, 135000, 135000, 128, 1024, 0, 135000, 0, H100_LOCAL_FWD_SLOTS[128]).splits == 1
    ranges = FA.local_fwd_chunks(5400, 5400, 1024, 0, 5400, 0, 32)
    assert max(e - f for f, e in ranges) == 66      # kernel 5 walks 169 at this T
    walked = 64 * 32 * sum(e - f for f, e in ranges)
    pairs = int(_valid(5400, 5400, 1024, None, None, 0).sum())
    assert 0.96 < pairs / walked < 0.97            # about 97 % of the walked entries are in the band
    # no valid key anywhere: every tile walks nothing, unsplit
    assert FA.local_fwd_plan(1, 5400, 5400, 128, 16, 150, 40, 0, H100_LOCAL_FWD_SLOTS[128]).splits == 1
    # a card with twice the slots splits more
    assert FA.local_fwd_plan(1, 5400, 5400, 128, 1024, 0, 5400, 0, 528).splits > 3


def test_planned_wrapper_takes_cuda_tensors_only():
    q = torch.zeros((1, 8, 32))
    with pytest.raises(ValueError, match="CUDA tensors"):
        FA.flash_local_fwd_planned(q, q, q, 0.1, 4, 1)


# --- (b) 3xTF32 under the band, split and merged, emulated ---------------------------------------


def _tile_split(q, k, v, r0, chunks, scale, limits, stream, three, steps_per_fresh=2):
    """(o, m, l) of one split of the 64-row tile at r0, as kernel 7 leaves them: the split's key chunks
    (zero-filled from kv_end on), the band's pairs, o unnormalised, m the row max in log2 units (-inf where
    the split saw no valid key of the row), l the sum of its weights."""
    k_lo, kv_end, d_lo, d_hi = limits
    rows = q[r0 : r0 + FA.FWD_TILE]
    n_rows, d = rows.shape
    o = np.zeros((n_rows, d), np.float32)
    m = np.full(n_rows, -np.inf, np.float32)
    l = np.zeros(n_rows, np.float32)
    sl2e = np.float32(scale) * LOG2E
    query = np.arange(r0, r0 + n_rows)[:, None]
    for c in chunks:
        key = np.arange(c * stream, (c + 1) * stream)
        inside = key < kv_end
        kc, vc = np.zeros((stream, d), np.float32), np.zeros((stream, d), np.float32)
        kc[inside], vc[inside] = k[key[inside]], v[key[inside]]
        s = np.zeros((n_rows, stream), np.float32)
        for g0 in range(0, d // 8, steps_per_fresh):
            ks = range(g0, min(d // 8, g0 + steps_per_fresh))
            s = s + _mma_chain(np.zeros((n_rows, stream), np.float32), [rows[:, 8 * i : 8 * i + 8] for i in ks],
                               [kc[:, 8 * i : 8 * i + 8].T for i in ks], three)
        diff = key[None, :] - query
        valid = inside[None, :] & (key[None, :] >= k_lo) & (diff >= d_lo) & (diff <= d_hi)
        s = np.where(valid, s * sl2e, np.float32(-np.inf))
        m_new = np.maximum(m, s.max(1))
        base = np.where(np.isinf(m_new), np.float32(0), m_new)   # a row with no valid key yet: weights 0, not NaN
        alpha = np.exp2(m - base).astype(np.float32)
        p = np.exp2(s - base[:, None]).astype(np.float32)
        l = l * alpha + p.sum(1, dtype=np.float32)
        m = m_new
        fresh = _mma_chain(np.zeros((n_rows, d), np.float32), [p[:, 8 * j : 8 * j + 8] for j in range(stream // 8)],
                           [vc[8 * j : 8 * j + 8] for j in range(stream // 8)], three)
        o = o * alpha[:, None] + fresh
    return o, m, l


def _finish(o, m, l):
    """The unsplit store: out = o / l and lse = m·ln 2 + log l, a dead row (m = -inf) out 0 and lse 0."""
    dead = np.isinf(m)
    out = np.where(dead[:, None], np.float32(0), o / np.where(dead, np.float32(1), l)[:, None])
    return out, np.where(dead, np.float32(0), m * LN2 + np.log(np.where(dead, np.float32(1), l)))


def _merge(parts):
    """fwd_merge_kernel: out = Σ 2^(m_i − m)·o_i / Σ 2^(m_i − m)·l_i in split order, a split that saw no valid
    key of the row weighing exactly 0, lse = m·ln 2 + log l; a row no split saw a valid key of is dead."""
    mx = np.max([m for _, m, _ in parts], axis=0)
    dead = np.isinf(mx)
    acc, l = np.zeros_like(parts[0][0]), np.zeros_like(mx)
    for o, m, li in parts:
        w = np.where(np.isinf(m), np.float32(0), np.exp2(m - np.where(dead, np.float32(0), mx))).astype(np.float32)
        acc, l = acc + w[:, None] * o, l + w * li
    return _finish(acc, np.where(dead, -np.inf, mx).astype(np.float32), l)


def _emulate_local_fwd(q, k, v, scale, window, lo, hi, q_offset, d, splits, three=True):
    """One head's out and lse as kernel 7 forms them: each 64-row tile's walk (local_fwd_chunks) cut in
    ``splits``, the splits merged (or, unsplit, stored directly)."""
    tq, tk = q.shape[0], k.shape[0]
    stream = FA.FWD_STREAM[d]
    k_lo, k_hi, d_lo, d_hi = FA.band_limits(tq, tk, window, lo, hi, q_offset)
    out, lse = np.zeros(q.shape, np.float32), np.zeros(tq, np.float32)
    for tile, (first, end) in enumerate(FA.local_fwd_chunks(tq, tk, window, lo, hi, q_offset, stream)):
        r0 = tile * FA.FWD_TILE
        parts = [_tile_split(q, k, v, r0, range(first + a, first + b), scale, (k_lo, k_hi, d_lo, d_hi), stream, three)
                 for a, b in FA.split_ranges(end - first, splits)]
        out[r0 : r0 + FA.FWD_TILE], lse[r0 : r0 + FA.FWD_TILE] = _finish(*parts[0]) if splits == 1 else _merge(parts)
    return out, lse


def _band_inputs(tq, tk, d, seed):
    q, k, v = (x.numpy()[0] for x in _t(seed, (1, tq, d), (1, tk, d), (1, tk, d)))
    return q, k, v, d ** -0.5


def _shares(got, want, out_tol=OUT_TOL):
    (out, lse), (want_out, want_lse) = got, want
    return float(np.abs(out - want_out).max() / out_tol), float(np.abs(lse - want_lse).max() / LSE_TOL)


def _plain(q, k, v, scale, window, lo, hi, q_offset):
    out, lse = FA.flash_local_fwd_plain(*(torch.as_tensor(x[None]) for x in (q, k, v)), scale, window, lo, hi, q_offset)
    return out[0].numpy(), lse[0].numpy()


# (tq, tk, d, window, lo, hi, q_offset): the main path's shape of band cut to T = 600, and Tq ≠ Tk with bounds
# inside a chunk and a negative offset
EMULATED = [(600, 600, 128, 100, 0, 600, 0), (300, 420, 64, 37, 5, 400, -20)]


@pytest.mark.parametrize("splits", [1, 3, 8])
@pytest.mark.parametrize("case", EMULATED, ids=lambda c: "-".join(map(str, c)))
def test_three_tf32_products_hold_the_tolerance(case, splits):
    tq, tk, d, window, lo, hi, q_offset = case
    q, k, v, scale = _band_inputs(tq, tk, d, 300)
    got = _emulate_local_fwd(q, k, v, scale, window, lo, hi, q_offset, d, splits)
    assert max(_shares(got, _plain(q, k, v, scale, window, lo, hi, q_offset))) <= 0.5


def test_one_tf32_product_breaks_the_tolerance():
    tq, tk, d, window, lo, hi, q_offset = EMULATED[0]
    q, k, v, scale = _band_inputs(tq, tk, d, 300)
    got = _emulate_local_fwd(q, k, v, scale, window, lo, hi, q_offset, d, 3, three=False)
    assert max(_shares(got, _plain(q, k, v, scale, window, lo, hi, q_offset))) > 1.0


@pytest.mark.parametrize("splits", [1, 3])
def test_emulated_kernel_matches_the_pallas_kernel(splits):
    """The emulation with key bounds and a query offset against ``_flash_local_fwd`` in interpret mode."""
    w, lo, hi = 20, 5, 230
    q, k, v, scale = _band_inputs(200, 240, 64, 310)
    got = _emulate_local_fwd(q, k, v, scale, w, lo, hi, w, 64, splits)
    o_j, lse_j = JF._flash_local_fwd(*(jnp.asarray(x[None]) for x in (q, k, v)), scale, w, 128, True,
                                     jnp.int32(lo), jnp.int32(hi), w)
    # the Pallas kernel's lse is (H, Tq padded, 128 lanes)
    want = np.asarray(o_j)[0], np.asarray(lse_j)[0, : q.shape[0], 0]
    assert max(_shares(got, want, JAX_OUT_TOL)) <= 1.0


@pytest.mark.parametrize("splits", range(1, FA.MAX_SPLIT + 1))
def test_rows_dead_inside_a_live_tile_give_zeros(splits):
    # keys valid in [40, 60) with W = 4: rows 36–63 of tile 0 see keys, rows 0–35 and 64–127 none; tile 0 walks
    # one chunk of 64, so every split past the first walks nothing and must weigh exactly 0
    tq, tk, d, window, lo, hi = 128, 128, 32, 4, 40, 60
    q, k, v, scale = _band_inputs(tq, tk, d, 320)
    assert FA.local_fwd_chunks(tq, tk, window, lo, hi, 0, FA.FWD_STREAM[d]) == [(0, 1), (0, 0)]
    out, lse = _emulate_local_fwd(q, k, v, scale, window, lo, hi, 0, d, splits)
    assert np.isfinite(out).all() and np.isfinite(lse).all()
    dead = np.r_[0:36, 64:128]
    assert not out[dead].any() and not lse[dead].any()
    assert out[36:64].any(axis=1).all()
    assert max(_shares((out, lse), _plain(q, k, v, scale, window, lo, hi, 0))) <= 1.0
