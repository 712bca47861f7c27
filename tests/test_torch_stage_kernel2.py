"""PyTorch port: what the conv-pool stage's kernel (kernel 2, ``csrc/fused_stage.cu``) rests on, on the CPU.

* ``stage_plan`` tiles (N, H, W) → (N, H − 2, W − 2, Cout) so that every pooled
  position of every frame and every output channel falls in exactly one block,
  each block's conv tile carries the pool's halo and fits the kernel's M, and
  its shared memory fits a block; at the main path's shapes it fills the
  card's resident blocks, for an H100 SXM's 132 SMs and the blocks per SM that
  the CUDA occupancy calculator gives the three kernels there (2, 1, 1 for
  MI = 2, 3, 4; a card test holds the card to those values).
* The kernel computes in 3xTF32 on the tensor cores, and the MMA's float32
  accumulation rounds toward zero.  A numpy emulation of its arithmetic (K
  walked as 8 input channels × 9 taps per stage, TF32 rounding as ``cvt.rna``
  does it, the MMA reading the small half's top 19 bits, each MMA's sum
  rounded toward zero, a fresh accumulator per stage of 9 k-steps added to
  float32 totals, then bias, ReLU and the pool) holds the tolerance of the
  card tests, 1e-4·max|ref|, against the plain float32 version and against
  the JAX package's Pallas kernel in interpret mode, where one TF32 product
  does not.  Shares of that tolerance (worst |err| / (1e-4·max|ref|)), on
  these inputs, at (4, 11, 11, 256 → 64) and (4, 13, 13, 64 → 64): the
  kernel's scheme 0.021 and 0.013 against the plain version (0.0096 and
  0.0075 against the Pallas kernel, which is itself 0.017 and 0.0080 from
  the plain version); a fresh accumulator per k-step 0.018 and 0.0085, per 4
  stages 0.037 and 0.030; one accumulator over all of K 0.23 and 0.052
  (inside this tolerance at these K, but 4–11× the kernel's error: the
  FP32-core kernel this design replaced was at 0.025 on an H100, so the
  fresh accumulators keep kernel 2 where it was); one TF32 product 2.92 and
  2.85.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvml_goalnet_tpu.ops.pallas.fused_stage import fused_conv_pool_stage as pallas_stage
from cvml_goalnet_tpu_torch.ops.cuda import fused_stage as S

H100_SMS, H100_REG_BLOCKS = 132, (2, 1, 1)   # blocks per SM of the kernels of M_TILES = (2, 3, 4) by registers
# (H, W, Cin, Cout) of conv1 and conv2 on the main path (configs/reference_parity.json: 40×40 frames)
CONV1, CONV2 = (13, 13, 64, 256), (11, 11, 256, 512)
PATH_N = (150, 300, 600, 1050, 5400)          # each video's frames, the batch of three, a match


def plan_of(n, h, w, cout):
    return S.stage_plan(n, h, w, cout, H100_SMS, H100_REG_BLOCKS)


def blocks_of(plan, n, h, w, cout):
    """(frames, pooled rows, pooled cols, channels) of each block, decoded from its index as the kernel does
    (channel slice fastest, then tile column, tile row, frame group)."""
    tiles_y, tiles_x = math.ceil((h - 2) / plan.rows), math.ceil((w - 2) / plan.cols)
    co_tiles = math.ceil(cout / S.BLOCK_N)
    for index in range(S.block_count(plan, n, h, w, cout)):
        b, ct = divmod(index, co_tiles)
        b, tx = divmod(b, tiles_x)
        group, ty = divmod(b, tiles_y)
        f0, oy0, ox0, co0 = group * plan.frames, ty * plan.rows, tx * plan.cols, ct * S.BLOCK_N
        yield (slice(f0, min(n, f0 + plan.frames)), slice(oy0, min(h - 2, oy0 + plan.rows)),
               slice(ox0, min(w - 2, ox0 + plan.cols)), slice(co0, min(cout, co0 + S.BLOCK_N)))


# --- (a) the tile plan --------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 150, 1050, 5400])
@pytest.mark.parametrize("h,w,cout", [CONV1[:2] + CONV1[3:], CONV2[:2] + CONV2[3:], (21, 21, 256), (19, 19, 512),
                                      (3, 40, 16), (40, 3, 16), (17, 17, 70), (3, 200, 8), (3, 3, 5)])
def test_stage_plan_covers_every_output_once(n, h, w, cout):
    plan = plan_of(n, h, w, cout)
    assert plan.m_tiles in S.M_TILES and plan.stages in S.STAGE_COUNTS
    assert 1 <= plan.rows <= h - 2 and 1 <= plan.cols <= w - 2 and 1 <= plan.frames <= n
    conv, inputs = S.block_positions(plan)
    assert conv == plan.frames * (plan.rows + 2) * (plan.cols + 2) <= 64 * plan.m_tiles   # the pool's halo fits M
    assert inputs == plan.frames * (plan.rows + 4) * (plan.cols + 4)                       # and the conv's
    assert S.smem_bytes(plan) <= S.BLOCK_SMEM
    assert S.blocks_per_sm(plan, dict(zip(S.M_TILES, H100_REG_BLOCKS))) >= 1
    covered = np.zeros((n, h - 2, w - 2, cout), np.int32)
    for f, oy, ox, co in blocks_of(plan, n, h, w, cout):
        covered[f, oy, ox, co] += 1
    assert (covered == 1).all()


@pytest.mark.parametrize("n", PATH_N)
@pytest.mark.parametrize("shape", [CONV1, CONV2])
def test_stage_plan_fills_the_card(n, shape):
    """Blocks over the resident slots of the rounds they take: at least 90 % of every round is busy."""
    h, w, _, cout = shape
    plan = plan_of(n, h, w, cout)
    blocks = S.block_count(plan, n, h, w, cout)
    slots = H100_SMS * S.blocks_per_sm(plan, dict(zip(S.M_TILES, H100_REG_BLOCKS)))
    assert blocks / (math.ceil(blocks / slots) * slots) >= 0.9


def test_stage_plan_at_the_paths_batches():
    # conv1: one 13×13 frame (169 conv positions) in MI = 3's 192; conv2: two 11×11 frames (242) in MI = 4's 256
    for n in (1050, 5400):
        assert plan_of(n, *CONV1[:2], CONV1[3]) == S.StagePlan(1, 11, 11, 3, 3)
        assert plan_of(n, *CONV2[:2], CONV2[3]) == S.StagePlan(2, 9, 9, 4, 3)
    # frame_size (64, 64): conv1 at 21×21 does not fit a block, so frames are cut into tiles with a halo
    tiled = plan_of(1050, 21, 21, 256)
    assert (tiled.rows, tiled.cols) != (19, 19) and tiled.frames == 1


@pytest.mark.parametrize("reg_blocks", [H100_REG_BLOCKS, (4, 2, 2), (1, 1, 1)])
@pytest.mark.parametrize("shape", [CONV1, CONV2, (21, 21, 64, 256), (3, 40, 8, 16)])
def test_stage_plan_takes_the_deepest_ring_that_costs_no_resident_block(reg_blocks, shape):
    h, w, _, cout = shape
    regs = dict(zip(S.M_TILES, reg_blocks))
    plan = S.stage_plan(1050, h, w, cout, H100_SMS, reg_blocks)
    rings = [plan._replace(stages=s) for s in S.STAGE_COUNTS if S.smem_bytes(plan._replace(stages=s)) <= S.BLOCK_SMEM]
    best = max(S.blocks_per_sm(p, regs) for p in rings)
    assert S.blocks_per_sm(plan, regs) == best
    assert plan.stages == max(p.stages for p in rings if S.blocks_per_sm(p, regs) == best)


def test_shared_memory_limits_resident_blocks():
    plan = S.StagePlan(2, 9, 9, 4, 3)      # conv2's plan on the main path
    by_smem = S.SM_SMEM // (S.smem_bytes(plan) + S.SMEM_PER_BLOCK)
    assert by_smem < 8 and S.blocks_per_sm(plan, {4: 8}) == by_smem
    assert S.blocks_per_sm(plan, {4: 1}) == 1
    assert S.blocks_per_sm(plan._replace(stages=2), {4: 8}) >= by_smem


# --- (b) 3xTF32 with fresh accumulators, emulated ------------------------------------------------


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


K_STEPS_PER_STAGE = 9   # the kernel's stage: 8 input channels at each of the 9 taps, one fresh accumulator


def _emulate_stage(x, w, b, three: bool = True, steps_per_fresh: int = K_STEPS_PER_STAGE) -> np.ndarray:
    """The stage as the kernel's MMAs form it: k-steps of 8 input channels at one tap, stage by stage (chunk
    of 8 channels) and tap by tap within it; each MMA adds its 8 exact products to its accumulator and rounds
    toward zero; a fresh accumulator per ``steps_per_fresh`` k-steps, added to float32 totals in order; then
    the bias, ReLU and the 3×3 pool.  ``three``: small·big' + big·small' + big·big', else one TF32 product."""
    n, h, wd, cin = x.shape
    cout = w.shape[3]
    cinp = -(-cin // S.CHUNK) * S.CHUNK
    xp = np.zeros((n, h + 2, wd + 2, cinp), np.float32)
    xp[:, 1:-1, 1:-1, :cin] = x
    wp = np.zeros((3, 3, cinp, cout), np.float32)
    wp[:, :, :cin] = w
    total = np.zeros((n * h * wd, cout), np.float32)
    fresh = np.zeros_like(total)
    steps = [(c0, tap) for c0 in range(0, cinp, S.CHUNK) for tap in range(9)]
    for i, (c0, tap) in enumerate(steps):
        dy, dx = divmod(tap, 3)
        a = xp[:, dy:dy + h, dx:dx + wd, c0:c0 + S.CHUNK].reshape(-1, S.CHUNK)
        bw = wp[dy, dx, c0:c0 + S.CHUNK]
        ab, bb = _tf32(a), _tf32(bw)
        terms = [(_tf32_truncated(a - ab), bb), (ab, _tf32_truncated(bw - bb)), (ab, bb)] if three else [(ab, bb)]
        for p, q in terms:
            fresh = _round_toward_zero(fresh.astype(np.float64) + p.astype(np.float64) @ q.astype(np.float64))
        if (i + 1) % steps_per_fresh == 0 or i == len(steps) - 1:
            total += fresh
            fresh[:] = 0
    y = torch.from_numpy(np.maximum(total.reshape(n, h, wd, cout) + b, 0)).permute(0, 3, 1, 2)
    return torch.nn.functional.max_pool2d(y, 3, 1).permute(0, 2, 3, 1).numpy()


@pytest.fixture(scope="module", params=[(11, 256, 0.02), (13, 64, 0.05)], ids=["conv2", "conv1"])
def stage_case(request):
    """conv2's and conv1's widths (64 output channels) at chip_smoke.py's input scales, and the plain stage."""
    hh, cin, scale = request.param
    rng = np.random.default_rng(hh)
    x = rng.standard_normal((4, hh, hh, cin)).astype(np.float32)
    w = (rng.standard_normal((3, 3, cin, 64)) * scale).astype(np.float32)
    b = (rng.standard_normal((hh, hh, 64)) * 0.1).astype(np.float32)
    plain = S.fused_conv_pool_stage_plain(*(torch.from_numpy(a) for a in (x, w, b))).numpy()
    return x, w, b, plain


def _share(got, want) -> float:
    return float(np.max(np.abs(got - want)) / (1e-4 * np.max(np.abs(want))))


def test_three_tf32_products_with_fresh_accumulators_hold_the_tolerance(stage_case):
    x, w, b, plain = stage_case
    assert _share(_emulate_stage(x, w, b), plain) <= 0.05   # 0.021 and 0.013


def test_emulated_kernel_matches_the_pallas_kernel(stage_case):
    x, w, b, _ = stage_case
    want = np.asarray(pallas_stage(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), 4, True))
    assert _share(_emulate_stage(x, w, b), want) <= 0.05


def test_one_tf32_product_breaks_the_tolerance(stage_case):
    x, w, b, plain = stage_case
    assert _share(_emulate_stage(x, w, b, three=False), plain) > 1.0   # 2.92 and 2.85


def test_one_accumulator_over_all_of_k_drifts(stage_case):
    """Round-toward-zero sums over all of K in one accumulator: 4–11× the kernel's error (0.23 and 0.052 of the
    tolerance against 0.021 and 0.013)."""
    x, w, b, plain = stage_case
    kernel = _share(_emulate_stage(x, w, b), plain)
    assert _share(_emulate_stage(x, w, b, steps_per_fresh=10**9), plain) > 3 * kernel


def test_ragged_channels_emulate_as_zero_padding():
    """Cin that is not a multiple of 8 walks zero-padded channels (the kernel's zero-filled copies)."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 7, 3)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 3, 70)) * 0.05).astype(np.float32)
    b = (rng.standard_normal((5, 7, 70)) * 0.1).astype(np.float32)
    plain = S.fused_conv_pool_stage_plain(*(torch.from_numpy(a) for a in (x, w, b))).numpy()
    assert _share(_emulate_stage(x, w, b), plain) <= 0.05


def test_round_toward_zero_never_rounds_up():
    v = np.array([1.0 + 2.0 ** -30, -1.0 - 2.0 ** -30, 3.0, -0.0, 1e-3 * (1 + 2.0 ** -40)])
    got = _round_toward_zero(v)
    assert np.all(np.abs(got.astype(np.float64)) <= np.abs(v))
    assert got[0] == np.float32(1.0) and got[1] == np.float32(-1.0) and got[2] == np.float32(3.0)


# --- (c) the wrapper on the CPU -------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(2, 21, 21, 8, 16), (1, 3, 40, 5, 70), (0, 5, 5, 3, 4)])
def test_cpu_tensors_take_the_plain_version(shape):
    n, h, w, c, co = shape
    rng = np.random.default_rng(n + h)
    x, wt, b = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)) for s in
                ((n, h, w, c), (3, 3, c, co), (h, w, co)))
    before = S.fused_conv_pool_stage.launches
    got = S.fused_conv_pool_stage(x, wt, b)
    assert S.fused_conv_pool_stage.launches == before   # the plain version launches nothing
    assert torch.equal(got, S.fused_conv_pool_stage_plain(x, wt, b)) and got.shape == (n, h - 2, w - 2, co)


def test_planned_entry_refuses_cpu_tensors():
    x = torch.zeros((1, 5, 5, 4))
    with pytest.raises(ValueError, match="CUDA tensors only"):
        S.fused_conv_pool_stage_planned(x, torch.zeros((3, 3, 4, 8)), torch.zeros((5, 5, 8)),
                                        S.StagePlan(1, 3, 3, 2, 2))
