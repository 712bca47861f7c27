"""PyTorch port: what the two low-precision forms on ``wgmma`` rest on, on the CPU.

* 3-bf16 (``csrc/matmul.cu``, ``head_bf16_wgmma_kernel``): ``head_bf16_plan``
  splits K into whole 64-deep steps that cover every K index once, its TMA
  boxes and row strides keep to TMA's 16-byte rules after the wrapper's
  padding, and at the main paths' shapes it takes at most two waves of an
  H100's 132 SMs with a ring that fits a block's 227 KB.
* 2-int8 (``csrc/fused_stage_lowp.cu``, ``conv_pool_int8_kernel``):
  ``int8_stage_plan`` fits a block's shared memory for conv1, conv2 and
  larger frames, and its blocks cover every pooled output and channel once.
* The passes around the int8 conv: the weight pack's plain version (the
  kernel's arithmetic: the largest bit pattern of |w| per channel, the scale,
  the values into the padded layout) equals ``ops/quant.py``'s
  ``quantize_weights_per_channel`` permuted and padded, and the amax pass's
  plain version equals ``quant.act_scale``, both bit for bit; both also equal
  the JAX package's ``ops/quant.py`` on seeded numpy inputs.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvml_goalnet_tpu.ops import quant as JQ
from cvml_goalnet_tpu_torch.ops import quant as TQ
from cvml_goalnet_tpu_torch.ops.cuda import fused_stage as FS
from cvml_goalnet_tpu_torch.ops.cuda import matmul as MM

H100_SMS = 132              # an H100 SXM's SMs
BLOCK_SMEM = 232_448        # the shared memory one block may take on Hopper (227 KB)
HEAD_K, HEAD_N = 41472, 512  # the visual head of configs/tpu_serving.json


# --- 3-bf16: the split plan and the TMA boxes -----------------------------------------------------

@pytest.mark.parametrize("m,k,n", [(1, HEAD_K, HEAD_N), (64, HEAD_K, HEAD_N), (65, HEAD_K, HEAD_N),
                                   (150, HEAD_K, HEAD_N), (1050, HEAD_K, HEAD_N), (5400, HEAD_K, HEAD_N),
                                   (65, 1000, 512), (37, 1000, 60), (5, 24, 8)])
def test_head_bf16_plan_covers_k_once(m, k, n):
    k8 = -(-k // 8) * 8   # the wrapper's padding
    splits, k_chunk = MM.head_bf16_plan(m, k8, n, H100_SMS)
    assert k_chunk % MM.BF16_BLOCK_K == 0
    covered = np.zeros(k8, dtype=np.int64)
    for z in range(splits):
        covered[z * k_chunk:min(k8, (z + 1) * k_chunk)] += 1
        assert z * k_chunk < k8, "an empty split"
    assert (covered == 1).all()


@pytest.mark.parametrize("k,n", [(HEAD_K, HEAD_N), (1000, 60), (24, 8), (1001, 13)])
def test_head_bf16_boxes_keep_tma_alignment(k, n):
    k8, n8 = -(-k // 8) * 8, -(-n // 8) * 8   # the wrapper pads K and N to multiples of 8
    assert (2 * k8) % 16 == 0 and (2 * n8) % 16 == 0   # bf16 rows of x (K) and w (N): 16-byte strides
    # every box is one 128-byte swizzle span wide: x boxes 64 of K, w boxes 64 columns, bf16
    assert 2 * MM.BF16_BLOCK_K == 128
    assert MM.BF16_BLOCK_N % 64 == 0   # a block's columns are whole w boxes
    # the ring's stages start on 1024-byte boundaries (the swizzle atom), so each box does
    assert MM.BF16_STAGE_BYTES % 1024 == 0 and (2 * MM.BF16_BLOCK_M * MM.BF16_BLOCK_K) % 1024 == 0


def test_head_bf16_aligned_copies_only_what_tma_cannot_take():
    x = torch.zeros(65 * 64 + 1, dtype=torch.bfloat16)
    view = x[1:].view(65, 64)
    assert view.data_ptr() % 16 != 0
    fixed = MM._aligned(view, 65, 64)
    assert fixed.data_ptr() % 16 == 0 and torch.equal(fixed, view)
    whole = torch.zeros((65, 64), dtype=torch.bfloat16)
    assert MM._aligned(whole, 65, 64) is whole


@pytest.mark.parametrize("m,plan", [(1050, MM.HeadPlan(7, 5952)), (5400, MM.HeadPlan(3, 13824))])
def test_head_bf16_plan_at_the_paths_shapes(m, plan):
    got = MM.head_bf16_plan(m, HEAD_K, HEAD_N, H100_SMS)
    assert got == plan
    blocks = math.ceil(m / MM.BF16_BLOCK_M) * math.ceil(HEAD_N / MM.BF16_BLOCK_N) * got.splits
    assert blocks <= 2 * H100_SMS     # one block an SM: at most two waves
    assert MM.BF16_SMEM <= BLOCK_SMEM   # the ring, its barriers and the alignment slack
    assert MM.BF16_STAGES * MM.BF16_STAGE_BYTES == 4 * 48 * 1024


# --- 2-int8: the stage plan ------------------------------------------------------------------------

INT8_SHAPES = [(1050, 13, 64, 256), (1050, 11, 256, 512), (5400, 13, 64, 256), (5400, 11, 256, 512),
               (64, 13, 64, 256), (1, 13, 64, 256), (3, 21, 32, 64), (2, 64, 256, 512), (2, 64, 64, 256),
               (5, 9, 20, 70), (2, 3, 16, 64)]


@pytest.mark.parametrize("n,hh,cin,cout", INT8_SHAPES)
def test_int8_plan_fits_a_block(n, hh, cin, cout):
    plan = FS.int8_stage_plan(n, hh, hh, cin, cout, H100_SMS)
    assert (plan.m_tiles, plan.block_n) in FS.INT8_SHAPES
    m, _ = FS.block_positions(plan)
    assert m <= 128 * plan.m_tiles   # two warpgroups of m_tiles m64 tiles
    assert FS.int8_smem_bytes(plan, FS.int8_cin(cin)) <= BLOCK_SMEM


@pytest.mark.parametrize("n,hh,cin,cout", INT8_SHAPES)
def test_int8_plan_covers_every_output_once(n, hh, cin, cout):
    """The kernel's block decode (channel slice fastest, then the tile's column and row, then the frame group)
    over the launch's blocks takes every (frame group, tile row, tile column, channel slice) once, and those
    ranges cut the frames, the pooled rows and columns and the channels without gap or overlap: every pooled
    output and channel is written exactly once."""
    plan = FS.int8_stage_plan(n, hh, hh, cin, cout, H100_SMS)
    oh = hh - 2
    groups, tiles_y, tiles_x = math.ceil(n / plan.frames), math.ceil(oh / plan.rows), math.ceil(oh / plan.cols)
    co_tiles = math.ceil(cout / plan.block_n)
    blocks = FS.int8_block_count(plan, n, hh, hh, cout)
    assert blocks == groups * tiles_y * tiles_x * co_tiles
    seen = set()
    for blk in range(blocks):
        ct, b = blk % co_tiles, blk // co_tiles
        tx, b = b % tiles_x, b // tiles_x
        ty, group = b % tiles_y, b // tiles_y
        seen.add((group, ty, tx, ct))
    assert len(seen) == blocks and max(s[0] for s in seen) == groups - 1
    for extent, step, count in ((n, plan.frames, groups), (oh, plan.rows, tiles_y), (oh, plan.cols, tiles_x),
                                (cout, plan.block_n, co_tiles)):
        hits = np.zeros(extent, dtype=np.int64)
        for i in range(count):
            hits[i * step:(i + 1) * step] += 1
        assert (hits == 1).all()


def test_int8_plan_at_the_paths_shapes():
    """conv1 takes 3 frames of 169 conv positions on 4 m64 tiles a warpgroup at 64 channels (507 of 512 rows),
    conv2 2 frames of 121 on 2 at 128 channels (242 of 256)."""
    assert FS.int8_stage_plan(1050, 13, 13, 64, 256, H100_SMS) == FS.Int8Plan(3, 11, 11, 4, 64)
    assert FS.int8_stage_plan(1050, 11, 11, 256, 512, H100_SMS) == FS.Int8Plan(2, 9, 9, 2, 128)


def test_int8_workspace_holds_every_part():
    n, hh, cin, cout = 5, 9, 20, 70
    cin_p = FS.int8_cin(cin)
    assert cin_p == 64
    parts = [cout * 9 * cin_p, 4 * cout, n * hh * hh * cin_p]
    assert FS.int8_workspace_bytes(n, hh, hh, cin, cout) == sum(-(-p // 256) * 256 for p in parts) + 16


# --- the passes around the int8 conv ---------------------------------------------------------------

def _weights(seed, cin, cout, scale=0.05):
    w = np.random.default_rng(seed).standard_normal((3, 3, cin, cout)).astype(np.float32) * scale
    w[..., 0] = 0.0   # an all-zero channel takes the 1e-12 floor
    return w


@pytest.mark.parametrize("cin,cout", [(64, 256), (256, 512), (20, 70), (16, 64)])
def test_weight_pack_plain_equals_quant_permuted_and_padded(cin, cout):
    w = torch.from_numpy(_weights(cin + cout, cin, cout))
    wq, s = FS.pack_weights_int8_plain(w)
    q_ref, s_ref = TQ.quantize_weights_per_channel(w, axis=3)
    want = torch.zeros((cout, 3, 3, FS.int8_cin(cin)), dtype=torch.int8)
    want[..., :cin] = q_ref.permute(3, 0, 1, 2)
    assert wq.dtype == torch.int8 and torch.equal(wq, want)
    assert s.dtype == torch.float32 and torch.equal(s, s_ref.reshape(-1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("scale", [1.0, 1e-3, 0.0])
def test_amax_plain_equals_act_scale(dtype, scale):
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((4, 11, 11, 256)).astype(np.float32) * scale)
    x = x.to(dtype)
    got = FS.act_scale_int8_plain(x)
    assert got.dtype == torch.float32 and got.shape == ()
    assert torch.equal(got, TQ.act_scale(x))


@pytest.mark.parametrize("cin,cout", [(64, 256), (20, 70)])
def test_weight_pack_plain_matches_jax(cin, cout):
    w = _weights(100 + cin, cin, cout)
    q_j, s_j = JQ.quantize_weights_per_channel(jnp.asarray(w), axis=3)
    wq, s = FS.pack_weights_int8_plain(torch.from_numpy(w))
    np.testing.assert_array_equal(wq[..., :cin].permute(1, 2, 3, 0).numpy(), np.asarray(q_j))
    assert not wq[..., cin:].any()
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_j).reshape(-1))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_amax_plain_matches_jax(dtype):
    x = np.maximum(np.random.default_rng(5).standard_normal((6, 13, 13, 64)).astype(np.float32), 0) * 3.0
    xj = jnp.asarray(x, dtype=jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    _, s_j = JQ.quantize_act_per_tensor(xj)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(getattr(torch, dtype))
    np.testing.assert_array_equal(FS.act_scale_int8_plain(xt).numpy(), np.asarray(s_j))


def test_amax_scale_divides_rather_than_multiplies():
    """The scale is the correctly rounded quotient amax / 127 (as JAX and the CPU give it), not the product with a
    rounded 1 / 127 (what PyTorch's CUDA division by a Python scalar computes): on these amax values the two
    differ, and the scale is the quotient."""
    amax = np.array([3.1848085, 2.7073061, 1.5512094], dtype=np.float32)
    quotient = amax / np.float32(127)
    product = amax * (np.float32(1) / np.float32(127))
    assert (quotient != product).all()
    np.testing.assert_array_equal(TQ.amax_scale(torch.from_numpy(amax)).numpy(), quotient)
