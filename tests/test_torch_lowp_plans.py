"""PyTorch port: what the low-precision forms on ``wgmma`` rest on, on the CPU.

* 3-bf16 (``csrc/matmul.cu``, ``head_bf16_wgmma_kernel``): ``head_bf16_plan``
  splits K into whole 64-deep steps that cover every K index once, its TMA
  boxes and row strides keep to TMA's 16-byte rules after the wrapper's
  padding, and at the main paths' shapes it takes at most two waves of an
  H100's 132 SMs with a ring that fits a block's 227 KB.
* 2-int8 (``csrc/fused_stage_lowp.cu``, ``conv_pool_wgmma_kernel<Int8Form>``):
  ``int8_stage_plan`` fits a block's shared memory for conv1, conv2 and
  larger frames, and its blocks cover every pooled output and channel once.
* 2-bf16 (the same kernel template, ``Bf16Form``): ``bf16_stage_plan`` fits a
  block's shared memory (its sum restated from the C++), covers every output
  once, picks conv1's and conv2's tiles at the path's N, and its TMA boxes
  keep to their taps and to TMA's 16-byte rules; the wrapper refuses what the
  kernel cannot take with a ``ValueError`` before any build or launch.
* 4-bf16 (``csrc/fused_mlp.cu``, ``fused_mlp_bf16_kernel``): ``bf16_mlp_plan``
  at M = 1050 on 132 SMs, the CTAs of a cluster covering every 64-column tile
  once, the shared-memory sum and the activation panels' swizzled layout, and
  the wrapper's refusals before any launch.
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
from cvml_goalnet_tpu_torch.ops.cuda import fused_mlp as M
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


# --- 2-bf16: the stage plan, its shared memory and its TMA boxes ---------------------------------------------

def _wg_smem_cpp(ring, bias_tile, bn, kb, frames, rows, cols, row_bytes):
    """csrc/fused_stage_lowp.cu::wg_smem, line by line (bias_tile: 1 the int8 form's staged tile, 2 the bf16
    form's TMA boxes)."""
    stages = ring // (bn * 64)
    per_frame = (rows + 2) * (cols + 2)
    p = frames * (rows + 4) * (cols + 4)
    bufs = 1 if row_bytes // kb < 2 else 2
    conv = 4 * frames * per_frame * (bn + 4)
    input_buf = (kb * p + 1023) // 1024 * 1024
    rings = ring + bufs * input_buf
    body = (max(rings, conv) + 15) // 16 * 16
    bias_box = (per_frame * 128 + 1023) // 1024 * 1024
    if bias_tile == 2:
        bias = (body + 1023) // 1024 * 1024
        scales = bias + bn // 64 * bias_box
    else:
        bias = body
        scales = bias + per_frame * (4 * bn + 16)
    barriers = scales + (4 * bn if bias_tile == 1 else 0)
    return 1024 + barriers + (2 * stages + 5) * 8


@pytest.mark.parametrize("n,hh,cin,cout", INT8_SHAPES)
def test_bf16_plan_fits_a_block_and_mirrors_the_kernels_layout(n, hh, cin, cout):
    plan = FS.bf16_stage_plan(n, hh, hh, cin, cout, H100_SMS)
    assert (plan.m_tiles, plan.block_n) in FS.WGMMA_SHAPES
    m, _ = FS.block_positions(plan)
    assert m <= 128 * plan.m_tiles
    cin_p = FS.bf16_cin(cin)
    kb = 128 if plan.m_tiles == 2 else 64   # the C entry's stage: 64 or 32 channels
    got = FS.bf16_smem_bytes(plan, cin_p)
    assert got == _wg_smem_cpp(FS.BF16_RING_BYTES, 2, plan.block_n, kb, plan.frames, plan.rows, plan.cols, 2 * cin_p)
    assert got <= BLOCK_SMEM
    int8 = FS.int8_stage_plan(n, hh, hh, cin, cout, H100_SMS)
    kb8 = FS.wgmma_k_bytes(int8, FS.int8_cin(cin), 1)
    assert FS.int8_smem_bytes(int8, FS.int8_cin(cin)) == _wg_smem_cpp(
        FS.INT8_RING_BYTES, 1, int8.block_n, kb8, int8.frames, int8.rows, int8.cols, FS.int8_cin(cin))


@pytest.mark.parametrize("n,hh,cin,cout", INT8_SHAPES)
def test_bf16_plan_covers_every_output_once(n, hh, cin, cout):
    """The same block decode as the int8 form's (one kernel template): every (frame group, tile row, tile column,
    channel slice) once, and those ranges cut frames, pooled rows and columns and channels without gap or
    overlap."""
    plan = FS.bf16_stage_plan(n, hh, hh, cin, cout, H100_SMS)
    oh = hh - 2
    counts = (math.ceil(n / plan.frames), math.ceil(oh / plan.rows), math.ceil(oh / plan.cols),
              math.ceil(cout / plan.block_n))
    assert FS.int8_block_count(plan, n, hh, hh, cout) == math.prod(counts)
    for extent, step, count in zip((n, oh, oh, cout), (plan.frames, plan.rows, plan.cols, plan.block_n), counts):
        hits = np.zeros(extent, dtype=np.int64)
        for i in range(count):
            hits[i * step:(i + 1) * step] += 1
        assert (hits == 1).all()


def test_bf16_plan_at_the_paths_shapes():
    """conv1: 3 frames of 169 conv positions on 4 m64 tiles a warpgroup at 64 channels, 1400 blocks; conv2: 2
    frames of 121 on 2 at 128 channels, 2100 blocks (10.6 and 15.9 waves of one block an SM); both fit beside a
    96 KB weight ring."""
    conv1 = FS.bf16_stage_plan(1050, 13, 13, 64, 256, H100_SMS)
    conv2 = FS.bf16_stage_plan(1050, 11, 11, 256, 512, H100_SMS)
    assert conv1 == FS.Int8Plan(3, 11, 11, 4, 64) and conv2 == FS.Int8Plan(2, 9, 9, 2, 128)
    assert FS.int8_block_count(conv1, 1050, 13, 13, 256) == 1400
    assert FS.int8_block_count(conv2, 1050, 11, 11, 512) == 2100
    assert FS.bf16_smem_bytes(conv1, 64) == 210_344 and FS.bf16_smem_bytes(conv2, 256) == 220_392


@pytest.mark.parametrize("cin,cout", [(64, 256), (256, 512), (20, 70), (16, 64), (32, 64)])
def test_bf16_weight_and_input_boxes_keep_to_tma(cin, cout):
    """w as stored, (9 Cin, Cout) row-major: a box of KB / 2 rows of K never crosses into the next tap once Cin is
    a multiple of 64 (the path's 64 and 256 are; others are padded), rows are 16-byte multiples once Cout is a
    multiple of 8; the input's 4-D boxes are KB bytes of channels, the swizzle's span."""
    cin_p, c_cols = FS.bf16_cin(cin), -(-cout // 8) * 8
    assert cin_p % 64 == 0 and cin_p >= cin and (cin in (64, 256)) <= (cin_p == cin)
    for kb in (128, 64):
        assert cin_p % (kb // 2) == 0 and (2 * cin_p) % kb == 0
    assert (2 * c_cols) % 16 == 0 and (2 * cin_p) % 16 == 0


def test_stage_bf16_wrapper_refuses_before_any_launch(monkeypatch):
    """More positions than the kernel's 32-bit offsets reach raise ValueError before the library is built or
    anything launched (meta tensors stand in for the card's); any channel count has a plan, since the input tile
    arrives a chunk of channels at a time (8192 channels: 64 chunks through two 12.5 KB buffers)."""
    from cvml_goalnet_tpu_torch.ops.cuda import _build

    monkeypatch.setattr(FS, "stage_sms", lambda device: H100_SMS)
    monkeypatch.setattr(_build, "load", lambda *a, **k: pytest.fail("built or launched"))
    x = torch.empty((1 << 15, 256, 256, 64), dtype=torch.bfloat16, device="meta")
    w = torch.empty((3, 3, 64, 64), dtype=torch.bfloat16, device="meta")
    b = torch.empty((256, 256, 64), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="32-bit offsets"):
        FS.fused_conv_pool_stage_bf16(x, w, b)
    with pytest.raises(ValueError, match="do not match"):
        FS.fused_conv_pool_stage_bf16(x[:2, :8, :8], w, b)
    plan = FS.bf16_stage_plan(2, 8, 8, 8192, 64, H100_SMS)
    assert FS.bf16_smem_bytes(plan, 8192) <= BLOCK_SMEM


# --- 4-bf16: the cluster plan -------------------------------------------------------------------------------

FUSION = (640, 512, 512, 256, 128, 1)


@pytest.mark.parametrize("d_in", [640, 512])
def test_mlp_bf16_plan_at_the_paths_m(d_in):
    """M = 1050 on an H100's 132 SMs: 17 tiles of 64 rows × clusters of 4 CTAs, 68 CTAs in one round of the 30
    clusters of 4 the card runs at once, each CTA's activations and weight ring in its shared memory."""
    dims = (d_in, *FUSION[1:])
    rows, c = M.bf16_mlp_plan(1050, dims)
    assert (rows, c) == (64, 4)
    assert -(-1050 // rows) * c == 68 <= H100_SMS
    assert -(-1050 // rows) <= M.H100_BF16_CLUSTERS_AT_ONCE[rows][c]
    assert M.bf16_smem_bytes(rows, dims) <= M.SMEM_LIMIT


@pytest.mark.parametrize("dims", [FUSION, (512, *FUSION[1:]), (48, 33, 17, 1), (640, 1),
                                  (64, 128, 64, 192, 64, 96, 64, 64, 1)])
@pytest.mark.parametrize("cluster", range(1, 9))
def test_mlp_bf16_tiles_cover_every_column_once(dims, cluster):
    """Each layer but the last (CUDA cores) splits its columns into 64-wide tiles t = rank, rank + C, ...: the
    cluster's CTAs cover every tile once, and bf16_cta_work counts rank 0's, the busiest."""
    weight_bytes = 0
    for k, n in zip(dims[:-2], dims[1:-1]):
        tiles = -(-n // 64)
        hits = np.zeros(tiles, dtype=np.int64)
        for rank in range(cluster):
            hits[rank::cluster] += 1
        assert (hits == 1).all()
        weight_bytes += len(range(0, tiles, cluster)) * -(-k // 64) * M.BF16_STAGE_BYTES
    assert M.bf16_cta_work(dims, 64, cluster)[0] == weight_bytes


@pytest.mark.parametrize("rows", M.BF16_ROWS)
def test_mlp_bf16_smem_and_panels(rows):
    """csrc/fused_mlp.cu::bf16_smem_bytes restated: two buffers of 64-wide panels (rows × 128 bytes), 8 ring
    stages of 8 KB and 17 barriers; and a panel's layout, element (r, k) at r · 128 + 16 · ((k / 8) ^ (r % 8)) +
    2 · (k % 8), holds every element once, and 8 consecutive rows reading one k hit 8 different 16-byte chunks."""
    panels0 = max(-(-FUSION[l] // 64) for l in (0, 2, 4))
    panels1 = max(-(-FUSION[l] // 64) for l in (1, 3))
    assert M.bf16_smem_bytes(rows, FUSION) == 1024 + (panels0 + panels1) * rows * 128 + 8 * 8192 + 17 * 8
    offs = {r * 128 + 16 * ((k // 8) ^ (r % 8)) + 2 * (k % 8) for r in range(rows) for k in range(64)}
    assert offs == set(range(0, rows * 128, 2))
    for k in range(64):
        for r0 in range(0, rows, 8):
            assert len({(r * 128 + 16 * ((k // 8) ^ (r % 8))) // 16 % 8 for r in range(r0, r0 + 8)}) == 8


def test_mlp_bf16_wrapper_refuses_before_any_launch(monkeypatch):
    """A last layer wider than 16 (it runs on the CUDA cores) or activations past a CTA's shared memory raise
    ValueError before the library is built or anything launched (meta tensors stand in for the card's)."""
    from cvml_goalnet_tpu_torch.ops.cuda import _build

    monkeypatch.setattr(_build, "load", lambda *a, **k: pytest.fail("built or launched"))

    def layers(*dims):
        return [{"w": torch.empty((a, b), dtype=torch.bfloat16, device="meta"),
                 "b": torch.empty((b,), dtype=torch.bfloat16, device="meta")} for a, b in zip(dims[:-1], dims[1:])]

    x = torch.empty((5, 640), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="last layer is 32 wide"):
        M.fused_fusion_mlp_bf16(x, layers(640, 512, 32))
    with pytest.raises(ValueError, match="shared memory"):
        M.fused_fusion_mlp_bf16(torch.empty((5, 8192), dtype=torch.bfloat16, device="meta"), layers(8192, 8192, 1))
    with pytest.raises(ValueError, match="1 to 8 layers"):
        M.fused_fusion_mlp_bf16(x, layers(640, *([64] * 8), 1))
