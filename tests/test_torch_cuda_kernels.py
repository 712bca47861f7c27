"""PyTorch port: each CUDA kernel against its plain version, on the card.

Marked ``cuda``; without a CUDA device every test skips.  The machine with
the card has no JAX, so run the file there without the suite's conftest:

    python -m pytest tests/test_torch_cuda_kernels.py --noconftest -m cuda -q

The shapes include the ragged ones of ``tests/test_pallas.py`` (batch,
channel and K edges) besides the reference widths, and for the flash-attention
forwards and backwards ragged sequence lengths, every head width the kernels
are built for and widths between and past them (the wide path), every split
of the full forward and of the banded backward, bands from 0 to past T, key
bounds with dead rows and a query offset.  The forwards hold out to 3e-5 and lse to 1e-5 against the plain
versions, the backwards dq, dk and dv to 1e-4·max(1, max|plain|): the
tolerances of ``tests/test_flash_attention.py``.  The spotting path, one
train step per scorer and one video of the summarization train function are
held against the CPU.  The bf16 and int8 forms of kernels 2-4 are held to
their plain versions at the main paths' shapes, odd shapes and N = 0 (4-bf16
also under every plan), with equal bits on a repeat, and ``fuse`` under the
serving preset's modes to the CPU (tolerances where they are defined below).
"""

import json

import numpy as np
import pytest
import torch

from cvml_goalnet_tpu_torch import weights
from cvml_goalnet_tpu_torch.config import ModelConfig, PipelineConfig, PreprocessConfig
from cvml_goalnet_tpu_torch.data.synthetic import synthetic_video_frames, synthetic_waveform
from cvml_goalnet_tpu_torch.ops.cuda import flash_attention as FA
from cvml_goalnet_tpu_torch.ops.cuda import fused_mlp as mlp_plan
from cvml_goalnet_tpu_torch.ops.cuda import fused_preprocess as pre_plan
from cvml_goalnet_tpu_torch.ops.cuda import fused_stage as stage_plan
from cvml_goalnet_tpu_torch.ops.cuda import matmul as head_plan
from cvml_goalnet_tpu_torch.ops.cuda.fused_mlp import fused_fusion_mlp, fused_fusion_mlp_plain
from cvml_goalnet_tpu_torch.ops.cuda.fused_preprocess import fused_preprocess_frames, fused_preprocess_frames_plain
from cvml_goalnet_tpu_torch.ops.cuda.fused_stage import fused_conv_pool_stage, fused_conv_pool_stage_plain
from cvml_goalnet_tpu_torch.ops.cuda.matmul import head_matmul, head_matmul_plain
from cvml_goalnet_tpu_torch.ops.preprocess import resize_taps_on
from cvml_goalnet_tpu_torch.pipeline import extract_features, fuse, summarize

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rand(shape, seed, scale=1.0, dev="cuda"):
    return torch.as_tensor(np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * scale, device=dev)


# clusters of 1, 2, 4 and 8 CTAs of kernel 1 an H100 SXM runs at once at the main path's layout
H100_PREPROCESS_CLUSTERS = (396, 198, 92, 45)
PREPROCESS_CASES = [
    ((5, 48, 64, 3), (24, 24), torch.float32),
    ((3, 36, 36, 3), (24, 24), torch.uint8),
    ((7, 180, 320, 3), (40, 40), torch.uint8),
    ((3, 7, 5, 3), (11, 13), torch.uint8),    # 105-byte frames: the unvectorised path
    ((1, 180, 320, 3), (40, 40), torch.uint8),          # N = 1: a cluster of 8 for one frame
    ((150, 180, 320, 3), (40, 40), torch.uint8),        # the smallest video of the summarization path
    ((9, 180, 320, 3), (40, 40), torch.float32),        # float32 rows: four times the bytes per row
    ((4, 20, 30, 3), (40, 40), torch.uint8),            # an upscale: one row feeds several slots
    ((6, 36, 36, 1), (24, 24), torch.uint8),            # C = 1
    ((5, 48, 64, 4), (24, 24), torch.float32),          # C = 4
    ((3, 3, 200, 3), (5, 8), torch.uint8),              # H < S: empty bands
    ((2, 180, 320, 3), (160, 160), torch.uint8),        # slots past shared memory: the workspace
]


def _preprocess_inputs(dev, shape, out_hw, dtype, seed=0):
    frames = torch.as_tensor(np.random.default_rng(seed).integers(0, 256, shape), device=dev).to(dtype)
    return frames, (resize_taps_on(shape[1], out_hw[0], dev), resize_taps_on(shape[2], out_hw[1], dev))


@pytest.mark.parametrize("shape,out_hw,dtype", PREPROCESS_CASES)
def test_preprocess(dev, shape, out_hw, dtype):
    frames, taps = _preprocess_inputs(dev, shape, out_hw, dtype)
    before = fused_preprocess_frames.launches
    got = fused_preprocess_frames(frames, *taps)
    assert fused_preprocess_frames.launches == before + 1
    want = fused_preprocess_frames_plain(frames, *taps)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("cluster", pre_plan.CLUSTER_SIZES)
@pytest.mark.parametrize("shape,out_hw,dtype", [c for c in PREPROCESS_CASES if c[0][0] <= 9])
def test_preprocess_every_cluster_size(dev, shape, out_hw, dtype, cluster):
    """Every S the kernel takes, whatever the plan picks, one frame per cluster, held to the plain version."""
    frames, taps = _preprocess_inputs(dev, shape, out_hw, dtype, seed=cluster)
    layout = pre_plan.preprocess_layout(shape[1], shape[2], shape[3], *out_hw, frames.element_size())
    plan = pre_plan.PreprocessPlan(cluster, shape[0], layout)
    got = pre_plan.fused_preprocess_frames_planned(frames, *taps, 1e-7, plan)
    torch.testing.assert_close(got, fused_preprocess_frames_plain(frames, *taps), atol=1e-5, rtol=0)


@pytest.mark.parametrize("cluster", [1, 4])
@pytest.mark.parametrize("clusters", [1, 2, 3, 6])
@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32])
def test_preprocess_clusters_loop_over_frames(dev, clusters, cluster, dtype):
    """Fewer clusters than frames: each loops over its frames as one stream of ring stages, the next frame's
    rows in flight during a frame's epilogue; with the slots in shared memory and in the workspace."""
    for out_hw in ((24, 24), (96, 96)):
        frames, taps = _preprocess_inputs(dev, (7, 36, 48, 3), out_hw, dtype, seed=clusters)
        layout = pre_plan.preprocess_layout(36, 48, 3, *out_hw, frames.element_size())
        if out_hw == (96, 96):   # force the workspace
            layout = layout._replace(cols_in_smem=False, smem_bytes=pre_plan.smem_bytes(
                36, layout.rows_per_stage, 48 * 3 * frames.element_size(), 96, 96 * 3, False))
        got = pre_plan.fused_preprocess_frames_planned(frames, *taps, 1e-7, pre_plan.PreprocessPlan(cluster, clusters,
                                                                                                    layout))
        torch.testing.assert_close(got, fused_preprocess_frames_plain(frames, *taps), atol=1e-5, rtol=0)


def test_preprocess_unaligned_frames(dev):
    """A frame base off a 16-byte boundary takes the element copy."""
    frames, taps = _preprocess_inputs(dev, (4, 36, 48, 3), (24, 24), torch.uint8)
    shifted = torch.empty(frames.numel() + 1, dtype=torch.uint8, device=dev)[1:].view(frames.shape)
    shifted.copy_(frames)
    assert shifted.data_ptr() % 16 != 0
    torch.testing.assert_close(fused_preprocess_frames(shifted, *taps), fused_preprocess_frames_plain(frames, *taps),
                               atol=1e-5, rtol=0)


def test_preprocess_plan_takes_the_cards_clusters(dev):
    """The plan's clusters at once are the card's (cudaOccupancyMaxActiveClusters) at the layout; on an H100
    SXM, the values the CPU plan tests use (tests/test_torch_preprocess_kernel1.py)."""
    layout = pre_plan.preprocess_layout(180, 320, 3, 40, 40, 1)
    at_once = pre_plan.clusters_at_once(dev, True, layout.smem_bytes)
    assert len(at_once) == len(pre_plan.CLUSTER_SIZES) and all(a >= 1 for a in at_once)
    for n in (1, 150, 300, 600, 5400):
        assert pre_plan.card_preprocess_plan(n, 180, 320, 3, 40, 40, 1, dev) == pre_plan.preprocess_plan(
            n, 180, 320, 3, 40, 40, 1, at_once)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    if "H100" in torch.cuda.get_device_name(dev) and sms == 132:
        assert at_once == H100_PREPROCESS_CLUSTERS


@pytest.mark.parametrize("n,capacity", [(1, 5), (37, 400), (540, 24300)])
def test_knapsack_device_engine_on_card(dev, n, capacity, monkeypatch):
    """The device engine (DP and doubling traceback on the card) selects what the native and host engines do,
    at a match's shape (540 clips, capacity 24,300) too."""
    import cvml_goalnet_tpu_torch.ops.knapsack as knapsack
    from cvml_goalnet_tpu_torch.ops.knapsack import knapsack_select

    rng = np.random.default_rng(n)
    values = rng.integers(30, 2000, n).astype(np.float64)
    weights = rng.integers(30, 450, n).astype(np.float64)
    on = []
    real = knapsack.knapsack_select_device
    monkeypatch.setattr(knapsack, "knapsack_select_device", lambda v, w, c: on.append(v.device.type) or real(v, w, c))
    got = knapsack_select(values, weights, capacity, scale_factor=1, engine="device", device=dev)
    assert on == ["cuda"]
    assert got == knapsack_select(values, weights, capacity, scale_factor=1, engine="native")
    assert got == knapsack_select(values, weights, capacity, scale_factor=1, engine="host")


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_zero_frames_card_matches_cpu(dev, dtype):
    """A stream's empty tail: extract_features on the card and on the CPU give the same empty (0, 40, 40, 3)
    float32 visual."""
    frames = np.zeros((0, 180, 320, 3), dtype)
    got = extract_features(frames, None, PipelineConfig())
    want = extract_features(frames, None, PipelineConfig(), device="cpu")
    assert got["visual"].device.type == "cuda" and want["visual"].device.type == "cpu"
    assert got["visual"].shape == want["visual"].shape == (0, 40, 40, 3)
    assert got["visual"].dtype == want["visual"].dtype == torch.float32
    assert got["audio"] is None and want["audio"] is None


# the reference widths at one video, a batch and a match's worth of frames; frame_size (64, 64)'s conv1 and conv2
# (21×21, 19×19) and 17×17, which a block cuts into tiles with a halo; thin frames (3×200, 40×3); ragged Cin
# (3, 5, 20) and Cout (70)
@pytest.mark.parametrize("shape", [
    (20, 13, 13, 8, 16), (9, 11, 11, 16, 32), (2, 5, 7, 3, 70),
    (3, 13, 13, 64, 256), (2, 11, 11, 256, 512), (1, 16, 16, 20, 64),
    (1050, 13, 13, 64, 256), (1050, 11, 11, 256, 512),
    (2, 21, 21, 64, 256), (2, 19, 19, 256, 512), (1, 17, 17, 4, 8),
    (1, 3, 200, 8, 16), (3, 40, 3, 5, 70),
])
def test_conv_pool_stage(dev, shape):
    n, h, w, c, co = shape
    x, wt, b = _rand((n, h, w, c), 1), _rand((3, 3, c, co), 2, 0.05), _rand((h, w, co), 3, 0.1)
    _poison_allocator(dev)
    before = fused_conv_pool_stage.launches
    got = fused_conv_pool_stage(x, wt, b)
    assert fused_conv_pool_stage.launches == before + 1
    want = fused_conv_pool_stage_plain(x, wt, b)
    torch.testing.assert_close(got, want, atol=1e-4 * want.abs().max().item(), rtol=0)
    assert torch.equal(got, fused_conv_pool_stage(x, wt, b))   # no atomics: runs repeat exactly


# every built kernel (m_tiles × ring depth), with whole frames and with tiles cut from a frame
@pytest.mark.parametrize("m_tiles", stage_plan.M_TILES)
@pytest.mark.parametrize("stages", stage_plan.STAGE_COUNTS)
@pytest.mark.parametrize("tiled", [False, True])
def test_conv_pool_stage_every_kernel(dev, m_tiles, stages, tiled):
    n, h, w, c, co = 5, 9, 10, 12, 70
    plan = stage_plan.StagePlan(1, 3, 5, m_tiles, stages) if tiled else stage_plan.StagePlan(
        64 * m_tiles // (h * w), h - 2, w - 2, m_tiles, stages)
    x, wt, b = _rand((n, h, w, c), 4), _rand((3, 3, c, co), 5, 0.05), _rand((h, w, co), 6, 0.1)
    _poison_allocator(dev)
    got = stage_plan.fused_conv_pool_stage_planned(x, wt, b, plan)
    want = fused_conv_pool_stage_plain(x, wt, b)
    torch.testing.assert_close(got, want, atol=1e-4 * want.abs().max().item(), rtol=0)


def test_stage_plan_takes_the_cards_slots(dev):
    """The plan's slots are the card's SMs and the occupancy calculator's blocks per SM of each kernel; the
    Python shared-memory limit agrees with the calculator at the main path's plans; on an H100 SXM, the values
    the CPU plan tests use (tests/test_torch_stage_kernel2.py)."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    slots = stage_plan.stage_slots(dev)
    assert slots[0] == sms and all(b >= 1 for b in slots[1])
    regs = dict(zip(stage_plan.M_TILES, slots[1]))
    for n, h, co in ((1050, 13, 256), (1050, 11, 512), (5400, 13, 256), (5400, 11, 512), (2, 21, 256)):
        plan = stage_plan.card_stage_plan(n, h, h, co, dev)
        assert plan == stage_plan.stage_plan(n, h, h, co, *slots)
        index = torch.cuda.current_device()
        on_card = stage_plan.card_blocks_per_sm(plan.m_tiles, plan.stages, stage_plan.smem_bytes(plan), index)
        assert stage_plan.blocks_per_sm(plan, regs) == on_card
    if "H100" in torch.cuda.get_device_name(dev) and sms == 132:
        assert slots == (132, (2, 1, 1))


# the summarization batch (1050), a per-video batch (150), one frame, K ending inside a split and inside a
# 32-deep K step (41452), and K and N that are not multiples of 4 (the wrapper pads them)
@pytest.mark.parametrize("m,k,n,relu", [
    (100, 4608, 512, True), (64, 4608, 128, True), (130, 2304, 256, True), (32, 2304, 128, False),
    (3, 20, 7, False), (37, 41472, 512, True), (1050, 41472, 512, True), (150, 41472, 512, True),
    (1, 41472, 512, True), (300, 41452, 512, False), (5, 18, 9, True),
])
def test_head_matmul(dev, m, k, n, relu):
    x, w, b = _rand((m, k), 4, 0.1), _rand((k, n), 5, 0.02), _rand((n,), 6)
    _poison_allocator(dev)
    before = head_matmul.launches
    got = head_matmul(x, w, b, relu)
    assert head_matmul.launches == before + 1
    torch.testing.assert_close(got, head_matmul_plain(x, w, b, relu), atol=2e-5, rtol=1e-5)
    assert torch.equal(got, head_matmul(x, w, b, relu))  # no atomics: runs repeat exactly


def test_head_plan_takes_the_cards_slots(dev):
    """The plan's slots are the card's SMs and the occupancy calculator's blocks per SM; on an H100 SXM,
    the values the CPU plan tests use (tests/test_torch_head_kernel3.py)."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    slots = head_plan.head_slots(dev)
    assert slots[0] == sms and slots[1] >= 1
    assert head_plan.card_head_plan(1050, 41472, 512, dev) == head_plan.head_plan(1050, 41472, 512, *slots)
    if "H100" in torch.cuda.get_device_name(dev) and sms == 132:
        assert slots == (132, 1)


def test_head_matmul_contraction_mismatch(dev):
    with pytest.raises(ValueError, match="contraction mismatch"):
        head_matmul(torch.zeros((8, 1000), device=dev), torch.zeros((999, 64), device=dev), torch.zeros(64, device=dev))


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    x = torch.zeros((64, 16), device=dev)
    with pytest.raises(ValueError, match="x must be contiguous float32"):
        head_matmul(x.t(), torch.zeros((64, 8), device=dev), torch.zeros(8, device=dev))


MLP_REF = (640, 512, 512, 256, 128, 1)
# (widths, squash): the reference, audio off, the 5-way classifier (logits), ragged, one layer, eight layers
MLP_CASES = [(MLP_REF, True), ((512, 512, 512, 256, 128, 1), True), ((640, 512, 512, 256, 128, 5), False),
             ((48, 33, 17, 1), True), ((640, 1), True), ((64, 48, 40, 36, 32, 24, 20, 12, 3), False)]


def _mlp_layers(dims):
    return [{"w": _rand((a, b), 10 + i, a ** -0.5), "b": _rand((b,), 20 + i, 0.1)}
            for i, (a, b) in enumerate(zip(dims[:-1], dims[1:]))]


@pytest.mark.parametrize("dims,squash", MLP_CASES)
@pytest.mark.parametrize("rows", [1, 7, 8, 9, 31, 32, 33, 150, 300, 600, 1050, 5400])
def test_fused_mlp(dev, dims, squash, rows):
    layers = _mlp_layers(dims)
    x = _rand((rows, dims[0]), 7)
    got = fused_fusion_mlp(x, layers, 1.0, 5.0, squash)
    torch.testing.assert_close(got, fused_fusion_mlp_plain(x, layers, 1.0, 5.0, squash), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("block_rows", mlp_plan.BLOCK_ROWS)
@pytest.mark.parametrize("cluster", range(1, mlp_plan.MAX_CLUSTER + 1))
def test_fused_mlp_every_plan(dev, block_rows, cluster):
    # every tile plan the kernel takes, at widths where all of them fit and a ragged M
    dims = (96, 72, 40, 3)
    layers = _mlp_layers(dims)
    x = _rand((203, dims[0]), 8)
    got = mlp_plan.fused_fusion_mlp_planned(x, layers, block_rows, cluster, squash=False)
    torch.testing.assert_close(got, fused_fusion_mlp_plain(x, layers, squash=False), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("rows", [9, 1050])
def test_fused_mlp_writes_every_output(dev, rows):
    # the allocator hands the output the memory of a NaN-filled block: a missed write stays NaN
    layers = _mlp_layers(MLP_REF)
    x = _rand((rows, MLP_REF[0]), 9)
    poison = torch.full((rows,), float("nan"), device=dev)
    del poison
    got = fused_fusion_mlp(x, layers)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, fused_fusion_mlp_plain(x, layers), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dims,squash", MLP_CASES[:3])
def test_fused_mlp_repeats_bit_for_bit(dev, dims, squash):
    layers = _mlp_layers(dims)
    x = _rand((1050, dims[0]), 11)
    assert torch.equal(fused_fusion_mlp(x, layers, squash=squash), fused_fusion_mlp(x, layers, squash=squash))


def test_fused_mlp_counts_one_launch_per_call(dev):
    layers = _mlp_layers(MLP_REF)
    x = _rand((150, MLP_REF[0]), 12)
    before = fused_fusion_mlp.launches
    for i in range(3):
        fused_fusion_mlp(x, layers)
        assert fused_fusion_mlp.launches == before + i + 1
    fused_fusion_mlp(x[:0], layers)   # no rows: nothing to launch
    assert fused_fusion_mlp.launches == before + 3


def test_small_pipeline_card_matches_cpu(dev):
    cfg = PipelineConfig(
        preprocess=PreprocessConfig(frame_size=(24, 24)),
        model=ModelConfig(vis_channels=(8, 16, 16), vis_feature_dim=32, aud_channels=(8, 16),
                          aud_feature_dim=16, fusion_hidden=(32, 16)),
    )
    frames = synthetic_video_frames(12, 48, 64, seed=1)
    wav = synthetic_waveform(12 * 22050, seed=1)
    p_np, s_np = weights.init_params(cfg, seed=2)
    got = fuse(*weights.from_jax(p_np, s_np), extract_features(frames, wav, cfg), cfg)
    want = fuse(*weights.from_jax(p_np, s_np, device="cpu"), extract_features(frames, wav, cfg, device="cpu"), cfg,
                device="cpu")
    np.testing.assert_allclose(got, want, atol=1e-4)
    iv = np.array([[0, 100], [100, 200], [200, 360]])
    a = summarize(got, iv, 30, 360)
    b = summarize(want, iv, 30, 360, device="cpu")
    np.testing.assert_array_equal(a.frame_mask, b.frame_mask)


def _small_cfg(**model) -> PipelineConfig:
    return PipelineConfig(
        preprocess=PreprocessConfig(frame_size=(24, 24)),
        model=ModelConfig(vis_channels=(8, 16, 16), vis_feature_dim=32, aud_channels=(8, 16), aud_feature_dim=16,
                          fusion_hidden=(32, 16), **model),
    )


@pytest.mark.parametrize("mode,tol", [({}, 1e-4), ({"dtype": "bfloat16"}, 0.0625),
                                      ({"quantized_inference": True}, 1e-4),
                                      ({"dtype": "bfloat16", "quantized_inference": True}, 0.0625)])
def test_dp_fuse_and_encode_launch_on_each_shards_card(dev, mode, tol):
    """The data-parallel fuse and trunk encode over every visible card: every launch (kernels 1-4 and the bf16
    and int8 forms) enters its shard's card, which is the current device while it launches, and the scores and
    features equal a CPU mesh's of as many entries (the same blocks) within the mode's tolerance."""
    from cvml_goalnet_tpu_torch.ops.cuda import _build
    from cvml_goalnet_tpu_torch.parallel.mesh import serving_mesh
    from cvml_goalnet_tpu_torch.parallel.serving import make_dp_encode, make_dp_fuse

    cfg = _small_cfg(**mode)
    mesh = serving_mesh(-1)
    cpu_mesh = serving_mesh(len(mesh), device="cpu")
    p_np, s_np = weights.init_params(cfg, seed=3)
    frames = synthetic_video_frames(9 * len(mesh) + 5, 48, 64, seed=4)
    wav = synthetic_waveform(len(frames) * 22050, seed=4)
    feats = extract_features(frames, wav, cfg)
    cpu_feats = extract_features(frames, wav, cfg, device="cpu")
    seen, real = [], _build.on_device

    class Spy:
        def __init__(self, t):
            self.t, self.ctx = t, real(t)

        def __enter__(self):
            self.ctx.__enter__()
            seen.append((self.t.device.index, torch.cuda.current_device()))

        def __exit__(self, *exc):
            return self.ctx.__exit__(*exc)

    _build.on_device = Spy
    try:
        got = make_dp_fuse(cfg.model, mesh)(*weights.from_jax(p_np, s_np), feats)
        enc = make_dp_encode(cfg.model, mesh)(*weights.from_jax(p_np, s_np), feats["visual"], feats["audio"])
    finally:
        _build.on_device = real
    cpu = weights.from_jax(p_np, s_np, device="cpu")
    np.testing.assert_allclose(got, make_dp_fuse(cfg.model, cpu_mesh)(*cpu, cpu_feats), atol=tol)
    want_enc = make_dp_encode(cfg.model, cpu_mesh)(*cpu, cpu_feats["visual"], cpu_feats["audio"])
    assert enc.device == mesh[0] and enc.shape == want_enc.shape
    np.testing.assert_allclose(enc.cpu().numpy(), want_enc.numpy(), atol=tol * max(1.0, float(want_enc.abs().max())))
    assert {card for card, _ in seen} == set(range(len(mesh)))
    assert all(card == current for card, current in seen), seen


def test_nccl_one_rank_step_matches_gloo_on_the_cpu(dev):
    """A spawned one-rank group on NCCL runs both data-parallel steps on the card as a one-rank gloo group on the
    CPU does: losses within 1e-5 relative, reduced gradients within 1e-4·max|g|, the ranks import no JAX."""
    import _torch_dp_ranks as ranks
    from cvml_goalnet_tpu_torch.parallel.launch import spawn_ranks

    cfg = _small_cfg(dropout_rate=0.0)
    p_np, s_np = weights.init_params(cfg, seed=5)
    rng = np.random.default_rng(6)
    job = {"cfg": cfg, "params": p_np, "model_state": s_np,
           "visual": rng.random((16, 24, 24, 3)).astype(np.float32),
           "audio": rng.random((16, cfg.audio.bin_length, cfg.audio.n_mfcc)).astype(np.float32),
           "labels": rng.integers(1, 6, 16).astype(np.float32)}
    card = spawn_ranks(ranks.step_parity, [torch.device("cuda", 0)], (job,))[0]
    cpu = spawn_ranks(ranks.step_parity, [torch.device("cpu")], (job,))[0]
    assert card["forbidden"] == [] and cpu["forbidden"] == []
    for kind in ("gspmd", "shardmap"):
        assert card[kind]["loss"] == pytest.approx(cpu[kind]["loss"], rel=1e-5)
        for g, w in zip(_leaves(card[kind]["grads"]), _leaves(cpu[kind]["grads"])):
            np.testing.assert_allclose(g, w, atol=1e-4 * max(float(np.abs(w).max()), 1e-12), rtol=0)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def test_visual_trunk_at_frame_size_64_card_matches_cpu(dev):
    """The full-width trunk at frame_size (64, 64): conv1 at 21×21 and conv2 at 19×19, which the stage kernel
    cuts into tiles; card against CPU with the same weights, within 1e-4 relative."""
    from cvml_goalnet_tpu_torch.models.visual import visual_encoder_apply

    cfg = PipelineConfig(preprocess=PreprocessConfig(frame_size=(64, 64)))
    p_np, s_np = weights.init_params(cfg, seed=6)
    frames = np.random.default_rng(7).random((3, 64, 64, 3)).astype(np.float32)
    before = fused_conv_pool_stage.launches
    with torch.no_grad():
        params, state = weights.from_jax(p_np, s_np)
        got = visual_encoder_apply(params["visual"], state["visual"], torch.as_tensor(frames, device=dev)).cpu()
        params, state = weights.from_jax(p_np, s_np, device="cpu")
        want = visual_encoder_apply(params["visual"], state["visual"], torch.from_numpy(frames))
    assert fused_conv_pool_stage.launches == before + 2
    assert got.shape == want.shape == (3, cfg.model.vis_feature_dim)
    assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()


def _attn_check(got, want, atol=3e-5):
    (o, lse), (o_want, lse_want) = got, want
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()
    torch.testing.assert_close(o, o_want, atol=atol, rtol=0)
    torch.testing.assert_close(lse, lse_want, atol=1e-5, rtol=1e-6)


@pytest.mark.parametrize("h,t,d", [(1, 1, 128), (2, 63, 64), (1, 64, 32), (2, 65, 128), (1, 1000, 32),
                                   (1, 5400, 128), (2, 5400, 64), (2, 300, 32), (2, 300, 64)])
def test_flash_fwd(dev, h, t, d):
    q, k, v = (_rand((h, t, d), 30 + i) for i in range(3))
    before = FA.flash_fwd.launches
    got = FA.flash_fwd(q, k, v, d ** -0.5)
    assert FA.flash_fwd.launches == before + 1
    _attn_check(got, FA.flash_fwd_plain(q, k, v, d ** -0.5))


@pytest.mark.parametrize("t_valid", [0, 1, 97, 1000])
def test_flash_fwd_t_valid_and_unequal_lengths(dev, t_valid):
    q, k, v = _rand((2, 200, 64), 40), _rand((2, 1000, 64), 41), _rand((2, 1000, 64), 42)
    got = FA.flash_fwd(q, k, v, 0.125, t_valid)
    _attn_check(got, FA.flash_fwd_plain(q, k, v, 0.125, t_valid))
    if t_valid == 0:
        assert not got[0].any() and not got[1].any()


@pytest.mark.parametrize("h,t,d,window", [(1, 1, 64, 0), (2, 63, 32, 1), (1, 65, 128, 37), (2, 1000, 64, 37),
                                          (1, 5400, 128, 1024), (2, 5400, 64, 1024), (1, 300, 32, 300),
                                          (1, 200, 64, 10**6), (2, 129, 128, 0), (4, 4300, 32, 100)])
def test_flash_local_fwd(dev, h, t, d, window):
    q, k, v = (_rand((h, t, d), 50 + i) for i in range(3))
    before = FA.flash_local_fwd.launches
    got = FA.flash_local_fwd(q, k, v, d ** -0.5, window)
    assert FA.flash_local_fwd.launches == before + 1
    _attn_check(got, FA.flash_local_fwd_plain(q, k, v, d ** -0.5, window))
    if window == 0:
        torch.testing.assert_close(got[0], v, atol=3e-6, rtol=0)


@pytest.mark.parametrize("lo,hi,q_offset", [(64, 200, 0), (10, 180, 16), (0, 192, 16), (150, 40, 0)])
def test_flash_local_fwd_bounds_dead_rows_and_offset(dev, lo, hi, q_offset):
    tq = 160 if q_offset else 256
    tk = tq + 2 * q_offset
    q, k, v = _rand((2, tq, 64), 60), _rand((2, tk, 64), 61), _rand((2, tk, 64), 62)
    got = FA.flash_local_fwd(q, k, v, 0.125, 16, lo, hi, q_offset)
    _attn_check(got, FA.flash_local_fwd_plain(q, k, v, 0.125, 16, lo, hi, q_offset))
    if (lo, hi) == (64, 200):   # rows < 48 and ≥ 216 have empty bands: out 0, lse 0
        for x in got:
            assert not x[:, :48].any() and not x[:, 216:].any()


@pytest.mark.parametrize("window", [0, 48])
def test_flash_large_magnitudes_stay_finite(dev, window):
    q, k, v = _rand((1, 1000, 64), 70, 10.0), _rand((1, 1000, 64), 71, 10.0), _rand((1, 1000, 64), 72)
    got = FA.flash_local_fwd(q, k, v, 0.125, window) if window else FA.flash_fwd(q, k, v, 0.125)
    # both forwards sum on the tensor cores in another order than the plain version, and at scores near 1e3 the
    # float32 plain version's own rounding on out reaches about 1e-4, so they are held to it in float64
    if window:
        want = tuple(t.float() for t in FA.flash_local_fwd_plain(q.double(), k.double(), v.double(), 0.125, window))
    else:
        want = tuple(t.float() for t in FA.flash_fwd_plain(q.double(), k.double(), v.double(), 0.125))
    # scores up to ~1e3: lse carries float32 rounding of that size
    assert torch.isfinite(got[0]).all() and torch.isfinite(got[1]).all()
    torch.testing.assert_close(got[0], want[0], atol=1e-4, rtol=0)
    torch.testing.assert_close(got[1], want[1], atol=1e-3, rtol=1e-6)


def test_flash_fwd_large_magnitudes_against_float64(dev):
    """The full forward at the inputs of test_flash_large_magnitudes_stay_finite, against the plain version in
    float64: out and lse at least as close to it as the plain float32 version, whose own rounding at scores
    near 1e3 reaches about 1e-4 on out."""
    q, k, v = _rand((1, 1000, 64), 70, 10.0), _rand((1, 1000, 64), 71, 10.0), _rand((1, 1000, 64), 72)
    exact = FA.flash_fwd_plain(q.double(), k.double(), v.double(), 0.125)
    got, plain = FA.flash_fwd(q, k, v, 0.125), FA.flash_fwd_plain(q, k, v, 0.125)
    for g, p, e in zip(got, plain, exact):
        assert (g - e).abs().max() <= (p - e).abs().max()


def test_flash_refuses_what_the_kernels_do_not_take(dev):
    x = torch.zeros((1, 8, 48), device=dev)
    out, lse = FA.flash_fwd(x, x, x, 0.1)     # d = 48 runs, zero-padded to 64
    assert out.shape == x.shape and not out.any() and torch.allclose(lse, torch.full_like(lse, np.log(8)))
    x = _rand((1, 8, 160), 29)                # d = 160 runs, zero-padded to 256
    _attn_check(FA.flash_fwd(x, x, x, 0.1), FA.flash_fwd_plain(x, x, x, 0.1))
    x = _rand((1, 8, 320), 28)                # d = 320 runs on the wide path, zero-padded to 384
    _attn_check(FA.flash_fwd(x, x, x, 0.1), FA.flash_fwd_plain(x, x, x, 0.1))
    y = torch.zeros((1, 16, 32), device=dev)
    with pytest.raises(ValueError, match="contiguous float32"):
        FA.flash_fwd(y.transpose(1, 2).contiguous().transpose(1, 2), y, y, 0.1)
    with pytest.raises(ValueError, match="self-attention band"):
        FA.flash_attention_local(y, torch.zeros((1, 17, 32), device=dev), torch.zeros((1, 17, 32), device=dev), 4)


def test_spotting_card_matches_cpu(dev):
    import dataclasses

    from cvml_goalnet_tpu_torch import spotting

    base = PipelineConfig(
        preprocess=PreprocessConfig(frame_size=(24, 24)),
        model=ModelConfig(vis_channels=(8, 16, 16), vis_feature_dim=32, aud_channels=(8, 16), aud_feature_dim=16,
                          fusion_hidden=(32, 16), audio_included=False, temporal_hidden=32, temporal_window=6,
                          temporal_max_len=128),
    )
    p_np, s_np = weights.init_params(base, seed=3)
    visual = np.random.default_rng(4).random((70, 24, 24, 3)).astype(np.float32)
    iv = np.array([[0, 700], [700, 1400], [1400, 2100]])
    for family in ("gru", "transformer", "hybrid"):
        cfg = dataclasses.replace(base, model=dataclasses.replace(base.model, temporal_model=family))
        t_np = weights.init_temporal_params(cfg.model, 32, seed=5)
        got = spotting.summarize_match(*weights.from_jax(p_np, s_np), weights.tree_from_jax(t_np), visual, None,
                                       iv, cfg, peak_window=3)
        want = spotting.summarize_match(*weights.from_jax(p_np, s_np, device="cpu"),
                                        weights.tree_from_jax(t_np, device="cpu"), visual, None, iv, cfg,
                                        peak_window=3, device="cpu")
        np.testing.assert_allclose(got.scores, want.scores, atol=1e-4)
        np.testing.assert_array_equal(got.events, want.events)


def _bwd_check(got, want):
    """dq, dk, dv against the plain backward: 1e-4·max(1, max|plain|) per gradient, the 1e-4 of the grad
    tests of ``tests/test_flash_attention.py`` scaled to the gradient's size (float32 sums over the keys,
    or over the queries, in another order)."""
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g, w, atol=1e-4 * max(1.0, w.abs().max().item()), rtol=0)


def _poison_allocator(dev):
    """Fill freed memory with NaN, so outputs from torch.empty that a kernel fails to write show up."""
    torch.full((64 << 20,), float("nan"), device=dev)
    torch.cuda.synchronize()


# (4, 4300, 32) and (2, 8500, 64) give at least two blocks per SM, so they take the 64-row tiles
@pytest.mark.parametrize("h,t,d", [(1, 1, 128), (2, 63, 64), (1, 64, 32), (2, 65, 128), (1, 1000, 32),
                                   (1, 5400, 128), (2, 300, 32), (2, 4500, 64), (4, 4300, 32), (2, 8500, 64)])
def test_flash_bwd(dev, h, t, d):
    q, k, v, do = (_rand((h, t, d), 80 + i) for i in range(4))
    out, lse = FA.flash_fwd_plain(q, k, v, d ** -0.5)
    _poison_allocator(dev)
    before = FA.flash_bwd.launches
    got = FA.flash_bwd(q, k, v, out, lse, do, d ** -0.5)
    assert FA.flash_bwd.launches == before + 1
    _bwd_check(got, FA.flash_bwd_plain(q, k, v, out, lse, do, d ** -0.5))
    assert all(torch.equal(a, b) for a, b in zip(got, FA.flash_bwd(q, k, v, out, lse, do, d ** -0.5)))


@pytest.mark.parametrize("t_valid", [0, 1, 97, 1000])
def test_flash_bwd_t_valid_g_lse_and_unequal_lengths(dev, t_valid):
    q, k, v, do = _rand((2, 200, 64), 90), _rand((2, 1000, 64), 91), _rand((2, 1000, 64), 92), _rand((2, 200, 64), 93)
    g_lse = _rand((2, 200), 94)
    out, lse = FA.flash_fwd_plain(q, k, v, 0.125, t_valid)
    _poison_allocator(dev)
    got = FA.flash_bwd(q, k, v, out, lse, do, 0.125, t_valid, g_lse)
    _bwd_check(got, FA.flash_bwd_plain(q, k, v, out, lse, do, 0.125, t_valid, g_lse))
    dq, dk, dv = got
    assert not dk[:, t_valid:].any() and not dv[:, t_valid:].any()   # key tiles no query reaches: zeros
    if t_valid == 0:                                                   # every row dead
        assert not dq.any()


@pytest.mark.parametrize("h,t,d,window", [(1, 1, 64, 0), (2, 63, 32, 1), (1, 65, 128, 37), (2, 1000, 64, 37),
                                          (1, 5400, 128, 1024), (2, 5400, 64, 1024), (1, 300, 32, 300),
                                          (1, 200, 64, 10**6), (2, 129, 128, 0), (4, 4300, 32, 100),
                                          (2, 8500, 64, 700)])
def test_flash_local_bwd(dev, h, t, d, window):
    q, k, v, do = (_rand((h, t, d), 100 + i) for i in range(4))
    out, lse = FA.flash_local_fwd_plain(q, k, v, d ** -0.5, window)
    _poison_allocator(dev)
    before = FA.flash_local_bwd.launches
    got = FA.flash_local_bwd(q, k, v, out, lse, do, d ** -0.5, window)
    assert FA.flash_local_bwd.launches == before + 1
    _bwd_check(got, FA.flash_local_bwd_plain(q, k, v, out, lse, do, d ** -0.5, window))


@pytest.mark.parametrize("lo,hi,q_offset", [(64, 200, 0), (10, 180, 16), (0, 192, 16), (150, 40, 0)])
def test_flash_local_bwd_bounds_dead_rows_and_offset(dev, lo, hi, q_offset):
    tq = 160 if q_offset else 256
    tk = tq + 2 * q_offset
    q, k, v, do = _rand((2, tq, 64), 110), _rand((2, tk, 64), 111), _rand((2, tk, 64), 112), _rand((2, tq, 64), 113)
    out, lse = FA.flash_local_fwd_plain(q, k, v, 0.125, 16, lo, hi, q_offset)
    _poison_allocator(dev)
    got = FA.flash_local_bwd(q, k, v, out, lse, do, 0.125, 16, lo, hi, q_offset)
    _bwd_check(got, FA.flash_local_bwd_plain(q, k, v, out, lse, do, 0.125, 16, lo, hi, q_offset))
    dq, dk, dv = got
    assert not dk[:, :max(lo, 0)].any() and not dk[:, max(hi, 0):].any() and not dv[:, max(hi, 0):].any()
    if (lo, hi) == (64, 200):   # rows < 48 and ≥ 216 have empty bands: dq 0
        assert not dq[:, :48].any() and not dq[:, 216:].any()


@pytest.mark.parametrize("window", [0, 48])
def test_flash_bwd_large_magnitudes_stay_finite(dev, window):
    q, k, v, do = _rand((1, 1000, 64), 120, 10.0), _rand((1, 1000, 64), 121, 10.0), _rand((1, 1000, 64), 122), \
        _rand((1, 1000, 64), 123)
    if window:
        out, lse = FA.flash_local_fwd_plain(q, k, v, 0.125, window)
        got = FA.flash_local_bwd(q, k, v, out, lse, do, 0.125, window)
        want = FA.flash_local_bwd_plain(q, k, v, out, lse, do, 0.125, window)
    else:
        out, lse = FA.flash_fwd_plain(q, k, v, 0.125)
        got = FA.flash_bwd(q, k, v, out, lse, do, 0.125)
        want = FA.flash_bwd_plain(q, k, v, out, lse, do, 0.125)
    _bwd_check(got, want)


# the plan splits every walk here (s > 1), and T is ragged against the 64-row tiles, the streamed chunks
# and the splits; t_valid falls inside a split, on a chunk edge, or past every key
@pytest.mark.parametrize("h,tq,tk,d,t_valid", [(1, 1000, 1000, 32, 300), (1, 1000, 1000, 32, None),
                                               (1, 777, 1000, 128, 513), (2, 130, 451, 64, 448),
                                               (1, 5400, 5400, 128, 5001), (1, 63, 63, 128, 40),
                                               (2, 300, 300, 32, 10**6), (1, 200, 333, 64, 0)])
def test_flash_bwd_split_boundaries(dev, h, tq, tk, d, t_valid):
    plan = FA.card_bwd_plan(h, tq, tk, d, dev)
    assert plan.s_dkv > 1 and plan.s_dq > 1
    q, do = _rand((h, tq, d), 160), _rand((h, tq, d), 161)
    k, v = _rand((h, tk, d), 162), _rand((h, tk, d), 163)
    g_lse = _rand((h, tq), 164)
    out, lse = FA.flash_fwd_plain(q, k, v, d ** -0.5, t_valid)
    _poison_allocator(dev)
    before = FA.flash_bwd.launches
    got = FA.flash_bwd(q, k, v, out, lse, do, d ** -0.5, t_valid, g_lse)
    assert FA.flash_bwd.launches == before + 1
    _bwd_check(got, FA.flash_bwd_plain(q, k, v, out, lse, do, d ** -0.5, t_valid, g_lse))
    kv_end = tk if t_valid is None else min(t_valid, tk)
    assert not got[1][:, kv_end:].any() and not got[2][:, kv_end:].any()
    if kv_end == 0:
        assert not got[0].any()
    again = FA.flash_bwd(q, k, v, out, lse, do, d ** -0.5, t_valid, g_lse)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_flash_bwd_plan_takes_the_cards_slots(dev):
    """The plan's resident slots are the card's SMs × the CUDA occupancy calculator's blocks per SM; on an
    H100 SXM they are the slots the CPU plan tests use (tests/test_torch_attention_kernel6.py)."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    slots = {}
    for d in FA.BWD_STREAM:   # the widths kernel 6 runs on the tensor cores
        per_dkv, per_dq = FA.bwd_blocks_per_sm(d, dev)
        slots[d] = FA.bwd_slots(d, dev)
        assert slots[d] == (sms * per_dkv, sms * per_dq)
        assert FA.card_bwd_plan(1, 5400, 5400, d, dev) == FA.full_bwd_plan(1, 5400, 5400, d, slots[d])
    if "H100" in torch.cuda.get_device_name(dev) and sms == 132:
        assert slots == {32: (396, 396), 64: (264, 396), 128: (264, 264)}


# kernel 8 with its walks forced into every split count on each side (s_dkv = s, s_dq = MAX_SPLIT + 1 − s),
# at the main path's band and at ragged shapes with key bounds, query offsets of either sign, crossed bounds
# and rows or keys that no pair reaches (those get exactly 0); equal bits on a repeat
@pytest.mark.parametrize("splits", range(1, FA.MAX_SPLIT + 1))
@pytest.mark.parametrize("h,tq,tk,d,window,lo,hi,q_offset", [
    (1, 5400, 5400, 128, 1024, None, None, 0), (2, 300, 250, 32, 37, 5, 233, -20),
    (2, 777, 451, 64, 37, 13, 400, 16), (1, 129, 63, 32, 5, -10, 1000, -100), (2, 200, 200, 64, 16, 150, 40, 0),
    (1, 1500, 1100, 128, 100, 70, 1033, 300)])
def test_flash_local_bwd_every_split(dev, splits, h, tq, tk, d, window, lo, hi, q_offset):
    q, do = _rand((h, tq, d), 220), _rand((h, tq, d), 221)
    k, v = _rand((h, tk, d), 222), _rand((h, tk, d), 223)
    scale = d ** -0.5
    out, lse = FA.flash_local_fwd_plain(q, k, v, scale, window, lo, hi, q_offset)
    _poison_allocator(dev)
    before = FA.flash_local_bwd.launches
    run = lambda: FA.flash_local_bwd_planned(q, k, v, out, lse, do, scale, window, splits, FA.MAX_SPLIT + 1 - splits,
                                             lo, hi, q_offset)
    got = run()
    assert FA.flash_local_bwd.launches == before
    _bwd_check(got, FA.flash_local_bwd_plain(q, k, v, out, lse, do, scale, window, lo, hi, q_offset))
    valid = FA._band_valid(q, k, window, lo, hi, q_offset)[0]
    dq, dk, dv = got
    assert not dq[:, ~valid.any(1)].any() and not dk[:, ~valid.any(0)].any() and not dv[:, ~valid.any(0)].any()
    assert all(torch.equal(a, b) for a, b in zip(got, run()))


def test_flash_local_bwd_plan_takes_the_cards_slots(dev):
    """Kernel 8's resident slots are the card's SMs × the CUDA occupancy calculator's blocks per SM of its
    band instantiations; on an H100 SXM they are the slots the CPU plan tests use
    (tests/test_torch_attention_kernel8.py), and the wrapper launches the card's plan."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    slots = {}
    for d in FA.BWD_STREAM:
        per_dkv, per_dq = FA.bwd_blocks_per_sm(d, dev, band=True)
        slots[d] = FA.bwd_slots(d, dev, band=True)
        assert slots[d] == (sms * per_dkv, sms * per_dq)
        assert (FA.card_local_bwd_plan(1, 5400, 5400, d, 1024, 0, 5400, 0, dev)
                == FA.local_bwd_plan(1, 5400, 5400, d, 1024, 0, 5400, 0, slots[d]))
    if "H100" in torch.cuda.get_device_name(dev) and sms == 132:
        assert slots == {32: (396, 396), 64: (264, 396), 128: (264, 264)}
    # the wrapper's launch is the plan's: the same bits as the planned call with the plan's splits
    q, k, v, do = (_rand((1, 5400, 128), 230 + i) for i in range(4))
    out, lse = FA.flash_local_fwd_plain(q, k, v, 128 ** -0.5, 1024)
    plan = FA.card_local_bwd_plan(1, 5400, 5400, 128, 1024, 0, 5400, 0, dev)
    got = FA.flash_local_bwd(q, k, v, out, lse, do, 128 ** -0.5, 1024)
    want = FA.flash_local_bwd_planned(q, k, v, out, lse, do, 128 ** -0.5, 1024, plan.s_dkv, plan.s_dq)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("d", [8, 16, 48, 96, 160, 192, 256, 257, 320, 512])
@pytest.mark.parametrize("kind", ["fwd", "local_fwd", "bwd", "local_bwd"])
def test_flash_head_dims_between_the_built_widths(dev, kind, d):
    """Head widths the kernels are not built for run zero-padded to the next built width, and past 256 to a
    multiple of 128 on the wide path."""
    h, t, window = 2, 300, 37
    q, k, v, do = (_rand((h, t, d), 170 + i) for i in range(4))
    scale = d ** -0.5
    wrapper = getattr(FA, f"flash_{kind}")
    before = wrapper.launches
    if kind == "fwd":
        _attn_check(FA.flash_fwd(q, k, v, scale, 250), FA.flash_fwd_plain(q, k, v, scale, 250))
    elif kind == "local_fwd":
        _attn_check(FA.flash_local_fwd(q, k, v, scale, window), FA.flash_local_fwd_plain(q, k, v, scale, window))
    elif kind == "bwd":
        out, lse = FA.flash_fwd_plain(q, k, v, scale, 250)
        _poison_allocator(dev)
        _bwd_check(FA.flash_bwd(q, k, v, out, lse, do, scale, 250),
                   FA.flash_bwd_plain(q, k, v, out, lse, do, scale, 250))
    else:
        out, lse = FA.flash_local_fwd_plain(q, k, v, scale, window)
        _poison_allocator(dev)
        _bwd_check(FA.flash_local_bwd(q, k, v, out, lse, do, scale, window),
                   FA.flash_local_bwd_plain(q, k, v, out, lse, do, scale, window))
    assert wrapper.launches == before + 1


@pytest.mark.parametrize("d", [160, 192, 256, 257, 320, 512])
@pytest.mark.parametrize("kind", ["full", "band"])
def test_flash_wide_heads_masks_and_dead_rows(dev, kind, d):
    """Heads of 160 to 512 wide under the masks: t_valid with unequal lengths and g_lse (every key tile past
    t_valid gets zeros), and a [lo, hi) band with a query offset and dead rows (out, lse and dq 0)."""
    if kind == "full":
        q, do = _rand((2, 200, d), 180), _rand((2, 200, d), 181)
        k, v = _rand((2, 700, d), 182), _rand((2, 700, d), 183)
        g_lse, scale = _rand((2, 200), 184), d ** -0.5
        _attn_check(FA.flash_fwd(q, k, v, scale, 97), FA.flash_fwd_plain(q, k, v, scale, 97))
        out, lse = FA.flash_fwd_plain(q, k, v, scale, 97)
        _poison_allocator(dev)
        got = FA.flash_bwd(q, k, v, out, lse, do, scale, 97, g_lse)
        _bwd_check(got, FA.flash_bwd_plain(q, k, v, out, lse, do, scale, 97, g_lse))
        assert not got[1][:, 97:].any() and not got[2][:, 97:].any()
    else:
        q, do = _rand((2, 256, d), 185), _rand((2, 256, d), 186)
        k, v = _rand((2, 256, d), 187), _rand((2, 256, d), 188)
        scale = d ** -0.5
        got = FA.flash_local_fwd(q, k, v, scale, 16, 64, 200)
        _attn_check(got, FA.flash_local_fwd_plain(q, k, v, scale, 16, 64, 200))
        for x in got:   # rows < 48 and ≥ 216 have empty bands
            assert not x[:, :48].any() and not x[:, 216:].any()
        out, lse = FA.flash_local_fwd_plain(q, k, v, scale, 16, 64, 200)
        _poison_allocator(dev)
        dq, dk, dv = FA.flash_local_bwd(q, k, v, out, lse, do, scale, 16, 64, 200)
        _bwd_check((dq, dk, dv), FA.flash_local_bwd_plain(q, k, v, out, lse, do, scale, 16, 64, 200))
        assert not dq[:, :48].any() and not dq[:, 216:].any() and not dk[:, :64].any() and not dv[:, 200:].any()
        qo = _rand((2, 160, d), 189)
        ko, vo = _rand((2, 192, d), 190), _rand((2, 192, d), 191)
        _attn_check(FA.flash_local_fwd(qo, ko, vo, scale, 16, 10, 180, 16),
                    FA.flash_local_fwd_plain(qo, ko, vo, scale, 16, 10, 180, 16))
        do_o = _rand((2, 160, d), 192)
        out, lse = FA.flash_local_fwd_plain(qo, ko, vo, scale, 16, 10, 180, 16)
        _bwd_check(FA.flash_local_bwd(qo, ko, vo, out, lse, do_o, scale, 16, 10, 180, 16),
                   FA.flash_local_bwd_plain(qo, ko, vo, out, lse, do_o, scale, 16, 10, 180, 16))


# kernel 5's tile kernel: blocks an H100 SXM keeps resident per width (tests/test_torch_attention_kernel5.py)
H100_FWD_SLOTS = {32: 396, 64: 264, 128: 264}
# kernel 7's: two blocks per SM at every width (tests/test_torch_attention_kernel7.py)
H100_LOCAL_FWD_SLOTS = {32: 264, 64: 264, 128: 264}


# each shape's plan as the card picks it (one head of a match splits in 3 on an H100, T = 32,768 does not);
# t_valid falls inside a chunk, and at 0 every row is dead
@pytest.mark.parametrize("h,tq,tk,d,t_valid", [(1, 5400, 5400, 128, None), (1, 32768, 32768, 128, None),
                                               (2, 300, 300, 64, None), (4, 300, 300, 128, 250),
                                               (1, 1000, 1000, 32, 97), (2, 777, 451, 64, 448),
                                               (1, 200, 333, 128, 0), (3, 65, 1000, 32, None)])
def test_flash_fwd_card_plans(dev, h, tq, tk, d, t_valid):
    q, k, v = _rand((h, tq, d), 200), _rand((h, tk, d), 201), _rand((h, tk, d), 202)
    plan = FA.card_fwd_plan(h, tq, FA._t_valid(tk, t_valid), d, dev)
    assert plan.stream == FA.FWD_STREAM[d]
    _poison_allocator(dev)
    before = FA.flash_fwd.launches
    got = FA.flash_fwd(q, k, v, d ** -0.5, t_valid)
    assert FA.flash_fwd.launches == before + 1
    _attn_check(got, FA.flash_fwd_plain(q, k, v, d ** -0.5, t_valid))
    again = FA.flash_fwd(q, k, v, d ** -0.5, t_valid)
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    if t_valid == 0:
        assert not got[0].any() and not got[1].any()


# every split count, forced, against the plain version with equal bits on a repeat; splits past the chunks
# walk no key and weigh exactly 0 in the merge
@pytest.mark.parametrize("splits", range(1, FA.MAX_SPLIT + 1))
@pytest.mark.parametrize("h,tq,tk,d,t_valid", [(1, 5400, 5400, 128, None), (2, 300, 300, 64, 97),
                                               (1, 1000, 1000, 32, None), (2, 48, 1000, 128, 0),
                                               (1, 200, 120, 16, None)])
def test_flash_fwd_every_split(dev, splits, h, tq, tk, d, t_valid):
    q, k, v = _rand((h, tq, d), 210), _rand((h, tk, d), 211), _rand((h, tk, d), 212)
    _poison_allocator(dev)
    got = FA.flash_fwd_planned(q, k, v, d ** -0.5, splits, t_valid)
    _attn_check(got, FA.flash_fwd_plain(q, k, v, d ** -0.5, t_valid))
    again = FA.flash_fwd_planned(q, k, v, d ** -0.5, splits, t_valid)
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])


# kernel 7 with its walk forced into every split count at d = 32, 64 and 128: the main path's band and ragged
# shapes with key bounds, query offsets of either sign, crossed bounds and rows no key reaches (out and lse exactly
# 0, also when they share a tile with live rows); equal bits on a repeat
@pytest.mark.parametrize("splits", range(1, FA.MAX_SPLIT + 1))
@pytest.mark.parametrize("h,tq,tk,d,window,lo,hi,q_offset", [
    (1, 5400, 5400, 128, 1024, None, None, 0), (2, 5400, 5400, 64, 1024, None, None, 0),
    (2, 300, 250, 32, 37, 5, 233, -20), (2, 777, 451, 64, 37, 13, 400, 16), (1, 129, 63, 32, 5, -10, 1000, -100),
    (2, 200, 200, 64, 16, 150, 40, 0), (1, 1500, 1100, 128, 100, 70, 1033, 300), (1, 128, 128, 32, 4, 40, 60, 0)])
def test_flash_local_fwd_every_split(dev, splits, h, tq, tk, d, window, lo, hi, q_offset):
    q, k, v = _rand((h, tq, d), 240), _rand((h, tk, d), 241), _rand((h, tk, d), 242)
    scale = d ** -0.5
    _poison_allocator(dev)
    before = FA.flash_local_fwd.launches
    run = lambda: FA.flash_local_fwd_planned(q, k, v, scale, window, splits, lo, hi, q_offset)
    got = run()
    assert FA.flash_local_fwd.launches == before
    _attn_check(got, FA.flash_local_fwd_plain(q, k, v, scale, window, lo, hi, q_offset))
    dead = ~FA._band_valid(q, k, window, lo, hi, q_offset)[0].any(1)
    assert not got[0][:, dead].any() and not got[1][:, dead].any()
    again = run()
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])


def test_flash_local_fwd_plan_takes_the_cards_slots(dev):
    """Kernel 7's resident slots are the card's SMs × the CUDA occupancy calculator's blocks per SM of its band
    instantiation; on an H100 SXM they are the slots the CPU plan tests use
    (tests/test_torch_attention_kernel7.py), and the wrapper launches the card's plan."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    slots = {}
    for d in FA.FWD_STREAM:
        slots[d] = FA.fwd_slots(d, dev, band=True)
        assert slots[d] == sms * FA.fwd_blocks_per_sm(d, dev, band=True)
        assert (FA.card_local_fwd_plan(1, 5400, 5400, d, 1024, 0, 5400, 0, dev)
                == FA.local_fwd_plan(1, 5400, 5400, d, 1024, 0, 5400, 0, slots[d]))
    if "H100" in torch.cuda.get_device_name(dev) and sms == 132:
        assert slots == H100_LOCAL_FWD_SLOTS
    # the wrapper's launch is the plan's: the same bits as the planned call with the plan's splits
    q, k, v = (_rand((1, 5400, 128), 250 + i) for i in range(3))
    plan = FA.card_local_fwd_plan(1, 5400, 5400, 128, 1024, 0, 5400, 0, dev)
    got = FA.flash_local_fwd(q, k, v, 128 ** -0.5, 1024)
    want = FA.flash_local_fwd_planned(q, k, v, 128 ** -0.5, 1024, plan.splits)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_flash_fwd_plan_takes_the_cards_slots(dev):
    """Kernel 5's resident slots are the card's SMs × the CUDA occupancy calculator's blocks per SM; on an H100
    SXM they are the slots the CPU plan tests use (tests/test_torch_attention_kernel5.py)."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    slots = {}
    for d in FA.FWD_STREAM:
        slots[d] = FA.fwd_slots(d, dev)
        assert slots[d] == sms * FA.fwd_blocks_per_sm(d, dev)
        assert FA.card_fwd_plan(1, 5400, 5400, d, dev) == FA.full_fwd_plan(1, 5400, 5400, d, slots[d])
    if "H100" in torch.cuda.get_device_name(dev) and sms == 132:
        assert slots == H100_FWD_SLOTS


@pytest.mark.parametrize("window", [0, 6])
def test_transformer_scorer_with_narrow_heads_card_matches_cpu(dev, window):
    """summarize_match with a transformer of 2 heads of 16 (padded to 32 on the card) against the CPU."""
    import dataclasses

    from cvml_goalnet_tpu_torch import spotting

    cfg = PipelineConfig(
        preprocess=PreprocessConfig(frame_size=(24, 24)),
        model=ModelConfig(vis_channels=(8, 16, 16), vis_feature_dim=32, aud_channels=(8, 16), aud_feature_dim=16,
                          fusion_hidden=(32, 16), audio_included=False, temporal_model="transformer",
                          temporal_hidden=32, temporal_num_heads=2, temporal_max_len=128),
    )
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, temporal_window=window))
    p_np, s_np = weights.init_params(cfg, seed=6)
    t_np = weights.init_temporal_params(cfg.model, 32, seed=7)
    visual = np.random.default_rng(8).random((90, 24, 24, 3)).astype(np.float32)
    iv = np.array([[0, 900], [900, 1800], [1800, 2700]])
    kernel = FA.flash_local_fwd if window else FA.flash_fwd
    before = kernel.launches
    got = spotting.summarize_match(*weights.from_jax(p_np, s_np), weights.tree_from_jax(t_np), visual, None, iv,
                                   cfg, peak_window=3)
    assert kernel.launches > before
    want = spotting.summarize_match(*weights.from_jax(p_np, s_np, device="cpu"),
                                    weights.tree_from_jax(t_np, device="cpu"), visual, None, iv, cfg,
                                    peak_window=3, device="cpu")
    np.testing.assert_allclose(got.scores, want.scores, atol=1e-4)
    np.testing.assert_array_equal(got.events, want.events)


@pytest.mark.parametrize("window", [0, 6])
def test_transformer_scorer_with_one_wide_head_card_matches_cpu(dev, window):
    """summarize_match with a transformer of one head of 256 (the 256-wide kernels) against the CPU."""
    import dataclasses

    from cvml_goalnet_tpu_torch import spotting

    cfg = PipelineConfig(
        preprocess=PreprocessConfig(frame_size=(24, 24)),
        model=ModelConfig(vis_channels=(8, 16, 16), vis_feature_dim=32, aud_channels=(8, 16), aud_feature_dim=16,
                          fusion_hidden=(32, 16), audio_included=False, temporal_model="transformer",
                          temporal_hidden=256, temporal_num_heads=1, temporal_max_len=128),
    )
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, temporal_window=window))
    p_np, s_np = weights.init_params(cfg, seed=9)
    t_np = weights.init_temporal_params(cfg.model, 32, seed=10)
    visual = np.random.default_rng(11).random((90, 24, 24, 3)).astype(np.float32)
    iv = np.array([[0, 900], [900, 1800], [1800, 2700]])
    kernel = FA.flash_local_fwd if window else FA.flash_fwd
    before = kernel.launches
    got = spotting.summarize_match(*weights.from_jax(p_np, s_np), weights.tree_from_jax(t_np), visual, None, iv,
                                   cfg, peak_window=3)
    assert kernel.launches > before
    want = spotting.summarize_match(*weights.from_jax(p_np, s_np, device="cpu"),
                                    weights.tree_from_jax(t_np, device="cpu"), visual, None, iv, cfg,
                                    peak_window=3, device="cpu")
    np.testing.assert_allclose(got.scores, want.scores, atol=1e-4)
    np.testing.assert_array_equal(got.events, want.events)


@pytest.mark.parametrize("window", [0, 7])
def test_public_attention_grads_card_match_cpu(dev, window):
    """The autograd Functions on the card (both kernels of the form) against the same Functions on the CPU."""
    x = [np.random.default_rng(130 + i).standard_normal((2, 300, 64)).astype(np.float32) for i in range(4)]
    grads = {}
    for where in ("cuda", "cpu"):
        q, k, v = (torch.tensor(a, device=where, requires_grad=True) for a in x[:3])
        out = FA.flash_attention_local(q, k, v, window) if window else FA.flash_attention(q, k, v)
        # the cotangent arrives permuted, as from the transformer's head merge
        out.permute(1, 0, 2).mul(torch.as_tensor(x[3], device=where).permute(1, 0, 2)).sum().backward()
        grads[where] = [t.grad.cpu() for t in (q, k, v)]
    _bwd_check(grads["cuda"], grads["cpu"])


def test_raw_kernel_wrappers_refuse_to_cut_the_gradient(dev):
    """Forward-only kernels raise on tensors that require grad with grad mode on, and run under no_grad."""
    q = torch.zeros((1, 16, 32), device=dev, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        FA.flash_fwd(q, q, q, 0.1)
    with pytest.raises(RuntimeError, match="no backward"):
        FA.flash_local_fwd(q, q, q, 0.1, 4)
    w = torch.zeros((8, 4), device=dev, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        head_matmul(torch.zeros((2, 8), device=dev), w, torch.zeros(4, device=dev))
    with pytest.raises(RuntimeError, match="no backward"):
        fused_fusion_mlp(torch.zeros((2, 8), device=dev), [{"w": w, "b": torch.zeros(4, device=dev)}])
    with pytest.raises(RuntimeError, match="no backward"):
        fused_conv_pool_stage(torch.zeros((1, 5, 5, 8), device=dev, requires_grad=True),
                              torch.zeros((3, 3, 8, 4), device=dev), torch.zeros((5, 5, 4), device=dev))
    frames = torch.zeros((1, 8, 8, 3), device=dev, requires_grad=True)
    taps = resize_taps_on(8, 4, dev), resize_taps_on(8, 4, dev)
    with pytest.raises(RuntimeError, match="no backward"):
        fused_preprocess_frames(frames, *taps)
    with torch.no_grad():
        FA.flash_fwd(q, q, q, 0.1)
        fused_preprocess_frames(frames, *taps)


def test_spotting_train_step_card_matches_cpu(dev):
    """Two steps of each scorer on the card (flash kernels forward and backward) against the CPU."""
    import dataclasses

    from cvml_goalnet_tpu_torch.train import spotting as TS

    mc = ModelConfig(temporal_hidden=32, temporal_window=40, temporal_max_len=512, temporal_num_heads=1)
    rng = np.random.default_rng(140)
    feats = rng.standard_normal((400, 24)).astype(np.float32)
    labels = (rng.random(400) < 0.02).astype(np.float32)
    for family, window in (("transformer", 40), ("transformer", 0), ("hybrid", 40), ("gru", 0)):
        m = dataclasses.replace(mc, temporal_model=family, temporal_window=window)
        p_np = weights.init_temporal_params(m, 24, seed=141)
        step = TS.make_spotting_train_step(32, lr=1e-3, scorer=family, window=window)
        runs = {}
        for where in ("cuda", "cpu"):
            tp = weights.tree_from_jax(p_np, device=where)
            x, y = torch.as_tensor(feats, device=where), torch.as_tensor(labels, device=where)
            _, g = step.value_and_grad(tp, x, y)
            opt, losses = TS.init_spotting_opt(tp), []
            for _ in range(2):
                tp, opt, loss = step(tp, opt, x, y)
                losses.append(loss.item())
            runs[where] = (losses, [t.cpu() for t in _leaves(g)])
        np.testing.assert_allclose(runs["cuda"][0], runs["cpu"][0], rtol=1e-4)
        for a, b in zip(runs["cuda"][1], runs["cpu"][1]):
            torch.testing.assert_close(a, b, atol=1e-4 * max(1.0, b.abs().max().item()), rtol=0)


def _summarization_train_setup(classifier=False):
    """A small summarization config at dropout 0 (Adam's eps 1e-4, as the CPU parity runs), a seeded state on
    each device, and one 13-frame video's items (3 sub-batches of 5)."""
    import dataclasses

    from cvml_goalnet_tpu_torch.config import AudioConfig, TrainConfig
    from cvml_goalnet_tpu_torch.data.dataset import VideoItem
    from cvml_goalnet_tpu_torch.data.synthetic import synthetic_change_points
    from cvml_goalnet_tpu_torch.train.state import create_train_state

    cfg = PipelineConfig(
        preprocess=PreprocessConfig(frame_size=(24, 24)),
        audio=AudioConfig(n_fft=512, hop_length=128, n_mels=40, n_mfcc=13, bin_length=12),
        model=ModelConfig(vis_channels=(8, 16, 16), vis_feature_dim=32, aud_channels=(8, 16), aud_feature_dim=16,
                          fusion_hidden=(32, 16), dropout_rate=0.0),
        train=TrainConfig(subbatch_size=5, eps=1e-4))
    rng = np.random.default_rng(150)
    n = 13
    item = VideoItem(video_id="v", title="v", visual=torch.as_tensor(rng.random((n, 24, 24, 3)).astype(np.float32)),
                     audio=torch.as_tensor(rng.random((n, 12, 13)).astype(np.float32)),
                     labels=rng.integers(1, 6, n).astype(np.float32),
                     gd_summary_masks=(rng.random((20, n * 30)) < 0.15).astype(np.uint8), full_n_frames=n * 30,
                     clip_intervals=synthetic_change_points(n * 30, 6, seed=150))
    states = {d: create_train_state(151, cfg, classifier, device=d) for d in ("cuda", "cpu")}
    items = {"cpu": item, "cuda": dataclasses.replace(item, visual=item.visual.cuda(), audio=item.audio.cuda())}
    return cfg, states, items


@pytest.mark.parametrize("classifier", [False, True])
def test_summarization_train_step_card_matches_cpu(dev, classifier):
    """One video through the summarization train function on the card (plain ops forward and backward, TF32 off
    in both) against the CPU: first sub-batch gradients 1e-4·max(1, max|g|) per leaf, the video's loss 1e-4
    relative; the train forward launches no kernel."""
    from cvml_goalnet_tpu_torch.train import loop as TL

    cfg, states, items = _summarization_train_setup(classifier)
    fn = TL.make_train_video_fn(cfg, classifier)
    runs = {}
    for where in ("cuda", "cpu"):
        st = states[where]
        v, a, lab, valid, _ = TL._pad_video(items[where], 5, torch.device(where))
        g = fn.value_and_grad(st.params, st.model_state, v[:5], a[:5], lab[:5], valid[:5], None)[3]
        before = (fused_conv_pool_stage.launches, head_matmul.launches, fused_fusion_mlp.launches)
        out = fn(st.params, st.model_state, st.opt_state, v, a, lab, valid, None)
        assert (fused_conv_pool_stage.launches, head_matmul.launches, fused_fusion_mlp.launches) == before
        runs[where] = ([t.cpu() for t in _leaves(g)], float(out[4]), out[2].step)
    assert runs["cuda"][2] == runs["cpu"][2] == 3
    assert runs["cuda"][1] == pytest.approx(runs["cpu"][1], rel=1e-4)
    for a, b in zip(runs["cuda"][0], runs["cpu"][0]):
        torch.testing.assert_close(a, b, atol=1e-4 * max(1.0, b.abs().max().item()), rtol=0)


def test_summarization_eval_launches_kernels_2_to_4(dev):
    """``eval_video`` on the card runs the eval forward under no grad: kernel 2 twice, kernels 3 and 4 once, and
    its predictions within 1e-4 of the CPU's (the eval-mode train-batchnorm compat path launches none)."""
    import dataclasses

    from cvml_goalnet_tpu_torch.train import loop as TL

    cfg, states, items = _summarization_train_setup()
    before = (fused_conv_pool_stage.launches, head_matmul.launches, fused_fusion_mlp.launches)
    got, loss = TL.eval_video(states["cuda"], items["cuda"], cfg)
    assert (fused_conv_pool_stage.launches, head_matmul.launches, fused_fusion_mlp.launches) == tuple(
        b + k for b, k in zip(before, (2, 1, 1)))
    want, want_loss = TL.eval_video(states["cpu"], items["cpu"], cfg)
    np.testing.assert_allclose(got, want, atol=1e-4)
    assert loss == pytest.approx(want_loss, rel=1e-4)
    compat = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, eval_train_mode_compat=True))
    before = (fused_conv_pool_stage.launches, head_matmul.launches, fused_fusion_mlp.launches)
    got, _ = TL.eval_video(states["cuda"], items["cuda"], compat)
    assert (fused_conv_pool_stage.launches, head_matmul.launches, fused_fusion_mlp.launches) == before
    np.testing.assert_allclose(got, TL.eval_video(states["cpu"], items["cpu"], compat)[0], atol=1e-4)


def _leaves(tree):
    from cvml_goalnet_tpu_torch.train.optim import tree_leaves

    return tree_leaves(tree)


def _parity_cfg(audio: bool):
    import dataclasses
    import os

    cfg = PipelineConfig.load(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs",
                                           "reference_parity.json"))
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, audio_included=audio))


@pytest.mark.parametrize("rows", [3, 22, 64, 150])
def test_fused_mlp_at_the_no_audio_trunks_512_wide_input(dev, rows):
    """Kernel 4 with the fusion layers of a no-audio trunk at reference_parity width (512 → 512 → 512 → 256 →
    128 → 1), at the row counts a stream gives it."""
    p_np, _ = weights.init_params(_parity_cfg(False), seed=13)
    layers = weights.tree_from_jax(p_np["fusion"])
    assert layers[0]["w"].shape[0] == 512
    x = torch.relu(_rand((rows, 512), 14))
    before = fused_fusion_mlp.launches
    got = fused_fusion_mlp(x, layers)
    assert fused_fusion_mlp.launches == before + 1
    torch.testing.assert_close(got, fused_fusion_mlp_plain(x, layers), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("staging", [1, 2, 3])
@pytest.mark.parametrize("host_preprocess,tdtype", [(False, None), (True, None), (True, np.uint8)])
def test_stream_card_matches_cpu(dev, staging, host_preprocess, tdtype, monkeypatch):
    """score_video_stream at reference_parity width (no audio): 41 chunks of 3 distinct 180×320 frames, then
    one of 2, through 1–3 pinned staging buffers, against the same stream on the CPU (1e-4).  A staging
    buffer written before its copy landed would hand the card another chunk's frames.  Kernel 1 launches once
    a chunk with device preprocessing and never with host preprocessing."""
    from cvml_goalnet_tpu_torch import streaming
    from cvml_goalnet_tpu_torch.streaming import score_video_stream

    monkeypatch.setattr(streaming, "STAGING_BUFFERS", staging)
    cfg = _parity_cfg(False)
    p_np, s_np = weights.init_params(cfg, seed=15)
    frames = np.random.default_rng(16).integers(0, 256, (125, 180, 320, 3), dtype=np.uint8)
    chunks = lambda: (frames[i:i + 3] for i in range(0, len(frames), 3))
    kw = dict(chunk_size=3, host_preprocess=host_preprocess, transfer_dtype=tdtype, max_inflight=2)
    before = {f: f.launches for f in (fused_preprocess_frames, fused_conv_pool_stage, head_matmul, fused_fusion_mlp)}
    got, stats = score_video_stream(*weights.from_jax(p_np, s_np), chunks(), cfg, **kw)
    launched = {f: f.launches - n for f, n in before.items()}
    want, _ = score_video_stream(*weights.from_jax(p_np, s_np, device="cpu"), chunks(), cfg, device="cpu", **kw)
    assert stats.chunks == 42 and stats.frames == 125
    np.testing.assert_allclose(got, want, atol=1e-4)
    assert launched[fused_preprocess_frames] == (0 if host_preprocess else 42)
    assert launched[fused_conv_pool_stage] == 84 and launched[head_matmul] == 42 and launched[fused_fusion_mlp] == 42


def _serving_cfg() -> PipelineConfig:
    return PipelineConfig(
        preprocess=PreprocessConfig(skip_frames=30, frame_size=(24, 24)),
        model=ModelConfig(vis_channels=(8, 16, 16), vis_feature_dim=32, aud_channels=(8, 16), aud_feature_dim=16,
                          fusion_hidden=(32, 16), audio_included=False),
    )


def test_batcher_on_the_card_matches_summarize_frames(dev):
    """The batcher (host preprocess, kernels 2–4 on bucket-padded batches) against ``summarize_frames`` (kernel 1
    on the card) on the same requests: scores within 1e-4, the host-preprocess bound of the stream tests."""
    from cvml_goalnet_tpu_torch.serve import DynamicBatcher, Summarizer

    cfg = _serving_cfg()
    s = Summarizer(cfg)
    rng = np.random.default_rng(0)
    reqs = [rng.integers(0, 255, (n, 72, 96, 3), dtype=np.uint8) for n in (30, 7, 64, 0, 100)]
    with DynamicBatcher(s, max_batch_frames=128, max_wait_ms=200.0, buckets=(32, 64, 128)) as batcher:
        batcher.warmup()
        futs = [batcher.submit(f"v{i}", r) for i, r in enumerate(reqs)]
        for r, f in zip(reqs, futs):
            got, want = f.result(timeout=300), s.summarize_frames("v", r)
            assert got.scores.shape == want.scores.shape == (len(r),)
            np.testing.assert_allclose(got.scores, want.scores, atol=1e-4)
        assert batcher.stats["batches"] < batcher.stats["requests"]


def test_cold_server_answers_two_concurrent_first_requests(tmp_path):
    """A server started without a warmup, on a fresh build directory, in a fresh process: two requests at
    once both answer 200 with the same scores, each kernel library is built once and no temporary file stays."""
    import subprocess
    import sys
    from pathlib import Path

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    repo = Path(__file__).resolve().parents[1]
    np.savez(str(tmp_path / "v.npz"), frames=np.random.default_rng(1).integers(0, 255, (900, 72, 96, 3), np.uint8))
    code = f"""
import json, sys, threading, urllib.request
from pathlib import Path
from cvml_goalnet_tpu_torch import runtime
from cvml_goalnet_tpu_torch.ops.cuda import _build
fresh = Path({str(tmp_path / 'build')!r})
_build.BUILD_DIR = runtime.BUILD_DIR = fresh
sys.path.insert(0, {str(repo / 'tests')!r})
from test_torch_cuda_kernels import _serving_cfg
from cvml_goalnet_tpu_torch.serve import Summarizer, start_http_background
server = start_http_background(Summarizer(_serving_cfg()), port=0, media_root={str(tmp_path)!r})
port = server.server_address[1]
out = [None, None]
gate = threading.Barrier(2)
def post(i):
    gate.wait()
    req = urllib.request.Request(f"http://127.0.0.1:{{port}}/summarize", data=b'{{"video": "v.npz"}}', method="POST")
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            out[i] = (r.status, json.load(r))
    except urllib.error.HTTPError as e:
        out[i] = (e.code, json.load(e))
threads = [threading.Thread(target=post, args=(i,)) for i in range(2)]
[t.start() for t in threads]
[t.join() for t in threads]
server.shutdown()
print(json.dumps({{"out": out, "files": sorted(p.name for p in fresh.iterdir())}}))
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    (s0, p0), (s1, p1) = res["out"]
    assert s0 == s1 == 200, res["out"]
    assert p0 == p1
    libs = [f for f in res["files"] if f.endswith(".so")]
    assert sorted(f.split("-")[0] for f in libs) == sorted(
        ["libfused_preprocess", "libfused_stage", "libmatmul", "libfused_mlp", "libgoalnet_runtime"]), res["files"]
    assert not [f for f in res["files"] if f.endswith(".tmp")]


# ---------------------------------------------------------------- the bf16 and int8 forms of kernels 2-4
#
# bf16 forms against their plain versions (the same roundings; float32 sums in another order): each output
# within 2 bf16 ulps of max(|output|, 2·|bias|), the bias over the pool window for kernel 2 (a float32 sum
# that lands on a bf16 tie rounds one way or the other, and an ulp of a sum the bias then cancels counts at
# the sum's size), plus 1e-6·max|plain| for signs that flip at ReLU's 0.  int8 forms: the int32 sums are
# exact on both sides, so outputs agree to 1e-6 relative of max|plain| (in practice to the bit).

from cvml_goalnet_tpu_torch.ops.cuda.fused_mlp import fused_fusion_mlp_bf16, fused_fusion_mlp_bf16_plain
from cvml_goalnet_tpu_torch.ops.cuda.fused_stage import (fused_conv_pool_stage_bf16, fused_conv_pool_stage_bf16_plain,
                                                         fused_conv_pool_stage_int8, fused_conv_pool_stage_int8_plain)
from cvml_goalnet_tpu_torch.ops.cuda.matmul import head_matmul_bf16, head_matmul_bf16_plain


def bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 values at |v| (8 significant bits), at least that of the smallest normal."""
    e = torch.floor(torch.log2(v.abs().to(torch.float32).clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


def assert_bf16_close(got: torch.Tensor, want: torch.Tensor, scale: torch.Tensor, what: str) -> None:
    assert got.dtype == want.dtype == torch.bfloat16 and got.shape == want.shape, what
    if not want.numel():
        return
    g, w = got.to(torch.float32), want.to(torch.float32)
    assert torch.isfinite(g).all(), what
    ref = torch.maximum(torch.maximum(g.abs(), w.abs()), scale.to(torch.float32))
    tol = 2 * bf16_ulp(ref) + 1e-6 * w.abs().max()
    bad = (g - w).abs() > tol
    assert not bad.any(), f"{what}: {int(bad.sum())} outputs past 2 bf16 ulps, worst {float((g - w).abs().max())}"


STAGE_LOWP_CASES = [
    (64, 13, 64, 256),     # conv1
    (64, 11, 256, 512),    # conv2
    (5, 9, 20, 70),        # Cin and Cout off the padding multiples
    (3, 21, 32, 64),       # a frame past one block: tiles with a recomputed halo
    (2, 3, 16, 64),        # the smallest frame
    (0, 13, 64, 256),      # no frames
    (1, 13, 64, 256),      # one frame: the int8 kernel's block holds less than its m64 tiles
]


def _stage_inputs(dev, n, hh, cin, cout, seed):
    x = _rand((n, hh, hh, cin), seed, dev=dev).relu()
    w = _rand((3, 3, cin, cout), seed + 1, 0.05, dev)
    b = _rand((hh, hh, cout), seed + 2, 0.1, dev)
    return x, w, b


STAGE_BF16_CASES = STAGE_LOWP_CASES + [
    (1050, 13, 64, 256),   # conv1 at the summarization batch's N
    (1050, 11, 256, 512),  # conv2 at the summarization batch's N
    (2, 11, 64, 200),      # Cout off both block widths but a multiple of 8 (no copy of w)
    (2, 64, 256, 512),     # a frame past one block: tiles with a recomputed halo, TMA boxes across the edges
]


@pytest.mark.parametrize("n,hh,cin,cout", STAGE_BF16_CASES)
def test_stage_bf16_matches_plain(dev, n, hh, cin, cout):
    x, w, b = (t.to(torch.bfloat16) for t in _stage_inputs(dev, n, hh, cin, cout, 3))
    before = fused_conv_pool_stage.launches, fused_conv_pool_stage_bf16.launches
    got = fused_conv_pool_stage(x, w, b)   # dispatches to the bf16 form
    torch.cuda.synchronize()
    assert (fused_conv_pool_stage.launches, fused_conv_pool_stage_bf16.launches) == (before[0], before[1] + (n > 0))
    want = fused_conv_pool_stage_bf16_plain(x, w, b)
    bias_window = torch.nn.functional.max_pool2d(b.to(torch.float32).abs().permute(2, 0, 1)[None], 3, 1)[0]
    assert_bf16_close(got, want, 2 * bias_window.permute(1, 2, 0)[None], f"stage bf16 {[n, hh, cin, cout]}")
    if n:
        assert torch.equal(got, fused_conv_pool_stage_bf16(x, w, b)), "two runs on the same inputs differ"


def test_stage_bf16_reads_w_as_stored(dev, monkeypatch):
    """At the path's shapes (Cin 64 and 256, Cout a multiple of 8) the bf16 form hands the kernel x, w and b as
    they are: no copy, no repack."""
    for n, hh, cin, cout in ((3, 13, 64, 256), (2, 11, 256, 512)):
        x, w, b = (t.to(torch.bfloat16) for t in _stage_inputs(dev, n, hh, cin, cout, 4))
        seen = []
        real = stage_plan._aligned16
        monkeypatch.setattr(stage_plan, "_aligned16", lambda t: seen.append(t) or real(t))
        fused_conv_pool_stage_bf16(x, w, b)
        monkeypatch.setattr(stage_plan, "_aligned16", real)
        assert [t.data_ptr() for t in seen] == [x.data_ptr(), w.data_ptr(), b.data_ptr()]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,hh,cin,cout", STAGE_LOWP_CASES)
def test_stage_int8_matches_plain(dev, dtype, n, hh, cin, cout):
    x, w, b = _stage_inputs(dev, n, hh, cin, cout, 5)
    x, b = x.to(dtype), b.to(dtype)
    before = fused_conv_pool_stage_int8.launches
    got = fused_conv_pool_stage_int8(x, w, b)
    torch.cuda.synchronize()
    assert fused_conv_pool_stage_int8.launches == before + (n > 0)
    want = fused_conv_pool_stage_int8_plain(x, w, b)
    assert got.dtype == want.dtype == dtype and got.shape == want.shape
    if n:
        err = (got.to(torch.float32) - want.to(torch.float32)).abs().max().item()
        assert err <= 1e-6 * want.to(torch.float32).abs().max().item(), err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stage_int8_takes_a_given_batch_scale(dev, dtype):
    """Inside ``quant.batch_scales`` (a data-parallel block) the 2-int8 wrapper launches the amax kernel, reduces
    its scale and passes the result to the C entry, which quantizes with it: an identity reduction gives the
    call's own bits, and a scale 3x the block's equals the plain version under the same reduction (int8 codes
    and int32 sums exact: 1e-6 relative)."""
    from cvml_goalnet_tpu_torch.ops import quant
    from cvml_goalnet_tpu_torch.ops.cuda.fused_stage import act_scale_int8

    x, w, b = _stage_inputs(dev, 37, 15, 64, 256, 11)
    x, b = x.to(dtype), b.to(dtype)
    alone = fused_conv_pool_stage_int8(x, w, b)
    before = act_scale_int8.launches
    with quant.batch_scales(lambda s: s):
        same = fused_conv_pool_stage_int8(x, w, b)
    torch.cuda.synchronize()
    assert act_scale_int8.launches == before + 1
    assert torch.equal(same, alone)
    with quant.batch_scales(lambda s: s * 3):
        got = fused_conv_pool_stage_int8(x, w, b)
        want = fused_conv_pool_stage_int8_plain(x.cpu(), w.cpu(), b.cpu())
    err = (got.cpu().to(torch.float32) - want.to(torch.float32)).abs().max().item()
    assert err <= 1e-6 * want.to(torch.float32).abs().max().item(), err
    assert not torch.equal(got, alone)


@pytest.mark.parametrize("m,k,n", [(150, 41472, 512), (1050, 41472, 512), (37, 1000, 60), (5, 24, 8), (0, 64, 64),
                                   (1, 41472, 512), (64, 41472, 512), (65, 41472, 512), (5400, 41472, 512),
                                   (65, 1000, 512)])   # K = 1000: a ragged last 64-deep box
def test_head_bf16_matches_plain(dev, m, k, n):
    x = _rand((m, k), 7, dev=dev).relu().to(torch.bfloat16)
    w = _rand((k, n), 8, k ** -0.5, dev).to(torch.bfloat16)
    b = _rand((n,), 9, 0.1, dev).to(torch.bfloat16)
    before = head_matmul.launches, head_matmul_bf16.launches
    got = head_matmul(x, w, b)
    torch.cuda.synchronize()
    assert (head_matmul.launches, head_matmul_bf16.launches) == (before[0], before[1] + (m > 0))
    want = head_matmul_bf16_plain(x, w, b)
    assert_bf16_close(got, want, 2 * b.abs()[None], f"head bf16 {[m, k, n]}")
    if m:
        assert torch.equal(got, head_matmul(x, w, b)), "two runs on the same inputs differ"


@pytest.mark.parametrize("m,dims,squash", [(1050, (640, 512, 512, 256, 128, 1), True),
                                           (5400, (640, 512, 512, 256, 128, 1), True),
                                           (7, (48, 33, 17, 1), True),   # widths off 8: zero-padded for TMA
                                           (40, (640, 512, 512, 256, 128, 5), False),
                                           (0, (640, 512, 1), True),
                                           (1050, (512, 512, 512, 256, 128, 1), True),   # --no-audio's input
                                           (1, (640, 512, 512, 256, 128, 1), True),
                                           (63, (640, 512, 512, 256, 128, 1), True),
                                           (65, (640, 512, 512, 256, 128, 1), True),
                                           (9, (640, 1), True),    # one layer: the CUDA-core layer alone
                                           (33, (64, 128, 64, 192, 64, 96, 64, 64, 1), False),   # eight layers
                                           (150, (640, 512, 512, 256, 128, 16), True)])   # the widest last layer
def test_mlp_bf16_matches_plain(dev, m, dims, squash):
    gen = np.random.default_rng(11)
    layers = [{"w": torch.as_tensor(gen.standard_normal((a, c)) * a ** -0.5 * 2, dtype=torch.bfloat16, device=dev),
               "b": torch.as_tensor(gen.standard_normal(c) * 0.1, dtype=torch.bfloat16, device=dev)}
              for a, c in zip(dims[:-1], dims[1:])]
    x = torch.as_tensor(gen.random((m, dims[0])), dtype=torch.bfloat16, device=dev)
    before = fused_fusion_mlp.launches, fused_fusion_mlp_bf16.launches
    got = fused_fusion_mlp(x, layers, 1.0, 5.0, squash)
    torch.cuda.synchronize()
    assert (fused_fusion_mlp.launches, fused_fusion_mlp_bf16.launches) == (before[0], before[1] + (m > 0))
    want = fused_fusion_mlp_bf16_plain(x, layers, 1.0, 5.0, squash)
    assert_bf16_close(got, want, torch.zeros(()), f"mlp bf16 {[m, *dims]}")
    if squash and m:
        g = got.to(torch.float32)
        assert ((g >= 1) & (g <= 5)).all()
        assert (g - want.to(torch.float32)).abs().max() <= 0.0625   # 2 bf16 ulps on [4, 5]
    if m:
        assert torch.equal(got, fused_fusion_mlp(x, layers, 1.0, 5.0, squash)), "two runs on the same inputs differ"


@pytest.mark.parametrize("rows", mlp_plan.BF16_ROWS)
@pytest.mark.parametrize("cluster", range(1, 9))
def test_mlp_bf16_every_plan(dev, rows, cluster):
    """4-bf16 under every (rows per tile, cluster) at M = 1050 with the fusion widths: within 2 bf16 ulps of the
    plain version, one launch, equal bits on a repeat."""
    gen = np.random.default_rng(12)
    dims = (640, 512, 512, 256, 128, 1)
    layers = [{"w": torch.as_tensor(gen.standard_normal((a, c)) * a ** -0.5 * 2, dtype=torch.bfloat16, device=dev),
               "b": torch.as_tensor(gen.standard_normal(c) * 0.1, dtype=torch.bfloat16, device=dev)}
              for a, c in zip(dims[:-1], dims[1:])]
    x = torch.as_tensor(gen.random((1050, 640)), dtype=torch.bfloat16, device=dev)
    before = fused_fusion_mlp_bf16.launches
    got = mlp_plan.fused_fusion_mlp_bf16_planned(x, layers, rows, cluster)
    torch.cuda.synchronize()
    assert fused_fusion_mlp_bf16.launches == before + 1
    assert_bf16_close(got, fused_fusion_mlp_bf16_plain(x, layers), torch.zeros(()), f"mlp bf16 plan {rows}x{cluster}")
    assert torch.equal(got, mlp_plan.fused_fusion_mlp_bf16_planned(x, layers, rows, cluster))


@pytest.mark.parametrize("cin,cout", [(64, 256), (256, 512), (20, 70)])
def test_int8_weight_pack_matches_plain(dev, cin, cout):
    """The int8 form's weight kernel: packed weights (Cout, 3, 3, Cin_p) and per-channel scales bit-equal to the
    plain pack (which equals ops/quant.py's, tests/test_torch_lowp_plans.py)."""
    w = _rand((3, 3, cin, cout), 21, 0.05, dev)
    w[..., 1] = 0.0   # an all-zero channel takes the 1e-12 floor
    before = stage_plan.pack_weights_int8.launches
    wq, s_w = stage_plan.pack_weights_int8(w)
    torch.cuda.synchronize()
    assert stage_plan.pack_weights_int8.launches == before + 1
    wq_plain, s_plain = stage_plan.pack_weights_int8_plain(w)
    assert torch.equal(wq, wq_plain) and torch.equal(s_w, s_plain)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1050, 13, 13, 64), (64, 11, 11, 256), (3, 7, 5, 3)])
def test_int8_act_scale_matches_plain(dev, dtype, shape):
    """The amax pass: s_x bit-equal to ops/quant.py's act_scale (and the plain amax pass)."""
    from cvml_goalnet_tpu_torch.ops import quant

    x = _rand(shape, 22, 3.0, dev).relu().to(dtype)
    before = stage_plan.act_scale_int8.launches
    s_x = stage_plan.act_scale_int8(x)
    torch.cuda.synchronize()
    assert stage_plan.act_scale_int8.launches == before + 1
    assert torch.equal(s_x, quant.act_scale(x)) and torch.equal(s_x, stage_plan.act_scale_int8_plain(x))


def test_quant_scale_divides_on_the_card_as_on_the_cpu(dev):
    """ops/quant.py's scale max(amax / 127, 1e-12) on the card is the CPU's (and JAX's) quotient: PyTorch divides a
    CUDA tensor by a Python scalar as a product with the scalar's reciprocal, one bit off on these values."""
    from cvml_goalnet_tpu_torch.ops import quant

    amax = torch.tensor([3.1848085, 2.7073061, 1.5512094], dtype=torch.float32)
    for a in amax:
        x = torch.stack([a, -a / 2])
        assert torch.equal(quant.act_scale(x.to(dev)).cpu(), quant.act_scale(x))
    w = torch.stack([amax, -amax / 3]).reshape(1, 1, 2, 3)
    q_card, s_card = quant.quantize_weights_per_channel(w.to(dev), axis=3)
    q_cpu, s_cpu = quant.quantize_weights_per_channel(w, axis=3)
    assert torch.equal(s_card.cpu(), s_cpu) and torch.equal(q_card.cpu(), q_cpu)


def test_wgmma_forms_take_views_off_16_byte_alignment(dev):
    """TMA takes no base off a 16-byte boundary: the head copies such an operand to an aligned buffer, the int8
    form copies x; each gives what the aligned input gives."""
    x = _rand((65, 1000), 23, dev=dev).relu().to(torch.bfloat16)
    w = _rand((1000, 64), 24, 1000 ** -0.5, dev).to(torch.bfloat16)
    b = _rand((64,), 25, 0.1, dev).to(torch.bfloat16)
    xs = torch.empty(x.numel() + 1, dtype=torch.bfloat16, device=dev)[1:].view(x.shape)
    xs.copy_(x)
    assert xs.data_ptr() % 16 != 0
    assert torch.equal(head_matmul_bf16(xs, w, b), head_matmul_bf16(x, w, b))
    xi, wi, bi = _stage_inputs(dev, 3, 13, 64, 256, 26)
    shifted = torch.empty(xi.numel() + 1, device=dev)[1:].view(xi.shape)
    shifted.copy_(xi)
    assert shifted.data_ptr() % 16 != 0
    got = fused_conv_pool_stage_int8(shifted, wi, bi)
    torch.cuda.synchronize()
    assert torch.equal(got, fused_conv_pool_stage_int8(xi, wi, bi))


def test_lowp_forms_refuse_other_dtypes(dev):
    x = torch.zeros((2, 13, 13, 64), device=dev, dtype=torch.float16)
    with pytest.raises(ValueError, match="must be contiguous float32"):
        fused_conv_pool_stage(x, torch.zeros((3, 3, 64, 64), device=dev, dtype=torch.float16),
                              torch.zeros((13, 13, 64), device=dev, dtype=torch.float16))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fused_conv_pool_stage_int8(x, torch.zeros((3, 3, 64, 64), device=dev),
                                   torch.zeros((13, 13, 64), device=dev, dtype=torch.float16))
    xb = torch.zeros((2, 64), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="must be contiguous bfloat16"):
        head_matmul(xb, torch.zeros((64, 8), device=dev), torch.zeros((8,), device=dev))
    with pytest.raises(ValueError, match="must be contiguous bfloat16"):
        fused_fusion_mlp(xb, [{"w": torch.zeros((64, 1), device=dev), "b": torch.zeros((1,), device=dev)}])


def _preset_cfg():
    import dataclasses
    from pathlib import Path

    cfg = PipelineConfig.load(str(Path(__file__).resolve().parents[1] / "configs" / "tpu_serving.json"))
    return cfg, dataclasses


@pytest.mark.parametrize("dtype,quant", [("bfloat16", False), ("float32", True), ("bfloat16", True)])
def test_preset_fuse_card_matches_cpu_and_launches_the_forms(dev, dtype, quant):
    """fuse at the preset's full width on 64 frames, card against CPU (the same roundings; one bf16 ulp of
    [4, 5] is 0.03125), with the forms of this dtype launched and the float32 kernels 2-4 not in bf16."""
    cfg, dataclasses = _preset_cfg()
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, dtype=dtype, quantized_inference=quant))
    p_np, s_np = weights.init_params(cfg, 0)
    gen = np.random.default_rng(4)
    feats = {"visual": gen.random((64, 40, 40, 3)).astype(np.float32),
             "audio": gen.standard_normal((64, 30, 30)).astype(np.float32)}
    tp, ts = weights.from_jax(p_np, s_np)
    counted = (fused_conv_pool_stage, fused_conv_pool_stage_bf16, fused_conv_pool_stage_int8, head_matmul,
               head_matmul_bf16, fused_fusion_mlp, fused_fusion_mlp_bf16)
    for f in counted:
        f.launches = 0
    card = fuse(tp, ts, feats, cfg)
    got = {f.__name__: f.launches for f in counted}
    cp, cs = weights.from_jax(p_np, s_np, device="cpu")
    cpu = fuse(cp, cs, feats, cfg, device="cpu")
    tol = 1e-4 if dtype == "float32" else 0.0625
    assert np.abs(card - cpu).max() <= tol
    bf16 = dtype == "bfloat16"
    want = {"fused_conv_pool_stage": 0 if bf16 or quant else 2, "fused_conv_pool_stage_bf16": 2 if bf16 and not quant else 0,
            "fused_conv_pool_stage_int8": 2 if quant else 0, "head_matmul": 0 if bf16 else 1,
            "head_matmul_bf16": 1 if bf16 else 0, "fused_fusion_mlp": 0 if bf16 else 1,
            "fused_fusion_mlp_bf16": 1 if bf16 else 0}
    assert got == want
    if bf16:   # the scores lie on the bf16 grid
        assert torch.equal(torch.from_numpy(card).to(torch.bfloat16).to(torch.float32), torch.from_numpy(card))


# ---------------------------------------------------------------- kernel 4 behind the text branch and MoE

def _text_moe_layers(text: bool, moe: bool, bf16: bool):
    """The fusion layers kernel 4 takes at reference_parity width: the whole 768-wide chain with the text branch
    ([audio 128 ‖ visual 512 ‖ text 128] → 512 → 512 → 256 → 128 → 1), or after an MoE first layer its
    remaining 512 → 512 → 256 → 128 → 1."""
    import dataclasses

    cfg = _parity_cfg(True)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, text_included=text,
                                                             fusion_moe_experts=4 if moe else 0))
    layers = weights.tree_from_jax(weights.init_params(cfg, seed=17)[0]["fusion"])
    layers = layers[1:] if moe else layers
    return [{k: v.to(torch.bfloat16) for k, v in lp.items()} for lp in layers] if bf16 else layers


@pytest.mark.parametrize("moe", [False, True])
@pytest.mark.parametrize("rows", [1, 22, 64, 150, 1050, 5400])
def test_fused_mlp_at_the_text_and_moe_chains(dev, moe, rows):
    """Kernel 4 at the 768-wide chain and the post-MoE chain, at the row counts the paths give it: one launch,
    within 1e-5 of the plain version, equal bits on a repeat."""
    layers = _text_moe_layers(not moe, moe, False)
    assert layers[0]["w"].shape[0] == (512 if moe else 768) and len(layers) == (4 if moe else 5)
    x = torch.relu(_rand((rows, layers[0]["w"].shape[0]), 18))
    before = fused_fusion_mlp.launches
    got = fused_fusion_mlp(x, layers)
    assert fused_fusion_mlp.launches == before + 1
    torch.testing.assert_close(got, fused_fusion_mlp_plain(x, layers), atol=1e-5, rtol=1e-5)
    assert torch.equal(got, fused_fusion_mlp(x, layers))


@pytest.mark.parametrize("moe", [False, True])
@pytest.mark.parametrize("rows", [1, 22, 64, 150, 1050, 5400])
def test_mlp_bf16_at_the_text_and_moe_chains(dev, moe, rows):
    """4-bf16 at the same chains: one launch, within 2 bf16 ulps of the plain version (0.0625 on [4, 5]),
    equal bits on a repeat."""
    layers = _text_moe_layers(not moe, moe, True)
    x = torch.relu(_rand((rows, layers[0]["w"].shape[0]), 19)).to(torch.bfloat16)
    before = fused_fusion_mlp_bf16.launches
    got = fused_fusion_mlp(x, layers)
    torch.cuda.synchronize()
    assert fused_fusion_mlp_bf16.launches == before + 1
    want = fused_fusion_mlp_bf16_plain(x, layers)
    assert_bf16_close(got, want, torch.zeros(()), f"mlp bf16 text/moe {rows}")
    assert (got.to(torch.float32) - want.to(torch.float32)).abs().max() <= 0.0625
    assert torch.equal(got, fused_fusion_mlp(x, layers))


@pytest.mark.parametrize("text,moe", [(True, False), (False, True), (True, True)])
def test_fuse_with_text_and_moe_card_matches_cpu(dev, text, moe):
    """fuse at reference_parity width with the text branch, the MoE fusion and both on 64 frames with a row of
    empty commentary: card against CPU within 1e-4, kernels 2-4 launched (kernel 4 once)."""
    import dataclasses

    from cvml_goalnet_tpu_torch.data.text import tokenize

    cfg = _parity_cfg(True)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, text_included=text,
                                                             fusion_moe_experts=4 if moe else 0))
    p_np, s_np = weights.init_params(cfg, 0)
    gen = np.random.default_rng(5)
    feats = {"visual": gen.random((64, 40, 40, 3)).astype(np.float32),
             "audio": gen.standard_normal((64, 30, 30)).astype(np.float32),
             "text": tokenize(["", *(f"goal number {i} from the spot" for i in range(63))],
                              cfg.model.text_vocab_size, cfg.model.text_max_len)}
    tp, ts = weights.from_jax(p_np, s_np)
    before = fused_fusion_mlp.launches, head_matmul.launches
    card = fuse(tp, ts, feats, cfg)
    assert (fused_fusion_mlp.launches, head_matmul.launches) == (before[0] + 1, before[1] + 1)
    cp, cs = weights.from_jax(p_np, s_np, device="cpu")
    assert np.abs(card - fuse(cp, cs, feats, cfg, device="cpu")).max() <= 1e-4


# ---------------------------------------------------------------- the resnet and vit backbones

@pytest.mark.parametrize("m,k,n", [(17, 8, 8), (1, 27, 5), (16, 576, 64), (0, 72, 16), (6400, 576, 64),
                                   (1750, 2304, 256), (23328, 27, 64), (5000, 192, 768), (9, 768, 192)])
def test_int8_gemm_is_exact_against_the_float64_product(dev, m, k, n):
    """``quant.int8_matmul`` through ``torch._int_mm`` (rows, K and N padded to what it takes) against the CPU's
    float64 product of the same int8 operands: equal int32 sums, at full ±127 magnitudes."""
    from cvml_goalnet_tpu_torch.ops.quant import int8_matmul

    gen = np.random.default_rng(m + k + n)
    a = torch.as_tensor(gen.integers(-127, 128, (m, k), dtype=np.int8))
    b = torch.as_tensor(gen.integers(-127, 128, (k, n), dtype=np.int8))
    got = int8_matmul(a.to(dev), b.to(dev))
    assert got.dtype == torch.int32 and got.device.type == "cuda"
    assert torch.equal(got.cpu(), int8_matmul(a, b))


@pytest.mark.parametrize("n,hw,cin,cout,stride", [(5, 24, 8, 16, 1), (3, 11, 16, 16, 2), (64, 10, 64, 64, 1),
                                                  (64, 10, 64, 256, 2), (64, 5, 256, 512, 2), (2, 3, 3, 5, 1)])
def test_conv2d_int8_card_matches_cpu(dev, n, hw, cin, cout, stride):
    """The int8 convolution on the card (im2col + cuBLAS's int8 GEMM) against the CPU's float64 convolution:
    equal int32 sums; ``quantized_conv2d`` and ``quantized_linear`` within 1e-6 relative."""
    from cvml_goalnet_tpu_torch.ops import quant

    gen = np.random.default_rng(n * hw + cin)
    x = torch.as_tensor(np.maximum(gen.standard_normal((n, hw, hw, cin)), 0).astype(np.float32))
    w = torch.as_tensor(gen.standard_normal((3, 3, cin, cout)).astype(np.float32) * 0.1)
    xq, _ = quant.quantize_act_per_tensor(x)
    wq, _ = quant.quantize_weights_per_channel(w, axis=3)
    got = quant.conv2d_int8(xq.to(dev), wq.to(dev), stride, 1)
    assert torch.equal(got.cpu(), quant.conv2d_int8(xq, wq, stride, 1))
    want = quant.quantized_conv2d(x, w, stride, 1)
    torch.testing.assert_close(quant.quantized_conv2d(x.to(dev), w.to(dev), stride, 1).cpu(), want,
                               atol=1e-6 * float(want.abs().max()), rtol=0)
    lin = {"w": w.reshape(-1, cout)[:cin], "b": torch.as_tensor(gen.standard_normal(cout).astype(np.float32))}
    want = quant.quantized_linear(lin, x)
    got = quant.quantized_linear({k: v.to(dev) for k, v in lin.items()}, x.to(dev)).cpu()
    torch.testing.assert_close(got, want, atol=1e-6 * float(want.abs().max()), rtol=0)


@pytest.mark.parametrize("backbone", ["resnet", "vit"])
@pytest.mark.parametrize("dtype,quant", [("float32", False), ("float32", True), ("bfloat16", False),
                                         ("bfloat16", True)])
def test_backbone_fuse_card_matches_cpu(dev, backbone, dtype, quant):
    """fuse at reference_parity width with the backbone swapped on 64 frames (and on zero frames), card against
    CPU: within 1e-4 in float32 and under int8 at float32, within 0.0625 in bf16 (on the bf16 grid); kernel 4
    (4-bf16 in bf16) launched once, kernels 2 and 3 not at all."""
    import dataclasses

    from cvml_goalnet_tpu_torch.ops.cuda.fused_mlp import fused_fusion_mlp_bf16

    cfg = _parity_cfg(True)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, vis_backbone=backbone, dtype=dtype,
                                                             quantized_inference=quant))
    p_np, s_np = weights.init_params(cfg, 0)
    gen = np.random.default_rng(6)
    feats = {"visual": gen.random((64, 40, 40, 3)).astype(np.float32),
             "audio": gen.standard_normal((64, 30, 30)).astype(np.float32)}
    tp, ts = weights.from_jax(p_np, s_np)
    mlp = fused_fusion_mlp_bf16 if dtype == "bfloat16" else fused_fusion_mlp
    before = mlp.launches, head_matmul.launches, fused_conv_pool_stage.launches
    card = fuse(tp, ts, feats, cfg)
    assert (mlp.launches, head_matmul.launches, fused_conv_pool_stage.launches) == (before[0] + 1, *before[1:])
    cp, cs = weights.from_jax(p_np, s_np, device="cpu")
    cpu = fuse(cp, cs, feats, cfg, device="cpu")
    assert np.abs(card - cpu).max() <= (1e-4 if dtype == "float32" else 0.0625)
    if dtype == "bfloat16":
        assert torch.equal(torch.from_numpy(card).to(torch.bfloat16).to(torch.float32), torch.from_numpy(card))
    empty = {"visual": feats["visual"][:0], "audio": feats["audio"][:0]}
    assert fuse(tp, ts, empty, cfg).shape == (0,)
