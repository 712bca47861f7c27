"""PyTorch port: each CUDA kernel against its plain version, on the card.

Marked ``cuda``; without a CUDA device every test skips.  The machine with
the card has no JAX, so run the file there without the suite's conftest:

    python -m pytest tests/test_torch_cuda_kernels.py --noconftest -m cuda -q

The shapes include the ragged ones of ``tests/test_pallas.py`` (batch,
channel and K edges) besides the reference widths.
"""

import numpy as np
import pytest
import torch

from cvml_goalnet_tpu_torch import weights
from cvml_goalnet_tpu_torch.config import ModelConfig, PipelineConfig, PreprocessConfig
from cvml_goalnet_tpu_torch.data.synthetic import synthetic_video_frames, synthetic_waveform
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


@pytest.mark.parametrize("shape,out_hw,dtype", [
    ((5, 48, 64, 3), (24, 24), torch.float32),
    ((3, 36, 36, 3), (24, 24), torch.uint8),
    ((7, 180, 320, 3), (40, 40), torch.uint8),
    ((3, 7, 5, 3), (11, 13), torch.uint8),    # 105-byte frames: the unvectorised path
])
def test_preprocess(dev, shape, out_hw, dtype):
    frames = torch.as_tensor(np.random.default_rng(0).integers(0, 256, shape), device=dev).to(dtype)
    taps = resize_taps_on(shape[1], out_hw[0], dev), resize_taps_on(shape[2], out_hw[1], dev)
    before = fused_preprocess_frames.launches
    got = fused_preprocess_frames(frames, *taps)
    assert fused_preprocess_frames.launches == before + 1
    want = fused_preprocess_frames_plain(frames, *taps)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("shape", [
    (20, 13, 13, 8, 16), (9, 11, 11, 16, 32), (2, 5, 7, 3, 70),
    (3, 13, 13, 64, 256), (2, 11, 11, 256, 512), (1, 16, 16, 20, 64),
])
def test_conv_pool_stage(dev, shape):
    n, h, w, c, co = shape
    x, wt, b = _rand((n, h, w, c), 1), _rand((3, 3, c, co), 2, 0.05), _rand((h, w, co), 3, 0.1)
    got = fused_conv_pool_stage(x, wt, b)
    want = fused_conv_pool_stage_plain(x, wt, b)
    torch.testing.assert_close(got, want, atol=1e-4 * want.abs().max().item(), rtol=0)


@pytest.mark.parametrize("m,k,n,relu", [
    (100, 4608, 512, True), (64, 4608, 128, True), (130, 2304, 256, True), (32, 2304, 128, False),
    (3, 20, 7, False), (37, 41472, 512, True),
])
def test_head_matmul(dev, m, k, n, relu):
    x, w, b = _rand((m, k), 4, 0.1), _rand((k, n), 5, 0.02), _rand((n,), 6)
    got = head_matmul(x, w, b, relu)
    torch.testing.assert_close(got, head_matmul_plain(x, w, b, relu), atol=2e-5, rtol=1e-5)
    assert torch.equal(got, head_matmul(x, w, b, relu))  # no atomics: runs repeat exactly


def test_head_matmul_contraction_mismatch(dev):
    with pytest.raises(ValueError, match="contraction mismatch"):
        head_matmul(torch.zeros((8, 1000), device=dev), torch.zeros((999, 64), device=dev), torch.zeros(64, device=dev))


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    x = torch.zeros((64, 16), device=dev)
    with pytest.raises(ValueError, match="x must be contiguous float32"):
        head_matmul(x.t(), torch.zeros((64, 8), device=dev), torch.zeros(8, device=dev))
    with pytest.raises(ValueError, match="H·W ≤ 256"):
        fused_conv_pool_stage(torch.zeros((1, 17, 17, 4), device=dev), torch.zeros((3, 3, 4, 8), device=dev),
                              torch.zeros((17, 17, 8), device=dev))


@pytest.mark.parametrize("dims,squash,rows", [
    ((640, 512, 512, 256, 128, 1), True, 1050), ((48, 32, 16, 1), True, 37), ((48, 32, 16, 5), False, 9),
])
def test_fused_mlp(dev, dims, squash, rows):
    layers = [{"w": _rand((a, b), 10 + i, a ** -0.5), "b": _rand((b,), 20 + i, 0.1)}
              for i, (a, b) in enumerate(zip(dims[:-1], dims[1:]))]
    x = _rand((rows, dims[0]), 7)
    got = fused_fusion_mlp(x, layers, 1.0, 5.0, squash)
    torch.testing.assert_close(got, fused_fusion_mlp_plain(x, layers, 1.0, 5.0, squash), atol=1e-5, rtol=1e-5)


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
