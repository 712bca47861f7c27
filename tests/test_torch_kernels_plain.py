"""PyTorch port: each kernel's plain version against its Pallas kernel (interpret mode).

The same numpy inputs go through the JAX package's Pallas kernel, run in
interpret mode on the CPU as ``tests/test_pallas.py`` runs it, and through the
port's wrapper on CPU tensors, which takes the plain version.  The cases are
those of ``tests/test_pallas.py``.  The CUDA kernels themselves run only on
the card (``tests/test_torch_cuda_kernels.py``).
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvml_goalnet_tpu.models.avm import avm_init
from cvml_goalnet_tpu.ops.pallas.fused_mlp import fused_fusion_mlp as pallas_mlp
from cvml_goalnet_tpu.ops.pallas.fused_preprocess import fused_preprocess_frames as pallas_preprocess
from cvml_goalnet_tpu.ops.pallas.fused_stage import fused_conv_pool_stage as pallas_stage
from cvml_goalnet_tpu.ops.pallas.matmul import head_matmul_pallas
from cvml_goalnet_tpu.ops.preprocess import preprocess_frames as jax_preprocess_frames
from cvml_goalnet_tpu.ops.preprocess import resize_matrices as jax_resize_matrices
from cvml_goalnet_tpu_torch.ops.cuda import _build
from cvml_goalnet_tpu_torch.ops.cuda import fused_mlp as mlp_plan
from cvml_goalnet_tpu_torch.ops.cuda.fused_mlp import fused_fusion_mlp
from cvml_goalnet_tpu_torch.ops.cuda.fused_stage import fused_conv_pool_stage
from cvml_goalnet_tpu_torch.ops.cuda.matmul import BLOCK_K, head_matmul, head_plan
from cvml_goalnet_tpu_torch.ops.preprocess import preprocess_frames, preprocess_frames_host, resize_matrices

MLP_REF = (640, 512, 512, 256, 128, 1)
# the reference, audio off, the 5-way classifier, ragged, one layer, eight layers
MLP_WIDTHS = [MLP_REF, (512, 512, 512, 256, 128, 1), (640, 512, 512, 256, 128, 5), (48, 33, 17, 1), (640, 1),
              (64, 48, 40, 36, 32, 24, 20, 12, 3)]
MLP_ROWS = [1, 7, 8, 9, 31, 32, 33, 150, 300, 600, 1050, 5400]


class TestFusedPreprocess:
    @pytest.mark.parametrize("shape,out_hw,dtype", [
        ((5, 48, 64, 3), (24, 24), np.float32),
        ((3, 36, 36, 3), (24, 24), np.uint8),
        ((2, 180, 320, 3), (40, 40), np.uint8),   # the serving shape
    ])
    def test_plain_matches_pallas(self, rng, shape, out_hw, dtype):
        frames = rng.integers(0, 255, shape).astype(dtype)
        want = np.asarray(pallas_preprocess(jnp.asarray(frames), out_hw, 1e-7, True))
        got = preprocess_frames(torch.from_numpy(frames), out_hw)
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
        np.testing.assert_allclose(got.numpy(), np.asarray(jax_preprocess_frames(jnp.asarray(frames), out_hw)), atol=1e-5)
        np.testing.assert_allclose(preprocess_frames_host(frames, out_hw), want, atol=1e-5)

    @pytest.mark.parametrize("src,dst", [((180, 320), (40, 40)), ((48, 64), (24, 24)), ((7, 5), (11, 13))])
    def test_resize_matrices_match_jax(self, src, dst):
        for got, want in zip(resize_matrices(*src, *dst), jax_resize_matrices(*src, *dst)):
            np.testing.assert_array_equal(got, want)


class TestFusedMLP:
    def test_plain_matches_pallas(self, small_cfg):
        params, _ = avm_init(jax.random.PRNGKey(0), small_cfg.model, small_cfg.preprocess, small_cfg.audio)
        fusion = tuple(params["fusion"])
        d = fusion[0]["w"].shape[0]
        x = np.random.default_rng(0).standard_normal((37, d)).astype(np.float32)
        want = np.asarray(pallas_mlp(jnp.asarray(x), fusion, 1.0, 5.0, 16, True))
        layers = [{k: torch.tensor(np.asarray(v)) for k, v in lp.items()} for lp in fusion]
        got = fused_fusion_mlp(torch.from_numpy(x), layers, 1.0, 5.0)
        assert got.shape == (37, 1)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)

    def test_logits_without_squash(self, small_cfg):
        params, _ = avm_init(jax.random.PRNGKey(0), small_cfg.model, small_cfg.preprocess, small_cfg.audio,
                             classifier=True)
        x = np.random.default_rng(1).standard_normal((9, params["fusion"][0]["w"].shape[0])).astype(np.float32)
        h = jnp.asarray(x)
        for i, lp in enumerate(params["fusion"]):
            h = h @ lp["w"] + lp["b"]
            if i < len(params["fusion"]) - 1:
                h = jax.nn.relu(h)
        layers = [{k: torch.tensor(np.asarray(v)) for k, v in lp.items()} for lp in params["fusion"]]
        got = fused_fusion_mlp(torch.from_numpy(x), layers, squash=False)
        assert got.shape == (9, 5)
        np.testing.assert_allclose(got.numpy(), np.asarray(h), atol=1e-5)

    def test_plain_matches_pallas_at_the_reference_width(self):
        # 640 → 512 → 512 → 256 → 128 → 1 over the summarization batch, in 256-row Pallas tiles
        rng = np.random.default_rng(5)
        fusion = [{"w": (rng.standard_normal((a, b)) * a ** -0.5).astype(np.float32),
                   "b": (rng.standard_normal(b) * 0.1).astype(np.float32)} for a, b in zip(MLP_REF[:-1], MLP_REF[1:])]
        x = rng.standard_normal((1050, MLP_REF[0])).astype(np.float32)
        jax_fusion = tuple({k: jnp.asarray(v) for k, v in lp.items()} for lp in fusion)
        want = np.asarray(pallas_mlp(jnp.asarray(x), jax_fusion, 1.0, 5.0, 256, True))
        got = fused_fusion_mlp(torch.from_numpy(x), [{k: torch.from_numpy(v) for k, v in lp.items()} for lp in fusion])
        assert got.shape == (1050, 1)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


class TestFusedMLPTilePlan:
    """The kernel's tile plan (pure Python): what ``fused_fusion_mlp`` launches on the card."""

    # (BM, C, blocks) at the summarization path's M with the H100 SXM's cluster counts (PERF.md §6)
    PATH_PLANS = {1050: (16, 2, 132), 600: (24, 4, 100), 300: (24, 8, 104), 150: (16, 8, 80)}

    @pytest.mark.parametrize("m", sorted(PATH_PLANS))
    def test_plan_at_the_path_shapes(self, m):
        bm, c = mlp_plan.tile_plan(m, MLP_REF)
        assert (bm, c, -(-m // bm) * c) == self.PATH_PLANS[m]

    @pytest.mark.parametrize("dims", MLP_WIDTHS)
    @pytest.mark.parametrize("m", MLP_ROWS)
    def test_plan_covers_m_and_fits(self, m, dims):
        bm, c = mlp_plan.tile_plan(m, dims)
        assert bm in mlp_plan.BLOCK_ROWS and 1 <= c <= mlp_plan.MAX_CLUSTER
        assert (-(-m // bm) - 1) * bm < m <= -(-m // bm) * bm
        assert mlp_plan.smem_bytes(bm, dims) <= 227 * 1024
        fmas, weight_bytes = mlp_plan.block_work(dims, bm, c)
        mine = [min(mlp_plan.cols_per_block(n, c), n) for n in dims[1:]]
        # the first block's threads do all of its FMAs, and it copies each of its weights once
        assert fmas * mlp_plan.THREADS >= bm * sum(k * n for k, n in zip(dims[:-1], mine))
        assert weight_bytes == 4 * sum(k * n for k, n in zip(dims[:-1], mine))

    @pytest.mark.parametrize("n,c", [(512, 2), (512, 3), (33, 4), (1, 8), (5, 2)])
    def test_column_slices_cover_the_layer(self, n, c):
        per = mlp_plan.cols_per_block(n, c)
        assert per % 4 == 0 and per * c >= n and per < -(-n // c) + 4

    def test_plan_follows_the_cards_cluster_counts(self):
        # a card that runs few clusters of 2 at once pushes M = 1050 off the 16 × 2 plan
        assert mlp_plan.tile_plan(1050, MLP_REF, lambda bm, c: 1 if c == 2 else 132 // c) != (16, 2)

    def test_widths_beyond_shared_memory_raise(self):
        with pytest.raises(ValueError, match="shared memory"):
            mlp_plan.tile_plan(100, (8192, 8192, 1))

    def test_constants_match_the_kernel_source(self):
        src = (_build.CSRC_DIR / "fused_mlp.cu").read_text()
        for name, value in {"kThreads": mlp_plan.THREADS, "kChunkK": mlp_plan.CHUNK_K,
                            "kPassCols": mlp_plan.PASS_COLS, "kStages": mlp_plan.STAGES}.items():
            assert re.search(rf"constexpr int {name} = {value};", src), name
        launched = {int(b) for b in re.findall(r"case (\d+): return launch<\1>", src)}
        assert launched == set(mlp_plan.BLOCK_ROWS)


class TestFusedConvPoolStage:
    # the reference's stage shapes; frame_size (64, 64)'s conv1 and conv2 (21×21, 19×19); a thin frame (3×40)
    @pytest.mark.parametrize("shape", [(20, 13, 13, 8, 16), (9, 11, 11, 16, 32), (2, 21, 21, 8, 16),
                                       (2, 19, 19, 8, 16), (2, 3, 40, 8, 16)])
    def test_plain_matches_pallas(self, shape):
        n, h, w, c, co = shape
        rng = np.random.default_rng(n)
        x = rng.standard_normal((n, h, w, c)).astype(np.float32)
        wt = rng.standard_normal((3, 3, c, co)).astype(np.float32) * 0.05
        b = rng.standard_normal((h, w, co)).astype(np.float32) * 0.1
        want = np.asarray(pallas_stage(jnp.asarray(x), jnp.asarray(wt), jnp.asarray(b), 8, True))
        got = fused_conv_pool_stage(torch.from_numpy(x), torch.from_numpy(wt), torch.from_numpy(b))
        assert got.shape == (n, h - 2, w - 2, co)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


class TestHeadMatmul:
    @pytest.mark.parametrize("m,k,n,bm,bk,relu", [
        (100, 4608, 512, 64, 2304, True),   # padded batch, 2 K steps
        (64, 4608, 128, 64, 1536, True),    # 3 K steps, single M tile
        (130, 2304, 256, 32, 2304, True),   # single K step
        (32, 2304, 128, 32, 1152, False),   # no ReLU
    ])
    def test_plain_matches_pallas(self, m, k, n, bm, bk, relu):
        rng = np.random.default_rng(m + k)
        x = rng.standard_normal((m, k)).astype(np.float32) * 0.1
        w = rng.standard_normal((k, n)).astype(np.float32) * 0.02
        b = rng.standard_normal((n,)).astype(np.float32)
        want = np.asarray(head_matmul_pallas(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), relu, bm, bk, True))
        if not relu:
            assert (want < 0).any()
        got = head_matmul(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b), relu)
        np.testing.assert_allclose(got.numpy(), want, atol=2e-5)

    def test_contraction_mismatch_raises(self):
        with pytest.raises(ValueError, match="contraction mismatch"):
            head_matmul(torch.zeros(8, 1000), torch.zeros(999, 64), torch.zeros(64))

    @pytest.mark.parametrize("m,k,n", [(1050, 41472, 512), (100, 4608, 512), (3, 20, 7), (130, 2304, 256)])
    def test_split_plan_covers_k(self, m, k, n):
        splits, k_chunk = head_plan(m, k, n, 132, 1)   # an H100 SXM's SMs, one resident block each
        assert k_chunk % BLOCK_K == 0 and splits >= 1
        assert (splits - 1) * k_chunk < k <= splits * k_chunk


class TestWrappersAndBuild:
    def test_unsupported_device_raises(self):
        x = torch.empty((2, 13, 13, 8), device="meta")
        with pytest.raises(ValueError, match="unsupported device"):
            fused_conv_pool_stage(x, torch.empty((3, 3, 8, 16), device="meta"), torch.empty((13, 13, 16), device="meta"))

    def test_require_f32_names_the_bad_tensor(self):
        cpu, f32, bf16 = torch.device("cpu"), torch.float32, torch.bfloat16
        _build.require_dtype("k", cpu, f32, x=torch.zeros(2, 3))
        _build.require_dtype("k", cpu, bf16, x=torch.zeros(2, 3, dtype=bf16))
        with pytest.raises(ValueError, match="k: w must be contiguous float32"):
            _build.require_dtype("k", cpu, f32, x=torch.zeros(2, 3), w=torch.zeros(2, 3, dtype=torch.float64))
        with pytest.raises(ValueError, match="k: x must be contiguous float32"):
            _build.require_dtype("k", cpu, f32, x=torch.zeros(3, 2).t())
        with pytest.raises(ValueError, match="k: x must be contiguous bfloat16"):
            _build.require_dtype("k", cpu, bf16, x=torch.zeros(2, 3))

    def test_build_without_nvcc_raises(self, monkeypatch, tmp_path):
        monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
        monkeypatch.setattr(_build.shutil, "which", lambda name: None)
        monkeypatch.setattr(_build.os.path, "exists", lambda p: False)
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.build(["matmul"])

    def test_every_kernel_has_a_source(self):
        for name in _build.KERNELS:
            assert (_build.CSRC_DIR / f"{name}.cu").is_file()
            assert _build.lib_path(name).name.startswith(f"lib{name}-")
