"""PyTorch port: what the cluster preprocess kernel (kernel 1) rests on, on the CPU.

* ``preprocess_bands`` cuts the source rows (and the output rows) into S
  bands that cover every row exactly once, empty bands included when H < S;
  ``stage_chunks`` cuts a band into ring stages that cover it once.
* ``slot_owners`` gives each tap slot (k, a) to the CTA whose band holds its
  source row ``ih[k][a]``, for upscales and clamped edges where one row
  feeds several slots as well.
* A torch emulation of the kernel's band-wise arithmetic (per band lo/hi
  over its ring stages, each slot's horizontal taps from the stage holding
  its row, then the cluster's lo/hi and each CTA's output rows from the two
  slots of each) equals ``fused_preprocess_frames_plain`` bit for bit at
  every cluster size, for uint8 and float32 frames, C = 1, 3 and 4, H < 8
  and an upscale; it also equals the JAX package's ``preprocess_frames`` and
  its Pallas kernel in interpret mode within 1e-5.
* The plan at the main path's shapes (180×320×3 → 40×40 at 1, 150, 300, 600
  and 5400 frames) for an H100's resident CTAs, and the layout's shared
  memory for float32 frames, whose rows are four times wider, and for rows
  and outputs too large for shared memory.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvml_goalnet_tpu.ops.pallas.fused_preprocess import fused_preprocess_frames as pallas_preprocess
from cvml_goalnet_tpu.ops.preprocess import preprocess_frames as jax_preprocess_frames
from cvml_goalnet_tpu_torch.ops.cuda import fused_preprocess as FP
from cvml_goalnet_tpu_torch.ops.preprocess import resize_taps

SOURCE = Path(FP.__file__).resolve().parents[2] / "csrc" / "fused_preprocess.cu"
# Clusters of 1, 2, 4 and 8 CTAs an H100 SXM runs at once at the main path's layout (74,608 bytes of shared
# memory a CTA: three fit an SM's 228 KB); a card test holds these to cudaOccupancyMaxActiveClusters.
H100_AT_ONCE = (396, 198, 92, 45)

# (n, h, w, c, oh, ow, dtype): the main path's shape, float32 frames, an upscale, C = 1 and 4, H < 8 (bands
# empty at S = 8), rows whose bytes are not a multiple of 16, a clamped edge (3 source rows, 5 outputs)
CASES = [
    (1, 180, 320, 3, 40, 40, torch.uint8),
    (150, 180, 320, 3, 40, 40, torch.uint8),
    (2, 180, 320, 3, 40, 40, torch.float32),
    (3, 20, 30, 3, 40, 40, torch.uint8),
    (4, 36, 36, 1, 24, 24, torch.uint8),
    (3, 48, 64, 4, 24, 24, torch.float32),
    (3, 7, 5, 3, 11, 13, torch.uint8),
    (2, 3, 200, 3, 5, 8, torch.float32),
]


def _ids(case):
    n, h, w, c, oh, ow, dtype = case
    return f"{n}x{h}x{w}x{c}-{oh}x{ow}-{str(dtype).split('.')[-1]}"


def _frames(case, seed=0):
    n, h, w, c, _, _, dtype = case
    rng = np.random.default_rng(seed)
    if dtype == torch.uint8:
        return torch.from_numpy(rng.integers(0, 256, (n, h, w, c)).astype(np.uint8))
    return torch.from_numpy((rng.standard_normal((n, h, w, c)) * 40.0 + 7.0).astype(np.float32))


def _taps(h, w, oh, ow):
    return tuple(tuple(torch.from_numpy(a) for a in resize_taps(src, dst)) for src, dst in ((h, oh), (w, ow)))


def emulate(frames, taps_h, taps_w, eps, plan):
    """The kernel's walk in torch, batched over frames (each frame's arithmetic is its own): CTA s streams
    its band in ring stages, takes their min/max and the horizontal taps of the slots it owns from the
    stage that holds each slot's row; then the cluster's lo/hi, and CTA s's output rows from their two
    slots, divided by (hi − lo + eps)."""
    n, h, w, c = frames.shape
    (ih, wh), (iw, ww) = taps_h, taps_w
    oh, nslots = ih.shape[1], 2 * ih.shape[1]
    rows, owners = ih.reshape(-1).tolist(), FP.slot_owners(ih, h, plan.cluster)
    iw = iw.long()
    cols, parts = [None] * nslots, []
    for s, band in enumerate(FP.preprocess_bands(h, plan.cluster)):
        lo = torch.full((n,), float("inf"))
        hi = torch.full((n,), float("-inf"))
        for c0, c1 in FP.stage_chunks(band, plan.layout.rows_per_stage):
            stage = frames[:, c0:c1].to(torch.float32)
            lo = torch.minimum(lo, stage.reshape(n, -1).amin(dim=1))
            hi = torch.maximum(hi, stage.reshape(n, -1).amax(dim=1))
            for j in range(nslots):
                if c0 <= rows[j] < c1:
                    assert owners[j] == s and cols[j] is None
                    row = stage[:, rows[j] - c0]                                   # (n, w, c)
                    cols[j] = ww[0][:, None] * row[:, iw[0]] + ww[1][:, None] * row[:, iw[1]]
        parts.append((lo, hi))
    assert all(x is not None for x in cols)
    lo = torch.stack([p[0] for p in parts]).amin(dim=0)[:, None, None]
    hi = torch.stack([p[1] for p in parts]).amax(dim=0)[:, None, None]
    out = torch.empty((n, oh, iw.shape[1], c), dtype=torch.float32)
    for a0, a1 in FP.preprocess_bands(oh, plan.cluster):
        for a in range(a0, a1):
            v = wh[0][a] * cols[a] + wh[1][a] * cols[oh + a]
            out[:, a] = (v - lo) / (hi - lo + eps)
    return out


def _plan(case, cluster):
    n, h, w, c, oh, ow, dtype = case
    layout = FP.preprocess_layout(h, w, c, oh, ow, 1 if dtype == torch.uint8 else 4)
    return FP.PreprocessPlan(cluster, n, layout)


@pytest.mark.parametrize("parts", FP.CLUSTER_SIZES)
@pytest.mark.parametrize("extent", [1, 3, 5, 7, 20, 40, 180, 1080])
def test_bands_cover_every_row_once(extent, parts):
    bands = FP.preprocess_bands(extent, parts)
    assert len(bands) == parts and bands[0][0] == 0 and bands[-1][1] == extent
    assert all(a1 == b0 for (_, a1), (b0, _) in zip(bands, bands[1:]))
    assert sorted(r for a, b in bands for r in range(a, b)) == list(range(extent))
    sizes = [b - a for a, b in bands]
    assert max(sizes) - min(sizes) <= 1   # balanced; some empty when extent < parts
    assert (min(sizes) == 0) == (extent < parts)
    for s, (a, b) in enumerate(bands):
        assert all(FP.band_owner(r, extent, parts) == s for r in range(a, b))


@pytest.mark.parametrize("rows_per_stage", [1, 2, 7, 8, 64, 500])
@pytest.mark.parametrize("band", [(0, 0), (0, 1), (3, 25), (0, 180), (157, 180)])
def test_stage_chunks_cover_the_band_once(band, rows_per_stage):
    chunks = FP.stage_chunks(band, rows_per_stage)
    assert [r for a, b in chunks for r in range(a, b)] == list(range(*band))
    assert all(0 < b - a <= rows_per_stage for a, b in chunks)
    assert len(chunks) == -(-(band[1] - band[0]) // rows_per_stage)


@pytest.mark.parametrize("parts", FP.CLUSTER_SIZES)
@pytest.mark.parametrize("src,dst", [(180, 40), (20, 40), (7, 11), (3, 5), (1, 4), (36, 24), (1080, 40)])
def test_each_slot_is_owned_by_the_cta_that_holds_its_row(src, dst, parts):
    ih, _ = resize_taps(src, dst)
    owners = FP.slot_owners(torch.from_numpy(ih), src, parts)
    bands = FP.preprocess_bands(src, parts)
    assert len(owners) == 2 * dst
    for j, r in enumerate(ih.reshape(-1).tolist()):
        a, b = bands[owners[j]]
        assert a <= r < b


@pytest.mark.parametrize("src,dst,parts,remote", [(180, 40, 8, 0), (20, 40, 2, 2), (20, 40, 8, 14), (7, 11, 4, 5),
                                                  (36, 24, 8, 4)])
def test_slots_read_from_another_cta(src, dst, parts, remote):
    """Slots whose source row lies in another CTA's band than their output row: the combine reads them through
    distributed shared memory.  At the main path's 180 → 40 every slot is its combining CTA's own."""
    ih, _ = resize_taps(src, dst)
    owners = FP.slot_owners(torch.from_numpy(ih), src, parts)
    assert sum(owners[j] != FP.band_owner(j % dst, dst, parts) for j in range(2 * dst)) == remote


def test_upscale_and_clamped_edges_feed_several_slots_from_one_row():
    ih, _ = resize_taps(20, 40)
    rows = ih.reshape(-1).tolist()
    assert max(rows.count(r) for r in set(rows)) >= 3           # one row, several slots
    assert any(ih[0][a] == ih[1][a] for a in range(40))          # ih0 == ih1 at a clamped edge


@pytest.mark.parametrize("cluster", FP.CLUSTER_SIZES)
@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_emulation_equals_the_plain_version_bit_for_bit(case, cluster):
    n, h, w, c, oh, ow, dtype = case
    frames = _frames(case)
    taps_h, taps_w = _taps(h, w, oh, ow)
    got = emulate(frames, taps_h, taps_w, 1e-7, _plan(case, cluster))
    want = FP.fused_preprocess_frames_plain(frames, taps_h, taps_w, 1e-7)
    assert got.shape == want.shape == (n, oh, ow, c)
    assert torch.equal(got, want)


@pytest.mark.parametrize("case", [cs for cs in CASES if cs[0] <= 4], ids=_ids)
def test_emulation_matches_jax_and_pallas(case):
    n, h, w, c, oh, ow, dtype = case
    frames = _frames(case, seed=1)
    taps_h, taps_w = _taps(h, w, oh, ow)
    cluster = FP.preprocess_plan(n, h, w, c, oh, ow, frames.element_size(), H100_AT_ONCE).cluster
    got = emulate(frames, taps_h, taps_w, 1e-7, _plan(case, cluster)).numpy()
    x = jnp.asarray(frames.numpy())
    np.testing.assert_allclose(got, np.asarray(jax_preprocess_frames(x, (oh, ow), 1e-7)), atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(pallas_preprocess(x, (oh, ow), 1e-7, True)), atol=1e-5)


@pytest.mark.parametrize("n,cluster,clusters", [(1, 8, 1), (45, 8, 45), (49, 8, 25), (50, 4, 50), (99, 4, 50),
                                                (150, 2, 150), (198, 2, 198), (199, 1, 199), (300, 1, 300),
                                                (600, 1, 300), (1050, 1, 350), (5400, 1, 386)])
def test_plan_at_the_main_path_shapes(n, cluster, clusters):
    plan = FP.preprocess_plan(n, 180, 320, 3, 40, 40, 1, H100_AT_ONCE)
    assert (plan.cluster, plan.clusters) == (cluster, clusters)
    # 17 rows of 960 bytes a stage, the 80 slots of 120 floats in shared memory, tables, 12 list starts
    assert plan.layout == FP.PreprocessLayout(17, True, 2 * 16320 + 80 * 120 * 4 + 16 * 120 + 20 * 80 + 4 * 12)
    assert plan.layout.smem_bytes == 74_608
    assert H100_AT_ONCE[0] == 132 * (228 * 1024 // (plan.layout.smem_bytes + 1024))


@pytest.mark.parametrize("n", [1, 2, 7, 48, 99, 150, 397, 5400, 10**6])
@pytest.mark.parametrize("h", [1, 2, 3, 5, 180])
def test_plan_runs_every_cluster_at_once(n, h):
    """S at most h, and n·S within FILL times the resident CTAs; all clusters run at once (one round), each
    over ⌈n / at_once⌉ frames or one fewer, at any n."""
    plan = FP.preprocess_plan(n, h, 320, 3, 40, 40, 1, H100_AT_ONCE)
    at_once = H100_AT_ONCE[FP.CLUSTER_SIZES.index(plan.cluster)]
    assert plan.cluster <= max(1, h) and plan.clusters <= min(n, at_once)
    assert plan.cluster == 1 or n * plan.cluster <= FP.FILL * H100_AT_ONCE[0]
    per = [len(FP.cluster_frames(q, n, plan.clusters)) for q in range(plan.clusters)]
    assert max(per) == -(-n // at_once) and min(per) >= max(per) - 1


@pytest.mark.parametrize("n,clusters", [(1, 1), (7, 1), (7, 3), (7, 7), (600, 300), (5400, 386)])
def test_cluster_frames_cover_every_frame_once(n, clusters):
    frames = [f for q in range(clusters) for f in FP.cluster_frames(q, n, clusters)]
    assert sorted(frames) == list(range(n))


def test_float32_rows_take_four_times_the_bytes_in_fewer_rows_per_stage():
    u8 = FP.preprocess_layout(180, 320, 3, 40, 40, 1)
    f32 = FP.preprocess_layout(180, 320, 3, 40, 40, 4)
    assert (u8.rows_per_stage, f32.rows_per_stage) == (17, 4)
    assert max(u8.rows_per_stage * 960, f32.rows_per_stage * 3840) <= FP.STAGE_BYTES
    assert max(u8.smem_bytes, f32.smem_bytes) <= FP.SMEM_LIMIT and u8.cols_in_smem and f32.cols_in_smem


@pytest.mark.parametrize("h,w,c,oh,ow,elem_bytes,cols_in_smem", [
    (180, 320, 3, 64, 64, 1, True),         # frame_size (64, 64): 98 KB of slots still fit
    (1080, 3840, 3, 40, 40, 4, True),       # 4K float32 rows: one 46 KB row a stage
    (1080, 4800, 3, 40, 40, 4, True),       # rows of 57.6 KB
    (180, 320, 3, 160, 160, 1, False),      # 614 KB of slots: the workspace
    (100, 9000, 3, 160, 160, 4, False),     # 108 KB rows and the workspace
])
def test_layout_fits_shared_memory(h, w, c, oh, ow, elem_bytes, cols_in_smem):
    layout = FP.preprocess_layout(h, w, c, oh, ow, elem_bytes)
    assert layout.cols_in_smem == cols_in_smem
    assert layout.smem_bytes <= FP.SMEM_LIMIT
    assert layout.smem_bytes == FP.smem_bytes(h, layout.rows_per_stage, w * c * elem_bytes, oh, ow * c, cols_in_smem)


def test_layout_refuses_rows_past_two_stages():
    with pytest.raises(ValueError, match="do not fit two ring stages"):
        FP.preprocess_layout(10, 20_000, 3, 40, 40, 4)


def test_constants_agree_with_the_cuda_source():
    src = SOURCE.read_text()
    assert int(re.search(r"constexpr int kMaxCluster = (\d+);", src).group(1)) == max(FP.CLUSTER_SIZES)
    static = int(re.search(r"constexpr size_t kStaticSmem = (\d+);", src).group(1))
    assert FP.SMEM_LIMIT == 232448 - static
    assert int(re.search(r"constexpr int kStages = (\d+);", src).group(1)) == FP.STAGES
