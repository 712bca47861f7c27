"""PyTorch port: what the visual head's kernel (kernel 3, ``csrc/matmul.cu``) rests on, on the CPU.

* ``head_plan`` splits K so that every K index falls in exactly one split, in
  chunks of whole K steps, and fills the card's resident blocks at the
  summarization and match batches, for an H100 SXM's 132 SMs and the one
  resident block per SM that the CUDA occupancy calculator gives the kernel
  there (a card test holds the card to those values).
* The kernel computes in 3xTF32 on the tensor cores, and the MMA's float32
  accumulation rounds toward zero.  A numpy emulation of its arithmetic (the
  k order, TF32 rounding as ``cvt.rna`` does it, the MMA reading the small
  half's top 19 bits, each MMA's sum rounded toward zero, a fresh accumulator
  per 32-deep K step added to float32 totals, the splits added in order) holds
  the head at (8, 41472) @ (41472, 64) to the card test's ``atol=2e-5,
  rtol=1e-5`` against the plain float32 version and the JAX package's Pallas
  kernel, where one TF32 product, or one accumulator over all of K, does not.
  Shares of that tolerance (worst |err| / (2e-5 + 1e-5·|ref|)), on these
  inputs: the kernel's scheme 0.029 with the plan's 62 splits and 0.058 with
  one split; a fresh accumulator per 16, 64 or 256 K steps of 8 with one
  split 0.097, 0.27 and 1.04, so the kernel takes one per 4; one TF32 product
  15.0; one accumulator over all of K 25.0.
* The wrapper's padding of operands whose K or N is not a multiple of 4.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvml_goalnet_tpu.ops.pallas.matmul import head_matmul_pallas
from cvml_goalnet_tpu_torch.ops.cuda import matmul as MM

H100_SMS, H100_BLOCKS_PER_SM = 132, 1   # csrc/matmul.cu's GEMM pass: 128 KB of shared memory, one block per SM
ATOL, RTOL = 2e-5, 1e-5                 # tests/test_torch_cuda_kernels.py::test_head_matmul
HEAD_K, HEAD_N = 41472, 512             # the visual head of configs/reference_parity.json


# --- (a) the split plan --------------------------------------------------------------------------


@pytest.mark.parametrize("m", [1, 3, 150, 300, 600, 1050, 5400])
@pytest.mark.parametrize("k,n", [(HEAD_K, HEAD_N), (HEAD_K - 20, HEAD_N), (20, 8), (4608, 128), (32, 64), (4, 4)])
def test_head_plan_covers_k_exactly(m, k, n):
    splits, k_chunk = MM.head_plan(m, k, n, H100_SMS, H100_BLOCKS_PER_SM)
    assert k_chunk % MM.BLOCK_K == 0 and 1 <= splits <= MM.MAX_SPLITS
    assert (splits - 1) * k_chunk < k <= splits * k_chunk   # no split is empty, none is missing
    covered = [i for s in range(splits) for i in range(s * k_chunk, min(k, (s + 1) * k_chunk))]
    assert covered == list(range(k))


@pytest.mark.parametrize("m", [150, 300, 600, 1050, 5400])
def test_head_plan_fills_the_card(m):
    """Blocks over the resident slots of the rounds they take: at least 90 % of every round is busy."""
    splits, _ = MM.head_plan(m, HEAD_K, HEAD_N, H100_SMS, H100_BLOCKS_PER_SM)
    blocks = math.ceil(m / MM.BLOCK_M) * math.ceil(HEAD_N / MM.BLOCK_N) * splits
    slots = H100_SMS * H100_BLOCKS_PER_SM
    assert blocks / (math.ceil(blocks / slots) * slots) >= 0.9


def test_head_plan_at_the_paths_batches():
    plan = lambda m, sms=H100_SMS, per_sm=H100_BLOCKS_PER_SM: MM.head_plan(m, HEAD_K, HEAD_N, sms, per_sm)
    assert plan(1050) == MM.HeadPlan(11, 3776)    # 36 tiles × 11 = 396 blocks: three full rounds
    assert plan(5400) == MM.HeadPlan(3, 13824)    # 172 tiles × 3 = 516 blocks in four rounds of 132
    assert plan(150) == MM.HeadPlan(16, 2592)     # 8 tiles × 16 = 128 blocks
    assert plan(150, per_sm=2).splits > plan(150).splits   # a card with more slots splits more


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


def _emulate_head(x, w, b, three: bool, steps_per_fresh: int, splits: int) -> np.ndarray:
    """x @ w + b as the kernel's MMAs form it (K a multiple of 32).

    K steps of 8 in the kernel's k order; each MMA adds its 8 exact products to its accumulator and rounds
    toward zero; a fresh accumulator per ``steps_per_fresh`` K steps, added to the split's float32 totals
    in order; the splits added in order, then the bias.  ``three``: big·big' + big·small' + small·big'
    (small·big' first), else one TF32 product.
    """
    m, k = x.shape
    n = w.shape[1]
    # within 32 k: (half, t, k-step, pair) → (half, k-step, t, pair): k-step ks takes 4t + 2ks, 4t + 2ks + 1
    order = np.arange(k).reshape(k // 32, 2, 4, 2, 2).transpose(0, 1, 3, 2, 4).reshape(k)
    xs, ws = x[:, order].reshape(m, k // 8, 8), w[order].reshape(k // 8, 8, n)
    xb, wb = _tf32(xs), _tf32(ws)
    xsm, wsm = _tf32_truncated(xs - xb), _tf32_truncated(ws - wb)
    terms = [(xsm, wb), (xb, wsm), (xb, wb)] if three else [(xb, wb)]
    steps = k // 8
    per_split = -(-steps // splits)
    y = np.zeros((m, n), np.float32)
    for s0 in range(0, steps, per_split):
        s1 = min(steps, s0 + per_split)
        groups = -(-(s1 - s0) // steps_per_fresh)
        fresh = np.zeros((groups, m, n), np.float32)   # every group's fresh accumulator at once
        for i in range(steps_per_fresh):
            at = s0 + np.arange(groups) * steps_per_fresh + i
            live = (at < s1)[:, None, None]
            at = np.minimum(at, s1 - 1)
            for a, bb in terms:
                prod = np.einsum("mgk,gkn->gmn", a[:, at].astype(np.float64), bb[at].astype(np.float64))
                fresh = np.where(live, _round_toward_zero(fresh.astype(np.float64) + prod), fresh)
        total = np.zeros((m, n), np.float32)
        for g in range(groups):
            total += fresh[g]
        y += total
    return y + b


@pytest.fixture(scope="module")
def head_case():
    """The card test's input scales at (8, 41472) @ (41472, 64), and the plain float32 head."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((8, HEAD_K)) * 0.1).astype(np.float32)
    w = (rng.standard_normal((HEAD_K, 64)) * 0.02).astype(np.float32)
    b = rng.standard_normal(64).astype(np.float32)
    plain = MM.head_matmul_plain(*(torch.from_numpy(a) for a in (x, w, b)), relu=False).numpy()
    return x, w, b, plain


def _share(got, want) -> float:
    return float(np.max(np.abs(got - want) / (ATOL + RTOL * np.abs(want))))


STEPS_PER_STAGE = MM.BLOCK_K // 8   # the kernel's fresh accumulator spans one 32-deep K step


@pytest.mark.parametrize("one_split", [False, True])
def test_three_tf32_products_with_fresh_accumulators_hold_the_tolerance(head_case, one_split):
    x, w, b, plain = head_case
    splits = 1 if one_split else MM.head_plan(8, HEAD_K, 64, H100_SMS, H100_BLOCKS_PER_SM).splits
    got = _emulate_head(x, w, b, True, STEPS_PER_STAGE, splits)
    assert _share(got, plain) <= 0.1   # 0.029 and 0.058


def test_emulated_kernel_matches_the_pallas_kernel(head_case):
    x, w, b, _ = head_case
    want = np.asarray(head_matmul_pallas(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), False, 8, 5184, True))
    splits = MM.head_plan(8, HEAD_K, 64, H100_SMS, H100_BLOCKS_PER_SM).splits
    assert _share(_emulate_head(x, w, b, True, STEPS_PER_STAGE, splits), want) <= 0.1


def test_one_tf32_product_breaks_the_tolerance(head_case):
    x, w, b, plain = head_case
    splits = MM.head_plan(8, HEAD_K, 64, H100_SMS, H100_BLOCKS_PER_SM).splits
    assert _share(_emulate_head(x, w, b, False, STEPS_PER_STAGE, splits), plain) > 1.0   # 15.0


def test_one_accumulator_over_all_of_k_breaks_the_tolerance(head_case):
    x, w, b, plain = head_case
    assert _share(_emulate_head(x, w, b, True, HEAD_K // 8, 1), plain) > 1.0   # 25.0


def test_round_toward_zero_never_rounds_up():
    v = np.array([1.0 + 2.0 ** -30, -1.0 - 2.0 ** -30, 3.0, -0.0, 1e-3 * (1 + 2.0 ** -40)])
    got = _round_toward_zero(v)
    assert np.all(np.abs(got.astype(np.float64)) <= np.abs(v))
    assert got[0] == np.float32(1.0) and got[1] == np.float32(-1.0) and got[2] == np.float32(3.0)


# --- (c) the wrapper's padding -------------------------------------------------------------------


def test_aligned_pads_with_zeros_and_keeps_what_fits():
    x = torch.arange(21, dtype=torch.float32).reshape(3, 7)
    assert MM._aligned(x, 3, 7) is x
    got = MM._aligned(x, 3, 8)
    assert got.shape == (3, 8) and torch.equal(got[:, :7], x) and not got[:, 7].any()
    offset = torch.zeros(9)[1:]                       # 4 bytes past an allocation's start
    again = MM._aligned(offset, 8)
    assert again.data_ptr() % 16 == 0 and torch.equal(again, offset)


@pytest.mark.parametrize("m,k,n,relu", [(3, 20, 7, False), (5, 18, 8, True), (2, 3, 1, True)])
def test_padded_operands_keep_the_product(m, k, n, relu):
    """The products of the padded operands the kernel would take, sliced back, are the unpadded ones."""
    rng = np.random.default_rng(m * k * n)
    x, w, b = (torch.as_tensor(rng.standard_normal(s).astype(np.float32)) for s in ((m, k), (k, n), (n,)))
    k4, n4 = -(-k // 4) * 4, -(-n // 4) * 4
    padded = MM.head_matmul_plain(MM._aligned(x, m, k4), MM._aligned(w, k4, n4), MM._aligned(b, n4), relu)
    torch.testing.assert_close(padded[:, :n], MM.head_matmul(x, w, b, relu), atol=1e-6, rtol=0)
