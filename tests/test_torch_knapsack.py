"""PyTorch port: the knapsack engines and ``summarize``'s ``"native-full"`` against the JAX package, on the CPU.

* ``knapsack_select`` with ``"host"``, ``"native"``, ``"device"`` (torch on the
  CPU) and ``"auto"`` gives exactly the JAX package's indices for the same
  engine: integral and float values, float weights with ``scale_factor = 5``,
  ties, an empty input, capacity 0, an item over capacity, and tables of a few
  million cells.
* The device engine's table and its traceback, a walk built by doubling,
  equal the JAX package's ``knapsack_table_device`` and
  ``knapsack_select_device`` bit for bit; it keeps the JAX package's int32
  overflow check and routes non-integral values to the host float64 engine.
* ``"auto"`` takes the device engine only for integral values on a CUDA
  device where the card's cost model puts it at or below native, else
  native when the runtime builds, else host; an explicit ``"native"`` or
  ``"native-full"`` raises when the runtime cannot be built.
* ``summarize(..., knapsack_engine="native-full")`` gives the JAX package's
  mask, clips and frames, and the port's staged path's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cvml_goalnet_tpu.ops.knapsack as JK
import cvml_goalnet_tpu.pipeline as JP
import cvml_goalnet_tpu_torch.ops.knapsack as K
import cvml_goalnet_tpu_torch.pipeline as TP
from cvml_goalnet_tpu.config import KnapsackConfig as JaxKnapsackConfig
from cvml_goalnet_tpu_torch import runtime
from cvml_goalnet_tpu_torch.config import KnapsackConfig
from cvml_goalnet_tpu_torch.data.synthetic import synthetic_change_points
from cvml_goalnet_tpu_torch.ops.cuda._build import BUILD_DIR

ENGINES = ("host", "native", "device", "auto")


def _case(name: str):
    """(values, weights, capacity, scale_factor) of a seeded case."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "integral":
        return rng.integers(0, 12, 40).astype(float), rng.integers(1, 40, 40).astype(float), 300, 5
    if name == "float_values":
        return rng.random(35) * 7, rng.integers(1, 30, 35).astype(float), 120, 5
    if name == "float_weights":
        return rng.integers(1, 50, 30).astype(float), (rng.integers(1, 40, 30) / 4).astype(float), 60.0, 5
    if name == "float_both":
        return rng.random(25) * 9, rng.random(25) * 11 + 0.5, 37.3, 5
    if name == "ties":
        return np.full(20, 3.0), np.full(20, 5.0), 42, 5
    if name == "tie_heavy":
        return rng.integers(0, 4, 60).astype(float), rng.integers(1, 9, 60).astype(float), 90, 5
    if name == "empty":
        return np.zeros(0), np.zeros(0), 10, 5
    if name == "capacity_0":
        return np.array([3.0, 1.0]), np.array([1.0, 2.0]), 0, 5
    if name == "one_over_capacity":
        return np.array([9.0]), np.array([12.0]), 7, 5
    if name == "some_over_capacity":
        return np.array([4.0, 9.0, 2.0, 6.0]), np.array([3.0, 50.0, 1.0, 4.0]), 8, 5
    if name == "zero_weight":
        return np.array([4.0, 1.0, 2.0]), np.array([0.0, 3.0, 2.0]), 4, 5
    if name == "large_values":   # past float32's exact integers, inside int32
        return np.array([float(2**23 + i) for i in range(8)]), np.ones(8), 5, 5
    if name == "match_clips":    # a 90-minute match's shape, cut: 540 clips, 15 % of 162,000 frames / 10
        return rng.integers(30, 150, 540).astype(float), rng.integers(150, 450, 540).astype(float), 2430, 5
    if name == "millions":       # 3.6 million cells
        return rng.integers(0, 20, 300).astype(float), rng.integers(5, 200, 300).astype(float), 12_000, 5
    raise KeyError(name)


CASES = ["integral", "float_values", "float_weights", "float_both", "ties", "tie_heavy", "empty", "capacity_0",
         "one_over_capacity", "some_over_capacity", "zero_weight", "large_values", "match_clips", "millions"]


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("case", CASES)
def test_engine_matches_jax(case, engine):
    values, weights, capacity, scale = _case(case)
    want = JK.knapsack_select(values, weights, capacity, scale, engine=engine)
    got = K.knapsack_select(values, weights, capacity, scale, engine=engine, device="cpu")
    assert got == want
    # every engine gives the host engine's selection
    assert got == K.knapsack_select(values, weights, capacity, scale, engine="host")


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("n", [1, 2, 3, 5, 17, 64])
def test_device_select_matches_jax_mask(n, seed):
    """The doubling walk at every count of items, with many inherited rows (the skip branch) and early
    exhaustion (the running value reaching 0)."""
    rng = np.random.default_rng(100 * n + seed)
    values = rng.integers(0, 6, n).astype(np.int32)
    weights = rng.integers(0, 9, n).astype(np.int64)
    cap = int(rng.integers(1, 50))
    want = np.asarray(JK.knapsack_select_device(jnp.asarray(values), jnp.asarray(weights), cap))
    got = K.knapsack_select_device(torch.as_tensor(values), weights, cap)
    assert got.dtype == torch.bool and got.shape == (n,)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("integer", [True, False])
def test_device_table_matches_jax(integer):
    rng = np.random.default_rng(3)
    values = rng.integers(1, 50, 12) if integer else rng.random(12) * 50
    weights = rng.integers(0, 15, 12)
    jv = jnp.asarray(values.astype(np.int32 if integer else np.float32))
    want = np.asarray(JK.knapsack_table_device(jv, jnp.asarray(weights), 40))
    got = K.knapsack_table_device(torch.as_tensor(np.array(jv)), weights, 40)
    assert got.dtype == (torch.int32 if integer else torch.float32)
    np.testing.assert_array_equal(got.numpy(), want)


def test_device_engine_keeps_the_int32_overflow_check():
    values, weights = [2.0**30, 2.0**30, 5.0], [1.0, 1.0, 1.0]
    with pytest.raises(AssertionError, match="overflow"):
        JK.knapsack_select(values, weights, 2, engine="device")
    with pytest.raises(OverflowError, match="overflow"):
        K.knapsack_select(values, weights, 2, engine="device", device="cpu")


def _spy(monkeypatch, module, name: str, seen: list) -> None:
    """Record each call of ``module.name`` in ``seen``, then run it."""
    real = getattr(module, name)
    monkeypatch.setattr(module, name, lambda *args: seen.append(name) or real(*args))


def test_device_engine_routes_float_values_to_the_host(monkeypatch):
    values, weights, capacity, scale = _case("float_values")
    seen = []
    _spy(monkeypatch, K, "knapsack_select_device", seen)
    _spy(monkeypatch, K, "knapsack_table_host", seen)
    got = K.knapsack_select(values, weights, capacity, scale, engine="device", device="cpu")
    assert seen == ["knapsack_table_host"]
    assert got == JK.knapsack_select(values, weights, capacity, scale, engine="device")


def test_device_engine_refuses_negative_weights():
    with pytest.raises(ValueError, match="≥ 0"):
        K.knapsack_table_device(torch.tensor([1, 2], dtype=torch.int32), [1, -1], 3)


MATCH_CELLS = 540 * 24_301   # a match's table: 540 clips, capacity 24,300


@pytest.mark.parametrize("integral,n,cells,device,native,want", [
    (True, 540, MATCH_CELLS, "cuda", True, "device"),
    (True, 540, MATCH_CELLS, "cuda", False, "device"),
    (True, 540, 540 * 5_001, "cuda", True, "native"),
    (False, 540, MATCH_CELLS * 10, "cuda", True, "native"),
    (True, 540, MATCH_CELLS * 10, "cpu", True, "native"),
    (True, 540, MATCH_CELLS * 10, None, False, "host"),
    (True, 1, 10, "cuda", False, "host"),
])
def test_auto_engine(monkeypatch, integral, n, cells, device, native, want):
    monkeypatch.setattr(runtime, "native_available", lambda: native)
    assert K.auto_engine(integral, n, cells, None if device is None else torch.device(device)) == want


def test_crossover_grows_with_the_items():
    """The device engine pays for each item and native for each cell, so where they meet depends on both: a
    table the device engine takes at 360 items goes native at 1080, and at 540 items the device engine's
    share of the modelled time grows slower than native's as the cells grow."""
    cells = 6_000_000
    assert K.auto_engine(True, 360, cells, torch.device("cuda")) == "device"
    assert K.auto_engine(True, 1080, cells, torch.device("cuda")) != "device"
    small, large = K.modelled_ms(540, 1_000_000), K.modelled_ms(540, 100_000_000)
    assert small[0] > small[1] and large[0] < large[1]


def test_auto_runs_the_device_engine_past_the_crossover(monkeypatch):
    """A table past the crossover on a CUDA device takes the device engine: here the device engine is modelled
    free and spied on, so the test runs without a card."""
    values, weights, capacity, scale = _case("millions")
    seen = []
    real = K.knapsack_select_device
    monkeypatch.setattr(K, "knapsack_select_device", lambda v, w, c: seen.append(v.device) or real(v.cpu(), w, c))
    monkeypatch.setattr(K, "resolve_device", lambda d: torch.device("cpu"))
    monkeypatch.setattr(K, "DEVICE_MS", (0.0, 0.0, 0.0))
    got = K.knapsack_select(values, weights, capacity, scale, engine="auto", device=torch.device("cuda"))
    assert seen
    assert got == JK.knapsack_select(values, weights, capacity, scale, engine="host")


@pytest.fixture
def no_compiler(monkeypatch, tmp_path):
    """The runtime as on a machine without g++ and without a built library."""
    monkeypatch.setattr(runtime, "_lib", None)
    monkeypatch.setattr(runtime, "_failure", None)
    monkeypatch.setattr(runtime, "lib_path", lambda: tmp_path / "libgoalnet_runtime-missing.so")
    monkeypatch.setattr(runtime.shutil, "which", lambda name: None)


def test_explicit_native_raises_without_the_runtime(no_compiler):
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        K.knapsack_select([3.0, 4.0], [1.0, 2.0], 2, engine="native")
    with pytest.raises(RuntimeError, match="native runtime unavailable"):
        TP.summarize(np.ones(3), np.array([[0, 30], [30, 90]]), 30, 90, knapsack_engine="native-full", device="cpu")


def test_auto_takes_the_host_engine_without_the_runtime(no_compiler, monkeypatch):
    values, weights, capacity, scale = _case("integral")
    seen = []
    _spy(monkeypatch, K, "knapsack_table_host", seen)
    assert K.knapsack_select(values, weights, capacity, scale, engine="auto", device="cpu") == JK.knapsack_select(
        values, weights, capacity, scale, engine="host")
    assert seen == ["knapsack_table_host"]


def test_runtime_builds_into_the_ports_build_directory():
    assert runtime.native_available()
    assert runtime.lib_path().parent == BUILD_DIR and runtime.lib_path().exists()


def test_unknown_engine_raises():
    with pytest.raises(ValueError, match="knapsack engine"):
        K.knapsack_select([1.0], [1.0], 1, engine="gpu")


@pytest.mark.parametrize("inclusive", [True, False])
@pytest.mark.parametrize("seed", range(3))
def test_summarize_native_full_matches_jax(seed, inclusive):
    rng = np.random.default_rng(seed)
    n_cond, skip = int(rng.integers(20, 80)), 30
    full_n = n_cond * skip + int(rng.integers(0, skip))
    scores = (rng.random(n_cond) * 4 + 1).astype(np.float32)
    scores[::7] = np.round(scores[::7]) + 0.5          # ties for round-half-even
    iv = synthetic_change_points(full_n, max(4, n_cond // 5), seed=seed)
    frames = np.arange(full_n)[:, None]
    want = JP.summarize(scores, iv, skip, full_n, JaxKnapsackConfig(inclusive_mask=inclusive), full_frames=frames,
                        knapsack_engine="native-full")
    kcfg = KnapsackConfig(inclusive_mask=inclusive)
    got = TP.summarize(scores, iv, skip, full_n, kcfg, full_frames=frames, knapsack_engine="native-full", device="cpu")
    staged = TP.summarize(torch.as_tensor(scores)[:, None], iv, skip, full_n, kcfg, full_frames=frames,
                          knapsack_engine="host", device="cpu")
    for other in (want, staged):
        np.testing.assert_array_equal(got.frame_mask, other.frame_mask)
        assert got.selected_clips == list(other.selected_clips)
        np.testing.assert_array_equal(got.clip_intervals, other.clip_intervals)
        np.testing.assert_array_equal(got.summary_frames, other.summary_frames)
    assert got.frame_mask.dtype == np.uint8 and got.frame_mask.shape == (full_n,)


def test_summarize_native_full_without_frames_takes_the_staged_path():
    """No raw frames: the C call refuses its arguments and, as in the JAX package, the staged path runs."""
    iv = np.array([[0, 30]])
    got = TP.summarize(np.ones(3, np.float32), iv, 30, 0, knapsack_engine="native-full", device="cpu")
    want = JP.summarize(np.ones(3, np.float32), iv, 30, 0, knapsack_engine="native-full")
    assert got.frame_mask.shape == (0,)
    np.testing.assert_array_equal(got.frame_mask, want.frame_mask)
    assert got.selected_clips == list(want.selected_clips)


@pytest.mark.parametrize("engine", ["host", "native", "device", "auto"])
def test_summarize_engines_agree(engine):
    rng = np.random.default_rng(11)
    scores = (rng.random(60) * 4 + 1).astype(np.float32)
    full_n = 60 * 30
    iv = synthetic_change_points(full_n, 12, seed=5)
    want = JP.summarize(scores, iv, 30, full_n, knapsack_engine="host")
    got = TP.summarize(scores, iv, 30, full_n, knapsack_engine=engine, device="cpu")
    np.testing.assert_array_equal(got.frame_mask, want.frame_mask)
    assert got.selected_clips == list(want.selected_clips)
