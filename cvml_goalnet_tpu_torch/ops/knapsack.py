"""0/1 knapsack keyshot selection: host, native, device and ``"auto"`` engines.

Port of ``cvml_goalnet_tpu/ops/knapsack.py`` (reference ``knapsack``,
``utils.py:466-510``): weights and capacity scaled by an integer
``scale_factor``, a DP table built one row per item, and the reference's
greedy-from-the-end traceback.  The engines:

* ``"host"`` — NumPy, one vectorised row per item;
* ``"native"`` — the C++ solver of ``runtime/knapsack.cc``, built at first use
  (``cvml_goalnet_tpu_torch/runtime.py``);
* ``"device"`` — :func:`knapsack_select_device`: the int32 DP row by row on
  the summarize device (each item one masked shift and max over the capacity
  axis) and the traceback on that device too, with no host sync per step;
  only the (n,) mask comes back;
* ``"auto"`` — the device engine when the values are integral, the device is
  a CUDA card and the card's cost model (:data:`DEVICE_MS`, :data:`NATIVE_MS`)
  puts it at or below native; else native when it builds; else host.

The JAX package's device engine runs its DP and traceback as ``lax.scan``s,
with no Pallas kernel, so torch operations are its port.
"""

from __future__ import annotations

import numpy as np
import torch

from cvml_goalnet_tpu_torch import runtime
from cvml_goalnet_tpu_torch.device import resolve_device

# "auto"'s model of the two engines' wall milliseconds on a CUDA card, for n items and n·(capacity + 1) cells:
# the device engine DEVICE_MS[0] + DEVICE_MS[1]·n + DEVICE_MS[2]·cells (two launches an item, launch-bound on
# the host, then the traceback's passes over the table), the native one NATIVE_MS[0]·cells^NATIVE_MS[1] (its
# float64 table outgrows the host's caches, so a cell costs more in a larger table).  The device engine pays
# for each item, so no count of cells alone splits the two.  Fitted by chip_smoke.py's knapsack sweep (matches
# of 600-10,800 frames with their own clips and a capacity of 15 %, and capacities of 1,851-185,184 at 540
# clips; least squares in relative error, and in log-log for native) on an NVIDIA H100 80GB HBM3 at 700 W,
# where it picks the faster engine at all 12 points (PERF.md §5).  The JAX package's 30,000,000 cells were
# measured on a TPU v5e and do not carry over.
DEVICE_MS = (1.029, 0.02731, 1.337e-7)
NATIVE_MS = (3.330e-8, 1.275)


def _scaled(weights, capacity, scale_factor):
    w = np.asarray([int(x * scale_factor) for x in np.asarray(weights).tolist()], dtype=np.int64)
    return w, int(capacity * scale_factor)


def knapsack_table_host(values: np.ndarray, weights: np.ndarray, capacity: int) -> np.ndarray:
    """DP table K of shape (n+1, capacity+1); weights/capacity already integer."""
    values = np.asarray(values)
    weights = np.asarray(weights, dtype=np.int64)
    n = len(values)
    table = np.zeros((n + 1, capacity + 1), dtype=values.dtype if values.dtype.kind == "f" else np.int64)
    row = table[0]
    for i in range(n):
        wi, vi = int(weights[i]), values[i]
        new = row.copy()
        if wi <= capacity:
            take = row[: capacity + 1 - wi] + vi
            new[wi:] = np.maximum(row[wi:], take)
        table[i + 1] = new
        row = new
    return table


def knapsack_table_device(values: torch.Tensor, weights, capacity: int) -> torch.Tensor:
    """The DP table (n+1, capacity+1) on ``values``' device, int32 for integer values and float32 otherwise
    (the JAX package's ``knapsack_table_device``).

    Row i+1 is ``max(row i, row i shifted by w_i + v_i)``: the columns below w_i keep row i, as the masked
    shift of the JAX package leaves them.  ``weights`` are host integers ≥ 0 (clip lengths), so each shift
    is a slice and the loop never waits for the device.  Two launches a row: the shifted sum into the new
    row's columns from w_i, then the max with the old row over all columns (every cell is ≥ 0, so the
    zeros below w_i take the old row)."""
    weights = np.asarray(weights, dtype=np.int64)
    if weights.size and weights.min() < 0:
        raise ValueError("knapsack_table_device: weights must be ≥ 0")
    values = values.to(torch.int32 if not values.is_floating_point() else torch.float32)
    n = values.shape[0]
    table = torch.zeros((n + 1, capacity + 1), dtype=values.dtype, device=values.device)
    for i, w in enumerate(weights.tolist()):
        prev, cur = table[i], table[i + 1]
        if w > capacity:
            cur.copy_(prev)
            continue
        torch.add(prev[: capacity + 1 - w], values[i], out=cur[w:])
        torch.maximum(cur, prev, out=cur)
    return table


def knapsack_select_device(values: torch.Tensor, weights, capacity: int) -> torch.Tensor:
    """Integer values: the DP and the reference's traceback on ``values``' device → (n,) bool mask there.

    With exact integers the traceback's running value always equals the table cell it stands on, so item r
    is taken at column c exactly when ``K[r+1][c] > 0`` and ``K[r+1][c] != K[r][c]``, and the walk moves to
    ``c − w_r``.  Those moves form one map per item over the capacity axis; the walk from (n, capacity) is
    their suffix compositions, built by doubling in ⌈log2 n⌉ batched gathers instead of n dependent steps.
    Nothing comes back to the host before the mask."""
    table = knapsack_table_device(values.to(torch.int32), weights, capacity)
    n, dev = table.shape[0] - 1, table.device
    if n == 0:
        return torch.zeros((0,), dtype=torch.bool, device=dev)
    taken = (table[1:] != table[:-1]) & (table[1:] > 0)                          # (n, capacity + 1)
    w = torch.as_tensor(np.asarray(weights, dtype=np.int64), device=dev)
    walk = torch.arange(capacity + 1, device=dev) - w[:, None] * taken            # item r: column at row r+1 → row r
    d = 1
    while d < n:   # walk[r] ← walk[r] ∘ walk[r + d]: items r .. r + 2d − 1
        walk = torch.cat([torch.gather(walk[: n - d], 1, walk[d:]), walk[n - d:]])
        d *= 2
    # the column the walk stands on at row r + 1 when it decides item r: capacity for the last item, else
    # the composition of items r + 1 .. n − 1 applied to capacity
    at = torch.cat([walk[1:, capacity], torch.full((1,), capacity, device=dev, dtype=walk.dtype)])
    return taken.gather(1, at[:, None])[:, 0]


def _traceback(table: np.ndarray, values: np.ndarray, weights: np.ndarray, capacity: int) -> list[int]:
    """Reference-exact traceback (``utils.py:494-510``): walk items from the end,
    skip item i when ``K[i][w] == K[i-1][w]``, else take it."""
    n = len(values)
    res = table[n][capacity]
    w = capacity
    selected: list[int] = []
    for i in range(n, 0, -1):
        if res <= 0:
            break
        if w < 0:
            # only reachable for non-integral float values whose subtraction
            # breaks the equality test; a negative index would read a wrong cell
            break
        if res == table[i - 1][w]:
            continue
        selected.append(i - 1)
        res = res - values[i - 1]
        w = w - int(weights[i - 1])
    selected.reverse()
    return selected


def modelled_ms(n: int, cells: int) -> tuple[float, float]:
    """The device and the native engine's modelled wall milliseconds for n items and ``cells`` cells."""
    fixed, per_item, per_cell = DEVICE_MS
    scale, power = NATIVE_MS
    return fixed + per_item * n + per_cell * cells, scale * float(cells) ** power


def auto_engine(integral: bool, n: int, cells: int, device) -> str:
    """What ``"auto"`` runs for n items and ``cells`` cells: ``"device"`` for integral values on a CUDA device
    where :func:`modelled_ms` puts the device engine at or below native, else ``"native"`` when the runtime
    builds, else ``"host"``."""
    if integral and device is not None and torch.device(device).type == "cuda":
        device_ms, native_ms = modelled_ms(n, cells)
        if device_ms <= native_ms:
            return "device"
    return "native" if runtime.native_available() else "host"


def knapsack_select(values, weights, capacity, scale_factor: int = 5, engine: str = "auto", device=None) -> list[int]:
    """Clip indices maximising summed value under a length budget (reference ``knapsack(values, weights,
    capacity, scale_factor=5)``), with a choice of engine: ``"host"``, ``"native"``, ``"device"`` or ``"auto"``.

    ``device`` is where the device engine runs (the summarize device); None means the card, which ``"device"``
    requires and ``"auto"`` takes when there is one.  Non-integral values take the host float64 engine under
    ``"device"``, as in the JAX package (a float32 table against a float64 traceback is not exact), and an
    integral selection whose values sum past int32 raises there.  An explicit ``"native"`` raises when the
    runtime cannot be built, and the first ``"auto"`` call builds it (g++, a few seconds).
    """
    if engine not in ("auto", "host", "native", "device"):
        raise ValueError(f"knapsack engine {engine!r}: expected 'auto', 'host', 'native' or 'device'")
    values = np.asarray(values, dtype=np.float64)
    w_arr = np.asarray(weights, dtype=np.float64)
    if w_arr.size and np.all(w_arr == np.floor(w_arr)) and capacity == int(capacity):
        # all-integer weights: scaling weights and capacity by one factor leaves
        # the feasible set, the DP argmax and the traceback unchanged, so skip it
        scale_factor = 1
    int_weights, int_capacity = _scaled(weights, capacity, scale_factor)
    if len(values) == 0 or int_capacity <= 0:
        return []

    integral = bool(np.all(values == np.floor(values)))
    if engine == "auto":
        if device is None and torch.cuda.is_available():
            device = "cuda"
        engine = auto_engine(integral, len(values), len(values) * (int_capacity + 1), device)

    if engine == "native":
        return runtime.knapsack_native(values, int_weights, int_capacity)
    if engine == "device" and integral:
        iv = values.astype(np.int64)
        if np.abs(iv).sum() >= 2**31:
            raise OverflowError("device knapsack int32 overflow: the values sum past 2^31")
        dev = resolve_device(device)
        mask = knapsack_select_device(torch.as_tensor(iv.astype(np.int32), device=dev), int_weights, int_capacity)
        return np.nonzero(mask.cpu().numpy())[0].tolist()
    table = knapsack_table_host(values, int_weights, int_capacity)
    return _traceback(table, values, int_weights, int_capacity)
