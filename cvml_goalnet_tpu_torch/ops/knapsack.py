"""0/1 knapsack keyshot selection — the host engine.

Port of the ``"host"`` engine of ``cvml_goalnet_tpu/ops/knapsack.py``
(reference ``knapsack``, ``utils.py:466-510``): weights and capacity scaled by
an integer ``scale_factor``, a NumPy DP table built one vectorised row per
item, and the reference's greedy-from-the-end traceback.  The table and
traceback are data-dependent host work; the ``"device"`` and C++ engines come
in a later slice, so ``"auto"`` resolves to ``"host"`` here.
"""

from __future__ import annotations

import numpy as np


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


def knapsack_select(values, weights, capacity, scale_factor: int = 5, engine: str = "auto") -> list[int]:
    """Clip indices maximising summed value under a length budget.

    ``engine``: ``"host"`` or ``"auto"`` (which is ``"host"`` in this slice).
    """
    if engine not in ("auto", "host"):
        raise NotImplementedError(
            f"knapsack engine {engine!r} is not ported yet (the device and C++ "
            "engines come in a later slice); use 'host' or 'auto'"
        )
    values = np.asarray(values, dtype=np.float64)
    w_arr = np.asarray(weights, dtype=np.float64)
    if w_arr.size and np.all(w_arr == np.floor(w_arr)) and capacity == int(capacity):
        # all-integer weights: scaling weights and capacity by one factor leaves
        # the feasible set, the DP argmax and the traceback unchanged, so skip it
        scale_factor = 1
    int_weights, int_capacity = _scaled(weights, capacity, scale_factor)
    if len(values) == 0 or int_capacity <= 0:
        return []
    table = knapsack_table_host(values, int_weights, int_capacity)
    return _traceback(table, values, int_weights, int_capacity)
