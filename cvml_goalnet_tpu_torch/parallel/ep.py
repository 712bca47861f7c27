"""Expert parallelism: the experts of an MoE layer split over a model axis.

Port of ``cvml_goalnet_tpu/parallel/ep.py``.  The layer's output is a sum
over experts of ``probs[:, e] · expert_e(x)``, so each of n model ranks
computes its E/n experts' share of every row, weighted by its slice
``me·E/n … (me + 1)·E/n`` of the gate's combine weights (the gate runs whole
on every rank), and one differentiable all-reduce
(``collectives.all_reduce_sum``) adds the shares.  That all-reduce's backward
sums the output's gradients over the axis: each rank's loss is its share of
the objective, and a leaf's gradient is the sum over the axis of the ranks'
(an expert's nonzero on its own rank only).  Plain PyTorch, as the
single-device layer (``models/moe.py``).

The combine runs on a lock-step view of the axis (a rank's
``parallel.mesh.Axis``, or a ``parallel.mesh.VirtualAxis`` of every shard in
one process: the one-card check of ``chip_smoke.py``).
"""

from __future__ import annotations

import torch

from cvml_goalnet_tpu_torch.models import layers as L
from cvml_goalnet_tpu_torch.models.moe import moe_gate_probs


def _experts_share(params, x: torch.Tensor, probs: torch.Tensor, me: int, n: int) -> torch.Tensor:
    """Shard ``me`` of ``n``'s experts applied to every row of ``x``, weighted by their combine weights → (N,
    out)."""
    e_local = params["experts"]["w"].shape[0] // n
    sl = slice(me * e_local, (me + 1) * e_local)
    ew, eb = params["experts"]["w"][sl], params["experts"]["b"][sl]
    y = L._contract("nd,edo->eno", x, ew.to(x.dtype)) + eb.to(x.dtype)[:, None, :]   # (E/n, N, out)
    return L._contract("eno,ne->no", y, probs[:, sl])


def moe_apply_expert_parallel(params, x: torch.Tensor, axis, top_k: int = 2) -> torch.Tensor:
    """Expert-parallel ``moe_apply`` of the whole layer ``params`` on (N, in) → (N, out) on every rank of
    ``axis`` (a ``parallel.mesh.Axis``), or of every shard in one process for a ``parallel.mesh.VirtualAxis``.
    Equal to the single-device layer, reassociated only across the expert axis; n must divide E."""
    n_experts = params["experts"]["w"].shape[0]
    if n_experts % axis.size:
        raise ValueError(
            f"{n_experts} experts not divisible over {axis.size}-way mesh "
            f"axis 'model'")
    probs = moe_gate_probs(params, x, top_k)
    return axis.sum([_experts_share(params, x, probs, me, axis.size) for me in axis.lanes])[0]
