"""The mixture-of-experts fusion layer: a top-k softmax gate over E linear experts, dense dispatch.

Port of ``cvml_goalnet_tpu/models/moe.py``.  With
``ModelConfig.fusion_moe_experts = E > 0`` the fusion MLP's first layer is
``{"gate": {"w", "b"}, "experts": {"w": (E, in, out), "b": (E, out)}}``:
every expert computes every row (one batched product, as the JAX package's
``einsum``), and the gate's combine weights zero the experts a row is not
routed to.  The gate keeps every logit at or above the k-th largest, so a
tie keeps more than k experts, as ``jax.lax.top_k`` with ``>=`` does; with
``top_k >= E`` nothing is masked.  Plain PyTorch on the card as on the CPU
(the JAX package computes it in XLA), in the input's dtype, rounding where
the JAX package's bf16 einsums round.
"""

from __future__ import annotations

import torch

from cvml_goalnet_tpu_torch.models import layers as L


def moe_gate_probs(params, x: torch.Tensor, top_k: int) -> torch.Tensor:
    """(N, in) → (N, E) combine weights: the softmax over the logits at or above the k-th largest of each
    row, 0 elsewhere.  Differentiable through the kept logits."""
    logits = L.linear_apply(params["gate"], x)
    if top_k < logits.shape[-1]:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits >= kth, logits, torch.full((), float("-inf"), dtype=logits.dtype,
                                                               device=logits.device))
    return L.softmax(logits, dim=-1)


def moe_apply(params, x: torch.Tensor, top_k: int = 2, probs: torch.Tensor | None = None) -> torch.Tensor:
    """(N, in) → (N, out): the gate-weighted sum of the experts' outputs.  ``probs`` (from
    :func:`moe_gate_probs`) is reused when given, as the training loop does for the auxiliary loss."""
    if probs is None:
        probs = moe_gate_probs(params, x, top_k)
    ew, eb = params["experts"]["w"], params["experts"]["b"]
    y = L._contract("nd,edo->eno", x, ew.to(x.dtype)) + eb.to(x.dtype)[:, None, :]   # (E, N, out)
    return L._contract("eno,ne->no", y, probs)


def moe_load_balance_loss(probs: torch.Tensor) -> torch.Tensor:
    """Switch-style balance penalty ``E · Σ_e frac_e · mean_p_e``: ``frac_e`` the share of rows whose first
    largest weight is expert e (no gradient), ``mean_p_e`` the mean weight (the gradient's path).  1 when
    routing is balanced, E when it has collapsed onto one expert."""
    n_experts = probs.shape[-1]
    top1 = torch.nn.functional.one_hot(torch.argmax(probs, dim=-1), n_experts).to(probs.dtype)
    return n_experts * torch.sum(top1.mean(dim=0) * probs.mean(dim=0))
