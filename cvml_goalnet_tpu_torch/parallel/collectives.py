"""The collectives of the data group, over ``torch.distributed`` (NCCL on the cards, gloo on the CPU).

Port of what the two data-parallel steps need of
``cvml_goalnet_tpu/parallel/collectives.py``: the sum and the mean over the
group (``psum``, ``pmean``), and a sum that autograd passes through
(:func:`all_reduce_sum`, whose backward all-reduces the incoming gradient),
which the global batchnorm statistics take.  Trees (dicts and lists of
tensors) are reduced as one flat buffer: one collective, not one per leaf.
``group=None`` is the default (world) group.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from cvml_goalnet_tpu_torch.train.optim import tree_leaves, tree_unflatten


class _AllReduceSum(torch.autograd.Function):
    """Σ over the group forward; backward, the sum over the group of the output's gradients (every rank's loss
    reads the sum, so each rank's input feeds every rank's loss)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad, ctx.group), None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Σ over the ranks of ``group``, differentiable: the gradient of each rank's input is the sum of every
    rank's gradient of the output."""
    return _AllReduceSum.apply(x, group)


def psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Σ over the ranks of ``group``, a new tensor (no autograd)."""
    out = x.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


def pmean(x: torch.Tensor, group=None) -> torch.Tensor:
    """The mean over the ranks of ``group`` (no autograd)."""
    return psum(x, group) / dist.get_world_size(group)


def tree_psum(tree, group=None, mean: bool = False):
    """Every leaf of a tree of float tensors summed (or averaged) over ``group``, in one all-reduce of the
    leaves flattened into one buffer."""
    leaves = tree_leaves(tree)
    if not leaves:
        return tree
    flat = torch.cat([t.detach().reshape(-1).to(torch.float32) for t in leaves])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    if mean:
        flat = flat / dist.get_world_size(group)
    out, off = [], 0
    for t in leaves:
        out.append(flat[off:off + t.numel()].reshape(t.shape).to(t.dtype))
        off += t.numel()
    return tree_unflatten(tree, out)
