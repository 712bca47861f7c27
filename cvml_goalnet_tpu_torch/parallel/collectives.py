"""The collectives of the parallel paths, over ``torch.distributed`` (NCCL on the cards, gloo on the CPU).

Port of what the data-parallel steps need of
``cvml_goalnet_tpu/parallel/collectives.py``: the sum and the mean over the
group (``psum``, ``pmean``), and a sum that autograd passes through
(:func:`all_reduce_sum`, whose backward all-reduces the incoming gradient),
which the global batchnorm statistics take.  Trees (dicts and lists of
tensors) are reduced as one flat buffer: one collective, not one per leaf.
``group=None`` is the default (world) group.

The context-parallel paths add what ``shard_map`` gives the JAX package:

* :func:`ring_shift`, ``lax.ppermute`` by ±1 around an axis of the rank grid
  (``parallel/mesh.py::Axis``), on ``batch_isend_irecv``; its backward is the
  reverse shift, which is what ``ppermute`` transposes to.  A ring of one
  returns its input: nothing is sent to oneself.
* Megatron's pair for the model axis: :func:`copy_to_axis` (identity
  forward; its backward all-reduces the gradient of the replicated input
  that every model rank reads) and :func:`reduce_from_axis` (the all-reduce
  of a row-split output; identity backward).
* :func:`all_gather_cat`, the shards of an axis concatenated in axis order
  (no autograd: scoring only).

The tensor-, pipeline- and expert-parallel paths add the other half of
Megatron's set, :func:`gather_from_axis` (all-gather forward, this rank's
slice of the gradient backward) and :func:`scatter_to_axis` (this rank's
slice forward, all-gather backward).  A rank's ``parallel.mesh.Axis`` runs
its lock-step combines on these.

The sums take ``group`` as one process group or as an ordered list of them,
reduced over one after the other: a multi-slice grid's data-parallel step
sums inside a host first, then across hosts (``parallel/multislice.py``).

JAX's named-axis collectives close the module, over a lock-step view of an
axis (a rank's ``parallel.mesh.Axis``, or a ``VirtualAxis`` holding every
lane): :func:`all_gather`, :func:`reduce_scatter`, :func:`ppermute_ring`,
:func:`axis_index` and :func:`barrier`.  Each takes and returns one entry a
lane held, as the views' methods do.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from cvml_goalnet_tpu_torch.train.optim import tree_leaves, tree_unflatten


def _groups(group) -> list:
    """``group`` as the groups to sum over in order: one process group (``None``: the world), or a list of
    them."""
    return list(group) if isinstance(group, (list, tuple)) else [group]


def group_size(group) -> int:
    """The ranks a sum over ``group`` spans: the product of its groups' sizes."""
    return math.prod(dist.get_world_size(g) for g in _groups(group))


def _sum_in_place(t: torch.Tensor, group) -> torch.Tensor:
    for g in _groups(group):
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=g)
    return t


class _AllReduceSum(torch.autograd.Function):
    """Σ over the group forward; backward, the sum over the group of the output's gradients (every rank's loss
    reads the sum, so each rank's input feeds every rank's loss)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _sum_in_place(x.clone(memory_format=torch.contiguous_format), group)

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad, ctx.group), None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Σ over the ranks of ``group``, differentiable: the gradient of each rank's input is the sum of every
    rank's gradient of the output."""
    return _AllReduceSum.apply(x, group)


def psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Σ over the ranks of ``group``, a new tensor (no autograd)."""
    return _sum_in_place(x.detach().clone(), group)


def pmean(x: torch.Tensor, group=None) -> torch.Tensor:
    """The mean over the ranks of ``group`` (no autograd)."""
    return psum(x, group) / group_size(group)


def tree_psum(tree, group=None, mean: bool = False):
    """Every leaf of a tree of float tensors summed (or averaged) over ``group``, in one all-reduce of the
    leaves flattened into one buffer."""
    leaves = tree_leaves(tree)
    if not leaves:
        return tree
    flat = _sum_in_place(torch.cat([t.detach().reshape(-1).to(torch.float32) for t in leaves]), group)
    if mean:
        flat = flat / group_size(group)
    out, off = [], 0
    for t in leaves:
        out.append(flat[off:off + t.numel()].reshape(t.shape).to(t.dtype))
        off += t.numel()
    return tree_unflatten(tree, out)


def _shifted(x: torch.Tensor, axis, step: int) -> torch.Tensor:
    """The ``x`` of the rank ``step`` places back on ``axis``'s ring (rank j's goes to j + step)."""
    n = axis.size
    if n == 1 or step % n == 0:
        return x
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, axis.ranks[(axis.index + step) % n], axis.group),
           dist.P2POp(dist.irecv, out, axis.ranks[(axis.index - step) % n], axis.group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, step):
        ctx.axis, ctx.step = axis, step
        return _shifted(x, axis, step)

    @staticmethod
    def backward(ctx, grad):
        return _RingShift.apply(grad, ctx.axis, -ctx.step), None, None


def ring_shift(x: torch.Tensor, axis, step: int = 1) -> torch.Tensor:
    """``ppermute`` by ``step`` around ``axis`` (a ``parallel.mesh.Axis``): each rank gets the ``x`` of the rank
    ``step`` places back.  Differentiable: the gradient goes back by the reverse shift."""
    return _RingShift.apply(x, axis, step)


class _CopyToAxis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, op=dist.ReduceOp.SUM, group=ctx.group)
        return grad, None


class _ReduceFromAxis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_axis(x: torch.Tensor, axis) -> torch.Tensor:
    """``x`` as is; in the backward the sum over ``axis`` of the gradients (every rank of the axis reads the same
    ``x`` into its own columns).  The identity on an axis of one."""
    return x if axis.size == 1 else _CopyToAxis.apply(x, axis.group)


def reduce_from_axis(x: torch.Tensor, axis) -> torch.Tensor:
    """Σ over ``axis`` of each rank's ``x`` (a row-split product's partial sums); the gradient passes to each
    rank's ``x`` unchanged.  The identity on an axis of one."""
    return x if axis.size == 1 else _ReduceFromAxis.apply(x, axis.group)


class _GatherFromAxis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim, ctx.width = axis, dim, x.shape[dim]
        return all_gather_cat(x, axis, dim)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.axis.index * ctx.width, ctx.width), None, None


class _ScatterToAxis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        width = x.shape[dim] // axis.size
        return x.narrow(dim, axis.index * width, width).contiguous()

    @staticmethod
    def backward(ctx, grad):
        return all_gather_cat(grad, ctx.axis, ctx.dim), None, None


def gather_from_axis(x: torch.Tensor, axis, dim: int = -1) -> torch.Tensor:
    """Every rank's ``x`` on ``axis`` concatenated along ``dim`` in axis order; the gradient of this rank's ``x`` is
    its slice of the output's (every rank reads the same gathered tensor)."""
    return x if axis.size == 1 else _GatherFromAxis.apply(x, axis, dim % x.dim())


def scatter_to_axis(x: torch.Tensor, axis, dim: int = -1) -> torch.Tensor:
    """This rank's slice (``axis.index`` of ``axis.size`` equal ones) of a replicated ``x`` along ``dim``; the
    gradient of ``x`` is every rank's slice gradient gathered."""
    return x if axis.size == 1 else _ScatterToAxis.apply(x, axis, dim % x.dim())


def all_gather_cat(x: torch.Tensor, axis, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` (one shape) on ``axis``, concatenated along ``dim`` in axis order; no autograd."""
    if axis.size == 1:
        return x
    x = x.detach().contiguous()
    parts = [torch.empty_like(x) for _ in range(axis.size)]
    dist.all_gather(parts, x, group=axis.group)
    return torch.cat(parts, dim=dim)


def all_gather(xs: list, axis, tiled: bool = False) -> list:
    """JAX's ``all_gather`` over ``axis``: for each lane held, every lane's ``x`` stacked on a new leading dim in
    axis order, or with ``tiled`` concatenated along dim 0.  Differentiable (``Axis.gather``)."""
    return axis.gather(xs if tiled else [x.unsqueeze(0) for x in xs], dim=0)


def reduce_scatter(xs: list, axis) -> list:
    """JAX's ``psum_scatter(tiled=True)`` over ``axis``: the sum of every lane's ``x``, cut along dim 0 into
    ``axis.size`` equal chunks, lane i's the i-th.  Differentiable.  On a rank it is an all-reduce and a slice
    (gloo has no reduce-scatter)."""
    rows = xs[0].shape[0]
    if rows % axis.size:
        raise ValueError(f"reduce_scatter: {rows} rows do not split over an axis of {axis.size}")
    return axis.scatter(axis.sum(xs), dim=0)


def ppermute_ring(xs: list, axis, shift: int = 1) -> list:
    """JAX's ``ppermute_ring``: lane i's ``x`` goes to lane i + ``shift`` around ``axis`` (``Axis.shift``)."""
    return axis.shift(xs, shift)


def axis_index(axis) -> list:
    """JAX's ``axis_index``: the index on ``axis`` of each lane held."""
    return list(axis.lanes)


def barrier(xs: list, axis) -> list:
    """Every rank of ``axis`` reaches this point before any goes on; ``xs`` comes back as it was (one process
    holding every lane has nothing to wait for)."""
    axis.barrier()
    return xs
