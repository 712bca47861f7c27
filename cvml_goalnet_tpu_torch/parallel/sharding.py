"""Sharding rules: which parameters a model rank holds a slice of, and which rows of a batch a data rank takes.

Port of ``cvml_goalnet_tpu/parallel/sharding.py``.  JAX states a layout as
``NamedSharding``s and lets GSPMD place the pieces; a rank of the port holds
its pieces itself.  A layout here is a tree congruent with the parameters
whose leaves name the dimension a leaf splits along over the model axis, or
``None`` for a leaf every model rank holds whole (``P()``):

* :func:`fusion_param_shardings`, the fusion MLP's Megatron layout (JAX
  ``:31-66``): even hidden layers split output features (column parallel,
  their bias with them), odd hidden layers split input features (row
  parallel, bias whole), the last layer and an MoE layer stay whole;
* :func:`transformer_param_shardings`, the temporal transformer's (JAX
  ``:69-110``): ``wq``/``wk``/``wv``/``mlp_in`` by columns, ``wo``/``mlp_out``
  by rows, everything else whole.

:func:`model_shard` cuts one model rank's slice of a tree (views: autograd
through a slice reaches the whole leaf), :func:`gather_model_shards` puts a
rank's slices back together over its model axis, :func:`place_params` is
JAX's ``place_params`` for a rank (the whole tree, or its fusion slice), and
:func:`shard_batch` is the rank's contiguous block of a host batch over its
data axis (``batch_sharding`` the rows).
"""

from __future__ import annotations

import torch

from cvml_goalnet_tpu_torch.train.optim import tree_map

COLS, ROWS = 1, 0   # the split dimension of a weight (in, out): its output columns or its input rows


def fusion_layer_split(i: int, n_layers: int, layer) -> str:
    """How fusion layer ``i`` of ``n_layers`` splits: ``"cols"`` (even hidden), ``"rows"`` (odd hidden) or
    ``"whole"`` (the last layer, and an MoE layer, which expert parallelism shards instead)."""
    if i == n_layers - 1 or "experts" in layer:
        return "whole"
    return "cols" if i % 2 == 0 else "rows"


def _linear_spec(linear, split: str) -> dict:
    """The layout of one ``{"w", "b"}`` linear split by ``"cols"`` or ``"rows"``, in its own key order."""
    dims = {"w": COLS, "b": 0} if split == "cols" else {"w": ROWS, "b": None}
    return {k: dims[k] for k in linear}


def partition_leaves(tree, shardings) -> tuple[list, list]:
    """The leaves of ``tree`` that ``shardings`` keeps whole and those it splits over the model axis, each in
    ``tree_leaves`` order."""
    whole, split = [], []
    tree_map(lambda t, dim: (whole if dim is None else split).append(t), tree, shardings)
    return whole, split


def replicated(params):
    """The layout that keeps every leaf whole on every rank."""
    return tree_map(lambda _: None, params)


def fusion_param_shardings(params):
    """The fusion MLP's Megatron layout over the model axis, everything else whole (a tree congruent with
    ``params``)."""
    out = replicated(params)
    if isinstance(params, dict) and "fusion" in params:
        n_layers = len(params["fusion"])
        specs = []
        for i, layer in enumerate(params["fusion"]):
            split = fusion_layer_split(i, n_layers, layer)
            if split == "whole":
                specs.append(replicated(layer))
            else:   # biases live with the output features of the column-parallel layers
                specs.append(_linear_spec(layer, split))
        out["fusion"] = specs
    return out


def transformer_param_shardings(params):
    """Megatron's head and MLP split of every block of the temporal transformer: column-parallel ``wq``, ``wk``,
    ``wv`` and ``mlp_in`` (whole heads per rank when the model axis divides them), row-parallel ``wo`` and
    ``mlp_out``; ``proj_in``, ``pos``, ``head`` and the layer norms whole."""
    out = replicated(params)
    for spec, layer in zip(out["layers"], params["layers"]):
        for name in ("wq", "wk", "wv", "mlp_in"):
            spec[name] = _linear_spec(layer[name], "cols")
        for name in ("wo", "mlp_out"):
            spec[name] = _linear_spec(layer[name], "rows")
    return out


def _check_divides(t: torch.Tensor, dim: int, n: int) -> None:
    if t.shape[dim] % n:
        raise ValueError(f"a leaf of shape {tuple(t.shape)} does not split over a {n}-way model axis along "
                         f"dimension {dim}")


def model_shard(params, shardings, index: int, n: int):
    """Model rank ``index`` of ``n``'s slice of ``params`` under ``shardings``: a view of each split leaf, the
    whole leaf elsewhere."""
    def cut(t, dim):
        if dim is None or n == 1:
            return t
        _check_divides(t, dim, n)
        width = t.shape[dim] // n
        return t.narrow(dim, index * width, width)

    return tree_map(cut, params, shardings)


def gather_model_shards(params, shardings, axis):
    """The whole tree from every model rank's slice (``axis`` a ``parallel.mesh.Axis``), on every rank; no
    autograd."""
    from cvml_goalnet_tpu_torch.parallel.collectives import all_gather_cat

    return tree_map(lambda t, dim: t if dim is None else all_gather_cat(t, axis, dim), params, shardings)


def place_params(params, model=None, tensor_parallel: bool = False, device=None):
    """This rank's parameters on ``device``: the whole tree (data parallel), or with ``tensor_parallel`` its
    slice of the fusion layout at its index on ``model`` (a ``parallel.mesh.Axis``)."""
    params = tree_map(lambda t: torch.as_tensor(t, device=device), params)
    if tensor_parallel:
        params = model_shard(params, fusion_param_shardings(params), model.index, model.size)
    return tree_map(torch.Tensor.contiguous, params)


def batch_sharding(n: int, axis) -> slice:
    """The rows of an ``n``-row batch that data rank ``axis.index`` of ``axis.size`` takes: its contiguous
    block."""
    if n % axis.size:
        raise ValueError(f"a batch of {n} does not split over the {axis.size} devices of the data axis")
    b = n // axis.size
    return slice(axis.index * b, (axis.index + 1) * b)


def shard_batch(x, axis):
    """This data rank's block of a host batch ``x`` (leading axis)."""
    return x[batch_sharding(len(x), axis)]
