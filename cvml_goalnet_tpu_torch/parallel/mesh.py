"""Device meshes of the port: an ordered list of the devices of a mesh, and the rank grids of the parallel
training paths.

Port of what the parallel paths need of ``cvml_goalnet_tpu/parallel/mesh.py``
and ``parallel/serving.py:30``.  A JAX mesh is a grid of devices with named
axes; the port's mesh is a plain list of ``torch.device``s in the JAX mesh's
device order (row-major over its axes): ``cuda:0 … cuda:n-1`` on the cards.
On the CPU (``device="cpu"``) a mesh of n entries repeats the one CPU device n
times, so the padding, splitting and gathering run as on n cards.

The training paths run one spawned rank per mesh entry
(``parallel/launch.py``).  :func:`grid_groups` lays the ranks out as a JAX
mesh of named axes (rank r at the row-major coordinates of r) and gives a rank
one :class:`Axis` per name: the ``(data, model)`` grid of ``train --dp``,
the ``(data, model, ctx)`` grid of ``spot-train --cp`` (:func:`cp_groups`)
and the ``(data, pipe)`` grid of ``spot-train --pp``.  An :class:`Axis` and a
:class:`VirtualAxis` (every rank of an axis in one process) are also the
lock-step views the parallel layers run on.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from cvml_goalnet_tpu_torch.config import MeshConfig
from cvml_goalnet_tpu_torch.device import resolve_device
from cvml_goalnet_tpu_torch.parallel import collectives as C
from cvml_goalnet_tpu_torch.train.optim import tree_leaves, tree_unflatten


def _visible(dev: torch.device) -> int:
    return torch.cuda.device_count() if dev.type == "cuda" else 1


def _entries(dev: torch.device, n: int) -> list[torch.device]:
    if dev.type == "cuda":
        return [torch.device("cuda", i) for i in range(n)]
    return [dev] * n


def serving_mesh(n_devices: int | None = None, device=None) -> list[torch.device]:
    """The first ``n_devices`` cards (all of them for ``None`` or ``-1``), or on the CPU that many entries of the
    CPU device (one for ``None`` or ``-1``).  More cards than are visible raise the JAX package's ``ValueError``."""
    dev = resolve_device(device)
    visible = _visible(dev)
    if n_devices is None or n_devices == -1:
        return _entries(dev, visible)
    if n_devices < 1:
        raise ValueError(f"--dp {n_devices}: give a positive device count, or -1 for every visible device")
    if dev.type == "cuda" and n_devices > visible:
        raise ValueError(f"--dp {n_devices} requested but only {visible} device(s) are visible")
    return _entries(dev, n_devices)


def mesh_axis_sizes(cfg: MeshConfig, n_devices: int) -> tuple[int, int]:
    """(data, model) of ``cfg`` over ``n_devices`` devices (``data = -1``: the rest of them), JAX's checks."""
    model = max(1, cfg.model)
    if n_devices % model != 0:
        raise ValueError(f"{n_devices} devices not divisible by model axis {model}")
    data = cfg.data if cfg.data > 0 else n_devices // model
    if data * model != n_devices:
        raise ValueError(f"mesh {data}x{model} != {n_devices} devices")
    return data, model


def build_mesh(cfg: MeshConfig = MeshConfig(), device=None) -> list[torch.device]:
    """The ``data × model`` grid of ``cfg`` as a device list in the JAX mesh's order (entry ``d·model + m``).

    ``data = -1`` takes every visible card (one data entry on the CPU); more
    cards than are visible raise ``ValueError``, as does a model axis that
    does not divide the visible cards.
    """
    dev = resolve_device(device)
    visible = _visible(dev)
    model = max(1, cfg.model)
    if dev.type == "cuda" and cfg.data <= 0:
        data, model = mesh_axis_sizes(cfg, visible)
    else:
        data = cfg.data if cfg.data > 0 else 1
    if dev.type == "cuda" and data * model > visible:
        raise ValueError(f"mesh {data}x{model} needs {data * model} devices but only {visible} are visible")
    return _entries(dev, data * model)


def cpu_mesh(n: int, model: int = 1) -> list[torch.device]:
    """JAX's test mesh of ``n`` CPU devices as a ``(n / model) × model`` grid: ``n`` entries of the CPU device
    (gloo ranks for the training paths); a model axis that does not divide ``n`` raises its ``ValueError``."""
    data, model = mesh_axis_sizes(MeshConfig(data=n // max(1, model), model=model), n)
    return build_mesh(MeshConfig(data=data, model=model), device="cpu")


class Axis(NamedTuple):
    """One axis of the rank grid as this rank sees it: the process group of the ranks that differ from it along
    the axis only, their global ranks in axis order, and this rank's index among them.

    It is also the lock-step view of the axis that the tensor-, pipeline-,
    expert- and context-parallel code runs on, holding one lane, this rank's
    (:class:`VirtualAxis` holds every lane in one process).  Each method takes
    and returns a list with one entry a lane held, and each combine is a
    collective over the axis (``parallel/collectives.py``): ``copy`` and
    ``reduce`` are Megatron's pair, ``sum`` the differentiable all-reduce,
    ``tree_sum`` one all-reduce of a tree (no autograd), ``gather`` and
    ``scatter`` the other pair, ``shift`` the ring's ``ppermute``.  ``split``
    gives the trees of the lanes held from what the caller holds (a rank
    holds its own lane's already) and ``join`` the reverse; ``barrier`` waits
    for every rank of the axis.
    """
    group: object
    ranks: tuple
    index: int

    @property
    def size(self) -> int:
        return len(self.ranks)

    @property
    def lanes(self) -> list:
        return [self.index]

    def copy(self, xs: list) -> list:
        return [C.copy_to_axis(xs[0], self)]

    def reduce(self, xs: list) -> list:
        return [C.reduce_from_axis(xs[0], self)]

    def sum(self, xs: list) -> list:
        return [xs[0] if self.size == 1 else C.all_reduce_sum(xs[0], self.group)]

    def tree_sum(self, trees: list) -> list:
        return [C.tree_psum(trees[0], self.group)]

    def gather(self, xs: list, dim: int = -1) -> list:
        return [C.gather_from_axis(xs[0], self, dim)]

    def scatter(self, xs: list, dim: int = -1) -> list:
        return [C.scatter_to_axis(xs[0], self, dim)]

    def shift(self, xs: list, step: int = 1) -> list:
        return [C.ring_shift(xs[0], self, step)]

    def split(self, tree, cut) -> list:
        return [tree]

    def barrier(self) -> None:
        dist.barrier(group=self.group)

    def join(self, trees: list, glue):
        return trees[0]


class VirtualAxis:
    """Every lane of an axis of ``size`` in one process, in order, with :class:`Axis`'s methods: a combine is
    plain arithmetic on the lanes (sums, concatenations, slices, the ring's rotation), so autograd through it
    is the whole axis's.  The one-card checks of ``chip_smoke.py`` run the parallel paths on it.  ``split``
    cuts lane i's tree from the whole one with ``cut(tree, i, size)``, ``join`` gives ``glue(trees)``."""

    def __init__(self, size: int):
        self.size, self.lanes = size, list(range(size))

    def copy(self, xs: list) -> list:
        return list(xs)

    def reduce(self, xs: list) -> list:
        total = sum(xs[1:], xs[0])
        return [total] * self.size

    sum = reduce

    def tree_sum(self, trees: list) -> list:
        leaves = [tree_leaves(t) for t in trees]
        total = tree_unflatten(trees[0], [sum(ls[1:], ls[0]) for ls in zip(*leaves)])
        return [total] * self.size

    def gather(self, xs: list, dim: int = -1) -> list:
        return [torch.cat(xs, dim=dim)] * self.size

    def scatter(self, xs: list, dim: int = -1) -> list:
        return [x.narrow(dim, i * (x.shape[dim] // self.size), x.shape[dim] // self.size) for i, x in enumerate(xs)]

    def shift(self, xs: list, step: int = 1) -> list:
        return [xs[(i - step) % self.size] for i in self.lanes]

    def split(self, tree, cut) -> list:
        return [cut(tree, i, self.size) for i in self.lanes]

    def barrier(self) -> None:
        pass

    def join(self, trees: list, glue):
        return glue(trees)


class CpGroups(NamedTuple):
    """This rank's place in the (data, model, ctx) grid: one :class:`Axis` each."""
    data: Axis
    model: Axis
    ctx: Axis


def grid_groups(axes) -> dict:
    """This rank's :class:`Axis` of each named axis of a rank grid → ``{name: Axis}``.

    ``axes`` is ``[(name, size), ...]`` in the JAX mesh's order, and the world
    (the default process group) must hold their product: rank r sits at the
    row-major coordinates of r.  Every rank creates every group of every
    axis, in one order (``new_group`` is collective), and keeps its own.
    """
    names, sizes = [n for n, _ in axes], [int(s) for _, s in axes]
    world, me = dist.get_world_size(), dist.get_rank()
    if math.prod(sizes) != world:
        raise ValueError(f"a {'x'.join(map(str, sizes))} rank grid needs {math.prod(sizes)} ranks, the world has "
                         f"{world}")
    coords = [tuple(int(c) for c in np.unravel_index(r, sizes)) for r in range(world)]
    out = {}
    for k, name in enumerate(names):
        lines: dict = {}
        for r, c in enumerate(coords):   # along a line, r grows with coordinate k
            lines.setdefault(c[:k] + c[k + 1:], []).append(r)
        for key in sorted(lines):
            ranks = tuple(lines[key])
            group = dist.new_group(list(ranks))
            if me in ranks:
                out[name] = Axis(group, ranks, ranks.index(me))
    return out


def cp_groups(ndp: int, ntp: int, nctx: int) -> CpGroups:
    """This rank's :class:`CpGroups` in a world of ``ndp·ntp·nctx`` ranks, JAX's ``(data, model, ctx)`` mesh."""
    return CpGroups(**grid_groups([("data", ndp), ("model", ntp), ("ctx", nctx)]))


def cp_world(device=None, cpu_ranks: int = 1) -> list[torch.device]:
    """The devices a context- or pipeline-parallel ``spot-train`` may take: every visible card, as the JAX CLI
    takes every device; on the CPU ``cpu_ranks`` entries of the CPU device (gloo ranks; the config's
    ``mesh.data``)."""
    dev = resolve_device(device)
    return _entries(dev, _visible(dev) if dev.type == "cuda" else max(1, cpu_ranks))
