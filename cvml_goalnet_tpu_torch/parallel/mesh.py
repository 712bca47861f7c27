"""Device meshes of the port: an ordered list of the devices that split a batch, and the rank grid of the
context-parallel spotting steps.

Port of what the data-parallel paths need of ``cvml_goalnet_tpu/parallel/mesh.py``
and ``parallel/serving.py:30``.  A JAX mesh is a grid of devices with named
axes; the port's data axis is a plain list of ``torch.device``s, entry i
holding the i-th contiguous block of a batch: ``cuda:0 … cuda:n-1`` on the
cards.  On the CPU (``device="cpu"``) a mesh of n entries repeats the one CPU
device n times, so the padding, splitting and gathering run as on n cards.
The model axis of the fusion MLP (its Megatron layout,
``parallel/sharding.py:31``) is not ported: a mesh with ``model > 1`` raises.

Context-parallel spotting (``spot-train --cp``) runs one spawned rank per
mesh entry (``parallel/launch.py``), laid out as the JAX CLI's
``Mesh(devices.reshape(ndp, ntp, nctx), ("data", "model", "ctx"))``: rank
``(d·ntp + m)·nctx + c`` sits at data index d, model index m and ctx index c.
:func:`cp_groups` gives a rank its ctx ring, its model group and its data
group (:class:`CpGroups`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from cvml_goalnet_tpu_torch.config import MeshConfig
from cvml_goalnet_tpu_torch.device import resolve_device

TP_NOT_PORTED = (
    "tensor-parallel fusion (mesh.model > 1, tensor_parallel=True: the Megatron layout of the JAX package's "
    "parallel/sharding.py:31) is not ported yet (ROADMAP.md §1 item 6.6); the port runs the data axis only"
)


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


def build_mesh(cfg: MeshConfig = MeshConfig(), device=None) -> list[torch.device]:
    """The data axis of ``cfg`` (``data = -1``: every visible card, one entry on the CPU) as a device list.

    ``model > 1`` raises ``NotImplementedError`` (ROADMAP §1 item 6.6); more
    cards than are visible raise ``ValueError``.
    """
    if cfg.model > 1:
        raise NotImplementedError(TP_NOT_PORTED)
    dev = resolve_device(device)
    visible = _visible(dev)
    data = cfg.data if cfg.data > 0 else visible
    if dev.type == "cuda" and data > visible:
        raise ValueError(f"mesh {data}x{max(1, cfg.model)} needs {data} devices but only {visible} are visible")
    return _entries(dev, data)


class Axis(NamedTuple):
    """One axis of the rank grid as this rank sees it: the process group of the ranks that differ from it along
    the axis only, their global ranks in axis order, and this rank's index among them."""
    group: object
    ranks: tuple
    index: int

    @property
    def size(self) -> int:
        return len(self.ranks)


class CpGroups(NamedTuple):
    """This rank's place in the (data, model, ctx) grid: one :class:`Axis` each."""
    data: Axis
    model: Axis
    ctx: Axis


def grid_rank(d: int, m: int, c: int, ntp: int, nctx: int) -> int:
    """The global rank at data index d, model index m, ctx index c (the JAX mesh's device order)."""
    return (d * ntp + m) * nctx + c


def cp_groups(ndp: int, ntp: int, nctx: int) -> CpGroups:
    """This rank's :class:`CpGroups` in a world of ``ndp·ntp·nctx`` ranks (the default process group).

    Every rank creates every group of every axis, in one order (``new_group`` is collective), and keeps its
    own three.
    """
    world, me = dist.get_world_size(), dist.get_rank()
    if ndp * ntp * nctx != world:
        raise ValueError(f"a {ndp}x{ntp}x{nctx} rank grid needs {ndp * ntp * nctx} ranks, the world has {world}")
    coords = {grid_rank(d, m, c, ntp, nctx): (d, m, c)
              for d in range(ndp) for m in range(ntp) for c in range(nctx)}
    axes = {}
    for axis, size in (("data", ndp), ("model", ntp), ("ctx", nctx)):
        k = ("data", "model", "ctx").index(axis)
        lines = {}
        for r, dmc in sorted(coords.items()):
            key = dmc[:k] + dmc[k + 1:]
            lines.setdefault(key, []).append(r)
        for key in sorted(lines):
            ranks = tuple(sorted(lines[key], key=lambda r: coords[r][k]))
            group = dist.new_group(list(ranks))
            if me in ranks:
                axes[axis] = Axis(group, ranks, ranks.index(me))
    return CpGroups(**axes)


def cp_world(device=None, cpu_ranks: int = 1) -> list[torch.device]:
    """The ranks of a context-parallel ``spot-train``: every visible card, as the JAX CLI takes every device;
    on the CPU ``cpu_ranks`` entries of the CPU device (gloo ranks; the config's ``mesh.data``)."""
    dev = resolve_device(device)
    return _entries(dev, _visible(dev) if dev.type == "cuda" else max(1, cpu_ranks))
