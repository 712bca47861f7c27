"""Multi-slice grids: the fast link inside a slice, the slow one across slices.

Port of ``cvml_goalnet_tpu/parallel/multislice.py``.  On a TPU a slice is a
set of chips on one ICI torus, and slices talk over DCN.  On H100s a slice is
a host: its cards share NVLink, and hosts talk over the network.  So a grid's
``("slice", "data", "model")`` axes put the outer, infrequent axis across
hosts and the data and model axes inside one, and a data-parallel step sums
its gradients over ``data`` (inside the host) first, then over ``slice``
(:func:`grad_reduce_axes`), never in one all-reduce over the world.

A grid is a :class:`SliceMesh`: every rank's device in rank order, rank r at
the row-major (slice, data, model) coordinates of r, which is
``parallel/mesh.py::grid_groups``' layout and, with one slice a host, the
process-major rank order of ``parallel/multihost.py``.  In a rank,
:func:`data_parallel_groups` makes the grid's groups and gives what
``parallel/dp.py::make_dp_train_step`` takes.
"""

from __future__ import annotations

from typing import NamedTuple

from cvml_goalnet_tpu_torch.parallel.mesh import grid_groups
from cvml_goalnet_tpu_torch.parallel.multihost import global_data_mesh, process_count


class SliceMesh(NamedTuple):
    """A ``(slice, data, model)`` grid: ``devices`` in rank order, ``shape`` ``{"slice": S, "data": D, "model":
    M}`` (JAX's ``mesh.shape``)."""
    devices: tuple
    shape: dict

    @property
    def axes(self) -> list[tuple[str, int]]:
        """The grid's axes in order, as ``grid_groups`` takes them."""
        return list(self.shape.items())


def build_multislice_mesh(data: int = -1, model: int = 1, devices=None, n_slices: int | None = None) -> SliceMesh:
    """The grid with axes ("slice", "data", "model") over ``devices`` (default: every rank of every host
    process, ``multihost.global_data_mesh``).

    With ``n_slices=None`` a slice is a host: the grid spans ``process_count()`` slices, one on a single host,
    so training code shards over ("slice", "data") either way.  ``n_slices`` overrides that with JAX's
    synthetic contiguous partition of the device list, slice-major, as single-host tests do.  ``data = -1``
    takes the rest of a slice; the model axis must divide a slice and ``data × model`` fill it (JAX's
    ``ValueError``s).
    """
    devices = global_data_mesh().devices if devices is None else list(devices)
    if n_slices is None:
        n_slices = process_count()
        if len(devices) % n_slices:
            raise ValueError(f"{len(devices)} devices do not split over {n_slices} hosts")
    elif n_slices < 1 or len(devices) % n_slices != 0:
        raise ValueError(f"n_slices {n_slices} must divide {len(devices)} devices")
    per_slice = len(devices) // n_slices
    if model <= 0 or per_slice % model != 0:
        raise ValueError(f"model axis {model} must divide per-slice size {per_slice}")
    data = per_slice // model if data <= 0 else data
    if data * model != per_slice:
        raise ValueError(f"slice mesh {data}x{model} != {per_slice} devices/slice")
    return SliceMesh(tuple(devices), {"slice": n_slices, "data": data, "model": model})


def grad_reduce_axes(mesh: SliceMesh) -> tuple[str, ...]:
    """Axes a data-parallel gradient sum must span, inside a host first, then across hosts."""
    return tuple(a for a in ("data", "slice") if mesh.shape.get(a, 1) > 1) or ("data",)


def data_parallel_groups(mesh: SliceMesh) -> tuple[list, int]:
    """In a rank of ``mesh``'s grid (every rank calls it: groups are made collectively) → the process groups
    of :func:`grad_reduce_axes`, in order, for ``make_dp_train_step(cfg, group=...)``, and this rank's block
    of the global batch, which splits over the flattened (slice × data) product: ``slice·D + data``."""
    grid = grid_groups(mesh.axes)
    return [grid[a].group for a in grad_reduce_axes(mesh)], grid["slice"].index * grid["data"].size + grid["data"].index
