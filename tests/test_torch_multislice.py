"""PyTorch port: multi-slice grids (``parallel/multislice.py``), JAX's remaining collectives and ``cpu_mesh``
against the JAX package, on the CPU.

The grid cases are JAX's ``TestMultiSlice`` and ``TestMultiSliceNonDegenerate`` shape and ``ValueError``
cases (``tests/test_parallel.py``), each held to JAX's ``build_multislice_mesh`` on the suite's 8 CPU devices;
with ``n_slices=None`` a slice is a host process.  The collectives run on a ``VirtualAxis`` of 8 lanes against
JAX's under ``shard_map`` on the 8 devices (exact but for float sums, 1e-6).  The multi-host data-parallel
step on the (2, 2, 1) grid, and its gradient against JAX's ``test_dp_grads_reduce_over_slice_and_data``, are
in ``tests/test_torch_multihost.py`` (two host processes).
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from cvml_goalnet_tpu.parallel.mesh import cpu_mesh as jax_cpu_mesh
from cvml_goalnet_tpu.parallel.multislice import build_multislice_mesh as jax_build
from cvml_goalnet_tpu.parallel.multislice import grad_reduce_axes as jax_axes
from cvml_goalnet_tpu_torch.parallel import collectives as C
from cvml_goalnet_tpu_torch.parallel import multihost
from cvml_goalnet_tpu_torch.parallel.launch import Hosts
from cvml_goalnet_tpu_torch.parallel.mesh import VirtualAxis, cpu_mesh, serving_mesh
from cvml_goalnet_tpu_torch.parallel.multislice import build_multislice_mesh, grad_reduce_axes
from test_torch_multihost import jax_collectives, lanes

CPU8 = serving_mesh(8, device="cpu")
GRID_CASES = {
    "single_slice_degenerate": {},
    "model_axis_split": {"model": 2},
    "hybrid_two_slices": {"n_slices": 2},
    "hybrid_two_slices_model_2": {"model": 2, "n_slices": 2},
    "four_slices_model_2": {"model": 2, "n_slices": 4},
    "eight_slices": {"n_slices": 8},
    "data_given": {"data": 4, "n_slices": 2},
}
INVALID_CASES = {
    "invalid_model_axis": {"model": 3},
    "invalid_synthetic_partition": {"n_slices": 3},
    "no_slices": {"n_slices": 0},
    "data_past_the_slice": {"data": 3},
    "data_times_model_short": {"data": 2, "model": 2, "n_slices": 1},
}


@pytest.mark.parametrize("kw", list(GRID_CASES.values()), ids=list(GRID_CASES))
def test_grid_matches_jax(kw):
    want = jax_build(devices=jax.devices("cpu")[:8], **kw)
    got = build_multislice_mesh(devices=CPU8, **kw)
    assert got.shape == dict(want.shape)
    assert [n for n, _ in got.axes] == list(want.axis_names)
    assert grad_reduce_axes(got) == jax_axes(want)
    assert list(got.devices) == CPU8


@pytest.mark.parametrize("kw", list(INVALID_CASES.values()), ids=list(INVALID_CASES))
def test_invalid_grid_raises_as_jax(kw):
    with pytest.raises(ValueError):
        jax_build(devices=jax.devices("cpu")[:8], **kw)
    with pytest.raises(ValueError):
        build_multislice_mesh(devices=CPU8, **kw)


@pytest.mark.parametrize("hosts,want", [(1, {"slice": 1, "data": 4, "model": 1}),
                                        (2, {"slice": 2, "data": 2, "model": 1}),
                                        (4, {"slice": 4, "data": 1, "model": 1})])
def test_a_slice_is_a_host_process(monkeypatch, hosts, want):
    monkeypatch.setattr(multihost, "_HOSTS", Hosts("127.0.0.1", 1, hosts, 0))
    mesh = build_multislice_mesh(devices=serving_mesh(4, device="cpu"))
    assert mesh.shape == want
    assert grad_reduce_axes(mesh) == (tuple(a for a in ("data", "slice") if want[a] > 1) or ("data",))


def test_devices_that_do_not_split_over_the_hosts_raise(monkeypatch):
    monkeypatch.setattr(multihost, "_HOSTS", Hosts("127.0.0.1", 1, 2, 0))
    with pytest.raises(ValueError, match="hosts"):
        build_multislice_mesh(devices=serving_mesh(3, device="cpu"))


COLLECTIVES = ["all_gather", "all_gather_tiled", "reduce_scatter", "axis_index", "ppermute_ring_1",
               "ppermute_ring_-1", "ppermute_ring_2"]


@pytest.fixture(scope="module")
def jax_lanes8():
    x = lanes(8)
    return x, jax_collectives(x)


def port_collective(name: str, xs: list, axis) -> list:
    if name == "all_gather_tiled":
        return C.all_gather(xs, axis, tiled=True)
    if name.startswith("ppermute_ring_"):
        return C.ppermute_ring(xs, axis, int(name.rsplit("_", 1)[1]))
    return getattr(C, name)(axis) if name == "axis_index" else getattr(C, name)(xs, axis)


@pytest.mark.parametrize("name", COLLECTIVES)
def test_collective_on_virtual_lanes_matches_jax_shard_map(jax_lanes8, name):
    x, want = jax_lanes8
    axis = VirtualAxis(8)
    got = port_collective(name, [torch.as_tensor(v) for v in x], axis)
    assert len(got) == 8
    for i, g in enumerate(got):
        np.testing.assert_allclose(np.asarray(g), want[name][i], rtol=0, atol=1e-6, err_msg=f"{name} lane {i}")


def test_all_gather_and_reduce_scatter_are_differentiable():
    """JAX transposes ``all_gather`` to ``psum_scatter``: the gradient of lane i's input is the sum over lanes of
    the incoming gradient's i-th block."""
    axis = VirtualAxis(4)
    xs = [torch.randn(2, 3, generator=torch.Generator().manual_seed(i), requires_grad=True) for i in range(4)]
    cot = [torch.randn(8, 3, generator=torch.Generator().manual_seed(10 + i)) for i in range(4)]
    gathered = C.all_gather(xs, axis, tiled=True)
    grads = torch.autograd.grad(sum((g * c).sum() for g, c in zip(gathered, cot)), xs)
    want = C.reduce_scatter(cot, axis)
    for g, w in zip(grads, want):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-6)


def test_reduce_scatter_refuses_rows_that_do_not_split():
    with pytest.raises(ValueError, match="split"):
        C.reduce_scatter([torch.zeros(3, 2)] * 2, VirtualAxis(2))


def test_barrier_on_virtual_lanes_returns_its_input():
    xs = [torch.ones(2)] * 3
    assert C.barrier(xs, VirtualAxis(3)) is xs


@pytest.mark.parametrize("n,model", [(8, 1), (8, 2), (4, 4), (2, 1)])
def test_cpu_mesh_matches_jax(n, model):
    want = jax_cpu_mesh(n, model=model)
    got = cpu_mesh(n, model=model)
    assert len(got) == want.devices.size and all(d == torch.device("cpu") for d in got)


def test_cpu_mesh_model_axis_that_does_not_divide_raises_as_jax():
    with pytest.raises(ValueError):
        jax_cpu_mesh(8, model=3)
    with pytest.raises(ValueError):
        cpu_mesh(8, model=3)
