"""Host processes and rank functions for ``tests/test_torch_multihost.py`` and ``tests/test_torch_multislice.py``.

This module imports the port only (no JAX, no ``cvml_goalnet_tpu``).  Run as a script it is one host process
of a multi-host run on the CPU:

    python tests/_torch_multihost_ranks.py <process_id> <num_processes> <port> <local_ranks> <job.pkl> <out.pkl>

It joins the coordinator at ``127.0.0.1:<port>``, spawns ``<local_ranks>`` gloo ranks through
``multihost.run_ranks`` and pickles what its first local rank returned, with the grid the process built, into
``<out.pkl>`` (a failure's message instead, when the job is expected to raise).
"""

from __future__ import annotations

import os
import pickle
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _host(tree):
    from cvml_goalnet_tpu_torch.train.optim import tree_map

    return tree_map(lambda t: t.detach().cpu().numpy(), tree)


def _step(job: dict, device, group, block: int) -> dict:
    """One ``make_dp_train_step`` from the job's weights on this rank's block of the global batch."""
    from cvml_goalnet_tpu_torch import weights
    from cvml_goalnet_tpu_torch.parallel.dp import make_dp_train_step
    from cvml_goalnet_tpu_torch.parallel.multihost import shard_host_batch
    from cvml_goalnet_tpu_torch.train.optim import adam_init

    params, model_state = weights.from_jax(job["params"], job["model_state"], device)
    vis, aud, lab = (shard_host_batch(x, job["mesh"])[0] for x in job["rows"])
    p, ms, opt, loss = make_dp_train_step(job["cfg"], group=group)(params, model_state, adam_init(params), vis, aud,
                                                                    lab)
    return {"loss": float(loss), "params": _host(p), "model_state": _host(ms), "block": block}


def _linear_grad(job: dict, group, block: int) -> np.ndarray:
    """JAX's ``test_dp_grads_reduce_over_slice_and_data``: a block's gradient of its summed squared error,
    summed over ``group`` (data, then slice) and divided by the global rows."""
    from cvml_goalnet_tpu_torch.parallel.collectives import tree_psum

    w = torch.tensor(job["w"], requires_grad=True)
    b = len(job["x"]) // job["blocks"]
    x = torch.as_tensor(job["x"][block * b:(block + 1) * b])
    y = torch.as_tensor(job["y"][block * b:(block + 1) * b])
    d = (x @ w)[:, 0] - y
    (g,) = torch.autograd.grad(torch.sum(d * d), [w])
    return (tree_psum({"g": g}, group)["g"] / len(job["x"])).numpy()


def _collectives(job: dict, rank: int, world: int) -> dict:
    """JAX's named-axis collectives on this rank's row of ``job["lanes"]`` over the world's axis."""
    import torch.distributed as dist

    from cvml_goalnet_tpu_torch.parallel import collectives as C
    from cvml_goalnet_tpu_torch.parallel.mesh import Axis

    axis = Axis(dist.group.WORLD, tuple(range(world)), rank)
    xs = [torch.as_tensor(job["lanes"][rank])]
    out = {"all_gather": C.all_gather(xs, axis)[0], "all_gather_tiled": C.all_gather(xs, axis, tiled=True)[0],
           "reduce_scatter": C.reduce_scatter(xs, axis)[0], "axis_index": C.axis_index(axis)[0]}
    for shift in (1, -1, 2):
        out[f"ppermute_ring_{shift}"] = C.ppermute_ring(xs, axis, shift)[0]
    C.barrier(xs, axis)
    return {k: v.numpy() if isinstance(v, torch.Tensor) else v for k, v in out.items()}


def rank_run(rank: int, world: int, device, job: dict) -> dict:
    """A rank's whole job: the data-parallel step over the world, the same step on the (slice, data, model)
    grid with its gradients summed over data then slice, the linear gradient on that grid, and the
    collectives."""
    from cvml_goalnet_tpu_torch.parallel.multislice import data_parallel_groups

    groups, block = data_parallel_groups(job["slices"])
    out = {"rank": rank, "world": world, "flat": _step(job, device, None, rank),
           "grid": _step(job, device, groups, block), "linear_grad": _linear_grad(job, groups, block),
           "collectives": _collectives(job, rank, world),
           "forbidden": sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "cvml_goalnet_tpu"))}
    return out


def main() -> int:
    from cvml_goalnet_tpu_torch.parallel import multihost
    from cvml_goalnet_tpu_torch.parallel.multislice import build_multislice_mesh

    pid, nproc, port, local = (int(a) for a in sys.argv[1:5])
    job_fp, out_fp = sys.argv[5:7]
    with open(job_fp, "rb") as f:
        job = pickle.load(f)
    multihost.initialize_from_env(f"127.0.0.1:{port}", nproc, pid, timeout=120)
    try:
        mesh = multihost.global_data_mesh(local=local, device="cpu")
        b = len(job["global"][0]) // nproc
        job.update(mesh=mesh, rows=[x[pid * b:(pid + 1) * b] for x in job.pop("global")],
                   slices=build_multislice_mesh(devices=mesh.devices))
        try:
            ranks = multihost.run_ranks(rank_run, mesh, (job,))
            out = {"ranks": ranks, "grid_shape": job["slices"].shape, "process_count": multihost.process_count(),
                   "process_index": multihost.process_index()}
        except ValueError as e:
            out = {"error": str(e)}
    finally:
        multihost.shutdown()
    with open(out_fp, "wb") as f:
        pickle.dump(out, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
