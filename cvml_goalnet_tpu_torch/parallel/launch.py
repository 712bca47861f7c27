"""One process per mesh entry, joined in one ``torch.distributed`` group.

JAX runs a data-parallel step as one program over the mesh; the port runs
one rank per device.  :func:`spawn_ranks` starts them (the ``spawn`` start
method: each rank is a fresh interpreter that imports the port only), joins
them through a ``FileStore`` in a fresh temporary directory (no TCP port, so
concurrent runs on one machine never collide), on NCCL for the cards and
gloo for the CPU, and returns what each rank's function returned.  There is
no fallback: without NCCL on the cards it raises before starting, and a
rank that fails ends the others and raises here.
"""

from __future__ import annotations

import datetime
import os
import pickle
import shutil
import tempfile

import torch
import torch.distributed as dist

NO_NCCL = ("data parallelism on the cards needs torch.distributed's NCCL backend, which this PyTorch build lacks; "
           "the port does not fall back to gloo or to fewer ranks")
TIMEOUT = datetime.timedelta(minutes=30)


def backend_of(mesh) -> str:
    """``"nccl"`` for a mesh of cards, ``"gloo"`` for the CPU."""
    return "nccl" if mesh[0].type == "cuda" else "gloo"


def cpu_threads(world: int) -> int:
    """Intra-op threads of a CPU rank: the machine's cores shared out, so ``world`` ranks do not each take them
    all."""
    return max(1, min(4, (os.cpu_count() or 1) // world))


def _rank_entry(rank: int, fn, mesh, run_dir: str, backend: str, args: tuple) -> None:
    world, dev = len(mesh), mesh[rank]
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:
        torch.set_num_threads(cpu_threads(world))
    store = dist.FileStore(os.path.join(run_dir, "store"), world)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world, timeout=TIMEOUT,
                            device_id=dev if dev.type == "cuda" else None)
    try:
        out = fn(rank, world, dev, *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    path = os.path.join(run_dir, f"rank{rank}.pkl")
    with open(path + ".tmp", "wb") as f:
        pickle.dump(out, f)
    os.replace(path + ".tmp", path)


def spawn_ranks(fn, mesh, args: tuple = ()) -> list:
    """Run ``fn(rank, world, device, *args)`` in one spawned process per entry of ``mesh`` (a device list), all
    in the default process group → the list of their return values, in rank order (pickled back).

    ``fn`` must be a module-level function of a module that imports no JAX.
    """
    backend = backend_of(mesh)
    if backend == "nccl" and not dist.is_nccl_available():
        raise RuntimeError(NO_NCCL)
    run_dir = tempfile.mkdtemp(prefix="goalnet-ranks-")
    try:
        torch.multiprocessing.start_processes(_rank_entry, args=(fn, list(mesh), run_dir, backend, args),
                                              nprocs=len(mesh), join=True, start_method="spawn")
        out = []
        for rank in range(len(mesh)):
            with open(os.path.join(run_dir, f"rank{rank}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)
