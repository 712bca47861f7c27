"""One process per mesh entry, joined in one ``torch.distributed`` group.

JAX runs a data-parallel step as one program over the mesh; the port runs
one rank per device.  :func:`spawn_ranks` starts them (the ``spawn`` start
method: each rank is a fresh interpreter that imports the port only), joins
them through a ``FileStore`` in a fresh temporary directory (no TCP port, so
concurrent runs on one machine never collide), on NCCL for the cards and
gloo for the CPU, and returns what each rank's function returned.  There is
no fallback: without NCCL on the cards it raises before starting, and a
rank that fails ends the others and raises here.

Across host processes (``parallel/multihost.py``) the ranks join through
the coordinator's ``TCPStore`` instead (:class:`Hosts`): process p of P, with
L local entries, runs global ranks p·L … p·L + L − 1 of one group of P·L.
Every process must run the same L (checked through the store before any
rank starts) and call :func:`spawn_ranks` as often as the others, in the
same order: the n-th call of each process joins the n-th group.
"""

from __future__ import annotations

import datetime
import itertools
import os
import pickle
import shutil
import tempfile
from typing import NamedTuple

import torch
import torch.distributed as dist

NO_NCCL = ("data parallelism on the cards needs torch.distributed's NCCL backend, which this PyTorch build lacks; "
           "the port does not fall back to gloo or to fewer ranks")
TIMEOUT = datetime.timedelta(minutes=30)
_RUNS = itertools.count()   # this process's spawn_ranks calls with hosts: the n-th names the n-th group's keys


class Hosts(NamedTuple):
    """The host processes' rendezvous: the coordinator's ``TCPStore`` at ``host:port``, the processes' count,
    this process's index, and this process's connection to the store (``None`` in a rank)."""
    host: str
    port: int
    count: int
    index: int
    store: object = None


def backend_of(mesh) -> str:
    """``"nccl"`` for a mesh of cards, ``"gloo"`` for the CPU."""
    return "nccl" if mesh[0].type == "cuda" else "gloo"


def cpu_threads(world: int) -> int:
    """Intra-op threads of a CPU rank: the machine's cores shared out, so ``world`` ranks do not each take them
    all."""
    return max(1, min(4, (os.cpu_count() or 1) // world))


def _rank_entry(local: int, fn, mesh, run_dir: str, backend: str, args: tuple, hosts, prefix: str) -> None:
    dev = mesh[local]
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:
        torch.set_num_threads(cpu_threads(len(mesh)))
    if hosts is None:
        rank, world = local, len(mesh)
        store = dist.FileStore(os.path.join(run_dir, "store"), world)
    else:
        rank, world = hosts.index * len(mesh) + local, hosts.count * len(mesh)
        store = dist.PrefixStore(prefix, dist.TCPStore(hosts.host, hosts.port, is_master=False, timeout=TIMEOUT))
    dist.init_process_group(backend, store=store, rank=rank, world_size=world, timeout=TIMEOUT,
                            device_id=dev if dev.type == "cuda" else None)
    try:
        out = fn(rank, world, dev, *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    path = os.path.join(run_dir, f"rank{local}.pkl")
    with open(path + ".tmp", "wb") as f:
        pickle.dump(out, f)
    os.replace(path + ".tmp", path)


def _check_local_counts(hosts: Hosts, prefix: str, local: int) -> None:
    """Every host process posts its count of local ranks to the store and reads the others'; unequal counts
    raise in every process before any rank starts."""
    hosts.store.set(f"{prefix}local{hosts.index}", str(local))
    keys = [f"{prefix}local{p}" for p in range(hosts.count)]
    hosts.store.wait(keys)
    counts = [int(hosts.store.get(k)) for k in keys]
    if len(set(counts)) > 1:
        raise ValueError(f"every host process must run the same number of local ranks; the processes run {counts}")


def spawn_ranks(fn, mesh, args: tuple = (), hosts: Hosts | None = None) -> list:
    """Run ``fn(rank, world, device, *args)`` in one spawned process per entry of ``mesh`` (a device list), all
    in the default process group → the list of their return values, in rank order (pickled back).

    With ``hosts`` the entries are this host process's, its ranks join every other host process's through the
    coordinator's store, ``rank`` and ``world`` are global, and the list holds this process's ranks' values.
    ``fn`` must be a module-level function of a module that imports no JAX.
    """
    backend = backend_of(mesh)
    if backend == "nccl" and not dist.is_nccl_available():
        raise RuntimeError(NO_NCCL)
    prefix = ""
    if hosts is not None:
        prefix = f"goalnet/run{next(_RUNS)}/"
        _check_local_counts(hosts, prefix, len(mesh))
        hosts = hosts._replace(store=None)   # a rank opens its own connection
    run_dir = tempfile.mkdtemp(prefix="goalnet-ranks-")
    try:
        torch.multiprocessing.start_processes(_rank_entry,
                                              args=(fn, list(mesh), run_dir, backend, args, hosts, prefix),
                                              nprocs=len(mesh), join=True, start_method="spawn")
        out = []
        for rank in range(len(mesh)):
            with open(os.path.join(run_dir, f"rank{rank}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)
