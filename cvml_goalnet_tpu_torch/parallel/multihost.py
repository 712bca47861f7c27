"""Multi-host training: one process per host, the local cards of every host as ranks of one global group.

Port of ``cvml_goalnet_tpu/parallel/multihost.py``.  JAX runs one process per
host, which drives that host's chips; the port also runs one process per host,
and that process spawns one rank per local device (``parallel/launch.py``).
Process p with L local devices runs global ranks p·L … p·L + L − 1,
process-major, which is the order of ``jax.devices()``, so a global batch's
rows land on the ranks in JAX's order.  The ranks of every process form one
``torch.distributed`` group (NCCL on the cards, gloo on the CPU, no fallback
between them), joined through a ``TCPStore`` that process 0 serves at the
coordinator.

* :func:`initialize_from_env` — this process's place among the host
  processes, from explicit arguments or ``GOALNET_COORDINATOR`` /
  ``GOALNET_NUM_PROCESSES`` / ``GOALNET_PROCESS_ID``; with none given it
  takes JAX's fallback (a GPU host has no counterpart of a TPU pod's
  metadata to detect peers from);
* :func:`global_data_mesh` — one data axis over every rank of every process;
* :func:`shard_host_batch` — a process's rows of a global batch cut into its
  local ranks' contiguous blocks, each on its rank's device;
* :func:`run_ranks` — a function on every local rank, in the global group;
* :func:`replicated_to_host`, :func:`process_count`, :func:`process_index` —
  of hosts, not ranks;
* :func:`shutdown` — the host processes leave the store (JAX's
  ``jax.distributed.shutdown``).

The parallel steps (``parallel/dp.py``) run unchanged over the global group:
a rank sees a world of P·L ranks whether they live in one process's children
or in many hosts'.  ``examples/multihost_train_torch.py`` is the per-process
entry point.
"""

from __future__ import annotations

import datetime
import os
import time
import warnings
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from cvml_goalnet_tpu_torch.parallel.launch import Hosts, spawn_ranks
from cvml_goalnet_tpu_torch.parallel.mesh import serving_mesh

_HOSTS: Hosts | None = None   # set by initialize_from_env, with this process's connection to the store


def _env_int(name: str) -> int | None:
    return int(os.environ[name]) if name in os.environ else None


def initialize_from_env(coordinator: str | None = None, num_processes: int | None = None,
                        process_id: int | None = None, timeout: float = 300.0) -> None:
    """Join the host processes at ``coordinator`` (``"host:port"``) as ``process_id`` of ``num_processes``, or
    from ``GOALNET_COORDINATOR`` / ``GOALNET_NUM_PROCESSES`` / ``GOALNET_PROCESS_ID``.

    Process 0 serves the ``TCPStore`` at the coordinator; every process waits there for all of them, up to
    ``timeout`` seconds, and raises when it cannot reach the coordinator.  With nothing given it warns and
    runs single-process, unless the environment names a multi-worker cluster (``MEGASCALE_*``, a
    ``TPU_WORKER_HOSTNAMES`` list), where it refuses.  Call once per process; a second call is a no-op.
    """
    global _HOSTS
    if _HOSTS is not None:
        return
    coordinator = coordinator or os.environ.get("GOALNET_COORDINATOR")
    num_processes = num_processes if num_processes is not None else _env_int("GOALNET_NUM_PROCESSES")
    process_id = process_id if process_id is not None else _env_int("GOALNET_PROCESS_ID")
    if coordinator is None and num_processes is None and process_id is None:
        hints = [k for k in ("MEGASCALE_COORDINATOR_ADDRESS", "MEGASCALE_NUM_SLICES") if os.environ.get(k)]
        if "," in os.environ.get("TPU_WORKER_HOSTNAMES", ""):   # one hostname is not a cluster
            hints.append("TPU_WORKER_HOSTNAMES")
        if hints:
            raise RuntimeError(
                f"no GOALNET_* distributed config, but cluster env hints are present ({hints}) — refusing to "
                "silently fall back to single-process mode on what looks like a multi-host job; set "
                "GOALNET_COORDINATOR/GOALNET_NUM_PROCESSES/GOALNET_PROCESS_ID explicitly")
        warnings.warn("no distributed config detected (no GOALNET_* env; a GPU host has no peer "
                      "auto-detection) — running single-process", stacklevel=2)
        return
    if coordinator is None or num_processes is None or process_id is None:
        raise ValueError("a multi-host run needs all three of coordinator, num_processes and process_id "
                         "(GOALNET_COORDINATOR, GOALNET_NUM_PROCESSES, GOALNET_PROCESS_ID); got "
                         f"{coordinator!r}, {num_processes!r}, {process_id!r}")
    if num_processes < 1 or not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} is not one of {num_processes} processes")
    host, _, port = coordinator.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"coordinator {coordinator!r} is not host:port")
    try:
        store = dist.TCPStore(host, int(port), world_size=num_processes, is_master=process_id == 0,
                              timeout=datetime.timedelta(seconds=timeout), wait_for_workers=True)
    except (RuntimeError, OSError) as e:   # DistNetworkError and DistStoreError are RuntimeErrors
        raise RuntimeError(f"process {process_id} of {num_processes} could not join the coordinator at "
                           f"{coordinator} within {timeout} s: {e}") from e
    _HOSTS = Hosts(host, int(port), num_processes, process_id, store)


def shutdown(timeout: float = 300.0) -> None:
    """Leave the host processes: each tells process 0, which serves the store until every other has left.  A
    no-op without :func:`initialize_from_env`'s multi-host config."""
    global _HOSTS
    hosts, _HOSTS = _HOSTS, None
    if hosts is None:
        return
    if hosts.index != 0:
        hosts.store.add("goalnet/left", 1)
        return
    deadline = time.monotonic() + timeout
    while hosts.store.add("goalnet/left", 0) < hosts.count - 1:
        if time.monotonic() > deadline:
            raise RuntimeError(f"shutdown: not every host process left within {timeout} s")
        time.sleep(0.01)


def process_count() -> int:
    """Host processes (1 without a multi-host config)."""
    return _HOSTS.count if _HOSTS is not None else 1


def process_index() -> int:
    """This host process's index (0 without a multi-host config)."""
    return _HOSTS.index if _HOSTS is not None else 0


class GlobalMesh(NamedTuple):
    """One 1-D ``axis`` over every rank of every host process: ``local`` is this process's devices, its ranks
    ``process_index·L + i`` in order (L = ``len(local)``, the same on every process)."""
    axis: str
    local: tuple
    process_index: int
    process_count: int

    @property
    def size(self) -> int:
        return self.process_count * len(self.local)

    @property
    def devices(self) -> list:
        """Every rank's device in rank order (another host's entries name that host's devices)."""
        return list(self.local) * self.process_count


def global_data_mesh(axis: str = "data", local=None, device=None) -> GlobalMesh:
    """The global data axis: this process's ``local`` devices (every visible card for ``None``, the first n
    for an int, or a list of devices; ``device="cpu"``: that many CPU entries, one for ``None``) after every
    other process's, in process order."""
    devices = list(local) if isinstance(local, (list, tuple)) else serving_mesh(local, device)
    return GlobalMesh(axis, tuple(devices), process_index(), process_count())


def _held(mesh: GlobalMesh) -> list[int]:
    """The local ranks whose blocks the caller holds: its own inside a rank of ``mesh``, else all of them."""
    if not (dist.is_initialized() and dist.get_world_size() == mesh.size):
        return list(range(len(mesh.local)))
    local = dist.get_rank() - mesh.process_index * len(mesh.local)
    if not 0 <= local < len(mesh.local):
        raise ValueError(f"rank {dist.get_rank()} is not one of process {mesh.process_index}'s ranks")
    return [local]


def shard_host_batch(x_local, mesh: GlobalMesh, axis: str = "data") -> list[torch.Tensor]:
    """This process's rows of a global batch (the same shape on every process; rows p·B … (p + 1)·B − 1 of
    the global batch on process p) → the contiguous blocks of the local ranks the caller holds, each on its
    rank's device: a rank of ``mesh`` gets a list of its own block, the host process every local rank's.  No
    process ever holds the global batch."""
    if axis != mesh.axis:
        raise ValueError(f"the mesh's axis is {mesh.axis!r}, not {axis!r}")
    n_local = len(mesh.local)
    if x_local.shape[0] % n_local:
        raise ValueError(f"{x_local.shape[0]} rows do not split over {n_local} local ranks")
    b = x_local.shape[0] // n_local
    return [torch.as_tensor(np.asarray(x_local[i * b:(i + 1) * b])).to(mesh.local[i]) for i in _held(mesh)]


def replicated_to_host(x) -> np.ndarray:
    """The value of a replicated result (a loss, a metric) on this host: a tensor, or a list of the held
    ranks' equal copies, as a numpy array."""
    if isinstance(x, (list, tuple)):
        x = x[0]
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
    return np.asarray(x)


def run_ranks(fn, mesh: GlobalMesh, args: tuple = ()) -> list:
    """``fn(rank, world, device, *args)`` on every local rank of ``mesh``, in one group with every other
    process's ranks (``rank`` and ``world`` global) → this process's ranks' return values, in local order.
    Every host process calls it the same number of times, in the same order."""
    return spawn_ranks(fn, list(mesh.local), args, hosts=_HOSTS)
