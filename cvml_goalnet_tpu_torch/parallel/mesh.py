"""Device meshes of the port: an ordered list of the devices that split a batch.

Port of what the data-parallel paths need of ``cvml_goalnet_tpu/parallel/mesh.py``
and ``parallel/serving.py:30``.  A JAX mesh is a grid of devices with named
axes; the port's data axis is a plain list of ``torch.device``s, entry i
holding the i-th contiguous block of a batch: ``cuda:0 … cuda:n-1`` on the
cards.  On the CPU (``device="cpu"``) a mesh of n entries repeats the one CPU
device n times, so the padding, splitting and gathering run as on n cards.
The model axis (the fusion MLP's Megatron layout, ``parallel/sharding.py:31``)
is not ported: a mesh with ``model > 1`` raises.
"""

from __future__ import annotations

import torch

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
