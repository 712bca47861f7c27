"""Data, tensor, context, pipeline and expert parallelism over the cards of one machine or of many hosts.

Port of ``cvml_goalnet_tpu/parallel/``: device meshes as device lists and the
rank grids of the parallel steps (``mesh.py``), the layouts of the fusion MLP
and the transformer over a model axis (``sharding.py``), the data-parallel
eval fuse and trunk encode (``serving.py``), one spawned rank per device in
one process group (``launch.py``), the collectives (``collectives.py``: sums
over a group, the ring shift, Megatron's pairs, the lock-step axis views),
the data-parallel train steps with the fusion MLP optionally tensor parallel
(``dp.py``), ring and halo attention (``ring_attention.py``,
``halo_attention.py``), the GPipe pipeline of the temporal transformer
(``pp.py``), expert-parallel MoE (``ep.py``), one process per host with the
local cards of every host as ranks of one group (``multihost.py``) and the
(slice, data, model) grid whose gradients sum inside a host before across
hosts (``multislice.py``).

Every name of the JAX package's ``__all__`` is exported here, with
multihost's and multislice's public functions and JAX's remaining
collectives, imported at first use (the submodules import one another's
packages).
"""

from __future__ import annotations

import importlib

_EXPORTS = {
    "build_mesh": "mesh",
    "cpu_mesh": "mesh",
    "mesh_axis_sizes": "mesh",
    "batch_sharding": "sharding",
    "fusion_param_shardings": "sharding",
    "replicated": "sharding",
    "shard_batch": "sharding",
    "all_gather": "collectives",
    "axis_index": "collectives",
    "barrier": "collectives",
    "pmean": "collectives",
    "ppermute_ring": "collectives",
    "psum": "collectives",
    "reduce_scatter": "collectives",
    "make_dp_train_step": "dp",
    "moe_apply_expert_parallel": "ep",
    "make_pp_spotting_train_step": "pp",
    "pipeline_transformer_apply": "pp",
    "initialize_from_env": "multihost",
    "global_data_mesh": "multihost",
    "shard_host_batch": "multihost",
    "replicated_to_host": "multihost",
    "process_count": "multihost",
    "process_index": "multihost",
    "run_ranks": "multihost",
    "shutdown": "multihost",
    "build_multislice_mesh": "multislice",
    "grad_reduce_axes": "multislice",
    "data_parallel_groups": "multislice",
}

__all__ = list(_EXPORTS)


def __getattr__(name: str):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"), name)
