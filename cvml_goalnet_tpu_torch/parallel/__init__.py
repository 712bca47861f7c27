"""Data and context parallelism over the cards of one machine.

Port of what ``serve --dp``, ``train --dp`` and ``spot-train --cp`` need of
``cvml_goalnet_tpu/parallel/``: device meshes as device lists and the
(data, model, ctx) rank grid of the context-parallel steps (``mesh.py``),
the data-parallel eval fuse and trunk encode (``serving.py``), one spawned
rank per device in one process group (``launch.py``), the collectives
(``collectives.py``: sums over a group, the ring shift, Megatron's pair),
the two data-parallel train steps (``dp.py``), and ring and halo attention
(``ring_attention.py``, ``halo_attention.py``).  Pipeline, expert and the
fusion MLP's tensor parallelism are not ported yet (ROADMAP.md §1 items
6.4–6.6).
"""
