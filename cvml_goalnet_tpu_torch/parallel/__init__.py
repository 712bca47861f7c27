"""Data parallelism over the cards of one machine.

Port of what ``serve --dp`` and ``train --dp`` need of
``cvml_goalnet_tpu/parallel/``: device meshes as device lists
(``mesh.py``), the data-parallel eval fuse and trunk encode (``serving.py``),
one spawned rank per device in one process group (``launch.py``), the
collectives of the data group (``collectives.py``) and the two
data-parallel train steps (``dp.py``).  Context, pipeline, expert and tensor
parallelism are not ported yet (ROADMAP.md §1 items 6.3–6.6).
"""
