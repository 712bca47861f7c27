"""Multi-host data-parallel training with the PyTorch port: one process per host.

The port's counterpart of ``examples/multihost_train.py``.  Each host process
spawns one rank per local card; the ranks of every process form one
``torch.distributed`` group (NCCL on the cards, gloo on the CPU) joined
through a TCPStore that process 0 serves at the coordinator.  Launch one copy
per host:

    # every card of each host (one command per host):
    GOALNET_COORDINATOR=host0:12321 GOALNET_NUM_PROCESSES=2 GOALNET_PROCESS_ID=0 \
        python examples/multihost_train_torch.py
    GOALNET_COORDINATOR=host0:12321 GOALNET_NUM_PROCESSES=2 GOALNET_PROCESS_ID=1 \
        python examples/multihost_train_torch.py

    # a simulated 2-process cluster on one machine's CPU, two gloo ranks each:
    GOALNET_PLATFORM=cpu GOALNET_COORDINATOR=127.0.0.1:12321 GOALNET_NUM_PROCESSES=2 \
        GOALNET_PROCESS_ID=0 python examples/multihost_train_torch.py --local-devices 2 &
    GOALNET_PLATFORM=cpu GOALNET_COORDINATOR=127.0.0.1:12321 GOALNET_NUM_PROCESSES=2 \
        GOALNET_PROCESS_ID=1 python examples/multihost_train_torch.py --local-devices 2 &
    wait

Each process:

1. joins the other host processes (``parallel/multihost.initialize_from_env``);
2. lays every rank of every process on one global data axis
   (``global_data_mesh``);
3. makes only ITS slice of each global batch; each of its ranks takes its
   block of that slice (``shard_host_batch``), so no process ever holds the
   whole batch;
4. runs three steps of the same ``make_dp_train_step`` that ``train --dp``
   runs, on the tiny config and seeds of the JAX example.  With
   ``--multislice`` the ranks form a (slice, data, model) grid, one slice a
   host, and the gradients sum inside each host before across hosts
   (``parallel/multislice.py``).
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np  # noqa: E402

from cvml_goalnet_tpu_torch.config import (  # noqa: E402
    AudioConfig, MeshConfig, ModelConfig, PipelineConfig, PreprocessConfig)
from cvml_goalnet_tpu_torch.parallel.multihost import (  # noqa: E402
    global_data_mesh,
    initialize_from_env,
    process_count,
    process_index,
    replicated_to_host,
    run_ranks,
    shard_host_batch,
    shutdown,
)

STEPS = 3


def tiny_config(n_ranks: int) -> PipelineConfig:
    """The JAX example's tiny full-architecture config over ``n_ranks`` data ranks."""
    return PipelineConfig(
        preprocess=PreprocessConfig(frame_size=(24, 24)),
        audio=AudioConfig(n_fft=512, hop_length=128, n_mels=40, n_mfcc=13, bin_length=12),
        model=ModelConfig(vis_channels=(8, 16, 16), vis_feature_dim=32, aud_channels=(8, 16), aud_feature_dim=16,
                          fusion_hidden=(32, 16)),
        mesh=MeshConfig(data=n_ranks, model=1),
    )


def make_job(mesh, steps: int = STEPS, multislice: bool = False, seed: int = 0) -> dict:
    """What every local rank of this process is handed: the config, the mesh, the grid with ``multislice``,
    and this process's rows of each step's global batch (4 rows a rank), made from one seed on every
    process."""
    from cvml_goalnet_tpu_torch.parallel.multislice import build_multislice_mesh

    cfg = tiny_config(mesh.size)
    rng = np.random.default_rng(seed)
    b = 4 * mesh.size
    lo, hi = mesh.process_index * b // mesh.process_count, (mesh.process_index + 1) * b // mesh.process_count
    batches = []
    for _ in range(steps):
        vis = rng.random((b, *cfg.preprocess.frame_size, 3)).astype(np.float32)
        aud = rng.random((b, cfg.audio.bin_length, cfg.audio.n_mfcc)).astype(np.float32)
        lab = rng.integers(1, 6, b).astype(np.float32)
        batches.append((vis[lo:hi], aud[lo:hi], lab[lo:hi]))
    slices = build_multislice_mesh(devices=mesh.devices) if multislice else None
    return {"cfg": cfg, "mesh": mesh, "slices": slices, "batches": batches, "seed": seed}


def rank_steps(rank: int, world: int, device, job: dict) -> list[float]:
    """One rank's steps: the seeded state, its block of each global batch, ``make_dp_train_step`` over the
    world (or the grid's data, then slice, groups) → the global loss of each step."""
    from cvml_goalnet_tpu_torch.parallel.dp import make_dp_train_step, rank_generator
    from cvml_goalnet_tpu_torch.parallel.multislice import data_parallel_groups
    from cvml_goalnet_tpu_torch.train.state import create_train_state

    cfg, mesh = job["cfg"], job["mesh"]
    groups, block = data_parallel_groups(job["slices"]) if job["slices"] is not None else (None, rank)
    state = create_train_state(job["seed"], cfg, device=device)
    params, model_state, opt_state = state.params, state.model_state, state.opt_state
    step = make_dp_train_step(cfg, group=groups)
    losses = []
    for it, rows in enumerate(job["batches"]):
        vis, aud, lab = (shard_host_batch(x, mesh)[0] for x in rows)
        params, model_state, opt_state, loss = step(params, model_state, opt_state, vis, aud, lab,
                                                    rank_generator(job["seed"] + it, block, device))
        losses.append(float(replicated_to_host(loss)))
    return losses


def run(mesh, steps: int = STEPS, multislice: bool = False, seed: int = 0) -> list[float]:
    """The steps on every local rank of ``mesh``, in one group with every other host process's ranks → the
    global loss of each step (every rank reports the same)."""
    losses = run_ranks(rank_steps, mesh, (make_job(mesh, steps, multislice, seed),))
    if any(got != losses[0] for got in losses):
        raise RuntimeError(f"the local ranks report different losses: {losses}")
    return losses[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--local-devices", type=int, default=None,
                    help="ranks of this process: the first N cards (default every visible card; one CPU rank "
                         "under GOALNET_PLATFORM=cpu)")
    ap.add_argument("--multislice", action="store_true",
                    help="a (slice, data, model) grid, one slice a host: gradients sum over data, then slice")
    args = ap.parse_args()
    initialize_from_env()
    device = "cpu" if os.environ.get("GOALNET_PLATFORM", "").lower() == "cpu" else None
    mesh = global_data_mesh(local=args.local_devices, device=device)
    pid = process_index()
    print(f"process {pid}/{process_count()}: {len(mesh.local)} local / {mesh.size} global ranks", flush=True)
    for it, loss in enumerate(run(mesh, multislice=args.multislice)):
        print(f"process {pid}: step {it} loss {loss:.6f}", flush=True)
    print(f"process {pid}: done", flush=True)
    shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
