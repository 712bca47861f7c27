#!/usr/bin/env python3
"""Context-parallel spotting training over every visible card, against one card, at tpu_spotting width.

    python3 tools/cp_four_cards.py [--seed 0]

Needs CUDA cards (it is meant for a machine with four, all to all over
NVLink); run it from the repository root.  It builds the kernels, writes two
``--no-audio`` videos at ``skip_frames = 1`` from ``chip_smoke.py``'s
5400-frame match (all 5400 frames, and the first 4400: a group of the two is
padded) with seeded ``.events.json`` sidecars, and runs ``spot-train`` of
``configs/tpu_spotting.json`` through ``cli.main`` over every card, one
spawned NCCL rank each:

* ``--cp`` banded (W = 1024) and full (``--attn-window 0``): the ring or the
  halo over every card;
* ``--cp --dp-timelines 2``: two timelines over the data axis, the rest of
  the cards on the ctx axis;
* ``--cp --tp 2 --heads 2``: the heads split over a model axis of two.

Each rank keeps its step losses and rank 0 its first step's gradients
(``step.value_and_grad`` once more before the first step).  Each layout is
held against the same step on one card (a one-rank NCCL group in this
process, from the same head and the same timelines or groups): the first
step's gradients within 1e-4·max|g| and its loss within 1e-4 relative.  It
prints each verb's wall (and the banded ``--cp`` verb's on one card), one
JSON line, the card's name and power limit, and as its last line ``{"ok":
true, "cards": N}``; any failed check raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as C  # noqa: E402
from cvml_goalnet_tpu_torch import cli, runtime  # noqa: E402
from cvml_goalnet_tpu_torch.ops.cuda import _build  # noqa: E402

RECORD_ENV = "GOALNET_CP_FOUR_CARDS_DIR"   # where the ranks write their step losses and rank 0 its gradients
SECOND_FRAMES = 4400   # a shard of the four-card ring (1,100 frames) must hold the 1,024-frame halo
EPOCHS = 2


def recorded_rank(rank: int, world: int, device, job: dict):
    """``train/cp_loop.py``'s rank function with its step wrapped: every step's loss kept, and the first batch's
    gradients once more before the first step (written by rank 0)."""
    from cvml_goalnet_tpu_torch.train import cp_loop
    from cvml_goalnet_tpu_torch.train.optim import tree_leaves

    out_dir, losses, real = os.environ[RECORD_ENV], [], cp_loop._step_of

    def step_of(groups, layout):
        step = real(groups, layout)

        def run(params, opt, f, lab):
            if not losses:
                _, grads = step.value_and_grad(params, f, lab)
                if rank == 0:
                    np.savez(os.path.join(out_dir, "grads.npz"), *[g.cpu().numpy() for g in tree_leaves(grads)])
            res = step(params, opt, f, lab)
            losses.append(float(res[2]))
            return res

        return run

    cp_loop._step_of = step_of
    t0 = time.perf_counter()
    res = cp_loop._cp_rank(rank, world, device, job)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump({"rank": rank, "wall_s": time.perf_counter() - t0, "step_losses": losses}, f)
    return res


def one_card_reference(job: dict, ntp: int) -> tuple[float, list]:
    """The first step of the verb's layout on one card: a one-rank NCCL group in this process, the same head and
    the same first timeline (or group) → (loss, gradient leaves)."""
    import torch.distributed as dist

    from cvml_goalnet_tpu_torch.parallel.mesh import cp_groups
    from cvml_goalnet_tpu_torch.train import spotting as TS
    from cvml_goalnet_tpu_torch.train.optim import tree_leaves, tree_map

    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1), rank=0, world_size=1,
                                device_id=torch.device("cuda", 0))
        try:
            groups = cp_groups(1, 1, 1)
            layout = job["layout"]
            kw = {"num_heads": layout["num_heads"], "lr": layout["lr"], "pos_weight": layout["pos_weight"],
                  "window": layout["window"]}
            make = (TS.make_3d_spotting_train_step if ntp > 1 else
                    TS.make_dp_cp_spotting_train_step if layout["batched"] else TS.make_sharded_spotting_train_step)
            step = make(groups, **kw)
            params = tree_map(lambda a: torch.as_tensor(a).cuda(), job["tparams"])
            f, lab = (torch.as_tensor(x).cuda() for x in job["batches"][0])
            loss, grads = step.value_and_grad(params, f, lab)
            return float(loss), [g.cpu().numpy() for g in tree_leaves(grads)]
        finally:
            dist.destroy_process_group()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("cp_four_cards: no CUDA device", file=sys.stderr)
        return 1
    from cvml_goalnet_tpu_torch.parallel import mesh as mesh_module
    from cvml_goalnet_tpu_torch.train import cp_loop
    from cvml_goalnet_tpu_torch.train.optim import tree_map

    t_start = time.perf_counter()
    smi = C.nvidia_smi_line()
    cards = torch.cuda.device_count()
    print(f"cards: {cards} x {torch.cuda.get_device_name(0)} ({smi}); torch {torch.__version__}", flush=True)
    t0 = time.perf_counter()
    _build.build()
    runtime.load()
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    base = C.PipelineConfig.load(str(C.REPO / "configs" / "tpu_spotting.json"))
    cfg = dataclasses.replace(base, preprocess=dataclasses.replace(base.preprocess, skip_frames=1),
                              model=dataclasses.replace(base.model, audio_included=False))
    match = C.make_match(base, args.seed)
    layouts = {"cp_banded": ["--cp"], "cp_full": ["--cp", "--attn-window", "0"],
               "dp_cp": ["--cp", "--dp-timelines", "2"], "tp_cp": ["--cp", "--tp", "2", "--heads", "2"]}
    out = {"cards": cards, "layouts": {}}
    with tempfile.TemporaryDirectory() as root:
        cfg_path = os.path.join(root, "cfg.json")
        cfg.save(cfg_path)
        videos = []
        for i, n in enumerate((C.MATCH_FRAMES, SECOND_FRAMES)):
            fp = os.path.join(root, f"m{i}.npz")
            np.savez(fp, frames=match["frames"][:n])
            C.write_events(fp, n, 1, args.seed + 2200 + i)
            videos.append(fp)
        real_rank, real_train, real_world = cp_loop._cp_rank, cp_loop.train_spotting_cp, mesh_module.cp_world
        for name, flags in [*layouts.items(), ("cp_banded_one_card", ["--cp"])]:
            rec_dir = os.path.join(root, name)
            os.makedirs(rec_dir)
            os.environ[RECORD_ENV] = rec_dir
            jobs = []

            def capture(cfg_, pairs, val_pairs, tparams, mesh, **kw):
                jobs.append({"tparams": tparams, "pairs": pairs, "kw": kw})
                return real_train(cfg_, pairs, val_pairs, tparams, mesh, **kw)

            cp_loop._cp_rank, cp_loop.train_spotting_cp = recorded_rank, capture
            if name.endswith("one_card"):
                mesh_module.cp_world = lambda device=None, cpu_ranks=1: [torch.device("cuda", 0)]
            argv = ["spot-train", "--videos", *videos, "--config", cfg_path, "--workdir", os.path.join(root, "w"),
                    "--no-audio", "--epochs", str(EPOCHS), "--out", os.path.join(rec_dir, "head.npz"), *flags]
            t0 = time.perf_counter()
            try:
                with C.fd_stdout(os.path.join(rec_dir, "stdout.txt")):
                    rc = cli.main(argv)
            finally:
                cp_loop._cp_rank, cp_loop.train_spotting_cp, mesh_module.cp_world = real_rank, real_train, real_world
            wall = time.perf_counter() - t0
            with open(os.path.join(rec_dir, "stdout.txt")) as f:
                text = f.read()
            print(text, end="", flush=True)
            C.require(rc == 0 and "Operation completed" in text, f"{name}: exit code {rc}")
            ranks = [json.load(open(os.path.join(rec_dir, f"rank{r}.json")))
                     for r in range(1 if name.endswith("one_card") else cards)]
            C.require(all(r["step_losses"] == ranks[0]["step_losses"] for r in ranks),
                      f"{name}: the ranks' step losses differ")
            rec = {"verb_s": wall, "rank_walls_s": [r["wall_s"] for r in ranks], "step_losses": ranks[0]["step_losses"]}
            if not name.endswith("one_card"):
                kw = jobs[0]["kw"]
                ndp, ntp = kw["ndp"], kw["ntp"]
                batched = ndp > 1 or ntp > 1
                mc = cfg.model
                window = 0 if "--attn-window" in flags else mc.temporal_window
                heads = 2 if "--heads" in flags else mc.temporal_num_heads
                job = {"tparams": tree_map(lambda t: t.detach().cpu().numpy(), jobs[0]["tparams"]),
                       "batches": (cp_loop.group_timelines(jobs[0]["pairs"], ndp) if batched else
                                   [(f.cpu().numpy(), lab.cpu().numpy()) for _, f, lab in jobs[0]["pairs"]]),
                       "layout": {"num_heads": heads, "lr": kw["lr"], "pos_weight": kw["pos_weight"],
                                  "window": window, "batched": batched}}
                loss, grads = one_card_reference(job, ntp)
                with np.load(os.path.join(rec_dir, "grads.npz")) as f:
                    got = [f[f"arr_{i}"] for i in range(len(f.files))]
                gmax = max(float(np.abs(g).max()) for g in grads)
                gerr = max(float(np.abs(a - b).max()) for a, b in zip(got, grads)) / gmax
                lerr = abs(rec["step_losses"][0] - loss) / abs(loss)
                C.require(gerr <= 1e-4 and lerr <= 1e-4,
                          f"{name}: first step vs one card: gradients {gerr:.3g} of max|g|, loss {lerr:.3g} relative")
                rec.update({"grid": [ndp, ntp, cards // (ndp * ntp)], "one_card_first_loss": loss,
                            "first_loss_rel_err": lerr, "first_grads_err_over_max": gerr})
            out["layouts"][name] = rec
            print(f"{name} on {cards} card(s) ({smi}): {json.dumps(rec)}", flush=True)
    out["total_s"] = time.perf_counter() - t_start
    print(json.dumps(out))
    print(smi)
    print(json.dumps({"ok": True, "cards": cards}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
