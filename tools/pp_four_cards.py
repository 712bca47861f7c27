#!/usr/bin/env python3
"""Pipeline, tensor and expert parallelism over four cards, against one card.

    python3 tools/pp_four_cards.py [--seed 0]

Needs four CUDA cards (all to all over NVLink); run it from the repository
root.  It builds the kernels and runs, one spawned NCCL rank a card:

* ``spot-train --pp 2`` and ``--pp 4`` through ``cli.main`` on two
  ``--no-audio`` videos at ``skip_frames = 1`` made from ``chip_smoke.py``'s
  5400-frame match (the match, and the match rolled by a third), with
  seeded ``.events.json`` sidecars, at ``configs/tpu_spotting.json``'s width
  (for ``--pp 4`` a copy with ``temporal_num_layers = 4``); each rank keeps
  its step losses and rank 0 the first step's gradients (the stages
  gathered);
* DP×PP on a 2 × 2 ``(data, pipe)`` grid: ``make_pp_spotting_train_step``
  with a data axis on four seeded 5400-frame timelines in two
  microbatches;
* ``train_data_parallel(tensor_parallel=True)`` on a 2 × 2 ``(data,
  model)`` grid at ``configs/reference_parity.json``'s width with dropout 0,
  one epoch over two seeded 256-frame videos in global batches of 64;
* the ``--moe-experts 4`` layer over 4 expert shards
  (``parallel/ep.py``) on 1050 seeded rows.

Each is held against the same work on one card (the monolithic scorer's
batch loss, the one-rank ``train_data_parallel``, the whole MoE layer): the
first step's gradients within 1e-4·max|g| and its loss within 1e-4
relative (the MoE layer's output within 1e-5·max(1, max|y|)).  It prints
each run's wall beside the one-card run's, one JSON line, the card's name
and power limit, and as its last line ``{"ok": true, "cards": N}``; any
failed check raises.
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
from cvml_goalnet_tpu_torch import cli, runtime, weights  # noqa: E402
from cvml_goalnet_tpu_torch.ops.cuda import _build  # noqa: E402

RECORD_ENV = "GOALNET_PP_FOUR_CARDS_DIR"   # where the ranks write their step losses and rank 0 its gradients
EPOCHS = 2
DPPP_TIMELINES = 4
DP_VIDEO_FRAMES = 256
DP_GLOBAL_BATCH = 64
EP_ROWS = 1050


def _save_grads(path: str, grads) -> None:
    from cvml_goalnet_tpu_torch.train.optim import tree_leaves

    np.savez(path, *[g.detach().cpu().numpy() for g in tree_leaves(grads)])


def _load_grads(path: str) -> list:
    with np.load(path) as f:
        return [f[f"arr_{i}"] for i in range(len(f.files))]


def _record(rank: int, out_dir: str, t0: float, losses: list) -> None:
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump({"rank": rank, "wall_s": time.perf_counter() - t0, "step_losses": losses}, f)


def recorded_pp_rank(rank: int, world: int, device, job: dict):
    """``train/cp_loop.py``'s rank function with its step wrapped: every step's loss kept, and before the first
    step its gradients once more, the stages gathered (a collective), written by rank 0."""
    from cvml_goalnet_tpu_torch.parallel.pp import gather_stages
    from cvml_goalnet_tpu_torch.train import cp_loop

    out_dir, losses, real = os.environ[RECORD_ENV], [], cp_loop._step_of

    def step_of(groups, layout):
        step = real(groups, layout)

        def run(params, opt, f, lab):
            if not losses:
                _, grads = step.value_and_grad(params, f, lab)
                whole = gather_stages([grads], groups["pipe"])
                if rank == 0:
                    _save_grads(os.path.join(out_dir, "grads.npz"), whole)
            res = step(params, opt, f, lab)
            losses.append(float(res[2]))
            return res

        return run

    cp_loop._step_of = step_of
    t0 = time.perf_counter()
    res = cp_loop._cp_rank(rank, world, device, job)
    _record(rank, out_dir, t0, losses)
    return res


def recorded_dp_rank(rank: int, world: int, device, job: dict):
    """``train/dp_loop.py``'s rank function with its step wrapped: every step's loss kept, and before the first
    step its gradients once more, the model ranks' slices gathered (a collective), written by rank 0."""
    from cvml_goalnet_tpu_torch.parallel import dp
    from cvml_goalnet_tpu_torch.parallel.sharding import fusion_param_shardings, gather_model_shards
    from cvml_goalnet_tpu_torch.train import dp_loop

    out_dir, losses, make = os.environ[RECORD_ENV], [], dp.make_dp_train_step

    def recording(*a, **kw):
        step, model = make(*a, **kw), kw.get("model")

        def run(*args, **kws):
            if not losses:
                params, model_state, _, vis, aud, lab, gen = args[:7]
                _, _, grads = step.loss_and_grads(params, model_state, vis, aud, lab, gen, kws.get("text"))
                if model is not None:
                    grads = gather_model_shards(grads, fusion_param_shardings(grads), model)
                if rank == 0:
                    _save_grads(os.path.join(out_dir, "grads.npz"), grads)
            res = step(*args, **kws)
            losses.append(float(res[3]))
            return res

        return run

    dp.make_dp_train_step = recording
    t0 = time.perf_counter()
    res = dp_loop._train_rank(rank, world, device, job)
    _record(rank, out_dir, t0, losses)
    return res


def _dppp_inputs(seed: int, device, d_in: int):
    gen = torch.Generator(device=device).manual_seed(seed)
    feats = torch.randn((DPPP_TIMELINES, C.MATCH_FRAMES, d_in), generator=gen, device=device)
    labels = (torch.rand((DPPP_TIMELINES, C.MATCH_FRAMES), generator=gen, device=device) < 0.02).float()
    return feats, labels


def dppp_rank(rank: int, world: int, device, job: dict):
    """The DP×PP step on a 2 × 2 (data, pipe) grid: rank 0's first loss and gathered gradients, and every
    rank's wall for ``EPOCHS`` steps."""
    from cvml_goalnet_tpu_torch.parallel.mesh import grid_groups
    from cvml_goalnet_tpu_torch.parallel.pp import gather_stages, make_pp_spotting_train_step, stage_params
    from cvml_goalnet_tpu_torch.train.optim import adam_init, tree_leaves, tree_map

    grid = grid_groups([("data", 2), ("pipe", world // 2)])
    pipe = grid["pipe"]
    params = stage_params(tree_map(lambda a: torch.as_tensor(a).to(device), job["tparams"]), pipe.index, pipe.size)
    feats, labels = _dppp_inputs(job["seed"], device, job["d_in"])
    step = make_pp_spotting_train_step(pipe, job["heads"], n_micro=2, window=job["window"], data=grid["data"])
    loss, grads = step.value_and_grad(params, feats, labels)
    whole = [g.cpu().numpy() for g in tree_leaves(gather_stages([grads], pipe))]
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    opt = adam_init(params)
    for _ in range(EPOCHS):
        params, opt, _ = step(params, opt, feats, labels)
    torch.cuda.synchronize(device)
    wall = (time.perf_counter() - t0) / EPOCHS
    return {"loss": float(loss), "grads": whole, "step_s": wall} if rank == 0 else None


def ep_rank(rank: int, world: int, device, job: dict):
    """The MoE layer over ``world`` expert shards: rank 0's output and the gradients of Σ y² (each rank's share
    1/world of it, summed over the axis)."""
    from cvml_goalnet_tpu_torch.parallel.collectives import tree_psum
    from cvml_goalnet_tpu_torch.parallel.ep import moe_apply_expert_parallel
    from cvml_goalnet_tpu_torch.parallel.mesh import grid_groups
    from cvml_goalnet_tpu_torch.train.optim import tree_leaves, tree_map, tree_unflatten

    model = grid_groups([("model", world)])["model"]
    moe = tree_map(lambda a: torch.as_tensor(a).to(device), job["moe"])
    x = torch.as_tensor(job["x"]).to(device)
    leaves = [t.requires_grad_() for t in tree_leaves(moe)]
    with torch.enable_grad():
        y = moe_apply_expert_parallel(tree_unflatten(moe, leaves), x, model, job["top_k"])
        grads = torch.autograd.grad((y * y).sum() / world, leaves)
    grads = tree_psum(list(grads), model.group)
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    with torch.no_grad():
        for _ in range(5):
            moe_apply_expert_parallel(moe, x, model, job["top_k"])
    torch.cuda.synchronize(device)
    wall = (time.perf_counter() - t0) / 5
    return {"out": y.detach().cpu().numpy(), "grads": [g.cpu().numpy() for g in grads], "fwd_s": wall} \
        if rank == 0 else None


def _errs(got: list, want: list, loss=None, want_loss=None) -> dict:
    gmax = max(float(np.abs(g).max()) for g in want)
    rec = {"first_grads_err_over_max": max(float(np.abs(a - b).max()) for a, b in zip(got, want)) / gmax}
    if loss is not None:
        rec["first_loss_rel_err"] = abs(loss - want_loss) / abs(want_loss)
    return rec


def _require(rec: dict, what: str) -> None:
    C.require(rec["first_grads_err_over_max"] <= 1e-4 and rec.get("first_loss_rel_err", 0.0) <= 1e-4,
              f"{what} vs one card: {json.dumps(rec)}")


def monolithic_batch_grads(tparams_np, feats, labels, heads: int, window: int, pos_weight: float):
    """The batch's weighted BCE through the single-device scorer on card 0 → (loss, gradient leaves)."""
    from cvml_goalnet_tpu_torch.models.temporal_attention import temporal_transformer_apply
    from cvml_goalnet_tpu_torch.device import strict_f32
    from cvml_goalnet_tpu_torch.train.optim import tree_leaves, tree_unflatten
    from cvml_goalnet_tpu_torch.train.spotting import weighted_bce

    params = weights.tree_from_jax(tparams_np)
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    with torch.enable_grad(), strict_f32():
        p = tree_unflatten(params, leaves)
        logits = torch.stack([temporal_transformer_apply(p, f, heads, window) for f in feats])
        loss = weighted_bce(logits.reshape(labels.shape), labels, pos_weight)
        grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), [g.cpu().numpy() for g in grads]


def spot_train_pp(root: str, cfg, videos: list, npp: int, out: dict) -> None:
    """``spot-train --pp npp`` over the cards against the monolithic batch step on card 0, and the one-card
    ``spot-train`` wall."""
    from cvml_goalnet_tpu_torch.train import cp_loop
    from cvml_goalnet_tpu_torch.train.optim import tree_map

    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, temporal_num_layers=max(2, npp)))
    cfg_path = os.path.join(root, f"cfg_pp{npp}.json")
    cfg.save(cfg_path)
    rec = {}
    for mode in ("pp", "one_card"):
        rec_dir = os.path.join(root, f"pp{npp}_{mode}")
        os.makedirs(rec_dir)
        os.environ[RECORD_ENV] = rec_dir
        jobs, real_rank, real_train = [], cp_loop._cp_rank, cp_loop.train_spotting_cp

        def capture(cfg_, pairs, val_pairs, tparams, mesh, **kw):
            jobs.append({"tparams": tparams, "pairs": pairs, "kw": kw})
            return real_train(cfg_, pairs, val_pairs, tparams, mesh, **kw)

        cp_loop._cp_rank, cp_loop.train_spotting_cp = recorded_pp_rank, capture
        argv = ["spot-train", "--videos", *videos, "--config", cfg_path, "--workdir", os.path.join(root, "w"),
                "--no-audio", "--epochs", str(EPOCHS), "--out", os.path.join(rec_dir, "head.npz")]
        if mode == "pp":
            argv += ["--pp", str(npp)]
        t0 = time.perf_counter()
        try:
            with C.fd_stdout(os.path.join(rec_dir, "stdout.txt")):
                rc = cli.main(argv)
        finally:
            cp_loop._cp_rank, cp_loop.train_spotting_cp = real_rank, real_train
        rec[f"{mode}_verb_s"] = time.perf_counter() - t0
        with open(os.path.join(rec_dir, "stdout.txt")) as f:
            text = f.read()
        print(text, end="", flush=True)
        C.require(rc == 0 and "Operation completed" in text, f"--pp {npp} {mode}: exit code {rc}")
        if mode == "one_card":
            continue
        C.require(f"pipeline-parallel: {npp} stages x 2 microbatches" in text, f"--pp {npp}: the layout line")
        ranks = [json.load(open(os.path.join(rec_dir, f"rank{r}.json"))) for r in range(npp)]
        C.require(all(r["step_losses"] == ranks[0]["step_losses"] for r in ranks), f"--pp {npp}: losses differ")
        job = jobs[0]
        tparams = tree_map(lambda t: t.detach().cpu().numpy(), job["tparams"])
        feats = torch.stack([f for _, f, _ in job["pairs"]]).cuda()
        labels = torch.stack([lab for _, _, lab in job["pairs"]]).cuda()
        loss, grads = monolithic_batch_grads(tparams, feats, labels, cfg.model.temporal_num_heads,
                                             cfg.model.temporal_window, job["kw"]["pos_weight"])
        rec.update(_errs(_load_grads(os.path.join(rec_dir, "grads.npz")), grads, ranks[0]["step_losses"][0], loss))
        rec.update({"step_losses": ranks[0]["step_losses"], "rank_walls_s": [r["wall_s"] for r in ranks]})
        _require(rec, f"--pp {npp}")
    out[f"spot_train_pp{npp}"] = rec
    print(f"spot-train --pp {npp}: {json.dumps(rec)}", flush=True)


def dppp(cfg, seed: int, out: dict) -> None:
    from cvml_goalnet_tpu_torch.parallel.launch import spawn_ranks

    mc = dataclasses.replace(cfg.model, temporal_num_layers=4)
    tparams = weights.init_temporal_params(mc, C.PP_FEATURES, seed=seed + 23)
    job = {"tparams": tparams, "seed": seed + 24, "d_in": C.PP_FEATURES, "heads": mc.temporal_num_heads,
           "window": mc.temporal_window}
    t0 = time.perf_counter()
    got = spawn_ranks(dppp_rank, [torch.device("cuda", i) for i in range(4)], (job,))[0]
    wall = time.perf_counter() - t0
    feats, labels = _dppp_inputs(seed + 24, torch.device("cuda", 0), C.PP_FEATURES)
    t1 = time.perf_counter()
    loss, grads = monolithic_batch_grads(tparams, feats, labels, mc.temporal_num_heads, mc.temporal_window, 10.0)
    torch.cuda.synchronize()
    rec = {"grid": [2, 2], "timelines": DPPP_TIMELINES, "run_s": wall, "pp_step_s": got["step_s"],
           "one_card_loss_and_grads_s": time.perf_counter() - t1, **_errs(got["grads"], grads, got["loss"], loss)}
    _require(rec, "DP×PP")
    out["dppp"] = rec
    print(f"DP×PP 2 × 2: {json.dumps(rec)}", flush=True)


def tp_dp(seed: int, out: dict) -> None:
    from cvml_goalnet_tpu_torch.config import MeshConfig
    from cvml_goalnet_tpu_torch.data.dataset import VideoDataset, VideoItem
    from cvml_goalnet_tpu_torch.train import dp_loop
    from cvml_goalnet_tpu_torch.train.optim import adam_init
    from cvml_goalnet_tpu_torch.train.state import TrainState

    base = C.PipelineConfig.load(str(C.REPO / "configs" / "reference_parity.json"))
    cfg = dataclasses.replace(base, model=dataclasses.replace(base.model, dropout_rate=0.0),
                              train=dataclasses.replace(base.train, eps=1e-4))
    rng = np.random.default_rng(seed + 25)
    items = []
    for i in range(2):
        n = DP_VIDEO_FRAMES
        items.append(VideoItem(video_id=f"v{i}", title=f"v{i}",
                               visual=rng.random((n, *cfg.preprocess.frame_size, 3)).astype(np.float32),
                               audio=rng.random((n, cfg.audio.bin_length, cfg.audio.n_mfcc)).astype(np.float32),
                               labels=rng.integers(1, 6, n).astype(np.float32), gd_summary_masks=None,
                               full_n_frames=n, clip_intervals=np.array([[0, n]])))
    params_np, state_np = weights.init_params(cfg, seed + 26)
    rec, real = {}, dp_loop._train_rank
    with tempfile.TemporaryDirectory() as root:
        for mode, mesh, model in (("tp_2x2", [torch.device("cuda", i) for i in range(4)], 2),
                                  ("one_card", [torch.device("cuda", 0)], 1)):
            rec_dir = os.path.join(root, mode)
            os.makedirs(rec_dir)
            os.environ[RECORD_ENV] = rec_dir
            params, model_state = weights.from_jax(params_np, state_np)
            state = TrainState(params, model_state, adam_init(params), 0)
            dp_loop._train_rank = recorded_dp_rank
            t0 = time.perf_counter()
            try:
                grid = dataclasses.replace(cfg, mesh=MeshConfig(data=len(mesh) // model, model=model))
                _, hist = dp_loop.train_data_parallel(grid, VideoDataset(items), VideoDataset([]), state,
                                                      num_epochs=1, global_batch=DP_GLOBAL_BATCH, mesh=mesh,
                                                      tensor_parallel=model > 1, verbose=False)
            finally:
                dp_loop._train_rank = real
            rec[f"{mode}_run_s"] = time.perf_counter() - t0
            ranks = [json.load(open(os.path.join(rec_dir, f"rank{r}.json"))) for r in range(len(mesh))]
            C.require(all(r["step_losses"] == ranks[0]["step_losses"] for r in ranks), f"{mode}: losses differ")
            rec[mode] = {"train_loss": hist["train_loss"], "step_losses": ranks[0]["step_losses"],
                         "grads": _load_grads(os.path.join(rec_dir, "grads.npz"))}
    got, want = rec["tp_2x2"], rec["one_card"]
    rec.update(_errs(got.pop("grads"), want.pop("grads"), got["step_losses"][0], want["step_losses"][0]))
    _require(rec, "train_data_parallel(tensor_parallel=True)")
    out["tp_dp"] = rec
    print(f"train_data_parallel 2 × 2 tensor parallel: {json.dumps(rec)}", flush=True)


def ep(seed: int, out: dict) -> None:
    from cvml_goalnet_tpu_torch.models.moe import moe_apply
    from cvml_goalnet_tpu_torch.parallel.launch import spawn_ranks
    from cvml_goalnet_tpu_torch.train.optim import tree_leaves, tree_unflatten

    cfg = C.text_moe_cfg(C.PipelineConfig.load(str(C.REPO / "configs" / "reference_parity.json")), "moe")
    moe_np = weights.init_params(cfg, seed + 27)[0]["fusion"][0]
    x = np.random.default_rng(seed + 28).standard_normal((EP_ROWS, 640)).astype(np.float32)
    k = cfg.model.fusion_moe_top_k
    t0 = time.perf_counter()
    got = spawn_ranks(ep_rank, [torch.device("cuda", i) for i in range(4)], ({"moe": moe_np, "x": x, "top_k": k},))[0]
    wall = time.perf_counter() - t0
    moe = weights.tree_from_jax(moe_np)
    leaves = [t.requires_grad_() for t in tree_leaves(moe)]
    xc = torch.as_tensor(x).cuda()
    with torch.enable_grad():
        y = moe_apply(tree_unflatten(moe, leaves), xc, k)
        grads = [g.cpu().numpy() for g in torch.autograd.grad((y * y).sum(), leaves)]
    y = y.detach().cpu().numpy()
    rec = {"shards": 4, "rows": EP_ROWS, "run_s": wall, "ep_fwd_s": got["fwd_s"],
           "one_card_fwd_s": C.time_ms(lambda: moe_apply(moe, xc, k), reps=5) / 1e3,
           "out_err": float(np.abs(got["out"] - y).max()) / max(1.0, float(np.abs(y).max())),
           **_errs(got["grads"], grads)}
    _require(rec, "EP")
    C.require(rec["out_err"] <= 1e-5, f"EP output: {json.dumps(rec)}")
    out["ep"] = rec
    print(f"EP over 4 cards: {json.dumps(rec)}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        print("pp_four_cards: needs four CUDA devices", file=sys.stderr)
        return 1
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
    out = {"cards": cards}
    with tempfile.TemporaryDirectory() as root:
        videos = []
        for i, shift in enumerate((0, C.MATCH_FRAMES // 3)):
            fp = os.path.join(root, f"m{i}.npz")
            np.savez(fp, frames=np.roll(match["frames"], shift, axis=0))
            C.write_events(fp, C.MATCH_FRAMES, 1, args.seed + 2300 + i)
            videos.append(fp)
        for npp in (2, 4):
            spot_train_pp(root, cfg, videos, npp, out)
    dppp(base, args.seed, out)
    tp_dp(args.seed, out)
    ep(args.seed, out)
    out["total_s"] = time.perf_counter() - t_start
    print(json.dumps(out))
    print(smi)
    print(json.dumps({"ok": True, "cards": cards}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
