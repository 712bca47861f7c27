"""PyTorch port: context-parallel spotting (``parallel/ring_attention.py``, ``parallel/halo_attention.py``, the
CP, DP×CP, TP×CP and 3-D transformer applies, the three train steps, ``score_timeline_sharded``) against the
JAX package, on the CPU.

The port runs in spawned ``gloo`` ranks that import the port only (``tests/_torch_cp_ranks.py``), at worlds
2 and 4 and one 3-D run at 2×2×2 (8 ranks); each world spawns once for the module and runs every case of it
in one go.  The JAX side runs the same inputs on the suite's 8 CPU devices with ``use_flash=False`` (its XLA
attention), and for one ring and one halo case with ``use_flash=True, flash_interpret=True`` (the Pallas
kernels in interpret mode).  Held: ring and halo outputs within 1e-5·max(1, max|out|) and their gradients
within 1e-4·max(1, max|g|), padded and extreme-magnitude cases included; the four applies within
1e-5·max(1, max|s|) for learned and rotary positions, multi-class heads, padded groups and all-pad dummy
timelines; the three steps' losses within 1e-5 relative, their gradients within 1e-4·max|g| and the
parameters after one Adam step within 2·lr (Adam moves an entry whose gradient is rounding noise by up to lr
either way); ``score_timeline_sharded`` for the transformer, the GRU and the hybrid within 1e-5·max(1, max|s|).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

import _torch_cp_ranks as RANKS
from cvml_goalnet_tpu.models import temporal_attention as JTA
from cvml_goalnet_tpu.parallel.halo_attention import halo_attention_local
from cvml_goalnet_tpu.parallel.mesh import cpu_mesh
from cvml_goalnet_tpu.parallel.ring_attention import ring_attention
from cvml_goalnet_tpu.spotting import score_timeline_sharded, temporal_head_init_auto
from cvml_goalnet_tpu.train.spotting import timeline_lengths, weighted_bce
from cvml_goalnet_tpu_torch.config import PipelineConfig
from cvml_goalnet_tpu_torch.parallel.launch import spawn_ranks
from cvml_goalnet_tpu_torch.parallel.mesh import serving_mesh
from test_torch_reference_checkpoints import _leaves

LR = 1e-3
POS_WEIGHT = 10.0


def _mesh(shape, names) -> Mesh:
    return Mesh(np.array(jax.devices("cpu")[:int(np.prod(shape))]).reshape(shape), names)


def _qkv(h, t, d, seed, k_scale=None):
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal((h, t, d)).astype(np.float32) for _ in range(4))
    if k_scale is not None:
        k = (k * np.repeat(k_scale, t // len(k_scale))[None, :, None]).astype(np.float32)
    return {"q": q, "k": k, "v": v, "g": g}


def _params(seed, in_dim=12, d=32, layers=2, heads=2, max_len=48, n_classes=1, pos="learned"):
    p = JTA.temporal_transformer_init(jax.random.PRNGKey(seed), in_dim, model_dim=d, num_layers=layers,
                                      num_heads=heads, max_len=max_len, n_classes=n_classes, pos_encoding=pos)
    return jax.tree.map(np.asarray, p)


def _feats(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _labels(shape, seed, pad_from=None):
    lab = (np.random.default_rng(seed).random(shape) < 0.15).astype(np.float32)
    if pad_from is not None:
        for b, start in enumerate(pad_from):
            lab[b, start:] = -1.0
    return lab


# ------------------------------------------------------------------ the JAX side of each case


def _jax_attention(case, n):
    """JAX's ring (``ring_attention``) or halo (``halo_attention_local`` in a ``shard_map``) over ``cpu_mesh(n)``,
    and its VJP for the cotangent ``g``."""
    flash = case.get("flash", False)
    if case["kind"] == "ring":
        def fn(q, k, v):
            return ring_attention(q, k, v, cpu_mesh(n), t_valid=case.get("t_valid"), use_flash=flash,
                                  flash_interpret=flash)
    else:
        seq = P(None, "data", None)
        fn = jax.jit(shard_map(
            lambda ql, kl, vl: halo_attention_local(ql, kl, vl, "data", case["window"], t_valid=case.get("t_valid"),
                                                    use_flash=flash, flash_interpret=flash),
            mesh=cpu_mesh(n), in_specs=(seq, seq, seq), out_specs=seq, check_rep=False))
    out, vjp = jax.vjp(fn, *(jnp.asarray(case[x]) for x in ("q", "k", "v")))
    dq, dk, dv = vjp(jnp.asarray(case["g"]))
    return {"out": out, "dq": dq, "dk": dk, "dv": dv}


def _jax_apply_fn(case):
    """JAX's apply of the case's layout as ``f(params, features, lengths)``."""
    ndp, ntp, nctx = case["grid"]
    heads, window = case["heads"], case["window"]
    which = case.get("apply", case.get("step"))
    if which == "sharded":
        mesh = cpu_mesh(nctx)
        return lambda p, f, _: JTA.temporal_transformer_sharded_apply(p, f, mesh, heads, "data", window=window)
    if which == "tp_cp":
        mesh = _mesh((ntp, nctx), ("model", "ctx"))
        return lambda p, f, _: JTA.temporal_transformer_tp_cp_apply(p, f, mesh, heads, "model", "ctx", window=window)
    if which == "dp_cp":
        mesh = _mesh((ndp, nctx), ("data", "ctx"))
        return lambda p, f, lens: JTA.temporal_transformer_dp_cp_apply(p, f, mesh, heads, "data", "ctx",
                                                                       window=window, lengths=lens)
    mesh = _mesh((ndp, ntp, nctx), ("data", "model", "ctx"))
    return lambda p, f, lens: JTA.temporal_transformer_3d_apply(p, f, mesh, heads, "data", "model", "ctx",
                                                                window=window, lengths=lens)


def _jax_apply(case):
    return {"out": _jax_apply_fn(case)(case["params"], jnp.asarray(case["features"]), case.get("lengths"))}


def _jax_step(case):
    """What JAX's step of the case's layout computes once from Adam's start: ``value_and_grad`` of its loss
    (``weighted_bce`` of the layout's apply, each timeline's true length from its labels in the batched
    layouts) and ``adam_update`` at lr (the step factories themselves run in ``test_torch_cli_spot_cp.py``,
    through the JAX CLI)."""
    from cvml_goalnet_tpu.train.optim import adam_init, adam_update

    apply = _jax_apply_fn(case)
    lab = jnp.asarray(case["labels"])
    lens = None if case["step"] == "sharded" else timeline_lengths(lab)

    def loss_fn(p):
        return weighted_bce(apply(p, jnp.asarray(case["features"]), lens).reshape(lab.shape), lab, POS_WEIGHT)

    loss, grads = jax.value_and_grad(loss_fn)(case["params"])
    params, _ = adam_update(grads, adam_init(case["params"]), case["params"], LR)
    return {"loss": float(loss), "grads": jax.tree.map(np.asarray, grads), "params": jax.tree.map(np.asarray, params)}


def _score_cfg(small_cfg, model: str):
    mc = dataclasses.replace(small_cfg.model, temporal_model=model, temporal_hidden=16, temporal_num_heads=2,
                             temporal_window=3 if model != "gru" else 0, temporal_chunk=16, temporal_halo=4,
                             temporal_max_len=64)
    return dataclasses.replace(small_cfg, model=mc)


def _jax_score(case, small_cfg):
    cfg = _score_cfg(small_cfg, case["model"])
    return {"out": score_timeline_sharded(case["params"], jnp.asarray(case["features"]), cpu_mesh(case["grid"][2]),
                                          cfg)}


# ------------------------------------------------------------------ the cases of each world


def _cases(world: int, small_cfg) -> dict:
    c: dict = {}
    if world == 2:
        c["ring"] = {"kind": "ring", **_qkv(2, 64, 16, 1)}
        c["halo"] = {"kind": "halo", "window": 8, "t_valid": 64, **_qkv(2, 64, 16, 2)}
        c["apply_sharded_learned_wrapping"] = {"kind": "apply", "apply": "sharded", "grid": (1, 1, 2), "heads": 2,
                                               "window": 0, "params": _params(3), "features": _feats((60, 12), 3)}
        c["step_sharded_banded"] = {"kind": "step", "step": "sharded", "grid": (1, 1, 2), "heads": 1, "window": 5,
                                    "params": _params(4, layers=1, heads=1), "features": _feats((50, 12), 4),
                                    "labels": _labels((50,), 4)}
        for window in (0, 4):   # rings of one: no shift, the halos wrap to the rank itself and are masked
            c[f"apply_ring_of_one_w{window}"] = {
                "kind": "apply", "apply": "dp_cp", "grid": (2, 1, 1), "heads": 2, "window": window,
                "params": _params(5), "features": _feats((2, 20, 12), 5), "lengths": [20, 13]}
        c["imports"] = {"kind": "imports"}
    elif world == 4:
        c["ring_padded"] = {"kind": "ring", "t_valid": 90, **_qkv(1, 96, 32, 10)}
        c["ring_extreme"] = {"kind": "ring", **_qkv(1, 128, 16, 11, k_scale=[0.1, 8.0, 0.1, 8.0])}
        c["ring_flash_interpret"] = {"kind": "ring", "flash": True, "t_valid": 120, **_qkv(1, 128, 32, 12)}
        c["halo_padded"] = {"kind": "halo", "window": 6, "t_valid": 90, **_qkv(2, 96, 16, 13)}
        c["halo_extreme"] = {"kind": "halo", "window": 12, **_qkv(1, 128, 16, 14, k_scale=[0.1, 8.0, 0.1, 8.0])}
        c["halo_flash_interpret"] = {"kind": "halo", "flash": True, "window": 8, "t_valid": 128,
                                     **_qkv(1, 128, 32, 15)}
        c["apply_sharded_rotary_banded"] = {"kind": "apply", "apply": "sharded", "grid": (1, 1, 4), "heads": 2,
                                            "window": 5, "params": _params(20, pos="rotary"),
                                            "features": _feats((90, 12), 20)}
        c["apply_sharded_multiclass"] = {"kind": "apply", "apply": "sharded", "grid": (1, 1, 4), "heads": 2,
                                         "window": 0, "params": _params(21, n_classes=3),
                                         "features": _feats((64, 12), 21)}
        c["apply_dp_cp_padded_dummy"] = {"kind": "apply", "apply": "dp_cp", "grid": (2, 1, 2), "heads": 2,
                                         "window": 3, "params": _params(22), "features": _feats((2, 30, 12), 22),
                                         "lengths": [23, 0]}
        c["apply_tp_cp_rotary"] = {"kind": "apply", "apply": "tp_cp", "grid": (1, 2, 2), "heads": 2, "window": 0,
                                   "params": _params(23, pos="rotary"), "features": _feats((42, 12), 23)}
        c["apply_3d"] = {"kind": "apply", "apply": "3d", "grid": (2, 2, 1), "heads": 2, "window": 4,
                         "params": _params(24, n_classes=2), "features": _feats((2, 26, 12), 24),
                         "lengths": [26, 17]}
        c["step_dp_cp_padded_dummy"] = {"kind": "step", "step": "dp_cp", "grid": (2, 1, 2), "heads": 2, "window": 3,
                                        "params": _params(31), "features": _feats((2, 30, 12), 31),
                                        "labels": _labels((2, 30), 31, pad_from=[26, 0])}
        c["step_3d_multiclass"] = {"kind": "step", "step": "3d", "grid": (1, 2, 2), "heads": 2, "window": 0,
                                   "params": _params(32, n_classes=2), "features": _feats((1, 40, 12), 32),
                                   "labels": _labels((1, 40, 2), 32)}
        for model in ("transformer", "gru", "hybrid"):
            cfg = _score_cfg(small_cfg, model)
            head = temporal_head_init_auto(jax.random.PRNGKey(40), 12, cfg.model)
            c[f"score_{model}"] = {"kind": "score", "grid": (1, 1, 4), "model": model,
                                   "cfg": PipelineConfig.from_json(cfg.to_json()),
                                   "params": jax.tree.map(np.asarray, head), "features": _feats((100, 12), 41)}
        c["window_error"] = {"kind": "window_error", "tl": 4, "window": 6}
        c["imports"] = {"kind": "imports"}
    else:
        c["apply_3d_222"] = {"kind": "apply", "apply": "3d", "grid": (2, 2, 2), "heads": 2, "window": 3,
                             "params": _params(50), "features": _feats((2, 36, 12), 50), "lengths": [36, 21]}
        c["step_3d_222"] = {"kind": "step", "step": "3d", "grid": (2, 2, 2), "heads": 2, "window": 4,
                            "params": _params(51), "features": _feats((2, 40, 12), 51),
                            "labels": _labels((2, 40), 51, pad_from=[40, 29])}
        c["imports"] = {"kind": "imports"}
    return c


@pytest.fixture(scope="module")
def runs(small_cfg):
    """world → {case name: (the JAX package's result, the port's rank 0 result)}; each world spawned once."""
    cache: dict = {}

    def run(world: int) -> dict:
        if world not in cache:
            cases = _cases(world, small_cfg)
            ranks = spawn_ranks(RANKS.run_cases, serving_mesh(world, device="cpu"), (list(cases.values()),))
            got = ranks[0]
            want = {}
            for name, case in cases.items():
                kind = case["kind"]
                if kind in ("ring", "halo"):
                    want[name] = _jax_attention(case, world)
                elif kind == "apply":
                    want[name] = _jax_apply(case)
                elif kind == "step":
                    want[name] = _jax_step(case)
                elif kind == "score":
                    want[name] = _jax_score(case, small_cfg)
            cache[world] = {name: (want.get(name), g) for name, g in zip(cases, got)}
            cache[world]["imports"] = (None, [r[list(cases).index("imports")] for r in ranks])
        return cache[world]

    return run


def _names(kind: str) -> list:
    return [(w, n) for w in (2, 4, 8) for n, c in _cases_index()[w].items() if c == kind]


def _cases_index() -> dict:
    """world → {case name: kind}, without building the inputs (pytest collects from it)."""
    return {
        2: {"ring": "ring", "halo": "halo", "apply_sharded_learned_wrapping": "apply",
            "step_sharded_banded": "step", "apply_ring_of_one_w0": "apply", "apply_ring_of_one_w4": "apply"},
        4: {"ring_padded": "ring", "ring_extreme": "ring", "ring_flash_interpret": "ring", "halo_padded": "halo",
            "halo_extreme": "halo", "halo_flash_interpret": "halo", "apply_sharded_rotary_banded": "apply",
            "apply_sharded_multiclass": "apply", "apply_dp_cp_padded_dummy": "apply", "apply_tp_cp_rotary": "apply",
            "apply_3d": "apply", "step_dp_cp_padded_dummy": "step",
            "step_3d_multiclass": "step", "score_transformer": "score", "score_gru": "score",
            "score_hybrid": "score"},
        8: {"apply_3d_222": "apply", "step_3d_222": "step"},
    }


def _close(got, want, rel: float, what: str):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(1.0, float(np.abs(want).max())), err_msg=what)


@pytest.mark.parametrize("world,name", _names("ring") + _names("halo"))
def test_ring_and_halo_attention_match_jax(runs, world, name):
    want, got = runs(world)[name]
    _close(got["out"], want["out"], 1e-5, "out")
    for g in ("dq", "dk", "dv"):
        _close(got[g], want[g], 1e-4, g)


@pytest.mark.parametrize("world,name", _names("apply"))
def test_applies_match_jax(runs, world, name):
    want, got = runs(world)[name]
    assert got["out"].shape == np.asarray(want["out"]).shape
    _close(got["out"], want["out"], 1e-5, name)


@pytest.mark.parametrize("world,name", _names("step"))
def test_steps_match_jax(runs, world, name):
    want, got = runs(world)[name]
    assert abs(got["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"])
    assert got["loss_step"] == got["loss"]
    gw, gg = dict(_leaves(want["grads"])), dict(_leaves(got["grads"]))
    assert gw.keys() == gg.keys()
    gmax = max(float(np.abs(g).max()) for g in gw.values())
    for k in gw:
        np.testing.assert_allclose(gg[k], gw[k], rtol=0, atol=1e-4 * gmax, err_msg=k)
    pw, pg = dict(_leaves(want["params"])), dict(_leaves(got["params"]))
    for k in pw:
        np.testing.assert_allclose(pg[k], pw[k], rtol=0, atol=2 * LR, err_msg=k)
    assert got["opt_step"] == 1


@pytest.mark.parametrize("world,name", _names("score"))
def test_score_timeline_sharded_matches_jax(runs, world, name):
    want, got = runs(world)[name]
    _close(got["out"], want["out"], 1e-5, name)


def test_window_past_the_shard_raises_as_jax(runs):
    _, got = runs(4)["window_error"]
    assert got["error"] is not None and got["error"].startswith(
        "halo banded attention needs window (6) <= per-device shard length (4)")


@pytest.mark.parametrize("world", [2, 4, 8])
def test_spawned_ranks_import_no_jax(runs, world):
    _, got = runs(world)["imports"]
    assert [r["forbidden"] for r in got] == [[]] * world


def test_case_index_is_the_cases(small_cfg):
    """The collected names are the cases each world runs (the index saves building the inputs at collection)."""
    for world, index in _cases_index().items():
        built = {n: c["kind"] for n, c in _cases(world, small_cfg).items()}
        assert {n: k for n, k in built.items() if k in ("ring", "halo", "apply", "step", "score")} == index


@pytest.mark.parametrize("kind,t,window", [("ring", 96, None), ("ring", 90, None), ("halo", 96, 8), ("halo", 90, 6)])
def test_virtual_shards_match_jax(kind, t, window):
    """The one-process forms (``ring_attention_shards``, ``halo_attention_shards``: the hop math chip_smoke.py
    drives over virtual shards on one card) over 4 shards of a timeline padded to a multiple of 4 (keys past
    ``t`` masked) against JAX's ring and halo on ``cpu_mesh(4)``: outputs within 1e-5, gradients within 1e-4."""
    import torch

    from cvml_goalnet_tpu_torch.parallel.halo_attention import halo_attention_shards
    from cvml_goalnet_tpu_torch.parallel.ring_attention import ring_attention_shards

    n, tp = 4, 96
    case = {"kind": kind, "t_valid": t, **_qkv(2, tp, 16, 60 + t)}
    if window is not None:
        case["window"] = window
    want = _jax_attention(case, n)
    leaves = [torch.tensor(case[x], requires_grad=True) for x in ("q", "k", "v")]
    with torch.enable_grad():
        qs, ks, vs = ([x[:, i * (tp // n):(i + 1) * (tp // n)] for i in range(n)] for x in leaves)
        outs = (ring_attention_shards(qs, ks, vs, t)[0] if kind == "ring"
                else halo_attention_shards(qs, ks, vs, window, t))
        out = torch.cat(outs, 1)
        grads = torch.autograd.grad((out * torch.tensor(case["g"])).sum(), leaves)
    _close(out.detach().numpy(), want["out"], 1e-5, "out")
    for name, g in zip(("dq", "dk", "dv"), grads):
        _close(g.numpy(), want[name], 1e-4, name)


def test_ring_shard_lse_is_the_monolithic_lse():
    """The merged log-sum-exp of the virtual ring equals one kernel call's over the whole timeline, masked
    hops (the padded tail's) weighing nothing."""
    import torch

    from cvml_goalnet_tpu_torch.ops.cuda.flash_attention import flash_fwd
    from cvml_goalnet_tpu_torch.parallel.ring_attention import ring_attention_shards

    c = _qkv(1, 80, 16, 70)
    q, k, v = (torch.tensor(c[x]) for x in ("q", "k", "v"))
    _, lses = ring_attention_shards(*([x[:, i * 20:(i + 1) * 20] for i in range(4)] for x in (q, k, v)), t_valid=47)
    _, want = flash_fwd(q, k, v, 0.25, 47)
    np.testing.assert_allclose(torch.cat(lses, 1)[..., 0].numpy(), want.numpy(), atol=1e-5, rtol=0)
