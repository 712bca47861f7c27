"""PyTorch port: pipeline parallelism (``parallel/pp.py``: ``stack_pipeline_stages``, ``pipeline_transformer_apply``,
``make_pp_spotting_train_step``, DP×PP) against the JAX package's, on the CPU.

The port runs in spawned ``gloo`` ranks that import the port only (``tests/_torch_pp_ranks.py``): a world of 2
(a pipe of two stages) and one of 4 (a pipe of four, and a 2 × 2 ``(data, pipe)`` grid), each spawned once for
the module.  The JAX side runs the same seeded inputs on the suite's 8 CPU devices (its XLA attention).  The
cases are those of ``tests/test_pipeline_parallel.py`` and the DP×PP ones of
``tests/test_composed_parallel.py``: learned and rotary positions, banded attention, a multi-class head,
1, 2 and 4 microbatches, the step's gradients and one Adam step, three steps with global-norm clipping and a
schedule.  Held: forwards within 1e-5·max(1, max|s|), gradients within 1e-4·max(1, max|g|) (a stage-fold
scaling of any leaf would miss that by far), step losses within 1e-5 relative, parameters after one Adam step
within 1e-5·max(1, max|p|) wherever the gradient is beyond its tolerance of 0 (2·lr where it is rounding noise),
each leaf moved from its start by more than that.  The one-process
form (every stage in this process, ``parallel.mesh.VirtualAxis``: what ``chip_smoke.py`` drives on one card) is
held to the same.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import _torch_pp_ranks as RANKS
from cvml_goalnet_tpu.models import temporal_attention as JTA
from cvml_goalnet_tpu.parallel import pp as JPP
from cvml_goalnet_tpu.parallel.mesh import cpu_mesh
from cvml_goalnet_tpu.train.optim import adam_init as jax_adam_init
from cvml_goalnet_tpu.train.spotting import weighted_bce
from cvml_goalnet_tpu_torch import weights as W
from cvml_goalnet_tpu_torch.parallel import pp as PP
from cvml_goalnet_tpu_torch.parallel.launch import spawn_ranks
from cvml_goalnet_tpu_torch.parallel.mesh import Axis, VirtualAxis, serving_mesh
from cvml_goalnet_tpu_torch.train.optim import tree_map
from test_torch_reference_checkpoints import _leaves

D_IN, DM, HEADS, T, B = 12, 16, 2, 32, 4
LR = 1e-3
CLIP = {"grad_clip_norm": 0.05, "lr_schedule": ("cosine", 1, 3, 0.1)}


def _params(pos="learned", num_layers=4, n_classes=1, seed=0, d=DM, max_len=T):
    p = JTA.temporal_transformer_init(jax.random.PRNGKey(seed), D_IN, model_dim=d, num_layers=num_layers,
                                      num_heads=HEADS, max_len=max_len, n_classes=n_classes, pos_encoding=pos)
    return jax.tree.map(np.asarray, p)


def _feats(seed=1, b=B, t=T):
    return np.random.default_rng(seed).standard_normal((b, t, D_IN)).astype(np.float32)


def _labels(shape, seed):
    return (np.random.default_rng(seed).random(shape) < 0.15).astype(np.float32)


def _mesh(axes) -> Mesh:
    shape = [n for _, n in axes]
    return Mesh(np.array(jax.devices("cpu")[:int(np.prod(shape))]).reshape(shape), [a for a, _ in axes])


# ------------------------------------------------------------------ the JAX side of each case


def _jax_apply(case):
    axes = case["axes"]
    data = "data" if len(axes) == 2 else None
    return {"out": JPP.pipeline_transformer_apply(case["params"], jnp.asarray(case["features"]), _mesh(axes), "pipe",
                                                  case["heads"], case.get("n_micro", 0), window=case.get("window", 0),
                                                  data_axis=data)}


def _jax_step(case):
    """JAX's ``make_pp_spotting_train_step`` for ``steps`` steps (losses, the tree after the first), and the
    gradient of its loss through ``pipeline_transformer_apply``."""
    axes = case["axes"]
    data = "data" if len(axes) == 2 else None
    mesh = _mesh(axes)
    f, lab = jnp.asarray(case["features"]), jnp.asarray(case["labels"])
    kw = {"n_micro": case.get("n_micro", 0), "window": case.get("window", 0), "data_axis": data}

    def loss_fn(p):
        out = JPP.pipeline_transformer_apply(p, f, mesh, "pipe", case["heads"], **kw)
        return weighted_bce(out.reshape(lab.shape), lab, 10.0)

    loss, grads = jax.value_and_grad(loss_fn)(case["params"])
    step = JPP.make_pp_spotting_train_step(mesh, "pipe", num_heads=case["heads"], lr=LR, **kw,
                                           **case.get("opt_kw", {}))
    p, opt, losses = case["params"], jax_adam_init(case["params"]), []
    for i in range(case.get("steps", 1)):
        p, opt, step_loss = step(p, opt, f, lab)
        losses.append(float(step_loss))
        if i == 0:
            first = jax.tree.map(np.asarray, p)
    return {"loss": float(loss), "grads": jax.tree.map(np.asarray, grads), "params": first, "losses": losses,
            "start": case["params"]}


# ------------------------------------------------------------------ the cases of each world


def _cases(world: int) -> dict:
    c: dict = {}
    pipe = (("pipe", world),)
    if world == 2:
        c["apply_2_stages"] = {"kind": "pp_apply", "axes": pipe, "heads": HEADS, "params": _params(),
                               "features": _feats()}
        c["step_2_stages_clip_schedule"] = {"kind": "pp_step", "axes": pipe, "heads": HEADS, "steps": 3,
                                            "opt_kw": CLIP, "params": _params(seed=5), "features": _feats(5),
                                            "labels": _labels((B, T), 5)}
    else:
        for pos in ("learned", "rotary"):
            c[f"apply_4_stages_{pos}"] = {"kind": "pp_apply", "axes": pipe, "heads": HEADS, "params": _params(pos),
                                          "features": _feats()}
        c["apply_banded"] = {"kind": "pp_apply", "axes": pipe, "heads": HEADS, "window": 8,
                             "params": _params("rotary"), "features": _feats()}
        c["apply_multiclass"] = {"kind": "pp_apply", "axes": pipe, "heads": HEADS, "params": _params(n_classes=3),
                                 "features": _feats()}
        for m in (1, 2, 4):
            c[f"apply_micro_{m}"] = {"kind": "pp_apply", "axes": pipe, "heads": HEADS, "n_micro": m,
                                     "params": _params(), "features": _feats()}
        c["step_4_stages"] = {"kind": "pp_step", "axes": pipe, "heads": HEADS, "params": _params(),
                              "features": _feats(2), "labels": _labels((B, T), 3)}
        c["step_4_stages_banded_multiclass"] = {"kind": "pp_step", "axes": pipe, "heads": HEADS, "window": 8,
                                                "n_micro": 2, "params": _params("rotary", n_classes=2, seed=6),
                                                "features": _feats(6), "labels": _labels((B, T, 2), 6)}
        grid = (("data", 2), ("pipe", 2))
        for pos in ("learned", "rotary"):
            c[f"dppp_apply_{pos}"] = {"kind": "pp_apply", "axes": grid, "heads": 2,
                                      "params": _params(pos, seed=1, d=32, max_len=64), "features": _feats(7, 8, 24)}
        c["dppp_step"] = {"kind": "pp_step", "axes": grid, "heads": 2, "params": _params(seed=1, d=32, max_len=64),
                          "features": _feats(8, 8, 24), "labels": _labels((8, 24), 8)}
        c["dppp_step_clip_schedule"] = {"kind": "pp_step", "axes": grid, "heads": 2, "steps": 3, "opt_kw": CLIP,
                                        "params": _params("rotary", seed=9, d=32, max_len=64),
                                        "features": _feats(9, 8, 24), "labels": _labels((8, 24), 9)}
    c["imports"] = {"kind": "imports"}
    return c


@pytest.fixture(scope="module")
def runs():
    """world → {case name: (the JAX package's result, the port's rank 0 result)}; each world spawned once."""
    cache: dict = {}

    def run(world: int) -> dict:
        if world not in cache:
            cases = _cases(world)
            ranks = spawn_ranks(RANKS.run_cases, serving_mesh(world, device="cpu"), (list(cases.values()),))
            cache[world] = {}
            for (name, case), got in zip(cases.items(), ranks[0]):
                want = {"pp_apply": _jax_apply, "pp_step": _jax_step}.get(case["kind"])
                cache[world][name] = (want(case) if want else None, got)
            cache[world]["imports"] = (None, [r[list(cases).index("imports")] for r in ranks])
        return cache[world]

    return run


def _index() -> dict:
    """world → {case name: kind}, without building the inputs (pytest collects from it)."""
    return {2: {"apply_2_stages": "pp_apply", "step_2_stages_clip_schedule": "pp_step"},
            4: {**{f"apply_4_stages_{p}": "pp_apply" for p in ("learned", "rotary")}, "apply_banded": "pp_apply",
                "apply_multiclass": "pp_apply", **{f"apply_micro_{m}": "pp_apply" for m in (1, 2, 4)},
                "step_4_stages": "pp_step", "step_4_stages_banded_multiclass": "pp_step",
                **{f"dppp_apply_{p}": "pp_apply" for p in ("learned", "rotary")}, "dppp_step": "pp_step",
                "dppp_step_clip_schedule": "pp_step"}}


def _names(kind: str) -> list:
    return [(w, n) for w, idx in _index().items() for n, k in idx.items() if k == kind]


def _close(got, want, rel: float, what: str):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(1.0, float(np.abs(want).max())), err_msg=what)


def adam_close(got, want, start, grads=None, lr: float = 0.0):
    """A tree after Adam (``got``) within 1e-5·max(1, max|p|) of ``want``, and every leaf of ``want`` moved from
    ``start`` by more than that, so that a tree Adam left as it was fails.

    With ``grads`` (one step's gradients, Adam's eps 1e-8) an entry whose gradient lies within the gradient
    tolerance 1e-4·max(1, max|g|) of 0 is held to 2·lr instead, and a leaf of such entries alone (a bias ahead
    of a batchnorm, a key bias: gradients 0 but for rounding) need not move: the sign of its gradient is
    noise, and Adam's first step moves it by up to lr either way.  Beyond that tolerance both gradients have
    one sign, and the two steps differ by at most lr·eps / |g|."""
    pw, pg, p0 = (dict(_leaves(t)) for t in (want, got, start))
    assert pw.keys() == pg.keys() == p0.keys()
    tol = 1e-5 * max(1.0, max(float(np.abs(np.asarray(p)).max()) for p in pw.values()))
    gw = None if grads is None else dict(_leaves(grads))
    if gw is not None:
        g_tol = 1e-4 * max(1.0, max(float(np.abs(np.asarray(g)).max()) for g in gw.values()))
    for k in pw:
        want_k = np.asarray(pw[k])
        sure = np.ones(want_k.shape, bool) if gw is None else np.abs(np.asarray(gw[k])) > g_tol
        assert np.all(np.abs(np.asarray(pg[k]) - want_k) <= np.where(sure, tol, 2 * lr)), k
        if sure.any():
            assert float(np.abs(want_k - np.asarray(p0[k]))[sure].max()) > tol, f"{k}: Adam did not move it"


def _grads_close(got, want):
    gw, gg = dict(_leaves(want)), dict(_leaves(got))
    assert gw.keys() == gg.keys()
    gmax = max(1.0, max(float(np.abs(g).max()) for g in gw.values()))
    for k in gw:
        np.testing.assert_allclose(gg[k], gw[k], rtol=0, atol=1e-4 * gmax, err_msg=k)


def test_case_index_is_the_cases():
    """The collected names are the cases each world runs (the index saves building the inputs at collection)."""
    for world in (2, 4):
        built = {n: c["kind"] for n, c in _cases(world).items() if c["kind"] != "imports"}
        assert built == _index()[world]


@pytest.mark.parametrize("world,name", _names("pp_apply"))
def test_pipeline_apply_matches_jax(runs, world, name):
    want, got = runs(world)[name]
    assert got["out"].shape == np.asarray(want["out"]).shape
    _close(got["out"], want["out"], 1e-5, name)


@pytest.mark.parametrize("world,name", _names("pp_step"))
def test_pipeline_step_gradients_match_jax(runs, world, name):
    want, got = runs(world)[name]
    assert abs(got["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"])
    _grads_close(got["grads"], want["grads"])


@pytest.mark.parametrize("world,name", _names("pp_step"))
def test_pipeline_step_matches_jax(runs, world, name):
    """The step's losses (three steps where clipping and the schedule act) within 1e-5 relative, and the tree
    after one Adam step within 1e-5·max(1, max|p|) where the gradient is not rounding noise, every leaf moved
    from its start (``adam_close``)."""
    want, got = runs(world)[name]
    assert got["opt_step"] == len(want["losses"])
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5, atol=0)
    adam_close(got["params"], want["params"], want["start"], want["grads"], LR)


@pytest.mark.parametrize("world", [2, 4])
def test_spawned_ranks_import_no_jax(runs, world):
    _, got = runs(world)["imports"]
    assert [r["forbidden"] for r in got] == [[]] * world


class TestStacking:
    def test_roundtrip_shapes(self):
        stages = PP.stack_pipeline_stages(W.tree_from_jax(_params(), device="cpu")["layers"], 2)
        assert len(stages) == 2 and [len(s) for s in stages] == [2, 2]
        assert tuple(stages[1][0]["wq"]["w"].shape) == (DM, DM)
        want = JPP.stack_pipeline_stages(_params()["layers"], 2)
        np.testing.assert_array_equal(stages[1][1]["wq"]["w"].numpy(), np.asarray(want["wq"]["w"][1, 1]))

    def test_indivisible_layers_raise_as_jax(self):
        with pytest.raises(ValueError) as want:
            JPP.stack_pipeline_stages(_params()["layers"], 3)
        with pytest.raises(ValueError) as got:
            PP.stack_pipeline_stages(_params()["layers"], 3)
        assert str(got.value) == str(want.value)

    def test_indivisible_batch_raises_as_jax(self):
        with pytest.raises(ValueError, match="microbatch") as want:
            JPP.pipeline_transformer_apply(_params(), _feats(b=5), cpu_mesh(4, model=4), "model", HEADS, n_micro=4)
        with pytest.raises(ValueError) as got:
            PP.pipeline_transformer_apply(W.tree_from_jax(_params(), device="cpu"), torch.as_tensor(_feats(b=5)),
                                          VirtualAxis(4), HEADS, n_micro=4)
        assert str(got.value) == str(want.value)

    def test_microbatch_not_divisible_over_data_raises_as_jax(self):
        with pytest.raises(ValueError, match="divide over data axis") as want:
            JPP.pipeline_transformer_apply(_params(seed=1, d=32, max_len=64), _feats(b=4, t=24),
                                           _mesh((("data", 2), ("pipe", 4))), "pipe", 2, n_micro=4, data_axis="data")
        with pytest.raises(ValueError) as got:
            PP.microbatches(4, 4, 4, data=Axis(None, (0, 1), 0))
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("stages,window,pos", [(2, 0, "learned"), (4, 8, "rotary")])
def test_virtual_stages_match_jax(stages, window, pos):
    """Every stage in this process (``VirtualAxis``, chip_smoke.py's one-card form): the forward within 1e-5 and
    the step's gradients within 1e-4·max(1, max|g|) of JAX's pipeline on ``cpu_mesh(stages)``."""
    case = {"axes": (("pipe", stages),), "heads": HEADS, "window": window, "params": _params(pos, seed=11),
            "features": _feats(11), "labels": _labels((B, T), 11)}
    want = _jax_step(case)
    params = W.tree_from_jax(case["params"], device="cpu")
    f, lab = torch.as_tensor(case["features"]), torch.as_tensor(case["labels"])
    out = PP.pipeline_transformer_apply(params, f, VirtualAxis(stages), HEADS, window=window)
    _close(out.numpy(), _jax_apply(case)["out"], 1e-5, "out")
    loss, grads = PP.make_pp_spotting_train_step(VirtualAxis(stages), HEADS, window=window).value_and_grad(
        params, f, lab)
    assert abs(float(loss) - want["loss"]) <= 1e-5 * abs(want["loss"])
    _grads_close(tree_map(torch.Tensor.numpy, grads), want["grads"])
