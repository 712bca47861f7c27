"""PyTorch port: the fusion MLP's tensor-parallel layout (``parallel/sharding.py``, ``models/avm.py::
fusion_train_apply``, ``make_dp_train_step(tensor_parallel=True)``, ``train_data_parallel(tensor_parallel=True)``)
and expert parallelism (``parallel/ep.py::moe_apply_expert_parallel``) against the JAX package's, on the CPU.

The port runs in spawned ``gloo`` ranks that import the port only (``tests/_torch_pp_ranks.py``): one world of
8 laid out as JAX's ``cpu_mesh(8, model=2)`` (4 × 2) for the tensor-parallel forward and step, and as
``(8/n) × n`` for the expert-parallel layer at n = 2, 4 and 8.  The JAX side runs the same seeded inputs on
the suite's 8 CPU devices with dropout off.  Held: the train forward within 1e-5·max(1, max|s|), the step's
loss within 1e-5 relative, its gradients within 1e-4·max(1, max|g|) and the parameters after one Adam step
within 1e-5·max(1, max|p|), every leaf moved; the layouts leaf for leaf against JAX's ``PartitionSpec``s; the
expert-parallel layer and its gradients within 1e-6·max(1, max|·|); ``train_data_parallel(tensor_parallel=True)`` on a 2 × 2 grid against
JAX's on ``cpu_mesh(4, model=2)`` (histories within 1e-5 relative), and against the port's data-only run at
the same seed with dropout on (a split layer takes its slice of the data rank's mask).  The one-process forms
(``parallel.mesh.VirtualAxis``: what ``chip_smoke.py`` drives on one card) are held to the unsplit layers.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_pp_ranks as RANKS
from cvml_goalnet_tpu.models.avm import avm_apply as jax_avm_apply
from cvml_goalnet_tpu.models.moe import moe_apply as jax_moe_apply
from cvml_goalnet_tpu.models.moe import moe_init
from cvml_goalnet_tpu.parallel.dp import make_dp_train_step as jax_dp_step
from cvml_goalnet_tpu.parallel.ep import moe_apply_expert_parallel as jax_ep
from cvml_goalnet_tpu.parallel.mesh import cpu_mesh
from cvml_goalnet_tpu.parallel.sharding import fusion_param_shardings as jax_fusion_shardings
from cvml_goalnet_tpu.parallel.sharding import place_params as jax_place_params
from cvml_goalnet_tpu.parallel.sharding import shard_batch as jax_shard_batch
from cvml_goalnet_tpu.parallel.sharding import transformer_param_shardings as jax_transformer_shardings
from cvml_goalnet_tpu.train.state import create_train_state as jax_train_state
from cvml_goalnet_tpu_torch import weights as W
from cvml_goalnet_tpu_torch.config import PipelineConfig
from cvml_goalnet_tpu_torch.models.avm import fusion_train_apply
from cvml_goalnet_tpu_torch.parallel import ep as EP
from cvml_goalnet_tpu_torch.parallel import sharding as S
from cvml_goalnet_tpu_torch.parallel.launch import spawn_ranks
from cvml_goalnet_tpu_torch.parallel.mesh import VirtualAxis, serving_mesh
from cvml_goalnet_tpu_torch.train.optim import tree_leaves, tree_map, tree_unflatten
from test_torch_pp import adam_close
from test_torch_reference_checkpoints import _leaves

N = 16                      # the global batch of the tensor-parallel step
DIN, DOUT, E, TOKENS = 24, 16, 8, 32   # tests/test_moe.py's layer
CPU = "cpu"


def _jcfg(small_cfg, **model):
    return dataclasses.replace(small_cfg, model=dataclasses.replace(small_cfg.model, dropout_rate=0.0, **model))


def _port(jcfg) -> PipelineConfig:
    return PipelineConfig.from_json(jcfg.to_json())


def _batch(cfg, n=N, seed=0):
    rng = np.random.default_rng(seed)
    return {"visual": rng.random((n, *cfg.preprocess.frame_size, 3)).astype(np.float32),
            "audio": rng.random((n, cfg.audio.bin_length, cfg.audio.n_mfcc)).astype(np.float32),
            "labels": rng.integers(1, 6, n).astype(np.float32)}


def _moe(seed=0, e=E):
    return jax.tree.map(np.asarray, moe_init(jax.random.PRNGKey(seed), DIN, DOUT, e))


def _x(seed=1):
    return np.array(jax.random.normal(jax.random.PRNGKey(seed), (TOKENS, DIN)))


def _tgt():
    return np.asarray(jax.random.normal(jax.random.PRNGKey(5), (TOKENS, DOUT)))


def _close(got, want, rel: float, what: str):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(1.0, float(np.abs(want).max())), err_msg=what)


def _trees_close(got, want, rel: float):
    gw, gg = dict(_leaves(want)), dict(_leaves(got))
    assert gw.keys() == gg.keys()
    scale = max(1.0, max(float(np.abs(np.asarray(g)).max()) for g in gw.values()))
    for k in gw:
        np.testing.assert_allclose(np.asarray(gg[k]), np.asarray(gw[k]), rtol=0, atol=rel * scale, err_msg=k)


# ------------------------------------------------------------------ the ranks: one world of 8


def _cases(small_cfg) -> dict:
    jcfg = _jcfg(small_cfg)
    js = jax_train_state(jax.random.PRNGKey(0), jcfg)
    tree = {"params": jax.tree.map(np.asarray, js.params), "model_state": jax.tree.map(np.asarray, js.model_state)}
    grid = (("data", 4), ("model", 2))
    c = {"tp_forward": {"kind": "tp_forward", "axes": grid, "cfg": _port(jcfg), **tree, **_batch(jcfg)},
         "tp_step": {"kind": "tp_step", "axes": grid, "cfg": _port(jcfg), **tree, **_batch(jcfg, seed=1)}}
    for n in (2, 4, 8):
        c[f"ep_{n}"] = {"kind": "ep", "axes": (("data", 8 // n), ("model", n)), "params": _moe(), "x": _x(),
                        "tgt": _tgt(), "top_k": 2}
    c["imports"] = {"kind": "imports"}
    return c


@pytest.fixture(scope="module")
def runs(small_cfg):
    """{case name: (its inputs, the port's rank 0 result)}, and the ranks' imports; spawned once."""
    cases = _cases(small_cfg)
    ranks = spawn_ranks(RANKS.run_cases, serving_mesh(8, device=CPU), (list(cases.values()),))
    out = {name: (case, got) for (name, case), got in zip(cases.items(), ranks[0])}
    out["imports"] = (None, [r[list(cases).index("imports")] for r in ranks])
    return out


def _jax_tp_state(small_cfg):
    jcfg = _jcfg(small_cfg)
    return jcfg, jax_train_state(jax.random.PRNGKey(0), jcfg)


def test_tensor_parallel_forward_matches_jax(runs, small_cfg):
    """The train forward with the fusion split over the model axis of a 4 × 2 grid (batchnorm over each data
    rank's group, the global batch) against JAX's train forward on TP-placed parameters over ``cpu_mesh(8,
    model=2)``."""
    case, got = runs["tp_forward"]
    jcfg, js = _jax_tp_state(small_cfg)
    mesh = cpu_mesh(8, model=2)

    def fwd(params):
        out, _ = jax_avm_apply(params, js.model_state, jnp.asarray(case["visual"]), jnp.asarray(case["audio"]),
                               None, cfg=jcfg.model, train=True, rng=jax.random.PRNGKey(0))
        return out

    want = np.asarray(jax.jit(fwd)(jax_place_params(js.params, mesh, tensor_parallel=True)))
    assert got["out"].shape == want.shape
    _close(got["out"], want, 1e-5, "preds")


def jax_tp_step(jcfg, js, case, mesh):
    """JAX's gradient of the global batch's loss (numpy) and its tensor-parallel step once over ``mesh`` → (grads,
    the tree after Adam, the loss)."""
    vis, aud, lab = (jnp.asarray(case[k]) for k in ("visual", "audio", "labels"))

    def loss_fn(p):
        preds, _ = jax_avm_apply(p, js.model_state, vis, aud, None, cfg=jcfg.model, train=True,
                                 rng=jax.random.PRNGKey(0))
        return jnp.mean((preds[:, 0] - lab) ** 2)

    grads = jax.tree.map(np.asarray, jax.grad(loss_fn)(js.params))
    p, _, _, loss = jax_dp_step(jcfg, mesh, tensor_parallel=True)(
        jax_place_params(js.params, mesh, tensor_parallel=True), js.model_state, js.opt_state,
        *(jax_shard_batch(mesh, x) for x in (vis, aud, lab)), jax.random.PRNGKey(1))
    return grads, jax.tree.map(np.asarray, p), float(loss)


def test_tensor_parallel_step_matches_jax(runs, small_cfg):
    """``make_dp_train_step(tensor_parallel=True)`` once on a 4 × 2 grid against JAX's on ``cpu_mesh(8,
    model=2)``: the loss within 1e-5 relative, the (gathered) gradients within 1e-4·max(1, max|g|) of the
    global batch's, the gathered parameters after Adam within 1e-5·max(1, max|p|) where the gradient is not
    rounding noise, every leaf moved (``test_torch_pp.adam_close``)."""
    case, got = runs["tp_step"]
    jcfg, js = _jax_tp_state(small_cfg)
    start = jax.tree.map(np.asarray, js.params)
    grads, p, loss = jax_tp_step(jcfg, js, case, cpu_mesh(8, model=2))
    assert abs(got["loss"] - loss) <= 1e-5 * abs(loss)
    assert got["loss_step"] == got["loss"] and got["opt_step"] == 1
    _trees_close(got["grads"], grads, 1e-4)
    adam_close(got["params"], p, start, grads, jcfg.train.learning_rate)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_expert_parallel_matches_jax(runs, n):
    """The layer over n expert shards against JAX's single-device layer and its expert-parallel one over
    ``cpu_mesh(8, model=n)``, and (the sum over the axis of each rank's share of the loss) its gradients against
    ``jax.grad`` of the single-device layer: all within 1e-6·max(1, max|·|)."""
    case, got = runs[f"ep_{n}"]
    x, tgt = jnp.asarray(case["x"]), jnp.asarray(case["tgt"])
    _close(got["out"], jax_moe_apply(case["params"], x, 2), 1e-6, "out vs moe_apply")
    _close(got["out"], jax_ep(case["params"], x, cpu_mesh(8, model=n), "model", top_k=2), 1e-6, "out vs EP")
    grads = jax.grad(lambda p: jnp.mean((jax_moe_apply(p, x, 2) - tgt) ** 2))(case["params"])
    _trees_close(got["grads"], jax.tree.map(np.asarray, grads), 1e-6)


def test_spawned_ranks_import_no_jax(runs):
    _, got = runs["imports"]
    assert [r["forbidden"] for r in got] == [[]] * 8


def test_indivisible_experts_raise_as_jax():
    p = _moe(e=6)
    with pytest.raises(ValueError, match="divisible") as want:
        jax_ep(p, _x(), cpu_mesh(8, model=8), "model")
    with pytest.raises(ValueError) as got:
        EP.moe_apply_expert_parallel(W.tree_from_jax(p, device=CPU), torch.as_tensor(_x()), VirtualAxis(8))
    assert str(got.value) == str(want.value)


# ------------------------------------------------------------------ layouts


def _spec_dims(tree):
    """JAX's NamedSharding tree → the port's layout: the dimension a leaf splits along over "model", or None."""
    def dim(sh):
        axes = [i for i, a in enumerate(sh.spec) if a == "model"]
        return axes[0] if axes else None

    return jax.tree.map(dim, tree, is_leaf=lambda x: hasattr(x, "spec"))


@pytest.mark.parametrize("moe", [0, 4])
def test_fusion_shardings_match_jax(small_cfg, moe):
    """Leaf for leaf the dimension JAX's ``fusion_param_shardings`` splits over "model" (column-parallel first
    hidden layer, whole last layer, whole MoE layer)."""
    jcfg = _jcfg(small_cfg, fusion_moe_experts=moe)
    js = jax_train_state(jax.random.PRNGKey(0), jcfg)
    got = S.fusion_param_shardings(W.tree_from_jax(js.params, device=CPU))
    want = _spec_dims(jax_fusion_shardings(js.params, cpu_mesh(8, model=2)))
    assert dict(_leaves(got)) == {k: v for k, v in _leaves(want)}
    assert isinstance(got["fusion"], list)
    assert got["fusion"][-1] == {"w": None, "b": None}
    assert got["fusion"][0] == ({"w": S.COLS, "b": 0} if not moe else S.replicated(js.params["fusion"][0]))


def test_transformer_shardings_match_jax():
    from cvml_goalnet_tpu.models.temporal_attention import temporal_transformer_init

    p = jax.tree.map(np.asarray, temporal_transformer_init(jax.random.PRNGKey(0), 12, model_dim=16, num_layers=2,
                                                           num_heads=2, max_len=32))
    got = S.transformer_param_shardings(W.tree_from_jax(p, device=CPU))
    want = _spec_dims(jax_transformer_shardings(p, cpu_mesh(8, model=2)))
    assert dict(_leaves(got)) == dict(_leaves(want))


def test_model_shard_and_place_params_round_trip(small_cfg):
    js = jax_train_state(jax.random.PRNGKey(0), _jcfg(small_cfg))
    params = W.tree_from_jax(js.params, device=CPU)
    layout = S.fusion_param_shardings(params)
    from cvml_goalnet_tpu_torch.parallel.mesh import Axis

    slices = [S.place_params(js.params, Axis(None, (0, 1), i), tensor_parallel=True, device=CPU) for i in (0, 1)]
    assert tuple(slices[1]["fusion"][0]["w"].shape) == (params["fusion"][0]["w"].shape[0],
                                                         params["fusion"][0]["w"].shape[1] // 2)
    whole = tree_map(lambda a, b, dim: a if dim is None else torch.cat([a, b], dim), slices[0], slices[1], layout)
    for (k, a), (_, b) in zip(_leaves(whole), _leaves(params)):
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=k)
    assert S.shard_batch(np.arange(8), Axis(None, (0, 1, 2, 3), 2)).tolist() == [4, 5]
    with pytest.raises(ValueError, match="does not split over the 3 devices"):
        S.batch_sharding(8, Axis(None, (0, 1, 2), 0))


# ------------------------------------------------------------------ the one-process forms


@pytest.mark.parametrize("moe", [0, 4])
def test_virtual_tensor_parallel_fusion_is_the_unsplit_layer(small_cfg, moe):
    """``fusion_train_apply`` over 2 virtual model ranks (dropout on, both from one seeded generator) against
    the unsplit MLP: the output and every gradient within 1e-5·max(1, max|·|); an MoE first layer stays whole
    and its row-parallel successor takes its slice of the input."""
    jcfg = dataclasses.replace(small_cfg, model=dataclasses.replace(small_cfg.model, fusion_moe_experts=moe))
    cfg = _port(jcfg)
    js = jax_train_state(jax.random.PRNGKey(0), jcfg)
    layers = W.tree_from_jax(js.params["fusion"], device=CPU)
    x = torch.as_tensor(np.random.default_rng(3).standard_normal((20, layers[0]["gate"]["w"].shape[0] if moe
                                                                    else layers[0]["w"].shape[0])).astype(np.float32))
    outs, grads = [], []
    for tp in (None, VirtualAxis(2)):
        leaves = [t.clone().requires_grad_() for t in tree_leaves(layers)]
        tracked = tree_unflatten(layers, leaves)
        held = tracked if tp is None else [S.model_shard({"fusion": tracked}, S.fusion_param_shardings(
            {"fusion": tracked}), i, 2)["fusion"] for i in tp.lanes]
        gen = torch.Generator().manual_seed(9)
        with torch.enable_grad():
            y, _ = fusion_train_apply(held, x, cfg.model, gen, tp)
            grads.append(torch.autograd.grad((y * y).sum(), leaves))
        outs.append(y.detach())
    assert cfg.model.dropout_rate > 0
    _close(outs[1].numpy(), outs[0].numpy(), 1e-5, "out")
    for a, b in zip(grads[1], grads[0]):
        _close(a.numpy(), b.numpy(), 1e-5, "grad")


def test_virtual_expert_parallel_is_the_layer():
    from cvml_goalnet_tpu_torch.models.moe import moe_apply

    p = W.tree_from_jax(_moe(), device=CPU)
    x = torch.as_tensor(_x())
    _close(EP.moe_apply_expert_parallel(p, x, VirtualAxis(4), 2).numpy(), moe_apply(p, x, 2).numpy(), 1e-6, "out")


# ------------------------------------------------------------------ the loop


def _items(jcfg, lengths):
    from test_torch_dp import _items as dp_items

    return dp_items(jcfg, lengths)


def _loop(cfg, ttrain, tval, state, mesh, model: int = 1, **kw):
    """The port's loop over ``mesh`` with ``cfg.mesh`` set to its ``data × model`` grid."""
    from cvml_goalnet_tpu_torch.config import MeshConfig
    from cvml_goalnet_tpu_torch.data.dataset import VideoDataset as TDS
    from cvml_goalnet_tpu_torch.train.dp_loop import train_data_parallel

    cfg = dataclasses.replace(cfg, mesh=MeshConfig(data=len(mesh) // model, model=model))
    return train_data_parallel(cfg, TDS(ttrain), TDS(tval), state, num_epochs=2, global_batch=8, mesh=mesh,
                               verbose=False, **kw)


def _port_state(js):
    from cvml_goalnet_tpu_torch.train.optim import adam_init
    from cvml_goalnet_tpu_torch.train.state import TrainState

    params, model_state = W.from_jax(js.params, js.model_state, device=CPU)
    return TrainState(params, model_state, adam_init(params), 0)


def test_dp_loop_with_tensor_parallel_matches_jax(small_cfg):
    """``train_data_parallel(tensor_parallel=True)`` on a 2 × 2 grid against JAX's on ``cpu_mesh(4, model=2)``:
    two epochs, every history entry within 1e-5 relative, the final parameters within 1e-5·max(1, max|p|),
    every leaf moved."""
    from cvml_goalnet_tpu.data.dataset import VideoDataset as JDS
    from cvml_goalnet_tpu.train.dp_loop import train_data_parallel as jax_loop

    jcfg = dataclasses.replace(_jcfg(small_cfg), train=dataclasses.replace(small_cfg.train, eps=1e-4))
    (jtrain, ttrain), (jval, tval) = _items(jcfg, (16, 16)), _items(jcfg, (12,))
    js = jax_train_state(jax.random.PRNGKey(0), jcfg)
    start = jax.tree.map(np.asarray, js.params)
    jfinal, jhist = jax_loop(jcfg, JDS(jtrain), JDS(jval), js, num_epochs=2, global_batch=8,
                             mesh=cpu_mesh(4, model=2), tensor_parallel=True, verbose=False)
    final, hist = _loop(_port(jcfg), ttrain, tval, _port_state(js), serving_mesh(4, device=CPU), model=2,
                        tensor_parallel=True)
    assert final.epoch == jfinal.epoch == 2 and final.opt_state.step == int(jfinal.opt_state.step)
    for k in ("train_loss", "val_loss", "val_f_avg", "val_f_max"):
        assert len(hist[k]) == 2, k
        np.testing.assert_allclose(hist[k], jhist[k], rtol=1e-5, err_msg=k)
    adam_close(tree_map(torch.Tensor.numpy, final.params), jax.tree.map(np.asarray, jfinal.params), start)


def test_tensor_parallel_run_is_the_data_only_run(small_cfg):
    """With dropout on, the 2 × 2 tensor-parallel loop equals the port's 2-rank data-only loop at the same seed
    (each data rank's mask, a split layer its slice of it): histories within 1e-5 relative, parameters and
    Adam's moments within 1e-5·max(1, max|·|)."""
    jcfg = dataclasses.replace(small_cfg, train=dataclasses.replace(small_cfg.train, eps=1e-4))
    assert jcfg.model.dropout_rate > 0
    (_, ttrain), (_, tval) = _items(jcfg, (16, 16)), _items(jcfg, (12,))
    js = jax_train_state(jax.random.PRNGKey(0), jcfg)
    runs = [_loop(_port(jcfg), ttrain, tval, _port_state(js), serving_mesh(n, device=CPU), model=m,
                  tensor_parallel=m > 1) for n, m in ((4, 2), (2, 1))]
    (tp_final, tp_hist), (dp_final, dp_hist) = runs
    for k in ("train_loss", "val_loss", "val_f_avg", "val_f_max"):
        np.testing.assert_allclose(tp_hist[k], dp_hist[k], rtol=1e-5, err_msg=k)
    for a, b in ((tp_final.params, dp_final.params), (tp_final.opt_state.mu, dp_final.opt_state.mu),
                 (tp_final.opt_state.nu, dp_final.opt_state.nu)):
        _trees_close(tree_map(torch.Tensor.numpy, a), tree_map(torch.Tensor.numpy, b), 1e-5)


def test_no_card_and_no_device_raises(small_cfg, monkeypatch):
    """No fallback: with no card and no explicit device the tensor-parallel loop and the ``(data, model)``
    mesh raise before any rank starts (the spawned ranks would otherwise join on gloo)."""
    from cvml_goalnet_tpu_torch.config import MeshConfig
    from cvml_goalnet_tpu_torch.data.dataset import VideoDataset as TDS
    from cvml_goalnet_tpu_torch.parallel.mesh import build_mesh, cp_world
    from cvml_goalnet_tpu_torch.train.dp_loop import train_data_parallel

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _port(dataclasses.replace(small_cfg, mesh=MeshConfig(data=2, model=2)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_mesh(cfg.mesh)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cp_world(None, 2)
    _, ttrain = _items(_jcfg(small_cfg), (16,))
    js = jax_train_state(jax.random.PRNGKey(0), _jcfg(small_cfg))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_data_parallel(cfg, TDS(ttrain), TDS([]), _port_state(js), tensor_parallel=True)
