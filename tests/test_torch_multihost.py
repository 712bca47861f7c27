"""PyTorch port: multi-host training (``parallel/multihost.py``) against the JAX package, on the CPU.

Two host processes (``tests/_torch_multihost_ranks.py``), each spawning two gloo ranks, join through a
``TCPStore`` at a free port: four global ranks, process-major.  Each process makes only its half of the global
batch and each rank takes its block of that half.  From one set of weights (a seeded draw in the JAX layout,
given to JAX as it is and to the ranks through ``weights.from_jax``) on ``tests/multihost_worker.py::tiny_dp_config``'s model
with dropout off (and Adam's eps at 1e-4), they run one ``make_dp_train_step`` over the world, and the same
step on the (slice, data, model) grid that ``build_multislice_mesh`` detects from the two hosts, with the gradients summed over data,
then slice.  Both processes report the same loss, within 1e-5 relative of JAX's single-process step on
``cpu_mesh(4)`` over the same global batch, and the updated parameters match JAX's within
1e-5·max(1, max|p|).  The grid's linear gradient equals JAX's ``test_dp_grads_reduce_over_slice_and_data``,
and the new collectives on the ranks' axis equal JAX's under ``shard_map``.  Then the ports of JAX's
``TestAutoDetectFallback`` cases, the single-process helpers, and the refusals: an unreachable coordinator, a
partial config, host processes with unequal local ranks.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P

from cvml_goalnet_tpu.parallel import collectives as JC
from cvml_goalnet_tpu.parallel.dp import make_dp_train_step as jax_dp_step
from cvml_goalnet_tpu.parallel.mesh import cpu_mesh as jax_cpu_mesh
from cvml_goalnet_tpu.parallel.sharding import shard_batch
from cvml_goalnet_tpu.train.optim import adam_init as jax_adam_init
from cvml_goalnet_tpu_torch import weights
from cvml_goalnet_tpu_torch.config import PipelineConfig
from cvml_goalnet_tpu_torch.parallel import multihost
from tests.multihost_worker import tiny_dp_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_multihost_ranks.py")
HOSTS, LOCAL = 2, 2
GLOBAL_BATCH = 2 * HOSTS * LOCAL
LANE_ROWS = 8   # rows of each rank's collective input: divisible by the 4 ranks for reduce_scatter


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def jax_cfg():
    """The tiny config with dropout off and Adam's eps at 1e-4: at 1e-8 an entry whose gradient is rounding
    noise moves by up to lr either way, so two sums in other orders part by lr·sign (``tests/test_torch_dp.py``
    holds those at 5e-3 instead)."""
    cfg = tiny_dp_config(HOSTS * LOCAL)
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, dropout_rate=0.0),
                               train=dataclasses.replace(cfg.train, eps=1e-4))


def global_batch(cfg, seed: int = 0):
    rng = np.random.default_rng(seed)
    return (rng.random((GLOBAL_BATCH, *cfg.preprocess.frame_size, 3)).astype(np.float32),
            rng.random((GLOBAL_BATCH, cfg.audio.bin_length, cfg.audio.n_mfcc)).astype(np.float32),
            rng.integers(1, 6, GLOBAL_BATCH).astype(np.float32))


def linear_case(seed: int = 0) -> dict:
    """The inputs of JAX's ``test_dp_grads_reduce_over_slice_and_data``."""
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((6, 1)).astype(np.float32), "x": rng.standard_normal((16, 6)).astype(np.float32),
            "y": rng.standard_normal((16,)).astype(np.float32)}


def lanes(n: int, seed: int = 3) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((n, LANE_ROWS, 3)).astype(np.float32)


def jax_collectives(x: np.ndarray) -> dict:
    """JAX's collectives under ``shard_map`` over ``x.shape[0]`` CPU devices, lane i's input ``x[i]`` → lane i's
    output of each, stacked."""
    n = x.shape[0]
    mesh = jax_cpu_mesh(n)

    def run(fn):
        body = shard_map(lambda v: fn(v[0])[None], mesh=mesh, in_specs=P("data"), out_specs=P("data"),
                         check_rep=False)
        return np.asarray(jax.jit(body)(jnp.asarray(x)))

    out = {"all_gather": run(lambda v: JC.all_gather(v)), "all_gather_tiled": run(lambda v: JC.all_gather(v, tiled=True)),
           "reduce_scatter": run(JC.reduce_scatter), "axis_index": run(lambda v: JC.axis_index()[None])[:, 0]}
    for shift in (1, -1, 2):
        out[f"ppermute_ring_{shift}"] = run(lambda v, s=shift: JC.ppermute_ring(v, shift=s))
    return out


def jax_linear_grad(case: dict) -> np.ndarray:
    def full_loss(w):
        d = (jnp.asarray(case["x"]) @ w)[:, 0] - jnp.asarray(case["y"])
        return jnp.mean(d * d)

    return np.asarray(jax.grad(full_loss)(jnp.asarray(case["w"])))


def job_of(cfg: PipelineConfig, params, model_state, batch) -> dict:
    return {"cfg": cfg, "params": params, "model_state": model_state, "global": batch, "blocks": HOSTS * LOCAL,
            "lanes": lanes(HOSTS * LOCAL), **linear_case()}


def start_hosts(tmp_path, job: dict, local_ranks) -> list:
    """``len(local_ranks)`` host processes of the worker, process p with ``local_ranks[p]`` gloo ranks, started
    → (process, output path) pairs for :func:`finish_hosts`."""
    port = free_port()
    job_fp = str(tmp_path / "job.pkl")
    with open(job_fp, "wb") as f:
        pickle.dump(job, f)
    env = {**os.environ, "PYTHONPATH": REPO}
    started = []
    for pid, local in enumerate(local_ranks):
        out = str(tmp_path / f"out{pid}.pkl")
        started.append((subprocess.Popen(
            [sys.executable, WORKER, str(pid), str(len(local_ranks)), str(port), str(local), job_fp, out],
            env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), out))
    return started


def finish_hosts(started) -> list[dict]:
    """Each started host process's output, once all have exited."""
    results = [p.communicate(timeout=240) for p, _ in started]
    for (p, _), (_, err) in zip(started, results):
        if p.returncode != 0:
            pytest.fail(f"host process failed (rc={p.returncode}):\n{err[-3000:]}")
    got = []
    for _, out in started:
        with open(out, "rb") as f:
            got.append(pickle.load(f))
    return got


@pytest.fixture(scope="module")
def two_hosts(tmp_path_factory):
    """(JAX's single-process step, the two host processes' outputs, the job); JAX runs while they do.  The one
    set of weights is a seeded draw in the JAX layout (``weights.init_params``), which both packages take."""
    jcfg = jax_cfg()
    cfg = PipelineConfig.from_json(jcfg.to_json())
    params_np, state_np = weights.init_params(cfg, 0)
    batch = global_batch(jcfg)
    job = job_of(cfg, params_np, state_np, batch)
    started = start_hosts(tmp_path_factory.mktemp("two_hosts"), job, [LOCAL] * HOSTS)
    mesh = jax_cpu_mesh(HOSTS * LOCAL)
    jparams, jstate = jax.tree.map(jnp.asarray, (params_np, state_np))
    params, model_state, _, loss = jax_dp_step(jcfg, mesh)(
        jparams, jstate, jax_adam_init(jparams), *(shard_batch(mesh, jnp.asarray(x)) for x in batch),
        jax.random.PRNGKey(1))
    want = {"loss": float(loss), "params": jax.tree.map(np.asarray, params)}
    return want, finish_hosts(started), job


def leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves(v, f"{path}/{i}")
    else:
        yield path, np.asarray(tree)


def assert_params_close(got, want) -> None:
    g, w = dict(leaves(got)), dict(leaves(want))
    assert g.keys() == w.keys()
    for k in w:
        np.testing.assert_allclose(g[k], w[k], rtol=0, atol=1e-5 * max(1.0, float(np.abs(w[k]).max())), err_msg=k)


def every_rank(out) -> list[dict]:
    return [r for host in out for r in host["ranks"]]


class TestTwoHostProcesses:
    def test_processes_and_ranks_in_order(self, two_hosts):
        _, out, _ = two_hosts
        assert [h["process_index"] for h in out] == [0, 1] and all(h["process_count"] == HOSTS for h in out)
        assert [r["rank"] for r in every_rank(out)] == list(range(HOSTS * LOCAL))
        assert all(r["world"] == HOSTS * LOCAL and r["forbidden"] == [] for r in every_rank(out))

    @pytest.mark.parametrize("kind", ["flat", "grid"])
    def test_loss_matches_jax_single_process(self, two_hosts, kind):
        want, out, _ = two_hosts
        losses = [r[kind]["loss"] for r in every_rank(out)]
        assert all(x == losses[0] for x in losses), losses   # every rank of both processes holds the same loss
        assert abs(losses[0] - want["loss"]) <= 1e-5 * abs(want["loss"])

    @pytest.mark.parametrize("kind", ["flat", "grid"])
    def test_params_match_jax_single_process(self, two_hosts, kind):
        want, out, _ = two_hosts
        ranks = every_rank(out)
        assert_params_close(ranks[0][kind]["params"], want["params"])
        for r in ranks[1:]:   # the replicated update is the same bits on every rank
            for (k, a), (_, b) in zip(leaves(r[kind]["params"]), leaves(ranks[0][kind]["params"])):
                np.testing.assert_array_equal(a, b, err_msg=k)

    def test_grid_is_two_hosts_of_two_ranks(self, two_hosts):
        _, out, _ = two_hosts
        assert all(h["grid_shape"] == {"slice": 2, "data": 2, "model": 1} for h in out)
        assert [r["grid"]["block"] for r in every_rank(out)] == [0, 1, 2, 3]

    def test_grid_gradient_matches_jax_slice_and_data_reduction(self, two_hosts):
        _, out, job = two_hosts
        want = jax_linear_grad(job)
        for r in every_rank(out):
            np.testing.assert_allclose(r["linear_grad"], want, rtol=1e-5, atol=1e-6)

    def test_collectives_on_the_ranks_match_jax(self, two_hosts):
        _, out, job = two_hosts
        want = jax_collectives(job["lanes"])
        for r in every_rank(out):
            for name, got in r["collectives"].items():
                np.testing.assert_allclose(got, want[name][r["rank"]], rtol=0, atol=1e-6, err_msg=name)

    def test_unequal_local_ranks_refused_in_every_process(self, tmp_path):
        out = finish_hosts(start_hosts(tmp_path, {"global": [np.zeros((2, 1), np.float32)]}, [1, 2]))
        for host in out:
            assert "same number of local ranks" in host["error"] and "[1, 2]" in host["error"]


class TestAutoDetectFallback:
    """JAX's ``TestAutoDetectFallback``: with no config a bare host runs single-process with a warning, but
    multi-worker hints refuse."""

    @pytest.fixture(autouse=True)
    def _bare(self, monkeypatch):
        for k in ("TPU_WORKER_HOSTNAMES", "MEGASCALE_COORDINATOR_ADDRESS", "MEGASCALE_NUM_SLICES",
                  "GOALNET_COORDINATOR", "GOALNET_NUM_PROCESSES", "GOALNET_PROCESS_ID"):
            monkeypatch.delenv(k, raising=False)
        monkeypatch.setattr(multihost, "_HOSTS", None)

    @pytest.mark.parametrize("env", [{}, {"TPU_WORKER_HOSTNAMES": "localhost"}],
                             ids=["bare_host", "single_hostname_is_not_a_pod_hint"])
    def test_warns_and_falls_back(self, monkeypatch, env):
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        with pytest.warns(UserWarning, match="single-process"):
            multihost.initialize_from_env()
        assert multihost.process_count() == 1 and multihost.process_index() == 0

    @pytest.mark.parametrize("env", [{"TPU_WORKER_HOSTNAMES": "host-0,host-1"},
                                     {"MEGASCALE_COORDINATOR_ADDRESS": "c:8476"}],
                             ids=["multi_worker_hostnames", "megascale_env"])
    def test_fails_loudly(self, monkeypatch, env):
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        with pytest.raises(RuntimeError, match="refusing"):
            multihost.initialize_from_env()


class TestSingleProcess:
    @pytest.fixture(autouse=True)
    def _fresh(self, monkeypatch):
        monkeypatch.setattr(multihost, "_HOSTS", None)

    def test_helpers(self):
        """JAX's ``test_helpers_single_process``: the host process holds every local rank's block."""
        mesh = multihost.global_data_mesh(local=4, device="cpu")
        assert mesh.size == 4 and mesh.devices == [torch.device("cpu")] * 4
        assert multihost.process_count() == 1 and multihost.process_index() == 0
        x = np.arange(4 * 3 * 2, dtype=np.float32).reshape(-1, 2)
        blocks = multihost.shard_host_batch(x, mesh)
        assert [tuple(b.shape) for b in blocks] == [(3, 2)] * 4
        np.testing.assert_array_equal(torch.cat(blocks).numpy(), x)
        np.testing.assert_array_equal(multihost.replicated_to_host([torch.tensor(x.sum())] * 4), x.sum())
        with pytest.raises(ValueError, match="axis"):
            multihost.shard_host_batch(x, mesh, axis="model")
        with pytest.raises(ValueError, match="split"):
            multihost.shard_host_batch(x[:5], mesh)

    def test_explicit_single_process_and_second_call(self, monkeypatch):
        port = free_port()
        multihost.initialize_from_env(f"127.0.0.1:{port}", 1, 0, timeout=30)
        try:
            assert multihost.process_count() == 1 and multihost.process_index() == 0
            monkeypatch.setenv("GOALNET_COORDINATOR", "127.0.0.1:1")   # a second call is a no-op: never read
            multihost.initialize_from_env()
            assert multihost._HOSTS.port == port
        finally:
            multihost.shutdown()
        assert multihost._HOSTS is None and multihost.process_count() == 1

    def test_unreachable_coordinator_raises(self):
        with pytest.raises(RuntimeError, match="could not join the coordinator"):
            multihost.initialize_from_env(f"127.0.0.1:{free_port()}", 2, 1, timeout=0.5)
        assert multihost._HOSTS is None

    @pytest.mark.parametrize("args", [("127.0.0.1:1", None, 0), (None, 2, 0), ("127.0.0.1:1", 2, 2),
                                      ("no-port", 1, 0)], ids=["no_count", "no_coordinator", "id_past_count",
                                                               "no_port"])
    def test_partial_or_bad_config_raises(self, monkeypatch, args):
        for k in ("GOALNET_COORDINATOR", "GOALNET_NUM_PROCESSES", "GOALNET_PROCESS_ID"):
            monkeypatch.delenv(k, raising=False)
        with pytest.raises(ValueError):
            multihost.initialize_from_env(*args)

    def test_reads_the_goalnet_variables(self, monkeypatch):
        port = free_port()
        monkeypatch.setenv("GOALNET_COORDINATOR", f"127.0.0.1:{port}")
        monkeypatch.setenv("GOALNET_NUM_PROCESSES", "1")
        monkeypatch.setenv("GOALNET_PROCESS_ID", "0")
        multihost.initialize_from_env(timeout=30)
        try:
            assert multihost._HOSTS.port == port and multihost.process_count() == 1
        finally:
            multihost.shutdown()
