"""PyTorch port: ``train/orbax_io.py`` against the JAX package's orbax backend (``cvml_goalnet_tpu/train/orbax_io.py``).

Each case of ``tests/test_orbax.py`` on the port's side, and the checkpoints
crossing between the packages: JAX's ``load_checkpoint_orbax`` restores what
the port writes (the plain per-array layout) bit for bit, onto one device and
onto the suite's 8-device mesh; the port restores what JAX writes (its OCDBT
store with zstd chunks, orbax's ``use_ocdbt=False`` layout, checkpoints
written from 8- and 4-device meshes whose leaves have several chunks) bit
for bit against JAX's own restore.  The JAX trees are built from the port's
numpy draws (``jax.numpy.asarray``), not by JAX's ``create_train_state``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvml_goalnet_tpu.train import orbax_io as JO
from cvml_goalnet_tpu.train.optim import AdamState as JAdam
from cvml_goalnet_tpu.train.state import TrainState as JState
from cvml_goalnet_tpu_torch import cli
from cvml_goalnet_tpu_torch.compat import zarr2
from cvml_goalnet_tpu_torch.compat.ocdbt import OcdbtStore
from cvml_goalnet_tpu_torch.config import PipelineConfig
from cvml_goalnet_tpu_torch.train.checkpoint import CheckpointMismatchError, load_checkpoint
from cvml_goalnet_tpu_torch.train.optim import AdamState, tree_map
from cvml_goalnet_tpu_torch.train.orbax_io import _leaves, load_checkpoint_orbax, save_checkpoint_orbax
from cvml_goalnet_tpu_torch.train.state import TrainState, create_train_state

CPU = "cpu"
FIXTURE = os.path.join(os.path.dirname(__file__), "data", "orbax_small")


def _pcfg(jcfg) -> PipelineConfig:
    return PipelineConfig.from_json(jcfg.to_json())


def _state(jcfg, seed: int, epoch: int = 0) -> TrainState:
    """A port state on the CPU with drawn Adam moments (so no leaf is all zeros), step 5."""
    st = create_train_state(seed, _pcfg(jcfg), device=CPU)
    g = torch.Generator().manual_seed(seed)
    mu = tree_map(lambda p: torch.randn(p.shape, generator=g) * 1e-3, st.params)
    nu = tree_map(lambda p: torch.rand(p.shape, generator=g) * 1e-6, st.params)
    return st._replace(opt_state=AdamState(step=5, mu=mu, nu=nu), epoch=epoch)


def _jax_state(st: TrainState) -> JState:
    to = lambda t: jnp.asarray(t.numpy())   # noqa: E731
    return JState(params=tree_map(to, st.params), model_state=tree_map(to, st.model_state),
                  opt_state=JAdam(step=jnp.asarray(st.opt_state.step, dtype=jnp.int32),
                                  mu=tree_map(to, st.opt_state.mu), nu=tree_map(to, st.opt_state.nu)),
                  epoch=st.epoch)


def _flat(st) -> dict:
    """{key path: numpy array} over params, batchnorm state, Adam's moments and step, for either package."""
    tree = {"params": st.params, "model_state": st.model_state, "mu": st.opt_state.mu, "nu": st.opt_state.nu,
            "step": st.opt_state.step}
    if isinstance(st, JState):
        flat, _ = jax.tree_util.tree_flatten_with_path(tree)
        return {tuple(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): np.asarray(v) for path, v in flat}
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v, dtype=np.int32))
            for k, _, v in _leaves(tree)}


def _bit_equal(got, want) -> None:
    a, b = _flat(got), _flat(want)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k].reshape(-1).view(np.uint8), b[k].reshape(-1).view(np.uint8), err_msg=str(k))
    assert got.epoch == want.epoch


@pytest.fixture(scope="module")
def mesh_checkpoints(tmp_path_factory, small_cfg):
    """Checkpoints JAX's ``save_checkpoint_orbax`` writes from the suite's 8-device mesh and from a 4-device
    one, the params in the shardings ``place_params(tensor_parallel=True)`` gives them, as ``tests/test_orbax.py``
    places them (assembled shard by shard from the host arrays, which spares a resharding compile per leaf)."""
    from cvml_goalnet_tpu.parallel.mesh import cpu_mesh
    from cvml_goalnet_tpu.parallel.sharding import fusion_param_shardings

    root = tmp_path_factory.mktemp("mesh_orbax")
    st = _jax_state(_state(small_cfg, 0))
    out = {}
    for n, epoch in ((8, 5), (4, 2)):
        params = jax.tree_util.tree_map(
            lambda x, sh: jax.make_array_from_callback(x.shape, sh, lambda idx, a=np.asarray(x): a[idx]),
            st.params, fusion_param_shardings(st.params, cpu_mesh(n)))
        JO.save_checkpoint_orbax(str(root / f"mesh{n}"), st._replace(params=params, epoch=epoch), small_cfg)
        out[n] = (str(root / f"mesh{n}"), st._replace(epoch=epoch))
    return out


class TestOrbaxCheckpoint:
    def test_roundtrip_full_state(self, small_cfg, tmp_path):
        st = _state(small_cfg, 0, epoch=7)
        save_checkpoint_orbax(str(tmp_path), st, _pcfg(small_cfg), tag="opt")
        got = load_checkpoint_orbax(str(tmp_path), create_train_state(1, _pcfg(small_cfg), device=CPU), tag="opt")
        _bit_equal(got, st)
        assert got.epoch == 7 and got.opt_state.step == 5 and isinstance(got.opt_state.step, int)
        meta = json.loads((tmp_path / "opt_orbax" / "_METADATA").read_text())
        assert meta["use_ocdbt"] is False and len(meta["tree_metadata"]) == 86
        assert meta["tree_metadata"]["('opt_state', 'mu', 'fusion', '0', 'b')"]["key_metadata"][3] == {
            "key": "0", "key_type": 1}

    @pytest.mark.parametrize("case", ["shape", "missing", "extra"])
    def test_mismatched_config_raises(self, small_cfg, tmp_path, case):
        """A leaf of another shape (another fusion width), a leaf the checkpoint lacks (the text branch on in
        the template only), a leaf the template lacks (on in the checkpoint only): JAX's error."""
        text = dataclasses.replace(small_cfg, model=dataclasses.replace(small_cfg.model, text_included=True))
        other = {"shape": dataclasses.replace(small_cfg, model=dataclasses.replace(small_cfg.model,
                                                                                   fusion_hidden=(24, 12))),
                 "missing": text, "extra": small_cfg}[case]
        saved = text if case == "extra" else small_cfg
        save_checkpoint_orbax(str(tmp_path), _state(saved, 0), _pcfg(saved))
        with pytest.raises(CheckpointMismatchError, match="does not match the current config"):
            load_checkpoint_orbax(str(tmp_path), create_train_state(1, _pcfg(other), device=CPU))

    def test_missing_checkpoint_raises_filenotfound(self, small_cfg, tmp_path):
        with pytest.raises(FileNotFoundError):
            load_checkpoint_orbax(str(tmp_path), create_train_state(0, _pcfg(small_cfg), device=CPU))


class TestReadsJaxMeshCheckpoints:
    """``test_orbax.py``'s two sharded cases on the port's side: checkpoints JAX writes from the 8- and 4-device
    meshes, whose leaves orbax cuts into several chunks, restored bit-equal to JAX's own restore."""

    @pytest.mark.parametrize("n", [8, 4])
    def test_reads_a_checkpoint_written_from_a_mesh(self, mesh_checkpoints, small_cfg, n):
        import tensorstore as ts

        directory, want = mesh_checkpoints[n]
        got = load_checkpoint_orbax(directory, create_train_state(1, _pcfg(small_cfg), device=CPU))
        _bit_equal(got, JO.load_checkpoint_orbax(directory, want))
        _bit_equal(got, want)
        path = os.path.join(directory, "ckp_orbax")
        store = OcdbtStore(path)
        kv = ts.KvStore.open({"driver": "ocdbt", "base": {"driver": "file", "path": path + "/"}}).result()
        keys = kv.list().result()
        assert store.list() == sorted(keys)
        assert all(store.read(k) == kv.read(k).result().value for k in keys)
        zarrays = [json.loads(store.read(k)) for k in keys if k.endswith(b"/.zarray")]
        assert sum(z["chunks"] != z["shape"] for z in zarrays) >= 20   # multi-chunk leaves


class TestOrbaxAtomicity:
    def test_overwrite_keeps_latest(self, small_cfg, tmp_path):
        cfg = _pcfg(small_cfg)
        st = _state(small_cfg, 0)
        save_checkpoint_orbax(str(tmp_path), st._replace(epoch=1), cfg)
        save_checkpoint_orbax(str(tmp_path), st._replace(epoch=2), cfg)
        assert load_checkpoint_orbax(str(tmp_path), create_train_state(1, cfg, device=CPU)).epoch == 2
        assert sorted(os.listdir(tmp_path)) == ["ckp_orbax", "ckp_orbax_manifest.json"]

    def test_load_recovers_interrupted_swap(self, small_cfg, tmp_path):
        cfg = _pcfg(small_cfg)
        st = _state(small_cfg, 0, epoch=5)
        save_checkpoint_orbax(str(tmp_path), st, cfg)
        os.rename(str(tmp_path / "ckp_orbax"), str(tmp_path / "ckp_orbax.old"))
        _bit_equal(load_checkpoint_orbax(str(tmp_path), create_train_state(1, cfg, device=CPU)), st)
        # read-only: renaming .old back here could race a live save's two-rename swap
        assert not os.path.isdir(str(tmp_path / "ckp_orbax")) and os.path.isdir(str(tmp_path / "ckp_orbax.old"))

    def test_save_recovers_interrupted_swap(self, small_cfg, tmp_path):
        cfg = _pcfg(small_cfg)
        st = _state(small_cfg, 0)
        save_checkpoint_orbax(str(tmp_path), st._replace(epoch=5), cfg)
        os.rename(str(tmp_path / "ckp_orbax"), str(tmp_path / "ckp_orbax.old"))
        os.makedirs(str(tmp_path / "ckp_orbax.new"))   # debris of the interrupted save
        save_checkpoint_orbax(str(tmp_path), st._replace(epoch=6), cfg)
        assert load_checkpoint_orbax(str(tmp_path), create_train_state(1, cfg, device=CPU)).epoch == 6
        assert sorted(os.listdir(tmp_path)) == ["ckp_orbax", "ckp_orbax_manifest.json"]

    def test_restores_pre_round3_checkpoint_without_epoch_leaf(self, small_cfg, tmp_path):
        """A payload without the epoch leaf, written by orbax as JAX wrote it before round 3: the epoch comes
        from the manifest."""
        import orbax.checkpoint as ocp

        st = _state(small_cfg, 0)
        js = _jax_state(st)
        with ocp.PyTreeCheckpointer() as ckptr:
            ckptr.save(str(tmp_path / "ckp_orbax"), {"params": js.params, "model_state": js.model_state,
                                                     "opt_state": js.opt_state._asdict()})
        (tmp_path / "ckp_orbax_manifest.json").write_text(json.dumps({"epoch": 4, "config": json.loads(
            small_cfg.to_json())}))
        got = load_checkpoint_orbax(str(tmp_path), create_train_state(1, _pcfg(small_cfg), device=CPU))
        _bit_equal(got, st._replace(epoch=4))

    def test_epoch_rides_in_payload_not_manifest(self, small_cfg, tmp_path):
        cfg = _pcfg(small_cfg)
        save_checkpoint_orbax(str(tmp_path), _state(small_cfg, 0, epoch=9), cfg)
        mpath = tmp_path / "ckp_orbax_manifest.json"
        manifest = json.loads(mpath.read_text())
        manifest["epoch"] = 1   # the manifest lies
        mpath.write_text(json.dumps(manifest))
        assert load_checkpoint_orbax(str(tmp_path), create_train_state(1, cfg, device=CPU)).epoch == 9


class TestOrbaxInTrainLoop:
    def test_train_loop_with_orbax_backend(self, small_cfg, tmp_path):
        from tests.test_torch_summarization_train import TDS, _items
        from cvml_goalnet_tpu_torch.train.loop import train_importance_model

        cfg = _pcfg(small_cfg)
        st = create_train_state(0, cfg, device=CPU)
        _, items = _items(small_cfg, [(10, 0)])
        train_importance_model(cfg, TDS(items), TDS([]), st, num_epochs=1, checkpoint_dir=str(tmp_path),
                               verbose=False, checkpoint_backend="orbax")
        assert os.path.isdir(str(tmp_path / "ckp_orbax")) and os.path.isdir(str(tmp_path / "opt_orbax"))
        assert not any(n.endswith(".npz") for n in os.listdir(tmp_path))
        assert load_checkpoint_orbax(str(tmp_path), st, tag="ckp").epoch >= 1

    def test_unknown_backend_raises(self, small_cfg):
        from cvml_goalnet_tpu_torch.train.loop import train_importance_model

        st = create_train_state(0, _pcfg(small_cfg), device=CPU)
        with pytest.raises(ValueError, match="checkpoint_backend"):
            train_importance_model(_pcfg(small_cfg), [], [], st, num_epochs=1, checkpoint_backend="protobuf")
        with pytest.raises(ValueError, match="async_checkpoint currently supports the npz backend only"):
            train_importance_model(_pcfg(small_cfg), [], [], st, num_epochs=1, checkpoint_backend="orbax",
                                   async_checkpoint=True)


class TestCLITrunkLoading:
    """``cli._load_trunk``: an incomplete orbax checkpoint fails hard; none at all is ``FileNotFoundError``."""

    def test_missing_orbax_manifest_fails_hard(self, small_cfg, tmp_path):
        cfg = _pcfg(small_cfg)
        st = create_train_state(0, cfg, device=CPU)
        save_checkpoint_orbax(str(tmp_path), st, cfg, tag="opt")
        os.remove(str(tmp_path / "opt_orbax_manifest.json"))
        args = types.SimpleNamespace(checkpoint_backend=None)
        with pytest.raises(CheckpointMismatchError, match="incomplete"):
            cli._load_trunk({"ckp_dir": str(tmp_path)}, st, args, tags=("opt",))

    def test_no_checkpoint_at_all_raises_filenotfound(self, small_cfg, tmp_path):
        st = create_train_state(0, _pcfg(small_cfg), device=CPU)
        with pytest.raises(FileNotFoundError):
            cli._load_trunk({"ckp_dir": str(tmp_path)}, st, types.SimpleNamespace(checkpoint_backend=None),
                            tags=("opt",))


class TestAcrossPackages:
    def test_jax_restores_the_ports_checkpoint_bit_for_bit(self, small_cfg, tmp_path):
        """JAX's ``load_checkpoint_orbax`` reads the port's plain layout onto one device and, with a template
        placed by ``place_params``, onto the suite's 8-device mesh in the template's shardings."""
        from cvml_goalnet_tpu.parallel.mesh import cpu_mesh
        from cvml_goalnet_tpu.parallel.sharding import place_params

        st = _state(small_cfg, 3, epoch=6)
        save_checkpoint_orbax(str(tmp_path), st, _pcfg(small_cfg), tag="opt")
        tpl = _jax_state(_state(small_cfg, 4))
        _bit_equal(JO.load_checkpoint_orbax(str(tmp_path), tpl, tag="opt"), st)
        mesh_tpl = tpl._replace(params=place_params(tpl.params, cpu_mesh(8), tensor_parallel=True))
        got = JO.load_checkpoint_orbax(str(tmp_path), mesh_tpl, tag="opt")
        _bit_equal(got, st)
        pairs = zip(jax.tree_util.tree_leaves(mesh_tpl.params), jax.tree_util.tree_leaves(got.params))
        assert all(r.sharding.is_equivalent_to(t.sharding, r.ndim) for t, r in pairs)
        assert any(len(r.sharding.device_set) > 1 for r in jax.tree_util.tree_leaves(got.params))

    @pytest.mark.parametrize("layout", ["plain", "ocdbt-uncompressed"])
    def test_port_restores_jax_layouts(self, small_cfg, tmp_path, layout):
        """orbax's ``use_ocdbt=False`` layout (a directory per leaf, zstd chunks) and an OCDBT store without
        compression, each written by JAX's orbax from the JAX payload, restored bit-equal to JAX's restore.
        (The OCDBT store with zstd chunks JAX's backend writes by default is the committed fixture, below.)"""
        import orbax.checkpoint as ocp

        st = _state(small_cfg, 2, epoch=3)
        js = _jax_state(st)
        opts = {"use_ocdbt": False} if layout == "plain" else {"use_compression": False}
        with ocp.PyTreeCheckpointer(**opts) as ckptr:
            ckptr.save(str(tmp_path / "ckp_orbax"), JO._payload(js))
        (tmp_path / "ckp_orbax_manifest.json").write_text(json.dumps({"epoch": 3, "config": json.loads(
            small_cfg.to_json())}))
        meta = json.loads((tmp_path / "ckp_orbax" / "_METADATA").read_text())
        assert meta["use_ocdbt"] is (layout != "plain")
        got = load_checkpoint_orbax(str(tmp_path), create_train_state(1, _pcfg(small_cfg), device=CPU))
        _bit_equal(got, JO.load_checkpoint_orbax(str(tmp_path), _jax_state(_state(small_cfg, 4))))
        _bit_equal(got, st)

    def test_jax_written_fixture_equals_its_npz_twin(self, small_cfg):
        """The committed JAX-written checkpoint (OCDBT, zstd level 1): the port's restore equals JAX's restore and
        the npz twin, leaf for leaf and bit for bit, and ``tools/make_orbax_fixture.py`` rebuilds those leaves
        from its seed."""
        import importlib.util

        spec = importlib.util.spec_from_file_location(
            "make_orbax_fixture", os.path.join(os.path.dirname(FIXTURE), "..", "..", "tools", "make_orbax_fixture.py"))
        tool = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(tool)
        assert tool.small_config() == small_cfg
        cfg = PipelineConfig.load(os.path.join(FIXTURE, "cfg.json"))
        tpl = create_train_state(1, cfg, device=CPU)
        got = load_checkpoint_orbax(FIXTURE, tpl)
        _bit_equal(got, load_checkpoint(FIXTURE, tpl))
        rebuilt = tool.fixture_state(small_cfg)
        _bit_equal(JO.load_checkpoint_orbax(FIXTURE, rebuilt), rebuilt)
        _bit_equal(got, rebuilt)
        assert got.epoch == tool.EPOCH and got.opt_state.step == tool.STEP

    def test_head_sized_leaf(self, tmp_path):
        """One full-width head leaf (41472 × 512 random float32, 85 MB) that JAX's orbax writes into its OCDBT
        store as one zstd chunk, read back by the port's OCDBT reader, zarr v2 reader and zstd decoder."""
        import orbax.checkpoint as ocp

        w = np.random.default_rng(9).standard_normal((41472, 512)).astype(np.float32)
        with ocp.PyTreeCheckpointer() as ckptr:
            ckptr.save(str(tmp_path / "head"), {"params": {"visual": {"head": {"w": jnp.asarray(w)}}}})
        store = OcdbtStore(str(tmp_path / "head"))
        meta = zarr2.read_metadata(store, "params.visual.head.w")
        assert meta["chunks"] == [41472, 512] and meta["compressor"]["id"] == "zstd"
        np.testing.assert_array_equal(zarr2.read_array(store, "params.visual.head.w", meta), w)
        shutil.rmtree(str(tmp_path / "head"))
