"""PyTorch port: the reference checkpoint verbs (``compat/torch_import.py``, ``import-torch``, ``export-torch``)
against the JAX package's, on the CPU.

A reference-format ``state_dict`` (the key schema of the reference's
``state_dict()``: ``visbl.*``, ``audbl.*``, ``fusion.*``) is drawn from a
numpy seed, as ``tests/test_torch_import.py`` draws one for the JAX package.
The port's imported trees must equal the JAX package's bit for bit, both
round trips must be bit-exact, and ``.pt`` and npz files must cross between
the packages both ways.  The refusals carry the JAX package's text, and the
verbs exit as the JAX CLI's do.
"""

from __future__ import annotations

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from cvml_goalnet_tpu import cli as jcli
from cvml_goalnet_tpu.compat import export_reference_state_dict as jax_export
from cvml_goalnet_tpu.compat import import_reference_state_dict as jax_import
from cvml_goalnet_tpu.pipeline import fuse as jax_fuse
from cvml_goalnet_tpu.train.checkpoint import load_checkpoint as jax_load_checkpoint
from cvml_goalnet_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from cvml_goalnet_tpu.train.state import create_train_state as jax_train_state
from cvml_goalnet_tpu_torch import cli
from cvml_goalnet_tpu_torch.compat import (
    export_reference_state_dict,
    import_reference_arrays,
    import_reference_state_dict,
)
from cvml_goalnet_tpu_torch.config import PipelineConfig
from cvml_goalnet_tpu_torch.models.audio import audio_temporal_trace
from cvml_goalnet_tpu_torch.models.visual import visual_spatial_trace
from cvml_goalnet_tpu_torch.pipeline import fuse
from cvml_goalnet_tpu_torch.train.checkpoint import load_checkpoint
from cvml_goalnet_tpu_torch.train.state import create_train_state

CPU = "cpu"


def _jcfg(small_cfg, audio=True, **model):
    return dataclasses.replace(small_cfg, model=dataclasses.replace(small_cfg.model, audio_included=audio, **model))


def _port(jcfg) -> PipelineConfig:
    return PipelineConfig.from_json(jcfg.to_json())


def reference_state_dict(cfg, seed: int, audio: bool = True) -> dict:
    """Seeded reference-format weights for ``cfg`` (JAX or port config), float32 numpy arrays."""
    rng = np.random.default_rng(seed)
    m, pre, aud = cfg.model, cfg.preprocess, cfg.audio
    sd = {}
    chans = (3,) + m.vis_channels
    for i, (cin, cout) in enumerate(zip(chans[:-1], chans[1:]), start=1):
        sd[f"visbl.conv{i}.weight"] = rng.standard_normal((cout, cin, 3, 3)).astype(np.float32) * 0.1
        sd[f"visbl.conv{i}.bias"] = rng.standard_normal(cout).astype(np.float32) * 0.1
        sd[f"visbl.bnorm{i}.weight"] = rng.random(cout).astype(np.float32) + 0.5
        sd[f"visbl.bnorm{i}.bias"] = rng.standard_normal(cout).astype(np.float32) * 0.1
        sd[f"visbl.bnorm{i}.running_mean"] = rng.standard_normal(cout).astype(np.float32) * 0.1
        sd[f"visbl.bnorm{i}.running_var"] = rng.random(cout).astype(np.float32) + 0.5
        sd[f"visbl.bnorm{i}.num_batches_tracked"] = np.asarray(0, np.int64)
    h, w = visual_spatial_trace(pre.frame_size, len(m.vis_channels))[-1]
    sd["visbl.linear5.weight"] = rng.standard_normal((m.vis_feature_dim, m.vis_channels[-1] * h * w)).astype(
        np.float32) * 0.05
    sd["visbl.linear5.bias"] = rng.standard_normal(m.vis_feature_dim).astype(np.float32) * 0.1
    if audio:
        achans = (aud.n_mfcc,) + m.aud_channels
        for i, (cin, cout) in enumerate(zip(achans[:-1], achans[1:]), start=1):
            sd[f"audbl.conv{i}.weight"] = rng.standard_normal((cout, cin, 3)).astype(np.float32) * 0.1
            sd[f"audbl.conv{i}.bias"] = rng.standard_normal(cout).astype(np.float32) * 0.1
        t = audio_temporal_trace(aud.bin_length, len(m.aud_channels))[-1]
        sd["audbl.linear3.weight"] = rng.standard_normal((m.aud_feature_dim, m.aud_channels[-1] * t)).astype(
            np.float32) * 0.05
        sd["audbl.linear3.bias"] = rng.standard_normal(m.aud_feature_dim).astype(np.float32) * 0.1
    dims = (m.vis_feature_dim + (m.aud_feature_dim if audio else 0),) + m.fusion_hidden + (1,)
    for li, (din, dout) in enumerate(zip(dims[:-1], dims[1:])):
        sd[f"fusion.{3 * li}.weight"] = rng.standard_normal((dout, din)).astype(np.float32) * 0.05
        sd[f"fusion.{3 * li}.bias"] = rng.standard_normal(dout).astype(np.float32) * 0.1
    return sd


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_trees_bit_equal(got, want):
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert g.keys() == w.keys()
    for k in g:
        a, b = _np(g[k]), _np(w[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)


def assert_state_dicts_bit_equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in got:
        a, b = _np(got[k]), _np(want[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.fixture(autouse=True)
def on_cpu(monkeypatch):
    monkeypatch.setenv("GOALNET_PLATFORM", "cpu")


class TestImport:
    @pytest.mark.parametrize("audio", [True, False])
    def test_trees_equal_jax_bit_for_bit(self, small_cfg, audio):
        jcfg = _jcfg(small_cfg, audio)
        cfg = _port(jcfg)
        sd = reference_state_dict(cfg, seed=1, audio=audio)
        jp, js = jax_import(sd, jcfg.model, jcfg.preprocess, jcfg.audio)
        p, s = import_reference_arrays(sd, cfg.model, cfg.preprocess, cfg.audio)
        assert_trees_bit_equal(p, jax.tree.map(np.asarray, jp))
        assert_trees_bit_equal(s, jax.tree.map(np.asarray, js))
        tp, ts = import_reference_state_dict(sd, cfg.model, cfg.preprocess, cfg.audio, device=CPU)
        assert_trees_bit_equal(tp, p)
        assert_trees_bit_equal(ts, s)
        # the kernels take row-major tensors only: the transposed weights are copied into that order
        assert all(t.dtype == torch.float32 and t.device.type == "cpu" and t.is_contiguous() for _, t in _leaves(tp))

    def test_torch_tensors_import_as_numpy(self, small_cfg):
        cfg = _port(_jcfg(small_cfg))
        sd = reference_state_dict(cfg, seed=2)
        as_torch = {k: torch.as_tensor(v) for k, v in sd.items()}
        assert_trees_bit_equal(import_reference_arrays(as_torch, cfg.model, cfg.preprocess, cfg.audio),
                               import_reference_arrays(sd, cfg.model, cfg.preprocess, cfg.audio))

    def test_imported_trunk_scores_as_jax(self, small_cfg):
        """The imported trunk fuses as the JAX package's imported trunk does (within 1e-4, the port's fuse
        tolerance)."""
        jcfg = _jcfg(small_cfg)
        cfg = _port(jcfg)
        sd = reference_state_dict(cfg, seed=3)
        rng = np.random.default_rng(4)
        feats = {"visual": rng.random((9, *cfg.preprocess.frame_size, 3)).astype(np.float32),
                 "audio": rng.random((9, cfg.audio.bin_length, cfg.audio.n_mfcc)).astype(np.float32), "text": None}
        p, s = import_reference_state_dict(sd, cfg.model, cfg.preprocess, cfg.audio, device=CPU)
        jp, js = jax_import(sd, jcfg.model, jcfg.preprocess, jcfg.audio)
        np.testing.assert_allclose(fuse(p, s, feats, cfg, device=CPU), np.asarray(jax_fuse(jp, js, feats, jcfg)),
                                   atol=1e-4)


class TestRoundTrips:
    @pytest.mark.parametrize("audio", [True, False])
    def test_import_then_export_is_bit_exact(self, small_cfg, audio):
        cfg = _port(_jcfg(small_cfg, audio))
        sd = reference_state_dict(cfg, seed=5, audio=audio)
        p, s = import_reference_state_dict(sd, cfg.model, cfg.preprocess, cfg.audio, device=CPU)
        out = export_reference_state_dict(p, s, cfg.model, cfg.preprocess, cfg.audio)
        assert_state_dicts_bit_equal(out, sd)
        assert out["visbl.bnorm1.num_batches_tracked"].dtype == np.int64
        assert all(v.flags.c_contiguous for v in out.values())
        assert int(out["visbl.bnorm1.num_batches_tracked"]) == 0

    @pytest.mark.parametrize("audio", [True, False])
    def test_export_then_import_is_bit_exact(self, small_cfg, audio):
        cfg = _port(_jcfg(small_cfg, audio))
        state = create_train_state(9, cfg, device=CPU)
        sd = export_reference_state_dict(state.params, state.model_state, cfg.model, cfg.preprocess, cfg.audio)
        p, s = import_reference_state_dict(sd, cfg.model, cfg.preprocess, cfg.audio, device=CPU)
        assert_trees_bit_equal(p, state.params)
        assert_trees_bit_equal(s, state.model_state)

    def test_export_equals_jax_export(self, small_cfg):
        jcfg = _jcfg(small_cfg)
        cfg = _port(jcfg)
        js = jax_train_state(jax.random.PRNGKey(3), jcfg)
        from cvml_goalnet_tpu_torch.weights import from_jax

        p, s = from_jax(js.params, js.model_state, device=CPU)
        assert_state_dicts_bit_equal(export_reference_state_dict(p, s, cfg.model, cfg.preprocess, cfg.audio),
                                     jax_export(js.params, js.model_state, jcfg.model, jcfg.preprocess, jcfg.audio))

    def test_bf16_trees_export_as_float32(self, small_cfg):
        cfg = _port(_jcfg(small_cfg, False))
        state = create_train_state(2, cfg, device=CPU)
        from cvml_goalnet_tpu_torch.utils import tree_cast

        sd = export_reference_state_dict(tree_cast(state.params, torch.bfloat16), state.model_state, cfg.model,
                                         cfg.preprocess, cfg.audio)
        assert all(v.dtype == np.float32 for k, v in sd.items() if not k.endswith("num_batches_tracked"))


def _raises_as_jax(port_call, jax_call):
    with pytest.raises(ValueError) as got:
        port_call()
    with pytest.raises(ValueError) as want:
        jax_call()
    assert str(got.value) == str(want.value)
    return str(got.value)


class TestRefusals:
    @pytest.mark.parametrize("backbone", ["resnet", "vit"])
    def test_backbones_refused_both_ways(self, small_cfg, backbone):
        jcfg = _jcfg(small_cfg, False, vis_backbone=backbone, vit_embed_dim=16, vit_depth=2, vit_num_heads=2)
        cfg = _port(jcfg)
        sd = reference_state_dict(_port(_jcfg(small_cfg, False)), seed=1, audio=False)
        msg = _raises_as_jax(lambda: import_reference_arrays(sd, cfg.model, cfg.preprocess, cfg.audio),
                             lambda: jax_import(sd, jcfg.model, jcfg.preprocess, jcfg.audio))
        assert "vis_backbone='reference'" in msg and backbone in msg
        js = jax_train_state(jax.random.PRNGKey(0), jcfg)
        p = jax.tree.map(np.asarray, js.params)
        s = jax.tree.map(np.asarray, js.model_state)
        assert "export" in _raises_as_jax(
            lambda: export_reference_state_dict(p, s, cfg.model, cfg.preprocess, cfg.audio),
            lambda: jax_export(js.params, js.model_state, jcfg.model, jcfg.preprocess, jcfg.audio))

    def test_moe_export_refused(self, small_cfg):
        jcfg = _jcfg(small_cfg, False, fusion_moe_experts=4)
        cfg = _port(jcfg)
        js = jax_train_state(jax.random.PRNGKey(0), jcfg)
        p = jax.tree.map(np.asarray, js.params)
        s = jax.tree.map(np.asarray, js.model_state)
        msg = _raises_as_jax(lambda: export_reference_state_dict(p, s, cfg.model, cfg.preprocess, cfg.audio),
                             lambda: jax_export(js.params, js.model_state, jcfg.model, jcfg.preprocess, jcfg.audio))
        assert "fusion_moe_experts=0" in msg

    def test_visual_only_state_dict_refused_by_audio_config(self, small_cfg):
        jcfg = _jcfg(small_cfg, True)
        cfg = _port(jcfg)
        sd = reference_state_dict(cfg, seed=1, audio=False)
        assert "audbl.*" in _raises_as_jax(lambda: import_reference_arrays(sd, cfg.model, cfg.preprocess, cfg.audio),
                                           lambda: jax_import(sd, jcfg.model, jcfg.preprocess, jcfg.audio))

    def test_audio_config_without_audio_branch_refused_on_export(self, small_cfg):
        jcfg = _jcfg(small_cfg, True)
        cfg = _port(jcfg)
        js = jax_train_state(jax.random.PRNGKey(0), _jcfg(small_cfg, False))
        p = jax.tree.map(np.asarray, js.params)
        s = jax.tree.map(np.asarray, js.model_state)
        _raises_as_jax(lambda: export_reference_state_dict(p, s, cfg.model, cfg.preprocess, cfg.audio),
                       lambda: jax_export(js.params, js.model_state, jcfg.model, jcfg.preprocess, jcfg.audio))


@pytest.fixture
def cfg_files(tmp_path, small_cfg):
    """Config files of the small model: audio, resnet and MoE."""
    out = {}
    for name, jcfg in (("audio", small_cfg),
                       ("resnet", _jcfg(small_cfg, True, vis_backbone="resnet")),
                       ("moe", _jcfg(small_cfg, True, fusion_moe_experts=4))):
        out[name] = str(tmp_path / f"{name}.json")
        jcfg.save(out[name])
    return out


def _ckp_dir(work: str, audio: bool = True) -> str:
    return os.path.join(work, "models", "importance" if audio else "importance_no_audio")


class TestVerbs:
    @pytest.mark.parametrize("audio", [True, False])
    def test_import_torch_npz_loads_in_jax(self, small_cfg, tmp_path, capsys, audio):
        """``import-torch`` writes opt and ckp with Adam at step 0 and epoch 0; JAX's ``load_checkpoint`` reads
        them back as JAX's own import of the same file."""
        jcfg = _jcfg(small_cfg, audio)
        cfg_fp = str(tmp_path / "cfg.json")
        jcfg.save(cfg_fp)
        sd = reference_state_dict(_port(jcfg), seed=6, audio=audio)
        pt = str(tmp_path / "ref.pt")
        torch.save({"state_dict": {k: torch.as_tensor(v) for k, v in sd.items()}}, pt)
        work = str(tmp_path / "work")
        flags = [] if audio else ["--no-audio"]
        assert cli.main(["import-torch", pt, "--config", cfg_fp, "--workdir", work, *flags]) == 0
        assert "Operation completed" in capsys.readouterr().out
        jp, js = jax_import(sd, jcfg.model, jcfg.preprocess, jcfg.audio)
        for tag in ("opt", "ckp"):
            got = jax_load_checkpoint(_ckp_dir(work, audio), jax_train_state(jax.random.PRNGKey(0), jcfg), tag=tag)
            assert got.epoch == 0 and int(got.opt_state.step) == 0
            assert_trees_bit_equal(jax.tree.map(np.asarray, got.params), jax.tree.map(np.asarray, jp))
            assert_trees_bit_equal(jax.tree.map(np.asarray, got.model_state), jax.tree.map(np.asarray, js))
            assert all(not np.asarray(m).any() for m in jax.tree_util.tree_leaves(got.opt_state.mu))

    def test_import_tag_writes_one_checkpoint(self, small_cfg, tmp_path, capsys):
        cfg_fp = str(tmp_path / "cfg.json")
        small_cfg.save(cfg_fp)
        pt = str(tmp_path / "ref.pt")
        torch.save({k: torch.as_tensor(v) for k, v in reference_state_dict(_port(small_cfg), seed=7).items()}, pt)
        work = str(tmp_path / "work")
        assert cli.main(["import-torch", pt, "--config", cfg_fp, "--workdir", work, "--tag", "ckp"]) == 0
        assert sorted(os.listdir(_ckp_dir(work))) == ["ckp_manifest.json", "ckp_state.npz"]

    def test_pt_files_cross_between_packages(self, small_cfg, tmp_path, capsys):
        """JAX's ``export-torch`` file imports through the port's verb, and the port's export of that trunk is
        the same file's contents, which JAX's ``import-torch`` takes back: every array bit-equal."""
        cfg_fp = str(tmp_path / "cfg.json")
        small_cfg.save(cfg_fp)
        js = jax_train_state(jax.random.PRNGKey(5), small_cfg)
        jax_work = str(tmp_path / "jax_work")
        jax_save_checkpoint(_ckp_dir(jax_work), js, small_cfg, tag="opt")
        jax_pt = str(tmp_path / "jax.pt")
        assert jcli.main(["export-torch", jax_pt, "--config", cfg_fp, "--workdir", jax_work]) == 0

        port_work = str(tmp_path / "port_work")
        assert cli.main(["import-torch", jax_pt, "--config", cfg_fp, "--workdir", port_work]) == 0
        cfg = _port(small_cfg)
        got = load_checkpoint(_ckp_dir(port_work), create_train_state(0, cfg, device=CPU), tag="opt")
        assert_trees_bit_equal(got.params, jax.tree.map(np.asarray, js.params))
        assert_trees_bit_equal(got.model_state, jax.tree.map(np.asarray, js.model_state))

        port_pt = str(tmp_path / "port.pt")
        assert cli.main(["export-torch", port_pt, "--config", cfg_fp, "--workdir", port_work]) == 0
        mine = torch.load(port_pt, map_location="cpu", weights_only=True)
        theirs = torch.load(jax_pt, map_location="cpu", weights_only=True)
        assert_state_dicts_bit_equal(mine, theirs)
        assert mine["visbl.bnorm2.num_batches_tracked"].dtype == torch.int64

        back = str(tmp_path / "back")
        assert jcli.main(["import-torch", port_pt, "--config", cfg_fp, "--workdir", back]) == 0
        again = jax_load_checkpoint(_ckp_dir(back), jax_train_state(jax.random.PRNGKey(0), small_cfg), tag="ckp")
        assert_trees_bit_equal(jax.tree.map(np.asarray, again.params), jax.tree.map(np.asarray, js.params))

    def test_export_picks_tag_and_falls_back_to_ckp(self, small_cfg, tmp_path, capsys):
        cfg_fp = str(tmp_path / "cfg.json")
        small_cfg.save(cfg_fp)
        work = str(tmp_path / "work")
        js = jax_train_state(jax.random.PRNGKey(8), small_cfg)
        jax_save_checkpoint(_ckp_dir(work), js, small_cfg, tag="ckp")
        out = str(tmp_path / "sub" / "out.pt")
        assert cli.main(["export-torch", out, "--config", cfg_fp, "--workdir", work]) == 0
        assert "falling back to rolling ckp" in capsys.readouterr().out
        assert_state_dicts_bit_equal(torch.load(out, weights_only=True),
                                     jax_export(js.params, js.model_state, small_cfg.model, small_cfg.preprocess,
                                                small_cfg.audio))

    @pytest.mark.parametrize("case", ["resnet_import", "audbl_missing", "missing_pt", "no_trunk", "mismatched_trunk",
                                      "moe_export", "resnet_export"])
    def test_exit_codes_match_jax(self, small_cfg, tmp_path, capsys, cfg_files, case):
        """Both CLIs exit 2 on each refusal, the port's message carrying the JAX CLI's."""
        pt = str(tmp_path / "ref.pt")
        audio_sd = reference_state_dict(_port(small_cfg), seed=1)
        torch.save({k: torch.as_tensor(v) for k, v in audio_sd.items()}, pt)
        work = str(tmp_path / "work")
        if case == "audbl_missing":
            torch.save({k: torch.as_tensor(v) for k, v in audio_sd.items() if not k.startswith("audbl.")}, pt)
        if case == "mismatched_trunk":   # a no-audio trunk under the audio directory
            c = _jcfg(small_cfg, False)
            jax_save_checkpoint(_ckp_dir(work), jax_train_state(jax.random.PRNGKey(0), c), c, tag="opt")
        if case in ("moe_export", "resnet_export"):
            c = _jcfg(small_cfg, True, **({"fusion_moe_experts": 4} if case == "moe_export"
                                          else {"vis_backbone": "resnet"}))
            jax_save_checkpoint(_ckp_dir(work), jax_train_state(jax.random.PRNGKey(0), c), c, tag="opt")
        cfg_fp = {"resnet_import": cfg_files["resnet"], "moe_export": cfg_files["moe"],
                  "resnet_export": cfg_files["resnet"]}.get(case, cfg_files["audio"])
        if case in ("resnet_import", "audbl_missing", "missing_pt"):
            argv = ["import-torch", pt if case != "missing_pt" else str(tmp_path / "none.pt")]
        else:
            argv = ["export-torch", str(tmp_path / "out.pt")]
        argv += ["--config", cfg_fp, "--workdir", work]
        assert jcli.main(argv) == 2
        want = capsys.readouterr().err.strip().splitlines()[0]
        assert cli.main(argv) == 2
        got = capsys.readouterr().err.strip().splitlines()[0]
        if case in ("resnet_import", "audbl_missing", "moe_export", "resnet_export"):
            assert got == want
        assert got.startswith("E: ")
        assert not os.path.exists(str(tmp_path / "out.pt"))

    def test_orbax_export_exits_2_naming_item_6(self, small_cfg, tmp_path, capsys, cfg_files):
        """``export-torch --checkpoint-backend orbax`` (the name records the refusal this test once held) on the
        committed JAX-written orbax trunk (``tests/data/orbax_small``: OCDBT, zstd) equals, tensor for tensor
        and bit for bit, the export of that trunk's npz twin."""
        import shutil

        fixture = os.path.join(os.path.dirname(__file__), "data", "orbax_small")
        outs = {}
        for name, files, flags in (("orbax", ("ckp_orbax", "ckp_orbax_manifest.json"), ["--checkpoint-backend",
                                                                                       "orbax"]),
                                   ("npz", ("ckp_state.npz", "ckp_manifest.json"), [])):
            work = str(tmp_path / name)
            os.makedirs(_ckp_dir(work))
            for f in files:
                src, dst = os.path.join(fixture, f), os.path.join(_ckp_dir(work), f)
                (shutil.copytree if os.path.isdir(src) else shutil.copy)(src, dst)
            outs[name] = str(tmp_path / f"{name}.pt")
            assert cli.main(["export-torch", outs[name], "--config", cfg_files["audio"], "--workdir", work,
                             "--tag", "ckp", *flags]) == 0
            assert "Operation completed" in capsys.readouterr().out
        assert_state_dicts_bit_equal(torch.load(outs["orbax"], weights_only=True),
                                     torch.load(outs["npz"], weights_only=True))
