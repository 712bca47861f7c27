"""PyTorch port: config layer and the JAX → torch parameter bridge, on the CPU."""

import glob
import json
import os

import jax
import numpy as np
import pytest
import torch

from cvml_goalnet_tpu.config import PipelineConfig as JaxPipelineConfig
from cvml_goalnet_tpu.models.avm import avm_init
from cvml_goalnet_tpu.train.checkpoint import save_checkpoint
from cvml_goalnet_tpu.train.state import create_train_state
from cvml_goalnet_tpu_torch import weights as W
from cvml_goalnet_tpu_torch.config import PipelineConfig as TorchPipelineConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "*.json")))


def _golden_cfg():
    from tests.goldens.generate import golden_cfg

    return golden_cfg()


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


class TestConfig:
    @pytest.mark.parametrize("path", CONFIGS, ids=[os.path.basename(p) for p in CONFIGS])
    def test_configs_round_trip_through_both_layers(self, path):
        jcfg = JaxPipelineConfig.load(path)
        tcfg = TorchPipelineConfig.load(path)
        assert json.loads(tcfg.to_json()) == json.loads(jcfg.to_json())
        # JAX → port → JAX and port → JAX → port are identities
        assert JaxPipelineConfig.from_json(TorchPipelineConfig.from_json(jcfg.to_json()).to_json()) == jcfg
        assert TorchPipelineConfig.from_json(JaxPipelineConfig.from_json(tcfg.to_json()).to_json()) == tcfg

    def test_unknown_key_fails_loudly(self):
        with pytest.raises(ValueError, match="unknown config key"):
            TorchPipelineConfig.from_json(json.dumps({"preprocess": {"skip_frame": 3}}))


class TestWeights:
    def test_from_jax_keeps_layout_and_values(self):
        cfg = _golden_cfg()
        params, state = avm_init(jax.random.PRNGKey(11), cfg.model, cfg.preprocess, cfg.audio)
        tp, ts = W.from_jax(params, state, device="cpu")
        jl = dict(_leaves(jax.tree.map(np.asarray, params)))
        tl = dict(_leaves(tp))
        assert jl.keys() == tl.keys()
        for k, v in jl.items():
            assert tl[k].dtype == torch.float32 and tl[k].device.type == "cpu"
            np.testing.assert_array_equal(tl[k].numpy(), v, err_msg=k)
        assert dict(_leaves(ts)).keys() == dict(_leaves(jax.tree.map(np.asarray, state))).keys()

    @pytest.mark.parametrize("classifier", [False, True])
    def test_init_params_matches_avm_init_structure(self, classifier):
        cfg = JaxPipelineConfig.load(os.path.join(REPO, "configs", "reference_parity.json"))
        params, state = avm_init(jax.random.PRNGKey(0), cfg.model, cfg.preprocess, cfg.audio, classifier=classifier)
        want = {k: np.shape(v) for k, v in _leaves(jax.tree.map(np.asarray, (params, state)))}
        tcfg = TorchPipelineConfig.load(os.path.join(REPO, "configs", "reference_parity.json"))
        got_p, got_s = W.init_params(tcfg, seed=0, classifier=classifier)
        got = {k: v.shape for k, v in _leaves((got_p, got_s))}
        assert got == want
        again, _ = W.init_params(tcfg, seed=0, classifier=classifier)
        np.testing.assert_array_equal(again["fusion"][0]["w"], got_p["fusion"][0]["w"])

    def test_load_jax_checkpoint(self, tmp_path):
        cfg = _golden_cfg()
        ts = create_train_state(jax.random.PRNGKey(11), cfg)
        save_checkpoint(str(tmp_path), ts, cfg, tag="opt")
        assert os.path.exists(tmp_path / "opt_state.npz")
        params, state = W.load_jax_checkpoint(str(tmp_path), tag="opt")
        for (kw, want), (kg, got) in zip(
            _leaves(jax.tree.map(np.asarray, (ts.params, ts.model_state))), _leaves((params, state))
        ):
            assert kw == kg
            np.testing.assert_array_equal(got, want, err_msg=kw)
        assert isinstance(params["fusion"], list) and len(params["fusion"]) == 3

    def test_checkpoint_key_format(self, tmp_path):
        """Pins the key format the bridge parses: "/".join over jax key paths."""
        cfg = _golden_cfg()
        save_checkpoint(str(tmp_path), create_train_state(jax.random.PRNGKey(1), cfg), cfg)
        keys = set(np.load(tmp_path / "ckp_state.npz").files)
        assert "['params']/['visual']/['conv0']/['w']" in keys
        assert "['params']/['fusion']/[0]/['w']" in keys
        assert "['model_state']/['visual']/['bn2']/['var']" in keys

    def test_from_jax_rejects_integer_leaves(self):
        with pytest.raises(TypeError, match="not floating point"):
            W.from_jax({"w": np.zeros(3, np.int32)}, {}, device="cpu")

    def test_from_jax_without_card_raises(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            W.from_jax({"w": np.zeros(3, np.float32)}, {})
