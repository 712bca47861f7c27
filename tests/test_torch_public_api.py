"""PyTorch port: the subpackages' public names against the JAX package's ``__all__``, on the CPU.

* Names: every name of JAX's ``ops``, ``data``, ``train``, ``models``, ``utils`` and ``parallel`` ``__all__``
  resolves in the port's matching subpackage, except the names of ``utils.NOT_PORTED``, each with its reason.
* Values: ``expand_scores_host``, ``clip_stats_host``, ``normalize_frames`` and ``resize_bilinear`` equal
  JAX's on seeded inputs, within 1e-6 (0 for the integer outputs).
* Inits: each ``*_init`` tree has JAX's keys, shapes and dtypes (JAX's through ``jax.eval_shape``, so nothing
  is drawn there), and every weight and bias of fan-in f lies within ±1/√f.
* Imports: a subprocess pins that importing the six subpackages and resolving every name loads neither
  ``jax`` nor ``cvml_goalnet_tpu``.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvml_goalnet_tpu.config import PipelineConfig as JaxPipelineConfig
from cvml_goalnet_tpu_torch.config import PipelineConfig
from cvml_goalnet_tpu_torch.utils import NOT_PORTED

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUBPACKAGES = ("ops", "data", "train", "models", "utils", "parallel")
NAMES = [(pkg, name) for pkg in SUBPACKAGES
         for name in importlib.import_module(f"cvml_goalnet_tpu.{pkg}").__all__ if name not in NOT_PORTED]


@pytest.mark.parametrize("pkg,name", NAMES, ids=[f"{p}.{n}" for p, n in NAMES])
def test_jax_name_resolves_in_the_port(pkg, name):
    assert getattr(importlib.import_module(f"cvml_goalnet_tpu_torch.{pkg}"), name) is not None


@pytest.mark.parametrize("pkg", SUBPACKAGES)
def test_port_all_lists_jax_names(pkg):
    """The port's ``__all__`` lists every JAX name it takes (``parallel`` adds multihost's and multislice's)."""
    jax_names = set(importlib.import_module(f"cvml_goalnet_tpu.{pkg}").__all__) - set(NOT_PORTED)
    assert jax_names <= set(importlib.import_module(f"cvml_goalnet_tpu_torch.{pkg}").__all__)


def test_not_ported_is_the_stated_list():
    assert set(NOT_PORTED) == {"apply_platform_override"}
    assert "compile cache" in NOT_PORTED["apply_platform_override"]
    assert not hasattr(importlib.import_module("cvml_goalnet_tpu_torch.utils"), "apply_platform_override")


def test_unknown_name_raises_attribute_error():
    with pytest.raises(AttributeError):
        importlib.import_module("cvml_goalnet_tpu_torch.ops").no_such_name


@pytest.mark.parametrize("n,skip,full", [(5, 3, 15), (5, 3, 13), (5, 3, 20), (7, 1, 7), (1, 30, 31)])
def test_expand_scores_host_matches_jax(n, skip, full):
    from cvml_goalnet_tpu.ops import expand_scores_host as jax_fn
    from cvml_goalnet_tpu_torch.ops import expand_scores_host

    scores = np.random.default_rng(n + full).random(n).astype(np.float32)
    got, want = expand_scores_host(scores, skip, full), jax_fn(scores, skip, full)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype and not np.shares_memory(got, scores)


@pytest.mark.parametrize("intervals", [[[0, 4], [4, 9], [9, 12]], [[-3, 2], [5, 40], [8, 3]], [[0, 0], [11, 12]]],
                         ids=["tiling", "clamped", "empty_and_last"])
def test_clip_stats_host_matches_jax(intervals):
    from cvml_goalnet_tpu.ops import clip_stats_host as jax_fn
    from cvml_goalnet_tpu_torch.ops import clip_stats, clip_stats_host

    imp = np.random.default_rng(7).random(12).astype(np.float32)
    (gs, gl), (ws, wl) = clip_stats_host(np.asarray(intervals), imp), jax_fn(np.asarray(intervals), imp)
    np.testing.assert_allclose(gs, ws, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(gl, wl)
    assert gl.dtype == wl.dtype == np.int32
    ts, tl = clip_stats(torch.as_tensor(intervals), torch.as_tensor(imp))   # the tensor op agrees with its mirror
    np.testing.assert_allclose(ts.numpy(), gs, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tl.numpy(), gl)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_normalize_frames_matches_jax(dtype):
    from cvml_goalnet_tpu.ops import normalize_frames as jax_fn
    from cvml_goalnet_tpu_torch.ops import normalize_frames

    rng = np.random.default_rng(1)
    frames = (rng.integers(0, 256, (3, 9, 11, 3)) if dtype == np.uint8 else rng.normal(size=(3, 9, 11, 3))).astype(dtype)
    got = normalize_frames(torch.as_tensor(frames)).numpy()
    want = np.asarray(jax_fn(jnp.asarray(frames)))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("shape,out_hw", [((2, 36, 48, 3), (24, 24)), ((3, 20, 30, 1), (40, 40)),
                                          ((1, 72, 96, 3), (40, 40))], ids=["down", "up_c1", "train_video"])
def test_resize_bilinear_matches_jax(shape, out_hw):
    from cvml_goalnet_tpu.ops import normalize_frames as jax_normalize
    from cvml_goalnet_tpu.ops import resize_bilinear as jax_fn
    from cvml_goalnet_tpu_torch.ops import resize_bilinear

    frames = np.array(jax_normalize(jnp.asarray(np.random.default_rng(2).integers(0, 256, shape).astype(np.uint8))))
    got = resize_bilinear(torch.as_tensor(frames), out_hw).numpy()
    want = np.asarray(jax_fn(jnp.asarray(frames), out_hw))
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def _shapes(tree, path=""):
    """{path: (shape, dtype)} of a tree of arrays (numpy, JAX or ShapeDtypeStruct)."""
    if isinstance(tree, dict):
        out = {}
        for k in tree:
            out.update(_shapes(tree[k], f"{path}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_shapes(v, f"{path}/{i}"))
        return out
    return {path: (tuple(tree.shape), np.dtype(tree.dtype))}


def _fan_in_bounded(tree, path="") -> list[str]:
    """Paths of the weight and bias leaves of every ``{"w", "b"}`` layer that lie outside ±1/√fan_in."""
    bad = []
    if isinstance(tree, dict):
        if set(tree) == {"w", "b"}:
            w, b = tree["w"], tree["b"]
            fan_in = w.shape[-2] if w.ndim == 3 and b.ndim == 2 else math.prod(w.shape[:-1])   # MoE experts
            bound = 1.0 / math.sqrt(fan_in)
            bad += [f"{path}/{k}" for k, v in tree.items() if np.abs(v).max() > bound]
            return bad
        for k, v in tree.items():
            bad += _fan_in_bounded(v, f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            bad += _fan_in_bounded(v, f"{path}/{i}")
    return bad


def _cfgs(small_cfg, **model):
    jcfg = dataclasses.replace(small_cfg, model=dataclasses.replace(small_cfg.model, **model))
    return jcfg, PipelineConfig.from_json(jcfg.to_json())


AVM_CASES = {"reference": {}, "no_audio": {"audio_included": False}, "text": {"text_included": True},
             "moe": {"fusion_moe_experts": 4}, "resnet": {"vis_backbone": "resnet"},
             "vit": {"vis_backbone": "vit", "vit_embed_dim": 16, "vit_depth": 1, "vit_num_heads": 2}}


@pytest.mark.parametrize("model", list(AVM_CASES.values()), ids=list(AVM_CASES))
@pytest.mark.parametrize("classifier", [False, True])
def test_avm_init_tree_matches_jax(small_cfg, model, classifier):
    from cvml_goalnet_tpu.models import avm_init as jax_init
    from cvml_goalnet_tpu_torch.models import avm_init

    jcfg, cfg = _cfgs(small_cfg, **model)
    want = jax.eval_shape(lambda k: jax_init(k, jcfg.model, jcfg.preprocess, jcfg.audio, classifier),
                          jax.random.PRNGKey(0))
    got = avm_init(3, cfg.model, cfg.preprocess, cfg.audio, classifier)
    assert _shapes(got) == _shapes(want)
    assert _fan_in_bounded(got[0]) == []


def test_visual_audio_and_temporal_inits_match_jax(small_cfg):
    from cvml_goalnet_tpu.models import audio_encoder_init as jax_audio
    from cvml_goalnet_tpu.models import temporal_scorer_init as jax_temporal
    from cvml_goalnet_tpu.models import visual_encoder_init as jax_visual
    from cvml_goalnet_tpu_torch.models import audio_encoder_init, temporal_scorer_init, visual_encoder_init

    jcfg, cfg = _cfgs(small_cfg)
    key = jax.random.PRNGKey(0)
    pairs = [(visual_encoder_init(1, cfg.model, cfg.preprocess),
              jax.eval_shape(lambda k: jax_visual(k, jcfg.model, jcfg.preprocess), key)),
             (audio_encoder_init(1, cfg.model, cfg.audio),
              jax.eval_shape(lambda k: jax_audio(k, jcfg.model, jcfg.audio), key))]
    for n_classes in (1, 3):
        pairs.append((temporal_scorer_init(1, 24, 8, n_classes),
                      jax.eval_shape(lambda k, c=n_classes: jax_temporal(k, 24, 8, c), key)))
    for got, want in pairs:
        assert _shapes(got) == _shapes(want)
        assert _fan_in_bounded(got) == []


def test_text_init_matches_jax_and_refuses_as_jax(small_cfg):
    from cvml_goalnet_tpu.models import text_encoder_init as jax_text
    from cvml_goalnet_tpu_torch.models import text_encoder_init

    jcfg, cfg = _cfgs(small_cfg, text_included=True)
    want = jax.eval_shape(lambda k: jax_text(k, jcfg.model), jax.random.PRNGKey(0))
    got = text_encoder_init(2, cfg.model)
    assert _shapes(got) == _shapes(want)
    assert _fan_in_bounded(got) == []
    assert np.abs(got["embed"]).max() < 0.02 * 6   # N(0, 0.02²), as JAX draws it
    bad_j, bad = _cfgs(small_cfg, text_included=True, text_embed_dim=15)
    with pytest.raises(ValueError):
        jax_text(jax.random.PRNGKey(0), bad_j.model)
    with pytest.raises(ValueError):
        text_encoder_init(2, bad.model)


def test_inits_are_seeded_draws_of_init_params(small_cfg):
    """The per-module inits draw as ``weights.init_params`` does: the whole model's tree is ``init_params``'
    own, and one seed gives one tree."""
    from cvml_goalnet_tpu_torch import weights
    from cvml_goalnet_tpu_torch.models import avm_init, visual_encoder_init

    _, cfg = _cfgs(small_cfg)
    a, b = avm_init(5, cfg.model, cfg.preprocess, cfg.audio), weights.init_params(cfg, 5)
    for (k, x), (_, y) in zip(sorted(_leaf_items(a)), sorted(_leaf_items(b))):
        np.testing.assert_array_equal(x, y, err_msg=k)
    v1, v2 = visual_encoder_init(5, cfg.model, cfg.preprocess), visual_encoder_init(5, cfg.model, cfg.preprocess)
    np.testing.assert_array_equal(v1[0]["head"]["w"], v2[0]["head"]["w"])
    assert not np.array_equal(visual_encoder_init(6, cfg.model, cfg.preprocess)[0]["head"]["w"], v1[0]["head"]["w"])


def _leaf_items(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaf_items(v, f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaf_items(v, f"{path}/{i}")
    else:
        yield path, np.asarray(tree)


def test_subpackages_import_no_jax():
    code = (
        "import importlib, json, sys\n"
        f"for pkg in {SUBPACKAGES!r}:\n"
        "    mod = importlib.import_module('cvml_goalnet_tpu_torch.' + pkg)\n"
        "    for name in mod.__all__:\n"
        "        getattr(mod, name)\n"
        "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'cvml_goalnet_tpu'))))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_jax_config_round_trips_for_the_inits(small_cfg):
    """The init tests build the port's config from JAX's JSON: the two configs agree on every model field."""
    jcfg, cfg = _cfgs(small_cfg)
    assert json.loads(cfg.to_json()) == json.loads(JaxPipelineConfig.from_json(jcfg.to_json()).to_json())
