"""Parameter bridge between the JAX package's pytrees and the port's tensors.

The port keeps the JAX package's parameter layout, so a checkpoint moves over
by dtype and device alone, with no transposes:

* linear weights ``(in, out)``, conv2d weights HWIO, conv1d weights WIO
  (``cvml_goalnet_tpu/models/layers.py``);
* ``params = {"visual": {"conv0".."conv2", "bn0".."bn2", "head"},
  "audio": {"conv0", "conv1", "head"}, "fusion": [{"w", "b"}, ...]}`` and
  ``model_state = {"visual": {"bn0".."bn2": {"mean", "var"}}}``;
* the resnet backbone's ``params["visual"] = {"stem", "bn_stem", "s{i}b{j}":
  {"conv1", "bn1", "conv2", "bn2", "proj"?, "bn_proj"?}, "head"}`` with the
  same keys' ``{"mean", "var"}`` in ``model_state["visual"]``; the vit's
  ``{"patch", "pos", "head", "ln_out", "blocks": [{"ln1", "wq", "wk", "wv",
  "wo", "ln2", "mlp_in", "mlp_out"}]}`` with ``model_state["visual"] = {}``;
* with the text branch ``params["text"] = {"embed": (V, d), "head",
  "layers": [{"ln1", "wq", "wk", "wv", "wo", "ln2", "mlp_in", "mlp_out"}]}``;
  with MoE ``params["fusion"][0] = {"gate": {"w", "b"}, "experts": {"w":
  (E, in, out), "b": (E, out)}}``.

:func:`init_params` draws a pytree of that layout from a numpy seed (it is a
fresh draw with PyTorch's default bounds, not ``avm_init``'s JAX random
stream; the models' ``*_init`` functions draw one module's tree the same
way); :func:`load_jax_checkpoint` reads the ``<tag>_state.npz`` files that
``cvml_goalnet_tpu/train/checkpoint.py`` writes.

The temporal (spotting) heads keep their JAX trees too: GRU
``{"fwd", "bwd": {"wx", "wh"}, "head"}``, transformer ``{"proj_in",
"pos"?, "layers": [{"ln1", "wq", "wk", "wv", "wo", "ln2", "mlp_in",
"mlp_out"}], "head"}`` (``pos`` only for learned positions), hybrid
``{"gru": {"fwd", "bwd"}, "transformer"}``.  :func:`init_temporal_params`
draws one, :func:`load_spotting_checkpoint` reads the npz that
``cvml_goalnet_tpu/train/spotting.py::save_spotting_checkpoint`` writes, and
:func:`tree_from_jax` moves any such tree to the device.
"""

from __future__ import annotations

import math
import os
import re

import numpy as np
import torch

from cvml_goalnet_tpu_torch.config import PipelineConfig
from cvml_goalnet_tpu_torch.device import resolve_device
from cvml_goalnet_tpu_torch.models.audio import audio_feature_channels, audio_temporal_trace
from cvml_goalnet_tpu_torch.models.avm import N_CLASSES, fusion_input_dim
from cvml_goalnet_tpu_torch.models.text import check_text_config
from cvml_goalnet_tpu_torch.models.visual import STAGE_GEOM, visual_spatial_trace
from cvml_goalnet_tpu_torch.models.vit import check_vit_config, vit_grid


def _map_with_paths(fn, tree, path=()):
    """Map ``fn(key, leaf)`` over a tree; ``key`` is the jax key path as the npz files spell it."""
    if isinstance(tree, dict):
        return {k: _map_with_paths(fn, v, path + (f"['{k}']",)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_with_paths(fn, v, path + (f"[{i}]",)) for i, v in enumerate(tree)]
    return fn("/".join(path), tree)


def tree_from_jax(tree, device=None):
    """Any numpy (or JAX) pytree → the same tree of contiguous float32 tensors on the device (a transposed numpy
    view is copied into row-major order, as the kernels take it); lists stay lists."""
    dev = resolve_device(device)

    def leaf(a):
        a = np.asarray(a)
        if a.dtype.kind != "f":
            raise TypeError(f"parameter leaf of dtype {a.dtype} is not floating point")
        return torch.as_tensor(np.array(a, dtype=np.float32, order="C")).to(dev)

    return _map_with_paths(lambda _, a: leaf(a), tree)


def from_jax(params, model_state, device=None):
    """Numpy (or JAX) pytrees in the JAX layout → the same trees of float32 tensors."""
    return tree_from_jax(params, device), tree_from_jax(model_state, device)


# ------------------------------------------------------------------ init


def _uniform(rng, shape, fan_in):
    # PyTorch's default bounds: kaiming_uniform(a=√5) weights, ±1/√fan_in bias;
    # both reduce to ±1/√fan_in
    bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
    return rng.uniform(-bound, bound, shape).astype(np.float32)


def _layer(rng, w_shape, fan_in):
    return {"w": _uniform(rng, w_shape, fan_in), "b": _uniform(rng, (w_shape[-1],), fan_in)}


def init_params(cfg: PipelineConfig, seed: int, classifier: bool = False):
    """A seeded (params, model_state) numpy pytree in the JAX layout.

    Batchnorm statistics are drawn away from their identity values (means
    near 0, variances in [0.5, 1.5], scales near 1) so the eval-time fold is
    exercised, as it would be with trained weights.
    """
    m, pre, aud = cfg.model, cfg.preprocess, cfg.audio
    rng = np.random.default_rng(seed)
    backbones = {"reference": _reference_backbone, "resnet": _resnet_backbone, "vit": _vit_backbone}
    if m.vis_backbone not in backbones:
        raise ValueError(f"unknown vis_backbone {m.vis_backbone!r} (reference | resnet | vit)")
    visual, vstate = backbones[m.vis_backbone](rng, m, pre)
    params = {"visual": visual}
    if m.audio_included:
        params["audio"] = _audio_encoder(rng, m, aud)
    dims = (fusion_input_dim(m),) + m.fusion_hidden + (N_CLASSES if classifier else 1,)
    params["fusion"] = [_layer(rng, (din, dout), din) for din, dout in zip(dims[:-1], dims[1:])]
    if m.fusion_moe_experts > 0:
        e, din, dout = m.fusion_moe_experts, dims[0], dims[1]
        params["fusion"][0] = {"gate": _layer(rng, (din, e), din),
                               "experts": {"w": _uniform(rng, (e, din, dout), din), "b": _uniform(rng, (e, dout), din)}}
    if m.text_included:
        params["text"] = _text_encoder(rng, m)
    return params, {"visual": vstate}


def _audio_encoder(rng, m, aud):
    """The audio branch (``models/audio.py``): ``conv0``, ``conv1`` (kernel 3, WIO) and the flatten head."""
    audio = {}
    achans = (audio_feature_channels(aud),) + m.aud_channels
    for i, (cin, cout) in enumerate(zip(achans[:-1], achans[1:])):
        audio[f"conv{i}"] = _layer(rng, (3, cin, cout), cin * 3)
    t = audio_temporal_trace(aud.bin_length, len(m.aud_channels))[-1]
    audio["head"] = _layer(rng, (m.aud_channels[-1] * t, m.aud_feature_dim), m.aud_channels[-1] * t)
    return audio


def _batchnorm(rng, cout):
    """A batchnorm's (params, state), away from the identity so the eval fold and its rounding are exercised."""
    return ({"scale": (1.0 + 0.1 * rng.standard_normal(cout)).astype(np.float32),
             "bias": (0.1 * rng.standard_normal(cout)).astype(np.float32)},
            {"mean": (0.1 * rng.standard_normal(cout)).astype(np.float32),
             "var": rng.uniform(0.5, 1.5, cout).astype(np.float32)})


def _conv(rng, k, cin, cout):
    return _layer(rng, (k, k, cin, cout), cin * k * k)


def _reference_backbone(rng, m, pre):
    """The reference stack (``models/visual.py``): ``conv0..2``, ``bn0..2``, the flatten head."""
    visual, vstate = {}, {}
    chans = (pre.channels,) + m.vis_channels
    for i, (cin, cout) in enumerate(zip(chans[:-1], chans[1:])):
        visual[f"conv{i}"] = _conv(rng, STAGE_GEOM[i][0], cin, cout)
        visual[f"bn{i}"], vstate[f"bn{i}"] = _batchnorm(rng, cout)
    h, w = visual_spatial_trace(pre.frame_size, len(m.vis_channels))[-1]
    flat = m.vis_channels[-1] * h * w
    visual["head"] = _layer(rng, (flat, m.vis_feature_dim), flat)
    return visual, vstate


def _resnet_backbone(rng, m, pre):
    """The resnet (``models/resnet.py``, JAX ``resnet.py:67-86``): ``stem`` (7×7 at frames of 32 px and more,
    3×3 below) and ``bn_stem``, two blocks ``s{i}b{j}`` a stage with a 1×1 ``proj`` where the stride or the
    width changes, and the head."""
    visual, vstate = {}, {}
    chans = m.vis_channels
    visual["stem"] = _conv(rng, 7 if min(pre.frame_size) >= 32 else 3, pre.channels, chans[0])
    visual["bn_stem"], vstate["bn_stem"] = _batchnorm(rng, chans[0])
    cin = chans[0]
    for si, cout in enumerate(chans):
        for bi in range(2):
            stride = 2 if (bi == 0 and si > 0) else 1
            blk, bst = {"conv1": _conv(rng, 3, cin, cout), "conv2": _conv(rng, 3, cout, cout)}, {}
            blk["bn1"], bst["bn1"] = _batchnorm(rng, cout)
            blk["bn2"], bst["bn2"] = _batchnorm(rng, cout)
            if stride != 1 or cin != cout:
                blk["proj"] = _conv(rng, 1, cin, cout)
                blk["bn_proj"], bst["bn_proj"] = _batchnorm(rng, cout)
            visual[f"s{si}b{bi}"], vstate[f"s{si}b{bi}"] = blk, bst
            cin = cout
    visual["head"] = _layer(rng, (chans[-1], m.vis_feature_dim), chans[-1])
    return visual, vstate


def _vit_backbone(rng, m, pre):
    """The vit (``models/vit.py``, JAX ``vit.py:65-85``): ``patch``, learned ``pos`` (N(0, 0.02²) a token),
    ``head``, ``ln_out`` and ``vit_depth`` pre-LN ``blocks``; its state is empty."""
    check_vit_config(m)
    d, p = m.vit_embed_dim, m.vit_patch_size
    n_tokens = vit_grid(m, pre)[2]
    visual = {"patch": _layer(rng, (p * p * pre.channels, d), p * p * pre.channels),
              "pos": (0.02 * rng.standard_normal((n_tokens, d))).astype(np.float32),
              "head": _layer(rng, (d, m.vis_feature_dim), d), "ln_out": _layernorm(rng, d),
              "blocks": [_block(rng, d) for _ in range(m.vit_depth)]}
    return visual, {}


def _text_encoder(rng, m):
    """The text branch's tree (``models/text.py``): ``embed`` (V, d) drawn as N(0, 0.02²), ``head`` and
    ``text_num_layers`` pre-LN blocks."""
    check_text_config(m)
    d = m.text_embed_dim
    params = {"embed": (0.02 * rng.standard_normal((m.text_vocab_size, d))).astype(np.float32),
              "head": _layer(rng, (d, m.text_feature_dim), d), "layers": []}
    for _ in range(m.text_num_layers):
        params["layers"].append(_block(rng, d))
    return params


def _layernorm(rng, dim):
    # away from the identity (1, 0), so the scale and shift are exercised
    return {"scale": (1.0 + 0.1 * rng.standard_normal(dim)).astype(np.float32),
            "bias": (0.1 * rng.standard_normal(dim)).astype(np.float32)}


def _gru(rng, in_dim, hidden):
    return {"wx": _layer(rng, (in_dim, 3 * hidden), in_dim), "wh": _layer(rng, (hidden, 3 * hidden), hidden)}


def _transformer(rng, in_dim, mc, n_classes):
    md = mc.temporal_hidden
    if md % mc.temporal_num_heads:
        raise ValueError(f"temporal_hidden={md} is not a multiple of temporal_num_heads={mc.temporal_num_heads}")
    if mc.temporal_pos_encoding not in ("learned", "rotary"):
        raise ValueError(f"pos_encoding must be 'learned' or 'rotary', got {mc.temporal_pos_encoding!r}")
    params = {"proj_in": _layer(rng, (in_dim, md), in_dim), "head": _layer(rng, (md, n_classes), md), "layers": []}
    if mc.temporal_pos_encoding == "learned":
        params["pos"] = (0.02 * rng.standard_normal((mc.temporal_max_len, md))).astype(np.float32)
    for _ in range(mc.temporal_num_layers):
        params["layers"].append(_block(rng, md))
    return params


def _block(rng, d):
    """A pre-LN transformer block: ``ln1``, ``wq/wk/wv/wo``, ``ln2``, ``mlp_in`` (d → 4d), ``mlp_out``."""
    layer = {"ln1": _layernorm(rng, d)}
    for name in ("wq", "wk", "wv", "wo"):
        layer[name] = _layer(rng, (d, d), d)
    layer["ln2"] = _layernorm(rng, d)
    layer["mlp_in"] = _layer(rng, (d, 4 * d), d)
    layer["mlp_out"] = _layer(rng, (4 * d, d), 4 * d)
    return layer


def init_temporal_params(model_cfg, in_dim: int, seed: int, n_classes: int = 1):
    """A seeded numpy temporal head for ``model_cfg.temporal_model``, in the tree of the JAX
    package's ``temporal_head_init_auto`` (a fresh draw, not its JAX random stream)."""
    mc = model_cfg
    rng = np.random.default_rng(seed)
    h = mc.temporal_hidden
    if mc.temporal_model == "gru":
        return {"fwd": _gru(rng, in_dim, h), "bwd": _gru(rng, in_dim, h), "head": _layer(rng, (2 * h, n_classes), 2 * h)}
    if mc.temporal_model == "transformer":
        return _transformer(rng, in_dim, mc, n_classes)
    if mc.temporal_model == "hybrid":
        gru = {"fwd": _gru(rng, in_dim, h), "bwd": _gru(rng, in_dim, h)}
        return {"gru": gru, "transformer": _transformer(rng, in_dim + 2 * h, mc, n_classes)}
    raise ValueError(
        f"unknown temporal_model {mc.temporal_model!r} — expected 'gru', 'transformer', or 'hybrid'")


# ------------------------------------------------------------ checkpoints

_KEY_PART = re.compile(r"^\['(.*)'\]$|^\[(\d+)\]$")


def _insert(tree: dict, parts: list[str], value):
    """Place ``value`` at a jax key path; ``[i]`` parts build lists."""
    node = tree
    for j, part in enumerate(parts):
        m = _KEY_PART.match(part)
        if m is None:
            raise ValueError(f"unrecognised checkpoint key part {part!r}")
        key = m.group(1) if m.group(1) is not None else int(m.group(2))
        last = j == len(parts) - 1
        node = node.setdefault(key, value if last else {})
    return tree


def _lists(tree):
    """Dicts whose keys are all ints (the ``[i]`` parts) → lists in index order."""
    if not isinstance(tree, dict):
        return tree
    if tree and all(isinstance(k, int) for k in tree):
        return [_lists(tree[i]) for i in range(len(tree))]
    return {k: _lists(v) for k, v in tree.items()}


def load_jax_checkpoint(ckp_dir: str, tag: str = "ckp"):
    """Read ``<ckp_dir>/<tag>_state.npz`` as the JAX package writes it → (params, model_state).

    Keys are ``"/".join(str(p) for p in path)`` over jax key paths, e.g.
    ``['params']/['visual']/['conv0']/['w']`` or ``['params']/['fusion']/[0]/['w']``.
    The optimizer state and epoch in the same file are for training and are
    not returned.
    """
    tree: dict = {}
    with np.load(os.path.join(ckp_dir, f"{tag}_state.npz")) as data:
        for key in data.files:
            if key == "__epoch__":
                continue
            _insert(tree, key.split("/"), data[key])
    tree = _lists(tree)
    if "params" not in tree:
        raise ValueError(f"{ckp_dir}/{tag}_state.npz holds no 'params' tree")
    # a vit's batchnorm-free state ({"visual": {}}) has no leaf, so the npz holds no key for it
    model_state = tree.get("model_state", {})
    model_state.setdefault("visual", {})
    return tree["params"], model_state


def load_spotting_checkpoint(path: str, template, classes=None):
    """Read a temporal head's npz into ``template``'s structure → a numpy tree.

    The file's key set must match the template's (a learned-position head
    has a ``pos`` table a rotary template lacks), and leaf shapes must agree.
    When the file carries its training-time ``__classes__``, ``classes`` must
    name the same classes in the same order: channels are positional.
    """
    with np.load(path) as data:
        files = set(data.files)
        if "__classes__" in files:
            stored = [str(c) for c in data["__classes__"]]
            want = list(classes) if classes else None
            if want != stored:
                raise ValueError(
                    f"spotting checkpoint {path!r} was trained with classes {stored} but is being "
                    f"loaded with {want if want is not None else 'no --classes'} — channel order is "
                    "positional, so the names must match exactly"
                )
        keys = []
        _map_with_paths(lambda key, leaf: keys.append(key), template)
        missing = [k for k in keys if k not in files]
        extra = sorted(files - set(keys) - {"__classes__"})
        if missing or extra:
            raise ValueError(
                f"spotting checkpoint {path!r} does not match the configured scorer structure "
                f"(missing: {missing or '—'}; not in template: {extra or '—'}) — was the head trained "
                "with a different temporal_pos_encoding / temporal_model / --classes setting?"
            )

        def leaf(key, tmpl):
            stored = data[key]
            if stored.shape != tuple(tmpl.shape):
                raise ValueError(
                    f"spotting checkpoint {path!r}: shape mismatch for {key} ({stored.shape} vs {tuple(tmpl.shape)})")
            return stored

        return _map_with_paths(leaf, template)
