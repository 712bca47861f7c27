"""Reference-format PyTorch ``state_dict`` to the port's parameter trees and back.

Port of ``cvml_goalnet_tpu/compat/torch_import.py``.  Users of the reference
hold checkpoints saved by ``torch.save(model.state_dict())`` (reference
``main.py:263,282``), keyed by its module attributes (``visbl.conv1.weight``,
``audbl.linear3.bias``, ``fusion.0.weight`` … — reference
``utils.py:145-258``).  The port keeps the JAX package's layout
(``weights.py``), so the same transforms apply:

* conv2d ``(O, I, kH, kW)`` → HWIO; conv1d ``(O, I, K)`` → WIO;
* linear ``(O, I)`` → ``(I, O)``;
* the two flatten boundaries change order with the layout — visual: NCHW
  ``c·(H·W) + h·W + w`` → NHWC ``h·(W·C) + w·C + c``; audio: ``(C, L)``
  ``c·L + l`` → NWC ``l·C + c`` — so the first linear after each flatten
  gets its input features permuted (inverted with ``argsort`` on export);
* batchnorm ``weight/bias/running_mean/running_var`` → scale/bias + state.

:func:`import_reference_arrays` builds the trees as numpy arrays, exactly as
the JAX function builds its arrays; :func:`import_reference_state_dict`
carries them to the device with ``weights.from_jax``.  Both read torch
tensors or numpy arrays.  :func:`export_reference_state_dict` is the exact
inverse, so both round trips are bit-exact.
"""

from __future__ import annotations

import numpy as np
import torch

from cvml_goalnet_tpu_torch.config import AudioConfig, ModelConfig, PreprocessConfig
from cvml_goalnet_tpu_torch.models.audio import audio_temporal_trace
from cvml_goalnet_tpu_torch.models.visual import visual_spatial_trace
from cvml_goalnet_tpu_torch.weights import from_jax


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().numpy()
    return np.asarray(t)


def _conv2d(sd, prefix):
    return {"w": _np(sd[f"{prefix}.weight"]).transpose(2, 3, 1, 0),   # OIHW → HWIO
            "b": _np(sd[f"{prefix}.bias"])}


def _conv1d(sd, prefix):
    return {"w": _np(sd[f"{prefix}.weight"]).transpose(2, 1, 0),      # OIK → WIO
            "b": _np(sd[f"{prefix}.bias"])}


def _linear(sd, prefix, in_perm=None):
    w = _np(sd[f"{prefix}.weight"]).T    # (I, O)
    if in_perm is not None:
        w = w[in_perm]
    return {"w": w, "b": _np(sd[f"{prefix}.bias"])}


def _batchnorm(sd, prefix):
    params = {"scale": _np(sd[f"{prefix}.weight"]), "bias": _np(sd[f"{prefix}.bias"])}
    state = {"mean": _np(sd[f"{prefix}.running_mean"]), "var": _np(sd[f"{prefix}.running_var"])}
    return params, state


def _nchw_to_nhwc_flat_perm(c: int, h: int, w: int) -> np.ndarray:
    """perm[nhwc_index] = nchw_index for the flatten boundary."""
    idx = np.arange(c * h * w).reshape(c, h, w)     # value = nchw index
    return idx.transpose(1, 2, 0).reshape(-1)       # iterate in nhwc order


def _cl_to_lc_flat_perm(c: int, length: int) -> np.ndarray:
    idx = np.arange(c * length).reshape(c, length)
    return idx.transpose(1, 0).reshape(-1)


def _require_reference_backbone(cfg: ModelConfig, direction: str) -> None:
    """Only the reference's ``VisBl`` has a state_dict schema (``utils.py:145-195``): resnet and vit trees
    have no reference-format counterpart, so migration fails at the boundary, not mid-transform."""
    if cfg.vis_backbone != "reference":
        raise ValueError(
            f"checkpoint {direction} requires vis_backbone='reference' (the "
            f"topology the reference's state_dict schema describes) — got "
            f"{cfg.vis_backbone!r}"
        )


def import_reference_arrays(state_dict, cfg: ModelConfig, pre: PreprocessConfig, aud: AudioConfig):
    """Reference state_dict (torch tensors or numpy) → (params, model_state) as numpy trees in the JAX layout."""
    _require_reference_backbone(cfg, "import")
    sd = dict(state_dict)
    params: dict = {"visual": {}, "fusion": []}
    state: dict = {"visual": {}}

    # visual branch: conv1..3 + bnorm1..3 + linear5 (reference utils.py:151-170)
    for i in range(len(cfg.vis_channels)):
        params["visual"][f"conv{i}"] = _conv2d(sd, f"visbl.conv{i + 1}")
        params["visual"][f"bn{i}"], state["visual"][f"bn{i}"] = _batchnorm(sd, f"visbl.bnorm{i + 1}")
    h, w = visual_spatial_trace(pre.frame_size, len(cfg.vis_channels))[-1]
    params["visual"]["head"] = _linear(sd, "visbl.linear5", _nchw_to_nhwc_flat_perm(cfg.vis_channels[-1], h, w))

    # audio branch (reference utils.py:203-211)
    if cfg.audio_included and not any(k.startswith("audbl.") for k in sd):
        # leaving params["audio"] out would hand back a tree the config does not describe
        raise ValueError(
            "cfg.audio_included=True but the state_dict has no audbl.* keys "
            "— this is a visual-only reference checkpoint; import it with an "
            "audio_included=False config (the reference's --train-no-audio "
            "variant, main.py:31-38)"
        )
    if cfg.audio_included:
        params["audio"] = {f"conv{i}": _conv1d(sd, f"audbl.conv{i + 1}") for i in range(len(cfg.aud_channels))}
        t = audio_temporal_trace(aud.bin_length, len(cfg.aud_channels))[-1]
        params["audio"]["head"] = _linear(sd, "audbl.linear3", _cl_to_lc_flat_perm(cfg.aud_channels[-1], t))

    # the fusion Sequential: Linear layers at indices 0, 3, 6, 9, 12 (utils.py:242-256)
    li = 0
    while f"fusion.{li}.weight" in sd:
        params["fusion"].append(_linear(sd, f"fusion.{li}"))
        li += 3
    return params, state


def import_reference_state_dict(state_dict, cfg: ModelConfig, pre: PreprocessConfig, aud: AudioConfig,
                                device=None):
    """Reference state_dict → (params, model_state), the port's contiguous float32 tensors on ``device`` (None:
    the card), ready for ``avm_apply`` and ``TrainState``."""
    return from_jax(*import_reference_arrays(state_dict, cfg, pre, aud), device=device)


def _f32(x) -> np.ndarray:
    """A tensor or array as a writable float32 array (bf16-trained trees upcast here; reference checkpoints
    are float32)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).cpu().numpy().copy()
    return np.array(x, dtype=np.float32)


def _row_major(sd: dict) -> dict:
    """Every array of a state_dict in row-major order, as ``model.state_dict()``'s tensors are."""
    return {k: np.array(v, order="C") for k, v in sd.items()}


def export_reference_state_dict(params, model_state, cfg: ModelConfig, pre: PreprocessConfig,
                                aud: AudioConfig) -> dict:
    """Inverse of :func:`import_reference_state_dict`: the port's trees → a reference-format ``state_dict`` of
    numpy arrays, which the reference loads with its own ``load_state_dict`` (``main.py:65-66,326``).

    Every transform is the exact inverse of the import's (HWIO→OIHW, WIO→OIK,
    (I, O)→(O, I), the flatten permutations through ``argsort``).  Batchnorm
    ``num_batches_tracked`` is written as int64 0: ``load_state_dict(strict=True)``
    needs the key and the reference never reads it.
    """
    _require_reference_backbone(cfg, "export")
    sd: dict = {}
    for i in range(len(cfg.vis_channels)):
        c = params["visual"][f"conv{i}"]
        sd[f"visbl.conv{i + 1}.weight"] = _f32(c["w"]).transpose(3, 2, 0, 1)  # HWIO → OIHW
        sd[f"visbl.conv{i + 1}.bias"] = _f32(c["b"])
        bn_p, bn_s = params["visual"][f"bn{i}"], model_state["visual"][f"bn{i}"]
        sd[f"visbl.bnorm{i + 1}.weight"] = _f32(bn_p["scale"])
        sd[f"visbl.bnorm{i + 1}.bias"] = _f32(bn_p["bias"])
        sd[f"visbl.bnorm{i + 1}.running_mean"] = _f32(bn_s["mean"])
        sd[f"visbl.bnorm{i + 1}.running_var"] = _f32(bn_s["var"])
        sd[f"visbl.bnorm{i + 1}.num_batches_tracked"] = np.asarray(0, dtype=np.int64)
    h, w = visual_spatial_trace(pre.frame_size, len(cfg.vis_channels))[-1]
    perm = _nchw_to_nhwc_flat_perm(cfg.vis_channels[-1], h, w)
    head = params["visual"]["head"]
    # import: ours = ref.T[perm]  ⇒  ref.T = ours[argsort(perm)]
    sd["visbl.linear5.weight"] = _f32(head["w"])[np.argsort(perm)].T
    sd["visbl.linear5.bias"] = _f32(head["b"])

    if cfg.audio_included:
        if "audio" not in params:
            raise ValueError(
                "cfg.audio_included=True but the pytree has no 'audio' branch "
                "— export with the audio_included=False config this model was "
                "trained under"
            )
        for i in range(len(cfg.aud_channels)):
            c = params["audio"][f"conv{i}"]
            sd[f"audbl.conv{i + 1}.weight"] = _f32(c["w"]).transpose(2, 1, 0)  # WIO → OIK
            sd[f"audbl.conv{i + 1}.bias"] = _f32(c["b"])
        t = audio_temporal_trace(aud.bin_length, len(cfg.aud_channels))[-1]
        aperm = _cl_to_lc_flat_perm(cfg.aud_channels[-1], t)
        sd["audbl.linear3.weight"] = _f32(params["audio"]["head"]["w"])[np.argsort(aperm)].T
        sd["audbl.linear3.bias"] = _f32(params["audio"]["head"]["b"])

    for li, layer in enumerate(params["fusion"]):
        if not isinstance(layer, dict) or "w" not in layer:
            raise ValueError(
                "fusion layer %d is not a plain linear (MoE heads have no "
                "reference-format equivalent — export requires "
                "fusion_moe_experts=0)" % li
            )
        sd[f"fusion.{3 * li}.weight"] = _f32(layer["w"]).T
        sd[f"fusion.{3 * li}.bias"] = _f32(layer["b"])
    return _row_major(sd)
