"""The frame-importance model, eval forward.

Port of the eval path of ``cvml_goalnet_tpu/models/avm.py`` (reference
``AVM``, ``utils.py:229-272``) for the reference visual backbone: visual
features (512) with audio features (128) concatenated in front when
``cfg.audio_included`` ([audio ‖ visual], ``utils.py:266``), then the fusion
MLP 640→512→512→256→128→1 and ``(hi − lo)·σ + lo``, in one launch of
``fused_fusion_mlp``.  ``classifier=True`` returns the raw 5-way logits.
"""

from __future__ import annotations

import torch

from cvml_goalnet_tpu_torch.config import ModelConfig
from cvml_goalnet_tpu_torch.models.audio import audio_encoder_apply
from cvml_goalnet_tpu_torch.models.visual import visual_encoder_apply
from cvml_goalnet_tpu_torch.ops.cuda.fused_mlp import fused_fusion_mlp

N_CLASSES = 5  # classifier-mode output arity (importance grades 1..5)


def fusion_input_dim(cfg: ModelConfig) -> int:
    dim = cfg.vis_feature_dim
    if cfg.audio_included:
        dim += cfg.aud_feature_dim
    if cfg.text_included:
        dim += cfg.text_feature_dim
    return dim


def check_supported(cfg: ModelConfig) -> None:
    """Raise for the model options this slice of the port does not run yet."""
    later = {
        "vis_backbone": (cfg.vis_backbone != "reference", "the resnet and vit families"),
        "fusion_moe_experts": (cfg.fusion_moe_experts > 0, "the mixture-of-experts fusion"),
        "text_included": (cfg.text_included, "the text branch"),
        "quantized_inference": (cfg.quantized_inference, "int8 inference"),
        "dtype": (cfg.dtype != "float32", "bf16"),
    }
    for name, (unsupported, what) in later.items():
        if unsupported:
            raise NotImplementedError(
                f"ModelConfig.{name}={getattr(cfg, name)!r}: {what} is not ported yet "
                "(a later slice of the PyTorch port; this slice runs the float32 "
                "reference backbone)"
            )


def avm_apply(params, state, visual: torch.Tensor, audio: torch.Tensor | None = None, *,
              cfg: ModelConfig, classifier: bool = False) -> torch.Tensor:
    """Eval forward → (N, 1) scores in [out_lo, out_hi], or (N, 5) logits with ``classifier``."""
    check_supported(cfg)
    parts = [visual_encoder_apply(params["visual"], state["visual"], visual)]
    if cfg.audio_included:
        parts.insert(0, audio_encoder_apply(params["audio"], audio))
    x = torch.cat(parts, dim=-1) if len(parts) > 1 else parts[0]
    return fused_fusion_mlp(x.contiguous(), params["fusion"], cfg.out_lo, cfg.out_hi, squash=not classifier)
