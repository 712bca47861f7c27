"""The frame-importance model: the eval forward and the train forward.

Port of ``cvml_goalnet_tpu/models/avm.py`` (reference ``AVM``,
``utils.py:229-272``) for the reference visual backbone: visual features
(512) with audio features (128) concatenated in front when
``cfg.audio_included`` ([audio ‖ visual], ``utils.py:266``), then the fusion
MLP 640→512→512→256→128→1 and ``(hi − lo)·σ + lo``.  ``classifier=True``
returns the raw 5-way logits.

* :func:`avm_apply` is the eval forward: the folded visual trunk (kernels 2
  and 3) and the fusion MLP in one launch of ``fused_fusion_mlp`` (kernel 4),
  in the dtype of its inputs (float32, or bf16 once the caller has cast
  params, state and features as ``pipeline.fuse`` does), with conv1 and
  conv2 through int8 under ``cfg.quantized_inference``.
* :func:`avm_train_apply` is JAX's ``avm_apply(train=True, rng=…,
  valid=…)``: the unfolded visual trunk with batch-statistics batchnorm
  (``valid`` keeps padded rows out of them), linear → ReLU → dropout per
  hidden fusion layer, all plain differentiable ops, and the new batchnorm
  state.  Where JAX splits its key into one key for the visual branch and
  one per hidden fusion layer, the dropouts here draw from one generator in
  that order.
"""

from __future__ import annotations

import torch

from cvml_goalnet_tpu_torch.config import ModelConfig
from cvml_goalnet_tpu_torch.models import layers as L
from cvml_goalnet_tpu_torch.models.audio import audio_encoder_apply
from cvml_goalnet_tpu_torch.models.visual import visual_encoder_apply, visual_encoder_train_apply
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
    }
    for name, (unsupported, what) in later.items():
        if unsupported:
            raise NotImplementedError(
                f"ModelConfig.{name}={getattr(cfg, name)!r}: {what} is not ported yet "
                "(ROADMAP.md §1 item 5, a later slice of the PyTorch port; the port runs the reference "
                "backbone)"
            )


def avm_apply(params, state, visual: torch.Tensor, audio: torch.Tensor | None = None, *,
              cfg: ModelConfig, classifier: bool = False) -> torch.Tensor:
    """Eval forward → (N, 1) scores in [out_lo, out_hi], or (N, 5) logits with ``classifier``, in the inputs'
    dtype."""
    check_supported(cfg)
    parts = [visual_encoder_apply(params["visual"], state["visual"], visual, quant=cfg.quantized_inference)]
    if cfg.audio_included:
        parts.insert(0, audio_encoder_apply(params["audio"], audio))
    x = torch.cat(parts, dim=-1) if len(parts) > 1 else parts[0]
    return fused_fusion_mlp(x.contiguous(), params["fusion"], cfg.out_lo, cfg.out_hi, squash=not classifier)


def avm_train_apply(params, state, visual: torch.Tensor, audio: torch.Tensor | None = None, *, cfg: ModelConfig,
                    generator: torch.Generator | None = None, classifier: bool = False,
                    valid: torch.Tensor | None = None):
    """Train-mode forward → ``((N, 1) scores or (N, 5) logits, new_state)``.

    ``valid`` (N,) marks the real rows of a zero-padded batch (the batchnorm
    statistics count only those).  The dropouts draw from ``generator``: the
    visual head's first, then each hidden fusion layer's.  Without a
    generator and with ``dropout_rate > 0`` it raises, as the JAX function
    does without a key: a fixed mask would train a fixed sparse subnetwork.
    """
    check_supported(cfg)
    if generator is None and cfg.dropout_rate > 0:
        raise ValueError("avm_train_apply with dropout_rate > 0 requires a generator")
    feats, vis_state = visual_encoder_train_apply(params["visual"], state["visual"], visual, generator=generator,
                                                  dropout_rate=cfg.dropout_rate, mask=valid)
    parts = [feats]
    if cfg.audio_included:
        parts.insert(0, audio_encoder_apply(params["audio"], audio))
    x = torch.cat(parts, dim=-1) if len(parts) > 1 else parts[0]
    n_hidden = len(cfg.fusion_hidden)
    for i, lp in enumerate(params["fusion"]):
        x = L.linear_apply(lp, x)
        if i < n_hidden:
            x = L.dropout(torch.relu(x), cfg.dropout_rate, True, generator)
    out = x if classifier else (cfg.out_hi - cfg.out_lo) * torch.sigmoid(x) + cfg.out_lo
    return out, {**state, "visual": vis_state}
