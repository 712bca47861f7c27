"""The frame-importance model: the eval forward and the train forward.

Port of ``cvml_goalnet_tpu/models/avm.py`` (reference ``AVM``,
``utils.py:229-272``): visual features (512, from the backbone that
``cfg.vis_backbone`` names: :func:`visual_apply`) with audio features (128)
concatenated in front when ``cfg.audio_included`` ([audio ‖ visual], ``utils.py:266``) and the text
branch's features (128) behind when ``cfg.text_included`` ([audio ‖ visual
‖ text]), then the fusion MLP (640 or 768 → 512 → 512 → 256 → 128 → 1) and
``(hi − lo)·σ + lo``.  ``classifier=True`` returns the raw 5-way logits.
With ``cfg.fusion_moe_experts > 0`` the fusion's first layer is a mixture
of experts (``models/moe.py``).

* :func:`avm_apply` is the eval forward: the visual backbone (the reference
  backbone's folded trunk on kernels 2 and 3, or the resnet or vit
  backbone), the text encoder and the MoE layer in plain PyTorch, and the
  fusion MLP in one launch of ``fused_fusion_mlp`` (kernel 4): the whole
  chain, or after an MoE layer and its ReLU the chain's remaining layers.
  It runs in the dtype of its inputs (float32, or bf16 once the caller has
  cast params, state and features as ``pipeline.fuse`` does), with the
  backbone's int8 path under ``cfg.quantized_inference``.
* :func:`avm_train_apply` is JAX's ``avm_apply(train=True, rng=…,
  valid=…)``: the backbone's train forward with batch-statistics batchnorm
  (``valid`` keeps padded rows out of them), the text encoder, linear (or
  MoE) → ReLU → dropout per hidden fusion layer, all plain differentiable
  ops, and the new batchnorm state; ``return_moe_probs`` adds the gate's
  combine weights for the load-balance loss.  With ``tp`` (a model axis) the
  fusion MLP runs tensor parallel in Megatron's layout
  (:func:`fusion_train_apply`).  Where JAX splits its key into
  one key for the visual branch and one per hidden fusion layer, the
  dropouts here draw from one generator in that order.
"""

from __future__ import annotations

import torch

from cvml_goalnet_tpu_torch.config import ModelConfig
from cvml_goalnet_tpu_torch.device import strict_f32
from cvml_goalnet_tpu_torch.models import layers as L
from cvml_goalnet_tpu_torch.models.audio import audio_encoder_apply
from cvml_goalnet_tpu_torch.models.moe import moe_apply, moe_gate_probs
from cvml_goalnet_tpu_torch.models.resnet import resnet_encoder_apply, resnet_encoder_train_apply
from cvml_goalnet_tpu_torch.models.text import text_encoder_apply
from cvml_goalnet_tpu_torch.models.visual import visual_encoder_apply, visual_encoder_train_apply
from cvml_goalnet_tpu_torch.models.vit import vit_encoder_apply, vit_encoder_train_apply
from cvml_goalnet_tpu_torch.ops.cuda.fused_mlp import fused_fusion_mlp

N_CLASSES = 5  # classifier-mode output arity (importance grades 1..5)


def fusion_input_dim(cfg: ModelConfig) -> int:
    dim = cfg.vis_feature_dim
    if cfg.audio_included:
        dim += cfg.aud_feature_dim
    if cfg.text_included:
        dim += cfg.text_feature_dim
    return dim


def visual_apply(cfg: ModelConfig):
    """The backbone ``cfg.vis_backbone`` names → ``(apply, train_apply)``, JAX ``_visual_init``'s dispatch.

    ``apply(params, state, x, quant=False)`` → (N, vis_feature_dim) features (eval);
    ``train_apply(params, state, x, *, generator, dropout_rate, mask=None)`` → ``(features, new_state)``.
    The vit's static geometry (heads, patch) is closed over.  An unknown name raises, as in JAX: it would
    otherwise build the reference stack under another name."""
    if cfg.vis_backbone == "resnet":
        return resnet_encoder_apply, resnet_encoder_train_apply
    if cfg.vis_backbone == "vit":
        geom = {"num_heads": cfg.vit_num_heads, "patch": cfg.vit_patch_size}

        def apply(params, state, x, quant=False):
            return vit_encoder_apply(params, state, x, quant=quant, **geom)

        def train_apply(params, state, x, **kw):
            return vit_encoder_train_apply(params, state, x, **geom, **kw)

        return apply, train_apply
    if cfg.vis_backbone != "reference":
        raise ValueError(
            f"unknown vis_backbone {cfg.vis_backbone!r} "
            "(reference | resnet | vit)"
        )
    return visual_encoder_apply, visual_encoder_train_apply


def _fused_input(params, feats: torch.Tensor, audio, text, cfg: ModelConfig) -> torch.Tensor:
    """[audio ‖ visual ‖ text]: the fusion MLP's input."""
    parts = [feats]
    if cfg.audio_included:
        parts.insert(0, audio_encoder_apply(params["audio"], audio))
    if cfg.text_included:
        if text is None:
            raise ValueError("cfg.text_included=True but no text token ids were given")
        parts.append(text_encoder_apply(params["text"], text, cfg=cfg))
    return torch.cat(parts, dim=-1) if len(parts) > 1 else parts[0]


def _moe_layer(lp, x: torch.Tensor, cfg: ModelConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """The MoE first layer → (its output before the ReLU, the gate's (N, E) combine weights)."""
    probs = moe_gate_probs(lp, x, cfg.fusion_moe_top_k)
    return moe_apply(lp, x, cfg.fusion_moe_top_k, probs=probs), probs


def avm_init(seed: int, cfg: ModelConfig, pre, aud, classifier: bool = False) -> tuple[dict, dict]:
    """The whole model's numpy (params, state) in the JAX layout for ``cfg`` (every backbone, audio, text and
    MoE option), drawn from ``seed`` by ``weights.init_params`` (JAX's ``avm_init`` takes a key; the draws
    differ).  ``weights.from_jax`` moves it to a device."""
    from cvml_goalnet_tpu_torch.config import PipelineConfig
    from cvml_goalnet_tpu_torch.weights import init_params

    return init_params(PipelineConfig(preprocess=pre, audio=aud, model=cfg), seed, classifier)


def avm_apply(params, state, visual: torch.Tensor, audio: torch.Tensor | None = None, text=None, *,
              cfg: ModelConfig, classifier: bool = False) -> torch.Tensor:
    """Eval forward → (N, 1) scores in [out_lo, out_hi], or (N, 5) logits with ``classifier``, in the inputs'
    dtype.  ``text`` (N, text_max_len) token ids, with ``cfg.text_included``."""
    apply, _ = visual_apply(cfg)
    feats = apply(params["visual"], state["visual"], visual, quant=cfg.quantized_inference)
    x = _fused_input(params, feats, audio, text, cfg)
    layers = params["fusion"]
    if cfg.fusion_moe_experts > 0:
        x, _ = _moe_layer(layers[0], x, cfg)
        layers = layers[1:]
        if layers:   # ReLU after a hidden layer; with no hidden layer the MoE layer gives the logits
            x = torch.relu(x)
    return fused_fusion_mlp(x.contiguous(), layers, cfg.out_lo, cfg.out_hi, squash=not classifier)


def avm_train_apply(params, state, visual: torch.Tensor, audio: torch.Tensor | None = None, text=None, *,
                    cfg: ModelConfig, generator: torch.Generator | None = None, classifier: bool = False,
                    valid: torch.Tensor | None = None, return_moe_probs: bool = False, bn_group=None, tp=None):
    """Train-mode forward → ``((N, 1) scores or (N, 5) logits, new_state)``, and the MoE gate's (N, E)
    combine weights third with ``return_moe_probs`` (which needs ``fusion_moe_experts > 0``).

    ``valid`` (N,) marks the real rows of a zero-padded batch (the batchnorm
    statistics count only those).  With ``bn_group`` (a ``torch.distributed``
    group, the data-parallel step's) the batchnorm statistics are those of the
    global batch, every rank's rows together.  With ``tp`` (the rank's ``parallel.mesh.Axis`` of the model
    axis) ``params["fusion"]`` is the rank's slice of the fusion layout and the MLP runs tensor parallel
    (:func:`fusion_train_apply`).  The dropouts draw from ``generator``: the
    visual head's first, then each hidden fusion layer's.  Without a
    generator and with ``dropout_rate > 0`` it raises, as the JAX function
    does without a key: a fixed mask would train a fixed sparse subnetwork.
    """
    _, train_apply = visual_apply(cfg)
    if generator is None and cfg.dropout_rate > 0:
        raise ValueError("avm_train_apply with dropout_rate > 0 requires a generator")
    feats, vis_state = train_apply(params["visual"], state["visual"], visual, generator=generator,
                                   dropout_rate=cfg.dropout_rate, mask=valid, bn_group=bn_group)
    x = _fused_input(params, feats, audio, text, cfg)
    x, moe_probs = fusion_train_apply(params["fusion"] if tp is None else [params["fusion"]], x, cfg, generator, tp)
    out = x if classifier else (cfg.out_hi - cfg.out_lo) * torch.sigmoid(x) + cfg.out_lo
    new_state = {**state, "visual": vis_state}
    if return_moe_probs:
        if moe_probs is None:
            raise ValueError("return_moe_probs requires fusion_moe_experts > 0")
        return out, new_state, moe_probs
    return out, new_state


def fusion_train_apply(layers, x: torch.Tensor, cfg: ModelConfig, generator: torch.Generator | None = None,
                       tp=None) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The train forward of the fusion MLP: linear (or MoE) → ReLU → dropout per hidden layer, then the last
    layer → (its output before the squash, the MoE gate's combine weights or None).

    With ``tp`` (a lock-step view of a model axis: a rank's ``parallel.mesh.Axis``, or ``VirtualAxis``
    for every rank in one process) ``layers`` is a list of the held ranks' slices of the fusion layout
    (``parallel/sharding.py::fusion_param_shardings``) and the MLP runs Megatron's way: a column-parallel
    layer reads its input through the axis's copy, a row-parallel one sums its partial products over the
    axis and then adds its bias once, a whole layer (the last, an MoE layer) gathers a split input first and
    a row-parallel one takes its slice of a whole input.  Each dropout draws the whole layer's mask from
    ``generator`` and a split layer keeps its slice of it, so the result is the unsplit MLP's at the same
    generator state.
    """
    n_hidden = len(cfg.fusion_hidden)
    rate = cfg.dropout_rate
    if tp is None:
        moe_probs = None
        for i, lp in enumerate(layers):
            if i == 0 and cfg.fusion_moe_experts > 0:
                x, moe_probs = _moe_layer(lp, x, cfg)
            else:
                x = L.linear_apply(lp, x)
            if i < n_hidden:
                x = L.dropout(torch.relu(x), rate, True, generator)
        return x, moe_probs

    from cvml_goalnet_tpu_torch.parallel.sharding import fusion_layer_split

    n_layers = len(layers[0])
    xs, split, moe_probs = [x] * len(tp.lanes), False, None
    for i in range(n_layers):
        lps = [held[i] for held in layers]
        how = fusion_layer_split(i, n_layers, lps[0])
        if how == "whole":
            if split:
                xs = tp.gather(xs)
            if "experts" in lps[0]:
                outs = [_moe_layer(lp, h, cfg) for lp, h in zip(lps, xs)]
                xs, moe_probs = [o for o, _ in outs], outs[0][1]
            else:
                xs = [L.linear_apply(lp, h) for lp, h in zip(lps, xs)]
        elif how == "cols":   # after a row-parallel or whole layer: its input is whole
            xs = [L.linear_apply(lp, h) for lp, h in zip(lps, tp.copy(xs))]
        else:
            if not split:
                xs = tp.scatter(xs)
            with strict_f32():
                parts = [torch.matmul(h, lp["w"]) for lp, h in zip(lps, xs)]
            xs = [h + lp["b"] for lp, h in zip(lps, tp.reduce(parts))]
        split = how == "cols"
        if i < n_hidden:
            xs = [torch.relu(h) for h in xs]
            if rate > 0:
                width = xs[0].shape[1] * (tp.size if split else 1)
                kept = L.dropout_keep((xs[0].shape[0], width), rate, generator, xs[0].device, xs[0].dtype)
                w = xs[0].shape[1]
                xs = [L.apply_keep(h, kept[:, j * w:(j + 1) * w] if split else kept, rate)
                      for j, h in zip(tp.lanes, xs)]
    return xs[0], moe_probs
