"""ResNet visual backbone (``ModelConfig.vis_backbone = "resnet"``): the eval, int8 and train forwards.

Port of ``cvml_goalnet_tpu/models/resnet.py``.  NHWC basic-block ResNet:
stem → stages of two 3×3 conv blocks with identity or 1×1 projection
shortcuts → global average pool → linear head → ReLU.  The stem's variant
comes from its weight's spatial size, as the checkpoint carries it: 7 is
the ImageNet stem (7×7 stride-2 conv + 3×3 stride-2 max pool, padded with
−inf), 3 the CIFAR stem (3×3 stride 1, no pool).  A block has a projection
wherever its ``proj`` key exists, and stages are walked while ``s{i}b0``
exists.  At ``configs/reference_parity.json``'s widths (channels 64, 256,
512, 40×40 frames) the spatial sizes are 40 → 20 → 10 (stage 0) → 5 → 3.

* :func:`resnet_encoder_apply` is the eval forward, batchnorm applied
  unfolded on the running statistics as the JAX package's is, in the
  input's dtype (float32, or bf16 rounding per operation as JAX's eager bf16
  forward does).  With ``quant`` every block's batchnorms are folded into
  their convs (``_bn_fold``) and the two 3×3 convs run through int8
  (``ops/quant.py::quantized_conv2d``: one activation scale over the whole
  batch at each of the twelve points); the stem's batchnorm stays unfolded
  and the projection shortcut stays float.
* :func:`resnet_encoder_train_apply` is the train forward: batch statistics
  (``mask`` keeps padded rows out of them), the new running statistics,
  and the head's dropout drawn from ``generator``.

Every op is a library call (cuDNN, cuBLAS and cuBLAS's int8 GEMM on the
card, TF32 off): the JAX package computes this backbone in XLA, with no
Pallas kernel.
"""

from __future__ import annotations

import torch

from cvml_goalnet_tpu_torch.models import layers as L
from cvml_goalnet_tpu_torch.ops.quant import quantized_conv2d


def _blocks(params):
    """``(name, stride)`` of every block in order: stages while ``s{si}b0`` exists, two blocks each, the first
    block of every stage but the first at stride 2."""
    si = 0
    while f"s{si}b0" in params:
        for bi in range(2):
            yield f"s{si}b{bi}", 2 if (bi == 0 and si > 0) else 1
        si += 1


def _project(proj, x: torch.Tensor, stride: int) -> torch.Tensor:
    """The 1×1 projection shortcut, ``conv2d_apply(proj, x, stride, padding=0)``, as the linear map of the
    strided pixels it is (the same sums and, on bf16, the same roundings).  PyTorch's CPU backward of a 1×1
    stride-2 convolution of a channel-last float32 input corrupts the heap (seen at 24×24, 8 → 16 channels),
    which the train forward would reach."""
    return L.linear_apply({"w": proj["w"][0, 0], "b": proj["b"]}, x[:, ::stride, ::stride, :])


def _block_apply(params, state, x: torch.Tensor, stride: int, train: bool, mask=None, group=None):
    new_state = {}
    y = L.conv2d_apply(params["conv1"], x, stride=stride, padding=1)
    y, new_state["bn1"] = L.batchnorm_apply(params["bn1"], state["bn1"], y, train, mask=mask, group=group)
    y = torch.relu(y)
    y = L.conv2d_apply(params["conv2"], y, stride=1, padding=1)
    y, new_state["bn2"] = L.batchnorm_apply(params["bn2"], state["bn2"], y, train, mask=mask, group=group)
    if "proj" in params:
        x = _project(params["proj"], x, stride)
        x, new_state["bn_proj"] = L.batchnorm_apply(params["bn_proj"], state["bn_proj"], x, train, mask=mask,
                                                    group=group)
    return torch.relu(x + y), new_state


def _stem_apply(params, state, x: torch.Tensor, train: bool, mask=None, group=None):
    """The stem in the checkpoint's variant → ``(x, new bn_stem state)``."""
    imagenet = params["stem"]["w"].shape[0] == 7
    x = L.conv2d_apply(params["stem"], x, stride=2 if imagenet else 1, padding=3 if imagenet else 1)
    x, bn_state = L.batchnorm_apply(params["bn_stem"], state["bn_stem"], x, train, mask=mask, group=group)
    x = torch.relu(x)
    if imagenet:
        x = L.maxpool2d(x, kernel=3, stride=2, padding=1)
    return x, bn_state


def _bn_fold(conv, bn_p, bn_s, eps: float = 1e-5) -> tuple[torch.Tensor, torch.Tensor]:
    """An output-side eval batchnorm folded into the conv that produces it → float32 ``(w·s, b·s + t)``."""
    f32 = torch.float32
    s = bn_p["scale"].to(f32) * torch.rsqrt(bn_s["var"].to(f32) + eps)
    t = bn_p["bias"].to(f32) - bn_s["mean"].to(f32) * s
    return conv["w"].to(f32) * s[None, None, None, :], conv["b"].to(f32) * s + t


def _block_apply_quant(params, state, x: torch.Tensor, stride: int) -> torch.Tensor:
    """The eval block with its batchnorms folded: the 3×3 convs through int8, the projection and the residual
    add in x's dtype."""
    w1, b1 = _bn_fold(params["conv1"], params["bn1"], state["bn1"])
    y = torch.relu(quantized_conv2d(x, w1, stride=stride, padding=1) + b1.to(x.dtype))
    w2, b2 = _bn_fold(params["conv2"], params["bn2"], state["bn2"])
    y = quantized_conv2d(y, w2, stride=1, padding=1) + b2.to(x.dtype)
    if "proj" in params:
        wp, bp = _bn_fold(params["proj"], params["bn_proj"], state["bn_proj"])
        x = _project({"w": wp.to(x.dtype), "b": bp.to(x.dtype)}, x, stride)
    return torch.relu(x + y)


def _pool_head(params, x: torch.Tensor) -> torch.Tensor:
    """Global average pool → head → ReLU."""
    return torch.relu(L.linear_apply(params["head"], L.mean(x, (1, 2))))


def resnet_encoder_apply(params, state, x: torch.Tensor, quant: bool = False) -> torch.Tensor:
    """x (N, H, W, C) normalised frames → (N, vis_feature_dim) in x's dtype, eval mode; ``quant`` takes every
    block's 3×3 convs through int8."""
    x, _ = _stem_apply(params, state, x, False)
    for name, stride in _blocks(params):
        if quant:
            x = _block_apply_quant(params[name], state[name], x, stride)
        else:
            x, _ = _block_apply(params[name], state[name], x, stride, False)
    return _pool_head(params, x)


def resnet_encoder_train_apply(params, state, x: torch.Tensor, *, generator: torch.Generator | None,
                               dropout_rate: float, mask: torch.Tensor | None = None, bn_group=None):
    """x (N, H, W, C) → ``((N, vis_feature_dim) features, new_state)`` in train mode: batchnorm on the batch
    statistics of the rows ``mask`` (N,) marks valid (of every rank of ``bn_group`` with one), the head's
    dropout from ``generator``."""
    new_state = {}
    x, new_state["bn_stem"] = _stem_apply(params, state, x, True, mask=mask, group=bn_group)
    for name, stride in _blocks(params):
        x, new_state[name] = _block_apply(params[name], state[name], x, stride, True, mask=mask, group=bn_group)
    return L.dropout(_pool_head(params, x), dropout_rate, True, generator), new_state
