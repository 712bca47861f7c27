"""Visual branch: the eval path with batchnorm folded into the next layer, and the train forward.

Port of ``cvml_goalnet_tpu/models/visual.py`` (reference ``VisBl``,
``utils.py:145-195``).  :func:`visual_encoder_apply` is the folded eval path
(JAX ``:93-162``): three
conv → ReLU → maxpool(3, s1) → batchnorm stages, channels (64, 256, 512),
spatial sizes 40→15→13→13→11→11→9, then flatten → linear(512) → ReLU.

Each eval batchnorm ``y = s·x + t`` is absorbed by the layer that consumes
it.  Its scale multiplies that layer's input-channel weights; its shift
becomes ``corr``, a batch-1 convolution over a t-filled map that carries the
conv bias and is exact at the zero-padded borders, added as a spatial bias.
Mapping onto the port's kernels:

* conv0 (k3 s3 p3, Cin 3) has no kernel of its own: ``F.conv2d`` + ReLU +
  ``F.max_pool2d``;
* conv1 and conv2 → ``fused_conv_pool_stage`` with ``b_spatial = corr[0]``
  and a zero conv bias;
* head → ``head_matmul`` on the NHWC flatten (N, 9·9·512) with the last
  batchnorm folded in; the flatten is channel-last, so the scale tiles as
  ``repeat(s, H·W)``.  Activations stay NHWC end to end.

The eval path runs in the input's dtype, as JAX's ``:93-162`` does: on bf16
frames (the caller casts params and state to bf16 first) the fold runs in
float32 from the bf16 statistics and weights, and the folded weights, ``corr``
and every activation are rounded to bf16, so kernels 2 and 3 take their bf16
forms.  ``quant`` (``quantized_inference``) routes conv1 and conv2 through
the int8 form of kernel 2 with the float32 folded weights, at float32 or bf16.

:func:`visual_encoder_train_apply` is the unfolded train forward (JAX
``:57-81``): conv → ReLU → maxpool → batchnorm on batch statistics, three
times, then the head, ReLU and dropout, all plain differentiable PyTorch ops
(``F.conv2d``, ``F.max_pool2d``, ``torch.matmul``).  The kernels have no
backward and their wrappers refuse tensors that require grad, so training
never reaches them.
"""

from __future__ import annotations

import torch

from cvml_goalnet_tpu_torch.models import layers as L
from cvml_goalnet_tpu_torch.ops.cuda.fused_stage import fused_conv_pool_stage, fused_conv_pool_stage_int8
from cvml_goalnet_tpu_torch.ops.cuda.matmul import head_matmul

# (kernel, stride, padding) per conv stage — reference utils.py:151-163.
STAGE_GEOM = ((3, 3, 3), (3, 1, 1), (3, 1, 1))
POOL = (3, 1)  # kernel, stride — reference utils.py:153


def visual_spatial_trace(hw: tuple[int, int], n_stages: int) -> list[tuple[int, int]]:
    """Spatial sizes after each conv+pool stage."""
    h, w = hw
    sizes = []
    for k, s, p in STAGE_GEOM[:n_stages]:
        h = L.conv_out_size(h, k, s, p)
        w = L.conv_out_size(w, k, s, p)
        h = L.conv_out_size(h, POOL[0], POOL[1], 0)
        w = L.conv_out_size(w, POOL[0], POOL[1], 0)
        sizes.append((h, w))
    return sizes


def visual_encoder_init(seed: int, cfg, pre) -> tuple[dict, dict]:
    """The reference stack's numpy (params, state) in the JAX layout (``conv0..2``, ``bn0..2``, ``head``; the
    batchnorm statistics), drawn from ``seed`` as ``weights.init_params`` draws them (JAX's
    ``visual_encoder_init`` takes a key; the draws differ)."""
    import numpy as np

    from cvml_goalnet_tpu_torch.weights import _reference_backbone

    return _reference_backbone(np.random.default_rng(seed), cfg, pre)


def visual_encoder_apply(params, state, x: torch.Tensor, quant: bool = False) -> torch.Tensor:
    """x (N, H, W, C) normalised frames → (N, vis_feature_dim) in x's dtype (float32 or bf16), eval mode;
    ``quant`` takes conv1 and conv2 through int8."""
    n, dt = x.shape[0], x.dtype
    n_stages = sum(1 for i in range(len(STAGE_GEOM)) if f"conv{i}" in params)
    s_prev = t_prev = None
    for i in range(n_stages):
        _, stride, pad = STAGE_GEOM[i]
        w, b = params[f"conv{i}"]["w"].to(torch.float32), params[f"conv{i}"]["b"].to(torch.float32)
        conv = {"w": w.to(dt), "b": b.to(dt)}
        if s_prev is None:
            x = L.maxpool2d(torch.relu(L.conv2d_apply(conv, x, stride, pad)), *POOL)
        else:
            t_map = t_prev.to(dt).expand(1, x.shape[1], x.shape[2], w.shape[2])
            corr = L.conv2d_apply(conv, t_map, stride, pad)[0].contiguous()
            w_folded = (w * s_prev[None, None, :, None]).contiguous()
            if quant:
                x = fused_conv_pool_stage_int8(x.contiguous(), w_folded, corr)
            else:
                x = fused_conv_pool_stage(x.contiguous(), w_folded.to(dt), corr)
        s_prev, t_prev = L.bn_affine(params[f"bn{i}"], state[f"bn{i}"])
    hw = x.shape[1] * x.shape[2]
    w = params["head"]["w"].to(torch.float32)
    w_folded = (w * s_prev.repeat(hw)[:, None]).to(dt)
    b_folded = L.linear_apply({"w": w, "b": params["head"]["b"].to(torch.float32)}, t_prev.repeat(hw)[None])[0]
    flat = x.contiguous().reshape(n, hw * x.shape[3])
    return head_matmul(flat, w_folded.contiguous(), b_folded.to(dt).contiguous(), relu=True)


def visual_encoder_train_apply(params, state, x: torch.Tensor, *, generator: torch.Generator | None,
                               dropout_rate: float, mask: torch.Tensor | None = None, bn_group=None):
    """x (N, H, W, C) normalised frames → ``((N, vis_feature_dim) features, new_state)`` in train mode.

    ``mask`` (N,) keeps padded rows out of the batchnorm statistics; with ``bn_group`` (a
    ``torch.distributed`` group) the statistics are those of every rank's rows; the head's dropout draws from
    ``generator``.
    """
    new_state = {}
    for i in range(len(STAGE_GEOM)):
        name = f"conv{i}"
        if name not in params:
            break
        _, stride, pad = STAGE_GEOM[i]
        x = L.maxpool2d(torch.relu(L.conv2d_apply(params[name], x, stride, pad)), *POOL)
        x, new_state[f"bn{i}"] = L.batchnorm_apply(params[f"bn{i}"], state[f"bn{i}"], x, True, mask=mask,
                                                   group=bn_group)
    x = x.reshape(x.shape[0], x.shape[1] * x.shape[2] * x.shape[3])
    x = torch.relu(L.linear_apply(params["head"], x))
    return L.dropout(x, dropout_rate, True, generator), new_state
