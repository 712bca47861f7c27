"""Training state: parameters, batchnorm statistics, Adam state and the epoch.

Port of ``cvml_goalnet_tpu/train/state.py``.  The trees keep the JAX layout
(``weights.py``) as float32 tensors on one device; the epoch is a host int,
checkpointed with the weights (the reference lost it on resume).
"""

from __future__ import annotations

from typing import Any, NamedTuple

from cvml_goalnet_tpu_torch.config import PipelineConfig
from cvml_goalnet_tpu_torch.train.optim import AdamState, adam_init
from cvml_goalnet_tpu_torch.weights import from_jax, init_params


class TrainState(NamedTuple):
    params: Any
    model_state: Any          # batchnorm running statistics
    opt_state: AdamState
    epoch: int


def create_train_state(seed: int, cfg: PipelineConfig, classifier: bool = False, device=None) -> TrainState:
    """A fresh state from ``weights.init_params(cfg, seed)`` on ``device`` (``None``: the card), Adam at step 0.

    The JAX function takes a PRNG key where this takes ``seed``; the draws differ (``weights.init_params``).
    """
    params, model_state = from_jax(*init_params(cfg, seed, classifier), device=device)
    return TrainState(params=params, model_state=model_state, opt_state=adam_init(params), epoch=0)
