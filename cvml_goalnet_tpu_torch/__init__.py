"""PyTorch/CUDA port of cvml_goalnet_tpu for NVIDIA Hopper (H100).

The JAX package ``cvml_goalnet_tpu`` stays the reference; this package imports
neither it nor JAX.  Public API, as in the JAX package:
``extract_features`` → ``fuse`` / ``fuse_many`` → ``summarize``
(``pipeline.py``), with weights from ``weights.from_jax`` /
``weights.load_jax_checkpoint``.  Entry points run on the card unless the
caller passes ``device="cpu"``.
"""

from cvml_goalnet_tpu_torch.config import PipelineConfig
from cvml_goalnet_tpu_torch.pipeline import extract_features, fuse, fuse_many, summarize
from cvml_goalnet_tpu_torch.weights import from_jax, init_params, load_jax_checkpoint

__all__ = [
    "PipelineConfig",
    "extract_features",
    "from_jax",
    "fuse",
    "fuse_many",
    "init_params",
    "load_jax_checkpoint",
    "summarize",
]
