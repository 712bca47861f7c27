"""PyTorch/CUDA port of cvml_goalnet_tpu for NVIDIA Hopper (H100).

The JAX package ``cvml_goalnet_tpu`` stays the reference; this package imports
neither it nor JAX.  Public API, as in the JAX package:
``extract_features`` → ``fuse`` / ``fuse_many`` → ``summarize``
(``pipeline.py``), with weights from ``weights.from_jax`` /
``weights.load_jax_checkpoint``; and event spotting, ``encode_timeline`` →
``score_timeline_auto`` → ``spot_events`` / ``summarize_match``, or
``spot_stream`` over a live stream (``spotting.py``), with temporal heads from
``weights.init_temporal_params`` / ``weights.load_spotting_checkpoint``; and
training of those heads, ``make_spotting_train_step`` / ``init_spotting_opt``
/ ``save_spotting_checkpoint`` (``train/spotting.py``, Adam from
``train/optim.py``); and training of the summarization model,
``train/loop.py::train_importance_model`` (with ``train/resilience.py``,
``baseline.py`` and the CLI verbs ``train``, ``eval`` and ``baseline``); and
serving (``serve.py``): the long-lived ``Summarizer`` and ``Spotter``, the
cross-request ``DynamicBatcher`` and the JSON-over-HTTP server
``serve_http`` (``/summarize``, ``/spot``, ``/spot-stream``, ``/reload``,
``/metrics``, ``/healthz``), data-parallel over several cards with ``mesh=``
(``parallel/``); data-parallel training (``train/dp_loop.py``); and the
reference checkpoint bridge (``compat/``).  The CLI (``cli.py``,
``goalnet-torch``) has every verb of the JAX CLI: ``train`` (``--dp``),
``eval``, ``baseline``, ``infer``, ``profile``, ``spot``, ``spot-train``,
``serve`` (``--dp``), ``import-torch`` and ``export-torch``.  Entry
points run on the card unless the caller passes ``device="cpu"``; the
training steps run where their tensors are.
"""

from cvml_goalnet_tpu_torch.config import PipelineConfig
from cvml_goalnet_tpu_torch.pipeline import extract_features, fuse, fuse_many, summarize
from cvml_goalnet_tpu_torch.spotting import (
    encode_timeline,
    score_timeline_auto,
    spot_events,
    spot_stream,
    summarize_match,
)
from cvml_goalnet_tpu_torch.train.spotting import (
    init_spotting_opt,
    make_spotting_train_step,
    save_spotting_checkpoint,
)
from cvml_goalnet_tpu_torch.weights import (
    from_jax,
    init_params,
    init_temporal_params,
    load_jax_checkpoint,
    load_spotting_checkpoint,
    tree_from_jax,
)

__all__ = [
    "PipelineConfig",
    "encode_timeline",
    "extract_features",
    "from_jax",
    "fuse",
    "fuse_many",
    "init_params",
    "init_spotting_opt",
    "init_temporal_params",
    "load_jax_checkpoint",
    "load_spotting_checkpoint",
    "make_spotting_train_step",
    "save_spotting_checkpoint",
    "score_timeline_auto",
    "spot_events",
    "spot_stream",
    "summarize",
    "summarize_match",
    "tree_from_jax",
]
