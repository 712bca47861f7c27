"""Typed configuration layer (the PyTorch port's own copy).

A field-for-field copy of ``cvml_goalnet_tpu/config.py``: the JAX package's
module cannot be imported without importing JAX (its package ``__init__``
pulls in the pipeline), so the port keeps this copy.  Both read the same
``configs/*.json`` files; ``tests/test_torch_config_weights.py`` round-trips
every one of them through both layers.

The reference has no config system — every hyperparameter is a hard-coded
constant scattered through ``main.py:31-53``, ``utils.py:333,466,629`` and
``main.py:311`` (see SURVEY.md §5 "Config / flag system — ABSENT").  Here the
whole pipeline is driven by frozen dataclasses that serialize to/from JSON, so
experiments are reproducible and the CLI / tests / benchmarks share one source
of truth.

Defaults reproduce the reference's training setup (reference ``main.py:45-53``):
``skip_frames=30``, 40×40 frames, MFCC with ``n_mfcc=30`` and ``bin_length=30``,
Adam ``lr=1e-3``, sub-batches of 10 frames, 150 epochs, knapsack budget 15%
with weight scale factor 5.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any


def _asdict(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: _asdict(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, (list, tuple)):
        return [_asdict(x) for x in obj]
    return obj


def _fromdict(cls: type, d: dict, path: str = "config") -> Any:
    # Unknown keys fail loudly: a typo'd hyperparameter ("skip_frame",
    # "learning_rte") must not silently run with the default value.
    known = {f.name for f in dataclasses.fields(cls)}
    unknown = sorted(set(d) - known)
    if unknown:
        raise ValueError(
            f"unknown config key(s) {unknown} under '{path}' (known: {sorted(known)})"
        )
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        if dataclasses.is_dataclass(f.type) if isinstance(f.type, type) else False:
            kwargs[f.name] = _fromdict(f.type, v, path=f"{path}.{f.name}")
        elif isinstance(v, dict) and dataclasses.is_dataclass(_CONFIG_TYPES.get(f.name, object)):
            kwargs[f.name] = _fromdict(_CONFIG_TYPES[f.name], v, path=f"{path}.{f.name}")
        elif isinstance(v, list):
            kwargs[f.name] = tuple(v)
        else:
            kwargs[f.name] = v
    return cls(**kwargs)


@dataclass(frozen=True)
class PreprocessConfig:
    """Frame decimation + normalize + resize contract (reference ``utils.py:274-292``)."""

    skip_frames: int = 30          # keep 1 frame every `skip_frames` raw frames
    frame_size: tuple[int, int] = (40, 40)  # (H, W) after resize
    channels: int = 3
    # Reference normalizes min-max over the WHOLE frame (all channels jointly)
    # BEFORE resizing (utils.py:284-285); we preserve that contract.
    eps: float = 1e-7
    # Channel order of decoded frames. cv2 decodes BGR (reference behavior);
    # our decoder keeps whatever the host decoder produces and records it here.
    channel_order: str = "bgr"
    # Expected decoded (H, W) of production serving/streaming inputs; drives
    # the Summarizer's default warmup shape so forgetting warmup(shapes=...)
    # compiles the REAL shape, not a toy one.
    serving_raw_hw: tuple[int, int] = (180, 320)


@dataclass(frozen=True)
class AudioConfig:
    """MFCC frontend contract (reference ``utils.py:313-349``).

    The reference delegates to librosa defaults: sr=22050, n_fft=2048,
    hop_length=512, hann window, centered (reflect-padded) STFT, 128 mel bands
    (Slaney norm, fmax=sr/2), power→dB with ``top_db=80``, DCT-II ortho, first
    ``n_mfcc`` coefficients.  The port computes all of it with PyTorch ops
    (FFT + matrix products) — see ``ops/audio.py``.
    """

    sample_rate: int = 22050
    n_mfcc: int = 30
    n_fft: int = 2048
    hop_length: int = 512
    n_mels: int = 128
    fmin: float = 0.0
    fmax: float | None = None      # None → sample_rate / 2
    top_db: float = 80.0
    bin_length: int = 30           # B: time columns per video frame after interpolation
    log_mel: bool = False          # config-2 variant: stop at log-mel, skip DCT
    # Centered-STFT edge padding.  librosa < 0.10 defaulted to "reflect";
    # librosa ≥ 0.10 defaults to "constant" (zeros).  The reference stack is
    # Python 3.10 + PyTorch 2.1.0 (late 2023, report §4.3) → librosa ≥ 0.10,
    # so "constant" is the era-correct default.
    # Slots shorter than n_fft//2 always use constant padding (both eras).
    stft_pad_mode: str = "constant"


@dataclass(frozen=True)
class ModelConfig:
    """Architecture of the AVM-equivalent model (reference ``utils.py:145-272``).

    Explicit shapes everywhere — the reference's Lazy* modules hid the
    conv→flatten dims (SURVEY.md §7.3); here they are pinned by construction.
    """

    audio_included: bool = True
    text_included: bool = False

    # Visual branch (reference VisBl, utils.py:145-195); "resnet" swaps in the
    # ResNet-18-class backbone (models/resnet.py, BASELINE.json config 1),
    # "vit" the patch-transformer backbone (models/vit.py)
    vis_backbone: str = "reference"
    vis_channels: tuple[int, ...] = (64, 256, 512)
    vis_feature_dim: int = 512
    # ViT backbone geometry (vis_backbone="vit"): patch must divide
    # PreprocessConfig.frame_size; embed_dim must divide by num_heads
    vit_patch_size: int = 8
    vit_embed_dim: int = 192
    vit_depth: int = 4
    vit_num_heads: int = 4
    # Audio branch (reference AudBl, utils.py:197-227)
    aud_channels: tuple[int, ...] = (64, 128)
    aud_feature_dim: int = 128
    # Text branch (new capability — BASELINE.json config 4)
    text_vocab_size: int = 32768
    text_embed_dim: int = 128
    text_num_layers: int = 2
    text_num_heads: int = 4
    text_feature_dim: int = 128
    text_max_len: int = 64

    # Fusion head (reference AVM.fusion, utils.py:242-258)
    fusion_hidden: tuple[int, ...] = (512, 512, 256, 128)
    dropout_rate: float = 0.2
    # Output scaling: 4*sigmoid(x)+1 ∈ [1, 5]  (utils.py:270)
    out_lo: float = 1.0
    out_hi: float = 5.0

    # Temporal spotting head (new capability — BASELINE.json config 5)
    # "gru": bidirectional scan (models/temporal.py); "transformer":
    # flash-attention transformer (models/temporal_attention.py); "hybrid":
    # GRU-augmented banded transformer (models/temporal_hybrid.py — the
    # distractor-rejection pick: GRU-tied mAP, measured-best leak on both
    # generator families at n=8 seeds; docs/BENCHMARKS.md quality section)
    temporal_model: str = "gru"
    # temporal_hidden doubles as the GRU hidden size AND the transformer's
    # model_dim; temporal_num_layers is the transformer block count — both
    # are wired through every head-construction site (cli spot/spot-train,
    # serve.Spotter), so a non-default value changes the architecture
    # everywhere consistently
    temporal_hidden: int = 128
    temporal_num_layers: int = 2
    temporal_num_heads: int = 1
    temporal_max_len: int = 8192
    # Transformer positions: "learned" (absolute table, tiled mod max_len —
    # aliases with period max_len on longer timelines) or "rotary" (RoPE,
    # relative and alias-free at any T — recommended for FULL attention at
    # match scale T≈135k).  Banded attention (temporal_window > 0) only sees
    # |i−j| ≤ W so tiling is harmless there.
    temporal_pos_encoding: str = "learned"
    # Transformer attention band radius in condensed frames: frame i attends
    # only |i−j| ≤ window (sliding-window flash kernel, O(T·W·d) compute —
    # event evidence is local at match scale).  0 = full attention.
    temporal_window: int = 0
    # GRU timelines longer than this are scored chunked+halo, with a
    # documented tolerance ≤2e-2 at chunk borders vs the monolithic scan.
    # 0 disables chunking (always monolithic/exact).
    temporal_chunk_threshold: int = 16384
    temporal_chunk: int = 4096
    temporal_halo: int = 256

    # Mixture-of-experts fusion: when > 0 the first fusion hidden layer
    # (reference utils.py:242-258's 640→512 linear) becomes a top-k gated
    # mixture of that many linear experts (models/moe.py); experts shard
    # over the mesh "model" axis for expert parallelism (parallel/ep.py).
    # 0 = dense (reference-parity default).
    fusion_moe_experts: int = 0
    fusion_moe_top_k: int = 2
    # Switch-style load-balance auxiliary loss weight (models/moe.py:
    # moe_load_balance_loss), added to the training objective whenever the
    # MoE head is enabled — without it the top-k gate can collapse onto one
    # expert and the mixture silently degenerates to a dense layer.
    fusion_moe_aux_weight: float = 0.01

    dtype: str = "float32"         # activations dtype ("bfloat16" in configs/tpu_serving.json)
    param_dtype: str = "float32"
    # Eval-only: run the visual convs conv1/conv2 (88% of model FLOPs) in
    # int8 (ops/quant.py); score drift gate in tests/test_precision.py.
    quantized_inference: bool = False


@dataclass(frozen=True)
class TrainConfig:
    """Training hyperparameters (reference ``main.py:45-53``)."""

    num_epochs: int = 150
    subbatch_size: int = 10
    learning_rate: float = 1e-3
    train_ratio: float = 0.8
    seed: int = 12344321
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    # LR schedule over OPTIMIZER steps (train/optim.py::schedule_lr).  The
    # reference is fixed-lr (main.py:49); "constant" + 0/0 reproduces it.
    lr_schedule: str = "constant"      # constant | cosine | linear
    lr_warmup_steps: int = 0
    lr_decay_steps: int = 0
    lr_min_ratio: float = 0.0          # decay floor as a fraction of base lr
    # Gradient spike guard + decoupled (AdamW) regularization; 0 = off = the
    # reference's raw-grad plain Adam (main.py:70).
    grad_clip_norm: float = 0.0
    weight_decay: float = 0.0
    # Stop after this many epochs without a new best optimum metric
    # (below); 0 = off = the reference's fixed 150-epoch run.
    early_stop_patience: int = 0
    # Which metric picks the "opt" checkpoint (and drives early stopping):
    # "train_f_avg" = the reference's policy (best TRAIN F-avg,
    # main.py:255-263); "val_f_avg" / "val_loss" = the production
    # held-out-selection policies the reference lacked (its train-side
    # policy can reward overfitting).  val metrics require a non-empty
    # val split (checked up front).
    optimum_metric: str = "train_f_avg"
    # True gradient accumulation: mean grads over K consecutive sub-batches,
    # ONE Adam step per K.  1 = the reference's step-per-sub-batch semantics
    # (main.py:177-196 — "not accumulation proper", SURVEY.md §2.3); >1 is
    # the production large-effective-batch mode the reference lacked.
    grad_accum_steps: int = 1
    # Non-finite-loss guard (the reference records whatever the loss was):
    # "off" = reference semantics; "raise" = fail loudly on the first
    # non-finite per-video loss; "rollback" = discard that video's updates
    # (params, BN stats, Adam moments — the whole scan's effect) and continue
    # from the last finite-loss state, raising only after nan_guard_limit
    # rollbacks.  Rollback is the production mode: one poisoned video (bad
    # decode, corrupt labels) costs its own updates, not the run.
    nan_guard: str = "off"
    nan_guard_limit: int = 3
    # Mixed precision: "bfloat16" runs forward/backward compute in bf16 with
    # f32 master params, Adam state, and loss.
    compute_dtype: str = "float32"
    # The reference's MSELoss((n,1), (n,)) silently broadcasts to (n,n)
    # (main.py:191 — SURVEY.md §7.1 documents this as a bug NOT to replicate).
    # False (default) = intended semantics: elementwise MSE on aligned shapes.
    # True  = bug-compatible broadcast loss, kept only for A/B comparison.
    broadcast_loss_compat: bool = False
    # The reference never calls model.eval(): its "evaluation" forwards run
    # in TRAIN mode (batchnorm batch stats, dropout active — main.py:93-118
    # has no .eval()).  False (default) = intended semantics (running-stat
    # BN, no dropout).  True = evaluation forwards use train-mode batchnorm
    # (the updated state is discarded), for live A/B against the reference;
    # pair with dropout_rate=0 for determinism.
    eval_train_mode_compat: bool = False
    checkpoint_every: int = 1      # epochs between rolling checkpoints


@dataclass(frozen=True)
class KnapsackConfig:
    """Keyshot selection budget (reference ``utils.py:466,629``)."""

    summary_ratio: float = 0.15    # capacity = ratio * full_n_frames
    scale_factor: int = 5          # integer scaling of weights/capacity
    # Reference builds the frame mask with an INCLUSIVE clip end
    # (utils.py:639-641) while the summary frames use an exclusive slice
    # (utils.py:634) — an off-by-one.  True keeps reference-compatible masks
    # (needed for F-score parity against its ground truths); False uses
    # self-consistent exclusive ends.  SURVEY.md §7.1.
    inclusive_mask: bool = True


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout (SPMD via jax.sharding; no reference equivalent —
    SURVEY.md §2.3 marks every parallelism strategy ABSENT upstream)."""

    data: int = -1                 # -1 → all remaining devices on the data axis
    model: int = 1                 # tensor-parallel degree for the fusion MLP
    axis_names: tuple[str, str] = ("data", "model")


@dataclass(frozen=True)
class PipelineConfig:
    preprocess: PreprocessConfig = field(default_factory=PreprocessConfig)
    audio: AudioConfig = field(default_factory=AudioConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    knapsack: KnapsackConfig = field(default_factory=KnapsackConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(_asdict(self), indent=indent)

    @classmethod
    def from_json(cls, s: str) -> "PipelineConfig":
        return _fromdict(cls, json.loads(s))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def load(cls, path: str) -> "PipelineConfig":
        with open(path) as f:
            return cls.from_json(f.read())


_CONFIG_TYPES = {
    "preprocess": PreprocessConfig,
    "audio": AudioConfig,
    "model": ModelConfig,
    "train": TrainConfig,
    "knapsack": KnapsackConfig,
    "mesh": MeshConfig,
}
