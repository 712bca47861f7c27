#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--phases 1,15-17]

From the repository root, on a machine with a CUDA card:

1. prints the card (``nvidia-smi`` name and power limit, torch's device name);
2. builds every CUDA kernel from ``csrc/`` (one ``nvcc`` per source, all at
   once) and times the build;
3. calls each kernel's wrapper at the shapes its main path gives it, holds
   the result against the kernel's plain PyTorch version on the same inputs,
   and times kernel, plain version and one library call (CUDA events, after
   warm-up) beside the least time the card could take; the preprocess
   (kernel 1) at each video's N and at a match's, with its plan (CTAs a
   frame, clusters, rows a ring stage, shared memory), registers, the card's
   clusters at once, its time, its plain version's and the library's back
   to back, and beside them the kernel's time on the device alone (the
   host's calls queued behind a spin), the host's time issuing one call and
   one call with the L2 flushed; the conv-pool stage
   (kernel 2) at conv1's and conv2's shapes at the batch's and the match's N,
   with its plan, blocks per SM and tensor-core bound, and the visual trunk
   at frame_size (64, 64), where kernel 2 cuts frames into tiles, against the
   CPU, then every whole-frame plan of kernel 2 at the batch's N timed beside
   the plan model's cost; the head (kernel 3)
   at the batch's and the match's M and at one video's, with its plan, the
   traced times of its two passes and its tensor-core bound; the attention
   kernels also at T = 32,768, with one head of 256 and with one head of 512
   (the wide path), and the banded one at T = 135,000, where it is checked on
   row slices; the full and the banded forward (kernels 5 and 7) with their
   plans, the traced times of their tile and merge kernels, their tensor-core
   bounds and equal bits on a repeat, and at scores near 1e3 their distance
   from the plain version and from float64 beside the plain version's own;
   kernel 7 also with its walk forced into every split count at head widths
   32, 64 and 128, dead rows exactly 0; the fusion MLP also at
   each video's M, at the 5-way classifier's widths and at the
   ``--no-audio`` trunk's 512-wide input (150, 64 and 22 rows, as ``infer``
   gives it), with equal bits on a repeat, then every tile plan at the
   path's M timed and the plan's cost model refitted to those times;
4. drives the summarization path — ``extract_features`` → ``fuse_many`` →
   ``summarize`` — over three synthetic videos (600, 300 and 150 condensed
   180×320 frames with their audio) at the full width of
   ``configs/reference_parity.json``; prints the knapsack engine ``"auto"``
   ran, checks the outputs, holds the first 64 frames against the same port
   run on the CPU, and times the path;
4a. runs the device, native and host knapsack engines at a match's shape
   (540 clips, capacity 24,300), holds their selections equal and times them,
   then sweeps tables of about 1e6 to 1e8 cells for the crossover where the
   device engine (on the card) falls below the native one;
5. drives the spotting path over one synthetic 5400-frame match with its
   audio (cut: one seeded 600-frame segment repeated): ``extract_features``, then ``summarize_match`` with
   ``configs/tpu_spotting.json`` (banded attention), the same with
   ``temporal_window = 0`` (full attention) and
   ``configs/tpu_spotting_quality.json`` (GRU + banded hybrid), then
   ``spot_stream`` in 600-frame chunks, printing the knapsack engine each
   ``summarize_match`` ran; holds the stream to the offline
   scores, each scorer and the default GRU scorer to its CPU run on the
   card's features, a GRU timeline past ``temporal_chunk_threshold`` (scored
   chunked) to the CPU on seeded features, and the trunk to the CPU on the
   first 64 frames, and times the path;
6. holds the two attention backwards (dq, dk, dv) against their plain
   versions at the same shapes as the forwards, with times, bounds and the
   backward of ``scaled_dot_product_attention``; the full (kernel 6) and the
   banded (kernel 8) one at head widths up to 128 with their plans, the
   traced times of their dK/dV, dQ and split-sum kernels, their tensor-core
   bounds and equal bits on a repeat, and kernel 8 at scores near 1e3 beside
   the plain version, both against float64; the band at T = 135,000 on row
   and key slices;
7. drives spotting training on the match's features: a seeded event sidecar
   read back with ``load_event_labels``, then two
   ``make_spotting_train_step`` steps from one seeded head for the banded,
   full and hybrid configs on the card and on the CPU (first gradients and
   every loss held to each other; the hybrid, whose GRU steps through the
   timeline on the host, on the match's first ``HYBRID_TRAIN_FRAMES``
   frames), ``save_spotting_checkpoint`` →
   ``weights.load_spotting_checkpoint`` → ``score_timeline_auto`` →
   ``spot_events``, with the median step time per scorer;
8. reports which of cv2, imageio, h5py and matplotlib import on this
   machine;
9. the inference journey: ``cli.main(["infer", ...])`` in-process at the
   full width of ``configs/reference_parity.json`` over one seeded video of
   4,500 raw 180×320 frames saved as ``.npz`` (150 condensed frames; one
   500-frame generator block repeated, as in phase 11) with its ``.wav``
   sidecar, the trunks (audio and ``--no-audio``) written by
   the port's ``save_checkpoint``: offline (kernels 1–4; the export equal to
   ``extract_features`` → ``fuse`` → ``summarize`` on the same inputs),
   ``--no-audio --stream --stream-chunk 64`` (kernels 1–4; scores within
   1e-4 of offline ``--no-audio`` scoring, the selection equal but for a
   clip at a rounding boundary, reported), ``--host-preprocess`` with
   ``--transfer-dtype`` unset, float16 and uint8 (kernels 2–4 and never 1;
   the JAX package's bounds 1e-4, 1e-3, 2e-2), ``--follow`` over a
   directory a writer thread fills (equal to the file run) and ``--follow``
   on a file (exit 2); then offline and streamed runs in turns, their host
   memory, and one traced run of each (busy share, pinned and pageable
   copies).  ``data.video.export_video`` is replaced by a sink that keeps
   the frames it is handed (this machine may have no mp4 writer; the run
   says so), and ``streaming.score_video_stream`` is wrapped to keep its
   scores;
10. the training journey at the full width of ``configs/reference_parity.json``
    (audio trunk, dropout 0.2) on four seeded videos ``vidA``–``vidD`` of
    4,500–5,400 raw 72×96 frames (150–180 condensed) with their ``.wav``
    sidecars and TVSum ``anno.tsv`` rows, three for training and one for
    validation: ``cli.main(["train", ..., "--epochs", "2"])``, then ``train
    --checkpoint --epochs 3`` (it must print "Resumed from epoch 2"),
    ``eval`` and ``baseline --samples 2``, then ``train_importance_model``
    with ``async_checkpoint`` and ``nan_guard="rollback"`` on a video whose
    labels hold a NaN (its updates discarded exactly: the rolling
    checkpoint equals a run without it bit for bit).  Kernel 1 launches
    once per video built, kernels 2 (twice), 3 and 4 in every evaluation.
    This machine may have no h5py and no matplotlib, so an in-memory
    stand-in replaces ``data.dataset.AnnotationStore`` (change points and
    annotator scores from the seeded arrays) and sinks replace
    ``viz.generate_metric_plots`` and ``viz.export_indices``; the run says
    so.  Then the card against the CPU from one seeded state at dropout 0:
    first sub-batch gradients, eval predictions and F-scores, every
    per-video loss of one epoch on the card against the CPU's at the
    card's parameters, the trained state through a checkpoint; and the
    step time, the epoch split into train, eval and checkpoint, steps per
    second, one traced epoch's busy share and copies, the resident state's
    bytes and each verb's wall;
11. serving (``serve.py`` and the verbs that reach it) at the full width of
    ``configs/reference_parity.json``: (a) ``Summarizer.summarize_path`` on
    a video of phase 9's shape with its ``.wav`` against ``extract_features``
    → ``fuse`` → ``summarize(native-full)``; (b) a warmed ``DynamicBatcher``
    (buckets 256–2048, 5 ms) taking 24 requests of 30–300 condensed 180×320
    frames with audio from 8 threads, each against ``summarize_frames`` of
    the same request, kernel 1 never launched there, then a 0-frame and a
    grayscale rider and the request after them, with frames/s and the split
    between the requests' host work and the batched fuse; (c)
    ``Spotter.spot_frames`` on phase 5's match (``configs/tpu_spotting.json``,
    p50 of three) against the path run directly, and the hybrid of
    ``configs/tpu_spotting_quality.json`` once; (d) two HTTP servers on
    ``127.0.0.1:0`` over one Summarizer, one with the batcher, and a
    ``--no-audio`` banded spotter: 32 ``/summarize`` requests from 8 clients
    to each (p50/p95, requests/s, every answer against ``summarize_path``),
    ``/spot`` and ``/spot-stream`` (time to the first line, streamed scores
    against the offline ones) on a 300-frame video, ``/reload`` in the middle
    of a load after the trunk's npz is rewritten, ``/metrics`` counts, a 403
    and a 404; (e) ``cli.main`` of ``spot-train`` (banded, ``--val-videos``,
    ``--early-stop``), ``spot`` and ``spot --stream`` with its head against
    the direct path, ``serve --max-requests 3`` driven by a client thread,
    and ``profile --repeats 3 --trace-dir`` with its trace's busy share;
    then ``spot-train --epochs 1`` of a GRU and of a hybrid head on the card
    and on the CPU (every step's loss within 1e-4 relative, the two saved
    heads scoring the spot target within 1e-4·max(1, max|s|)).
    The videos of (d) and (e) are 72×96 raw, as in phase 10 (cut: the model
    resizes to 40×40 either way), and repeat one seeded block of 500 frames;
12. bf16 and int8 inference at the full width of ``configs/tpu_serving.json``
    (``reference_parity.json``'s widths in bf16 with int8 conv1 and conv2),
    before phase 11: (a) the four low-precision forms (2-bf16, 2-int8 in
    float32 and bf16, 3-bf16, 4-bf16) against their plain versions at the
    main paths' shapes, with times, bounds on the bf16 and int8 tensor cores
    and the library calls (cuDNN's bf16 chain beside the int8 convolution,
    which no one PyTorch call computes); for the two forms on ``wgmma``
    (3-bf16 and 2-int8) their registers, spills, shared memory and SASS
    wgmma counts, device time alone and host call, 3-bf16's plan and a part
    at a match's M, and 2-int8's weight pack and amax pass timed alone; (b) phase 1's three videos in bf16,
    int8 and both (each with its forms launched and the float32 kernels it
    replaces not), card against CPU on 64 frames, the drift from the card's
    float32 scores (0.1), batch time, per-video p50 and stage split; (c)
    ``infer --config tpu_serving.json`` offline and ``--no-audio --stream`` on
    phase 9's video against the direct path (the stream's chunks zero-padded
    as the int8 scale needs); (d) the preset's ``Summarizer`` and one
    ``DynamicBatcher`` request against its bucket scored directly; (e) a
    quantized ``Spotter`` (2-int8 at T = 5400) on phase 5's match; (f) three
    bf16 mixed-precision train steps, card against CPU;
13. the text (commentary) branch and the mixture-of-experts fusion at the
    full width of ``configs/reference_parity.json`` (vocab 32,768, two
    128-wide layers of 4 heads, 64 tokens; 4 experts, top 2), with seeded
    commentary sidecars (a line of 3-12 words every 150 raw frames), after
    phase 12: (a) kernel 4 and 4-bf16 at M = 1050 on the 768-wide chain and
    on the chain after an MoE first layer (parts of their rows, off the
    rows' totals); (b) phase 1's three videos with commentary, with MoE and
    with both (card vs CPU on 64 frames ≤ 1e-4, the text encoder's and the
    MoE layer's share of the fuse); (c) ``infer --commentary --moe-experts
    4`` on phase 9's video against the direct path, and ``--stream
    --commentary`` exiting 2; (d) ``train --commentary --moe-experts 4
    --epochs 1`` and ``eval --commentary`` on phase 10's videos, and the
    first sub-batch's gradients with the auxiliary loss card vs CPU; (e)
    the ``Summarizer`` and a batcher request with commentary, and a banded
    ``Spotter`` on a 3-modality trunk over phase 5's match, its trunk vs
    the CPU on 64 frames; (f) the serving preset with both flags, card vs
    CPU ≤ 0.0625 (a frame beyond only where the gate routes it to other
    experts on the two sides, reported);
14. the resnet and vit visual backbones at the widths of
    ``configs/reference_parity.json`` with ``vis_backbone`` swapped (resnet
    64/256/512 with the 7×7 ImageNet stem at 40×40; vit patch 8, 25 tokens,
    d = 192, depth 4, 4 heads), after phase 13: (a) phase 1's three videos
    with each backbone in float32, bf16, int8 and bf16 + int8, kernel 1 and
    kernel 4 (4-bf16 in bf16) launched and kernels 2 and 3 not, card
    against CPU on 64 frames (≤ 1e-4 at float32 and int8 at float32, ≤
    0.0625 in bf16) with the int8 codes that part between the two sides
    counted, frames/s, the fuse and the backbone's share of it beside the
    backbone's floor; (b) under int8 at float32 every int8 GEMM of those 64
    frames (cuBLAS's, through ``torch._int_mm``) equal to the CPU's float64
    product; (c) ``infer`` on phase 9's video against the direct path, then
    ``train --epochs 1`` and ``eval`` on phase 10's videos, per backbone,
    and the first sub-batch's gradients from one seeded state at dropout 0,
    card against CPU (each leaf within 1e-4·max(1, max|g|));
    (d) the ``Summarizer`` and a batcher request per backbone against the
    path scored directly; (e) ``Spotter.spot_frames`` over phase 5's match
    with the resnet backbone and a full-window head (kernel 5 through
    ``serve.py``), with the vit backbone and the default GRU head, and with
    the resnet under int8 and the banded head (kernel 7), each against the
    path run directly, its trunk against the CPU on 64 frames;
15. the reference checkpoint verbs at the width of
    ``configs/reference_parity.json``: a seeded reference-format ``state_dict``
    saved as ``.pt``, ``import-torch``, then ``infer`` on phase 9's video from
    the imported trunk (kernels 1–4; its scores within 1e-4 of the same path
    on the CPU, the selection equal but for a clip at a rounding boundary),
    ``export-torch`` (every array the ``.pt``'s bit for bit) and the export's
    re-import (the npz the first import's bit for bit);
16. data-parallel serving over ``serving_mesh(-1)`` (every visible card):
    the ``Summarizer`` on phase 1's three videos and the banded (kernel 7) and
    full-window (kernel 5) ``Spotter`` on phase 5's match, each against the
    single-device service (scores within 1e-5, masks and events equal but at
    a rounding boundary or a near tie), with the launch scopes each card
    entered and the walls beside one card's; the serving preset's int8 (at
    float32 within 1e-5, with bf16 within 0.0625) over the mesh against one
    card, the amax kernel launched twice a card (every block quantizes with
    the batch's scale); then ``serve --dp -1`` answering one ``/summarize``
    (its banner naming the mesh size);
17. data-parallel training: ``train --dp --global-batch 64 --epochs 1
    --checkpoint`` over every visible card on NCCL (one spawned rank per
    card) at the width of ``configs/reference_parity.json`` with dropout 0,
    on phase 10's videos from a seeded ``ckp``: the ``[dp epoch 0]`` line,
    the ``ckp`` and ``opt`` checkpoints, rank 0's evaluation launching
    kernels 2–4 on its card, every rank's step losses equal, and rank 0's
    first-step loss within 1e-4 relative of the train forward's loss on the
    same global batch on one card;
18. context-parallel spotting at the width of ``configs/tpu_spotting.json``
    (transformer 128 wide, 2 layers, W = 1024, and W = 0) on the one card:
    (a) the ring's and the halo's hop math (``parallel/ring_attention.py``,
    ``parallel/halo_attention.py``) over 4 virtual shards of one (1, T, 128)
    q, k, v at T = 5400 and 5399 (a partial last shard), forward and
    backward, against the monolithic kernels 5–8 (outputs and lse within
    1e-5·max(1, max|out|), gradients within 1e-4·max(1, max|g|)), kernel 5
    launched n² and kernel 7 n times a forward, 6 and 8 as often a backward;
    (b) ``spot-train --cp`` through ``cli.main`` on one NCCL rank, banded and
    full, for 2 epochs on phase 5's match (written as a ``--no-audio`` video
    at ``skip_frames = 1`` with seeded events), against the single-device
    ``spot-train``: every epoch's loss within 1e-4 relative, the rank's
    launches of kernels 7 and 8 (5 and 6) counted, the two saved heads
    scoring the match within 1e-4·max(1, max|s|); (c) on one NCCL rank in
    this process, ``score_timeline_sharded`` against ``score_timeline_auto``
    (banded, full) and the chunked single-device scorers (GRU, hybrid);
    (d) the CP step's ms beside the single-device step's, and the phase's
    wall;
19. pipeline, tensor and expert parallelism on the one card: (a) GPipe
    (``parallel/pp.py``) over 2 and 4 virtual stages of
    ``configs/tpu_spotting.json``'s head with 4 blocks, banded (W = 1024)
    and full, on two seeded 5400-frame timelines in two microbatches,
    against the single-device scorer and ``make_spotting_train_step``
    (outputs within 1e-5·max(1, max|s|), the loss within 1e-5 relative,
    the first step's gradients within 1e-4·max(1, max|g|)), each block
    launched once a microbatch, the PP step's ms beside the single-device
    steps'; (b) at ``configs/reference_parity.json``'s fusion widths the
    fusion MLP's train forward over 2 virtual model ranks (alone and after
    an MoE first layer, dropout on) and the ``--moe-experts 4`` layer over
    4 virtual expert shards against the whole layers (outputs within 1e-5,
    gradients within 1e-4, relative to max(1, max)); (c) ``spot-train --pp
    N+1`` on N cards exiting 2 with the JAX CLI's device-count message;
20. the orbax checkpoint backend (``--checkpoint-backend orbax``): (a) the
    hand-written zstd decoder (``csrc/zstd_decode.cc``) built with g++ and
    its decode rate over 64 MB of the committed JAX-written fixture's
    largest chunk (random float32, zstd level 1) decoded again and again;
    (b) that fixture (``tests/data/orbax_small``: an OCDBT store with zstd
    chunks, written by ``tools/make_orbax_fixture.py`` with the JAX
    package) loaded onto the card, every leaf bit-equal to its npz twin's;
    (c) at the default config's full width on phase 10's videos, ``train
    --epochs 1 --checkpoint-backend orbax``, its resume with ``--checkpoint``
    to epoch 2 (the resumed state bit-equal to the one saved), ``infer`` on a
    work directory holding only the orbax trunk (found without the flag;
    its scores equal to an npz save of the same state's), ``serve`` answering
    one ``/reload`` from the orbax trunk and one ``/summarize``, and the
    save and load walls of the full state in both layouts; (d) kernels 1–4
    launched by (c), from their counts.  The phase prints its wall;
21. multi-host training (``parallel/multihost.py``,
    ``parallel/multislice.py``) on the card: (a) the path of
    ``examples/multihost_train_torch.py`` as one host process with every
    visible card, its ranks on NCCL joined through a ``TCPStore`` on
    ``127.0.0.1`` at a free port: three ``make_dp_train_step`` steps of the
    example's tiny config, every step's loss bit-equal to the same ranks
    joined through phase 17's per-run ``FileStore`` on the same cards and
    batches; (b) the same steps on ``build_multislice_mesh``'s grid, the
    gradients summed over data, then slice, within 1e-6 relative of (a);
    (c) ``all_gather`` (stacked and tiled), ``reduce_scatter`` and
    ``ppermute_ring`` (shifts 1, −1, 2) on a ``VirtualAxis`` of CUDA lanes
    against the same lanes on the CPU; the ranks' kernel launch counts (the
    data-parallel train step reaches no Pallas counterpart, as in JAX: none
    of kernels 1–8) and the phase's wall;
22. the port's examples and the reference corpus: (a) the ``main`` of
    ``examples/train_and_summarize_torch.py``, ``serve_and_spot_torch.py``
    and ``live_follow_spotting_torch.py`` on the card, with h5py and
    matplotlib stood in where this machine lacks them (the in-memory
    annotation store and the plot sink of phase 10), their banner lines
    printed; (b) each against the same example run on the CPU in a child
    process from the same seeded weights (``train_and_summarize`` at dropout
    0 and Adam eps 1e-4 on both sides): summarization scores within 1e-4,
    training losses within 1e-4 relative (``serve_and_spot``: its first 10
    steps free-running, then the card's loss from the CPU run's parameters
    at every 25th step), ``spot_stream``'s scores within
    1e-4·max(1, max|s|), masks, clips and events equal but at a rounding
    boundary or a near tie; (c) each example's launches of kernels 1–8, kernels 2–4 from
    ``train_and_summarize`` and from the batcher; (d) where cv2 and h5py
    import, ``compat.reference_runner.build_reference_corpus`` read through
    the port's loaders and its first video fused on the card; the wall.

Every phase prints its wall and the script's time so far.  Then it prints the kernel table as one JSON line, the ``nvidia-smi`` line,
and as the last line ``{"ok": true, "device": {...}}``.  ``--phases`` runs
only the named phases (numbers and ranges, e.g. ``1,15-17``; phase 7 brings
1 and 5): set-up, the build, the table of the kernels that were checked and
the last lines run always, and a failed phase still exits non-zero.

Every path is driven with the launch counts set to 0 just before it and read
just after; a kernel of the path that did not launch fails the run.  Any
failed phase raises, so the script exits non-zero and prints no result; so
does a machine without a CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from cvml_goalnet_tpu_torch import cli, runtime, streaming, viz, weights
from cvml_goalnet_tpu_torch.config import PipelineConfig
from cvml_goalnet_tpu_torch.data import dataset as dataset_io
from cvml_goalnet_tpu_torch.data import video as video_io
from cvml_goalnet_tpu_torch.data.audio_io import load_waveform, write_wav
from cvml_goalnet_tpu_torch.data.dataset import uniform_clip_intervals
from cvml_goalnet_tpu_torch.data.text import commentary_per_frame, tokenize
from cvml_goalnet_tpu_torch.data.synthetic import (
    synthetic_change_points,
    synthetic_video_frames,
    synthetic_waveform,
)
from cvml_goalnet_tpu_torch.device import strict_f32
from cvml_goalnet_tpu_torch.models.audio import audio_encoder_apply
from cvml_goalnet_tpu_torch.models import layers as L
from cvml_goalnet_tpu_torch.models.avm import _fused_input, _moe_layer, visual_apply
from cvml_goalnet_tpu_torch.models.text import text_encoder_apply
from cvml_goalnet_tpu_torch.models.visual import visual_encoder_apply
from cvml_goalnet_tpu_torch.ops.cuda import _build
from cvml_goalnet_tpu_torch.ops.cuda.flash_attention import (
    BWD_STREAM,
    FWD_STREAM,
    MAX_SPLIT,
    _band_valid,
    bwd_blocks_per_sm,
    bwd_slots,
    card_bwd_plan,
    card_fwd_plan,
    card_local_bwd_plan,
    card_local_fwd_plan,
    flash_attention_local_bounded,
    flash_attention_with_lse,
    flash_bwd,
    flash_bwd_plain,
    flash_fwd,
    flash_fwd_plain,
    flash_local_bwd,
    flash_local_bwd_plain,
    flash_local_fwd,
    flash_local_fwd_plain,
    flash_local_fwd_planned,
    fwd_blocks_per_sm,
    fwd_slots,
    padded_head_dim,
)
from cvml_goalnet_tpu_torch.ops.cuda.fused_mlp import BF16_ROWS as MLP_BF16_ROWS
from cvml_goalnet_tpu_torch.ops.cuda.fused_mlp import bf16_smem_bytes as mlp_bf16_smem_bytes
from cvml_goalnet_tpu_torch.ops.cuda.fused_mlp import (
    BLOCK_ROWS,
    MAX_CLUSTER,
    SMEM_LIMIT,
    bf16_clusters_at_once,
    bf16_cta_work,
    card_bf16_mlp_plan,
    card_plan,
    fused_fusion_mlp,
    fused_fusion_mlp_bf16,
    fused_fusion_mlp_bf16_plain,
    fused_fusion_mlp_bf16_planned,
    fused_fusion_mlp_plain,
    fused_fusion_mlp_planned,
    max_active_clusters,
    plan_terms,
    smem_bytes,
)
from cvml_goalnet_tpu_torch.ops.cuda.fused_preprocess import STAGES as PREPROCESS_STAGES
from cvml_goalnet_tpu_torch.ops.cuda.fused_preprocess import (
    card_preprocess_plan,
    clusters_at_once,
    fused_preprocess_frames,
    fused_preprocess_frames_plain,
)
from cvml_goalnet_tpu_torch.ops.cuda.fused_stage import BLOCK_SMEM as STAGE_BLOCK_SMEM
from cvml_goalnet_tpu_torch.ops.cuda.fused_stage import M_TILES as STAGE_M_TILES
from cvml_goalnet_tpu_torch.ops.cuda.fused_stage import (
    STAGE_COUNTS,
    StagePlan,
    act_scale_int8,
    act_scale_int8_plain,
    card_blocks_per_sm,
    bf16_cin,
    card_bf16_stage_plan,
    card_int8_stage_plan,
    card_stage_plan,
    fused_conv_pool_stage,
    fused_conv_pool_stage_bf16,
    fused_conv_pool_stage_bf16_plain,
    fused_conv_pool_stage_int8,
    fused_conv_pool_stage_int8_plain,
    fused_conv_pool_stage_plain,
    fused_conv_pool_stage_planned,
    int8_block_count,
    int8_cin,
    int8_smem_bytes,
    pack_weights_int8,
    pack_weights_int8_plain,
    plan_cost,
    stage_slots,
)
from cvml_goalnet_tpu_torch.ops.cuda.fused_stage import bf16_smem_bytes as stage_bf16_smem_bytes
from cvml_goalnet_tpu_torch.ops.cuda.fused_stage import block_count as stage_block_count
from cvml_goalnet_tpu_torch.ops.cuda.fused_stage import blocks_per_sm as stage_blocks_per_sm
from cvml_goalnet_tpu_torch.ops.cuda.fused_stage import smem_bytes as stage_smem_bytes
from cvml_goalnet_tpu_torch.ops.cuda.matmul import (
    BF16_BLOCK_K,
    BF16_BLOCK_M,
    BF16_BLOCK_N,
    BF16_SMEM,
    BF16_STAGES,
    card_head_bf16_plan,
    card_head_plan,
    head_matmul,
    head_matmul_bf16,
    head_matmul_bf16_plain,
    head_matmul_plain,
    head_bf16_slots,
    head_slots,
)
from cvml_goalnet_tpu_torch.ops import knapsack as knapsack_module
from cvml_goalnet_tpu_torch.ops import quant
from cvml_goalnet_tpu_torch.ops.knapsack import DEVICE_MS, NATIVE_MS, auto_engine, knapsack_select
from cvml_goalnet_tpu_torch.ops.audio import extract_audio_features
from cvml_goalnet_tpu_torch.ops.preprocess import preprocess_frames_host, resize_taps_on
from cvml_goalnet_tpu_torch.pipeline import extract_features, fuse, fuse_many, summarize
from cvml_goalnet_tpu_torch.spotting import (
    encode_timeline,
    load_event_labels,
    score_timeline_auto,
    scores_to_importance,
    spot_events,
    spot_stream,
    summarize_match,
)
from cvml_goalnet_tpu_torch.train import checkpoint as checkpoint_io
from cvml_goalnet_tpu_torch.train import loop as train_loop
from cvml_goalnet_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from cvml_goalnet_tpu_torch.train.optim import tree_leaves, tree_map
from cvml_goalnet_tpu_torch.train.state import TrainState, create_train_state
from cvml_goalnet_tpu_torch.utils import compute_dtype, tree_cast
from cvml_goalnet_tpu_torch.train.spotting import (
    init_spotting_opt,
    make_spotting_train_step,
    save_spotting_checkpoint,
)

REPO = Path(__file__).resolve().parent
VIDEO_LENGTHS = (600, 300, 150)   # condensed frames per synthetic video
RAW_HW = (180, 320)               # PreprocessConfig.serving_raw_hw
CPU_CHECK_FRAMES = 64
MATCH_FRAMES = 5400               # one 90-minute match at one condensed frame per second
SEGMENT_FRAMES = 600              # frames made per generator call, and spot_stream's chunk
PEAK_WINDOW = 5                   # spot_events' default neighbourhood
ATTN_WINDOW = 1024                # temporal_window of configs/tpu_spotting*.json
LONG_T = 32_768                   # attention checked against its plain version at this T too
MATCH_RATE_T = 135_000            # a 90-minute match at 25 frames/s: banded kernel timed alone
EVENT_SPACING = 300               # condensed frames per synthetic training event
TRAIN_STEPS = 2                   # make_spotting_train_step steps per scorer
HYBRID_TRAIN_FRAMES = 1_350       # the hybrid trains card vs CPU on the match's first quarter: its GRU steps on the host
LONG_GRU_EXTRA = 3_616            # frames past temporal_chunk_threshold for the chunked GRU check
PADDED_HEAD_DIM = 48              # a head width the kernels take zero-padded (to 64)
FRAME64_FRAMES = 6                # frames of the trunk check at frame_size (64, 64)
INFER_SEGMENTS = (1_800, 1_500, 1_200)   # raw frames of the --follow segments: 4,500 in all, 2.5 minutes at 30 fps
INFER_CHUNK = 64                         # --stream-chunk: 150 condensed frames in chunks of 64, 64 and 22
INFER_REPEATS = 2                        # offline and streamed --no-audio runs timed in turns
TRANSFER_BOUNDS = {None: 1e-4, "float16": 1e-3, "uint8": 2e-2}   # host preprocess vs device, the JAX package's
TRAIN_VIDEO_FRAMES = (4_500, 4_800, 5_100, 5_400)   # raw frames of vidA-vidD: 150-180 condensed at skip 30
TRAIN_RAW_HW = (72, 96)                             # synthetic_video_frames' raw size (the model runs on 40×40)
TRAIN_ANNOTATORS = 20                               # TVSum's annotators per video
TRAIN_CLIP_FRAMES = 60                              # about 2-second clips (shots) at 30 fps raw
TRAIN_EPOCHS = 2                                    # `train --epochs`; the resume runs one more
# the knapsack sweep: matches of these condensed frames with their own clips and capacity, then with a match's
# 540 clips capacities giving tables of about 1e6, 1e7 and 1e8 cells
KNAPSACK_SWEEP_FRAMES = (600, 2_400, 5_400, 10_800)
KNAPSACK_SWEEP_CAPACITIES = (1_851, 18_517, 185_184)
# (H, T, d, window, on a main path) of the attention kernels' checks: the spotting path's shapes, then
# T = 32,768, then one head of 256, the widest built width, and one of 512, on the wide path
ATTENTION_CASES = [(1, MATCH_FRAMES, 128, None, True), (1, MATCH_FRAMES, 128, ATTN_WINDOW, True),
                   (2, MATCH_FRAMES, 64, ATTN_WINDOW, True), (1, LONG_T, 128, None, False),
                   (1, LONG_T, 128, ATTN_WINDOW, False), (1, MATCH_FRAMES, 256, None, False),
                   (1, MATCH_FRAMES, 256, ATTN_WINDOW, False), (1, MATCH_FRAMES, 512, None, False),
                   (1, MATCH_FRAMES, 512, ATTN_WINDOW, False)]
# Published peaks of one H100 SXM (NVIDIA data sheet) at its 700 W limit:
# HBM3 bandwidth, float32 on the CUDA cores (the bound of the kernels that
# run there), and TF32 on the tensor cores, dense (the bound of kernels 3, 5
# and 6, whose products run there in 3xTF32).
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
PEAK_TF32_FLOP_PER_S = 495e12

# wrapper, CUDA source, and the TPU kernel it replaces, per kernel of the main path
KERNELS = {
    "fused_preprocess_frames": (fused_preprocess_frames, "cvml_goalnet_tpu_torch/csrc/fused_preprocess.cu",
                                "cvml_goalnet_tpu/ops/pallas/fused_preprocess.py:74"),
    "fused_conv_pool_stage": (fused_conv_pool_stage, "cvml_goalnet_tpu_torch/csrc/fused_stage.cu",
                              "cvml_goalnet_tpu/ops/pallas/fused_stage.py:65"),
    "head_matmul": (head_matmul, "cvml_goalnet_tpu_torch/csrc/matmul.cu",
                    "cvml_goalnet_tpu/ops/pallas/matmul.py:50"),
    "fused_fusion_mlp": (fused_fusion_mlp, "cvml_goalnet_tpu_torch/csrc/fused_mlp.cu",
                         "cvml_goalnet_tpu/ops/pallas/fused_mlp.py:38"),
    "flash_fwd": (flash_fwd, "cvml_goalnet_tpu_torch/csrc/flash_attention.cu",
                  "cvml_goalnet_tpu/ops/pallas/flash_attention.py:125"),
    "flash_bwd": (flash_bwd, "cvml_goalnet_tpu_torch/csrc/flash_attention.cu",
                  "cvml_goalnet_tpu/ops/pallas/flash_attention.py:275"),
    "flash_local_fwd": (flash_local_fwd, "cvml_goalnet_tpu_torch/csrc/flash_attention.cu",
                        "cvml_goalnet_tpu/ops/pallas/flash_attention.py:609"),
    "flash_local_bwd": (flash_local_bwd, "cvml_goalnet_tpu_torch/csrc/flash_attention.cu",
                        "cvml_goalnet_tpu/ops/pallas/flash_attention.py:661"),
    # the low-precision forms (phase 12): kernels 2-4 at bf16, and the int8 conv in kernel 2's place
    "fused_conv_pool_stage_bf16": (fused_conv_pool_stage_bf16, "cvml_goalnet_tpu_torch/csrc/fused_stage_lowp.cu",
                                   "cvml_goalnet_tpu/ops/pallas/fused_stage.py:65"),
    "fused_conv_pool_stage_int8": (fused_conv_pool_stage_int8, "cvml_goalnet_tpu_torch/csrc/fused_stage_lowp.cu",
                                   "cvml_goalnet_tpu/ops/quant.py:53"),
    "head_matmul_bf16": (head_matmul_bf16, "cvml_goalnet_tpu_torch/csrc/matmul.cu",
                         "cvml_goalnet_tpu/ops/pallas/matmul.py:50"),
    "fused_fusion_mlp_bf16": (fused_fusion_mlp_bf16, "cvml_goalnet_tpu_torch/csrc/fused_mlp.cu",
                              "cvml_goalnet_tpu/ops/pallas/fused_mlp.py:38"),
}
LOWP_FORMS = ("fused_conv_pool_stage_bf16", "fused_conv_pool_stage_int8", "head_matmul_bf16", "fused_fusion_mlp_bf16")
TRUNK = ("fused_conv_pool_stage", "head_matmul")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Mean milliseconds per call on the card (CUDA events around ``reps`` calls back to back)."""
    return time_ms_and_host(fn, reps, warmup)[0]


def time_ms_and_host(fn, reps: int = 10, warmup: int = 2, queued: bool = False) -> tuple[float, float]:
    """:func:`time_ms`, and the host's wall milliseconds per call spent issuing them.  With ``queued`` the card
    is kept busy while the host queues the calls, so the time is the device's alone, without the host's."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(10_000_000)   # a spin of some milliseconds ahead of the calls
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = time.perf_counter() - t0
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, 1e3 * host / reps


def time_ms_cold(fn, reps: int = 10) -> float:
    """Median milliseconds of one call after a write of 256 MB that leaves none of its inputs in the 50 MB L2."""
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(reps):
        flush.add_(1)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(n_bytes: float, n_flops: float, peak_flop_per_s: float = PEAK_F32_FLOP_PER_S) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S, n_flops / peak_flop_per_s
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def max_err(got: torch.Tensor, want: torch.Tensor) -> float:
    if got.shape != want.shape:
        raise AssertionError(f"shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError("non-finite kernel output")
    return (got - want).abs().max().item()


def row_of(parts: list[dict]) -> dict:
    """A kernel's row: times and bounds summed over the parts at its main paths' shapes
    (one call each); the error is the worst of all parts."""
    main = [p for p in parts if p.get("main_path", True)]
    return {
        "ms": sum(p["ms"] for p in main),
        "plain_ms": sum(p["plain_ms"] for p in main),
        "library_ms": sum(p["library_ms"] for p in main),
        "bound_ms": sum(p["bound_ms"] for p in main),
        "bound_by": main[0]["bound_by"],
        "max_abs_err": max(p["max_abs_err"] for p in parts),
        "parts": parts,
    }


def check_kernels(n: int, cfg: PipelineConfig, fusion_layers, gen: torch.Generator) -> dict:
    """Each kernel of the summarization path against its plain version at the path's shapes, with times and bounds."""
    dev = torch.device("cuda")
    rows = {}

    def record(name, parts):
        rows[name] = row_of(parts)

    # preprocess, once per video as extract_features launches it and once for a match: each output is a few
    # float32 operations on exact uint8 values rounded as the plain version rounds them, so the two agree to
    # the bit; the tolerance is the goldens' 1e-5.  Kernel, plain version and library call are timed back to
    # back, as every row is; beside them, the kernel's time on the device alone ("device_ms", the host's
    # calls queued behind a spin), the host's wall time issuing one call ("host_call_ms") and one call with
    # the L2 flushed ("cold_ms")
    h, w = RAW_HW
    oh, ow = cfg.preprocess.frame_size
    eps = cfg.preprocess.eps
    taps_h, taps_w = resize_taps_on(h, oh, dev), resize_taps_on(w, ow, dev)
    parts = []
    for nv in (*VIDEO_LENGTHS, MATCH_FRAMES):
        frames = torch.randint(0, 256, (nv, h, w, 3), generator=gen, device=dev, dtype=torch.uint8)
        got = fused_preprocess_frames(frames, taps_h, taps_w, eps)
        want = fused_preprocess_frames_plain(frames, taps_h, taps_w, eps)
        err = max_err(got, want)
        if err > 1e-5:
            raise AssertionError(f"fused_preprocess_frames ({nv} frames): max |err| {err} > 1e-5")

        def library_preprocess():
            lo, hi = torch.aminmax(frames.reshape(nv, -1), dim=1)
            lo, hi = lo.float()[:, None, None, None], hi.float()[:, None, None, None]
            small = F.interpolate(frames.permute(0, 3, 1, 2).float(), size=(oh, ow), mode="bilinear",
                                  align_corners=False)
            return (small - lo) / (hi - lo + eps)

        lib_err = max_err(library_preprocess().permute(0, 2, 3, 1), want)
        b, kind = bound_ms(nv * (h * w * 3 + oh * ow * 3 * 4), nv * (2 * h * w * 3 + 10 * oh * ow * 3))
        plan = card_preprocess_plan(nv, h, w, 3, oh, ow, 1, dev)

        def kernel():
            return fused_preprocess_frames(frames, taps_h, taps_w, eps)

        device_ms, host_call_ms = time_ms_and_host(kernel, queued=True)
        parts.append({
            "shape": [nv, h, w, 3], "ms": time_ms(kernel), "device_ms": device_ms, "host_call_ms": host_call_ms,
            "cold_ms": time_ms_cold(kernel),
            "plan": {"cta_per_frame": plan.cluster, "clusters": plan.clusters, "stages": PREPROCESS_STAGES,
                     "rows_per_stage": plan.layout.rows_per_stage, "smem_bytes": plan.layout.smem_bytes},
            "plain_ms": time_ms(lambda: fused_preprocess_frames_plain(frames, taps_h, taps_w, eps)),
            "library_ms": time_ms(library_preprocess), "library_max_abs_err": lib_err,
            "bound_ms": b, "bound_by": kind, "max_abs_err": err,
        })
        del frames, got, want
    record("fused_preprocess_frames", parts)

    torch.cuda.empty_cache()
    layout = card_preprocess_plan(1, h, w, 3, oh, ow, 1, dev).layout
    print(f"kernel 1 (fused_preprocess_frames) registers and spill bytes: {json.dumps(ptxas_report('fused_preprocess'))}; "
          f"{layout.smem_bytes} bytes of shared memory a CTA, {layout.rows_per_stage} rows a stage; clusters of "
          f"1, 2, 4, 8 CTAs at once {json.dumps(clusters_at_once(dev, True, layout.smem_bytes))}; plans and times "
          f"{json.dumps([{k: p[k] for k in ('shape', 'plan', 'ms', 'device_ms', 'host_call_ms', 'cold_ms', 'bound_ms')} for p in parts])}",
          flush=True)

    # conv-pool stages, conv1 and conv2 at the batch's N and at a match's (both on the main paths)
    record("fused_conv_pool_stage", [stage_part(m, hh, cin, cout, scale, gen) for m in (n, MATCH_FRAMES)
                                     for hh, cin, cout, scale in ((13, 64, 256, 0.05), (11, 256, 512, 0.02))])

    # head: the summarization batch and a match (both on the main paths), and one video of 150 frames
    k, nout = 9 * 9 * cfg.model.vis_channels[-1], cfg.model.vis_feature_dim
    record("head_matmul", [head_part(m, k, nout, main, gen) for m, main in
                           ((n, True), (MATCH_FRAMES, True), (VIDEO_LENGTHS[-1], False))])

    # fusion MLP: five short float32 chains and a sigmoid; outputs in [1, 5].  The batch of the three
    # videos is the row's headline; each video's M as the per-video path calls it, and the 5-way
    # classifier's widths (raw logits), are parts beside it
    lo, hi = cfg.model.out_lo, cfg.model.out_hi
    k_last = fusion_layers[-1]["w"].shape[0]
    classifier = [*fusion_layers[:-1], {"w": torch.randn((k_last, 5), generator=gen, device=dev) * k_last ** -0.5,
                                        "b": torch.randn((5,), generator=gen, device=dev) * 0.1}]
    # the no-audio trunk's 512-wide input (infer --no-audio): offline at one video's M, streamed at the chunk's
    # and the tail's
    dims = [cfg.model.vis_feature_dim, *cfg.model.fusion_hidden, 1]
    no_audio = [{"w": torch.randn((a, b), generator=gen, device=dev) * a ** -0.5,
                 "b": torch.randn((b,), generator=gen, device=dev) * 0.1} for a, b in zip(dims[:-1], dims[1:])]
    n_infer = sum(INFER_SEGMENTS) // cfg.preprocess.skip_frames
    cases = [(n, fusion_layers, True, True), *((m, fusion_layers, True, False) for m in VIDEO_LENGTHS),
             (n, classifier, False, False), (n_infer, no_audio, True, True), (INFER_CHUNK, no_audio, True, False),
             (n_infer % INFER_CHUNK, no_audio, True, False)]
    record("fused_fusion_mlp", [mlp_part(m, layers, squash, lo, hi, main, gen) for m, layers, squash, main in cases])
    return rows


def stage_part(n: int, hh: int, cin: int, cout: int, scale: float, gen: torch.Generator) -> dict:
    """Kernel 2 at (n, hh, hh, cin) → cout against its plain version, with equal bits on a repeat, its plan and
    resident blocks per SM, and its bound on the tensor cores, where it computes: 3 TF32 products per
    multiply-add (3xTF32) at the dense TF32 rate, or its bytes, whichever takes longer; the FP32-core bound
    beside it.  Tolerance 1e-4·max|ref|: float32 sums of 9·Cin products in another order than cuDNN's."""
    dev = torch.device("cuda")
    x = torch.randn((n, hh, hh, cin), generator=gen, device=dev)
    wt = torch.randn((3, 3, cin, cout), generator=gen, device=dev) * scale
    bs = torch.randn((hh, hh, cout), generator=gen, device=dev) * 0.1
    run = lambda: fused_conv_pool_stage(x, wt, bs)
    got, want = run(), fused_conv_pool_stage_plain(x, wt, bs)
    err, tol = max_err(got, want), 1e-4 * want.abs().max().item()
    if err > tol:
        raise AssertionError(f"fused_conv_pool_stage {n}x{hh}x{hh}x{cin}->{cout}: max |err| {err} > {tol}")
    require(torch.equal(got, run()), f"fused_conv_pool_stage at {[n, hh, cin, cout]}: two runs on the same inputs differ")
    x_nchw = x.permute(0, 3, 1, 2)               # channels-last view, no copy
    w_oihw = wt.permute(3, 2, 0, 1).contiguous()
    b_chw = bs.permute(2, 0, 1)[None]

    def library():
        with strict_f32():
            return F.max_pool2d(F.relu(F.conv2d(x_nchw, w_oihw, padding=1) + b_chw), 3, 1)

    macs = 1.0 * n * hh * hh * cin * cout * 9
    n_bytes = 4.0 * (n * hh * hh * cin + 9 * cin * cout + hh * hh * cout + n * (hh - 2) ** 2 * cout)
    f32_b, _ = bound_ms(n_bytes, 2.0 * macs)
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S, 6.0 * macs / PEAK_TF32_FLOP_PER_S
    plan = card_stage_plan(n, hh, hh, cout, dev)
    part = {
        "shape": [n, hh, hh, cin, cout], "main_path": True, "ms": time_ms(run),
        "plain_ms": time_ms(lambda: fused_conv_pool_stage_plain(x, wt, bs)), "library_ms": time_ms(library),
        "library_max_abs_err": max_err(library().permute(0, 2, 3, 1), want),
        "bound_ms": 1e3 * max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "f32_core_bound_ms": f32_b, "max_abs_err": err, "tolerance": tol, "plan": plan._asdict(),
        "blocks": stage_block_count(plan, n, hh, hh, cout),
        "blocks_per_sm": card_blocks_per_sm(plan.m_tiles, plan.stages, stage_smem_bytes(plan), torch.cuda.current_device()),
    }
    print(f"fused_conv_pool_stage (kernel 2) at {part['shape']}: {part['ms']:.4f} ms (library {part['library_ms']:.4f}, "
          f"plain {part['plain_ms']:.4f}); plan {json.dumps(part['plan'])}, {part['blocks']} blocks, "
          f"{part['blocks_per_sm']} per SM; bound {part['bound_ms']:.4f} ms tensor cores in 3xTF32 "
          f"({part['bound_by']}), {f32_b:.4f} ms float32 cores; max |err| {err:.3g} (tol {tol:.3g})", flush=True)
    del x, wt, bs, got, want
    torch.cuda.empty_cache()
    return part


def check_trunk_at_frame_size_64(seed: int) -> dict:
    """The visual trunk of configs/reference_parity.json's widths at frame_size (64, 64) on a few frames, card
    against CPU with the same weights: conv1 runs at 21×21 and conv2 at 19×19, which the stage kernel cuts
    into tiles with a recomputed halo.  Features within 1e-4 relative."""
    cfg = PipelineConfig.load(str(REPO / "configs" / "reference_parity.json"))
    cfg = dataclasses.replace(cfg, preprocess=dataclasses.replace(cfg.preprocess, frame_size=(64, 64)))
    p_np, s_np = weights.init_params(cfg, seed)
    frames = np.random.default_rng(seed).random((FRAME64_FRAMES, 64, 64, 3)).astype(np.float32)
    before = fused_conv_pool_stage.launches
    with torch.no_grad():
        params, state = weights.from_jax(p_np, s_np)
        card = visual_encoder_apply(params["visual"], state["visual"], torch.as_tensor(frames, device="cuda")).cpu()
        params, state = weights.from_jax(p_np, s_np, device="cpu")
        cpu = visual_encoder_apply(params["visual"], state["visual"], torch.from_numpy(frames))
    require(fused_conv_pool_stage.launches == before + 2, "trunk at frame_size (64, 64): kernel 2 did not launch twice")
    rel = ((card - cpu).abs().max() / cpu.abs().max()).item()
    if not rel <= 1e-4:
        raise AssertionError(f"trunk at frame_size (64, 64) card vs CPU: features max |err| {rel} relative > 1e-4")
    plans = {f"{h}x{h}": card_stage_plan(FRAME64_FRAMES, h, h, c, torch.device("cuda"))._asdict()
             for h, c in ((21, 256), (19, 512))}
    return {"frames": FRAME64_FRAMES, "features_rel": rel, "plans": plans}


def head_part(m: int, k: int, n: int, main_path: bool, gen: torch.Generator) -> dict:
    """Kernel 3 at (m, k) @ (k, n) against its plain version, with equal bits on a repeat, its plan, the
    traced times of its two passes, and its bound on the tensor cores, where it computes: 3 TF32 products
    per multiply-add (3xTF32) at the dense TF32 rate, or its bytes, whichever takes longer; the FP32-core
    bound beside it.  Tolerance 1e-4·max|ref|: float32 sums over K in another order (split K, then the
    splits in order) than cuBLAS."""
    x = torch.rand((m, k), generator=gen, device="cuda")
    wt = torch.randn((k, n), generator=gen, device="cuda") * 0.005
    bs = torch.randn((n,), generator=gen, device="cuda") * 0.1
    run = lambda: head_matmul(x, wt, bs)
    got, want = run(), head_matmul_plain(x, wt, bs)
    err, tol = max_err(got, want), 1e-4 * want.abs().max().item()
    if err > tol:
        raise AssertionError(f"head_matmul at M = {m}: max |err| {err} > {tol}")
    require(torch.equal(got, run()), f"head_matmul at M = {m}: two runs on the same inputs differ")

    def library():
        with strict_f32():
            return torch.relu(torch.addmm(bs, x, wt))

    n_bytes = 4.0 * (m * k + k * n + n + m * n)
    f32_b, _ = bound_ms(n_bytes, 2.0 * m * k * n)
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S, 6.0 * m * k * n / PEAK_TF32_FLOP_PER_S
    passes = head_passes(run)
    part = {
        "shape": [m, k, n], "main_path": main_path, "ms": time_ms(run),
        "plain_ms": time_ms(lambda: head_matmul_plain(x, wt, bs)), "library_ms": time_ms(library),
        "library_max_abs_err": max_err(library(), want),
        "bound_ms": 1e3 * max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "f32_core_bound_ms": f32_b, "max_abs_err": err, "tolerance": tol,
        "plan": card_head_plan(m, k, n, x.device)._asdict(), "passes_traced_ms": passes,
    }
    print(f"head_matmul (kernel 3) at {[m, k, n]}: {part['ms']:.4f} ms (library {part['library_ms']:.4f}, plain "
          f"{part['plain_ms']:.4f}); plan {json.dumps(part['plan'])}; traced passes {json.dumps(passes)}; bound "
          f"{part['bound_ms']:.4f} ms tensor cores in 3xTF32 ({part['bound_by']}), {f32_b:.4f} ms float32 cores",
          flush=True)
    del x, wt, bs, got, want
    torch.cuda.empty_cache()
    return part


def traced_parts(run, part_of, parts: tuple[str, ...], required: tuple[str, ...], tries: int = 3) -> dict:
    """Device ms of a kernel's parts in one traced call of ``run``: ``part_of`` names the part of each traced
    kernel (None for the rest).  The tracer has been seen to drop a kernel's record of a call, so a trace
    that lacks a ``required`` part is taken again; after ``tries`` such traces the part reads "not
    measured"."""
    for _ in range(tries):
        got = dict.fromkeys(parts, 0.0)
        for name, ms in profile_run(run).get("device_ms_by_name", []):
            if part := part_of(name):
                got[part] += ms
        if all(got[p] > 0 for p in required):
            return got
    return {k: v if v > 0 or k not in required else "not measured" for k, v in got.items()}


def head_passes(run) -> dict:
    """Device ms of kernel 3's GEMM and reduce passes in one traced call."""
    part_of = lambda n: "gemm_ms" if "splitk_tc_gemm_kernel" in n else "reduce_ms" if "reduce_bias_kernel" in n else None
    return traced_parts(run, part_of, ("gemm_ms", "reduce_ms"), ("gemm_ms", "reduce_ms"))


def mlp_dims(layers) -> list[int]:
    return [layers[0]["w"].shape[0], *(lp["w"].shape[1] for lp in layers)]


def mlp_part(m: int, layers, squash: bool, lo: float, hi: float, main_path: bool, gen: torch.Generator) -> dict:
    """The fusion MLP at one M and widths against its plain version (1e-5: float32 sums in another order
    through five layers), with equal bits on a second call, times, bound and the plan launched."""
    dims = mlp_dims(layers)
    x = torch.rand((m, dims[0]), generator=gen, device="cuda")
    run = lambda: fused_fusion_mlp(x, layers, lo, hi, squash)
    got, want = run(), fused_fusion_mlp_plain(x, layers, lo, hi, squash)
    err = max_err(got, want)
    if err > 1e-5:
        raise AssertionError(f"fused_fusion_mlp {dims} at M = {m}: max |err| {err} > 1e-5")
    require(torch.equal(got, run()), f"fused_fusion_mlp {dims} at M = {m}: two calls on the same inputs differ")

    def library():
        with strict_f32():
            h = x
            for i, lp in enumerate(layers):
                h = torch.addmm(lp["b"], h, lp["w"])
                if i < len(layers) - 1:
                    h = torch.relu(h)
            return (hi - lo) * torch.sigmoid(h) + lo if squash else h

    macs = sum(a * b for a, b in zip(dims[:-1], dims[1:]))
    n_bytes = 4.0 * (m * (dims[0] + dims[-1]) + sum(lp["w"].numel() + lp["b"].numel() for lp in layers))
    b, kind = bound_ms(n_bytes, 2.0 * m * macs)
    bm, c = card_plan(m, dims, x.device)
    reps = 100   # a call takes about 0.1 ms: ten would time a millisecond
    return {
        "shape": [m, *dims], "squash": squash, "main_path": main_path, "ms": time_ms(run, reps),
        "plain_ms": time_ms(lambda: fused_fusion_mlp_plain(x, layers, lo, hi, squash), reps),
        "library_ms": time_ms(library, reps), "bound_ms": b, "bound_by": kind, "max_abs_err": err,
        "plan": {"block_rows": bm, "cluster": c, "blocks": -(-m // bm) * c,
                 "clusters_at_once": max_active_clusters(dims, bm, c, x.device)},
    }


def mlp_plan_sweep(layers, gen: torch.Generator) -> dict:
    """Every plan that fits, timed at the summarization path's M, and the plan model refitted to them.

    The model (``ops/cuda/fused_mlp.py::plan_seconds``) is rounds × (fixed + FMAs per thread · a +
    weight bytes · b); least squares over these times gives the three constants the module carries.
    """
    dims = mlp_dims(layers)
    at_once = {(bm, c): max_active_clusters(dims, bm, c, "cuda") for bm in BLOCK_ROWS
               if smem_bytes(bm, dims) <= SMEM_LIMIT for c in range(1, MAX_CLUSTER + 1)}
    times, rows, terms, chosen = {}, [], [], {}
    for m in (sum(VIDEO_LENGTHS), *VIDEO_LENGTHS):
        x = torch.rand((m, dims[0]), generator=gen, device="cuda")
        for (bm, c), n_at_once in at_once.items():
            times[f"{m}:{bm}x{c}"] = time_ms(lambda: fused_fusion_mlp_planned(x, layers, bm, c), 50)
            rounds, fmas, weight_bytes = plan_terms(m, dims, bm, c, n_at_once)
            rows.append([rounds, rounds * fmas, rounds * weight_bytes])
            terms.append(times[f"{m}:{bm}x{c}"] * 1e-3)
        bm, c = card_plan(m, dims, "cuda")
        best = min((t, k) for k, t in times.items() if k.startswith(f"{m}:"))
        chosen[m] = {"plan": f"{bm}x{c}", "ms": times[f"{m}:{bm}x{c}"], "best": best[1], "best_ms": best[0]}
    fit = np.linalg.lstsq(np.array(rows, dtype=float), np.array(terms), rcond=None)[0]
    return {"chosen": chosen, "fit": {"fixed_s": fit[0], "s_per_thread_fma": fit[1], "s_per_weight_byte": fit[2]},
            "clusters_at_once": {f"{bm}x{c}": v for (bm, c), v in at_once.items()}, "ms": times}


def stage_plan_sweep(n: int, gen: torch.Generator) -> dict:
    """Kernel 2 at conv1's and conv2's shapes at the summarization batch's N under every whole-frame plan that
    fits (frames per block, m_tiles, ring depth), timed beside the plan model's cost
    (``ops/cuda/fused_stage.py::plan_cost``), with the chosen plan and the fastest."""
    dev = torch.device("cuda")
    sms, reg_blocks = stage_slots(dev)
    regs = dict(zip(STAGE_M_TILES, reg_blocks))
    out = {}
    for hh, cin, cout in ((13, 64, 256), (11, 256, 512)):
        x = torch.randn((n, hh, hh, cin), generator=gen, device=dev)
        wt = torch.randn((3, 3, cin, cout), generator=gen, device=dev) * 0.05
        bs = torch.randn((hh, hh, cout), generator=gen, device=dev) * 0.1
        ms, cost = {}, {}
        for mi in STAGE_M_TILES:
            for f in range(1, 64 * mi // (hh * hh) + 1):
                for st in STAGE_COUNTS:
                    plan = StagePlan(f, hh - 2, hh - 2, mi, st)
                    if stage_smem_bytes(plan) > STAGE_BLOCK_SMEM or stage_blocks_per_sm(plan, regs) < 1:
                        continue
                    key = f"frames {f}, m_tiles {mi}, stages {st}"
                    ms[key] = time_ms(lambda: fused_conv_pool_stage_planned(x, wt, bs, plan))
                    cost[key] = plan_cost(plan, n, hh, hh, cout, sms, regs)
        chosen = card_stage_plan(n, hh, hh, cout, dev)
        key = f"frames {chosen.frames}, m_tiles {chosen.m_tiles}, stages {chosen.stages}"
        if (chosen.rows, chosen.cols) != (hh - 2, hh - 2):   # a tiled plan: not among the whole-frame ones
            key = f"{key}, tile {chosen.rows}x{chosen.cols}"
            ms[key] = time_ms(lambda: fused_conv_pool_stage_planned(x, wt, bs, chosen))
            cost[key] = plan_cost(chosen, n, hh, hh, cout, sms, regs)
        best = min(ms, key=ms.get)
        out[f"{hh}x{hh}x{cin}->{cout}"] = {"chosen": key, "chosen_ms": ms[key], "best": best, "best_ms": ms[best],
                                            "ms": ms, "model_cost": cost}
        del x, wt, bs
    return out


def make_videos(cfg: PipelineConfig, seed: int) -> list[dict]:
    skip = cfg.preprocess.skip_frames
    per_frame = cfg.audio.sample_rate * skip // 30   # samples per condensed frame at 30 fps raw
    videos = []
    for i, n in enumerate(VIDEO_LENGTHS):
        full_n = n * skip
        videos.append({
            "frames": synthetic_video_frames(n, *RAW_HW, seed=seed + i),
            "waveform": synthetic_waveform(n * per_frame, cfg.audio.sample_rate, seed=seed + i),
            "intervals": synthetic_change_points(full_n, max(8, n // 10), seed=seed + i),
            "full_n": full_n,
            "per_frame": per_frame,
        })
    return videos


def run_path(videos, params, state, cfg, commentary=None):
    """The main path over ``videos`` (with each video's per-frame ``commentary`` for the text branch); also
    returns the wall seconds of its three stages."""
    t0 = time.perf_counter()
    feats = [extract_features(v["frames"], v["waveform"], cfg, commentary=None if commentary is None else c)
             for v, c in zip(videos, commentary or [None] * len(videos))]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    scores = fuse_many(params, state, feats, cfg)   # NumPy scores: waits for the card
    t2 = time.perf_counter()
    results = [summarize(s, v["intervals"], cfg.preprocess.skip_frames, v["full_n"], cfg.knapsack)
               for s, v in zip(scores, videos)]
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    return feats, scores, results, {"extract_s": t1 - t0, "fuse_s": t2 - t1, "summarize_s": t3 - t2}


def profile_run(run) -> dict:
    """One run of ``run()`` traced on the card: device time by name and the device's busy share.

    Only device activity is traced (tracing host ops costs more than the run),
    and only the second of two runs (the first starts the tracer).  Busy time
    is the union of the device intervals (kernels and copies) over that run's
    wall time; the tracer's own buffer requests are left out.
    """
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    traced = []  # the profiler clears its events after each cycle: keep the active one's
    with profile(activities=[ProfilerActivity.CUDA], schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: traced.extend(p.events())) as prof:
        for _ in range(2):
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
            prof.step()
    spans, by_name = [], {}
    for ev in traced:
        if ev.device_type != DeviceType.CUDA or ev.name.startswith("Activity Buffer"):
            continue
        start, end = ev.time_range.start, ev.time_range.end
        spans.append((start, end))
        by_name[ev.name] = by_name.get(ev.name, 0.0) + (end - start) / 1e3
    if not spans:
        return {"device_ms": "not measured"}
    busy_us, cur_start, cur_end = 0.0, None, None
    for start, end in sorted(spans):
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                busy_us += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    busy_us += cur_end - cur_start
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"wall_ms": wall_ms, "device_busy_ms": busy_us / 1e3, "busy_share": busy_us / 1e3 / wall_ms,
            "attention_kernel_ms": sum(v for k, v in by_name.items()
                                       if "flash_" in k or "split_sum" in k or "fwd_merge" in k),
            "mlp_kernel_ms": sum(v for k, v in by_name.items() if "fused_mlp" in k),
            "memcpy_ms": {k: v for k, v in by_name.items() if k.startswith("Memcpy")},
            "device_ms_by_name": [[k[:100], round(v, 4)] for k, v in top]}


def require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def check_outputs(videos, feats, scores, results, cfg):
    h, w = cfg.preprocess.frame_size
    for i, (v, f, s, r) in enumerate(zip(videos, feats, scores, results)):
        n = len(v["frames"])
        require(tuple(f["visual"].shape) == (n, h, w, 3) and bool(torch.isfinite(f["visual"]).all()),
                f"video {i}: visual features of shape {tuple(f['visual'].shape)} or not finite")
        require(tuple(f["audio"].shape) == (n, cfg.audio.bin_length, cfg.audio.n_mfcc)
                and bool(torch.isfinite(f["audio"]).all()),
                f"video {i}: audio features of shape {tuple(f['audio'].shape)} or not finite")
        require(s.shape == (n,) and bool(np.isfinite(s).all()), f"video {i}: scores {s.shape} or not finite")
        require(bool((s >= cfg.model.out_lo).all() and (s <= cfg.model.out_hi).all()), f"video {i}: scores out of range")
        require(r.frame_mask.shape == (v["full_n"],) and r.frame_mask.dtype == np.uint8, f"video {i}: mask shape")
        # every chosen clip fits the budget; the inclusive end adds one frame per clip
        budget = int(cfg.knapsack.summary_ratio * v["full_n"]) + len(r.selected_clips)
        require(len(r.selected_clips) > 0 and 0 < int(r.frame_mask.sum()) <= budget,
                f"video {i}: {len(r.selected_clips)} clips, {int(r.frame_mask.sum())} frames for budget {budget}")


def check_against_cpu(video, feats, scores, params_np, state_np, cfg) -> dict:
    """First frames on the CPU (plain versions) against the card: features, encoders, scores."""
    m = CPU_CHECK_FRAMES
    cpu_feats = extract_features(video["frames"][:m], video["waveform"][: m * video["per_frame"]], cfg,
                                 device="cpu")
    tp, ts = weights.from_jax(params_np, state_np, device="cpu")
    cpu_scores = fuse(tp, ts, cpu_feats, cfg, device="cpu")
    gp, gs = weights.from_jax(params_np, state_np)
    with torch.no_grad():
        gpu_vis = visual_encoder_apply(gp["visual"], gs["visual"], feats["visual"][:m]).cpu()
        cpu_vis = visual_encoder_apply(tp["visual"], ts["visual"], cpu_feats["visual"])
        gpu_aud = audio_encoder_apply(gp["audio"], feats["audio"][:m]).cpu()
        cpu_aud = audio_encoder_apply(tp["audio"], cpu_feats["audio"])
    errs = {
        "visual_input": (feats["visual"][:m].cpu() - cpu_feats["visual"]).abs().max().item(),
        "audio_input": (feats["audio"][:m].cpu() - cpu_feats["audio"]).abs().max().item(),
        "visual_features_rel": ((gpu_vis - cpu_vis).abs().max() / cpu_vis.abs().max()).item(),
        "audio_features_rel": ((gpu_aud - cpu_aud).abs().max() / cpu_aud.abs().max()).item(),
        "scores": float(np.abs(scores[:m] - cpu_scores).max()),
    }
    # visual inputs: 1e-5 as in the goldens; audio: cuFFT vs the CPU FFT, the
    # goldens' rtol 1e-3 / atol 2e-3; encoders: float32 sums in other orders;
    # scores: the goldens' 1e-4
    limits = {"visual_input": 1e-5, "audio_input": 2e-3 + 1e-3 * cpu_feats["audio"].abs().max().item(),
              "visual_features_rel": 1e-4, "audio_features_rel": 1e-4, "scores": 1e-4}
    for k, lim in limits.items():
        if not errs[k] <= lim:
            raise AssertionError(f"card vs CPU: {k} max |err| {errs[k]} > {lim}")
    return errs


def band_pairs(t: int, window: int | None) -> int:
    """Valid (query, key) pairs of one head: all T² for full attention, else those with |i − j| ≤ W."""
    if window is None:
        return t * t
    i = np.arange(t)
    return int((np.minimum(i + window, t - 1) - np.maximum(i - window, 0) + 1).sum())


def attention_bound(h: int, t: int, d: int, window: int | None) -> tuple[float, str]:
    # 4·d FLOP per valid pair (score and weighted sum); q, k, v read and out, lse written once
    return bound_ms(4.0 * (4 * h * t * d + h * t), 4.0 * d * h * band_pairs(t, window))


def attention_fwd_tc_bound(h: int, t: int, d: int, window: int | None = None) -> tuple[float, str]:
    """The forward's bound on the tensor cores, where kernels 5 and 7 compute: each of its 4·d FLOP per valid
    pair (all T² for the full form, the band's for kernel 7) as three TF32 products (3xTF32) at the dense TF32
    rate, or its bytes, whichever takes longer."""
    t_bytes = 4.0 * (4 * h * t * d + h * t) / PEAK_BYTES_PER_S
    t_ops = 12.0 * d * h * band_pairs(t, window) / PEAK_TF32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def fwd_tc_parts(run, mask: str) -> dict:
    """Device ms of the parts of the tensor-core forward with mask policy ``mask`` (kernel 5: TcAllKeys, kernel
    7: TcBand) in one traced call: the tile kernel and, when the plan splits, the merge."""
    def part_of(name):
        if "flash_fwd_tc_kernel" in name and mask in name:
            return "tile_ms"
        return "merge_ms" if "fwd_merge_kernel" in name else None
    return traced_parts(run, part_of, ("tile_ms", "merge_ms"), ("tile_ms",))


# (H, Tq, Tk, d, window, lo, hi, q_offset) of kernel 7's every-split check: the main path's two bands, then at
# d = 32, 64 and 128 key bounds, a positive offset and Tq ≠ Tk, with rows 421–776 dead (tile 6 holds live and
# dead rows), and crossed bounds (every row dead)
LOCAL_FWD_SPLIT_CASES = [(1, MATCH_FRAMES, MATCH_FRAMES, 128, ATTN_WINDOW, None, None, 0),
                         (2, MATCH_FRAMES, MATCH_FRAMES, 64, ATTN_WINDOW, None, None, 0),
                         *((2, 777, 451, d, 37, 13, 400, 16) for d in (32, 64, 128)),
                         (2, 200, 200, 64, 16, 150, 40, 0)]


def local_fwd_every_split(gen: torch.Generator) -> dict:
    """Kernel 7 with its walk forced into every split count (``flash_local_fwd_planned``) at
    LOCAL_FWD_SPLIT_CASES, against the plain version at the forwards' tolerances: the worst |err| of out and lse
    per case over the split counts, whether every dead row's out and lse are exactly 0 in every split count,
    and whether two calls give equal bits."""
    dev = torch.device("cuda")
    report = []
    for case in LOCAL_FWD_SPLIT_CASES:
        h, tq, tk, d, window, lo, hi, q_offset = case
        q = torch.randn((h, tq, d), generator=gen, device=dev)
        k, v = (torch.randn((h, tk, d), generator=gen, device=dev) for _ in range(2))
        scale = d ** -0.5
        want_out, want_lse = flash_local_fwd_plain(q, k, v, scale, window, lo, hi, q_offset)
        dead = ~_band_valid(q, k, window, lo, hi, q_offset)[0].any(1)   # rows with no valid key
        err_out = err_lse = 0.0
        for splits in range(1, MAX_SPLIT + 1):
            out, lse = flash_local_fwd_planned(q, k, v, scale, window, splits, lo, hi, q_offset)
            err_out, err_lse = max(err_out, max_err(out, want_out)), max(err_lse, max_err(lse, want_lse))
            require(not out[:, dead].any() and not lse[:, dead].any(),
                    f"flash_local_fwd {case}, {splits} splits: a dead row is not 0")
            again = flash_local_fwd_planned(q, k, v, scale, window, splits, lo, hi, q_offset)
            require(torch.equal(out, again[0]) and torch.equal(lse, again[1]),
                    f"flash_local_fwd {case}, {splits} splits: two runs differ")
        if err_out > 3e-5 or err_lse > 1e-5:
            raise AssertionError(f"flash_local_fwd {case}: max |err| over the split counts out {err_out} > 3e-5 "
                                 f"or lse {err_lse} > 1e-5")
        report.append({"case": list(case), "splits": [1, MAX_SPLIT],
                       "dead_rows": int(dead.sum()), "max_abs_err_out": err_out, "max_abs_err_lse": err_lse})
        del q, k, v, want_out, want_lse
    return {"cases": report, "dead_rows_exactly_0": True, "equal_bits_on_a_repeat": True}



def check_attention_kernels(gen: torch.Generator) -> dict:
    """The two attention kernels against their plain versions, with times, bounds and the library call.

    Tolerances: 3e-5 on out and 1e-5 on lse, as ``tests/test_flash_attention.py``
    holds the Pallas kernels (float32 sums in another order; the row statistics
    are kept in float32 by both).
    """
    dev = torch.device("cuda")
    parts = {"flash_fwd": [], "flash_local_fwd": []}
    for h, t, d, window, main_path in ATTENTION_CASES:
        q, k, v = (torch.randn((h, t, d), generator=gen, device=dev) for _ in range(3))
        scale = d ** -0.5
        if window is None:
            name, run = "flash_fwd", lambda: flash_fwd(q, k, v, scale)
            plain = lambda: flash_fwd_plain(q, k, v, scale)
            mask = None
        else:
            name, run = "flash_local_fwd", lambda: flash_local_fwd(q, k, v, scale, window)
            plain = lambda: flash_local_fwd_plain(q, k, v, scale, window)
            idx = torch.arange(t, device=dev)
            mask = (idx[:, None] - idx[None, :]).abs() <= window

        def library():
            with strict_f32():
                return F.scaled_dot_product_attention(q[None], k[None], v[None], attn_mask=mask, scale=scale)[0]

        (out, lse), (want_out, want_lse) = run(), plain()
        err_out, err_lse = max_err(out, want_out), max_err(lse, want_lse)
        if err_out > 3e-5 or err_lse > 1e-5:
            raise AssertionError(f"{name} {(h, t, d, window)}: max |err| out {err_out} > 3e-5 or lse {err_lse} > 1e-5")
        lib_err = max_err(library(), want_out)
        b, kind = attention_bound(h, t, d, window)
        part = {
            "shape": [h, t, d], "window": window, "main_path": main_path, "ms": time_ms(run),
            "plain_ms": time_ms(plain), "library_ms": time_ms(library), "library_max_abs_err": lib_err,
            "bound_ms": b, "bound_by": kind, "max_abs_err": max(err_out, err_lse), "lse_max_abs_err": err_lse,
        }
        if d > 256:
            part["padded_to"] = padded_head_dim(d)
        if d in FWD_STREAM:   # kernel 5 or 7: plan, traced parts, held to the tensor cores' bound
            require(all(torch.equal(x, y) for x, y in zip(run(), (out, lse))),
                    f"{name} {(h, t, d, window)}: two runs on the same inputs differ")
            tc_b, tc_kind = attention_fwd_tc_bound(h, t, d, window)
            if window is None:
                label, plan, mask = "flash_fwd (kernel 5)", card_fwd_plan(h, t, t, d, dev), "TcAllKeys"
            else:
                label, mask = "flash_local_fwd (kernel 7)", "TcBand"
                plan = card_local_fwd_plan(h, t, t, d, window, 0, t, 0, dev)
            part.update(plan=plan._asdict(), parts_ms=fwd_tc_parts(run, mask), bound_ms=tc_b, bound_by=tc_kind,
                        f32_core_bound_ms=b, equal_bits_on_a_repeat=True)
            print(f"{label} at {[h, t, d]}{'' if window is None else f' W = {window}'}: {part['ms']:.4f} ms "
                  f"(library {part['library_ms']:.4f}, plain {part['plain_ms']:.4f}); plan {json.dumps(part['plan'])}; "
                  f"traced parts {json.dumps(part['parts_ms'])}; bound {tc_b:.4f} ms tensor cores in 3xTF32 "
                  f"({tc_kind}), {b:.4f} ms float32 cores; max |err| out {err_out:.3g}, lse {err_lse:.3g}; equal "
                  f"bits on a repeat", flush=True)
        parts[name].append(part)
        del q, k, v, out, lse, want_out, want_lse, mask
        torch.cuda.empty_cache()

    q, k, v = (torch.randn((2, 1000, PADDED_HEAD_DIM), generator=gen, device=dev) for _ in range(3))
    scale = PADDED_HEAD_DIM ** -0.5
    print(f"flash_fwd (kernel 5) at scores near 1e3, max |err| of (out, lse): "
          f"{json.dumps(large_magnitude_case(dev))}", flush=True)
    print(f"flash_local_fwd (kernel 7) at scores near 1e3 (W = 48), max |err| of (out, lse): "
          f"{json.dumps(large_magnitude_case(dev, 48))}", flush=True)
    print(f"flash_local_fwd (kernel 7) every split count 1..{MAX_SPLIT}: {json.dumps(local_fwd_every_split(gen))}",
          flush=True)
    parts["flash_fwd"].append(padded_case("flash_fwd", lambda: flash_fwd(q, k, v, scale),
                                          lambda: flash_fwd_plain(q, k, v, scale)))
    parts["flash_local_fwd"].append(padded_case("flash_local_fwd", lambda: flash_local_fwd(q, k, v, scale, 100),
                                                lambda: flash_local_fwd_plain(q, k, v, scale, 100)))
    del q, k, v

    # a full-rate match: the plain version's score matrix would be 73 GB, so check
    # row slices: a banded row needs only the keys within ±W, so the plain version
    # on keys [a − W, b + W) with the offset gives rows [a, b) exactly
    t, d = MATCH_RATE_T, 128
    q, k, v = (torch.randn((1, t, d), generator=gen, device=dev) for _ in range(3))
    out, lse = flash_local_fwd(q, k, v, d ** -0.5, ATTN_WINDOW)
    err = 0.0
    for a in (0, t // 2, t - 2048):
        b = a + 2048
        ks, ke = max(0, a - ATTN_WINDOW), min(t, b + ATTN_WINDOW)
        want_out, want_lse = flash_local_fwd_plain(q[:, a:b], k[:, ks:ke], v[:, ks:ke], d ** -0.5, ATTN_WINDOW,
                                                   q_offset=a - ks)
        e_out, e_lse = max_err(out[:, a:b], want_out), max_err(lse[:, a:b], want_lse)
        if e_out > 3e-5 or e_lse > 1e-5:
            raise AssertionError(f"flash_local_fwd T={t} rows [{a}, {b}): max |err| out {e_out}, lse {e_lse}")
        err = max(err, e_out, e_lse)
    b, _ = attention_bound(1, t, d, ATTN_WINDOW)
    tc_b, tc_kind = attention_fwd_tc_bound(1, t, d, ATTN_WINDOW)
    parts["flash_local_fwd"].append({
        "shape": [1, t, d], "window": ATTN_WINDOW, "main_path": False,
        "ms": time_ms(lambda: flash_local_fwd(q, k, v, d ** -0.5, ATTN_WINDOW)), "plain_ms": None,
        "library_ms": None, "bound_ms": tc_b, "bound_by": tc_kind, "f32_core_bound_ms": b,
        "plan": card_local_fwd_plan(1, t, t, d, ATTN_WINDOW, 0, t, 0, dev)._asdict(), "max_abs_err": err,
        "checked": "rows [0, 2048), [67500, 69548), [132952, 135000) against the plain version on their keys",
    })
    del q, k, v, out, lse
    torch.cuda.empty_cache()
    return {name: row_of(p) for name, p in parts.items()}


def attention_bwd_bound(h: int, t: int, d: int, window: int | None) -> tuple[float, str]:
    # 10·d FLOP per valid pair (s, dp, dv, dk, dq); q, k, v, out, dout read and dq, dk, dv written once, lse read
    return bound_ms(4.0 * (8 * h * t * d + h * t), 10.0 * d * h * band_pairs(t, window))


def attention_bwd_tc_bound(h: int, t: int, d: int, window: int | None) -> tuple[float, str]:
    """The backward's bound on the tensor cores, where kernels 6 and 8 compute: each of its 10·d FLOP per
    valid pair (all T² for the full form, the band's for kernel 8) as three TF32 products (3xTF32) at the
    dense TF32 rate, or its bytes, whichever takes longer."""
    t_bytes = 4.0 * (8 * h * t * d + h * t) / PEAK_BYTES_PER_S
    t_ops = 30.0 * d * h * band_pairs(t, window) / PEAK_TF32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def ptxas_report(name: str) -> dict:
    """{kernel: {"registers", "spill_bytes"}} of csrc/<name>.cu from the ``-Xptxas -v`` report of its build;
    kernels 1, 2, 5, 6, 7 and 8 under readable names (kernel 8's as kernel 6's template with ", band", kernel 7's
    as kernel 5's with ", band")."""
    report, fn = {}, None
    for line in (_build.BUILD_DIR / f"{name}.log").read_text().splitlines():
        if m := re.search(r"Function properties for (\S+)", line):
            fn = m.group(1)
            if k6 := re.search(r"flash_bwd_tc_kernelILi(\d+)ELb([01])E.*?(TcAllKeys|TcBand)", fn):
                fn = (f"flash_bwd_tc_kernel<{k6.group(1)}, {'dK/dV' if k6.group(2) == '1' else 'dQ'}"
                      f"{', band' if k6.group(3) == 'TcBand' else ''}>")
            elif k5 := re.search(r"flash_fwd_tc_kernelILi(\d+)E.*?(TcAllKeys|TcBand)", fn):
                fn = f"flash_fwd_tc_kernel<{k5.group(1)}{', band' if k5.group(2) == 'TcBand' else ''}>"
            elif "fwd_merge_kernel" in fn:
                fn = "fwd_merge_kernel"
            elif k2 := re.search(r"conv_pool_tc_kernelILi(\d+)ELi(\d+)E", fn):
                fn = f"conv_pool_tc_kernel<{k2.group(1)}, {k2.group(2)}>"
            elif "pack_weights_kernel" in fn:
                fn = "pack_weights_kernel"
            elif k1 := re.search(r"preprocess_cluster_kernelI([hf])E", fn):
                fn = f"preprocess_cluster_kernel<{'uint8' if k1.group(1) == 'h' else 'float'}>"
        elif (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)) and fn:
            report.setdefault(fn, {})["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        elif (m := re.search(r"Used (\d+) registers", line)) and fn:
            report.setdefault(fn, {})["registers"] = int(m.group(1))
            fn = None
    return report


def bwd_tc_parts(run, mask: str) -> dict:
    """Device ms of the parts of the tensor-core backward with mask policy ``mask`` in one traced call: the
    dK/dV and dQ kernels and the split sums."""
    def part_of(name):
        if "flash_bwd_tc_kernel" in name and mask in name:
            return "dkv_ms" if "true" in name else "dq_ms"
        return "reduction_ms" if "split_sum_kernel" in name else None
    return traced_parts(run, part_of, ("dkv_ms", "dq_ms", "reduction_ms"), ("dkv_ms", "dq_ms"))


def large_magnitude_case(dev: torch.device, window: int | None = None) -> dict:
    """The full forward (kernel 5), or with ``window`` the banded one (kernel 7), at the inputs of
    ``tests/test_torch_cuda_kernels.py::test_flash_large_magnitudes_stay_finite`` (scores near 1e3): the worst
    |err| of (out, lse) of the kernel against the plain version, of the kernel against the plain version in
    float64, and of the float32 plain version against float64 (ROADMAP §3).  The kernel must be at least as close
    to float64 as the float32 plain version."""
    q, k, v = (torch.as_tensor(np.random.default_rng(seed).standard_normal((1, 1000, 64)).astype(np.float32) * sc,
                               device=dev) for seed, sc in ((70, 10.0), (71, 10.0), (72, 1.0)))
    if window is None:
        name, kernel, plain_of = "flash_fwd", flash_fwd, flash_fwd_plain
    else:
        name = "flash_local_fwd"
        kernel = lambda *x: flash_local_fwd(*x, window)
        plain_of = lambda *x: flash_local_fwd_plain(*x, window)
    got, plain = kernel(q, k, v, 0.125), plain_of(q, k, v, 0.125)
    exact = plain_of(q.double(), k.double(), v.double(), 0.125)
    worst = lambda xs, ys: [(x.double() - y.double()).abs().max().item() for x, y in zip(xs, ys)]
    errs = {"kernel_vs_plain": worst(got, plain), "kernel_vs_float64": worst(got, exact),
            "plain_vs_float64": worst(plain, exact)}
    require(all(a <= b for a, b in zip(errs["kernel_vs_float64"], errs["plain_vs_float64"])),
            f"{name} at scores near 1e3: further from float64 than the plain version: {errs}")
    return errs


def large_magnitude_bwd_case(dev: torch.device) -> dict:
    """The banded backward (kernel 8) at the inputs of ``tests/test_torch_cuda_kernels.py::
    test_flash_bwd_large_magnitudes_stay_finite[48]`` (scores near 1e3, W = 48): the worst |err| over (dq, dk,
    dv), and its ratio to 1e-4·max(1, max|reference|), of the kernel against the plain version, of the kernel
    against the plain version in float64, and of the float32 plain version against float64.  The kernel must
    be within the tolerance of float64, and at least as close to it as the float32 plain version."""
    q, k, v, do = (torch.as_tensor(np.random.default_rng(seed).standard_normal((1, 1000, 64)).astype(np.float32) * sc,
                                   device=dev) for seed, sc in ((120, 10.0), (121, 10.0), (122, 1.0), (123, 1.0)))
    out, lse = flash_local_fwd_plain(q, k, v, 0.125, 48)
    got = flash_local_bwd(q, k, v, out, lse, do, 0.125, 48)
    plain = flash_local_bwd_plain(q, k, v, out, lse, do, 0.125, 48)
    exact = flash_local_bwd_plain(*(x.double() for x in (q, k, v, out, lse, do)), 0.125, 48)
    worst = lambda xs, ys: grads_err([x.double() for x in xs], ys)
    errs = {"kernel_vs_plain": worst(got, plain), "kernel_vs_float64": worst(got, exact),
            "plain_vs_float64": worst(plain, exact)}
    require(errs["kernel_vs_float64"][1] <= min(1.0, errs["plain_vs_float64"][1]),
            f"flash_local_bwd at scores near 1e3: further from float64 than the tolerance or the plain version: {errs}")
    return errs


def padded_case(name: str, run, plain) -> dict:
    """One call at a head width the kernels take zero-padded, against the plain version, at the
    tolerances of the unpadded cases (forwards: out 3e-5, lse 1e-5; backwards: grads_err)."""
    got, want = run(), plain()
    if name.endswith("bwd"):
        err, ratio = grads_err(got, want)
    else:
        e_out, e_lse = max_err(got[0], want[0]), max_err(got[1], want[1])
        err, ratio = max(e_out, e_lse), max(e_out / 3e-5, e_lse / 1e-5)
    if ratio > 1.0:
        raise AssertionError(f"{name} at head dim {PADDED_HEAD_DIM}: max |err| {err} beyond its tolerance")
    return {"shape": list(want[0].shape), "padded_to": padded_head_dim(PADDED_HEAD_DIM), "main_path": False,
            "max_abs_err": err, "checked": "a head width the kernels take zero-padded, against the plain version"}


def grads_err(got, want) -> tuple[float, float]:
    """Worst |err| of (dq, dk, dv) against the plain version, and its worst ratio to 1e-4·max(1, max|plain|):
    the 1e-4 of the grad tests of tests/test_flash_attention.py, scaled to each gradient's size (float32 sums
    over keys or queries in another order)."""
    err, ratio = 0.0, 0.0
    for g, w in zip(got, want):
        e = max_err(g, w)
        err, ratio = max(err, e), max(ratio, e / (1e-4 * max(1.0, w.abs().max().item())))
    return err, ratio


def check_attention_bwd_kernels(gen: torch.Generator) -> dict:
    """The two attention backwards against their plain versions, with times, bounds and the library backward.

    Inputs are the kernels' own forward outputs and a random cotangent; the
    library is ``scaled_dot_product_attention``'s backward through
    ``torch.autograd.grad`` on a retained graph, float32, TF32 off, with the
    boolean band mask for the banded form.
    """
    dev = torch.device("cuda")
    parts = {"flash_bwd": [], "flash_local_bwd": []}
    for h, t, d, window, main_path in ATTENTION_CASES:
        q, k, v, do = (torch.randn((h, t, d), generator=gen, device=dev) for _ in range(4))
        scale = d ** -0.5
        if window is None:
            name, mask = "flash_bwd", None
            out, lse = flash_fwd(q, k, v, scale)
            run = lambda: flash_bwd(q, k, v, out, lse, do, scale)
            plain = lambda: flash_bwd_plain(q, k, v, out, lse, do, scale)
        else:
            name = "flash_local_bwd"
            out, lse = flash_local_fwd(q, k, v, scale, window)
            run = lambda: flash_local_bwd(q, k, v, out, lse, do, scale, window)
            plain = lambda: flash_local_bwd_plain(q, k, v, out, lse, do, scale, window)
            idx = torch.arange(t, device=dev)
            mask = (idx[:, None] - idx[None, :]).abs() <= window
        err, ratio = grads_err(run(), plain())
        if ratio > 1.0:
            raise AssertionError(f"{name} {(h, t, d, window)}: max |err| {err} beyond 1e-4·max(1, max|plain|)")
        lq, lk, lv = (x.detach().clone().requires_grad_() for x in (q, k, v))
        with strict_f32():
            lib_out = F.scaled_dot_product_attention(lq[None], lk[None], lv[None], attn_mask=mask, scale=scale)

        def library():
            with strict_f32():
                return torch.autograd.grad(lib_out, (lq, lk, lv), do[None], retain_graph=True)

        lib_err, _ = grads_err(library(), plain())
        b, kind = attention_bwd_bound(h, t, d, window)
        part = {
            "shape": [h, t, d], "window": window, "main_path": main_path, "ms": time_ms(run),
            "plain_ms": time_ms(plain), "library_ms": time_ms(library), "library_max_abs_err": lib_err,
            "bound_ms": b, "bound_by": kind, "max_abs_err": err, "err_over_tolerance": ratio,
        }
        if d > 256:
            part["padded_to"] = padded_head_dim(d)
        if d in BWD_STREAM:   # kernel 6 or 8: plan, traced parts, held to the tensor cores' bound
            require(all(torch.equal(x, y) for x, y in zip(run(), run())), f"{name} {(h, t, d, window)}: two runs "
                    "on the same inputs differ")
            tc_b, tc_kind = attention_bwd_tc_bound(h, t, d, window)
            if window is None:
                label, plan, mask = "flash_bwd (kernel 6)", card_bwd_plan(h, t, t, d, dev), "TcAllKeys"
            else:
                label, mask = "flash_local_bwd (kernel 8)", "TcBand"
                plan = card_local_bwd_plan(h, t, t, d, window, 0, t, 0, dev)
            part.update(plan=plan._asdict(), parts_ms=bwd_tc_parts(run, mask), bound_ms=tc_b, bound_by=tc_kind,
                        f32_core_bound_ms=b)
            print(f"{label} at {[h, t, d]}{'' if window is None else f' W = {window}'}: {part['ms']:.4f} ms "
                  f"(library {part['library_ms']:.4f}, plain {part['plain_ms']:.4f}); plan {json.dumps(part['plan'])}; "
                  f"traced parts {json.dumps(part['parts_ms'])}; bound {tc_b:.4f} ms tensor cores in 3xTF32 "
                  f"({tc_kind}), {b:.4f} ms float32 cores; max |err| {err:.3g} ({ratio:.3g} of tolerance)",
                  flush=True)
        parts[name].append(part)
        del q, k, v, do, out, lse, mask, lq, lk, lv, lib_out
        torch.cuda.empty_cache()

    print(f"flash_local_bwd (kernel 8) at scores near 1e3, max |err| of (dq, dk, dv) and its ratio to the "
          f"tolerance: {json.dumps(large_magnitude_bwd_case(dev))}", flush=True)
    q, k, v, do = (torch.randn((2, 1000, PADDED_HEAD_DIM), generator=gen, device=dev) for _ in range(4))
    scale = PADDED_HEAD_DIM ** -0.5
    out, lse = flash_fwd_plain(q, k, v, scale)
    parts["flash_bwd"].append(padded_case("flash_bwd", lambda: flash_bwd(q, k, v, out, lse, do, scale),
                                          lambda: flash_bwd_plain(q, k, v, out, lse, do, scale)))
    out, lse = flash_local_fwd_plain(q, k, v, scale, 100)
    parts["flash_local_bwd"].append(padded_case(
        "flash_local_bwd", lambda: flash_local_bwd(q, k, v, out, lse, do, scale, 100),
        lambda: flash_local_bwd_plain(q, k, v, out, lse, do, scale, 100)))
    del q, k, v, do, out, lse

    # a full-rate match: dq of rows [a, b) needs only keys [a − W, b + W), and dk, dv of keys [a, b)
    # only queries [a − W, b + W), so the plain version on those slices, with the offset, gives them exactly
    t, d, w = MATCH_RATE_T, 128, ATTN_WINDOW
    q, k, v, do = (torch.randn((1, t, d), generator=gen, device=dev) for _ in range(4))
    out, lse = flash_local_fwd(q, k, v, d ** -0.5, w)
    dq, dk, dv = flash_local_bwd(q, k, v, out, lse, do, d ** -0.5, w)
    require(all(bool(torch.isfinite(x).all()) for x in (dq, dk, dv)), f"flash_local_bwd T={t}: non-finite output")
    err, ratio = 0.0, 0.0
    slices = [(a, a + 2048) for a in (0, t // 2, t - 2048)]
    for a, b in slices:
        s0, s1 = max(0, a - w), min(t, b + w)
        want_dq = flash_local_bwd_plain(q[:, a:b], k[:, s0:s1], v[:, s0:s1], out[:, a:b], lse[:, a:b], do[:, a:b],
                                        d ** -0.5, w, q_offset=a - s0)[0]
        want_dkv = flash_local_bwd_plain(q[:, s0:s1], k[:, a:b], v[:, a:b], out[:, s0:s1], lse[:, s0:s1],
                                         do[:, s0:s1], d ** -0.5, w, q_offset=s0 - a)[1:]
        e, r = grads_err((dq[:, a:b], dk[:, a:b], dv[:, a:b]), (want_dq, *want_dkv))
        if r > 1.0:
            raise AssertionError(f"flash_local_bwd T={t} slice [{a}, {b}): max |err| {e}")
        err, ratio = max(err, e), max(ratio, r)
    b, _ = attention_bwd_bound(1, t, d, w)
    tc_b, tc_kind = attention_bwd_tc_bound(1, t, d, w)
    parts["flash_local_bwd"].append({
        "shape": [1, t, d], "window": w, "main_path": False,
        "ms": time_ms(lambda: flash_local_bwd(q, k, v, out, lse, do, d ** -0.5, w)), "plain_ms": None,
        "library_ms": None, "bound_ms": tc_b, "bound_by": tc_kind, "f32_core_bound_ms": b,
        "plan": card_local_bwd_plan(1, t, t, d, w, 0, t, 0, dev)._asdict(), "max_abs_err": err,
        "err_over_tolerance": ratio,
        "checked": f"dq of rows and dk, dv of keys {', '.join(f'[{a}, {b})' for a, b in slices)} against the "
                   "plain version on their slices; every output finite",
    })
    del q, k, v, do, out, lse, dq, dk, dv
    torch.cuda.empty_cache()
    return {name: row_of(p) for name, p in parts.items()}


def match_knapsack(seed: int, frames: int = MATCH_FRAMES) -> tuple[np.ndarray, np.ndarray, int]:
    """A match's knapsack as summarize_match gives it: for a match of ``frames`` condensed frames (30 raw each),
    the frames // 10 clips of synthetic_change_points, each clip's summed importance (seeded integers 1 to 5 a
    condensed frame, expanded) and its length, and the capacity of 15 % of the raw frames."""
    full_n = frames * 30
    iv = np.clip(synthetic_change_points(full_n, frames // 10, seed=seed + 300), 0, full_n)
    per_frame = np.random.default_rng(seed + 300).integers(1, 6, frames).repeat(30)
    prefix = np.concatenate([[0], np.cumsum(per_frame)])
    lengths = np.maximum(iv[:, 1] - iv[:, 0], 0)
    return (prefix[iv[:, 0] + lengths] - prefix[iv[:, 0]]).astype(np.float64), lengths.astype(np.float64), \
        int(0.15 * full_n)


def time_engine(values, weights, capacity: int, engine: str, reps: int) -> tuple[list[int], float]:
    """One engine's selection and its median wall milliseconds (the device engine's ends when its mask is on the
    host)."""
    times, sel = [], None
    for _ in range(reps):
        t0 = time.perf_counter()
        sel = knapsack_select(values, weights, capacity, scale_factor=1, engine=engine, device="cuda")
        times.append(1e3 * (time.perf_counter() - t0))
    return sel, statistics.median(times)


@contextlib.contextmanager
def knapsack_engines_run():
    """The knapsack engines that run inside the block, in order: this script wraps each engine's entry point
    (the device engine's, the native solver's, the host table's) to record its name while the block runs."""
    ran = []
    entries = {"device": (knapsack_module, "knapsack_select_device"), "native": (runtime, "knapsack_native"),
               "host": (knapsack_module, "knapsack_table_host")}
    real = {engine: getattr(mod, fn) for engine, (mod, fn) in entries.items()}

    def spy(engine):
        return lambda *args: ran.append(engine) or real[engine](*args)

    for engine, (mod, fn) in entries.items():
        setattr(mod, fn, spy(engine))
    try:
        yield ran
    finally:
        for engine, (mod, fn) in entries.items():
            setattr(mod, fn, real[engine])


def fit_engine_model(sweep: list[dict]) -> tuple[tuple[float, float, float], tuple[float, float]]:
    """The constants of knapsack.DEVICE_MS and knapsack.NATIVE_MS from the sweep: the device engine's ms as
    fixed + per item · n + per cell · cells by least squares in relative error, the native one's as
    scale · cells^power by least squares in log-log."""
    n = np.array([r["clips"] for r in sweep], dtype=np.float64)
    cells = np.array([r["cells"] for r in sweep], dtype=np.float64)
    dev_ms = np.array([r["device_ms"] for r in sweep])
    a = np.stack([np.ones_like(n), n, cells], axis=1) / dev_ms[:, None]
    device = np.linalg.lstsq(a, np.ones_like(n), rcond=None)[0]
    power, log_scale = np.polyfit(np.log(cells), np.log([r["native_ms"] for r in sweep]), 1)
    return tuple(float(x) for x in device), (float(np.exp(log_scale)), float(power))


def knapsack_phase(seed: int, smi: str) -> None:
    """The device, native and host knapsack engines at a match's shape, their selections held equal, then the
    sweep for "auto"'s cost model: matches of 600-10,800 frames with their own clips and capacity (the
    pipeline's traffic), and capacities giving tables of about 1e6 to 1e8 cells at a match's 540 clips."""
    values, weights, capacity = match_knapsack(seed)
    knapsack_select(values, weights, capacity, scale_factor=1, engine="device", device="cuda")
    at_match = {}
    for engine in ("device", "native", "host"):
        sel, ms = time_engine(values, weights, capacity, engine, reps=5)
        at_match[engine] = {"ms": ms, "clips": len(sel)}
        at_match.setdefault("selection", sel)
        require(sel == at_match["selection"], f"knapsack at the match's shape: {engine} selects otherwise than device")
    del at_match["selection"]
    cells = len(values) * (capacity + 1)
    print(f"knapsack engines at the match's shape ({len(values)} clips, capacity {capacity}, {cells} cells) on "
          f"{smi}: selections equal; {json.dumps(at_match)}", flush=True)
    points = [("match", frames, *match_knapsack(seed, frames)) for frames in KNAPSACK_SWEEP_FRAMES]
    points += [("capacity", MATCH_FRAMES, values, weights, cap) for cap in KNAPSACK_SWEEP_CAPACITIES]
    sweep = []
    for kind, frames, v, wts, cap in points:
        row = {"sweep": kind, "frames": frames, "clips": len(v), "capacity": cap, "cells": len(v) * (cap + 1)}
        selections = []
        for engine in ("device", "native", "host"):
            sel, row[f"{engine}_ms"] = time_engine(v, wts, cap, engine, reps=1 if engine == "host" else 3)
            selections.append(sel)
        require(selections[0] == selections[1] == selections[2], f"knapsack sweep {row}: engines differ")
        row["faster"] = "device" if row["device_ms"] < row["native_ms"] else "native"
        row["auto"] = auto_engine(True, row["clips"], row["cells"], "cuda")
        sweep.append(row)
    fitted_device, fitted_native = fit_engine_model(sweep)
    agree = sum(r["faster"] == r["auto"] for r in sweep)
    print(f"knapsack engine sweep on {smi}: fitted DEVICE_MS = {json.dumps(fitted_device)}, NATIVE_MS = "
          f"{json.dumps(fitted_native)} (in the code: {json.dumps(DEVICE_MS)}, {json.dumps(NATIVE_MS)}); \"auto\" "
          f"picks the faster engine at {agree} of {len(sweep)} points; {json.dumps(sweep)}", flush=True)


_matches: dict = {}


def make_match(cfg: PipelineConfig, seed: int) -> dict:
    """One synthetic match: 600-frame segments as uint8 (the generator's float64
    temporaries for 5400 frames at once would take about 22 GB), its audio and clips.
    Cut: one seeded segment repeated (each segment takes about 9 s to make), as phase 9's video repeats one
    block.  Made once per seed and shape: phases 11-14 serve the match phase 5 spots."""
    key = (seed, cfg.preprocess.skip_frames, cfg.audio.sample_rate, MATCH_FRAMES)
    if key not in _matches:
        _matches[key] = _make_match(cfg, seed)
    return _matches[key]


def _make_match(cfg: PipelineConfig, seed: int) -> dict:
    skip = cfg.preprocess.skip_frames
    per_frame = cfg.audio.sample_rate * skip // 30
    segment = synthetic_video_frames(SEGMENT_FRAMES, *RAW_HW, seed=seed + 100)
    frames = np.concatenate([segment] * (MATCH_FRAMES // SEGMENT_FRAMES))
    full_n = MATCH_FRAMES * skip
    return {
        "frames": frames,
        "waveform": synthetic_waveform(MATCH_FRAMES * per_frame, cfg.audio.sample_rate, seed=seed + 100),
        "intervals": synthetic_change_points(full_n, MATCH_FRAMES // 10, seed=seed + 100),
        "full_n": full_n,
        "per_frame": per_frame,
    }


def drive(label: str, expect, fn, launches_by_path: dict):
    """Run one path with every launch count set to 0 just before and read just after."""
    for f, _, _ in KERNELS.values():
        f.launches = 0
    out = fn()
    torch.cuda.synchronize()
    got = {name: f.launches for name, (f, _, _) in KERNELS.items()}
    launches_by_path[label] = got
    missing = [name for name in expect if got[name] == 0]
    if missing:
        raise AssertionError(f"{label}: kernels never launched: {missing} (counts {got})")
    print(f"{label} launches: {json.dumps({k: v for k, v in got.items() if v})}", flush=True)
    return out


def run_match(match, params, state, tparams, cfg) -> tuple[np.ndarray, dict]:
    """The spotting path stage by stage, as ``summarize_match`` runs it after ``extract_features``;
    returns the scores and the wall milliseconds of each stage."""
    t0 = time.perf_counter()
    feats = extract_features(match["frames"], match["waveform"], cfg)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    enc = encode_timeline(params, state, feats["visual"], feats["audio"], cfg)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    scores = score_timeline_auto(tparams, enc, cfg).cpu().numpy()
    t3 = time.perf_counter()
    spot_events(scores, PEAK_WINDOW)
    summarize(scores_to_importance(scores), match["intervals"], cfg.preprocess.skip_frames, match["full_n"],
              cfg.knapsack)
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    return scores, {"extract_ms": 1e3 * (t1 - t0), "encode_ms": 1e3 * (t2 - t1), "score_ms": 1e3 * (t3 - t2),
                    "events_summarize_ms": 1e3 * (t4 - t3)}


def check_match(res, match) -> None:
    n = MATCH_FRAMES
    require(res.scores.shape == (n,) and bool(np.isfinite(res.scores).all()),
            f"match scores {res.scores.shape} or not finite")
    require(res.events.ndim == 1 and bool(((res.events >= 0) & (res.events < n)).all()), "event frames out of range")
    require(res.summary.frame_mask.shape == (match["full_n"],), "summary mask shape")
    require(0 < int(res.summary.frame_mask.sum()) <= int(0.15 * match["full_n"]) + len(res.summary.selected_clips),
            "summary frames outside the knapsack budget")


def peak_margin(s: np.ndarray, i: int, window: int, threshold: float = 0.0) -> float:
    """How far frame i's peak test (max of its ±window neighbourhood and > threshold) is from flipping."""
    nb = np.delete(s[max(0, i - window) : i + window + 1], i - max(0, i - window))
    return float(min(abs(s[i] - threshold), abs(s[i] - nb.max()) if len(nb) else np.inf))


def compare_events(a: np.ndarray, b: np.ndarray, tol: float, window: int = PEAK_WINDOW) -> list[dict]:
    """Frames whose event status differs between two score vectors; each must be a near tie."""
    ea, eb = set(spot_events(a, window).tolist()), set(spot_events(b, window).tolist())
    diffs = []
    for i in sorted(ea ^ eb):
        margin = min(peak_margin(a, i, window), peak_margin(b, i, window))
        if margin > tol:
            raise AssertionError(f"event at frame {i} differs, decided by {margin} > {tol}")
        diffs.append({"frame": i, "margin": margin})
    return diffs


def score_tolerance(scores: np.ndarray) -> float:
    # float32 sums in other orders through 2 layers at T = 5400: 1e-4 relative to the score scale
    return 1e-4 * max(1.0, float(np.abs(scores).max()))


def check_scorers_against_cpu(enc: torch.Tensor, scorers) -> dict:
    """Each scorer on the card's (T, 640) features, on the card and on the CPU (plain versions)."""
    enc_cpu = enc.cpu()
    out = {}
    for label, cfg, tp_np in scorers:
        card = score_timeline_auto(weights.tree_from_jax(tp_np), enc, cfg).cpu().numpy()
        cpu = score_timeline_auto(weights.tree_from_jax(tp_np, device="cpu"), enc_cpu, cfg).numpy()
        err, tol = float(np.abs(card - cpu).max()), score_tolerance(cpu)
        if err > tol:
            raise AssertionError(f"{label}: card vs CPU scores max |err| {err} > {tol}")
        out[label] = {"max_abs_err": err, "tolerance": tol, "near_tie_events": compare_events(card, cpu, tol)}
    return out


def check_trunk_against_cpu(match, feats, card_weights, cpu_weights, cfg) -> dict:
    """The first frames through extract_features and encode_timeline on the CPU against the card."""
    m = CPU_CHECK_FRAMES
    cpu_feats = extract_features(match["frames"][:m], match["waveform"][: m * match["per_frame"]], cfg, device="cpu")
    cpu_enc = encode_timeline(*cpu_weights, cpu_feats["visual"], cpu_feats["audio"], cfg, device="cpu")
    card_enc = encode_timeline(*card_weights, feats["visual"][:m], feats["audio"][:m], cfg).cpu()
    errs = {
        "visual_input": (feats["visual"][:m].cpu() - cpu_feats["visual"]).abs().max().item(),
        "audio_input": (feats["audio"][:m].cpu() - cpu_feats["audio"]).abs().max().item(),
        "features_rel": ((card_enc - cpu_enc).abs().max() / cpu_enc.abs().max()).item(),
    }
    # as check_against_cpu: inputs 1e-5 and cuFFT's 2e-3 + 1e-3·max; trunk features 1e-4 relative
    limits = {"visual_input": 1e-5, "audio_input": 2e-3 + 1e-3 * cpu_feats["audio"].abs().max().item(),
              "features_rel": 1e-4}
    for k, lim in limits.items():
        if not errs[k] <= lim:
            raise AssertionError(f"trunk card vs CPU: {k} max |err| {errs[k]} > {lim}")
    return errs


def spotting_phase(seed: int, smi: str, launches_by_path: dict):
    """The spotting path at the full width of configs/tpu_spotting*.json over one 5400-frame match.

    Returns the match's encoded (T, 640) features and, per scorer, (label, config, numpy head) for training.
    """
    banded_cfg = PipelineConfig.load(str(REPO / "configs" / "tpu_spotting.json"))
    full_cfg = dataclasses.replace(banded_cfg, model=dataclasses.replace(banded_cfg.model, temporal_window=0))
    hybrid_cfg = PipelineConfig.load(str(REPO / "configs" / "tpu_spotting_quality.json"))
    params_np, state_np = weights.init_params(banded_cfg, seed)
    params, state = weights.from_jax(params_np, state_np)
    in_dim = banded_cfg.model.vis_feature_dim + banded_cfg.model.aud_feature_dim
    transformer_np = weights.init_temporal_params(banded_cfg.model, in_dim, seed)
    hybrid_np = weights.init_temporal_params(hybrid_cfg.model, in_dim, seed)
    transformer, hybrid = weights.tree_from_jax(transformer_np), weights.tree_from_jax(hybrid_np)
    runs = (("spot_banded", banded_cfg, transformer, transformer_np, "flash_local_fwd"),
            ("spot_full", full_cfg, transformer, transformer_np, "flash_fwd"),
            ("spot_hybrid", hybrid_cfg, hybrid, hybrid_np, "flash_local_fwd"))

    t0 = time.perf_counter()
    match = make_match(banded_cfg, seed)
    print(f"match: {MATCH_FRAMES} frames of {RAW_HW} with audio and {len(match['intervals'])} clips, "
          f"made in {time.perf_counter() - t0:.1f} s", flush=True)
    feats = drive("spot_extract", ["fused_preprocess_frames"],
                  lambda: extract_features(match["frames"], match["waveform"], banded_cfg), launches_by_path)
    results = {}
    for label, cfg, tparams, _, kernel in runs:
        with knapsack_engines_run() as engines:
            results[label] = drive(label, [*TRUNK, kernel], lambda: summarize_match(
                params, state, tparams, feats["visual"], feats["audio"], match["intervals"], cfg), launches_by_path)
        check_match(results[label], match)
        print(f"{label}: {len(results[label].events)} events, {len(results[label].summary.selected_clips)} clips "
              f"selected by the knapsack engine {json.dumps(engines)} (\"auto\")", flush=True)

    # the stream in 600-frame chunks equals the offline banded scorer (finite receptive field)
    chunks = [slice(i, i + SEGMENT_FRAMES) for i in range(0, MATCH_FRAMES, SEGMENT_FRAMES)]
    updates = drive("spot_stream", [*TRUNK, "flash_local_fwd"], lambda: list(spot_stream(
        params, state, transformer, [feats["visual"][c] for c in chunks], banded_cfg,
        audio_chunks=[feats["audio"][c] for c in chunks], peak_window=PEAK_WINDOW)), launches_by_path)
    streamed = np.concatenate([u.scores for u in updates])
    offline = results["spot_banded"].scores
    err, tol = float(np.abs(streamed - offline).max()), score_tolerance(offline)
    if streamed.shape != offline.shape or err > tol:
        raise AssertionError(f"spot_stream scores {streamed.shape} vs offline: max |err| {err} > {tol}")
    # its events are spot_events of its scores exactly, and the offline events up to near ties
    if not np.array_equal(np.sort(np.concatenate([u.events for u in updates])), spot_events(streamed, PEAK_WINDOW)):
        raise AssertionError("spot_stream events differ from spot_events on the streamed scores")
    ties = compare_events(streamed, offline, tol)
    print(f"spot_stream: {len(updates)} updates, scores vs offline max |err| {err:.3g} (tol {tol:.3g}), "
          f"events equal except near ties {ties}", flush=True)

    enc = encode_timeline(params, state, feats["visual"], feats["audio"], banded_cfg)
    # the default GRU scorer (configs/reference_parity.json) beside the three of the path
    gru_cfg = PipelineConfig.load(str(REPO / "configs" / "reference_parity.json"))
    gru_np = weights.init_temporal_params(gru_cfg.model, in_dim, seed)
    cpu = check_scorers_against_cpu(enc, [*((label, cfg, tp_np) for label, cfg, _, tp_np, _ in runs),
                                          ("spot_gru", gru_cfg, gru_np)])
    print(f"scorers card vs CPU on the card's features: {json.dumps(cpu)}")
    # a GRU timeline past temporal_chunk_threshold, scored chunked with halos, on seeded features
    t_long = gru_cfg.model.temporal_chunk_threshold + LONG_GRU_EXTRA
    long_feats = torch.randn((t_long, in_dim), generator=torch.Generator().manual_seed(seed)).cuda()
    t0 = time.perf_counter()
    chunked = check_scorers_against_cpu(long_feats, [("gru_chunked", gru_cfg, gru_np)])
    print(f"GRU over {t_long} seeded frames (chunks of {gru_cfg.model.temporal_chunk}, halo "
          f"{gru_cfg.model.temporal_halo}) card vs CPU: {json.dumps(chunked)} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    del long_feats
    trunk = check_trunk_against_cpu(match, feats, (params, state),
                                    weights.from_jax(params_np, state_np, device="cpu"), banded_cfg)
    print(f"trunk card vs CPU on {CPU_CHECK_FRAMES} frames: {json.dumps(trunk)}", flush=True)
    del feats

    for label, cfg, tparams, _, _ in runs:
        stages = [run_match(match, params, state, tparams, cfg)[1] for _ in range(2)]
        totals = [sum(st.values()) for st in stages]
        p50 = statistics.median(totals)
        stage_ms = {k: statistics.median(st[k] for st in stages) for k in stages[0]}
        print(f"{label} on {smi}: per-match p50 {p50:.1f} ms over 2 runs = {1e3 * MATCH_FRAMES / p50:.1f} "
              f"frames/s; stages median ms {json.dumps(stage_ms)}", flush=True)
    prof = profile_run(lambda: run_match(match, params, state, transformer, banded_cfg))
    print(f"profile of one spot_banded match on {smi}: {json.dumps(prof)}", flush=True)
    return enc, [(label.replace("spot_", "train_"), cfg, tp_np) for label, cfg, _, tp_np, _ in runs]


def synthetic_labels(n: int, skip: int, seed: int, directory: str) -> np.ndarray:
    """Seeded events about one per EVENT_SPACING condensed frames, written as a ``.events.json`` sidecar in
    raw frame indices and read back with ``load_event_labels`` → (n,) 0/1 labels."""
    rng = np.random.default_rng(seed)
    n_events = n // EVENT_SPACING
    condensed = np.sort(rng.choice(n, n_events, replace=False))
    raw = condensed * skip + rng.integers(0, skip, n_events)
    path = os.path.join(directory, "match.events.json")
    with open(path, "w") as f:
        json.dump([int(i) for i in raw], f)
    labels = load_event_labels(path, n, skip)
    require(labels.shape == (n,) and int(labels.sum()) == n_events and bool((labels[condensed] == 1).all()),
            "event sidecar did not read back")
    return labels


def train_steps(step, params, features, labels, steps: int = TRAIN_STEPS):
    """``steps`` steps from ``params`` → (params, losses, wall ms per step, each ending in a synchronise)."""
    opt, losses, ms = init_spotting_opt(params), [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        params, opt, loss = step(params, opt, features, labels)
        losses.append(loss.item())   # waits for the card
        ms.append(1e3 * (time.perf_counter() - t0))
    return params, losses, ms


def attention_ms_at(name: str, shape: list, window: int) -> float:
    """The attention kernel ``name``'s time (CUDA events) at ``shape`` (H, T, d) on seeded inputs: for a step at a
    length the kernel phase timed no part at."""
    gen = torch.Generator(device="cuda").manual_seed(len(name))
    q, k, v, do = (torch.randn(shape, generator=gen, device="cuda") for _ in range(4))
    scale = shape[2] ** -0.5
    fwd = (lambda: flash_local_fwd(q, k, v, scale, window)) if window > 0 else (lambda: flash_fwd(q, k, v, scale))
    if name.endswith("_fwd"):
        return time_ms(fwd)
    out, lse = fwd()
    if window > 0:
        return time_ms(lambda: flash_local_bwd(q, k, v, out, lse, do, scale, window))
    return time_ms(lambda: flash_bwd(q, k, v, out, lse, do, scale))


def training_phase(enc_match: torch.Tensor, runs, seed: int, smi: str, kernel_rows: dict,
                   launches_by_path: dict) -> None:
    """Spotting training on the match's (T, 640) features, per scorer: first gradients and TRAIN_STEPS steps on the
    card against the CPU, then the trained head through a checkpoint file and back to scoring on the card.  The
    hybrid trains on the match's first HYBRID_TRAIN_FRAMES frames, with every check and tolerance of the others:
    its GRU steps through the timeline on the host, on the card and on the CPU alike."""
    n_match = enc_match.shape[0]
    with tempfile.TemporaryDirectory() as tmp:
        labels_match = synthetic_labels(n_match, runs[0][1].preprocess.skip_frames, seed + 200, tmp)
        print(f"training labels: {int(labels_match.sum())} events over {n_match} frames", flush=True)
        for label, cfg, tp_np in runs:
            mc = cfg.model
            n = min(n_match, HYBRID_TRAIN_FRAMES) if mc.temporal_model == "hybrid" else n_match
            enc, labels_np = enc_match[:n], labels_match[:n]
            enc_cpu = enc.cpu()
            y_card, y_cpu = torch.as_tensor(labels_np, device="cuda"), torch.as_tensor(labels_np)
            n_layers = mc.temporal_num_layers
            fwd, bwd = ("flash_local_fwd", "flash_local_bwd") if mc.temporal_window > 0 else ("flash_fwd", "flash_bwd")
            step = make_spotting_train_step(mc.temporal_hidden if mc.temporal_model == "hybrid" else 0, lr=1e-3,
                                            pos_weight=10.0, scorer=mc.temporal_model,
                                            num_heads=mc.temporal_num_heads, window=mc.temporal_window)
            card0, cpu0 = weights.tree_from_jax(tp_np), weights.tree_from_jax(tp_np, device="cpu")

            # the first step's gradients, leaf by leaf: float32 sums over 5400 frames in other orders,
            # 1e-4·max(1, max|g|) as the kernels' gradients are held
            g_card = tree_leaves(step.value_and_grad(card0, enc, y_card)[1])
            g_cpu = tree_leaves(step.value_and_grad(cpu0, enc_cpu, y_cpu)[1])
            grad_ratio = max((a.cpu() - b).abs().max().item() / (1e-4 * max(1.0, b.abs().max().item()))
                             for a, b in zip(g_card, g_cpu))
            if grad_ratio > 1.0:
                raise AssertionError(f"{label}: card vs CPU gradients beyond 1e-4·max(1, max|g|) ({grad_ratio:.3g}×)")

            trained, losses, step_ms = drive(label, [fwd, bwd], lambda: train_steps(step, card0, enc, y_card),
                                             launches_by_path)
            got = launches_by_path[label]
            require(got[fwd] == got[bwd] == TRAIN_STEPS * n_layers,
                    f"{label}: {got[fwd]} {fwd} and {got[bwd]} {bwd} launches for {TRAIN_STEPS} steps of "
                    f"{n_layers} layers")
            trained_cpu, losses_cpu, _ = train_steps(step, cpu0, enc_cpu, y_cpu)
            loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, losses_cpu))
            if loss_rel > 1e-4:
                raise AssertionError(f"{label}: card losses {losses} vs CPU {losses_cpu}")
            param_diff = max((a.cpu() - b).abs().max().item()
                             for a, b in zip(tree_leaves(trained), tree_leaves(trained_cpu)))

            # the trained head through a checkpoint file and back: the same scores and events on the card
            path = os.path.join(tmp, f"{label}.npz")
            save_spotting_checkpoint(path, trained)
            template = weights._map_with_paths(lambda _, t: t.detach().cpu().numpy(), trained)
            loaded = weights.tree_from_jax(weights.load_spotting_checkpoint(path, template))
            scores = score_timeline_auto(loaded, enc, cfg).cpu().numpy()
            in_memory = score_timeline_auto(trained, enc, cfg).cpu().numpy()
            require(np.array_equal(scores, in_memory), f"{label}: the reloaded head scores differently")
            events = spot_events(scores, PEAK_WINDOW)

            # the attention kernels' share of the steps, from their times at these shapes in the kernel phase (timed
            # here at a length it did not take)
            heads = mc.temporal_num_heads
            shape = [heads, n, mc.temporal_hidden // heads]
            attn_ms = TRAIN_STEPS * n_layers * sum(
                next((p["ms"] for p in kernel_rows[name]["parts"] if p["shape"] == shape), None)
                or attention_ms_at(name, shape, mc.temporal_window) for name in (fwd, bwd))
            record = {
                "frames": n, "losses": losses, "losses_cpu": losses_cpu, "loss_max_rel_err": loss_rel,
                "first_grads_err_over_tolerance": grad_ratio, "param_max_abs_diff_after_steps": param_diff,
                "step_ms": step_ms, "step_ms_median": statistics.median(step_ms),
                "attention_kernel_share_from_kernel_times": attn_ms / sum(step_ms),
                "reloaded_scores_equal": True, "events_after_training": len(events),
            }
            print(f"{label} on {smi}: {json.dumps(record)}", flush=True)
            if mc.temporal_model == "transformer":
                prof = profile_run(lambda: step(card0, init_spotting_opt(card0), enc, y_card))
                print(f"profile of one {label} step on {smi}: {json.dumps(prof)}", flush=True)


def make_infer_inputs(cfg: PipelineConfig, seed: int, root: str) -> dict:
    """One seeded raw video (4,500 frames of 180×320×3 uint8, one 500-frame generator block repeated, as
    :func:`write_video` makes it) saved as ``.npz``, its 22,050 Hz ``.wav`` sidecar written with the port's
    ``write_wav``, and the two trunks of ``weights.init_params(cfg, seed)`` (with audio and ``--no-audio``)
    written with the port's ``save_checkpoint`` under ``<root>/work/models/importance{,_no_audio}``."""
    video = os.path.join(root, "video.npz")
    raw = write_video(video, sum(INFER_SEGMENTS), RAW_HW, seed + 300, cfg)
    cfg_path = os.path.join(root, "cfg.json")
    cfg.save(cfg_path)
    work = os.path.join(root, "work")
    for audio in (True, False):
        c = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, audio_included=audio))
        save_checkpoint(cli._artifact_paths(work, audio)["ckp_dir"], create_train_state(seed, c, device="cpu"), c,
                        tag="opt")
    return {"raw": raw, "video": video, "cfg_path": cfg_path, "work": work}


class ExportSink:
    """Keeps the frames ``data.video.export_video`` is handed.  Where this machine has cv2 or imageio it also
    writes the mp4 with the real ``export_video``; where it has neither it writes nothing (the real one, like
    the JAX package's, raises ``ImportError`` there)."""

    def __init__(self, write: bool):
        self.frames: np.ndarray | None = None
        self.path: str | None = None
        self.writer = video_io.export_video
        self.write = write

    def __call__(self, frames, output_path, fps=30):
        self.frames = np.array(frames, copy=True)
        if self.write:
            self.writer(frames, output_path, fps=fps)
            self.path = output_path


class ScoreSpy:
    """Wraps ``streaming.score_video_stream`` as the CLI calls it: keeps its scores, stats and wall."""

    def __init__(self):
        self.fn = streaming.score_video_stream
        self.calls: list[dict] = []

    def __call__(self, *args, **kw):
        t0 = time.perf_counter()
        scores, stats = self.fn(*args, **kw)
        self.calls.append({"scores": scores, "stats": stats, "wall_s": time.perf_counter() - t0})
        return scores, stats


def chosen_frames(raw: np.ndarray, intervals) -> np.ndarray:
    return np.concatenate([raw[int(a):int(b)] for a, b in intervals])


def rounding_flips(a: np.ndarray, b: np.ndarray, tol: float) -> list[dict]:
    """Frames whose rounded scores differ between two runs; each must lie within ``tol`` of a .5 boundary."""
    flips = []
    for i in np.flatnonzero(np.round(a) != np.round(b)):
        margin = abs(abs(float(b[i]) - np.floor(float(b[i]))) - 0.5)
        require(margin <= tol, f"frame {i}: rounded scores {np.round(a[i])} and {np.round(b[i])} differ "
                               f"{margin:.3g} from a rounding boundary (> {tol})")
        flips.append({"frame": int(i), "scores": [float(a[i]), float(b[i])], "boundary_margin": margin})
    return flips


def traced_host_peak(run) -> float:
    """Peak MB of host memory that Python and NumPy allocated during ``run()`` (tracemalloc; torch's own host
    allocations are not traced)."""
    import tracemalloc

    tracemalloc.start()
    try:
        run()
        return tracemalloc.get_traced_memory()[1] / 2**20
    finally:
        tracemalloc.stop()


def infer_phase(seed: int, smi: str, launches_by_path: dict) -> None:
    """Phase 9: ``cli.main(["infer", ...])`` in-process on the card at the full width of
    ``configs/reference_parity.json``, offline and with ``--stream``, ``--host-preprocess``
    (``--transfer-dtype`` unset, float16, uint8) and ``--follow``, each against the direct path."""
    os.environ.pop("GOALNET_PLATFORM", None)   # the CLI runs on the card, as a user's call would
    present = {}
    for name in ("cv2", "imageio", "h5py", "matplotlib"):
        try:
            __import__(name)
            present[name] = True
        except ImportError:
            present[name] = False
    print(f"phase 8: packages on this machine: {json.dumps(present)}", flush=True)

    cfg = PipelineConfig.load(str(REPO / "configs" / "reference_parity.json"))
    no_audio = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, audio_included=False))
    skip = cfg.preprocess.skip_frames
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        inp = make_infer_inputs(cfg, seed, root)
        raw, video = inp["raw"], inp["video"]
        full_n, n = len(raw), len(raw[::skip])
        print(f"phase 9: video of {full_n} raw frames ({n} condensed) of {RAW_HW}, its wav and two trunks written "
              f"in {time.perf_counter() - t0:.1f} s", flush=True)

        writes = present["cv2"] or present["imageio"]
        sink, spy = ExportSink(writes), ScoreSpy()
        if not writes:
            try:
                sink.writer(raw[:2], os.path.join(root, "probe.mp4"))
            except ImportError as e:
                print(f"phase 9: export_video raises ImportError here ({e}), as the JAX package's does", flush=True)
            else:
                raise AssertionError("export_video wrote an mp4 with neither cv2 nor imageio")
        print(f"phase 9: data.video.export_video is wrapped by a sink that keeps the frames it is handed "
              f"({'and writes the mp4: this machine has a writer' if writes else 'and writes nothing: this machine has neither cv2 nor imageio'}); "
              "streaming.score_video_stream is wrapped to keep its scores", flush=True)
        video_io.export_video, streaming.score_video_stream = sink, spy
        base = ["infer", video, "--config", inp["cfg_path"], "--workdir", inp["work"]]
        walls = {}

        def infer(label, argv, expect, rc=0):
            t0 = time.perf_counter()
            got = drive(label, expect, lambda: cli.main(argv), launches_by_path) if expect else cli.main(argv)
            walls[label] = time.perf_counter() - t0
            require(got == rc, f"{label}: exit code {got}, expected {rc}")

        try:
            # the direct path on the same inputs: extract_features → fuse → summarize
            intervals = uniform_clip_intervals(cfg, full_n)
            waveform, _ = load_waveform(os.path.join(root, "video.wav"), cfg.audio.sample_rate)
            direct = {}
            for audio, c in ((True, cfg), (False, no_audio)):
                p, s = weights.from_jax(*weights.init_params(c, seed))
                scores = fuse(p, s, extract_features(raw[::skip], waveform if audio else None, c), c)
                direct[audio] = (scores, summarize(scores, intervals, skip, full_n, c.knapsack))
            for audio, (_, res) in direct.items():
                require(len(res.clip_intervals) > 0, f"direct path (audio {audio}): no clip selected")

            # 1. offline, the audio trunk: kernels 1-4
            infer("infer offline", base, ["fused_preprocess_frames", *TRUNK, "fused_fusion_mlp"])
            require(np.array_equal(sink.frames, chosen_frames(raw, direct[True][1].clip_intervals)),
                    "offline infer exported other frames than extract_features → fuse → summarize selects")
            offline_frames = len(sink.frames)
            if present["cv2"]:
                written = len(video_io.decode_all_frames(sink.path))
                require(written == offline_frames, f"the offline mp4 holds {written} frames, not {offline_frames}")
                print(f"phase 9: the offline mp4 read back with cv2: {written} frames", flush=True)

            # 2. --no-audio --stream: three chunks (64, 64, 22), kernels 1-4; scores against offline --no-audio
            spy.calls.clear()
            stream = base + ["--no-audio", "--stream", "--stream-chunk", str(INFER_CHUNK)]
            infer("infer --stream", stream, ["fused_preprocess_frames", *TRUNK, "fused_fusion_mlp"])
            call = spy.calls[-1]
            require((call["stats"].chunks, call["stats"].frames) == (-(-n // INFER_CHUNK), n),
                    f"--stream: {call['stats'].chunks} chunks of {call['stats'].frames} frames")
            stream_err = float(np.abs(call["scores"] - direct[False][0]).max())
            require(stream_err <= 1e-4, f"--stream scores {stream_err} from offline --no-audio scoring (> 1e-4)")
            flips = rounding_flips(call["scores"], direct[False][0], 1e-4)
            stream_res = summarize(call["scores"], intervals, skip, full_n, no_audio.knapsack)
            if not flips:
                require(stream_res.selected_clips == direct[False][1].selected_clips,
                        "--stream selects other clips than offline --no-audio with equal rounded scores")
            require(np.array_equal(sink.frames, chosen_frames(raw, stream_res.clip_intervals)),
                    "--stream exported other frames than its scores select")
            stream_frames, stream_scores = sink.frames, call["scores"]
            print(f"phase 9: --stream on {smi}: scores max |err| {stream_err:.3g} against offline --no-audio "
                  f"(1e-4); clips flipped at a rounding boundary {json.dumps(flips)}; selection "
                  f"{'equal' if stream_res.selected_clips == direct[False][1].selected_clips else 'differs'}; "
                  f"{len(stream_frames)} frames exported (offline, audio trunk: {offline_frames}); "
                  f"{call['stats'].frames / call['wall_s']:.1f} streamed frames/s; stages "
                  f"{json.dumps(call['stats'].stage_seconds)}", flush=True)

            # 3. --host-preprocess: kernels 2-4, never kernel 1; scores at the JAX package's bounds
            for tdtype, bound in TRANSFER_BOUNDS.items():
                label = f"infer --stream --host-preprocess{' --transfer-dtype ' + tdtype if tdtype else ''}"
                spy.calls.clear()
                infer(label, stream + ["--host-preprocess"] + (["--transfer-dtype", tdtype] if tdtype else []),
                      [*TRUNK, "fused_fusion_mlp"])
                require(launches_by_path[label]["fused_preprocess_frames"] == 0, f"{label}: kernel 1 launched")
                call = spy.calls[-1]
                err = float(np.abs(call["scores"] - stream_scores).max())
                require(err <= bound, f"{label}: scores {err} from device preprocessing (> {bound})")
                print(f"phase 9: {label} on {smi}: scores max |err| {err:.3g} against device preprocessing "
                      f"({bound}); {call['stats'].frames / call['wall_s']:.1f} streamed frames/s; stages "
                      f"{json.dumps(call['stats'].stage_seconds)}", flush=True)

            # 4. --follow over a directory a writer thread fills with three segments, then END
            live = os.path.join(root, "live")
            os.makedirs(live)

            def writer():
                for i, part in enumerate(np.split(raw, np.cumsum(INFER_SEGMENTS)[:-1])):
                    time.sleep(0.1)
                    with open(os.path.join(live, f"{i:05d}.npz.part"), "wb") as f:
                        np.savez(f, frames=part)
                    os.replace(os.path.join(live, f"{i:05d}.npz.part"), os.path.join(live, f"{i:05d}.npz"))
                open(os.path.join(live, "END"), "w").close()

            spy.calls.clear()
            w = threading.Thread(target=writer)
            w.start()
            try:
                follow = ["infer", live, "--config", inp["cfg_path"], "--workdir", inp["work"], "--no-audio",
                          "--stream", "--stream-chunk", str(INFER_CHUNK), "--follow", "--follow-poll", "0.05",
                          "--follow-timeout", "60"]
                infer("infer --stream --follow", follow, ["fused_preprocess_frames", *TRUNK, "fused_fusion_mlp"])
            finally:
                w.join(60.0)
            require(not w.is_alive(), "--follow: the writer thread did not finish")
            require(spy.calls[-1]["stats"].frames == n, f"--follow streamed {spy.calls[-1]['stats'].frames} frames")
            require(np.array_equal(sink.frames, stream_frames), "--follow exported other frames than the file run")

            # 5. --follow on a file: exit 2
            infer("infer --stream --follow FILE", stream + ["--follow"], None, rc=2)

            # offline against streamed (--no-audio both), in turns
            offline = base + ["--no-audio"]
            turns = {"offline": [], "stream": []}
            for _ in range(INFER_REPEATS):
                for key, argv in (("offline", offline), ("stream", stream)):
                    t0 = time.perf_counter()
                    require(cli.main(argv) == 0, f"{key} run failed")
                    turns[key].append(time.perf_counter() - t0)
                    want = direct[False][1].clip_intervals if key == "offline" else stream_res.clip_intervals
                    require(np.array_equal(sink.frames, chosen_frames(raw, want)),
                            f"{key} --no-audio infer exported other frames than the direct path selects")
            peaks = {key: traced_host_peak(lambda: cli.main(argv)) for key, argv in (("offline", offline),
                                                                                     ("stream", stream))}
            print(f"phase 9: infer walls on {smi} (s, one run each, cli.main in-process): "
                  f"{json.dumps(walls)}", flush=True)
            print(f"phase 9: --no-audio offline vs --stream on {smi}, {INFER_REPEATS} runs each in turns: offline "
                  f"{json.dumps(turns['offline'])} (median {statistics.median(turns['offline']):.4f} s), stream "
                  f"{json.dumps(turns['stream'])} (median {statistics.median(turns['stream']):.4f} s); traced "
                  f"host peak MB (Python/NumPy allocations): {json.dumps(peaks)}; the raw video alone is "
                  f"{raw.nbytes / 2**20:.1f} MB and offline infer loads it twice", flush=True)
            # the host pieces every run pays, timed alone: the raw video read back, the template state, the trunk
            pieces = {}
            t0 = time.perf_counter()
            np.load(video)["frames"]
            pieces["npz_load_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            template = create_train_state(no_audio.train.seed, no_audio)
            torch.cuda.synchronize()
            pieces["template_state_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            load_checkpoint(cli._artifact_paths(inp["work"], False)["ckp_dir"], template, tag="opt")
            torch.cuda.synchronize()
            pieces["checkpoint_load_s"] = time.perf_counter() - t0
            del template
            print(f"phase 9: host pieces of one run on {smi}: {json.dumps(pieces)}", flush=True)
            for key, argv in (("offline", offline), ("stream", stream)):
                prof = profile_run(lambda: cli.main(argv))
                print(f"phase 9: profile of one --no-audio {key} infer on {smi}: {json.dumps(prof)}", flush=True)
        finally:
            video_io.export_video, streaming.score_video_stream = sink.writer, spy.fn


class Tee:
    """A stream that writes to several: a verb's output is printed and kept."""

    def __init__(self, *streams):
        self.streams = streams

    def write(self, text):
        for st in self.streams:
            st.write(text)
        return len(text)

    def flush(self):
        for st in self.streams:
            st.flush()

    def isatty(self):
        return False


class AnnotationStand:
    """In-memory stand-in for ``data.dataset.AnnotationStore`` (this machine may have no h5py to read the
    ``.mat``/``.h5`` pair): each video's annotator scores and change points from the seeded arrays
    :func:`make_train_inputs` writes into ``anno.tsv``, the rule ``synthetic_dataset_dir`` writes them by."""

    arrays: dict = {}

    def __init__(self, mat_file_path=None, h5_file_path=None):
        pass

    def user_annotations(self, video_id: str) -> np.ndarray:
        return self.arrays[video_id]["anno"]

    def change_points(self, video_id: str) -> np.ndarray:
        return self.arrays[video_id]["change_points"]


class PlotSink:
    """Keeps what ``viz.generate_metric_plots`` and ``viz.export_indices`` are handed (this machine may have
    no matplotlib; the JAX package's ``train`` needs it too)."""

    def __init__(self):
        self.curves: list[int] = []
        self.indices: list[tuple] = []

    def metric_plots(self, history, out_fp, opt_val_loss=None):
        self.curves.append(len(history["train_loss"]))

    def export_indices(self, pred_mask, gd_masks, out_fp):
        self.indices.append((pred_mask.shape, gd_masks.shape, int(pred_mask.sum())))


_train_frames: dict = {}


def make_train_inputs(cfg: PipelineConfig, seed: int, root: str) -> dict:
    """Four seeded videos vidA-vidD (``TRAIN_VIDEO_FRAMES`` raw 72×96 uint8 frames as ``.npz``, the 22,050 Hz
    ``.wav`` sidecars), ``anno.tsv`` with 20 annotators' 1-5 grades per raw frame and ``info.tsv``, as
    ``synthetic_dataset_dir`` lays them out; the annotator arrays and change points go to
    :class:`AnnotationStand`."""
    rng = np.random.default_rng(seed)
    ids = [f"vid{c}" for c in "ABCD"[:len(TRAIN_VIDEO_FRAMES)]]
    fps, rows, arrays = [], [], {}
    for i, (vid, n) in enumerate(zip(ids, TRAIN_VIDEO_FRAMES)):
        path = os.path.join(root, f"{vid}.npz")
        key = (n, TRAIN_RAW_HW, seed + 400 + i)
        if key not in _train_frames:   # made once (about 8 s a video); phases 10, 13, 14 and 17 write them
            _train_frames[key] = synthetic_video_frames(n, *TRAIN_RAW_HW, seed=seed + 400 + i)
        np.savez(path, frames=_train_frames[key])
        write_wav(os.path.join(root, f"{vid}.wav"),
                  synthetic_waveform(int(n / 30 * cfg.audio.sample_rate), cfg.audio.sample_rate, seed=seed + 400 + i),
                  cfg.audio.sample_rate)
        anno = rng.integers(1, 6, size=(TRAIN_ANNOTATORS, n)).astype(np.float64)
        rows += [f"{vid}\tcategory\t{','.join(str(int(x)) for x in a)}" for a in anno]
        arrays[vid] = {"anno": anno,
                       "change_points": synthetic_change_points(n - 1, n // TRAIN_CLIP_FRAMES, seed=seed + 400 + i)}
        fps.append(path)
    with open(os.path.join(root, "anno.tsv"), "w") as f:
        f.write("\n".join(rows) + "\n")
    with open(os.path.join(root, "info.tsv"), "w") as f:
        f.write("video_id\ttitle\n" + "".join(f"{v}\tTitle of {v}\n" for v in ids))
    AnnotationStand.arrays = arrays
    return {"videos": fps, "annotation_fp": os.path.join(root, "anno.tsv"), "info_fp": os.path.join(root, "info.tsv"),
            "mat_fp": os.path.join(root, "gt.mat"), "h5_fp": os.path.join(root, "gt.h5")}


class EvalLaunches:
    """Wraps ``train.loop.eval_video``: every evaluation must launch kernel 2 twice and kernels 3 and 4 once
    (the eval forward on the card); counts the evaluations."""

    EXPECT = {"fused_conv_pool_stage": 2, "head_matmul": 1, "fused_fusion_mlp": 1}

    def __init__(self):
        self.fn = train_loop.eval_video
        self.calls = 0

    def __call__(self, *args, **kw):
        before = {name: KERNELS[name][0].launches for name in self.EXPECT}
        out = self.fn(*args, **kw)
        got = {name: KERNELS[name][0].launches - before[name] for name in self.EXPECT}
        require(got == self.EXPECT, f"an evaluation launched {got}, not {self.EXPECT}")
        self.calls += 1
        return out


class EpochClock:
    """Times the pieces of ``train_importance_model``'s epochs: each video's train function (synchronised),
    each ``evaluate_dataset`` and each checkpoint write, and the end of each epoch."""

    def __init__(self):
        self.make_fn, self.evaluate, self.save = (train_loop.make_train_video_fn, train_loop.evaluate_dataset,
                                                  checkpoint_io.save_checkpoint)
        self.events: list[tuple[str, float, float]] = []   # (what, start, end)

    def _timed(self, what, fn):
        def run(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            self.events.append((what, t0, time.perf_counter()))
            return out
        return run

    def __enter__(self):
        train_loop.make_train_video_fn = lambda *a, **kw: self._timed("train", self.make_fn(*a, **kw))
        train_loop.evaluate_dataset = self._timed("eval", self.evaluate)
        checkpoint_io.save_checkpoint = self._timed("checkpoint", self.save)
        return self

    def __exit__(self, *exc):
        train_loop.make_train_video_fn, train_loop.evaluate_dataset, checkpoint_io.save_checkpoint = (
            self.make_fn, self.evaluate, self.save)

    def epoch_end(self, epoch, history, best):
        self.events.append(("epoch_end", time.perf_counter(), time.perf_counter()))

    def split(self) -> list[dict]:
        """Per epoch: wall from the end of the one before (of the initial checkpoint for the first) to its end,
        and the seconds in train, eval and checkpoint inside it."""
        out, start, acc = [], None, {"train": 0.0, "eval": 0.0, "checkpoint": 0.0}
        for what, t0, t1 in self.events:
            if what == "epoch_end":
                out.append({"wall_s": t1 - start, **{f"{k}_s": v for k, v in acc.items()}})
                start, acc = t1, {k: 0.0 for k in acc}
            elif start is None:
                start = t1 if what == "checkpoint" else start   # the initial opt checkpoint opens epoch 0
            else:
                acc[what] += t1 - t0
        return out


def state_bytes(state) -> dict:
    """Bytes of the training state resident on the card: parameters, batchnorm statistics, Adam's moments."""
    size = lambda tree: sum(t.numel() * t.element_size() for t in tree_leaves(tree))   # noqa: E731
    return {"params": size(state.params), "batchnorm": size(state.model_state), "adam_mu": size(state.opt_state.mu),
            "adam_nu": size(state.opt_state.nu)}


def on_cpu(item):
    return dataclasses.replace(item, visual=item.visual.cpu(), audio=None if item.audio is None else item.audio.cpu(),
                               text=None if item.text is None else item.text.cpu())


def train_against_cpu(cfg: PipelineConfig, train_ds, val_ds, seed: int) -> dict:
    """From one seeded state at dropout 0, the card against the CPU on the same items: first sub-batch gradients;
    eval predictions and F-scores; one epoch on the card with the CPU's loss at every sub-batch taken at the
    card's parameters and batchnorm state, per video; a checkpoint of the trained state saved and reloaded.

    The CPU follows the card's trajectory rather than its own: two free-running float32 trajectories part at
    max-pool windows whose two largest values lie within rounding of each other (the gradient takes the other
    one), and Adam carries that on: on the CPU alone, frames scaled by 1 + 1.2e-7 move the twelfth sub-batch's
    loss of a 150-frame video by a quarter, where float32 and float64 agree within 2e-6
    (``tools/train_divergence.py``).  The loss itself has no such jump."""
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, dropout_rate=0.0))
    dev, cpu = train_ds[0].visual.device, torch.device("cpu")
    S = cfg.train.subbatch_size
    items = {"card": list(train_ds) + list(val_ds), "cpu": [on_cpu(it) for it in list(train_ds) + list(val_ds)]}
    states = {"card": create_train_state(seed, cfg, device=dev), "cpu": create_train_state(seed, cfg, device=cpu)}
    fn = train_loop.make_train_video_fn(cfg)
    grads, evals, fscores = {}, {}, {}
    for name, d in (("card", dev), ("cpu", cpu)):
        st = states[name]
        v, a, lab, valid, _ = train_loop._pad_video(items[name][0], S, d)
        grads[name] = [g.cpu() for g in tree_leaves(
            fn.value_and_grad(st.params, st.model_state, v[:S], a[:S], lab[:S], valid[:S], None)[3])]
        evals[name] = [train_loop.eval_video(st, it, cfg) for it in items[name]]
        fscores[name] = [train_loop._video_fscores(it, p, cfg, d) for it, (p, _) in zip(items[name], evals[name])]
    grad_ratio = max((a - b).abs().max().item() / (1e-4 * max(1.0, b.abs().max().item()))
                     for a, b in zip(grads["card"], grads["cpu"]))
    require(grad_ratio <= 1.0, f"training: card vs CPU first gradients beyond 1e-4·max(1, max|g|) ({grad_ratio:.3g}×)")
    pred_err = max(float(np.abs(a[0] - b[0]).max()) for a, b in zip(evals["card"], evals["cpu"]))
    require(pred_err <= 1e-4, f"training: card eval predictions {pred_err} from the CPU's (> 1e-4)")
    flips = {}
    for it, (pa, _), (pb, _), fa, fb in zip(items["card"], evals["card"], evals["cpu"], fscores["card"],
                                          fscores["cpu"]):
        f = rounding_flips(pa, pb, 1e-4)
        if f:
            flips[it.video_id] = {"frames": f, "fscores": [fa, fb]}
        else:
            require(fa == fb, f"training: {it.video_id} F-scores {fa} (card) and {fb} (CPU) with equal rounded scores")

    # one epoch on the card; the CPU's loss of each sub-batch at the card's parameters before its step
    st = states["card"]
    params, ms, opt = st.params, st.model_state, st.opt_state
    losses = {"card": [], "cpu": []}
    to_cpu = lambda tree: tree_map(lambda t: t.cpu(), tree)   # noqa: E731
    for it_card, it_cpu in zip(train_ds, items["cpu"]):
        v, a, lab, valid, _ = train_loop._pad_video(it_card, S, dev)
        vh, ah, labh, validh, _ = train_loop._pad_video(it_cpu, S, cpu)
        card, host = [], []
        for i in range(len(v) // S):
            sl = slice(i * S, (i + 1) * S)
            host.append(float(fn.value_and_grad(to_cpu(params), to_cpu(ms), vh[sl], ah[sl], labh[sl], validh[sl],
                                                None)[0]))
            params, ms, opt, _, loss = fn(params, ms, opt, v[sl], a[sl], lab[sl], valid[sl], None)
            card.append(loss)
        losses["card"].append(float(torch.stack(card).mean()))
        losses["cpu"].append(float(np.mean(host)))
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses["card"], losses["cpu"]))
    require(loss_rel <= 1e-4, f"training: card losses {losses['card']} vs CPU {losses['cpu']}")

    # the trained state through a checkpoint file and back evaluates bit for bit as the state in memory
    trained = TrainState(params, ms, opt, 1)
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, trained, cfg, tag="ckp")
        loaded = load_checkpoint(d, create_train_state(seed + 1, cfg, device=dev), tag="ckp")
    reloaded_equal = loaded.epoch == 1 and loaded.opt_state.step == opt.step and all(
        np.array_equal(train_loop.eval_video(loaded, it, cfg)[0], train_loop.eval_video(trained, it, cfg)[0])
        for it in items["card"])
    require(reloaded_equal, "training: the reloaded checkpoint evaluates differently from the state in memory")
    return {"first_grads_err_over_tolerance": grad_ratio, "eval_pred_max_abs_err": pred_err,
            "fscores_card": fscores["card"], "fscores_cpu": fscores["cpu"], "rounding_flips": flips,
            "epoch_losses_card": losses["card"], "epoch_losses_cpu_at_the_cards_parameters": losses["cpu"],
            "loss_max_rel_err": loss_rel, "adam_steps": opt.step, "reloaded_checkpoint_evaluates_bit_equal": True}


def training_journey_phase(seed: int, smi: str, launches_by_path: dict) -> None:
    """Phase 10: the training verbs in-process on the card at the full width of ``configs/reference_parity.json``,
    the loop's recovery paths, the card against the CPU, and the journey's numbers."""
    os.environ.pop("GOALNET_PLATFORM", None)   # the CLI runs on the card, as a user's call would
    cfg = PipelineConfig.load(str(REPO / "configs" / "reference_parity.json"))
    n_videos = len(TRAIN_VIDEO_FRAMES)
    kernels = ["fused_preprocess_frames", *TRUNK, "fused_fusion_mlp"]
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        data = make_train_inputs(cfg, seed, root)
        cfg_path = os.path.join(root, "cfg.json")
        cfg.save(cfg_path)
        print(f"phase 10: {n_videos} videos of {list(TRAIN_VIDEO_FRAMES)} raw frames of {TRAIN_RAW_HW} with their "
              f"wav and anno.tsv rows written in {time.perf_counter() - t0:.1f} s", flush=True)
        print("phase 10: data.dataset.AnnotationStore is replaced by an in-memory stand-in (change points and "
              "annotator scores from the seeded arrays; the .mat/.h5 pair needs h5py, which the CPU tests read), "
              "and viz.generate_metric_plots / viz.export_indices by sinks that keep what they are handed "
              "(matplotlib; the plots are drawn by the CPU tests)", flush=True)
        store, plots, evals = dataset_io.AnnotationStore, PlotSink(), EvalLaunches()
        saved = (viz.generate_metric_plots, viz.export_indices, train_loop.eval_video)
        dataset_io.AnnotationStore = AnnotationStand
        viz.generate_metric_plots, viz.export_indices, train_loop.eval_video = (plots.metric_plots,
                                                                                 plots.export_indices, evals)
        work = os.path.join(root, "work")
        args = ["--videos", *data["videos"], "--annotation-fp", data["annotation_fp"], "--mat-fp", data["mat_fp"],
                "--h5-fp", data["h5_fp"], "--info-fp", data["info_fp"], "--config", cfg_path, "--workdir", work]
        walls = {}
        try:
            def verb(label, argv):
                evals.calls = 0
                buf = io.StringIO()
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(Tee(buf, sys.stdout)):
                    rc = drive(label, kernels, lambda: cli.main(argv), launches_by_path)
                walls[label] = time.perf_counter() - t0
                require(rc == 0, f"{label}: exit code {rc}")
                got = launches_by_path[label]
                require(got["fused_preprocess_frames"] == n_videos,
                        f"{label}: kernel 1 launched {got['fused_preprocess_frames']} times for {n_videos} videos")
                require(evals.calls > 0 and got["head_matmul"] == evals.calls,
                        f"{label}: {got['head_matmul']} head launches for {evals.calls} evaluations")
                print(f"phase 10: {label}: {evals.calls} evaluations, each launching kernel 2 twice and kernels "
                      f"3 and 4 once; wall {walls[label]:.3f} s on {smi}", flush=True)
                return buf.getvalue()

            out = verb("train", ["train", *args, "--epochs", str(TRAIN_EPOCHS)])
            require(f"Number of train videos: {n_videos - 1}" in out and "Number of val videos: 1" in out,
                    "train: the split is not three videos and one")
            require("Optimal epoch: " in out, "train printed no optimal epoch")
            require(plots.curves == list(range(2, TRAIN_EPOCHS + 2)), f"train drew the curves {plots.curves}")
            out = verb("train --checkpoint", ["train", *args, "--checkpoint", "--epochs", str(TRAIN_EPOCHS + 1)])
            require(f"Resumed from epoch {TRAIN_EPOCHS}" in out, "train --checkpoint did not resume at the epoch")
            events = [json.loads(ln) for ln in open(os.path.join(work, "tmp", "events.jsonl"))]
            require([e["epoch"] for e in events if e["event"] == "epoch"]
                    == list(range(-1, TRAIN_EPOCHS)) + [-1, TRAIN_EPOCHS], "events.jsonl epochs")
            out = verb("eval", ["eval", *args])
            require(evals.calls == n_videos and out.count("[eval]") == 2, "eval: not one evaluation a video")
            out = verb("baseline", ["baseline", *args, "--samples", "2"])
            require(evals.calls == 2 * n_videos and "mean_train_loss" in out, "baseline: not two samples")
            print(f"phase 10: curves drawn {plots.curves}, summary masks exported {json.dumps(plots.indices)}",
                  flush=True)

            # the loop's recovery paths on the datasets the verbs built, card only
            train_ds, val_ds = dataset_io.build_datasets(data["videos"], cfg, data["annotation_fp"], data["mat_fp"],
                                                         data["h5_fp"], data["info_fp"])
            rollback = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, nan_guard="rollback"))
            good, bad = train_ds[0], train_ds[1]
            labels = bad.labels.copy()
            labels[len(labels) // 2] = np.nan
            poisoned = dataclasses.replace(bad, video_id="poisoned", labels=labels)
            state0 = create_train_state(seed, cfg)
            deterministic = torch.backends.cudnn.deterministic
            torch.backends.cudnn.deterministic = True   # bit-equal runs: deterministic cuDNN backward algorithms
            try:
                dirs = {k: os.path.join(root, k) for k in ("rollback", "clean")}
                t0 = time.perf_counter()
                _, hist = drive("train_importance_model rollback + async", kernels[1:], lambda: train_loop.train_importance_model(
                    rollback, dataset_io.VideoDataset([good, poisoned]), val_ds, state0, num_epochs=1,
                    checkpoint_dir=dirs["rollback"], verbose=False, async_checkpoint=True), launches_by_path)
                walls["train_importance_model rollback + async"] = time.perf_counter() - t0
                _, clean = train_loop.train_importance_model(rollback, dataset_io.VideoDataset([good]), val_ds, state0,
                                                             num_epochs=1, checkpoint_dir=dirs["clean"],
                                                             verbose=False)
            finally:
                torch.backends.cudnn.deterministic = deterministic
            require(hist.get("nan_rollbacks") == 1 and "nan_rollbacks" not in clean, f"rollbacks {hist.get('nan_rollbacks')}")
            a, b = (load_checkpoint(dirs[k], create_train_state(seed + 1, cfg), tag="ckp") for k in ("rollback", "clean"))
            require(a.epoch == b.epoch == 1 and a.opt_state.step == b.opt_state.step, "rollback: other steps or epochs")
            diffs = [(x - y).abs().max().item() for x, y in zip(
                tree_leaves((a.params, a.model_state, a.opt_state.mu, a.opt_state.nu)),
                tree_leaves((b.params, b.model_state, b.opt_state.mu, b.opt_state.nu)))]
            require(max(diffs) == 0.0, f"rollback: the NaN video's updates were not discarded exactly "
                                       f"(max |diff| {max(diffs)})")
            print(f"phase 10: nan_guard rollback with async checkpoints: 1 video rolled back, the rolling "
                  f"checkpoint bit-equal to a run without it ({a.opt_state.step} Adam steps)", flush=True)
        finally:
            dataset_io.AnnotationStore = store
            viz.generate_metric_plots, viz.export_indices, train_loop.eval_video = saved

        # card against CPU
        record = train_against_cpu(cfg, train_ds, val_ds, seed)
        print(f"phase 10: card vs CPU on {smi}: {json.dumps(record)}", flush=True)

        # numbers: one video's steps, one epoch split, one traced epoch, the resident state
        S = cfg.train.subbatch_size
        state = create_train_state(seed, cfg)
        fn = train_loop.make_train_video_fn(cfg)
        gen = torch.Generator(device=state0.params["fusion"][0]["w"].device).manual_seed(seed)
        v, a_, lab, valid, _ = train_loop._pad_video(train_ds[0], S, gen.device)
        params, ms, opt, step_ms = state.params, state.model_state, state.opt_state, []
        for i in range(len(v) // S):
            sl = slice(i * S, (i + 1) * S)
            t0 = time.perf_counter()
            params, ms, opt, _, loss = fn(params, ms, opt, v[sl], a_[sl], lab[sl], valid[sl], gen)
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t0))
        n_steps = sum(-(-len(it.visual) // S) for it in train_ds)
        with EpochClock() as clock, tempfile.TemporaryDirectory() as ckdir:
            train_loop.train_importance_model(cfg, train_ds, val_ds, create_train_state(seed, cfg), num_epochs=1,
                                              checkpoint_dir=ckdir, on_epoch_end=clock.epoch_end, verbose=False)
        split = clock.split()[0]
        fresh = create_train_state(seed, cfg)   # made outside the traced runs: its 94 MB cross as pageable HtoD
        prof = profile_run(lambda: train_loop.train_importance_model(cfg, train_ds, val_ds, fresh, num_epochs=1,
                                                                     verbose=False))
        numbers = {
            "step_ms": step_ms, "step_ms_median": statistics.median(step_ms[1:] or step_ms),   # the first warms the allocator
            "epoch_split_s": split, "steps_per_epoch": n_steps, "steps_per_s": n_steps / split["train_s"],
            "resident_state_bytes": state_bytes(state), "verb_walls_s": walls,
        }
        print(f"phase 10: training numbers on {smi}: {json.dumps(numbers)}", flush=True)
        print(f"phase 10: profile of one traced epoch (train + val eval, no checkpoint) on {smi}: {json.dumps(prof)}",
              flush=True)


# ---------------------------------------------------------------- phase 11: serving

SERVE_REQUESTS = 16                               # batcher requests of 30-300 condensed 180×320 frames
SERVE_THREADS = 8                                 # client threads, in the batcher and over HTTP
HTTP_VIDEO_FRAMES = (1_800, 2_700, 3_600, 4_500)  # raw 72×96 frames of the HTTP videos: 60-150 condensed
HTTP_SPOT_FRAMES = 9_000                          # raw frames of the /spot video: 300 condensed
HTTP_REQUESTS = 16                                # /summarize requests per server
SPOT_WINDOW = 64                                  # --attn-window of the --no-audio banded spotter and the CLI verbs


def write_video(path: str, n: int, hw, seed: int, cfg: PipelineConfig | None = None) -> np.ndarray:
    """``n`` raw frames saved as ``.npz``, with a ``.wav`` sidecar when ``cfg`` is given → the raw frames.  The
    frames repeat one seeded block of 500 (the generator takes about 10 ms a 180×320 frame); 500 is no multiple
    of ``skip_frames``, so the condensed frames seldom repeat."""
    raw = np.resize(synthetic_video_frames(min(n, 500), *hw, seed=seed), (n, *hw, 3))
    np.savez(path, frames=raw)
    if cfg is not None:
        write_wav(path[:-4] + ".wav", synthetic_waveform(int(n / 30 * cfg.audio.sample_rate), cfg.audio.sample_rate,
                                                         seed=seed), cfg.audio.sample_rate)
    return raw


def write_events(path: str, n_condensed: int, skip: int, seed: int) -> None:
    """A seeded ``.events.json`` sidecar: about one event per 20 condensed frames, in raw frame indices."""
    rng = np.random.default_rng(seed)
    picked = np.sort(rng.choice(n_condensed, max(2, n_condensed // 20), replace=False))
    with open(path[:-4] + ".events.json", "w") as f:
        json.dump([int(i * skip + rng.integers(0, skip)) for i in picked], f)


def same_summary(got_scores, got_clips, want_scores, want_clips, tol: float, what: str) -> list[dict]:
    """Scores within ``tol``; clips equal, or else every frame whose rounded score differs lies within ``tol`` of
    a .5 boundary (a flip, reported)."""
    got_scores, want_scores = np.asarray(got_scores), np.asarray(want_scores)
    require(got_scores.shape == want_scores.shape, f"{what}: scores {got_scores.shape} vs {want_scores.shape}")
    err = float(np.abs(got_scores - want_scores).max()) if len(got_scores) else 0.0
    require(err <= tol, f"{what}: scores max |err| {err} > {tol}")
    flips = rounding_flips(want_scores, got_scores, tol)
    require(np.array_equal(np.asarray(got_clips), np.asarray(want_clips)) or flips,
            f"{what}: clips differ with no score at a rounding boundary")
    return flips


def percentiles(walls: list[float]) -> dict:
    w = sorted(walls)
    return {"p50_ms": 1e3 * w[len(w) // 2], "p95_ms": 1e3 * w[min(len(w) - 1, int(len(w) * 0.95))],
            "max_ms": 1e3 * w[-1], "n": len(w)}


def http(port: int, path: str, body: dict | None = None) -> tuple[int, dict]:
    import urllib.error
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", method="GET" if body is None else "POST",
                                 data=None if body is None else json.dumps(body).encode())
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, json.load(r)
    except urllib.error.HTTPError as e:
        return e.code, json.load(e)


def http_stream(port: int, body: dict) -> tuple[list[dict], float]:
    """A /spot-stream response's lines and the seconds to its first line."""
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}/spot-stream", data=json.dumps(body).encode(),
                                 method="POST")
    t0, first, lines = time.perf_counter(), None, []
    with urllib.request.urlopen(req, timeout=600) as r:
        for line in r:
            if first is None:
                first = time.perf_counter() - t0
            if line.strip():
                lines.append(json.loads(line))
    return lines, first


def verb_payload(text: str) -> dict:
    """The indented JSON payload a verb prints (the lines around it are left)."""
    return json.JSONDecoder().raw_decode(text[text.index("{\n"):])[0]


class PortWatch:
    """A stdout that keeps what is written and finds the port in the ``serve`` verb's "serving on" line."""

    def __init__(self, echo):
        self.echo, self.text, self.port = echo, "", None
        self.ready = threading.Event()

    def write(self, text):
        self.echo.write(text)
        self.text += text
        m = re.search(r"serving on http://127\.0\.0\.1:(\d+)", self.text)
        if m and not self.ready.is_set():
            self.port = int(m.group(1))
            self.ready.set()
        return len(text)

    def flush(self):
        self.echo.flush()

    def isatty(self):
        return False


def trace_busy_share(path: str) -> dict:
    """From a Chrome trace of ``torch.profiler``: the card's busy time (the union of its kernels, copies and sets)
    over the trace's span, and the stage regions' walls."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    device = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                    if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    busy, cur = 0.0, None
    for a, b in device:
        if cur is None or a > cur[1]:
            busy += (cur[1] - cur[0]) if cur else 0.0
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    busy += (cur[1] - cur[0]) if cur else 0.0
    span = max(e["ts"] + e["dur"] for e in events) - min(e["ts"] for e in events)
    stages = {}
    for e in events:
        if e.get("cat") == "user_annotation" and e["name"] in ("decode", "audio_load", "features", "score",
                                                               "postprocess"):
            stages[e["name"]] = stages.get(e["name"], 0.0) + e["dur"] / 1e3
    return {"device_busy_ms": busy / 1e3, "span_ms": span / 1e3, "busy_share": busy / span if span else None,
            "device_events": len(device), "stage_region_ms": stages}


def summarizer_check(s, video: str, raw: np.ndarray, cfg: PipelineConfig, launches_by_path: dict) -> dict:
    """11a: ``Summarizer.summarize_path`` against ``extract_features`` → ``fuse`` → ``summarize(native-full)``."""
    from cvml_goalnet_tpu_torch.data.audio_io import load_waveform

    skip = cfg.preprocess.skip_frames
    got = drive("serve_summarizer", ["fused_preprocess_frames", *TRUNK, "fused_fusion_mlp"],
                lambda: s.summarize_path(video), launches_by_path)
    frames = raw[::skip]
    waveform, _ = load_waveform(video[:-4] + ".wav", cfg.audio.sample_rate)
    feats = extract_features(frames, waveform, cfg)
    scores = fuse(s.state.params, s.state.model_state, feats, cfg)
    want = summarize(scores, uniform_clip_intervals(cfg, len(raw)), skip, len(raw), cfg.knapsack,
                     knapsack_engine="native-full")
    flips = same_summary(got.scores, got.clips, scores, want.clip_intervals, 1e-4, "11a summarize_path")
    require(got.frame_mask.shape == (len(raw),) and (flips or np.array_equal(got.frame_mask, want.frame_mask)),
            "11a: the mask differs")
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        s.summarize_path(video)
        walls.append(time.perf_counter() - t0)
    return {"max_abs_err": float(np.abs(got.scores - scores).max()), "rounding_flips": flips,
            "summarize_path": percentiles(walls), "clips": len(got.clips)}


def batcher_check(s, match: dict, cfg: PipelineConfig, seed: int, launches_by_path: dict) -> dict:
    """11b: ``SERVE_REQUESTS`` requests from ``SERVE_THREADS`` threads through a warmed ``DynamicBatcher``, each
    against ``summarize_frames`` of the same request; then a 0-frame and a grayscale rider."""
    from concurrent.futures import ThreadPoolExecutor

    from cvml_goalnet_tpu_torch.serve import DynamicBatcher

    rng = np.random.default_rng(seed + 500)
    per = match["per_frame"]
    reqs = []
    for _ in range(SERVE_REQUESTS):
        n = int(rng.integers(30, 301))
        a = int(rng.integers(0, MATCH_FRAMES - n))
        reqs.append((match["frames"][a:a + n], match["waveform"][a * per:(a + n) * per]))
    batcher = DynamicBatcher(s)
    out = {"buckets": list(batcher.buckets), "max_wait_ms": batcher.max_wait_ms}
    try:
        t0 = time.perf_counter()
        batcher.warmup()
        out["warmup_s"] = time.perf_counter() - t0
        fuse_s = []
        real_chunked = batcher._scores_chunked

        def timed_chunked(visual, audio, text=None):
            t = time.perf_counter()
            r = real_chunked(visual, audio, text)
            fuse_s.append(time.perf_counter() - t)
            return r

        batcher._scores_chunked = timed_chunked
        submit_s = [0.0] * len(reqs)

        def one(i):
            t = time.perf_counter()
            fut = batcher.submit(f"r{i}", reqs[i][0], waveform=reqs[i][1])
            submit_s[i] = time.perf_counter() - t
            return fut.result()

        def run():
            with ThreadPoolExecutor(SERVE_THREADS) as pool:
                return list(pool.map(one, range(len(reqs))))

        t0 = time.perf_counter()
        got = drive("serve_batcher", TRUNK + ("fused_fusion_mlp",), run, launches_by_path)
        wall = time.perf_counter() - t0
        require(launches_by_path["serve_batcher"]["fused_preprocess_frames"] == 0,
                "11b: kernel 1 launched in the batcher (it preprocesses on the host)")
        frames = sum(len(r[0]) for r in reqs)
        st = dict(batcher.stats)
        require(st["requests"] == len(reqs) and st["batches"] < st["requests"] and st["batched_frames"] == frames,
                f"11b: batcher stats {st}")
        errs, flips = [], []
        for i, (g, (fr, wave)) in enumerate(zip(got, reqs)):
            want = s.summarize_frames(f"r{i}", fr, waveform=wave)
            errs.append(float(np.abs(g.scores - want.scores).max()))
            flips += same_summary(g.scores, g.clips, want.scores, want.clips, 1e-4, f"11b request {i}")
        out.update({"requests": len(reqs), "frames": frames, "wall_s": wall, "frames_per_s": frames / wall,
                    "stats": st, "max_abs_err": max(errs), "rounding_flips": flips,
                    "submit_s_sum": sum(submit_s), "submit_s_max": max(submit_s),
                    "batched_fuse_s_sum": sum(fuse_s), "batched_fuse_calls": len(fuse_s)})
        empty = batcher.submit("empty", match["frames"][:0], waveform=match["waveform"][:per]).result()
        require(empty.scores.shape == (0,) and empty.frame_mask.shape == (0,), "11b: the 0-frame rider")
        gray = batcher.submit("gray", match["frames"][:20, :, :, :1])
        try:
            gray.result()
        except Exception as e:   # the worker's error, carried by the rider's future
            out["grayscale_rider"] = repr(e)[:160]
        require("grayscale_rider" in out, "11b: a grayscale rider was answered")
        nxt = batcher.submit("next", reqs[0][0], waveform=reqs[0][1]).result()
        require(np.array_equal(nxt.scores, got[0].scores) or float(np.abs(nxt.scores - got[0].scores).max()) <= 1e-4,
                "11b: the request after the bad riders")
    finally:
        batcher.close()
    return out


def spotter_check(seed: int, match: dict, launches_by_path: dict) -> dict:
    """11c: ``Spotter.spot_frames`` on the banded config against the path run directly; the hybrid once."""
    from cvml_goalnet_tpu_torch.serve import Spotter

    banded = PipelineConfig.load(str(REPO / "configs" / "tpu_spotting.json"))
    hybrid = PipelineConfig.load(str(REPO / "configs" / "tpu_spotting_quality.json"))
    sp = Spotter(banded, state=create_train_state(seed, banded))
    t0 = time.perf_counter()
    sp.warmup()
    out = {"warmup_s": time.perf_counter() - t0}
    full_n = match["full_n"]
    walls = []
    t0 = time.perf_counter()
    got = drive("serve_spotter", ["fused_preprocess_frames", *TRUNK, "flash_local_fwd"],
                lambda: sp.spot_frames("match", match["frames"], full_n, match["waveform"]), launches_by_path)
    walls.append(time.perf_counter() - t0)
    for _ in range(2):
        t0 = time.perf_counter()
        sp.spot_frames("match", match["frames"], full_n, match["waveform"])
        walls.append(time.perf_counter() - t0)
    feats = extract_features(match["frames"], match["waveform"], banded)
    enc = encode_timeline(sp.state.params, sp.state.model_state, feats["visual"], feats["audio"], banded)
    scores = score_timeline_auto(sp.temporal_params, enc, banded).cpu().numpy()
    tol = score_tolerance(scores)
    err = float(np.abs(got.scores - scores).max())
    require(err <= tol, f"11c: spot_frames scores max |err| {err} > {tol}")
    near = compare_events(got.scores, scores, tol)   # raises unless every differing event is a near tie
    want = summarize(scores_to_importance(scores), uniform_clip_intervals(banded, full_n), banded.preprocess.skip_frames,
                     full_n, banded.knapsack, knapsack_engine="native-full")
    out.update({"max_abs_err": err, "tolerance": tol, "near_tie_events": near, "events": len(got.events),
                "summary_clips_equal": bool(np.array_equal(got.summary_clips, want.clip_intervals)),
                "spot_frames": percentiles(walls)})
    hy = Spotter(hybrid, state=sp.state)
    res = drive("serve_spotter_hybrid", [*TRUNK, "flash_local_fwd"],
                lambda: hy.spot_frames("match", match["frames"], full_n, match["waveform"]), launches_by_path)
    require(res.scores.shape == (MATCH_FRAMES,) and bool(np.isfinite(res.scores).all()), "11c: hybrid scores")
    out["hybrid_events"] = len(res.events)
    return out


def http_check(cfg: PipelineConfig, seed: int, root: str, launches_by_path: dict) -> dict:
    """11d: two servers on 127.0.0.1:0 over one Summarizer (one with the batcher) and a --no-audio banded spotter:
    /summarize under load, /spot, /spot-stream, /reload mid-load, /metrics, 403 and 404."""
    from concurrent.futures import ThreadPoolExecutor

    from cvml_goalnet_tpu_torch.serve import DynamicBatcher, Spotter, Summarizer, start_http_background

    media = os.path.join(root, "media")
    os.makedirs(media)
    videos = []
    for i, n in enumerate(HTTP_VIDEO_FRAMES):
        path = os.path.join(media, f"h{i}.npz")
        write_video(path, n, TRAIN_RAW_HW, seed + 600 + 10 * i, cfg)
        videos.append(path)
    spot_video = os.path.join(media, "match.npz")
    write_video(spot_video, HTTP_SPOT_FRAMES, TRAIN_RAW_HW, seed + 700)
    np.savez(os.path.join(root, "outside.npz"), frames=np.zeros((30, 8, 8, 3), np.uint8))
    ckp = cli._artifact_paths(os.path.join(root, "work"), True)["ckp_dir"]
    save_checkpoint(ckp, create_train_state(seed, cfg, device="cpu"), cfg, tag="opt")
    spot_cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, audio_included=False, temporal_model="transformer", temporal_window=SPOT_WINDOW))

    s = Summarizer(cfg, checkpoint_dir=ckp)
    sp = Spotter(spot_cfg, state=create_train_state(seed, spot_cfg))
    batcher = DynamicBatcher(s)
    t0 = time.perf_counter()
    s.warmup()
    batcher.warmup()
    sp.warmup()
    out = {"warmup_s": time.perf_counter() - t0}
    refs = {v: s.summarize_path(v) for v in videos}
    spot_ref = sp.spot_path(spot_video)
    plain = start_http_background(s, port=0, media_root=media, spotter=sp)
    batched = start_http_background(s, port=0, media_root=media, batcher=batcher)
    sent = {"plain": {"/summarize": 0, "/spot": 0, "/spot-stream": 0, "/reload": 0}, "batched": {"/summarize": 0}}
    try:
        def load(name, port, n=HTTP_REQUESTS):
            def one(i):
                v = videos[i % len(videos)]
                t = time.perf_counter()
                code, payload = http(port, "/summarize", {"video": os.path.basename(v)})
                return v, code, payload, time.perf_counter() - t

            t = time.perf_counter()
            with ThreadPoolExecutor(SERVE_THREADS) as pool:
                res = list(pool.map(one, range(n)))
            wall = time.perf_counter() - t
            sent[name]["/summarize"] += n
            return res, wall

        def phase():
            results = {}
            for name, server in (("plain", plain), ("batched", batched)):
                res, wall = load(name, server.server_address[1])
                flips = []
                for v, code, payload, _ in res:
                    require(code == 200, f"11d {name}: /summarize answered {code}: {payload}")
                    ref = refs[v]
                    require(payload["mask_frames"] == int(ref.frame_mask.sum()) or name == "batched",
                            f"11d {name}: mask frames differ")
                    # the wire rounds to 4 decimals: 1e-4 of host preprocess (batched) plus one unit of it
                    flips += same_summary(payload["scores"], payload["clips"], ref.scores, ref.clips.tolist(),
                                          2e-4 if name == "batched" else 5e-5 + 1e-6, f"11d {name}")
                results[name] = {**percentiles([r[3] for r in res]), "requests_per_s": len(res) / wall,
                                 "wall_s": wall, "rounding_flips": flips}
            port = plain.server_address[1]
            code, payload = http(port, "/spot", {"video": "match.npz"})
            sent["plain"]["/spot"] += 1
            require(code == 200 and payload["events_condensed_frames"] == spot_ref.events.tolist()
                    and payload["summary_clips"] == spot_ref.summary_clips.tolist(), f"11d /spot: {code}")
            lines, first = http_stream(port, {"video": "match.npz", "emit_scores": True})
            sent["plain"]["/spot-stream"] += 1
            streamed = np.concatenate([line["scores"] for line in lines if "scores" in line])
            tol = score_tolerance(spot_ref.scores) + 1e-6
            err = float(np.abs(streamed - spot_ref.scores).max())
            require(lines[-1]["streamed_frames"] == len(spot_ref.scores) and err <= tol,
                    f"11d /spot-stream: scores max |err| {err} > {tol}")
            near = compare_events(streamed, spot_ref.scores, tol)
            results["spot_stream"] = {"time_to_first_line_s": first, "lines": len(lines), "max_abs_err": err,
                                      "near_tie_events": near}
            return results

        out.update(drive("serve_http", ["fused_preprocess_frames", *TRUNK, "fused_fusion_mlp", "flash_local_fwd"],
                         phase, launches_by_path))

        # /reload in the middle of a load, after the trunk's npz is rewritten with other weights
        port = plain.server_address[1]
        save_checkpoint(ckp, create_train_state(seed + 1, cfg, device="cpu"), cfg, tag="opt")
        with ThreadPoolExecutor(1) as pool:
            during = pool.submit(load, "plain", port, 2 * SERVE_THREADS)
            time.sleep(0.2)
            code, payload = http(port, "/reload", {})
            sent["plain"]["/reload"] += 1
            res, _ = during.result()
        require(code == 200 and payload["reloaded"] == {"summarizer": 1} and "spotter" in payload["skipped"],
                f"11d /reload: {code} {payload}")
        require(all(c == 200 for _, c, _, _ in res), "11d: a request failed during the reload")
        new = Summarizer(cfg, checkpoint_dir=ckp).summarize_path(videos[0])
        code, after = http(port, "/summarize", {"video": os.path.basename(videos[0])})
        sent["plain"]["/summarize"] += 1
        same_summary(after["scores"], after["clips"], new.scores, new.clips.tolist(), 5e-5 + 1e-6, "11d after reload")
        require(s.reload_count == 1, f"11d: reload count {s.reload_count}")
        outside = http(port, "/summarize", {"video": "../outside.npz"})[0]
        missing = http(port, "/summarize", {"video": "missing.npz"})[0]
        sent["plain"]["/summarize"] += 2
        require((outside, missing) == (403, 404), f"11d: {outside} and {missing} for 403 and 404")
        for name, server in (("plain", plain), ("batched", batched)):
            m = http(server.server_address[1], "/metrics")[1]["endpoints"]
            got = {ep: m.get(ep, {}).get("requests", 0) for ep in sent[name]}
            require(got == sent[name], f"11d {name}: /metrics counts {got} != sent {sent[name]}")
            if name == "plain":
                require(m["/summarize"]["errors"] == 2, f"11d: /metrics errors {m['/summarize']}")
                out["metrics_plain"] = m
        out["reload"] = {"requests_during": len(res), "count": s.reload_count}
        out["batcher_stats"] = dict(batcher.stats)
    finally:
        for server in (plain, batched):
            server.shutdown()
            server.server_close()
        batcher.close()
    return out


def spot_train_heads_check(cfg: PipelineConfig, videos: list[str], target: str, common: list[str], work: str,
                           root: str, seed: int, launches_by_path: dict) -> dict:
    """11e: ``spot-train --epochs 1`` of a GRU and of a hybrid head on the first two videos (the third for
    validation), on the card and then on the CPU (``GOALNET_PLATFORM=cpu``, the same verb): every step's loss
    within 1e-4 relative, and the two saved heads scoring ``target``'s trunk features on the card within
    1e-4·max(1, max|s|); the walls."""
    from cvml_goalnet_tpu_torch.data.dataset import build_video_item
    from cvml_goalnet_tpu_torch.serve import trunk_feature_dim
    from cvml_goalnet_tpu_torch.train import spotting as train_spotting

    state = load_checkpoint(cli._artifact_paths(work, False)["ckp_dir"], create_train_state(seed, cfg), tag="opt")
    item = build_video_item(target, cfg, None, None, False)
    enc = encode_timeline(state.params, state.model_state, item.visual, None, cfg)
    out = {}
    for family, flags, kernels in (
            ("gru", ["--temporal-model", "gru"], []),
            ("hybrid", ["--temporal-model", "hybrid", "--attn-window", str(SPOT_WINDOW)],
             ["flash_local_fwd", "flash_local_bwd"])):
        fcfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, temporal_model=family, temporal_window=SPOT_WINDOW if family == "hybrid" else 0))
        losses, scores, walls = {}, {}, {}
        for where in ("card", "cpu"):
            head = os.path.join(root, f"head_{family}_{where}.npz")
            argv = ["spot-train", "--videos", *videos[:2], "--val-videos", videos[2], *common, *flags,
                    "--epochs", "1", "--out", head]
            kept = []
            real_make = train_spotting.make_spotting_train_step

            def recording(*a, **kw):
                step = real_make(*a, **kw)

                def run(*args):
                    res = step(*args)
                    kept.append(float(res[2]))
                    return res

                return run

            train_spotting.make_spotting_train_step = recording
            buf = io.StringIO()
            t0 = time.perf_counter()
            try:
                with contextlib.redirect_stdout(buf):
                    if where == "card":
                        rc = drive(f"cli_spot_train_{family}", ["fused_preprocess_frames", *TRUNK, *kernels],
                                   lambda: cli.main(argv), launches_by_path)
                    else:
                        os.environ["GOALNET_PLATFORM"] = "cpu"
                        rc = cli.main(argv)
            finally:
                train_spotting.make_spotting_train_step = real_make
                os.environ.pop("GOALNET_PLATFORM", None)
            walls[where] = time.perf_counter() - t0
            require(rc == 0 and os.path.exists(head) and kept,
                    f"11e: spot-train of a {family} head on the {where} exited {rc}: {buf.getvalue()[-1500:]}")
            losses[where] = kept
            tmpl = weights.init_temporal_params(fcfg.model, trunk_feature_dim(fcfg), seed=1)
            with torch.no_grad():
                scores[where] = score_timeline_auto(weights.tree_from_jax(weights.load_spotting_checkpoint(head, tmpl)),
                                                    enc, fcfg).cpu().numpy()
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses["card"], losses["cpu"]))
        require(len(losses["card"]) == len(losses["cpu"]) and rel <= 1e-4,
                f"11e: spot-train {family} losses card {losses['card']} vs CPU {losses['cpu']}")
        tol = score_tolerance(scores["cpu"])
        err = float(np.abs(scores["card"] - scores["cpu"]).max())
        require(err <= tol, f"11e: the {family} heads trained on the card and the CPU score {err} apart (> {tol})")
        launched = {k: v for k, v in launches_by_path[f"cli_spot_train_{family}"].items() if v}
        out[family] = {"losses_card": losses["card"], "loss_max_rel_err": rel, "head_scores_max_abs_err": err,
                       "walls_s": walls, "launches": launched}
    return out


def cli_check(cfg: PipelineConfig, seed: int, root: str, launches_by_path: dict) -> dict:
    """11e: the verbs ``spot-train``, ``spot``, ``spot --stream``, ``serve --max-requests 3`` and ``profile``
    in-process, ``--no-audio``, on the 72×96 videos of 11d with seeded ``.events.json`` sidecars."""
    from cvml_goalnet_tpu_torch import spotting
    from cvml_goalnet_tpu_torch.data.dataset import build_video_item
    from cvml_goalnet_tpu_torch.serve import trunk_feature_dim

    media = os.path.join(root, "media")
    videos = [os.path.join(media, f"h{i}.npz") for i in range(len(HTTP_VIDEO_FRAMES))]
    skip = cfg.preprocess.skip_frames
    for i, (v, n) in enumerate(zip(videos, HTTP_VIDEO_FRAMES)):
        write_events(v, n // skip, skip, seed + 800 + i)
    no_audio = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, audio_included=False))
    work = os.path.join(root, "cli")
    save_checkpoint(cli._artifact_paths(work, False)["ckp_dir"], create_train_state(seed, no_audio, device="cpu"),
                    no_audio, tag="opt")
    cfg_path = os.path.join(root, "cfg.json")
    cfg.save(cfg_path)
    head = os.path.join(root, "head.npz")
    common = ["--config", cfg_path, "--workdir", work, "--no-audio"]
    temporal = ["--temporal-model", "transformer", "--attn-window", str(SPOT_WINDOW)]
    band_cfg = dataclasses.replace(no_audio, model=dataclasses.replace(
        no_audio.model, temporal_model="transformer", temporal_window=SPOT_WINDOW))
    out, walls = {}, {}

    def verb(label, expect, argv, stdout=None):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(stdout or Tee(buf, sys.stdout)):
            rc = drive(label, expect, lambda: cli.main(argv), launches_by_path)
        walls[label] = time.perf_counter() - t0
        require(rc == 0, f"{label}: exit code {rc}")
        return buf.getvalue()

    text = verb("cli_spot_train", ["fused_preprocess_frames", *TRUNK, "flash_local_fwd", "flash_local_bwd"],
                ["spot-train", "--videos", *videos[:2], "--val-videos", videos[2], *common, *temporal,
                 "--epochs", "3", "--early-stop", "2", "--out", head])
    epochs = re.findall(r"^epoch (\d+): loss ([-\d.]+) val-loss ([-\d.]+) val-mAP ([-\d.]+)$", text, re.M)
    require(len(epochs) >= 1 and os.path.exists(head), "11e: spot-train printed no epochs or saved no head")
    out["spot_train_epochs"] = [[float(x) for x in e] for e in epochs]

    target = videos[3]
    out["spot_train_heads"] = spot_train_heads_check(no_audio, videos, target, common, work, root, seed,
                                                     launches_by_path)
    text = verb("cli_spot", ["fused_preprocess_frames", *TRUNK, "flash_local_fwd"],
                ["spot", target, *common, *temporal, "--temporal-checkpoint", head])
    payload = verb_payload(text)
    state = load_checkpoint(cli._artifact_paths(work, False)["ckp_dir"], create_train_state(seed, no_audio), tag="opt")
    tparams = weights.tree_from_jax(weights.load_spotting_checkpoint(
        head, weights.init_temporal_params(band_cfg.model, trunk_feature_dim(band_cfg), seed=1)))
    item = build_video_item(target, band_cfg, None, None, False)
    direct = summarize_match(state.params, state.model_state, tparams, item.visual, None, item.clip_intervals,
                             band_cfg, full_n_frames=item.full_n_frames)
    require(payload["events_condensed_frames"] == direct.events.tolist(), "11e: spot's events differ from the path's")
    out["spot_events"] = len(direct.events)

    kept = []
    real_stream = spotting.spot_stream

    def keep(*a, **kw):
        for u in real_stream(*a, **kw):
            kept.append(np.asarray(u.scores))
            yield u

    spotting.spot_stream = keep
    try:
        text = verb("cli_spot_stream", [*TRUNK, "flash_local_fwd"],
                    ["spot", target, *common, *temporal, "--temporal-checkpoint", head, "--stream",
                     "--stream-chunk", "64"])
    finally:
        spotting.spot_stream = real_stream
    summary = verb_payload(text)
    streamed = np.concatenate(kept)
    tol = score_tolerance(direct.scores)
    require(float(np.abs(streamed - direct.scores).max()) <= tol, "11e: streamed scores differ from offline")
    near = compare_events(streamed, direct.scores, tol)
    require(near or summary["events_condensed_frames"] == payload["events_condensed_frames"],
            "11e: --stream's events differ from offline")
    out["spot_stream_near_ties"] = near

    watch = PortWatch(sys.stdout)
    answers = {}

    def client():
        if not watch.ready.wait(600):
            return
        answers["healthz"] = http(watch.port, "/healthz")
        answers["summarize"] = http(watch.port, "/summarize", {"video": os.path.basename(target)})
        answers["spot"] = http(watch.port, "/spot", {"video": os.path.basename(target)})

    c = threading.Thread(target=client)
    c.start()
    try:
        verb("cli_serve", [*TRUNK, "fused_fusion_mlp", "flash_local_fwd"],
             ["serve", *common, *temporal, "--port", "0", "--media-root", media, "--batch", "--spot",
              "--temporal-checkpoint", head, "--warmup", "--max-requests", "3"], stdout=watch)
    finally:
        watch.ready.set()
        c.join()
    require(answers.get("healthz", (0,))[0] == 200 and answers.get("summarize", (0,))[0] == 200
            and answers.get("spot", (0,))[0] == 200, f"11e: serve answered {({k: v[0] for k, v in answers.items()})}")
    require(answers["spot"][1]["events_condensed_frames"] == direct.events.tolist(), "11e: serve's /spot events")

    tdir = os.path.join(root, "trace")
    text = verb("cli_profile", ["fused_preprocess_frames", *TRUNK, "fused_fusion_mlp"],
                ["profile", target, *common, "--repeats", "3", "--trace-dir", tdir])
    prof = verb_payload(text)
    require(set(prof["stages_mean_s"]) == {"decode", "features", "score", "postprocess"}
            and prof["backend"] == "cuda" and os.path.exists(prof["trace_file"]), f"11e: profile {prof}")
    out["profile"] = {k: prof[k] for k in ("stages_mean_s", "first_pass_s", "total_mean_s", "condensed_fps")}
    out["profile_trace"] = trace_busy_share(prof["trace_file"])
    out["walls_s"] = walls
    return out


def serving_phase(seed: int, smi: str, launches_by_path: dict) -> None:
    """Phase 11: serving on the card — ``Summarizer``, ``DynamicBatcher``, ``Spotter``, the HTTP server and the
    verbs ``spot-train``, ``spot``, ``serve`` and ``profile`` — each against the path it wraps."""
    from cvml_goalnet_tpu_torch.serve import Summarizer

    os.environ.pop("GOALNET_PLATFORM", None)   # the CLI runs on the card, as a user's call would
    t_phase = time.perf_counter()
    cfg = PipelineConfig.load(str(REPO / "configs" / "reference_parity.json"))
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        video = os.path.join(root, "video.npz")
        raw = write_video(video, sum(INFER_SEGMENTS), RAW_HW, seed + 300, cfg)
        ckp = cli._artifact_paths(os.path.join(root, "work"), True)["ckp_dir"]
        save_checkpoint(ckp, create_train_state(seed, cfg, device="cpu"), cfg, tag="opt")
        print(f"phase 11: a video of phase 9's shape ({len(raw)} raw frames of {RAW_HW}) with its wav, and a trunk, "
              f"written in {time.perf_counter() - t0:.1f} s", flush=True)
        s = Summarizer(cfg, checkpoint_dir=ckp)
        t0 = time.perf_counter()
        s.warmup()
        warm = time.perf_counter() - t0
        res = summarizer_check(s, video, raw, cfg, launches_by_path)
        print(f"phase 11a: Summarizer on {smi}: warmup {warm:.2f} s; {json.dumps(res)}", flush=True)
        del raw
        t0 = time.perf_counter()
        match = make_match(PipelineConfig.load(str(REPO / "configs" / "tpu_spotting.json")), seed)
        print(f"phase 11: phase 5's match in {time.perf_counter() - t0:.1f} s", flush=True)
        print(f"phase 11b: DynamicBatcher on {smi}: {json.dumps(batcher_check(s, match, cfg, seed, launches_by_path))}",
              flush=True)
        print(f"phase 11c: Spotter on {smi}: {json.dumps(spotter_check(seed, match, launches_by_path))}", flush=True)
        del match
        _matches.clear()
        t0 = time.perf_counter()
        res = http_check(cfg, seed, root, launches_by_path)
        print(f"phase 11d: HTTP on {smi} (raw frames {TRAIN_RAW_HW}; made and served in "
              f"{time.perf_counter() - t0:.1f} s): {json.dumps(res)}", flush=True)
        print(f"phase 11e: CLI verbs on {smi}: {json.dumps(cli_check(cfg, seed, root, launches_by_path))}", flush=True)
    print(f"phase 11: {time.perf_counter() - t_phase:.1f} s wall", flush=True)


# ---------------------------------------------------------------- phase 12: bf16 and int8 inference

PEAK_BF16_FLOP_PER_S = 989e12    # H100 SXM tensor cores, dense (NVIDIA data sheet), at 700 W
PEAK_INT8_OP_PER_S = 1_979e12
PRESET_MODES = {"bf16": ("bfloat16", False), "int8": ("float32", True), "bf16_int8": ("bfloat16", True)}
LOWP_TRAIN_FRAMES = 30           # three sub-batches of 10: three bf16 Adam steps
LOWP_BATCH_REQUEST = 100         # condensed frames of the batcher's request (bucket 256)


def preset_cfg(mode: str = "bf16_int8") -> PipelineConfig:
    """``configs/tpu_serving.json`` (``reference_parity.json``'s widths in bf16 with int8 conv1 and conv2),
    with the dtype and quantization of ``mode``."""
    cfg = PipelineConfig.load(str(REPO / "configs" / "tpu_serving.json"))
    dtype, quant = PRESET_MODES[mode]
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, dtype=dtype, quantized_inference=quant))


def bf16_ulps_past(got: torch.Tensor, want: torch.Tensor, scale) -> float:
    """The largest |got − want| in bf16 ulps of max(|got|, |want|, scale), plus a floor of 1e-6·max|want| for
    signs that flip at ReLU's 0: the bf16 forms' tolerance is 2 (``tests/test_torch_cuda_kernels.py``)."""
    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        raise AssertionError("non-finite kernel output")
    ref = torch.maximum(torch.maximum(g.abs(), w.abs()), torch.as_tensor(scale, device=g.device).float())
    ulp = torch.exp2(torch.floor(torch.log2(ref.clamp_min(2.0 ** -126))) - 7)
    return float(((g - w).abs() - 1e-6 * w.abs().max()).clamp_min(0).div(ulp).max())


def lowp_stage_part(form: str, n: int, hh: int, cin: int, cout: int, dtype: torch.dtype, gen) -> dict:
    """A low-precision form of kernel 2 at (n, hh, hh, cin) → cout against its plain version, timed beside it
    and beside cuDNN's bf16 convolution + bias + ReLU + pool (for the int8 form no one PyTorch call computes an
    int8 convolution, so its library time is None and cuDNN's bf16 chain stands beside it)."""
    dev = torch.device("cuda")
    x = torch.randn((n, hh, hh, cin), generator=gen, device=dev).relu().to(dtype)
    w32 = torch.randn((3, 3, cin, cout), generator=gen, device=dev) * (0.05 if cin == 64 else 0.02)
    b = (torch.randn((hh, hh, cout), generator=gen, device=dev) * 0.1).to(dtype)
    if form == "bf16":
        w = w32.to(torch.bfloat16)
        run, plain = (lambda: fused_conv_pool_stage_bf16(x, w, b)), (lambda: fused_conv_pool_stage_bf16_plain(x, w, b))
    else:
        run, plain = (lambda: fused_conv_pool_stage_int8(x, w32, b)), (lambda: fused_conv_pool_stage_int8_plain(x, w32, b))
        wq, sw = pack_weights_int8(w32)
        wq_plain, sw_plain = pack_weights_int8_plain(w32)
        require(torch.equal(wq, wq_plain) and torch.equal(sw, sw_plain),
                f"pack_weights_int8 {[cin, cout]}: the packed weights or scales differ from the plain pack")
        require(torch.equal(act_scale_int8(x), act_scale_int8_plain(x)),
                f"act_scale_int8 {[n, hh, cin, str(dtype)]}: s_x differs from the plain amax pass")
    got, want = run(), plain()
    if form == "bf16":
        window = F.max_pool2d(b.float().abs().permute(2, 0, 1)[None], 3, 1)[0].permute(1, 2, 0)[None]
        err, tol = bf16_ulps_past(got, want, 2 * window), 2.0
        require(err <= tol, f"fused_conv_pool_stage_bf16 {[n, hh, cin, cout]}: {err} bf16 ulps past (> 2)")
        require(torch.equal(got, run()), f"fused_conv_pool_stage_bf16 {[n, hh, cin, cout]}: two runs on the same "
                                         "inputs differ")
        err_abs = max_err(got.float(), want.float())
    else:
        err_abs = max_err(got.float(), want.float())
        err, tol = err_abs, 1e-6 * want.float().abs().max().item()
        require(err <= tol, f"fused_conv_pool_stage_int8 {[n, hh, cin, cout, str(dtype)]}: max |err| {err} > {tol}")
    xb = x.to(torch.bfloat16).permute(0, 3, 1, 2)
    wb = w32.to(torch.bfloat16).permute(3, 2, 0, 1).contiguous()
    bb = b.to(torch.bfloat16).permute(2, 0, 1)[None]

    def cudnn_bf16():
        return F.max_pool2d(F.relu(F.conv2d(xb, wb, padding=1) + bb), 3, 1)

    macs = 1.0 * n * hh * hh * cin * cout * 9
    # each input read once (x and the bias in their dtype; w in bf16, or float32 for the int8 form, which
    # quantizes it), the output written once
    n_bytes = (x.element_size() * (n * hh * hh * cin + hh * hh * cout + n * (hh - 2) ** 2 * cout)
               + (2 if form == "bf16" else 4) * 9 * cin * cout)
    bound, kind = bound_ms(n_bytes, 2 * macs, PEAK_BF16_FLOP_PER_S if form == "bf16" else PEAK_INT8_OP_PER_S)
    ms, cudnn_ms = time_ms(run), time_ms(cudnn_bf16)
    device_ms, host_call_ms = time_ms_and_host(run, queued=True)
    part = {"shape": [n, hh, hh, cin, cout], "dtype": str(dtype).removeprefix("torch."), "main_path": True,
            "ms": ms, "device_ms": device_ms, "host_call_ms": host_call_ms, "plain_ms": time_ms(plain), "library_ms": cudnn_ms if form == "bf16" else None,
            "bound_ms": bound, "bound_by": kind, "max_abs_err": err_abs,
            ("bf16_ulps" if form == "bf16" else "tolerance"): err if form == "bf16" else tol}
    if form == "bf16":
        plan = card_bf16_stage_plan(n, hh, hh, cin, cout, dev)
        part["plan"] = {**plan._asdict(), "smem_bytes": stage_bf16_smem_bytes(plan, bf16_cin(cin)),
                        "blocks": int8_block_count(plan, n, hh, hh, cout)}
    else:
        plan = card_int8_stage_plan(n, hh, hh, cin, cout, dev)
        part["plan"] = {**plan._asdict(), "smem_bytes": int8_smem_bytes(plan, int8_cin(cin))}
        part["bf16_cudnn_ms"] = cudnn_ms
        # the passes around the conv, each timed alone on the device (queued behind a spin)
        part["pack_device_ms"] = time_ms_and_host(lambda: pack_weights_int8(w32), 20, queued=True)[0]
        part["amax_device_ms"] = time_ms_and_host(lambda: act_scale_int8(x), 20, queued=True)[0]
    extra = (f"; weight pack alone {part['pack_device_ms']:.4f} ms, amax pass alone {part['amax_device_ms']:.4f} ms"
             if form != "bf16" else "")
    print(f"fused_conv_pool_stage_{form} at {part['shape']} {part['dtype']}: {ms:.4f} ms (device alone "
          f"{device_ms:.4f}, host call {host_call_ms:.4f}; plain {part['plain_ms']:.4f}, "
          f"cuDNN bf16 {cudnn_ms:.4f}); bound {bound:.4f} ms ({kind}); plan {json.dumps(part['plan'])}; "
          f"max |err| {err_abs:.3g}{extra}", flush=True)
    del x, w32, b, got, want
    torch.cuda.empty_cache()
    return part


def lowp_head_part(m: int, k: int, n: int, gen, main_path: bool = True) -> dict:
    """3-bf16 at (m, k) @ (k, n) against its plain version (2 bf16 ulps, equal bits on a repeat), timed beside
    cuBLAS's addmm + ReLU, with its device time alone, its host call and its plan."""
    x = torch.rand((m, k), generator=gen, device="cuda").to(torch.bfloat16)
    w = (torch.randn((k, n), generator=gen, device="cuda") * 0.005).to(torch.bfloat16)
    b = (torch.randn((n,), generator=gen, device="cuda") * 0.1).to(torch.bfloat16)
    run, plain = (lambda: head_matmul_bf16(x, w, b)), (lambda: head_matmul_bf16_plain(x, w, b))
    got, want = run(), plain()
    ulps = bf16_ulps_past(got, want, 2 * b.float().abs()[None])
    require(ulps <= 2, f"head_matmul_bf16 at M = {m}: {ulps} bf16 ulps past (> 2)")
    require(torch.equal(got, run()), f"head_matmul_bf16 at M = {m}: two runs on the same inputs differ")
    bound, kind = bound_ms(2.0 * (m * k + k * n + n + m * n), 2.0 * m * k * n, PEAK_BF16_FLOP_PER_S)
    device_ms, host_call_ms = time_ms_and_host(run, queued=True)
    plan = card_head_bf16_plan(m, k, n, x.device)
    tiles = -(-m // BF16_BLOCK_M) * -(-n // BF16_BLOCK_N)
    part = {"shape": [m, k, n], "main_path": main_path, "ms": time_ms(run), "device_ms": device_ms,
            "host_call_ms": host_call_ms, "plain_ms": time_ms(plain),
            "library_ms": time_ms(lambda: torch.relu(torch.addmm(b, x, w))), "bound_ms": bound, "bound_by": kind,
            "max_abs_err": max_err(got.float(), want.float()), "bf16_ulps": ulps,
            "plan": {**plan._asdict(), "tile": [BF16_BLOCK_M, BF16_BLOCK_N, BF16_BLOCK_K], "stages": BF16_STAGES,
                     "cluster": 1, "blocks": tiles * plan.splits, "waves": tiles * plan.splits / head_bf16_slots(x.device)[0]}}
    print(f"head_matmul_bf16 at {part['shape']}{'' if main_path else ' (not on the main path)'}: {part['ms']:.4f} ms "
          f"(device alone {device_ms:.4f}, host call {host_call_ms:.4f}; plain {part['plain_ms']:.4f}, library "
          f"{part['library_ms']:.4f}); bound {bound:.4f} ms ({kind}); plan {json.dumps(part['plan'])}", flush=True)
    del x, w, b, got, want
    torch.cuda.empty_cache()
    return part


def lowp_mlp_part(m: int, layers, lo: float, hi: float, gen, main_path: bool = True) -> dict:
    """4-bf16 at (m, widths) against its plain version (0.0625: 2 bf16 ulps on [4, 5]; equal bits on a repeat),
    timed beside the bf16 addmm chain, with its device time alone, its host call and its plan."""
    dims = mlp_dims(layers)
    x = torch.rand((m, dims[0]), generator=gen, device="cuda").to(torch.bfloat16)
    run, plain = (lambda: fused_fusion_mlp_bf16(x, layers, lo, hi)), (lambda: fused_fusion_mlp_bf16_plain(x, layers, lo, hi))
    got, want = run(), plain()
    err = max_err(got.float(), want.float())
    require(err <= 0.0625, f"fused_fusion_mlp_bf16 at M = {m}: max |err| {err} > 0.0625 (2 bf16 ulps on [4, 5])")
    require(torch.equal(got, run()), f"fused_fusion_mlp_bf16 at M = {m}: two runs on the same inputs differ")

    def library():
        h = x
        for i, lp in enumerate(layers):
            h = torch.addmm(lp["b"], h, lp["w"])
            if i < len(layers) - 1:
                h = torch.relu(h)
        return (hi - lo) * torch.sigmoid(h) + lo

    macs = sum(a * b for a, b in zip(dims[:-1], dims[1:]))
    n_bytes = 2.0 * (m * (dims[0] + dims[-1]) + sum(lp["w"].numel() + lp["b"].numel() for lp in layers))
    bound, kind = bound_ms(n_bytes, 2.0 * m * macs, PEAK_BF16_FLOP_PER_S)
    device_ms, host_call_ms = time_ms_and_host(run, 100, queued=True)
    rows, c = card_bf16_mlp_plan(m, dims, x.device)
    part = {"shape": [m, *dims], "main_path": main_path, "ms": time_ms(run, 100), "device_ms": device_ms,
            "host_call_ms": host_call_ms, "plain_ms": time_ms(plain, 100),
            "library_ms": time_ms(library, 100), "bound_ms": bound, "bound_by": kind, "max_abs_err": err,
            "plan": {"rows": rows, "cluster": c, "ctas": -(-m // rows) * c,
                     "clusters_at_once": bf16_clusters_at_once(torch.cuda.current_device(), tuple(dims), rows, c),
                     "smem_bytes": mlp_bf16_smem_bytes(rows, dims)}}
    print(f"fused_fusion_mlp_bf16 at {part['shape']}{'' if main_path else ' (not on the main path)'}: {part['ms']:.4f} ms "
          f"(device alone {device_ms:.4f}, host call {host_call_ms:.4f}; plain {part['plain_ms']:.4f}, library "
          f"{part['library_ms']:.4f}); bound {bound:.4f} ms ({kind}); plan {json.dumps(part['plan'])}; max |err| "
          f"{err:.3g}", flush=True)
    return part


def lowp_mlp_plan_sweep(layers, gen) -> dict:
    """4-bf16 under every plan (rows per tile × cluster) at the batch's M and at each video's, timed on the device
    alone, beside the plan the wrapper picks; and the plan model (``ops/cuda/fused_mlp.py::bf16_plan_seconds``:
    rounds × (fixed + the busiest CTA's weight bytes · a + its wgmma · b)) fitted to them by least squares."""
    dims = mlp_dims(layers)
    dev = torch.cuda.current_device()
    at_once = {(r, c): bf16_clusters_at_once(dev, tuple(dims), r, c) for r in MLP_BF16_ROWS
               for c in range(1, MAX_CLUSTER + 1) if mlp_bf16_smem_bytes(r, dims) <= SMEM_LIMIT}
    times, chosen, rows_, terms = {}, {}, [], []
    for m in (sum(VIDEO_LENGTHS), *VIDEO_LENGTHS):
        x = torch.rand((m, dims[0]), generator=gen, device="cuda").to(torch.bfloat16)
        for (r, c), n_at_once in at_once.items():
            t = time_ms_and_host(lambda: fused_fusion_mlp_bf16_planned(x, layers, r, c), 50, queued=True)[0]
            times[f"{m}:{r}x{c}"] = t
            rounds = -(-(-(-m // r)) // n_at_once)
            weight_bytes, mma = bf16_cta_work(dims, r, c)
            rows_.append([rounds, rounds * weight_bytes, rounds * mma])
            terms.append(t * 1e-3)
        r, c = card_bf16_mlp_plan(m, dims, "cuda")
        best = min((t, k) for k, t in times.items() if k.startswith(f"{m}:"))
        chosen[m] = {"plan": f"{r}x{c}", "ms": times[f"{m}:{r}x{c}"], "best": best[1], "best_ms": best[0]}
    fit = np.linalg.lstsq(np.array(rows_, dtype=float), np.array(terms), rcond=None)[0]
    return {"chosen": chosen, "fit": {"fixed_s": fit[0], "s_per_weight_byte": fit[1], "s_per_mma": fit[2]},
            "clusters_at_once": {f"{r}x{c}": v for (r, c), v in at_once.items()}, "device_ms": times}


def sass_mma_counts(name: str) -> dict:
    """{kernel: {opcode: count}} of the HGMMA / IGMMA (wgmma) and HMMA / IMMA (mma.sync) instructions in the
    built library of csrc/<name>.cu, by ``cuobjdump -sass`` (beside nvcc)."""
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(_build.lib_path(name))], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
        elif fn and (op := re.search(r"\b(HGMMA|IGMMA|HMMA|IMMA)\.", line)):
            counts.setdefault(fn, {}).setdefault(op.group(1), 0)
            counts[fn][op.group(1)] += 1
    return counts


def wgmma_label(fn: str) -> str:
    """A readable name of a wgmma kernel's mangled one."""
    if k := re.search(r"conv_pool_wgmma_kernelINS_8(Int8FormIf|Int8FormI13__nv_bfloat16|Bf16Form)EE?Li(\d)ELi(\d+)ELi(\d+)E", fn):
        form = {"Int8FormIf": "Int8Form<float>", "Int8FormI13__nv_bfloat16": "Int8Form<bf16>",
                "Bf16Form": "Bf16Form"}[k.group(1)]
        return f"conv_pool_wgmma_kernel<{form}, {k.group(2)}, {k.group(3)}, {k.group(4)}>"
    if k := re.search(r"fused_mlp_bf16_kernelILi(\d+)E", fn):
        return f"fused_mlp_bf16_kernel<{k.group(1)}>"
    return "head_bf16_wgmma_kernel" if "head_bf16_wgmma_kernel" in fn else fn


def wgmma_forms_report(n: int, fusion_dims) -> dict:
    """The wgmma kernels of the four forms (3-bf16's head, the conv-pool template of 2-bf16 and 2-int8, 4-bf16's
    MLP): registers and spill bytes (ptxas), shared memory a block (their plans at the main paths' shapes: the
    batch's N and M), and their wgmma instructions in the SASS (each must issue some, and ptxas must have
    serialized none: no C7510-C7519 note in their builds' reports)."""
    report = {}
    for lib, key in (("matmul", "head_bf16_wgmma_kernel"), ("fused_stage_lowp", "conv_pool_wgmma_kernel"),
                     ("fused_mlp", "fused_mlp_bf16_kernel")):
        regs = {fn: r for fn, r in ptxas_report(lib).items() if key in fn}
        sass = {fn: c for fn, c in sass_mma_counts(lib).items() if key in fn}
        require(bool(sass) and all(c.get("HGMMA", 0) + c.get("IGMMA", 0) > 0 for c in sass.values()),
                f"{key}: no wgmma (HGMMA / IGMMA) in its SASS: {sass}")
        for fn in set(regs) | set(sass):
            report[wgmma_label(fn)] = {**regs.get(fn, {}), "sass": sass.get(fn, {})}
    require(any("Bf16Form" in k and v["sass"].get("HGMMA", 0) > 0 for k, v in report.items()),
            f"conv_pool_wgmma_kernel<Bf16Form, ...>: no HGMMA in its SASS: {report}")
    serialized = [line.strip() for lib in ("matmul", "fused_stage_lowp", "fused_mlp")
                  for line in (_build.BUILD_DIR / f"{lib}.log").read_text().splitlines() if "C75" in line]
    require(not serialized, f"ptxas serialized wgmma: {serialized}")
    report["head_bf16_wgmma_kernel"]["smem_bytes"] = BF16_SMEM
    dev = torch.device("cuda")
    for hh, ci, co in ((13, 64, 256), (11, 256, 512)):
        plan = card_int8_stage_plan(n, hh, hh, ci, co, dev)
        kb = 128 if plan.m_tiles == 2 and int8_cin(ci) % 128 == 0 else 64   # the C entry's stage depth
        label = f"conv_pool_wgmma_kernel<Int8Form<float>, {plan.m_tiles}, {plan.block_n}, {kb}>"
        report.setdefault(label, {}).setdefault("smem_bytes", {})[f"{hh}x{hh}, {ci}->{co}"] = int8_smem_bytes(plan, int8_cin(ci))
        plan = card_bf16_stage_plan(n, hh, hh, ci, co, dev)
        label = f"conv_pool_wgmma_kernel<Bf16Form, {plan.m_tiles}, {plan.block_n}, {128 if plan.m_tiles == 2 else 64}>"
        report.setdefault(label, {}).setdefault("smem_bytes", {})[f"{hh}x{hh}, {ci}->{co}"] = \
            stage_bf16_smem_bytes(plan, bf16_cin(ci))
    rows, _ = card_bf16_mlp_plan(n, fusion_dims, dev)
    report.setdefault(f"fused_mlp_bf16_kernel<{rows}>", {})["smem_bytes"] = mlp_bf16_smem_bytes(rows, fusion_dims)
    return report


def lowp_row(parts: list[dict]) -> dict:
    row = row_of([{**p, "library_ms": p["library_ms"] or 0.0} for p in parts])
    if any(p["library_ms"] is None for p in parts):
        row["library_ms"] = None
        row["library_note"] = ("no one PyTorch call computes an int8 convolution; cuDNN's bf16 convolution + bias + "
                               "ReLU + pool at the same shapes: bf16_cudnn_ms")
        row["bf16_cudnn_ms"] = sum(p["bf16_cudnn_ms"] for p in parts if p.get("main_path", True))
    row["parts"] = parts
    return row


def lowp_kernel_rows(n: int, cfg: PipelineConfig, fusion_layers, gen) -> dict:
    """12a: each form at the main paths' shapes: 2-bf16 at the batch's N; 2-int8 at the batch's N in float32
    and bf16 and at a match's N in float32 (the quantized Spotter); 3-bf16 and 4-bf16 at the batch's M (3-bf16
    also at a match's M and 4-bf16 also 512 wide (``--no-audio``), parts off this phase's main path, so their
    scaling is on record)."""
    stages = ((13, 64, 256), (11, 256, 512))
    bf16_layers = [{k: v.to(torch.bfloat16) for k, v in lp.items()} for lp in fusion_layers]
    # the --no-audio chain's 512-wide input (its first layer takes the visual features alone)
    gen_w = torch.Generator(device="cuda").manual_seed(512)
    no_audio = [{"w": (torch.randn((512, bf16_layers[0]["w"].shape[1]), generator=gen_w, device="cuda")
                       * 512 ** -0.5).to(torch.bfloat16), "b": bf16_layers[0]["b"]}, *bf16_layers[1:]]
    rows = {
        "fused_conv_pool_stage_bf16": lowp_row([lowp_stage_part("bf16", n, hh, ci, co, torch.bfloat16, gen)
                                                for hh, ci, co in stages]),
        "fused_conv_pool_stage_int8": lowp_row([lowp_stage_part("int8", m, hh, ci, co, dt, gen)
                                                for m, dt in ((n, torch.float32), (n, torch.bfloat16),
                                                              (MATCH_FRAMES, torch.float32))
                                                for hh, ci, co in stages]),
        "head_matmul_bf16": lowp_row([lowp_head_part(m, 9 * 9 * cfg.model.vis_channels[-1], cfg.model.vis_feature_dim,
                                                     gen, main_path=m == n) for m in (n, MATCH_FRAMES)]),
        "fused_fusion_mlp_bf16": lowp_row([lowp_mlp_part(n, bf16_layers, cfg.model.out_lo, cfg.model.out_hi, gen),
                                           lowp_mlp_part(n, no_audio, cfg.model.out_lo, cfg.model.out_hi, gen,
                                                         main_path=False)]),
    }
    return rows


LOWP_KERNELS = {
    "bf16": ["fused_preprocess_frames", "fused_conv_pool_stage_bf16", "head_matmul_bf16", "fused_fusion_mlp_bf16"],
    "int8": ["fused_preprocess_frames", "fused_conv_pool_stage_int8", "head_matmul", "fused_fusion_mlp"],
    "bf16_int8": ["fused_preprocess_frames", "fused_conv_pool_stage_int8", "head_matmul_bf16", "fused_fusion_mlp_bf16"],
}


def require_not_launched(label: str, names, launches_by_path: dict) -> None:
    ran = {k: launches_by_path[label][k] for k in names if launches_by_path[label][k]}
    require(not ran, f"{label}: {ran} launched")


def lowp_videos_check(seed: int, smi: str, launches_by_path: dict, videos: list[dict]) -> dict:
    """12b: phase 1's three videos through extract_features → fuse_many → summarize in each mode, with the same
    weights as a float32 run: launches, card against CPU on 64 frames (the card's features on both sides),
    drift from the card's float32 scores, batch time, per-video p50 and the stage split."""
    f32_cfg = PipelineConfig.load(str(REPO / "configs" / "reference_parity.json"))
    params_np, state_np = weights.init_params(f32_cfg, seed)
    params, state = weights.from_jax(params_np, state_np)
    cpu_params, cpu_state = weights.from_jax(params_np, state_np, device="cpu")
    _, f32_scores, _, _ = run_path(videos, params, state, f32_cfg)
    out = {}
    for mode in PRESET_MODES:
        cfg = preset_cfg(mode)
        label = f"summarize_{mode}"
        feats, scores, results, _ = drive(label, LOWP_KERNELS[mode], lambda: run_path(videos, params, state, cfg),
                                          launches_by_path)
        f32_forms = {"bf16": TRUNK + ("fused_fusion_mlp",), "int8": ("fused_conv_pool_stage",),
                     "bf16_int8": TRUNK + ("fused_fusion_mlp",)}[mode]
        require_not_launched(label, f32_forms, launches_by_path)
        check_outputs(videos, feats, scores, results, cfg)
        bf16 = cfg.model.dtype == "bfloat16"
        if bf16:
            for s in scores:
                require(np.array_equal(torch.from_numpy(s).to(torch.bfloat16).float().numpy(), s),
                        f"{label}: scores off the bf16 grid")
        m = CPU_CHECK_FRAMES
        sub = {"visual": feats[0]["visual"][:m], "audio": feats[0]["audio"][:m]}
        card = fuse(params, state, sub, cfg)
        cpu = fuse(cpu_params, cpu_state, {k: v.cpu() for k, v in sub.items()}, cfg, device="cpu")
        tol = 0.0625 if bf16 else 1e-4
        err = float(np.abs(card - cpu).max())
        require(err <= tol, f"{label}: card vs CPU on {m} frames, max |err| {err} > {tol}")
        drift = max(float(np.abs(a - b).max()) for a, b in zip(scores, f32_scores))
        require(drift <= 0.1, f"{label}: scores {drift} from the card's float32 scores (> 0.1, the drift gate)")
        walls, stages, per_video = [], [], []
        for _ in range(2):
            t0 = time.perf_counter()
            stages.append(run_path(videos, params, state, cfg)[3])
            walls.append(time.perf_counter() - t0)
            for v in videos:
                t0 = time.perf_counter()
                run_path([v], params, state, cfg)
                per_video.append(time.perf_counter() - t0)
        n_total = sum(VIDEO_LENGTHS)
        wall = statistics.median(walls)
        out[mode] = {"card_vs_cpu_max_abs_err": err, "tolerance": tol, "drift_from_f32": drift,
                     "distinct_scores": int(len(np.unique(np.concatenate(scores)))),
                     "batch_s": wall, "frames_per_s": n_total / wall,
                     "per_video_p50_ms": 1e3 * statistics.median(per_video),
                     "stage_ms": {k: 1e3 * statistics.median(st[k] for st in stages) for k in stages[0]}}
        print(f"phase 12b: {mode} on {smi}: {json.dumps(out[mode])}", flush=True)
    f32_walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        run_path(videos, params, state, f32_cfg)
        f32_walls.append(time.perf_counter() - t0)
    out["f32_batch_s"] = statistics.median(f32_walls)
    print(f"phase 12b: float32 batch of the same three videos in the same call: {out['f32_batch_s']:.4f} s", flush=True)
    return out


def lowp_infer_check(seed: int, smi: str, launches_by_path: dict) -> dict:
    """12c: ``infer --config`` the preset on phase 9's video, offline (audio trunk) and ``--no-audio --stream``,
    each against the direct path on the same inputs (the stream's chunks zero-padded to ``--stream-chunk`` as
    the int8 scale needs); then 12d, the preset's ``Summarizer`` and ``DynamicBatcher`` once each."""
    from cvml_goalnet_tpu_torch.serve import DynamicBatcher, Summarizer

    os.environ.pop("GOALNET_PLATFORM", None)
    cfg = preset_cfg()
    no_audio = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, audio_included=False))
    skip = cfg.preprocess.skip_frames
    out = {}
    with tempfile.TemporaryDirectory() as root:
        inp = make_infer_inputs(cfg, seed, root)
        raw, video = inp["raw"], inp["video"]
        full_n = len(raw)
        frames = raw[::skip]
        sink, spy = ExportSink(False), ScoreSpy()
        video_io.export_video, streaming.score_video_stream = sink, spy
        try:
            intervals = uniform_clip_intervals(cfg, full_n)
            waveform, _ = load_waveform(os.path.join(root, "video.wav"), cfg.audio.sample_rate)
            p, s = weights.from_jax(*weights.init_params(cfg, seed))
            scores = fuse(p, s, extract_features(frames, waveform, cfg), cfg)
            direct = summarize(scores, intervals, skip, full_n, cfg.knapsack)
            base = ["infer", video, "--config", inp["cfg_path"], "--workdir", inp["work"]]
            t0 = time.perf_counter()
            rc = drive("infer_preset", LOWP_KERNELS["bf16_int8"], lambda: cli.main(base), launches_by_path)
            out["offline_s"] = time.perf_counter() - t0
            require(rc == 0, f"12c: infer --config tpu_serving.json exited {rc}")
            require(np.array_equal(sink.frames, chosen_frames(raw, direct.clip_intervals)),
                    "12c: offline infer exported other frames than the direct path selects")
            stream = base + ["--no-audio", "--stream", "--stream-chunk", str(INFER_CHUNK)]
            t0 = time.perf_counter()
            rc = drive("infer_preset_stream", LOWP_KERNELS["bf16_int8"], lambda: cli.main(stream), launches_by_path)
            out["stream_s"] = time.perf_counter() - t0
            require(rc == 0, f"12c: infer --stream --config tpu_serving.json exited {rc}")
            got = spy.calls[-1]["scores"]
            pn, sn = weights.from_jax(*weights.init_params(no_audio, seed))
            want = []
            for a in range(0, len(frames), INFER_CHUNK):
                chunk = frames[a:a + INFER_CHUNK]
                padded = np.concatenate([chunk, np.zeros((INFER_CHUNK - len(chunk),) + chunk.shape[1:], chunk.dtype)])
                want.append(fuse(pn, sn, extract_features(padded, None, no_audio), no_audio)[:len(chunk)])
            err = float(np.abs(got - np.concatenate(want)).max())
            require(err <= 0.0625, f"12c: --stream scores {err} from the padded chunks scored directly (> 0.0625)")
            out.update({"stream_max_abs_err": err, "stream_stages": spy.calls[-1]["stats"].stage_seconds,
                        "exported_frames": int(len(sink.frames))})
            print(f"phase 12c: infer --config tpu_serving.json on {smi}: {json.dumps(out)}", flush=True)

            ckp = cli._artifact_paths(inp["work"], True)["ckp_dir"]
            summ = Summarizer(cfg, checkpoint_dir=ckp)
            res = drive("serve_preset_summarizer", LOWP_KERNELS["bf16_int8"], lambda: summ.summarize_path(video),
                        launches_by_path)
            serr = float(np.abs(res.scores - scores).max())
            require(serr <= 0.0625, f"12d: Summarizer scores {serr} from the direct path (> 0.0625)")
            batcher = DynamicBatcher(summ)
            try:
                n = LOWP_BATCH_REQUEST
                per = len(waveform) // len(frames)
                req = drive("serve_preset_batcher", LOWP_KERNELS["bf16_int8"][1:],
                            lambda: batcher.submit("r", frames[:n], waveform=waveform[:n * per]).result(),
                            launches_by_path)
            finally:
                batcher.close()
            bucket = batcher._bucket(n)
            f = extract_features(frames[:n], waveform[:n * per], cfg)
            v = torch.cat([f["visual"], f["visual"].new_zeros((bucket - n,) + tuple(f["visual"].shape[1:]))])
            a = torch.cat([f["audio"], f["audio"].new_zeros((bucket - n,) + tuple(f["audio"].shape[1:]))])
            berr = float(np.abs(req.scores - fuse(summ.state.params, summ.state.model_state,
                                                  {"visual": v, "audio": a}, cfg)[:n]).max())
            require(berr <= 0.0625, f"12d: the batcher's scores {berr} from its bucket scored directly (> 0.0625)")
            out.update({"summarizer_max_abs_err": serr, "batcher_bucket": bucket, "batcher_max_abs_err": berr})
            print(f"phase 12d: preset Summarizer and DynamicBatcher on {smi}: summarize_path max |err| {serr:.3g}, "
                  f"a {n}-frame request in bucket {bucket} max |err| {berr:.3g}", flush=True)
        finally:
            video_io.export_video, streaming.score_video_stream = sink.writer, spy.fn
    return out


def lowp_spotter_check(seed: int, smi: str, launches_by_path: dict) -> dict:
    """12e: a quantized ``Spotter`` (``configs/tpu_spotting.json`` with ``quantized_inference``; the trunk in
    float32 with int8 conv1 and conv2 at T = 5400) on phase 5's match, against the path run directly."""
    from cvml_goalnet_tpu_torch.serve import Spotter

    banded = PipelineConfig.load(str(REPO / "configs" / "tpu_spotting.json"))
    cfg = dataclasses.replace(banded, model=dataclasses.replace(banded.model, quantized_inference=True))
    match = make_match(banded, seed)
    sp = Spotter(cfg, state=create_train_state(seed, cfg))
    sp.warmup()
    walls = []
    t0 = time.perf_counter()
    got = drive("serve_spotter_int8", ["fused_preprocess_frames", "fused_conv_pool_stage_int8", "head_matmul",
                                       "flash_local_fwd"],
                lambda: sp.spot_frames("match", match["frames"], match["full_n"], match["waveform"]), launches_by_path)
    walls.append(time.perf_counter() - t0)
    require_not_launched("serve_spotter_int8", ("fused_conv_pool_stage",), launches_by_path)
    for _ in range(2):
        t0 = time.perf_counter()
        sp.spot_frames("match", match["frames"], match["full_n"], match["waveform"])
        walls.append(time.perf_counter() - t0)
    feats = extract_features(match["frames"], match["waveform"], cfg)
    enc = encode_timeline(sp.state.params, sp.state.model_state, feats["visual"], feats["audio"], cfg)
    scores = score_timeline_auto(sp.temporal_params, enc, cfg).cpu().numpy()
    tol = score_tolerance(scores)
    err = float(np.abs(got.scores - scores).max())
    require(err <= tol, f"12e: quantized spot_frames scores max |err| {err} > {tol}")
    f32 = encode_timeline(sp.state.params, sp.state.model_state, feats["visual"], feats["audio"], banded)
    rel = float(((enc - f32).abs().max() / f32.abs().max()).item())
    out = {"max_abs_err": err, "tolerance": tol, "near_tie_events": compare_events(got.scores, scores, tol),
           "events": len(got.events), "features_rel_from_f32": rel, "spot_frames": percentiles(walls)}
    print(f"phase 12e: quantized Spotter on {smi}: {json.dumps(out)}", flush=True)
    return out


def lowp_train_check(seed: int, smi: str, launches_by_path: dict) -> dict:
    """12f: three bf16 mixed-precision train steps (``compute_dtype = "bfloat16"``, dropout 0) at phase 10's
    width on a 30-frame video, on the card and on the CPU from the same state: the first loss within 1e-2
    relative, the master params float32, and no kernel launched (the train forward is plain PyTorch)."""
    base = PipelineConfig.load(str(REPO / "configs" / "reference_parity.json"))
    cfg = dataclasses.replace(base, model=dataclasses.replace(base.model, dropout_rate=0.0),
                              train=dataclasses.replace(base.train, compute_dtype="bfloat16"))
    rng = np.random.default_rng(seed + 700)
    n = LOWP_TRAIN_FRAMES
    arrays = [rng.random((n, *cfg.preprocess.frame_size, 3)).astype(np.float32),
              rng.random((n, cfg.audio.bin_length, cfg.audio.n_mfcc)).astype(np.float32),
              rng.integers(1, 6, n).astype(np.float32), np.ones(n, np.float32)]
    fn = train_loop.make_train_video_fn(cfg)
    out = {}
    for device in ("cuda", "cpu"):
        st = create_train_state(seed, cfg, device=device)
        ins = [torch.from_numpy(a).to(device) for a in arrays]
        S = cfg.train.subbatch_size
        loss0 = float(fn.value_and_grad(st.params, st.model_state, *(t[:S] for t in ins), None)[0])
        t0 = time.perf_counter()
        if device == "cuda":
            p, ms, opt, preds, loss = drive("train_bf16", [], lambda: fn(st.params, st.model_state, st.opt_state,
                                                                         *ins, None), launches_by_path)
            require_not_launched("train_bf16", list(KERNELS), launches_by_path)
        else:
            p, ms, opt, preds, loss = fn(st.params, st.model_state, st.opt_state, *ins, None)
        out[device] = {"first_loss": loss0, "mean_loss": float(loss), "steps": opt.step,
                       "wall_s": time.perf_counter() - t0}
        require(opt.step == n // S and all(t.dtype == torch.float32 for t in tree_leaves(p)),
                f"12f: {opt.step} steps or master params not float32 on {device}")
    rel = abs(out["cuda"]["first_loss"] - out["cpu"]["first_loss"]) / abs(out["cpu"]["first_loss"])
    require(rel <= 1e-2, f"12f: the first bf16 loss card vs CPU {rel} relative (> 1e-2)")
    out["first_loss_rel"] = rel
    print(f"phase 12f: three bf16 train steps on {smi}: {json.dumps(out)}", flush=True)
    return out


def lowp_phase(seed: int, smi: str, launches_by_path: dict, videos: list[dict]) -> dict:
    """Phase 12: bf16 and int8 inference at the preset's full width (``configs/tpu_serving.json``) on phase 1's
    ``videos`` and the rest, and bf16 training; returns the kernel rows of the four low-precision forms."""
    t_phase = time.perf_counter()
    cfg = preset_cfg()
    fusion = weights.from_jax(*weights.init_params(cfg, seed))[0]["fusion"]
    gen = torch.Generator(device="cuda").manual_seed(seed + 12)
    fusion_dims = mlp_dims(fusion)
    print(f"phase 12a: the wgmma kernels of 3-bf16, 2-bf16, 2-int8 and 4-bf16 (registers, spill bytes, shared memory "
          f"a block, SASS MMA instructions): {json.dumps(wgmma_forms_report(sum(VIDEO_LENGTHS), fusion_dims))}",
          flush=True)
    rows = lowp_kernel_rows(sum(VIDEO_LENGTHS), cfg, fusion, gen)
    sweep = lowp_mlp_plan_sweep([{k: v.to(torch.bfloat16) for k, v in lp.items()} for lp in fusion], gen)
    print(f"fused_fusion_mlp_bf16 plans on {smi}: chosen {json.dumps(sweep['chosen'])}; model fitted "
          f"{json.dumps(sweep['fit'])}; clusters at once {json.dumps(sweep['clusters_at_once'])}; device ms by "
          f"M:plan {json.dumps(sweep['device_ms'])}", flush=True)
    print(f"phase 12a: the four forms on {smi}: {json.dumps({k: {x: r[x] for x in ('ms', 'plain_ms', 'library_ms', 'bound_ms', 'bound_by', 'max_abs_err')} for k, r in rows.items()})}",
          flush=True)
    lowp_videos_check(seed, smi, launches_by_path, videos)
    lowp_infer_check(seed, smi, launches_by_path)
    lowp_spotter_check(seed, smi, launches_by_path)
    lowp_train_check(seed, smi, launches_by_path)
    print(f"phase 12: {time.perf_counter() - t_phase:.1f} s wall", flush=True)
    return rows

# ---------------------------------------------------------------- phase 13: the text branch and the MoE fusion

TEXT_LINE_EVERY = 150    # raw frames between two lines of a seeded commentary sidecar (5 s at 30 fps)
TEXT_WORDS = ("goal", "shot", "save", "corner", "keeper", "header", "cross", "free", "kick", "penalty", "offside",
              "tackle", "yellow", "card", "counter", "attack", "box", "post", "bar", "what", "a", "strike", "o'neill's")
MOE_EXPERTS = 4          # --moe-experts of the JAX package's own CLI and MoE tests
TEXT_MODES = {"text": (True, 0), "moe": (False, MOE_EXPERTS), "text_moe": (True, MOE_EXPERTS)}
TEXT_FLAGS = ["--commentary", "--moe-experts", str(MOE_EXPERTS)]
TEXT_BATCH_REQUEST = 100   # condensed frames of phase 13e's batcher request (bucket 256)


def text_moe_cfg(base: PipelineConfig, mode: str = "text_moe") -> PipelineConfig:
    """``base`` with the text branch (``--commentary``), the MoE fusion (``--moe-experts 4``) or both."""
    text, experts = TEXT_MODES[mode]
    return dataclasses.replace(base, model=dataclasses.replace(base.model, text_included=text,
                                                               fusion_moe_experts=experts))


def synthetic_commentary(full_n: int, seed: int) -> list[tuple[int, str]]:
    """Seeded commentary: a line of 3-12 words from :data:`TEXT_WORDS` every :data:`TEXT_LINE_EVERY` raw frames."""
    rng = np.random.default_rng(seed)
    return [(f, " ".join(rng.choice(TEXT_WORDS, int(rng.integers(3, 13))))) for f in range(0, full_n, TEXT_LINE_EVERY)]


def write_commentary(video_fp: str, full_n: int, seed: int) -> list[tuple[int, str]]:
    """:func:`synthetic_commentary` written as the video's ``.commentary.jsonl`` sidecar; returns its lines."""
    entries = synthetic_commentary(full_n, seed)
    with open(video_fp.rsplit(".", 1)[0] + ".commentary.jsonl", "w") as f:
        for frame, line in entries:
            f.write(json.dumps({"frame": frame, "text": line}) + "\n")
    return entries


def text_moe_mlp_parts(n: int, seed: int, smi: str, gen) -> tuple[list[dict], list[dict]]:
    """13a: kernel 4 and 4-bf16 at M = ``n`` on the 768-wide chain of the text branch and on the chain after an
    MoE first layer (parts off the rows' totals, so the rows stay comparable with earlier runs)."""
    base = PipelineConfig.load(str(REPO / "configs" / "reference_parity.json"))
    chains = {"768-wide": weights.from_jax(*weights.init_params(text_moe_cfg(base, "text"), seed))[0]["fusion"],
              "post-MoE": weights.from_jax(*weights.init_params(text_moe_cfg(base, "moe"), seed))[0]["fusion"][1:]}
    lo, hi = base.model.out_lo, base.model.out_hi
    f32, bf16 = [], []
    for chain, layers in chains.items():
        part = {**mlp_part(n, layers, True, lo, hi, False, gen), "chain": chain, "phase": 13}
        f32.append(part)
        print(f"phase 13a: fused_fusion_mlp at {part['shape']} ({chain}) on {smi}: {part['ms']:.4f} ms (plain "
              f"{part['plain_ms']:.4f}, library {part['library_ms']:.4f}); bound {part['bound_ms']:.4f} ms "
              f"({part['bound_by']}); plan {json.dumps(part['plan'])}; max |err| {part['max_abs_err']:.3g}", flush=True)
        blayers = [{k: v.to(torch.bfloat16) for k, v in lp.items()} for lp in layers]
        bf16.append({**lowp_mlp_part(n, blayers, lo, hi, gen, main_path=False), "chain": chain, "phase": 13})
    return f32, bf16


def moe_routing(params, state, feats: dict, cfg: PipelineConfig, n: int) -> torch.Tensor:
    """The MoE gate's kept experts (n, E) of the first ``n`` frames of ``feats``, in ``cfg``'s dtype as ``fuse``
    computes them."""
    dt = compute_dtype(cfg.model.dtype)
    p, s = tree_cast(params, dt), tree_cast(state, dt)
    dev = feats["visual"].device
    with torch.no_grad():
        vis = visual_encoder_apply(p["visual"], s["visual"], feats["visual"][:n].to(dt),
                                   quant=cfg.model.quantized_inference)
        x = _fused_input(p, vis, feats["audio"][:n].to(dt), feats["text"][:n].to(dev), cfg.model)
        return _moe_layer(p["fusion"][0], x, cfg.model)[1] > 0


def text_moe_videos_check(seed: int, smi: str, launches_by_path: dict, videos: list[dict]) -> dict:
    """13b and 13f: phase 1's three videos with seeded commentary through ``extract_features(commentary=)`` →
    ``fuse_many`` → ``summarize`` with the text branch, the MoE fusion and both, and the serving preset with
    both: launches, card against CPU on 64 frames, the stage walls and the text encoder's and the MoE layer's
    share of the fuse."""
    base = PipelineConfig.load(str(REPO / "configs" / "reference_parity.json"))
    skip = base.preprocess.skip_frames
    comm = [commentary_per_frame(synthetic_commentary(v["full_n"], seed + 500 + i), len(v["frames"]), skip)
            for i, v in enumerate(videos)]
    m, n_total = CPU_CHECK_FRAMES, sum(VIDEO_LENGTHS)
    v0 = videos[0]
    out = {}
    for mode in (*TEXT_MODES, "preset_text_moe"):
        preset = mode.startswith("preset")
        cfg = text_moe_cfg(preset_cfg()) if preset else text_moe_cfg(base, mode)
        params_np, state_np = weights.init_params(cfg, seed)
        params, state = weights.from_jax(params_np, state_np)
        c = comm if cfg.model.text_included else None
        label = "summarize_bf16_int8_text_moe" if preset else f"text_moe_summarize_{mode}"
        kernels = LOWP_KERNELS["bf16_int8"] if preset else ["fused_preprocess_frames", *TRUNK, "fused_fusion_mlp"]
        feats, scores, results, _ = drive(label, kernels, lambda: run_path(videos, params, state, cfg, c),
                                          launches_by_path)
        check_outputs(videos, feats, scores, results, cfg)
        if cfg.model.text_included:
            require(all(tuple(f["text"].shape) == (len(v["frames"]), cfg.model.text_max_len)
                        and f["text"].dtype == torch.int32 for f, v in zip(feats, videos)), f"{label}: token ids")
        cpu_feats = extract_features(v0["frames"][:m], v0["waveform"][: m * v0["per_frame"]], cfg,
                                     commentary=None if c is None else c[0][:m], device="cpu")
        tp, ts = weights.from_jax(params_np, state_np, device="cpu")
        cpu = fuse(tp, ts, cpu_feats, cfg, device="cpu")
        card = scores[0][:m]
        tol = 0.0625 if preset else 1e-4
        err = float(np.abs(card - cpu).max())
        rec = {"card_vs_cpu_max_abs_err": err, "tolerance": tol}
        if preset:
            require(np.array_equal(torch.from_numpy(card).to(torch.bfloat16).float().numpy(), card),
                    f"{label}: scores off the bf16 grid")
            # a gate whose k-th logit ties under one rounding and not the other routes a frame to other experts:
            # allowed only there, and reported
            parted = np.nonzero(np.abs(card - cpu) > tol)[0]
            if len(parted):
                routed = (moe_routing(params, state, feats[0], cfg, m).cpu()
                          != moe_routing(tp, ts, cpu_feats, cfg, m)).any(dim=1).numpy()
                require(bool(routed[parted].all()), f"{label}: card vs CPU {err} > {tol} on frames "
                                                    f"{parted.tolist()} routed alike")
                rec["rerouted_frames"] = parted.tolist()
        else:
            require(err <= tol, f"{label}: card vs CPU on {m} frames, max |err| {err} > {tol}")
        if cfg.model.text_included and not preset:
            with torch.no_grad():
                gt = text_encoder_apply(params["text"], feats[0]["text"][:m], cfg=cfg.model).cpu()
                ct = text_encoder_apply(tp["text"], cpu_feats["text"], cfg=cfg.model)
            rel = float(((gt - ct).abs().max() / ct.abs().max().clamp_min(1.0)).item())
            require(rel <= 1e-4, f"{label}: text features card vs CPU {rel} relative (> 1e-4)")
            rec["text_features_rel"] = rel
        walls, stages = [], []
        for _ in range(2):
            t0 = time.perf_counter()
            stages.append(run_path(videos, params, state, cfg, c)[3])
            walls.append(time.perf_counter() - t0)
        dt = compute_dtype(cfg.model.dtype)
        pc = tree_cast(params, dt)
        with torch.no_grad():
            rec["fuse_ms"] = time_ms(lambda: fuse_many(params, state, feats, cfg), 5)
            if cfg.model.text_included:
                tokens = torch.cat([f["text"] for f in feats])
                rec["text_encoder_ms"] = time_ms(lambda: text_encoder_apply(pc["text"], tokens, cfg=cfg.model), 5)
            if cfg.model.fusion_moe_experts:
                x = torch.rand((n_total, pc["fusion"][0]["gate"]["w"].shape[0]), device="cuda").to(dt)
                rec["moe_layer_ms"] = time_ms(lambda: _moe_layer(pc["fusion"][0], x, cfg.model), 5)
        rec.update({"batch_s": statistics.median(walls), "frames_per_s": n_total / statistics.median(walls),
                    "stage_ms": {k: 1e3 * statistics.median(st[k] for st in stages) for k in stages[0]}})
        for k in ("text_encoder_ms", "moe_layer_ms"):
            if k in rec:
                rec[k.replace("_ms", "_share_of_fuse")] = rec[k] / rec["fuse_ms"]
        out[mode] = rec
        print(f"phase 13{'f' if preset else 'b'}: {mode} on {smi}: {json.dumps(rec)}", flush=True)
    return out


def text_moe_infer_check(seed: int, smi: str, launches_by_path: dict) -> dict:
    """13c: ``cli.main(["infer", ..., "--commentary", "--moe-experts", "4"])`` offline on phase 9's video with a
    seeded commentary sidecar and a trunk of that structure, against the direct path; ``--stream --commentary``
    exits 2."""
    os.environ.pop("GOALNET_PLATFORM", None)
    base = PipelineConfig.load(str(REPO / "configs" / "reference_parity.json"))
    cfg = text_moe_cfg(base)
    skip = cfg.preprocess.skip_frames
    out = {}
    with tempfile.TemporaryDirectory() as root:
        inp = make_infer_inputs(cfg, seed, root)
        base.save(inp["cfg_path"])   # the flags add the branch and the experts, as a user passes them
        raw, video = inp["raw"], inp["video"]
        full_n = len(raw)
        entries = write_commentary(video, full_n, seed + 600)
        sink = ExportSink(False)
        video_io.export_video = sink
        try:
            argv = ["infer", video, "--config", inp["cfg_path"], "--workdir", inp["work"], *TEXT_FLAGS]
            t0 = time.perf_counter()
            rc = drive("infer_text_moe", ["fused_preprocess_frames", *TRUNK, "fused_fusion_mlp"],
                       lambda: cli.main(argv), launches_by_path)
            out["offline_s"] = time.perf_counter() - t0
            require(rc == 0, f"13c: infer --commentary --moe-experts 4 exited {rc}")
            frames = raw[::skip]
            waveform, _ = load_waveform(video[:-4] + ".wav", cfg.audio.sample_rate)
            p, s = weights.from_jax(*weights.init_params(cfg, seed))
            feats = extract_features(frames, waveform, cfg, commentary=commentary_per_frame(entries, len(frames), skip))
            direct = summarize(fuse(p, s, feats, cfg), uniform_clip_intervals(cfg, full_n), skip, full_n, cfg.knapsack)
            require(np.array_equal(sink.frames, chosen_frames(raw, direct.clip_intervals)),
                    "13c: infer --commentary --moe-experts 4 exported other frames than the direct path selects")
            err = io.StringIO()
            with contextlib.redirect_stderr(err):
                rc = cli.main([*argv, "--no-audio", "--stream"])
            require(rc == 2 and "commentary alignment" in err.getvalue(),
                    f"13c: infer --stream --commentary exited {rc}: {err.getvalue()[-300:]}")
            out.update({"exported_frames": int(len(sink.frames)), "stream_refusal": err.getvalue().strip()})
        finally:
            video_io.export_video = sink.writer
    print(f"phase 13c: infer {' '.join(TEXT_FLAGS)} on {smi}: {json.dumps(out)}", flush=True)
    return out


def first_grads_against_cpu(cfg: PipelineConfig, item, seed: int, what: str) -> dict:
    """The first sub-batch's loss and gradients of ``item`` (on the card) from one seeded state, card against
    CPU: each leaf within 1e-4·max(1, max|g|) → the losses, the largest error as a share of its tolerance and
    the leaf count.  ``cfg`` runs at dropout 0 (the two devices draw other masks)."""
    fn = train_loop.make_train_video_fn(cfg)
    S = cfg.train.subbatch_size
    grads, losses = {}, {}
    for name, it in (("card", item), ("cpu", on_cpu(item))):
        d = it.visual.device
        st = create_train_state(seed, cfg, device=d)
        v, a, lab, valid, _ = train_loop._pad_video(it, S, d)
        text = train_loop._pad_text(it, len(v), d, cfg)
        loss, _, _, g = fn.value_and_grad(st.params, st.model_state, v[:S], None if a is None else a[:S], lab[:S],
                                          valid[:S], None, None if text is None else text[:S])
        grads[name], losses[name] = [t.cpu() for t in tree_leaves(g)], float(loss)
    ratio = max((a - b).abs().max().item() / (1e-4 * max(1.0, b.abs().max().item()))
                for a, b in zip(grads["card"], grads["cpu"]))
    require(ratio <= 1.0, f"{what}: card vs CPU first gradients beyond 1e-4·max(1, max|g|) ({ratio:.3g}×)")
    return {"first_loss": losses, "grad_ratio_of_tolerance": ratio, "leaves": len(grads["card"])}


def text_moe_train_check(seed: int, smi: str, launches_by_path: dict) -> dict:
    """13d: ``train --commentary --moe-experts 4 --epochs 1``, then ``eval --commentary`` with a config of 4
    experts (``eval`` takes no ``--moe-experts``, as the JAX CLI's), on phase 10's videos (vidA and vidC
    with seeded commentary sidecars, vidB and vidD without: empty commentary); then the first sub-batch's
    gradients, the load-balance auxiliary loss included, card against CPU from one seeded state at dropout 0."""
    os.environ.pop("GOALNET_PLATFORM", None)
    base = PipelineConfig.load(str(REPO / "configs" / "reference_parity.json"))
    cfg = text_moe_cfg(base)
    kernels = ["fused_preprocess_frames", *TRUNK, "fused_fusion_mlp"]
    out = {}
    with tempfile.TemporaryDirectory() as root:
        data = make_train_inputs(base, seed, root)
        for i, fp in enumerate(data["videos"]):
            if i % 2 == 0:
                write_commentary(fp, TRAIN_VIDEO_FRAMES[i], seed + 700 + i)
        cfg_path, moe_path = os.path.join(root, "cfg.json"), os.path.join(root, "moe.json")
        base.save(cfg_path)
        text_moe_cfg(base, "moe").save(moe_path)   # eval takes --commentary only (as the JAX CLI): MoE by config
        store, plots = dataset_io.AnnotationStore, PlotSink()
        saved = (viz.generate_metric_plots, viz.export_indices)
        dataset_io.AnnotationStore = AnnotationStand
        viz.generate_metric_plots, viz.export_indices = plots.metric_plots, plots.export_indices
        args = ["--videos", *data["videos"], "--annotation-fp", data["annotation_fp"], "--mat-fp", data["mat_fp"],
                "--h5-fp", data["h5_fp"], "--info-fp", data["info_fp"], "--workdir", os.path.join(root, "work")]
        try:
            verbs = (("train_text_moe", ["train", *args, "--config", cfg_path, *TEXT_FLAGS, "--epochs", "1"]),
                     ("eval_text_moe", ["eval", *args, "--config", moe_path, "--commentary"]))
            for label, argv in verbs:
                buf = io.StringIO()
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(buf):
                    rc = drive(label, kernels, lambda: cli.main(argv), launches_by_path)
                out[f"{label}_s"] = time.perf_counter() - t0
                require(rc == 0 and "Operation completed" in buf.getvalue(), f"13d: {label} exited {rc}")
                out[f"{label}_lines"] = [ln for ln in buf.getvalue().splitlines()
                                         if ln.startswith(("[eval]", "Optimal"))]
            dcfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, dropout_rate=0.0))
            train_ds, _ = dataset_io.build_datasets(data["videos"], dcfg, data["annotation_fp"], data["mat_fp"],
                                                    data["h5_fp"], data["info_fp"])
        finally:
            dataset_io.AnnotationStore = store
            viz.generate_metric_plots, viz.export_indices = saved
    item = train_ds[0]
    require(item.text is not None and bool(item.text.any()), "13d: vidA's commentary did not reach its item")
    out.update(first_grads_against_cpu(dcfg, item, seed, "13d"))
    print(f"phase 13d: train and eval {' '.join(TEXT_FLAGS)} on {smi}: {json.dumps(out)}", flush=True)
    return out


def text_moe_serving_check(seed: int, smi: str, launches_by_path: dict, videos: list[dict]) -> dict:
    """13e: the ``Summarizer`` with commentary and one ``DynamicBatcher`` request with commentary, each against
    the path scored directly; a banded ``Spotter`` on a 3-modality trunk (``configs/tpu_spotting.json`` with
    ``--commentary``) over phase 5's match with seeded commentary, its trunk against the CPU on 64 frames."""
    from cvml_goalnet_tpu_torch.serve import DynamicBatcher, Spotter, Summarizer

    base = PipelineConfig.load(str(REPO / "configs" / "reference_parity.json"))
    cfg = text_moe_cfg(base)
    skip = cfg.preprocess.skip_frames
    v = videos[0]
    comm = commentary_per_frame(synthetic_commentary(v["full_n"], seed + 800), len(v["frames"]), skip)
    summ = Summarizer(cfg, state=create_train_state(seed, cfg))
    summ.warmup(((16, *RAW_HW),))
    res = drive("serve_text_moe_summarizer", ["fused_preprocess_frames", *TRUNK, "fused_fusion_mlp"],
                lambda: summ.summarize_frames("v", v["frames"], v["intervals"], v["full_n"], v["waveform"],
                                              commentary=comm), launches_by_path)
    p, s = summ.state.params, summ.state.model_state
    direct = fuse(p, s, extract_features(v["frames"], v["waveform"], cfg, commentary=comm), cfg)
    serr = float(np.abs(res.scores - direct).max())
    require(serr <= 1e-5, f"13e: Summarizer with commentary {serr} from the direct path (> 1e-5)")
    n = TEXT_BATCH_REQUEST
    wave = v["waveform"][: n * v["per_frame"]]
    batcher = DynamicBatcher(summ)
    try:
        req = drive("serve_text_moe_batcher", [*TRUNK, "fused_fusion_mlp"],
                    lambda: batcher.submit("r", v["frames"][:n], waveform=wave, commentary=comm[:n]).result(),
                    launches_by_path)
    finally:
        batcher.close()
    bucket = batcher._bucket(n)
    pad = bucket - n
    vis = preprocess_frames_host(v["frames"][:n], cfg.preprocess.frame_size, cfg.preprocess.eps)
    aud = extract_audio_features(wave, n, cfg.audio, torch.device("cuda"))
    tok = tokenize(comm[:n], cfg.model.text_vocab_size, cfg.model.text_max_len)
    want = fuse(p, s, {"visual": np.concatenate([vis, np.zeros((pad,) + vis.shape[1:], vis.dtype)]),
                       "audio": torch.cat([aud, aud.new_zeros((pad,) + tuple(aud.shape[1:]))]),
                       "text": np.concatenate([tok, np.zeros((pad,) + tok.shape[1:], tok.dtype)])}, cfg)[:n]
    berr = float(np.abs(req.scores - want).max())
    require(berr <= 1e-5, f"13e: the batcher's scores with commentary {berr} from its bucket scored directly")

    banded = PipelineConfig.load(str(REPO / "configs" / "tpu_spotting.json"))
    scfg = text_moe_cfg(banded, "text")
    match = make_match(banded, seed)
    mcomm = commentary_per_frame(synthetic_commentary(match["full_n"], seed + 900), MATCH_FRAMES, skip)
    sp = Spotter(scfg, state=create_train_state(seed, scfg))
    sp.warmup(64)
    walls = []
    t0 = time.perf_counter()
    got = drive("serve_text_spotter", ["fused_preprocess_frames", *TRUNK, "flash_local_fwd"],
                lambda: sp.spot_frames("match", match["frames"], match["full_n"], match["waveform"], commentary=mcomm),
                launches_by_path)
    walls.append(time.perf_counter() - t0)
    for _ in range(2):
        t0 = time.perf_counter()
        sp.spot_frames("match", match["frames"], match["full_n"], match["waveform"], commentary=mcomm)
        walls.append(time.perf_counter() - t0)
    require(got.scores.shape == (MATCH_FRAMES,) and bool(np.isfinite(got.scores).all()), "13e: spotter scores")
    m = CPU_CHECK_FRAMES
    wv = match["waveform"][: m * match["per_frame"]]
    encs = []
    for dev in (None, "cpu"):
        f = extract_features(match["frames"][:m], wv, scfg, commentary=mcomm[:m], device=dev)
        st = sp.state if dev is None else create_train_state(seed, scfg, device="cpu")
        encs.append(encode_timeline(st.params, st.model_state, f["visual"], f["audio"], scfg, device=dev,
                                    text=f["text"]).cpu())
    rel = float(((encs[0] - encs[1]).abs().max() / encs[1].abs().max()).item())
    require(rel <= 1e-4, f"13e: 3-modality trunk card vs CPU {rel} relative (> 1e-4)")
    out = {"summarizer_max_abs_err": serr, "batcher_bucket": bucket, "batcher_max_abs_err": berr,
           "spotter_trunk_width": int(encs[0].shape[1]), "spotter_trunk_rel": rel, "spotter_events": len(got.events),
           "spot_frames": percentiles(walls)}
    print(f"phase 13e: serving with commentary on {smi}: {json.dumps(out)}", flush=True)
    return out


def text_moe_phase(seed: int, smi: str, launches_by_path: dict, videos: list[dict], rows: dict) -> None:
    """Phase 13: the text (commentary) branch and the MoE fusion at ``reference_parity.json``'s full width
    (vocab 32,768, 2 layers of 128 wide with 4 heads, 64 tokens; 4 experts, top 2), and the serving preset with
    both; adds 13a's parts to the rows of kernel 4 and 4-bf16."""
    t_phase = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(seed + 13)
    f32, bf16 = text_moe_mlp_parts(sum(VIDEO_LENGTHS), seed, smi, gen)
    if "fused_fusion_mlp" in rows:   # run alone (--phases), phase 13 has no phase 1 or 12 rows to add to
        rows["fused_fusion_mlp"] = row_of(rows["fused_fusion_mlp"]["parts"] + f32)
    if "fused_fusion_mlp_bf16" in rows:
        rows["fused_fusion_mlp_bf16"] = lowp_row(rows["fused_fusion_mlp_bf16"]["parts"] + bf16)
    text_moe_videos_check(seed, smi, launches_by_path, videos)
    text_moe_infer_check(seed, smi, launches_by_path)
    text_moe_train_check(seed, smi, launches_by_path)
    text_moe_serving_check(seed, smi, launches_by_path, videos)
    print(f"phase 13: {time.perf_counter() - t_phase:.1f} s wall", flush=True)


# ---------------------------------------------------------------- phase 14: the resnet and vit backbones

BACKBONES = ("resnet", "vit")
BACKBONE_MODES = {"float32": ("float32", False), "bf16": ("bfloat16", False), "int8": ("float32", True),
                  "bf16_int8": ("bfloat16", True)}


def backbone_cfg(backbone: str, mode: str = "float32", base: str = "reference_parity.json") -> PipelineConfig:
    """``configs/<base>`` with ``vis_backbone`` swapped and the mode's ``dtype`` and ``quantized_inference``."""
    cfg = PipelineConfig.load(str(REPO / "configs" / base))
    dtype, quant_on = BACKBONE_MODES[mode]
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, vis_backbone=backbone, dtype=dtype,
                                                              quantized_inference=quant_on))


def backbone_flops(cfg: PipelineConfig) -> tuple[float, float]:
    """Multiply-adds × 2 a frame of the backbone → (all of it, the part int8 takes under ``quantized_inference``:
    the resnet's 3×3 block convolutions, the vit's block linears)."""
    m, (h, w), c = cfg.model, cfg.preprocess.frame_size, cfg.preprocess.channels
    if m.vis_backbone == "vit":
        d, p = m.vit_embed_dim, m.vit_patch_size
        t = (h // p) * (w // p)
        block_linear = 2 * t * (4 * d * d + 8 * d * d)
        attention = 2 * 2 * t * t * d
        total = 2 * t * p * p * c * d + m.vit_depth * (block_linear + attention) + 2 * d * m.vis_feature_dim
        return float(total), float(m.vit_depth * block_linear)
    chans = m.vis_channels
    k = 7 if min(h, w) >= 32 else 3
    if k == 7:
        h, w = L.conv_out_size(h, 7, 2, 3), L.conv_out_size(w, 7, 2, 3)
        total = 2 * h * w * k * k * c * chans[0]
        h, w = L.conv_out_size(h, 3, 2, 1), L.conv_out_size(w, 3, 2, 1)
    else:
        total = 2 * h * w * k * k * c * chans[0]
    quant_part, cin = 0, chans[0]
    for si, cout in enumerate(chans):
        for bi in range(2):
            stride = 2 if (bi == 0 and si > 0) else 1
            h, w = L.conv_out_size(h, 3, stride, 1), L.conv_out_size(w, 3, stride, 1)
            convs = 2 * h * w * 9 * (cin * cout + cout * cout)
            quant_part += convs
            total += convs + (2 * h * w * cin * cout if (stride != 1 or cin != cout) else 0)
            cin = cout
    return float(total + 2 * chans[-1] * m.vis_feature_dim), float(quant_part)


def backbone_floor_ms(cfg: PipelineConfig, n: int) -> float:
    """The least time of the backbone's products on ``n`` frames at the card's peak for their type: float32 on
    the CUDA cores (TF32 is off), bf16 on the tensor cores, the int8 part at the int8 tensor-core peak."""
    total, quant_part = backbone_flops(cfg)
    peak = PEAK_BF16_FLOP_PER_S if cfg.model.dtype == "bfloat16" else PEAK_F32_FLOP_PER_S
    if not cfg.model.quantized_inference:
        return 1e3 * n * total / peak
    return 1e3 * n * (quant_part / PEAK_INT8_OP_PER_S + (total - quant_part) / peak)


@contextlib.contextmanager
def int8_records(keep_products: bool = False):
    """Records each activation's int8 codes that ``ops/quant.py`` quantizes (``quantize_act_per_tensor``), and
    with ``keep_products`` each int8 GEMM's operands and int32 sums (``int8_matmul``), while the scope is open."""
    codes, products = [], []
    real_act, real_mm = quant.quantize_act_per_tensor, quant.int8_matmul

    def act(x):
        q, s = real_act(x)
        codes.append(q.cpu())
        return q, s

    def mm(a, b):
        out = real_mm(a, b)
        products.append((a.cpu(), b.cpu(), out.cpu()))
        return out

    quant.quantize_act_per_tensor = act
    if keep_products:
        quant.int8_matmul = mm
    try:
        yield codes, products
    finally:
        quant.quantize_act_per_tensor, quant.int8_matmul = real_act, real_mm


def backbone_videos_check(seed: int, smi: str, launches_by_path: dict, videos: list[dict]) -> dict:
    """14a and 14b: phase 1's three videos through ``extract_features`` → ``fuse_many`` → ``summarize`` with each
    backbone in float32, bf16, int8 and bf16 + int8: kernel 1 and kernel 4 (4-bf16 in bf16) launched and kernels
    2 and 3 not; card against CPU on 64 frames (≤ 1e-4 at float32 and int8 at float32, ≤ 0.0625 and on the bf16
    grid in bf16), the int8 codes that part between the two sides counted; under int8 at float32 every int8
    GEMM's sums on those 64 frames equal to the CPU's float64 product; frames/s, the fuse and the backbone's
    share of it beside the backbone's floor."""
    m, n_total = CPU_CHECK_FRAMES, sum(VIDEO_LENGTHS)
    out = {}
    for backbone in BACKBONES:
        for mode in BACKBONE_MODES:
            cfg = backbone_cfg(backbone, mode)
            bf16 = cfg.model.dtype == "bfloat16"
            params_np, state_np = weights.init_params(cfg, seed)
            params, state = weights.from_jax(params_np, state_np)
            label = f"backbone_{backbone}_{mode}"
            mlp = "fused_fusion_mlp_bf16" if bf16 else "fused_fusion_mlp"
            feats, scores, results, _ = drive(label, ["fused_preprocess_frames", mlp],
                                              lambda: run_path(videos, params, state, cfg), launches_by_path)
            require_not_launched(label, TRUNK + ("fused_conv_pool_stage_bf16", "fused_conv_pool_stage_int8",
                                                 "head_matmul_bf16", "fused_fusion_mlp" if bf16 else
                                                 "fused_fusion_mlp_bf16"), launches_by_path)
            check_outputs(videos, feats, scores, results, cfg)
            sub = {"visual": feats[0]["visual"][:m], "audio": feats[0]["audio"][:m]}
            cpu_params, cpu_state = weights.from_jax(params_np, state_np, device="cpu")
            exact = mode == "int8"
            with int8_records(keep_products=exact) as (card_codes, products):
                card = fuse(params, state, sub, cfg)
            with int8_records() as (cpu_codes, _):
                cpu = fuse(cpu_params, cpu_state, {k: v.cpu() for k, v in sub.items()}, cfg, device="cpu")
            tol = 0.0625 if bf16 else 1e-4
            err = float(np.abs(card - cpu).max())
            require(err <= tol, f"{label}: card vs CPU on {m} frames, max |err| {err} > {tol}")
            if bf16:
                for s in scores:
                    require(np.array_equal(torch.from_numpy(s).to(torch.bfloat16).float().numpy(), s),
                            f"{label}: scores off the bf16 grid")
            rec = {"card_vs_cpu_max_abs_err": err, "tolerance": tol,
                   "distinct_scores": int(len(np.unique(np.concatenate(scores))))}
            if cfg.model.quantized_inference:
                require(len(card_codes) == len(cpu_codes) > 0, f"{label}: {len(card_codes)} int8 activations on the "
                                                               f"card, {len(cpu_codes)} on the CPU")
                rec["int8_points"] = len(card_codes)
                rec["int8_code_flips"] = [int((a != b).sum()) for a, b in zip(card_codes, cpu_codes)]
                rec["int8_codes"] = int(sum(a.numel() for a in card_codes))
            if exact:
                require(len(products) > 0, f"{label}: no int8 GEMM ran")
                for i, (a, b, got) in enumerate(products):
                    want = torch.matmul(a.to(torch.float64), b.to(torch.float64)).to(torch.int32)
                    require(torch.equal(got, want), f"{label}: int8 GEMM {i} {tuple(a.shape)} × {tuple(b.shape)} "
                                                    "sums differ from the float64 product")
                rec["int8_gemms_exact"] = [f"{tuple(a.shape)}x{tuple(b.shape)}" for a, b, _ in products]
            walls, stages = [], []
            for _ in range(2):
                t0 = time.perf_counter()
                stages.append(run_path(videos, params, state, cfg)[3])
                walls.append(time.perf_counter() - t0)
            dt = compute_dtype(cfg.model.dtype)
            pc, sc = tree_cast(params, dt), tree_cast(state, dt)
            vis = torch.cat([f["visual"] for f in feats]).to(dt)
            apply, _ = visual_apply(cfg.model)
            with torch.no_grad():
                rec["fuse_ms"] = time_ms(lambda: fuse_many(params, state, feats, cfg), 5)
                rec["backbone_ms"] = time_ms(lambda: apply(pc["visual"], sc["visual"], vis,
                                                           quant=cfg.model.quantized_inference), 5)
            wall = statistics.median(walls)
            rec.update({"batch_s": wall, "frames_per_s": n_total / wall,
                        "backbone_share_of_fuse": rec["backbone_ms"] / rec["fuse_ms"],
                        "backbone_floor_ms": backbone_floor_ms(cfg, n_total),
                        "backbone_gflop_a_frame": backbone_flops(cfg)[0] / 1e9,
                        "stage_ms": {k: 1e3 * statistics.median(st[k] for st in stages) for k in stages[0]}})
            out[label] = rec
            print(f"phase 14a: {backbone} {mode} on {smi}: {json.dumps(rec)}", flush=True)
            del feats
    return out


def backbone_verbs_check(seed: int, smi: str, launches_by_path: dict) -> dict:
    """14c: for each backbone, ``infer`` offline on phase 9's video against the direct path, then ``train
    --epochs 1`` and ``eval`` on phase 10's videos (each evaluation through kernel 4), then vidA's first
    sub-batch's gradients from one seeded state at dropout 0, card against CPU."""
    os.environ.pop("GOALNET_PLATFORM", None)
    out = {}
    with tempfile.TemporaryDirectory() as root:
        base = backbone_cfg("resnet")
        inp = make_infer_inputs(base, seed, root)
        raw, video = inp["raw"], inp["video"]
        full_n, skip = len(raw), base.preprocess.skip_frames
        waveform, _ = load_waveform(video[:-4] + ".wav", base.audio.sample_rate)
        train_root = os.path.join(root, "train")
        os.makedirs(train_root)
        data = make_train_inputs(base, seed, train_root)
        store, plots = dataset_io.AnnotationStore, PlotSink()
        saved = (viz.generate_metric_plots, viz.export_indices)
        dataset_io.AnnotationStore = AnnotationStand
        viz.generate_metric_plots, viz.export_indices = plots.metric_plots, plots.export_indices
        sink = ExportSink(False)
        video_io.export_video = sink
        try:
            for backbone in BACKBONES:
                cfg = backbone_cfg(backbone)
                work = os.path.join(root, f"work_{backbone}")
                cfg_path = os.path.join(root, f"{backbone}.json")
                cfg.save(cfg_path)
                state = create_train_state(seed, cfg, device="cpu")
                save_checkpoint(cli._artifact_paths(work, True)["ckp_dir"], state, cfg, tag="opt")
                t0 = time.perf_counter()
                rc = drive(f"infer_{backbone}", ["fused_preprocess_frames", "fused_fusion_mlp"],
                           lambda: cli.main(["infer", video, "--config", cfg_path, "--workdir", work]),
                           launches_by_path)
                rec = {"infer_s": time.perf_counter() - t0}
                require(rc == 0, f"14c: infer with the {backbone} backbone exited {rc}")
                p, s = weights.from_jax(*weights.init_params(cfg, seed))
                direct = summarize(fuse(p, s, extract_features(raw[::skip], waveform, cfg), cfg),
                                   uniform_clip_intervals(cfg, full_n), skip, full_n, cfg.knapsack)
                require(np.array_equal(sink.frames, chosen_frames(raw, direct.clip_intervals)),
                        f"14c: infer with the {backbone} backbone exported other frames than the direct path")
                rec["exported_frames"] = int(len(sink.frames))
                args = ["--videos", *data["videos"], "--annotation-fp", data["annotation_fp"], "--mat-fp",
                        data["mat_fp"], "--h5-fp", data["h5_fp"], "--info-fp", data["info_fp"], "--workdir",
                        os.path.join(root, f"train_{backbone}"), "--config", cfg_path]
                for verb, argv in (("train", ["train", *args, "--epochs", "1"]), ("eval", ["eval", *args])):
                    buf = io.StringIO()
                    t0 = time.perf_counter()
                    with contextlib.redirect_stdout(buf):
                        rc = drive(f"{verb}_{backbone}", ["fused_preprocess_frames", "fused_fusion_mlp"],
                                   lambda: cli.main(argv), launches_by_path)
                    rec[f"{verb}_s"] = time.perf_counter() - t0
                    require(rc == 0 and "Operation completed" in buf.getvalue(), f"14c: {verb} with the {backbone} "
                                                                                 f"backbone exited {rc}")
                    rec[f"{verb}_lines"] = [ln for ln in buf.getvalue().splitlines()
                                            if ln.startswith(("[eval]", "Optimal"))]
                require_not_launched(f"train_{backbone}", TRUNK, launches_by_path)
                t0 = time.perf_counter()
                dcfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, dropout_rate=0.0))
                item = dataset_io.build_video_item(data["videos"][0], dcfg, data["annotation_fp"], AnnotationStand(),
                                                   True)
                rec["first_grads"] = first_grads_against_cpu(dcfg, item, seed, f"14c {backbone}")
                rec["first_grads_s"] = time.perf_counter() - t0
                out[backbone] = rec
                print(f"phase 14c: infer, train and eval with the {backbone} backbone on {smi}: {json.dumps(rec)}",
                      flush=True)
        finally:
            video_io.export_video = sink.writer
            dataset_io.AnnotationStore = store
            viz.generate_metric_plots, viz.export_indices = saved
    return out


def backbone_serving_check(seed: int, smi: str, launches_by_path: dict, videos: list[dict]) -> dict:
    """14d and 14e: for each backbone the ``Summarizer`` and one ``DynamicBatcher`` request against the path
    scored directly; then ``Spotter.spot_frames`` over phase 5's match with the resnet backbone and a
    full-window transformer head (``configs/tpu_spotting.json`` with ``temporal_window = 0``: kernel 5 through
    ``serve.py``), with the vit backbone and the default GRU head (``reference_parity.json``) and with the
    resnet backbone under int8 and the banded head (``configs/tpu_spotting.json``: kernel 7), each against the
    path run directly and its trunk against the CPU on 64 frames."""
    from cvml_goalnet_tpu_torch.serve import DynamicBatcher, Spotter, Summarizer

    out = {}
    v = videos[0]
    n = LOWP_BATCH_REQUEST
    for backbone in BACKBONES:
        cfg = backbone_cfg(backbone)
        summ = Summarizer(cfg, state=create_train_state(seed, cfg))
        summ.warmup(((16, *RAW_HW),))
        res = drive(f"serve_{backbone}_summarizer", ["fused_preprocess_frames", "fused_fusion_mlp"],
                    lambda: summ.summarize_frames("v", v["frames"], v["intervals"], v["full_n"], v["waveform"]),
                    launches_by_path)
        p, s = summ.state.params, summ.state.model_state
        direct = fuse(p, s, extract_features(v["frames"], v["waveform"], cfg), cfg)
        serr = float(np.abs(res.scores - direct).max())
        require(serr <= 1e-5, f"14d: the {backbone} Summarizer {serr} from the direct path (> 1e-5)")
        wave = v["waveform"][: n * v["per_frame"]]
        batcher = DynamicBatcher(summ)
        try:
            req = drive(f"serve_{backbone}_batcher", ["fused_fusion_mlp"],
                        lambda: batcher.submit("r", v["frames"][:n], waveform=wave).result(), launches_by_path)
        finally:
            batcher.close()
        pad = batcher._bucket(n) - n
        vis = preprocess_frames_host(v["frames"][:n], cfg.preprocess.frame_size, cfg.preprocess.eps)
        aud = extract_audio_features(wave, n, cfg.audio, torch.device("cuda"))
        want = fuse(p, s, {"visual": np.concatenate([vis, np.zeros((pad,) + vis.shape[1:], vis.dtype)]),
                           "audio": torch.cat([aud, aud.new_zeros((pad,) + tuple(aud.shape[1:]))])}, cfg)[:n]
        berr = float(np.abs(req.scores - want).max())
        require(berr <= 1e-5, f"14d: the {backbone} batcher's scores {berr} from its bucket scored directly")
        out[backbone] = {"summarizer_max_abs_err": serr, "batcher_bucket": batcher._bucket(n),
                         "batcher_max_abs_err": berr}
        print(f"phase 14d: {backbone} Summarizer and batcher on {smi}: {json.dumps(out[backbone])}", flush=True)

    match = make_match(PipelineConfig.load(str(REPO / "configs" / "tpu_spotting.json")), seed)
    banded = backbone_cfg("resnet", "int8", base="tpu_spotting.json")
    full = dataclasses.replace(banded, model=dataclasses.replace(banded.model, temporal_window=0,
                                                                 quantized_inference=False))
    m = CPU_CHECK_FRAMES
    for label, scfg, head_kernel in (("serve_spotter_resnet_full", full, ["flash_fwd"]),
                                     ("serve_spotter_vit_gru", backbone_cfg("vit"), []),
                                     ("serve_spotter_resnet_int8_banded", banded, ["flash_local_fwd"])):
        sp = Spotter(scfg, state=create_train_state(seed, scfg))
        sp.warmup(64)
        t0 = time.perf_counter()
        got = drive(label, ["fused_preprocess_frames", *head_kernel],
                    lambda: sp.spot_frames("match", match["frames"], match["full_n"], match["waveform"]),
                    launches_by_path)
        wall = time.perf_counter() - t0
        others = tuple(k for k in ("flash_fwd", "flash_local_fwd") if k not in head_kernel)
        require_not_launched(label, TRUNK + others + ("fused_conv_pool_stage_int8",), launches_by_path)
        feats = extract_features(match["frames"], match["waveform"], scfg)
        enc = encode_timeline(sp.state.params, sp.state.model_state, feats["visual"], feats["audio"], scfg)
        scores = score_timeline_auto(sp.temporal_params, enc, scfg).cpu().numpy()
        tol = score_tolerance(scores)
        err = float(np.abs(got.scores - scores).max())
        require(err <= tol, f"14e: {label} scores max |err| {err} > {tol}")
        near = compare_events(got.scores, scores, tol)
        encs, codes = [], []   # the first 64 frames alone on both sides: under int8 the scale spans the batch
        for dev, st in ((None, sp.state), ("cpu", create_train_state(seed, scfg, device="cpu"))):
            f = extract_features(match["frames"][:m], match["waveform"][: m * match["per_frame"]], scfg, device=dev)
            with int8_records() as (c, _):
                encs.append(encode_timeline(st.params, st.model_state, f["visual"], f["audio"], scfg, device=dev).cpu())
            codes.append(c)
        rel = float(((encs[0] - encs[1]).abs().max() / encs[1].abs().max()).item())
        out[label] = {"max_abs_err": err, "tolerance": tol, "near_tie_events": near, "events": len(got.events),
                      "trunk_rel": rel, "spot_frames_s": wall, "temporal_model": scfg.model.temporal_model,
                      "temporal_window": scfg.model.temporal_window}
        if scfg.model.quantized_inference:
            # reported, not held to 1e-4: the int8 codes that part at a rounding boundary (cuDNN's and the CPU's
            # float sums before the first quantization) move later codes too, through the 12 points
            out[label]["int8_code_flips"] = [int((a != b).sum()) for a, b in zip(*codes)]
        else:
            require(rel <= 1e-4, f"14e: {label} trunk card vs CPU {rel} relative (> 1e-4)")
        print(f"phase 14e: {label} on {smi}: {json.dumps(out[label])}", flush=True)
    return out


def backbone_phase(seed: int, smi: str, launches_by_path: dict, videos: list[dict]) -> None:
    """Phase 14: the resnet and vit backbones at ``reference_parity.json``'s widths (resnet 64/256/512 with the
    ImageNet stem at 40×40; vit patch 8, 25 tokens, d = 192, depth 4, 4 heads) in float32, bf16, int8 and
    bf16 + int8, through the videos, the verbs and the services."""
    t_phase = time.perf_counter()
    backbone_videos_check(seed, smi, launches_by_path, videos)
    backbone_verbs_check(seed, smi, launches_by_path)
    backbone_serving_check(seed, smi, launches_by_path, videos)
    print(f"phase 14: {time.perf_counter() - t_phase:.1f} s wall", flush=True)




# ---------------------------------------------------------------- phases 15-17: checkpoint verbs, DP serving, DP training

DP_GLOBAL_BATCH = 64           # `train --dp --global-batch`: 16 frames a rank on four cards
DP_SERVE_VIDEO_FRAMES = 1_800  # raw 180×320 frames of phase 16's `serve --dp -1` request (60 condensed)
RANK_COUNTS_ENV = "GOALNET_SMOKE_RANK_COUNTS"   # where phase 17's spawned ranks write their launch counts
RANK_GRADS_ENV = "GOALNET_SMOKE_RANK_GRADS"     # set: rank 0 also writes its first step's reduced gradients


def reference_state_dict(cfg: PipelineConfig, seed: int) -> dict:
    """Seeded reference-format weights (``visbl.*``, ``audbl.*``, ``fusion.*``: the reference's ``state_dict()``
    schema) at ``cfg``'s widths, as ``tests/test_torch_reference_checkpoints.py`` draws them."""
    from cvml_goalnet_tpu_torch.models.audio import audio_temporal_trace
    from cvml_goalnet_tpu_torch.models.visual import visual_spatial_trace

    rng = np.random.default_rng(seed)
    m, pre, aud = cfg.model, cfg.preprocess, cfg.audio
    f32 = lambda shape, scale: (rng.standard_normal(shape) * scale).astype(np.float32)   # noqa: E731
    sd = {}
    chans = (3,) + m.vis_channels
    for i, (cin, cout) in enumerate(zip(chans[:-1], chans[1:]), start=1):
        sd[f"visbl.conv{i}.weight"] = f32((cout, cin, 3, 3), 1.0 / np.sqrt(9 * cin))
        sd[f"visbl.conv{i}.bias"] = f32(cout, 0.1)
        sd[f"visbl.bnorm{i}.weight"] = (rng.random(cout) + 0.5).astype(np.float32)
        sd[f"visbl.bnorm{i}.bias"] = f32(cout, 0.1)
        sd[f"visbl.bnorm{i}.running_mean"] = f32(cout, 0.1)
        sd[f"visbl.bnorm{i}.running_var"] = (rng.random(cout) + 0.5).astype(np.float32)
        sd[f"visbl.bnorm{i}.num_batches_tracked"] = np.asarray(0, np.int64)
    h, w = visual_spatial_trace(pre.frame_size, len(m.vis_channels))[-1]
    flat = m.vis_channels[-1] * h * w
    sd["visbl.linear5.weight"] = f32((m.vis_feature_dim, flat), 1.0 / np.sqrt(flat))
    sd["visbl.linear5.bias"] = f32(m.vis_feature_dim, 0.1)
    achans = (aud.n_mfcc,) + m.aud_channels
    for i, (cin, cout) in enumerate(zip(achans[:-1], achans[1:]), start=1):
        sd[f"audbl.conv{i}.weight"] = f32((cout, cin, 3), 1.0 / np.sqrt(3 * cin))
        sd[f"audbl.conv{i}.bias"] = f32(cout, 0.1)
    t = audio_temporal_trace(aud.bin_length, len(m.aud_channels))[-1]
    sd["audbl.linear3.weight"] = f32((m.aud_feature_dim, m.aud_channels[-1] * t), 1.0 / np.sqrt(m.aud_channels[-1] * t))
    sd["audbl.linear3.bias"] = f32(m.aud_feature_dim, 0.1)
    dims = (m.vis_feature_dim + m.aud_feature_dim,) + m.fusion_hidden + (1,)
    for li, (din, dout) in enumerate(zip(dims[:-1], dims[1:])):
        sd[f"fusion.{3 * li}.weight"] = f32((dout, din), 1.0 / np.sqrt(din))
        sd[f"fusion.{3 * li}.bias"] = f32(dout, 0.1)
    return sd


class FuseSpy:
    """Wraps ``pipeline.fuse`` as the CLI calls it (``cmd_infer`` imports it at call time): keeps the scores."""

    def __init__(self):
        import cvml_goalnet_tpu_torch.pipeline as pipeline_module

        self.module, self.fn, self.scores = pipeline_module, pipeline_module.fuse, []

    def __call__(self, *args, **kw):
        out = self.fn(*args, **kw)
        self.scores.append(np.asarray(out).copy())
        return out

    def __enter__(self):
        self.module.fuse = self
        return self

    def __exit__(self, *exc):
        self.module.fuse = self.fn


class CardLaunches:
    """Counts the launch scopes each card enters (``ops/cuda/_build.on_device``, which every wrapper enters once
    around each launch of its kernel): where a data-parallel path's launches went."""

    def __init__(self):
        self.by_card: dict[int, int] = {}
        self.real = _build.on_device

    def _spy(self, t):
        self.by_card[t.device.index] = self.by_card.get(t.device.index, 0) + 1
        return self.real(t)

    def __enter__(self):
        _build.on_device = self._spy
        return self

    def __exit__(self, *exc):
        _build.on_device = self.real


def npz_arrays(path: str) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def checkpoint_verbs_phase(seed: int, smi: str, launches_by_path: dict) -> None:
    """Phase 15: ``import-torch`` of a reference-format ``.pt`` at the width of
    ``configs/reference_parity.json``, ``infer`` on the card from the imported trunk (kernels 1–4; scores against
    the same path on the CPU), ``export-torch`` (bit-equal to the ``.pt``) and its re-import (bit-equal npz)."""
    from cvml_goalnet_tpu_torch.compat import import_reference_state_dict

    os.environ.pop("GOALNET_PLATFORM", None)   # the CLI runs on the card, as a user's call would
    t_phase = time.perf_counter()
    cfg = PipelineConfig.load(str(REPO / "configs" / "reference_parity.json"))
    out = {}
    with tempfile.TemporaryDirectory() as root:
        inp = make_infer_inputs(cfg, seed, root)
        raw, video, cfg_path = inp["raw"], inp["video"], inp["cfg_path"]
        sd = reference_state_dict(cfg, seed + 1500)
        pt = os.path.join(root, "reference.pt")
        torch.save({k: torch.as_tensor(v) for k, v in sd.items()}, pt)
        work = os.path.join(root, "imported")
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["import-torch", pt, "--config", cfg_path, "--workdir", work])
        out["import_s"] = time.perf_counter() - t0
        require(rc == 0 and "Operation completed" in buf.getvalue(), f"15: import-torch exited {rc}")
        ckp_dir = cli._artifact_paths(work, True)["ckp_dir"]
        require(sorted(os.listdir(ckp_dir)) == ["ckp_manifest.json", "ckp_state.npz", "opt_manifest.json",
                                                "opt_state.npz"], f"15: import-torch wrote {os.listdir(ckp_dir)}")

        sink = ExportSink(False)
        video_io.export_video = sink
        try:
            with FuseSpy() as spy, contextlib.redirect_stdout(io.StringIO()):
                t0 = time.perf_counter()
                rc = drive("import_torch_infer", ["fused_preprocess_frames", *TRUNK, "fused_fusion_mlp"],
                           lambda: cli.main(["infer", video, "--config", cfg_path, "--workdir", work]),
                           launches_by_path)
                out["infer_s"] = time.perf_counter() - t0
        finally:
            video_io.export_video = sink.writer
        require(rc == 0 and len(spy.scores) == 1, f"15: infer from the imported trunk exited {rc}")
        skip, full_n = cfg.preprocess.skip_frames, len(raw)
        p, s = import_reference_state_dict(sd, cfg.model, cfg.preprocess, cfg.audio, device="cpu")
        waveform, _ = load_waveform(video[:-4] + ".wav", cfg.audio.sample_rate)
        cpu_scores = fuse(p, s, extract_features(raw[::skip], waveform, cfg, device="cpu"), cfg, device="cpu")
        direct = summarize(cpu_scores, uniform_clip_intervals(cfg, full_n), skip, full_n, cfg.knapsack, device="cpu")
        card = spy.scores[0]
        out["card_vs_cpu_max_abs_err"] = float(np.abs(card - cpu_scores).max())
        require(out["card_vs_cpu_max_abs_err"] <= 1e-4,
                f"15: infer's scores from the imported trunk are {out['card_vs_cpu_max_abs_err']} from the CPU's")
        flips = rounding_flips(cpu_scores, card, 1e-4)
        same = bool(np.array_equal(sink.frames, chosen_frames(raw, direct.clip_intervals)))
        require(same or flips, "15: infer exported other frames than the CPU path, with no score at a boundary")
        out.update({"scores": int(len(card)), "score_range": [float(card.min()), float(card.max())],
                    "exported_frames": int(len(sink.frames)), "selection_equal_to_cpu": same, "rounding_flips": flips})

        exported = os.path.join(root, "exported.pt")
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            rc = cli.main(["export-torch", exported, "--config", cfg_path, "--workdir", work])
        out["export_s"] = time.perf_counter() - t0
        require(rc == 0, f"15: export-torch exited {rc}")
        back = torch.load(exported, map_location="cpu", weights_only=True)
        require(sorted(back) == sorted(sd), "15: export-torch wrote other keys than the reference's")
        for k, v in sd.items():
            require(back[k].numpy().dtype == v.dtype and np.array_equal(back[k].numpy(), v),
                    f"15: export-torch's {k} is not the imported array bit for bit")
        again = os.path.join(root, "reimported")
        with contextlib.redirect_stdout(io.StringIO()):
            rc = cli.main(["import-torch", exported, "--config", cfg_path, "--workdir", again])
        require(rc == 0, f"15: the re-import exited {rc}")
        first = npz_arrays(os.path.join(ckp_dir, "opt_state.npz"))
        second = npz_arrays(os.path.join(cli._artifact_paths(again, True)["ckp_dir"], "opt_state.npz"))
        require(sorted(first) == sorted(second) and all(np.array_equal(first[k], second[k]) for k in first),
                "15: the re-imported checkpoint is not the first import bit for bit")
        out["round_trip"] = {"keys": len(sd), "bit_exact": True}
    print(f"phase 15: import-torch → infer → export-torch → import-torch at reference_parity width on {smi}: "
          f"{json.dumps(out)}; {time.perf_counter() - t_phase:.1f} s wall", flush=True)


def dp_serving_phase(seed: int, smi: str, launches_by_path: dict, videos: list[dict]) -> dict:
    """Phase 16: ``Summarizer`` and ``Spotter`` over ``serving_mesh(-1)`` (every visible card) against the
    single-device services on phase 1's videos and phase 5's match, with the launch scopes per card, then
    ``serve --dp -1`` answering one ``/summarize``."""
    from cvml_goalnet_tpu_torch.parallel.mesh import serving_mesh
    from cvml_goalnet_tpu_torch.serve import Spotter, Summarizer

    os.environ.pop("GOALNET_PLATFORM", None)
    t_phase = time.perf_counter()
    mesh = serving_mesh(-1)
    out = {"mesh": [str(d) for d in mesh]}
    cfg = PipelineConfig.load(str(REPO / "configs" / "reference_parity.json"))
    state = create_train_state(seed, cfg)
    base, dp = Summarizer(cfg, state=state), Summarizer(cfg, state=state, mesh=mesh)
    per_video = []
    for i, v in enumerate(videos):
        args = (f"v{i}", v["frames"], v["intervals"], v["full_n"], v["waveform"])
        want = base.summarize_frames(*args)
        with CardLaunches() as cards:
            got = drive(f"serve_dp_summarize_{i}", ["fused_preprocess_frames", *TRUNK, "fused_fusion_mlp"],
                        lambda: dp.summarize_frames(*args), launches_by_path)
        flips = same_summary(got.scores, got.clips, want.scores, want.clips, 1e-5, f"16: video {i}")
        require(len(cards.by_card) == len(mesh), f"16: launches reached the cards {sorted(cards.by_card)}")
        per_video.append({"frames": len(v["frames"]), "max_abs_err": float(np.abs(got.scores - want.scores).max()),
                          "rounding_flips": flips, "launch_scopes_by_card": cards.by_card})
    out["summarizer"] = per_video
    # the serving preset's int8 (at float32, and with bf16): every block quantizes with the batch's activation
    # scale (its amax from the 2-int8 kernel, reduced over the blocks), so the mesh's scores are one card's
    from cvml_goalnet_tpu_torch.ops.cuda.fused_stage import act_scale_int8

    out["preset_int8"] = {}
    for mode, tol in (("int8", 1e-5), ("bf16_int8", 0.0625)):
        pcfg = preset_cfg(mode)
        pstate = create_train_state(seed, pcfg)
        v = videos[0]
        args = ("v0", v["frames"], v["intervals"], v["full_n"], v["waveform"])
        want = Summarizer(pcfg, state=pstate).summarize_frames(*args)
        scales = act_scale_int8.launches
        got = drive(f"serve_preset_dp_{mode}", ["fused_preprocess_frames", "fused_conv_pool_stage_int8"],
                    lambda: Summarizer(pcfg, state=pstate, mesh=mesh).summarize_frames(*args), launches_by_path)
        flips = same_summary(got.scores, got.clips, want.scores, want.clips, tol, f"16: preset {mode}")
        require(act_scale_int8.launches - scales == 2 * len(mesh), f"16: preset {mode}: "
                f"{act_scale_int8.launches - scales} amax launches over {len(mesh)} card(s), want 2 a card")
        out["preset_int8"][mode] = {"max_abs_err": float(np.abs(got.scores - want.scores).max()), "tol": tol,
                                    "rounding_flips": flips}
    walls = {"single": [], "mesh": []}
    for _ in range(2):
        for name, svc in (("single", base), ("mesh", dp)):
            t0 = time.perf_counter()
            for i, v in enumerate(videos):
                svc.summarize_frames(f"v{i}", v["frames"], v["intervals"], v["full_n"], v["waveform"])
            walls[name].append(time.perf_counter() - t0)
    out["three_videos_s"] = {k: percentiles(w) for k, w in walls.items()}

    match = make_match(PipelineConfig.load(str(REPO / "configs" / "tpu_spotting.json")), seed)
    spots = {}
    for label, window, kernel in (("banded", None, "flash_local_fwd"), ("full", 0, "flash_fwd")):
        scfg = PipelineConfig.load(str(REPO / "configs" / "tpu_spotting.json"))
        if window is not None:
            scfg = dataclasses.replace(scfg, model=dataclasses.replace(scfg.model, temporal_window=window))
        sstate = create_train_state(seed, scfg)
        one, many = Spotter(scfg, state=sstate), Spotter(scfg, state=sstate, mesh=mesh)
        many.temporal_params = one.temporal_params
        args = ("match", match["frames"], match["full_n"], match["waveform"])
        want = one.spot_frames(*args)
        with CardLaunches() as cards:
            t0 = time.perf_counter()
            got = drive(f"serve_dp_spotter_{label}", ["fused_preprocess_frames", *TRUNK, kernel],
                        lambda: many.spot_frames(*args), launches_by_path)
            wall = time.perf_counter() - t0
        tol = 1e-5 * max(1.0, float(np.abs(want.scores).max()))
        err = float(np.abs(got.scores - want.scores).max())
        require(err <= tol, f"16: the {label} Spotter on the mesh is {err} from one card's (> {tol})")
        near = compare_events(got.scores, want.scores, tol)
        require(near or np.array_equal(got.events, want.events), f"16: the {label} Spotter's events differ")
        turns = {"single": [], "mesh": []}
        for svc_name, svc in (("single", one), ("mesh", many), ("mesh", many), ("single", one)):
            t0 = time.perf_counter()
            svc.spot_frames(*args)
            turns[svc_name].append(time.perf_counter() - t0)
        spots[label] = {"max_abs_err": err, "events": len(got.events), "near_tie_events": near,
                        "summary_clips_equal": bool(np.array_equal(got.summary_clips, want.summary_clips)),
                        "first_mesh_call_s": wall, "spot_frames_s": {k: percentiles(v) for k, v in turns.items()},
                        "launch_scopes_by_card": cards.by_card}
    out["spotter"] = spots

    with tempfile.TemporaryDirectory() as root:
        media = os.path.join(root, "media")
        os.makedirs(media)
        target = os.path.join(media, "dp.npz")
        write_video(target, DP_SERVE_VIDEO_FRAMES, RAW_HW, seed + 1600, cfg)
        work = os.path.join(root, "work")
        save_checkpoint(cli._artifact_paths(work, True)["ckp_dir"], create_train_state(seed, cfg, device="cpu"), cfg,
                        tag="opt")
        cfg_path = os.path.join(root, "cfg.json")
        cfg.save(cfg_path)
        watch = PortWatch(sys.stdout)
        answers = {}

        def client():
            if watch.ready.wait(600):
                t0 = time.perf_counter()
                answers["summarize"] = http(watch.port, "/summarize", {"video": "dp.npz"})
                answers["wall_s"] = time.perf_counter() - t0

        c = threading.Thread(target=client)
        c.start()
        try:
            with CardLaunches() as cards, contextlib.redirect_stdout(watch):
                rc = drive("cli_serve_dp", ["fused_preprocess_frames", *TRUNK, "fused_fusion_mlp"],
                           lambda: cli.main(["serve", "--config", cfg_path, "--workdir", work, "--port", "0",
                                             "--media-root", media, "--dp", "-1", "--max-requests", "1"]),
                           launches_by_path)
        finally:
            watch.ready.set()
            c.join()
        require(rc == 0 and answers.get("summarize", (0,))[0] == 200, f"16: serve --dp -1 answered {answers}")
        require(f"dp={len(mesh)})" in watch.text, "16: serve --dp -1's banner does not name the mesh size")
        want = Summarizer(cfg, checkpoint_dir=cli._artifact_paths(work, True)["ckp_dir"]).summarize_path(target)
        reply = answers["summarize"][1]
        require(np.abs(np.asarray(reply["scores"]) - np.round(want.scores, 4)).max() <= 2e-4
                and reply["clips"] == want.clips.tolist(), "16: serve --dp -1 answered other scores or clips")
        out["cli_serve_dp"] = {"request_s": answers["wall_s"], "launch_scopes_by_card": cards.by_card,
                               "clips": len(reply["clips"])}
    print(f"phase 16: data-parallel serving over {len(mesh)} card(s) on {smi}: {json.dumps(out)}; "
          f"{time.perf_counter() - t_phase:.1f} s wall", flush=True)
    return out


def counted_train_rank(rank: int, world: int, device, job: dict):
    """``train/dp_loop.py``'s rank function, with every kernel's launch count set to 0 before it and read after,
    and each step's (global) loss kept; written as ``rank<r>.json`` under ``$GOALNET_SMOKE_RANK_COUNTS``.  With
    ``$GOALNET_SMOKE_RANK_GRADS`` set every rank also computes its first step's reduced gradients once more
    (``step.loss_and_grads``, a collective), and rank 0 writes them as ``grads.npz`` there.  The parent swaps it
    in for ``dp_loop._train_rank``; a spawned rank imports this script as its main module."""
    from cvml_goalnet_tpu_torch.parallel import dp
    from cvml_goalnet_tpu_torch.train import dp_loop

    losses, make = [], dp.make_dp_train_step
    counts_dir = os.environ[RANK_COUNTS_ENV]

    def counting(*a, **kw):
        step = make(*a, **kw)

        def run(*args, **kws):
            if os.environ.get(RANK_GRADS_ENV) and not losses:
                params, model_state, _, vis, aud, lab, gen = args[:7]
                _, _, grads = step.loss_and_grads(params, model_state, vis, aud, lab, gen, kws.get("text"))
                if rank == 0:
                    np.savez(os.path.join(counts_dir, "grads.npz"),
                             *[g.cpu().numpy() for g in tree_leaves(grads)])
            res = step(*args, **kws)
            losses.append(float(res[3]))
            return res

        return run

    dp.make_dp_train_step = counting
    for f, _, _ in KERNELS.values():
        f.launches = 0
    t0 = time.perf_counter()
    res = dp_loop._train_rank(rank, world, device, job)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    rec = {"rank": rank, "device": str(device), "wall_s": time.perf_counter() - t0, "step_losses": losses,
           "launches": {name: f.launches for name, (f, _, _) in KERNELS.items() if f.launches}}
    with open(os.path.join(counts_dir, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)
    return res


@contextlib.contextmanager
def fd_stdout(path: str):
    """File descriptor 1 (and ``sys.stdout``) into ``path`` for the scope, so what spawned processes print is
    kept too; restored after."""
    sys.stdout.flush()
    saved = os.dup(1)
    with open(path, "w") as f:
        os.dup2(f.fileno(), 1)
    try:
        with open(1, "w", closefd=False) as fd1, contextlib.redirect_stdout(fd1):
            yield
            fd1.flush()
    finally:
        os.dup2(saved, 1)
        os.close(saved)


def dp_train_run(argv: list[str], counts_dir: str, label: str, launches_by_path: dict) -> tuple[str, list[dict]]:
    """``cli.main(argv)`` (a ``train --dp``) with :func:`counted_train_rank` as the ranks' function → (its output
    and its ranks', each rank's record)."""
    from cvml_goalnet_tpu_torch.train import dp_loop

    os.makedirs(counts_dir, exist_ok=True)
    os.environ[RANK_COUNTS_ENV] = counts_dir
    real, dp_loop._train_rank = dp_loop._train_rank, counted_train_rank
    log = os.path.join(counts_dir, "stdout.txt")
    try:
        with fd_stdout(log):
            rc = drive(label, ["fused_preprocess_frames"], lambda: cli.main(argv), launches_by_path)
    finally:
        dp_loop._train_rank = real
    with open(log) as f:
        text = f.read()
    print(text, end="", flush=True)
    require(rc == 0 and "Operation completed" in text, f"{label}: exit code {rc}")
    ranks = []
    for name in sorted(os.listdir(counts_dir)):
        if name.startswith("rank") and name.endswith(".json"):
            with open(os.path.join(counts_dir, name)) as f:
                ranks.append(json.load(f))
    return text, sorted(ranks, key=lambda r: r["rank"])


def global_batch_loss(cfg: PipelineConfig, state, pool: dict, idx: np.ndarray, device) -> float:
    """The train forward's mean squared error on the global batch ``idx`` on one device: the loss a
    data-parallel step reports before its update."""
    from cvml_goalnet_tpu_torch.models.avm import avm_train_apply

    def rows(key):
        x = pool[key]
        return None if x is None else torch.as_tensor(x[idx]).to(device)

    with torch.no_grad(), strict_f32():
        preds, _ = avm_train_apply(state.params, state.model_state, rows("visual"), rows("audio"), None,
                                   cfg=cfg.model)
        return float(torch.mean(torch.square(preds[:, 0] - rows("labels"))))


def dp_training_phase(seed: int, smi: str, launches_by_path: dict, one_rank_too: bool = False) -> dict:
    """Phase 17: ``train --dp --epochs 1`` over every visible card on NCCL, one spawned rank per card, at the width
    of ``configs/reference_parity.json`` (dropout 0) on phase 10's videos, from a seeded ``ckp``; rank 0's
    evaluation on its card (kernels 2–4) and first-step loss against the single-device global-batch loss.
    ``one_rank_too``: the same run again with ``mesh.data = 1`` (one rank on the first card), every step's loss
    and the walls beside the mesh's (``tools/dp_four_cards.py``)."""
    from cvml_goalnet_tpu_torch.data.dataset import build_datasets
    from cvml_goalnet_tpu_torch.parallel.launch import backend_of
    from cvml_goalnet_tpu_torch.parallel.mesh import build_mesh
    from cvml_goalnet_tpu_torch.train.dp_loop import pool_dataset

    os.environ.pop("GOALNET_PLATFORM", None)
    t_phase = time.perf_counter()
    base = PipelineConfig.load(str(REPO / "configs" / "reference_parity.json"))
    cfg = dataclasses.replace(base, model=dataclasses.replace(base.model, dropout_rate=0.0))
    if one_rank_too:
        # Adam's eps at 1e-4, as the CPU tests set it: at 1e-8 an entry whose gradient is rounding noise moves by
        # lr either way, and two runs that sum in other orders part within a few steps (PERF.md §6)
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, eps=1e-4))
        os.environ[RANK_GRADS_ENV] = "1"
    mesh = build_mesh(cfg.mesh)
    out = {"ranks": len(mesh), "backend": backend_of(mesh), "global_batch": DP_GLOBAL_BATCH}
    with tempfile.TemporaryDirectory() as root:
        data = make_train_inputs(cfg, seed, root)
        cfg_path = os.path.join(root, "cfg.json")
        cfg.save(cfg_path)
        work = os.path.join(root, "work")
        ckp_dir = cli._artifact_paths(work, True)["ckp_dir"]
        start = create_train_state(seed, cfg, device="cpu")
        save_checkpoint(ckp_dir, start, cfg, tag="ckp")
        store = dataset_io.AnnotationStore
        dataset_io.AnnotationStore = AnnotationStand
        try:
            args = ["--videos", *data["videos"], "--annotation-fp", data["annotation_fp"], "--mat-fp",
                    data["mat_fp"], "--h5-fp", data["h5_fp"], "--info-fp", data["info_fp"], "--config", cfg_path,
                    "--workdir", work]
            t0 = time.perf_counter()
            text, ranks = dp_train_run(["train", *args, "--dp", "--global-batch", str(DP_GLOBAL_BATCH),
                                        "--epochs", "1", "--checkpoint"], os.path.join(root, "counts"),
                                       "train_dp", launches_by_path)
            out["train_dp_s"] = time.perf_counter() - t0
            train_ds, _ = build_datasets(data["videos"], cfg, data["annotation_fp"], data["mat_fp"], data["h5_fp"],
                                         data["info_fp"], audio_included=True)
        finally:
            dataset_io.AnnotationStore = store
        require(re.search(r"^\[dp epoch 0\] train loss [\d.]+ val loss [\d.]+ F-avg [\d.]+$", text, re.M)
                is not None, "17: train --dp printed no [dp epoch 0] line")
        require(len(ranks) == len(mesh) and [r["device"] for r in ranks] == [str(d) for d in mesh],
                f"17: the ranks ran on {[r['device'] for r in ranks]}")
        for name in TRUNK + ("fused_fusion_mlp",):
            require(ranks[0]["launches"].get(name, 0) > 0, f"17: rank 0's evaluation never launched {name}")
        for tag in ("ckp", "opt"):
            st = load_checkpoint(ckp_dir, create_train_state(seed, cfg, device="cpu"), tag=tag)
            require(st.epoch == 1 and st.opt_state.step == len(ranks[0]["step_losses"]),
                    f"17: {tag} holds epoch {st.epoch}, step {st.opt_state.step}")
        pool = pool_dataset(train_ds)
        n = len(pool["visual"])
        gb = min(DP_GLOBAL_BATCH, (n // len(mesh)) * len(mesh))
        first = np.random.default_rng(cfg.train.seed).permutation(n)[:gb]
        single = global_batch_loss(cfg, TrainState(*weights.from_jax(*weights.init_params(cfg, seed)), None, 0), pool,
                                   first, mesh[0])
        got = ranks[0]["step_losses"][0]
        require(all(r["step_losses"] == ranks[0]["step_losses"] for r in ranks), "17: the ranks' losses differ")
        err = abs(got - single)
        require(err <= 1e-4 * max(1.0, abs(single)), f"17: rank 0's first-step loss {got} vs one card's {single}")
        out.update({"pooled_frames": n, "steps": len(ranks[0]["step_losses"]), "first_step_loss": got,
                    "single_device_loss": single, "first_step_abs_err": err,
                    "rank_walls_s": [r["wall_s"] for r in ranks],
                    "rank_launches": {r["device"]: r["launches"] for r in ranks},
                    "epoch_line": [ln for ln in text.splitlines() if ln.startswith("[dp epoch")]})
        if one_rank_too:
            one_cfg = dataclasses.replace(cfg, mesh=dataclasses.replace(cfg.mesh, data=1))
            one_path = os.path.join(root, "one.json")
            one_cfg.save(one_path)
            one_work = os.path.join(root, "one_work")
            save_checkpoint(cli._artifact_paths(one_work, True)["ckp_dir"], start, one_cfg, tag="ckp")
            dataset_io.AnnotationStore = AnnotationStand
            try:
                argv = ["train", *args[:-4], "--config", one_path, "--workdir", one_work, "--dp", "--global-batch",
                        str(DP_GLOBAL_BATCH), "--epochs", "1", "--checkpoint"]
                t0 = time.perf_counter()
                one_text, one_ranks = dp_train_run(argv, os.path.join(root, "one_counts"), "train_dp_one_rank",
                                                   launches_by_path)
                out["one_rank_train_dp_s"] = time.perf_counter() - t0
            finally:
                dataset_io.AnnotationStore = store
            os.environ.pop(RANK_GRADS_ENV, None)
            a, b = np.asarray(ranks[0]["step_losses"]), np.asarray(one_ranks[0]["step_losses"])
            require(len(one_ranks) == 1 and a.shape == b.shape, f"17: one rank ran {b.shape} steps, the mesh {a.shape}")
            rel = np.abs(a - b) / np.maximum(np.abs(b), 1.0)
            g_mesh = list(npz_arrays(os.path.join(root, "counts", "grads.npz")).values())
            g_one = list(npz_arrays(os.path.join(root, "one_counts", "grads.npz")).values())
            g_scale = max(float(np.abs(g).max()) for g in g_one)
            g_err = max(float(np.abs(x - y).max()) for x, y in zip(g_mesh, g_one)) / g_scale
            require(g_err <= 1e-4, f"17: the mesh's first-step gradients are {g_err} of max|g| from one rank's")
            require(rel[0] <= 1e-4 and rel.max() <= 1e-2, f"17: the mesh's step losses {a} vs one rank's {b}")
            out["one_rank"] = {"adam_eps": cfg.train.eps, "step_losses": b.tolist(), "mesh_step_losses": a.tolist(),
                               "first_step_grads_err_of_max": g_err, "grads_max": g_scale,
                               "max_rel_diff": float(rel.max()), "first_step_rel_diff": float(rel[0]),
                               "rank_wall_s": one_ranks[0]["wall_s"],
                               "epoch_line": [ln for ln in one_text.splitlines() if ln.startswith("[dp epoch")]}
    print(f"phase 17: train --dp over {len(mesh)} card(s) on {out['backend']} on {smi}: {json.dumps(out)}; "
          f"{time.perf_counter() - t_phase:.1f} s wall", flush=True)
    return out


CP_SHARDS = 4                   # phase 18a: virtual shards of the match on the one card
CP_RANK_COUNTS_ENV = "GOALNET_SMOKE_CP_COUNTS"   # where phase 18b's spawned rank writes its launch counts
CP_EPOCHS = 2                   # phase 18b: `spot-train --epochs`, one step an epoch (one match)
CP_MASKED_VALID = 2000          # phase 18a: a true length that leaves the last two virtual shards no valid key


def halo_extended(xs: list, me: int, window: int) -> torch.Tensor:
    """Shard ``me``'s extended keys (or values) from a list of shards (H, Tl, d): the previous shard's last
    ``window`` frames, its own, the next shard's first ``window`` (wrapping round at the two ends)."""
    n, tl = len(xs), xs[me].shape[1]
    return torch.cat([xs[(me - 1) % n][:, tl - window:], xs[me], xs[(me + 1) % n][:, :window]], dim=1)


def cp_virtual_case(t: int, window: int | None, gen: torch.Generator, launches_by_path: dict,
                    t_valid: int | None = None) -> dict:
    """18a: ring (``window`` None) or halo attention of one (1, t, 128) q, k, v cut into ``CP_SHARDS`` virtual
    shards on the one card (t padded to a multiple, keys from ``t_valid``, default t, on masked), forward and
    backward through the port's hop math (``parallel/ring_attention.py``, ``parallel/halo_attention.py``),
    against the monolithic kernels 5-8 on the same q, k, v: every value finite, outputs and lse within
    1e-5·max(1, max|out|), gradients within 1e-4·max(1, max|g|); kernel 5 (7) launched n² (n) times in the
    forward, kernel 6 (8) as often in the backward.  A ``t_valid`` at most 2·t/n leaves the last shards with no
    valid key: ring hops at ``t_valid`` 0 and halo shards with empty bounds, as the verb's padded groups give."""
    from cvml_goalnet_tpu_torch.parallel.halo_attention import halo_bounds, halo_attention_shards
    from cvml_goalnet_tpu_torch.parallel.ring_attention import ring_attention_shards

    n, d = CP_SHARDS, 128
    q, k, v, g = (torch.randn((1, t, d), generator=gen, device="cuda") for _ in range(4))
    tl, tv = -(-t // n), t if t_valid is None else t_valid
    label = f"cp_virtual_{'ring' if window is None else 'halo'}_{t}" + ("" if tv == t else f"_valid{tv}")
    fwd, bwd = ("flash_fwd", "flash_bwd") if window is None else ("flash_local_fwd", "flash_local_bwd")
    leaves = [F.pad(x, (0, 0, 0, n * tl - t)).requires_grad_() for x in (q, k, v)]
    qs, ks, vs = ([x[:, i * tl:(i + 1) * tl] for i in range(n)] for x in leaves)

    def forward():
        with torch.enable_grad():
            if window is None:
                outs, lses = ring_attention_shards(qs, ks, vs, t_valid=tv)
                return torch.cat(outs, 1)[:, :t], torch.cat(lses, 1)[:, :t, 0]
            return torch.cat(halo_attention_shards(qs, ks, vs, window, t_valid=tv), 1)[:, :t], None

    t0 = time.perf_counter()
    out, lse = drive(f"{label}_fwd", [fwd], forward, launches_by_path)
    grads = drive(f"{label}_bwd", [bwd], lambda: torch.autograd.grad((out * g).sum(), leaves), launches_by_path)
    cp_ms = 1e3 * (time.perf_counter() - t0)
    want = n * n if window is None else n
    require(launches_by_path[f"{label}_fwd"][fwd] == want and launches_by_path[f"{label}_bwd"][bwd] == want,
            f"18a {label}: {launches_by_path[f'{label}_fwd'][fwd]} {fwd} and {launches_by_path[f'{label}_bwd'][bwd]} "
            f"{bwd} launches, want {want} each")
    mono = [x.clone().requires_grad_() for x in (q, k, v)]
    t0 = time.perf_counter()
    with torch.enable_grad():
        if window is None:
            m_out, m_lse = flash_attention_with_lse(*mono, tv)
            m_lse = m_lse[..., 0]
        else:
            m_out = flash_attention_local_bounded(*mono, 0, tv, window)
        m_grads = torch.autograd.grad((m_out * g).sum(), mono)
    torch.cuda.synchronize()
    mono_ms = 1e3 * (time.perf_counter() - t0)
    if window is not None:   # the halo's lse, shard by shard, through kernel 7's wrapper (not the path's launches)
        with torch.no_grad():
            lse = torch.cat([flash_local_fwd(qs[i], halo_extended(ks, i, window), halo_extended(vs, i, window),
                                             1 / d ** 0.5, window, *halo_bounds(i, n, tl, window, tv),
                                             q_offset=window)[1] for i in range(n)], 1)[:, :t]
            m_lse = flash_local_fwd(q, k, v, 1 / d ** 0.5, window, 0, tv)[1]
    out, m_out = out.detach(), m_out.detach()
    finite = all(bool(torch.isfinite(x).all()) for x in (out, lse, *grads))
    require(finite, f"18a {label}: a non-finite output, lse or gradient")
    scale = max(1.0, float(m_out.abs().max()))
    rec = {"t": t, "t_valid": tv, "shards": n, "shard_frames": tl, "finite": finite, "out_err": float((out - m_out).abs().max()) / scale,
           "lse_err": float((lse.detach() - m_lse.detach()).abs().max()) / scale,
           "grad_err": max(float((a[:, :t] - b).abs().max()) / max(1.0, float(b.abs().max()))
                           for a, b in zip(grads, m_grads)),
           "launches": {fwd: want, bwd: want}, "virtual_ms": cp_ms, "monolithic_ms": mono_ms}
    require(rec["out_err"] <= 1e-5 and rec["lse_err"] <= 1e-5 and rec["grad_err"] <= 1e-4,
            f"18a {label}: {json.dumps(rec)}")
    return rec


def counted_cp_rank(rank: int, world: int, device, job: dict):
    """``train/cp_loop.py``'s rank function with every kernel's launch count set to 0 before it and read after,
    written as ``cp_rank<r>.json`` under ``$GOALNET_SMOKE_CP_COUNTS``; the parent swaps it in for
    ``cp_loop._cp_rank`` (a spawned rank imports this script as its main module)."""
    from cvml_goalnet_tpu_torch.train import cp_loop

    for f, _, _ in KERNELS.values():
        f.launches = 0
    t0 = time.perf_counter()
    res = cp_loop._cp_rank(rank, world, device, job)
    torch.cuda.synchronize(device)
    rec = {"rank": rank, "wall_s": time.perf_counter() - t0,
           "launches": {name: f.launches for name, (f, _, _) in KERNELS.items()}}
    with open(os.path.join(os.environ[CP_RANK_COUNTS_ENV], f"cp_rank{rank}.json"), "w") as f:
        json.dump(rec, f)
    return res


def cp_verb_check(seed: int, smi: str, launches_by_path: dict, match: dict, root: str) -> dict:
    """18b: ``spot-train --cp`` through ``cli.main`` on one NCCL rank, banded and full, ``CP_EPOCHS`` epochs on
    phase 5's match (its 5400 frames written as a ``--no-audio`` video at ``skip_frames = 1``, seeded events),
    against the single-device ``spot-train`` from the same seed: every epoch's loss within 1e-4 relative, and
    the two saved heads scoring the match within 1e-4·max(1, max|s|)."""
    from cvml_goalnet_tpu_torch.train import cp_loop
    from cvml_goalnet_tpu_torch.train import spotting as train_spotting

    base = PipelineConfig.load(str(REPO / "configs" / "tpu_spotting.json"))
    cfg = dataclasses.replace(base, preprocess=dataclasses.replace(base.preprocess, skip_frames=1),
                              model=dataclasses.replace(base.model, audio_included=False))
    cfg_path, video = os.path.join(root, "cfg.json"), os.path.join(root, "match.npz")
    cfg.save(cfg_path)
    np.savez(video, frames=match["frames"])
    write_events(video, MATCH_FRAMES, 1, seed + 1800)
    counts_dir = os.path.join(root, "counts")
    os.makedirs(counts_dir)
    os.environ[CP_RANK_COUNTS_ENV] = counts_dir
    state = create_train_state(cfg.train.seed, cfg)
    feats = extract_features(match["frames"], None, cfg)
    enc = encode_timeline(state.params, state.model_state, feats["visual"], None, cfg)
    out = {}
    for label, window, kernels in (("banded", ATTN_WINDOW, ("flash_local_fwd", "flash_local_bwd")),
                                   ("full", 0, ("flash_fwd", "flash_bwd"))):
        heads, losses, walls = {}, {}, {}
        for mode in ("cp", "single"):
            head = os.path.join(root, f"{label}_{mode}.npz")
            argv = ["spot-train", "--videos", video, "--config", cfg_path, "--workdir", os.path.join(root, "work"),
                    "--no-audio", "--attn-window", str(window), "--epochs", str(CP_EPOCHS), "--out", head]
            kept = []
            if mode == "cp":
                real_rank, real_train = cp_loop._cp_rank, cp_loop.train_spotting_cp
                cp_loop._cp_rank = counted_cp_rank
                cp_loop.train_spotting_cp = lambda *a, **kw: kept.append(real_train(*a, **kw)) or kept[-1]
                expect, argv = ["fused_preprocess_frames", *TRUNK], [*argv, "--cp"]
            else:
                real_make = train_spotting.make_spotting_train_step

                def recording(*a, **kw):
                    step = real_make(*a, **kw)

                    def run(*args):
                        res = step(*args)
                        kept.append(float(res[2]))
                        return res

                    return run

                train_spotting.make_spotting_train_step = recording
                expect = ["fused_preprocess_frames", *TRUNK, *kernels]
            buf = io.StringIO()
            t0 = time.perf_counter()
            try:
                log = os.path.join(root, f"{label}_{mode}.txt")
                with fd_stdout(log):
                    rc = drive(f"cp_verb_{label}_{mode}", expect, lambda: cli.main(argv), launches_by_path)
                with open(log) as f:
                    buf.write(f.read())
            finally:
                if mode == "cp":
                    cp_loop._cp_rank, cp_loop.train_spotting_cp = real_rank, real_train
                else:
                    train_spotting.make_spotting_train_step = real_make
            walls[mode] = time.perf_counter() - t0
            text = buf.getvalue()
            require(rc == 0 and "Operation completed" in text and os.path.exists(head),
                    f"18b {label} {mode}: exit code {rc}: {text[-2000:]}")
            if mode == "cp":
                require("context-parallel over 1 devices" in text, f"18b: the layout line {text[-500:]}")
                with open(os.path.join(counts_dir, "cp_rank0.json")) as f:
                    rank = json.load(f)
                launches_by_path[f"cp_verb_{label}_rank0"] = rank["launches"]
                per = CP_EPOCHS * cfg.model.temporal_num_layers
                require(all(rank["launches"][k] == per for k in kernels),
                        f"18b {label}: the rank launched {rank['launches']}, want {per} of each of {kernels}")
                losses[mode] = [x for epoch in kept[0]["step_losses"] for x in epoch]
                out[f"{label}_rank_wall_s"] = rank["wall_s"]
            else:
                losses[mode] = kept
            tmpl = weights.init_temporal_params(
                dataclasses.replace(cfg.model, temporal_window=window), enc.shape[1], seed=1)
            heads[mode] = weights.tree_from_jax(weights.load_spotting_checkpoint(head, tmpl))
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses["cp"], losses["single"]))
        require(len(losses["cp"]) == len(losses["single"]) == CP_EPOCHS and rel <= 1e-4,
                f"18b {label}: losses {losses}")
        wcfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, temporal_window=window))
        with torch.no_grad():
            s_cp, s_one = (score_timeline_auto(heads[m], enc, wcfg).cpu().numpy() for m in ("cp", "single"))
        tol = 1e-4 * max(1.0, float(np.abs(s_one).max()))
        err = float(np.abs(s_cp - s_one).max())
        require(err <= tol, f"18b {label}: the two heads score the match {err} apart (> {tol})")
        out[label] = {"losses_cp": losses["cp"], "losses_single": losses["single"], "loss_max_rel_err": rel,
                      "head_scores_max_abs_err": err, "verb_walls_s": walls}
    return out, enc


def cp_in_process_check(seed: int, smi: str, launches_by_path: dict, enc: torch.Tensor, root: str) -> dict:
    """18c and 18d on one NCCL rank in this process: ``score_timeline_sharded`` against ``score_timeline_auto``
    (transformer banded and full; the GRU and the hybrid against the chunked single-device scorer), then the CP
    step's ms beside the single-device step's on the match's features (median of six, synchronised)."""
    import torch.distributed as dist

    from cvml_goalnet_tpu_torch.parallel.mesh import cp_groups
    from cvml_goalnet_tpu_torch.spotting import score_timeline_chunked, score_timeline_sharded
    from cvml_goalnet_tpu_torch.train.spotting import make_sharded_spotting_train_step

    dist.init_process_group("nccl", store=dist.FileStore(os.path.join(root, "store"), 1), rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    out = {"scores": {}, "steps": {}}
    try:
        groups = cp_groups(1, 1, 1)
        d = enc.shape[1]
        base = PipelineConfig.load(str(REPO / "configs" / "tpu_spotting.json"))
        gru = PipelineConfig.load(str(REPO / "configs" / "reference_parity.json"))
        # chunks that split the match (its 5400 frames are one window at the configs' 4096 + 2·256): five
        # chunks for the GRU, three for the hybrid
        chunk = MATCH_FRAMES // 5
        gru = dataclasses.replace(gru, model=dataclasses.replace(gru.model, temporal_chunk=chunk,
                                                                 temporal_halo=chunk // 16))
        hybrid = PipelineConfig.load(str(REPO / "configs" / "tpu_spotting_quality.json"))
        chunk = MATCH_FRAMES // 3
        hybrid = dataclasses.replace(hybrid, model=dataclasses.replace(hybrid.model, temporal_chunk=chunk,
                                                                       temporal_halo=chunk // 8))
        cases = (("banded", base, "flash_local_fwd"),
                 ("full", dataclasses.replace(base, model=dataclasses.replace(base.model, temporal_window=0)),
                  "flash_fwd"), ("gru", gru, None), ("hybrid", hybrid, "flash_local_fwd"))
        for label, cfg, kernel in cases:
            tp = weights.tree_from_jax(weights.init_temporal_params(cfg.model, d, seed))
            with torch.no_grad():
                got = drive(f"cp_sharded_score_{label}", [kernel] if kernel else [],
                            lambda: score_timeline_sharded(tp, enc, groups, cfg), launches_by_path).cpu().numpy()
                mc = cfg.model
                if label in ("banded", "full"):
                    want = score_timeline_auto(tp, enc, cfg).cpu().numpy()
                elif label == "gru":
                    want = score_timeline_chunked(tp, enc, mc.temporal_hidden, mc.temporal_chunk,
                                                  mc.temporal_halo).cpu().numpy()
                else:   # the hybrid's chunks one by one on one device, kept as the GRU's chunked scorer keeps them
                    want = hybrid_chunked(tp, enc, cfg)
            err = float(np.abs(got - want).max())
            tol = 1e-4 * max(1.0, float(np.abs(want).max()))
            require(got.shape == want.shape and err <= tol, f"18c {label}: sharded vs single {err} (> {tol})")
            out["scores"][label] = {"max_abs_err": err, "tol": tol}
        with tempfile.TemporaryDirectory() as tmp:
            labels = torch.as_tensor(synthetic_labels(enc.shape[0], 1, seed + 1900, tmp), device="cuda")
        for label, window in (("banded", ATTN_WINDOW), ("full", 0)):
            tp = weights.tree_from_jax(weights.init_temporal_params(
                dataclasses.replace(base.model, temporal_window=window), d, seed))
            cp_step = make_sharded_spotting_train_step(groups, base.model.temporal_num_heads, window=window)
            one_step = make_spotting_train_step(0, scorer="transformer", num_heads=base.model.temporal_num_heads,
                                                window=window)
            ms = {}
            for name, step in (("cp", cp_step), ("single", one_step), ("cp", cp_step), ("single", one_step)):
                _, losses, step_ms = train_steps(step, tp, enc, labels, steps=3)
                ms.setdefault(name, []).extend(step_ms)
            out["steps"][label] = {k: statistics.median(v) for k, v in ms.items()}
    finally:
        dist.destroy_process_group()
    return out


def hybrid_chunked(tp, enc: torch.Tensor, cfg: PipelineConfig) -> np.ndarray:
    """The hybrid's chunked scores on one device: windows of chunk + 2·halo clamped into the timeline, each
    scored alone, the chunk kept (``score_timeline_chunked``'s layout)."""
    from cvml_goalnet_tpu_torch.models.temporal_hybrid import temporal_hybrid_apply

    mc = cfg.model
    t, chunk, halo = enc.shape[0], mc.temporal_chunk, mc.temporal_halo
    window = chunk + 2 * halo
    starts = np.arange(-(-t // chunk)) * chunk
    outs = []
    for st in starts:
        ws = int(np.clip(st - halo, 0, t - window))
        s = temporal_hybrid_apply(tp, enc[ws:ws + window], mc.temporal_hidden, mc.temporal_num_heads,
                                  mc.temporal_window)
        outs.append(s[st - ws:st - ws + chunk])
    return torch.cat(outs)[:t].cpu().numpy()


def cp_phase(seed: int, smi: str, launches_by_path: dict, gen: torch.Generator) -> dict:
    """Phase 18: context-parallel spotting on the one card — (a) the ring's and the halo's hop math over
    ``CP_SHARDS`` virtual shards against kernels 5-8, (b) ``spot-train --cp`` on one NCCL rank against the
    single-device verb, (c) ``score_timeline_sharded`` against the single-device scorers, (d) the CP step's ms
    beside the single-device step's."""
    t_phase = time.perf_counter()
    cp_virtual_case(MATCH_FRAMES, None, gen, {})   # warm-up: the first autograd pass through the hops
    # the last two: a true length of 2000 frames leaves shards 2 and 3 of 1350 with no valid key
    out = {"virtual": [cp_virtual_case(t, w, gen, launches_by_path, tv)
                       for t, tv in ((MATCH_FRAMES, None), (MATCH_FRAMES - 1, None), (MATCH_FRAMES, CP_MASKED_VALID))
                       for w in (None, ATTN_WINDOW)]}
    print(f"phase 18a: ring and halo over {CP_SHARDS} virtual shards vs kernels 5-8 on {smi}: "
          f"{json.dumps(out['virtual'])}", flush=True)
    match = make_match(PipelineConfig.load(str(REPO / "configs" / "tpu_spotting.json")), seed)
    with tempfile.TemporaryDirectory() as root:
        out["verb"], enc = cp_verb_check(seed, smi, launches_by_path, match, root)
        print(f"phase 18b: spot-train --cp on one NCCL rank vs one device on {smi}: {json.dumps(out['verb'])}",
              flush=True)
        out.update(cp_in_process_check(seed, smi, launches_by_path, enc, root))
    print(f"phase 18c: score_timeline_sharded on one rank vs one device: {json.dumps(out['scores'])}", flush=True)
    print(f"phase 18d: CP step vs single-device step, median ms over 6 steps each, on {smi}: "
          f"{json.dumps(out['steps'])}", flush=True)
    print(f"phase 18: {time.perf_counter() - t_phase:.1f} s wall", flush=True)
    return out


# ---------------------------------------------------------------- phase 19: pipeline, tensor and expert parallelism

PP_LAYERS = 4          # 19a: configs/tpu_spotting.json's head (128 wide, W = 1024) with 4 blocks
PP_TIMELINES = 2       # 19a: one batch of two seeded 5400-frame timelines, drained in two microbatches
PP_FEATURES = 640      # the trunk's features under tpu_spotting.json (audio 128 ‖ visual 512)
EP_SHARDS = 4          # 19b: virtual expert shards of the --moe-experts 4 layer
TP_RANKS = 2           # 19b: virtual model ranks of the fusion MLP
SPLIT_ROWS = 1050      # 19b: frames through the split layers (phase 1's batch)


def pp_virtual_case(stages: int, window: int, gen: torch.Generator, launches_by_path: dict) -> dict:
    """19a: GPipe over ``stages`` virtual stages on the one card (``parallel/pp.py`` with
    ``parallel.mesh.VirtualAxis``: the ranks' code, every stage's tick loop in this process, the shifts a
    rotation of a list, the output's, loss's and shared leaves' sums over the pipe and the stages' gather
    arithmetic on it) on
    ``PP_TIMELINES`` seeded timelines of ``MATCH_FRAMES`` frames, against the single-device scorer and
    ``make_spotting_train_step`` on the same card: outputs within 1e-5·max(1, max|s|), the batch's loss
    within 1e-5 relative and the first step's gradients within 1e-4·max(1, max|g|) of the single-device
    steps' (each timeline's weighted by its share of the batch's BCE weights); each block launched once a
    microbatch (kernel 5 or 7 forward, 6 or 8 backward: the stages' idle ticks compute nothing); then the PP
    step's ms beside the single-device steps' over the same two timelines."""
    from cvml_goalnet_tpu_torch.models.temporal_attention import temporal_transformer_apply
    from cvml_goalnet_tpu_torch.parallel.mesh import VirtualAxis
    from cvml_goalnet_tpu_torch.parallel.pp import make_pp_spotting_train_step, pipeline_transformer_apply
    from cvml_goalnet_tpu_torch.train.spotting import bce_weights

    base = PipelineConfig.load(str(REPO / "configs" / "tpu_spotting.json"))
    mc = dataclasses.replace(base.model, temporal_num_layers=PP_LAYERS, temporal_window=window)
    params = weights.tree_from_jax(weights.init_temporal_params(mc, PP_FEATURES, seed=19))
    feats = torch.randn((PP_TIMELINES, MATCH_FRAMES, PP_FEATURES), generator=gen, device="cuda")
    labels = (torch.rand((PP_TIMELINES, MATCH_FRAMES), generator=gen, device="cuda") < 0.02).float()
    heads, axis = mc.temporal_num_heads, VirtualAxis(stages)
    fwd, bwd = ("flash_local_fwd", "flash_local_bwd") if window else ("flash_fwd", "flash_bwd")
    label = f"pp_virtual_{stages}_{'banded' if window else 'full'}"
    with torch.no_grad():
        out = drive(f"{label}_apply", [fwd], lambda: pipeline_transformer_apply(params, feats, axis, heads,
                                                                                window=window), launches_by_path)
        mono = torch.stack([temporal_transformer_apply(params, f, heads, window) for f in feats])
    pp_step = make_pp_spotting_train_step(axis, heads, window=window)
    loss, grads = drive(f"{label}_step", [fwd, bwd], lambda: pp_step.value_and_grad(params, feats, labels),
                        launches_by_path)
    one_step = make_spotting_train_step(0, scorer="transformer", num_heads=heads, window=window)
    w = bce_weights(labels, 10.0).sum(dim=1)
    share = [float(x) for x in w / w.sum()]   # the batch's BCE is Σ_b num_b / Σ_b den_b
    parts = [one_step.value_and_grad(params, f, lab) for f, lab in zip(feats, labels)]
    want_loss = sum(s * float(part_loss) for s, (part_loss, _) in zip(share, parts))
    want = tree_map(lambda *g: sum(s * x for s, x in zip(share, g)), *[g for _, g in parts])
    per = PP_TIMELINES * PP_LAYERS
    got_launches = launches_by_path[f"{label}_step"]
    require(launches_by_path[f"{label}_apply"][fwd] == per and got_launches[fwd] == per and got_launches[bwd] == per,
            f"19a {label}: {got_launches[fwd]} {fwd} and {got_launches[bwd]} {bwd} launches, want {per} each")
    gl, wl = tree_leaves(grads), tree_leaves(want)
    finite = all(bool(torch.isfinite(x).all()) for x in (out, loss, *gl))
    rec = {"stages": stages, "window": window, "microbatches": PP_TIMELINES, "layers": PP_LAYERS, "finite": finite,
           "out_err": float((out - mono).abs().max()) / max(1.0, float(mono.abs().max())),
           "loss_rel_err": abs(float(loss) - want_loss) / abs(want_loss),
           "grad_err": max(float((a - b).abs().max()) for a, b in zip(gl, wl))
           / max(1.0, max(float(b.abs().max()) for b in wl)),
           "launches": {fwd: per, bwd: per}}
    require(finite and rec["out_err"] <= 1e-5 and rec["loss_rel_err"] <= 1e-5 and rec["grad_err"] <= 1e-4,
            f"19a {label}: {json.dumps(rec)}")
    opt = init_spotting_opt(params)
    rec["pp_step_ms"] = time_ms(lambda: pp_step(params, opt, feats, labels), reps=3, warmup=1)
    rec["single_steps_ms"] = time_ms(lambda: [one_step(params, opt, f, lab) for f, lab in zip(feats, labels)],
                                     reps=3, warmup=1)
    return rec


def split_against_whole(run, leaves_of, what: str) -> dict:
    """``run(split)`` → output, with ``split`` False (the whole layer) and True (its virtual split), each with
    fresh leaves ``leaves_of()``: the output within 1e-5·max(1, max|y|) and the gradients of Σ y² within
    1e-4·max(1, max|g|) of the whole layer's."""
    res = []
    for split in (False, True):
        leaves = leaves_of()
        with torch.enable_grad():
            y = run(split, leaves)
            grads = torch.autograd.grad((y * y).sum(), leaves)
        res.append((y.detach(), grads))
    (y0, g0), (y1, g1) = res
    rec = {"out_err": float((y1 - y0).abs().max()) / max(1.0, float(y0.abs().max())),
           "grad_err": max(float((a - b).abs().max()) for a, b in zip(g1, g0))
           / max(1.0, max(float(b.abs().max()) for b in g0)),
           "finite": bool(torch.isfinite(y1).all()) and all(bool(torch.isfinite(g).all()) for g in g1)}
    require(rec["finite"] and rec["out_err"] <= 1e-5 and rec["grad_err"] <= 1e-4, f"19b {what}: {json.dumps(rec)}")
    return rec


def split_layers_check(gen: torch.Generator) -> dict:
    """19b: at ``configs/reference_parity.json``'s fusion widths (640 → 512 → 512 → 256 → 128 → 1) on
    ``SPLIT_ROWS`` seeded rows: the fusion MLP's train forward split over ``TP_RANKS`` virtual model ranks
    (``models/avm.py::fusion_train_apply`` with ``parallel.mesh.VirtualAxis``; dropout on, both sides from one
    seed), alone and after an MoE first layer, and the ``--moe-experts 4`` layer over ``EP_SHARDS`` virtual
    expert shards (``parallel/ep.py``), each against the whole layer on the same card.  Plain PyTorch, as the
    train forward: no kernel of the port runs here."""
    from cvml_goalnet_tpu_torch.models.avm import fusion_train_apply
    from cvml_goalnet_tpu_torch.models.moe import moe_apply
    from cvml_goalnet_tpu_torch.parallel.mesh import VirtualAxis
    from cvml_goalnet_tpu_torch.parallel.ep import moe_apply_expert_parallel
    from cvml_goalnet_tpu_torch.parallel.sharding import fusion_param_shardings, model_shard
    from cvml_goalnet_tpu_torch.train.optim import tree_unflatten

    cfg = PipelineConfig.load(str(REPO / "configs" / "reference_parity.json"))
    out = {}
    for label, c in (("tp_fusion", cfg), ("tp_fusion_after_moe", text_moe_cfg(cfg, "moe"))):
        layers = weights.tree_from_jax(weights.init_params(c, 19)[0]["fusion"])
        x = torch.randn((SPLIT_ROWS, 640), generator=gen, device="cuda")

        def run(split, leaves, layers=layers, c=c, x=x):
            tracked = tree_unflatten(layers, leaves)
            tp = VirtualAxis(TP_RANKS) if split else None
            held = tracked if not split else tp.split(
                tracked, lambda t, i, n: model_shard({"fusion": t}, fusion_param_shardings({"fusion": t}), i, n)["fusion"])
            return fusion_train_apply(held, x, c.model, torch.Generator(device="cuda").manual_seed(19), tp)[0]

        out[label] = split_against_whole(run, lambda layers=layers: [t.clone().requires_grad_()
                                                                     for t in tree_leaves(layers)], label)
    moe_cfg = text_moe_cfg(cfg, "moe")
    moe = weights.tree_from_jax(weights.init_params(moe_cfg, 19)[0]["fusion"][0])
    x = torch.randn((SPLIT_ROWS, 640), generator=gen, device="cuda")
    k = moe_cfg.model.fusion_moe_top_k

    def run_ep(split, leaves):
        p = tree_unflatten(moe, leaves)
        return moe_apply_expert_parallel(p, x, VirtualAxis(EP_SHARDS), k) if split else moe_apply(p, x, k)

    out["ep_moe"] = split_against_whole(run_ep, lambda: [t.clone().requires_grad_() for t in tree_leaves(moe)],
                                        "ep_moe")
    out["tp_ranks"], out["ep_shards"], out["rows"] = TP_RANKS, EP_SHARDS, SPLIT_ROWS
    return out


def pp_refusal_check(root: str) -> dict:
    """19c: ``spot-train --pp N+1`` on the N visible cards exits 2 with the JAX CLI's device-count message,
    before any decode (a config copy of tpu_spotting.json with N + 1 blocks, videos that do not exist)."""
    n = torch.cuda.device_count()
    base = PipelineConfig.load(str(REPO / "configs" / "tpu_spotting.json"))
    path = os.path.join(root, "pp_cfg.json")
    dataclasses.replace(base, model=dataclasses.replace(base.model, temporal_num_layers=n + 1)).save(path)
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = cli.main(["spot-train", "--videos", os.path.join(root, "none.npz"), "--config", path, "--workdir", root,
                       "--temporal-model", "transformer", "--pp", str(n + 1)])
    message = f"E: --pp {n + 1} needs {n + 1} devices, have {n}"
    require(rc == 2 and message in err.getvalue(), f"19c: exit code {rc}: {err.getvalue()[-500:]}")
    return {"rc": rc, "message": message}


def pp_tp_ep_phase(seed: int, smi: str, launches_by_path: dict, gen: torch.Generator) -> dict:
    """Phase 19: pipeline, tensor and expert parallelism on the one card — (a) GPipe over 2 and 4 virtual stages
    against the single-device steps, banded and full, (b) the fusion MLP over virtual model ranks and the MoE
    layer over virtual expert shards against the whole layers, (c) ``spot-train --pp`` past the cards refused."""
    t_phase = time.perf_counter()
    out = {"pp": [pp_virtual_case(stages, window, gen, launches_by_path)
                  for window in (ATTN_WINDOW, 0) for stages in (2, 4)]}
    print(f"phase 19a: GPipe over virtual stages vs one device on {smi}: {json.dumps(out['pp'])}", flush=True)
    out["split"] = split_layers_check(gen)
    print(f"phase 19b: fusion MLP over {TP_RANKS} virtual model ranks, MoE over {EP_SHARDS} virtual expert "
          f"shards vs the whole layers on {smi}: {json.dumps(out['split'])}", flush=True)
    with tempfile.TemporaryDirectory() as root:
        out["refusal"] = pp_refusal_check(root)
    print(f"phase 19c: spot-train --pp past the cards: {json.dumps(out['refusal'])}", flush=True)
    print(f"phase 19: {time.perf_counter() - t_phase:.1f} s wall", flush=True)
    return out


# ---------------------------------------------------------------- phase 20: the orbax checkpoint backend

ORBAX_FIXTURE = REPO / "tests" / "data" / "orbax_small"   # JAX-written (tools/make_orbax_fixture.py)
ZSTD_RATE_BYTES = 64 << 20                                # decoded bytes behind the decode rate


class OrbaxSaves:
    """Keeps a copy of each state ``save_checkpoint_orbax`` writes, by tag, and of each state
    ``load_checkpoint_orbax`` returns, on their devices (the training loop imports the functions at call time,
    so the module attributes are what it calls)."""

    def __init__(self):
        from cvml_goalnet_tpu_torch.train import orbax_io

        self.module, self.save_fn, self.load_fn = orbax_io, orbax_io.save_checkpoint_orbax, orbax_io.load_checkpoint_orbax
        self.saved, self.loaded = {}, []

    @staticmethod
    def snapshot(state) -> list:
        return tree_map(lambda t: t.detach().clone() if isinstance(t, torch.Tensor) else t,
                        [state.params, state.model_state, state.opt_state._asdict(), state.epoch])

    def save(self, directory, state, cfg, tag="ckp"):
        self.saved.setdefault(tag, []).append(self.snapshot(state))
        return self.save_fn(directory, state, cfg, tag)

    def load(self, directory, template, tag="ckp"):
        out = self.load_fn(directory, template, tag)
        self.loaded.append(self.snapshot(out))
        return out

    def __enter__(self):
        self.module.save_checkpoint_orbax, self.module.load_checkpoint_orbax = self.save, self.load
        return self

    def __exit__(self, *exc):
        self.module.save_checkpoint_orbax, self.module.load_checkpoint_orbax = self.save_fn, self.load_fn


def same_tree(a, b) -> bool:
    """Equal structure and every leaf bit-equal (tensors on any device, ints)."""
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        (isinstance(x, torch.Tensor) and isinstance(y, torch.Tensor) and x.dtype == y.dtype and x.shape == y.shape
         and torch.equal(x, y.to(x.device))) or (not isinstance(x, torch.Tensor) and x == y) for x, y in zip(la, lb))


def orbax_phase(seed: int, smi: str, launches_by_path: dict) -> None:
    """Phase 20: the orbax backend: the zstd decoder's build and rate, the JAX-written fixture on the card, and
    train, its resume, infer and serve through ``--checkpoint-backend orbax`` at the default config's width."""
    from cvml_goalnet_tpu_torch.compat import zstd
    from cvml_goalnet_tpu_torch.compat import zarr2
    from cvml_goalnet_tpu_torch.compat.ocdbt import OcdbtStore
    from cvml_goalnet_tpu_torch.train.orbax_io import load_checkpoint_orbax, save_checkpoint_orbax

    os.environ.pop("GOALNET_PLATFORM", None)   # the CLI runs on the card, as a user's call would
    t_phase = time.perf_counter()
    out = {}

    # (a) the decoder: built with g++ on this machine (always, timed: a copy of the tree may carry a library built
    # elsewhere), then one call decoding the fixture's largest chunk's frame, concatenated until its content is
    # ZSTD_RATE_BYTES, into one fresh array of that size (as the reader decodes a chunk: input and output far
    # past the host's caches)
    lib = zstd.lib_path()
    fresh = lib.with_name(f"{lib.stem}.phase20-{os.getpid()}.so")
    t0 = time.perf_counter()
    zstd._build(fresh)
    out["zstd_build_s"] = time.perf_counter() - t0
    os.replace(fresh, lib)   # the library load() opens
    zstd.load()
    store = OcdbtStore(str(ORBAX_FIXTURE / "ckp_orbax"))
    chunks = [k for k in store.list() if not k.endswith(b"/.zarray")]
    key = max(chunks, key=lambda k: len(store.read(k)))
    name = key.decode().rsplit("/", 1)[0]
    meta = zarr2.read_metadata(store, name)
    frame = store.read(key)
    chunk_bytes = int(np.prod(meta["chunks"])) * zarr2.DTYPES[meta["dtype"]].itemsize
    reps = -(-ZSTD_RATE_BYTES // chunk_bytes)
    stream = frame * reps
    buf = np.empty((reps * chunk_bytes,), dtype=np.uint8)
    t0 = time.perf_counter()
    n = zstd.decompress_into(stream, buf)
    wall = time.perf_counter() - t0
    require(n == buf.nbytes and np.array_equal(buf[:chunk_bytes], buf[-chunk_bytes:]),
            f"20a: {reps} concatenated frames decoded to {n} bytes, expected {buf.nbytes}")
    out["zstd_decode"] = {"chunk": key.decode(), "frames": reps, "stream_bytes": len(stream),
                          "decoded_bytes": n, "s": wall, "MB_per_s": n / wall / 1e6}
    print(f"phase 20a: zstd decoder built with g++ in {out['zstd_build_s']:.2f} s "
          f"({zstd.lib_path().name}); one call decoding {reps} concatenated frames of {key.decode()} "
          f"({len(stream)} → {n} bytes, into a fresh array) in {wall:.4f} s: "
          f"{out['zstd_decode']['MB_per_s']:.1f} MB/s on the host of {smi}", flush=True)

    # (b) the JAX-written fixture onto the card, leaf for leaf against its npz twin
    fcfg = PipelineConfig.load(str(ORBAX_FIXTURE / "cfg.json"))
    tpl = create_train_state(seed, fcfg)
    t0 = time.perf_counter()
    got = load_checkpoint_orbax(str(ORBAX_FIXTURE), tpl)
    out["fixture_load_s"] = time.perf_counter() - t0
    twin = load_checkpoint(str(ORBAX_FIXTURE), tpl)
    leaves = tree_leaves([got.params, got.model_state, got.opt_state.mu, got.opt_state.nu])
    require(all(t.is_cuda for t in leaves), "20b: the fixture's leaves are not on the card")
    require(same_tree([got.params, got.model_state, got.opt_state._asdict(), got.epoch],
                      [twin.params, twin.model_state, twin.opt_state._asdict(), twin.epoch]),
            "20b: the JAX-written orbax fixture is not its npz twin bit for bit")
    print(f"phase 20b: the JAX-written fixture ({len(leaves)} tensors, epoch {got.epoch}, Adam step "
          f"{got.opt_state.step}) on the card, bit-equal to its npz twin; loaded in {out['fixture_load_s']:.3f} s",
          flush=True)

    # (c) the verbs at the default config's full width on phase 10's videos
    cfg = PipelineConfig()
    kernels = ["fused_preprocess_frames", *TRUNK, "fused_fusion_mlp"]
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        data = make_train_inputs(cfg, seed, root)
        cfg_path = os.path.join(root, "cfg.json")
        cfg.save(cfg_path)
        out["data_s"] = time.perf_counter() - t0
        store_cls, plots = dataset_io.AnnotationStore, PlotSink()
        saved_viz = (viz.generate_metric_plots, viz.export_indices)
        dataset_io.AnnotationStore = AnnotationStand
        viz.generate_metric_plots, viz.export_indices = plots.metric_plots, plots.export_indices
        work = os.path.join(root, "work")
        args = ["--videos", *data["videos"], "--annotation-fp", data["annotation_fp"], "--mat-fp", data["mat_fp"],
                "--h5-fp", data["h5_fp"], "--info-fp", data["info_fp"], "--config", cfg_path, "--workdir", work]
        walls = {}

        def verb(label, argv, expect=kernels, stdout=None):
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(stdout or buf):
                rc = drive(label, expect, lambda: cli.main(argv), launches_by_path)
            walls[label] = time.perf_counter() - t0
            require(rc == 0, f"{label}: exit code {rc}")
            return buf.getvalue()

        try:
            with OrbaxSaves() as spy:
                text = verb("orbax_train", ["train", *args, "--epochs", "1", "--checkpoint-backend", "orbax"])
                require("Operation completed" in text, "20c: train --checkpoint-backend orbax did not complete")
                ckp_dir = cli._artifact_paths(work, True)["ckp_dir"]
                names = sorted(os.listdir(ckp_dir))
                require({"ckp_orbax", "opt_orbax", "ckp_orbax_manifest.json", "opt_orbax_manifest.json"} <= set(names)
                        and not any(n.endswith(".npz") for n in names), f"20c: train wrote {names}")
                text = verb("orbax_train --checkpoint", ["train", *args, "--checkpoint", "--epochs", "2",
                                                         "--checkpoint-backend", "orbax"])
                require("Resumed from epoch 1" in text, "20c: the resume did not start at epoch 1")
                require(len(spy.saved.get("ckp", ())) >= 1 and len(spy.loaded) == 1
                        and same_tree(spy.loaded[0], spy.saved["ckp"][0]),
                        "20c: the resumed state is not the saved one bit for bit")
                require(len(spy.saved.get("opt", ())) >= 1, "20c: train saved no opt checkpoint")
            out["resumed_state_bit_equal_to_saved"] = True

            # infer on a work directory holding only the orbax trunk (no flag), against an npz save of that state
            only = os.path.join(root, "orbax_only")
            only_dir = cli._artifact_paths(only, True)["ckp_dir"]
            os.makedirs(only_dir)
            for n in ("opt_orbax", "opt_orbax_manifest.json"):
                (shutil.copytree if n.endswith("_orbax") else shutil.copy)(os.path.join(ckp_dir, n),
                                                                            os.path.join(only_dir, n))
            # the full-width states: `full` is saved and loaded back below, into `template` (another seed)
            full, template = create_train_state(seed, cfg), create_train_state(seed + 1, cfg)
            state = load_checkpoint_orbax(ckp_dir, template, tag="opt")
            require(same_tree(OrbaxSaves.snapshot(state), spy.saved["opt"][-1]),
                    "20c: the opt trunk loads other than the state train saved, bit for bit")
            out["opt_load_bit_equal_to_saved"] = True
            twin_work = os.path.join(root, "npz_twin")
            save_checkpoint(cli._artifact_paths(twin_work, True)["ckp_dir"], state, cfg, tag="opt")
            video = data["videos"][0]
            scores = {}
            sink = ExportSink(False)
            video_io.export_video = sink
            try:
                for label, w in (("orbax_infer", only), ("orbax_infer npz twin", twin_work)):
                    with FuseSpy() as fspy:
                        verb(label, ["infer", video, "--config", cfg_path, "--workdir", w])
                    require(len(fspy.scores) == 1, f"{label}: {len(fspy.scores)} fuse calls")
                    scores[label] = fspy.scores[0]
            finally:
                video_io.export_video = sink.writer
            diff = float(np.abs(scores["orbax_infer"] - scores["orbax_infer npz twin"]).max())
            require(diff == 0.0, f"20c: infer from the orbax trunk scores {diff} from the npz twin's")
            out["infer"] = {"scores": int(len(scores["orbax_infer"])), "max_abs_diff_to_npz_twin": diff}

            # serve: booted on the orbax-only trunk, one /reload (the same auto-detected orbax load) and one
            # /summarize of the video
            watch = PortWatch(io.StringIO())
            answers = {}

            def client():
                if not watch.ready.wait(300):
                    return
                answers["reload"] = http(watch.port, "/reload", {})
                answers["summarize"] = http(watch.port, "/summarize", {"video": os.path.basename(video)})

            c = threading.Thread(target=client)
            c.start()
            try:
                verb("orbax_serve", ["serve", "--config", cfg_path, "--workdir", only, "--port", "0", "--media-root",
                                     os.path.dirname(video), "--max-requests", "2"], stdout=watch)
            finally:
                watch.ready.set()
                c.join()
            require(answers.get("reload", (0,))[0] == 200 and answers["reload"][1].get("reloaded") == {"summarizer": 1},
                    f"20c: /reload answered {answers.get('reload')}")
            require(answers.get("summarize", (0,))[0] == 200, f"20c: /summarize answered {answers.get('summarize')}")
            served = np.asarray(answers["summarize"][1]["scores"], dtype=np.float32)
            out["serve"] = {"reload": answers["reload"][1],
                            "summarize_max_abs_diff_to_infer": float(np.abs(served - scores["orbax_infer"]).max())}
            require(out["serve"]["summarize_max_abs_diff_to_infer"] <= 1e-4,   # the response rounds to 4 decimals
                    f"20c: /summarize after /reload scores {out['serve']} from infer's")
        finally:
            dataset_io.AnnotationStore = store_cls
            viz.generate_metric_plots, viz.export_indices = saved_viz

        # the full state's save and load walls, both layouts (the card's state; files on this machine's disk)
        io_walls = {}
        for name, save, load in (("orbax", save_checkpoint_orbax, load_checkpoint_orbax),
                                 ("npz", save_checkpoint, load_checkpoint)):
            d = os.path.join(root, f"walls_{name}")
            t0 = time.perf_counter()
            save(d, full, cfg, tag="ckp")
            io_walls[f"{name}_save_s"] = time.perf_counter() - t0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            back = load(d, template, tag="ckp")
            torch.cuda.synchronize()
            io_walls[f"{name}_load_s"] = time.perf_counter() - t0
            require(same_tree(back.params, full.params), f"20c: the {name} round trip changed the parameters")
        out["state_MB"] = sum(state_bytes(full).values()) / 1e6
        out["io_walls"] = io_walls
        out["data_s"] = round(out["data_s"], 3)
    out["verb_walls_s"] = walls
    for label in ("orbax_train", "orbax_train --checkpoint", "orbax_infer", "orbax_serve"):
        got = launches_by_path[label]
        out.setdefault("launches", {})[label] = {k: got[k] for k in kernels}
    wall = time.perf_counter() - t_phase
    out["phase_wall_s"] = wall
    print(f"phase 20: orbax backend at the default config's width on {smi}: {json.dumps(out)}", flush=True)
    print(f"phase 20: {wall:.1f} s wall (of which {out['data_s']:.1f} s making phase 10's videos when phase 10 "
          f"did not run first)", flush=True)


COLLECTIVE_LANES = 4          # 21c: lanes of the VirtualAxis
COLLECTIVE_ROWS = 1_024       # 21c: rows of each lane's (rows, 128) tensor, divisible by the lanes


def example_module(name: str):
    """``examples/<name>.py`` as a module (its directory put on the path, which spawned ranks inherit)."""
    import importlib

    examples = str(REPO / "examples")
    if examples not in sys.path:
        sys.path.insert(0, examples)
    return importlib.import_module(name)


def counted_multihost_rank(rank: int, world: int, device, jobs: list) -> dict:
    """The example's rank function over each job in turn, with every kernel's launch count set to 0 before and
    read after → each job's step losses and the counts.  A spawned rank imports this script as its main
    module."""
    example = example_module("multihost_train_torch")
    for f, _, _ in KERNELS.values():
        f.launches = 0
    losses = [example.rank_steps(rank, world, device, job) for job in jobs]
    return {"losses": losses, "launches": {name: f.launches for name, (f, _, _) in KERNELS.items()}}


def collectives_check(gen: torch.Generator) -> dict:
    """21c: JAX's remaining collectives on a VirtualAxis of CUDA lanes against the same lanes on the CPU."""
    from cvml_goalnet_tpu_torch.parallel import collectives as C
    from cvml_goalnet_tpu_torch.parallel.mesh import VirtualAxis

    axis = VirtualAxis(COLLECTIVE_LANES)
    card = [torch.randn((COLLECTIVE_ROWS, 128), generator=gen, device="cuda") for _ in range(COLLECTIVE_LANES)]
    cpu = [x.cpu() for x in card]
    runs = {"all_gather": lambda xs: C.all_gather(xs, axis), "all_gather_tiled": lambda xs: C.all_gather(xs, axis, True),
            "reduce_scatter": lambda xs: C.reduce_scatter(xs, axis)}
    for shift in (1, -1, 2):
        runs[f"ppermute_ring_{shift}"] = lambda xs, s=shift: C.ppermute_ring(xs, axis, s)
    errs = {}
    for name, run in runs.items():
        got, want = run(card), run(cpu)
        require(all(g.is_cuda for g in got) and [g.shape for g in got] == [w.shape for w in want],
                f"21c: {name} on the card gave {[tuple(g.shape) for g in got]}")
        errs[name] = max(max_err(g.cpu(), w) for g, w in zip(got, want))
        tol = 1e-6 * max(1.0, max(float(w.abs().max()) for w in want)) if name == "reduce_scatter" else 0.0
        require(errs[name] <= tol, f"21c: {name} on the card {errs[name]} from the CPU (tolerance {tol})")
    return errs


def multihost_phase(seed: int, smi: str, launches_by_path: dict) -> dict:
    """Phase 21: the example's multi-host path on every visible card as one host process, against phase 17's
    launcher; the multislice grid; the collectives on CUDA lanes; launch counts and the wall."""
    import socket

    from cvml_goalnet_tpu_torch.parallel import multihost
    from cvml_goalnet_tpu_torch.parallel.launch import backend_of, spawn_ranks

    t_phase = time.perf_counter()
    example = example_module("multihost_train_torch")
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    multihost.initialize_from_env(f"127.0.0.1:{port}", 1, 0, timeout=60)
    try:
        mesh = multihost.global_data_mesh()
        flat = example.make_job(mesh, seed=seed)
        grid = example.make_job(mesh, multislice=True, seed=seed)
        walls, got = {}, {}

        def run(label, fn):
            t0 = time.perf_counter()
            got[label] = fn()
            walls[label] = time.perf_counter() - t0

        # (a) and (b) through the coordinator's TCPStore; phase 17's FileStore launch of the same ranks beside
        threads = [threading.Thread(target=run, args=("tcp", lambda: multihost.run_ranks(
                       counted_multihost_rank, mesh, ([flat, grid],)))),
                   threading.Thread(target=run, args=("filestore", lambda: spawn_ranks(
                       counted_multihost_rank, list(mesh.local), ([flat],))))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        multihost.shutdown()
    require(set(got) == {"tcp", "filestore"}, f"21: a launch of the ranks failed ({sorted(got)} came back)")
    tcp_flat, tcp_grid = got["tcp"][0]["losses"]
    file_flat = got["filestore"][0]["losses"][0]
    require(all(r["losses"] == got["tcp"][0]["losses"] for r in got["tcp"]), "21: the ranks' losses differ")
    require(len(tcp_flat) == example.STEPS and tcp_flat == file_flat,
            f"21a: the TCPStore ranks' losses {tcp_flat} vs the FileStore ranks' {file_flat}")
    rel = max(abs(a - b) / abs(b) for a, b in zip(tcp_grid, tcp_flat))
    require(rel <= 1e-6, f"21b: the multislice grid's losses {tcp_grid} vs {tcp_flat} ({rel} relative)")
    launches = {name: sum(r["launches"][name] for r in got["tcp"] + got["filestore"]) for name in KERNELS}
    require(not any(launches.values()), f"21: the data-parallel train step launched kernels: {launches}")
    for label in ("multihost_tcp", "multihost_filestore"):
        launches_by_path[label] = {name: 0 for name in KERNELS}
    gen = torch.Generator(device="cuda").manual_seed(seed + 21)
    out = {"ranks": mesh.size, "backend": backend_of(list(mesh.local)), "steps": example.STEPS, "losses": tcp_flat,
           "filestore_losses": file_flat, "bit_equal": True, "grid": grid["slices"].shape, "grid_losses": tcp_grid,
           "grid_max_rel_diff": rel, "collectives_max_abs_err": collectives_check(gen),
           "kernel_launches": launches, "walls_s": walls}
    out["phase_wall_s"] = time.perf_counter() - t_phase
    print(f"phase 21: multi-host training (one host process, {mesh.size} card(s), {out['backend']} over a TCPStore) on "
          f"{smi}: "
          f"{json.dumps(out)}", flush=True)
    print(f"phase 21: {out['phase_wall_s']:.1f} s wall", flush=True)
    return out


# ---------------------------------------------------------------- phase 22: the examples and the reference corpus

EXAMPLES = ("train_and_summarize_torch", "serve_and_spot_torch", "live_follow_spotting_torch")
FORCED_EVERY = 25          # 22b: the card's serve_and_spot loss from the CPU run's parameters at every 25th step
EXAMPLES_CPU_THREADS = 4   # torch threads of the child process that runs the examples on the CPU
OPTIONAL_MODULES = ("h5py", "cv2", "matplotlib")


def absent_modules() -> list[str]:
    import importlib.util

    return [m for m in OPTIONAL_MODULES if importlib.util.find_spec(m) is None]


def synthetic_dataset_stand(root: str, video_ids=("vidA", "vidB"), full_n_frames: int = 360, n_annotators: int = 20,
                            n_clips: int = 8, fps_raw: int = 30, sr: int = 22050, seed: int = 7,
                            length_step: int = 30) -> dict:
    """``data.synthetic.synthetic_dataset_dir`` without h5py: the same ``.npz`` videos, ``.wav`` sidecars and
    TSVs from the same draws; the arrays it would write into the ``.mat``/``.h5`` pair go to
    :class:`AnnotationStand`."""
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    fps, rows, arrays = [], [], {}
    for vi, vid in enumerate(video_ids):
        n = full_n_frames + vi * length_step
        np.savez_compressed(os.path.join(root, f"{vid}.npz"), frames=synthetic_video_frames(n, seed=seed + vi))
        write_wav(os.path.join(root, f"{vid}.wav"), synthetic_waveform(int(n / fps_raw * sr), sr, seed=seed + vi), sr)
        anno = rng.integers(1, 6, size=(n_annotators, n)).astype(np.float64)
        rows += [f"{vid}\tcategory\t{','.join(str(int(x)) for x in a)}\n" for a in anno]
        arrays[vid] = {"anno": anno, "change_points": synthetic_change_points(n - 1, n_clips, seed=seed + vi)}
        fps.append(os.path.join(root, f"{vid}.npz"))
    with open(os.path.join(root, "anno.tsv"), "w") as f:
        f.writelines(rows)
    with open(os.path.join(root, "info.tsv"), "w") as f:
        f.write("video_id\ttitle\n" + "".join(f"{v}\tTitle of {v}\n" for v in video_ids))
    AnnotationStand.arrays = arrays
    return {"video_fps": fps, "annotation_fp": os.path.join(root, "anno.tsv"),
            "mat_file_path": os.path.join(root, "gt.mat"), "h5_file_path": os.path.join(root, "gt.h5"),
            "info_fp": os.path.join(root, "info.tsv"), "video_ids": list(video_ids), "sr": sr, "fps_raw": fps_raw}


@contextlib.contextmanager
def examples_stood_in(absent: list[str]):
    """Without h5py, ``train_and_summarize``'s dataset is written by :func:`synthetic_dataset_stand` and read
    through :class:`AnnotationStand`; without matplotlib its curves go to a :class:`PlotSink`."""
    ex = example_module("train_and_summarize_torch")
    saved = (ex.synthetic_dataset_dir, ex.generate_metric_plots, dataset_io.AnnotationStore)
    if "h5py" in absent:
        ex.synthetic_dataset_dir, dataset_io.AnnotationStore = synthetic_dataset_stand, AnnotationStand
    if "matplotlib" in absent:
        ex.generate_metric_plots = PlotSink().metric_plots
    try:
        yield
    finally:
        ex.synthetic_dataset_dir, ex.generate_metric_plots, dataset_io.AnnotationStore = saved


def run_example(label: str, fn, launches_by_path: dict | None, expect=()):
    """One example's ``main`` with its output kept → (result, printed lines); on the card driven with the launch
    counts set to 0 before and read after."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn() if launches_by_path is None else drive(label, expect, fn, launches_by_path)
    return out, buf.getvalue().splitlines()


def run_examples(device: str, launches_by_path: dict | None, root: str) -> dict:
    """The three examples' ``main`` on ``device`` with their default (seeded) weights, each working in a
    directory under ``root`` → numpy results and the lines each printed.  ``train_and_summarize`` runs at
    dropout 0 and Adam eps 1e-4 (the run compared across devices) and, on the card, also as the example is;
    ``serve_and_spot`` keeps its head's parameters at every ``FORCED_EVERY``-th step and its last, and on the
    card the batcher's launches (before the first encode)."""
    on_card = launches_by_path is not None
    train, serve, live = (example_module(name) for name in EXAMPLES)
    res, lines, walls = {}, {}, {}

    def workdir(name):
        os.makedirs(os.path.join(root, name))
        return os.path.join(root, name)

    def timed(name, fn):
        t0 = time.perf_counter()
        out, lines[name] = fn()
        walls[name] = time.perf_counter() - t0
        return out

    kernels_24 = ["fused_conv_pool_stage", "head_matmul", "fused_fusion_mlp"]
    if on_card:
        timed("train_and_summarize", lambda: run_example(
            "example_train_and_summarize", lambda: train.main(device, work=workdir("train")), launches_by_path,
            ["fused_preprocess_frames", *kernels_24]))
    cfg = train.example_config()
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, dropout_rate=0.0),
                              train=dataclasses.replace(cfg.train, eps=1e-4))
    out = timed("train_and_summarize_dropout0", lambda: run_example(
        "example_train_and_summarize_dropout0", lambda: train.main(device, cfg=cfg, work=workdir("train_dropout0")),
        launches_by_path, ["fused_preprocess_frames", *kernels_24]))
    res["train"] = {"history": {k: v for k, v in out["history"].items() if isinstance(v, list)},
                    "scores": np.asarray(out["scores"]), "mask": out["summary"].frame_mask,
                    "clips": np.asarray(out["summary"].clip_intervals)}

    visited, snapshot = {}, {}
    real_make, real_encode = serve.make_spotting_train_step, serve.encode_timeline

    def recording(*a, **kw):
        step = real_make(*a, **kw)
        count = [0]

        def run(params, *rest):
            k = count[0]
            if k % FORCED_EVERY == 0 or k == serve.STEPS - 1:
                visited[k] = tree_map(lambda t: t.detach().cpu().numpy(), params)
            count[0] += 1
            return step(params, *rest)

        run.value_and_grad = step.value_and_grad
        return run

    def encode_after_batcher(*a, **kw):
        if not snapshot:
            snapshot.update({name: f.launches for name, (f, _, _) in KERNELS.items()})
        return real_encode(*a, **kw)

    serve.make_spotting_train_step, serve.encode_timeline = recording, encode_after_batcher
    try:
        out = timed("serve_and_spot", lambda: run_example(
            "example_serve_and_spot", lambda: serve.main(device), launches_by_path, kernels_24))
    finally:
        serve.make_spotting_train_step, serve.encode_timeline = real_make, real_encode
    res["serve"] = {"scores": [r.scores for r in out["responses"]], "clips": [np.asarray(r.clips) for r in
                                                                              out["responses"]],
                    "masks": [r.frame_mask for r in out["responses"]], "stats": out["batcher_stats"],
                    "features": out["features"].cpu().numpy(), "losses": out["losses"], "visited": visited,
                    "head_scores": out["scores"], "events": out["events"], "prf": out["prf"],
                    "average_map": out["average_map"], "labels": serve.example_inputs()["labels"]}
    if on_card:
        res["serve"]["batcher_launches"] = snapshot

    out = timed("live_follow_spotting", lambda: run_example(
        "example_live_follow_spotting", lambda: live.main(device, live_dir=workdir("live")), launches_by_path, TRUNK))
    res["live"] = {"streamed": out["streamed"], "events": np.sort(np.concatenate(out["events"])),
                   "drift": out["drift"], "updates": out["updates"]}
    res["lines"], res["walls_s"] = lines, walls
    return res


def examples_on_cpu(out_path: str, root: str) -> None:
    """Phase 22b's child process: the examples on the CPU (:func:`run_examples`, working under ``root``),
    pickled to ``out_path``."""
    import pickle

    torch.set_num_threads(EXAMPLES_CPU_THREADS)
    with examples_stood_in(absent_modules()):
        res = run_examples("cpu", None, root)
    with open(out_path, "wb") as f:
        pickle.dump(res, f)


def compare_examples(card: dict, cpu: dict, device: str = "cuda") -> dict:
    """22b: each example on the card against its CPU run, at PERF.md §2's tolerances (the forced losses of
    ``serve_and_spot`` on ``device``)."""
    out = {}
    tr, tc = card["train"], cpu["train"]
    rel = {k: max(abs(a - b) / abs(b) for a, b in zip(tr["history"][k], tc["history"][k]))
           for k in tc["history"] if tc["history"][k]}
    require(all(len(tr["history"][k]) == len(v) for k, v in tc["history"].items()) and max(rel.values()) <= 1e-4,
            f"22b train_and_summarize: histories {tr['history']} vs CPU {tc['history']}")
    flips = same_summary(tr["scores"], tr["clips"], tc["scores"], tc["clips"], 1e-4, "22b train_and_summarize")
    require(flips or np.array_equal(tr["mask"], tc["mask"]), "22b train_and_summarize: the summary masks differ")
    out["train_and_summarize"] = {"history_max_rel_err": rel, "scores_max_abs_err": float(
        np.abs(tr["scores"] - tc["scores"]).max()), "rounding_flips": flips}

    sr, sc = card["serve"], cpu["serve"]
    flips = []
    for i, (a, b, ca, cb, ma, mb) in enumerate(zip(sr["scores"], sc["scores"], sr["clips"], sc["clips"], sr["masks"],
                                                   sc["masks"])):
        f = same_summary(a, ca, b, cb, 1e-4, f"22b serve_and_spot clip{i}")
        require(f or np.array_equal(ma, mb), f"22b serve_and_spot: clip{i}'s masks differ")
        flips += f
    require(sr["stats"]["requests"] == sc["stats"]["requests"] == len(sr["scores"]),
            f"22b serve_and_spot: batcher stats {sr['stats']} vs {sc['stats']}")
    first = max(abs(a - b) / abs(b) for a, b in zip(sr["losses"][:10], sc["losses"][:10]))
    require(len(sr["losses"]) == len(sc["losses"]) and first <= 1e-4,
            f"22b serve_and_spot: the first 10 losses {sr['losses'][:10]} vs CPU {sc['losses'][:10]}")
    serve = example_module("serve_and_spot_torch")
    step = make_spotting_train_step(serve.example_config().model.temporal_hidden, lr=1e-2, pos_weight=20.0)
    feats = torch.as_tensor(sr["features"], device=device)
    labels = torch.as_tensor(sr["labels"], device=device)
    forced = {}
    for k, params in sc["visited"].items():
        loss, _ = step.value_and_grad(weights.tree_from_jax(params, device=device), feats, labels)
        forced[k] = abs(float(loss) - sc["losses"][k]) / abs(sc["losses"][k])
    require(len(forced) == len(range(0, serve.STEPS, FORCED_EVERY)) + 1 and max(forced.values()) <= 1e-4,
            f"22b serve_and_spot: the card's losses from the CPU run's parameters {forced}")
    require(np.array_equal(sr["events"], sc["events"]) and sr["prf"] == sc["prf"]
            and sr["average_map"] == sc["average_map"],
            f"22b serve_and_spot: events {sr['events']} {sr['prf']} vs CPU {sc['events']} {sc['prf']}")
    out["serve_and_spot"] = {
        "batcher_rounding_flips": flips, "first_10_losses_max_rel_err": first, "forced_losses_max_rel_err":
        max(forced.values()), "last_loss": [sr["losses"][-1], sc["losses"][-1]],
        "free_running_head_scores_max_abs_diff": float(np.abs(sr["head_scores"] - sc["head_scores"]).max()),
        "events": sr["events"].tolist(), "prf": sr["prf"], "average_map": sr["average_map"]}

    lr_, lc = card["live"], cpu["live"]
    tol = score_tolerance(lc["streamed"])
    err = float(np.abs(lr_["streamed"] - lc["streamed"]).max())
    require(lr_["streamed"].shape == lc["streamed"].shape and err <= tol,
            f"22b live_follow_spotting: streamed scores {err} from the CPU's (> {tol})")
    window = example_module("live_follow_spotting_torch").PEAK_WINDOW
    near = compare_events(lr_["streamed"], lc["streamed"], tol, window)
    require(near or np.array_equal(lr_["events"], lc["events"]), "22b live_follow_spotting: the events differ")
    out["live_follow_spotting"] = {"streamed_max_abs_err": err, "near_ties": near, "events": lr_["events"].tolist(),
                                   "drift_vs_offline": lr_["drift"]}
    return out


def reference_corpus_check(root: str, absent: list[str], seed: int, launches_by_path: dict,
                           device: str = "cuda") -> dict:
    """22d: where cv2 and h5py import, ``build_reference_corpus`` into ``root``, read through the port's loaders
    at the width of ``configs/reference_parity.json`` (no audio: the sidecars are empty), and its first video
    fused on the card (kernels 1–4)."""
    lacking = [m for m in ("cv2", "h5py") if m in absent]
    if lacking:
        return {"ran": False, "absent": lacking}
    from cvml_goalnet_tpu_torch.compat.reference_runner import build_reference_corpus

    t0 = time.perf_counter()
    corpus = build_reference_corpus(root)
    base = PipelineConfig.load(str(REPO / "configs" / "reference_parity.json"))
    cfg = dataclasses.replace(base, model=dataclasses.replace(base.model, audio_included=False))
    train_ds, val_ds = dataset_io.build_datasets(corpus["video_fps"], cfg, corpus["annotation_fp"],
                                                 corpus["mat_file_path"], corpus["h5_file_path"], corpus["info_fp"],
                                                 audio_included=False, device=device)
    items = [*train_ds, *val_ds]
    require([it.video_id for it in items] == corpus["video_ids"]
            and all(it.labels is not None and it.gd_summary_masks is not None for it in items),
            f"22d: the corpus read as {[it.video_id for it in items]}")
    state = create_train_state(seed, cfg, device=device)
    scores = drive("reference_corpus_fuse", ["fused_conv_pool_stage", "head_matmul", "fused_fusion_mlp"],
                   lambda: fuse(state.params, state.model_state, {"visual": items[0].visual, "audio": None}, cfg,
                                device=device),
                   launches_by_path)
    require(scores.shape == (len(items[0].visual),) and np.isfinite(scores).all(), "22d: the corpus's scores")
    return {"ran": True, "video_ids": corpus["video_ids"], "decoded_frames": corpus["n_frames"],
            "condensed_frames": [len(it.visual) for it in items], "wall_s": time.perf_counter() - t0}


def examples_phase(seed: int, smi: str, launches_by_path: dict, device: str = "cuda") -> dict:
    """Phase 22: the three examples on the card (``device``), each against its run on the CPU in a child
    process (started first, so the two overlap), their kernel launches, and the reference corpus."""
    import pickle

    os.environ.pop("GOALNET_PLATFORM", None)
    t_phase = time.perf_counter()
    absent = absent_modules()
    stood_in = [m for m in absent if m in ("h5py", "matplotlib")]
    print(f"phase 22: absent here: {absent or 'none'}; stood in for train_and_summarize: {stood_in or 'none'}",
          flush=True)
    with tempfile.TemporaryDirectory() as root:
        cpu_path, log_path = os.path.join(root, "cpu.pkl"), os.path.join(root, "cpu.log")
        code = (f"import sys; sys.path.insert(0, {str(REPO)!r}); import chip_smoke; "
                f"chip_smoke.examples_on_cpu({cpu_path!r}, {os.path.join(root, 'cpu')!r})")
        with open(log_path, "w") as log:
            child = subprocess.Popen([sys.executable, "-c", code], cwd=str(REPO), stdout=log, stderr=subprocess.STDOUT,
                                     env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
        try:
            with examples_stood_in(absent):
                card = run_examples(device, launches_by_path, os.path.join(root, "card"))
            t0 = time.perf_counter()
            rc = child.wait(timeout=600)
            cpu_wait = time.perf_counter() - t0
        finally:
            if child.poll() is None:
                child.kill()
                child.wait()
        with open(log_path) as f:
            log_text = f.read()
        require(rc == 0, f"22b: the examples' CPU run exited {rc}: {log_text[-3000:]}")
        with open(cpu_path, "rb") as f:
            cpu = pickle.load(f)
        corpus = reference_corpus_check(os.path.join(root, "corpus"), absent, seed, launches_by_path, device)
    for name, lines in card["lines"].items():
        banners = [ln for ln in lines if ln.startswith(("summary:", "artifacts in", "[serve]", "[spot]", "[producer] "
                                                        "segment 0", "[check]", "live follow spotting"))]
        require(banners, f"22a: {name} printed no banner line")
        for ln in banners:
            print(f"phase 22a: {name}: {ln}", flush=True)
    launches = {label: {k: v for k, v in got.items() if v} for label, got in launches_by_path.items()
                if label.startswith("example_")}
    batcher = card["serve"]["batcher_launches"]
    require(all(batcher[k] for k in ("fused_conv_pool_stage", "head_matmul", "fused_fusion_mlp")),
            f"22c: the batcher launched {batcher}")
    require(not any(got.get(k) for got in launches.values() for k in ("flash_fwd", "flash_bwd", "flash_local_fwd",
                                                                          "flash_local_bwd")),
            f"22c: an example with a GRU head launched an attention kernel: {launches}")
    out = {"stood_in": stood_in, "absent": absent, "launches": launches,
           "batcher_launches": {k: v for k, v in batcher.items() if v}, "compare": compare_examples(card, cpu, device),
           "reference_corpus": corpus, "card_walls_s": card["walls_s"], "cpu_walls_s": cpu["walls_s"],
           "cpu_wait_after_card_s": cpu_wait}
    if not corpus["ran"]:
        print(f"phase 22d: the reference corpus did not run: {', '.join(corpus['absent'])} absent here", flush=True)
    out["phase_wall_s"] = time.perf_counter() - t_phase
    print(f"phase 22: the examples on {smi} against the CPU: {json.dumps(out, default=str)}", flush=True)
    print(f"phase 22: {out['phase_wall_s']:.1f} s wall", flush=True)
    return out


PHASES = ("1", "4", "5", "7", "9", "10", "11", "12", "13", "14", "15", "16", "17", "18", "19", "20", "21", "22")


def parse_phases(spec: str | None) -> set[str]:
    """``--phases 1,15-17`` → {"1", "15", "16", "17"} (every phase without the flag).  Phase 7 trains on phase 5's
    features and times against phase 1's kernel rows, so it brings both; phases 12-14 and 16 use phase 1's
    videos and phases 11-14, 16 and 18 phase 5's match, which are made when needed."""
    if not spec:
        return set(PHASES)
    chosen = set()
    for part in spec.split(","):
        lo, _, hi = part.strip().partition("-")
        for i in range(int(lo), int(hi or lo) + 1):
            if str(i) not in PHASES:
                raise SystemExit(f"chip_smoke: no phase {i} (phases: {', '.join(PHASES)})")
            chosen.add(str(i))
    if "7" in chosen:
        chosen.update(("1", "5"))
    return chosen


class PhaseClock:
    """Prints each phase's wall (from the end of the one before) and the script's time so far."""

    def __init__(self, t_start: float):
        self.t_start = self.last = t_start

    def done(self, name: str) -> None:
        now = time.perf_counter()
        print(f"phase {name} wall: {now - self.last:.1f} s (script at {now - self.t_start:.1f} s)", flush=True)
        self.last = now


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases", default=None,
                    help="run only these phases, e.g. 1,15-17 (default: every phase); set-up, the build and "
                         "the last lines run always")
    args = ap.parse_args()
    phases = parse_phases(args.phases)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the port on the card", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {smi} | torch {torch.__version__} cuda {torch.version.cuda} | {kind}", flush=True)

    t0 = time.perf_counter()
    per_kernel = _build.build()
    build_s = time.perf_counter() - t0
    print(f"build: {build_s:.1f} s wall ({json.dumps({k: round(v, 1) for k, v in per_kernel.items()})})")
    t0 = time.perf_counter()
    runtime.load()   # the native runtime (g++), which "auto" asks for at its first call, is set-up too
    print(f"native runtime: built and loaded in {time.perf_counter() - t0:.1f} s ({runtime.lib_path().name})")
    for name in _build.KERNELS:
        log = _build.BUILD_DIR / f"{name}.log"
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  ptxas {name}: {line.strip()}")

    attention_regs = ptxas_report("flash_attention")
    k5 = {fn: r for fn, r in attention_regs.items()
          if fn.startswith(("flash_fwd_tc_kernel", "fwd_merge_kernel")) and "band" not in fn}
    k7 = {fn: r for fn, r in attention_regs.items() if fn.startswith("flash_fwd_tc_kernel") and "band" in fn}
    k6 = {fn: r for fn, r in attention_regs.items() if fn.startswith("flash_bwd_tc_kernel") and "band" not in fn}
    k8 = {fn: r for fn, r in attention_regs.items() if fn.startswith("flash_bwd_tc_kernel") and "band" in fn}
    dev = torch.device("cuda")
    print(f"kernel 5 (flash_fwd) registers and spill bytes: {json.dumps(k5)}; blocks per SM "
          f"{json.dumps({d: fwd_blocks_per_sm(d, dev) for d in FWD_STREAM})}, resident slots "
          f"{json.dumps({d: fwd_slots(d, dev) for d in FWD_STREAM})}", flush=True)
    print(f"kernel 7 (flash_local_fwd) registers and spill bytes: {json.dumps(k7)}; blocks per SM "
          f"{json.dumps({d: fwd_blocks_per_sm(d, dev, band=True) for d in FWD_STREAM})}, resident slots "
          f"{json.dumps({d: fwd_slots(d, dev, band=True) for d in FWD_STREAM})}", flush=True)
    print(f"kernel 6 (flash_bwd) registers and spill bytes: {json.dumps(k6)}; blocks per SM (dK/dV, dQ) "
          f"{json.dumps({d: bwd_blocks_per_sm(d, dev) for d in BWD_STREAM})}, resident slots "
          f"{json.dumps({d: bwd_slots(d, dev) for d in BWD_STREAM})}", flush=True)
    print(f"kernel 8 (flash_local_bwd) registers and spill bytes: {json.dumps(k8)}; blocks per SM (dK/dV, dQ) "
          f"{json.dumps({d: bwd_blocks_per_sm(d, dev, band=True) for d in BWD_STREAM})}, resident slots "
          f"{json.dumps({d: bwd_slots(d, dev, band=True) for d in BWD_STREAM})}", flush=True)
    k2 = ptxas_report("fused_stage")
    print(f"kernel 2 (fused_conv_pool_stage) registers and spill bytes: {json.dumps(k2)}; (SMs, blocks per SM by "
          f"registers for m_tiles 2, 3, 4) {json.dumps(stage_slots(dev))}", flush=True)
    k3 = {fn: r for fn, r in ptxas_report("matmul").items() if "splitk_tc_gemm_kernel" in fn}
    print(f"kernel 3 (head_matmul) GEMM pass registers and spill bytes: {json.dumps(k3)}; (SMs, blocks per SM) "
          f"{json.dumps(head_slots(dev))}", flush=True)

    cfg = PipelineConfig.load(str(REPO / "configs" / "reference_parity.json"))
    params_np, state_np = weights.init_params(cfg, args.seed)
    params, state = weights.from_jax(params_np, state_np)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    n_total = sum(VIDEO_LENGTHS)
    rows: dict = {}
    launches_by_path: dict[str, dict] = {}
    videos = None

    def phase_videos():
        nonlocal videos
        if videos is None:
            t0 = time.perf_counter()
            videos = make_videos(cfg, args.seed)
            print(f"data: {len(videos)} videos, {n_total} frames of {RAW_HW}, made in {time.perf_counter() - t0:.1f} s")
        return videos

    clock = PhaseClock(t_start)
    clock.done("set-up and build")
    if "1" in phases:
        rows = check_kernels(n_total, cfg, params["fusion"], gen)
        print(f"trunk at frame_size (64, 64), card vs CPU: {json.dumps(check_trunk_at_frame_size_64(args.seed))}",
              flush=True)
        print(f"fused_conv_pool_stage plans at N = {n_total} on {smi}: {json.dumps(stage_plan_sweep(n_total, gen))}",
              flush=True)
        sweep = mlp_plan_sweep(params["fusion"], gen)
        print(f"fused_fusion_mlp plans on {smi}: chosen {json.dumps(sweep['chosen'])}; model refitted "
              f"{json.dumps(sweep['fit'])}; clusters at once {json.dumps(sweep['clusters_at_once'])}; "
              f"ms by M:plan {json.dumps(sweep['ms'])}", flush=True)
        rows.update(check_attention_kernels(gen))
        rows.update(check_attention_bwd_kernels(gen))
        rows = {name: rows[name] for name in KERNELS if name not in LOWP_FORMS}
        for name, r in rows.items():
            print(f"kernel {name} on {smi}: max|err| {r['max_abs_err']:.3g}  {r['ms']:.4f} ms  plain "
                  f"{r['plain_ms']:.4f} ms  library {r['library_ms']:.4f} ms  bound {r['bound_ms']:.4f} ms "
                  f"({r['bound_by']})", flush=True)

        videos = phase_videos()
        t0 = time.perf_counter()
        with knapsack_engines_run() as engines:
            feats, scores, results, _ = drive(
                "summarize", ["fused_preprocess_frames", *TRUNK, "fused_fusion_mlp"],
                lambda: run_path(videos, params, state, cfg), launches_by_path)
        first_s = time.perf_counter() - t0
        print(f"summarize's knapsack (\"auto\") ran the engines {json.dumps(engines)}, one a video", flush=True)
        check_outputs(videos, feats, scores, results, cfg)
        errs = check_against_cpu(videos[0], feats[0], scores[0], params_np, state_np, cfg)
        print(f"card vs CPU on {CPU_CHECK_FRAMES} frames: {json.dumps(errs)}")

        walls, stages, per_video = [], [], []
        for _ in range(3):
            t0 = time.perf_counter()
            stages.append(run_path(videos, params, state, cfg)[3])
            walls.append(time.perf_counter() - t0)
            for v in videos:
                t0 = time.perf_counter()
                run_path([v], params, state, cfg)
                per_video.append(time.perf_counter() - t0)
        wall = statistics.median(walls)
        stage_ms = {k: 1e3 * statistics.median(st[k] for st in stages) for k in stages[0]}
        print(f"main path on {kind} ({smi}): first run {first_s:.3f} s; three videos in one batch "
              f"median {wall:.4f} s = {n_total / wall:.1f} frames/s; per-video p50 "
              f"{1e3 * statistics.median(per_video):.1f} ms over {len(per_video)} runs "
              f"(lengths {VIDEO_LENGTHS}); batch stages median ms {json.dumps(stage_ms)}")
        prof = profile_run(lambda: run_path(videos, params, state, cfg))
        print(f"profile of one batch run: {json.dumps(prof)}")
        print(f"fused_fusion_mlp at M = {n_total} on {smi}: traced in the path {prof.get('mlp_kernel_ms')} ms, "
              f"timing loop {rows['fused_fusion_mlp']['ms']:.4f} ms")
        del feats   # phase 12 runs the videos again
        clock.done("1")

    if "4" in phases:
        knapsack_phase(args.seed, smi)
        clock.done("4")
    if "5" in phases:
        enc, train_runs = spotting_phase(args.seed, smi, launches_by_path)
        clock.done("5")
        if "7" in phases:
            training_phase(enc, train_runs, args.seed, smi, rows, launches_by_path)
            clock.done("7")
        del enc, train_runs
    if "9" in phases:
        infer_phase(args.seed, smi, launches_by_path)
        clock.done("9")
    if "10" in phases:
        training_journey_phase(args.seed, smi, launches_by_path)
        clock.done("10")
    if "12" in phases:
        rows.update(lowp_phase(args.seed, smi, launches_by_path, phase_videos()))
        clock.done("12")
    if "13" in phases:
        text_moe_phase(args.seed, smi, launches_by_path, phase_videos(), rows)
        clock.done("13")
    if "14" in phases:
        backbone_phase(args.seed, smi, launches_by_path, phase_videos())
        clock.done("14")
    if "15" in phases:
        checkpoint_verbs_phase(args.seed, smi, launches_by_path)
        clock.done("15")
    if "16" in phases:
        dp_serving_phase(args.seed, smi, launches_by_path, phase_videos())
        clock.done("16")
    if "17" in phases:
        dp_training_phase(args.seed, smi, launches_by_path)
        clock.done("17")
    if "18" in phases:
        cp_phase(args.seed, smi, launches_by_path, gen)
        clock.done("18")
    if "19" in phases:
        pp_tp_ep_phase(args.seed, smi, launches_by_path, gen)
        clock.done("19")
    if "20" in phases:
        orbax_phase(args.seed, smi, launches_by_path)
        clock.done("20")
    if "21" in phases:
        multihost_phase(args.seed, smi, launches_by_path)
        clock.done("21")
    if "22" in phases:
        examples_phase(args.seed, smi, launches_by_path)
        clock.done("22")
    del videos
    if "11" in phases:
        serving_phase(args.seed, smi, launches_by_path)
        clock.done("11")
    for label, got in launches_by_path.items():   # the float32 paths never take a low-precision form
        if not label.startswith(("summarize_", "infer_preset", "serve_preset", "serve_spotter_int8", "train_bf16",
                                 "backbone_")):   # phase 14a checks the forms of its own labels
            require_not_launched(label, LOWP_FORMS, launches_by_path)
    if args.phases is None:   # every phase ran: every kernel has its row
        require(set(rows) == set(KERNELS), f"kernel rows missing: {sorted(set(KERNELS) - set(rows))}")
    rows = {name: rows[name] for name in KERNELS if name in rows}
    for name in LOWP_FORMS:
        if name not in rows:
            continue
        r = rows[name]
        print(f"kernel {name} on {smi}: max|err| {r['max_abs_err']:.3g}  {r['ms']:.4f} ms  plain "
              f"{r['plain_ms']:.4f} ms  library {r['library_ms']} ms  bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']})", flush=True)
    print(f"total script {time.perf_counter() - t_start:.1f} s")

    table = []
    for name, r in rows.items():
        _, source, replaces = KERNELS[name]
        by_path = {label: got[name] for label, got in launches_by_path.items() if got[name]}
        table.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(by_path.values()), "launches_by_path": by_path, "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "parts": r["parts"],
        })
        if "21" in phases:   # the multi-host paths' ranks counted their own launches
            table[-1]["multihost_phase_21"] = {
                "launches": 0, "why": "the data-parallel train step reaches no Pallas counterpart, as in JAX"}
    print(json.dumps({"kernels": table}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
