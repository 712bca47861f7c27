#!/usr/bin/env python3
"""How far two runs of the summarization train function part, on the CPU, at full width.

    python3 tools/train_divergence.py [--frames 150] [--eps 1e-4]

One seeded video (uniform 40×40 frames and MFCCs, labels the rounded mean
of 20 seeded annotators) through ``train/loop.py::make_train_video_fn`` of
``configs/reference_parity.json`` at dropout 0, one sub-batch at a time, three
ways from one seeded state: in float64, in float32, and in float32 with the
frames scaled by 1 + 1.2e-7 (one float32 step).  It prints each sub-batch's
loss in float64 and the relative gaps of the other two to it and to each
other.  A run whose gaps grow far past rounding while float32 and float64
agree says the trajectory jumps at near-ties (a max-pool window whose two
largest values lie within rounding of each other sends the gradient the
other way, and Adam carries the difference on); that is why ``chip_smoke.py``
holds the card's epoch losses to the CPU's at the card's parameters, not to
a free-running CPU epoch.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from cvml_goalnet_tpu_torch.config import PipelineConfig  # noqa: E402
from cvml_goalnet_tpu_torch.data.dataset import VideoItem  # noqa: E402
from cvml_goalnet_tpu_torch.train import loop  # noqa: E402
from cvml_goalnet_tpu_torch.train.optim import AdamState, tree_map  # noqa: E402
from cvml_goalnet_tpu_torch.train.state import create_train_state  # noqa: E402


def run(cfg, item, dtype, scale: float) -> np.ndarray:
    """The video's sub-batch losses in ``dtype``, the frames multiplied by ``scale``."""
    st = create_train_state(0, cfg, device="cpu")
    cast = lambda tree: tree_map(lambda t: t.to(dtype), tree)   # noqa: E731
    params, ms = cast(st.params), cast(st.model_state)
    opt = AdamState(0, cast(st.opt_state.mu), cast(st.opt_state.nu))
    fn = loop.make_train_video_fn(cfg)
    S = cfg.train.subbatch_size
    v, a, lab, valid, _ = loop._pad_video(item, S, torch.device("cpu"))
    v, a, lab, valid = v.to(dtype) * torch.tensor(scale, dtype=dtype), a.to(dtype), lab.to(dtype), valid.to(dtype)
    losses = []
    for i in range(len(v) // S):
        sl = slice(i * S, (i + 1) * S)
        params, ms, opt, _, loss = fn(params, ms, opt, v[sl], a[sl], lab[sl], valid[sl], None)
        losses.append(float(loss))
    return np.array(losses)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=150)
    ap.add_argument("--eps", type=float, default=1e-4, help="Adam's eps")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = PipelineConfig.load(os.path.join(repo, "configs", "reference_parity.json"))
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, dropout_rate=0.0),
                              train=dataclasses.replace(cfg.train, eps=args.eps))
    rng = np.random.default_rng(args.seed)
    n = args.frames
    h, w = cfg.preprocess.frame_size
    item = VideoItem(
        video_id="v", title="v", visual=torch.as_tensor(rng.random((n, h, w, 3)).astype(np.float32)),
        audio=torch.as_tensor(rng.standard_normal((n, cfg.audio.bin_length, cfg.audio.n_mfcc)).astype(np.float32)),
        labels=np.round(rng.integers(1, 6, (20, n)).mean(0)).astype(np.float32), gd_summary_masks=None,
        full_n_frames=n * cfg.preprocess.skip_frames, clip_intervals=np.array([[0, n * cfg.preprocess.skip_frames]]))
    f64 = run(cfg, item, torch.float64, 1.0)
    f32 = run(cfg, item, torch.float32, 1.0)
    nudged = run(cfg, item, torch.float32, float(np.float32(1) + np.finfo(np.float32).eps))
    print(f"sub-batch losses, float64: {f64.tolist()}")
    print(f"float32 vs float64, relative: {(np.abs(f32 - f64) / f64).tolist()}")
    print(f"float32 with the frames × (1 + 1.2e-7) vs float32, relative: {(np.abs(nudged - f32) / f32).tolist()}")
    print(f"largest: float32 vs float64 {np.max(np.abs(f32 - f64) / f64):.3g}; nudged vs float32 "
          f"{np.max(np.abs(nudged - f32) / f32):.3g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
