#!/usr/bin/env python3
"""Data-parallel serving and training over every visible card, against one card, at reference_parity width.

    python3 tools/dp_four_cards.py [--seed 0]

Needs CUDA cards (it is meant for a machine with four, all to all over
NVLink); run it from the repository root.  It builds the kernels, then runs
two phases of ``chip_smoke.py`` over ``serving_mesh(-1)`` / ``mesh.data = -1``:

* phase 16: the ``Summarizer`` on phase 1's three videos and the banded and
  full-window ``Spotter`` on phase 5's match, each split over every card and
  held to the service on one card (scores within 1e-5, masks and events
  equal but at a rounding boundary or a near tie), with the launch scopes
  each card entered and both walls; then ``serve --dp -1`` answering one
  ``/summarize``;
* phase 17 with a one-rank run beside it: ``train --dp --global-batch 64
  --epochs 1`` over every card on NCCL and the same with ``mesh.data = 1``
  from the same ``ckp``: every step's loss of the two (the first within 1e-4
  relative), rank 0's first-step loss against the loss on one card, and the
  walls.

It prints one JSON line per phase, then the card's name and power limit, and
as its last line ``{"ok": true, "cards": N}``; any failed check raises.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

import chip_smoke as C  # noqa: E402
from cvml_goalnet_tpu_torch import runtime  # noqa: E402
from cvml_goalnet_tpu_torch.ops.cuda import _build  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("dp_four_cards: no CUDA device", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    smi = C.nvidia_smi_line()
    cards = torch.cuda.device_count()
    print(f"cards: {cards} x {torch.cuda.get_device_name(0)} ({smi}); torch {torch.__version__}", flush=True)
    t0 = time.perf_counter()
    _build.build()
    runtime.load()
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    launches: dict = {}
    cfg = C.PipelineConfig.load(str(C.REPO / "configs" / "reference_parity.json"))
    serving = C.dp_serving_phase(args.seed, smi, launches, C.make_videos(cfg, args.seed))
    training = C.dp_training_phase(args.seed, smi, launches, one_rank_too=True)
    print(json.dumps({"serving": serving, "training": training, "total_s": time.perf_counter() - t_start}))
    print(smi)
    print(json.dumps({"ok": True, "cards": cards}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
