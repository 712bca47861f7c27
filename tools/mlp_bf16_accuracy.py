#!/usr/bin/env python3
"""How close 4-bf16 (the bf16 fusion MLP kernel) and its plain version come to exact sums, on the card.

    python3 tools/mlp_bf16_accuracy.py [--seeds 20]

Needs a CUDA card and ``nvcc``.  Both the kernel and the plain version round
each layer as the JAX package's bf16 forward does, bf16(bf16(x·w) + b), from
float32 sums taken in different orders; a sum that lands near a bf16 tie
rounds one way or the other, and the chain carries the flip on.  This holds
both to the same chain with its sums taken in float64 (the reference of
neither) over ``--seeds`` seeded inputs at three shapes (raw logits, 16 and 5
wide, and the squashed 1050-row batch) and prints, for each side, the inputs
where some output is past 2 bf16 ulps of the float64 chain, the outputs past
2 ulps, and the outputs that differ at all; then the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from cvml_goalnet_tpu_torch.ops.cuda import fused_mlp as M  # noqa: E402
from cvml_goalnet_tpu_torch.utils import bf16_rounded  # noqa: E402

CASES = ((150, (640, 512, 512, 256, 128, 16), False), (40, (640, 512, 512, 256, 128, 5), False),
         (1050, (640, 512, 512, 256, 128, 1), True))


def float64_chain(x, layers, squash: bool) -> torch.Tensor:
    h = x.double()
    for i, lp in enumerate(layers):
        h = bf16_rounded(bf16_rounded((h @ lp["w"].double()).float()) + lp["b"].float()).double()
        if i < len(layers) - 1:
            h = torch.relu(h)
    h = h.float()
    return (M.squash_bf16(h, 1.0, 5.0) if squash else h).to(torch.bfloat16)


def past(got: torch.Tensor, want: torch.Tensor) -> list[int]:
    """[any output past 2 bf16 ulps of max(|got|, |want|), how many, how many differ]."""
    g, w = got.float(), want.float()
    ulp = torch.exp2(torch.floor(torch.log2(torch.maximum(g.abs(), w.abs()).clamp_min(2.0 ** -126))) - 7)
    n = int(((g - w).abs() > 2 * ulp + 1e-6 * w.abs().max()).sum())
    return [int(n > 0), n, int((g != w).sum())]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("mlp_bf16_accuracy: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    totals = {"kernel": np.zeros(3, dtype=np.int64), "plain": np.zeros(3, dtype=np.int64)}
    for seed in range(11, 11 + args.seeds):
        for m, dims, squash in CASES:
            gen = np.random.default_rng(seed)
            layers = [{"w": torch.as_tensor(gen.standard_normal((a, c)) * a ** -0.5 * 2, dtype=torch.bfloat16, device=dev),
                       "b": torch.as_tensor(gen.standard_normal(c) * 0.1, dtype=torch.bfloat16, device=dev)}
                      for a, c in zip(dims[:-1], dims[1:])]
            x = torch.as_tensor(gen.random((m, dims[0])), dtype=torch.bfloat16, device=dev)
            exact = float64_chain(x, layers, squash)
            totals["kernel"] += past(M.fused_fusion_mlp_bf16(x, layers, 1.0, 5.0, squash), exact)
            totals["plain"] += past(M.fused_fusion_mlp_bf16_plain(x, layers, 1.0, 5.0, squash), exact)
    print(json.dumps({side: dict(zip(("inputs_past_2_ulps", "outputs_past_2_ulps", "outputs_differing"), t.tolist()))
                      for side, t in totals.items()} | {"inputs": args.seeds * len(CASES)}))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
