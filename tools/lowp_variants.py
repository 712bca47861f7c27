#!/usr/bin/env python3
"""Where the wgmma conv-pool forms' time goes on the card: variant builds with parts switched off.

    python3 tools/lowp_variants.py [--reps 20] [--rounds 2] [--forms int8 bf16]

Needs a CUDA card and ``nvcc``.  It copies ``csrc/fused_stage_lowp.cu`` and the
headers into ``cvml_goalnet_tpu_torch/_build/variants/<name>/``, edits each copy
by a text replacement, builds it with the port's own ``nvcc`` flags, loads it
with ctypes and times, on the device alone (queued behind a spin), the whole
int8 call (``fused_conv_pool_stage_int8``: the amax pass, the quantize pass,
the weight pack and the conv, x in float32) and the bf16 call
(``fused_conv_pool_stage_bf16``: the conv alone, w read as stored) at conv1
(13×13, 64→256) and conv2 (11×11, 256→512) of N = 1050 frames, the variants in
turns, ``--rounds`` times.  Both forms are one kernel template, so each
variant edits both.  The variants:

* ``full``: the source as it is;
* ``no_mma``: the ``wgmma`` skipped (the ring, the A loads and the barriers run);
* ``no_epilogue``: the block returns after its main loop;
* ``no_mma_no_epilogue``: both;
* ``no_pool``: the conv tile is written but not pooled or stored;
* ``k64``: conv2 on 64-byte weight stages rather than 128 (both forms: int8
  (2, 128, 64), bf16 (2, 128, 64), 32 channels a stage and twice the stages).

Each variant's output is wrong by construction except ``full`` and ``k64``,
which are held to the plain version (int8 to the bit, bf16 within 2 bf16
ulps).  It prints one JSON line per round and the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from cvml_goalnet_tpu_torch.ops.cuda import _build  # noqa: E402
from cvml_goalnet_tpu_torch.ops.cuda import fused_stage as FS  # noqa: E402

SOURCE = _build.CSRC_DIR / "fused_stage_lowp.cu"
SHAPES = ((1050, 13, 64, 256), (1050, 11, 256, 512))


def _replace(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise SystemExit(f"the source no longer holds one copy of {old[:60]!r}: update tools/lowp_variants.py")
    return src.replace(old, new)


def _no_mma(src):
    return _replace(src, "      for (int i = 0; i < MT; ++i) Form::template mma<BN>(acc[i], af[i][kk], db);",
                    "      for (int i = 0; i < MT; ++i) if (db == 1) Form::template mma<BN>(acc[i], af[i][kk], db);")


def _no_epilogue(src):
    return _replace(src, "  __syncthreads();   // both warpgroups are done with the ring and the input tile: the conv tile reuses them",
                    "  if (acc[0][0] == 12345 && acc[MT - 1][BN / 2 - 1] == 777) store1(out, 1.f);\n  return;")


def _no_pool(src):
    return _replace(src, "  for (int e = tid; e < g.frames * g.cols * (BN / 4); e += kWThreads) {",
                    "  for (int e = tid; e < g.frames * g.cols * (BN / 4) * (g.n == -1); e += kWThreads) {")


def _k64(src):
    src = _replace(src, "  if (m_tiles == 2 && cin_p % 128 == 0)", "  if (m_tiles == 2 && cin_p % 128 == 0 && n < 0)")
    src = _replace(src, "  const int kb = m_tiles == 2 ? 128 : 64;", "  const int kb = 64;")
    return _replace(src, "  if (m_tiles == 2) return launch_wgmma<Bf16Form, 2, 128, 128>(",
                    "  if (m_tiles == 2) return launch_wgmma<Bf16Form, 2, 128, 64>(")


VARIANTS = {
    "full": lambda s: s,
    "no_mma": _no_mma,
    "no_epilogue": _no_epilogue,
    "no_mma_no_epilogue": lambda s: _no_mma(_no_epilogue(s)),
    "no_pool": _no_pool,
    "k64": _k64,
}


def build(name: str, src: str):
    d = _build.BUILD_DIR / "variants" / name
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    for header in _build.CSRC_DIR.glob("*.cuh"):
        shutil.copy(header, d)
    (d / SOURCE.name).write_text(src)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(d), "-o", str(d / "lib.so"), str(d / SOURCE.name)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), d


def device_ms(fn, reps: int) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)   # the card stays busy while the host queues the calls
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bf16_ulps(got: torch.Tensor, want: torch.Tensor, scale: torch.Tensor) -> float:
    """The largest |got − want| in bf16 ulps of max(|got|, |want|, scale), past 1e-6·max|want| (chip_smoke.py's
    measure)."""
    g, w = got.float(), want.float()
    ref = torch.maximum(torch.maximum(g.abs(), w.abs()), scale)
    ulp = torch.exp2(torch.floor(torch.log2(ref.clamp_min(2.0 ** -126))) - 7)
    return float(((g - w).abs() - 1e-6 * w.abs().max()).clamp_min(0).div(ulp).max())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--forms", nargs="+", default=["int8", "bf16"], choices=["int8", "bf16"])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("lowp_variants: no CUDA device", file=sys.stderr)
        return 1
    source = SOURCE.read_text()
    procs = {name: build(name, edit(source)) for name, edit in VARIANTS.items()}
    libs = {}
    p, i = ctypes.c_void_p, ctypes.c_int
    for name, (proc, d) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(log[-4000:], file=sys.stderr)
            return 1
        serialized = [line.strip() for line in log.splitlines() if "C75" in line]
        if serialized:
            print(f"{name}: ptxas {serialized}")
        lib = ctypes.CDLL(str(d / "lib.so"))
        lib.fused_conv_pool_stage_int8.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, i, i, i, i, p, p]
        lib.fused_conv_pool_stage_bf16.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, i, i, i, p]
        lib.fused_conv_pool_stage_int8.restype = lib.fused_conv_pool_stage_bf16.restype = ctypes.c_int
        libs[name] = lib

    dev = torch.device("cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    for n, hh, cin, cout in SHAPES:
        x = torch.randn((n, hh, hh, cin), generator=gen, device=dev).relu()
        w = torch.randn((3, 3, cin, cout), generator=gen, device=dev) * 0.05
        b = torch.randn((hh, hh, cout), generator=gen, device=dev) * 0.1
        if "int8" in args.forms:
            cases.append(("int8", n, hh, cin, cout, x, w, b, FS.fused_conv_pool_stage_int8_plain(x, w, b),
                          FS.card_int8_stage_plan(n, hh, hh, cin, cout, dev)))
        if "bf16" in args.forms:
            xb, wb, bb = x.to(torch.bfloat16), w.to(torch.bfloat16), b.to(torch.bfloat16)
            cases.append(("bf16", n, hh, cin, cout, xb, wb, bb, FS.fused_conv_pool_stage_bf16_plain(xb, wb, bb),
                          FS.card_bf16_stage_plan(n, hh, hh, cin, cout, dev)))
    for rnd in range(args.rounds):
        line = {}
        for name, lib in libs.items():
            for form, n, hh, cin, cout, x, w, b, want, plan in cases:
                out = torch.empty_like(want)
                if form == "int8":
                    ws = torch.empty(FS.int8_workspace_bytes(n, hh, hh, cin, cout), dtype=torch.uint8, device=dev)

                    def call():
                        code = lib.fused_conv_pool_stage_int8(
                            x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), ws.data_ptr(), n, hh, hh, cin,
                            cout, 0, plan.frames, plan.rows, plan.cols, plan.m_tiles, plan.block_n, None,
                            torch.cuda.current_stream().cuda_stream)
                        if code:
                            raise RuntimeError(f"{name}: CUDA error {code}")
                else:
                    def call():
                        code = lib.fused_conv_pool_stage_bf16(
                            x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), n, hh, hh, cin, cout, cout,
                            plan.frames, plan.rows, plan.cols, plan.m_tiles, plan.block_n,
                            torch.cuda.current_stream().cuda_stream)
                        if code:
                            raise RuntimeError(f"{name}: CUDA error {code}")

                call()
                torch.cuda.synchronize()
                if name in ("full", "k64"):
                    if form == "int8" and not torch.equal(out, want):
                        raise AssertionError(f"{name} int8 at {[n, hh, cin, cout]}: differs from the plain version")
                    window = F.max_pool2d(b.float().abs().permute(2, 0, 1)[None], 3, 1)[0].permute(1, 2, 0)[None]
                    if form == "bf16" and bf16_ulps(out, want, 2 * window) > 2:
                        raise AssertionError(f"{name} bf16 at {[n, hh, cin, cout]}: past 2 bf16 ulps of the plain version")
                line[f"{name} {form} {hh}x{hh} {cin}->{cout}"] = device_ms(call, args.reps)
        print(json.dumps({"round": rnd, "device_ms": line}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
