#!/usr/bin/env python3
"""Multi-host training over four H100s of one machine: two host processes of two cards each, against one
process with all four.

    python3 tools/multihost_four_cards.py          # from the repository root, on a machine with four cards
    python3 tools/multihost_four_cards.py --cpu    # the same on four gloo ranks of the CPU (a rehearsal)

It runs the path of ``examples/multihost_train_torch.py`` (three ``make_dp_train_step`` steps of the example's
tiny config, a global batch of 16 rows):

1. one host process with the four cards (global ranks 0-3 on ``cuda:0``-``cuda:3``), its ranks on NCCL joined
   through a ``TCPStore`` on ``127.0.0.1``: the steps over the world, then on ``build_multislice_mesh``'s grid
   (1, 4, 1);
2. two host processes (this script again, ``--host 0`` and ``--host 1``), process p with ``cuda:2p`` and
   ``cuda:2p+1`` (global ranks 2p and 2p + 1), joined through one ``TCPStore``: cross-process NCCL, the same
   steps over the world, then on the grid (2, 2, 1), one slice a process, the gradients summed over data
   (inside each process's pair of cards), then over slice.

Each run's losses must be within 1e-6 relative of run 1's over the world.  It prints each run's walls (each
host process from its start to its exit, and each ``run`` of the steps, spawning its ranks included) beside
the card's name and power limit, and as the last line ``{"ok": true, ...}``; any miss exits 1.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "examples"))

import torch  # noqa: E402

import multihost_train_torch as example  # noqa: E402
from cvml_goalnet_tpu_torch.parallel import multihost  # noqa: E402

CARDS, HOSTS = 4, 2
TOL = 1e-6


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def local_devices(cpu: bool, first: int, count: int) -> list:
    return [torch.device("cpu")] * count if cpu else [torch.device("cuda", first + i) for i in range(count)]


def steps(mesh) -> dict:
    """The example's steps over the world and on the grid → their losses and walls."""
    out = {}
    for name, multislice in (("world", False), ("grid", True)):
        t0 = time.perf_counter()
        out[name] = example.run(mesh, multislice=multislice)
        out[f"{name}_run_s"] = time.perf_counter() - t0
    return out


def host_main(args) -> int:
    """One of the two host processes: its pair of cards, the steps, its output as JSON."""
    t0 = time.perf_counter()
    multihost.initialize_from_env(f"127.0.0.1:{args.port}", HOSTS, args.host, timeout=300)
    try:
        per = CARDS // HOSTS
        mesh = multihost.global_data_mesh(local=local_devices(args.cpu, args.host * per, per))
        out = {"host": args.host, "local": [str(d) for d in mesh.local], "ranks": mesh.size, **steps(mesh)}
    finally:
        multihost.shutdown()
    out["process_s"] = time.perf_counter() - t0
    with open(args.out, "w") as f:
        json.dump(out, f)
    return 0


def smi_line() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def rel_diff(a: list, b: list) -> float:
    return max(abs(x - y) / abs(y) for x, y in zip(a, b))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true", help="four gloo ranks of the CPU instead of four cards")
    ap.add_argument("--host", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--out", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.host is not None:
        return host_main(args)
    if not args.cpu and torch.cuda.device_count() < CARDS:
        print(f"multihost_four_cards: needs {CARDS} cards, {torch.cuda.device_count()} visible", file=sys.stderr)
        return 1
    smi = smi_line() if not args.cpu else "cpu"
    print(f"cards: {smi} | torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    multihost.initialize_from_env(f"127.0.0.1:{free_port()}", 1, 0, timeout=300)
    try:
        one = steps(multihost.global_data_mesh(local=local_devices(args.cpu, 0, CARDS)))
    finally:
        multihost.shutdown()
    one["process_s"] = time.perf_counter() - t0
    print(f"one host process, {CARDS} ranks: {json.dumps(one)}", flush=True)

    port = free_port()
    with tempfile.TemporaryDirectory() as tmp:
        outs = [os.path.join(tmp, f"host{p}.json") for p in range(HOSTS)]
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--host", str(p), "--port", str(port),
                                   "--out", outs[p], *(["--cpu"] if args.cpu else [])], cwd=REPO)
                 for p in range(HOSTS)]
        codes = [p.wait(timeout=900) for p in procs]
        two_s = time.perf_counter() - t0
        if any(codes):
            print(f"multihost_four_cards: a host process exited {codes}", file=sys.stderr)
            return 1
        hosts = []
        for out in outs:
            with open(out) as f:
                hosts.append(json.load(f))
    print(f"two host processes of {CARDS // HOSTS} ranks, {two_s:.1f} s from start to exit: {json.dumps(hosts)}",
          flush=True)

    want = one["world"]
    diffs = {"one_process_grid": rel_diff(one["grid"], want)}
    for h in hosts:
        diffs[f"host{h['host']}_world"] = rel_diff(h["world"], want)
        diffs[f"host{h['host']}_grid"] = rel_diff(h["grid"], want)
    summary = {"cards": smi, "one_process": {"world": want, "grid": one["grid"], "walls_s": {
                   k: one[k] for k in ("world_run_s", "grid_run_s", "process_s")}},
               "two_processes": {"world": hosts[0]["world"], "grid": hosts[0]["grid"], "start_to_exit_s": two_s,
                                 "walls_s": [{k: h[k] for k in ("world_run_s", "grid_run_s", "process_s")}
                                             for h in hosts]},
               "max_rel_diff": diffs, "bit_equal_world": all(h["world"] == want for h in hosts)}
    print(json.dumps(summary), flush=True)
    bad = {k: v for k, v in diffs.items() if v > TOL}
    if bad:
        print(f"multihost_four_cards: losses past {TOL} relative of one process's: {bad}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "max_rel_diff": max(diffs.values())}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
