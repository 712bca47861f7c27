"""Build the port's CUDA kernels with ``nvcc`` and load them through ``ctypes``.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a plain
C interface (``-gencode arch=compute_90a,code=sm_90a``), at first use, into
``cvml_goalnet_tpu_torch/_build/``.  A library's file name carries a hash of
its sources and flags, so an edited kernel is rebuilt and a stale one is never
loaded.  :func:`build` starts one ``nvcc`` per missing library, all at once.
Both :func:`build` and :func:`load` hold a lock per kernel, so however many
threads ask for a kernel at once, one ``nvcc`` builds it and all get it.

There is no fallback: without ``nvcc``, or when a build fails, this raises.
Every C entry returns ``cudaGetLastError()`` after its launches;
:func:`check` turns a non-zero code into an exception.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
KERNELS = ("fused_preprocess", "fused_stage", "fused_stage_lowp", "matmul", "fused_mlp", "flash_attention")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: dict[str, ctypes.CDLL] = {}
_locks: dict[str, threading.RLock] = {}
_locks_guard = threading.Lock()


def _lock(name: str) -> threading.RLock:
    """The lock of one kernel's build and load (reentrant: :func:`load` builds under it)."""
    with _locks_guard:
        return _locks.setdefault(name, threading.RLock())


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found (PATH or /usr/local/cuda/bin): the port's CUDA kernels "
        "are built from csrc/ at first use and have no fallback"
    )


def lib_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` is built, named by a hash of its inputs."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in (CSRC_DIR / f"{name}.cu", *sorted(CSRC_DIR.glob("*.cuh"))):
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=KERNELS) -> dict[str, float]:
    """Compile every named kernel whose library is missing, one ``nvcc`` each, concurrently.

    Returns the wall seconds until each build finished (empty when all were
    built).  The ``-Xptxas -v`` report (registers, shared memory, spills) of
    each build is kept in ``_build/<name>.log``.
    """
    with contextlib.ExitStack() as held:
        for n in sorted(set(names)):   # one order for every thread: no deadlock between overlapping sets
            held.enter_context(_lock(n))
        return _build_locked([n for n in names if not lib_path(n).exists()])


def _build_locked(todo: list[str]) -> dict[str, float]:
    if not todo:
        return {}
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs, seconds, failed = {}, {}, []
    try:
        for n in todo:
            tmp = lib_path(n).with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")   # unique per thread
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", str(tmp), str(CSRC_DIR / f"{n}.cu")]
            procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp)
        for n, (proc, tmp) in procs.items():
            log, _ = proc.communicate()
            (BUILD_DIR / f"{n}.log").write_text(log)
            if proc.returncode != 0:
                failed.append(f"{n} (nvcc exit {proc.returncode}):\n{log}")
                tmp.unlink(missing_ok=True)
                continue
            os.replace(tmp, lib_path(n))  # atomic: a concurrent loader sees all or nothing
            seconds[n] = time.perf_counter() - t0
    finally:
        for proc, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return seconds


def load(name: str, signatures: dict[str, list]) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built first if missing).

    ``signatures`` maps each C entry to its ``argtypes``; every entry returns
    an ``int`` CUDA error code.
    """
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    with _lock(name):
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(lib_path(name)))
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            lib.goalnet_cuda_error_string.argtypes = [ctypes.c_int]
            lib.goalnet_cuda_error_string.restype = ctypes.c_char_p
            _loaded[name] = lib
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise when a C entry reported a CUDA error."""
    if code != 0:
        msg = lib.goalnet_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def require_dtype(what: str, device: torch.device, dtype: torch.dtype, **tensors: torch.Tensor) -> None:
    """Raise unless every tensor is contiguous ``dtype`` on ``device``: what a form of a kernel takes (no
    tensor is ever cast for it)."""
    for name, t in tensors.items():
        if t.dtype != dtype or not t.is_contiguous() or t.device != device:
            raise ValueError(f"{what}: {name} must be contiguous {str(dtype).removeprefix('torch.')} on {device}, "
                             f"got {t.dtype} on {t.device}")


def refuse_grad(what: str, *tensors: torch.Tensor) -> None:
    """Raise when autograd would record a forward-only kernel: its output has no ``grad_fn``, so the
    gradient would stop there without a word.  Training takes the differentiable path instead."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what}: the kernel has no backward and its output would cut the gradient; call it under "
            "torch.no_grad() or on tensors that do not require grad (training takes the differentiable path)"
        )


def stream_of(t: torch.Tensor) -> int:
    """The raw ``cudaStream_t`` of PyTorch's current stream on ``t``'s device (the accessor compiled code uses:
    ``torch.cuda.current_stream`` builds a Stream object, some microseconds of every launch)."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def on_device(t: torch.Tensor) -> contextlib.AbstractContextManager:
    """The scope that makes ``t``'s card current: a ctypes launch runs on the current device, and
    :func:`stream_of` gives the stream of ``t``'s, so every launch enters this first.  Nothing to do, and no
    switch paid for, when the card is current already."""
    if t.device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(t.device)


def device_index(device: torch.device) -> int:
    """The card's index: ``cuda`` alone names the current one."""
    device = torch.device(device)
    return torch.cuda.current_device() if device.index is None else device.index
