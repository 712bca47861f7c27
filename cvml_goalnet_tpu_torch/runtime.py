"""ctypes bindings to the native (C++) host runtime in the repository's ``runtime/``.

Port of ``cvml_goalnet_tpu/runtime/__init__.py``: the knapsack solver
(``runtime/knapsack.cc``, reference ``utils.py:466-510``), the whole
summarize postprocess in one call (``runtime/postprocess.cc``) and the WAV
reader (``runtime/wav.cc``, the file-loading half of reference
``utils.py:320``).  At first use
the library is compiled from ``knapsack.cc``, ``wav.cc`` and
``postprocess.cc`` with ``g++`` and the flags of ``runtime/Makefile`` into
``cvml_goalnet_tpu_torch/_build/``, under a name that carries a hash of the
sources and flags, and loaded with ctypes.  Nothing is written to
``runtime/build/``, and nothing of the JAX package is imported: importing its
``runtime`` would run its ``__init__.py``, and with it jax.

:func:`native_available` says whether the library builds here (the ``"auto"``
engine asks it); :func:`load` raises when it cannot be built, so an explicit
``"native"`` or ``"native-full"`` engine never runs something else instead.
:func:`wav_read_native` returns None when the library cannot be built, as the
JAX package's does: ``data/audio_io.py`` then reads the file with scipy.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

from cvml_goalnet_tpu_torch.ops.cuda._build import BUILD_DIR

RUNTIME_DIR = Path(__file__).resolve().parents[1] / "runtime"
SOURCES = ("knapsack.cc", "wav.cc", "postprocess.cc")
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall", "-Wextra", "-shared")   # runtime/Makefile's

_lib: ctypes.CDLL | None = None
_failure: str | None = None   # why the library could not be built, kept so a failed build is tried once
_lock = threading.Lock()      # one build and load per process, however many threads ask at once


def lib_path() -> Path:
    """Where the library is built, named by a hash of its sources and flags."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for name in SOURCES:
        h.update((RUNTIME_DIR / name).read_bytes())
    return BUILD_DIR / f"libgoalnet_runtime-{h.hexdigest()[:16]}.so"


def _build(path: Path) -> None:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native runtime is built from runtime/*.cc at first use")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")   # unique per process and thread
    cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), *(str(RUNTIME_DIR / name) for name in SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native runtime build failed (g++ exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, path)   # atomic: a concurrent loader sees all or nothing


def load() -> ctypes.CDLL:
    """The loaded runtime library, built first if missing; raises when it cannot be built.

    Thread-safe: the first caller builds and loads under a lock, and callers
    that waited on it get that library (or that build's failure).
    """
    global _lib, _failure
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        if _failure is not None:
            raise RuntimeError(_failure)
        try:
            path = lib_path()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
        except (OSError, RuntimeError, subprocess.SubprocessError) as exc:
            _failure = f"native runtime unavailable: {exc}"
            raise RuntimeError(_failure) from exc
        lib.goalnet_knapsack.restype = ctypes.c_int32
        lib.goalnet_knapsack.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int64), ctypes.c_int32, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.goalnet_summarize.restype = ctypes.c_int32
        lib.goalnet_summarize.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int32, ctypes.POINTER(ctypes.c_int64), ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int64, ctypes.c_double, ctypes.c_int32, ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.goalnet_wav_info.restype = ctypes.c_int
        lib.goalnet_wav_info.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64)]
        lib.goalnet_wav_read.restype = ctypes.c_int64
        lib.goalnet_wav_read.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64]
        _lib = lib
        return lib


def native_available() -> bool:
    """Whether the runtime builds and loads here (built at the first ask)."""
    try:
        load()
    except RuntimeError:
        return False
    return True


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def knapsack_native(values: np.ndarray, int_weights: np.ndarray, int_capacity: int) -> list[int]:
    """The C++ DP and the reference's traceback (``runtime/knapsack.cc``): selected indices, ascending."""
    lib = load()
    values = np.ascontiguousarray(values, dtype=np.float64)
    weights = np.ascontiguousarray(int_weights, dtype=np.int64)
    out = np.empty((len(values),), dtype=np.int32)
    count = lib.goalnet_knapsack(_ptr(values, ctypes.c_double), _ptr(weights, ctypes.c_int64), len(values),
                                 int(int_capacity), _ptr(out, ctypes.c_int32))
    return out[:count].tolist()


def summarize_native(importances, intervals, skip_frames: int, full_n_frames: int, summary_ratio: float,
                     inclusive_mask: bool) -> tuple[list[int], np.ndarray] | None:
    """The whole postprocess (round → expand → clip sums → knapsack → mask) in one C++ call
    (``runtime/postprocess.cc``): (selected clips, (full_n_frames,) uint8 mask), or None when the call refuses
    its arguments (no scores, no frames), as the JAX package's ``summarize_native`` returns."""
    lib = load()
    imp = np.ascontiguousarray(np.asarray(importances).reshape(-1), dtype=np.float32)
    iv = np.ascontiguousarray(np.asarray(intervals, dtype=np.int64).reshape(-1, 2))
    mask = np.zeros((max(int(full_n_frames), 0),), dtype=np.uint8)
    selected = np.empty((max(len(iv), 1),), dtype=np.int32)
    count = lib.goalnet_summarize(_ptr(imp, ctypes.c_float), len(imp), _ptr(iv, ctypes.c_int64), len(iv),
                                  int(skip_frames), int(full_n_frames), float(summary_ratio), int(bool(inclusive_mask)),
                                  _ptr(mask, ctypes.c_uint8), _ptr(selected, ctypes.c_int32))
    if count < 0:
        return None
    return selected[:count].tolist(), mask


def wav_read_native(path: str) -> tuple[np.ndarray, int] | None:
    """A WAV file → (mono float32 samples, sample rate) by ``runtime/wav.cc``; None when the library cannot be
    built here or the file is not a WAV it reads (``data/audio_io.py`` then tries scipy)."""
    try:
        lib = load()
    except RuntimeError:
        return None
    info = np.zeros((2,), dtype=np.int64)
    if lib.goalnet_wav_info(path.encode(), _ptr(info, ctypes.c_int64)) != 0 or info[1] <= 0:
        return None
    out = np.empty((int(info[1]),), dtype=np.float32)
    if lib.goalnet_wav_read(path.encode(), _ptr(out, ctypes.c_float), len(out)) < 0:
        return None
    return out, int(info[0])
