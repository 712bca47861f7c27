"""ctypes binding to the hand-written Zstandard decoder (``csrc/zstd_decode.cc``).

The orbax checkpoints the JAX package writes keep every B-tree node and array
chunk as a zstd frame, and the card's machine has neither ``zstandard`` nor a
promised ``libzstd``.  So the port decodes them itself: at first use the
decoder is compiled with ``g++`` and the native runtime's flags
(``runtime.CXX_FLAGS``) into ``cvml_goalnet_tpu_torch/_build/``, under a name
that carries a hash of the source and flags, and loaded with ctypes.  There is
no fallback: without ``g++``, or when the build fails, :func:`load` raises.
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

from cvml_goalnet_tpu_torch.ops.cuda._build import BUILD_DIR, CSRC_DIR
from cvml_goalnet_tpu_torch.runtime import CXX_FLAGS

SOURCE = CSRC_DIR / "zstd_decode.cc"
ERRORS = {
    -2: "corrupt zstd data",
    -3: "zstd output larger than the buffer",
    -4: "zstd content checksum mismatch",
    -5: "truncated zstd frame",
    -6: "unsupported zstd frame (a dictionary or a reserved bit)",
    -7: "no zstd frame",
}
UNKNOWN = -1

_lib: ctypes.CDLL | None = None
_failure: str | None = None
_lock = threading.Lock()   # one build and load per process


class ZstdError(ValueError):
    """A zstd frame the decoder refuses (corrupt, truncated, a checksum mismatch, a dictionary)."""


def lib_path() -> Path:
    """Where the decoder is built, named by a hash of its source and flags."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libgoalnet_zstd-{h.hexdigest()[:16]}.so"


def _build(path: Path) -> None:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the zstd decoder is built from csrc/zstd_decode.cc at first use")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)], capture_output=True, text=True,
                          timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"zstd decoder build failed (g++ exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, path)   # atomic: a concurrent loader sees all or nothing


def load() -> ctypes.CDLL:
    """The loaded decoder, built first if missing; raises when it cannot be built (no other decoder is tried)."""
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
            _failure = f"zstd decoder unavailable: {exc}"
            raise RuntimeError(_failure) from exc
        lib.goalnet_zstd_content_size.restype = ctypes.c_int64
        lib.goalnet_zstd_content_size.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.goalnet_zstd_decode.restype = ctypes.c_int64
        lib.goalnet_zstd_decode.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64]
        _lib = lib
        return lib


def _check(code: int) -> int:
    if code < 0 and code != UNKNOWN:
        raise ZstdError(ERRORS.get(code, f"zstd error {code}"))
    return code


def content_size(data) -> int | None:
    """The decoded size of every frame in ``data`` when their headers state it, else None."""
    src = np.frombuffer(data, dtype=np.uint8)
    size = _check(load().goalnet_zstd_content_size(src.ctypes.data, src.size))
    return None if size == UNKNOWN else size


def decompress_into(data, out: np.ndarray) -> int:
    """Decode every frame of ``data`` into the contiguous array ``out``; the bytes written.  The GIL is released
    while the decoder runs, so threads decode chunks side by side."""
    src = np.frombuffer(data, dtype=np.uint8)
    if not out.flags.c_contiguous:
        raise ValueError("the output array must be C-contiguous")
    return _check(load().goalnet_zstd_decode(src.ctypes.data, src.size, out.ctypes.data, out.nbytes))


def decompress(data, max_size: int = 1 << 31) -> bytes:
    """Decode every frame of ``data``: into a buffer of the headers' content size when they state it, else into
    one that grows until the output fits; either at most ``max_size`` bytes."""
    size = content_size(data)
    if size is not None:
        if size > max_size:
            raise ZstdError(f"zstd content of {size} bytes is past the {max_size}-byte limit")
        out = np.empty((max(size, 1),), dtype=np.uint8)
        return out[:decompress_into(data, out)].tobytes()
    cap = min(max(4 * len(data), 1 << 16), max_size)
    while True:
        out = np.empty((cap,), dtype=np.uint8)
        try:
            return out[:decompress_into(data, out)].tobytes()
        except ZstdError as e:
            if str(e) != ERRORS[-3] or cap >= max_size:
                raise
            cap = min(2 * cap, max_size)
