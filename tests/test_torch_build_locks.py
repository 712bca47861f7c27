"""PyTorch port: first-use builds are safe across threads, on the CPU.

Serving launches kernels and calls the native knapsack from several threads
at once (HTTP handlers and the batcher's worker), so the first use of the
native runtime (``runtime.load``, built with ``g++``) and of each CUDA kernel
(``ops/cuda/_build.build`` / ``load``, built with ``nvcc``) may come from
several threads together.  Each must build once, into a temporary file of
its own, and hand every waiting thread the one library.  There is no
``nvcc`` here: the kernel builds run a stub compiler that sleeps, writes its
``-o`` file and counts its runs.
"""

from __future__ import annotations

import ctypes
import os
import stat
import sys
import threading
from concurrent.futures import ThreadPoolExecutor

import pytest

from cvml_goalnet_tpu_torch import runtime
from cvml_goalnet_tpu_torch.ops.cuda import _build

THREADS = 4


def _together(fn, n: int = THREADS) -> list:
    """``fn()`` from ``n`` threads released at once → each thread's result or exception."""
    gate = threading.Barrier(n)

    def one(_):
        gate.wait()
        try:
            return fn()
        except Exception as e:   # noqa: BLE001 - the test inspects what each thread got
            return e

    with ThreadPoolExecutor(n) as pool:
        return list(pool.map(one, range(n)))


class TestNativeRuntime:
    def test_concurrent_first_load_builds_once(self, tmp_path, monkeypatch):
        """Four threads call ``runtime.load()`` against an empty build directory: all four get the one library,
        ``g++`` ran once and no failure is kept.  (Before the lock, two of four raised ``No such file or
        directory`` on the shared temporary file, and the failure stuck for the process.)"""
        monkeypatch.setattr(runtime, "BUILD_DIR", tmp_path)
        monkeypatch.setattr(runtime, "_lib", None)
        monkeypatch.setattr(runtime, "_failure", None)
        runs = []
        real = runtime._build

        def counted(path):
            runs.append(path)
            real(path)

        monkeypatch.setattr(runtime, "_build", counted)
        got = _together(runtime.load)
        assert not [g for g in got if isinstance(g, Exception)], got
        assert all(g is got[0] for g in got)
        assert len(runs) == 1
        assert runtime._failure is None
        assert [p.name for p in tmp_path.iterdir()] == [runtime.lib_path().name]   # no temporary file left

    def test_temporary_file_is_unique_per_thread(self, tmp_path, monkeypatch):
        """Two threads building at once (as two processes may) write different temporary files."""
        seen = []

        def fake_run(cmd, **kw):
            seen.append(cmd[cmd.index("-o") + 1])
            open(cmd[cmd.index("-o") + 1], "wb").close()
            return type("P", (), {"returncode": 0, "stderr": ""})()

        monkeypatch.setattr(runtime, "BUILD_DIR", tmp_path)
        monkeypatch.setattr(runtime.subprocess, "run", fake_run)
        monkeypatch.setattr(runtime.shutil, "which", lambda _: "/bin/true")
        target = tmp_path / "lib.so"
        got = _together(lambda: runtime._build(target), n=2)
        assert got == [None, None]
        assert len(set(seen)) == 2
        assert target.exists()

    def test_a_real_build_failure_is_kept(self, tmp_path, monkeypatch):
        monkeypatch.setattr(runtime, "BUILD_DIR", tmp_path)
        monkeypatch.setattr(runtime, "_lib", None)
        monkeypatch.setattr(runtime, "_failure", None)
        monkeypatch.setattr(runtime.shutil, "which", lambda _: None)
        got = _together(runtime.load)
        assert all(isinstance(g, RuntimeError) and "g++ not found" in str(g) for g in got)
        assert "g++ not found" in runtime._failure


@pytest.fixture
def stub_nvcc(tmp_path, monkeypatch):
    """A stub ``nvcc`` that sleeps, appends its kernel's name to a log and writes its ``-o`` file; the build
    directory is fresh and no kernel is loaded."""
    log = tmp_path / "runs.txt"
    script = tmp_path / "nvcc"
    script.write_text(
        f"#!{sys.executable}\n"
        "import sys, time\n"
        "time.sleep(0.3)\n"
        "out = sys.argv[sys.argv.index('-o') + 1]\n"
        f"open({str(log)!r}, 'a').write(sys.argv[-1] + '\\n')\n"
        "open(out, 'wb').write(b'stub')\n"
        "print('ptxas info    : Used 1 registers')\n"
    )
    script.chmod(script.stat().st_mode | stat.S_IXUSR)
    build_dir = tmp_path / "build"
    monkeypatch.setattr(_build, "BUILD_DIR", build_dir)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(script))
    monkeypatch.setattr(_build, "_loaded", {})

    def runs() -> list[str]:
        return [os.path.basename(line) for line in log.read_text().split()] if log.exists() else []

    return build_dir, runs


class TestKernelBuild:
    @pytest.mark.parametrize("names", [["fused_mlp"], ["fused_mlp", "matmul"]])
    def test_concurrent_build_runs_nvcc_once_per_kernel(self, stub_nvcc, names):
        build_dir, runs = stub_nvcc
        got = _together(lambda: _build.build(names))
        assert not [g for g in got if isinstance(g, Exception)], got
        assert sorted(runs()) == sorted(f"{n}.cu" for n in names)
        # the thread that built reports every kernel's seconds; the others found them built
        assert sorted(len(g) for g in got) == [0] * (THREADS - 1) + [len(names)]
        assert sorted(p.name for p in build_dir.glob("*.so")) == sorted(_build.lib_path(n).name for n in names)
        assert not list(build_dir.glob("*.tmp"))

    def test_overlapping_sets_build_each_kernel_once(self, stub_nvcc):
        """Threads asking for overlapping sets of kernels in different orders neither deadlock nor rebuild."""
        _, runs = stub_nvcc
        sets = [["matmul", "fused_mlp"], ["fused_mlp", "fused_stage"], ["fused_stage", "matmul"], ["fused_mlp"]]
        turn = iter(sets)
        pick = threading.Lock()

        def one():
            with pick:
                names = next(turn)
            return _build.build(names)

        got = _together(one)
        assert not [g for g in got if isinstance(g, Exception)], got
        assert len(runs()) == len(set(runs()))

    def test_concurrent_load_builds_once_and_shares_the_library(self, stub_nvcc, monkeypatch):
        _, runs = stub_nvcc
        opened = []
        real_cdll = ctypes.CDLL

        class FakeLib:
            def __init__(self, path):
                opened.append(path)
                libc = real_cdll(None)
                self.goalnet_cuda_error_string = libc.strerror   # any ctypes function objects
                self.entry = libc.abs

        monkeypatch.setattr(_build.ctypes, "CDLL", FakeLib)
        got = _together(lambda: _build.load("fused_mlp", {"entry": [ctypes.c_int]}))
        assert not [g for g in got if isinstance(g, Exception)], got
        assert all(g is got[0] for g in got)
        assert runs() == ["fused_mlp.cu"] and len(opened) == 1
