"""PyTorch port: the hand-written zstd decoder, OCDBT reader and zarr v2 arrays against the libraries, on the CPU.

``compat/zstd.py`` (``csrc/zstd_decode.cc``, built with g++ at first use) is
held to ``zstandard``'s compressor and decompressor; ``compat/ocdbt.py`` to
``tensorstore``'s own OCDBT key-value store on stores orbax and tensorstore write
(the key set and every value's bytes); ``compat/zarr2.py`` to tensorstore's
zarr arrays.  The port itself imports none of these libraries.
"""

from __future__ import annotations

import os
import shutil
import struct

import numpy as np
import pytest

from cvml_goalnet_tpu_torch.compat import ocdbt, zarr2, zstd

zstandard = pytest.importorskip("zstandard")
ts = pytest.importorskip("tensorstore")

RNG = np.random.default_rng(2024)
PAYLOADS = {
    "text": b"the quick brown fox jumps over the lazy dog; " * 2000,
    "floats": RNG.standard_normal(60_000).astype(np.float32).tobytes(),
    "mixed": b"".join(RNG.standard_normal(int(RNG.integers(1, 3000))).astype(np.float32).tobytes()
                      + bytes(int(RNG.integers(0, 2000))) + b"goal! " * int(RNG.integers(0, 50)) for _ in range(40)),
    "coarse": (RNG.integers(-8, 8, 200_000).astype(np.float32) * 2.0 ** -12).tobytes(),
}


def _frame(data: bytes, level: int = 3, checksum: bool = False, size: bool = True) -> bytes:
    return zstandard.ZstdCompressor(level=level, write_checksum=checksum, write_content_size=size).compress(data)


class TestDecoder:
    @pytest.mark.parametrize("level", [1, 3, 19, -5])
    @pytest.mark.parametrize("payload", sorted(PAYLOADS))
    def test_levels_match_zstandard(self, payload, level):
        data = PAYLOADS[payload]
        frame = _frame(data, level)
        assert zstd.decompress(frame) == zstandard.ZstdDecompressor().decompress(frame) == data

    @pytest.mark.parametrize("checksum", [False, True])
    @pytest.mark.parametrize("size", [False, True])
    def test_checksum_and_content_size(self, checksum, size):
        data = PAYLOADS["mixed"]
        frame = _frame(data, 1, checksum, size)
        assert zstd.content_size(frame) == (len(data) if size else None)
        assert zstd.decompress(frame) == data

    def test_concatenated_and_skippable_frames(self):
        parts = [PAYLOADS["text"][:5000], PAYLOADS["floats"], b"", PAYLOADS["coarse"][:70_000]]
        skip = struct.pack("<II", 0x184D2A5A, 6) + b"orbax!"
        stream = skip + b"".join(_frame(p, lvl, checksum=True) + skip for p, lvl in zip(parts, (1, 3, 19, -5)))
        assert zstd.decompress(stream) == b"".join(parts)
        assert zstd.content_size(stream) == sum(map(len, parts))
        unknown = _frame(parts[0], size=False) + _frame(parts[1])
        assert zstd.content_size(unknown) is None and zstd.decompress(unknown) == parts[0] + parts[1]

    def test_empty_payload_and_empty_input(self):
        assert zstd.decompress(_frame(b"")) == b""
        assert zstd.decompress(_frame(b"", checksum=True, size=False)) == b""
        with pytest.raises(zstd.ZstdError, match="no zstd frame"):
            zstd.decompress(b"")

    def test_head_sized_random_floats(self):
        """40 MB of random float32 at level 1 (a full-width head leaf is 85 MB of this kind), into a buffer."""
        data = np.random.default_rng(3).standard_normal(10_000_000).astype(np.float32)
        frame = _frame(data.tobytes(), 1, checksum=True)
        out = np.empty_like(data)
        assert zstd.decompress_into(frame, out.view(np.uint8)) == data.nbytes
        np.testing.assert_array_equal(out, data)

    def test_truncated_and_corrupted_frames_are_errors(self):
        """Into a buffer of the payload's size, as a zarr chunk is decoded: every truncation and every flipped bit
        of a checksummed frame is an error; any byte of a frame without a checksum decodes or errs, never
        crashes; a stated content size past the limit is refused before any allocation."""
        data = PAYLOADS["mixed"]
        out = np.empty((len(data),), np.uint8)
        frame = _frame(data, 3, checksum=True)
        for cut in (0, 3, 5, 9, len(frame) // 3, len(frame) - 5, len(frame) - 1):
            with pytest.raises(zstd.ZstdError):
                zstd.decompress_into(frame[:cut], out)
        rng = np.random.default_rng(5)
        for _ in range(200):
            bad = bytearray(frame)
            bad[int(rng.integers(12, len(frame)))] ^= 1 << int(rng.integers(0, 8))
            with pytest.raises(zstd.ZstdError):
                zstd.decompress_into(bytes(bad), out)
        plain = _frame(data, 19)
        for _ in range(200):
            bad = bytearray(plain)
            bad[int(rng.integers(6, len(plain)))] = int(rng.integers(0, 256))
            try:
                zstd.decompress_into(bytes(bad), out)
            except zstd.ZstdError:
                pass
        with pytest.raises(zstd.ZstdError, match="past the"):
            zstd.decompress(frame, max_size=len(data) - 1)
        with pytest.raises(zstd.ZstdError, match="larger than the buffer"):
            zstd.decompress_into(frame, np.empty((len(data) - 1,), np.uint8))
        small = _frame(b"abc" * 10)   # single segment, no dictionary: give it dictionary id 7
        assert small[4] & 3 == 0 and small[4] & 0x20
        with pytest.raises(zstd.ZstdError, match="unsupported"):
            zstd.decompress(small[:4] + bytes([small[4] | 1, 7]) + small[5:])

    def test_built_at_first_use_without_fallback(self, monkeypatch, tmp_path):
        """The library is named by a hash of its source under ``_build/``; with no g++ loading raises (no
        ``zstandard``, no system libzstd)."""
        zstd.load()
        assert zstd.lib_path().parent == zstd.BUILD_DIR and zstd.lib_path().name.startswith("libgoalnet_zstd-")
        assert zstd.lib_path().exists()
        monkeypatch.setattr(zstd, "_lib", None)
        monkeypatch.setattr(zstd, "_failure", None)
        monkeypatch.setattr(zstd, "lib_path", lambda: tmp_path / "libgoalnet_zstd-x.so")
        monkeypatch.setattr(zstd.shutil, "which", lambda name: None)
        with pytest.raises(RuntimeError, match="g.. not found"):
            zstd.load()
        with pytest.raises(RuntimeError, match="zstd decoder unavailable"):
            zstd.decompress(_frame(b"x"))


def _ts_kv(path: str):
    spec = {"driver": "ocdbt", "base": {"driver": "file", "path": os.path.abspath(path) + "/"}}
    return ts.KvStore.open(spec).result()


def _same_as_tensorstore(path: str) -> int:
    mine = ocdbt.OcdbtStore(path)
    kv = _ts_kv(path)
    keys = kv.list().result()
    assert mine.list() == sorted(keys)
    for k in keys:
        assert mine.read(k) == kv.read(k).result().value, k
    return len(keys)


FIXTURE = os.path.join(os.path.dirname(__file__), "data", "orbax_small", "ckp_orbax")


class TestOcdbt:
    def test_jax_written_fixture_matches_tensorstore(self):
        """The committed checkpoint the JAX package's orbax backend wrote (``tools/make_orbax_fixture.py``): its
        root tree points into ``ocdbt.process_0/d/``.  (``tests/test_torch_orbax.py`` holds the reader to
        tensorstore on checkpoints written from the 8- and 4-device meshes too.)"""
        store = ocdbt.OcdbtStore(FIXTURE)
        assert store.config.compression == "zstd" and store.version.root_height == 0
        assert _same_as_tensorstore(FIXTURE) == 172

    @staticmethod
    def _write_commits(path, config):
        kv = ts.KvStore.open({"driver": "ocdbt", "base": {"driver": "file", "path": str(path) + "/"},
                              "config": config}).result()
        rng = np.random.default_rng(7)
        for commit in range(3):
            with ts.Transaction() as txn:
                for k in range(120):
                    key = f"params.{commit}.layer{k * 7 % 120:03d}/{'0.' * (k % 3)}0"
                    kv.with_transaction(txn)[key] = rng.bytes(int(rng.integers(0, 200)))

    @pytest.mark.parametrize("config", [
        {"max_decoded_node_bytes": 400, "max_inline_value_bytes": 16},
        {"compression": None, "max_decoded_node_bytes": 500, "max_inline_value_bytes": 0},
    ], ids=["interior-nodes", "uncompressed"])
    def test_deep_trees(self, tmp_path, config):
        """Stores tensorstore writes with small nodes (interior nodes three and more levels deep, keys relative
        to their subtree's prefix, indirect values), compressed or not, after several commits (the newest
        version is read)."""
        self._write_commits(tmp_path, config)
        store = ocdbt.OcdbtStore(str(tmp_path))
        assert store.version.root_height >= 2
        assert _same_as_tensorstore(str(tmp_path)) == 360

    def test_numbered_manifest_is_refused(self, tmp_path):
        """orbax writes the single manifest kind; a store of the numbered kind is refused by name."""
        self._write_commits(tmp_path, {"manifest_kind": "numbered"})
        with pytest.raises(ocdbt.OcdbtError, match="manifest kind 1"):
            ocdbt.OcdbtStore(str(tmp_path))

    def test_framing_is_checked(self, tmp_path):
        dst = str(tmp_path / "copy")
        shutil.copytree(FIXTURE, dst)
        path = os.path.join(dst, "manifest.ocdbt")
        with open(path, "rb") as f:
            good = f.read()
        for bad, match in ((good[:-1] + bytes([good[-1] ^ 1]), "CRC-32C"), (good[:20], "bytes"),
                           (b"\x0c\xdb\x3a\x2b" + good[4:], "magic")):
            with open(path, "wb") as f:
                f.write(bad)
            with pytest.raises(ocdbt.OcdbtError, match=match):
                ocdbt.OcdbtStore(dst)
        with pytest.raises(FileNotFoundError):
            ocdbt.OcdbtStore(str(tmp_path / "none"))


class TestZarr2:
    @pytest.mark.parametrize("dtype", ["<f4", "<f8", "<i4", "<i8", "|u1", "|b1"])
    def test_edge_chunks_and_dtypes_match_tensorstore(self, tmp_path, dtype):
        """An array tensorstore writes in zarr v2 as 5×7 chunks of a 13×20 shape (edge chunks cropped), zstd level
        1, one chunk never written (the fill value)."""
        rng = np.random.default_rng(11)
        spec = {"driver": "zarr", "kvstore": {"driver": "file", "path": str(tmp_path / "a")},
                "metadata": {"shape": [13, 20], "chunks": [5, 7], "dtype": dtype,
                             "compressor": {"id": "zstd", "level": 1}, "fill_value": None}}
        arr = ts.open(spec, create=True).result()
        full = rng.standard_normal((13, 20)) * 50
        full = full > 0 if dtype == "|b1" else full.astype(np.dtype(dtype))
        arr[:, 7:].write(full[:, 7:]).result()   # the first column of chunks stays unwritten
        want = arr.read().result()
        store = zarr2.DirectoryStore(str(tmp_path))
        got = zarr2.read_array(store, "a")
        assert got.shape == (13, 20)
        np.testing.assert_array_equal(got.view(np.uint8), np.ascontiguousarray(want).view(np.uint8))

    @pytest.mark.parametrize("shape", [(), (1,), (48, 32), (3, 3, 8, 16)])
    def test_writer_is_read_by_tensorstore(self, tmp_path, shape):
        a = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
        zarr2.write_array(str(tmp_path), "params.x.w", a)
        got = ts.open({"driver": "zarr", "kvstore": {"driver": "file", "path": str(tmp_path / "params.x.w")}}).result()
        np.testing.assert_array_equal(got.read().result(), a)
        np.testing.assert_array_equal(zarr2.read_array(zarr2.DirectoryStore(str(tmp_path)), "params.x.w"), a)
