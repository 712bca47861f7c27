"""A read-only OCDBT key-value store: the on-disk format tensorstore writes and orbax checkpoints use.

OCDBT ("optionally-cooperative distributed B+tree") keeps a manifest and
B-tree nodes under a directory; the values live inline in the leaves or in
data files under ``d/`` (orbax's per-process stores put theirs under
``ocdbt.process_<i>/d/``, and the root tree points there).  This reads what
tensorstore's published "OCDBT on-disk format" lays down:

* every manifest and node is framed: a big-endian magic, the whole file's
  length (u64), a format version and a compression method (varints), the
  body (zstd-compressed, through :mod:`compat.zstd`, or raw), and a CRC-32C
  of everything before it;
* the manifest holds the config (uuid, manifest kind, inline and node size
  limits, version-tree arity, compression) and the newest versions of the
  tree, each with its root node's location (the "single" manifest kind
  orbax writes; the "numbered" kind is refused);
* a node holds its height, a table of data files (each path relative to the
  base path of the file the node came from), then its entries: keys
  prefix-compressed against the previous one and relative to the prefix the
  path from the root accumulated; a leaf's values (inline, or a data file,
  offset and length); an interior node's children (their location and the
  length of the key prefix their whole subtree shares).

:class:`OcdbtStore` walks the newest version's tree once and then answers
``list()`` and ``read(key)``.  Nothing here writes: the port's checkpoints
are written in the plain per-array layout instead (``train/orbax_io.py``).
"""

from __future__ import annotations

import os
import struct
from typing import NamedTuple

from cvml_goalnet_tpu_torch.compat import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
MISSING = (1 << 64) - 1   # the offset and length of an empty tree's root


class OcdbtError(ValueError):
    """The directory does not hold an OCDBT store this reader understands."""


def _crc32c_table() -> list[int]:
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), as the framing's trailer holds it."""
    crc = 0xFFFFFFFF
    table = _CRC_TABLE
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


class _Reader:
    """Sequential reads of varints, bytes and fixed-width integers from a body."""

    def __init__(self, data: bytes, what: str):
        self.data, self.pos, self.what = data, 0, what

    def _need(self, n: int) -> None:
        if self.pos + n > len(self.data):
            raise OcdbtError(f"{self.what}: truncated")

    def varint(self) -> int:
        value, shift = 0, 0
        while True:
            self._need(1)
            b = self.data[self.pos]
            self.pos += 1
            value |= (b & 0x7F) << shift
            if b < 0x80:
                return value
            shift += 7
            if shift > 63:
                raise OcdbtError(f"{self.what}: varint too long")

    def varints(self, n: int) -> list[int]:
        return [self.varint() for _ in range(n)]

    def byte(self) -> int:
        self._need(1)
        self.pos += 1
        return self.data[self.pos - 1]

    def raw(self, n: int) -> bytes:
        self._need(n)
        self.pos += n
        return self.data[self.pos - n:self.pos]

    def u64(self) -> int:
        return struct.unpack("<Q", self.raw(8))[0]

    def i32(self) -> int:
        return struct.unpack("<i", self.raw(4))[0]


def unframe(data: bytes, magic: int, what: str) -> bytes:
    """A manifest's or node's framing checked (magic, length, version, CRC-32C) → its decompressed body."""
    if len(data) < 4 + 8 + 2 + 4:
        raise OcdbtError(f"{what}: {len(data)} bytes is too short")
    (got_magic,) = struct.unpack(">I", data[:4])
    if got_magic != magic:
        raise OcdbtError(f"{what}: magic {got_magic:#010x}, expected {magic:#010x}")
    (length,) = struct.unpack("<Q", data[4:12])
    if length != len(data):
        raise OcdbtError(f"{what}: the header gives {length} bytes, the data has {len(data)}")
    (stored_crc,) = struct.unpack("<I", data[-4:])
    if crc32c(data[:-4]) != stored_crc:
        raise OcdbtError(f"{what}: CRC-32C mismatch")
    r = _Reader(data[:-4], what)
    r.pos = 12
    version = r.varint()
    if version != 0:
        raise OcdbtError(f"{what}: format version {version} (this reader knows 0)")
    method = r.varint()
    body = data[r.pos:-4]
    if method == 0:
        return body
    if method == 1:
        return zstd.decompress(body, max_size=1 << 32)
    raise OcdbtError(f"{what}: compression method {method} (0 none, 1 zstd)")


class Config(NamedTuple):
    uuid: bytes
    manifest_kind: int           # 0 single, 1 numbered
    max_inline_value_bytes: int
    max_decoded_node_bytes: int
    version_tree_arity_log2: int
    compression: str             # "none" or "zstd"


class Location(NamedTuple):
    path: str          # of the data file, relative to the store's directory
    base_path: str     # the part of `path` the paths inside that file are relative to
    offset: int
    length: int


class Version(NamedTuple):
    generation: int
    root_height: int
    root: Location | None   # None: an empty tree
    num_keys: int


def _read_config(r: _Reader) -> Config:
    uuid = r.raw(16)
    kind = r.varint()
    max_inline = r.varint()
    max_node = r.varint()
    arity = r.byte()
    method = r.varint()
    if method == 1:
        r.i32()   # the zstd level the writer used
    elif method != 0:
        raise OcdbtError(f"{r.what}: config compression {method}")
    return Config(uuid, kind, max_inline, max_node, arity, "zstd" if method == 1 else "none")


def _read_file_table(r: _Reader, transitive: str) -> list[tuple[str, str]]:
    """A node's or manifest's table of data files → [(path, base path)], prefixed with ``transitive``."""
    n = r.varint()
    if n == 0:
        return []
    prefix = [0] + r.varints(n - 1)
    suffix = r.varints(n)
    base_len = r.varints(n)
    out: list[tuple[str, str]] = []
    prev = b""
    for i in range(n):
        if prefix[i] > len(prev):
            raise OcdbtError(f"{r.what}: data file prefix past the previous path")
        path = prev[:prefix[i]] + r.raw(suffix[i])
        if base_len[i] > len(path):
            raise OcdbtError(f"{r.what}: data file base path past its path")
        prev = path
        text = path.decode()
        out.append((transitive + text, transitive + text[:base_len[i]]))
    return out


def _file(table: list[tuple[str, str]], index: int, what: str) -> tuple[str, str]:
    if index >= len(table):
        raise OcdbtError(f"{what}: data file {index} of {len(table)}")
    return table[index]


def _read_versions(r: _Reader) -> list[Version]:
    table = _read_file_table(r, "")
    n = r.varint()
    generations = r.varints(n)
    heights = [r.byte() for _ in range(n)]
    files = r.varints(n)
    offsets = r.varints(n)
    lengths = r.varints(n)
    num_keys = r.varints(n)
    r.varints(n)   # tree bytes
    r.varints(n)   # indirect value bytes
    for _ in range(n):
        r.u64()    # commit time
    out = []
    for i in range(n):
        path, base = _file(table, files[i], r.what)
        root = None if (not path or offsets[i] == MISSING) else Location(path, base, offsets[i], lengths[i])
        out.append(Version(generations[i], heights[i], root, num_keys[i]))
    return out


class ValueRef(NamedTuple):
    inline: bytes | None
    location: Location | None


class OcdbtStore:
    """The newest version of the OCDBT store under ``directory``: ``list()`` and ``read(key)``."""

    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        mpath = os.path.join(self.directory, "manifest.ocdbt")
        if not os.path.isfile(mpath):
            raise FileNotFoundError(mpath)
        r = _Reader(unframe(_read(mpath), MANIFEST_MAGIC, mpath), mpath)
        self.config = _read_config(r)
        if self.config.manifest_kind != 0:
            raise OcdbtError(f"{mpath}: manifest kind {self.config.manifest_kind} (single only)")
        versions = _read_versions(r)
        if not versions:
            raise OcdbtError(f"{mpath}: no version")
        self.version = max(versions, key=lambda v: v.generation)
        self._entries: dict[bytes, ValueRef] = {}
        if self.version.root is not None:
            self._walk(self.version.root, self.version.root_height, b"")

    def _node(self, loc: Location) -> bytes:
        return unframe(_read(os.path.join(self.directory, loc.path), loc.offset, loc.length), NODE_MAGIC,
                       f"{loc.path}@{loc.offset}")

    def _walk(self, loc: Location, height: int, prefix: bytes) -> None:
        what = f"{loc.path}@{loc.offset}"
        r = _Reader(self._node(loc), what)
        got = r.byte()
        if got != height:
            raise OcdbtError(f"{what}: height {got}, expected {height}")
        table = _read_file_table(r, loc.base_path)
        n = r.varint()
        if n == 0:
            return
        key_prefix = [0] + r.varints(n - 1)
        key_suffix = r.varints(n)
        common = r.varints(n) if height > 0 else None
        keys: list[bytes] = []
        prev = b""
        for i in range(n):
            if key_prefix[i] > len(prev):
                raise OcdbtError(f"{what}: key prefix past the previous key")
            prev = prev[:key_prefix[i]] + r.raw(key_suffix[i])
            keys.append(prev)
        if height == 0:
            lengths = r.varints(n)
            kinds = [r.byte() for _ in range(n)]
            if any(k > 1 for k in kinds):
                raise OcdbtError(f"{what}: value kind {max(kinds)}")
            m = sum(kinds)
            files = r.varints(m)
            offsets = r.varints(m)
            j = 0
            for i in range(n):
                if kinds[i]:
                    path, base = _file(table, files[j], what)
                    ref = ValueRef(None, Location(path, base, offsets[j], lengths[i]))
                    j += 1
                else:
                    ref = ValueRef(r.raw(lengths[i]), None)
                self._entries[prefix + keys[i]] = ref
            return
        files = r.varints(n)
        offsets = r.varints(n)
        lengths = r.varints(n)
        for _ in range(3):
            r.varints(n)   # the subtree's key count, tree bytes and indirect value bytes
        for i in range(n):
            if common[i] > len(keys[i]):
                raise OcdbtError(f"{what}: subtree prefix past its key")
            path, base = _file(table, files[i], what)
            self._walk(Location(path, base, offsets[i], lengths[i]), height - 1, prefix + keys[i][:common[i]])

    def list(self) -> list[bytes]:
        """Every key, sorted."""
        return sorted(self._entries)

    def __contains__(self, key) -> bool:
        return _as_key(key) in self._entries

    def read(self, key) -> bytes:
        """The value of ``key`` (bytes or str); ``KeyError`` when absent."""
        ref = self._entries[_as_key(key)]
        if ref.inline is not None:
            return ref.inline
        loc = ref.location
        data = _read(os.path.join(self.directory, loc.path), loc.offset, loc.length)
        if len(data) != loc.length:
            raise OcdbtError(f"{loc.path}: {len(data)} bytes at {loc.offset}, expected {loc.length}")
        return data


def _as_key(key) -> bytes:
    return key.encode() if isinstance(key, str) else bytes(key)


def _read(path: str, offset: int = 0, length: int | None = None) -> bytes:
    with open(path, "rb") as f:
        if offset:
            f.seek(offset)
        return f.read() if length is None else f.read(length)
