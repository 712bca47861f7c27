"""One zarr v2 array read from, or written to, a key-value store: the per-array layout of orbax checkpoints.

An array ``<name>`` is the JSON ``<name>/.zarray`` (``shape``, ``chunks``,
``dtype``, ``compressor``, ``fill_value``, ``order``,
``dimension_separator``) and one value per chunk, ``<name>/<i>.<j>…``
(``<name>/0`` for a scalar).  An edge chunk is stored at the full chunk shape
and cropped; a missing chunk takes the fill value.  A checkpoint written from
a sharded mesh has several chunks per array, one per shard.

The store is either a plain directory (:class:`DirectoryStore`: a key is a
file under it) or an OCDBT store (:class:`compat.ocdbt.OcdbtStore`).  Chunks
are raw or zstd-compressed (decoded by :mod:`compat.zstd`, on a thread pool:
the decoder releases the GIL).  The writer writes one chunk, uncompressed,
into a directory.
"""

from __future__ import annotations

import json
import math
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from cvml_goalnet_tpu_torch.compat import zstd

# zarr v2 dtype strings → numpy
DTYPES = {
    "<f4": np.dtype("<f4"), "<f8": np.dtype("<f8"), "<i4": np.dtype("<i4"), "<i8": np.dtype("<i8"),
    "|u1": np.dtype("u1"), "|b1": np.dtype("bool"),
}
_DECODE_THREADS = 8


class ZarrError(ValueError):
    """An array this reader does not understand, or whose chunks break its metadata."""


class DirectoryStore:
    """Keys as files under a directory."""

    def __init__(self, directory: str):
        self.directory = directory

    def __contains__(self, key: str) -> bool:
        return os.path.isfile(os.path.join(self.directory, key))

    def read(self, key: str) -> bytes:
        with open(os.path.join(self.directory, key), "rb") as f:
            return f.read()


def read_metadata(store, name: str) -> dict:
    """``<name>/.zarray``, checked: zarr format 2, a known dtype, C order, compressor zstd or none."""
    key = f"{name}/.zarray"
    if key not in store:
        raise KeyError(key)
    meta = json.loads(store.read(key))
    if meta.get("zarr_format") != 2:
        raise ZarrError(f"{key}: zarr_format {meta.get('zarr_format')}")
    if meta.get("dtype") not in DTYPES:
        raise ZarrError(f"{key}: dtype {meta.get('dtype')!r}")
    if meta.get("order", "C") != "C":
        raise ZarrError(f"{key}: order {meta.get('order')!r} (C only)")
    if meta.get("filters"):
        raise ZarrError(f"{key}: filters {meta['filters']!r}")
    comp = meta.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise ZarrError(f"{key}: compressor {comp.get('id')!r} (zstd or none)")
    if len(meta["chunks"]) != len(meta["shape"]):
        raise ZarrError(f"{key}: chunks {meta['chunks']} for shape {meta['shape']}")
    return meta


def _chunk_keys(name: str, grid: tuple, sep: str):
    if not grid:
        yield (), f"{name}/0"
        return
    for idx in np.ndindex(*grid):
        yield idx, f"{name}/" + sep.join(str(i) for i in idx)


def read_array(store, name: str, meta: dict | None = None) -> np.ndarray:
    """The whole array ``name`` of ``store``, assembled from its chunks (C order, the stored dtype)."""
    meta = read_metadata(store, name) if meta is None else meta
    dtype = DTYPES[meta["dtype"]]
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    if any(c <= 0 for c in chunks):
        raise ZarrError(f"{name}: chunk shape {chunks}")
    sep = meta.get("dimension_separator") or "."
    fill = meta.get("fill_value")
    grid = tuple(math.ceil(s / c) for s, c in zip(shape, chunks))
    chunk_bytes = math.prod(chunks) * dtype.itemsize
    compressed = meta.get("compressor") is not None
    todo = [(idx, key) for idx, key in _chunk_keys(name, grid, sep) if key in store]
    whole = chunks == shape and len(todo) == 1
    if whole and not compressed and isinstance(store, DirectoryStore):
        # one raw chunk, the whole array: read it straight into the array
        out = np.fromfile(os.path.join(store.directory, todo[0][1]), dtype=dtype)
        if out.nbytes != chunk_bytes:
            raise ZarrError(f"{todo[0][1]}: {out.nbytes} bytes, a chunk is {chunk_bytes}")
        return out.reshape(shape)
    out = np.empty(shape, dtype=dtype)
    if not whole:
        # a never-written chunk takes the fill value (tensorstore's zeros when it is null)
        out[...] = float(fill) if isinstance(fill, str) else (fill or 0)
    if whole and compressed:
        data = store.read(todo[0][1])
        n = zstd.decompress_into(data, out.reshape(-1).view(np.uint8)) if chunk_bytes else 0
        if n != chunk_bytes:
            raise ZarrError(f"{todo[0][1]}: decodes to {n} bytes, a chunk is {chunk_bytes}")
        return out

    def place(item) -> None:
        idx, key = item
        data = store.read(key)
        if compressed:
            buf = np.empty((max(chunk_bytes, 1),), dtype=np.uint8)
            n = zstd.decompress_into(data, buf)
            if n != chunk_bytes:
                raise ZarrError(f"{key}: decodes to {n} bytes, a chunk is {chunk_bytes}")
            chunk = buf[:chunk_bytes].view(dtype).reshape(chunks)
        else:
            if len(data) != chunk_bytes:
                raise ZarrError(f"{key}: {len(data)} bytes, a chunk is {chunk_bytes}")
            chunk = np.frombuffer(data, dtype=dtype).reshape(chunks)
        lo = [i * c for i, c in zip(idx, chunks)]
        hi = [min(a + c, s) for a, c, s in zip(lo, chunks, shape)]
        out[tuple(slice(a, b) for a, b in zip(lo, hi))] = chunk[tuple(slice(0, b - a) for a, b in zip(lo, hi))]

    if compressed and len(todo) > 1:
        with ThreadPoolExecutor(min(_DECODE_THREADS, len(todo))) as pool:
            list(pool.map(place, todo))
    else:
        for item in todo:
            place(item)
    return out


def dtype_string(a: np.ndarray) -> str:
    """The zarr v2 dtype string of ``a``."""
    for text, dt in DTYPES.items():
        if dt == a.dtype:
            return text
    raise ZarrError(f"no zarr v2 dtype for {a.dtype}")


def write_array(directory: str, name: str, a: np.ndarray) -> None:
    """``a`` as ``<directory>/<name>/.zarray`` and one uncompressed chunk (``0.0…``, or ``0`` for a scalar)."""
    a = np.asarray(a, order="C")   # (np.ascontiguousarray would make a scalar 1-d)
    path = os.path.join(directory, name)
    os.makedirs(path, exist_ok=True)
    meta = {
        "chunks": [max(int(s), 1) for s in a.shape], "compressor": None, "dimension_separator": ".",
        "dtype": dtype_string(a), "fill_value": None, "filters": None, "order": "C",
        "shape": [int(s) for s in a.shape], "zarr_format": 2,
    }
    with open(os.path.join(path, ".zarray"), "w") as f:
        json.dump(meta, f)
    if a.size:
        with open(os.path.join(path, ".".join("0" * a.ndim) or "0"), "wb") as f:
            f.write(a.tobytes())
