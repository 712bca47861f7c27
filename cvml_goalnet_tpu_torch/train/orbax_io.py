"""The orbax checkpoint backend: the training state in the ``<tag>_orbax/`` layout the JAX package reads and writes.

Port of ``cvml_goalnet_tpu/train/orbax_io.py``, without orbax (it imports
jax) and without tensorstore (the card's machine has neither).  The contract
is JAX's:

* the payload is ``params``, ``model_state``, ``opt_state`` (Adam's fields
  as a dict) and ``epoch`` (an int64 scalar: the step counter can never pair
  with another epoch's weights; the manifest's epoch is informational);
* ``<tag>_orbax_manifest.json`` (the epoch and the whole config) is written
  first; the payload is finalised at ``<tag>_orbax.new`` and swapped in
  through ``.old`` with two renames, so the previous checkpoint stays valid
  throughout.  The saver puts back a ``.old`` a crash left between the two
  renames; the loader only reads it there (a rename could race a live save).

What :func:`save_checkpoint_orbax` writes is orbax's per-array layout
without OCDBT, which JAX's ``load_checkpoint_orbax`` restores bit for bit:
``_METADATA`` (every leaf's key path and key types, ``"use_ocdbt": false``),
``_CHECKPOINT_METADATA``, and per leaf a directory ``<a.b.c>/`` holding a zarr
v2 ``.zarray`` and one uncompressed chunk (``compat/zarr2.py``).
:func:`load_checkpoint_orbax` reads that and what JAX writes: an OCDBT store
(``compat/ocdbt.py``) whose chunks are zstd frames (``compat/zstd.py``,
a decoder written for the port), one or several chunks per leaf.
"""

from __future__ import annotations

import json
import os
import shutil
import time

import numpy as np
import torch

from cvml_goalnet_tpu_torch.compat import zarr2
from cvml_goalnet_tpu_torch.compat.ocdbt import OcdbtStore
from cvml_goalnet_tpu_torch.config import PipelineConfig
from cvml_goalnet_tpu_torch.train.checkpoint import CheckpointMismatchError
from cvml_goalnet_tpu_torch.train.optim import AdamState
from cvml_goalnet_tpu_torch.train.state import TrainState

DICT_KEY, SEQUENCE_KEY = 2, 1   # orbax's key_type of a dict key and of a list index
HANDLER = "orbax.checkpoint._src.handlers.pytree_checkpoint_handler.PyTreeCheckpointHandler"


def _payload(state: TrainState) -> dict:
    return {
        "params": state.params,
        "model_state": state.model_state,
        "opt_state": state.opt_state._asdict(),
        "epoch": np.asarray(state.epoch, dtype=np.int64),
    }


def _leaves(tree, path=()):
    """(key path, key types, leaf) of every leaf, keys as orbax spells them (list indices as strings)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + ((str(k), DICT_KEY),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + ((str(i), SEQUENCE_KEY),))
    else:
        yield tuple(k for k, _ in path), tuple(t for _, t in path), tree


def _map(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map(fn, v, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(fn, v, path + (str(i),)) for i, v in enumerate(tree)]
    return fn(path, tree)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    if isinstance(leaf, int):
        return np.asarray(leaf, dtype=np.int32)   # Adam's step count, an int32 scalar in the JAX layout
    return np.asarray(leaf)


def _recover_interrupted_swap(path: str) -> None:
    """A crash between "old renamed away" and "new renamed in" leaves the previous checkpoint at ``.old``: put
    it back.  Only the saver calls this; a loader reads ``.old`` where it is."""
    if not os.path.isdir(path) and os.path.isdir(path + ".old"):
        os.rename(path + ".old", path)


def _write_payload(directory: str, payload: dict) -> None:
    os.makedirs(directory)
    tree_metadata = {}
    for keys, types, leaf in _leaves(payload):
        a = _to_numpy(leaf)
        zarr2.write_array(directory, ".".join(keys), a)
        value = {"value_type": "np.ndarray" if isinstance(leaf, np.ndarray) else "jax.Array",
                 "skip_deserialize": False}
        if value["value_type"] == "jax.Array":
            value["write_shape"] = [int(s) for s in a.shape]
        tree_metadata[str(keys)] = {
            "key_metadata": [{"key": k, "key_type": t} for k, t in zip(keys, types)],
            "value_metadata": value,
        }
    meta = {"tree_metadata": tree_metadata, "use_ocdbt": False, "use_zarr3": False,
            "store_array_data_equal_to_fill_value": True, "custom_metadata": None}
    with open(os.path.join(directory, "_METADATA"), "w") as f:
        json.dump(meta, f)
    now = time.time_ns()
    with open(os.path.join(directory, "_CHECKPOINT_METADATA"), "w") as f:
        json.dump({"item_handlers": HANDLER, "metrics": {}, "performance_metrics": {},
                   "init_timestamp_nsecs": now, "commit_timestamp_nsecs": time.time_ns(), "custom_metadata": {}}, f)


def save_checkpoint_orbax(directory: str, state: TrainState, cfg: PipelineConfig, tag: str = "ckp") -> str:
    """Write ``<directory>/<tag>_orbax/`` and its manifest; the checkpoint's path.

    The payload is finalised at ``<tag>_orbax.new`` and swapped in by two renames, the previous checkpoint valid
    (at its path or at ``.old``) throughout; the next save repairs a swap a crash interrupted.
    """
    os.makedirs(directory, exist_ok=True)
    path = os.path.abspath(os.path.join(directory, f"{tag}_orbax"))
    _recover_interrupted_swap(path)

    # the manifest first: the config and an informational epoch
    manifest = {"epoch": state.epoch, "config": json.loads(cfg.to_json())}
    mpath = os.path.join(directory, f"{tag}_orbax_manifest.json")
    with open(mpath + ".tmp", "w") as f:
        json.dump(manifest, f, indent=2)
    os.replace(mpath + ".tmp", mpath)

    new = path + ".new"
    if os.path.isdir(new):
        shutil.rmtree(new)   # debris of an interrupted save
    tmp = new + f".tmp{os.getpid()}"
    if os.path.isdir(tmp):
        shutil.rmtree(tmp)
    _write_payload(tmp, _payload(state))
    os.rename(tmp, new)      # finalised, as orbax's own rename does

    old = path + ".old"
    if os.path.isdir(old):
        shutil.rmtree(old)
    if os.path.isdir(path):
        os.rename(path, old)
    os.rename(new, path)
    if os.path.isdir(old):
        shutil.rmtree(old)
    return path


def _mismatch(path: str, e: Exception) -> CheckpointMismatchError:
    return CheckpointMismatchError(
        f"orbax checkpoint at {path!r} does not match the current config ({type(e).__name__}: {e}) — it was "
        "saved with different model settings (e.g. audio/text branches)")


def load_checkpoint_orbax(directory: str, template: TrainState, tag: str = "ckp") -> TrainState:
    """Restore into ``template``'s structure: every leaf a tensor of the template leaf's dtype on its device,
    Adam's step an int.  Reads the OCDBT layout JAX writes and the plain one both packages can write."""
    path = os.path.abspath(os.path.join(directory, f"{tag}_orbax"))
    # a saver that crashed between its two renames left the finalised checkpoint at .old: read it there
    if not os.path.isdir(path) and os.path.isdir(path + ".old"):
        path = path + ".old"
    if not os.path.isdir(path):
        raise FileNotFoundError(path)
    with open(os.path.join(directory, f"{tag}_orbax_manifest.json")) as f:
        manifest = json.load(f)
    try:
        with open(os.path.join(path, "_METADATA")) as f:
            meta = json.load(f)
        on_disk = {tuple(m["key"] for m in entry["key_metadata"]) for entry in meta["tree_metadata"].values()}
        if meta.get("use_zarr3"):
            raise ValueError("a zarr3 layout (the JAX package writes zarr v2)")
        store = OcdbtStore(path) if meta.get("use_ocdbt", True) else zarr2.DirectoryStore(path)
    except (OSError, ValueError, KeyError, TypeError) as e:
        raise _mismatch(path, e) from e

    full = _payload(template)
    if ("epoch",) not in on_disk:
        full.pop("epoch")   # written before the epoch rode in the payload: the manifest's epoch stands
    wanted = {keys for keys, _, _ in _leaves(full)}
    try:
        missing, extra = sorted(wanted - on_disk), sorted(on_disk - wanted)
        if missing or extra:
            raise ValueError(f"tree structures differ: missing {missing[:4]}, unexpected {extra[:4]}")

        def restore(keys, leaf):
            name = ".".join(keys)
            zmeta = zarr2.read_metadata(store, name)
            shape = tuple(leaf.shape) if isinstance(leaf, (torch.Tensor, np.ndarray)) else ()
            if tuple(zmeta["shape"]) != shape:
                raise ValueError(f"{name} has shape {tuple(zmeta['shape'])}, expected {shape}")
            a = zarr2.read_array(store, name, zmeta)
            if isinstance(leaf, torch.Tensor):
                return torch.from_numpy(a).to(device=leaf.device, dtype=leaf.dtype)
            return int(a)

        payload = _map(restore, full)
    except (OSError, ValueError, KeyError) as e:
        raise _mismatch(path, e) from e
    epoch = payload.get("epoch")
    return TrainState(
        params=payload["params"],
        model_state=payload["model_state"],
        opt_state=AdamState(**payload["opt_state"]),
        epoch=int(epoch) if epoch is not None else int(manifest["epoch"]),
    )
