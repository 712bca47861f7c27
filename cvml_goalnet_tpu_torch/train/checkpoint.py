"""Checkpoints of the training state: one ``.npz`` of every leaf and a JSON manifest.

Port of ``cvml_goalnet_tpu/train/checkpoint.py``
(reference ``torch.save(state_dict)``, ``main.py:251-282``, which kept neither
Adam's moments nor the epoch).  The layout is the JAX package's, so a
checkpoint moves both ways:

* ``<tag>_state.npz``: each leaf of ``{"params", "model_state",
  "opt_state": {"step", "mu", "nu"}}`` under its jax key path (for example
  ``['params']/['fusion']/[0]/['w']``), and ``__epoch__``;
* ``<tag>_manifest.json``: the epoch and the whole config.

Writes are atomic (a temporary file, then a rename), so a crash mid-save
leaves the previous checkpoint whole.  :func:`load_checkpoint` checks every
leaf's key and shape against a template state built from the current config
and raises :class:`CheckpointMismatchError` on the first that differs.
:class:`AsyncCheckpointer` writes on a worker thread.
"""

from __future__ import annotations

import json
import os
import threading

import numpy as np
import torch

from cvml_goalnet_tpu_torch.config import PipelineConfig
from cvml_goalnet_tpu_torch.train.optim import AdamState, tree_map
from cvml_goalnet_tpu_torch.train.state import TrainState
from cvml_goalnet_tpu_torch.weights import _map_with_paths


def _payload(state: TrainState) -> dict:
    return {"params": state.params, "model_state": state.model_state, "opt_state": state.opt_state._asdict()}


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    if isinstance(leaf, int):   # Adam's step count, an int32 scalar in the JAX layout
        return np.asarray(leaf, dtype=np.int32)
    return np.asarray(leaf)


def save_checkpoint(directory: str, state: TrainState, cfg: PipelineConfig, tag: str = "ckp") -> str:
    """Write ``state`` as ``<tag>_state.npz`` and ``<tag>_manifest.json`` under ``directory``; the npz path."""
    os.makedirs(directory, exist_ok=True)
    arrays = {}
    _map_with_paths(lambda key, leaf: arrays.__setitem__(key, _to_numpy(leaf)), _payload(state))
    # the epoch rides inside the npz so weights and epoch swap in one rename; the manifest's is informational
    arrays["__epoch__"] = np.asarray(state.epoch, dtype=np.int64)
    path = os.path.join(directory, f"{tag}_state.npz")
    tmp = path + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)

    manifest = {"epoch": state.epoch, "config": json.loads(cfg.to_json())}
    mpath = os.path.join(directory, f"{tag}_manifest.json")
    with open(mpath + ".tmp", "w") as f:
        json.dump(manifest, f, indent=2)
    os.replace(mpath + ".tmp", mpath)
    return path


class CheckpointMismatchError(ValueError):
    """A checkpoint's shapes do not match the current config's model."""


def load_checkpoint(directory: str, template: TrainState, tag: str = "ckp") -> TrainState:
    """Restore into the structure of ``template`` (built from the same config): every leaf a tensor of the
    template leaf's dtype on its device, Adam's step an int."""
    with open(os.path.join(directory, f"{tag}_manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(directory, f"{tag}_state.npz")) as data:
        files = set(data.files)

        def restore(key, leaf):
            stored = data[key] if key in files else None   # each access of an npz member reads it again
            shape = tuple(leaf.shape) if isinstance(leaf, torch.Tensor) else np.shape(leaf)
            if stored is None or stored.shape != shape:
                raise CheckpointMismatchError(
                    f"checkpoint at {directory!r} does not match the current config: "
                    f"{key} is {'absent' if stored is None else stored.shape}, expected {shape} — it was saved "
                    "with different model settings (e.g. audio/text branches)"
                )
            if isinstance(leaf, torch.Tensor):
                return torch.as_tensor(stored).to(device=leaf.device, dtype=leaf.dtype)
            return int(stored)

        payload = _map_with_paths(restore, _payload(template))
        # the epoch from the payload (atomic with the weights); files without it fall back to the manifest
        epoch = int(data["__epoch__"]) if "__epoch__" in files else int(manifest["epoch"])
    return TrainState(params=payload["params"], model_state=payload["model_state"],
                      opt_state=AdamState(**payload["opt_state"]), epoch=epoch)


def _host_copy(leaf):
    return leaf.detach().to("cpu", copy=True) if isinstance(leaf, torch.Tensor) else leaf


class AsyncCheckpointer:
    """Checkpoints written on a worker thread, so training does not wait for the disk.

    :meth:`save` copies the state to host memory at once (``.cpu()`` copies:
    the training thread pays only the device-to-host copy) and the npz and
    manifest are written by a worker.  One write is pending per tag: a newer
    snapshot for a tag replaces an older one still queued, so a slow disk
    builds no backlog.  :meth:`wait` blocks until every queued write has
    landed and re-raises the first write error.  Writes are atomic, as
    :func:`save_checkpoint`'s.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._pending: dict[str, tuple] = {}
        self._thread: threading.Thread | None = None
        self._errors: list[BaseException] = []

    def save(self, directory: str, state: TrainState, cfg: PipelineConfig, tag: str = "ckp") -> None:
        opt = state.opt_state
        host_state = TrainState(
            params=tree_map(_host_copy, state.params),
            model_state=tree_map(_host_copy, state.model_state),
            opt_state=AdamState(step=opt.step, mu=tree_map(_host_copy, opt.mu), nu=tree_map(_host_copy, opt.nu)),
            epoch=state.epoch,
        )
        with self._lock:
            self._pending[tag] = (directory, host_state, cfg)
            # the worker clears self._thread under this lock as it decides to exit, so None here means no
            # worker will see this item: start one (a worker still alive but leaving would drop it)
            if self._thread is None:
                self._thread = threading.Thread(target=self._drain, daemon=True)
                self._thread.start()

    def _drain(self) -> None:
        while True:
            with self._lock:
                if not self._pending:
                    self._thread = None   # atomic with the decision to exit
                    return
                tag, (directory, state, cfg) = next(iter(self._pending.items()))
                del self._pending[tag]
            try:
                save_checkpoint(directory, state, cfg, tag)
            except BaseException as e:  # surfaced by wait()
                self._errors.append(e)

    def wait(self) -> None:
        """Block until every queued write has landed; re-raise the first failure."""
        while True:
            with self._lock:
                t = self._thread
            if t is None:
                break
            t.join()   # a save racing this worker's exit may have started another: loop until none is left
        if self._errors:
            raise self._errors[0]
