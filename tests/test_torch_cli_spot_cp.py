"""PyTorch port: ``goalnet-torch spot-train --cp`` (with ``--dp-timelines N`` and ``--tp N``) against the JAX
package's CLI, on the CPU.

``cli.main`` of both packages runs in-process under ``GOALNET_PLATFORM=cpu``
on the seeded videos of ``tests/test_torch_cli_spot.py``'s layout (30, 27 and
24 condensed frames to train on and 25 to validate, with ``.events.json``
sidecars) and a trunk written by the
JAX package's ``save_checkpoint``.  The JAX CLI lays its mesh over the
suite's 8 CPU devices; the port spawns the config's ``mesh.data`` gloo ranks
(4 here; the ranks print the epoch lines, so the output is read with
``capfd``).  Both start from the JAX package's initial head: every epoch's
loss (and val loss) within 1e-5 relative plus one unit of the printed 4
decimals, and the two saved heads scoring one seeded timeline within
1e-4·max(1, max|s|) of each other (their scores, not their leaves: Adam
moves an entry whose gradient is rounding noise, such as a key bias that
the softmax cancels, by up to lr a step, and such an entry moves no score).
Each JAX
refusal of the ``--cp`` paths exits 2 with its message in both packages.
"""

from __future__ import annotations

import dataclasses
import json
import re

import jax
import numpy as np
import pytest

from cvml_goalnet_tpu import cli as JC
from cvml_goalnet_tpu.config import MeshConfig
from cvml_goalnet_tpu.models.temporal_attention import temporal_transformer_apply
from cvml_goalnet_tpu.spotting import temporal_head_init_auto
from cvml_goalnet_tpu.train.checkpoint import save_checkpoint
from cvml_goalnet_tpu.train.spotting import load_spotting_checkpoint
from cvml_goalnet_tpu.train.state import create_train_state
from cvml_goalnet_tpu_torch import cli
from cvml_goalnet_tpu_torch import weights as W
from cvml_goalnet_tpu_torch.data import dataset as TD

LENGTHS = (900, 810, 720, 750)   # raw frames: 30, 27, 24 and 25 condensed at skip 30; the last one validates
PORT_RANKS = 4
EPOCH = re.compile(r"^epoch (\d+): loss ([-\d.]+)(?: val-loss ([-\d.]+) val-mAP ([-\d.]+))?$", re.M)


@pytest.fixture(autouse=True)
def on_cpu(monkeypatch):
    monkeypatch.setenv("GOALNET_PLATFORM", "cpu")


@pytest.fixture(scope="module")
def env(tmp_path_factory, small_cfg):
    from cvml_goalnet_tpu_torch.data.audio_io import write_wav

    root = tmp_path_factory.mktemp("torch_cli_spot_cp")
    cfg = dataclasses.replace(small_cfg, model=dataclasses.replace(small_cfg.model, audio_included=False))
    cfgs = {"jax": str(root / "jax.json"), "port": str(root / "port.json")}
    cfg.save(cfgs["jax"])
    dataclasses.replace(cfg, mesh=MeshConfig(data=PORT_RANKS)).save(cfgs["port"])
    data = root / "data"
    data.mkdir()
    videos = []
    for i, n in enumerate(LENGTHS):
        rng = np.random.default_rng(40 + i)
        fp = str(data / f"vid{i}.npz")
        np.savez(fp, frames=rng.integers(0, 255, (n, 36, 48, 3), dtype=np.uint8))
        write_wav(fp[:-4] + ".wav", rng.uniform(-0.5, 0.5, n * cfg.audio.sample_rate // 30).astype(np.float32),
                  cfg.audio.sample_rate)
        events = [{"frame": int(f), "label": ("goal", "card")[k % 2]}
                  for k, f in enumerate(sorted(rng.choice(np.arange(30, n - 30), 4, replace=False)))]
        with open(fp[:-4] + ".events.json", "w") as f:
            json.dump(events, f)
        videos.append(fp)
    work = root / "work"
    save_checkpoint(str(work / "models" / "importance_no_audio"), create_train_state(jax.random.PRNGKey(22), cfg),
                    cfg, tag="opt")
    return {"root": root, "cfgs": cfgs, "work": str(work), "videos": videos, "model": cfg.model}


@pytest.fixture(autouse=True)
def jax_initial_head(monkeypatch):
    """The port starts from the JAX package's initial head (the draw ``temporal_head_init_auto`` makes for
    ``goalnet spot-train``)."""
    def init(mc, in_dim, seed, n_classes=1):
        return jax.tree.map(np.asarray, temporal_head_init_auto(jax.random.PRNGKey(seed), in_dim, mc,
                                                                n_classes=n_classes))

    monkeypatch.setattr(W, "init_temporal_params", init)


def _argv(env, who: str, *flags) -> list[str]:
    return ["spot-train", "--videos", *env["videos"][:3], "--config", env["cfgs"][who], "--workdir", env["work"],
            "--data-root", str(env["root"] / "none"), "--no-audio", "--temporal-model", "transformer", *flags]


def _run(main, argv, capfd) -> tuple[int, str, str]:
    capfd.readouterr()
    rc = main(argv)
    out = capfd.readouterr()
    return rc, out.out, out.err


def _epochs(out: str) -> np.ndarray:
    return np.array([[float(x) if x else np.nan for x in m.groups()[1:]] for m in EPOCH.finditer(out)])


def _assert_losses(got: np.ndarray, want: np.ndarray, cols: int = 2):
    assert got.shape == want.shape and len(got)
    w = np.nan_to_num(want[:, :cols])
    np.testing.assert_allclose(np.nan_to_num(got[:, :cols]), w, atol=1e-4 + 1e-5 * max(1.0, np.abs(w).max()),
                               rtol=0)


# (flags, epochs, lr): banded over the ctx axis alone (the halo, one timeline a step); full attention (the ring)
# in the 3-D layout with a padded group and an all-pad dummy timeline (three timelines in groups of two),
# validation, early stopping and two classes
RUNS = {
    "banded": (["--cp", "--attn-window", "3"], 2, "3e-3"),
    "3d_val": (["--cp", "--attn-window", "0", "--dp-timelines", "2", "--tp", "2", "--heads", "2", "--classes",
                "goal,card", "--early-stop", "1"], 3, "3e-2"),
}


@pytest.mark.parametrize("name", list(RUNS))
def test_spot_train_cp_runs_as_jax(env, capfd, tmp_path, name):
    flags, epochs, lr = RUNS[name]
    val = name.endswith("_val")
    outs = {}
    for who, main in (("port", cli.main), ("jax", JC.main)):
        argv = _argv(env, who, *flags, "--epochs", str(epochs), "--lr", lr, "--out", str(tmp_path / f"{who}.npz"))
        if val:
            argv += ["--val-videos", env["videos"][3]]
        rc, out, err = _run(main, argv, capfd)
        assert rc == 0, err[-3000:]
        assert "Saved temporal head" in out and "Operation completed" in out
        outs[who] = out
    layout = {"banded": "context-parallel over 4 devices",
              "3d_val": "DP×TP×CP: 2 timelines × 2-way tensor × 1-way context parallel"}[name]
    assert layout in outs["port"]
    got, want = _epochs(outs["port"]), _epochs(outs["jax"])
    _assert_losses(got, want, cols=3 if val else 2)
    if val:
        best = re.compile(r"best val-loss [-\d.]+ at epoch (\d+)")
        assert best.search(outs["port"]).group(1) == best.search(outs["jax"]).group(1)
        assert ("Early stop" in outs["port"]) == ("Early stop" in outs["jax"])
    classes = ["goal", "card"] if "--classes" in flags else None
    heads = 2 if "--heads" in flags else 1
    window = int(flags[flags.index("--attn-window") + 1])
    mc = dataclasses.replace(env["model"], temporal_model="transformer", temporal_window=window,
                             temporal_num_heads=heads)
    template = temporal_head_init_auto(jax.random.PRNGKey(1), 32, mc, n_classes=2 if classes else 1)
    got_head = load_spotting_checkpoint(str(tmp_path / "port.npz"), template, classes)
    want_head = load_spotting_checkpoint(str(tmp_path / "jax.npz"), template, classes)
    timeline = np.random.default_rng(7).standard_normal((60, 32)).astype(np.float32)
    got_s, want_s = (np.asarray(temporal_transformer_apply(h, timeline, heads, False, window=window))
                     for h in (got_head, want_head))
    assert got_s.shape == want_s.shape == ((60, 2) if classes else (60,))
    np.testing.assert_allclose(got_s, want_s, atol=1e-4 * max(1.0, float(np.abs(want_s).max())), rtol=0)


class TestRefusals:
    @pytest.fixture(autouse=True)
    def no_decode(self, monkeypatch):
        def decoded(*a, **kw):
            raise AssertionError("a refused command decoded a video")

        monkeypatch.setattr(TD, "build_video_item", decoded)

    @pytest.mark.parametrize("flags,port_message,jax_message", [
        (["--cp", "--temporal-model", "gru"], "--cp needs the transformer scorer (--temporal-model transformer)",
         None),
        (["--cp", "--dp-timelines", "3"], "--dp-timelines 3 does not divide the 4-device mesh",
         "--dp-timelines 3 does not divide the 8-device mesh"),
        (["--cp", "--dp-timelines", "3", "--tp", "2", "--heads", "2"],
         "--dp-timelines 3 × --tp 2 does not divide the 4-device mesh",
         "--dp-timelines 3 × --tp 2 does not divide the 8-device mesh"),
        (["--cp", "--tp", "2"], "--tp 2 must divide the head count (1); pass --heads", None),
        (["--cp", "--tp", "4", "--heads", "2"], "--tp 4 must divide the head count (2); pass --heads", None),
    ])
    def test_refusals_exit_2_as_jax(self, env, capfd, monkeypatch, flags, port_message, jax_message):
        """The port refuses before any decode; the JAX CLI after encoding (its decoder is left alone), with the
        same message but for its device count."""
        rc, _, err = _run(cli.main, _argv(env, "port", *flags), capfd)
        assert rc == 2 and f"E: {port_message}" in err, err
        monkeypatch.undo()
        monkeypatch.setenv("GOALNET_PLATFORM", "cpu")
        rc, _, err = _run(JC.main, _argv(env, "jax", *flags), capfd)
        assert rc == 2 and f"E: {jax_message or port_message}" in err, err

    def test_pp_stays_refused_naming_item_6_4(self, env, capfd, monkeypatch):
        """Both packages exit 2 with the JAX CLI's equal-length refusal for ``--pp 2`` on these timelines of 30,
        27 and 24 frames: the port before any decode (the frame counts come from the ``.npz`` headers), the JAX
        CLI after encoding.  The name records the refusal this test once held: ``--pp`` runs now
        (``tests/test_torch_cli_spot_pp.py``)."""
        message = ("E: --pp requires equal-length timelines (the GPipe path does not mask pad rows out of "
                   "attention) — use --cp for variable lengths")
        rc, _, err = _run(cli.main, _argv(env, "port", "--pp", "2"), capfd)
        assert rc == 2 and message in err, err
        monkeypatch.undo()
        monkeypatch.setenv("GOALNET_PLATFORM", "cpu")
        rc, _, err = _run(JC.main, _argv(env, "jax", "--pp", "2"), capfd)
        assert rc == 2 and message in err, err

