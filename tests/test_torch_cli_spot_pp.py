"""PyTorch port: ``goalnet-torch spot-train --pp N`` (GPipe over the transformer's blocks) against the JAX package's
CLI, on the CPU.

``cli.main`` of both packages runs in-process under ``GOALNET_PLATFORM=cpu`` on four seeded 900-frame videos
(30 condensed frames each at skip 30; ``--pp`` needs equal lengths) with ``.events.json`` sidecars, a fifth of
750 frames to validate, and a trunk written by the JAX package's ``save_checkpoint``.  The JAX CLI takes the
first N of the suite's 8 CPU devices; the port the first N of the config's ``mesh.data`` gloo ranks (2 here;
the ranks print the epoch lines, so the output is read with ``capfd``).  Both start from the JAX package's
initial head and train on one batch of the four timelines in two microbatches: every epoch's loss (and val
loss) within 1e-5 relative plus one unit of the printed 4 decimals, and the two saved heads, each loaded into
the single-device scorer, scoring one seeded timeline within 1e-4·max(1, max|s|) of each other (the untrained
head misses that), and the port's head loads into its single-device ``spot`` verb.  Each of JAX's five ``--pp`` refusals exits 2 with its message in both packages, the port's
before any decode.
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

LENGTHS = (900, 900, 900, 900, 750, 810)   # raw frames: four of 30 condensed to train on, 25 to validate, 27
PORT_RANKS = 2
EPOCH = re.compile(r"^epoch (\d+): loss ([-\d.]+)(?: val-loss ([-\d.]+) val-mAP ([-\d.]+))?$", re.M)


@pytest.fixture(autouse=True)
def on_cpu(monkeypatch):
    monkeypatch.setenv("GOALNET_PLATFORM", "cpu")


@pytest.fixture(scope="module")
def env(tmp_path_factory, small_cfg):
    from cvml_goalnet_tpu_torch.data.audio_io import write_wav

    root = tmp_path_factory.mktemp("torch_cli_spot_pp")
    cfg = dataclasses.replace(small_cfg, model=dataclasses.replace(small_cfg.model, audio_included=False))
    cfgs = {"jax": str(root / "jax.json"), "port": str(root / "port.json"),
            "jax16": str(root / "jax16.json"), "port4": str(root / "port4.json")}
    cfg.save(cfgs["jax"])
    dataclasses.replace(cfg, mesh=MeshConfig(data=PORT_RANKS)).save(cfgs["port"])
    for name, layers in (("jax16", 16), ("port4", 4)):   # enough blocks for a --pp past the device count
        dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, temporal_num_layers=layers),
                            mesh=MeshConfig(data=PORT_RANKS)).save(cfgs[name])
    data = root / "data"
    data.mkdir()
    videos = []
    for i, n in enumerate(LENGTHS):
        rng = np.random.default_rng(60 + i)
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
    save_checkpoint(str(work / "models" / "importance_no_audio"), create_train_state(jax.random.PRNGKey(23), cfg),
                    cfg, tag="opt")
    return {"root": root, "cfgs": cfgs, "work": str(work), "videos": videos, "model": cfg.model}


@pytest.fixture(autouse=True)
def jax_initial_head(monkeypatch):
    """The port starts from the JAX package's initial head (the draw ``goalnet spot-train`` makes)."""
    def init(mc, in_dim, seed, n_classes=1):
        return jax.tree.map(np.asarray, temporal_head_init_auto(jax.random.PRNGKey(seed), in_dim, mc,
                                                                n_classes=n_classes))

    monkeypatch.setattr(W, "init_temporal_params", init)


def _argv(env, cfg: str, videos, *flags) -> list[str]:
    return ["spot-train", "--videos", *videos, "--config", env["cfgs"][cfg], "--workdir", env["work"],
            "--data-root", str(env["root"] / "none"), "--no-audio", *flags]


def _run(main, argv, capfd) -> tuple[int, str, str]:
    capfd.readouterr()
    rc = main(argv)
    out = capfd.readouterr()
    return rc, out.out, out.err


def _epochs(out: str) -> np.ndarray:
    return np.array([[float(x) if x else np.nan for x in m.groups()[1:]] for m in EPOCH.finditer(out)])


# (flags, epochs, lr): banded with two heads; full attention with validation, early stopping and two classes
RUNS = {
    "banded": (["--temporal-model", "transformer", "--attn-window", "3", "--heads", "2"], 2, "3e-3"),
    "full_val": (["--temporal-model", "transformer", "--attn-window", "0", "--classes", "goal,card",
                  "--early-stop", "1"], 3, "3e-2"),
}


@pytest.mark.parametrize("name", list(RUNS))
def test_spot_train_pp_runs_as_jax(env, capfd, tmp_path, name):
    flags, epochs, lr = RUNS[name]
    val = name.endswith("_val")
    outs = {}
    for who, main in (("port", cli.main), ("jax", JC.main)):
        argv = _argv(env, who, env["videos"][:4], "--pp", "2", *flags, "--epochs", str(epochs), "--lr", lr,
                     "--out", str(tmp_path / f"{who}.npz"))
        if val:
            argv += ["--val-videos", env["videos"][4]]
        rc, out, err = _run(main, argv, capfd)
        assert rc == 0, err[-3000:]
        assert "Saved temporal head" in out and "Operation completed" in out
        outs[who] = out
    assert "pipeline-parallel: 2 stages x 2 microbatches" in outs["port"]
    assert "pipeline-parallel: 2 stages x 2 microbatches" in outs["jax"]
    got, want = _epochs(outs["port"]), _epochs(outs["jax"])
    cols = 3 if val else 2
    assert got.shape == want.shape and len(got)
    w = np.nan_to_num(want[:, :cols])
    np.testing.assert_allclose(np.nan_to_num(got[:, :cols]), w, atol=1e-4 + 1e-5 * max(1.0, np.abs(w).max()), rtol=0)
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
    timeline = np.random.default_rng(8).standard_normal((60, 32)).astype(np.float32)
    got_s, want_s, start_s = (np.asarray(temporal_transformer_apply(h, timeline, heads, False, window=window))
                              for h in (load_spotting_checkpoint(str(tmp_path / "port.npz"), template, classes),
                                        load_spotting_checkpoint(str(tmp_path / "jax.npz"), template, classes),
                                        template))
    assert got_s.shape == want_s.shape == ((60, 2) if classes else (60,))
    tol = 1e-4 * max(1.0, float(np.abs(want_s).max()))
    np.testing.assert_allclose(got_s, want_s, atol=tol, rtol=0)
    assert float(np.abs(start_s - want_s).max()) > tol   # the check tells a trained head from the untrained one
    # the pipeline-trained head loads into the port's single-device spot verb
    spot = ["spot", env["videos"][0], "--config", env["cfgs"]["port"], "--workdir", env["work"], "--no-audio",
            *flags[:flags.index("--attn-window") + 2], "--temporal-checkpoint", str(tmp_path / "port.npz")]
    if "--heads" in flags:
        spot += ["--heads", "2"]
    if classes:
        spot += ["--classes", "goal,card"]
    rc, _, err = _run(cli.main, spot, capfd)
    assert rc == 0, err[-2000:]


class TestRefusals:
    @pytest.fixture(autouse=True)
    def no_decode(self, monkeypatch):
        def decoded(*a, **kw):
            raise AssertionError("a refused command decoded a video")

        for name in ("build_video_item", "_load_frames"):
            monkeypatch.setattr(TD, name, decoded)

    @pytest.mark.parametrize("cfgs,videos,flags,message", [
        (("port", "jax"), 4, ["--pp", "2", "--temporal-model", "gru"],
         "--pp needs the transformer scorer (--temporal-model transformer)"),
        (("port", "jax"), 4, ["--pp", "2", "--cp", "--temporal-model", "transformer"],
         "--pp and --cp are mutually exclusive (pipeline stages and context shards lay the mesh out differently)"),
        (("port", "jax"), 4, ["--pp", "3", "--temporal-model", "transformer"],
         "--pp 3 must divide temporal_num_layers (2) — one stage per device needs an even split of blocks"),
        (("port4", "jax16"), 4, ["--pp", "4", "--temporal-model", "transformer"], "--pp 4 needs 4 devices, have 2"),
        (("port", "jax"), 6, ["--pp", "2", "--temporal-model", "transformer"],
         "--pp requires equal-length timelines (the GPipe path does not mask pad rows out of attention) — use "
         "--cp for variable lengths"),
    ])
    def test_refusals_exit_2_as_jax(self, env, capfd, monkeypatch, cfgs, videos, flags, message):
        """The port refuses before any decode; the JAX CLI after encoding (its decoder is left alone), with the
        same message (its device-count refusal at --pp 16 over its 8 devices)."""
        vids = [v for i, v in enumerate(env["videos"]) if i != 4][:videos]   # the fifth validates, never trains
        rc, _, err = _run(cli.main, _argv(env, cfgs[0], vids, *flags), capfd)
        assert rc == 2 and f"E: {message}" in err, err
        monkeypatch.undo()
        monkeypatch.setenv("GOALNET_PLATFORM", "cpu")
        if cfgs[1] == "jax16":
            flags, message = ["--pp", "16", *flags[2:]], "--pp 16 needs 16 devices, have 8"
        rc, _, err = _run(JC.main, _argv(env, cfgs[1], vids, *flags), capfd)
        assert rc == 2 and f"E: {message}" in err, err


def test_container_counts_are_left_to_the_check_after_encoding(tmp_path, monkeypatch):
    """Before any decode the equal-length check reads only the exact frame count of an ``.npz`` header.  Two
    videos that decode to equal lengths while their containers report different counts (``CAP_PROP_FRAME_COUNT``
    is an estimate from the metadata) are not refused there; ``.npz`` timelines of two lengths are."""
    cv2 = pytest.importorskip("cv2")
    paths = []
    for i in range(2):
        fp = str(tmp_path / f"v{i}.mp4")
        writer = cv2.VideoWriter(fp, cv2.VideoWriter_fourcc(*"mp4v"), 25, (32, 32))
        for k in range(40):
            writer.write(np.full((32, 32, 3), 6 * k, np.uint8))
        writer.release()
        (tmp_path / f"v{i}.events.json").write_text("[]")
        paths.append(fp)
    decoded = [len(TD._load_frames(fp, 5)[0]) for fp in paths]
    assert decoded[0] == decoded[1] > 0
    real = cv2.VideoCapture

    class Reported:   # the second container overstates its frame count
        def __init__(self, fp):
            self.cap, self.extra = real(fp), 13 * paths.index(fp)

        def get(self, prop):
            return self.cap.get(prop) + (self.extra if prop == cv2.CAP_PROP_FRAME_COUNT else 0)

        def __getattr__(self, name):
            return getattr(self.cap, name)

    monkeypatch.setattr(cv2, "VideoCapture", Reported)
    assert [TD.condensed_length(fp, 5) for fp in paths] == [None, None]
    assert not cli._unequal_timelines(paths, 5)
    for i, n in enumerate((40, 35)):
        np.savez(tmp_path / f"n{i}.npz", frames=np.zeros((n, 8, 8, 3), np.uint8))
        (tmp_path / f"n{i}.events.json").write_text("[]")
    npz = [str(tmp_path / f"n{i}.npz") for i in range(2)]
    assert [TD.condensed_length(fp, 5) for fp in npz] == [8, 7]
    assert cli._unequal_timelines(npz, 5)
