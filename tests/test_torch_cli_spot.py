"""PyTorch port: ``goalnet-torch spot``, ``spot-train``, ``serve`` and ``profile`` against the JAX package's CLI.

``cli.main`` of both packages runs in-process under ``GOALNET_PLATFORM=cpu``
on one workdir: seeded ``.npz`` videos with ``.wav`` and ``.events.json``
sidecars, and trunks written by the JAX package's ``save_checkpoint``.  The
spotting payloads and stream lines must be equal (events, clips, seconds and
the evaluation's numbers); ``spot-train``, started from the JAX package's
initial head (the port's ``weights.init_temporal_params`` is replaced by the
JAX package's ``temporal_head_init_auto`` here), must print the same epoch
losses within 1e-5 relative (``test_torch_train.py``'s step tolerance) plus
one unit of the printed 4 decimals, choose the same best epoch, and save a
head the JAX package's ``load_spotting_checkpoint`` reads, within steps·lr of
the JAX package's head (Adam moves an entry whose gradient is rounding noise
by up to lr a step).  Every flag the port does not run yet exits 2 before
any decode, naming its ROADMAP item; ``--commentary`` and ``--moe-experts``
run in every verb and print what the JAX CLI prints, and ``serve --dp N``
answers as the JAX package's services on a mesh of N do.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import subprocess
import sys
import urllib.request

import jax
import numpy as np
import pytest

from cvml_goalnet_tpu import cli as JC
from cvml_goalnet_tpu.serve import Summarizer as JaxSummarizer
from cvml_goalnet_tpu.spotting import temporal_head_init_auto
from cvml_goalnet_tpu.train.checkpoint import save_checkpoint
from cvml_goalnet_tpu.train.spotting import load_spotting_checkpoint
from cvml_goalnet_tpu.train.state import create_train_state
from cvml_goalnet_tpu_torch import cli
from cvml_goalnet_tpu_torch import serve as TSV   # imported here, before TestRefusals stubs the decoders it binds
from cvml_goalnet_tpu_torch import weights as W
from cvml_goalnet_tpu_torch.data import dataset as TD
from cvml_goalnet_tpu_torch.data import video as TVID
from cvml_goalnet_tpu_torch.data.audio_io import write_wav

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LENGTHS = (900, 810, 720)   # raw frames: 30, 27 and 24 condensed at skip 30
CLASSES = "goal,card"


@pytest.fixture(autouse=True)
def on_cpu(monkeypatch):
    monkeypatch.setenv("GOALNET_PLATFORM", "cpu")


@pytest.fixture(scope="module")
def env(tmp_path_factory, small_cfg):
    root = tmp_path_factory.mktemp("torch_cli_spot")
    small_cfg.save(str(root / "cfg.json"))
    data = root / "data"
    data.mkdir()
    sr = small_cfg.audio.sample_rate
    videos = []
    for i, n in enumerate(LENGTHS):
        rng = np.random.default_rng(40 + i)
        fp = str(data / f"vid{i}.npz")
        np.savez(fp, frames=rng.integers(0, 255, (n, 36, 48, 3), dtype=np.uint8))
        write_wav(fp[:-4] + ".wav", rng.uniform(-0.5, 0.5, n * sr // 30).astype(np.float32), sr)
        events = [{"frame": int(f), "label": ("goal", "card")[k % 2]}
                  for k, f in enumerate(sorted(rng.choice(np.arange(30, n - 30), 4, replace=False)))]
        with open(fp[:-4] + ".events.json", "w") as f:
            json.dump(events, f)
        videos.append(fp)
    work = root / "work"
    for audio in (True, False):
        c = dataclasses.replace(small_cfg, model=dataclasses.replace(small_cfg.model, audio_included=audio))
        save_checkpoint(str(work / "models" / f"importance{'' if audio else '_no_audio'}"),
                        create_train_state(jax.random.PRNGKey(21 + audio), c), c, tag="opt")
    return {"root": root, "cfg": str(root / "cfg.json"), "work": str(work), "videos": videos, "small": small_cfg}


def _common(env, *extra):
    return ["--config", env["cfg"], "--workdir", env["work"], "--data-root", str(env["root"] / "none"), *extra]


def _run(main, argv, capsys) -> tuple[int, str, str]:
    capsys.readouterr()
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


def _payload(out: str) -> dict:
    return json.loads(out[out.index("{\n"):])


def _both(argv, capsys) -> tuple[str, str]:
    rc_t, out_t, err_t = _run(cli.main, argv, capsys)
    rc_j, out_j, err_j = _run(JC.main, argv, capsys)
    assert rc_t == rc_j == 0, (err_t[-2000:], err_j[-2000:])
    return out_t, out_j


@pytest.fixture(scope="module")
def heads(env, tmp_path_factory):
    """Temporal head checkpoints written by the JAX package: single- and two-class, GRU and banded transformer,
    for the no-audio trunk (d = 32) and the audio one (d = 48)."""
    from cvml_goalnet_tpu.train.spotting import save_spotting_checkpoint

    root = tmp_path_factory.mktemp("heads")
    out = {}
    small = env["small"]
    for name, over in (("gru", {}), ("band", {"temporal_model": "transformer", "temporal_window": 4})):
        mc = dataclasses.replace(small.model, **over)
        for audio, d in ((False, 32), (True, 48)):
            for classes in (None, CLASSES.split(",")):
                fp = str(root / f"{name}-{audio}-{bool(classes)}.npz")
                head = temporal_head_init_auto(jax.random.PRNGKey(7), d, mc, n_classes=len(classes) if classes else 1)
                save_spotting_checkpoint(fp, head, classes=classes)
                out[name, audio, bool(classes)] = fp
    return out


SCORER_FLAGS = {"gru": [], "band": ["--temporal-model", "transformer", "--attn-window", "4"]}


class TestSpot:
    @pytest.mark.parametrize("scorer", ["gru", "band"])
    @pytest.mark.parametrize("audio", [False, True])
    def test_single_class_matches_jax(self, env, heads, capsys, scorer, audio):
        argv = ["spot", env["videos"][0], *_common(env, *SCORER_FLAGS[scorer], "--eval-events",
                                                   "--temporal-checkpoint", heads[scorer, audio, False],
                                                   *([] if audio else ["--no-audio"]))]
        out_t, out_j = _both(argv, capsys)
        got, want = _payload(out_t), _payload(out_j)
        assert got == want
        assert set(got["eval"]) >= {"precision", "recall", "f1", "average_map"}

    @pytest.mark.parametrize("scorer", ["gru", "band"])
    def test_multi_class_matches_jax(self, env, heads, capsys, scorer):
        argv = ["spot", env["videos"][1], *_common(env, "--no-audio", *SCORER_FLAGS[scorer], "--classes", CLASSES,
                                                   "--eval-events", "--eval-tolerance", "3", "--peak-window", "3",
                                                   "--temporal-checkpoint", heads[scorer, False, True])]
        out_t, out_j = _both(argv, capsys)
        got, want = _payload(out_t), _payload(out_j)
        assert got == want
        assert got["classes"] == CLASSES.split(",") and set(got["eval"]["per_class"]) == {"goal", "card"}

    def test_random_head_warns(self, env, capsys):
        rc, out, _ = _run(cli.main, ["spot", env["videos"][2], *_common(env, "--no-audio")], capsys)
        assert rc == 0 and "random-init temporal head" in out
        assert len(_payload(out)["events_condensed_frames"]) > 0

    @pytest.mark.parametrize("classes", [False, True])
    def test_stream_lines_match_jax(self, env, heads, capsys, classes):
        argv = ["spot", env["videos"][0], *_common(env, "--no-audio", *SCORER_FLAGS["band"], "--stream",
                                                   "--stream-chunk", "8", "--stream-halo", "4",
                                                   "--temporal-checkpoint", heads["band", False, classes],
                                                   *(["--classes", CLASSES] if classes else []))]
        out_t, out_j = _both(argv, capsys)
        assert out_t == out_j
        assert _payload(out_t)["streamed_frames"] == 30

    @pytest.mark.parametrize("audio", [False, True])
    def test_stream_follow_lines_match_jax(self, env, heads, capsys, tmp_path, audio):
        raw = np.load(env["videos"][1])["frames"]
        sr = env["small"].audio.sample_rate
        wav = np.random.default_rng(3).uniform(-0.5, 0.5, len(raw) * sr // 30).astype(np.float32)
        d = tmp_path / "live"
        d.mkdir()
        bounds = [0, 300, 570, len(raw)]
        for i in range(3):
            np.savez(str(d / f"{i:05d}.npz"), frames=raw[bounds[i]:bounds[i + 1]])
            write_wav(str(d / f"{i:05d}.wav"), wav[bounds[i] * sr // 30:bounds[i + 1] * sr // 30], sr)
        (d / "END").touch()
        argv = ["spot", str(d), *_common(env, *SCORER_FLAGS["band"], "--stream", "--follow", "--stream-chunk", "8",
                                         "--follow-poll", "0.05", "--follow-timeout", "10",
                                         "--temporal-checkpoint", heads["band", audio, False],
                                         *([] if audio else ["--no-audio"]))]
        out_t, out_j = _both(argv, capsys)
        assert out_t == out_j
        assert _payload(out_t)["streamed_frames"] == 27


def _jax_initial_head(monkeypatch, env):
    """The port's ``spot-train`` starts from the JAX package's initial head (the same draw ``temporal_head_init_auto``
    makes for ``goalnet spot-train``)."""
    def init(mc, in_dim, seed, n_classes=1):
        head = temporal_head_init_auto(jax.random.PRNGKey(seed), in_dim, mc, n_classes=n_classes)
        return jax.tree.map(np.asarray, head)

    monkeypatch.setattr(W, "init_temporal_params", init)


EPOCH = re.compile(r"^epoch (\d+): loss ([-\d.]+)(?: val-loss ([-\d.]+) val-mAP ([-\d.]+))?$", re.M)


def _epochs(out: str) -> np.ndarray:
    return np.array([[float(x) if x else np.nan for x in m.groups()[1:]] for m in EPOCH.finditer(out)])


def _assert_losses(got: np.ndarray, want: np.ndarray):
    assert got.shape == want.shape and len(got)
    loss = np.nan_to_num(want[:, :2])
    np.testing.assert_allclose(np.nan_to_num(got[:, :2]), loss, atol=1e-4 + 1e-5 * max(1.0, np.abs(loss).max()),
                               rtol=0)


class TestSpotTrain:
    @pytest.mark.parametrize("scorer", ["gru", "transformer", "hybrid"])
    def test_matches_jax(self, env, capsys, monkeypatch, tmp_path, scorer):
        _jax_initial_head(monkeypatch, env)
        flags = ["--temporal-model", scorer] + (["--attn-window", "4"] if scorer != "gru" else [])
        outs = {}
        for name, main in (("port", cli.main), ("jax", JC.main)):
            rc, out, err = _run(main, ["spot-train", "--videos", *env["videos"][:2], *_common(
                env, "--no-audio", *flags, "--epochs", "3", "--lr", "3e-3", "--out", str(tmp_path / f"{name}.npz"))],
                capsys)
            assert rc == 0, err[-2000:]
            outs[name] = out
        _assert_losses(_epochs(outs["port"]), _epochs(outs["jax"]))
        mc = dataclasses.replace(env["small"].model, temporal_model=scorer,
                                 temporal_window=4 if scorer != "gru" else 0)
        template = temporal_head_init_auto(jax.random.PRNGKey(1), 32, mc)
        got = load_spotting_checkpoint(str(tmp_path / "port.npz"), template)
        want = load_spotting_checkpoint(str(tmp_path / "jax.npz"), template)
        # Adam moves an entry whose gradient is rounding noise by up to lr a step in either direction, so the
        # two heads can part by at most steps·lr there (6 steps of 3e-3); the losses above agree far closer
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=6 * 3e-3, rtol=0)

    def test_val_early_stop_and_classes_match_jax(self, env, capsys, monkeypatch, tmp_path):
        _jax_initial_head(monkeypatch, env)
        outs = {}
        for name, main in (("port", cli.main), ("jax", JC.main)):
            rc, out, err = _run(main, ["spot-train", "--videos", *env["videos"], "--val-videos",
                                       "./" + os.path.relpath(env["videos"][2]), *_common(
                env, "--no-audio", "--classes", CLASSES, "--epochs", "6", "--early-stop", "2", "--lr", "3e-2",
                "--out", str(tmp_path / f"{name}.npz"))], capsys)
            assert rc == 0, err[-2000:]
            outs[name] = out
        got, want = _epochs(outs["port"]), _epochs(outs["jax"])
        _assert_losses(got, want)
        np.testing.assert_allclose(got[:, 2:], want[:, 2:], atol=1e-4 + 1e-5 * np.nanmax(np.abs(want[:, 2])), rtol=0)
        best = re.compile(r"best val-loss [-\d.]+ at epoch (\d+)")
        assert best.search(outs["port"]).group(1) == best.search(outs["jax"]).group(1)
        assert ("Early stop" in outs["port"]) == ("Early stop" in outs["jax"])
        with np.load(str(tmp_path / "port.npz")) as f:
            assert [str(c) for c in f["__classes__"]] == CLASSES.split(",")

    def test_then_spot_with_the_trained_head(self, env, capsys, tmp_path):
        head = str(tmp_path / "head.npz")
        flags = ["--no-audio", *SCORER_FLAGS["band"]]
        rc, out, err = _run(cli.main, ["spot-train", "--videos", *env["videos"][:2], *_common(
            env, *flags, "--epochs", "2", "--out", head)], capsys)
        assert rc == 0 and "Saved temporal head" in out, err
        out_t, out_j = _both(["spot", env["videos"][2], *_common(env, *flags, "--temporal-checkpoint", head)], capsys)
        assert _payload(out_t) == _payload(out_j)


def _serving_line(proc) -> int:
    for _ in range(200):
        line = proc.stdout.readline()
        if "serving on" in line:
            return int(line.split("http://127.0.0.1:")[1].split(" ")[0])
        if not line and proc.poll() is not None:
            break
    raise AssertionError(f"no 'serving on' line; stderr: {proc.stderr.read()[-2000:]}")


class TestServeVerb:
    def test_serve_max_requests_end_to_end(self, env, heads):
        """``goalnet-torch serve`` in a subprocess: /healthz, /summarize (equal to the JAX package's Summarizer on
        the same trunk) and /spot, then it exits by itself after --max-requests 3."""
        media = os.path.dirname(env["videos"][0])
        proc = subprocess.Popen(
            [sys.executable, "-m", "cvml_goalnet_tpu_torch.cli", "serve", "--config", env["cfg"], "--workdir",
             env["work"], "--no-audio", "--port", "0", "--media-root", media, "--batch", "--warmup", "--spot",
             "--classes", CLASSES, "--temporal-checkpoint", heads["gru", False, True], "--max-requests", "3"],
            cwd=REPO, env={**os.environ, "GOALNET_PLATFORM": "cpu"}, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
        try:
            port = _serving_line(proc)
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=60) as r:
                assert json.load(r) == {"status": "ok"}
            name = os.path.basename(env["videos"][0])
            req = urllib.request.Request(f"http://127.0.0.1:{port}/summarize", data=json.dumps({"video": name}).encode(),
                                         method="POST")
            with urllib.request.urlopen(req, timeout=120) as r:
                got = json.load(r)
            req = urllib.request.Request(f"http://127.0.0.1:{port}/spot", data=json.dumps({"video": name}).encode(),
                                         method="POST")
            with urllib.request.urlopen(req, timeout=120) as r:
                spot = json.load(r)
            assert proc.wait(timeout=60) == 0
        finally:
            if proc.poll() is None:
                proc.kill()
        cfg = dataclasses.replace(env["small"], model=dataclasses.replace(env["small"].model, audio_included=False))
        from cvml_goalnet_tpu.train.checkpoint import load_checkpoint

        state = load_checkpoint(os.path.join(env["work"], "models", "importance_no_audio"),
                                create_train_state(jax.random.PRNGKey(cfg.train.seed), cfg), tag="opt")
        want = JaxSummarizer(cfg, state=state).summarize_path(env["videos"][0])
        assert got["mask_frames"] == int(want.frame_mask.sum()) and got["clips"] == want.clips.tolist()
        np.testing.assert_allclose(got["scores"], np.round(np.asarray(want.scores), 4), atol=2e-4)
        assert spot["classes"] == CLASSES.split(",") and set(spot["events_condensed_frames"]) == {"goal", "card"}


class TestProfile:
    def test_profile_matches_jax_and_writes_a_trace(self, env, capsys, tmp_path):
        outs = {}
        for name, main in (("port", cli.main), ("jax", JC.main)):
            rc, out, err = _run(main, ["profile", env["videos"][0], *_common(
                env, "--repeats", "2", "--trace-dir", str(tmp_path / name))], capsys)
            assert rc == 0, err[-2000:]
            outs[name] = _payload(out)
        got, want = outs["port"], outs["jax"]
        assert set(got) == set(want) | {"device_name", "trace_file"}
        assert got["backend"] == "cpu" and got["device_name"] == "cpu"
        for key in ("video_id", "repeats", "condensed_frames", "full_n_frames", "selected_clips"):
            assert got[key] == want[key], key
        stages = {"decode", "audio_load", "features", "score", "postprocess"}
        assert set(got["stages_mean_s"]) == set(want["stages_mean_s"]) == stages
        assert set(got["first_pass_s"]) == stages
        trace = open(got["trace_file"]).read()
        assert all(f'"{s}"' in trace for s in stages)

    def test_profile_without_a_trunk_warns(self, env, capsys, tmp_path):
        rc, out, _ = _run(cli.main, ["profile", env["videos"][2], "--config", env["cfg"], "--workdir",
                                     str(tmp_path), "--no-audio", "--repeats", "1"], capsys)
        assert rc == 0 and "random-init trunk" in out
        assert "first_pass_s" not in _payload(out)


class TestRefusals:
    @pytest.fixture(autouse=True)
    def no_decode(self, monkeypatch):
        def decoded(*a, **kw):
            raise AssertionError("a refused command decoded a video")

        for module, name in ((TD, "build_video_item"), (TD, "_load_frames"), (TVID, "stream_condensed_frames")):
            monkeypatch.setattr(module, name, decoded)

    @pytest.mark.parametrize("verb,flags,message", [
        ("spot", ["--follow"], "--follow is a --stream mode"),
        ("spot", ["--stream", "--follow", "--no-audio"], "live segment DIRECTORY"),
        ("spot", ["--stream", "--eval-events", "--no-audio"], "--eval-events is an offline option"),
        ("spot", ["--stream", "--no-audio", "--temporal-model", "transformer"], "needs a banded window"),
        ("spot", ["--stream"], "audio trunks stream via --follow"),
        ("spot", ["--stream", "--no-audio", "--commentary"], "no live ingest protocol for commentary tokens"),
        ("spot-train", ["--tp", "2"], "--dp-timelines/--tp require --cp"),
        ("spot-train", ["--dp-timelines", "2"], "--dp-timelines/--tp require --cp"),
        # once the refusals of an unported --pp (their ids kept); now the JAX CLI's --pp refusals in its order
        pytest.param("spot-train", ["--cp", "--pp", "2", "--temporal-model", "transformer"],
                     "--pp and --cp are mutually exclusive", id="spot-train-flags8-item 6"),
        pytest.param("spot-train", ["--cp", "--dp-timelines", "2", "--tp", "2", "--pp", "2"],
                     "--cp needs the transformer scorer", id="spot-train-flags9-item 6"),
        pytest.param("spot-train", ["--pp", "2", "--temporal-model", "transformer"], "--pp 2 needs 2 devices, have 1",
                     id="spot-train-flags10-item 6"),
        ("spot-train", ["--early-stop", "2"], "--early-stop needs --val-videos"),
        ("serve", ["--host", "0.0.0.0", "--port", "0", "--no-audio"], "non-loopback"),
    ])
    def test_exits_2_before_any_decode(self, env, capsys, verb, flags, message):
        video = [env["videos"][0]] if verb in ("spot", "profile") else []
        data = ["--videos", *env["videos"]] if verb == "spot-train" else []
        common = ["--config", env["cfg"], "--workdir", env["work"]]
        rc, _, err = _run(cli.main, [verb, *video, *data, *common, *flags], capsys)
        assert rc == 2 and message in err, err

    def test_spot_train_val_refusals(self, env, capsys, tmp_path):
        bare = str(tmp_path / "bare.npz")
        np.savez(bare, frames=np.zeros((60, 8, 8, 3), np.uint8))
        common = ["--config", env["cfg"], "--workdir", env["work"], "--no-audio"]
        rc, _, err = _run(cli.main, ["spot-train", "--videos", *env["videos"], "--val-videos", bare, *common], capsys)
        assert rc == 2 and "no .events.json sidecar" in err
        rc, _, err = _run(cli.main, ["spot-train", "--videos", env["videos"][0], "--val-videos",
                                     "./" + os.path.relpath(env["videos"][0]), *common], capsys)
        assert rc == 2 and "nothing left to train on" in err

    def test_jax_refuses_alike(self, env, capsys):
        """The refusals both packages make before any decode carry the JAX package's message."""
        common = ["--config", env["cfg"], "--workdir", env["work"], "--no-audio"]
        for argv, message in ((["spot", env["videos"][0], "--follow", *common], "--follow is a --stream mode"),
                              (["spot-train", "--videos", *env["videos"], "--tp", "2", *common],
                               "--dp-timelines/--tp require --cp"),
                              (["spot-train", "--videos", *env["videos"], "--early-stop", "2", *common],
                               "--early-stop needs --val-videos")):
            for main in (cli.main, JC.main):
                rc, _, err = _run(main, argv, capsys)
                assert rc == 2 and message in err, (main, err)

    def test_without_a_card_or_the_variable_it_raises(self, env, monkeypatch):
        import torch

        monkeypatch.delenv("GOALNET_PLATFORM")
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["serve", "--config", env["cfg"], "--workdir", env["work"], "--no-audio", "--port", "0"])


# ------------------------------------------------------------------ --commentary and --moe-experts


def _model_workdir(env, tmp_path, flags):
    """Copies of vid0 and vid1 (frames, .wav, .events.json) with a commentary sidecar for vid0, a JAX-written
    trunk (tag ``opt``) and a JAX-written single-class head of the trunk's width → (argv tail, videos, head)."""
    import shutil

    from cvml_goalnet_tpu.train.spotting import save_spotting_checkpoint

    data = tmp_path / "data"
    data.mkdir()
    videos = []
    for i, src in enumerate(env["videos"][:2]):
        dst = str(data / os.path.basename(src))
        for ext in (".npz", ".wav", ".events.json"):
            shutil.copy(src[:-4] + ext, dst[:-4] + ext)
        if i == 0:
            with open(dst[:-4] + ".commentary.jsonl", "w") as f:
                for frame, line in ((0, "kick off"), (200, "a shot on goal"), (420, "GOAL! 1-0"), (700, "corner")):
                    f.write(json.dumps({"frame": frame, "text": line}) + "\n")
        videos.append(dst)
    common = ["--config", env["cfg"], "--workdir", str(tmp_path / "work"), *flags]
    cfg = JC._load_cfg(cli.build_parser().parse_args(["spot", videos[0], *common]))
    save_checkpoint(str(tmp_path / "work" / "models" / "importance"), create_train_state(jax.random.PRNGKey(23), cfg),
                    cfg, tag="opt")
    d = cfg.model.vis_feature_dim + cfg.model.aud_feature_dim + (cfg.model.text_feature_dim if cfg.model.text_included
                                                                 else 0)
    head = str(tmp_path / "head.npz")
    save_spotting_checkpoint(head, temporal_head_init_auto(jax.random.PRNGKey(7), d, cfg.model))
    return common, videos, head, cfg


def _serve_once(argv, requests, monkeypatch):
    """``cli.main(["serve", ...])`` in a thread with ``--port 0``; POST each (path, body) once it listens →
    (exit code, the JSON replies)."""
    import threading

    servers, replies, rc = [], [], []
    real = TSV.serve_http

    def capture(*a, **kw):
        servers.append(real(*a, **kw))
        servers[-1].timeout = 30   # a request never sent ends handle_request after 30 s, so the thread ends
        return servers[-1]

    monkeypatch.setattr(TSV, "serve_http", capture)
    t = threading.Thread(target=lambda: rc.append(cli.main(argv + ["--port", "0", "--max-requests",
                                                                   str(len(requests))])))
    t.start()
    try:
        for _ in range(600):
            if servers or not t.is_alive():
                break
            t.join(0.1)
        assert servers, "the server did not start"
        port = servers[0].server_address[1]
        for path, body in requests:
            req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
                                         method="POST")
            try:
                with urllib.request.urlopen(req, timeout=120) as r:
                    replies.append(json.load(r))
            except urllib.error.HTTPError as e:
                replies.append({"status": e.code, **json.load(e)})
    finally:
        t.join(120)
    return rc[0], replies


class TestModelOptions:
    @pytest.mark.parametrize("verb,flags", [
        ("spot", ["--commentary"]),
        ("spot", ["--moe-experts", "4"]),
        ("spot-train", ["--commentary"]),
        ("profile", ["--moe-experts", "4"]),
        ("serve", ["--commentary"]),
        ("serve", ["--moe-experts", "2"]),
    ])
    def test_run_as_jax(self, env, capsys, monkeypatch, tmp_path, verb, flags):
        """Each verb with the text branch (the video's commentary sidecar) or the MoE fusion, on a JAX-written
        trunk of that structure: ``spot`` prints the JAX CLI's payload, ``spot-train`` its epoch losses,
        ``profile`` its frame and clip counts, and ``serve`` answers /summarize (and /spot) as the JAX
        package's services do."""
        common, videos, head, cfg = _model_workdir(env, tmp_path, flags)
        if verb != "serve":
            common = [*common, "--data-root", str(tmp_path / "none")]
        if verb == "spot":
            out_t, out_j = _both(["spot", videos[0], *common, "--temporal-checkpoint", head, "--eval-events"], capsys)
            assert _payload(out_t) == _payload(out_j)
        elif verb == "spot-train":
            _jax_initial_head(monkeypatch, env)
            outs = {}
            for name, main in (("port", cli.main), ("jax", JC.main)):
                rc, out, err = _run(main, ["spot-train", "--videos", *videos, *common, "--epochs", "2", "--lr", "3e-3",
                                           "--out", str(tmp_path / f"{name}.npz")], capsys)
                assert rc == 0, err[-2000:]
                outs[name] = out
            _assert_losses(_epochs(outs["port"]), _epochs(outs["jax"]))
        elif verb == "profile":
            outs = {}
            for name, main in (("port", cli.main), ("jax", JC.main)):
                rc, out, err = _run(main, ["profile", videos[0], *common, "--repeats", "1"], capsys)
                assert rc == 0, err[-2000:]
                outs[name] = _payload(out)
            for key in ("video_id", "repeats", "condensed_frames", "full_n_frames", "selected_clips"):
                assert outs["port"][key] == outs["jax"][key], key
        else:
            from cvml_goalnet_tpu.serve import Spotter as JaxSpotter
            from cvml_goalnet_tpu.train.checkpoint import load_checkpoint

            media = os.path.dirname(videos[0])
            name = os.path.basename(videos[0])
            spot = ["--spot", "--temporal-checkpoint", head] if "--commentary" in flags else []
            reqs = [("/summarize", {"video": name})] + ([("/spot", {"video": name})] if spot else [])
            rc, replies = _serve_once(["serve", *common, "--media-root", media, "--batch", *spot], reqs, monkeypatch)
            assert rc == 0 and all("error" not in r for r in replies), replies
            state = load_checkpoint(str(tmp_path / "work" / "models" / "importance"),
                                    create_train_state(jax.random.PRNGKey(0), cfg), tag="opt")
            want = JaxSummarizer(cfg, state=state).summarize_path(videos[0])
            assert replies[0]["mask_frames"] == int(want.frame_mask.sum())
            assert replies[0]["clips"] == want.clips.tolist()
            np.testing.assert_allclose(replies[0]["scores"], np.round(np.asarray(want.scores), 4), atol=2e-4)
            if spot:
                jsp = JaxSpotter(cfg, state=state, temporal_checkpoint=head)
                w = jsp.spot_path(videos[0])
                assert replies[1]["events_condensed_frames"] == w.events.tolist()

    def test_serve_dp_runs_as_jax(self, env, capsys, monkeypatch, tmp_path):
        """``serve --dp 2 --batch --spot`` (once refused, naming item 6) on a CPU mesh of 2: the banner names
        ``dp=2`` as the JAX CLI's does, and /summarize and /spot answer as the JAX package's services on its
        mesh of 2 virtual devices."""
        from cvml_goalnet_tpu.parallel.serving import serving_mesh as jax_serving_mesh
        from cvml_goalnet_tpu.serve import Spotter as JaxSpotter
        from cvml_goalnet_tpu.train.checkpoint import load_checkpoint

        common, videos, head, cfg = _model_workdir(env, tmp_path, [])
        media, name = os.path.dirname(videos[0]), os.path.basename(videos[0])
        reqs = [("/summarize", {"video": name}), ("/spot", {"video": name})]
        rc, replies = _serve_once(["serve", *common, "--media-root", media, "--batch", "--dp", "2", "--spot",
                                   "--temporal-checkpoint", head], reqs, monkeypatch)
        assert rc == 0 and all("error" not in r for r in replies), replies
        assert "dp=2)" in capsys.readouterr().out
        state = load_checkpoint(str(tmp_path / "work" / "models" / "importance"),
                                create_train_state(jax.random.PRNGKey(0), cfg), tag="opt")
        mesh = jax_serving_mesh(2)
        want = JaxSummarizer(cfg, state=state, mesh=mesh).summarize_path(videos[0])
        assert replies[0]["mask_frames"] == int(want.frame_mask.sum())
        assert replies[0]["clips"] == want.clips.tolist()
        np.testing.assert_allclose(replies[0]["scores"], np.round(np.asarray(want.scores), 4), atol=2e-4)
        w = JaxSpotter(cfg, state=state, temporal_checkpoint=head, mesh=mesh).spot_path(videos[0])
        assert replies[1]["events_condensed_frames"] == w.events.tolist()

    def test_serve_dp_past_the_visible_cards_exits_2_as_jax(self, env, capsys, monkeypatch):
        import torch

        monkeypatch.delenv("GOALNET_PLATFORM")
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
        rc, _, err = _run(cli.main, ["serve", "--config", env["cfg"], "--workdir", env["work"], "--dp", "3"], capsys)
        assert rc == 2 and "--dp 3 requested but only 2 device(s) are visible" in err

    @pytest.mark.parametrize("verb,backbone", [("spot", "resnet"), ("spot", "vit"), ("spot-train", "resnet"),
                                               ("spot-train", "vit"), ("profile", "resnet"), ("serve", "vit")])
    def test_backbones_run_as_jax(self, env, capsys, monkeypatch, tmp_path, verb, backbone):
        """Each verb on a JAX-written trunk of the resnet or vit backbone (the suite's config with
        ``vis_backbone`` swapped, a narrow vit), checked as :meth:`test_run_as_jax` checks the other options."""
        from cvml_goalnet_tpu.config import PipelineConfig as JaxPipelineConfig

        jcfg = JaxPipelineConfig.load(env["cfg"])
        jcfg = dataclasses.replace(jcfg, model=dataclasses.replace(
            jcfg.model, vis_backbone=backbone, vit_embed_dim=16, vit_depth=2, vit_num_heads=2))
        path = str(tmp_path / f"{backbone}.json")
        jcfg.save(path)
        self.test_run_as_jax(env, capsys, monkeypatch, tmp_path, verb, ["--config", path])
