"""PyTorch port: ``cli.main(["infer", ...])`` in-process against the JAX package, on the CPU.

``GOALNET_PLATFORM=cpu`` (the JAX package's variable) puts the port's CLI on
the CPU.  The data is the suite's synthetic TVSum set (``synth_dir``), the
trunks are written by the JAX package's ``save_checkpoint``, and the
expected summaries come from the JAX package in-process: ``build_video_item
→ fuse → summarize`` for offline ``infer``, ``score_video_stream →
summarize`` for ``--stream``.  ``data.video.export_video`` is wrapped to
keep the frames the CLI exports, so the selected intervals are compared
frame for frame (the synthetic frames are noise, so equal frames mean equal
intervals); the mp4s' own frame counts are read back with cv2.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time

import jax
import numpy as np
import pytest

from cvml_goalnet_tpu import streaming as JS
from cvml_goalnet_tpu.data.annotations import AnnotationStore
from cvml_goalnet_tpu.data.dataset import build_video_item
from cvml_goalnet_tpu.data.video import stream_condensed_frames
from cvml_goalnet_tpu.pipeline import fuse, summarize
from cvml_goalnet_tpu.serve import _uniform_clip_intervals
from cvml_goalnet_tpu.train.checkpoint import save_checkpoint
from cvml_goalnet_tpu.train.state import create_train_state
from cvml_goalnet_tpu_torch import cli
from cvml_goalnet_tpu_torch.data import video as TV


def _cfg(small_cfg, audio: bool):
    return dataclasses.replace(small_cfg, model=dataclasses.replace(small_cfg.model, audio_included=audio))


@pytest.fixture(scope="module")
def env(tmp_path_factory, small_cfg, synth_dir):
    """A workdir with JAX-written trunks (audio and no-audio, tag ``opt``) and the config file."""
    root = tmp_path_factory.mktemp("torch_cli")
    small_cfg.save(str(root / "cfg.json"))
    states = {}
    for audio in (True, False):
        c = _cfg(small_cfg, audio)
        states[audio] = create_train_state(jax.random.PRNGKey(11), c)
        save_checkpoint(str(root / "work" / "models" / f"importance{'' if audio else '_no_audio'}"), states[audio], c,
                        tag="opt")
    return {"root": root, "work": str(root / "work"), "cfg": str(root / "cfg.json"), "states": states,
            "meta": synth_dir}


@pytest.fixture(autouse=True)
def on_cpu(monkeypatch):
    monkeypatch.setenv("GOALNET_PLATFORM", "cpu")


@pytest.fixture
def exported(monkeypatch):
    """The frames each ``export_video`` call was handed (the mp4 is still written)."""
    got = []
    real = TV.export_video

    def keep(frames, output_path, fps=30):
        got.append(np.asarray(frames).copy())
        real(frames, output_path, fps=fps)

    monkeypatch.setattr(TV, "export_video", keep)
    return got


def _args(env, *extra, store=True):
    meta = env["meta"]
    out = ["--config", env["cfg"], "--workdir", env["work"], *extra]
    if store:
        out += ["--mat-fp", meta["mat_file_path"], "--h5-fp", meta["h5_file_path"]]
    else:
        out += ["--data-root", str(env["root"] / "no-data")]
    return out


def _frame_count(fp):
    import cv2

    cap = cv2.VideoCapture(fp)
    n = 0
    while cap.read()[0]:
        n += 1
    cap.release()
    return n


def _raw(video):
    return np.load(video)["frames"]


def _chosen_frames(frames, intervals):
    return np.concatenate([frames[int(a):int(b)] for a, b in intervals])


def _jax_offline(env, small_cfg, video, audio, store, state=None):
    cfg = _cfg(small_cfg, audio)
    meta = env["meta"]
    st = AnnotationStore(meta["mat_file_path"], meta["h5_file_path"]) if store else None
    item = build_video_item(video, cfg, None, st, audio)
    state = env["states"][audio] if state is None else state
    scores = fuse(state.params, state.model_state, {"visual": item.visual, "audio": item.audio, "text": item.text},
                  cfg)
    return summarize(scores, item.clip_intervals, cfg.preprocess.skip_frames, item.full_n_frames, cfg.knapsack,
                     full_frames=_raw(video))


def _jax_stream(env, small_cfg, video, chunk, store, **kw):
    cfg = _cfg(small_cfg, False)
    meta = env["meta"]
    counter = {}
    state = env["states"][False]
    scores, _ = JS.score_video_stream(state.params, state.model_state,
                                      stream_condensed_frames(video, cfg.preprocess.skip_frames, chunk, counter=counter),
                                      cfg, chunk_size=chunk, **kw)
    full_n = counter["full_n"]
    vid = os.path.basename(video).rsplit(".", 1)[0]
    iv = (AnnotationStore(meta["mat_file_path"], meta["h5_file_path"]).change_points(vid) if store
          else _uniform_clip_intervals(cfg, full_n))
    return summarize(scores, iv, cfg.preprocess.skip_frames, full_n, cfg.knapsack)


ORBAX_FIXTURE = os.path.join(os.path.dirname(__file__), "data", "orbax_small")


def _orbax_workdir(root) -> str:
    """A workdir whose only trunk is the committed JAX-written orbax checkpoint (``tests/data/orbax_small``,
    the suite's small config with audio, tag ``ckp``: OCDBT, zstd chunks)."""
    import shutil

    work = str(root / "work")
    ckp = os.path.join(work, "models", "importance")
    shutil.copytree(os.path.join(ORBAX_FIXTURE, "ckp_orbax"), os.path.join(ckp, "ckp_orbax"))
    shutil.copy(os.path.join(ORBAX_FIXTURE, "ckp_orbax_manifest.json"), ckp)
    return work


def _orbax_fixture_state(cfg):
    """The fixture's state as JAX reads its npz twin."""
    from cvml_goalnet_tpu.train.checkpoint import load_checkpoint

    return load_checkpoint(ORBAX_FIXTURE, create_train_state(jax.random.PRNGKey(0), cfg), tag="ckp")


def _jax_trunk(cfg):
    return create_train_state(jax.random.PRNGKey(13), cfg)


def _commentary_workdir(env, small_cfg, tmp_path, flags):
    """A workdir with a JAX-written trunk for ``flags`` (tag ``opt``) and a copy of vidA with a commentary
    sidecar → (workdir, video path)."""
    import json
    import shutil

    from cvml_goalnet_tpu.cli import _load_cfg as jax_load_cfg

    src = env["meta"]["video_fps"][0]
    video = str(tmp_path / os.path.basename(src))
    shutil.copy(src, video)
    shutil.copy(src.rsplit(".", 1)[0] + ".wav", video.rsplit(".", 1)[0] + ".wav")
    with open(video.rsplit(".", 1)[0] + ".commentary.jsonl", "w") as f:
        for frame, line in ((0, "kick off"), (70, "a long ball forward"), (150, "GOAL! what a strike")):
            f.write(json.dumps({"frame": frame, "text": line}) + "\n")
    cfg = jax_load_cfg(cli.build_parser().parse_args(["infer", video, "--config", env["cfg"], *flags]))
    work = str(tmp_path / "work")
    save_checkpoint(os.path.join(work, "models", "importance"), _jax_trunk(cfg), cfg, tag="opt")
    return work, video


@pytest.mark.parametrize("audio", [True, False])
@pytest.mark.parametrize("store", [True, False])
def test_offline_matches_jax(env, small_cfg, exported, audio, store, capsys):
    video = env["meta"]["video_fps"][0]
    extra = [] if audio else ["--no-audio"]
    assert cli.main(["infer", video, *_args(env, *extra, store=store)]) == 0
    want = _jax_offline(env, small_cfg, video, audio, store)
    assert len(exported) == 1 and len(want.summary_frames) > 0
    np.testing.assert_array_equal(exported[0], want.summary_frames)
    out = os.path.join(env["work"], "tmp", "vidA.mp4")
    assert _frame_count(out) == len(want.summary_frames)
    assert "Exported video details" in capsys.readouterr().out


@pytest.mark.parametrize("chunk", [1, 4, 8, 9])
@pytest.mark.parametrize("store", [True, False])
def test_stream_matches_jax(env, small_cfg, exported, chunk, store, capsys):
    video = env["meta"]["video_fps"][1]
    assert cli.main(["infer", video, *_args(env, "--no-audio", "--stream", "--stream-chunk", str(chunk),
                                            store=store)]) == 0
    want = _jax_stream(env, small_cfg, video, chunk, store)
    np.testing.assert_array_equal(exported[0], _chosen_frames(_raw(video), want.clip_intervals))
    out = capsys.readouterr().out
    assert f"streamed 9 condensed frames in {-(-9 // chunk)} chunks" in out   # 270 raw frames at skip 30
    assert f"Frames: {len(exported[0])}" in out
    assert _frame_count(os.path.join(env["work"], "tmp", "vidB.mp4")) == len(exported[0])


@pytest.mark.parametrize("stream", [False, True])
def test_serving_preset_options_match_jax(env, small_cfg, exported, tmp_path, stream):
    """``configs/tpu_serving.json``'s model options (bf16 with int8 conv1 and conv2) at the suite's widths: the
    same trunks, offline (audio) and ``--no-audio --stream`` (chunks of 4, the last zero-padded under int8 as
    the JAX scorer pads it), select the frames the JAX package selects."""
    cfg = dataclasses.replace(small_cfg, model=dataclasses.replace(small_cfg.model, dtype="bfloat16",
                                                                   quantized_inference=True))
    path = str(tmp_path / "preset.json")
    cfg.save(path)
    video = env["meta"]["video_fps"][1 if stream else 0]
    extra = ["--no-audio", "--stream", "--stream-chunk", "4"] if stream else []
    args = ["--config", path, "--workdir", env["work"], *extra, "--mat-fp", env["meta"]["mat_file_path"],
            "--h5-fp", env["meta"]["h5_file_path"]]
    assert cli.main(["infer", video, *args]) == 0
    if stream:
        want = _jax_stream(env, cfg, video, 4, True)
        np.testing.assert_array_equal(exported[0], _chosen_frames(_raw(video), want.clip_intervals))
    else:
        np.testing.assert_array_equal(exported[0], _jax_offline(env, cfg, video, True, True).summary_frames)


@pytest.mark.parametrize("tdtype", [None, "float16", "uint8"])
def test_stream_host_preprocess_matches_jax(env, small_cfg, exported, tdtype):
    video = env["meta"]["video_fps"][0]
    extra = ["--transfer-dtype", tdtype] if tdtype else []
    assert cli.main(["infer", video, *_args(env, "--no-audio", "--stream", "--stream-chunk", "4",
                                            "--host-preprocess", *extra)]) == 0
    np_dtype = {"float16": np.float16, "uint8": np.uint8}.get(tdtype)
    want = _jax_stream(env, small_cfg, video, 4, True, host_preprocess=True, transfer_dtype=np_dtype)
    np.testing.assert_array_equal(exported[0], _chosen_frames(_raw(video), want.clip_intervals))


def test_stream_offline_and_jax_select_alike(env, small_cfg, exported):
    """JAX's own CLI test: streamed and offline exports of one trunk hold the same frames."""
    video = env["meta"]["video_fps"][0]
    assert cli.main(["infer", video, *_args(env, "--no-audio")]) == 0
    assert cli.main(["infer", video, *_args(env, "--no-audio", "--stream", "--stream-chunk", "4")]) == 0
    np.testing.assert_array_equal(exported[0], exported[1])


def test_follow_live_directory_matches_the_file_run(env, exported, tmp_path, capsys):
    video = env["meta"]["video_fps"][0]
    common = _args(env, "--no-audio", "--stream", "--stream-chunk", "4", store=False)
    assert cli.main(["infer", video, *common]) == 0
    file_out = capsys.readouterr().out

    d = str(tmp_path / "liveA")
    os.makedirs(d)
    parts = np.split(_raw(video), [100, 170])

    def writer():
        for i, p in enumerate(parts):
            time.sleep(0.2)
            tmp = os.path.join(d, f"{i:05d}.npz.part")
            with open(tmp, "wb") as f:
                np.savez(f, frames=p)
            os.replace(tmp, os.path.join(d, f"{i:05d}.npz"))
        open(os.path.join(d, "END"), "w").close()

    w = threading.Thread(target=writer)
    w.start()
    try:
        rc = cli.main(["infer", d, *common, "--follow", "--follow-poll", "0.05", "--follow-timeout", "20"])
    finally:
        w.join(20.0)
    assert not w.is_alive() and rc == 0
    follow_out = capsys.readouterr().out
    assert "streamed 8 condensed frames in 2 chunks" in file_out and "streamed 8 condensed frames in 2 chunks" in follow_out
    np.testing.assert_array_equal(exported[1], exported[0])
    assert _frame_count(os.path.join(env["work"], "tmp", "liveA.mp4")) == len(exported[0])


class TestRefusals:
    def _refused(self, env, capsys, argv, message):
        assert cli.main(argv) == 2
        assert message in capsys.readouterr().err

    def test_follow_requires_stream(self, env, tmp_path, capsys):
        self._refused(env, capsys, ["infer", str(tmp_path), *_args(env, "--no-audio", "--follow")],
                      "--follow is a --stream mode")

    def test_follow_on_a_file(self, env, capsys):
        self._refused(env, capsys, ["infer", env["meta"]["video_fps"][0],
                                    *_args(env, "--no-audio", "--stream", "--follow")],
                      "is not one — stream a finished file without --follow")

    def test_stream_rejects_an_audio_trunk(self, env, capsys):
        self._refused(env, capsys, ["infer", env["meta"]["video_fps"][0], *_args(env, "--stream")], "visual-only")

    def test_transfer_dtype_requires_host_preprocess(self, env, capsys):
        self._refused(env, capsys, ["infer", env["meta"]["video_fps"][0],
                                    *_args(env, "--no-audio", "--stream", "--transfer-dtype", "uint8")],
                      "host-preprocess")

    @pytest.mark.parametrize("flag", [["--commentary"], ["--moe-experts", "4"]])
    def test_model_options_run_offline_as_jax(self, env, small_cfg, exported, tmp_path, flag):
        """``--commentary`` (the video's sidecar through the text branch) and ``--moe-experts 4`` run offline
        on a JAX-written trunk of that structure and export the frames the JAX package selects."""
        from cvml_goalnet_tpu.cli import _load_cfg as jax_load_cfg

        work, video = _commentary_workdir(env, small_cfg, tmp_path, flag)
        args = ["--config", env["cfg"], "--workdir", work, *flag, "--mat-fp", env["meta"]["mat_file_path"],
                "--h5-fp", env["meta"]["h5_file_path"]]
        assert cli.main(["infer", video, *args]) == 0
        cfg = jax_load_cfg(cli.build_parser().parse_args(["infer", video, *args]))
        item = build_video_item(video, cfg, None, AnnotationStore(env["meta"]["mat_file_path"],
                                                                  env["meta"]["h5_file_path"]), True)
        state = _jax_trunk(cfg)
        scores = fuse(state.params, state.model_state, {"visual": item.visual, "audio": item.audio,
                                                        "text": item.text}, cfg)
        want = summarize(scores, item.clip_intervals, cfg.preprocess.skip_frames, item.full_n_frames, cfg.knapsack,
                         full_frames=_raw(video))
        assert len(exported) == 1 and len(want.summary_frames) > 0
        np.testing.assert_array_equal(exported[0], want.summary_frames)

    def test_stream_refuses_commentary_as_jax(self, env, capsys):
        """``infer --stream --commentary`` exits 2 with the JAX CLI's message, before any decode."""
        from cvml_goalnet_tpu import cli as jcli

        argv = ["infer", env["meta"]["video_fps"][0], *_args(env, "--no-audio", "--stream", "--commentary")]
        errs = []
        for main in (jcli.main, cli.main):
            assert main(argv) == 2
            errs.append([ln for ln in capsys.readouterr().err.splitlines() if ln.startswith("E: ")])
        assert errs[0] == errs[1] and "commentary alignment" in errs[1][0]

    def _orbax_infer(self, env, small_cfg, exported, tmp_path, capsys, flag):
        video = env["meta"]["video_fps"][0]
        work = _orbax_workdir(tmp_path)
        extra = ["--checkpoint-backend", "orbax"] if flag else []
        argv = ["infer", video, "--config", env["cfg"], "--workdir", work, *extra,
                "--mat-fp", env["meta"]["mat_file_path"], "--h5-fp", env["meta"]["h5_file_path"]]
        assert cli.main(argv) == 0
        assert "falling back to rolling ckp" in capsys.readouterr().out
        want = _jax_offline(env, small_cfg, video, True, True, state=_orbax_fixture_state(_cfg(small_cfg, True)))
        assert len(exported) == 1 and len(want.summary_frames) > 0
        np.testing.assert_array_equal(exported[0], want.summary_frames)

    def test_orbax_backend_flag(self, env, small_cfg, exported, tmp_path, capsys):
        """``infer --checkpoint-backend orbax`` (once refused, naming ROADMAP item 6.5) reads the JAX-written
        orbax trunk and exports the frames the JAX package selects with that trunk."""
        self._orbax_infer(env, small_cfg, exported, tmp_path, capsys, True)

    def test_orbax_only_checkpoint(self, env, small_cfg, exported, tmp_path, capsys):
        """A workdir with only an orbax trunk (once refused) is found without the flag, as the JAX CLI finds it,
        and exports the frames the JAX package selects."""
        self._orbax_infer(env, small_cfg, exported, tmp_path, capsys, False)

    def test_checkpoint_of_another_structure(self, env, small_cfg, tmp_path, capsys):
        other = dataclasses.replace(small_cfg, model=dataclasses.replace(small_cfg.model, audio_included=False,
                                                                        fusion_hidden=(8,)))
        save_checkpoint(str(tmp_path / "models" / "importance_no_audio"),
                        create_train_state(jax.random.PRNGKey(0), other), other, tag="opt")
        argv = ["infer", env["meta"]["video_fps"][0], "--config", env["cfg"], "--workdir", str(tmp_path), "--no-audio"]
        self._refused(env, capsys, argv, "does not match the current config")

    def test_no_checkpoint(self, env, tmp_path, capsys):
        argv = ["infer", env["meta"]["video_fps"][0], "--config", env["cfg"], "--workdir", str(tmp_path), "--no-audio",
                "--stream"]
        self._refused(env, capsys, argv, "E: file not found: no opt/ckp checkpoint")
        args = cli.build_parser().parse_args(argv)
        with pytest.raises(FileNotFoundError, match="no opt/ckp checkpoint"):
            cli._load_trunk(cli._artifact_paths(str(tmp_path), False), None, args)

    def test_without_a_card_or_the_variable_it_raises(self, env, monkeypatch):
        import torch

        if torch.cuda.is_available():
            pytest.skip("a card is present")
        monkeypatch.delenv("GOALNET_PLATFORM")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["infer", env["meta"]["video_fps"][0], *_args(env, "--no-audio")])


# ------------------------------------------------------------ train, eval, baseline


def _train_cfg(small_cfg, root):
    """The suite's small config at dropout 0 with Adam's eps at 1e-4, written where both CLIs read it (the
    dropout masks cannot be JAX's; at the default eps, Adam's lr·sign(g) steps on gradient noise part the
    packages' histories by more than 1e-5 within two epochs: ``tests/test_torch_summarization_train.py``)."""
    cfg = dataclasses.replace(small_cfg, model=dataclasses.replace(small_cfg.model, dropout_rate=0.0),
                              train=dataclasses.replace(small_cfg.train, eps=1e-4))
    path = str(root / "train_cfg.json")
    cfg.save(path)
    return path


def _data_args(meta, cfg_path, work, *extra):
    return ["--videos", *meta["video_fps"], "--annotation-fp", meta["annotation_fp"], "--mat-fp",
            meta["mat_file_path"], "--h5-fp", meta["h5_file_path"], "--info-fp", meta["info_fp"], "--config",
            cfg_path, "--workdir", work, *extra]


def _epochs(work):
    from cvml_goalnet_tpu_torch.utils.metrics import MetricsLogger

    return [e for e in MetricsLogger.read(os.path.join(work, "tmp", "events.jsonl")) if e["event"] == "epoch"]


class TestTrainVerbs:
    def test_train_resume_eval_baseline(self, env, small_cfg, tmp_path, capsys):
        """The port's own journey on the synthetic TVSum set with its .mat/.h5 files and plots: train two
        epochs, resume to three, evaluate the trunk, then the random baseline."""
        meta = env["meta"]
        work = str(tmp_path / "work")
        args = _data_args(meta, env["cfg"], work)
        assert cli.main(["train", *args, "--epochs", "2"]) == 0
        out = capsys.readouterr().out
        assert "Number of train videos: 1" in out and "Number of val videos: 1" in out
        assert "Optimal epoch: " in out and "Operation completed" in out
        ckp = os.path.join(work, "models", "importance")
        for name in ("opt_state.npz", "opt_manifest.json", "ckp_state.npz", "ckp_manifest.json"):
            assert os.path.exists(os.path.join(ckp, name)), name
        assert os.path.getsize(os.path.join(work, "tmp", "train_states.png")) > 0
        assert [e["epoch"] for e in _epochs(work)] == [-1, 0, 1]

        assert cli.main(["train", *args, "--checkpoint", "--epochs", "3"]) == 0
        out = capsys.readouterr().out
        assert "Resumed from epoch 2" in out
        assert [e["epoch"] for e in _epochs(work)] == [-1, 0, 1, -1, 2]

        assert cli.main(["eval", *args]) == 0
        lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("[eval]")]
        assert len(lines) == 2 and lines[0].startswith("[eval] train - loss: ") and "F-avg" in lines[1]

        assert cli.main(["baseline", *args, "--samples", "2"]) == 0
        report = dict(ln.split(": ") for ln in capsys.readouterr().out.splitlines() if ": " in ln)
        assert {f"{a}_{k}" for a in ("mean", "opt") for k in ("train_loss", "val_f_avg")} <= set(report)
        assert float(report["opt_train_loss"]) <= float(report["mean_train_loss"])

    def test_on_epoch_end_draws_the_curves_and_the_optimum(self, env, tmp_path, monkeypatch):
        from cvml_goalnet_tpu_torch import viz

        drawn = []
        monkeypatch.setattr(viz, "generate_metric_plots", lambda h, fp: drawn.append(("curves", len(h["train_loss"]))))
        monkeypatch.setattr(viz, "export_indices", lambda p, g, fp: drawn.append(("indices", p.shape, g.shape)))
        work = str(tmp_path / "work")
        assert cli.main(["train", *_data_args(env["meta"], env["cfg"], work, "--epochs", "2")]) == 0
        assert [d for d in drawn if d[0] == "curves"] == [("curves", 2), ("curves", 3)]
        best = _epochs(work)
        assert all(d[1][0] == 240 and d[2][1] == 240 for d in drawn if d[0] == "indices")
        assert any(d[0] == "indices" for d in drawn) or all(e["train_f_avg"] <= best[0]["train_f_avg"]
                                                            for e in best[1:])

    @pytest.mark.parametrize("writer", ["jax", "port"])
    def test_checkpoint_resumed_across_packages(self, env, small_cfg, tmp_path, capsys, writer):
        """One package's ``train --epochs 1`` writes the rolling checkpoint; both packages' ``train --checkpoint
        --epochs 2`` resume it and log the same epoch (1e-5 relative; F-scores equal)."""
        import shutil

        from cvml_goalnet_tpu import cli as jcli

        meta = env["meta"]
        cfg_path = _train_cfg(small_cfg, tmp_path)
        first = str(tmp_path / "first")
        run = {"jax": jcli.main, "port": cli.main}
        assert run[writer](["train", *_data_args(meta, cfg_path, first, "--epochs", "1")]) == 0
        logs = {}
        for name, main in run.items():
            work = str(tmp_path / name)
            shutil.copytree(os.path.join(first, "models"), os.path.join(work, "models"))
            capsys.readouterr()
            assert main(["train", *_data_args(meta, cfg_path, work, "--checkpoint", "--epochs", "2")]) == 0
            assert "Resumed from epoch 1" in capsys.readouterr().out
            logs[name] = _epochs(work)
        assert [e["epoch"] for e in logs["port"]] == [e["epoch"] for e in logs["jax"]] == [-1, 1]
        for got, want in zip(logs["port"], logs["jax"]):
            for k in ("train_loss", "val_loss"):
                assert got[k] == pytest.approx(want[k], rel=1e-5), k
            for k in ("train_f_avg", "train_f_max", "val_f_avg", "val_f_max"):
                assert got[k] == want[k], k
        from cvml_goalnet_tpu_torch.train.checkpoint import load_checkpoint as port_load
        from cvml_goalnet_tpu_torch.train.state import create_train_state as port_state

        cfg = cli._load_cfg(cli.build_parser().parse_args(["eval", "--config", cfg_path]))
        for name in run:
            st = port_load(os.path.join(str(tmp_path / name), "models", "importance"),
                           port_state(0, cfg, device="cpu"), tag="ckp")
            assert st.epoch == 2 and st.opt_state.step == 4


class TestTrainDataParallel:
    def test_train_dp_runs_as_jax(self, env, small_cfg, tmp_path, capfd):
        """``train --dp`` (once refused, naming item 6) at two gloo ranks (``mesh.data = 2``) against the JAX
        CLI's ``train --dp`` on its 8 virtual devices, the same global batch and dropout off: the printed
        ``[dp epoch N]`` losses and F-scores within 1e-4 relative plus one unit of the printed 4 decimals, and
        the ckp and opt checkpoints the JAX package's ``load_checkpoint`` reads within 5e-3 (its step
        tolerance) of its own.  The spawned ranks print, so the output is read at the file descriptors."""
        import re

        from cvml_goalnet_tpu import cli as JC
        from cvml_goalnet_tpu.config import MeshConfig
        from cvml_goalnet_tpu.train.checkpoint import load_checkpoint

        jcfg = dataclasses.replace(small_cfg, model=dataclasses.replace(small_cfg.model, dropout_rate=0.0),
                                   train=dataclasses.replace(small_cfg.train, eps=1e-4))
        paths = {}
        for name, mesh in (("jax", MeshConfig()), ("port", MeshConfig(data=2))):
            paths[name] = str(tmp_path / f"{name}.json")
            dataclasses.replace(jcfg, mesh=mesh).save(paths[name])
        out, works = {}, {}
        start = create_train_state(jax.random.PRNGKey(3), jcfg)   # both resume from it: the inits' draws differ
        for name, main in (("jax", JC.main), ("port", cli.main)):
            works[name] = str(tmp_path / name)
            save_checkpoint(os.path.join(works[name], "models", "importance"), start, jcfg, tag="ckp")
            capfd.readouterr()
            rc = main(["train", *_data_args(env["meta"], paths[name], works[name]), "--dp", "--global-batch", "8",
                       "--epochs", "2", "--checkpoint"])
            out[name] = capfd.readouterr().out
            assert rc == 0 and "Operation completed" in out[name], out[name]
            assert "Resumed from epoch 0" in out[name]

        def epochs(text):
            return [[float(x) for x in re.findall(r"-?\d+\.\d+", line)] for line in text.splitlines()
                    if line.startswith("[dp epoch")]

        got, want = epochs(out["port"]), epochs(out["jax"])
        assert len(got) == len(want) == 2
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
        for tag in ("ckp", "opt"):
            states = [load_checkpoint(os.path.join(works[n], "models", "importance"),
                                      create_train_state(jax.random.PRNGKey(0), jcfg), tag=tag) for n in ("port", "jax")]
            assert states[0].epoch == states[1].epoch == 2
            assert int(states[0].opt_state.step) == int(states[1].opt_state.step) == 2
            for a, b in zip(jax.tree_util.tree_leaves(states[0].params), jax.tree_util.tree_leaves(states[1].params)):
                np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=5e-3)

    def test_train_dp_with_a_model_axis_exits_2_naming_item_6_6(self, env, small_cfg, tmp_path, capfd):
        """``train --dp`` with ``mesh.model = 2`` runs as the JAX CLI runs it (the name records the refusal this
        test once held): the model axis holds replicas and the batch splits over the data axis.  The port on a 2 × 2 grid of gloo ranks
        against the JAX CLI on its 4 × 2 mesh of the 8 virtual devices, both resuming one JAX-drawn ``ckp``
        with dropout off: the printed ``[dp epoch N]`` numbers within 1e-4 relative plus one unit of the
        printed 4 decimals, the checkpoints within 5e-3."""
        import re

        from cvml_goalnet_tpu import cli as JC
        from cvml_goalnet_tpu.config import MeshConfig
        from cvml_goalnet_tpu.train.checkpoint import load_checkpoint

        jcfg = dataclasses.replace(small_cfg, model=dataclasses.replace(small_cfg.model, dropout_rate=0.0),
                                   train=dataclasses.replace(small_cfg.train, eps=1e-4))
        out, works = {}, {}
        start = create_train_state(jax.random.PRNGKey(3), jcfg)
        for name, main, mesh in (("jax", JC.main, MeshConfig(model=2)),
                                 ("port", cli.main, MeshConfig(data=2, model=2))):
            path = str(tmp_path / f"{name}.json")
            dataclasses.replace(jcfg, mesh=mesh).save(path)
            works[name] = str(tmp_path / name)
            save_checkpoint(os.path.join(works[name], "models", "importance"), start, jcfg, tag="ckp")
            capfd.readouterr()
            rc = main(["train", *_data_args(env["meta"], path, works[name]), "--dp", "--global-batch", "8",
                       "--epochs", "1", "--checkpoint"])
            out[name] = capfd.readouterr().out
            assert rc == 0 and "Operation completed" in out[name], out[name]

        def epochs(text):
            return [[float(x) for x in re.findall(r"-?\d+\.\d+", line)] for line in text.splitlines()
                    if line.startswith("[dp epoch")]

        got, want = epochs(out["port"]), epochs(out["jax"])
        assert len(got) == len(want) == 1
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
        states = [load_checkpoint(os.path.join(works[n], "models", "importance"),
                                  create_train_state(jax.random.PRNGKey(0), jcfg), tag="ckp") for n in ("port", "jax")]
        for a, b in zip(jax.tree_util.tree_leaves(states[0].params), jax.tree_util.tree_leaves(states[1].params)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=5e-3)


class TestOrbaxVerbs:
    """``train`` and ``eval`` with ``--checkpoint-backend orbax``, once refused before any decode (naming ROADMAP
    item 6.5), now run as the JAX CLI's do."""

    @staticmethod
    def _eval_numbers(text):
        import re

        return [[float(x) for x in re.findall(r"-?\d+\.\d+", ln)] for ln in text.splitlines()
                if ln.startswith("[eval]")]

    @pytest.mark.parametrize("verb", ["train", "eval"])
    def test_orbax_backend_runs_as_jax(self, env, small_cfg, tmp_path, capsys, verb):
        """``train``: the port's ``train --epochs 1 --checkpoint-backend orbax`` writes ``opt_orbax`` and
        ``ckp_orbax`` (no npz), and the JAX CLI's ``eval --checkpoint-backend orbax`` reads that trunk and prints
        what the port's ``eval`` prints.  ``eval``: on the JAX-written orbax trunk (OCDBT, zstd) both CLIs'
        ``eval --checkpoint-backend orbax`` print the same losses and F-scores (1e-4 plus one printed unit)."""
        from cvml_goalnet_tpu import cli as jcli

        meta = env["meta"]
        if verb == "train":
            work = str(tmp_path / "work")
            assert cli.main(["train", *_data_args(meta, env["cfg"], work, "--epochs", "1", "--checkpoint-backend",
                                                  "orbax")]) == 0
            assert "Operation completed" in capsys.readouterr().out
            ckp = os.path.join(work, "models", "importance")
            assert {"opt_orbax", "ckp_orbax", "opt_orbax_manifest.json"} <= set(os.listdir(ckp))
            assert not any(n.endswith(".npz") for n in os.listdir(ckp))
        else:
            work = _orbax_workdir(tmp_path)
        printed = {}
        for name, main in (("port", cli.main), ("jax", jcli.main)):
            assert main(["eval", *_data_args(meta, env["cfg"], work, "--checkpoint-backend", "orbax")]) == 0
            printed[name] = self._eval_numbers(capsys.readouterr().out)
        assert len(printed["port"]) == len(printed["jax"]) == 2
        np.testing.assert_allclose(printed["port"], printed["jax"], rtol=1e-4, atol=1e-4)


def _commentary_videos(meta, root):
    """Copies of the synthetic videos (and their .wav) under ``root``, vidA with a commentary sidecar and vidB
    without one (its frames read as empty commentary)."""
    import json
    import shutil

    out = []
    for i, src in enumerate(meta["video_fps"]):
        dst = os.path.join(str(root), os.path.basename(src))
        shutil.copy(src, dst)
        shutil.copy(src.rsplit(".", 1)[0] + ".wav", dst.rsplit(".", 1)[0] + ".wav")
        if i == 0:
            with open(dst.rsplit(".", 1)[0] + ".commentary.jsonl", "w") as f:
                for frame, line in ((0, "kick off"), (95, "shot"), (180, "GOAL")):
                    f.write(json.dumps({"frame": frame, "text": line}) + "\n")
        out.append(dst)
    return out


def _text_data_args(meta, videos, cfg_path, work, *extra):
    args = _data_args(meta, cfg_path, work, *extra)
    i = args.index("--videos")
    return args[:i + 1] + videos + args[i + 1 + len(meta["video_fps"]):]


class TestModelOptionVerbs:
    @pytest.mark.parametrize("verb,flags", [
        ("train", ["--commentary"]),
        ("train", ["--moe-experts", "4"]),
        ("eval", ["--commentary"]),
    ])
    def test_run_as_jax(self, env, small_cfg, tmp_path, capsys, verb, flags):
        """``train`` and ``eval`` with the text branch (sidecars read, the empty-commentary fallback for a video
        without one) or the MoE fusion: the JAX package's ``train --epochs 1`` writes the trunk; both packages
        then resume it for an epoch (the logs 1e-5 relative, F-scores equal), or evaluate it (equal lines)."""
        import shutil

        from cvml_goalnet_tpu import cli as jcli

        meta = env["meta"]
        videos = _commentary_videos(meta, tmp_path)
        cfg_path = _train_cfg(small_cfg, tmp_path)
        first = str(tmp_path / "first")
        assert jcli.main(["train", *_text_data_args(meta, videos, cfg_path, first, "--epochs", "1", *flags)]) == 0
        outs, logs = [], {}
        for name, main in (("jax", jcli.main), ("port", cli.main)):
            work = str(tmp_path / name)
            shutil.copytree(os.path.join(first, "models"), os.path.join(work, "models"))
            capsys.readouterr()
            extra = ["--checkpoint", "--epochs", "2"] if verb == "train" else []
            assert main([verb, *_text_data_args(meta, videos, cfg_path, work, *extra, *flags)]) == 0
            out = capsys.readouterr().out
            if verb == "train":
                assert "Resumed from epoch 1" in out
                logs[name] = _epochs(work)
            outs.append([ln for ln in out.splitlines() if ln.startswith("[eval]")])
        if verb == "eval":
            assert len(outs[1]) == 2
            for got, want in zip(outs[1], outs[0]):
                g, w = got.split(" - "), want.split(" - ")
                assert g[0] == w[0] and g[2:] == w[2:]
                assert float(g[1].split(": ")[1]) == pytest.approx(float(w[1].split(": ")[1]), rel=1e-3)
            return
        assert [e["epoch"] for e in logs["port"]] == [e["epoch"] for e in logs["jax"]] == [-1, 1]
        for got, want in zip(logs["port"], logs["jax"]):
            for k in ("train_loss", "val_loss"):
                assert got[k] == pytest.approx(want[k], rel=1e-5), k
            for k in ("train_f_avg", "train_f_max", "val_f_avg", "val_f_max"):
                assert got[k] == want[k], k

    def test_baseline_runs_a_moe_config(self, env, small_cfg, tmp_path, capsys):
        """``baseline`` with an MoE (and text) config prints the JAX baseline's report keys (its samples are
        the port's own draws, so the values differ by design: baseline.py)."""
        from cvml_goalnet_tpu import cli as jcli

        path = str(tmp_path / "moe.json")
        dataclasses.replace(small_cfg, model=dataclasses.replace(small_cfg.model, fusion_moe_experts=4,
                                                                 text_included=True)).save(path)
        keys = []
        for main in (jcli.main, cli.main):
            assert main(["baseline", *_data_args(env["meta"], path, env["work"]), "--samples", "2"]) == 0
            report = dict(ln.split(": ") for ln in capsys.readouterr().out.splitlines() if ": " in ln)
            keys.append(set(report))
            assert all(np.isfinite(float(v)) for v in report.values())
        assert keys[0] == keys[1] and "opt_train_loss" in keys[1]

    def test_jax_trained_trunk_with_both_flags_infers_as_jax(self, env, small_cfg, tmp_path, capsys, exported,
                                                              monkeypatch):
        """A trunk that the JAX package's ``train --commentary --moe-experts 4`` wrote on the synthetic set:
        ``infer`` with the same flags in both packages exports the same frames, and the two packages' scores
        of it agree within 1e-5."""
        from cvml_goalnet_tpu import cli as jcli
        from cvml_goalnet_tpu.data import video as JVid
        from cvml_goalnet_tpu.train.checkpoint import load_checkpoint as jax_load
        from cvml_goalnet_tpu_torch.data.dataset import build_video_item as port_item
        from cvml_goalnet_tpu_torch.pipeline import fuse as port_fuse
        from cvml_goalnet_tpu_torch.train.checkpoint import load_checkpoint as port_load
        from cvml_goalnet_tpu_torch.train.state import create_train_state as port_state

        jax_exported = []
        real = JVid.export_video
        monkeypatch.setattr(JVid, "export_video", lambda f, o, fps=30: (jax_exported.append(np.asarray(f).copy()),
                                                                          real(f, o, fps=fps)))
        meta = env["meta"]
        videos = _commentary_videos(meta, tmp_path)
        flags = ["--commentary", "--moe-experts", "4"]
        cfg_path = _train_cfg(small_cfg, tmp_path)
        work = str(tmp_path / "work")
        assert jcli.main(["train", *_text_data_args(meta, videos, cfg_path, work, "--epochs", "1", *flags)]) == 0
        args = ["--config", cfg_path, "--workdir", work, *flags, "--mat-fp", meta["mat_file_path"], "--h5-fp",
                meta["h5_file_path"]]
        assert jcli.main(["infer", videos[0], *args]) == 0
        assert cli.main(["infer", videos[0], *args]) == 0
        assert len(exported) == len(jax_exported) == 1
        np.testing.assert_array_equal(exported[0], jax_exported[0])
        pcfg = cli._load_cfg(cli.build_parser().parse_args(["infer", videos[0], *args]))
        jcfg = jcli._load_cfg(cli.build_parser().parse_args(["infer", videos[0], *args]))
        ckp = os.path.join(work, "models", "importance")
        st = port_load(ckp, port_state(0, pcfg, device="cpu"), tag="opt")
        js = jax_load(ckp, create_train_state(jax.random.PRNGKey(0), jcfg), tag="opt")
        item, jitem = port_item(videos[0], pcfg, None, None, True, device="cpu"), build_video_item(videos[0], jcfg,
                                                                                                None, None, True)
        np.testing.assert_array_equal(item.text.numpy(), jitem.text)
        np.testing.assert_allclose(
            port_fuse(st.params, st.model_state, {"visual": item.visual, "audio": item.audio, "text": item.text},
                      pcfg, device="cpu"),
            fuse(js.params, js.model_state, {"visual": jitem.visual, "audio": jitem.audio, "text": jitem.text}, jcfg),
            atol=1e-5, rtol=0)


class TestEvalTrunk:
    def test_eval_matches_jax(self, env, small_cfg, capsys):
        """``eval`` of the JAX-written trunk prints the JAX package's numbers (loss 1e-5 relative, F equal)."""
        from cvml_goalnet_tpu import cli as jcli

        args = _data_args(env["meta"], env["cfg"], env["work"])
        outs = []
        for main in (jcli.main, cli.main):
            assert main(["eval", *args]) == 0
            outs.append([ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("[eval]")])
        for got, want in zip(*outs[::-1]):
            g, w = got.split(" - "), want.split(" - ")
            assert g[0] == w[0] and g[2:] == w[2:]
            assert float(g[1].split(": ")[1]) == pytest.approx(float(w[1].split(": ")[1]), rel=1e-3)   # 4 decimals

    def test_missing_trunk(self, env, tmp_path, capsys):
        assert cli.main(["eval", *_data_args(env["meta"], env["cfg"], str(tmp_path))]) == 2
        assert "no opt/ckp checkpoint" in capsys.readouterr().err

    def test_trunk_of_another_structure(self, env, small_cfg, tmp_path, capsys):
        other = dataclasses.replace(small_cfg, model=dataclasses.replace(small_cfg.model, fusion_hidden=(8,)))
        save_checkpoint(str(tmp_path / "models" / "importance"), create_train_state(jax.random.PRNGKey(0), other),
                        other, tag="opt")
        assert cli.main(["eval", *_data_args(env["meta"], env["cfg"], str(tmp_path))]) == 2
        assert "does not match the current config" in capsys.readouterr().err

    def test_train_without_a_card_or_the_variable_raises(self, env, tmp_path, monkeypatch):
        import torch

        if torch.cuda.is_available():
            pytest.skip("a card is present")
        monkeypatch.delenv("GOALNET_PLATFORM")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["train", *_data_args(env["meta"], env["cfg"], str(tmp_path), "--epochs", "1")])
