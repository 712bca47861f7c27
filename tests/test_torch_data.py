"""PyTorch port: the host data layer against the JAX package, on the CPU.

The same seeded files through ``cvml_goalnet_tpu.data.*`` and
``cvml_goalnet_tpu_torch.data.*``: WAV reading and resampling, decode and
streaming decode of ``.npz`` archives and of small mp4s written with cv2,
the clip export, the synthetic dataset on disk, the annotation store,
``build_video_item`` (features at the tolerances of
``tests/test_torch_pipeline.py``: visual 1e-5, audio rtol 1e-3 / atol 2e-3;
intervals and ground-truth masks exact), the prefetcher, the live-directory
follower, the plots and the checkpoint layout in both directions.
"""

from __future__ import annotations

import dataclasses
import filecmp
import os
import threading
import time

import jax
import numpy as np
import pytest
import torch

from cvml_goalnet_tpu.data import annotations as JA
from cvml_goalnet_tpu.data import audio_io as JAIO
from cvml_goalnet_tpu.data import dataset as JD
from cvml_goalnet_tpu.data import follow as JF
from cvml_goalnet_tpu.data import video as JV
from cvml_goalnet_tpu.models.avm import avm_init
from cvml_goalnet_tpu.train import checkpoint as JC
from cvml_goalnet_tpu.train.state import create_train_state as jax_create_train_state
from cvml_goalnet_tpu_torch import runtime
from cvml_goalnet_tpu_torch.config import PipelineConfig
from cvml_goalnet_tpu_torch.data import annotations as TA
from cvml_goalnet_tpu_torch.data import audio_io as TAIO
from cvml_goalnet_tpu_torch.data import dataset as TD
from cvml_goalnet_tpu_torch.data import follow as TF
from cvml_goalnet_tpu_torch.data import synthetic as TS
from cvml_goalnet_tpu_torch.data import video as TV
from cvml_goalnet_tpu_torch.train import checkpoint as TC
from cvml_goalnet_tpu_torch.train.state import create_train_state
from cvml_goalnet_tpu_torch import viz

CPU = "cpu"
SKIP = 3


def _port_cfg(jcfg) -> PipelineConfig:
    return PipelineConfig.from_json(jcfg.to_json())


@pytest.fixture(scope="module")
def port_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_synth")
    return TS.synthetic_dataset_dir(str(root / "data"), full_n_frames=240, n_clips=6)


def _write_mp4(path, frames, fps=30):
    import cv2

    h, w = frames.shape[1:3]
    out = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    for f in frames:
        out.write(np.ascontiguousarray(f))
    out.release()


@pytest.fixture(scope="module")
def media(tmp_path_factory):
    """A 47-frame mp4 (cv2) and an .npz of the same frames."""
    root = tmp_path_factory.mktemp("media")
    frames = TS.synthetic_video_frames(47, 48, 64, seed=11)
    mp4, npz = str(root / "clip.mp4"), str(root / "clip.npz")
    _write_mp4(mp4, frames)
    np.savez(npz, frames=frames)
    return {"mp4": mp4, "npz": npz, "frames": frames, "root": root}


# ----------------------------------------------------------------------- WAV


class TestAudioIO:
    @pytest.mark.parametrize("sr", [22050, 16000])
    def test_native_scipy_and_jax_read_equal_samples(self, tmp_path, sr, monkeypatch):
        y = TS.synthetic_waveform(sr // 2 + 13, sr, seed=3)
        path = str(tmp_path / "a.wav")
        TAIO.write_wav(path, y, sr)
        jax_path = str(tmp_path / "b.wav")
        JAIO.write_wav(jax_path, y, sr)
        assert filecmp.cmp(path, jax_path, shallow=False)

        native = runtime.wav_read_native(path)
        assert native is not None and native[1] == sr
        monkeypatch.setattr(TAIO, "wav_read_native", lambda p: None)
        scipy_y, scipy_sr = TAIO._read_wav(path)
        monkeypatch.undo()
        want, want_sr = JAIO._read_wav(path)
        assert scipy_sr == want_sr == sr
        np.testing.assert_array_equal(native[0], want)
        np.testing.assert_array_equal(scipy_y, want)

    def test_native_reader_refuses_a_non_wav(self, tmp_path):
        path = tmp_path / "x.wav"
        path.write_bytes(b"not a wav file at all")
        assert runtime.wav_read_native(str(path)) is None

    @pytest.mark.parametrize("orig,target", [(44100, 22050), (16000, 22050), (22050, 22050), (48000, 22050)])
    def test_resample_matches_jax(self, orig, target):
        y = TS.synthetic_waveform(orig // 3, orig, seed=5)
        np.testing.assert_array_equal(TAIO.resample(y, orig, target), JAIO.resample(y, orig, target))

    def test_load_waveform_matches_jax(self, tmp_path):
        path = str(tmp_path / "a.wav")
        TAIO.write_wav(path, TS.synthetic_waveform(8000, 8000, seed=1), 8000)
        got, sr = TAIO.load_waveform(path, 22050)
        want, want_sr = JAIO.load_waveform(path, 22050)
        assert sr == want_sr
        np.testing.assert_array_equal(got, want)

    def test_demux_needs_ffmpeg_or_a_sidecar(self, tmp_path, monkeypatch):
        monkeypatch.setattr(TAIO.shutil, "which", lambda _: None)
        with pytest.raises(RuntimeError, match="no ffmpeg"):
            TAIO.demux_audio(str(tmp_path / "v.mp4"), str(tmp_path / "v.wav"))


# --------------------------------------------------------------------- video


class TestVideo:
    @pytest.mark.parametrize("skip", [1, 3, 7])
    def test_decode_matches_jax(self, media, skip):
        got, n = TV.decode_condensed_frames(media["mp4"], skip)
        want, want_n = JV.decode_condensed_frames(media["mp4"], skip)
        assert n == want_n == 47
        np.testing.assert_array_equal(got, want)

    def test_decode_all_frames_matches_jax(self, media):
        for drop in (False, True):
            np.testing.assert_array_equal(TV.decode_all_frames(media["mp4"], drop), JV.decode_all_frames(media["mp4"], drop))

    @pytest.mark.parametrize("kind", ["npz", "mp4"])
    @pytest.mark.parametrize("chunk", [1, 4, 16, 100])
    def test_stream_matches_jax(self, media, kind, chunk):
        got_counter, want_counter = {}, {}
        got = list(TV.stream_condensed_frames(media[kind], SKIP, chunk, counter=got_counter))
        want = list(JV.stream_condensed_frames(media[kind], SKIP, chunk, counter=want_counter))
        assert [len(c) for c in got] == [len(c) for c in want]
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        assert got_counter == want_counter == {"full_n": 47}

    @pytest.mark.parametrize("workers", [1, 2, 4])
    def test_parallel_decoders_match_jax(self, media, workers):
        got, n = TV.decode_condensed_frames_parallel(media["mp4"], SKIP, workers)
        want, want_n = JV.decode_condensed_frames_parallel(media["mp4"], SKIP, workers)
        assert n == want_n
        np.testing.assert_array_equal(got, want)
        got = list(TV.stream_condensed_frames_parallel(media["mp4"], SKIP, 4, workers))
        want = list(JV.stream_condensed_frames_parallel(media["mp4"], SKIP, 4, workers))
        assert [len(c) for c in got] == [len(c) for c in want]
        np.testing.assert_array_equal(np.concatenate(got), np.concatenate(want))

    def test_decode_workers(self, media):
        assert TV.resolve_decode_workers("3", media["mp4"]) == 3
        assert TV.pick_decode_workers(media["mp4"], candidates=(1,), use_cache=False) == 1
        assert TV.probe_video_fps(media["npz"]) is None
        assert TV.probe_video_fps(media["mp4"]) == JV.probe_video_fps(media["mp4"])

    @pytest.mark.parametrize("kind", ["npz", "mp4"])
    @pytest.mark.parametrize("intervals", [[[0, 5], [9, 20], [40, 47]], [[3, 4]], [[30, 60]]])
    def test_export_selected_clips_counts_match_jax(self, media, tmp_path, kind, intervals):
        got = TV.export_selected_clips_stream(media[kind], intervals, str(tmp_path / "t.mp4"))
        want = JV.export_selected_clips_stream(media[kind], intervals, str(tmp_path / "j.mp4"))
        assert got == want == sum(min(b, 47) - a for a, b in intervals)
        assert len(TV.decode_all_frames(str(tmp_path / "t.mp4"))) == got

    def test_export_refuses_overlapping_intervals(self, media, tmp_path):
        with pytest.raises(ValueError, match="ascending and disjoint"):
            TV.export_selected_clips_stream(media["npz"], [[0, 10], [5, 12]], str(tmp_path / "x.mp4"))

    def test_export_video_frame_count(self, media, tmp_path):
        TV.export_video(media["frames"][:9], str(tmp_path / "e.mp4"), fps=30)
        assert len(TV.decode_all_frames(str(tmp_path / "e.mp4"))) == 9


# -------------------------------------------------- synthetic data, annotations


class TestSyntheticAndAnnotations:
    def test_dataset_dir_files_equal_jax(self, port_dir, synth_dir):
        # the suite's synth_dir is JAX's synthetic_dataset_dir(full_n_frames=240, n_clips=6)
        for a, b in zip(port_dir["video_fps"], synth_dir["video_fps"]):
            np.testing.assert_array_equal(np.load(a)["frames"], np.load(b)["frames"])
            assert filecmp.cmp(a[:-4] + ".wav", b[:-4] + ".wav", shallow=False)
        for name in ("annotation_fp", "info_fp"):
            assert filecmp.cmp(port_dir[name], synth_dir[name], shallow=False)
        assert {k: v for k, v in port_dir.items() if not k.endswith(("fp", "path", "fps"))} == \
               {k: v for k, v in synth_dir.items() if not k.endswith(("fp", "path", "fps"))}

    @pytest.mark.parametrize("vid", ["vidA", "vidB"])
    def test_store_equals_jax(self, port_dir, synth_dir, vid):
        got = TA.AnnotationStore(port_dir["mat_file_path"], port_dir["h5_file_path"])
        want = JA.AnnotationStore(synth_dir["mat_file_path"], synth_dir["h5_file_path"])
        np.testing.assert_array_equal(got.change_points(vid), want.change_points(vid))
        np.testing.assert_array_equal(got.user_annotations(vid), want.user_annotations(vid))
        assert got.mat_nframes(vid) == want.mat_nframes(vid)
        for skip in (1, 30):
            for a, b in zip(TA.load_tvsum_annotations(port_dir["annotation_fp"], vid, skip),
                            JA.load_tvsum_annotations(synth_dir["annotation_fp"], vid, skip)):
                np.testing.assert_array_equal(a, b)

    def test_unknown_ids_raise(self, port_dir):
        store = TA.AnnotationStore(port_dir["mat_file_path"], port_dir["h5_file_path"])
        with pytest.raises(KeyError):
            store.change_points("nope")
        with pytest.raises(KeyError, match="no annotator rows"):
            TA.load_tvsum_annotations(port_dir["annotation_fp"], "nope", 30)

    def test_titles_match_jax(self, port_dir):
        ids = ["vidA", "vidB", "other"]
        assert TD._load_titles(port_dir["info_fp"], ids) == JD._load_titles(port_dir["info_fp"], ids)


# --------------------------------------------------------------- video items


@pytest.fixture(scope="module")
def jax_weights(small_cfg):
    params, state = avm_init(jax.random.PRNGKey(0), small_cfg.model, small_cfg.preprocess, small_cfg.audio)
    return jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, state)


def _assert_items_match(got, want):
    assert (got.video_id, got.title, got.full_n_frames) == (want.video_id, want.title, want.full_n_frames)
    np.testing.assert_allclose(got.visual.numpy(), np.asarray(want.visual), atol=1e-5)
    if want.audio is None:
        assert got.audio is None
    else:
        np.testing.assert_allclose(got.audio.numpy(), np.asarray(want.audio), rtol=1e-3, atol=2e-3)
    np.testing.assert_array_equal(got.clip_intervals, want.clip_intervals)
    for a, b in ((got.labels, want.labels), (got.gd_summary_masks, want.gd_summary_masks)):
        if b is None:
            assert a is None
        else:
            np.testing.assert_array_equal(a, b)


class TestBuildVideoItem:
    @pytest.mark.parametrize("with_store", [True, False])
    @pytest.mark.parametrize("audio", [True, False])
    def test_matches_jax(self, synth_dir, small_cfg, with_store, audio):
        vid = synth_dir["video_fps"][1]
        jstore = JA.AnnotationStore(synth_dir["mat_file_path"], synth_dir["h5_file_path"]) if with_store else None
        tstore = TA.AnnotationStore(synth_dir["mat_file_path"], synth_dir["h5_file_path"]) if with_store else None
        anno = synth_dir["annotation_fp"] if with_store else None
        want = JD.build_video_item(vid, small_cfg, anno, jstore, audio, title="T")
        got = TD.build_video_item(vid, _port_cfg(small_cfg), anno, tstore, audio, title="T", device=CPU)
        _assert_items_match(got, want)

    def test_build_datasets_matches_jax(self, synth_dir, small_cfg):
        args = (synth_dir["annotation_fp"], synth_dir["mat_file_path"], synth_dir["h5_file_path"],
                synth_dir["info_fp"])
        want = JD.build_datasets(synth_dir["video_fps"], small_cfg, *args, audio_included=True)
        got = TD.build_datasets(synth_dir["video_fps"], _port_cfg(small_cfg), *args, audio_included=True, device=CPU)
        for g, w in zip(got, want):
            assert len(g) == len(w)
            for a, b in zip(g, w):
                _assert_items_match(a, b)

    def test_uniform_intervals_match_jax_serve(self, small_cfg):
        from cvml_goalnet_tpu.serve import _uniform_clip_intervals

        for full_n in (1, 59, 240, 4500):
            np.testing.assert_array_equal(TD.uniform_clip_intervals(_port_cfg(small_cfg), full_n),
                                          _uniform_clip_intervals(small_cfg, full_n))

    def test_commentary_sidecar_matches_jax(self, synth_dir, small_cfg, tmp_path):
        """With the text branch the ``.commentary.jsonl`` sidecar is read and aligned as the JAX package does,
        and the token ids are cut with the other per-frame tensors to the annotation's length; a video
        without a sidecar gets all-zero ids."""
        import json
        import shutil

        jcfg = dataclasses.replace(small_cfg, model=dataclasses.replace(small_cfg.model, text_included=True))
        store = JA.AnnotationStore(synth_dir["mat_file_path"], synth_dir["h5_file_path"])
        for i, fp in enumerate(synth_dir["video_fps"][:2]):
            video = str(tmp_path / os.path.basename(fp))
            shutil.copy(fp, video)
            shutil.copy(fp.rsplit(".", 1)[0] + ".wav", video.rsplit(".", 1)[0] + ".wav")
            if i == 0:
                with open(video.rsplit(".", 1)[0] + ".commentary.jsonl", "w") as f:
                    for frame, line in ((30, "kick off"), (100, "shot on target"), (181, "GOAL")):
                        f.write(json.dumps({"frame": frame, "text": line}) + "\n")
            want = JD.build_video_item(video, jcfg, synth_dir["annotation_fp"], store, True)
            got = TD.build_video_item(video, _port_cfg(jcfg), synth_dir["annotation_fp"], store, True, device=CPU)
            assert got.text.dtype == torch.int32 and len(got.text) == len(got.visual) == len(want.labels)
            np.testing.assert_array_equal(got.text.numpy(), want.text)
            assert bool(got.text.numpy().any()) == (i == 0)

    def test_decode_workers_env(self, media, monkeypatch):
        monkeypatch.setenv("GOALNET_DECODE_WORKERS", "2")
        got = TD._load_frames(media["mp4"], SKIP)
        want = JD._load_frames(media["mp4"], SKIP)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]


# ---------------------------------------------------------------- prefetcher


class TestPrefetcher:
    @pytest.mark.parametrize("depth", [1, 2, 5])
    def test_order(self, depth):
        assert list(TD.Prefetcher(iter(range(37)), depth=depth)) == list(range(37))

    def test_error_reaches_the_consumer_after_the_items_before_it(self):
        def gen():
            yield 1
            yield 2
            raise KeyError("boom")

        got = []
        with pytest.raises(KeyError, match="boom"):
            for x in TD.Prefetcher(gen()):
                got.append(x)
        assert got == [1, 2]

    def test_early_exit_closes_the_source(self):
        closed = threading.Event()

        def gen():
            try:
                for i in range(1000):
                    yield i
            finally:
                closed.set()

        it = iter(TD.Prefetcher(gen(), depth=2))
        assert next(it) == 0
        it.close()
        assert closed.wait(5.0)


# ------------------------------------------------------------------- follow


def _write_segment(dirpath, name, frames, wav=None, sr=8000):
    seg = os.path.join(dirpath, name)
    if wav is not None:
        TAIO.write_wav(os.path.join(dirpath, name.rsplit(".", 1)[0] + ".wav"), wav, sr)
    with open(seg + ".part", "wb") as f:
        np.savez(f, frames=frames)
    os.replace(seg + ".part", seg)


def _frames(n, seed=0, hw=(24, 24)):
    return np.random.default_rng(seed).integers(0, 255, (n, *hw, 3), dtype=np.uint8)


class TestFollow:
    def test_sentinel_order_and_scratch_names(self, tmp_path):
        d = str(tmp_path)
        _write_segment(d, "00002.npz", _frames(4, 2))
        _write_segment(d, "00001.npz", _frames(4, 1))
        for junk in ("00003.npz.part", "00001.wav", ".hidden", "x.json", "y.tmp"):
            open(os.path.join(d, junk), "w").close()
        open(os.path.join(d, "END"), "w").close()
        got = list(TF.follow_segments(d, timeout=2.0, poll_interval=0.05))
        want = list(JF.follow_segments(d, timeout=2.0, poll_interval=0.05))
        assert got == want and [os.path.basename(p) for p in got] == ["00001.npz", "00002.npz"]
        assert TF.list_segments(d) == JF.list_segments(d) == got

    def test_timeout(self, tmp_path):
        for mod in (TF, JF):
            with pytest.raises(TimeoutError, match="no new segment"):
                list(mod.follow_segments(str(tmp_path), timeout=0.2, poll_interval=0.05))

    def test_stale_name_raises(self, tmp_path):
        d = str(tmp_path)
        _write_segment(d, "00005.npz", _frames(2))
        for mod in (TF, JF):
            it = mod.follow_segments(d, timeout=2.0, poll_interval=0.05)
            assert os.path.basename(next(it)) == "00005.npz"
            _write_segment(d, "00003.npz", _frames(2))
            with pytest.raises(RuntimeError, match="monotonically increasing"):
                next(it)
            os.remove(os.path.join(d, "00003.npz"))

    def test_missing_directory_and_file(self, tmp_path):
        for mod in (TF, JF):
            with pytest.raises(FileNotFoundError, match="does not exist"):
                next(mod.follow_segments(str(tmp_path / "nope"), timeout=0.1))
        f = tmp_path / "file.npz"
        f.write_bytes(b"")
        with pytest.raises(NotADirectoryError, match="not a segment directory"):
            next(TF.follow_segments(str(f), timeout=0.1))

    def test_list_segments_needs_the_sentinel(self, tmp_path):
        with pytest.raises(ValueError, match="has not ended"):
            TF.list_segments(str(tmp_path))

    @pytest.mark.parametrize("chunk", [1, 4, 7])
    def test_chunks_match_jax_while_the_directory_grows(self, tmp_path, chunk):
        d = str(tmp_path)
        parts = [_frames(n, seed=i) for i, n in enumerate((10, 7, 1, 12))]

        def writer():
            for i, p in enumerate(parts):
                time.sleep(0.05)
                _write_segment(d, f"{i:05d}.npz", p)
            open(os.path.join(d, "END"), "w").close()

        w = threading.Thread(target=writer)
        w.start()
        counter = {}
        got = list(TF.stream_condensed_frames_follow(d, SKIP, chunk, counter=counter, poll_interval=0.02,
                                                     timeout=10.0))
        w.join(10.0)
        assert not w.is_alive()
        want_counter = {}
        want = list(JF.stream_condensed_frames_follow(d, SKIP, chunk, counter=want_counter, timeout=1.0))
        assert [len(c) for c in got] == [len(c) for c in want]
        np.testing.assert_array_equal(np.concatenate(got), np.concatenate(parts)[::SKIP])
        assert counter == want_counter == {"full_n": 30}

    def test_audio_rows_match_jax(self, tmp_path, small_cfg):
        d = str(tmp_path)
        acfg = dataclasses.replace(small_cfg.audio, sample_rate=8000)
        for i, n in enumerate((9, 6)):
            _write_segment(d, f"{i:05d}.npz", _frames(n, seed=i), TS.synthetic_waveform(n * 800, 8000, seed=i))
        open(os.path.join(d, "END"), "w").close()
        port_acfg = _port_cfg(dataclasses.replace(small_cfg, audio=acfg)).audio
        got = list(TF.follow_condensed_chunks(d, SKIP, 2, audio_cfg=port_acfg, timeout=1.0))
        want = list(JF.follow_condensed_chunks(d, SKIP, 2, audio_cfg=acfg, timeout=1.0))
        assert len(got) == len(want)
        for (gf, ga), (wf, wa) in zip(got, want):
            np.testing.assert_array_equal(gf, wf)
            np.testing.assert_allclose(ga, np.asarray(wa), rtol=1e-3, atol=2e-3)

    def test_missing_sidecar_is_loud(self, tmp_path, small_cfg):
        d = str(tmp_path)
        _write_segment(d, "00000.npz", _frames(6))
        open(os.path.join(d, "END"), "w").close()
        with pytest.raises(ValueError, match="sidecar"):
            list(TF.follow_condensed_chunks(d, SKIP, 4, audio_cfg=_port_cfg(small_cfg).audio, timeout=1.0))

    @pytest.mark.parametrize("intervals", [[[0, 5], [9, 20]], [[12, 29]], [[2, 3], [25, 40]]])
    def test_export_from_segments_matches_jax(self, tmp_path, intervals):
        d = str(tmp_path / "segs")
        os.makedirs(d)
        parts = [_frames(n, seed=i) for i, n in enumerate((10, 7, 13))]
        for i, p in enumerate(parts):
            _write_segment(d, f"{i:05d}.npz", p)
        open(os.path.join(d, "END"), "w").close()
        got = TF.export_selected_clips_from_segments(d, intervals, str(tmp_path / "t.mp4"))
        want = JF.export_selected_clips_from_segments(d, intervals, str(tmp_path / "j.mp4"))
        assert got == want == sum(min(b, 30) - a for a, b in intervals)
        assert len(TV.decode_all_frames(str(tmp_path / "t.mp4"))) == got


# ------------------------------------------------------------- viz, checkpoints


def test_plots_are_written(tmp_path):
    history = {"train_loss": [3.0, 2.0, 1.5], "val_loss": [], "train_f_avg": [0.1, 0.2, 0.3],
               "train_f_max": [0.2, 0.3, 0.4], "val_f_avg": [], "val_f_max": []}
    viz.generate_metric_plots(history, str(tmp_path / "curves.png"), opt_val_loss=1.7)
    viz.export_indices(np.array([0, 1, 1, 0], np.uint8), np.ones((3, 4), np.uint8), str(tmp_path / "idx.png"))
    assert (tmp_path / "curves.png").stat().st_size > 0 and (tmp_path / "idx.png").stat().st_size > 0


class TestCheckpoint:
    @pytest.mark.parametrize("audio", [True, False])
    def test_jax_checkpoint_loads_into_the_port(self, tmp_path, small_cfg, audio):
        jcfg = dataclasses.replace(small_cfg, model=dataclasses.replace(small_cfg.model, audio_included=audio))
        jstate = jax_create_train_state(jax.random.PRNGKey(3), jcfg)._replace(epoch=4)
        JC.save_checkpoint(str(tmp_path), jstate, jcfg, tag="opt")
        got = TC.load_checkpoint(str(tmp_path), create_train_state(0, _port_cfg(jcfg), device=CPU), tag="opt")
        assert got.epoch == 4 and got.opt_state.step == 0
        np.testing.assert_array_equal(got.params["fusion"][0]["w"].numpy(), np.asarray(jstate.params["fusion"][0]["w"]))
        np.testing.assert_array_equal(got.model_state["visual"]["bn1"]["var"].numpy(),
                                      np.asarray(jstate.model_state["visual"]["bn1"]["var"]))

    def test_port_checkpoint_loads_into_jax(self, tmp_path, small_cfg):
        cfg = _port_cfg(small_cfg)
        state = create_train_state(5, cfg, device=CPU)
        state = state._replace(epoch=2, opt_state=state.opt_state._replace(step=7))
        TC.save_checkpoint(str(tmp_path), state, cfg, tag="ckp")
        got = JC.load_checkpoint(str(tmp_path), jax_create_train_state(jax.random.PRNGKey(0), small_cfg), tag="ckp")
        assert got.epoch == 2 and int(got.opt_state.step) == 7
        np.testing.assert_array_equal(np.asarray(got.params["visual"]["head"]["w"]),
                                      state.params["visual"]["head"]["w"].numpy())
        back = TC.load_checkpoint(str(tmp_path), create_train_state(9, cfg, device=CPU), tag="ckp")
        for a, b in zip(jax.tree.leaves(back.params), jax.tree.leaves(state.params)):
            assert torch.equal(a, b)

    def test_structure_mismatch_raises(self, tmp_path, small_cfg):
        cfg = _port_cfg(small_cfg)
        TC.save_checkpoint(str(tmp_path), create_train_state(0, cfg, device=CPU), cfg, tag="opt")
        no_audio = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, audio_included=False))
        with pytest.raises(TC.CheckpointMismatchError, match="does not match the current config"):
            TC.load_checkpoint(str(tmp_path), create_train_state(0, no_audio, device=CPU), tag="opt")
