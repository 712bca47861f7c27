"""PyTorch port: the streaming scorer against the JAX package's, on the CPU.

The same seeded frames, MFCC blocks and weights (``weights.from_jax``)
through ``cvml_goalnet_tpu.streaming.score_video_stream`` and the port's, at
chunk sizes 1, 4, N and N + 1, with device and host preprocessing and the
three transfer dtypes.  The bounds are the JAX package's own
(``tests/test_streaming_resilience.py``): 1e-4 between float32 paths (host
against device preprocess too), 1e-3 for float16 transfers, 2e-2 for uint8.
The alignment errors and the commentary refusal are JAX's word for word.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest

from cvml_goalnet_tpu import streaming as JS
from cvml_goalnet_tpu.models.avm import avm_init
from cvml_goalnet_tpu_torch import streaming as TS
from cvml_goalnet_tpu_torch import weights as W
from cvml_goalnet_tpu_torch.config import PipelineConfig
from cvml_goalnet_tpu_torch.data.synthetic import synthetic_change_points
from cvml_goalnet_tpu_torch.ops.cuda.fused_preprocess import fused_preprocess_frames
from cvml_goalnet_tpu_torch.pipeline import extract_features, fuse

CPU = "cpu"
N = 70
BOUND = {None: 1e-4, np.float16: 1e-3, np.uint8: 2e-2}


def _chunks(x, size):
    for i in range(0, len(x), size):
        yield x[i:i + size]


def _cfgs(small_cfg, audio: bool):
    jcfg = dataclasses.replace(small_cfg, model=dataclasses.replace(small_cfg.model, audio_included=audio))
    return jcfg, PipelineConfig.from_json(jcfg.to_json())


@pytest.fixture(scope="module")
def inputs(small_cfg):
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 255, (N, 48, 64, 3)).astype(np.uint8)
    audio = rng.random((N, small_cfg.audio.bin_length, small_cfg.audio.n_mfcc)).astype(np.float32)
    return frames, audio


@pytest.fixture(scope="module")
def trunks(small_cfg):
    """{audio_included: (jax params, jax state, port params, port state, jax cfg, port cfg)}"""
    out = {}
    for audio in (True, False):
        jcfg, cfg = _cfgs(small_cfg, audio)
        params, state = avm_init(jax.random.PRNGKey(0), jcfg.model, jcfg.preprocess, jcfg.audio)
        out[audio] = (params, state, *W.from_jax(params, state, device=CPU), jcfg, cfg)
    return out


@pytest.mark.parametrize("chunk", [1, 4, N, N + 1])
@pytest.mark.parametrize("audio", [True, False])
def test_device_preprocess_matches_jax(inputs, trunks, chunk, audio):
    frames, mfcc = inputs
    jp, js, tp, ts, jcfg, cfg = trunks[audio]
    a_chunks = (lambda: _chunks(mfcc, chunk)) if audio else (lambda: None)
    want, want_stats = JS.score_video_stream(jp, js, _chunks(frames, chunk), jcfg, chunk_size=chunk,
                                             audio_chunks=a_chunks())
    got, stats = TS.score_video_stream(tp, ts, _chunks(frames, chunk), cfg, chunk_size=chunk,
                                       audio_chunks=a_chunks(), device=CPU)
    assert got.shape == want.shape == (N,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-4)
    assert (stats.chunks, stats.frames) == (want_stats.chunks, want_stats.frames) == (-(-N // chunk), N)
    assert {"stage_decode", "stage_produce", "stage_upload", "stage_dispatch", "stage_drain"} <= set(stats.stage_seconds)


def test_stream_equals_offline_fuse(inputs, trunks):
    frames, mfcc = inputs
    _, _, tp, ts, _, cfg = trunks[True]
    feats = extract_features(frames, None, cfg, device=CPU)
    feats["audio"] = mfcc
    want = fuse(tp, ts, feats, cfg, device=CPU)
    got, _ = TS.score_video_stream(tp, ts, _chunks(frames, 32), cfg, chunk_size=32,
                                   audio_chunks=_chunks(mfcc, 32), device=CPU)
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("chunk", [1, 4, N, N + 1])
@pytest.mark.parametrize("tdtype", [None, np.float16, np.uint8])
def test_host_preprocess_matches_jax(inputs, trunks, chunk, tdtype):
    frames, _ = inputs
    jp, js, tp, ts, jcfg, cfg = trunks[False]
    want, _ = JS.score_video_stream(jp, js, _chunks(frames, chunk), jcfg, chunk_size=chunk, host_preprocess=True,
                                    transfer_dtype=tdtype)
    got, _ = TS.score_video_stream(tp, ts, _chunks(frames, chunk), cfg, chunk_size=chunk, host_preprocess=True,
                                   transfer_dtype=tdtype, device=CPU)
    np.testing.assert_allclose(got, want, atol=BOUND[tdtype])
    device_pre, _ = TS.score_video_stream(tp, ts, _chunks(frames, chunk), cfg, chunk_size=chunk, device=CPU)
    np.testing.assert_allclose(got, device_pre, atol=BOUND[tdtype])


def test_host_preprocess_runs_no_preprocess_kernel(inputs, trunks, monkeypatch):
    frames, _ = inputs
    _, _, tp, ts, _, cfg = trunks[False]
    calls = []
    import cvml_goalnet_tpu_torch.ops.preprocess as P

    monkeypatch.setattr(P, "fused_preprocess_frames", lambda *a: calls.append(1) or fused_preprocess_frames(*a))
    TS.score_video_stream(tp, ts, _chunks(frames, 16), cfg, chunk_size=16, host_preprocess=True, device=CPU)
    assert calls == []
    TS.score_video_stream(tp, ts, _chunks(frames, 16), cfg, chunk_size=16, device=CPU)
    assert len(calls) == 5


def test_summarize_video_stream_matches_jax(inputs, trunks):
    frames, _ = inputs
    jp, js, tp, ts, jcfg, cfg = trunks[False]
    full_n = N * cfg.preprocess.skip_frames
    iv = synthetic_change_points(full_n, 12, seed=3)
    want, _ = JS.summarize_video_stream(jp, js, _chunks(frames, 8), iv, full_n, jcfg, chunk_size=8)
    got, stats = TS.summarize_video_stream(tp, ts, _chunks(frames, 8), iv, full_n, cfg, chunk_size=8, device=CPU)
    assert got.selected_clips == want.selected_clips
    np.testing.assert_array_equal(got.frame_mask, want.frame_mask)
    assert stats.frames == N


class TestRefusals:
    def test_audio_exhausted(self, inputs, trunks):
        frames, mfcc = inputs
        _, _, tp, ts, _, cfg = trunks[True]
        with pytest.raises(ValueError, match="audio_chunks exhausted before frame_chunks — the stream must "
                                             "yield one chunk per frame chunk"):
            TS.score_video_stream(tp, ts, _chunks(frames, 32), cfg, chunk_size=32,
                                  audio_chunks=_chunks(mfcc[:32], 32), device=CPU)

    def test_audio_boundary(self, inputs, trunks):
        frames, mfcc = inputs
        _, _, tp, ts, _, cfg = trunks[True]
        with pytest.raises(ValueError, match="audio_chunks chunk has 16 rows but the frame chunk has 32 — chunk "
                                             "the modalities on the same boundaries as frame_chunks"):
            TS.score_video_stream(tp, ts, _chunks(frames, 32), cfg, chunk_size=32,
                                  audio_chunks=_chunks(mfcc, 16), device=CPU)

    def test_text_chunks_required(self, inputs, trunks, small_cfg):
        frames, _ = inputs
        _, _, tp, ts, jcfg, cfg = trunks[False]
        tcfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, text_included=True))
        jtcfg = dataclasses.replace(jcfg, model=dataclasses.replace(jcfg.model, text_included=True))
        messages = []
        for fn, c, p, s in ((TS.score_video_stream, tcfg, tp, ts), (JS.score_video_stream, jtcfg, *trunks[False][:2])):
            with pytest.raises(ValueError) as err:
                fn(p, s, _chunks(frames, 8), c, chunk_size=8)
            messages.append(str(err.value))
        assert messages[0] == messages[1]
        # with the chunks, a 3-modality trunk streams as the JAX scorer does and as the offline fuse scores
        from cvml_goalnet_tpu.data.text import tokenize

        params, state = avm_init(jax.random.PRNGKey(2), jtcfg.model, jtcfg.preprocess, jtcfg.audio)
        ttp, tts = W.from_jax(params, state, device=CPU)
        tokens = tokenize(["", "kick off", "shot", "GOAL!", "", "corner"] * 12, 128, 12)[:N]
        want, _ = JS.score_video_stream(params, state, _chunks(frames, 8), jtcfg, chunk_size=8,
                                        text_chunks=_chunks(tokens, 8))
        got, _ = TS.score_video_stream(ttp, tts, _chunks(frames, 8), tcfg, chunk_size=8,
                                       text_chunks=_chunks(tokens, 8), device=CPU)
        np.testing.assert_allclose(got, want, atol=1e-4)
        offline = fuse(ttp, tts, {**extract_features(frames, None, tcfg, device=CPU), "text": tokens}, tcfg,
                       device=CPU)
        np.testing.assert_allclose(got, offline, atol=1e-5)

    def test_chunk_longer_than_chunk_size(self, inputs, trunks):
        frames, _ = inputs
        _, _, tp, ts, _, cfg = trunks[False]
        with pytest.raises(ValueError, match="exceeds chunk_size"):
            TS.score_video_stream(tp, ts, _chunks(frames, 16), cfg, chunk_size=8, device=CPU)

    def test_decoder_error_reaches_the_caller(self, trunks):
        _, _, tp, ts, _, cfg = trunks[False]

        def broken():
            yield np.zeros((3, 48, 64, 3), np.uint8)
            raise OSError("decoder lost the file")

        with pytest.raises(OSError, match="decoder lost the file"):
            TS.score_video_stream(tp, ts, broken(), cfg, chunk_size=8, device=CPU)

    def test_empty_stream(self, trunks):
        _, _, tp, ts, _, cfg = trunks[False]
        scores, stats = TS.score_video_stream(tp, ts, iter([]), cfg, device=CPU)
        assert scores.shape == (0,) and (stats.chunks, stats.frames) == (0, 0)

    def test_no_card_raises(self, inputs, trunks):
        import torch

        if torch.cuda.is_available():
            pytest.skip("a card is present")
        frames, _ = inputs
        _, _, tp, ts, _, cfg = trunks[False]
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TS.score_video_stream(tp, ts, _chunks(frames, 8), cfg, chunk_size=8)


@pytest.mark.parametrize("shape,out_hw", [((5, 180, 320, 3), (40, 40)), ((64, 48, 64, 3), (24, 24)),
                                          ((3, 36, 36, 1), (24, 24))])
@pytest.mark.parametrize("with_cv2", [True, False])
def test_host_preprocess_takes_the_jax_paths(shape, out_hw, with_cv2, monkeypatch):
    """``--host-preprocess``'s producer: cv2.resize frame by frame where cv2 imports (threads from 64 frames),
    else the BLAS products, as the JAX host mirror; equal to it bit for bit either way."""
    import sys

    import cv2

    from cvml_goalnet_tpu.ops.preprocess import preprocess_frames_host as jax_host
    from cvml_goalnet_tpu_torch.ops.preprocess import preprocess_frames_host

    frames = np.random.default_rng(3).integers(0, 256, shape, dtype=np.uint8)
    calls = []
    if with_cv2:
        real = cv2.resize
        monkeypatch.setattr(cv2, "resize", lambda *a, **k: calls.append(1) or real(*a, **k))
    else:
        monkeypatch.setitem(sys.modules, "cv2", None)   # import cv2 raises ImportError
    got = preprocess_frames_host(frames, out_hw)
    assert len(calls) == (shape[0] if with_cv2 else 0)
    want = jax_host(frames, out_hw)
    assert got.dtype == np.float32 and got.shape == (shape[0], *out_hw, shape[3])
    np.testing.assert_array_equal(got, want)
