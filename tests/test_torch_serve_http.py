"""PyTorch port: the HTTP server against the JAX package's, on the CPU.

The JAX package's server and the port's (``device="cpu"``) run side by side
on ``127.0.0.1:0`` over the same trunk and head, and take the same requests:
status codes, payload keys, masks, clips and events must be equal.  Scores go
over the wire rounded (``/summarize`` to 4 decimals, ``/spot-stream`` to 6),
so they are held within 1e-4 (``test_torch_pipeline.py``'s bound for
``fuse``) plus one unit of that rounding.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest

import cvml_goalnet_tpu.serve as JV
from cvml_goalnet_tpu.spotting import temporal_head_init_auto
from cvml_goalnet_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from cvml_goalnet_tpu.train.state import create_train_state as jax_train_state
import cvml_goalnet_tpu_torch.serve as TV
from cvml_goalnet_tpu_torch import weights as W
from cvml_goalnet_tpu_torch.config import PipelineConfig
from cvml_goalnet_tpu_torch.data.audio_io import write_wav
from cvml_goalnet_tpu_torch.train.state import TrainState

CPU = "cpu"
SUMMARIZE_ATOL = 2e-4   # 1e-4, plus the wire's rounding to 4 decimals
STREAM_ATOL = 1e-4 + 1e-6
_servers: list = []


@pytest.fixture(autouse=True)
def _shut_down():
    """Shut down the servers and close the port's batchers a test started (the conftest closes only the JAX
    package's batchers)."""
    yield
    while _servers:
        s = _servers.pop()
        s.shutdown()
        s.server_close()
    for b in list(TV._live_batchers):
        b.close()


def _start(module, summarizer, **kw):
    server = module.start_http_background(summarizer, port=0, **kw)
    _servers.append(server)
    return server.server_address[1]


def _post(port, path, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(), method="POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.load(r)
    except urllib.error.HTTPError as e:
        return e.code, json.load(e)


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60) as r:
            return r.status, json.load(r)
    except urllib.error.HTTPError as e:
        return e.code, json.load(e)


def _stream(port, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/spot-stream", data=json.dumps(body).encode(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        assert r.headers["Content-Type"] == "application/x-ndjson"
        return [json.loads(line) for line in r if line.strip()]


def _port_cfg(jcfg) -> PipelineConfig:
    return PipelineConfig.from_json(jcfg.to_json())


def _port_state(jstate) -> TrainState:
    params, model_state = W.from_jax(jstate.params, jstate.model_state, device=CPU)
    return TrainState(params=params, model_state=model_state, opt_state=None, epoch=0)


def _frames(n, seed):
    return np.random.default_rng(seed).integers(0, 255, (n, 32, 40, 3), dtype=np.uint8)


@pytest.fixture(scope="module")
def world(small_cfg, tmp_path_factory):
    """Media (npz videos with wav sidecars), an audio summarization trunk and a no-audio banded spotter, each
    as the JAX package's and as the port's."""
    root = tmp_path_factory.mktemp("serve_http")
    media = root / "media"
    media.mkdir()
    scfg = small_cfg
    pcfg = dataclasses.replace(small_cfg, model=dataclasses.replace(
        small_cfg.model, audio_included=False, temporal_model="transformer", temporal_num_heads=2,
        temporal_window=4))
    sr = scfg.audio.sample_rate
    videos = []
    for i, n in enumerate((300, 270, 390, 240)):
        fp = str(media / f"v{i}.npz")
        np.savez(fp, frames=_frames(n, seed=i))
        write_wav(fp[:-4] + ".wav", np.random.default_rng(i).uniform(-0.5, 0.5, n * sr // 30).astype(np.float32),
                  sr)
        videos.append(fp)
    match = str(media / "match.npz")
    np.savez(match, frames=_frames(1200, seed=9))
    js = jax_train_state(jax.random.PRNGKey(3), scfg)
    jp = jax_train_state(jax.random.PRNGKey(4), pcfg)
    head = temporal_head_init_auto(jax.random.PRNGKey(5), pcfg.model.vis_feature_dim, pcfg.model, n_classes=1)
    return {"root": root, "media": str(media), "videos": videos, "match": match, "scfg": scfg, "pcfg": pcfg,
            "js": js, "ts": _port_state(js), "jp": jp, "tp": _port_state(jp), "head": head}


def _pair(world, spot=True, batch=False, **kw):
    """(JAX server port, the port's server port, the port's services) over the same weights."""
    jsum = JV.Summarizer(world["scfg"], state=world["js"])
    tsum = TV.Summarizer(_port_cfg(world["scfg"]), state=world["ts"], device=CPU)
    jspot = tspot = None
    if spot:
        jspot = JV.Spotter(world["pcfg"], state=world["jp"])
        tspot = TV.Spotter(_port_cfg(world["pcfg"]), state=world["tp"], device=CPU)
        jspot.temporal_params = world["head"]
        tspot.temporal_params = W.tree_from_jax(world["head"], device=CPU)
    jb = JV.DynamicBatcher(jsum, max_wait_ms=200.0, buckets=(16, 32)) if batch else None
    tb = TV.DynamicBatcher(tsum, max_wait_ms=200.0, buckets=(16, 32)) if batch else None
    jport = _start(JV, jsum, spotter=jspot, batcher=jb, **kw)
    tport = _start(TV, tsum, spotter=tspot, batcher=tb, **kw)
    return jport, tport, {"summarizer": tsum, "spotter": tspot, "batcher": tb, "jax_batcher": jb}


def _assert_summarize(got, want):
    assert set(got) == set(want) == {"video_id", "mask_frames", "clips", "scores"}
    assert (got["video_id"], got["mask_frames"], got["clips"]) == (want["video_id"], want["mask_frames"],
                                                                   want["clips"])
    np.testing.assert_allclose(got["scores"], want["scores"], atol=SUMMARIZE_ATOL)


class TestSummarize:
    @pytest.mark.parametrize("batch", [False, True])
    def test_summarize_matches_jax(self, world, batch):
        jport, tport, svc = _pair(world, spot=False, batch=batch)
        bodies = [{"video": v} for v in world["videos"]] * 2
        with ThreadPoolExecutor(4) as pool:
            got = list(pool.map(lambda b: _post(tport, "/summarize", b), bodies))
            want = list(pool.map(lambda b: _post(jport, "/summarize", b), bodies))
        for (gs, g), (ws, w_) in zip(got, want):
            assert gs == ws == 200
            _assert_summarize(g, w_)
        direct = svc["summarizer"].summarize_path(world["videos"][0])
        np.testing.assert_allclose(got[0][1]["scores"], np.round(direct.scores, 4), atol=1e-6)
        if batch:
            st = svc["batcher"].stats
            assert st["requests"] == len(bodies) and st["batches"] <= st["requests"]

    def test_errors_match_jax(self, world, tmp_path):
        outside = str(tmp_path / "outside.npz")
        np.savez(outside, frames=_frames(60, seed=1))
        jport, tport, _ = _pair(world, spot=False, media_root=world["media"])
        cases = [("/summarize", {"video": "missing.npz"}, 404),
                 ("/summarize", {"video": "../" + os.path.relpath(outside, world["root"])}, 403),
                 ("/summarize", {"video": "/../../" + outside}, 403),
                 ("/summarize", {}, 500),
                 ("/spot", {"video": "v0.npz"}, 404),
                 ("/spot-stream", {"video": "v0.npz"}, 404),
                 ("/nowhere", {}, 404)]
        for path, body, code in cases:
            (gs, g), (ws, w_) = _post(tport, path, body), _post(jport, path, body)
            assert gs == ws == code, (path, body, g, w_)
            assert set(g) == set(w_)
        got = _post(tport, "/summarize", {"video": "v1.npz"})
        assert got[0] == 200 and got[1]["video_id"] == "v1"
        assert _get(tport, "/nowhere") == _get(jport, "/nowhere") == (404, {"error": "unknown path"})

    def test_non_loopback_needs_a_media_root(self, world):
        tsum = TV.Summarizer(_port_cfg(world["scfg"]), state=world["ts"], device=CPU)
        with pytest.raises(ValueError, match="non-loopback"):
            TV.serve_http(tsum, host="0.0.0.0", port=0)
        server = TV.serve_http(tsum, host="0.0.0.0", port=0, media_root=world["media"])
        server.server_close()

    def test_metrics_and_healthz(self, world):
        jport, tport, _ = _pair(world, spot=False)
        for port in (jport, tport):
            for v in world["videos"][:3]:
                assert _post(port, "/summarize", {"video": v})[0] == 200
            assert _post(port, "/summarize", {"video": "nope.npz"})[0] == 404
            assert _post(port, "/reload", {})[0] == 400
            assert _post(port, "/elsewhere", {})[0] == 404
        assert _get(tport, "/healthz") == _get(jport, "/healthz") == (200, {"status": "ok"})
        (gs, g), (ws, w_) = _get(tport, "/metrics"), _get(jport, "/metrics")
        assert gs == ws == 200 and set(g) == set(w_) == {"uptime_s", "endpoints"}
        for ep in ("/summarize", "/reload", "(other)"):
            assert set(g["endpoints"][ep]) == set(w_["endpoints"][ep])
            assert {k: g["endpoints"][ep][k] for k in ("requests", "errors")} == \
                   {k: w_["endpoints"][ep][k] for k in ("requests", "errors")}
        assert g["endpoints"]["/summarize"]["requests"] == 4 and g["endpoints"]["/summarize"]["errors"] == 1

    def test_metrics_carry_the_batcher(self, world):
        _, tport, svc = _pair(world, spot=False, batch=True)
        assert _post(tport, "/summarize", {"video": world["videos"][0]})[0] == 200
        batcher = _get(tport, "/metrics")[1]["batcher"]
        assert batcher["requests"] == 1 and batcher["mean_batch_frames"] == 10.0


class TestSpot:
    def test_spot_matches_jax(self, world):
        jport, tport, _ = _pair(world)
        for body in ({"video": world["match"]}, {"video": world["match"], "peak_window": 2, "peak_threshold": -9}):
            (gs, g), (ws, w_) = _post(tport, "/spot", body), _post(jport, "/spot", body)
            assert gs == ws == 200
            assert g == w_

    def test_spot_multiclass_matches_jax(self, world):
        jcfg = world["pcfg"]
        classes = ["goal", "card"]
        head = temporal_head_init_auto(jax.random.PRNGKey(6), jcfg.model.vis_feature_dim, jcfg.model, n_classes=2)
        jspot = JV.Spotter(jcfg, state=world["jp"], classes=classes)
        tspot = TV.Spotter(_port_cfg(jcfg), state=world["tp"], classes=classes, device=CPU)
        jspot.temporal_params, tspot.temporal_params = head, W.tree_from_jax(head, device=CPU)
        jport = _start(JV, JV.Summarizer(world["scfg"], state=world["js"]), spotter=jspot)
        tport = _start(TV, TV.Summarizer(_port_cfg(world["scfg"]), state=world["ts"], device=CPU), spotter=tspot)
        body = {"video": world["match"], "peak_window": 3}
        assert _post(tport, "/spot", body) == _post(jport, "/spot", body)
        lines = [_stream(p, {**body, "chunk": 8, "halo": 4}) for p in (tport, jport)]
        assert lines[0] == lines[1]
        assert lines[0][-1]["classes"] == classes

    def test_spot_stream_matches_jax(self, world):
        jport, tport, svc = _pair(world)
        body = {"video": world["match"], "chunk": 16, "halo": 8, "peak_window": 3, "emit_scores": True}
        got, want = _stream(tport, body), _stream(jport, body)
        assert len(got) == len(want)
        for g, w_ in zip(got, want):
            assert set(g) == set(w_)
            if "scores" in g:
                np.testing.assert_allclose(g["scores"], w_["scores"], atol=STREAM_ATOL)
            else:
                assert g == w_
        assert got[-1]["streamed_frames"] == 40
        # the streamed scores are the offline banded scores (the scorer's receptive field is finite)
        streamed = np.concatenate([line["scores"] for line in got if "scores" in line])
        offline = svc["spotter"].spot_path(world["match"]).scores
        np.testing.assert_allclose(streamed, offline, atol=STREAM_ATOL)

    def test_spot_stream_follows_a_directory_being_written(self, world, tmp_path):
        jport, tport, _ = _pair(world)
        raw = np.load(world["match"])["frames"]
        lines = {}
        for name, port in (("port", tport), ("jax", jport)):
            d = tmp_path / name / "live"
            d.mkdir(parents=True)

            def writer(d=d):
                for i, part in enumerate(np.split(raw, [500, 900])):
                    time.sleep(0.2)
                    tmp = d / f"{i:05d}.npz.part"
                    with open(tmp, "wb") as f:
                        np.savez(f, frames=part)
                    os.replace(tmp, d / f"{i:05d}.npz")
                (d / "END").touch()

            w = threading.Thread(target=writer)
            w.start()
            try:
                lines[name] = _stream(port, {"video": str(d), "chunk": 8, "halo": 4, "peak_window": 3,
                                             "follow": True, "follow_timeout": 20})
            finally:
                w.join()
        assert lines["port"] == lines["jax"]
        assert lines["port"][-1]["streamed_frames"] == 40

    def test_spot_stream_refusals_are_400_before_any_byte(self, world):
        jport, tport, _ = _pair(world)
        for body in ({"video": world["match"], "chunk": 0}, {"video": world["match"], "follow": True},
                     {"video": world["match"], "halo": -1}):
            (gs, g), (ws, w_) = _post(tport, "/spot-stream", body), _post(jport, "/spot-stream", body)
            assert gs == ws == 400 and set(g) == set(w_) == {"error"}
        assert _post(tport, "/spot-stream", {"video": "nope.npz"})[0] == 404
        assert _post(tport, "/spot-stream", {})[0] == 400

    def test_spot_stream_error_mid_stream_is_a_trailing_line(self, world, monkeypatch):
        _, tport, svc = _pair(world)

        def broken(*a, **kw):
            yield from ()
            raise RuntimeError("kernel launch failed")

        monkeypatch.setattr(svc["spotter"], "spot_stream_path", lambda *a, **kw: broken())
        lines = _stream(tport, {"video": world["match"]})
        assert lines == [{"error": "RuntimeError('kernel launch failed')"}]


class TestReload:
    def test_reload_200_then_500_keeping_the_old_weights(self, world, tmp_path):
        jcfg = world["scfg"]
        ckp = tmp_path / "ckp"
        jax_save_checkpoint(str(ckp), world["js"], jcfg, tag="opt")
        tsum = TV.Summarizer(_port_cfg(jcfg), checkpoint_dir=str(ckp), device=CPU)
        jsum = JV.Summarizer(jcfg, checkpoint_dir=str(ckp))
        tport, jport = _start(TV, tsum), _start(JV, jsum)
        body = {"video": world["videos"][0]}
        before = _post(tport, "/summarize", body)[1]
        new = jax_train_state(jax.random.PRNGKey(99), jcfg)
        jax_save_checkpoint(str(ckp), new, jcfg, tag="opt")
        (gs, g), (ws, w_) = _post(tport, "/reload", {}), _post(jport, "/reload", {})
        assert gs == ws == 200 and g == w_ == {"reloaded": {"summarizer": 1}, "skipped": {}}
        after = _post(tport, "/summarize", body)[1]
        _assert_summarize(after, _post(jport, "/summarize", body)[1])
        assert not np.allclose(after["scores"], before["scores"], atol=1e-3)
        npz = ckp / "opt_state.npz"
        npz.write_bytes(npz.read_bytes()[:200])   # a truncated zip: a corrupt file, not a mismatch
        (gs, g), (ws, w_) = _post(tport, "/reload", {}), _post(jport, "/reload", {})
        assert gs == ws == 500 and set(g) == set(w_) == {"error", "note"}
        assert _post(tport, "/summarize", body)[1] == after
        assert tsum.reload_count == 1

    def test_reload_of_a_mismatched_checkpoint_is_500(self, world, tmp_path):
        ckp = tmp_path / "ckp"
        other = dataclasses.replace(world["scfg"], model=dataclasses.replace(world["scfg"].model, audio_included=False))
        jax_save_checkpoint(str(ckp), jax_train_state(jax.random.PRNGKey(1), other), other, tag="opt")
        tsum = TV.Summarizer(_port_cfg(world["scfg"]), state=world["ts"], device=CPU,
                             reloader=lambda: TV.Summarizer(_port_cfg(world["scfg"]), checkpoint_dir=str(ckp),
                                                            device=CPU).state)
        status, payload = _post(_start(TV, tsum), "/reload", {})
        assert status == 500 and payload["note"] == "previous weights still serving"

    def test_reload_with_nothing_reloadable_is_400(self, world):
        jport, tport, _ = _pair(world)
        (gs, g), (ws, w_) = _post(tport, "/reload", {}), _post(jport, "/reload", {})
        assert gs == ws == 400 and set(g) == set(w_) == {"error", "detail"}
        assert set(g["detail"]) == {"summarizer", "spotter"}
