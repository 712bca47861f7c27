"""PyTorch port: the reference corpus (``compat/reference_runner.py``) against the JAX package's, on the CPU.

Both packages build the corpus into their own directory from the same seeds, at the default (300, 600)
raw frames and at (330, 270) (11 and 9 condensed frames: short final sub-batches).  Then:

* the anno and info TSVs are byte-equal;
* every ``.mat`` and ``.h5`` dataset is equal, with the ``.mat``'s object references resolved;
* the mp4 videos decode to equal frames, frame for frame, and the ``.wav`` sidecars are empty;
* the returned dicts agree, paths taken relative to their roots;
* ``synthetic_audio_features`` is bit-equal to JAX's for both video ids at a few shapes;
* the port's ``data/annotations.py`` and ``data/dataset.py`` read the port's corpus as JAX's read JAX's:
  equal condensed frames, titles, clip intervals, labels, per-annotator ground-truth masks and lengths,
  preprocessed frames within 1e-6 (the two resizes sum in another order), and the reference's
  ``NOT_PORTED`` names with their reason.
"""

from __future__ import annotations

import importlib.util
import os
import subprocess
import sys

import h5py
import numpy as np
import pytest

from cvml_goalnet_tpu.compat import reference_runner as JR
import cvml_goalnet_tpu.data.annotations as JA
import cvml_goalnet_tpu.data.dataset as JD
import cvml_goalnet_tpu.data.video as JV
from cvml_goalnet_tpu_torch.compat import reference_runner as TR
from cvml_goalnet_tpu_torch.config import PipelineConfig
import cvml_goalnet_tpu_torch.data.annotations as TA
import cvml_goalnet_tpu_torch.data.dataset as TD
import cvml_goalnet_tpu_torch.data.video as TV

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAME_COUNTS = [(300, 600), (330, 270)]


@pytest.fixture(scope="module", params=FRAME_COUNTS, ids=["default", "short_subbatches"])
def corpora(request, tmp_path_factory):
    """(JAX's corpus, the port's corpus) built from the same seeds into two directories."""
    n_frames = request.param
    jroot, troot = tmp_path_factory.mktemp("jax_corpus"), tmp_path_factory.mktemp("port_corpus")
    return JR.build_reference_corpus(str(jroot), n_frames=n_frames), TR.build_reference_corpus(str(troot),
                                                                                           n_frames=n_frames)


def _relative(corpus: dict) -> dict:
    root = corpus["root"]
    rel = lambda p: os.path.relpath(p, root)   # noqa: E731
    out = {k: (rel(v) if isinstance(v, str) and k != "root" else v) for k, v in corpus.items()}
    out["video_fps"] = [rel(p) for p in corpus["video_fps"]]
    del out["root"]
    return out


def test_returned_dicts_agree(corpora):
    j, t = corpora
    assert set(t) == set(j)
    assert _relative(t) == _relative(j)
    assert t["video_ids"] == list(TR.REFERENCE_VIDEO_IDS[: len(t["video_ids"])])


def test_layout_and_sidecars(corpora):
    j, t = corpora
    walk = lambda root: sorted(os.path.relpath(os.path.join(d, f), root)   # noqa: E731
                               for d, _, fs in os.walk(root) for f in fs) + sorted(
        os.path.relpath(d, root) for d, _, _ in os.walk(root))
    assert walk(t["root"]) == walk(j["root"])
    for fp in t["video_fps"]:
        assert os.path.getsize(fp.rsplit(".", 1)[0] + ".wav") == 0
    assert os.path.isdir(os.path.join(t["root"], "models")) and os.path.isdir(os.path.join(t["root"], "tmp"))


@pytest.mark.parametrize("key", ["annotation_fp", "info_fp"])
def test_tsvs_are_byte_equal(corpora, key):
    j, t = corpora
    with open(j[key], "rb") as a, open(t[key], "rb") as b:
        assert b.read() == a.read()


def _h5_contents(path: str) -> dict:
    """{dataset name: value} over every dataset of an HDF5 file, object references resolved to the name and
    value of what they point at."""
    out = {}
    with h5py.File(path, "r") as f:
        def visit(name, obj):
            if not isinstance(obj, h5py.Dataset):
                return
            data = obj[()]
            if obj.dtype == h5py.special_dtype(ref=h5py.Reference):
                data = [[(f[r].name, f[r][()].tolist()) for r in row] for row in data]
            else:
                data = (str(data.dtype), data.shape, data.tolist())
            out[name] = data
        f.visititems(visit)
    return out


@pytest.mark.parametrize("key", ["mat_file_path", "h5_file_path"])
def test_mat_and_h5_datasets_are_equal(corpora, key):
    j, t = corpora
    got, want = _h5_contents(t[key]), _h5_contents(j[key])
    assert sorted(got) == sorted(want) and got
    for name in want:
        assert got[name] == want[name], name


def test_videos_decode_equal(corpora):
    j, t = corpora
    for jfp, tfp, n in zip(j["video_fps"], t["video_fps"], t["n_frames"]):
        got, want = TV.decode_all_frames(tfp), JV.decode_all_frames(jfp)
        assert got.shape == want.shape and len(got) == n
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_frames,n_mfcc,bin_length", [(10, 30, 30), (20, 30, 30), (9, 13, 12), (1, 40, 7)])
@pytest.mark.parametrize("video_id", JR.REFERENCE_VIDEO_IDS)
def test_synthetic_audio_features_are_bit_equal(video_id, n_frames, n_mfcc, bin_length):
    got = TR.synthetic_audio_features(video_id, n_frames, n_mfcc, bin_length)
    want = JR.synthetic_audio_features(video_id, n_frames, n_mfcc, bin_length)
    assert got.dtype == want.dtype == np.float32 and got.shape == (n_frames, n_mfcc, bin_length)
    assert got.tobytes() == want.tobytes()


def test_annotation_store_reads_as_jax(corpora):
    j, t = corpora
    jstore = JA.AnnotationStore(j["mat_file_path"], j["h5_file_path"])
    tstore = TA.AnnotationStore(t["mat_file_path"], t["h5_file_path"])
    for vid in t["video_ids"]:
        np.testing.assert_array_equal(tstore.user_annotations(vid), jstore.user_annotations(vid))
        np.testing.assert_array_equal(np.asarray(tstore.change_points(vid)), np.asarray(jstore.change_points(vid)))
        assert tstore.mat_nframes(vid) == jstore.mat_nframes(vid)
        got, _ = TA.load_tvsum_annotations(t["annotation_fp"], vid, 30)
        want, _ = JA.load_tvsum_annotations(j["annotation_fp"], vid, 30)
        np.testing.assert_array_equal(got, want)


def test_condensed_frames_decode_as_jax(corpora):
    j, t = corpora
    for jfp, tfp in zip(j["video_fps"], t["video_fps"]):
        got, got_n = TV.decode_condensed_frames(tfp, 30)
        want, want_n = JV.decode_condensed_frames(jfp, 30)
        assert got_n == want_n
        np.testing.assert_array_equal(got, want)


def test_datasets_read_as_jax(corpora, small_cfg):
    """The port's ``build_datasets`` over its corpus against JAX's over JAX's (no audio: the sidecars are
    empty, as the reference's A/B reads them)."""
    j, t = corpora
    cfg = PipelineConfig.from_json(small_cfg.to_json())
    files = lambda c: dict(annotation_fp=c["annotation_fp"], mat_file_path=c["mat_file_path"],   # noqa: E731
                           h5_file_path=c["h5_file_path"], info_fp=c["info_fp"], audio_included=False)
    jtrain, jval = JD.build_datasets(j["video_fps"], small_cfg, **files(j))
    ttrain, tval = TD.build_datasets(t["video_fps"], cfg, **files(t), device="cpu")
    assert (len(ttrain), len(tval)) == (len(jtrain), len(jval))
    for ti, ji in zip([*ttrain, *tval], [*jtrain, *jval]):
        assert (ti.video_id, ti.title, ti.full_n_frames) == (ji.video_id, ji.title, ji.full_n_frames)
        assert ti.title == f"Title {ti.video_id}" and ti.audio is None and ji.audio is None
        np.testing.assert_array_equal(ti.clip_intervals, np.asarray(ji.clip_intervals))
        np.testing.assert_array_equal(ti.labels, np.asarray(ji.labels))
        np.testing.assert_array_equal(ti.gd_summary_masks, np.asarray(ji.gd_summary_masks))
        np.testing.assert_allclose(ti.visual.numpy(), np.asarray(ji.visual), rtol=0, atol=1e-6)


def test_not_ported_names_the_live_functions():
    assert set(TR.NOT_PORTED) == {"reference_session", "run_reference_training", "reference_eval_and_postprocess",
                                  "run_reference_baseline"}
    assert all(callable(getattr(JR, name)) for name in TR.NOT_PORTED)
    assert all("main.py" in why and "no repository" in why for why in TR.NOT_PORTED.values())
    assert not any(hasattr(TR, name) for name in TR.NOT_PORTED)


def _fresh_copy(module):
    """A new module object run from ``module``'s file (it reads the environment anew); ``sys.modules`` is
    left as it was."""
    spec = importlib.util.spec_from_file_location(f"_fresh_{module.__name__}", module.__file__)
    copy = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(copy)
    return copy


def test_reference_dir_and_availability(monkeypatch, tmp_path):
    """``GOALNET_REFERENCE_DIR`` names the directory in both packages; the port's default is ``reference/`` at
    the root of the repository."""
    monkeypatch.setenv("GOALNET_REFERENCE_DIR", str(tmp_path / "ref"))
    assert [_fresh_copy(m).REFERENCE_DIR for m in (JR, TR)] == [str(tmp_path / "ref")] * 2
    monkeypatch.undo()
    if "GOALNET_REFERENCE_DIR" not in os.environ:
        assert TR.REFERENCE_DIR == os.path.join(REPO, "reference")
    monkeypatch.setattr(TR, "REFERENCE_DIR", str(tmp_path))
    assert not TR.reference_available()
    (tmp_path / "main.py").write_text("")
    assert not TR.reference_available()
    (tmp_path / "utils.py").write_text("")
    assert TR.reference_available()


def test_compat_exports_and_imports_no_jax():
    code = ("import sys; import cvml_goalnet_tpu_torch.compat as C; "
            "assert {'build_reference_corpus', 'synthetic_audio_features', 'reference_available', 'REFERENCE_DIR', "
            "'REFERENCE_VIDEO_IDS'} <= set(C.__all__); "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'cvml_goalnet_tpu.'))"
            " or m == 'cvml_goalnet_tpu']; assert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
