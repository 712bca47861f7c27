"""The reference's on-disk corpus and its synthetic audio features, without the live reference.

Port of the corpus half of ``cvml_goalnet_tpu/compat/reference_runner.py``:
:func:`build_reference_corpus` materializes a synthetic corpus in the
reference's exact layout (``ydata-tvsum50-v1_1/{data,ground_truth,video}``,
reference ``main.py:39-43``) from the same seeds, so the same files come out
of either package; :func:`synthetic_audio_features` is the deterministic
stand-in for the reference's librosa MFCC frontend, drawn from the same
crc32 key, so its arrays are bit-equal to the JAX package's.

The other half drives the live reference's ``main.py`` in-process; it is
listed in :data:`NOT_PORTED` with its reason.  ``GOALNET_REFERENCE_DIR`` names
the reference's directory, as in the JAX package; without it the port looks in
``reference/`` at the root of this repository, where its files would go.

Finding kept from the JAX module: the reference's ``full_n_frames = count -
1`` (``utils.py:288``) equals the true raw frame count, because ``count``
includes the final failed ``read()``; the port's decoder counts the same.
"""

from __future__ import annotations

import os
import zlib

import numpy as np

REFERENCE_DIR = os.environ.get("GOALNET_REFERENCE_DIR",
                               os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
                                   os.path.abspath(__file__)))), "reference"))

#: the two video ids hard-coded by the reference trainer (``main.py:43``); the corpus uses them so
#: ``train_importance_model`` finds its data.
REFERENCE_VIDEO_IDS = ("37rzWOQsNIw", "RBCABdttQmI")

_LIVE = "imports the reference's main.py, which is in no repository here"
NOT_PORTED = {
    "reference_session": _LIVE,
    "run_reference_training": _LIVE,
    "reference_eval_and_postprocess": _LIVE,
    "run_reference_baseline": _LIVE,
}

__all__ = ["REFERENCE_DIR", "REFERENCE_VIDEO_IDS", "build_reference_corpus", "reference_available",
           "synthetic_audio_features"]


def reference_available() -> bool:
    """Whether ``REFERENCE_DIR`` holds the reference's ``main.py`` and ``utils.py``."""
    return all(os.path.exists(os.path.join(REFERENCE_DIR, f)) for f in ("main.py", "utils.py"))


def _write_mp4(fp: str, frames: np.ndarray) -> int:
    """``frames`` as an mp4v video at 30 fps → the number of frames cv2 decodes back."""
    import cv2

    h, w = frames.shape[1:3]
    out = cv2.VideoWriter(fp, cv2.VideoWriter_fourcc(*"mp4v"), 30, (w, h))
    for f in frames:
        out.write(np.ascontiguousarray(f))
    out.release()
    cap = cv2.VideoCapture(fp)
    count = 0
    while cap.read()[0]:
        count += 1
    cap.release()
    return count


def build_reference_corpus(
    root: str,
    n_frames: tuple[int, ...] = (300, 600),
    n_annotators: int = 20,
    n_clips: tuple[int, ...] = (16, 24),
    seed: int = 42,
) -> dict:
    """Materialize ``<root>/ydata-tvsum50-v1_1/`` in the reference layout → the corpus's paths and counts.

    Real mp4v videos; the anno TSV (``utils.py:370-377`` row schema); a
    MATLAB-v7.3-style ``.mat`` with HDF5 object references
    (``utils.py:525-550``); an eccv16-style ``.h5`` with ``change_points``
    under the ``nframes_mat == nframes_h5 + 1`` rule (``utils.py:615-622``);
    the info TSV for titles (``utils.py:57``); empty ``.wav`` sidecars, so the
    reference's demux (``utils.py:95-96``) is skipped by its own existence
    check; and ``models/``, ``tmp/`` (the reference writes there relative to
    its working directory).  The ground truth is made from the decoded frame
    counts.  Annotations are a slow importance wave plus per-annotator noise,
    so grades span 1..5.  cv2 and h5py are imported here.
    """
    import h5py

    from cvml_goalnet_tpu_torch.data.synthetic import synthetic_change_points, synthetic_video_frames

    video_ids = REFERENCE_VIDEO_IDS[: len(n_frames)]
    vdir = os.path.join(root, "ydata-tvsum50-v1_1")
    for d in ("data", "ground_truth", "video"):
        os.makedirs(os.path.join(vdir, d), exist_ok=True)

    decoded_counts = []
    for vi, (vid, n) in enumerate(zip(video_ids, n_frames)):
        # a per-video seed offset that does not depend on the salted str hash
        frames = synthetic_video_frames(n, seed=seed + 131 * vi)
        decoded_counts.append(_write_mp4(os.path.join(vdir, "video", f"{vid}.mp4"), frames))
        open(os.path.join(vdir, "video", f"{vid}.wav"), "wb").close()

    rng = np.random.default_rng(seed)
    tsv_rows = []
    mat_fp = os.path.join(vdir, "ground_truth", "ydata-tvsum50.mat")
    h5_fp = os.path.join(vdir, "ground_truth", "eccv16_dataset_tvsum_google_pool5.h5")
    with h5py.File(mat_fp, "w") as mat, h5py.File(h5_fp, "w") as h5:
        grp = mat.create_group("tvsum50")
        video_refs, nframe_refs, anno_refs = [], [], []
        for vi, (vid, full_n, k) in enumerate(zip(video_ids, decoded_counts, n_clips)):
            t = np.arange(full_n)
            base = 3.0 + 1.8 * np.sin(2 * np.pi * t / 97.0)
            anno = np.clip(np.round(base[None, :] + rng.normal(0, 0.9, (n_annotators, full_n))), 1, 5
                           ).astype(np.float64)
            tsv_rows.extend([vid, "category", ",".join(str(int(x)) for x in row)] for row in anno)
            chars = np.array([[ord(c)] for c in vid], dtype=np.uint16)
            video_refs.append([mat.create_dataset(f"#refs#/v{vi}", data=chars).ref])
            nframe_refs.append([mat.create_dataset(f"#refs#/n{vi}", data=np.array([[full_n]], np.float64)).ref])
            anno_refs.append([mat.create_dataset(f"#refs#/a{vi}", data=anno).ref])
            cps = synthetic_change_points(full_n - 1, k, seed=seed + vi)
            h5.create_group(f"video_{vi}").create_dataset("change_points", data=cps)
        ref_dtype = h5py.special_dtype(ref=h5py.Reference)
        for name, refs in (("video", video_refs), ("nframes", nframe_refs), ("user_anno", anno_refs)):
            grp.create_dataset(name, data=np.array(refs, dtype=object), dtype=ref_dtype)

    anno_fp = os.path.join(vdir, "data", "ydata-tvsum50-anno.tsv")
    with open(anno_fp, "w") as f:
        f.writelines("\t".join(row) + "\n" for row in tsv_rows)
    info_fp = os.path.join(vdir, "data", "ydata-tvsum50-info.tsv")
    with open(info_fp, "w") as f:
        f.write("video_id\ttitle\n")
        f.writelines(f"{vid}\tTitle {vid}\n" for vid in video_ids)

    os.makedirs(os.path.join(root, "models"), exist_ok=True)
    os.makedirs(os.path.join(root, "tmp"), exist_ok=True)
    return {
        "root": root,
        "video_ids": list(video_ids),
        "video_fps": [os.path.join(vdir, "video", f"{vid}.mp4") for vid in video_ids],
        "annotation_fp": anno_fp,
        "mat_file_path": mat_fp,
        "h5_file_path": h5_fp,
        "info_fp": info_fp,
        "n_frames": decoded_counts,
    }


def synthetic_audio_features(video_id: str, n_frames: int, n_mfcc: int = 30, bin_length: int = 30) -> np.ndarray:
    """Deterministic ``(n_frames, n_mfcc, bin_length)`` float32 features in the reference's layout.

    The stand-in for the reference's librosa frontend (``utils.py:313-349``),
    which its training path only needs to return that shape
    (``utils.py:98-99``).  The port's audio encoder takes
    ``.transpose(0, 2, 1)``.  Drawn from ``crc32(f"{video_id}:{n_frames}:
    {n_mfcc}:{bin_length}")``, as the JAX package draws it.
    """
    seed = zlib.crc32(f"{video_id}:{n_frames}:{n_mfcc}:{bin_length}".encode())
    return np.random.default_rng(seed).standard_normal((n_frames, n_mfcc, bin_length)).astype(np.float32)
