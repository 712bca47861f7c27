"""Deterministic synthetic inputs: frames, waveforms, clip intervals and a TVSum-shaped dataset on disk.

The port's own copies of the generators in ``cvml_goalnet_tpu/data/synthetic.py``
(same seeds give the same arrays and files), so ``chip_smoke.py`` and the
tests can build inputs without importing the JAX package.
:func:`synthetic_dataset_dir` writes ``.npz`` videos, ``.wav`` sidecars and
the TVSum file pair (``.tsv`` annotations, MATLAB-v7.3-style ``.mat`` with
HDF5 object references, eccv16-style ``.h5`` with ``change_points``); it
needs h5py, imported when it is called.
"""

from __future__ import annotations

import os

import numpy as np


def synthetic_video_frames(
    n_frames: int, h: int = 72, w: int = 96, seed: int = 0
) -> np.ndarray:
    """Deterministic moving-gradient frames (n_frames, h, w, 3) uint8."""
    rng = np.random.default_rng(seed)
    t = np.arange(n_frames)[:, None, None, None]
    yy = np.arange(h)[None, :, None, None]
    xx = np.arange(w)[None, None, :, None]
    c = np.arange(3)[None, None, None, :]
    base = 127.5 + 80 * np.sin(0.1 * t + 0.05 * yy + 0.07 * xx + 2.0 * c)
    noise = rng.normal(0, 8, size=(n_frames, h, w, 3))
    return np.clip(base + noise, 0, 255).astype(np.uint8)


def synthetic_waveform(n_samples: int, sr: int = 22050, seed: int = 0) -> np.ndarray:
    """Deterministic chirp+noise mono waveform in [-1, 1]."""
    rng = np.random.default_rng(seed)
    t = np.arange(n_samples) / sr
    y = 0.5 * np.sin(2 * np.pi * (220 + 40 * t) * t) + 0.05 * rng.standard_normal(n_samples)
    return np.clip(y, -1, 1).astype(np.float32)


def synthetic_change_points(full_n_frames: int, n_clips: int, seed: int = 0) -> np.ndarray:
    """(K, 2) contiguous clip intervals covering [0, full_n_frames)."""
    rng = np.random.default_rng(seed)
    cuts = np.sort(rng.choice(np.arange(1, full_n_frames), size=n_clips - 1, replace=False))
    starts = np.concatenate([[0], cuts])
    ends = np.concatenate([cuts, [full_n_frames]])
    return np.stack([starts, ends], axis=1).astype(np.int64)


def synthetic_dataset_dir(
    root: str,
    video_ids: tuple[str, ...] = ("vidA", "vidB"),
    full_n_frames: int = 360,
    n_annotators: int = 20,
    n_clips: int = 8,
    fps_raw: int = 30,
    sr: int = 22050,
    seed: int = 7,
    length_step: int = 30,
    write_audio: bool = True,
) -> dict:
    """Materialize a mini TVSum-shaped dataset on disk.

    Layout mirrors what the ingest layer consumes: ``<id>.npz`` raw frames
    (stand-in for mp4 when no encoder exists), ``<id>.wav`` audio,
    ``anno.tsv`` (20 annotators × frames, reference TSV schema), ``gt.mat``
    (HDF5 with ``tvsum50/{video,nframes,user_anno}`` object refs) and
    ``gt.h5`` (``<key>/change_points``) honoring the reference's
    ``nframes_mat == nframes_h5 + 1`` mapping rule (``utils.py:615-622``).
    """
    import h5py

    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    meta: dict = {"video_fps": [], "annotation_fp": os.path.join(root, "anno.tsv")}

    tsv_rows = []
    with h5py.File(os.path.join(root, "gt.mat"), "w") as mat, h5py.File(
        os.path.join(root, "gt.h5"), "w"
    ) as h5:
        grp = mat.create_group("tvsum50")
        video_refs, nframe_refs, anno_refs = [], [], []
        for vi, vid in enumerate(video_ids):
            # distinct raw lengths → unique mat↔h5 id mapping; length_step=1
            # keeps the CONDENSED length nearly constant for wide corpora
            # (fewer distinct shapes when 50 videos train in one suite run)
            n = full_n_frames + vi * length_step
            frames = synthetic_video_frames(n, seed=seed + vi)
            np.savez_compressed(os.path.join(root, f"{vid}.npz"), frames=frames)
            if write_audio:
                from cvml_goalnet_tpu_torch.data.audio_io import write_wav

                wav = synthetic_waveform(int(n / fps_raw * sr), sr, seed=seed + vi)
                write_wav(os.path.join(root, f"{vid}.wav"), wav, sr)
            meta["video_fps"].append(os.path.join(root, f"{vid}.npz"))

            # Annotations: 1..5 grades, (n_annotators, n).
            anno = rng.integers(1, 6, size=(n_annotators, n)).astype(np.float64)
            for a in range(n_annotators):
                tsv_rows.append(
                    [vid, "category", ",".join(str(int(x)) for x in anno[a])]
                )

            # .mat entries (HDF5 object references, MATLAB-char style).
            chars = np.array([[ord(c)] for c in vid], dtype=np.uint16)
            dv = mat.create_dataset(f"#refs#/v{vi}", data=chars)
            dn = mat.create_dataset(f"#refs#/n{vi}", data=np.array([[n]], dtype=np.float64))
            da = mat.create_dataset(f"#refs#/a{vi}", data=anno)
            video_refs.append([dv.ref])
            nframe_refs.append([dn.ref])
            anno_refs.append([da.ref])

            # .h5 change points: last end == n - 1 (mat nframes = h5 total + 1).
            cps = synthetic_change_points(n - 1, n_clips, seed=seed + vi)
            h5.create_group(f"video_{vi}").create_dataset("change_points", data=cps)

        ref_dtype = h5py.special_dtype(ref=h5py.Reference)
        grp.create_dataset("video", data=np.array(video_refs, dtype=object), dtype=ref_dtype)
        grp.create_dataset("nframes", data=np.array(nframe_refs, dtype=object), dtype=ref_dtype)
        grp.create_dataset("user_anno", data=np.array(anno_refs, dtype=object), dtype=ref_dtype)

    with open(meta["annotation_fp"], "w") as f:
        for row in tsv_rows:
            f.write("\t".join(row) + "\n")

    # Info TSV for title lookup (reference dataloader.get_titles, utils.py:55-66).
    info_fp = os.path.join(root, "info.tsv")
    with open(info_fp, "w") as f:
        f.write("video_id\ttitle\n")
        for vid in video_ids:
            f.write(f"{vid}\tTitle of {vid}\n")

    meta.update(
        mat_file_path=os.path.join(root, "gt.mat"),
        h5_file_path=os.path.join(root, "gt.h5"),
        info_fp=info_fp,
        video_ids=list(video_ids),
        sr=sr,
        fps_raw=fps_raw,
    )
    return meta
