"""Annotation and ground-truth ingest: TVSum TSV, MATLAB v7.3 ``.mat``, eccv16 ``.h5``.

Port of ``cvml_goalnet_tpu/data/annotations.py`` (reference
``get_annotations``, ``utils.py:370-394``; ``load_mat_file``,
``utils.py:525-550``; ``get_video_data_from_h5`` / ``get_video_data_from_mat``
and the mat↔h5 id mapping, ``utils.py:424-443, 615-622``; ``decode_titles`` /
``get_frame_numbers``, ``utils.py:362-368, 412-422``).  Host only.

The reference re-opened and re-parsed both files on every ``postprocess``
call; :class:`AnnotationStore` parses each file once and serves cached
lookups.  h5py is imported only when a ``.mat`` or ``.h5`` file is read.
"""

from __future__ import annotations

import csv
from functools import cached_property

import numpy as np


def load_tvsum_annotations(
    annotation_fp: str, video_id: str, skip_frames: int
) -> tuple[np.ndarray, np.ndarray]:
    """Mean-of-annotators importance labels (trimmed, full) for one video.

    Matches reference ``get_annotations`` (``utils.py:370-394``): read the
    20 annotator rows for ``video_id`` from the TSV, average per frame, keep
    every ``skip_frames``-th frame for the trimmed vector, round both.
    """
    rows = []
    with open(annotation_fp) as f:
        for row in csv.reader(f, delimiter="\t"):
            if row and row[0] == video_id:   # tolerate blank/short lines
                rows.append(row[2].strip().split(","))
    if not rows:
        # a clear lookup error, not numpy's "axis 1 is out of bounds"
        raise KeyError(
            f"video id {video_id!r} has no annotator rows in {annotation_fp!r}"
        )
    ann = np.array(rows, dtype=np.float32).T          # (frames, annotators)
    mean_full = ann.mean(axis=1)
    mean_trimmed = mean_full[::skip_frames]
    return np.round(mean_trimmed), np.round(mean_full)


def _decode_h5_strings(refs, h5file) -> list[str]:
    """Dereference MATLAB HDF5 object refs to strings (``utils.py:412-422``)."""
    out = []
    for ref_array in refs:
        for ref in ref_array:
            data = h5file[ref]
            out.append("".join(chr(c[0]) for c in data))
    return out


def _decode_h5_ints(refs, h5file) -> list[int]:
    out = []
    for ref_array in refs:
        for ref in ref_array:
            data = h5file[ref]
            out.extend(int(c[0]) for c in data)
    return out


class AnnotationStore:
    """One-shot cached view over the TVSum ground-truth file pair.

    Construction is lazy; each underlying file is parsed at most once.
    Serves every lookup the reference's postprocess/eval path needs:
    per-annotator summaries (``user_anno``), change-point clip intervals,
    and the mat↔h5 video-id correspondence (matched by
    ``nframes_mat == nframes_h5 + 1`` exactly as ``utils.py:615-622``).
    """

    def __init__(self, mat_file_path: str | None = None, h5_file_path: str | None = None):
        self.mat_file_path = mat_file_path
        self.h5_file_path = h5_file_path

    # ------------------------------------------------------------------ .mat

    @cached_property
    def _mat_data(self) -> dict:
        import h5py

        videos: list[str] = []
        nframes: list[int] = []
        annos: list[np.ndarray] = []
        with h5py.File(self.mat_file_path, "r") as f:
            root = f["tvsum50"]
            videos = _decode_h5_strings(root["video"][:], f)
            nframes = _decode_h5_ints(root["nframes"][:], f)
            for ref in root["user_anno"][:]:
                annos.append(np.array(f[ref[0]]))
        return {"videos": videos, "nframes": nframes, "annos": annos}

    def _mat_index(self, video_id: str) -> int:
        # Reference match rule: decoded title contained in the id, lowercase
        # (utils.py:540).
        for i, name in enumerate(self._mat_data["videos"]):
            if name.lower() in video_id.lower():
                return i
        raise KeyError(video_id)

    def user_annotations(self, video_id: str) -> np.ndarray:
        """(n_annotators, n_frames) per-annotator importances (``utils.py:525-550``)."""
        return self._mat_data["annos"][self._mat_index(video_id)]

    def mat_nframes(self, video_id: str) -> int:
        return self._mat_data["nframes"][self._mat_index(video_id)]

    # ------------------------------------------------------------------- .h5

    @cached_property
    def _h5_data(self) -> dict:
        import h5py

        change_points: dict[str, np.ndarray] = {}
        totals: dict[str, int] = {}
        with h5py.File(self.h5_file_path, "r") as f:
            for vid in f.keys():
                cps = np.array(f[vid]["change_points"][:])
                change_points[vid] = cps
                totals[vid] = int(cps[-1][1])
        return {"change_points": change_points, "totals": totals}

    @cached_property
    def _mat_to_h5(self) -> dict[str, str]:
        """mat-id → h5-key map via nframes equality with +1 offset (``utils.py:615-622``).

        First match wins (the reference's loop order) — continuing the scan
        would let a LATER h5 video with the same frame total silently
        overwrite the mapping and serve another video's change points."""
        out = {}
        for name, n in zip(self._mat_data["videos"], self._mat_data["nframes"]):
            for h5_id, total in self._h5_data["totals"].items():
                if n == total + 1:
                    out[name] = h5_id
                    break
        return out

    def change_points(self, video_id: str) -> np.ndarray:
        """(K, 2) clip intervals for a mat-style video id (``utils.py:624-625``)."""
        mat_name = self._mat_data["videos"][self._mat_index(video_id)]
        return self._h5_data["change_points"][self._mat_to_h5[mat_name]]
