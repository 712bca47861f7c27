"""Live segment-directory ingest: follow footage that is still being written.

Port of ``cvml_goalnet_tpu/data/follow.py``.  A producer drops finalized
segment files into one directory and the consumer scores them while later
segments are still being written.

Producer contract (the HLS/DASH shape, down-scoped):

* segments are files in ONE directory with lexicographically increasing
  names (``00001.npz``, ``00002.npz``, …): ``.npz`` frame archives (key
  ``frames``) or any container the decoders read (``.mp4`` via cv2);
* a segment is finalized before its final name appears: write
  ``<name>.part`` (ignored), then rename — atomic on POSIX, so the consumer
  never sees a half-written segment;
* an optional audio sidecar ``<stem>.wav`` carries exactly the segment's
  waveform span, written BEFORE the segment's rename (the rename publishes
  the pair);
* an empty sentinel file (default ``END``) marks the end of the stream.

Decimation is GLOBAL: the condensed-frame phase (``raw_index % skip_frames
== 0``) carries across segment boundaries, so the condensed timeline equals
decimating the concatenated footage.  Audio features are SEGMENT-LOCAL: each
segment's waveform is slotted over that segment's condensed frames.

One difference from the JAX module: :func:`export_selected_clips_from_segments`
over ``.npz`` segments gathers the selected frames and writes them with
``data.video.export_video``, as ``export_selected_clips_stream`` does for an
``.npz`` file, so a host without cv2 writes them as that function can;
segments in real containers stream through a cv2 writer, as in JAX.  And
``follow_segments`` on a path that is not a directory raises
``NotADirectoryError`` with a message saying so.
"""

from __future__ import annotations

import os
import time
from collections.abc import Iterator

import numpy as np
import torch

from cvml_goalnet_tpu_torch.config import AudioConfig

#: extensions that are never segments (sidecars / scratch)
_SIDECAR_EXT = (".wav", ".part", ".json", ".tmp")


def follow_segments(
    directory: str,
    *,
    poll_interval: float = 0.25,
    timeout: float = 60.0,
    end_sentinel: str = "END",
) -> Iterator[str]:
    """Yield finalized segment paths from a LIVE directory, in name order.

    Polls ``directory`` every ``poll_interval`` seconds; a file is a segment
    unless it is the sentinel, hidden, or has a sidecar/scratch extension
    (``.wav``/``.part``/``.json``/``.tmp``).  Ends (StopIteration) once the
    sentinel exists AND every segment named before the final poll has been
    yielded.  Raises ``TimeoutError`` after ``timeout`` seconds with no new
    segment and no sentinel — a stalled producer must be loud, not an
    eternal silent poll.

    Producers must use monotonically increasing names: a segment that
    appears with a name sorting BEFORE one already yielded is a contract
    violation and raises ``RuntimeError`` (yielding it would reorder the
    timeline; ignoring it would silently drop footage).
    """
    seen: set[str] = set()
    last = ""  # lexicographic high-water mark
    waited = 0.0
    while True:
        try:
            names = sorted(os.listdir(directory))
        except FileNotFoundError:
            raise FileNotFoundError(
                f"follow_segments: {directory!r} does not exist — create the "
                "segment directory before starting the consumer") from None
        except NotADirectoryError:
            raise NotADirectoryError(
                f"follow_segments: {directory!r} is a file, not a segment "
                "directory — stream a file without --follow") from None
        ended = end_sentinel in names
        fresh = [
            n for n in names
            if n not in seen
            and n != end_sentinel
            and not n.startswith(".")
            and not n.endswith(_SIDECAR_EXT)
        ]
        stale = [n for n in fresh if n < last]
        if stale:
            raise RuntimeError(
                f"follow_segments: segment(s) {stale} appeared AFTER "
                f"{last!r} but sort before it — producers must write "
                "monotonically increasing names (the consumer has already "
                "emitted that part of the timeline)")
        if fresh:
            waited = 0.0
            for n in fresh:
                seen.add(n)
                last = n
                yield os.path.join(directory, n)
        elif ended:
            return
        else:
            if waited >= timeout:
                raise TimeoutError(
                    f"follow_segments: no new segment in {directory!r} for "
                    f"{timeout:.0f}s and no {end_sentinel!r} sentinel — "
                    "producer stalled or forgot to finalize the stream")
            time.sleep(poll_interval)
            waited += poll_interval


def _segment_raw_frames(path: str) -> np.ndarray:
    """All raw frames of ONE finalized segment → (m, H, W, C) uint8."""
    if path.endswith(".npz"):
        return np.load(path)["frames"]
    from cvml_goalnet_tpu_torch.data.video import _open_cv2

    cap = _open_cv2(path)
    if cap is None:
        raise RuntimeError(f"no decoder available for segment {path!r}")
    frames = []
    while True:
        ok, img = cap.read()
        if not ok:
            break
        frames.append(img)
    cap.release()
    if not frames:
        raise RuntimeError(f"segment {path!r} decoded to zero frames")
    return np.stack(frames)


def follow_condensed_chunks(
    directory: str,
    skip_frames: int,
    chunk: int = 256,
    *,
    audio_cfg: "AudioConfig | None" = None,
    poll_interval: float = 0.25,
    timeout: float = 60.0,
    end_sentinel: str = "END",
    counter: "dict | None" = None,
) -> Iterator[tuple[np.ndarray, "np.ndarray | None"]]:
    """Follow a live segment directory → aligned ``(frames, audio)`` chunks.

    ``frames``: (k ≤ chunk, H, W, C) uint8 condensed frames with GLOBAL
    decimation phase (identical to decimating the concatenated footage).
    ``audio``: (k, bin_length, n_mfcc) features from each segment's ``.wav``
    sidecar when ``audio_cfg`` is given, else ``None`` — rows stay in
    lockstep with ``frames`` across every segment/chunk boundary, the
    alignment :func:`spotting.spot_stream` requires of ``audio_chunks``.

    With ``audio_cfg`` set, a segment without its ``<stem>.wav`` sidecar
    raises ``ValueError`` (an audio trunk scoring silence where the producer
    dropped a sidecar would silently mis-score — the same loud contract as
    ``spot_stream`` itself).

    ``counter``: on exhaustion, ``counter["full_n"]`` holds the true raw
    frame count (knapsack capacity — same convention as
    ``stream_condensed_frames``).
    """
    from cvml_goalnet_tpu_torch.data.audio_io import load_waveform

    want_audio = audio_cfg is not None
    fbuf: list[np.ndarray] = []   # pending condensed frames
    abuf: list[np.ndarray] = []   # pending audio feature rows (lockstep)
    raw_count = 0                 # global raw-frame counter (decimation phase)

    def drain(final: bool):
        while fbuf and (len(fbuf) >= chunk or final):
            k = min(chunk, len(fbuf))
            frames = np.stack(fbuf[:k])
            del fbuf[:k]
            audio = None
            if want_audio:
                audio = np.stack(abuf[:k])
                del abuf[:k]
            yield frames, audio

    for seg in follow_segments(
        directory, poll_interval=poll_interval, timeout=timeout,
        end_sentinel=end_sentinel,
    ):
        raw = _segment_raw_frames(seg)
        first = (-raw_count) % skip_frames
        condensed = raw[first::skip_frames]
        raw_count += len(raw)
        if len(condensed) == 0:
            continue
        if want_audio:
            wav_fp = seg.rsplit(".", 1)[0] + ".wav"
            if not os.path.exists(wav_fp):
                raise ValueError(
                    f"audio trunk but segment {seg!r} has no {wav_fp!r} "
                    "sidecar — live AV streaming needs every segment to "
                    "ship its waveform span (or stream with a --no-audio "
                    "trunk)")
            from cvml_goalnet_tpu_torch.ops.audio import extract_audio_features

            y, _ = load_waveform(wav_fp, target_sr=audio_cfg.sample_rate)
            # host rows, like the frames: the consumer uploads each chunk
            feats = extract_audio_features(y, len(condensed), audio_cfg, torch.device("cpu")).numpy()
            abuf.extend(feats)
        fbuf.extend(condensed)
        yield from drain(final=False)
    yield from drain(final=True)
    if counter is not None:
        counter["full_n"] = raw_count


def stream_condensed_frames_follow(
    directory: str,
    skip_frames: int,
    chunk: int = 256,
    *,
    counter: "dict | None" = None,
    poll_interval: float = 0.25,
    timeout: float = 60.0,
    end_sentinel: str = "END",
) -> Iterator[np.ndarray]:
    """Frames-only follow iterator with the exact
    ``data.video.stream_condensed_frames`` contract (chunk shapes +
    ``counter["full_n"]`` on exhaustion) — what ``infer --stream --follow``
    plugs into the existing streaming-summarize pipeline."""
    for frames, _ in follow_condensed_chunks(
        directory, skip_frames, chunk, counter=counter,
        poll_interval=poll_interval, timeout=timeout,
        end_sentinel=end_sentinel,
    ):
        yield frames


def list_segments(directory: str, end_sentinel: str = "END") -> list[str]:
    """The finalized segments of a COMPLETE stream, in timeline order.

    For post-stream passes (summary export) — requires the end sentinel
    (without it the directory may still be growing and a 'complete' walk
    would silently truncate the timeline)."""
    names = sorted(os.listdir(directory))
    if end_sentinel not in names:
        raise ValueError(
            f"{directory!r} has no {end_sentinel!r} sentinel — the stream "
            "has not ended; a complete-timeline pass over a still-growing "
            "directory would silently truncate it")
    return [
        os.path.join(directory, n) for n in names
        if n != end_sentinel and not n.startswith(".")
        and not n.endswith(_SIDECAR_EXT)
    ]


def _selected_raw_frames(segments: list[str], iv: list[tuple[int, int]]) -> Iterator[np.ndarray]:
    """The raw frames inside the ascending, disjoint ``[a, b)`` intervals ``iv``, walking ``segments`` in
    order with GLOBAL raw indices; stops at the last interval's end."""
    i, k = 0, 0
    for seg in segments:
        if k >= len(iv):
            return
        for img in _segment_raw_frames(seg):
            if k >= len(iv):
                return
            a, b = iv[k]
            if a <= i < b:
                yield img
            i += 1
            if i >= b:
                k += 1


def export_selected_clips_from_segments(
    directory: str, clip_intervals, output_path: str, fps: int = 30,
    end_sentinel: str = "END",
) -> int:
    """Directory twin of ``data.video.export_selected_clips_stream``: walk
    the finalized segments in timeline order with GLOBAL raw indices and
    write only the frames inside the chosen ``[a, b)`` raw intervals →
    frames written.

    ``.npz`` segments: the selected frames are gathered and written by
    ``data.video.export_video`` (cv2, else imageio), as an ``.npz`` file is
    by ``export_selected_clips_stream``.  Real containers: a cv2 writer, and
    memory stays bounded by one segment."""
    from cvml_goalnet_tpu_torch.data import video

    iv = [(int(a), int(b)) for a, b in np.asarray(clip_intervals)]
    if any(b0 > a1 for (_, b0), (a1, _) in zip(iv, iv[1:])):
        raise ValueError("clip_intervals must be ascending and disjoint")
    segments = list_segments(directory, end_sentinel)
    if all(seg.endswith(".npz") for seg in segments):
        chosen = list(_selected_raw_frames(segments, iv))
        if chosen:
            video.export_video(np.stack(chosen), output_path, fps=fps)
        return len(chosen)
    import cv2

    writer = None
    written = 0
    try:
        for img in _selected_raw_frames(segments, iv):
            if writer is None:
                h, w = img.shape[:2]
                writer = cv2.VideoWriter(output_path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
            writer.write(np.ascontiguousarray(img))
            written += 1
    finally:
        if writer is not None:
            writer.release()
    return written
