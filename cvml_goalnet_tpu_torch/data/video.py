"""Host video decode and decimation, feeding the device preprocess.

Port of ``cvml_goalnet_tpu/data/video.py`` (reference
``extract_condensed_frame_tensor`` / ``get_frame_tensor``, ``utils.py:274-305``):
decode a video, keep every ``skip_frames``-th frame, count the raw frames.
Host only: nothing here touches torch.

* Decode gives RAW uint8 frames; the per-frame min-max normalise and resize
  run on the device (``ops/preprocess.py``, kernel 1 on the card).
* ``full_n_frames`` is the true raw frame count, which the reference also
  reports (its ``count - 1``, ``utils.py:288``, cancels the failed final
  read its loop counts); ``reference_off_by_one=True`` (count − 1) is kept
  for parity with the JAX package only.
* Decoders are cv2 or imageio, whichever the host has; ``.npz`` frame
  archives (key ``frames``) stand in for videos where a loader says so.
  Frames can be streamed in chunks, and decoded by several threads that
  each seek to their own segment.
* :func:`export_video` writes an mp4 with cv2, else imageio, and raises
  ``ImportError`` on a host with neither.

cv2 decodes BGR, the channel order of the reference's training data
(``PreprocessConfig.channel_order``); the imageio path flips RGB to BGR.
"""

from __future__ import annotations

import os
from collections.abc import Iterator

import numpy as np


def _open_cv2(path: str):
    try:
        import cv2
    except ImportError:
        return None
    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        cap.release()
        return None
    return cap


def decode_condensed_frames(
    path: str,
    skip_frames: int,
    reference_off_by_one: bool = False,
) -> tuple[np.ndarray, int]:
    """Decode and decimate → ((N, H, W, C) uint8 frames, full_n_frames)."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    cap = _open_cv2(path)
    frames = []
    count = 0
    if cap is not None:
        while True:
            ok, img = cap.read()
            if not ok:
                break
            if count % skip_frames == 0:
                frames.append(img)
            count += 1
        cap.release()
    else:  # imageio fallback (no cv2 on host)
        import imageio.v3 as iio

        count = -1
        for count, img in enumerate(iio.imiter(path), start=0):
            if count % skip_frames == 0:
                frames.append(img[..., ::-1])  # RGB → BGR for parity
        count += 1
    if not frames:
        raise RuntimeError(f"no frames decoded from {path!r} (unreadable or empty video)")
    full_n = count - 1 if reference_off_by_one else count
    return np.stack(frames), full_n


def decode_all_frames(path: str, drop_last: bool = False) -> np.ndarray:
    """All raw frames (reference ``get_frame_tensor``, ``utils.py:294-305``).

    The reference appends the final failed read then slices it off AND loses
    the true last frame; ``drop_last=True`` reproduces that accounting.
    """
    frames, _ = decode_condensed_frames(path, skip_frames=1)
    return frames[:-1] if drop_last else frames


def stream_condensed_frames(
    path: str, skip_frames: int, chunk: int = 256,
    counter: "dict | None" = None,
) -> Iterator[np.ndarray]:
    """Yield decimated frames in chunks for double-buffered host→device feed.

    ``.npz`` frame archives are accepted alongside real videos (the same
    convention as the one-shot loaders), sliced into the same chunk shapes
    a real decoder would produce.

    ``counter``: optional dict — on exhaustion ``counter["full_n"]`` holds
    the TRUE raw frame count (what the one-shot loaders return as
    ``full_n_frames``), so streaming consumers get the knapsack capacity
    without trusting container metadata (which can lie in both directions —
    see the parallel decoders' reconciliation notes).
    """
    if path.endswith(".npz"):
        all_frames = np.load(path)["frames"]
        if counter is not None:
            counter["full_n"] = len(all_frames)
        frames = all_frames[::skip_frames]
        for i in range(0, len(frames), chunk):
            yield frames[i:i + chunk]
        return
    cap = _open_cv2(path)
    if cap is None:
        raise RuntimeError(f"no decoder available for {path}")
    buf: list[np.ndarray] = []
    count = 0
    while True:
        ok, img = cap.read()
        if not ok:
            break
        if count % skip_frames == 0:
            buf.append(img)
            if len(buf) == chunk:
                yield np.stack(buf)
                buf = []
        count += 1
    cap.release()
    if counter is not None:
        counter["full_n"] = count
    if buf:
        yield np.stack(buf)


def decode_condensed_frames_parallel(
    path: str,
    skip_frames: int,
    workers: int = 4,
) -> tuple[np.ndarray, int]:
    """Segment-parallel decode: N threads, each seeking to its own segment.

    A single-threaded decode loop can hold back the whole pipeline; cv2
    releases the GIL inside ``read()``, so decoding disjoint segments in
    threads scales with cores ("decode sharding", SURVEY.md §7.3).  Each
    worker opens its own capture, seeks to its segment start and decodes its
    range; global decimation indices are preserved so the output is
    bit-identical to :func:`decode_condensed_frames`.

    Falls back to sequential decode when seeking is unreliable (frame count
    unknown) or ``workers <= 1``.
    """
    import threading

    cap = _open_cv2(path)
    if cap is None or workers <= 1:
        if cap is not None:
            cap.release()
        return decode_condensed_frames(path, skip_frames)
    import cv2

    total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    cap.release()
    if total <= 0:
        return decode_condensed_frames(path, skip_frames)

    bounds = np.linspace(0, total, workers + 1).astype(int)
    results: list[list[np.ndarray] | None] = [None] * workers
    decoded: list[int] = [0] * workers
    errors: list[BaseException] = []

    def worker(w: int):
        try:
            c = _open_cv2(path)
            start, end = int(bounds[w]), int(bounds[w + 1])
            c.set(cv2.CAP_PROP_POS_FRAMES, start)
            kept = []
            got = 0
            for idx in range(start, end):
                ok, img = c.read()
                if not ok:
                    break
                got += 1
                if idx % skip_frames == 0:
                    kept.append(img)
            if w == workers - 1 and got == end - start:
                # metadata frame counts UNDERSTATE real content for some
                # VFR/estimated-duration files: the sequential decoder reads
                # those trailing frames, so the last worker must too (it is
                # already positioned at `end` — no extra seek) or the two
                # decoders diverge on frames AND full_n_frames
                idx = end
                while True:
                    ok, img = c.read()
                    if not ok:
                        break
                    got += 1
                    if idx % skip_frames == 0:
                        kept.append(img)
                    idx += 1
            c.release()
            decoded[w] = got
            results[w] = kept
        except BaseException as e:  # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(w,)) for w in range(workers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    # Contract check: every worker must have decoded its FULL range (the last
    # may exceed it — the metadata tail above).  A short segment (mid-read
    # failure, VFR metadata mismatch, inaccurate seek) would silently drop
    # frames AND make the metadata `total` diverge from the actually-decodable
    # count — which changes `full_n_frames` and therefore the knapsack
    # capacity downstream.  Fall back to the sequential decoder, whose frame
    # count is ground truth, whenever reality ≠ metadata.
    expected = [int(bounds[w + 1]) - int(bounds[w]) for w in range(workers)]
    short = (errors or any(r is None for r in results)
             or decoded[:-1] != expected[:-1] or decoded[-1] < expected[-1])
    if short:
        return decode_condensed_frames(path, skip_frames)
    frames = [f for seg in results for f in seg]
    # actual decodable count, not the metadata estimate
    return np.stack(frames), int(bounds[workers - 1]) + decoded[-1]


def stream_condensed_frames_parallel(
    path: str,
    skip_frames: int,
    chunk: int = 256,
    workers: int = 4,
) -> Iterator[np.ndarray]:
    """Ordered streaming decode with segment-parallel workers.

    Segments are decoded concurrently (each worker seeks to its range) and
    re-chunked IN ORDER, so the consumer sees the same chunk sequence as
    :func:`stream_condensed_frames` while decode throughput scales with
    threads.  Falls back to the sequential streamer when seeking is
    unavailable.
    """
    from concurrent.futures import ThreadPoolExecutor

    cap = _open_cv2(path)
    if cap is None or workers <= 1:
        if cap is not None:
            cap.release()
        yield from stream_condensed_frames(path, skip_frames, chunk)
        return
    import cv2

    total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    cap.release()
    if total <= 0:
        yield from stream_condensed_frames(path, skip_frames, chunk)
        return

    # segment boundaries aligned to the decimation grid so global indices hold
    seg = max(chunk * skip_frames, -(-total // (workers * 4)))
    seg -= seg % skip_frames or 0
    starts = list(range(0, total, seg))

    def decode_segment(start: int) -> tuple[list[np.ndarray], bool]:
        c = _open_cv2(path)
        c.set(cv2.CAP_PROP_POS_FRAMES, start)
        kept = []
        end = min(start + seg, total)
        got = 0
        for idx in range(start, end):
            ok, img = c.read()
            if not ok:
                break
            got += 1
            if idx % skip_frames == 0:
                kept.append(img)
        if end >= total and got == end - start:
            # final segment: read past the metadata count to EOF — header
            # frame counts can UNDERSTATE real content (VFR files), and the
            # sequential streamer would have yielded those trailing frames
            idx = end
            while True:
                ok, img = c.read()
                if not ok:
                    break
                if idx % skip_frames == 0:
                    kept.append(img)
                idx += 1
        c.release()
        return kept, got >= end - start

    def resume_sequential(raw_start: int):
        """Re-decode from frame 0 (reads are reliable; seeks are not) and
        yield decimated frames from raw index ``raw_start`` on."""
        c = _open_cv2(path)
        idx = 0
        while True:
            ok, img = c.read()
            if not ok:
                break
            if idx >= raw_start and idx % skip_frames == 0:
                yield img
            idx += 1
        c.release()

    buf: list[np.ndarray] = []
    aborted_at: int | None = None
    with ThreadPoolExecutor(max_workers=workers) as pool:
        # sliding submission window bounds memory to ~(workers+1) segments
        pending = []
        next_start = 0
        seg_idx = 0
        while pending or next_start < len(starts):
            while next_start < len(starts) and len(pending) <= workers:
                pending.append(pool.submit(decode_segment, starts[next_start]))
                next_start += 1
            frames, complete = pending.pop(0).result()   # in-order consumption
            if not complete:
                # A short segment means seeks/metadata lied for this file —
                # discard this segment's frames (their indices are suspect)
                # and finish with a sequential decode from its raw start.
                # Every earlier segment was verified complete, so the global
                # decimation grid up to here is exact.
                aborted_at = starts[seg_idx]
                for f in pending:
                    f.cancel()
                break
            buf.extend(frames)
            seg_idx += 1
            while len(buf) >= chunk:
                yield np.stack(buf[:chunk])
                buf = buf[chunk:]
    if aborted_at is not None:
        for img in resume_sequential(aborted_at):
            buf.append(img)
            if len(buf) == chunk:
                yield np.stack(buf)
                buf = []
    if buf:
        yield np.stack(buf)


def _probe_decode_fps(path: str, workers: int, probe_seconds: float, total: int) -> float:
    """Aggregate raw-decode throughput with ``workers`` concurrent readers,
    measured directly for ~``probe_seconds`` (each thread seeks to its own
    region and decodes until the deadline — no segment/chunk machinery, so
    the measurement is valid regardless of file length)."""
    import threading
    import time

    import cv2

    counts = [0] * workers
    deadline = time.perf_counter() + probe_seconds

    def reader(w: int):
        c = _open_cv2(path)
        if c is None:
            return
        if workers > 1:
            c.set(cv2.CAP_PROP_POS_FRAMES, int(total * w / workers))
        n = 0
        while time.perf_counter() < deadline:
            if not c.read()[0]:
                break
            n += 1
        c.release()
        counts[w] = n

    t0 = time.perf_counter()
    threads = [threading.Thread(target=reader, args=(w,)) for w in range(workers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return sum(counts) / max(time.perf_counter() - t0, 1e-6)


# auto-probe results, one per candidate set: decode throughput is a HOST
# property (cores, codec lib), so the first probed video's answer serves the
# whole process — without this every _load_frames call (each HTTP /summarize,
# every video in a training scan) would pay the multi-second probe again
_auto_workers_cache: dict[tuple[int, ...], int] = {}


def pick_decode_workers(
    path: str,
    candidates: tuple[int, ...] = (1, 2, 4, 8),
    probe_seconds: float = 0.75,
    use_cache: bool = True,
) -> int:
    """Probe decode throughput briefly per candidate and return the fastest.

    More threads can hurt through seek contention, so a core-count
    heuristic is unreliable.  This measures ~``probe_seconds`` of
    real concurrent decode at each candidate (a few seconds total, amortized
    over a 90-minute match) and picks the empirical argmax.  Candidates
    above the host's core count are skipped.  The result is cached for the
    process (``use_cache=False`` re-probes): short clips must not pay a
    probe that costs more than their own decode.
    """
    try:
        import cv2  # noqa: F401 — the probe needs cv2's threaded decode
    except ImportError:
        # imageio-only host: the sequential decoder handles it; parallel
        # decode (and therefore the probe) is a cv2 feature
        return 1

    if use_cache and candidates in _auto_workers_cache:
        return _auto_workers_cache[candidates]
    ncpu = os.cpu_count() or 1
    cands = [c for c in candidates if c <= max(ncpu, 1)] or [1]
    if len(cands) == 1:
        return cands[0]
    cap = _open_cv2(path)
    if cap is None:
        return 1
    total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    cap.release()
    if total <= 0:
        return 1  # seeking unreliable → the parallel decoder would fall back anyway
    best, best_fps = cands[0], -1.0
    for w in cands:
        fps = _probe_decode_fps(path, w, probe_seconds, total)
        if fps > best_fps:
            best, best_fps = w, fps
    if use_cache:
        _auto_workers_cache[candidates] = best
    return best


def resolve_decode_workers(value: "str | int | None", path: str) -> int:
    """'auto'/None → probe (:func:`pick_decode_workers`); else int(value)."""
    if value is None or value == "" or str(value).lower() == "auto":
        return pick_decode_workers(path)
    return int(value)


def probe_video_fps(path: str) -> "float | None":
    """Container-reported fps, or None (npz archives, unreadable files).

    Callers converting frame indices to seconds must not assume a fixed
    rate — production footage is 25 fps while the reference's EXPORT
    convention is 30 (``utils.py:523``); only the container knows.
    """
    if path.endswith(".npz"):
        return None
    cap = _open_cv2(path)
    if cap is None:
        return None
    import cv2

    fps = float(cap.get(cv2.CAP_PROP_FPS))
    cap.release()
    return fps if fps > 0 else None


def export_selected_clips_stream(
    path: str, clip_intervals, output_path: str, fps: int = 30
) -> int:
    """Single-pass summary export: re-decode ``path`` and write only the raw
    frames inside the chosen ``[a, b)`` clip intervals → frames written.

    The streaming counterpart of the offline path's decode-everything +
    ``export_video`` (reference ``get_frame_tensor`` + ``utils.py:512-523``):
    memory stays bounded by one frame.  Intervals must be ascending and
    disjoint — exactly what ``summarize`` returns (``knapsack_select``
    reverses its traceback into ascending index order), so the written
    frame order equals the offline export's concatenation order.
    """
    iv = [(int(a), int(b)) for a, b in np.asarray(clip_intervals)]
    if any(b0 > a1 for (_, b0), (a1, _) in zip(iv, iv[1:])):
        raise ValueError("clip_intervals must be ascending and disjoint")
    if path.endswith(".npz"):
        frames = np.load(path)["frames"]
        chosen = [frames[a:b] for a, b in iv if b > a]
        if not chosen:
            return 0
        out = np.concatenate(chosen)
        export_video(out, output_path, fps=fps)
        return len(out)
    cap = _open_cv2(path)
    if cap is None:
        raise RuntimeError(f"no decoder available for {path}")
    import cv2  # _open_cv2 succeeded, so cv2 is importable

    writer = None
    written = 0
    i, k = 0, 0
    try:
        while k < len(iv):
            ok, img = cap.read()
            if not ok:
                break
            a, b = iv[k]
            if a <= i < b:
                if writer is None:
                    h, w = img.shape[:2]
                    writer = cv2.VideoWriter(
                        output_path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
                writer.write(np.ascontiguousarray(img))
                written += 1
            i += 1
            if i >= b:
                k += 1
    finally:
        cap.release()
        if writer is not None:
            writer.release()
    return written


def export_video(frames: np.ndarray, output_path: str, fps: int = 30) -> None:
    """Write frames to an mp4 (reference ``export_video``, ``utils.py:512-523``)."""
    try:
        import cv2

        h, w = frames[0].shape[:2]
        out = cv2.VideoWriter(output_path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
        for frame in frames:
            out.write(np.ascontiguousarray(frame))
        out.release()
    except ImportError:
        import imageio.v3 as iio

        iio.imwrite(output_path, frames[..., ::-1], fps=fps)
