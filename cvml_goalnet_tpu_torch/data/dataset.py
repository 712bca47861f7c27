"""Per-video dataset assembly and a background prefetcher.

Port of ``cvml_goalnet_tpu/data/dataset.py`` (reference ``dataloader`` /
``get_dataloaders``, ``utils.py:16-143``): one batch is one whole video,
carrying its condensed frames' features, per-frame MFCCs, trimmed
mean-annotator labels and the per-annotator ground-truth summary masks, made
by the same knapsack ``summarize`` as at eval (``utils.py:104-116``).

* :class:`VideoItem` records are immutable (the reference's ``__getitem__``
  set ``self.title`` / ``full_n_frames_`` on the instance, ``utils.py:73-74``);
* annotation files are parsed once by :class:`AnnotationStore`;
* ``.npz`` frame archives (key ``frames``) are read alongside real videos;
* :func:`build_video_item` runs the port's ``extract_features`` (kernel 1 and
  the MFCC frontend on the card unless ``device="cpu"``), so ``visual`` and
  ``audio`` are tensors on that device;
* :class:`Prefetcher` produces item i+1 on a thread while the caller works
  on item i.

With ``ModelConfig.text_included`` each video's commentary comes from its
``<video>.commentary.jsonl`` sidecar, aligned per condensed frame
(``data/text.py``), or ``""`` for every frame without one: the model still
expects the modality, and empty commentary is the pattern it trains on.
"""

from __future__ import annotations

import os
import queue
import threading
from dataclasses import dataclass

import numpy as np
import torch

from cvml_goalnet_tpu_torch.config import PipelineConfig
from cvml_goalnet_tpu_torch.data.annotations import AnnotationStore, load_tvsum_annotations
from cvml_goalnet_tpu_torch.data.audio_io import demux_audio, load_waveform
from cvml_goalnet_tpu_torch.data.video import (
    decode_condensed_frames,
    decode_condensed_frames_parallel,
    resolve_decode_workers,
)
from cvml_goalnet_tpu_torch.data.text import commentary_sidecar
from cvml_goalnet_tpu_torch.pipeline import extract_features, summarize


@dataclass
class VideoItem:
    video_id: str
    title: str
    visual: torch.Tensor                # (N, h, w, C) preprocessed frames, on the device
    audio: torch.Tensor | None          # (N, B, n_mfcc) MFCCs, on the device
    labels: np.ndarray | None           # (N,) trimmed mean-annotator grades
    gd_summary_masks: np.ndarray | None  # (A, full_n) knapsack ground-truth masks
    full_n_frames: int
    clip_intervals: np.ndarray          # (K, 2)
    text: torch.Tensor | None = None    # (N, text_max_len) int32 commentary token ids, on the device


class VideoDataset:
    """A list of :class:`VideoItem`; iteration yields one video per batch."""

    def __init__(self, items: list[VideoItem]):
        self.items = items

    def __len__(self) -> int:
        return len(self.items)

    def __getitem__(self, i: int) -> VideoItem:
        return self.items[i]

    def __iter__(self):
        return iter(self.items)


def _load_frames(path: str, skip_frames: int) -> tuple[np.ndarray, int]:
    """Decimated raw frames and the raw frame count; ``GOALNET_DECODE_WORKERS`` (default 1, or ``auto``)
    sets the decode threads for real videos."""
    if path.endswith(".npz"):
        frames = np.load(path)["frames"]
        return frames[::skip_frames], len(frames)
    workers = resolve_decode_workers(os.environ.get("GOALNET_DECODE_WORKERS", "1"), path)
    if workers > 1:
        return decode_condensed_frames_parallel(path, skip_frames, workers)
    return decode_condensed_frames(path, skip_frames)


def condensed_length(path: str, skip_frames: int) -> int | None:
    """The length of a video's condensed timeline (``ceil(raw frames / skip_frames)``, what ``_load_frames``
    keeps) where the file states its frame count exactly, without decoding: the ``frames`` array's header in
    an ``.npz``.  None for a video container, whose reported count (``CAP_PROP_FRAME_COUNT``) is an estimate
    from its metadata that the decoded frames need not match."""
    if not path.endswith(".npz"):
        return None
    import zipfile

    with zipfile.ZipFile(path) as z, z.open("frames.npy") as f:
        fmt = np.lib.format
        read = fmt.read_array_header_1_0 if fmt.read_magic(f) == (1, 0) else fmt.read_array_header_2_0
        return -(-int(read(f)[0][0]) // skip_frames)


def _load_titles(info_fp: str | None, video_ids: list[str]) -> dict[str, str]:
    """Title lookup from the info TSV (reference ``utils.py:55-66``)."""
    titles = {vid: vid for vid in video_ids}
    if info_fp and os.path.exists(info_fp):
        import csv

        with open(info_fp) as f:
            reader = csv.DictReader(f, delimiter="\t")
            for row in reader:
                if row.get("video_id") in titles:
                    titles[row["video_id"]] = row.get("title", row["video_id"])
    return titles


def uniform_clip_intervals(cfg: PipelineConfig, full_n: int) -> np.ndarray:
    """Uniform ~2-second clips where no annotation store gives change points, never wider than the knapsack
    budget (a single whole-video clip could never fit the 15 % capacity and every summary would be empty)."""
    budget = max(1, int(cfg.knapsack.summary_ratio * full_n))
    step = max(1, min(2 * 30, budget))
    starts = np.arange(0, full_n, step, dtype=np.int64)
    return np.stack([starts, np.minimum(starts + step, full_n)], 1)


def build_video_item(
    video_fp: str,
    cfg: PipelineConfig,
    annotation_fp: str | None,
    store: AnnotationStore | None,
    audio_included: bool,
    title: str | None = None,
    device=None,
) -> VideoItem:
    """Assemble one video's tensors on ``device`` (reference ``utils.py:86-122``, the per-video body)."""
    video_id = os.path.basename(video_fp).rsplit(".", 1)[0]
    skip = cfg.preprocess.skip_frames
    frames_raw, full_n = _load_frames(video_fp, skip)

    waveform = None
    if audio_included:
        audio_fp = video_fp.rsplit(".", 1)[0] + ".wav"
        if not os.path.exists(audio_fp):
            demux_audio(video_fp, audio_fp)
        waveform, _ = load_waveform(audio_fp, cfg.audio.sample_rate)

    commentary = None
    if cfg.model.text_included:   # without a sidecar every frame is "": the model expects the modality
        commentary = commentary_sidecar(video_fp, len(frames_raw), skip) or [""] * len(frames_raw)
    feats = extract_features(frames_raw, waveform, cfg, commentary=commentary, device=device)

    labels = gd_masks = None
    if store is None:
        clip_intervals = uniform_clip_intervals(cfg, full_n)
    else:
        clip_intervals = np.asarray(store.change_points(video_id))
        if annotation_fp is not None:
            labels, _ = load_tvsum_annotations(annotation_fp, video_id, skip)
            # annotation and decode streams can disagree by a trailing frame;
            # align every per-frame tensor to the common length
            n = min(len(labels), len(feats["visual"]))
            labels = labels[:n]
            feats["visual"] = feats["visual"][:n]
            if feats["audio"] is not None:
                feats["audio"] = feats["audio"][:n]
            if feats["text"] is not None:
                feats["text"] = feats["text"][:n]
        # ground-truth summaries: each annotator's importances through the
        # same expand → clips → knapsack pipeline (reference utils.py:104-116)
        masks = [summarize(annotator_gd, clip_intervals, skip_frames=skip, full_n_frames=full_n,
                           kcfg=cfg.knapsack, device=device).frame_mask
                 for annotator_gd in store.user_annotations(video_id)]
        gd_masks = np.stack(masks)

    return VideoItem(
        video_id=video_id,
        title=title or video_id,
        visual=feats["visual"],
        audio=feats["audio"],
        labels=labels,
        gd_summary_masks=gd_masks,
        full_n_frames=full_n,
        clip_intervals=clip_intervals,
        text=feats["text"],
    )


def build_datasets(
    video_fps: list[str],
    cfg: PipelineConfig,
    annotation_fp: str | None = None,
    mat_file_path: str | None = None,
    h5_file_path: str | None = None,
    info_fp: str | None = None,
    audio_included: bool = True,
    device=None,
) -> tuple[VideoDataset, VideoDataset]:
    """Train/val split by ``cfg.train.train_ratio`` (reference ``utils.py:78-143``)."""
    store = AnnotationStore(mat_file_path, h5_file_path) if mat_file_path and h5_file_path else None
    ids = [os.path.basename(fp).rsplit(".", 1)[0] for fp in video_fps]
    titles = _load_titles(info_fp, ids)
    items = [build_video_item(fp, cfg, annotation_fp, store, audio_included, titles[vid], device=device)
             for fp, vid in zip(video_fps, ids)]
    offset = int(cfg.train.train_ratio * len(items))
    return VideoDataset(items[:offset]), VideoDataset(items[offset:])


class Prefetcher:
    """Background-thread prefetch: host assembles item i+1 while caller works on i.

    Abandoning the iteration early (consumer exception, generator GC) closes
    the prefetcher: the worker would otherwise block forever in ``q.put``,
    leaking the thread, ``depth`` buffered items, and the source iterator
    (e.g. an open ``VideoCapture``) — fatal in a long-lived serving process
    where each failed stream would leak permanently.
    """

    _SENTINEL = object()

    def __init__(self, iterable, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._err: BaseException | None = None
        self._stop = threading.Event()

        def worker():
            try:
                it = iter(iterable)
                while not self._stop.is_set():
                    try:
                        item = next(it)
                    except StopIteration:
                        break
                    while not self._stop.is_set():
                        try:
                            self._q.put(item, timeout=0.2)
                            break
                        except queue.Full:
                            pass
            except BaseException as e:  # re-raise in consumer
                self._err = e
            finally:
                close = getattr(iterable, "close", None)
                if close is not None:
                    try:
                        close()  # release the source (decoder handles etc.)
                    except Exception:
                        pass
                while True:  # deliver the sentinel unless the consumer left
                    try:
                        self._q.put(self._SENTINEL, timeout=0.2)
                        break
                    except queue.Full:
                        if self._stop.is_set():
                            break

        self._t = threading.Thread(target=worker, daemon=True)
        self._t.start()

    def close(self) -> None:
        """Stop the worker, release buffered items, and close the source."""
        self._stop.set()
        self._t.join(timeout=5.0)
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break

    def __iter__(self):
        try:
            while True:
                item = self._q.get()
                if item is self._SENTINEL:
                    if self._err is not None:
                        raise self._err
                    return
                yield item
        finally:
            # normal exhaustion: joins an already-finished thread (cheap);
            # early abandonment: unblocks and reaps the worker
            self.close()
