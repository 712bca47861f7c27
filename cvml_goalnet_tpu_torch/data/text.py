"""Commentary ingest for the text branch: the hashing tokeniser and the per-frame sidecar alignment.

The port's own copy of ``cvml_goalnet_tpu/data/text.py`` (token ids must
match the JAX package's exactly, so a checkpoint's embedding rows mean the
same words in both): words are the ``[a-z0-9']+`` runs of the lowercased
text, each hashed by 64-bit FNV-1a over its UTF-8 bytes into ids
``1 .. vocab_size − 1``; id 0 is padding.

A commentary sidecar is ``<video>.commentary.jsonl``: one JSON object per
line, ``{"frame": <raw frame index>, "text": "..."}``.  Condensed frame ``i``
(raw frame ``i · skip_frames``) carries the latest line at or before it;
frames before the first line get the empty string (all-zero ids).
"""

from __future__ import annotations

import json
import re

import numpy as np

_WORD = re.compile(r"[a-z0-9']+")


def _fnv1a(s: str) -> int:
    h = 0xCBF29CE484222325
    for ch in s.encode("utf-8"):
        h = ((h ^ ch) * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


def tokenize(texts: list[str], vocab_size: int, max_len: int) -> np.ndarray:
    """(N,) strings → (N, max_len) int32 token ids; 0 = padding, the first ``max_len`` words kept."""
    if vocab_size < 2:
        # id 0 is the padding slot, so hashing needs at least one real id
        raise ValueError(f"text_vocab_size must be >= 2 (got {vocab_size}); "
                         "id 0 is reserved for padding")
    out = np.zeros((len(texts), max_len), dtype=np.int32)
    for i, text in enumerate(texts):
        words = _WORD.findall(text.lower())[:max_len]
        for j, w in enumerate(words):
            out[i, j] = 1 + _fnv1a(w) % (vocab_size - 1)
    return out


def load_commentary_jsonl(path: str) -> list[tuple[int, str]]:
    """A commentary sidecar → its (raw frame, text) pairs sorted by frame; blank lines are skipped."""
    entries: list[tuple[int, str]] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            obj = json.loads(line)
            entries.append((int(obj["frame"]), str(obj["text"])))
    entries.sort(key=lambda e: e[0])
    return entries


def commentary_per_frame(entries: list[tuple[int, str]], n_condensed: int, skip_frames: int) -> list[str]:
    """Sorted (raw frame, text) pairs → one string per condensed frame: the latest line at or before raw
    frame ``i · skip_frames`` (commentary holds until the next line), ``""`` before the first."""
    out: list[str] = []
    j = -1
    for i in range(n_condensed):
        raw = i * skip_frames
        while j + 1 < len(entries) and entries[j + 1][0] <= raw:
            j += 1
        out.append(entries[j][1] if j >= 0 else "")
    return out


def commentary_sidecar(video_fp: str, n_condensed: int, skip_frames: int) -> list[str] | None:
    """The per-frame commentary of ``<video>.commentary.jsonl`` beside ``video_fp``, or None without one."""
    import os

    path = video_fp.rsplit(".", 1)[0] + ".commentary.jsonl"
    if not os.path.exists(path):
        return None
    return commentary_per_frame(load_commentary_jsonl(path), n_condensed, skip_frames)
