"""Host audio ingest: WAV loading and resampling to the frontend's sample rate.

Port of ``cvml_goalnet_tpu/data/audio_io.py`` (the loading half of reference
``utils.py:320``, ``librosa.load`` → mono float32 at 22.05 kHz):

* WAV parsing by the native C++ reader (``runtime/wav.cc``, through
  ``runtime.wav_read_native``) when it builds, else ``scipy.io.wavfile``;
  several channels are averaged to mono (librosa's convention);
* resampling to ``AudioConfig.sample_rate`` by polyphase filtering
  (``scipy.signal.resample_poly``; librosa defaults to soxr_hq, both are
  band-limited resamplers).

:func:`demux_audio` (reference ``export_audio_from_video``, ``utils.py:307-311``)
needs ffmpeg and raises a clear error without it: ship ``.wav`` sidecars.
"""

from __future__ import annotations

import math
import os
import shutil
import subprocess

import numpy as np

from cvml_goalnet_tpu_torch.runtime import wav_read_native


def _read_wav(path: str) -> tuple[np.ndarray, int]:
    native = wav_read_native(path)
    if native is not None:
        return native
    from scipy.io import wavfile

    sr, data = wavfile.read(path)
    if data.dtype.kind == "i":
        data = data.astype(np.float32) / float(2 ** (8 * data.dtype.itemsize - 1))
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    if data.ndim == 2:
        data = data.mean(axis=1)
    return data, int(sr)


def resample(y: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    if orig_sr == target_sr:
        return y
    from scipy.signal import resample_poly

    g = math.gcd(orig_sr, target_sr)
    return resample_poly(y, target_sr // g, orig_sr // g).astype(np.float32)


def load_waveform(path: str, target_sr: int = 22050) -> tuple[np.ndarray, int]:
    """WAV file → (mono float32 at target_sr, target_sr)."""
    y, sr = _read_wav(path)
    return resample(y, sr, target_sr), target_sr


def demux_audio(video_fp: str, audio_fp: str) -> None:
    """Extract a video's audio track to WAV (reference ``utils.py:307-311``)."""
    if os.path.exists(audio_fp):
        return
    ffmpeg = shutil.which("ffmpeg")
    if ffmpeg is None:
        raise RuntimeError(
            "no ffmpeg on this host: provide a .wav sidecar next to the video "
            f"(expected at {audio_fp})"
        )
    subprocess.run(
        [ffmpeg, "-y", "-i", video_fp, "-vn", "-acodec", "pcm_s16le", audio_fp],
        check=True,
        capture_output=True,
    )


def write_wav(path: str, y: np.ndarray, sr: int) -> None:
    """PCM16 WAV writer (synthetic fixtures and summary export)."""
    from scipy.io import wavfile

    pcm = np.clip(np.asarray(y, np.float32), -1.0, 1.0)
    wavfile.write(path, sr, (pcm * 32767.0).astype(np.int16))
