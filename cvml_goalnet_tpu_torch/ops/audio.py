"""Audio frontend: slots → STFT → mel → dB → DCT → MFCC → cubic interpolation.

Port of ``cvml_goalnet_tpu/ops/audio.py`` (reference ``extract_audio_features``,
``utils.py:313-349``, librosa defaults re-derived).  The constant tables
(window, mel filterbank, DCT, cubic-interpolation matrix) are the same NumPy
arrays; the per-slot work runs as batched PyTorch ops on the waveform's
device: ``torch.fft.rfft`` for the STFT, matrix products for mel, DCT and
interpolation.  Slots are batched by sample count, and the ``top_db`` clamp
is taken per slot, as the JAX package's ``vmap`` over slots takes it.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from cvml_goalnet_tpu_torch.config import AudioConfig
from cvml_goalnet_tpu_torch.device import strict_f32

# --------------------------------------------------------------- constants


@lru_cache(maxsize=8)
def hann_window(n: int) -> np.ndarray:
    """Periodic Hann window (scipy.signal.get_window('hann', n, fftbins=True))."""
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(n) / n))).astype(np.float32)


def _hz_to_mel(f: np.ndarray) -> np.ndarray:
    """Slaney mel scale (librosa htk=False): linear below 1 kHz, log above."""
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3
    mel = f / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(f >= min_log_hz, min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep, mel)


def _mel_to_hz(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), f_sp * m)


@lru_cache(maxsize=8)
def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float, fmax: float | None) -> np.ndarray:
    """(n_mels, 1 + n_fft//2) triangular filterbank, Slaney mel + Slaney norm."""
    if fmax is None:
        fmax = sr / 2.0
    fft_freqs = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
    mel_pts = np.linspace(_hz_to_mel(np.array(fmin)), _hz_to_mel(np.array(fmax)), n_mels + 2)
    hz_pts = _mel_to_hz(mel_pts)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels])
    return (weights * enorm[:, None]).astype(np.float32)


@lru_cache(maxsize=8)
def dct_matrix(n_out: int, n_in: int) -> np.ndarray:
    """Orthonormal DCT-II matrix (n_out, n_in) — scipy.fftpack.dct(type=2, norm='ortho')."""
    k = np.arange(n_out)[:, None]
    n = np.arange(n_in)[None, :]
    m = np.cos(np.pi * k * (2 * n + 1) / (2 * n_in)) * np.sqrt(2.0 / n_in)
    m[0] *= 1.0 / np.sqrt(2.0)
    return m.astype(np.float32)


@lru_cache(maxsize=256)
def cubic_interp_matrix(t_in: int, t_out: int) -> np.ndarray:
    """(t_out, t_in) matrix W with W @ y == scipy interp1d(kind='cubic')(linspace).

    Spline interpolation is linear in the data, so scipy's solver applied to
    each basis vector gives the exact linear map.  Below 4 input points a
    cubic spline is underdetermined and the map is piecewise linear (or the
    constant map for one point), as in the JAX package.
    """
    x_out = np.linspace(0.0, t_in - 1.0, t_out)
    if t_in == 1:
        return np.ones((t_out, 1), dtype=np.float32)
    if t_in < 4:
        w = np.zeros((t_out, t_in), dtype=np.float64)
        lo = np.clip(np.floor(x_out).astype(int), 0, t_in - 2)
        frac = x_out - lo
        w[np.arange(t_out), lo] = 1.0 - frac
        w[np.arange(t_out), lo + 1] = frac
        return w.astype(np.float32)
    from scipy.interpolate import interp1d

    basis = np.eye(t_in)
    interp = interp1d(np.arange(t_in), basis, kind="cubic", axis=0, fill_value="extrapolate")
    return interp(x_out).astype(np.float32)


# ------------------------------------------------------------ tensor path


def stft_power(y: torch.Tensor, n_fft: int, hop: int, pad_mode: str = "constant") -> torch.Tensor:
    """Centred power spectrogram of (S, L) equal-length slots → (S, T, 1 + n_fft//2).

    Reflect padding needs ``L > n_fft//2``; shorter slots always use zero
    padding, the same degradation librosa applies.
    """
    pad = n_fft // 2
    mode = pad_mode if y.shape[-1] > pad else "constant"
    y = F.pad(y.to(torch.float32)[:, None, :], (pad, pad), mode=mode)[:, 0]
    frames = y.unfold(-1, n_fft, hop) * torch.as_tensor(hann_window(n_fft), device=y.device)
    return torch.abs(torch.fft.rfft(frames, dim=-1)) ** 2


def power_to_db(S: torch.Tensor, top_db: float | None = 80.0, amin: float = 1e-10) -> torch.Tensor:
    """librosa ``power_to_db`` (ref=1.0) on (S, T, M); the ``top_db`` clamp is per slot."""
    log_spec = 10.0 * torch.log10(torch.clamp(S, min=amin))
    if top_db is not None:
        peak = log_spec.amax(dim=(-2, -1), keepdim=True)
        log_spec = torch.maximum(log_spec, peak - top_db)
    return log_spec


def mfcc_slots(y: torch.Tensor, cfg: AudioConfig) -> torch.Tensor:
    """MFCCs (or log-mel with ``cfg.log_mel``) of (S, L) slots → (S, T, D)."""
    dev = y.device
    power = stft_power(y, cfg.n_fft, cfg.hop_length, cfg.stft_pad_mode)
    fb = torch.as_tensor(mel_filterbank(cfg.sample_rate, cfg.n_fft, cfg.n_mels, cfg.fmin, cfg.fmax), device=dev)
    with strict_f32():
        mel_db = power_to_db(power @ fb.T, cfg.top_db)
        if cfg.log_mel:
            return mel_db
        return mel_db @ torch.as_tensor(dct_matrix(cfg.n_mfcc, cfg.n_mels), device=dev).T


def slot_boundaries(n_samples: int, n_frames: int) -> list[tuple[int, int]]:
    """Reference slot arithmetic (``utils.py:322-330``), including Python's
    banker's ``round()`` and the end clamp."""
    per = n_samples / n_frames
    out = []
    for i in range(n_frames):
        start = round(i * per)
        end = min(round(start + per), n_samples)
        out.append((start, end))
    return out


def extract_audio_features(
    y: np.ndarray, n_frames: int, cfg: AudioConfig, device: torch.device
) -> torch.Tensor:
    """Waveform → (n_frames, B, n_mfcc) per-video-frame MFCCs on ``device`` (NWC, time-major).

    Zero frames give an empty (0, B, n_mfcc) tensor: a 0-frame request with a
    waveform then answers as one without (the JAX package divides by zero in
    ``slot_boundaries`` there).
    """
    depth = cfg.n_mels if cfg.log_mel else cfg.n_mfcc
    out = torch.empty((n_frames, cfg.bin_length, depth), dtype=torch.float32, device=device)
    if n_frames == 0:
        return out
    y = np.asarray(y, dtype=np.float32)
    bounds = slot_boundaries(len(y), n_frames)
    groups: dict[int, list[int]] = {}
    for i, (a, b) in enumerate(bounds):
        groups.setdefault(b - a, []).append(i)
    for idxs in groups.values():
        stack = np.stack([y[bounds[i][0] : bounds[i][1]] for i in idxs])
        feats = mfcc_slots(torch.as_tensor(stack, device=device), cfg)            # (S, T, D)
        w = torch.as_tensor(cubic_interp_matrix(feats.shape[1], cfg.bin_length), device=device)
        with strict_f32():
            out[torch.as_tensor(idxs, device=device)] = torch.matmul(w, feats)   # (S, B, D)
    return out
