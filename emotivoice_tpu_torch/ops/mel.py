"""Mel filterbank, log-mel extraction and its approximate inverse
(counterpart of `emotivoice_tpu/ops/mel.py`). The filterbank is a numpy
copy of the JAX package's, which reproduces librosa's `filters.mel(htk=
False, norm='slaney')`, the reference's mel basis.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from emotivoice_tpu_torch.ops.stft import stft_magnitude

_F_SP = 200.0 / 3.0  # Slaney linear region: 66.67 Hz per mel step
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = np.log(6.4) / 27.0


def hz_to_mel(f):
    f = np.asanyarray(f, dtype=np.float64)
    mel = f / _F_SP
    return np.where(
        f >= _MIN_LOG_HZ,
        _MIN_LOG_MEL + np.log(np.maximum(f, _MIN_LOG_HZ) / _MIN_LOG_HZ) / _LOGSTEP,
        mel,
    )


def mel_to_hz(m):
    m = np.asanyarray(m, dtype=np.float64)
    f = m * _F_SP
    return np.where(m >= _MIN_LOG_MEL, _MIN_LOG_HZ * np.exp(_LOGSTEP * (m - _MIN_LOG_MEL)), f)


@functools.lru_cache(maxsize=8)
def mel_filterbank(
    sr: int = 16000,
    n_fft: int = 1024,
    n_mels: int = 80,
    fmin: float = 0.0,
    fmax: Optional[float] = 8000.0,
) -> np.ndarray:
    """Slaney-normalised triangular mel filterbank, (n_mels, n_fft//2+1)."""
    if fmax is None:
        fmax = sr / 2.0
    fftfreqs = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
    mel_f = mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2))
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    weights *= (2.0 / (mel_f[2:n_mels + 2] - mel_f[:n_mels]))[:, None]
    return weights.astype(np.float32)


def dynamic_range_compression(x: torch.Tensor, clip_val: float = 1e-5) -> torch.Tensor:
    """log(clamp(x, 1e-5))."""
    return torch.log(torch.clamp(x, min=clip_val))


def mel_spectrogram(
    wav: torch.Tensor,
    sr: int = 16000,
    n_fft: int = 1024,
    hop_length: int = 256,
    win_length: int = 1024,
    n_mels: int = 80,
    fmin: float = 0.0,
    fmax: Optional[float] = 8000.0,
    *,
    loss_mode: bool = False,
) -> torch.Tensor:
    """(B, T) or (T,) waveform in [-1, 1] -> (B, n_mels, n_frames) log-mel.

    loss_mode=False: the dataset's ground-truth mel (centred frames);
    loss_mode=True: the training loss's mel over waveform segments."""
    mag = stft_magnitude(wav, n_fft, hop_length, win_length, center=True,
                         loss_mode=loss_mode)
    basis = torch.from_numpy(mel_filterbank(sr, n_fft, n_mels, fmin, fmax)).to(mag.device)
    return dynamic_range_compression(torch.matmul(basis, mag))


@functools.lru_cache(maxsize=8)
def _filterbank_pinv(sr: int, n_fft: int, n_mels: int, fmin: float, fmax: float) -> np.ndarray:
    return np.linalg.pinv(mel_filterbank(sr, n_fft, n_mels, fmin, fmax))


def mel_to_linear(
    mel: torch.Tensor,
    sr: int = 16000,
    n_fft: int = 1024,
    n_mels: int = 80,
    fmin: float = 0.0,
    fmax: float = 8000.0,
) -> torch.Tensor:
    """Log-mel (B, n_mels, T) -> linear magnitude (B, n_bins, T) through the
    filterbank's pseudo-inverse (numpy), clamped at 0. With `griffin_lim`
    it is the checkpoint-free fallback vocoder."""
    pinv = torch.from_numpy(_filterbank_pinv(sr, n_fft, n_mels, fmin, fmax)).to(mel.device)
    return torch.clamp(torch.matmul(pinv, torch.exp(mel.float())), min=0.0)
