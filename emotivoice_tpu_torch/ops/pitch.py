"""Batched F0 extraction by normalised autocorrelation (counterpart of
`emotivoice_tpu/ops/pitch.py`: `extract_pitch`, `normalize_pitch`,
`continuous_pitch_np`; the reference uses pyworld DIO + StoneMask on the
host).

Per frame: normalised autocorrelation over the lag window
[sr/pitch_max, sr/pitch_min] (through `torch.fft`), an octave-robust peak
pick with parabolic refinement, a voicing decision by NAC threshold, then
the reference's continuous-pitch completion (edge fill + linear
interpolation over unvoiced gaps) with previous/next-voiced index scans.
Frames align with the centred mel frames (1 + T//hop).
"""

from __future__ import annotations

import numpy as np
import torch

from emotivoice_tpu_torch.ops.stft import frame_signal, hann_window, reflect_pad


def _interp_unvoiced(pitch: torch.Tensor, voiced: torch.Tensor) -> torch.Tensor:
    """(B, T) f0 and voicing -> f0 with unvoiced frames filled in."""
    t = pitch.shape[-1]
    idx = torch.arange(t, device=pitch.device)
    prev_pos = torch.cummax(torch.where(voiced, idx, -1), dim=-1).values
    next_pos_r = torch.cummax(torch.where(voiced.flip(-1), idx, -1), dim=-1).values
    next_pos = (t - 1) - next_pos_r.flip(-1)

    prev_val = torch.gather(pitch, -1, prev_pos.clamp(0, t - 1))
    next_val = torch.gather(pitch, -1, next_pos.clamp(0, t - 1))
    has_prev, has_next = prev_pos >= 0, next_pos <= t - 1

    span = torch.clamp(next_pos - prev_pos, min=1).to(pitch.dtype)
    frac = (idx - prev_pos).to(pitch.dtype) / span
    interp = prev_val + (next_val - prev_val) * frac

    out = torch.where(has_prev & has_next, interp, torch.zeros_like(pitch))
    out = torch.where(has_prev & ~has_next, prev_val, out)
    out = torch.where(~has_prev & has_next, next_val, out)
    return torch.where(voiced.any(dim=-1, keepdim=True), out, torch.zeros_like(pitch))


def extract_pitch(
    wav: torch.Tensor,
    sr: int = 16000,
    hop_length: int = 256,
    frame_length: int = 1024,
    pitch_min: float = 80.0,
    pitch_max: float = 400.0,
    nac_threshold: float = 0.3,
    return_voiced: bool = False,
):
    """(B, T) or (T,) waveform -> (B, 1 + T//hop) F0 in Hz, on wav's device.
    With ``return_voiced`` also the per-frame voicing decision (before the
    unvoiced frames are filled in)."""
    squeeze = wav.dim() == 1
    if squeeze:
        wav = wav[None]
    x = reflect_pad(wav.float(), frame_length // 2)
    frames = frame_signal(x, frame_length, hop_length)
    frames = frames - frames.mean(dim=-1, keepdim=True)

    # Autocorrelation through the FFT (Wiener-Khinchin), windowed.
    win = torch.from_numpy(hann_window(frame_length)).to(x.device)
    n_fft2 = 2 * frame_length
    spec = torch.fft.rfft(frames * win, n=n_fft2, dim=-1)
    acf = torch.fft.irfft(spec * torch.conj(spec), n=n_fft2, dim=-1)[..., :frame_length]

    lag_min = max(int(sr / pitch_max), 2)
    lag_max = min(int(np.ceil(sr / pitch_min)), frame_length - 2)
    lags = torch.arange(lag_min, lag_max + 1, device=x.device)
    e0 = acf[..., 0:1]
    nac = acf[..., lag_min:lag_max + 1] / torch.clamp(e0, min=1e-10)

    # Octave-robust peak pick: among lags whose NAC is within 0.85 of the
    # maximum take the shortest, if it is a local peak; else the argmax.
    gmax = nac.max(dim=-1, keepdim=True).values
    good = nac >= 0.85 * torch.clamp(gmax, min=1e-10)
    first_good = torch.argmax(good.to(torch.uint8), dim=-1)
    inner = nac[..., 1:-1]
    is_peak = (inner >= nac[..., :-2]) & (inner >= nac[..., 2:])
    is_peak = torch.nn.functional.pad(is_peak, (1, 1))
    fg_peak = torch.gather(is_peak, -1, first_good[..., None])[..., 0]
    best = torch.where(fg_peak, first_good, torch.argmax(nac, dim=-1))
    peak = torch.gather(nac, -1, best[..., None])[..., 0]

    # Parabolic interpolation around the best integer lag.
    bm = best.clamp(1, nac.shape[-1] - 2)
    ym1 = torch.gather(nac, -1, (bm - 1)[..., None])[..., 0]
    y0 = torch.gather(nac, -1, bm[..., None])[..., 0]
    yp1 = torch.gather(nac, -1, (bm + 1)[..., None])[..., 0]
    denom = ym1 - 2 * y0 + yp1
    safe = torch.where(denom.abs() > 1e-9, denom, torch.ones_like(denom))
    delta = torch.where(denom.abs() > 1e-9, 0.5 * (ym1 - yp1) / safe, torch.zeros_like(denom))
    delta = delta.clamp(-0.5, 0.5)
    lag = lags[best].float() + torch.where(best == bm, delta, torch.zeros_like(delta))

    f0 = sr / torch.clamp(lag, min=1.0)
    voiced = (peak > nac_threshold) & (e0[..., 0] > 1e-8)
    f0 = torch.where(voiced, f0, torch.zeros_like(f0))
    f0 = _interp_unvoiced(f0, voiced)
    if squeeze:
        f0, voiced = f0[0], voiced[0]
    return (f0, voiced) if return_voiced else f0


def normalize_pitch(f0, stats=(225.089, 53.78)):
    """Corpus z-score of F0 (reference config/joint/config.py:108)."""
    mean, std = stats
    return (f0 - mean) / std


def continuous_pitch_np(pitch: np.ndarray) -> np.ndarray:
    """Host-side unvoiced-gap completion as the reference's
    `_convert_to_continuous_pitch`: edge frames take the first / last voiced
    value, interior gaps interpolate linearly."""
    pitch = np.asarray(pitch, np.float64).copy()
    nz = np.flatnonzero(pitch != 0)
    if nz.size == 0:
        return pitch
    pitch[: nz[0]] = pitch[nz[0]]
    pitch[nz[-1]:] = pitch[nz[-1]]
    nz = np.flatnonzero(pitch != 0)
    return np.interp(np.arange(pitch.shape[0]), nz, pitch[nz])


def extract_pitch_pyworld(wav: np.ndarray, sr: int = 16000, hop_length: int = 256) -> np.ndarray:
    """The reference's host pitch path: pyworld DIO + StoneMask at
    frame_period = 1000*hop/sr, then continuous-pitch completion. Needs the
    optional `pyworld` package (ImportError without it)."""
    import pyworld

    x = np.asarray(wav, np.float64)
    f0, t = pyworld.dio(x, fs=sr, frame_period=1000.0 * hop_length / sr)
    return continuous_pitch_np(pyworld.stonemask(x, f0, t, sr))
