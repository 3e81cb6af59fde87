"""STFT magnitude and phase, frame energy, inverse STFT and Griffin-Lim
(counterpart of `emotivoice_tpu/ops/stft.py`: `hann_window`, `frame_signal`,
`stft_magnitude`, `frame_energy`, `istft`, `stft_phase`, `griffin_lim`).

The signal is framed by index and transformed with `torch.fft.rfft`, not
`torch.stft`, so framing and padding are those of the JAX package exactly.
Two padding modes cover the reference's two pipelines:

  - ``center=True``: reflect-pad n_fft//2 each side (dataset ground-truth
    mel). Frames = 1 + T//hop.
  - ``loss_mode=True``: reflect pre-pad (n_fft-hop)//2 each side, no
    centering, magnitude sqrt(power + 1e-6) (training-loss mel). Frames =
    T//hop for T % hop == 0.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def hann_window(win_length: int, dtype=np.float32) -> np.ndarray:
    """Periodic Hann window (torch.hann_window(N), scipy's fftbins=True)."""
    n = np.arange(win_length)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(dtype)


def frame_signal(x: torch.Tensor, n_fft: int, hop_length: int) -> torch.Tensor:
    """(B, T) -> overlapping frames (B, 1 + (T - n_fft)//hop, n_fft)."""
    return x.unfold(-1, n_fft, hop_length)


def reflect_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Reflect-pad the last axis of (B, T) by `pad` on both sides (F.pad's
    reflect mode wants a channel axis)."""
    return F.pad(x[:, None, :], (pad, pad), mode="reflect")[:, 0]


def _window(win_length: int, n_fft: int) -> np.ndarray:
    win = hann_window(win_length)
    if win_length < n_fft:  # centred in n_fft
        lpad = (n_fft - win_length) // 2
        win = np.pad(win, (lpad, n_fft - win_length - lpad))
    return win


def _spectrum(x: torch.Tensor, n_fft: int, hop_length: int, win_length: int) -> torch.Tensor:
    """rfft of the windowed frames of an already padded (B, T) signal:
    (B, n_frames, n_bins) complex."""
    win = torch.from_numpy(_window(win_length, n_fft)).to(x.device)
    return torch.fft.rfft(frame_signal(x, n_fft, hop_length) * win, dim=-1)


def stft_magnitude(
    x: torch.Tensor,
    n_fft: int = 1024,
    hop_length: int = 256,
    win_length: int = 1024,
    *,
    center: bool = True,
    loss_mode: bool = False,
    power_eps: float = 0.0,
) -> torch.Tensor:
    """|STFT| of a (B, T) or (T,) signal -> (B, n_bins, n_frames), f32."""
    squeeze = x.dim() == 1
    if squeeze:
        x = x[None]
    x = x.float()
    if loss_mode:
        x = reflect_pad(x, (n_fft - hop_length) // 2)
        power_eps = 1e-6
    elif center:
        x = reflect_pad(x, n_fft // 2)
    spec = _spectrum(x, n_fft, hop_length, win_length)
    mag = torch.sqrt(spec.real * spec.real + spec.imag * spec.imag + power_eps)
    mag = mag.transpose(-1, -2)
    return mag[0] if squeeze else mag


def frame_energy(
    x: torch.Tensor,
    n_fft: int = 1024,
    hop_length: int = 256,
    win_length: int = 1024,
) -> torch.Tensor:
    """Per-frame L2 norm of the centred linear magnitude spectrum:
    sqrt(clamp(sum over bins of |STFT|^2, 1e-10))."""
    mag = stft_magnitude(x, n_fft, hop_length, win_length, center=True)
    power = torch.sum(mag * mag, dim=-2)
    return torch.sqrt(torch.clamp(power, min=1e-10))


@functools.lru_cache(maxsize=16)
def _inverse_envelope(win_length: int, n_fft: int, hop_length: int, n_frames: int) -> np.ndarray:
    """1 / window sum-square of `n_frames` overlapped windows (1 where the
    sum is below 1e-11), built in numpy frame by frame as the JAX package
    builds it. Read-only: the cache hands the same array to every caller."""
    win = _window(win_length, n_fft)
    wss = np.zeros(n_fft + hop_length * (n_frames - 1), np.float32)
    w2 = (win * win).astype(np.float32)
    for i in range(n_frames):
        wss[i * hop_length:i * hop_length + n_fft] += w2
    nz = wss > 1e-11
    return np.where(nz, 1.0 / np.where(nz, wss, 1.0), 1.0).astype(np.float32)


def istft(
    magnitude: torch.Tensor,
    phase: torch.Tensor,
    n_fft: int = 1024,
    hop_length: int = 256,
    win_length: int = 1024,
) -> torch.Tensor:
    """Inverse of the centred STFT: (B, n_bins, n_frames) magnitude and
    phase -> (B, hop * (n_frames - 1)) waveform, by overlap-add (`index_add_`
    on the input's device) and window sum-square normalisation, with the
    centre padding cut off."""
    if magnitude.dim() == 2:
        magnitude, phase = magnitude[None], phase[None]
    b, _, n_frames = magnitude.shape
    spec = torch.complex(magnitude * torch.cos(phase), magnitude * torch.sin(phase))
    frames = torch.fft.irfft(spec.transpose(-1, -2), n=n_fft, dim=-1)
    frames = frames * torch.from_numpy(_window(win_length, n_fft)).to(frames.device)
    out_len = n_fft + hop_length * (n_frames - 1)
    idx = (torch.arange(n_frames, device=frames.device)[:, None] * hop_length
           + torch.arange(n_fft, device=frames.device)[None, :]).reshape(-1)
    sig = torch.zeros(b, out_len, dtype=frames.dtype, device=frames.device)
    sig.index_add_(1, idx, frames.reshape(b, -1))
    inv = _inverse_envelope(win_length, n_fft, hop_length, n_frames)
    sig = sig * torch.from_numpy(inv).to(sig.device)
    pad = n_fft // 2
    return sig[:, pad:out_len - pad]


def stft_phase(
    x: torch.Tensor,
    n_fft: int = 1024,
    hop_length: int = 256,
    win_length: int = 1024,
) -> torch.Tensor:
    """Phase angle of the centred STFT of (B, T) or (T,) -> (B, n_bins,
    n_frames)."""
    squeeze = x.dim() == 1
    if squeeze:
        x = x[None]
    spec = _spectrum(reflect_pad(x.float(), n_fft // 2), n_fft, hop_length, win_length)
    phase = torch.atan2(spec.imag, spec.real).transpose(-1, -2)
    return phase[0] if squeeze else phase


def griffin_lim(
    magnitude: torch.Tensor,
    n_iter: int = 32,
    n_fft: int = 1024,
    hop_length: int = 256,
    win_length: int = 1024,
) -> torch.Tensor:
    """Griffin-Lim phase reconstruction, |STFT| (B, n_bins, n_frames) ->
    waveform (B, hop * (n_frames - 1)): from zero phase, `n_iter` rounds of
    istft and re-analysis, each cut to n_frames; the checkpoint-free
    fallback vocoder."""
    if magnitude.dim() == 2:
        magnitude = magnitude[None]
    n_frames = magnitude.shape[-1]
    phase = torch.zeros_like(magnitude)
    for _ in range(n_iter):
        wav = istft(magnitude, phase, n_fft, hop_length, win_length)
        phase = stft_phase(wav, n_fft, hop_length, win_length)[:, :, :n_frames]
    return istft(magnitude, phase, n_fft, hop_length, win_length)
