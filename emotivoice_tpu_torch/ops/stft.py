"""STFT magnitude and frame energy (counterpart of `emotivoice_tpu/ops/stft.py`:
`hann_window`, `frame_signal`, `stft_magnitude`, `frame_energy`).

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
    win = torch.from_numpy(_window(win_length, n_fft)).to(x.device)
    spec = torch.fft.rfft(frame_signal(x, n_fft, hop_length) * win, dim=-1)
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
