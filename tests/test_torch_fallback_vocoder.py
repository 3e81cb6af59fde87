"""The port's checkpoint-free fallback vocoder (`ops/stft.py`: `istft`,
`stft_phase`, `griffin_lim`; `ops/mel.py`: `mel_to_linear`) against the JAX
package's functions on the CPU, with seeded numpy inputs.

Tolerances, relative to the largest magnitude of the JAX output:
  - istft, mel_to_linear: 1e-5;
  - stft_phase: compared as the spectrum it implies, |X| e^{i phase}, at
    1e-5 (a bare angle is arbitrary where |X| is near zero and wraps at pi);
  - griffin_lim at 1 and 4 rounds: 1e-4 (FFT roundings of the two libraries
    go through every round).
The sine and mel round-trip properties of `tests/test_dsp.py`'s
`TestGriffinLim` are held on the port with the same bounds.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import test_torch_support  # noqa: F401  (one intra-op thread per worker)

from emotivoice_tpu.ops import mel as jmel
from emotivoice_tpu.ops import stft as jstft
from emotivoice_tpu_torch.ops import mel as tmel
from emotivoice_tpu_torch.ops import stft as tstft

FFT_SHAPES = [(1024, 256, 1024), (256, 64, 256), (256, 64, 200)]  # (n_fft, hop, win)


def _max_err(got, want):
    return float(np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64)).max())


def _spectrogram(seed, n_fft, n_frames, b=2):
    rng = np.random.RandomState(seed)
    n_bins = n_fft // 2 + 1
    mag = np.abs(rng.randn(b, n_bins, n_frames)).astype(np.float32)
    phase = rng.uniform(-np.pi, np.pi, (b, n_bins, n_frames)).astype(np.float32)
    return mag, phase


@pytest.mark.parametrize("n_fft,hop,win", FFT_SHAPES)
def test_istft_matches_jax(n_fft, hop, win):
    mag, phase = _spectrogram(0, n_fft, 7)
    want = np.asarray(jstft.istft(jnp.asarray(mag), jnp.asarray(phase), n_fft, hop, win))
    got = tstft.istft(torch.from_numpy(mag), torch.from_numpy(phase), n_fft, hop, win).numpy()
    assert got.shape == want.shape == (2, hop * 6)
    assert _max_err(got, want) <= 1e-5 * np.abs(want).max()


def test_istft_of_one_spectrogram_without_batch_axis():
    mag, phase = _spectrogram(1, 256, 5, b=1)
    got = tstft.istft(torch.from_numpy(mag[0]), torch.from_numpy(phase[0]), 256, 64, 256)
    want = tstft.istft(torch.from_numpy(mag), torch.from_numpy(phase), 256, 64, 256)
    assert torch.equal(got, want)


@pytest.mark.parametrize("n_fft,hop,win", FFT_SHAPES)
def test_stft_phase_matches_jax(n_fft, hop, win):
    rng = np.random.RandomState(2)
    x = rng.randn(2, 6 * n_fft).astype(np.float32)
    want = np.asarray(jstft.stft_phase(jnp.asarray(x), n_fft, hop, win))
    got = tstft.stft_phase(torch.from_numpy(x), n_fft, hop, win).numpy()
    assert got.shape == want.shape == (2, n_fft // 2 + 1, 1 + 6 * n_fft // hop)
    mag = np.asarray(jstft.stft_magnitude(jnp.asarray(x), n_fft, hop, win, center=True))
    err = np.abs(mag * (np.exp(1j * got.astype(np.float64)) - np.exp(1j * want.astype(np.float64))))
    assert err.max() <= 1e-5 * mag.max()
    # a 1-D signal gives the un-batched phase
    assert torch.equal(tstft.stft_phase(torch.from_numpy(x[0]), n_fft, hop, win),
                       torch.from_numpy(got[0]))


@pytest.mark.parametrize("sr,n_fft,n_mels,fmax", [(16000, 1024, 80, 8000.0),
                                                   (22050, 512, 40, 11025.0)])
def test_mel_to_linear_matches_jax(sr, n_fft, n_mels, fmax):
    mel = np.random.RandomState(3).randn(2, n_mels, 9).astype(np.float32)
    want = np.asarray(jmel.mel_to_linear(jnp.asarray(mel), sr, n_fft, n_mels, 0.0, fmax))
    got = tmel.mel_to_linear(torch.from_numpy(mel), sr, n_fft, n_mels, 0.0, fmax).numpy()
    assert got.shape == want.shape == (2, n_fft // 2 + 1, 9)
    assert got.min() >= 0.0
    assert _max_err(got, want) <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("n_iter", [1, 4])
def test_griffin_lim_matches_jax(n_iter):
    with jax.default_matmul_precision("highest"):
        mag, _ = _spectrogram(4, 256, 12)
        want = np.asarray(jstft.griffin_lim(jnp.asarray(mag), n_iter, 256, 64, 256))
    got = tstft.griffin_lim(torch.from_numpy(mag), n_iter, 256, 64, 256).numpy()
    assert got.shape == want.shape == (2, 64 * 11)
    assert _max_err(got, want) <= 1e-4 * np.abs(want).max()


def _spectral_error(rec, ref, n_fft, hop):
    """Phase-blind error of `tests/test_dsp.py`: sum |STFT mag difference| /
    sum |STFT mag of the reference|."""
    ma = tstft.stft_magnitude(torch.from_numpy(rec), n_fft, hop, n_fft).numpy()
    mb = tstft.stft_magnitude(torch.from_numpy(ref), n_fft, hop, n_fft).numpy()
    return float(np.abs(ma - mb).sum() / np.abs(mb).sum())


def test_griffin_lim_reconstructs_a_sine():
    sr, n_fft, hop = 16000, 1024, 256
    t = np.arange(sr, dtype=np.float32) / sr
    wav = (0.5 * np.sin(2 * np.pi * 440.0 * t)).astype(np.float32)
    mag = tstft.stft_magnitude(torch.from_numpy(wav), n_fft, hop, n_fft)
    rec = tstft.griffin_lim(mag, n_iter=16, n_fft=n_fft, hop_length=hop,
                            win_length=n_fft)[0].numpy()
    n = min(len(rec), len(wav))
    a, b = rec[hop:n - hop], wav[hop:n - hop]
    assert _spectral_error(a, b, n_fft, hop) < 0.2
    assert abs(np.sqrt((a ** 2).mean()) - 0.354) < 0.02  # 0.5 sine: rms 0.354


def test_mel_round_trip_keeps_the_dominant_bins():
    sr = 16000
    t = np.arange(sr // 2, dtype=np.float32) / sr
    wav = (0.3 * np.sin(2 * np.pi * 220.0 * t)
           + 0.2 * np.sin(2 * np.pi * 1200.0 * t)).astype(np.float32)
    mel = tmel.mel_spectrogram(torch.from_numpy(wav)[None], sr, 1024, 256, 1024, 80, 0.0, 8000.0)
    lin = tmel.mel_to_linear(mel, sr).numpy()
    ref = tstft.stft_magnitude(torch.from_numpy(wav)[None], 1024, 256, 1024).numpy()
    top_ref = np.argsort(ref.sum(-1)[0])[-4:]
    top_inv = np.argsort(lin.sum(-1)[0])[-4:]
    assert len(set(top_ref) & set(top_inv)) >= 2
