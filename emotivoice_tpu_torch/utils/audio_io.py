"""Waveform I/O for the port (counterpart of
`emotivoice_tpu/utils/audio_io.py`: `read_wav`, `write_wav`,
`trim_silence`, `resample`, `wav_stream_header`, `pcm16_bytes`).

Decode, encode, trim and resample run in the port's native C++ codec
(`utils/native.py`) when it can be built, else in scipy / numpy;
`native.backend()` says which. The native calls take a path: a file object
(`io.BytesIO`, as the HTTP service writes) always takes the scipy path.
"""

from __future__ import annotations

import struct
from math import gcd

import numpy as np
from scipy.io import wavfile

from emotivoice_tpu_torch.utils import native

MAX_WAV_VALUE = 32768.0


def _int16(wav: np.ndarray) -> np.ndarray:
    """float waveform in [-1, 1] -> int16 (reference scaling x32768)."""
    return np.clip(np.asarray(wav) * MAX_WAV_VALUE, -32768, 32767).astype("<i2")


def read_wav(path) -> tuple:
    """Returns (sample_rate, float32 waveform in [-1, 1]), channels averaged."""
    if isinstance(path, str):
        got = native.read_wav(path)
        if got is not None:
            return got
    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        data = data.astype(np.float32) / MAX_WAV_VALUE
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    if data.ndim > 1:
        data = data.mean(axis=1)
    return sr, data


def trim_silence(wav: np.ndarray, sr: int, threshold: float = 0.005,
                 pad_ms: float = 50.0) -> np.ndarray:
    """Cut what lies outside the first and last sample above `threshold` x
    peak, keeping `pad_ms` on each side (reference prompt_dataset.py:39-46:
    0.5% of peak, 50 ms)."""
    trimmed = native.trim_silence(wav, sr, threshold, pad_ms)
    if trimmed is not None:
        return trimmed
    peak = np.abs(wav).max() if len(wav) else 0.0
    if peak <= 0:
        return wav
    above = np.where(np.abs(wav) > threshold * peak)[0]
    if len(above) == 0:
        return wav
    pad = int(sr * pad_ms / 1000.0)
    return wav[max(int(above[0]) - pad, 0):min(int(above[-1]) + pad, len(wav))]


def write_wav(path, wav: np.ndarray, sr: int = 16000):
    """Write a float waveform in [-1, 1] as int16 to a path or a binary
    file object (e.g. `io.BytesIO`)."""
    if isinstance(path, str) and native.write_wav(path, wav, sr):
        return
    wavfile.write(path, sr, _int16(wav))


def resample(wav: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """float32 waveform at sr_in -> sr_out: the native windowed-sinc
    resampler, or scipy's polyphase `resample_poly` without the library (two
    close but different functions). The corpus recipes resample to 16 kHz
    with it (the reference uses librosa, e.g.
    data/LJspeech/src/step1_clean_raw_data.py:44-48)."""
    if sr_in == sr_out:
        return np.asarray(wav, np.float32)
    out = native.resample(wav, sr_in, sr_out)
    if out is not None:
        return out
    from scipy.signal import resample_poly

    g = gcd(sr_out, sr_in)
    return resample_poly(np.asarray(wav, np.float32), sr_out // g, sr_in // g).astype(np.float32)


def wav_stream_header(sr: int = 16000, channels: int = 1, bits: int = 16) -> bytes:
    """RIFF/WAVE header with unknown (0xFFFFFFFF) data length, the streaming
    convention: players read PCM until the transport closes. Used by the
    HTTP streaming endpoint (serving/api.py)."""
    byte_rate = sr * channels * bits // 8
    block_align = channels * bits // 8
    return b"".join([
        b"RIFF", struct.pack("<I", 0xFFFFFFFF), b"WAVE",
        b"fmt ", struct.pack("<IHHIIHH", 16, 1, channels, sr, byte_rate,
                             block_align, bits),
        b"data", struct.pack("<I", 0xFFFFFFFF),
    ])


def pcm16_bytes(wav: np.ndarray) -> bytes:
    """float waveform in [-1, 1] -> raw little-endian int16 PCM bytes."""
    return _int16(wav).tobytes()
