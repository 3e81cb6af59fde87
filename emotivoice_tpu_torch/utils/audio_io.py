"""Waveform I/O for the port (counterpart of
`emotivoice_tpu/utils/audio_io.py`: `read_wav`, `write_wav`,
`trim_silence`, `wav_stream_header`, `pcm16_bytes`; scipy / numpy paths
only, the native codec is not ported yet)."""

from __future__ import annotations

import struct

import numpy as np
from scipy.io import wavfile

MAX_WAV_VALUE = 32768.0


def _int16(wav: np.ndarray) -> np.ndarray:
    """float waveform in [-1, 1] -> int16 (reference scaling x32768)."""
    return np.clip(np.asarray(wav) * MAX_WAV_VALUE, -32768, 32767).astype("<i2")


def read_wav(path) -> tuple:
    """Returns (sample_rate, float32 waveform in [-1, 1]), channels averaged."""
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
    wavfile.write(path, sr, _int16(wav))


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
