"""Waveform output for the port (counterpart of
`emotivoice_tpu/utils/audio_io.py`: `write_wav`, `wav_stream_header`,
`pcm16_bytes`; scipy path only, the native codec is not ported yet)."""

from __future__ import annotations

import struct

import numpy as np
from scipy.io import wavfile

MAX_WAV_VALUE = 32768.0


def _int16(wav: np.ndarray) -> np.ndarray:
    """float waveform in [-1, 1] -> int16 (reference scaling x32768)."""
    return np.clip(np.asarray(wav) * MAX_WAV_VALUE, -32768, 32767).astype("<i2")


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
