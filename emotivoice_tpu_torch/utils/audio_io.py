"""Waveform output for the port (counterpart of
`emotivoice_tpu/utils/audio_io.py:write_wav`, scipy path only; the native
codec is not ported yet)."""

from __future__ import annotations

import numpy as np
from scipy.io import wavfile

MAX_WAV_VALUE = 32768.0


def write_wav(path: str, wav: np.ndarray, sr: int = 16000):
    """Write float waveform in [-1, 1] as int16 (reference scaling x32768)."""
    wav = np.asarray(wav)
    out = np.clip(wav * MAX_WAV_VALUE, -32768, 32767).astype(np.int16)
    wavfile.write(path, sr, out)
