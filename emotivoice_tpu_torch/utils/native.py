"""ctypes bindings for the port's native C++ audio codec
(`emotivoice_tpu_torch/native/audio_io.cc`; counterpart of
`emotivoice_tpu/utils/native.py`, same C entry points and argument types).

The library is compiled with g++ at first use into
`build/torch_native/libemotivoice_audio.so` at the repository root, and
reused while a stamp of the source's and flags' hash matches. Processes may
build at once: each takes an exclusive `fcntl` lock on the build
directory's lock file, compiles to a name of its own and `os.replace`s the
result into place, so no process can load a half-written library.

Without a compiler on PATH `load()` returns None and every call site in
`audio_io.py` falls back to scipy / numpy, as the JAX package's does; a
compiler that fails on the source raises. `backend()` says which of the two
the dispatching functions use in this process.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional

import numpy as np

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(PKG_DIR, "native", "audio_io.cc")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build", "torch_native")
LIB_NAME = "libemotivoice_audio.so"
CXX_FLAGS = ["-O3", "-fPIC", "-Wall", "-Wextra", "-std=c++17", "-shared"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False

_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")


def _digest() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return h.hexdigest()


def build() -> Optional[str]:
    """Compile the source unless an up-to-date library exists; its path, or
    None when no g++ is on PATH. Raises if the compiler fails."""
    cxx = shutil.which("g++")
    if cxx is None:
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    lib_path = os.path.join(BUILD_DIR, LIB_NAME)
    stamp = os.path.join(BUILD_DIR, "source.sha256")
    digest = _digest()
    with open(os.path.join(BUILD_DIR, "lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if os.path.exists(lib_path) and os.path.exists(stamp):
            with open(stamp) as f:
                if f.read().strip() == digest:
                    return lib_path
        tmp = f"{lib_path}.tmp{os.getpid()}"
        cmd = [cxx, *CXX_FLAGS, "-o", tmp, SOURCE]
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed ({' '.join(cmd)}):\n{res.stderr}")
        os.replace(tmp, lib_path)
        with open(stamp + ".tmp", "w") as f:
            f.write(digest)
        os.replace(stamp + ".tmp", stamp)
    return lib_path


def _declare(lib: ctypes.CDLL) -> None:
    lib.ev_wav_info.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_long),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.ev_wav_info.restype = ctypes.c_int
    lib.ev_wav_read.argtypes = [ctypes.c_char_p, _f32p, ctypes.c_long]
    lib.ev_wav_read.restype = ctypes.c_int
    lib.ev_wav_write.argtypes = [ctypes.c_char_p, _f32p, ctypes.c_long, ctypes.c_int]
    lib.ev_wav_write.restype = ctypes.c_int
    lib.ev_trim_silence.argtypes = [
        _f32p, ctypes.c_long, ctypes.c_int, ctypes.c_float, ctypes.c_float,
        ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_long),
    ]
    lib.ev_trim_silence.restype = None
    lib.ev_resample_len.argtypes = [ctypes.c_long, ctypes.c_int, ctypes.c_int]
    lib.ev_resample_len.restype = ctypes.c_long
    lib.ev_resample.argtypes = [
        _f32p, ctypes.c_long, ctypes.c_int, ctypes.c_int, _f32p, ctypes.c_long,
    ]
    lib.ev_resample.restype = ctypes.c_int


def load() -> Optional[ctypes.CDLL]:
    """The shared library, or None without a compiler. Thread-safe, cached
    for the process."""
    global _lib, _tried
    with _lock:
        if not _tried:
            path = build()
            if path is not None:
                lib = ctypes.CDLL(path)
                _declare(lib)
                _lib = lib
            _tried = True
        return _lib


def available() -> bool:
    return load() is not None


def backend() -> str:
    """'native' when the dispatching functions of `audio_io` run the C++
    library, 'scipy' when they fall back to scipy / numpy."""
    return "native" if available() else "scipy"


def read_wav(path: str):
    """Native wav decode + mono mix. Returns (sr, float32 wav) or None."""
    lib = load()
    if lib is None:
        return None
    sr = ctypes.c_int()
    n = ctypes.c_long()
    ch = ctypes.c_int()
    if lib.ev_wav_info(path.encode(), ctypes.byref(sr), ctypes.byref(n), ctypes.byref(ch)):
        return None
    out = np.empty(n.value, np.float32)
    if lib.ev_wav_read(path.encode(), out, n.value):
        return None
    return sr.value, out


def write_wav(path: str, wav: np.ndarray, sr: int) -> bool:
    lib = load()
    if lib is None:
        return False
    wav = np.ascontiguousarray(np.asarray(wav, np.float32).reshape(-1))
    return lib.ev_wav_write(path.encode(), wav, len(wav), sr) == 0


def trim_silence(wav: np.ndarray, sr: int, threshold: float = 0.005, pad_ms: float = 50.0):
    """The trimmed view, or None when the library is absent."""
    lib = load()
    if lib is None:
        return None
    wav = np.ascontiguousarray(np.asarray(wav, np.float32))
    start = ctypes.c_long()
    end = ctypes.c_long()
    lib.ev_trim_silence(wav, len(wav), sr, threshold, pad_ms,
                        ctypes.byref(start), ctypes.byref(end))
    return wav[start.value:end.value]


def resample(wav: np.ndarray, sr_in: int, sr_out: int):
    """Windowed-sinc resample, or None when the library is absent."""
    lib = load()
    if lib is None:
        return None
    wav = np.ascontiguousarray(np.asarray(wav, np.float32))
    n_out = lib.ev_resample_len(len(wav), sr_in, sr_out)
    out = np.empty(n_out, np.float32)
    if lib.ev_resample(wav, len(wav), sr_in, sr_out, out, n_out):
        return None
    return out
