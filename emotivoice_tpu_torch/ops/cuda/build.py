"""Build and load the port's hand-written CUDA kernels.

Every `emotivoice_tpu_torch/csrc/*.cu` is compiled at first use with
`nvcc -gencode arch=compute_90a,code=sm_90a -O3` (one nvcc per source, all
started together), linked into `build/torch_kernels/libemotivoice_kernels.so`
at the repository root, and loaded with ctypes. The sources have a plain C
interface and include no PyTorch header, so a build takes seconds. A stamp
of the sources' and flags' hash lets a later process reuse the library.
"""

from __future__ import annotations

import contextlib
import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Optional

PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build", "torch_kernels")
LIB_NAME = "libemotivoice_kernels.so"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_count_lock = threading.Lock()
_capture = threading.local()  # .tally: launches recorded by a CUDA graph capture on this thread
_lib: Optional[ctypes.CDLL] = None
build_log = ""  # nvcc's output of the last build in this process (ptxas -v)
build_seconds = 0.0  # wall time of that build (0 when the library was reused)


def find_nvcc() -> str:
    """nvcc from CUDA_HOME, /usr/local/cuda/bin or PATH; raises if absent."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin, PATH); "
        "the port's CUDA kernels are built from source at first use"
    )


def _sources():
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(glob.glob(os.path.join(CSRC_DIR, "*"))):
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + f.read())
    return h.hexdigest()


def build() -> str:
    """Compile the sources into the shared library unless an up-to-date one
    exists; returns the library's path."""
    global build_log, build_seconds
    lib_path = os.path.join(BUILD_DIR, LIB_NAME)
    stamp = os.path.join(BUILD_DIR, "sources.sha256")
    digest = _digest()
    if os.path.exists(lib_path) and os.path.exists(stamp):
        with open(stamp) as f:
            if f.read().strip() == digest:
                build_seconds = 0.0
                return lib_path
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    start = time.perf_counter()
    procs = []
    for src in _sources():
        obj = os.path.join(BUILD_DIR, os.path.basename(src)[:-3] + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-I", CSRC_DIR, "-c", src, "-o", obj]
        procs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs = []
    for cmd, _, p in procs:
        out, _ = p.communicate()
        logs.append(out)
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n{out}")
    tmp = lib_path + f".tmp{os.getpid()}"
    cmd = [nvcc, "-shared", "-o", tmp, *[obj for _, obj, _ in procs], "-lcudart"]
    res = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({' '.join(cmd)}):\n{res.stdout}")
    os.replace(tmp, lib_path)
    with open(stamp, "w") as f:
        f.write(digest)
    build_log = "".join(logs) + res.stdout
    build_seconds = time.perf_counter() - start
    return lib_path


def _declare(lib: ctypes.CDLL) -> None:
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    pi = ctypes.POINTER(i32)
    lib.evt_residual_unit_bf16.argtypes = [vp] * 6 + [i32] * 11 + [vp]
    lib.evt_residual_unit_f32.argtypes = [vp] * 5 + [i32] * 11 + [vp]
    lib.evt_mrf_stage_bf16.argtypes = [vp, vp, ctypes.POINTER(vp), pi, pi, pi] + [i32] * 10 + [vp]
    lib.evt_mrf_stage_f32.argtypes = ([vp, vp, vp, i32, ctypes.POINTER(vp), pi, pi, pi, pi, pi]
                                      + [i32] * 10 + [vp])
    lib.evt_attention_bf16.argtypes = [vp] * 5 + [i32] * 4 + [ctypes.c_float, vp]
    lib.evt_attention_f32.argtypes = [vp] * 5 + [i32] * 4 + [ctypes.c_float, vp]
    lib.evt_aa_snake_bf16.argtypes = [vp] * 6 + [i32] * 3 + [vp]
    lib.evt_aa_snake_f32.argtypes = [vp] * 6 + [i32] * 3 + [vp]
    for fn in (lib.evt_residual_unit_bf16, lib.evt_residual_unit_f32, lib.evt_mrf_stage_bf16,
               lib.evt_mrf_stage_f32, lib.evt_attention_bf16, lib.evt_attention_f32,
               lib.evt_aa_snake_bf16, lib.evt_aa_snake_f32):
        fn.restype = i32
    lib.evt_error_string.argtypes = [i32]
    lib.evt_error_string.restype = ctypes.c_char_p


def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library once per process."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            _declare(lib)
            _lib = lib
        return _lib


def count_launch(wrapper) -> None:
    """Add one to a kernel wrapper's `launches` counter. The lock keeps the
    count exact when several threads (engine replicas) launch at once.
    Inside `capturing_launches` on this thread the launch was recorded into
    a CUDA graph, not run: it goes to the capture's tally, which each replay
    adds (`add_launches`)."""
    tally = getattr(_capture, "tally", None)
    if tally is not None:
        tally[wrapper] = tally.get(wrapper, 0) + 1
        return
    with _count_lock:
        wrapper.launches += 1


@contextlib.contextmanager
def capturing_launches():
    """Around a CUDA graph capture on this thread: yields the tally
    {wrapper: launches} of the kernels the capture records."""
    _capture.tally = tally = {}
    try:
        yield tally
    finally:
        _capture.tally = None


def capturing() -> bool:
    """Whether this thread is inside `capturing_launches`."""
    return getattr(_capture, "tally", None) is not None


def add_launches(tally) -> None:
    """Count one replay of a captured graph: its tally onto the wrappers."""
    with _count_lock:
        for wrapper, n in tally.items():
            wrapper.launches += n


def check(err: int, name: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        msg = load().evt_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")
