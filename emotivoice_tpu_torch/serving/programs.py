"""One program per bucket for `SynthesisEngine` (counterpart of `_compiled`
in `emotivoice_tpu/serving/engine.py`: a `jax.jit` function per (text, mel)
bucket, re-specialised per batch shape, in an `lru_cache(maxsize=128)`).

On a CUDA replica a `BucketProgram` is one CUDA graph of the replica's
whole forward at one (rows, t_text, max_frames) key, on static input and
output buffers, so the several hundred launches of a call (both MRF kernels
among them) leave the host as one graph launch. A key's first call is the
eager forward on the caller's stream and inputs, whose outputs it returns,
so a bucket used once (a corpus run, the long tail of traffic) costs what
the eager forward does. Its second call captures the graph (a warm-up run
on a side stream, then the capture) and replays it, and every later call
replays. The engine's warmup captures right after the first call's forward
instead (`run(..., capture=True)`).
`alpha` is one of the inputs, a 0-d tensor, as it is a traced scalar in the
JAX program: every speed replays the bucket's graph. On a CPU replica the
same object runs the forward eagerly on the same buffers, captures nothing
and keeps no outputs. A capture or replay that fails raises; nothing falls
back to the eager forward on the card.

What a replay reads, and what keeps it right:

- The replica's parameters and buffers at their addresses of capture time.
  The forward folds the weight norm and casts to the compute dtype at each
  call, inside the graph, so an in-place update (`load_state_dict`,
  `param.data.copy_`) is seen by the next replay. A parameter or buffer
  that moved (a replaced `Parameter`, `.to()`) makes the program stale and
  `ProgramCache` rebuilds it: the MRF kernels' TMA maps were encoded on the
  host with the old addresses. A program watches the (module, name) slots
  the replica had when it was built; a replaced submodule is not seen.
- The kernel launch counters: a capture tallies the kernels it records
  without counting them (`build.capturing_launches`), and each replay adds
  the tally to the wrappers' `launches`.
- Memory: the programs of one replica share one graph pool. A later
  capture may place its intermediates where an earlier graph's outputs
  lie, so a program's outputs hold only until another program of the pool
  replays. The engine replays one replica's programs one at a time, under
  its run lock, and copies each output to the host before it releases it.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from emotivoice_tpu_torch.ops.cuda import build

MAX_PROGRAMS = 128  # per replica, as the JAX engine's lru_cache(maxsize=128)

Key = Tuple[int, int, int]  # (rows, t_text, max_frames)

_card_locks: Dict[torch.device, threading.Lock] = {}
_side_streams: Dict[torch.device, torch.cuda.Stream] = {}
_per_card_guard = threading.Lock()


def _card(device: torch.device) -> torch.device:
    if device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _card_lock(device: torch.device) -> threading.Lock:
    """One capture (with its warm-up run) at a time on a card's side
    stream: work that another thread put on a stream while it is capturing
    would break the capture. Replicas and engines on the card take turns."""
    with _per_card_guard:
        return _card_locks.setdefault(_card(device), threading.Lock())


def _side_stream(device: torch.device) -> torch.cuda.Stream:
    """The stream every program on a card warms up and captures on, one for
    the process: the caching allocator reuses a block only on the stream
    that freed it, so the blocks one capture's warm-up run freed serve the
    next one's, in any engine, and a replica's captures share its pool's
    memory."""
    device = _card(device)
    with _per_card_guard:
        if device not in _side_streams:
            _side_streams[device] = torch.cuda.Stream(device)
        return _side_streams[device]


def _weight_slots(model: nn.Module):
    return [(slots, name) for mod in model.modules()
            for slots in (mod._parameters, mod._buffers) for name in slots]


def _addresses(slots) -> list:
    out = []
    for d, name in slots:
        t = d.get(name)
        out.append(None if t is None else (id(t), t.data_ptr()))
    return out


class BucketProgram:
    """The forward of `model` (one replica, on `device`) at one key, on
    static buffers: a CUDA graph on a card, eager on the CPU. On a card
    `pool` is the graph pool of the replica's programs. `run` is not
    thread-safe; the caller serializes the programs of a replica."""

    def __init__(self, model: nn.Module, key: Key, device: torch.device, dtype: torch.dtype,
                 pool=None):
        rows, t_text, self.max_frames = key
        self.key, self.model, self.device, self.dtype = key, model, device, dtype
        self.pool = pool
        self.stream = _side_stream(device) if device.type == "cuda" else None
        d = model.cfg.am.bert_embedding
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.ran = False  # the key's first call, the eager forward, is done
        self.launches: Dict[object, int] = {}  # kernel wrapper -> launches per replay
        self.outputs: Optional[Dict[str, torch.Tensor]] = None  # the graph's static outputs
        self.capture_seconds: Optional[float] = None
        self._slots = _weight_slots(model)
        self._addresses = _addresses(self._slots)
        with torch.inference_mode():
            ids = dict(dtype=torch.long, device=device)
            emb = dict(dtype=torch.float32, device=device)
            self.inputs = (torch.zeros(rows, t_text, **ids), torch.ones(rows, **ids),
                           torch.zeros(rows, **ids), torch.zeros(rows, d, **emb),
                           torch.zeros(rows, d, **emb))
            self.alpha = torch.ones((), **emb)

    def _forward(self) -> Dict[str, torch.Tensor]:
        return self.model(*self.inputs, max_frames=self.max_frames, alpha=self.alpha,
                          dtype=self.dtype)

    def capture(self) -> None:
        """Capture the forward into the program's graph: on a card, once.
        First a warm-up run on the side stream, where cuDNN and cuBLAS
        choose their algorithms and workspaces for it, then the capture on
        that stream. Raises if the capture fails."""
        if self.stream is None or self.graph is not None:
            return
        start = time.perf_counter()
        current = torch.cuda.current_stream(self.device)
        with torch.cuda.device(self.device), _card_lock(self.device):
            self.stream.wait_stream(current)
            with torch.cuda.stream(self.stream):
                self._forward()
            graph = torch.cuda.CUDAGraph()
            # thread_local: other threads (the style encoder, another engine)
            # may use the card while this one captures.
            with build.capturing_launches() as tally, torch.cuda.graph(
                    graph, pool=self.pool, stream=self.stream,
                    capture_error_mode="thread_local"):
                outputs = self._forward()
            current.wait_stream(self.stream)
        self.graph, self.launches, self.outputs = graph, tally, outputs
        self.capture_seconds = time.perf_counter() - start

    def stale(self) -> bool:
        """Whether a parameter or buffer of the replica moved since the build."""
        return _addresses(self._slots) != self._addresses

    def replay(self) -> None:
        """Launch the captured graph once and count the kernels it holds."""
        self.graph.replay()
        build.add_launches(self.launches)

    def run(self, arrays: Sequence[np.ndarray], alpha: float,
            capture: bool = False) -> Tuple[np.ndarray, np.ndarray]:
        """One bucket: (tokens, lengths, speaker, style, content) numpy in,
        (wav_predictions, output_lengths) numpy out. The first call is the
        eager forward on the caller's stream; on a card the second captures
        (or the first, after its forward, with `capture`), and every call
        after the capture replays."""
        with torch.inference_mode():
            for buf, a in zip(self.inputs, arrays):
                a = torch.as_tensor(a)
                if a.shape != buf.shape:
                    raise ValueError(f"bucket {self.key}: input of shape {tuple(a.shape)} for a "
                                     f"buffer of {tuple(buf.shape)}")
                buf.copy_(a)
            self.alpha.fill_(float(alpha))
            if self.ran:
                self.capture()
            if self.graph is not None:
                self.replay()
                out = self.outputs
            else:
                out = self._forward()
                self.ran = True
                if capture:
                    self.capture()
            return out["wav_predictions"].cpu().numpy(), out["output_lengths"].cpu().numpy()


class ProgramCache:
    """The programs of one replica by key, least recently used first out
    past MAX_PROGRAMS; a stale program is rebuilt before it runs.
    `build(key)` makes a program; `pool` is the graph pool its programs
    share (None on the CPU)."""

    def __init__(self, build: Callable[[Key], BucketProgram], pool=None):
        self._build = build
        self.pool = pool
        self._programs: "collections.OrderedDict[Key, BucketProgram]" = collections.OrderedDict()
        self.builds = 0  # programs built, rebuilds included
        self.rebuilds = 0  # of those, stale programs built again

    def __len__(self) -> int:
        return len(self._programs)

    def keys(self):
        return list(self._programs)

    def get(self, key: Key) -> BucketProgram:
        prog = self._programs.pop(key, None)
        if prog is not None and prog.stale():
            prog = None  # its graph goes before the new one is captured
            self.rebuilds += 1
        if prog is None:
            prog = self._build(key)
            self.builds += 1
        self._programs[key] = prog
        while len(self._programs) > MAX_PROGRAMS:
            self._programs.popitem(last=False)
        return prog

    def capture_seconds(self) -> Dict[Key, float]:
        """Each kept program's capture time, of those captured."""
        return {k: p.capture_seconds for k, p in self._programs.items()
                if p.capture_seconds is not None}

    def pool_bytes(self) -> int:
        """Bytes of the card's memory the allocator holds in the pool."""
        if self.pool is None:
            return 0
        return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
                   if tuple(s["segment_pool_id"]) == tuple(self.pool))
