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

The copy to the host (`HostStaging`): on a card only each row's delivered
samples cross, its first n_frames x hop, into one pinned host buffer that
the replica's programs share and reuse, and from there into a zeroed array
the caller owns, whose memory is reused once the caller has dropped it.
The padded tail of a bucket (three quarters of its samples in the served
traffic) never leaves the card.
"""

from __future__ import annotations

import collections
import contextlib
import gc
import threading
import time
import weakref
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from emotivoice_tpu_torch.ops.cuda import build
from emotivoice_tpu_torch.serving import tracing
from emotivoice_tpu_torch.utils import marks

MAX_PROGRAMS = 128  # per replica, as the JAX engine's lru_cache(maxsize=128)

Key = Tuple[int, int, int]  # (rows, t_text, max_frames)

_card_locks: Dict[torch.device, threading.Lock] = {}
_side_streams: Dict[torch.device, torch.cuda.Stream] = {}
_per_card_guard = threading.Lock()
_collector_guard = threading.Lock()
_collector_holds = [0, False]  # captures under way, whether the collector was on before the first


@contextlib.contextmanager
def _collector_paused():
    """Python's cyclic garbage collector off while any thread captures. A
    program no longer referenced (an engine deleted, a stale program
    replaced) holds its CUDA graph until a collection frees the cycle; a
    collection in the middle of a capture destroys that graph there, which
    is not permitted while a stream captures and invalidates the capture."""
    with _collector_guard:
        if _collector_holds[0] == 0:
            _collector_holds[1] = gc.isenabled()
            gc.disable()
        _collector_holds[0] += 1
    try:
        yield
    finally:
        with _collector_guard:
            _collector_holds[0] -= 1
            if _collector_holds[0] == 0 and _collector_holds[1]:
                gc.enable()


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


class _Lease:
    """The owner of a result buffer while the caller holds arrays of it:
    numpy reaches the memory through `__array_interface__`, and every array
    made from it keeps the lease alive, so the lease dies with the last."""

    __slots__ = ("buffer", "__array_interface__", "__weakref__")

    def __init__(self, buffer: np.ndarray):
        self.buffer = buffer
        self.__array_interface__ = dict(shape=buffer.shape, typestr=buffer.dtype.str,
                                        data=(buffer.ctypes.data, False), version=3)


class HostStaging:
    """Where one replica's waveforms cross to the host. `copy_out` copies
    each row's first n_frames x hop samples into one flat staging buffer,
    pinned when the waveform is on a card, packed row after row; the buffer
    grows to the largest bucket's waveform the replica has copied and is
    reused after. From there the samples go into a result buffer that the
    caller's arrays hold; once no array of it is left, the buffer comes back
    to be reused (at most `KEEP` wait), with only the spans the last call
    wrote zeroed again. Memory the process has written before costs a copy;
    fresh memory costs a page fault per page first written, which on a
    sandboxed host cost as much as the whole copy did. So the result buffer
    is made ready (zeroed, and a new one written through) before the wait
    for the card, while the card still runs the call.

    `copy_out` is not thread-safe: the engine's run lock serializes a
    replica's calls (a buffer may come back from any thread). `copy_bytes`
    and `bucket_bytes` sum, over the calls, the waveform bytes that crossed
    and those a copy of the whole padded waveform would have moved."""

    KEEP = 2  # result buffers kept for reuse

    def __init__(self):
        self.buffer: Optional[torch.Tensor] = None  # flat f32
        self.lengths: Optional[torch.Tensor] = None  # the frame counts, int64
        self.grows = 0  # allocations of `buffer`
        self.results = 0  # result buffers allocated
        self.copy_bytes = 0
        self.bucket_bytes = 0
        self._event: Optional[torch.cuda.Event] = None
        self._free: list = []  # (result buffer, the (start, end) spans it holds samples in)
        self._free_lock = threading.Lock()

    def _room(self, samples: int, rows: int, pin: bool) -> None:
        if self.buffer is None or self.buffer.numel() < samples:
            self.buffer = None  # the old one goes first
            self.buffer = torch.empty(samples, dtype=torch.float32, pin_memory=pin)
            self.grows += 1
        if self.lengths is None or self.lengths.numel() < rows:
            self.lengths = torch.empty(rows, dtype=torch.int64, pin_memory=pin)

    def _wait(self, stream) -> None:
        """Until the work on `stream` so far is done (nothing on the CPU)."""
        if stream is None:
            return
        if self._event is None:
            self._event = torch.cuda.Event()
        self._event.record(stream)
        self._event.synchronize()

    def _result(self, samples: int) -> np.ndarray:
        """A flat f32 buffer, its first `samples` zeros written (so copying
        into them takes no page fault), that no caller holds: one given back
        (one too small for this call is dropped) with the spans its last
        call wrote zeroed again, or a new one as large as the staging
        buffer."""
        with self._free_lock:
            buf = spans = None
            while self._free and buf is None:
                buf, spans = self._free.pop()
                if buf.size < samples:
                    buf = None
        if buf is None:
            self.results += 1
            buf = np.zeros(self.buffer.numel(), np.float32)
            spans = [(0, samples)]
        for a, b in spans:
            buf[a:b] = 0
        return buf

    def _give_back(self, buf: np.ndarray, spans: list) -> None:
        with self._free_lock:
            if len(self._free) < self.KEEP:
                self._free.append((buf, spans))

    def copy_out(self, wav: torch.Tensor, n_frames: torch.Tensor, max_frames: int,
                 mark: Optional[Callable[[], None]] = None) -> Tuple[np.ndarray, np.ndarray, int]:
        """(wav (B, max_frames x hop) f32, n_frames (B,)) numpy, arrays the
        caller owns (no later call writes them), and the waveform bytes
        copied. Row i holds its first n_frames[i] x hop samples of `wav` as
        they are and zeros after. On a card the frame counts come over first
        (one wait), then one copy per row on the card's current stream;
        `mark` is called once the last copy is on the stream, before the
        wait for it."""
        rows, width = wav.shape
        hop = width // max_frames
        pin = wav.device.type == "cuda"
        stream = torch.cuda.current_stream(wav.device) if pin else None
        self._room(rows * width, rows, pin)
        buf = self._result(rows * width)  # on the host while the card still computes
        lengths = self.lengths[:rows]
        lengths.copy_(n_frames, non_blocking=pin)
        self._wait(stream)
        n = lengths.numpy().copy()
        counts = np.clip(n, 0, max_frames) * hop
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        for i, (at, c) in enumerate(zip(starts, counts)):
            if c:
                self.buffer[at:at + c].copy_(wav[i, :c], non_blocking=pin)
        if mark is not None:
            mark()
        self._wait(stream)
        host = self.buffer.numpy()
        out = buf[:rows * width].reshape(rows, width)
        for i, (at, c) in enumerate(zip(starts, counts)):
            out[i, :c] = host[at:at + c]
        lease = _Lease(buf)
        weakref.finalize(lease, self._give_back, buf,
                         [(i * width, i * width + c) for i, c in enumerate(counts)]).atexit = False
        moved = int(counts.sum()) * 4
        self.copy_bytes += moved
        self.bucket_bytes += rows * width * 4
        return np.asarray(lease)[:rows * width].reshape(rows, width), n, moved


def to_host(wav: torch.Tensor, n_frames: torch.Tensor, max_frames: int, staging: HostStaging,
            mark: Optional[Callable[[], None]] = None) -> Tuple[np.ndarray, np.ndarray, Optional[int]]:
    """A forward's waveform and frame counts as numpy (`HostStaging.
    copy_out`), and the waveform bytes that crossed to the host. A CPU
    forward's outputs are on the host already: they are handed back as
    they are (the forward made them for this call), and None crossed."""
    if wav.device.type != "cpu":
        return staging.copy_out(wav, n_frames, max_frames, mark)
    out = wav.numpy(), n_frames.numpy(), None
    if mark is not None:
        mark()
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
        self.cache: Optional["ProgramCache"] = None  # counts this program's capture
        self.staging = HostStaging()  # its cache's, once in one
        # The model's marks (utils/marks.py) record these events: inside a
        # capture they become event-record nodes of the graph, always, so
        # the graph is the same whether or not a profiler runs. The events
        # around the model call are recorded only while one does. All of
        # them on the program's card (`_record`).
        self._card = _card(device) if device.type == "cuda" else None
        self._events: Dict[str, torch.cuda.Event] = {}
        if device.type == "cuda":
            self._events = {name: torch.cuda.Event(enable_timing=True, external=True)
                            for name in marks.MARKS}
            self._events.update({name: torch.cuda.Event(enable_timing=True)
                                 for name in ("start", "copied", "computed", "end")})
        self._slots = _weight_slots(model)
        self._addresses = _addresses(self._slots)
        with torch.inference_mode():
            ids = dict(dtype=torch.long, device=device)
            emb = dict(dtype=torch.float32, device=device)
            self.inputs = (torch.zeros(rows, t_text, **ids), torch.ones(rows, **ids),
                           torch.zeros(rows, **ids), torch.zeros(rows, d, **emb),
                           torch.zeros(rows, d, **emb))
            self.alpha = torch.ones((), **emb)

    def _record(self, name: str) -> None:
        """Record the event `name` on the current stream of the program's
        card, where its work runs: the calling thread's current card may be
        another (an engine's replica threads), and an event records only on
        the card it was first recorded on."""
        self._events[name].record(torch.cuda.current_stream(self._card))

    def _forward(self) -> Dict[str, torch.Tensor]:
        with marks.marking(self._record if self._events else None):
            return self.model(*self.inputs, max_frames=self.max_frames, alpha=self.alpha,
                              dtype=self.dtype)

    def _device_ms(self) -> Dict[str, float]:
        """Device milliseconds of the call's parts (tracing.DEVICE_PARTS),
        once the copy-out's event has completed."""
        ev = self._events
        order = ("start", "copied", *marks.MARKS, "computed", "end")
        return {part: ev[a].elapsed_time(ev[b])
                for part, a, b in zip(tracing.DEVICE_PARTS, order, order[1:])}

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
            with _collector_paused(), build.capturing_launches() as tally, torch.cuda.graph(
                    graph, pool=self.pool, stream=self.stream,
                    capture_error_mode="thread_local"):
                outputs = self._forward()
            current.wait_stream(self.stream)
        self.graph, self.launches, self.outputs = graph, tally, outputs
        self.capture_seconds = time.perf_counter() - start
        if self.cache is not None:
            self.cache.captures += 1

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
        (wav_predictions (rows, max_frames x hop) f32, output_lengths)
        numpy out, arrays the caller owns. On a card each row holds its
        first n_frames x hop samples and zeros after (`to_host`; the rest
        never leaves the card). The first call is the eager forward on the
        caller's stream; on a card the second captures (or the first, after
        its forward, with `capture`), and every call after the capture
        replays. While a profiler runs, records the span `program.run`
        (tracing), on a card with the waveform bytes copied and those of
        the whole bucket, and with the parts' device milliseconds where the
        call did not capture."""
        span = tracing.begin("program.run")
        timed = span is not None and bool(self._events)
        with torch.inference_mode():
            if timed:
                self._record("start")
            for buf, a in zip(self.inputs, arrays):
                a = torch.as_tensor(a)
                if a.shape != buf.shape:
                    raise ValueError(f"bucket {self.key}: input of shape {tuple(a.shape)} for a "
                                     f"buffer of {tuple(buf.shape)}")
                buf.copy_(a)
            self.alpha.fill_(float(alpha))
            replay = self.graph is not None
            if timed:
                self._record("copied")
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
            if timed:
                self._record("computed")
            kind = "replay" if replay else "capture" if self.graph is not None else "eager"
            # a capture's warm-up run moved the marks
            end = (lambda: self._record("end")) if timed and kind != "capture" else None
            wav, n_frames, moved = to_host(out["wav_predictions"], out["output_lengths"],
                                           self.max_frames, self.staging, end)
            if span is not None:
                if end is not None:
                    self._events["end"].synchronize()
                    span.attrs.update(self._device_ms())
                if moved is not None:
                    span.attrs.update(copy_bytes=moved, bucket_bytes=wav.nbytes)
                tracing.end(span, kind=kind)
            return wav, n_frames


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
        self.captures = 0  # CUDA graphs captured by its programs
        self.staging = HostStaging()  # the replica's copy to the host, shared by its programs

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
            prog.cache, prog.staging = self, self.staging
            self.builds += 1
        self._programs[key] = prog
        while len(self._programs) > MAX_PROGRAMS:
            self._programs.popitem(last=False)
        return prog

    @property
    def copy_bytes(self) -> int:
        """Waveform bytes its programs copied to the host (`HostStaging`)."""
        return self.staging.copy_bytes

    @property
    def bucket_bytes(self) -> int:
        """The bytes of the whole padded waveforms of those calls."""
        return self.staging.bucket_bytes

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
