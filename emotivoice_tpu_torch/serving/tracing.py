"""Spans of the serving path, recorded only while a
`torch.profiler` profile runs in the process.

A span is a named interval on `time.perf_counter_ns()` with its own id,
the id of the span open around it on the same thread (its parent), and a
few attributes. The batcher, the engine and the bucket programs open spans
at their boundaries:

- `batcher.wait`, one per request: from its arrival on the batcher's
  queue to the moment its batch is handed to the engine; `request`,
  `taken_ns` (when the batcher's worker took it off the queue) and `call`
  (the id of the `engine.call` it went into).
- `batcher.fan_out`, one per engine call: results handed to the futures;
  `call`.
- `engine.call`: one `SynthesisEngine.synthesize_batch`; `requests` (their
  ids) and `frames` (the frames it delivered).
- `engine.prepare`: encoding and bucket choice, and the host padding of
  each dispatch.
- `engine.results`: slicing a dispatch's rows into results.
- `program.run`: one `BucketProgram.run`; `kind` ("eager", "capture" or
  "replay"), and on a card `copy_bytes` (the waveform bytes that crossed to
  the host: each row's delivered samples), `bucket_bytes` (those of the
  whole padded waveform) and the device milliseconds of its parts
  (`DEVICE_PARTS`), from CUDA timing events read after the copy-out.

Recording is on exactly while the profiler runs (PyTorch's own flag for
fast checks, `torch.autograd.profiler._is_profiler_enabled`): there is no
other switch. Off, a boundary costs one read of that flag. Nothing here
adds a range to the profiler's timeline; `to_profiler_ns` maps a span's
time onto the profiler's clock instead.

The device parts come from CUDA events that a bucket program records where
the model marks the end of each part (`utils/marks.py`).
"""

from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import Callable, Dict, List, Optional

from torch.autograd import profiler as _profiler

MAX_SPANS = 1 << 16  # kept in memory; the oldest go first
# program.run's device milliseconds, in order along the stream
DEVICE_PARTS = ("copy_in", "encoder", "variance", "decoder", "vocoder", "copy_out")


class Span:
    __slots__ = ("name", "start_ns", "end_ns", "id", "parent", "attrs")

    def __init__(self, name: str, start_ns: int, parent: Optional[int], attrs: Dict):
        self.name, self.start_ns, self.end_ns = name, start_ns, start_ns
        self.id, self.parent, self.attrs = next(_ids), parent, attrs

    @property
    def ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, id={self.id}, parent={self.parent}, "
                f"{self.ms:.3f} ms, {self.attrs})")


_ids = itertools.count(1)
_lock = threading.Lock()
_spans: "collections.deque[Span]" = collections.deque(maxlen=MAX_SPANS)
_local = threading.local()  # .stack: open spans; .last: name -> id of the last ended
_offset_ns: Optional[int] = None  # time.time_ns() - perf_counter_ns(), taken at the first span
dropped = 0  # spans dropped from the front of the list


def recording() -> bool:
    """Whether a profiler runs in the process, so spans are recorded."""
    return _profiler._is_profiler_enabled


def _stack() -> List[Span]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _take_offset() -> None:
    """The offset of the profiler's clock (the Unix epoch, as
    `time.time_ns()`) from `perf_counter_ns()`: the closest of three
    readings bracketed by the latter."""
    global _offset_ns
    best = None
    for _ in range(3):
        a = time.perf_counter_ns()
        wall = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, wall - (a + b) // 2)
    _offset_ns = best[1]


def _keep(span: Span) -> None:
    global dropped
    with _lock:
        if _offset_ns is None:
            _take_offset()
        if len(_spans) == _spans.maxlen:
            dropped += 1
        _spans.append(span)


def begin(name: str, **attrs) -> Optional[Span]:
    """Open a span on this thread, or return None when nothing records."""
    if not _profiler._is_profiler_enabled:
        return None
    stack = _stack()
    span = Span(name, time.perf_counter_ns(), stack[-1].id if stack else None, attrs)
    stack.append(span)
    return span


def end(span: Optional[Span], **attrs) -> None:
    """Close `span` (from `begin`; None: nothing) with more attributes and
    keep it. Spans opened after it on this thread and left open (an
    exception passed through them) are closed with it and not kept."""
    if span is None:
        return
    span.end_ns = time.perf_counter_ns()
    span.attrs.update(attrs)
    stack = _stack()
    if span in stack:
        del stack[stack.index(span):]
    last = getattr(_local, "last", None)
    if last is None:
        last = _local.last = {}
    last[span.name] = span.id
    _keep(span)


def add(name: str, start_ns: int, end_ns: int, **attrs) -> None:
    """Keep a span whose times were taken elsewhere (no parent)."""
    span = Span(name, start_ns, None, attrs)
    span.end_ns = end_ns
    _keep(span)


def last_id(name: str) -> Optional[int]:
    """The id of the last span named `name` ended on this thread."""
    return getattr(_local, "last", {}).get(name)


def spans() -> List[Span]:
    """The kept spans, oldest first."""
    with _lock:
        return list(_spans)


def clear() -> None:
    """Drop every kept span; the next one takes the clock offset anew."""
    global dropped, _offset_ns
    with _lock:
        _spans.clear()
        dropped = 0
        _offset_ns = None


def to_profiler_ns(t_ns: int) -> int:
    """A `perf_counter_ns()` time on the profiler's clock: the Unix epoch
    in nanoseconds, as `prof.profiler.kineto_results.trace_start_ns()` plus
    an event's relative microseconds x 1000 gives it."""
    with _lock:
        if _offset_ns is None:
            _take_offset()
        return t_ns + _offset_ns


def carried(fn: Callable) -> Callable:
    """`fn`, to be called on another thread (an engine's replica threads):
    the spans it begins there have the span open here, if any, as their
    parent."""
    stack = getattr(_local, "stack", None)
    if not stack:
        return fn
    parent = stack[-1]

    def run(*args, **kwargs):
        inner = _stack()
        inner.append(parent)
        try:
            return fn(*args, **kwargs)
        finally:
            del inner[inner.index(parent):]
    return run
