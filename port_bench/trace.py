"""Reads a `torch.profiler` trace of a traced sub-window: the device's busy
time as the union of its operations' intervals (kernels, copies, sets), so
overlapping operations are not counted twice, each kernel's device time by
name, and the idle gaps, each named by the benchmark's innermost span
(`probe.Probe`) that covered it on the host.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

WINDOW = "port_bench.traced_window"
OUTSIDE = "outside the engine (client loop, batcher queue)"


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    device_ops: List[Tuple[str, float]]  # name -> seconds, most first
    idle_gaps: List[Tuple[str, float]]  # the longest gaps, what the host was doing
    op_seconds: Dict[str, float]  # every device operation's seconds by name


def profiler():
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _label(t: float, spans: List[Tuple[float, float, str]]) -> str:
    inner: Optional[Tuple[float, float, str]] = None
    for a, b, name in spans:
        if a <= t <= b and (inner is None or b - a < inner[1] - inner[0]):
            inner = (a, b, name)
    return inner[2] if inner else OUTSIDE


def summarize(events, top: int = 10) -> Optional[TraceSummary]:
    """`events` as `prof.events()` gives them (times in microseconds).
    None when the trace holds no window span or no device operation."""
    from torch.autograd import DeviceType

    window = [e for e in events if e.name == WINDOW]
    # the device's operations; a record_function range also appears on the
    # device's timeline, as an annotation, and is no operation
    device = [e for e in events if e.device_type == DeviceType.CUDA
              and not e.name.startswith("port_bench.")]
    if not window or not device:
        return None
    w0, w1 = window[0].time_range.start, window[0].time_range.end
    spans = [(e.time_range.start, e.time_range.end, e.name) for e in events
             if e.name.startswith("port_bench.") and e.name != WINDOW]
    by_name: Dict[str, float] = collections.defaultdict(float)
    intervals = []
    for e in device:
        a, b = max(e.time_range.start, w0), min(e.time_range.end, w1)
        if b > a:
            intervals.append((a, b))
            by_name[e.name] += (b - a) / 1e6
    busy = union(intervals)
    gaps = []
    edge = w0
    for a, b in busy + [(w1, w1)]:
        if a > edge:
            gaps.append((a - edge, _label((a + edge) / 2, spans)))
        edge = max(edge, b)
    gaps.sort(reverse=True)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])
    return TraceSummary(
        window_s=(w1 - w0) / 1e6,
        busy_s=sum(b - a for a, b in busy) / 1e6,
        device_ops=ops[:top],
        idle_gaps=[(name, g / 1e6) for g, name in gaps[:top]],
        op_seconds=dict(by_name),
    )


def kernel_seconds(summary: TraceSummary, fragment: str) -> float:
    """Device seconds of the operations whose name holds `fragment`."""
    return sum(s for name, s in summary.op_seconds.items() if fragment in name)


def warm_profiler(device) -> None:
    """One short trace in set-up, so the profiler's first start (CUPTI's
    set-up) is not paid inside the window."""
    with profiler():
        torch.ones(8, device=device).sum().item()
