"""What the readers of the program's own spans share (`metrics/<name>.py`
whose source is "program_span"): the spans `emotivoice_tpu_torch.serving.
tracing` records while a profiler runs, which in a `--trace 1` run are the
traced sub-window's and those of the calls that drain after it.

A reader takes the spans that lie inside the traced sub-window, from the
first start to the last end of `view.traced_dispatches` (the same
`perf_counter` clock, in ns there), and returns None where there are none:
a run without `--trace 1`, or a program that records no spans.
"""

from __future__ import annotations

import importlib
import statistics
from typing import Dict, Iterable, List, Optional

CALL = "engine.call"
HOST = ("engine.prepare", "engine.results")
ACOUSTIC = ("encoder", "variance", "decoder")  # device parts of program.run
VOCODER = ("vocoder",)


def recorded() -> Optional[list]:
    """Every span the program kept, or None where it keeps none."""
    try:
        tracing = importlib.import_module("emotivoice_tpu_torch.serving.tracing")
    except ImportError:  # a program without spans
        return None
    return tracing.spans()


def _window(view, spans: list) -> list:
    lo = min(d.t0 for d in view.traced_dispatches) * 1e9
    hi = max(d.t1 for d in view.traced_dispatches) * 1e9
    return [s for s in spans if lo <= s.start_ns and s.end_ns <= hi]


def in_window(view) -> Optional[list]:
    if not view.traced_dispatches:
        return None
    spans = recorded()
    return _window(view, spans) if spans else None


def _median(values: Iterable[float]) -> Optional[float]:
    values = list(values)
    return statistics.median(values) if values else None


def _top_call(span, by_id: Dict[int, object]) -> Optional[int]:
    """The id of the outermost engine.call above `span` (or `span` itself)."""
    top = span.id if span.name == CALL else None
    p = by_id.get(span.parent)
    while p is not None:
        if p.name == CALL:
            top = p.id
        p = by_id.get(p.parent)
    return top


def calls(view) -> Optional[Dict[int, Dict]]:
    """The outermost engine calls inside the traced sub-window, by id, each
    with its `call` span, the spans below it (`below`) and the batcher's
    fan-out of its results (`fan_out`, wherever it lies)."""
    if not view.traced_dispatches:
        return None
    spans = recorded()
    if not spans:
        return None
    by_id = {s.id: s for s in spans}
    out = {s.id: {"call": s, "below": [], "fan_out": []} for s in _window(view, spans)
           if s.name == CALL and _top_call(s, by_id) == s.id}
    for s in spans:
        if s.name == "batcher.fan_out":
            if s.attrs.get("call") in out:
                out[s.attrs["call"]]["fan_out"].append(s)
        elif s.name != CALL or s.id not in out:
            top = _top_call(s, by_id)
            if top in out and top != s.id:
                out[top]["below"].append(s)
    return out or None


def queue_wait_ms(view) -> Optional[float]:
    """Median of the requests' `batcher.wait`: arrival on the batcher's
    queue to the hand-off of their batch to the engine."""
    spans = in_window(view)
    return _median(s.ms for s in spans or () if s.name == "batcher.wait")


def host_ms_per_call(view, fan_out: bool) -> Optional[float]:
    """Median over the engine calls of their host work: encoding, bucket
    choice and padding (`engine.prepare`), slicing the rows into results
    (`engine.results`), and with `fan_out` handing them to the futures."""
    cs = calls(view)
    return _median(
        sum(s.ms for s in c["below"] if s.name in HOST)
        + (sum(s.ms for s in c["fan_out"]) if fan_out else 0.0)
        for c in (cs or {}).values())


def copy_out_ms(view) -> Optional[float]:
    """Median of `program.run`'s device ms copying the waveform and frame
    counts to the host."""
    spans = in_window(view)
    return _median(s.attrs["copy_out"] for s in spans or ()
                   if s.name == "program.run" and "copy_out" in s.attrs)


def _audio_s(view, frames: int) -> float:
    hop = 1
    for r in view.cfg["vocoder"]["upsample_rates"]:
        hop *= int(r)
    return frames * hop / view.cfg["audio"]["sampling_rate"]


def device_ms_per_audio_s(view, parts: List[str]) -> Optional[float]:
    """The device ms of `parts` over the engine calls' `program.run`s, per
    second of audio those calls delivered; a call with a run not timed (a
    capture) is left out whole."""
    cs = calls(view)
    ms = audio = 0.0
    for c in (cs or {}).values():
        runs = [s for s in c["below"] if s.name == "program.run"]
        if not runs or any(p not in r.attrs for r in runs for p in parts):
            continue
        ms += sum(r.attrs[p] for r in runs for p in parts)
        audio += _audio_s(view, int(c["call"].attrs.get("frames", 0)))
    return ms / audio if audio > 0 else None
