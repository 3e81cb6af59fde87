"""The benchmark's spans around the engine's calls, and the outputs of the
timed path that it keeps for the check.

It wraps, on one `SynthesisEngine` instance, `synthesize_batch`,
`_dispatch` (one padded bucket: the rows it holds and the bucket they went
to), `run` (the model call: a CUDA graph replay, or the eager forward at a
bucket's first call) and the model's `forward` (whose outputs a bucket's
eager call returns). After each call in the window it copies, for the
requests the check may sample, what the program computed on the way to
the waveform: the log durations, the durations and the mel. With `tracing`
each span is also a `record_function` range, so a profiler trace shows what
the host was doing between the device's operations.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Dict, List, Optional, Set

import numpy as np
import torch


@dataclasses.dataclass
class Dispatch:
    rids: List[int]  # the requests of the bucket's rows, in row order
    rows: int  # the bucket's rows, padding rows included
    t_text: int
    max_frames: int
    t0: float
    t1: float = 0.0
    n_frames: List[int] = dataclasses.field(default_factory=list)
    built: bool = False  # the bucket's program was built by this call


@dataclasses.dataclass
class Kept:
    """What the program computed for one request, at its last dispatch."""

    t_text: int
    max_frames: int
    group: List[int]  # the requests of the batch it came in (the text bucket's reason)
    log_d: np.ndarray  # (t_text,)
    durations: np.ndarray  # (t_text,)
    mel: np.ndarray  # (max_frames, n_mels)


class Probe:
    def __init__(self, engine, flagged: Set[int], tracing: bool):
        self.engine = engine
        self.flagged = flagged
        self.tracing = tracing
        self.recording = False
        self.dispatches: List[Dispatch] = []
        self.kept: Dict[int, Kept] = {}
        self._local = threading.local()
        self._lock = threading.Lock()
        self._orig = {name: getattr(engine, name) for name in ("synthesize_batch", "_dispatch", "run")}
        self._orig_forward = engine.model.forward
        engine.synthesize_batch = self._synthesize_batch
        engine._dispatch = self._dispatch
        engine.run = self._run
        engine.model.forward = self._forward

    def span(self, name: str):
        if self.tracing:
            return torch.profiler.record_function("port_bench." + name)
        return contextlib.nullcontext()

    def _synthesize_batch(self, requests):
        self._local.group = [r.rid for r in requests]
        with self.span("batch"):
            return self._orig["synthesize_batch"](requests)

    def _dispatch(self, requests, token_ids, t_text, max_frames, alpha):
        rec = Dispatch([r.rid for r in requests], self.engine.padded_rows(len(requests)),
                       t_text, max_frames, time.perf_counter())
        self._local.rec = rec
        try:
            with self.span("dispatch"):
                results = self._orig["_dispatch"](requests, token_ids, t_text, max_frames, alpha)
        finally:
            self._local.rec = None
        rec.t1 = time.perf_counter()
        rec.n_frames = [r.n_frames for r in results]
        if self.recording:
            with self._lock:
                self.dispatches.append(rec)
        return results

    def _forward(self, *args, **kwargs):
        out = self._orig_forward(*args, **kwargs)
        forwards = getattr(self._local, "forwards", None)
        if forwards is not None:
            forwards.append(out)
        return out

    def _run(self, tokens, lengths, speaker, style, content, max_frames, alpha):
        key = (int(np.shape(tokens)[0]), int(np.shape(tokens)[1]), int(max_frames))
        cache = self.engine.programs[0]
        prog = cache._programs.get(key)  # a plain look, no LRU move
        ran_before = prog is not None and prog.ran
        builds = cache.builds
        self._local.forwards = []
        try:
            with self.span("run"):
                out = self._orig["run"](tokens, lengths, speaker, style, content, max_frames, alpha)
            rec = getattr(self._local, "rec", None)
            if rec is not None and self.recording:
                rec.built = cache.builds > builds
                prog = cache._programs[key]
                # a replay leaves its outputs in the graph's static buffers;
                # a bucket's first call returns those of its eager forward
                graph_out = prog.outputs if (ran_before and prog.graph is not None) else None
                self._keep(rec, graph_out if graph_out is not None else self._local.forwards[0])
        finally:
            self._local.forwards = None
        return out

    def _keep(self, rec: Dispatch, out) -> None:
        rows = [i for i, rid in enumerate(rec.rids) if rid in self.flagged]
        if not rows:
            return
        with self.span("keep_outputs"):
            idx = torch.tensor(rows, device=out["durations"].device)
            log_d = out["log_duration_predictions"].index_select(0, idx).float().cpu().numpy()
            dur = out["durations"].index_select(0, idx).float().cpu().numpy()
            mel = out["dec_outputs"].index_select(0, idx).float().cpu().numpy()
        group = getattr(self._local, "group", rec.rids)
        for j, i in enumerate(rows):
            self.kept[rec.rids[i]] = Kept(rec.t_text, rec.max_frames, list(group), log_d[j],
                                          dur[j], mel[j])

    def restore(self) -> None:
        for name, fn in self._orig.items():
            setattr(self.engine, name, fn)
        self.engine.model.forward = self._orig_forward
