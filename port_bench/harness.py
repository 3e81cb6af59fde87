"""One run of one cell: set-up, the measured window, the traced sub-window,
the check, and the result line.

Set-up builds the program's `SynthesisEngine` over a `JETSGenerator` at the
configuration's widths, loads the seeded weights (`weights.py`), generates
the traffic (`traffic.py`) and warms exactly the buckets that traffic
reaches (`engine.warmup`, which captures each bucket's CUDA graph), so no
program is built inside the window; builds that happen there anyway are
reported. The window is a closed loop through `synthesize_batch` or an open
loop through a `MicroBatcher`, as the mix says. With `--trace 1` a
sub-window in the middle of it runs under `torch.profiler`.
"""

from __future__ import annotations

import dataclasses
import gc
import sys
import time
from concurrent.futures import wait
from typing import Dict, List, Optional

import numpy as np
import torch

from port_bench import check, trace, traffic
from port_bench.probe import Probe
from port_bench.reference import buckets
from port_bench.spec import Cell, reader
from port_bench.weights import make_state_dict

TRACE_SECONDS = 4.0  # the traced sub-window: the window's last 4 s, or 40% of it
CLOSE_WAIT_S = 60.0  # how long an open loop waits for answers after the close
PRIME_S = 2.0  # seconds of an open loop's schedule run once in set-up
PRIME_CALLS = 6  # calls of a closed loop run once in set-up
FORBIDDEN = ("jax", "jaxlib", "flax", "emotivoice_tpu")


class NoDevice(RuntimeError):
    pass


def port_config(cfg: Dict):
    """The program's configuration object for a configuration file."""
    from emotivoice_tpu_torch.config import AcousticConfig, AudioConfig, EmotiVoiceConfig, VocoderConfig

    def tuples(d):
        return {k: (tuple(tuple(x) if isinstance(x, list) else x for x in v)
                    if isinstance(v, list) else v) for k, v in d.items()}

    return EmotiVoiceConfig(audio=AudioConfig(**tuples(cfg["audio"])),
                            am=AcousticConfig(**tuples(cfg["am"])),
                            vocoder=VocoderConfig(**tuples(cfg["vocoder"])))


def warm_shapes(mix: Dict, reqs: traffic.Requests) -> List[tuple]:
    """The (rows, text, mel) buckets the traffic reaches, by the frozen
    bucket rule: a closed loop's batches in corpus order, and the next mel
    bucket up for one or two rows whose frames reach theirs; an open loop's
    batches of any size up to max_batch at every text bucket its lengths
    reach, at their mel bucket and the next one up."""
    n_tok = np.array([len(t) for t in reqs.tokens])
    if mix["loop"] == "closed":
        b = int(mix["batch"])
        longest = {int(n_tok[i:i + b].max()) for i in range(0, len(n_tok) - b + 1, b)}
        texts = sorted({buckets.first_bucket(x, reqs.alpha) for x in longest})
        first = [(buckets.rows(b), t, m) for t, m in texts]
        again = [(r, t, buckets.next_mel(m)) for r in (1, 2) for t, m in texts
                 if buckets.next_mel(m) != m]
        return first + again
    texts = sorted({buckets.first_bucket(int(x), reqs.alpha) for x in np.unique(n_tok)})
    rows = sorted({buckets.rows(n) for n in range(1, int(mix["max_batch"]) + 1)})
    return [(r, t, mm) for r in rows for t, m in texts
            for mm in sorted({m, buckets.next_mel(m)})]


@dataclasses.dataclass
class RunView:
    """What a per-layer metric's reader reads (`metrics/<name>.py`)."""

    cfg: Dict
    dtype: str
    window_s: float
    completed: List[tuple]  # (tokens, frames) of each request finished in the window
    dispatches: list  # probe.Dispatch of the window
    batcher: Optional[Dict]  # {"dispatches", "requests"} of the window, open loop only
    trace: Optional[trace.TraceSummary]
    traced_dispatches: list  # the dispatches inside the traced sub-window


class Run:
    def __init__(self, cell: Cell, seed: int, seconds: float, tracing: bool, t_start: float,
                 device: str = "cuda", control: bool = False, log=print):
        self.cell, self.seed, self.seconds, self.tracing = cell, int(seed), float(seconds), tracing
        self.t_start, self.control, self.log = t_start, control, log
        self.cfg = cell.config
        self.mix = cell.traffic
        self.dtype = self.cfg["dtype"]
        if device == "cuda":
            if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
                raise NoDevice(f"cell {cell.name} needs {cell.chips} CUDA device(s); "
                               f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        self.device = torch.device(device)

    # ----------------------------------------------------------------- set-up
    def setup(self) -> None:
        from emotivoice_tpu_torch.frontend.tokens import TokenVocab
        from emotivoice_tpu_torch.models.jets import JETSGenerator
        from emotivoice_tpu_torch.serving.engine import SynthesisEngine, SynthesisRequest
        from emotivoice_tpu_torch.utils.device import use_exact_f32

        use_exact_f32(self.dtype)
        cfg = self.cfg
        self.reqs = traffic.generate(self.mix, cfg, self.seed, self.seconds)
        self.sd = make_state_dict(cfg, self.seed, self.device, self.reqs)
        with torch.device(self.device):
            model = JETSGenerator(port_config(cfg))
        model.to(self.device).load_state_dict(self.sd, strict=True)
        self.vocab = TokenVocab.from_tokens([f"t{i}" for i in range(cfg["am"]["n_vocab"])])
        self.engine = SynthesisEngine(model.cfg, model, self.vocab, dtype=self.dtype,
                                      device=self.device)
        n_tok = np.array([len(t) for t in self.reqs.tokens])
        self.n_tok = n_tok
        every = int(self.mix["check_every"])
        self.flagged = set(np.flatnonzero(traffic.flagged(n_tok, every, self.seed)).tolist())
        self.request = lambda i: self._request(SynthesisRequest, i)
        self.shapes = warm_shapes(self.mix, self.reqs)
        self.engine.warmup(self.shapes)
        self.batcher = None
        if self.mix["loop"] == "open":
            from emotivoice_tpu_torch.serving.batcher import MicroBatcher
            self.batcher = MicroBatcher(self.engine, max_batch=int(self.mix["max_batch"]),
                                        max_wait_ms=float(self.mix["max_wait_ms"]))
        self.probe = Probe(self.engine, self.flagged, self.tracing)
        # the loop itself once, over its first PRIME_S seconds of arrivals or
        # its first PRIME_CALLS calls, so first calls on the host are set-up too
        self.window(limit=int(np.searchsorted(self.reqs.due, PRIME_S)) if self.batcher
                    else PRIME_CALLS)
        if self.tracing and self.device.type == "cuda":
            trace.warm_profiler(self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        gc.collect()
        gc.freeze()
        self.setup_s = time.perf_counter() - self.t_start

    def _request(self, cls, i: int):
        r = self.reqs
        req = cls(phonemes=[f"t{x}" for x in r.tokens[i]], speaker_id=int(r.speaker[i]),
                  style_embedding=r.style[i], content_embedding=r.content[i], alpha=r.alpha)
        req.rid = i
        return req

    # ----------------------------------------------------------------- window
    def _trace_bounds(self):
        """The traced sub-window: the window's last seconds. The profiler
        stops, and reads its trace, only once the window's work is done."""
        return self.seconds - min(TRACE_SECONDS, 0.4 * self.seconds), self.seconds

    def window(self, limit: Optional[int] = None) -> None:
        """The measured window; with `limit`, an unrecorded rehearsal: an open
        loop's first `limit` requests, or a closed loop's `limit` calls."""
        self.done: Dict[int, tuple] = {}  # rid -> (t_done, n_frames)
        self.wavs: Dict[int, np.ndarray] = {}
        self.errors: Dict[int, str] = {}
        self.trace_summary = None
        self.traced = (0.0, 0.0)
        self.probe.recording = limit is None
        builds = self.engine.programs[0].builds
        if self.mix["loop"] == "closed":
            self._closed(limit)
        else:
            self._open(len(self.reqs) if limit is None else limit, limit is None)
        self.probe.recording = False
        self.builds = self.engine.programs[0].builds - builds

    def _closed(self, calls: Optional[int] = None) -> None:
        """The window; with `calls`, that many calls from the corpus's end,
        unrecorded."""
        b = int(self.mix["batch"])
        n = len(self.reqs)
        lo, hi = self._trace_bounds()
        prof = None
        seq = 0 if calls is None else n - calls * b
        t0 = time.perf_counter()
        self.t0 = t0
        while (time.perf_counter() - t0 < self.seconds) if calls is None else seq < n:
            el = time.perf_counter() - t0
            if self.tracing and calls is None and prof is None and el >= lo:
                prof, span = self._trace_start()
            batch = [self.request(i % n) for i in range(seq, seq + b)]
            for j, r in enumerate(batch):
                r.rid = seq + j
            seq += b
            try:
                results = self.engine.synthesize_batch(batch)
            except Exception as e:  # every request of the call failed
                for r in batch:
                    self.errors[r.rid] = repr(e)
                continue
            t = time.perf_counter()
            for r, res in zip(batch, results):
                self.done[r.rid] = (t, res.n_frames)
                if r.rid in self.flagged:
                    self.wavs[r.rid] = res.wav
        if prof is not None:
            self._trace_end(span)
            self._trace_finish(prof)
        self.attempted = seq if calls is None else calls * b
        self.t_end = max([t for t, _ in self.done.values()], default=time.perf_counter())

    def _open(self, n: int, measured: bool = True) -> None:
        """Each request handed to the micro-batcher at its due time by this
        one thread, as `MicroBatcher.submit` hands it (its queue, a
        future); the future's callback, run by the batcher's worker as it
        sets the result, takes the completion time."""
        from concurrent.futures import Future

        reqs = [self.request(i) for i in range(n)]
        due = self.reqs.due[:n]
        sent = np.zeros(n)
        futures = []

        def finished(i: int, fut: Future) -> None:
            t = time.perf_counter()
            err = fut.exception()
            if err is not None:
                self.errors[i] = repr(err)
                return
            res = fut.result()
            self.done[i] = (t, res.n_frames)
            if i in self.flagged:
                self.wavs[i] = res.wav

        b0 = (self.batcher.dispatches, self.batcher.requests)
        lo, hi = self._trace_bounds()
        prof = span = None
        self.t0 = time.perf_counter() + 0.01
        for i in range(n):
            if self.tracing and measured:
                if prof is None and due[i] >= lo:
                    self._sleep_until(self.t0 + lo)
                    prof, span = self._trace_start()
            self._sleep_until(self.t0 + due[i])
            fut = Future()
            fut.add_done_callback(lambda f, i=i: finished(i, f))
            sent[i] = time.perf_counter()
            self.batcher._queue.put((reqs[i], fut))
            futures.append(fut)
        if span is not None:
            self._sleep_until(self.t0 + hi)
            self._trace_end(span)
        give_up = self.t0 + self.seconds + CLOSE_WAIT_S
        wait(futures, timeout=max(0.0, give_up - time.perf_counter()))
        if prof is not None:
            self._trace_finish(prof)
        self.batcher_counts = {"dispatches": self.batcher.dispatches - b0[0],
                               "requests": self.batcher.requests - b0[1]}
        self.attempted = n
        self.t_end = max([t for t, _ in self.done.values()], default=time.perf_counter())
        lateness = sent - (self.t0 + due)
        self.log(f"open loop: {n} requests due over {due[n - 1]:.3f} s; sent late by p99 "
                 f"{traffic.percentile(lateness, 99) * 1e3:.3f} ms, max {lateness.max() * 1e3:.3f} ms")
        self.give_up = give_up

    @staticmethod
    def _sleep_until(t: float) -> None:
        delay = t - time.perf_counter()
        if delay > 0:
            time.sleep(delay)

    def _trace_start(self):
        prof = trace.profiler()
        prof.__enter__()
        span = torch.profiler.record_function(trace.WINDOW)
        span.__enter__()
        self.traced = (time.perf_counter(), 0.0)
        return prof, span

    def _trace_end(self, span) -> None:
        span.__exit__(None, None, None)
        self.traced = (self.traced[0], time.perf_counter())

    def _trace_finish(self, prof) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.__exit__(None, None, None)
        self._prof = prof

    # ---------------------------------------------------------------- metrics
    def _frames_s(self) -> float:
        v = self.cfg["vocoder"]
        return float(np.prod(v["upsample_rates"])) / self.cfg["audio"]["sampling_rate"]

    def end_to_end(self) -> Dict[str, float]:
        out = {"setup_s": self.setup_s}
        names = {m["name"] for m in self.cell.end_to_end}
        if "audio_s_per_s" in names:
            frames = sum(f for _, f in self.done.values())
            out["audio_s_per_s"] = frames * self._frames_s() / (self.t_end - self.t0)
        if names & {"latency_p95_ms", "latency_p50_ms"}:
            lat = []
            for i in range(self.attempted):
                t_done = self.done[i][0] if i in self.done else self.give_up
                lat.append((t_done - (self.t0 + self.reqs.due[i])) * 1e3)
            out["latency_p95_ms"] = traffic.percentile(lat, 95)
            out["latency_p50_ms"] = traffic.percentile(lat, 50)
        return {k: v for k, v in out.items() if k in names}

    def view(self) -> RunView:
        lo, hi = self.traced
        disp = self.probe.dispatches
        return RunView(
            cfg=self.cfg, dtype=self.dtype, window_s=self.t_end - self.t0,
            completed=[(int(self.n_tok[i % len(self.reqs)]), f) for i, (_, f) in self.done.items()],
            dispatches=disp, batcher=getattr(self, "batcher_counts", None),
            trace=self.trace_summary,
            traced_dispatches=[d for d in disp if d.t0 >= lo and d.t1 <= hi] if hi else [],
        )

    def per_layer(self) -> Dict[str, float]:
        view = self.view()
        out = {}
        for m in self.cell.per_layer:
            value = reader(m["name"])(view)
            if value is not None:
                out[m["name"]] = value
        return out

    def profile_lines(self) -> List[str]:
        """What the window was made of: frames a token, and the engine
        calls' host seconds in the window's first tenth against the rest."""
        out = []
        n = len(self.reqs)
        tok = sum(int(self.n_tok[i % n]) for i in self.done)
        frames = sum(f for _, f in self.done.values())
        if tok:
            out.append(f"delivered {frames} frames for {tok} tokens: {frames / tok:.4f} a token")
        d = self.probe.dispatches
        if d:
            cut = self.t0 + 0.1 * (self.t_end - self.t0)
            for name, part in (("first tenth", [x for x in d if x.t0 < cut]),
                               ("rest", [x for x in d if x.t0 >= cut])):
                if part:
                    ms = np.array([x.t1 - x.t0 for x in part]) * 1e3
                    rows = np.mean([len(x.rids) for x in part])
                    out.append(f"engine calls, {name}: {len(part)}, ms median {np.median(ms):.3f} "
                               f"max {ms.max():.3f}, rows {rows:.2f}")
            out.append("first calls (rows, text, mel, ms): " + ", ".join(
                f"({x.rows}, {x.t_text}, {x.max_frames}, {1e3 * (x.t1 - x.t0):.1f})" for x in d[:12]))
        return out

    # ------------------------------------------------------------------ check
    def served(self, rid: int) -> check.Served:
        line = rid % len(self.reqs)
        kept = self.probe.kept[rid]
        group_longest = max(int(self.n_tok[g % len(self.reqs)]) for g in kept.group)
        return check.Served(rid, self.reqs.tokens[line], int(self.reqs.speaker[line]),
                            self.reqs.style[line], self.reqs.content[line], self.reqs.alpha,
                            group_longest, self.done[rid][1], self.wavs[rid], kept)

    def check(self) -> Dict:
        failed = self.attempted - len(self.done) if self.mix["loop"] == "open" else len(self.errors)
        cands = sorted(r for r in self.done if r in self.probe.kept and r in self.wavs)
        n_tokens = {r: int(self.n_tok[r % len(self.reqs)]) for r in cands}
        pick = check.sample(cands, n_tokens, int(self.mix["check_sample"]), self.seed)
        served = [self.served(r) for r in pick]
        with torch.no_grad():
            rows = [check.program_numbers(s, self.sd, self.cfg, self.device) for s in served]
            numbers = check.worst(rows, failed)
            out = {"numbers": numbers, "sampled": len(served), "correct": check.judge(
                numbers, self.cell.limits) and len(served) > 0}
            if self.control:
                ctrl = [check.control_numbers(s, self.sd, self.cfg, self.device,
                                              self.cfg["control"]) for s in served]
                cn = check.worst(ctrl, 0)
                out["control"] = {"precision": self.cfg["control"], "numbers": cn,
                                  "correct": check.judge(cn, self.cell.limits)}
        return out

    # ------------------------------------------------------------- teardown
    def free_program(self) -> None:
        if self.batcher is not None:
            self.batcher.close()
        self.probe.restore()
        self.engine = self.probe.engine = self.batcher = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def execute(cell: Cell, seed: int, seconds: float, trace_on: bool, t_start: float,
            device: str = "cuda", control: bool = False, err=sys.stderr) -> Dict:
    """One run; returns the result object (raises NoDevice before any
    work). Prints the check's numbers with their limits as the last lines
    on `err`."""
    def log(msg):
        print(msg, file=err, flush=True)

    if check.empty(cell.limits):
        raise ValueError(check.empty(cell.limits))
    run = Run(cell, seed, seconds, trace_on, t_start, device, control, log)
    run.setup()
    log(f"set-up {run.setup_s:.3f} s; warmed {len(run.shapes)} buckets: {run.shapes}")
    run.window()
    peak = torch.cuda.max_memory_allocated(run.device) if run.device.type == "cuda" else 0
    if trace_on and getattr(run, "_prof", None) is not None:
        run.trace_summary = trace.summarize(run._prof.events())
        run._prof = None
    metrics = run.end_to_end() if not trace_on else run.per_layer()
    eng = run.engine
    log(f"window {run.t_end - run.t0:.3f} s: {len(run.done)} of {run.attempted} requests done, "
        f"{len(run.errors)} raised; dispatches {len(run.probe.dispatches)}; builds in the window "
        f"{run.builds}; saturation redispatches {eng.saturation_redispatches}, truncations "
        f"{eng.saturation_truncations}; graph pool {eng.programs[0].pool_bytes()} bytes")
    if run.errors:
        log(f"first error: {next(iter(run.errors.values()))}")
    for line in run.profile_lines():
        log(line)
    run.free_program()
    verdict = run.check()
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"forbidden modules loaded in the run's process: {found}")
    dev = {"platform": "gpu" if run.device.type == "cuda" else run.device.type,
           "kind": torch.cuda.get_device_name(run.device) if run.device.type == "cuda" else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(verdict["correct"]), "attempted": int(run.attempted),
              "failed": int(verdict["numbers"]["failed"]),
              "metrics": {k: {"value": v, "unit": _unit(cell, k)} for k, v in metrics.items()},
              "device": dev}
    if trace_on:
        s = run.trace_summary
        dev["busy_s"] = s.busy_s if s else 0.0
        dev["window_s"] = s.window_s if s else 0.0
        if s:
            result["breakdown"] = {"device_ops": [[k, v] for k, v in s.device_ops],
                                   "idle_gaps": [[k, v] for k, v in s.idle_gaps]}
    if "control" in verdict:
        result["control"] = verdict["control"]
        for line in check.lines(verdict["control"]["numbers"], cell.limits, "control "):
            log(line)
    log(f"check: {verdict['sampled']} requests sampled, correct={verdict['correct']}")
    for line in check.lines(verdict["numbers"], cell.limits):
        log(line)
    result["checked"] = {k: {"value": verdict["numbers"][k], "limit": cell.limits[k]}
                         for k in check.ORDER}
    return result


def _unit(cell: Cell, name: str) -> str:
    for m in cell.end_to_end + cell.per_layer:
        if m["name"] == name:
            return m["unit"]
    raise KeyError(name)
