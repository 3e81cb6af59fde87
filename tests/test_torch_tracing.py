"""The port's spans and device marks (`serving/tracing.py`) on the CPU:
nothing recorded without a profiler; under a CPU `torch.profiler` the span
tree of one batch and of a saturation redispatch, request ids shared from
the batcher to the engine, the arrival stamp of a request put straight on
the batcher's queue, the model's marks in order, the clock mapping onto
the profiler's trace, the bounded span list, and the capture counter in
`GET /v1/metrics`."""

import collections
import json
import threading
import time
from concurrent.futures import Future

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

import test_torch_support  # noqa: F401  (one intra-op thread per worker)
from emotivoice_tpu_torch.config import tiny_test_config
from emotivoice_tpu_torch.frontend.tokens import TokenVocab
from emotivoice_tpu_torch.models.jets import JETSGenerator, init_random_
from emotivoice_tpu_torch.serving import tracing
from emotivoice_tpu_torch.serving.api import TTSService, make_stdlib_server
from emotivoice_tpu_torch.serving.batcher import MicroBatcher
from emotivoice_tpu_torch.serving.engine import SynthesisEngine, SynthesisRequest
from emotivoice_tpu_torch.utils import marks

PHONES = ["<sos/eos>", "a", "b", "c", "<sos/eos>"]


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


@pytest.fixture(scope="module")
def model():
    cfg = tiny_test_config()
    vocab = TokenVocab.from_tokens(["_", "<sos/eos>", "a", "b", "c"])
    cfg = cfg.replace(am=cfg.am.__class__(**{**cfg.am.__dict__, "n_vocab": len(vocab)}))
    return init_random_(JETSGenerator(cfg), seed=0), vocab


@pytest.fixture
def engine(model):
    m, vocab = model
    tracing.clear()
    return SynthesisEngine(m.cfg, m, vocab, text_buckets=(8, 16), mel_buckets=(64, 128),
                           batch_buckets=(1, 2, 4), device="cpu")


def _req(engine, alpha=1.0):
    d = engine.cfg.am.bert_embedding
    return SynthesisRequest(phonemes=PHONES, speaker_id=0,
                            style_embedding=np.zeros(d, np.float32),
                            content_embedding=np.zeros(d, np.float32), alpha=alpha)


def _named(spans, name):
    return [s for s in spans if s.name == name]


def _children(spans, parent):
    return [s for s in spans if s.parent == parent.id]


def test_nothing_recorded_without_a_profiler(engine):
    assert not tracing.recording()
    batcher = MicroBatcher(engine, max_batch=4, max_wait_ms=20.0)
    try:
        reqs = [_req(engine), _req(engine)]
        batcher.submit_many(reqs)
        engine.synthesize_batch([_req(engine)])
    finally:
        batcher.close()
    assert tracing.spans() == [] and tracing.dropped == 0
    # ids are given all the same, one per request
    assert len({r.request_id for r in reqs}) == 2 and None not in {r.request_id for r in reqs}
    with cpu_profile():
        assert tracing.recording()
    assert not tracing.recording()


def test_span_tree_of_one_batch_through_the_batcher(engine):
    batcher = MicroBatcher(engine, max_batch=4, max_wait_ms=200.0)
    reqs = [_req(engine), _req(engine)]
    try:
        with cpu_profile():
            out = batcher.submit_many(reqs)
    finally:
        batcher.close()
    spans = tracing.spans()
    (call,) = _named(spans, "engine.call")
    ids = [r.request_id for r in reqs]
    assert call.parent is None and call.attrs["requests"] == ids
    assert call.attrs["frames"] == sum(r.n_frames for r in out) > 0
    kids = _children(spans, call)
    assert [s.name for s in sorted(kids, key=lambda s: s.start_ns)] == [
        "engine.prepare", "engine.prepare", "program.run", "engine.results"]
    (run,) = _named(kids, "program.run")
    assert run.attrs["kind"] == "eager"
    assert not set(tracing.DEVICE_PARTS) & set(run.attrs)  # no device events on the CPU
    waits = _named(spans, "batcher.wait")
    assert sorted(s.attrs["request"] for s in waits) == sorted(ids)
    for w in waits:
        assert w.attrs["call"] == call.id
        assert w.start_ns <= w.attrs["taken_ns"] <= w.end_ns <= call.start_ns
    (fan,) = _named(spans, "batcher.fan_out")
    assert fan.attrs["call"] == call.id and fan.start_ns >= call.end_ns
    for s in spans:
        assert s.start_ns <= s.end_ns
        if s.parent is not None:
            p = next(x for x in spans if x.id == s.parent)
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns


def test_span_tree_of_a_saturation_redispatch(model):
    """A mel bucket of 2 frames saturates; the rows go again at 64."""
    m, vocab = model
    tracing.clear()
    e = SynthesisEngine(m.cfg, m, vocab, text_buckets=(8,), mel_buckets=(2, 64),
                        batch_buckets=(1, 2), frames_per_token=0.1, device="cpu")
    reqs = [_req(e), _req(e)]
    with cpu_profile():
        out = e.synthesize_batch(reqs)
    assert e.saturation_redispatches == 1 and all(r.n_frames > 2 for r in out)
    spans = tracing.spans()
    (call,) = _named(spans, "engine.call")
    assert call.attrs["requests"] == [r.request_id for r in reqs]
    assert call.attrs["frames"] == sum(r.n_frames for r in out)
    kids = sorted(_children(spans, call), key=lambda s: s.start_ns)
    assert [s.name for s in kids] == ["engine.prepare", "engine.prepare", "program.run",
                                      "engine.results", "engine.prepare", "program.run",
                                      "engine.results"]
    assert [s.attrs["kind"] for s in _named(kids, "program.run")] == ["eager", "eager"]


def test_a_request_put_straight_on_the_queue_gets_its_stamp(engine):
    """As `(request, future)` on `MicroBatcher._queue`, not through
    `submit`; a request of another alpha, put back by the worker, keeps its
    first stamp."""
    batcher = MicroBatcher(engine, max_batch=4, max_wait_ms=300.0)
    a, b = _req(engine), _req(engine, alpha=1.3)
    fa, fb = Future(), Future()
    try:
        with cpu_profile():
            t0 = time.perf_counter_ns()
            batcher._queue.put((a, fa))
            batcher._queue.put((b, fb))
            t1 = time.perf_counter_ns()
            fa.result(timeout=60)
            fb.result(timeout=60)
    finally:
        batcher.close()
    assert a.request_id is not None and b.request_id is not None
    waits = {s.attrs["request"]: s for s in _named(tracing.spans(), "batcher.wait")}
    calls = {s.id: s for s in _named(tracing.spans(), "engine.call")}
    assert set(waits) == {a.request_id, b.request_id} and len(calls) == 2
    for r in (a, b):
        w = waits[r.request_id]
        assert t0 <= w.start_ns <= t1  # stamped at the put, not at the re-post
        assert calls[w.attrs["call"]].attrs["requests"] == [r.request_id]
    assert waits[b.request_id].attrs["taken_ns"] > waits[a.request_id].end_ns


def test_model_marks_fire_in_order_and_do_nothing_unarmed(model):
    m, _ = model
    d = m.cfg.am.bert_embedding
    args = (torch.tensor([[2, 3, 4]]), torch.tensor([3]), torch.tensor([0]),
            torch.zeros(1, d), torch.zeros(1, d))
    seen = []
    with torch.inference_mode():
        with marks.marking(seen.append):
            m(*args, max_frames=16)
            # armed on this thread only
            th = threading.Thread(target=torch.inference_mode()(lambda: m(*args, max_frames=16)))
            th.start()
            th.join(timeout=60)
        m(*args, max_frames=16)  # disarmed again
    assert not th.is_alive()
    assert seen == list(marks.MARKS) == ["encoder", "variance", "decoder"]


def test_to_profiler_ns_lands_beside_a_record_function(engine):
    with cpu_profile() as prof:
        with record_function("test.warm"):  # a process's first range enters ~1 ms late
            pass
        with record_function("test.around_the_call"):
            engine.synthesize_batch([_req(engine)])
    (call,) = _named(tracing.spans(), "engine.call")
    start0 = prof.profiler.kineto_results.trace_start_ns()
    (ev,) = [e for e in prof.events() if e.name == "test.around_the_call"]
    a = start0 + ev.time_range.start * 1000
    b = start0 + ev.time_range.end * 1000
    assert abs(tracing.to_profiler_ns(call.start_ns) - a) < 1e6
    assert abs(tracing.to_profiler_ns(call.end_ns) - b) < 1e6


def test_span_list_is_bounded_and_counts_what_it_drops(monkeypatch):
    tracing.clear()
    monkeypatch.setattr(tracing, "_spans", collections.deque(maxlen=2))
    for i in range(5):
        tracing.add("x", i, i + 1, n=i)
    assert [s.attrs["n"] for s in tracing.spans()] == [3, 4] and tracing.dropped == 3
    tracing.clear()
    assert tracing.spans() == [] and tracing.dropped == 0


def test_spans_left_open_by_an_exception_close_with_their_parent():
    tracing.clear()
    with cpu_profile():
        outer = tracing.begin("outer")
        inner = tracing.begin("inner")
        assert inner.parent == outer.id
        tracing.end(outer)
        after = tracing.begin("after")
        tracing.end(after)
    assert [s.name for s in tracing.spans()] == ["outer", "after"]
    assert after.parent is None and tracing.last_id("outer") == outer.id


def test_captures_stay_zero_on_the_cpu_and_reach_v1_metrics(engine):
    engine.synthesize_batch([_req(engine)])
    engine.synthesize_batch([_req(engine)])
    (cache,) = engine.programs
    assert cache.builds == 1 and cache.captures == 0
    svc = TTSService(engine, g2p_fn=lambda text: " ".join(PHONES),
                     embed_fn=lambda text: np.zeros(engine.cfg.am.bert_embedding, np.float32),
                     speaker2id={"0": 0}, batching=False)
    assert "programs" not in svc.metrics.snapshot(svc._batcher, engine)  # the JAX keys
    srv = make_stdlib_server(svc, "127.0.0.1", 0)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        import http.client

        conn = http.client.HTTPConnection("127.0.0.1", srv.server_address[1], timeout=60)
        conn.request("GET", "/v1/metrics")
        snap = json.loads(conn.getresponse().read())
        conn.close()
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(timeout=30)
        svc.close()
    assert not th.is_alive()
    # the CPU launches no kernel, and its waveforms cross no bus
    assert snap["programs"] == {"builds": 1, "rebuilds": 0, "captures": 0, "copy_bytes": 0,
                                "bucket_bytes": 0, "fused_aa_snake_launches": 0}
    assert engine.program_counts() == snap["programs"]


class _Event:
    """Stands in for a card's timing event: logs the stream it records on."""

    def __init__(self, name, log):
        self.name, self.log = name, log

    def record(self, stream=None):
        self.log.append((self.name, stream))

    def elapsed_time(self, other):
        return 1.0

    def synchronize(self):
        pass


def test_program_records_its_events_on_its_own_card(model, monkeypatch):
    """A replica on cuda:1 may run on a thread whose current card is 0 (an
    engine's replica threads): every event of its bucket program, the
    model's marks and those around the call, records on the current stream
    of the program's own card, asked for by that card, never on the
    thread's. On the CPU, with stand-ins for the card's events and streams."""
    from emotivoice_tpu_torch.serving.programs import BucketProgram

    m, _ = model
    d = m.cfg.am.bert_embedding
    prog = BucketProgram(m, (1, 8, 64), torch.device("cpu"), torch.float32)
    log = []
    prog._card = torch.device("cuda", 1)
    prog._events = {n: _Event(n, log) for n in (*marks.MARKS, "start", "copied", "computed", "end")}
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: ("stream", device))
    arrays = (np.array([[1, 2, 3, 4, 1, 0, 0, 0]]), np.array([5]), np.array([0]),
              np.zeros((1, d), np.float32), np.zeros((1, d), np.float32))
    tracing.clear()
    with cpu_profile():
        prog.run(arrays, 1.0)
    assert [n for n, _ in log] == ["start", "copied", *marks.MARKS, "computed", "end"]
    assert {st for _, st in log} == {("stream", torch.device("cuda", 1))}
    (run,) = _named(tracing.spans(), "program.run")
    assert run.attrs["kind"] == "eager"
    assert {p: run.attrs[p] for p in tracing.DEVICE_PARTS} == dict.fromkeys(tracing.DEVICE_PARTS, 1.0)
    log.clear()
    prog.run(arrays, 1.0)  # no profiler: only the marks, which a capture keeps
    assert [n for n, _ in log] == list(marks.MARKS)


def test_spans_of_replica_threads_nest_under_the_engine_call(model):
    m, vocab = model
    tracing.clear()
    two = SynthesisEngine(m.cfg, m, vocab, text_buckets=(8,), mel_buckets=(64,),
                          batch_buckets=(2,), devices=["cpu", "cpu"])
    def probe():
        span = tracing.begin("probe")
        tracing.end(span)
        return span

    with cpu_profile():
        two.synthesize_batch([_req(two), _req(two)])
        # the replica threads keep nothing open after the call
        left = [two._pool.submit(probe).result() for _ in range(4)]
    spans = tracing.spans()
    (call,) = _named(spans, "engine.call")
    runs = _named(spans, "program.run")
    assert len(runs) == 2 and {r.parent for r in runs} == {call.id}
    assert all(call.start_ns <= r.start_ns <= r.end_ns <= call.end_ns for r in runs)
    assert [s.parent for s in left] == [None] * 4


def test_threads_keep_every_span_and_their_own_parents():
    """More threads than cores recording at once, switching often: no span
    is lost, ids and request ids are unique, and each parent is a span of
    the same thread."""
    import os
    import sys

    tracing.clear()
    n_threads, per = 2 * (os.cpu_count() or 2) + 2, 200
    reqs = [[SynthesisRequest(PHONES, 0, None, None) for _ in range(per)] for _ in range(n_threads)]
    from emotivoice_tpu_torch.serving.engine import assign_request_id

    def work(i):
        for j in range(per):
            outer = tracing.begin("outer", thread=i)
            inner = tracing.begin("inner", thread=i)
            assign_request_id(reqs[i][j])
            tracing.end(inner)
            tracing.end(outer)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with cpu_profile():
            threads = [threading.Thread(target=work, args=(i,)) for i in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    spans = tracing.spans()
    assert len(spans) == 2 * n_threads * per and tracing.dropped == 0
    assert len({s.id for s in spans}) == len(spans)
    by_id = {s.id: s for s in spans}
    for s in spans:
        if s.name == "inner":
            assert by_id[s.parent].name == "outer"
            assert by_id[s.parent].attrs["thread"] == s.attrs["thread"]
        else:
            assert s.parent is None
    ids = [r.request_id for row in reqs for r in row]
    assert None not in ids and len(set(ids)) == len(ids)
