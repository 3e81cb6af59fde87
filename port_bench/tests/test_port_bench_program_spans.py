"""The readers of the program's spans (`program_spans.py`, source
"program_span") on synthetic spans: the values each computes, the traced
sub-window's edges, and None where there is nothing to read."""

import dataclasses
import json
import os
import sys
import types
from typing import Dict, Optional

import pytest

from port_bench import program_spans, spec

BENCH = json.load(open(os.path.join(spec.ROOT, "BENCHMARK.json")))
NEW = {m["name"]: m for m in BENCH["per_layer"] if m["source"] == "program_span"
       and m["name"].split(".")[0] in {"queue_wait_ms", "host_ms_per_call", "copy_out_ms",
                                       "acoustic_ms_per_audio_s", "vocoder_ms_per_audio_s"}}
CFG = {"vocoder": {"upsample_rates": [8, 8, 2, 2]}, "audio": {"sampling_rate": 16000}}
MS = 1_000_000  # ns


@dataclasses.dataclass
class S:
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: Optional[int] = None
    attrs: Dict = dataclasses.field(default_factory=dict)

    @property
    def ms(self):
        return (self.end_ns - self.start_ns) / 1e6


def _view(lo_ms=100, hi_ms=400):
    d = types.SimpleNamespace(t0=lo_ms * MS / 1e9, t1=hi_ms * MS / 1e9)
    return types.SimpleNamespace(cfg=CFG, traced_dispatches=[d])


def _call(base, t0, frames, ms, fan_ms, waits, device=True):
    """One engine call at t0 ms (ids from `base`): prepare 1 + 0.5 ms,
    results 0.25 ms, a program.run with device ms `ms`, a fan-out, and the
    batcher.wait of each request."""
    call = S("engine.call", t0 * MS, (t0 + 50) * MS, base, attrs={"frames": frames})
    out = [call,
           S("engine.prepare", t0 * MS, (t0 + 1) * MS, base + 1, base),
           S("engine.prepare", (t0 + 1) * MS, int((t0 + 1.5) * MS), base + 2, base),
           S("program.run", (t0 + 2) * MS, (t0 + 49) * MS, base + 3, base,
             dict(ms, kind="replay") if device else {"kind": "capture"}),
           S("engine.results", (t0 + 49) * MS, int((t0 + 49.25) * MS), base + 4, base),
           S("batcher.fan_out", (t0 + 50) * MS, (t0 + 50 + fan_ms) * MS, base + 5,
             attrs={"call": base})]
    out += [S("batcher.wait", (t0 - w) * MS, t0 * MS, base + 10 + i,
              attrs={"request": base * 100 + i, "call": base}) for i, w in enumerate(waits)]
    return out


PARTS = dict(copy_in=0.5, encoder=2.0, variance=3.0, decoder=5.0, vocoder=20.0)


@pytest.fixture
def spans(monkeypatch):
    box = []
    monkeypatch.setattr(program_spans, "recorded", lambda: box)
    return box


def test_every_new_metric_has_its_reader_and_entry():
    assert set(NEW) == {"queue_wait_ms.interactive", "host_ms_per_call.bulk",
                        "host_ms_per_call.interactive", "copy_out_ms.bulk",
                        "copy_out_ms.interactive", "acoustic_ms_per_audio_s.bulk",
                        "vocoder_ms_per_audio_s.bulk"}
    for name, m in NEW.items():
        assert callable(spec.reader(name)) and m["better"] == "lower"
        suffix = name.split(".")[1]
        assert m["workloads"] == (["bf16-interactive"] if suffix == "interactive"
                                  else ["bf16-bulk", "f32-bulk"])


def test_values_over_the_traced_sub_window(spans):
    spans += _call(1000, 150, frames=1000, ms=dict(PARTS, copy_out=4.0), fan_ms=2, waits=[10, 30])
    spans += _call(2000, 250, frames=3000, ms=dict(PARTS, copy_out=6.0), fan_ms=4, waits=[20])
    # starts before the sub-window: none of it is read, but for its fan-out
    spans += _call(3000, 80, frames=500, ms=dict(PARTS, copy_out=100.0), fan_ms=9, waits=[5])
    view = _view()
    read = {name: spec.reader(name)(view) for name in NEW}
    assert read["queue_wait_ms.interactive"] == 20.0  # of 10, 30, 20
    assert read["host_ms_per_call.bulk"] == pytest.approx(1.75)
    assert read["host_ms_per_call.interactive"] == pytest.approx(1.75 + 3)  # fan-outs 2, 4
    assert read["copy_out_ms.bulk"] == read["copy_out_ms.interactive"] == 5.0
    audio_s = 4000 * 256 / 16000
    assert read["acoustic_ms_per_audio_s.bulk"] == pytest.approx(2 * 10.0 / audio_s)
    assert read["vocoder_ms_per_audio_s.bulk"] == pytest.approx(2 * 20.0 / audio_s)


def test_nested_calls_count_once_under_the_outermost(spans):
    """A batch larger than the engine's largest bucket: one outer call of
    two inner ones."""
    inner_a = _call(10, 150, frames=100, ms=dict(PARTS, copy_out=1.0), fan_ms=0, waits=[])[:5]
    inner_b = _call(20, 210, frames=300, ms=dict(PARTS, copy_out=1.0), fan_ms=0, waits=[])[:5]
    outer = S("engine.call", 149 * MS, 261 * MS, 1, attrs={"frames": 400})
    inner_a[0].parent = inner_b[0].parent = 1
    spans += [outer, *inner_a, *inner_b]
    view = _view()
    assert program_spans.host_ms_per_call(view, fan_out=False) == pytest.approx(2 * 1.75)
    assert program_spans.device_ms_per_audio_s(view, ["vocoder"]) == pytest.approx(
        40.0 / (400 * 256 / 16000))


def test_a_call_with_a_capture_is_left_out_of_the_device_split(spans):
    spans += _call(1000, 150, frames=1000, ms=PARTS, fan_ms=1, waits=[1], device=False)
    view = _view()
    assert program_spans.device_ms_per_audio_s(view, ["vocoder"]) is None
    assert program_spans.copy_out_ms(view) is None
    spans += _call(2000, 250, frames=1000, ms=dict(PARTS, copy_out=3.0), fan_ms=1, waits=[1])
    assert program_spans.device_ms_per_audio_s(view, ["vocoder"]) == pytest.approx(
        20.0 / (1000 * 256 / 16000))


def test_nothing_to_read_gives_none(spans, monkeypatch):
    view = _view()
    for name in NEW:  # the program recorded nothing
        assert spec.reader(name)(view) is None
    spans += _call(1000, 150, frames=1000, ms=dict(PARTS, copy_out=4.0), fan_ms=2, waits=[10])
    for name in NEW:  # no traced sub-window
        assert spec.reader(name)(types.SimpleNamespace(cfg=CFG, traced_dispatches=[])) is None
    for name in NEW:  # spans only outside it
        assert spec.reader(name)(_view(500, 900)) is None
    monkeypatch.setattr(program_spans, "recorded", lambda: None)  # a program without spans
    for name in NEW:
        assert spec.reader(name)(view) is None


def test_recorded_is_none_for_a_program_without_the_recorder(monkeypatch):
    from emotivoice_tpu_torch.serving import tracing

    assert program_spans.recorded() == tracing.spans()
    monkeypatch.setitem(sys.modules, "emotivoice_tpu_torch.serving.tracing", None)
    assert program_spans.recorded() is None


# On the card: the program's device parts, which the readers above read

def _arrays(cfg, rows: int, t_text: int, seed: int = 0):
    import numpy as np
    rng = np.random.RandomState(seed)
    d = cfg.am.bert_embedding
    return (rng.randint(2, cfg.am.n_vocab, (rows, t_text)), rng.randint(t_text // 2, t_text + 1, rows),
            rng.randint(0, cfg.am.n_speaker, rows), rng.randn(rows, d).astype(np.float32),
            rng.randn(rows, d).astype(np.float32))


def _runs():
    from emotivoice_tpu_torch.serving import tracing
    return [s for s in tracing.spans() if s.name == "program.run"]


@pytest.mark.card
def test_device_parts_of_a_call_add_up_on_the_card(card):
    """A bucket program of the full-width model on the card, in bf16: the
    eager first call and a replay carry the six device parts, the capture
    none; a replay's parts add up to the device time between events
    recorded around the call, and its vocoder part holds the MRF kernels'
    launches that the profiler saw in the call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from emotivoice_tpu_torch.config import EmotiVoiceConfig
    from emotivoice_tpu_torch.models.jets import JETSGenerator, init_random_
    from emotivoice_tpu_torch.serving import tracing
    from emotivoice_tpu_torch.serving.programs import BucketProgram
    from port_bench.reference import hifigan_launches

    dev = torch.device("cuda")
    cfg = EmotiVoiceConfig()
    model = init_random_(JETSGenerator(cfg), 0).to(dev).eval()
    prog = BucketProgram(model, (8, 64, 512), dev, torch.bfloat16,
                         pool=torch.cuda.graph_pool_handle())
    arrays = _arrays(cfg, 8, 64)
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):
            prog.run(arrays, 1.0)
    eager, capture, replay = _runs()
    assert [eager.attrs["kind"], capture.attrs["kind"], replay.attrs["kind"]] == [
        "eager", "capture", "replay"]
    assert not set(tracing.DEVICE_PARTS) & set(capture.attrs)
    for run in (eager, replay):
        assert all(run.attrs[p] > 0 for p in tracing.DEVICE_PARTS), run.attrs

    before, after = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        before.record()
        prog.run(arrays, 1.0)
        after.record()
        after.synchronize()
    (run,) = _runs()
    total = before.elapsed_time(after)
    parts = sum(run.attrs[p] for p in tracing.DEVICE_PARTS)
    assert 0.95 * total <= parts <= total, (parts, total, run.attrs)
    mrf_ms = sum(e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == DeviceType.CUDA
                 and any(k in e.name for k in hifigan_launches.KERNELS.values())) / 1e3
    assert 0 < mrf_ms <= run.attrs["vocoder"], (mrf_ms, run.attrs)


@pytest.mark.card
def test_programs_on_a_card_that_is_not_current(card):
    """Replicas on cuda:1, called from threads whose current card is cuda:0
    (the main thread with `device="cuda:1"`, an engine's replica threads
    with `devices=["cuda:0", "cuda:1"]`): each bucket's eager call, capture
    and replay run, with and without a profiler, and the timed calls carry
    the device parts."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from emotivoice_tpu_torch.config import tiny_test_config
    from emotivoice_tpu_torch.frontend.tokens import TokenVocab
    from emotivoice_tpu_torch.models.jets import JETSGenerator, init_random_
    from emotivoice_tpu_torch.serving import tracing
    from emotivoice_tpu_torch.serving.engine import SynthesisEngine

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    assert torch.cuda.current_device() == 0
    cfg = tiny_test_config()
    vocab = TokenVocab.from_tokens(["_", "<sos/eos>"] + [f"p{i}" for i in range(cfg.am.n_vocab - 2)])
    kw = dict(text_buckets=(8, 16), mel_buckets=(64,), batch_buckets=(2,))
    for places in (dict(device="cuda:1"), dict(devices=["cuda:0", "cuda:1"])):
        model = init_random_(JETSGenerator(cfg, kernels=False), 0)  # each engine moves its own
        engine = SynthesisEngine(cfg, model, vocab, **kw, **places)
        for _ in range(3):  # the marks record on every call, profiler or not
            engine.run(*_arrays(cfg, 2, 8), max_frames=64, alpha=1.0)
        tracing.clear()
        with profile(activities=[ProfilerActivity.CPU]):
            for _ in range(3):
                wav, n = engine.run(*_arrays(cfg, 2, 16), max_frames=64, alpha=1.0)
        runs = _runs()
        assert sorted(r.attrs["kind"] for r in runs) == sorted(
            ["eager", "capture", "replay"] * len(engine.replicas))
        for r in runs:
            if r.attrs["kind"] != "capture":
                assert all(r.attrs[p] >= 0 for p in tracing.DEVICE_PARTS), r.attrs
        assert [c.captures for c in engine.programs] == [2] * len(engine.replicas)
        assert np.isfinite(wav).all() and (n > 0).all()
