"""The harness on the CPU: traffic from the seed, lookups by name, the open
loop's clock, imports, the exit without a card, and whole runs at the tiny
configuration with the timed path sound and broken."""

import ast
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from port_bench import harness, spec, traffic

ROOT = spec.ROOT
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))


def _mix(name):
    return json.load(open(os.path.join(ROOT, "port_bench", "traffic", name + ".json")))


@pytest.mark.parametrize("name", ["bulk", "interactive"])
def test_traffic_deterministic_in_seed_and_follows_its_lengths(tiny_file, name):
    mix = _mix(name)
    seed = 2 ** 31 + 9
    a, b = traffic.generate(mix, tiny_file, seed, 20.0), traffic.generate(mix, tiny_file, seed, 20.0)
    c = traffic.generate(mix, tiny_file, seed + 1, 20.0)
    assert len(a) == traffic.count(mix, 20.0)
    assert all(np.array_equal(x, y) for x, y in zip(a.tokens, b.tokens))
    assert np.array_equal(a.style, b.style) and np.array_equal(a.due, b.due)
    assert not all(np.array_equal(x, y) for x, y in zip(a.tokens, c.tokens))
    n = np.array([len(t) for t in a.tokens])
    tok = mix["tokens"]
    assert n.min() >= tok["min"] and n.max() <= tok["max"]
    assert abs(np.median(n) - tok["median"]) <= 1
    # every seed: the same sizes and gaps, in another order
    assert np.array_equal(np.sort(n), np.sort([len(t) for t in c.tokens]))
    if mix["loop"] == "open":
        assert np.all(np.diff(a.due) > 0) and a.due[0] > 0
        assert a.due[-1] == pytest.approx(20.0, rel=0.02)
        gaps = [np.sort(np.diff(x.due, prepend=0.0)) for x in (a, c)]
        assert np.allclose(gaps[0], gaps[1])
        assert a.due[-1] == pytest.approx(c.due[-1])


def test_unknown_names_fail():
    with pytest.raises(KeyError):
        spec.load_cell("no-such-cell")
    with pytest.raises(FileNotFoundError):
        spec.reader("no_such_metric")


def test_every_entry_found_by_name_from_its_own_file():
    for w in BENCH["workloads"]:
        cell = spec.load_cell(w["name"])
        assert cell.config["name"] == w["config"] and cell.traffic_name == w["traffic"]
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert callable(spec.reader(m["name"]))
            assert m["moves"] in reported


def test_open_loop_sends_at_due_times_and_times_from_them(tiny_file):
    """A stand-in batcher answering each request 20 ms after it is queued:
    every request is sent at its due time and its latency is counted from
    that time."""
    import threading

    class Queue:
        def put(self, item):
            req, fut = item
            Batcher.requests += 1
            Batcher.dispatches += 1
            threading.Timer(0.02, fut.set_result,
                            [type("R", (), {"n_frames": 5, "wav": None})()]).start()

    class Batcher:
        dispatches = requests = 0
        _queue = Queue()

    run = harness.Run.__new__(harness.Run)
    run.seconds, run.tracing, run.log = 1.0, False, lambda m: None
    run.mix = dict(_mix("interactive"), rate_per_s=60)
    run.reqs = traffic.generate(run.mix, tiny_file, 4, run.seconds)
    run.batcher, run.flagged = Batcher(), set()
    run.request = lambda i: i
    run.cell = type("C", (), {"end_to_end": [{"name": "latency_p95_ms"}, {"name": "latency_p50_ms"}]})()
    run.done, run.errors, run.wavs = {}, {}, {}
    run.traced = (0.0, 0.0)
    run.setup_s = 0.0
    run._open(len(run.reqs))
    assert len(run.done) == run.attempted == 60
    took = np.array([run.done[i][0] for i in range(60)]) - (run.t0 + run.reqs.due)
    assert np.all(took >= 0.02)
    e2e = run.end_to_end()
    assert 20.0 <= e2e["latency_p50_ms"] < 30.0
    assert run.batcher_counts == {"dispatches": 60, "requests": 60}


def _imports(path):
    out = set()
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            out.add(node.module)
    return out


def test_reference_imports_nothing_of_the_program():
    """A reference module imports torch and the standard library's plain
    parts, and may share the pieces of another reference module."""
    ref = os.path.join(ROOT, "port_bench", "reference")
    for f in os.listdir(ref):
        if f.endswith(".py"):
            mods = {m for m in _imports(os.path.join(ref, f))
                    if m.split(".")[:2] != ["port_bench", "reference"]}
            tops = {m.split(".")[0] for m in mods}
            assert tops <= {"__future__", "contextlib", "math", "typing", "torch"}, (f, tops)


def test_command_loads_no_jax():
    """Everything the command imports, the program's modules and every
    metric reader included, leaves no module whose top-level name is jax,
    jaxlib, flax or emotivoice_tpu."""
    code = (
        "import sys, runpy; sys.argv = ['run.py', '--help']\n"
        "sys.path.insert(0, 'port_bench')\n"
        "import run\n"
        "from port_bench import harness, spec, sweep\n"
        "import emotivoice_tpu_torch.serving.engine, emotivoice_tpu_torch.serving.batcher\n"
        "import emotivoice_tpu_torch.models.jets, emotivoice_tpu_torch.frontend.tokens\n"
        "for m in spec.load_cell('bf16-interactive').per_layer + spec.load_cell('bf16-bulk').per_layer:\n"
        "    spec.reader(m['name'])\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & {'jax', 'jaxlib', 'flax', 'emotivoice_tpu'}))\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_no_card_exits_without_a_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "port_bench/run.py", "--workload", "bf16-bulk",
                          "--seed", str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "{" not in out.stdout
    assert "CUDA" in out.stderr


def _tiny_cell(tiny_file, name, dtype="f32"):
    cell = spec.load_cell(name)
    cell.config = dict(tiny_file, dtype=dtype)
    tok = dict(cell.traffic["tokens"], median=12, min=4, max=40)
    if cell.traffic["loop"] == "closed":
        cell.traffic = dict(cell.traffic, lines=96, batch=4, block_batches=3, tokens=tok, check_every=1,
                            check_sample=1000)
    else:
        cell.traffic = dict(cell.traffic, rate_per_s=30, tokens=tok, check_every=1,
                            check_sample=1000)
    return cell


def _execute(cell, trace_on=False):
    import io
    return harness.execute(cell, 2 ** 31 + 21, 1.0, trace_on, time.perf_counter(), device="cpu",
                           err=io.StringIO())


@pytest.mark.parametrize("name", ["bf16-bulk", "bf16-interactive"])
def test_whole_run_on_the_cpu(tiny_file, name):
    res = _execute(_tiny_cell(tiny_file, name))
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0
    assert list(res)[-1] == "checked"
    assert set(res["metrics"]) == {m["name"] for m in spec.load_cell(name).end_to_end}
    assert all(v["value"] > 0 for v in res["metrics"].values())


def _fault_altered_answer(monkeypatch):
    from emotivoice_tpu_torch.models.hifigan import HiFiGANGenerator
    orig = HiFiGANGenerator.forward

    def forward(self, mel, dtype=torch.float32):
        return -orig(self, mel, dtype)  # every answer's polarity turned
    monkeypatch.setattr(HiFiGANGenerator, "forward", forward)


def _fault_half_batch(monkeypatch):
    from emotivoice_tpu_torch.models.jets import JETSGenerator
    orig = JETSGenerator.forward

    def forward(self, *a, **k):
        out = orig(self, *a, **k)
        wav = out["wav_predictions"]
        out["wav_predictions"] = torch.cat([wav[: (len(wav) + 1) // 2],
                                            torch.zeros_like(wav[(len(wav) + 1) // 2:])])
        return out
    monkeypatch.setattr(JETSGenerator, "forward", forward)


def _fault_durations(monkeypatch):
    from emotivoice_tpu_torch.models.variance import DurationPredictor
    orig = DurationPredictor.to_durations

    def to_durations(log_d, offset=1.0):
        d = orig(log_d, offset)
        return d + (torch.arange(d.shape[-1]) == 0).to(d)  # one frame more on each first token
    monkeypatch.setattr(DurationPredictor, "to_durations", staticmethod(to_durations))


@pytest.mark.parametrize("fault", [_fault_altered_answer, _fault_half_batch, _fault_durations])
@pytest.mark.parametrize("name", ["bf16-bulk", "bf16-interactive"])
def test_broken_timed_path_is_not_correct(tiny_file, monkeypatch, fault, name):
    fault(monkeypatch)
    res = _execute(_tiny_cell(tiny_file, name))
    assert res["correct"] is False


def test_traced_run_on_the_cpu_reads_what_it_can(tiny_file):
    res = _execute(_tiny_cell(tiny_file, "bf16-bulk"), trace_on=True)
    assert res["correct"]
    names = set(res["metrics"])
    assert {"pad_share.bulk", "mfu.bulk"} <= names
    # no device trace on the CPU: the trace's metrics are left out, never 0
    assert not names & {"resblock_roofline.bulk", "mrf_stage_roofline.bulk", "idle_share.bulk"}


@pytest.mark.card
@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_control_fails_on_the_card(card, name):
    """The control (the reference one precision below the configuration's,
    in the program's place) comes out not correct at the cell's own size on
    three seeds, while the program comes out correct."""
    for seed in (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103):
        out = subprocess.run([sys.executable, "port_bench/run.py", "--workload", name, "--seed",
                              str(seed), "--seconds", "4", "--trace", "0", "--control", "1"],
                             cwd=ROOT, capture_output=True, text=True, timeout=900)
        assert out.returncode == 0, out.stderr[-3000:]
        res = json.loads(out.stdout.strip().splitlines()[-1])
        assert res["correct"] is True
        assert res["control"]["correct"] is False


def test_trace_busy_is_the_union_of_device_intervals():
    """Overlapping operations count once, a record_function range on the
    device's timeline is no operation, and each idle gap is named by the
    innermost span that covered it on the host."""
    from torch.autograd import DeviceType

    from port_bench import trace as tr

    def ev(name, a, b, dev):
        return type("E", (), {"name": name, "device_type": dev,
                              "time_range": type("T", (), {"start": a, "end": b})()})()

    cuda, cpu = DeviceType.CUDA, DeviceType.CPU
    events = [ev(tr.WINDOW, 0, 1000, cpu), ev("port_bench.dispatch", 100, 600, cpu),
              ev("port_bench.run", 400, 600, cpu), ev("port_bench.run", 400, 600, cuda),
              ev("k1", 100, 300, cuda), ev("k2", 200, 350, cuda), ev("k1", 500, 900, cuda)]
    s = tr.summarize(events)
    assert s.window_s == pytest.approx(1e-3)
    assert s.busy_s == pytest.approx(650e-6)
    assert dict(s.device_ops) == pytest.approx({"k1": 600e-6, "k2": 150e-6})
    assert dict((round(g * 1e6), n) for n, g in s.idle_gaps) == {
        150: "port_bench.run", 100: tr.OUTSIDE}
    assert tr.kernel_seconds(s, "k") == pytest.approx(750e-6)
