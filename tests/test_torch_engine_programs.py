"""The port's bucket programs (`serving/programs.py`) on the CPU at
tiny_test_config size: a program against the JAX engine's `_compiled` for
the same bucket, alpha as the program's input, the per-replica LRU cache,
rebuilds when a parameter moves, the launch accounting of captured graphs,
when a program captures (its key's second call, or the warmup's first)
and that a CPU program keeps no outputs, and the model-parallel engine,
which stays eager. The CUDA graphs
themselves (capture, replay, shared pool) run only on a card:
`chip_smoke.py` holds replay against the eager forward there."""

import copy
import dataclasses
import threading
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_support import (assert_close_rel, both_configs, jax_jets_params, jax_lax_engine,
                                port_jets)

from emotivoice_tpu.frontend.tokens import TokenVocab as JTokenVocab
from emotivoice_tpu_torch.frontend.tokens import TokenVocab
from emotivoice_tpu_torch.models.jets import JETSGenerator, init_random_
from emotivoice_tpu_torch.ops.cuda import build
from emotivoice_tpu_torch.serving import programs
from emotivoice_tpu_torch.serving.engine import SynthesisEngine

BUCKETS = dict(text_buckets=(16, 32), mel_buckets=(128, 256), batch_buckets=(1, 2, 4))
ROWS, T_TEXT, FRAMES = 2, 16, 128  # the one JAX bucket of this file
ALPHAS = (1.0, 1.3)


def _inputs(n_vocab: int, d: int, seed: int = 0):
    rng = np.random.RandomState(seed)
    return (rng.randint(2, n_vocab, (ROWS, T_TEXT)), np.array([T_TEXT, 9]),
            np.array([1, 3]), rng.randn(ROWS, d).astype(np.float32),
            rng.randn(ROWS, d).astype(np.float32))


@pytest.fixture(scope="module")
def ref():
    """The port's config and the seeded JAX parameters, the bucket's inputs
    and the JAX engine's `_compiled` outputs at each alpha (one compile:
    alpha is traced)."""
    jc, tc = both_configs()
    n = len(TokenVocab.default())
    jc = jc.replace(am=jc.am.__class__(**{**jc.am.__dict__, "n_vocab": n}))
    tc = tc.replace(am=tc.am.__class__(**{**tc.am.__dict__, "n_vocab": n}))
    params = jax_jets_params(jc, seed=3)
    jengine = jax_lax_engine(jc, params, JTokenVocab.default(), **BUCKETS)
    arrays = _inputs(n, tc.am.bert_embedding)
    fn = jengine._compiled(T_TEXT, FRAMES)
    want = {}
    for alpha in ALPHAS:
        wav, n_frames = fn(jengine.params, *(
            jnp.asarray(a, jnp.float32 if a.dtype.kind == "f" else jnp.int32) for a in arrays),
            jnp.float32(alpha))
        want[alpha] = (np.asarray(wav), np.asarray(n_frames))
    return tc, params, arrays, want


def _engine(tc, params):
    return SynthesisEngine(tc, port_jets(tc, params), TokenVocab.default(), device="cpu",
                           **BUCKETS)


# ---------------------------------------------------------------------------
# (a), (b) a program against the JAX engine's per-bucket program
# ---------------------------------------------------------------------------

def test_bucket_program_matches_jax_compiled(ref):
    tc, params, arrays, want = ref
    engine = _engine(tc, params)
    wav, n_frames = engine.run(*arrays, FRAMES, ALPHAS[0])
    assert engine.programs[0].keys() == [(ROWS, T_TEXT, FRAMES)]
    np.testing.assert_array_equal(n_frames, want[ALPHAS[0]][1])
    assert_close_rel(wav, want[ALPHAS[0]][0], 1e-4)


def test_two_alphas_share_one_program(ref):
    tc, params, arrays, want = ref
    engine = _engine(tc, params)
    got = {alpha: engine.run(*arrays, FRAMES, alpha) for alpha in ALPHAS}
    cache = engine.programs[0]
    assert len(cache) == 1 and cache.builds == 1
    assert cache.get((ROWS, T_TEXT, FRAMES)).alpha.dim() == 0  # alpha is an input tensor
    assert not np.array_equal(want[ALPHAS[0]][1], want[ALPHAS[1]][1])  # alpha matters here
    for alpha in ALPHAS:
        np.testing.assert_array_equal(got[alpha][1], want[alpha][1])
        assert_close_rel(got[alpha][0], want[alpha][0], 1e-4)


# ---------------------------------------------------------------------------
# (c) at most 128 programs per replica, least recently used out first
# ---------------------------------------------------------------------------

def test_program_cache_is_an_lru_of_128():
    built = []

    def fake_build(key):
        built.append(key)
        return types.SimpleNamespace(key=key, stale=lambda: False)

    cache = programs.ProgramCache(fake_build)
    assert programs.MAX_PROGRAMS == 128
    keys = [(1, 16, 128 + i) for i in range(129)]
    for key in keys[:128]:
        cache.get(key)
    first = cache.get(keys[0])  # a hit: now the most recently used
    assert len(built) == 128 and first.key == keys[0]
    cache.get(keys[128])  # one past the limit: the least recently used goes
    assert len(cache) == 128 and cache.builds == 129
    assert keys[1] not in cache.keys() and keys[0] in cache.keys()
    assert cache.keys()[-1] == keys[128]
    cache.get(keys[1])  # built again
    assert built[-1] == keys[1] and cache.builds == 130 and keys[2] not in cache.keys()
    assert cache.rebuilds == 0 and cache.pool_bytes() == 0


# ---------------------------------------------------------------------------
# (d) live weights: in place is seen, a moved parameter rebuilds
# ---------------------------------------------------------------------------

def test_moved_parameter_rebuilds_in_place_change_is_seen(ref):
    tc, params, arrays, _ = ref
    engine = _engine(tc, params)
    model = engine.replicas[0]
    cache = engine.programs[0]

    def eager():
        with torch.inference_mode():
            out = model(*(torch.as_tensor(a) for a in arrays), max_frames=FRAMES)
        return out["wav_predictions"].numpy(), out["output_lengths"].numpy()

    before, _ = engine.run(*arrays, FRAMES, 1.0)
    conv = model.generator.resblocks[0].convs1[0]
    with torch.no_grad():
        conv.weight_g.mul_(3.0)
    wav, n = engine.run(*arrays, FRAMES, 1.0)
    assert cache.builds == 1 and cache.rebuilds == 0
    assert np.abs(wav - before).max() > 1e-4  # the change reached the output
    want_wav, want_n = eager()
    np.testing.assert_array_equal(n, want_n)
    np.testing.assert_array_equal(wav, want_wav)

    conv.weight_v = torch.nn.Parameter(conv.weight_v.detach().flip(0).clone())
    assert cache.get((ROWS, T_TEXT, FRAMES)) is not None
    assert cache.builds == 2 and cache.rebuilds == 1
    wav, n = engine.run(*arrays, FRAMES, 1.0)
    assert cache.builds == 2  # rebuilt once, then kept
    want_wav, want_n = eager()
    np.testing.assert_array_equal(n, want_n)
    np.testing.assert_array_equal(wav, want_wav)

    with pytest.raises(ValueError, match="input of shape"):
        cache.get((ROWS, T_TEXT, FRAMES)).run([a[:1] for a in arrays], 1.0)


# ---------------------------------------------------------------------------
# (e) the launches a capture recorded are counted at each replay
# ---------------------------------------------------------------------------

def test_captured_launches_count_at_each_replay(ref):
    def unit():  # stand-ins for the kernel wrappers, which carry `launches`
        pass

    def stage():
        pass

    unit.launches = stage.launches = 0
    with build.capturing_launches() as tally:
        assert build.capturing()
        for _ in range(3):
            build.count_launch(unit)
        build.count_launch(stage)
        other = threading.Thread(target=build.count_launch, args=(unit,))  # not capturing
        other.start()
        other.join(timeout=30)
    assert not other.is_alive() and not build.capturing()
    assert tally == {unit: 3, stage: 1} and (unit.launches, stage.launches) == (1, 0)
    build.count_launch(stage)
    assert stage.launches == 1

    tc, params, arrays, _ = ref
    prog = _engine(tc, params).programs[0].get((ROWS, T_TEXT, FRAMES))
    prog.graph, prog.launches, prog.outputs = FakeGraph(), {unit: 18, stage: 2}, _static_outputs()
    for _ in range(2):
        prog.run(arrays, 1.0)
    assert prog.graph.replays == 2 and (unit.launches, stage.launches) == (1 + 36, 1 + 4)


# ---------------------------------------------------------------------------
# when a program captures, and what it keeps
# ---------------------------------------------------------------------------

class FakeGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def _static_outputs():
    return {"wav_predictions": torch.zeros(ROWS, 4), "output_lengths": torch.ones(ROWS)}


def test_cpu_program_keeps_no_outputs(ref):
    tc, params, arrays, _ = ref
    prog = _engine(tc, params).programs[0].get((ROWS, T_TEXT, FRAMES))
    for capture in (False, True, False):
        wav, _ = prog.run(arrays, 1.0, capture)
        assert wav.shape[0] == ROWS
        assert prog.outputs is None and prog.graph is None and prog.ran


@pytest.mark.parametrize("capture", [False, True], ids=["traffic", "warmup"])
def test_first_call_is_eager_then_the_graph_is_captured(ref, monkeypatch, capture):
    """The card's order, with the forward and the capture stubbed: the
    first call returns the eager forward's own outputs; the graph is
    captured at the second call, or right after the first's forward with
    `capture`; then every call replays."""
    tc, params, arrays, _ = ref
    steps = []

    def forward(prog):
        steps.append("forward")
        return {"wav_predictions": torch.full((ROWS, 4), 7.0),
                "output_lengths": torch.ones(ROWS)}

    def capture_graph(prog):
        if prog.graph is None:
            steps.append("capture")
            prog.graph, prog.outputs = FakeGraph(), _static_outputs()

    monkeypatch.setattr(programs.BucketProgram, "_forward", forward)
    monkeypatch.setattr(programs.BucketProgram, "capture", capture_graph)
    prog = _engine(tc, params).programs[0].get((ROWS, T_TEXT, FRAMES))
    first, _ = prog.run(arrays, 1.0, capture)
    assert (first == 7.0).all()  # the eager forward's own outputs
    assert steps == (["forward", "capture"] if capture else ["forward"])
    for n in (1, 2):
        wav, _ = prog.run(arrays, 1.0)
        assert (wav == 0.0).all() and prog.graph.replays == n
    assert steps == ["forward", "capture"]


def test_warmup_calls_capture_at_once(ref, monkeypatch):
    """The engine's warmup (and calls inside `capturing()`) asks its
    programs to capture after their first call's forward; traffic does
    not."""
    tc, params, arrays, _ = ref
    engine = _engine(tc, params)
    asked = []
    run = programs.BucketProgram.run

    def recorded(prog, arrays, alpha, capture=False):
        asked.append((prog.key, capture))
        return run(prog, arrays, alpha, capture)

    monkeypatch.setattr(programs.BucketProgram, "run", recorded)
    engine.run(*arrays, FRAMES, 1.0)
    engine._warm_one(1, 16, 128)
    with engine.capturing():
        with engine.capturing():
            pass
        engine.run(*arrays, FRAMES, 1.0)
    engine.run(*arrays, FRAMES, 1.0)
    assert asked == [((ROWS, T_TEXT, FRAMES), False), ((1, 16, 128), True),
                     ((ROWS, T_TEXT, FRAMES), True), ((ROWS, T_TEXT, FRAMES), False)]


# ---------------------------------------------------------------------------
# (f) a replica over a model group stays eager
# ---------------------------------------------------------------------------

def test_model_parallel_engine_stays_eager(monkeypatch):
    from emotivoice_tpu_torch.config import tiny_test_config

    cfg = tiny_test_config()
    vocab = TokenVocab.from_tokens(["_", "<sos/eos>", "a", "b", "c"])
    cfg = cfg.replace(am=dataclasses.replace(cfg.am, n_vocab=len(vocab)))
    model = init_random_(JETSGenerator(cfg), seed=0)
    kw = dict(text_buckets=(8, 16), mel_buckets=(64, 128), batch_buckets=(1, 2))
    one = SynthesisEngine(cfg, copy.deepcopy(model), vocab, device="cpu", **kw)
    tp = SynthesisEngine(cfg, model, vocab, devices=["cpu"] * 2, model_parallel=2, **kw)
    assert tp.programs is None and len(one.programs) == 1
    eager_calls = []
    run_eager = SynthesisEngine._run_eager

    def counted(self, *a):
        eager_calls.append(self)
        return run_eager(self, *a)

    monkeypatch.setattr(SynthesisEngine, "_run_eager", counted)
    rng = np.random.RandomState(1)
    d = cfg.am.bert_embedding
    arrays = (rng.randint(2, len(vocab), (2, 8)), np.array([8, 5]), np.array([0, 1]),
              rng.randn(2, d).astype(np.float32), rng.randn(2, d).astype(np.float32))
    want_wav, want_n = one.run(*arrays, 64, 1.2)
    assert eager_calls == [] and one.programs[0].builds == 1
    wav, n = tp.run(*arrays, 64, 1.2)
    assert eager_calls == [tp]
    np.testing.assert_array_equal(n, want_n)
    assert_close_rel(wav, want_wav, 1e-5)


def test_collector_paused_while_any_capture_runs():
    """The garbage collector stays off from the first capture's start to
    the last one's end (captures on two cards overlap), and comes back as
    it was: a collection inside a capture would free a dead program's
    graph there and invalidate the capture."""
    import gc

    enabled = gc.isenabled()
    try:
        gc.enable()
        outer = programs._collector_paused()
        outer.__enter__()
        assert not gc.isenabled()
        with programs._collector_paused():
            assert not gc.isenabled()
        assert not gc.isenabled()
        outer.__exit__(None, None, None)
        assert gc.isenabled()
        gc.disable()
        with programs._collector_paused():
            assert not gc.isenabled()
        assert not gc.isenabled()
    finally:
        (gc.enable if enabled else gc.disable)()
