"""Data-parallel and multi-process training and serving in the port, on
the CPU over gloo, and the repairs that came before them.

- Repairs: each kernel wrapper launches inside `torch.cuda.device(x.device)`
  (a stand-in card tensor and a stand-in kernel library record the device
  current at the launch); `serve`, `synthesize` and `train` in f32 turn
  TF32 off; a non-zero `weight_decay` is refused (optax.adam has none).
- Two gloo ranks in two processes (`test_torch_parallel_worker.py`) against one
  process on the concatenated batch: the ranks hold rows of one padded
  global batch, rank 0 the long ones, rank 1 the short ones, dropout off.
  Step 1's all-reduced G and D gradients within GRAD_TOL of each tensor's
  max; after 5 steps (lr 1e-3) every loss within LOSS_RTOL and every
  parameter within PARAM_TOL of its max; the segment starts equal;
  spectral-norm u, v equal on both ranks. The control: the same step with
  each rank's masked prosody means over its own tokens misses GRAD_TOL by
  orders of magnitude.
- Three ranks whose shards give different batch counts finish every epoch
  at the smallest count, each step padded to one shape; the training CLI
  with `--multihost` on two ranks.
- The engine with two CPU replicas gives the one-replica engine's results
  exactly; `serve --data-parallel 2` builds two replicas; `serve
  --multihost` in two processes answers byte for byte as one process does.

GRAD_TOL is 3e-5 of each tensor's max (or of FLOOR x the model's largest
gradient, where a tensor's own max is smaller: those gradients are 0 in
exact arithmetic, attention key biases). The ranks and the one process sum
the same terms in other orders; the worst tensor is conv_post's
one-element weight-norm gain, a sum over every sample of the segments, at
~1.8e-5; every other tensor is below 3e-6. A parameter whose gradient is
round-off is moved by Adam by about +-lr a step whatever its sign, so those
are held to 2 x lr x steps instead.
"""

import json
import os
import socket
import subprocess
import sys
import time
import types
import urllib.request

import numpy as np
import pytest
import torch

import test_torch_support  # noqa: F401  (one intra-op thread per worker)
from emotivoice_tpu_torch.config import tiny_test_config
from emotivoice_tpu_torch.frontend.tokens import TokenVocab
from emotivoice_tpu_torch.models.jets import JETSGenerator, init_random_
from emotivoice_tpu_torch.serving.engine import SynthesisEngine, SynthesisRequest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "test_torch_parallel_worker.py")
TIMEOUT_S = 240  # each multi-process run
GRAD_TOL = 3e-5
FLOOR = 1e-4
LOSS_RTOL = 1e-5
PARAM_TOL = 1e-4
STEPS, LR = 5, 1e-3  # the worker's


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(rank=None, world=None, port=None, **extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env["PYTHONPATH"] = ROOT
    env["OMP_NUM_THREADS"] = "1"  # the test workers share the host's cores
    if rank is not None:
        env.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    env.update(extra)
    return env


def _run_all(cmds_envs, cwd, timeout=TIMEOUT_S):
    """Start every (command, env) at once; wait for all, each bounded by
    `timeout`; return their (returncode, output)."""
    procs = [subprocess.Popen(cmd, env=env, cwd=cwd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd, env in cmds_envs]
    deadline = time.time() + timeout
    out = []
    try:
        for p in procs:
            text, _ = p.communicate(timeout=max(deadline - time.time(), 1))
            out.append((p.returncode, text))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    return out


# ---------------------------------------------------------------------------
# repairs
# ---------------------------------------------------------------------------

class _OnCard(torch.Tensor):
    """A CPU tensor that says it is on cuda:1, to reach a wrapper's launch."""

    @property
    def device(self):
        return torch.device("cuda", 1)


@pytest.mark.parametrize("kernel", ["fused_residual_unit", "fused_mrf_stage"])
def test_kernel_wrappers_launch_on_the_operands_device(kernel, monkeypatch):
    from emotivoice_tpu_torch.ops.cuda import build, mrf_stage, resblock

    current = []  # the device index set by the guard, innermost last
    seen = {}

    class Guard:
        def __init__(self, dev):
            self.index = torch.device(dev).index

        def __enter__(self):
            current.append(self.index)

        def __exit__(self, *exc):
            current.pop()

    def launch(name):
        def fn(*args):
            seen[name] = current[-1] if current else None
            return 0
        return fn

    lib = types.SimpleNamespace(evt_residual_unit_f32=launch("unit"),
                                evt_mrf_stage_f32=launch("stage"))
    monkeypatch.setattr(build, "load", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", Guard)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(resblock, "sm_count", lambda dev: 132)
    monkeypatch.setattr(mrf_stage, "sm_count", lambda dev: 132)
    rng = np.random.RandomState(0)

    def card(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).as_subclass(_OnCard)

    c = 128 if kernel == "fused_residual_unit" else 64
    x = card(1, 64, c)
    unit = (card(3, c, c), card(c), card(3, c, c), card(c))
    before = resblock.fused_residual_unit.launches, mrf_stage.fused_mrf_stage.launches
    if kernel == "fused_residual_unit":
        resblock.fused_residual_unit(x, *unit, 3, 1)
        assert seen == {"unit": 1}
        assert resblock.fused_residual_unit.launches == before[0] + 1
    else:
        mrf_stage.fused_mrf_stage(x, [[unit]], (3,), ((1,),))
        assert seen == {"stage": 1}
        assert mrf_stage.fused_mrf_stage.launches == before[1] + 1
    assert current == []


def _tf32_on(monkeypatch):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)


def _tf32_flags():
    return torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_serve_in_f32_turns_tf32_off(dtype, monkeypatch):
    from emotivoice_tpu_torch import serve
    from emotivoice_tpu_torch.serving import api

    _tf32_on(monkeypatch)
    served = []
    monkeypatch.setattr(api, "serve_stdlib", lambda service, host, port: served.append(port))
    monkeypatch.setitem(sys.modules, "uvicorn", None)
    serve.main(["--smoke-tiny", "--device", "cpu", "--no-warmup", "--no-background-warmup",
                "--port", "0", "--dtype", dtype])
    assert served == [0]
    assert _tf32_flags() == ((False, False) if dtype == "f32" else (True, True))


def test_synthesize_in_f32_turns_tf32_off(tmp_path, monkeypatch):
    from emotivoice_tpu_torch import synthesize

    _tf32_on(monkeypatch)
    (tmp_path / "lines.txt").write_text("")
    synthesize.main(["--test-file", str(tmp_path / "lines.txt"), "--output-dir",
                     str(tmp_path / "out"), "--device", "cpu"])
    assert _tf32_flags() == (False, False)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    from emotivoice_tpu_torch.data import synthetic_corpus

    path = tmp_path_factory.mktemp("corpus")
    synthetic_corpus.main(["--out", str(path), "--n-train", "8", "--n-valid", "2"])
    return path


def _train_args(corpus, out, *extra):
    return ["--datalist", str(corpus / "datalist.jsonl"),
            "--valid-datalist", str(corpus / "valid.jsonl"),
            "--tokenlist", str(corpus / "tokenlist"), "--speakers", str(corpus / "speakers"),
            "--output-dir", str(out), "--smoke-tiny", "--log-every", "1", *extra]


def test_train_turns_tf32_off(corpus, tmp_path, monkeypatch):
    from emotivoice_tpu_torch import train

    _tf32_on(monkeypatch)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)  # see RUN_TRAIN
    train.main(_train_args(corpus, tmp_path, "--device", "cpu", "--total-steps", "0"))
    assert _tf32_flags() == (False, False)


def test_weight_decay_is_refused():
    import dataclasses

    from emotivoice_tpu_torch.training.step import make_optimizer

    cfg = tiny_test_config()
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, weight_decay=1e-2))
    with pytest.raises(ValueError, match="optax.adam"):
        make_optimizer(cfg, [torch.nn.Parameter(torch.zeros(2))])


# ---------------------------------------------------------------------------
# the data-parallel train step: two ranks against one process
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dp_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("dp")
    port = _free_port()
    cmd = [sys.executable, WORKER, "step", "--steps", str(STEPS), "--out"]
    res = _run_all([(cmd + [str(d / "one.npz")], _env()),
                    (cmd + [str(d / "r0.npz")], _env(0, 2, port)),
                    (cmd + [str(d / "r1.npz")], _env(1, 2, port))], cwd=str(d))
    for rc, text in res:
        assert rc == 0, text[-3000:]
    return [dict(np.load(d / f)) for f in ("one.npz", "r0.npz", "r1.npz")]


def _grad_scale(one, key):
    largest = max(np.abs(v).max() for k, v in one.items() if k.startswith("grad/" + key[0]))
    return max(np.abs(one["grad/" + key]).max(), FLOOR * largest)


def _grad_errors(one, got, prefix="grad/"):
    return {k: np.abs(got[prefix + k] - one["grad/" + k]).max() / _grad_scale(one, k)
            for k in (n[5:] for n in one if n.startswith("grad/")) if prefix + k in got}


def test_two_ranks_step_one_gradients_equal_one_process(dp_runs):
    one, r0, r1 = dp_runs
    for got in (r0, r1):
        errs = _grad_errors(one, got)
        assert len(errs) == sum(k.startswith("grad/") for k in one) > 100
        worst = max(errs, key=errs.get)
        assert errs[worst] <= GRAD_TOL, (worst, errs[worst])


def test_two_ranks_five_steps_equal_one_process(dp_runs):
    one, r0, r1 = dp_runs
    metrics = [k for k in one if k.startswith("metric/")]
    assert len(metrics) == STEPS * 10
    for k in metrics:
        np.testing.assert_allclose(r0[k], one[k], rtol=LOSS_RTOL, err_msg=k)
    # the losses moved over the steps, so agreeing on them means something
    assert abs(one[f"metric/{STEPS - 1}/g_loss"] - one["metric/0/g_loss"]) > 0.1
    for s in range(STEPS):  # the global batch's segment starts, each rank its rows
        np.testing.assert_array_equal(np.concatenate([r0[f"starts/{s}"], r1[f"starts/{s}"]]),
                                      one[f"starts/{s}"])
    largest = max(np.abs(v).max() for k, v in one.items() if k.startswith("grad/"))
    params = [k for k in one if k.startswith("param/")]
    for k in params:
        grad = one.get("grad/" + k[6:])
        if grad is not None and np.abs(grad).max() < FLOOR * largest:
            atol = 2 * LR * STEPS  # round-off gradient: Adam moves it +-lr a step
        else:
            atol = PARAM_TOL * max(np.abs(one[k]).max(), 1e-6)
        np.testing.assert_allclose(r0[k], one[k], rtol=0, atol=atol, err_msg=k)
    # every parameter and buffer, spectral u and v included, equal on both ranks
    spectral = [k for k in params if k.endswith(("weight_u", "weight_v"))]
    assert spectral
    for k in params:
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)


def test_per_rank_masked_means_miss(dp_runs):
    """The control: averaging each rank's own masked means is not the
    global batch's masked mean when the ranks hold different lengths."""
    one, r0, _ = dp_runs
    errs = _grad_errors(one, r0, prefix="control_grad/")
    assert len(errs) > 50
    assert max(errs.values()) > 1000 * GRAD_TOL


def test_unequal_shards_agree_on_steps_and_shapes(tmp_path):
    port = _free_port()
    res = _run_all([([sys.executable, WORKER, "loader", "--out", str(tmp_path / f"{r}.json")],
                     _env(r, 3, port)) for r in range(3)], cwd=str(tmp_path))
    for rc, text in res:
        assert rc == 0, text[-3000:]
    runs = [json.load(open(tmp_path / f"{r}.json")) for r in range(3)]
    alone = np.array([r["alone"] for r in runs])  # (rank, epoch)
    assert (alone.min(0) < alone.max(0)).all()  # the shards do give different counts
    for r in runs:
        assert r["steps"] == alone.min(0).tolist()
        assert r["widths"] == runs[0]["widths"]  # one padded shape per step
    assert len({tuple(w) for w in runs[0]["widths"]}) > 1


# The CLI as `python -m`, with tensorboard hidden: where TensorFlow is
# installed, importing tensorboard pulls it in, seconds the other rank waits.
RUN_TRAIN = ("import runpy, sys; sys.modules['torch.utils.tensorboard'] = None; "
             "runpy.run_module('emotivoice_tpu_torch.train', run_name='__main__')")


def test_train_cli_on_two_ranks(corpus, tmp_path):
    out = tmp_path / "out"
    port = _free_port()
    args = _train_args(corpus, out, "--multihost", "--device", "cpu", "--batch-size", "4",
                       "--total-steps", "1", "--iters-per-validation", "1",
                       "--cache-dir", str(tmp_path / "cache"))
    cmd = [sys.executable, "-c", RUN_TRAIN] + args
    res = _run_all([(cmd, _env(r, 2, port)) for r in range(2)], cwd=ROOT)
    for r, (rc, text) in enumerate(res):
        assert rc == 0, text[-3000:]
        assert f"multihost: rank {r} of 2 on cpu" in text
    assert sorted(os.listdir(out / "ckpt")) == ["do_00000001", "g_00000001"]
    lines = open(out / "log" / "train_log.txt").read().splitlines()  # rank 0's alone
    assert [line.split()[0] for line in lines] == ["step=1", "step=1"]
    assert "g_loss=" in lines[0] and "mel_l1=" in lines[1]


def test_multihost_needs_a_card_per_local_rank(corpus, tmp_path, monkeypatch):
    from emotivoice_tpu_torch import serve, train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for k, v in dict(RANK="0", LOCAL_RANK="0", WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
                     MASTER_PORT="1").items():
        monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(_train_args(corpus, tmp_path, "--multihost"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--smoke-tiny", "--multihost"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--smoke-tiny", "--data-parallel", "2"])


# ---------------------------------------------------------------------------
# serving: engine replicas and one server per process
# ---------------------------------------------------------------------------

def _engines():
    cfg = tiny_test_config()
    vocab = TokenVocab.from_tokens(["_", "<sos/eos>", "a", "b", "c"])
    cfg = cfg.replace(am=cfg.am.__class__(**{**cfg.am.__dict__, "n_vocab": len(vocab)}))
    model = init_random_(JETSGenerator(cfg), seed=0)
    kw = dict(text_buckets=(8, 16), mel_buckets=(64, 128), batch_buckets=(1, 3, 4))
    return (SynthesisEngine(cfg, model, vocab, device="cpu", **kw),
            SynthesisEngine(cfg, model, vocab, devices=["cpu", "cpu"], **kw))


def test_engine_replicas_equal_one_replica(monkeypatch):
    one, two = _engines()
    assert two.replicas[1] is not two.replicas[0]
    rng = np.random.RandomState(0)
    d = one.cfg.am.bert_embedding
    phones = [["<sos/eos>"] + list(rng.choice(["a", "b", "c"], n)) + ["<sos/eos>"]
              for n in (3, 7, 5)]
    reqs = [SynthesisRequest(phonemes=p, speaker_id=i, style_embedding=rng.randn(d).astype(
        np.float32), content_embedding=rng.randn(d).astype(np.float32))
        for i, p in enumerate(phones)]
    rows = []
    run_replica = two._run_replica
    monkeypatch.setattr(two, "_run_replica", lambda i, arrays, *a: rows.append(
        (i, len(arrays[0]))) or run_replica(i, arrays, *a))
    want, got = one.synthesize_batch(reqs), two.synthesize_batch(reqs)
    # 3 requests: batch bucket 3, padded to 4 rows, 2 on each replica
    assert one.padded_rows(3) == 3 and two.padded_rows(3) == 4
    assert sorted(rows) == [(0, 2), (1, 2)]
    for w, g in zip(want, got):
        assert g.n_frames == w.n_frames > 0
        np.testing.assert_array_equal(g.wav, w.wav)
    rows.clear()
    two.warmup([(1, 8, 64)])  # warmup pads the same way
    assert sorted(rows) == [(0, 1), (1, 1)]


def test_serve_data_parallel_builds_replicas(monkeypatch):
    from emotivoice_tpu_torch import serve
    from emotivoice_tpu_torch.serving import api

    served = []
    monkeypatch.setattr(api, "serve_stdlib", lambda service, host, port: served.append(service))
    monkeypatch.setitem(sys.modules, "uvicorn", None)
    serve.main(["--smoke-tiny", "--device", "cpu", "--data-parallel", "2", "--port", "0",
                "--no-warmup", "--no-background-warmup"])
    engine = served[0].engine
    assert engine.devices == [torch.device("cpu")] * 2 and len(engine.replicas) == 2
    assert engine.padded_rows(1) == 2 and engine.padded_rows(3) == 4


def _post(port, body, timeout=120):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/audio/speech",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        assert resp.status == 200
        return resp.read()


def _wait_ready(port, proc, deadline):
    while time.time() < deadline:
        if proc.poll() is not None:
            raise AssertionError(f"server on port {port} exited: {proc.stdout.read()[-3000:]}")
        try:
            with socket.create_connection(("127.0.0.1", port), timeout=1):
                return
        except OSError:
            time.sleep(0.2)
    raise AssertionError(f"server on port {port} never listened")


def test_serve_multihost_processes_answer_as_one(tmp_path):
    body = {"input": "hello world", "voice": "3", "prompt": "happy",
            "response_format": "wav"}
    pg = _free_port()
    ports = [_free_port() for _ in range(3)]
    procs = []
    deadline = time.time() + TIMEOUT_S
    try:
        for i, port in enumerate(ports):
            cmd = [sys.executable, "-m", "emotivoice_tpu_torch.serve", "--smoke-tiny",
                   "--device", "cpu", "--host", "127.0.0.1", "--port", str(port),
                   "--no-warmup", "--no-background-warmup", "--no-batching"]
            env = _env() if i == 0 else _env(i - 1, 2, pg)
            procs.append(subprocess.Popen(cmd + (["--multihost"] if i else []), env=env,
                                          cwd=ROOT, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
        for port, proc in zip(ports, procs):
            _wait_ready(port, proc, deadline)
        got = [_post(port, body) for port in ports]
    finally:
        for p in procs:
            p.kill()
            p.wait(timeout=30)
    assert got[0][:4] == b"RIFF" and len(got[0]) > 1000
    assert got[1] == got[0] and got[2] == got[0]
