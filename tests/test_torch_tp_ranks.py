"""Tensor parallelism over the ranks of several processes in the port
(`parallel.mesh.make_rank_mesh`, `parallel.tensor_parallel.RankGroup`), on
the CPU over gloo, against one device, the single-process model group and
the JAX package's 'model' mesh axis (tiny_test_config, dropout off).

- Layout: the ranks of a world of W as (W / N, N), as JAX's `make_mesh`
  reshapes its device list, for W in {2, 4} and N in {1, 2, 4}; the groups
  the ranks really join (two ranks x TP(2), four ranks as DP(2) x TP(2)).
- Two ranks x TP(2) (`test_torch_tp_ranks_worker.py tp2`): inference
  against the JAX model-axis path at atol 1e-3 (run here, never in a
  worker) and against one device within 1e-5 of max, the vocoder alone on
  JAX's mel with the kernels on and off, both ranks' outputs equal; the
  V1 vocoder calls the MRF kernel wrappers 18 + 2 times on every rank, on
  whole weights; the engine equals the one-device engine, and a rank made
  to predict other durations takes the group's bucket (it would have
  redispatched alone, which hangs); one `TrainStep` against one device and
  against the single-process TP(2) step (which tests/test_torch_tensor_
  parallel.py holds to `make_parallel_train_step`): losses within
  LOSS_RTOL, gradients within GRAD_TOL of each tensor's max; whole
  parameters bit-equal on the ranks where one rank's backward rounds
  otherwise (and apart without the mean over the group); the state
  dicts and Adam's moments in the one-device layout, bit-equal both ways;
  `train()` for two steps over the ranks (one writer, validation through
  the kernels on both, checkpoints that restore bit-equal).
- The negative controls, each a trap the checks must catch:
  `torch.distributed.nn.functional.all_reduce` at the exit (the forward
  holds; each exit a gradient crosses backward multiplies it by N),
  per-shard weight norms (another function), an un-summed row-parallel g
  (exactly those gradients miss).
- Four ranks as DP(2) x TP(2): one step against one process on the global
  batch.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax

from test_torch_parallel import FLOOR, _env, _free_port, _run_all
from test_torch_parallel_worker import collate, global_rows, train_config
from test_torch_support import assert_close_rel, both_configs, jax_jets_params, port_jets
from test_torch_tp_ranks_worker import ENGINE_KW, engine_setup, v1_generator

from emotivoice_tpu.models.jets import JETSGenerator as JJETS
from emotivoice_tpu.parallel.mesh import make_mesh as jax_make_mesh
from emotivoice_tpu.parallel.sharding import tree_shardings
from emotivoice_tpu_torch.parallel.data_parallel import DataParallel
from emotivoice_tpu_torch.parallel.mesh import make_rank_mesh, rank_layout
from emotivoice_tpu_torch.parallel.sharding import shard_tensor
from emotivoice_tpu_torch.parallel.tensor_parallel import full_parameters, tensor_parallel
from emotivoice_tpu_torch.serving.engine import SynthesisEngine
from emotivoice_tpu_torch.training.loop import CheckpointManager, build_models
from emotivoice_tpu_torch.training.step import TrainStep

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "test_torch_tp_ranks_worker.py")
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4  # of each gradient's max (or of FLOOR x the largest, where smaller)
MAX_FRAMES = 32


def _spawn(mode, world, tmp_path, *extra):
    port = _free_port()
    out = tmp_path / mode
    out.mkdir()
    cmd = [sys.executable, WORKER, mode, "--out", str(out), *extra]
    res = _run_all([(cmd, _env(r, world, port)) for r in range(world)], cwd=str(tmp_path))
    for rc, text in res:
        assert rc == 0, text[-3000:]
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(world)]


def _inference_inputs(cfg, b=3, t_text=10, seed=10):
    rng = np.random.RandomState(seed)
    return tuple(torch.as_tensor(a) for a in (
        rng.randint(0, cfg.am.n_vocab, (b, t_text)), np.array([t_text, t_text - 3, 4][:b]),
        np.array([0, 3, 7][:b]), rng.randn(b, cfg.am.bert_embedding).astype(np.float32),
        rng.randn(b, cfg.am.bert_embedding).astype(np.float32)))


@pytest.fixture(scope="module")
def tp2(tmp_path_factory):
    """The two-rank run, with the JAX model-axis output of the plan's model
    and the one-device model it was converted into."""
    tmp = tmp_path_factory.mktemp("tp2")
    jc, tc = both_configs()
    params = jax_jets_params(jc, seed=3)
    mesh = jax_make_mesh(jax.devices()[:2], model_parallel_size=2)
    sharded = jax.device_put(params, tree_shardings(params, mesh))
    inputs = _inference_inputs(tc)
    fn = jax.jit(lambda p, *a: JJETS(jc, use_s2d=False).apply(p, *a, max_frames=MAX_FRAMES))
    want = {k: np.asarray(v) for k, v in fn(sharded, *(a.numpy() for a in inputs)).items()
            if k in ("durations", "output_lengths", "wav_predictions", "dec_outputs")}
    model = port_jets(tc, params)
    plan = dict(jets_state=model.state_dict(), inputs=inputs, max_frames=MAX_FRAMES,
                mel=torch.from_numpy(want["dec_outputs"].copy()))
    torch.save(plan, tmp / "plan.pt")
    ranks = _spawn("tp2", 2, tmp, "--plan", str(tmp / "plan.pt"), "--run-dir", str(tmp / "run"))
    return dict(jax=want, model=model, plan=plan, ranks=ranks, run_dir=tmp / "run")


@pytest.fixture(scope="module")
def dp2tp2(tmp_path_factory):
    return _spawn("dp2tp2", 4, tmp_path_factory.mktemp("dp2tp2"))


def _trainer(cfg, group):
    torch.manual_seed(0)
    models = [tensor_parallel(m, group) for m in build_models(cfg, torch.device("cpu"))]
    return TrainStep(cfg, *models, steps_per_epoch=1000, dp=DataParallel())


@pytest.fixture(scope="module")
def references(tp2):
    """One step on the global batch, at the ranks' segment starts, on one
    device and over the single-process model group [cpu, cpu]: metrics and
    whole gradients by name, and the one-device trainer."""
    cfg = train_config()
    batch = collate(global_rows(cfg, seed=100))
    starts = tp2["ranks"][0]["step"]["starts"]
    out = {}
    for name, group in (("one", ["cpu"]), ("local", ["cpu", "cpu"])):
        trainer = _trainer(cfg, group)
        metrics = trainer(batch, start_idxs=starts)
        grads = {}
        for prefix, module in (("g", trainer.model), ("d", trainer.disc)):
            for pname, parts, dim in full_parameters(module):
                if parts[0].grad is not None:
                    g = parts[0].grad if dim is None else torch.cat([p.grad for p in parts], dim)
                    grads[f"{prefix}.{pname}"] = g
        out[name] = dict(metrics={k: float(v) for k, v in metrics.items()}, grads=grads,
                         trainer=trainer)
    return out


def _whole(ranks, key, field):
    """A parameter's `field` (1 the value, 2 the gradient, 3-4 Adam's
    moments) over the model group `ranks`, in the one-device layout."""
    dim = ranks[0][key][0]
    parts = [r[key][field] for r in ranks]
    return parts[0] if dim is None else torch.cat(parts, dim)


def _rank_grads(ranks):
    return {k: _whole(ranks, k, 2) for k in ranks[0] if ranks[0][k][2] is not None}


def _grad_errors(want, got):
    """Per gradient: max |got - want| over its max (or FLOOR x the largest)."""
    largest = max(float(g.abs().max()) for g in want.values())
    return {k: float((got[k] - w).abs().max()) / max(float(w.abs().max()), FLOOR * largest)
            for k, w in want.items()}


def _check_step(got_metrics, got_grads, ref):
    """The step's check: every loss within LOSS_RTOL, every gradient within
    GRAD_TOL. Returns the worst (relative loss error, gradient error, name)."""
    assert set(got_metrics) == set(ref["metrics"]) and set(got_grads) == set(ref["grads"])
    loss = max(abs(got_metrics[k] - v) / max(abs(v), 1e-12) for k, v in ref["metrics"].items())
    errs = _grad_errors(ref["grads"], got_grads)
    worst = max(errs, key=errs.get)
    return loss, errs[worst], worst, errs


def _passes(check) -> bool:
    loss, grad, _, _ = check
    return loss <= LOSS_RTOL and grad <= GRAD_TOL


# ---------------------------------------------------------------------------
# the layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("n_model", [1, 2, 4])
def test_rank_layout_matches_jax_make_mesh(world, n_model):
    if world % n_model:
        with pytest.raises(ValueError):
            rank_layout(world, n_model)
        return
    jmesh = jax_make_mesh(jax.devices()[:world], model_parallel_size=n_model)
    want = np.vectorize(lambda d: d.id)(jmesh.devices)
    got = rank_layout(world, n_model)
    np.testing.assert_array_equal(got, want)
    assert jmesh.axis_names == ("data", "model") and got.shape == (world // n_model, n_model)


def test_ranks_join_their_groups(tp2, dp2tp2):
    assert make_rank_mesh(1).model_group is None  # one process: a mesh of one rank
    for ranks, n_model in ((tp2["ranks"], 2), (dp2tp2, 2)):
        layout = rank_layout(len(ranks), n_model)
        for r, out in enumerate(ranks):
            m = out["mesh"]
            d, i = divmod(r, n_model)
            assert (m["data_index"], m["model_index"]) == (d, i)
            assert (m["n_data"], m["n_model"]) == layout.shape
            assert m["model_ranks"] == layout[d].tolist()
            assert m["data_ranks"] == layout[:, i].tolist()


# ---------------------------------------------------------------------------
# inference, the kernels' path and the engine
# ---------------------------------------------------------------------------

def test_inference_over_ranks_matches_one_device_and_jax(tp2):
    want, model, plan = tp2["jax"], tp2["model"], tp2["plan"]
    r0, r1 = tp2["ranks"]
    assert r0["split_layers"] == "RowParallel"
    with torch.no_grad():
        one = model(*plan["inputs"], max_frames=MAX_FRAMES)
    got = r0["infer"]
    np.testing.assert_array_equal(got["durations"].numpy(), want["durations"])
    np.testing.assert_array_equal(got["output_lengths"].numpy(), want["output_lengths"])
    assert np.max(np.abs(want["wav_predictions"])) > 1e-2
    np.testing.assert_allclose(got["wav_predictions"].numpy(), want["wav_predictions"],
                               atol=1e-3)
    assert torch.equal(got["durations"], one["durations"])
    assert_close_rel(got["wav_predictions"], one["wav_predictions"], 1e-5)
    for k in got:
        assert torch.equal(r1["infer"][k], got[k]), k
    for kernels in (True, False):
        key = f"vocoder_kernels_{kernels}"
        model.generator.kernels = kernels
        with torch.no_grad():
            ref = model.generator(plan["mel"])
        np.testing.assert_allclose(r0[key].numpy(), want["wav_predictions"], atol=1e-3)
        assert_close_rel(r0[key], ref, 1e-5)
        assert torch.equal(r1[key], r0[key]), key
    # whole weights are gathered on every call with the kernels, not without
    assert r0["calls_kernels_True"]["all_gather"] > r0["calls_kernels_False"]["all_gather"]


def test_kernel_path_over_ranks_calls_18_plus_2_on_whole_weights(tp2):
    gen, mel = v1_generator()
    with torch.inference_mode():
        ref = gen(mel)
    for out in tp2["ranks"]:
        calls = out["v1_calls"]
        assert (len(calls["unit"]), len(calls["stage"])) == (18, 2)
        assert all(w1 == w2 == (k, c, c) for (c, w1, w2), k in
                   zip(calls["unit"], [3, 3, 3, 7, 7, 7, 11, 11, 11] * 2))
        assert [c for c, _ in calls["stage"]] == [64, 32]
        assert all(w == (3, c, c) for c, w in calls["stage"])
        assert_close_rel(out["v1_wav"], ref, 1e-5)
    assert torch.equal(tp2["ranks"][0]["v1_wav"], tp2["ranks"][1]["v1_wav"])


def test_engine_over_ranks_equals_one_device(tp2):
    cfg, vocab, model, reqs = engine_setup()
    want = SynthesisEngine(cfg, model, vocab, device="cpu", **ENGINE_KW).synthesize_batch(reqs)
    r0, r1 = (out["engine"] for out in tp2["ranks"])
    assert r0["n_frames"] == r1["n_frames"] == [w.n_frames for w in want]
    assert all(n > 0 for n in r0["n_frames"])
    for w, a, b in zip(want, r0["wavs"], r1["wavs"]):
        assert_close_rel(a, w.wav, 1e-5)
        np.testing.assert_array_equal(a, b)


def test_engine_ranks_follow_the_group_bucket(tp2):
    """Rank 1 predicts ~20x the durations: alone it would fill the first
    mel bucket and redispatch into the next, where rank 0 would never
    follow; it takes rank 0's frame counts instead, and both finish."""
    r0, r1 = (out["engine_skew"] for out in tp2["ranks"])
    first = r0["first_bucket"]
    assert max(r0["own_frames"]) < first <= max(r1["own_frames"])  # rank 1 alone: redispatch
    assert r1["n_frames"] == r0["n_frames"] == tp2["ranks"][0]["engine"]["n_frames"]
    assert r0["redispatches"] == r1["redispatches"] == 0
    assert r0["truncations"] == r1["truncations"] == 0


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def test_train_step_over_ranks_matches_one_device_and_local_tp(tp2, references):
    r0, r1 = (out["step"] for out in tp2["ranks"])
    grads = _rank_grads([r0["params"], r1["params"]])
    assert len(grads) > 100
    for ref in (references["one"], references["local"]):
        loss, grad, worst, _ = _check_step(r0["metrics"], grads, ref)
        assert loss <= LOSS_RTOL and grad <= GRAD_TOL, (loss, worst, grad)
    assert r0["metrics"] == r1["metrics"]
    for k, (dim, _, g, _, _) in r0["params"].items():
        if dim is None and g is not None:  # the whole parameters' gradients agree
            assert torch.equal(g, r1["params"][k][2]), k


def test_replicated_parameters_stay_equal_on_the_ranks(tp2):
    """Rank 1's backward gives two whole parameters' gradients 1e-3 more
    (a card's atomics round differently on each rank, far less): with
    their mean over the group every whole parameter and moment stays
    bit-equal on the ranks; without it (the control) those two part."""
    r0, r1 = (out["replicated"] for out in tp2["ranks"])
    c0, c1 = (out["replicated_control"] for out in tp2["ranks"])
    touched = {"g.am.src_word_emb.weight", "d.msd.discriminators.0.convs.0.weight_orig"}
    for k, (dim, p, _, m1, m2) in r0.items():
        if dim is None:
            assert torch.equal(p, r1[k][1]) and torch.equal(m1, r1[k][3]), k
            assert torch.equal(c0[k][1], c1[k][1]) != (k in touched), k


@pytest.mark.parametrize("control", ["exit_all_reduce", "per_shard_norm", "unsummed_g"])
def test_negative_control_fails_the_check(tp2, references, control):
    ranks = [out[f"control/{control}"] for out in tp2["ranks"]]
    grads = _rank_grads([r["params"] for r in ranks])
    ref = references["one"]
    check = _check_step(ranks[0]["metrics"], grads, ref)
    assert not _passes(check), check[:3]
    loss, _, _, errs = check
    if control == "exit_all_reduce":
        # the forward holds; after the last exit the gradient is exact,
        # before it each exit crossed multiplies it by N = 2
        assert loss <= LOSS_RTOL
        assert errs["g.generator.conv_post.bias"] <= GRAD_TOL
        k = "g.am.src_word_emb.weight"
        assert float(grads[k].norm() / ref["grads"][k].norm()) > 2.0
    elif control == "per_shard_norm":  # another function
        assert loss > 1e-3
    else:  # the whole g of each layer whose norm spans the shards, and nothing else
        missed = {k for k, e in errs.items() if e > GRAD_TOL}
        local = references["local"]["trainer"].model
        spanning = {f"g.{name}" for name, _, dim in full_parameters(local)
                    if name.startswith("generator.") and name.endswith("weight_g")
                    and dim is None}
        assert loss <= LOSS_RTOL
        assert missed and missed <= spanning, sorted(missed - spanning)
        assert any(".convs2." in k for k in missed) and any(".ups." in k for k in missed)


def test_rank_state_round_trips_to_one_device(tp2, references):
    """The ranks' gathered state in a one-device trainer: its every split
    parameter and Adam moment, cut as the ranks cut it, bit-equal to each
    rank's part; and that state loaded back into fresh rank-group
    trainers: their parts bit-equal to the live ones."""
    cfg = train_config()
    state = tp2["ranks"][0]["state"]
    one = _trainer(cfg, ["cpu"])
    one.model.load_state_dict(state["g"])
    one.disc.load_state_dict(state["d"])
    one.load_state_dict(state["t"])
    assert one.count == 1
    params = {**{f"g.{k}": p for k, p in one.model.named_parameters()},
              **{f"d.{k}": p for k, p in one.disc.named_parameters()}}
    opt_state = {**one.opt_g.state, **one.opt_d.state}
    n_split = 0
    for r, out in enumerate(tp2["ranks"]):
        live = out["step"]["params"]
        assert set(live) == set(params)
        for k, (dim, part, _, m1, m2) in live.items():
            whole = params[k]
            cut = (lambda t: t) if dim is None else (lambda t: shard_tensor(t, dim, 2)[r])
            assert torch.equal(cut(whole.detach()), part), k
            assert torch.equal(cut(opt_state[whole]["exp_avg"]), m1), k
            assert torch.equal(cut(opt_state[whole]["exp_avg_sq"]), m2), k
            n_split += dim is not None
        for k, (dim, part, _, m1, m2) in out["back_params"].items():
            assert torch.equal(part, live[k][1]), k
            assert torch.equal(m1, live[k][3]) and torch.equal(m2, live[k][4]), k
        assert out["back_count"] == 1
    assert n_split > 100
    # the whole layout is the one-device one
    assert list(state["g"]) == list(references["one"]["trainer"].model.state_dict())


def test_train_loop_over_ranks(tp2):
    """`train()` on the two ranks: the world's rank 0 alone writes (one log
    line a step, one validation line), both ranks validate (the pass
    gathers the kernels' weights over the group), and the checkpoint
    restores into fresh rank-group trainers bit-equal."""
    run = tp2["run_dir"]
    lines = (run / "log" / "train_log.txt").read_text().splitlines()
    steps = [ln.split()[0] for ln in lines if "g_loss=" in ln]
    assert steps == ["step=1", "step=2"]
    valid = [ln for ln in lines if "mel_l1=" in ln]
    assert len(valid) == 1 and valid[0].startswith("step=2")
    assert sorted(os.listdir(run / "ckpt")) == ["do_00000002", "g_00000002"]
    for out in tp2["ranks"]:
        loop = out["loop"]
        assert loop["count"] == 2 and loop["restored_step"] == 2
        for k, (dim, part, _, m1, m2) in loop["params"].items():
            got = loop["restored_params"][k]
            assert torch.equal(got[1], part), k
            assert torch.equal(got[3], m1) and torch.equal(got[4], m2), k
    # and into a one-device trainer
    one = _trainer(train_config(), ["cpu"])
    assert CheckpointManager(str(run / "ckpt")).restore(one) == 2
    r0, r1 = (out["loop"]["params"] for out in tp2["ranks"])
    for k, p in one.model.named_parameters():
        assert torch.equal(p.detach(), _whole([r0, r1], f"g.{k}", 1)), k


def test_dp2_times_tp2_matches_one_process(dp2tp2, references):
    steps = [out["step"] for out in dp2tp2]
    for a, b in ((0, 2), (1, 3)):  # one shard, two data indices: the mean gradient
        for k, v in steps[a]["params"].items():
            if v[2] is not None:
                assert torch.equal(v[2], steps[b]["params"][k][2]), k
    grads = _rank_grads([steps[0]["params"], steps[1]["params"]])
    loss, grad, worst, _ = _check_step(steps[0]["metrics"], grads, references["one"])
    assert loss <= LOSS_RTOL and grad <= GRAD_TOL, (loss, worst, grad)
    assert all(s["metrics"] == steps[0]["metrics"] for s in steps)
