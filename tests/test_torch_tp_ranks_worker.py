"""Subprocess worker of tests/test_torch_tp_ranks.py (no tests of its own).

One rank of a (data, model) mesh of gloo ranks on the CPU, the models split
over the rank's model group (`parallel.tensor_parallel.RankGroup`). The
rank and the world come from the torchrun environment (RANK, WORLD_SIZE,
MASTER_ADDR, MASTER_PORT). It imports no JAX: the parent hands it the JAX
model's parameters in the port's layout (`--plan`, a `torch.save` file).
Each rank writes what it computed to `<out>/rank<r>.pt`, split parameters
as its own parts, whole ones as its copy. Modes:

  tp2   two ranks, one model group of 2: the mesh; the JETS model of the
        plan over the group on the plan's inputs (durations, waveform), its
        vocoder on the plan's mel with kernels on and off; the HiFi-GAN V1
        vocoder through the MRF kernel wrappers (calls, shapes); the engine
        on three requests, and again with rank 1's duration predictor
        skewed (rank 1 alone would redispatch); one `TrainStep` (metrics,
        gradients, the models' and the optimizers' state gathered into the
        one-device layout, and loaded back into fresh rank-group trainers);
        one step with rank 1's whole-parameter gradients rounded
        otherwise, with and without their mean over the group; the three
        negative controls, one step each; `train()` for two steps with
        validation and checkpoints.
  dp2tp2  four ranks, data 2 x model 2: the mesh and one `TrainStep` on
        the rank's data shard of the global batch.
"""

import argparse
import dataclasses
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from test_torch_parallel_worker import collate, global_rows, train_config  # noqa: E402

from emotivoice_tpu_torch.config import VocoderConfig, tiny_test_config  # noqa: E402
from emotivoice_tpu_torch.models import hifigan  # noqa: E402
from emotivoice_tpu_torch.models.jets import JETSGenerator, init_random_  # noqa: E402
from emotivoice_tpu_torch.parallel import tensor_parallel as tp  # noqa: E402
from emotivoice_tpu_torch.parallel.data_parallel import DataParallel  # noqa: E402
from emotivoice_tpu_torch.parallel.mesh import make_rank_mesh  # noqa: E402
from emotivoice_tpu_torch.parallel.multihost import initialize_multihost  # noqa: E402

SKEW = 3.0  # added to rank 1's log-duration bias: ~20x the frames
ENGINE_TOKENS = ["_", "<sos/eos>", "a", "b", "c"]
ENGINE_LENGTHS = (3, 7, 5)
ENGINE_KW = dict(text_buckets=(8, 16), mel_buckets=(128, 256), batch_buckets=(1, 3, 4))


def engine_setup():
    """(config, vocab, seeded model, requests) of the engine cases (the
    parent builds the same for its one-device engine)."""
    from emotivoice_tpu_torch.frontend.tokens import TokenVocab
    from emotivoice_tpu_torch.serving.engine import SynthesisRequest

    cfg = tiny_test_config()
    vocab = TokenVocab.from_tokens(ENGINE_TOKENS)
    cfg = cfg.replace(am=dataclasses.replace(cfg.am, n_vocab=len(vocab)))
    model = init_random_(JETSGenerator(cfg), seed=0)
    rng = np.random.RandomState(0)
    d = cfg.am.bert_embedding
    reqs = [SynthesisRequest(
        phonemes=["<sos/eos>"] + list(rng.choice(["a", "b", "c"], n)) + ["<sos/eos>"],
        speaker_id=i, style_embedding=rng.randn(d).astype(np.float32),
        content_embedding=rng.randn(d).astype(np.float32))
        for i, n in enumerate(ENGINE_LENGTHS)]
    return cfg, vocab, model, reqs


def v1_generator():
    """The HiFi-GAN V1 vocoder (18 + 2 kernel calls a generator call) on the
    tiny model's mels, seeded, and its input mel."""
    cfg = tiny_test_config()
    cfg = cfg.replace(vocoder=VocoderConfig(initial_channel=cfg.am.n_mels))
    gen = init_random_(JETSGenerator(cfg), seed=9).generator.eval()
    mel = torch.randn(1, 4, cfg.am.n_mels, generator=torch.Generator().manual_seed(2))
    return gen, mel


def fresh_trainer(cfg, group, dp):
    from emotivoice_tpu_torch.training.loop import build_models
    from emotivoice_tpu_torch.training.step import TrainStep

    torch.manual_seed(0)
    models = [tp.tensor_parallel(m, group) for m in build_models(cfg, torch.device("cpu"))]
    return TrainStep(cfg, *models, steps_per_epoch=1000, dp=dp)


def local_params(trainer):
    """{prefix.name: (split dim, held part, its gradient, Adam's exp_avg,
    exp_avg_sq)} of every parameter of both models, this rank's part."""
    out = {}
    for prefix, module, opt in (("g", trainer.model, trainer.opt_g),
                                ("d", trainer.disc, trainer.opt_d)):
        for name, parts, dim in tp.full_parameters(module):
            (p,) = parts
            st = opt.state.get(p, {})
            out[f"{prefix}.{name}"] = (
                dim, p.detach().clone(), None if p.grad is None else p.grad.clone(),
                st.get("exp_avg"), st.get("exp_avg_sq"))
    return out


def one_step(cfg, group, dp, batch):
    trainer = fresh_trainer(cfg, group, dp)
    starts = []
    draw = trainer.draw_starts
    trainer.draw_starts = lambda lengths: starts.append(draw(lengths)) or starts[-1]
    metrics = trainer(dp.shard_batch(batch))
    return trainer, {k: float(v) for k, v in metrics.items()}, starts[0]


# ---------------------------------------------------------------------------
# the negative controls: each replaces one collective or fold with its trap
# ---------------------------------------------------------------------------

def _dims(v):
    return tuple(range(1, v.dim()))


def _per_shard_norm(self):
    """The fold with each rank's own part's norm (a norm that spans the
    shards taken per shard)."""
    if not self.wn or self.dim == 0:
        return REAL_WEIGHTS(self)
    gains = self.group.enter(self.weight_g)
    return [g * v / torch.clamp(torch.sqrt(torch.sum(v * v, dim=_dims(v), keepdim=True)),
                                min=1e-12)
            for g, v in zip(gains, self.parts("weight_v"))]


def _unsummed_g(self):
    """The fold with the whole g used as it is: its gradient stays the
    rank's partial."""
    if not self.wn or self.dim == 0:
        return REAL_WEIGHTS(self)
    vs = self.parts("weight_v")
    sq = self.group.reduce([torch.sum(v * v, dim=_dims(v), keepdim=True) for v in vs])
    norms = self.group.enter(torch.clamp(torch.sqrt(sq), min=1e-12))
    return [self.weight_g * v / n for v, n in zip(vs, norms)]


def _exit_dist_nn_all_reduce(self, parts):
    """The exit by partial sums through torch.distributed.nn's all_reduce,
    whose backward all-reduces again."""
    import torch.distributed.nn.functional as dnn

    (part,) = parts
    return dnn.all_reduce(part, group=self.group)


REAL_WEIGHTS = tp._ParallelLayer.weights
CONTROLS = {
    "exit_all_reduce": (tp.RankGroup, "reduce", _exit_dist_nn_all_reduce),
    "per_shard_norm": (tp._ParallelLayer, "weights", _per_shard_norm),
    "unsummed_g": (tp._ParallelLayer, "weights", _unsummed_g),
}


# ---------------------------------------------------------------------------
# the modes
# ---------------------------------------------------------------------------

def mesh_info(mesh):
    return dict(data_index=mesh.data_index, model_index=mesh.model_index, n_data=mesh.n_data,
                n_model=mesh.n_model,
                model_ranks=dist.get_process_group_ranks(mesh.model_group),
                data_ranks=dist.get_process_group_ranks(mesh.data_group))


def run_tp2(args, rank, out):
    from emotivoice_tpu_torch.serving.engine import SynthesisEngine, _bucket
    from emotivoice_tpu_torch.training.loop import CheckpointManager, train

    plan = torch.load(args.plan, weights_only=False)
    mesh = make_rank_mesh(2)
    out["mesh"] = mesh_info(mesh)
    group = tp.RankGroup(mesh.model_group, "cpu")
    dp = DataParallel.from_mesh(mesh, "cpu")

    # inference: the plan's JETS model over the group
    model = JETSGenerator(tiny_test_config())
    model.load_state_dict(plan["jets_state"], strict=False)
    model = tp.tensor_parallel(model.eval(), group)
    out["split_layers"] = type(model.generator.conv_post).__name__
    with torch.no_grad():
        o = model(*plan["inputs"], max_frames=plan["max_frames"])
        out["infer"] = {k: o[k] for k in ("durations", "output_lengths", "wav_predictions")}
        for kernels in (True, False):
            model.generator.kernels = kernels
            group.calls.clear()
            out[f"vocoder_kernels_{kernels}"] = model.generator(plan["mel"])
            out[f"calls_kernels_{kernels}"] = dict(group.calls)

    # the kernels' path: the V1 vocoder through the wrappers
    gen, mel = v1_generator()
    gen = tp.tensor_parallel(gen, group)
    calls = {"unit": [], "stage": []}
    unit, stage = hifigan.fused_residual_unit, hifigan.fused_mrf_stage

    def count_unit(x, w1, b1, w2, b2, k, d):
        calls["unit"].append((x.shape[-1], tuple(w1.shape), tuple(w2.shape)))
        return unit(x, w1, b1, w2, b2, k, d)

    def count_stage(x, weights, ks, ds):
        calls["stage"].append((x.shape[-1], tuple(weights[0][0][0].shape)))
        return stage(x, weights, ks, ds)

    hifigan.fused_residual_unit, hifigan.fused_mrf_stage = count_unit, count_stage
    try:
        with torch.inference_mode():
            out["v1_wav"] = gen(mel)
    finally:
        hifigan.fused_residual_unit, hifigan.fused_mrf_stage = unit, stage
    out["v1_calls"] = calls

    # the engine, then with rank 1's durations skewed
    for name in ("engine", "engine_skew"):
        cfg, vocab, emodel, reqs = engine_setup()
        if name == "engine_skew" and rank == 1:
            with torch.no_grad():
                emodel.am.duration_predictor.linear.bias.add_(SKEW)
        engine = SynthesisEngine(cfg, emodel, vocab, model_group=group, **ENGINE_KW)
        res = engine.synthesize_batch(reqs)
        out[name] = dict(n_frames=[r.n_frames for r in res], wavs=[r.wav for r in res],
                         redispatches=engine.saturation_redispatches,
                         truncations=engine.saturation_truncations)
        # the frames this rank's own durations give in the first bucket,
        # one dispatch without the group's agreement
        ids = [vocab.encode(r.phonemes) for r in reqs]
        t_text = _bucket(max(len(t) for t in ids), engine.text_buckets)
        first = _bucket(int(t_text * engine.frames_per_token), engine.mel_buckets)
        engine.model_group = None
        out[name]["own_frames"] = [r.n_frames for r in engine._dispatch(reqs, ids, t_text,
                                                                          first, 1.0)]
        out[name]["first_bucket"] = first

    # one train step, its state in the one-device layout, and back
    cfg = train_config()
    batch = collate(global_rows(cfg, seed=100))
    trainer, metrics, starts = one_step(cfg, group, dp, batch)
    out["step"] = dict(metrics=metrics, starts=starts, params=local_params(trainer))
    state = dict(g=trainer.model.state_dict(), d=trainer.disc.state_dict(),
                 t=trainer.state_dict())  # every rank of the group gathers
    if rank == 0:
        out["state"] = state
    back = fresh_trainer(cfg, group, dp)
    back.model.load_state_dict(state["g"])
    back.disc.load_state_dict(state["d"])
    back.load_state_dict(state["t"])
    out["back_params"] = local_params(back)
    out["back_count"] = back.count

    # a rank whose backward rounds a whole parameter's gradient otherwise
    # (as a card's atomics may): the ranks' copies stay equal, and without
    # the mean over the group they part
    import emotivoice_tpu_torch.training.step as step_module

    real_mean = step_module.mean_replicated_grads
    for name in ("replicated", "replicated_control"):
        if name == "replicated_control":
            step_module.mean_replicated_grads = lambda module: None
        try:
            trainer = fresh_trainer(cfg, group, dp)
            if rank == 1:
                for p in (trainer.model.am.src_word_emb.weight,
                          trainer.disc.msd.discriminators[0].convs[0].weight_orig):
                    p.register_hook(lambda g: g * (1 + 1e-3))
            trainer(dp.shard_batch(batch))
        finally:
            step_module.mean_replicated_grads = real_mean
        out[name] = local_params(trainer)

    # the negative controls
    for name, (owner, attr, fn) in CONTROLS.items():
        real = getattr(owner, attr)
        setattr(owner, attr, fn)
        try:
            trainer, metrics, _ = one_step(cfg, group, dp, batch)
        finally:
            setattr(owner, attr, real)
        out[f"control/{name}"] = dict(metrics=metrics, params=local_params(trainer))

    # train(): two steps, validation through the kernels, checkpoints
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, iters_per_validation=2,
                                                iters_per_checkpoint=2))
    torch.manual_seed(0)
    from emotivoice_tpu_torch.training.loop import build_models

    models = tuple(tp.tensor_parallel(m, group) for m in build_models(cfg, torch.device("cpu")))
    numpy_batch = {k: v.numpy() for k, v in batch.items()}
    trainer = train(cfg, lambda: iter([numpy_batch]), args.run_dir, total_steps=2,
                    valid_batch_iter_fn=lambda: iter([numpy_batch]), log_every=1,
                    device="cpu", models=models, dp=dp)
    out["loop"] = dict(count=trainer.count, params=local_params(trainer))
    dist.barrier()
    restored = fresh_trainer(cfg, group, dp)
    out["loop"]["restored_step"] = CheckpointManager(os.path.join(args.run_dir, "ckpt")).restore(
        restored)
    out["loop"]["restored_params"] = local_params(restored)


def run_dp2tp2(args, rank, out):
    mesh = make_rank_mesh(2)
    out["mesh"] = mesh_info(mesh)
    group = tp.RankGroup(mesh.model_group, "cpu")
    dp = DataParallel.from_mesh(mesh, "cpu")
    cfg = train_config()
    trainer, metrics, starts = one_step(cfg, group, dp, collate(global_rows(cfg, seed=100)))
    out["step"] = dict(metrics=metrics, starts=starts, params=local_params(trainer))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=["tp2", "dp2tp2"])
    ap.add_argument("--out", required=True, help="directory of the ranks' outputs")
    ap.add_argument("--plan", default=None)
    ap.add_argument("--run-dir", default=None, help="train()'s output directory (tp2)")
    args = ap.parse_args()
    torch.set_num_threads(1)
    # where TensorFlow is installed, importing tensorboard pulls it in:
    # seconds the other ranks wait
    sys.modules["torch.utils.tensorboard"] = None
    rank, world = initialize_multihost("cpu", timeout_s=240)
    out = {"rank": rank, "world": world}
    try:
        (run_tp2 if args.mode == "tp2" else run_dp2tp2)(args, rank, out)
        torch.save(out, os.path.join(args.out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
