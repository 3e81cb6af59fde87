"""The port's training step over several updates, its loop and its CLI, on
the CPU (tiny_test_config).

- Trajectory: three steps of the JAX package's `make_train_step` (jitted)
  and of the port's `TrainStep` from the same parameters, on three batches,
  the port replaying JAX's segment starts; lr 1e-3 with gamma 0.5 per epoch
  of 2 steps, so the third update runs at half the rate. Every metric at
  every step within 1e-4 relative, and each metric must move between steps
  by more than that, so the comparison can fail.
- Loop: a run resumed from its checkpoint ends bit-equal to a run that did
  not stop (step count, both optimizers, the segment draws and the dropout
  RNG all restored); rotation keeps `max_to_keep` pairs.
- CLI: `python -m emotivoice_tpu_torch.train` on a synthetic corpus, the
  JAX tool's flag that does not exist in the port is refused, and a warm
  start from the checkpoints the port wrote (speaker table grown by 2).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_support import (
    jax_disc_variables,
    jax_jets_params,
    port_discriminator,
    port_jets,
    train_configs,
)
from test_torch_train import jax_models, jax_segment_starts, training_batch

from emotivoice_tpu.training.step import TrainState, make_optimizers, make_train_step
from emotivoice_tpu_torch.training.step import TrainStep

RTOL = 1e-4
METRICS = ("mel_loss", "adv_loss", "fm_loss", "dur_loss", "pitch_loss", "energy_loss",
           "forwardsum_loss", "bin_loss", "g_loss", "d_loss")  # the JAX step's names


def _torch_batch(batch):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v)
            for k, v in batch.items()}


def test_three_steps_match_make_train_step():
    jc, tc = train_configs(lr=1e-3, lr_gamma_per_epoch=0.5)
    steps_per_epoch = 2
    g_params = jax_jets_params(jc, seed=41, with_alignment=True)
    d_params, spectral = jax_disc_variables(jc.disc, seed=42)
    opt_g, opt_d = make_optimizers(jc, steps_per_epoch)
    state = TrainState(step=jnp.zeros((), jnp.int32), g_params=g_params["params"],
                       d_params=d_params, d_spectral=spectral,
                       opt_g=opt_g.init(g_params["params"]), opt_d=opt_d.init(d_params),
                       rng=jax.random.PRNGKey(43))
    step_fn = jax.jit(make_train_step(jc, *jax_models(jc), steps_per_epoch))

    model = port_jets(tc, g_params)
    model.generator.kernels = False
    trainer = TrainStep(tc, model, port_discriminator(tc, d_params, spectral), steps_per_epoch)
    history = []
    for i in range(3):
        batch = training_batch(jc, seed=44 + i)
        _, starts = jax_segment_starts(state.rng, batch, jc.train.segment_size)
        state, want = step_fn(state, batch)
        got = trainer(_torch_batch(batch), start_idxs=torch.from_numpy(starts))
        assert set(got) == set(want) == set(METRICS)
        for k in METRICS:
            np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=RTOL,
                                       err_msg=f"step {i + 1} {k}")
        history.append({k: float(want[k]) for k in METRICS})
    assert trainer.count == int(state.step) == 3
    # step 3's batch again: the metrics moved (dur_loss by the updates alone,
    # the segment losses also by the new crop), so the comparison can fail
    batch = training_batch(jc, seed=46)
    _, starts = jax_segment_starts(state.rng, batch, jc.train.segment_size)
    state, want = step_fn(state, batch)
    got = trainer(_torch_batch(batch), start_idxs=torch.from_numpy(starts))
    for k in ("mel_loss", "g_loss", "d_loss", "dur_loss"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=RTOL, err_msg=k)
        assert abs(float(want[k]) - history[-1][k]) > 10 * RTOL * abs(float(want[k])), k


def _loop_batches(cfg, n=2):
    return [training_batch(cfg, seed=50 + i) for i in range(n)]


def _run(cfg, out, total, batches):
    from emotivoice_tpu_torch.training.loop import train

    return train(cfg, lambda: iter(batches), str(out), total_steps=total,
                 steps_per_epoch=len(batches), log_every=1, device="cpu")


def test_loop_resume_equals_an_unbroken_run(tmp_path, capsys):
    import dataclasses

    from emotivoice_tpu_torch.config import tiny_test_config

    cfg = tiny_test_config()  # dropout on: the RNG state matters
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, iters_per_checkpoint=1000))
    batches = _loop_batches(cfg)
    straight = _run(cfg, tmp_path / "a", 4, batches)
    _run(cfg, tmp_path / "b", 2, batches)
    capsys.readouterr()
    resumed = _run(cfg, tmp_path / "b", 4, batches)
    assert "resumed from step 2" in capsys.readouterr().out
    assert straight.count == resumed.count == 4
    for a, b in ((straight.model, resumed.model), (straight.disc, resumed.disc)):
        for (k, x), y in zip(a.state_dict().items(), b.state_dict().values()):
            assert torch.equal(x, y), k
    sa, sb = straight.opt_g.state_dict()["state"], resumed.opt_g.state_dict()["state"]
    assert all(torch.equal(sa[i]["exp_avg_sq"], sb[i]["exp_avg_sq"]) for i in sa)
    names = sorted(os.listdir(tmp_path / "b" / "ckpt"))
    assert names == ["do_00000002", "do_00000004", "g_00000002", "g_00000004"]
    g = torch.load(tmp_path / "b" / "ckpt" / "g_00000004", weights_only=True)
    do = torch.load(tmp_path / "b" / "ckpt" / "do_00000004", weights_only=True)
    assert set(g) == {"generator", "iteration"} and g["iteration"] == 4
    assert {"discriminator", "optim_g", "optim_d", "iteration", "rng"} <= set(do)
    log = open(tmp_path / "b" / "log" / "train_log.txt").read().splitlines()
    assert [line.split()[0] for line in log] == [f"step={i}" for i in (1, 2, 3, 4)]


def test_checkpoint_rotation_keeps_the_newest(tmp_path):
    from emotivoice_tpu_torch.config import tiny_test_config
    from emotivoice_tpu_torch.training.loop import CheckpointManager, build_models

    cfg = tiny_test_config()
    trainer = TrainStep(cfg, *build_models(cfg, torch.device("cpu")))
    ckpts = CheckpointManager(str(tmp_path), max_to_keep=2)
    assert ckpts.restore(trainer) is None
    for step in (5, 10, 15):
        trainer.count = step
        ckpts.save(trainer)
    open(tmp_path / "g_00000020", "wb").close()  # a pair without its do_ file
    assert ckpts.steps() == [10, 15] and ckpts.latest_step() == 15
    assert ckpts.restore(trainer) == 15 and trainer.count == 15


def test_train_cli_on_a_synthetic_corpus(tmp_path, capsys):
    from emotivoice_tpu_torch import train as cli
    from emotivoice_tpu_torch.data import synthetic_corpus

    corpus, out = tmp_path / "corpus", tmp_path / "out"
    synthetic_corpus.main(["--out", str(corpus), "--n-train", "4", "--n-valid", "2"])
    args = ["--datalist", str(corpus / "datalist.jsonl"),
            "--valid-datalist", str(corpus / "valid.jsonl"),
            "--tokenlist", str(corpus / "tokenlist"), "--speakers", str(corpus / "speakers"),
            "--output-dir", str(out), "--device", "cpu", "--smoke-tiny", "--batch-size", "2",
            "--total-steps", "2", "--log-every", "1", "--iters-per-validation", "2",
            "--cache-dir", str(out / "cache")]
    cli.main(args)
    assert sorted(os.listdir(out / "ckpt")) == ["do_00000002", "g_00000002"]
    assert os.path.exists(out / "log" / "valid_audio_00000002.wav")
    lines = open(out / "log" / "train_log.txt").read().splitlines()
    assert lines[0].startswith("step=1 ") and "mel_l1=" in lines[-1]
    with pytest.raises(SystemExit):  # the JAX tool's compile cache has no counterpart
        cli.main(args + ["--jax-cache", "off"])

    # warm start from the checkpoints just written, growing the speaker table
    # by 2 rows (voice cloning); one step at lr 1.25e-5 moves nothing far
    warm = tmp_path / "warm"
    g_path, do_path = out / "ckpt" / "g_00000002", out / "ckpt" / "do_00000002"
    cli.main([a if a != str(out) else str(warm) for a in args[:-2]]
             + ["--total-steps", "1", "--pretrained-generator", str(g_path),
                "--pretrained-discriminator", str(do_path), "--new-speakers", "2"])
    assert "warm-started from pretrained checkpoint" in capsys.readouterr().out
    src = torch.load(g_path, weights_only=True)["generator"]
    got = torch.load(warm / "ckpt" / "g_00000001", weights_only=True)["generator"]
    emb, new = src["am.spk_tokenizer.weight"], got["am.spk_tokenizer.weight"]
    assert new.shape == (emb.shape[0] + 2, emb.shape[1])
    rows = np.random.RandomState(0).randn(2, emb.shape[1]).astype(np.float32)
    assert float((new[-2:] - torch.from_numpy(rows)).abs().max()) < 1e-3
    for k, v in src.items():
        if k != "am.spk_tokenizer.weight":
            assert float((got[k] - v).abs().max()) < 1e-3, k
    d_src = torch.load(do_path, weights_only=True)["discriminator"]
    d_got = torch.load(warm / "ckpt" / "do_00000001", weights_only=True)["discriminator"]
    moved = {k: float((d_got[k] - v).abs().max()) for k, v in d_src.items()}
    spectral = [k for k in moved if k.startswith("msd.discriminators.0.")
                and k.endswith(("weight_u", "weight_v"))]  # power iteration moves these
    assert spectral and all(m < 1e-3 for k, m in moved.items() if k not in spectral)
