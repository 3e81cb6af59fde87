"""bf16 training compute in the port against the JAX package's, on the CPU
(tiny_test_config, every dropout rate 0, two MSD scales).

- Trajectory: three steps of JAX `make_train_step` with the models
  `init_train_state(compute_dtype=jnp.bfloat16)` builds (the generator with
  the lax conv lowering, `use_s2d=False`, the same math at a tenth of the
  compile time) and of the port's `TrainStep(dtype=torch.bfloat16)` from
  the same parameters, on three batches, replaying JAX's segment starts, at
  the configuration's lr (1.25e-5). Every loss at every step within
  LOSS_RTOL (the CPU shows <= 4.2e-3: XLA and PyTorch round bf16 at other
  places); every parameter within PARAM_TOL of its tensor's max (<= 2.9e-3
  seen). Adam moves an element by about lr a step whatever its gradient, so
  the parameters can differ by 2 x lr x steps at most: that part checks
  little beyond the losses, and the bf16 path is held to its dtypes below.
- Dtypes: in a bf16 step the generator's and the discriminator's convs see
  bf16 activations, while the alignment module (no dtype in JAX, so f32),
  the parameters, Adam's moments and every loss are f32; in f32, everything
  is f32.
- Validation in bf16 runs both MRF kernels (their plain versions on the
  CPU) in bf16.
"""

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
from test_torch_train import jax_segment_starts, training_batch

from emotivoice_tpu.convert.from_torch import convert_jets_generator
from emotivoice_tpu.models import hifigan as jh
from emotivoice_tpu.models.jets import JETSGenerator as JJETS
from emotivoice_tpu.training.step import TrainState, make_optimizers, make_train_step
from emotivoice_tpu_torch.training.step import TrainStep

LOSS_RTOL = 1e-2
PARAM_TOL = 5e-3
METRICS = ("mel_loss", "adv_loss", "fm_loss", "dur_loss", "pitch_loss", "energy_loss",
           "forwardsum_loss", "bin_loss", "g_loss", "d_loss")


def _torch_batch(batch):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v)
            for k, v in batch.items()}


def _port_trainer(tc, g_params, d_params, spectral, dtype):
    model = port_jets(tc, g_params)
    model.generator.kernels = False
    disc = port_discriminator(tc, d_params, spectral)
    disc.dtype = dtype  # as build_models(dtype=) makes it
    return TrainStep(tc, model, disc, dtype=dtype)


@pytest.fixture(scope="module")
def params():
    """(JAX generator variables, discriminator params, spectral state), seeded."""
    jc, _ = train_configs()
    return (jax_jets_params(jc, seed=41, with_alignment=True),
            *jax_disc_variables(jc.disc, seed=42))


def test_three_bf16_steps_match_make_train_step(params):
    jc, tc = train_configs()
    g_params, d_params, spectral = params
    opt_g, opt_d = make_optimizers(jc)
    state = TrainState(step=jnp.zeros((), jnp.int32), g_params=g_params["params"],
                       d_params=d_params, d_spectral=spectral,
                       opt_g=opt_g.init(g_params["params"]), opt_d=opt_d.init(d_params),
                       rng=jax.random.PRNGKey(43))
    step_fn = jax.jit(make_train_step(
        jc, JJETS(jc, compute_dtype=jnp.bfloat16, use_s2d=False),
        jh.Discriminator(jc.disc, dtype=jnp.bfloat16)))
    trainer = _port_trainer(tc, g_params, d_params, spectral, torch.bfloat16)
    for i in range(3):
        batch = training_batch(jc, seed=44 + i)
        _, starts = jax_segment_starts(state.rng, batch, jc.train.segment_size)
        state, want = step_fn(state, batch)
        got = trainer(_torch_batch(batch), start_idxs=torch.from_numpy(starts))
        assert set(got) == set(want) == set(METRICS)
        for k in METRICS:
            assert got[k].dtype == torch.float32
            np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=LOSS_RTOL,
                                       err_msg=f"step {i + 1} {k}")
    got = convert_jets_generator(
        {k: v.detach() for k, v in trainer.model.named_parameters()}, jc)
    want = jax.device_get(state.g_params)
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(flat) > 100
    for (path, w), g in zip(flat, jax.tree_util.tree_leaves(got)):
        w, g = np.asarray(w), np.asarray(g)
        assert g.shape == w.shape and g.dtype == np.float32
        np.testing.assert_allclose(g, w, rtol=0, atol=PARAM_TOL * max(np.abs(w).max(), 1e-6),
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_a_step_computes_in_its_dtype_and_keeps_f32_state(dtype, params, monkeypatch):
    import torch.nn.functional as F

    jc, tc = train_configs(lr=1e-3)
    trainer = _port_trainer(tc, *params, dtype)
    seen = {"g": set(), "d": set(), "align": set(), "other": set()}
    current = ["other"]  # the module whose convs are being recorded

    def spy(fn):
        def call(x, *args, **kw):
            seen[current[0]].add(x.dtype)
            return fn(x, *args, **kw)
        return call

    for name in ("conv1d", "conv2d"):
        monkeypatch.setattr(F, name, spy(getattr(F, name)))
    hooks = []
    for name, module in (("g", trainer.model.generator), ("d", trainer.disc),
                         ("align", trainer.model.am.alignment_module)):
        hooks.append(module.register_forward_pre_hook(
            lambda m, a, _n=name: current.__setitem__(0, _n)))
        hooks.append(module.register_forward_hook(
            lambda m, a, y: current.__setitem__(0, "other")))
    try:
        metrics = trainer(_torch_batch(training_batch(jc, seed=44)),
                          start_idxs=torch.tensor([0, 0]))
    finally:
        for h in hooks:
            h.remove()
    assert seen["g"] == {dtype} and seen["d"] == {dtype}
    # the alignment module has no dtype in JAX: f32 in either compute dtype
    assert seen["align"] == {torch.float32}
    assert all(v.dtype == torch.float32 for v in metrics.values())
    for opt, module in ((trainer.opt_g, trainer.model), (trainer.opt_d, trainer.disc)):
        assert all(p.dtype == torch.float32 for p in module.parameters())
        states = list(opt.state.values())
        assert states and all(s["exp_avg"].dtype == s["exp_avg_sq"].dtype == torch.float32
                              for s in states)


def test_bf16_validation_runs_both_kernels_in_bf16(monkeypatch):
    from emotivoice_tpu_torch.ops.cuda import mrf_stage, resblock
    from emotivoice_tpu_torch.training.validate import make_validate_fn
    from test_torch_support import SMALL_VOCODER, both_configs

    jc, tc = both_configs(SMALL_VOCODER)  # one stage per kernel
    g_params = jax_jets_params(jc, seed=41, with_alignment=True)
    model = port_jets(tc, g_params).train()
    model.generator.kernels = False  # as the trainer builds it
    calls = []
    for mod, name in ((resblock, "residual_unit_plain"), (mrf_stage, "mrf_stage_plain")):
        plain = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda x, *a, _p=plain, _n=name: calls.append(
            (_n, x.dtype)) or _p(x, *a))

    class Log:
        text_path, tb = "unused", None

        def log(self, step, metrics, prefix):
            self.logged = (step, prefix, metrics)

    batch = _torch_batch(training_batch(jc, seed=45))
    logger = Log()
    monkeypatch.setattr("emotivoice_tpu_torch.training.validate.write_wav", lambda *a: None)
    make_validate_fn(tc, model, lambda: [batch], logger, dtype=torch.bfloat16)(7)
    assert {n for n, _ in calls} == {"residual_unit_plain", "mrf_stage_plain"}
    assert {d for _, d in calls} == {torch.bfloat16}
    assert logger.logged[:2] == (7, "valid")
    assert all(np.isfinite(v) for v in logger.logged[2].values())
    assert model.generator.kernels is False and model.training
