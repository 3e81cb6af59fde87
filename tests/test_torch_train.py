"""The port's joint training step against the JAX package, on the CPU
(tiny_test_config, every dropout rate 0, two MSD scales): the gradients of
the D loss and of the G loss with respect to every parameter, and the losses
of one step. The JAX side composes the JAX package's public `apply`s and
losses under `jax.grad`, in the step's order: D loss with `update_stats`,
then the G loss against the updated spectral state. The port side is one
`TrainStep` call at lr 0 (so D is unchanged for the G loss, as on the JAX
side), replaying JAX's segment starts.

Tolerance: each gradient tensor within 1e-4 of its max |ref|, or of 1e-4 x
the model's largest gradient where its own max is smaller: gradients that
vanish in exact arithmetic (attention key biases, whose softmax ignores a
constant added to a query's scores; terms whose signs cancel) are round-off
in both. Each loss within 1e-5 relative.
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

from emotivoice_tpu.convert.from_torch import convert_jets_generator
from emotivoice_tpu.models import hifigan as jh
from emotivoice_tpu.models.jets import JETSGenerator as JJETS
from emotivoice_tpu.ops.mel import mel_spectrogram
from emotivoice_tpu.ops.segments import get_segments
from emotivoice_tpu.training.losses import alignment_losses, prosody_losses, segment_mel_l1
from emotivoice_tpu_torch.convert.from_jax import discriminator_state_dict

GRAD_TOL = 1e-4  # of each tensor's max |grad| (or of the floor): ~20x what the CPU shows
FLOOR = 1e-4  # x the model's largest gradient: the scale of one that is 0 in exact arithmetic
LOSS_RTOL = 1e-5


def training_batch(cfg, seed, b=2, t_text=8, t_feats=28):
    """A seeded batch in the collated layout (numpy)."""
    rng = np.random.RandomState(seed)
    feats = np.array([t_feats, t_feats - 5][:b], np.int32)
    return dict(
        tokens=rng.randint(1, cfg.am.n_vocab, (b, t_text)).astype(np.int32),
        text_lengths=np.array([t_text, t_text - 2][:b], np.int32),
        speaker=np.array([1, 5][:b], np.int32),
        style_embedding=rng.randn(b, cfg.am.bert_embedding).astype(np.float32),
        content_embedding=rng.randn(b, cfg.am.bert_embedding).astype(np.float32),
        mel=rng.randn(b, t_feats, cfg.am.n_mels).astype(np.float32),
        mel_lengths=feats,
        pitch=rng.randn(b, t_feats).astype(np.float32),
        energy=rng.randn(b, t_feats).astype(np.float32),
        wav=(0.3 * rng.randn(b, t_feats * 256)).astype(np.float32),
    )


def jax_segment_starts(rng_key, batch, segment_size):
    """The starts JAX's step draws from its state's key (step.py:157,
    segments.py:35-37)."""
    _, seg_rng, _ = jax.random.split(rng_key, 3)
    u = jax.random.uniform(seg_rng, (batch["mel_lengths"].shape[0],))
    max_start = jnp.clip(batch["mel_lengths"] - segment_size, 0, None).astype(jnp.float32)
    return seg_rng, np.array((u * max_start).astype(jnp.int32))


def jax_models(jc):
    """The JAX generator with the lax conv lowering (use_s2d=False: the same
    math as the default space-to-depth lowering, which the JAX package's own
    tests hold exact, at a tenth of the compile time) and discriminator."""
    return JJETS(jc, use_s2d=False), jh.Discriminator(jc.disc)


def make_jax_grads(jc):
    model, disc = jax_models(jc)
    t, a, up = jc.train, jc.audio, jc.vocoder.upsample_factor

    def seg_mel(wav):
        m = mel_spectrogram(wav, a.sampling_rate, a.n_fft, a.hop_length, a.win_length,
                            a.n_mels, a.fmin, a.fmax, loss_mode=True)
        return jnp.swapaxes(m, -1, -2)

    def forward(gp, batch, seg_rng):
        out = model.apply(
            {"params": gp}, batch["tokens"], batch["text_lengths"], batch["speaker"],
            batch["style_embedding"], batch["content_embedding"], mel_targets=batch["mel"],
            feats_lengths=batch["mel_lengths"], pitch_targets=batch["pitch"],
            energy_targets=batch["energy"], segment_rng=seg_rng)
        y = get_segments(batch["wav"], out["z_start_idxs"] * up, t.segment_size * up)
        return out, y

    @jax.jit
    def grads(gp, dp, spectral, batch, seg_rng):
        out, y = forward(gp, batch, seg_rng)
        y_hat = jax.lax.stop_gradient(out["wav_predictions"])

        def d_loss_fn(dp_):
            (ro, fo, _, _), new = disc.apply({"params": dp_, "spectral": spectral}, y, y_hat,
                                             update_stats=True, mutable=["spectral"])
            return jh.discriminator_loss(ro, fo), new["spectral"]

        (d_loss, new_spectral), d_grads = jax.value_and_grad(d_loss_fn, has_aux=True)(dp)

        def g_loss_fn(gp_):
            out_, y_ = forward(gp_, batch, seg_rng)
            (ro, fo, rf, ff), _ = disc.apply({"params": dp, "spectral": new_spectral}, y_,
                                             out_["wav_predictions"], mutable=["spectral"])
            mel_loss = segment_mel_l1(seg_mel(out_["wav_predictions"]), seg_mel(y_))
            pros, align = prosody_losses(out_), alignment_losses(out_)
            adv, fm = jh.generator_loss(fo), jh.feature_loss(rf, ff)
            total = (t.w_mel * mel_loss + t.w_dur * pros["dur_loss"]
                     + t.w_pitch * pros["pitch_loss"] + t.w_energy * pros["energy_loss"]
                     + t.w_forwardsum * align["forwardsum_loss"] + t.w_bin * align["bin_loss"]
                     + t.w_adv * adv + t.w_fm * fm)
            return total, {"mel_loss": mel_loss, "adv_loss": adv, "fm_loss": fm, **pros,
                           **align}

        (g_loss, metrics), g_grads = jax.value_and_grad(g_loss_fn, has_aux=True)(gp)
        metrics.update(g_loss=g_loss, d_loss=d_loss)
        return g_grads, d_grads, metrics

    return grads


@pytest.fixture(scope="module")
def step_pair():
    from emotivoice_tpu_torch.training.step import TrainStep

    jc, tc = train_configs(lr=0.0)
    g_params = jax_jets_params(jc, seed=31, with_alignment=True)
    d_params, spectral = jax_disc_variables(jc.disc, seed=32)
    batch = training_batch(jc, seed=33)
    seg_rng, starts = jax_segment_starts(jax.random.PRNGKey(34), batch, jc.train.segment_size)
    g_grads, d_grads, metrics = make_jax_grads(jc)(g_params["params"], d_params, spectral,
                                                   batch, seg_rng)
    model = port_jets(tc, g_params)
    model.generator.kernels = False
    disc = port_discriminator(tc, d_params, spectral)
    trainer = TrainStep(tc, model, disc)
    got = trainer({k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v)
                   for k, v in batch.items()}, start_idxs=torch.from_numpy(starts))
    return jc, tc, (g_grads, d_grads, metrics), trainer, got, spectral


def _close_per_tensor(name, got, want, floor):
    """|got - want| <= GRAD_TOL x max(max |want|, floor); returns the error
    over that scale."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    scale = max(np.max(np.abs(want)), floor)
    err = np.max(np.abs(got - want))
    assert err <= GRAD_TOL * scale, f"{name}: {err:.3g} > {GRAD_TOL} x {scale:.3g}"
    return err / scale


def test_step_losses_match_jax(step_pair):
    _, _, (_, _, want), _, got, _ = step_pair
    assert set(got) == set(want)
    for k in want:
        assert abs(float(want[k])) > 1e-3, k
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=LOSS_RTOL, err_msg=k)


def test_generator_gradients_match_jax_for_every_parameter(step_pair):
    jc, _, (g_grads, _, _), trainer, _, _ = step_pair
    named = dict(trainer.model.named_parameters())
    assert all(p.grad is not None for p in named.values())
    got = convert_jets_generator({k: p.grad for k, p in named.items()}, jc)
    want = jax.tree_util.tree_map(np.asarray, g_grads)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    floor = FLOOR * max(np.abs(w).max() for _, w in flat)
    for (path, w), g in zip(flat, jax.tree_util.tree_leaves(got)):
        _close_per_tensor(jax.tree_util.keystr(path), g, w, floor)
    # most tensors are held to their own max, not to the floor
    assert sum(np.abs(w).max() > floor for _, w in flat) >= 0.9 * len(flat)


def test_discriminator_gradients_match_jax_for_every_parameter(step_pair):
    _, tc, (_, d_grads, _), trainer, _, spectral = step_pair
    want = discriminator_state_dict(jax.tree_util.tree_map(np.asarray, d_grads), spectral,
                                    tc.disc)
    named = dict(trainer.disc.named_parameters())
    spectral_state = ("weight_u", "weight_v")  # buffers of the spectral-norm scale
    assert set(named) == {k for k in want if not (
        k.startswith("msd.discriminators.0.") and k.endswith(spectral_state))}
    floor = FLOOR * max(float(want[k].abs().max()) for k in named)
    for k, p in named.items():
        _close_per_tensor(k, p.grad, want[k], floor)
