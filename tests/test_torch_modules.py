"""PyTorch port vs the JAX package, module by module, at f32 on the CPU.

Every comparison runs the JAX module and its port counterpart on the same
seeded numpy parameters and inputs. Tolerance: 1e-4 of max |ref| (f32
math in both, summed in different orders).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_support import (
    SMALL_VOCODER,
    assert_close_rel,
    both_configs,
    jax_jets_params,
    port_jets,
    random_params,
)

from emotivoice_tpu.convert.from_torch import convert_jets_generator
from emotivoice_tpu.models import hifigan as jh
from emotivoice_tpu.models import transformer as jt
from emotivoice_tpu.models import variance as jv
from emotivoice_tpu.models.acoustic import PromptTTS as JPromptTTS
from emotivoice_tpu.ops.upsample import gaussian_upsample as j_upsample
from emotivoice_tpu_torch.convert.from_jax import hifigan_state_dict
from emotivoice_tpu_torch.models.hifigan import HiFiGANGenerator
from emotivoice_tpu_torch.ops.upsample import gaussian_upsample as t_upsample
from emotivoice_tpu_torch.models.jets import JETSGenerator

TOL = 1e-4


@pytest.fixture(scope="module")
def setup():
    jc, tc = both_configs()
    params = jax_jets_params(jc, seed=3, with_alignment=True)
    model = port_jets(tc, params)
    return jc, tc, params["params"]["am"], model, params


def _text_inputs(cfg, b=2, t=11, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, t, cfg.am.hidden).astype(np.float32)
    lens = np.array([t, t - 4][:b])
    valid = np.arange(t)[None, :] < lens[:, None]
    return x, valid


def test_sinusoid_table_matches():
    from emotivoice_tpu_torch.models.transformer import sinusoid_table

    np.testing.assert_array_equal(sinusoid_table(50, 16), jt.sinusoid_table(50, 16))


def test_transformer_encoder(setup):
    jc, _, am, model, _ = setup
    x, valid = _text_inputs(jc)
    enc = jt.TransformerEncoder(
        d_model=jc.am.hidden, n_heads=jc.am.encoder_n_heads,
        n_layers=jc.am.encoder_n_layers, kernel_size=jc.am.encoder_kernel_size,
        max_len=jc.am.max_pe_len,
    )
    want = enc.apply({"params": am["encoder"]}, x, valid)
    with torch.no_grad():
        got = model.am.encoder(torch.from_numpy(x), torch.from_numpy(valid))
    assert_close_rel(got, want, TOL)


def test_attention_ignores_padded_keys(setup):
    """Padded keys get exactly zero weight: changing the padded rows of x
    leaves every valid row of the attention output bit-identical."""
    x, valid = _text_inputs(setup[0])
    attn = setup[3].am.encoder.encoders[0].self_attn
    x2 = x.copy()
    x2[1, 7:] += 5.0
    m = torch.from_numpy(valid)
    with torch.no_grad():
        a = attn(torch.from_numpy(x), m)
        b = attn(torch.from_numpy(x2), m)
    assert torch.equal(a[1, :7], b[1, :7])
    assert torch.equal(a[0], b[0])


@pytest.mark.parametrize("name", ["duration_predictor", "pitch_predictor", "energy_predictor"])
def test_variance_predictors(setup, name):
    jc, _, am, model, _ = setup
    x, valid = _text_inputs(jc, seed=1)
    c = jc.am
    n_layers = {"duration_predictor": c.duration_n_layers,
                "pitch_predictor": c.variance_n_layers,
                "energy_predictor": c.energy_n_layers}[name]
    cls = jv.DurationPredictor if name == "duration_predictor" else jv.VariancePredictor
    mod = cls(n_layers=n_layers, n_chans=c.variance_n_hidden, kernel_size=3)
    want = mod.apply({"params": am[name]}, x, valid)
    with torch.no_grad():
        got = getattr(model.am, name)(torch.from_numpy(x), torch.from_numpy(valid))
    assert_close_rel(got, want, TOL)


def test_to_durations_rounds_half_to_even():
    from emotivoice_tpu_torch.models.variance import DurationPredictor

    log_d = np.log(np.array([[1.5, 2.5, 3.5, 0.2, 1.0, 7.49]], np.float32) + 1.0)
    want = jv.DurationPredictor.to_durations(jnp.asarray(log_d))
    got = DurationPredictor.to_durations(torch.from_numpy(log_d))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_variance_embedding(setup):
    jc, _, am, model, _ = setup
    track = np.random.RandomState(2).randn(2, 13).astype(np.float32)
    mod = jv.VarianceEmbedding(jc.am.hidden, jc.am.variance_embed_kernel_size)
    want = mod.apply({"params": am["pitch_embed"]}, track)
    with torch.no_grad():
        got = model.am.pitch_embed(torch.from_numpy(track))
    assert_close_rel(got, want, TOL)


def test_alignment_module(setup):
    jc, _, am, model, _ = setup
    x, valid = _text_inputs(jc, seed=4)
    feats = np.random.RandomState(5).randn(2, 17, jc.am.n_mels).astype(np.float32)
    want = jv.AlignmentModule(adim=jc.am.hidden).apply(
        {"params": am["alignment_module"]}, x, feats, valid)
    with torch.no_grad():
        got = model.am.alignment_module(
            torch.from_numpy(x), torch.from_numpy(feats), torch.from_numpy(valid))
    want = np.where(valid[:, None, :], np.asarray(want), 0.0)
    got = np.where(valid[:, None, :], got.numpy(), 0.0)
    assert_close_rel(got, want, TOL)


@pytest.mark.parametrize("alpha", [1.0, 1.3])
def test_gaussian_upsample(alpha):
    rng = np.random.RandomState(6)
    b, t, d, frames = 3, 9, 8, 40
    hs = rng.randn(b, t, d).astype(np.float32)
    ds = rng.randint(0, 5, (b, t)).astype(np.float32)
    ds[2] = 0.0  # all-zero durations: one frame per token fallback
    lens = np.array([9, 6, 5])
    valid = np.arange(t)[None, :] < lens[:, None]
    want, want_len = j_upsample(hs, ds, valid, frames, None, 0.1, alpha)
    got, got_len = t_upsample(torch.from_numpy(hs), torch.from_numpy(ds),
                              torch.from_numpy(valid), frames, None, 0.1, alpha)
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    assert got_len[2] == 5
    assert_close_rel(got, want, TOL)


def test_prompt_tts_inference(setup):
    jc, _, am, model, _ = setup
    rng = np.random.RandomState(7)
    b, t = 2, 12
    tokens = rng.randint(0, jc.am.n_vocab, (b, t))
    lens, spk = np.array([12, 8]), np.array([2, 5])
    sty = rng.randn(b, jc.am.bert_embedding).astype(np.float32)
    con = rng.randn(b, jc.am.bert_embedding).astype(np.float32)
    want = jax.jit(lambda p, *a: JPromptTTS(jc.am).apply({"params": p}, *a, max_frames=40))(
        am, tokens, lens, spk, sty, con)
    with torch.no_grad():
        got = model.am(*(torch.as_tensor(a) for a in (tokens, lens, spk, sty, con)),
                       max_frames=40)
    np.testing.assert_array_equal(got["durations"].numpy(), np.asarray(want["durations"]))
    np.testing.assert_array_equal(got["output_lengths"].numpy(),
                                  np.asarray(want["output_lengths"]))
    assert_close_rel(got["dec_outputs"], want["dec_outputs"], TOL)
    mel = got["dec_outputs"].numpy()
    for i, n in enumerate(got["output_lengths"].numpy()):
        assert np.all(mel[i, n:] == 0)


def test_prompt_tts_training_branch_raises(setup):
    """The training branch (tests/test_torch_align.py) needs all of its
    targets beside mel_targets."""
    model = setup[3]
    z = torch.zeros(1, 4, dtype=torch.long)
    with pytest.raises(ValueError, match="feats_lengths, pitch_targets"):
        model.am(z, torch.tensor([4]), torch.tensor([0]),
                 torch.zeros(1, 12), torch.zeros(1, 12),
                 mel_targets=torch.zeros(1, 8, 20))


@pytest.fixture(scope="module")
def small_vocoder():
    jc, tc = both_configs(SMALL_VOCODER)
    mel = np.random.RandomState(8).randn(2, 20, 20).astype(np.float32)
    shapes = jax.eval_shape(
        lambda: jh.HiFiGANGenerator(jc.vocoder, use_s2d=False).init(jax.random.PRNGKey(0), mel))
    tree = random_params(shapes, seed=9)["params"]
    gen = HiFiGANGenerator(tc.vocoder)
    gen.load_state_dict(hifigan_state_dict(tree, tc.vocoder))
    return jc, tree, gen.eval(), mel


def test_wn_conv1d(small_vocoder):
    jc, tree, gen, mel = small_vocoder
    mod = jh.WNConv1d(jc.vocoder.initial_channel, jc.vocoder.upsample_initial_channel,
                      7, padding=3)
    want = mod.apply({"params": tree["conv_pre"]}, mel)
    with torch.no_grad():
        got = gen.conv_pre(torch.from_numpy(mel))
    assert_close_rel(got, want, TOL)


def test_wn_conv_transpose1d_norms_per_input_channel(small_vocoder):
    jc, tree, gen, _ = small_vocoder
    c, u, k = jc.vocoder.upsample_initial_channel, 4, 8
    x = np.random.RandomState(10).randn(2, 15, c).astype(np.float32)
    mod = jh.WNConvTranspose1d(c, c // 2, k, stride=u, padding=(k - u) // 2)
    want = mod.apply({"params": tree["ups_0"]}, x)
    with torch.no_grad():
        got = gen.ups[0](torch.from_numpy(x))
        # (Ci, Co, K): folded per input channel, ||folded[i]|| == g[i]
        norms = gen.ups[0].folded().flatten(1).norm(dim=1)
        g = gen.ups[0].weight_g.detach().flatten()
    assert got.shape == (2, 15 * u, c // 2)
    assert_close_rel(got, want, TOL)
    assert gen.ups[0].weight_v.shape[0] == c
    np.testing.assert_allclose(norms.numpy(), g.numpy(), rtol=1e-5)


def test_hifigan_generator_both_dispatches(small_vocoder):
    """Stage 1 (C=128) runs the per-unit kernel path, stage 2 (C=64) the
    whole-stage path; on the CPU both take the plain versions."""
    jc, tree, gen, mel = small_vocoder
    want = jax.jit(jh.HiFiGANGenerator(jc.vocoder, use_s2d=False).apply)({"params": tree}, mel)
    with torch.no_grad():
        got = gen(torch.from_numpy(mel))
    assert got.dtype == torch.float32 and got.shape == (2, 20 * 8)
    assert_close_rel(got, want, TOL)


def test_weight_round_trip_through_reference_converter(setup):
    """JAX params -> port state dict -> port -> state_dict() -> the JAX
    package's own reference-checkpoint converter reproduces the JAX `am`
    and `generator` trees exactly, so the port's names match the reference
    checkpoint layout. The tree is the JAX init tree (training-branch init,
    so it holds the alignment module) with seeded values."""
    jc, _, _, model, params = setup
    back = convert_jets_generator(model.state_dict(), jc)
    want = jax.tree_util.tree_map(np.asarray, params["params"])
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(want)
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                            jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(b, a, err_msg=jax.tree_util.keystr(path))


def test_port_state_dict_keys_are_reference_names():
    _, tc = both_configs()
    keys = set(JETSGenerator(tc).state_dict())
    for k in ("am.encoder.embed.0.alpha",
              "am.encoder.encoders.0.self_attn.linear_q.weight",
              "am.duration_predictor.conv.1.2.weight",
              "am.pitch_embed.0.weight",
              "am.alignment_module.f_conv3.weight",
              "generator.resblocks.3.convs1.2.weight_g",
              "generator.resblocks.3.convs2.2.weight_v",
              "generator.ups.0.weight_g"):
        assert k in keys, k
