"""Alignment of the port against the JAX package, on the CPU: the
beta-binomial prior, monotonic alignment search (paths and durations
bit-equal, on continuous inputs where ties have measure zero and on an input
made of exact ties), bin loss, averaging over the path, the CTC forward-sum
loss, and the PromptTTS / JETS training branches (tiny_test_config).

Tolerances: prior within 1e-5 of max |ref| over the valid block; bin loss,
forward-sum loss and averages within 1e-5 relative; training-branch tensors
within 1e-4 of max |ref|, discrete outputs (paths, durations) equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_support import assert_close_rel, both_configs, jax_jets_params, port_jets

from emotivoice_tpu.models.acoustic import PromptTTS as JPromptTTS
from emotivoice_tpu.models.jets import JETSGenerator as JJETS
from emotivoice_tpu.ops import align as jalign
from emotivoice_tpu_torch.ops import align as talign

# The JAX functions jitted: one compile per shape, where op-by-op dispatch
# compiles each primitive.
_prior = jax.jit(jalign.beta_binomial_prior, static_argnums=(2, 3))
_viterbi = jax.jit(jalign.viterbi_decode)
_average_by_path = jax.jit(jalign.average_by_path, static_argnums=4)
_forward_sum_loss = jax.jit(jalign.forward_sum_loss)


def _case(seed, b=3, t_text=9, t_feats=31):
    rng = np.random.RandomState(seed)
    text = np.array([t_text, t_text - 3, 4][:b], np.int32)
    feats = np.array([t_feats, t_feats - 7, 12][:b], np.int32)
    scores = rng.randn(b, t_feats, t_text).astype(np.float32) * 2.0
    lp = np.asarray(jax.nn.log_softmax(jnp.asarray(scores), axis=-1))
    lp = lp + np.asarray(_prior(text, feats, t_text, t_feats))
    return lp.astype(np.float32), text, feats


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def test_prior_matches_jax():
    text, feats = np.array([9, 6, 4], np.int32), np.array([60, 23, 12], np.int32)
    want = np.asarray(_prior(text, feats, 9, 60))
    got = talign.beta_binomial_prior(*_t(text, feats), 9, 60).numpy()
    valid = want > -1e29
    assert valid.sum() == sum(int(a) * int(b) for a, b in zip(text, feats))
    np.testing.assert_array_equal(got <= -1e29, ~valid)
    assert_close_rel(np.where(valid, got, 0), np.where(valid, want, 0), 1e-5)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_viterbi_matches_jax(seed):
    lp, text, feats = _case(seed)
    want_d, want_bin, want_path = _viterbi(jnp.asarray(lp), text, feats)
    got_d, got_bin, got_path = talign.viterbi_decode(*_t(lp, text, feats))
    np.testing.assert_array_equal(got_path.numpy(), np.asarray(want_path))
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
    np.testing.assert_array_equal(got_d.numpy().sum(1), feats)
    np.testing.assert_allclose(float(got_bin), float(want_bin), rtol=1e-5)


def test_viterbi_tie_rules_match_jax():
    """All scores equal: every comparison is an exact tie, which both
    implementations break by the same rule (the diagonal is taken only on a
    strict gain forward, and on >= backward)."""
    b, t_text, t_feats = 2, 6, 17
    lp = np.zeros((b, t_feats, t_text), np.float32)
    text, feats = np.array([6, 4], np.int32), np.array([17, 9], np.int32)
    _, _, want_path = _viterbi(jnp.asarray(lp), text, feats)
    _, _, got_path = talign.viterbi_decode(*_t(lp, text, feats))
    np.testing.assert_array_equal(got_path.numpy(), np.asarray(want_path))


def test_average_by_path_and_forward_sum_match_jax():
    lp, text, feats = _case(3)
    _, _, path = _viterbi(jnp.asarray(lp), text, feats)
    xs = np.random.RandomState(4).randn(*lp.shape[:2]).astype(np.float32)
    want = np.asarray(_average_by_path(path, jnp.asarray(xs), text, feats, lp.shape[2]))
    got = talign.average_by_path(*_t(np.asarray(path).astype(np.int64), xs, text, feats),
                                 lp.shape[2]).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert np.all(got[2, 4:] == 0)
    want_fs = float(_forward_sum_loss(jnp.asarray(lp), text, feats))
    got_fs = float(talign.forward_sum_loss(*_t(lp, text, feats)))
    assert want_fs > 0.1
    np.testing.assert_allclose(got_fs, want_fs, rtol=1e-5)


@pytest.fixture(scope="module")
def setup():
    jc, tc = both_configs()
    params = jax_jets_params(jc, seed=11, with_alignment=True)
    return jc, tc, params, port_jets(tc, params)


def _training_batch(jc, seed=12, b=3, t_text=10, t_feats=40):
    rng = np.random.RandomState(seed)
    return dict(
        tokens=rng.randint(0, jc.am.n_vocab, (b, t_text)).astype(np.int32),
        lens=np.array([t_text, 7, 4], np.int32), spk=np.array([1, 4, 7], np.int32),
        sty=rng.randn(b, jc.am.bert_embedding).astype(np.float32),
        con=rng.randn(b, jc.am.bert_embedding).astype(np.float32),
        mel=rng.randn(b, t_feats, jc.am.n_mels).astype(np.float32),
        feats=np.array([t_feats, 29, 13], np.int32),
        pitch=rng.randn(b, t_feats).astype(np.float32),
        energy=rng.randn(b, t_feats).astype(np.float32),
    )


def test_prompt_tts_training_branch_matches_jax(setup):
    jc, _, params, model = setup
    x = _training_batch(jc)
    want = jax.jit(lambda p, x: JPromptTTS(jc.am).apply(
        {"params": p}, x["tokens"], x["lens"], x["spk"], x["sty"], x["con"],
        mel_targets=x["mel"], feats_lengths=x["feats"], pitch_targets=x["pitch"],
        energy_targets=x["energy"]))(params["params"]["am"], x)
    with torch.no_grad():
        got = model.am(*_t(x["tokens"], x["lens"], x["spk"], x["sty"], x["con"]),
                       mel_targets=torch.from_numpy(x["mel"]),
                       feats_lengths=torch.from_numpy(x["feats"]),
                       pitch_targets=torch.from_numpy(x["pitch"]),
                       energy_targets=torch.from_numpy(x["energy"]))
    np.testing.assert_array_equal(got["alignment_path"].numpy(), np.asarray(want["alignment_path"]))
    np.testing.assert_array_equal(got["duration_targets"].numpy(),
                                  np.asarray(want["duration_targets"]))
    np.testing.assert_array_equal(got["output_lengths"].numpy(), x["feats"])
    np.testing.assert_allclose(float(got["bin_loss"]), float(want["bin_loss"]), rtol=1e-5)
    valid = np.asarray(want["log_p_attn"]) > -1e29
    assert_close_rel(np.where(valid, got["log_p_attn"].numpy(), 0),
                     np.where(valid, np.asarray(want["log_p_attn"]), 0), 1e-4)
    for k in ("pitch_targets", "energy_targets", "dec_outputs", "pitch_predictions",
              "energy_predictions", "log_duration_predictions"):
        assert_close_rel(got[k], want[k], 1e-4)


def test_jets_training_forward_replays_jax_crop(setup):
    """cut=True: the crop starts JAX drew, replayed, give the same segment
    waveform; cut=False vocodes the whole decoded mel. (JAX side: the lax conv
    lowering, use_s2d=False, for its compile time; the same math.)"""
    jc, _, params, model = setup
    x = _training_batch(jc, seed=13)
    key = jax.random.PRNGKey(5)
    want = jax.jit(lambda p, x: JJETS(jc, use_s2d=False).apply(
        p, x["tokens"], x["lens"], x["spk"], x["sty"], x["con"], mel_targets=x["mel"],
        feats_lengths=x["feats"], pitch_targets=x["pitch"], energy_targets=x["energy"],
        segment_rng=key))(params, x)
    starts = torch.from_numpy(np.array(want["z_start_idxs"]))
    kw = dict(mel_targets=torch.from_numpy(x["mel"]), feats_lengths=torch.from_numpy(x["feats"]),
              pitch_targets=torch.from_numpy(x["pitch"]),
              energy_targets=torch.from_numpy(x["energy"]))
    args = _t(x["tokens"], x["lens"], x["spk"], x["sty"], x["con"])
    with torch.no_grad():
        got = model(*args, start_idxs=starts, **kw)
        whole = model(*args, cut=False, **kw)
    seg = jc.train.segment_size
    assert got["wav_predictions"].shape == (3, seg * 256)
    np.testing.assert_array_equal(got["z_start_idxs"].numpy(), np.asarray(want["z_start_idxs"]))
    assert_close_rel(got["wav_predictions"], want["wav_predictions"], 1e-4)
    assert whole["z_start_idxs"] is None and whole["wav_predictions"].shape == (3, 40 * 256)

