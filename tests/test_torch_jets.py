"""Whole slice, port vs JAX: phoneme ids -> waveform through JETSGenerator
inference on tiny_test_config weights, over two (t_text, max_frames)
buckets and two alpha values. Durations must match exactly; the waveform
within atol 1e-3.

With seed 3 no predicted duration lies within float noise of a .5
rounding edge (asserted below: every one is > 1e-4 away), so exact duration
equality is a fair requirement of f32 math summed in different orders.
"""

import numpy as np
import pytest
import torch

from test_torch_support import both_configs, jax_jets_params, port_jets

from emotivoice_tpu.models.jets import JETSGenerator as JJETS


@pytest.fixture(scope="module")
def models():
    jc, tc = both_configs()
    params = jax_jets_params(jc, seed=3)
    return jc, params, port_jets(tc, params)


@pytest.mark.parametrize("t_text,max_frames", [(10, 32), (16, 64)])
@pytest.mark.parametrize("alpha", [1.0, 1.3])
def test_jets_inference_matches_jax(models, t_text, max_frames, alpha):
    jc, params, model = models
    rng = np.random.RandomState(t_text)
    b = 3
    tokens = rng.randint(0, jc.am.n_vocab, (b, t_text))
    lens = np.array([t_text, t_text - 3, 4])
    spk = np.array([0, 3, 7])
    sty = rng.randn(b, jc.am.bert_embedding).astype(np.float32)
    con = rng.randn(b, jc.am.bert_embedding).astype(np.float32)

    want = JJETS(jc).apply(params, tokens, lens, spk, sty, con,
                           max_frames=max_frames, alpha=alpha)
    with torch.no_grad():
        got = model(*(torch.as_tensor(a) for a in (tokens, lens, spk, sty, con)),
                    max_frames=max_frames, alpha=alpha)

    # Durations: no value may sit near a rounding edge (see module doc).
    log_d = np.asarray(want["log_duration_predictions"], np.float64)
    frac = np.exp(log_d) - 1.0
    assert np.min(np.abs(frac - np.floor(frac) - 0.5)) > 1e-4
    np.testing.assert_array_equal(got["durations"].numpy(), np.asarray(want["durations"]))
    np.testing.assert_array_equal(got["output_lengths"].numpy(),
                                  np.asarray(want["output_lengths"]))
    wav_ref = np.asarray(want["wav_predictions"])
    assert wav_ref.shape == (b, max_frames * 256)
    assert np.max(np.abs(wav_ref)) > 1e-2
    np.testing.assert_allclose(got["wav_predictions"].numpy(), wav_ref, atol=1e-3)
