"""DSP and data pipeline of the port against the JAX package, on the CPU:
STFT magnitude and log-mel in both modes, frame energy, pitch, segment
crops, the synthetic corpus, dataset records and collated batches.

Tolerances: spectra and mels within 1e-5 of max |ref|; pitch voicing equal
on >= 99% of frames and F0 within 0.5 Hz where both are voiced; segments
bit-equal; dataset pitch / energy within 1e-4 of max, log-mel within 1e-4
of max above 1e-3 and the linear mel within 1e-5 of max everywhere,
everything else equal.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_support import assert_close_rel

from emotivoice_tpu.ops import mel as jmel
from emotivoice_tpu.ops import pitch as jpitch
from emotivoice_tpu.ops import segments as jseg
from emotivoice_tpu.ops import stft as jstft
from emotivoice_tpu_torch.ops import mel as tmel
from emotivoice_tpu_torch.ops import pitch as tpitch
from emotivoice_tpu_torch.ops import segments as tseg
from emotivoice_tpu_torch.ops import stft as tstft

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR, HOP = 16000, 256


def _voiced_signal(b=2, t=8192 * 2, seed=0):
    """Vowel-like pulse trains with a gliding F0 per row, an unvoiced
    (noise) stretch and a silent one, so voicing decisions and gap filling
    are on the path."""
    rng = np.random.RandomState(seed)
    n = np.arange(t) / SR
    rows = []
    for i in range(b):
        f0 = 110.0 + 60.0 * i + 30.0 * n / n[-1]
        phase = 2 * np.pi * np.cumsum(f0) / SR
        sig = sum(np.sin(k * phase) / k for k in range(1, 8))
        sig[t // 3: t // 3 + 2048] = 0.3 * rng.randn(2048)  # unvoiced
        sig[2 * t // 3: 2 * t // 3 + 1024] = 0.0  # silence
        sig = sig + 0.01 * rng.randn(t)
        rows.append(0.8 * sig / np.abs(sig).max())
    return np.stack(rows).astype(np.float32)


@pytest.mark.parametrize("center,loss_mode", [(True, False), (False, True)])
def test_stft_magnitude_matches_jax(center, loss_mode):
    x = _voiced_signal()
    want = jstft.stft_magnitude(jnp.asarray(x), center=center, loss_mode=loss_mode)
    got = tstft.stft_magnitude(torch.from_numpy(x), center=center, loss_mode=loss_mode)
    assert got.shape == want.shape
    assert_close_rel(got, want, 1e-5)


@pytest.mark.parametrize("loss_mode", [False, True])
def test_mel_spectrogram_matches_jax(loss_mode):
    x = _voiced_signal(seed=1)
    want = jmel.mel_spectrogram(jnp.asarray(x), loss_mode=loss_mode)
    got = tmel.mel_spectrogram(torch.from_numpy(x), loss_mode=loss_mode)
    assert got.shape == want.shape == (2, 80, x.shape[1] // HOP + (0 if loss_mode else 1))
    assert_close_rel(got, want, 1e-5)


def test_mel_filterbank_and_frame_energy_match_jax():
    np.testing.assert_array_equal(tmel.mel_filterbank(), jmel.mel_filterbank())
    np.testing.assert_array_equal(tstft.hann_window(1024), jstft.hann_window(1024))
    x = _voiced_signal(b=1, t=8192, seed=2)[0]
    want = jstft.frame_energy(jnp.asarray(x))
    got = tstft.frame_energy(torch.from_numpy(x))
    assert_close_rel(got, want, 1e-5)


def test_pitch_matches_jax():
    x = _voiced_signal(b=3, t=8192 * 3, seed=3)
    want_f0, want_v = jpitch.extract_pitch(jnp.asarray(x), return_voiced=True)
    got_f0, got_v = tpitch.extract_pitch(torch.from_numpy(x), return_voiced=True)
    want_f0, want_v = np.asarray(want_f0), np.asarray(want_v)
    got_f0, got_v = got_f0.numpy(), got_v.numpy()
    assert got_f0.shape == want_f0.shape == (3, 1 + x.shape[1] // HOP)
    assert 0.2 < want_v.mean() < 0.95  # both voiced and unvoiced frames on the path
    assert (got_v == want_v).mean() >= 0.99
    both = got_v & want_v
    assert np.abs(got_f0 - want_f0)[both].max() <= 0.5
    assert np.all(got_f0 > 0)  # gaps filled
    np.testing.assert_allclose(tpitch.normalize_pitch(got_f0),
                               np.asarray(jpitch.normalize_pitch(got_f0)), rtol=1e-6)
    track = np.where(np.arange(40) % 7 < 3, 0.0, 100.0 + np.arange(40))
    np.testing.assert_array_equal(tpitch.continuous_pitch_np(track),
                                  jpitch.continuous_pitch_np(track))


def test_pitch_pyworld_backend_as_jax():
    """Without pyworld both packages raise ImportError; with it they agree."""
    import importlib.util

    x = _voiced_signal(b=1, t=8192, seed=5)[0]
    if importlib.util.find_spec("pyworld") is None:
        for fn in (jpitch.extract_pitch_pyworld, tpitch.extract_pitch_pyworld):
            with pytest.raises(ImportError):
                fn(x)
    else:
        np.testing.assert_array_equal(tpitch.extract_pitch_pyworld(x),
                                      jpitch.extract_pitch_pyworld(x))


def test_segments_replay_jax_draw_bit_equal():
    rng = np.random.RandomState(4)
    x = rng.randn(3, 40, 5).astype(np.float32)
    lengths = np.array([40, 25, 6], np.int32)  # the last is shorter than a segment
    key = jax.random.PRNGKey(7)
    want, starts = jseg.get_random_segments(key, jnp.asarray(x), jnp.asarray(lengths), 8)
    # the same draw, computed from the same uniform numbers
    u = np.array(jax.random.uniform(key, (3,)))
    assert np.array_equal(
        (torch.from_numpy(u) * torch.clamp(torch.from_numpy(lengths) - 8, min=0).float()
         ).to(torch.int32).numpy(), np.asarray(starts))
    got, got_starts = tseg.get_random_segments(
        torch.from_numpy(x), torch.from_numpy(lengths), 8, start_idxs=torch.from_numpy(
            np.asarray(starts)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_starts.numpy(), np.asarray(starts))
    wav = rng.randn(3, 40 * 4).astype(np.float32)
    np.testing.assert_array_equal(
        tseg.get_segments(torch.from_numpy(wav), torch.from_numpy(np.asarray(starts)) * 4,
                          32).numpy(),
        np.asarray(jseg.get_segments(jnp.asarray(wav), starts * 4, 32)))
    # drawn starts lie in [0, max(len - size, 0)]
    gen = torch.Generator().manual_seed(0)
    _, drawn = tseg.get_random_segments(torch.from_numpy(x), torch.from_numpy(lengths), 8, gen)
    assert np.all(drawn.numpy() >= 0) and np.all(drawn.numpy() <= np.maximum(lengths - 8, 0))


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """The same corpus written by the JAX package's tool and by the port's
    copy."""
    out = {}
    for name, cmd in (("jax", [os.path.join(REPO, "tools/make_synthetic_corpus.py")]),
                      ("port", ["-m", "emotivoice_tpu_torch.data.synthetic_corpus"])):
        d = tmp_path_factory.mktemp(f"corpus_{name}")
        subprocess.run([sys.executable, *cmd, "--out", str(d), "--n-train", "5",
                        "--n-valid", "2", "--seed", "3"], check=True, cwd=REPO,
                       capture_output=True)
        out[name] = str(d)
    return out


def test_synthetic_corpus_equals_the_tool(corpora):
    a, b = corpora["jax"], corpora["port"]
    for name in ("tokenlist", "speakers"):
        assert open(os.path.join(a, name)).read() == open(os.path.join(b, name)).read()
    for name in ("datalist.jsonl", "valid.jsonl"):
        ra = [json.loads(line) for line in open(os.path.join(a, name))]
        rb = [json.loads(line) for line in open(os.path.join(b, name))]
        assert len(ra) == len(rb) > 0
        for x, y in zip(ra, rb):
            assert {k: v for k, v in x.items() if k != "wav_path"} == \
                   {k: v for k, v in y.items() if k != "wav_path"}
            with open(x["wav_path"], "rb") as fa, open(y["wav_path"], "rb") as fb:
                assert fa.read() == fb.read()


def test_dataset_records_and_batches_match_jax(corpora):
    from emotivoice_tpu.config import EmotiVoiceConfig as JCfg
    from emotivoice_tpu.data import dataset as jds
    from emotivoice_tpu.frontend.tokens import TokenVocab as JVocab
    from emotivoice_tpu_torch.config import EmotiVoiceConfig as TCfg
    from emotivoice_tpu_torch.data import dataset as tds
    from emotivoice_tpu_torch.frontend.tokens import TokenVocab as TVocab

    d = corpora["port"]
    speakers = [s.strip() for s in open(os.path.join(d, "speakers"))]
    emb = lambda text: np.full(768, len(text), np.float32)  # noqa: E731
    path = os.path.join(d, "datalist.jsonl")
    want = jds.PromptTTSDataset(path, JCfg(), JVocab.from_file(os.path.join(d, "tokenlist")),
                                speakers, emb)
    got = tds.PromptTTSDataset(path, TCfg(), TVocab.from_file(os.path.join(d, "tokenlist")),
                               speakers, emb, device="cpu")
    assert len(got) == len(want) == 5

    def check(g, w):
        assert set(g) == set(w)
        for k in w:
            if k == "mel":
                # log-mel: within 1e-4 of max where the mel is above 1e-3;
                # nearer the 1e-5 floor log() magnifies the two FFTs'
                # round-off, so there the linear mel is held (1e-5 of max)
                assert g[k].shape == w[k].shape, k
                loud = w[k] > np.log(1e-3)
                assert loud.mean() > 0.3
                assert_close_rel(np.where(loud, g[k], 0), np.where(loud, w[k], 0), 1e-4)
                assert_close_rel(np.exp(g[k]), np.exp(w[k]), 1e-5)
            elif k in ("pitch", "energy"):
                assert g[k].shape == w[k].shape, k
                assert_close_rel(g[k], w[k], 1e-4)
            elif k == "key":
                assert g[k] == w[k]
            else:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)

    records = [(got[i], want[i]) for i in range(len(want))]
    for g, w in records:
        check(g, w)
    spec = jds.BucketSpec(text_buckets=(16, 32), mel_buckets=(64, 128, 256))
    tspec = tds.BucketSpec(text_buckets=(16, 32), mel_buckets=(64, 128, 256))
    check(tds.collate([g for g, _ in records], tspec), jds.collate([w for _, w in records], spec))
    # loaders: same order, same padding to the batch
    gl = list(tds.BucketedLoader(got, 2, tspec, seed=1, drop_last=False, pad_to_batch=True))
    wl = list(jds.BucketedLoader(want, 2, spec, seed=1, drop_last=False, pad_to_batch=True))
    assert len(gl) == len(wl) > 0
    for g, w in zip(gl, wl):
        check(g, w)
    assert len(list(tds.PrefetchLoader(gl))) == len(gl)
