"""The port's SynthesisEngine, MicroBatcher and batch CLI on the CPU:
bucketing, padding, the uniform-alpha rule, saturation redispatch."""

import threading

import numpy as np
import pytest
import torch

import test_torch_support  # noqa: F401  (one intra-op thread per worker)
from emotivoice_tpu_torch.config import tiny_test_config
from emotivoice_tpu_torch.frontend.tokens import TokenVocab
from emotivoice_tpu_torch.models.jets import JETSGenerator, init_random_
from emotivoice_tpu_torch.serving.batcher import MicroBatcher
from emotivoice_tpu_torch.serving.engine import SynthesisEngine, SynthesisRequest, _bucket

PHONES = ["<sos/eos>", "a", "b", "c", "<sos/eos>"]


def test_bucket_ladder():
    assert _bucket(1, (2, 4, 8)) == 2
    assert _bucket(4, (2, 4, 8)) == 4
    assert _bucket(5, (2, 4, 8)) == 8
    assert _bucket(99, (2, 4, 8)) == 8


@pytest.fixture(scope="module")
def engine():
    cfg = tiny_test_config()
    vocab = TokenVocab.from_tokens(["_", "<sos/eos>", "a", "b", "c"])
    cfg = cfg.replace(am=cfg.am.__class__(**{**cfg.am.__dict__, "n_vocab": len(vocab)}))
    model = init_random_(JETSGenerator(cfg), seed=0)
    return SynthesisEngine(cfg, model, vocab, text_buckets=(8, 16),
                           mel_buckets=(64, 128), batch_buckets=(1, 2, 4), device="cpu")


def _req(engine, phonemes, alpha=1.0, speaker=0):
    d = engine.cfg.am.bert_embedding
    return SynthesisRequest(phonemes=phonemes, speaker_id=speaker,
                            style_embedding=np.zeros(d, np.float32),
                            content_embedding=np.zeros(d, np.float32), alpha=alpha)


def _recording_run(engine, calls):
    run = engine.run

    def rec(tokens, lengths, speaker, style, content, max_frames, alpha):
        calls.append((tokens.shape, max_frames, alpha, lengths.copy(), speaker.copy()))
        return run(tokens, lengths, speaker, style, content, max_frames, alpha)

    return rec


def test_engine_defaults_to_the_card(monkeypatch):
    """Without device= the engine runs on 'cuda' and raises where no card is."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tiny_test_config()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SynthesisEngine(cfg, JETSGenerator(cfg), TokenVocab.default())


def test_dtype_must_be_f32_or_bf16():
    cfg = tiny_test_config()
    with pytest.raises(ValueError):
        SynthesisEngine(cfg, JETSGenerator(cfg), TokenVocab.default(),
                        device="cpu", dtype=torch.float16)


def test_results_trimmed_and_batch_padded(engine, monkeypatch):
    calls = []
    monkeypatch.setattr(engine, "run", _recording_run(engine, calls))
    results = engine.synthesize_batch([_req(engine, PHONES)] * 3)
    assert len(results) == 3
    (shape, max_frames, alpha, lengths, speaker), = calls
    assert shape == (4, 8) and max_frames == 64 and alpha == 1.0
    assert lengths.tolist() == [5, 5, 5, 1]  # padding row: one token
    assert speaker.tolist() == [0, 0, 0, 0]
    for r in results:
        assert r.wav.dtype == np.float32 and r.wav.ndim == 1
        assert len(r.wav) == r.n_frames * engine.up
        assert np.all(np.isfinite(r.wav))


def test_text_and_mel_buckets_follow_the_longest_request(engine, monkeypatch):
    calls = []
    monkeypatch.setattr(engine, "run", _recording_run(engine, calls))
    engine.synthesize_batch([_req(engine, PHONES), _req(engine, ["a"] * 12)])
    (shape, max_frames, *_), = calls
    assert shape == (2, 16) and max_frames == 128  # 16 tokens x 8 frames


def test_batch_padding_does_not_change_results(engine):
    req = _req(engine, PHONES)
    solo = engine.synthesize_batch([req])[0]
    padded = engine.synthesize_batch([req, req, req])[0]
    assert solo.n_frames == padded.n_frames
    np.testing.assert_allclose(solo.wav, padded.wav, atol=2e-4)


def test_mixed_alpha_batch_rejected(engine):
    fast, slow = _req(engine, PHONES), _req(engine, PHONES, alpha=1.3)
    with pytest.raises(ValueError, match="uniform alpha"):
        engine.synthesize_batch([fast, slow])
    assert len(engine.synthesize_batch([slow, slow])) == 2


def test_oversized_batch_splits(engine, monkeypatch):
    calls = []
    monkeypatch.setattr(engine, "run", _recording_run(engine, calls))
    assert len(engine.synthesize_batch([_req(engine, PHONES)] * 6)) == 6
    assert [c[0][0] for c in calls] == [4, 2]


def _fake_run(engine, wanted_frames):
    def run(tokens, lengths, speaker, style, content, max_frames, alpha):
        n = min(wanted_frames, max_frames)  # clamped like the upsampler
        wav = np.zeros((tokens.shape[0], max_frames * engine.up), np.float32)
        wav[:, : n * engine.up] = 0.25
        return wav, np.full((tokens.shape[0],), n)
    return run


@pytest.fixture
def ladder_engine(engine):
    return SynthesisEngine(engine.cfg, engine.model, engine.vocab, text_buckets=(8, 16),
                           mel_buckets=(64, 128, 256), batch_buckets=(1, 2, 4),
                           device="cpu")


def test_saturation_redispatches_to_next_bucket(ladder_engine, monkeypatch):
    e = ladder_engine
    monkeypatch.setattr(e, "run", _fake_run(e, 100))
    (res,) = e.synthesize_batch([_req(e, PHONES)])
    assert res.n_frames == 100 and len(res.wav) == 100 * e.up
    assert e.saturation_redispatches == 1 and e.saturation_truncations == 0


def test_saturation_truncation_counted_at_the_top(ladder_engine, monkeypatch):
    e = ladder_engine
    monkeypatch.setattr(e, "run", _fake_run(e, 1000))
    (res,) = e.synthesize_batch([_req(e, PHONES)])
    assert res.n_frames == 256
    assert e.saturation_redispatches == 2 and e.saturation_truncations == 1


def test_microbatcher_groups_by_alpha(engine, monkeypatch):
    calls = []
    monkeypatch.setattr(engine, "run", _recording_run(engine, calls))
    batcher = MicroBatcher(engine, max_batch=4, max_wait_ms=200.0)
    try:
        reqs = [_req(engine, PHONES), _req(engine, PHONES), _req(engine, PHONES, alpha=1.3)]
        out = batcher.submit_many(reqs)
    finally:
        batcher.close()
    assert len(out) == 3 and all(len(r.wav) == r.n_frames * engine.up for r in out)
    assert sorted(c[2] for c in calls) == [1.0, 1.3]
    assert batcher.dispatches == 2 and batcher.requests == 3


def test_microbatcher_fans_failures_out(engine, monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("device lost")

    monkeypatch.setattr(engine, "run", boom)
    batcher = MicroBatcher(engine, max_batch=4, max_wait_ms=50.0)
    errors = []

    def worker():
        try:
            batcher.submit(_req(engine, PHONES))
        except RuntimeError as e:
            errors.append(str(e))

    threads = [threading.Thread(target=worker) for _ in range(3)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        batcher.close()
    assert not any(t.is_alive() for t in threads)
    assert errors == ["device lost"] * 3


def test_synthesize_cli_writes_wavs(tmp_path, monkeypatch):
    """The batch CLI end to end on the CPU, at tiny_test_config size."""
    import emotivoice_tpu_torch.config as pcfg
    from emotivoice_tpu_torch import synthesize
    from scipy.io import wavfile

    tiny = tiny_test_config()
    monkeypatch.setattr(pcfg, "EmotiVoiceConfig", lambda: tiny)
    lines = tmp_path / "lines.txt"
    lines.write_text("0|Happy|<sos/eos> [HH] [AH0] [L] [OW1] <sos/eos>|hello\n"
                     "3|Sad|<sos/eos> [W] [ER1] [L] [D] <sos/eos>|world\n")
    out = tmp_path / "out"
    synthesize.main(["--test-file", str(lines), "--output-dir", str(out),
                     "--device", "cpu", "--dtype", "bf16"])
    files = sorted(p.name for p in out.iterdir())
    assert files == ["0000_0.wav", "0001_3.wav"]
    sr, data = wavfile.read(out / "0000_0.wav")
    assert sr == 16000 and data.dtype == np.int16 and len(data) % 256 == 0
