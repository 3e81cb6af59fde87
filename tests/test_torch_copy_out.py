"""The copy of a bucket's waveform to the host (`serving/programs.py`
`HostStaging`, `to_host`) on the CPU, with plain (unpinned) tensors at
tiny_test_config size: each row's first n_frames x hop samples are the
untrimmed copy's, bit for bit, and the rest is zero, for padding rows, rows
at n_frames == max_frames (the redispatch case) and alpha != 1; the bytes
it counts; results that no later call overwrites while held, and whose
buffers are reused once released; one staging buffer grown to the largest
bucket and reused; a CPU forward's outputs handed back as they are;
the counters in `program_counts` and `GET /v1/metrics`. The pinned copy on
a card is held to the eager forward by `chip_smoke.py` `[main]`."""

import os
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import test_torch_support  # noqa: F401  (one intra-op thread per worker)
from emotivoice_tpu_torch.config import tiny_test_config
from emotivoice_tpu_torch.frontend.tokens import TokenVocab
from emotivoice_tpu_torch.models.jets import JETSGenerator, init_random_
from emotivoice_tpu_torch.serving import tracing
from emotivoice_tpu_torch.serving.api import TTSService
from emotivoice_tpu_torch.serving.engine import SynthesisEngine
from emotivoice_tpu_torch.serving.programs import HostStaging, to_host

T_TEXT, FRAMES = 16, 16


@pytest.fixture(scope="module")
def model():
    cfg = tiny_test_config()
    return init_random_(JETSGenerator(cfg), 0).eval()


def _arrays(cfg, seed=3):
    """Four rows as the engine pads them: 16, 9 and 4 tokens and a padding
    row (one pad token, speaker 0, zero embeddings)."""
    rng = np.random.RandomState(seed)
    d = cfg.am.bert_embedding
    lengths = np.array([16, 9, 4, 1])
    tokens = np.zeros((4, T_TEXT), np.int64)
    for i, n in enumerate(lengths[:3]):
        tokens[i, :n] = rng.randint(2, cfg.am.n_vocab, n)
    style, content = rng.randn(4, d).astype(np.float32), rng.randn(4, d).astype(np.float32)
    style[3] = content[3] = 0
    return tokens, lengths, np.array([1, 3, 5, 0]), style, content


def _forward(model, alpha, max_frames=FRAMES, seed=3):
    with torch.inference_mode():
        out = model(*(torch.as_tensor(a) for a in _arrays(model.cfg, seed)),
                    max_frames=max_frames, alpha=alpha)
    return out["wav_predictions"], out["output_lengths"]


@pytest.mark.parametrize("alpha", [1.0, 1.3])
def test_prefixes_are_the_untrimmed_copy_and_tails_are_zero(model, alpha):
    wav, n_frames = _forward(model, alpha)
    hop = model.cfg.vocoder.upsample_factor
    full, want_n = wav.numpy().copy(), n_frames.numpy().copy()
    # the rows this checks: one saturated (a redispatch's), one shorter, a padding row
    assert want_n[0] == FRAMES and 1 < want_n[1] < FRAMES and want_n[3] == 1
    staging, marked = HostStaging(), []
    got, n, moved = staging.copy_out(wav, n_frames, FRAMES, mark=lambda: marked.append(1))
    assert marked == [1]
    assert got.shape == full.shape and got.dtype == np.float32
    np.testing.assert_array_equal(n, want_n)
    for i, k in enumerate(want_n * hop):
        assert got[i, :k].tobytes() == full[i, :k].tobytes()
        assert not got[i, k:].any()
    assert full[0, :].any() and full[3, hop:].any()  # the tails it left behind were not zero
    assert moved == int(want_n.sum()) * hop * 4 == staging.copy_bytes
    assert staging.bucket_bytes == full.nbytes
    assert staging.copy_bytes < staging.bucket_bytes


def test_results_own_their_memory(model):
    """A second call on the same bucket overwrites the staging buffer, not
    what the first call returned, while any array of it is held: a row
    alone (as `SynthesisResult.wav` holds it) keeps its whole buffer."""
    staging = HostStaging()
    wav1, n1 = _forward(model, 1.0)
    first, first_n, _ = staging.copy_out(wav1, n1, FRAMES)
    kept, kept_n = first.copy(), first_n.copy()
    row = first[1, : int(first_n[1]) * model.cfg.vocoder.upsample_factor]
    del first
    wav2, n2 = _forward(model, 1.3, seed=4)
    second, second_n, _ = staging.copy_out(wav2, n2, FRAMES)
    assert staging.results == 2 and not np.shares_memory(row, second)
    np.testing.assert_array_equal(row, kept[1, : row.size])
    assert not np.array_equal(second, kept)  # the second call wrote other samples
    np.testing.assert_array_equal(first_n, kept_n)
    host = staging.buffer.numpy()
    for a in (row, first_n, second, second_n):
        assert not np.shares_memory(a, host)
        assert not np.shares_memory(a, staging.lengths.numpy())


def _synthetic(rows, frames, hop, lengths, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(rows, frames * hop, generator=g), torch.tensor(lengths, dtype=torch.int64)


def test_a_released_result_buffer_is_reused_with_the_old_samples_zeroed():
    """Once no array of a result is left, its buffer serves the next call;
    the spans the last call wrote are zero again, so a shorter row there
    leaves no old samples behind, and a smaller bucket fits in it."""
    hop, frames = 4, 32
    staging = HostStaging()
    wav, n = _synthetic(3, frames, hop, [32, 20, 9], 0)
    first, _, _ = staging.copy_out(wav, n, frames)
    address = first.ctypes.data
    del first
    for rows, lengths, seed in ((3, [5, 1, 30], 1), (2, [3, 17], 2)):
        wav, n = _synthetic(rows, frames, hop, lengths, seed)
        got, _, _ = staging.copy_out(wav, n, frames)
        assert got.ctypes.data == address and staging.results == 1
        for i, k in enumerate(np.array(lengths) * hop):
            assert got[i, :k].tobytes() == wav[i, :k].numpy().tobytes()
            assert not got[i, k:].any()
        del got


def test_at_most_keep_result_buffers_wait_for_reuse():
    hop, frames = 4, 8
    staging = HostStaging()
    held = [staging.copy_out(*_synthetic(2, frames, hop, [8, 3], s), frames)[0]
            for s in range(HostStaging.KEEP + 2)]
    assert staging.results == HostStaging.KEEP + 2
    del held
    assert len(staging._free) == HostStaging.KEEP
    for s in range(HostStaging.KEEP + 1):
        staging.copy_out(*_synthetic(2, frames, hop, [2, 5], s), frames)  # each released at once
    assert staging.results == HostStaging.KEEP + 2


def test_buffers_given_back_by_many_threads_are_never_handed_out_while_held():
    """Callers on more threads than cores take results (one copy at a time,
    as the engine's run lock allows) and drop them while others copy: no
    result changes while it is held, and no more than KEEP buffers wait."""
    hop, frames = 4, 8
    staging, lock, wrong = HostStaging(), threading.Lock(), []

    def caller(k):
        for j in range(40):
            wav, n = _synthetic(2, frames, hop, [frames, 1 + (k + j) % frames], 1000 * k + j)
            with lock:
                got, n_got, _ = staging.copy_out(wav, n, frames)
            want = got.copy()
            time.sleep(0)  # let the others copy and give buffers back
            if not np.array_equal(got, want) or got[0].tobytes() != wav[0].numpy().tobytes():
                wrong.append((k, j))
            del got

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=caller, args=(k,)) for k in range(2 * (os.cpu_count() or 2) + 2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert wrong == [] and len(staging._free) <= HostStaging.KEEP


def test_staging_grows_once_per_larger_bucket_and_is_reused(model):
    staging = HostStaging()
    wav, n = _forward(model, 1.0)
    staging.copy_out(wav, n, FRAMES)
    buf = staging.buffer
    assert staging.grows == 1 and buf.numel() == wav.numel() and not buf.is_pinned()
    staging.copy_out(wav, n, FRAMES)
    staging.copy_out(wav[:2], n[:2], FRAMES)  # a smaller bucket fits
    assert staging.grows == 1 and staging.buffer is buf
    big, big_n = _forward(model, 1.0, max_frames=2 * FRAMES)
    got, _, _ = staging.copy_out(big, big_n, 2 * FRAMES)
    assert staging.grows == 2 and staging.buffer.numel() == big.numel()
    hop = model.cfg.vocoder.upsample_factor
    for i, k in enumerate(big_n.numpy() * hop):
        assert got[i, :k].tobytes() == big.numpy()[i, :k].tobytes() and not got[i, k:].any()


def test_cpu_outputs_are_handed_back_as_they_are(model):
    """On the CPU nothing crosses a bus: `to_host` returns the forward's own
    outputs, counts nothing, and still calls the mark; a CPU program's span
    carries no copied bytes."""
    wav, n = _forward(model, 1.0)
    staging, marked = HostStaging(), []
    got, got_n, moved = to_host(wav, n, FRAMES, staging, mark=lambda: marked.append(1))
    assert moved is None and marked == [1] and staging.buffer is None
    assert np.shares_memory(got, wav.numpy()) and np.shares_memory(got_n, n.numpy())

    vocab = TokenVocab.from_tokens(["_", "<sos/eos>"] + [f"p{i}" for i in range(model.cfg.am.n_vocab - 2)])
    engine = SynthesisEngine(model.cfg, model, vocab, text_buckets=(T_TEXT,),
                             mel_buckets=(FRAMES,), batch_buckets=(4,), device="cpu")
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        engine.run(*_arrays(model.cfg), FRAMES, 1.0)
    (run,) = [s for s in tracing.spans() if s.name == "program.run"]
    assert "copy_bytes" not in run.attrs and "bucket_bytes" not in run.attrs
    assert engine.programs[0].staging.buffer is None


def test_each_replica_has_one_staging_and_its_sums_reach_v1_metrics(model):
    vocab = TokenVocab.from_tokens(["_", "<sos/eos>"] + [f"p{i}" for i in range(model.cfg.am.n_vocab - 2)])
    kw = dict(text_buckets=(T_TEXT,), mel_buckets=(FRAMES,), batch_buckets=(4,))
    two = SynthesisEngine(model.cfg, model, vocab, devices=["cpu", "cpu"], **kw)
    assert [s is c.staging for s, c in zip(two.staging, two.programs)] == [True, True]
    assert two.staging[0] is not two.staging[1]
    tp = SynthesisEngine(model.cfg, model, vocab, devices=["cpu", "cpu"], model_parallel=2, **kw)
    assert tp.programs is None and len(tp.staging) == 1  # the eager path's own
    prog = two.programs[0].get((2, T_TEXT, FRAMES))
    assert prog.staging is two.programs[0].staging  # shared by the replica's programs

    wav, n = _forward(model, 1.0)
    hop = model.cfg.vocoder.upsample_factor
    for staging in two.staging:
        staging.copy_out(wav, n, FRAMES)
    want = 2 * int(n.sum()) * hop * 4
    counts = two.program_counts()
    assert (counts["copy_bytes"], counts["bucket_bytes"]) == (want, 2 * wav.numel() * 4)
    svc = TTSService(two, g2p_fn=lambda text: "", embed_fn=lambda text: None,
                     speaker2id={"0": 0}, batching=False)
    try:
        programs = svc.metrics_snapshot()["programs"]
    finally:
        svc.close()
    assert (programs["copy_bytes"], programs["bucket_bytes"]) == (want, 2 * wav.numel() * 4)
