"""The port's serving shell on the CPU at tiny_test_config size: TTSService
against the JAX package's on the same weights, streaming, error mapping,
metrics, the stdlib HTTP server over a real socket, warmup shapes and the
background-warmup daemon, the Cog predictor and the two CLIs."""

import http.client
import io
import json
import os
import subprocess
import sys
import threading
import time
import zlib

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from test_torch_support import (
    StandInTokenizer,
    both_configs,
    jax_jets_params,
    jax_lax_engine,
    jax_style_params,
    port_jets,
    port_style_encoder,
)

from emotivoice_tpu.frontend.mixed import g2p_cn_en as jax_g2p
from emotivoice_tpu.frontend.tokens import TokenVocab as JTokenVocab
from emotivoice_tpu.serving.api import TTSService as JTTSService
from emotivoice_tpu.serving.engine import SynthesisEngine as JEngine
from emotivoice_tpu_torch.frontend.cn import _HAS_PYPINYIN
from emotivoice_tpu_torch.frontend.mixed import g2p_cn_en
from emotivoice_tpu_torch.frontend.tokens import TokenVocab
from emotivoice_tpu_torch.serving import api
from emotivoice_tpu_torch.serving.api import TranscodeUnavailable, TTSService, make_stdlib_server
from emotivoice_tpu_torch.serving.engine import SynthesisEngine
from emotivoice_tpu_torch.utils.audio_io import pcm16_bytes, wav_stream_header, write_wav

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUCKETS = dict(text_buckets=(16, 32, 64), mel_buckets=(128, 256, 512), batch_buckets=(1, 2, 4))
SHORT = "Hello world."
LONG = "The quick brown fox jumps. Over the lazy dog it goes! Then it rests?"
VOICES = {"0": 0, "3": 3, "中文": 5}


def stand_in_embed(d):
    """text -> (d,) f32 from a stable hash of the text."""
    def embed(text):
        return np.random.RandomState(zlib.crc32(text.encode("utf-8"))).randn(d).astype(np.float32)
    return embed


@pytest.fixture(scope="module")
def setup():
    """(JAX engine, port engine) over the same seeded tiny weights, with
    the default phoneme vocabulary so the real g2p feeds them."""
    jc, tc = both_configs()
    n = len(TokenVocab.default())
    jc = jc.replace(am=jc.am.__class__(**{**jc.am.__dict__, "n_vocab": n}))
    tc = tc.replace(am=tc.am.__class__(**{**tc.am.__dict__, "n_vocab": n}))
    params = jax_jets_params(jc, seed=3)
    jengine = jax_lax_engine(jc, params, JTokenVocab.default(), **BUCKETS)
    engine = SynthesisEngine(tc, port_jets(tc, params), TokenVocab.default(), device="cpu",
                             **BUCKETS)
    return jengine, engine


def port_service(engine, **kw):
    kw.setdefault("batching", False)
    return TTSService(engine, g2p_fn=g2p_cn_en,
                      embed_fn=stand_in_embed(engine.cfg.am.bert_embedding),
                      speaker2id=VOICES, longform_chars=40, **kw)


def parse_wav(data: bytes):
    sr, pcm = wavfile.read(io.BytesIO(data))
    assert sr == 16000 and pcm.dtype == np.int16 and pcm.ndim == 1
    return pcm


# ---------------------------------------------------------------------------
# the service as a whole, against the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("text,speed,min_chunks", [(SHORT, 1.0, 1), (LONG, 1.0, 2),
                                                   (SHORT, 1.5, 1)],
                         ids=["short", "longform", "speed"])
def test_speech_matches_jax_service(setup, text, speed, min_chunks):
    jengine, engine = setup
    d = engine.cfg.am.bert_embedding
    with JTTSService(jengine, g2p_fn=jax_g2p, embed_fn=stand_in_embed(d), speaker2id=VOICES,
                     longform_chars=40, batching=False) as jsvc, port_service(engine) as svc:
        assert len(svc._build_requests(text, "3", "", speed)) >= min_chunks
        want = parse_wav(jsvc.speech(text, "3", prompt="Happy", speed=speed))
        got = parse_wav(svc.speech(text, "3", prompt="Happy", speed=speed))
    assert len(got) == len(want) and len(got) % 256 == 0 and len(got) > 0
    assert np.abs(want.astype(np.int32)).max() > 100  # not silence
    assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 2


def test_build_requests_same_as_jax(setup):
    jengine, engine = setup
    d = engine.cfg.am.bert_embedding
    with JTTSService(jengine, g2p_fn=jax_g2p, embed_fn=stand_in_embed(d), speaker2id=VOICES,
                     longform_chars=40, batching=False) as jsvc, port_service(engine) as svc:
        for text, prompt, speed in ((SHORT, "", 1.0), (LONG, "Sad", 2.0), (LONG, "", 0.0)):
            want = jsvc._build_requests(text, "3", prompt, speed)
            got = svc._build_requests(text, "3", prompt, speed)
            assert len(got) == len(want)
            for g, w in zip(got, want):
                assert g.phonemes == w.phonemes and g.speaker_id == w.speaker_id
                assert g.alpha == w.alpha
                np.testing.assert_array_equal(g.style_embedding, w.style_embedding)
                np.testing.assert_array_equal(g.content_embedding, w.content_embedding)


def test_stream_equals_speech(setup):
    _, engine = setup
    with port_service(engine) as svc:
        parts = list(svc.speech_stream(LONG, "0"))
        whole = svc.speech(LONG, "0")
    assert parts[0] == wav_stream_header(engine.sr) and len(parts[0]) == 44
    assert parts[0][4:8] == parts[0][40:44] == b"\xff\xff\xff\xff"
    assert len(parts) >= 3  # header + one PCM part per sentence chunk
    # The stream runs each chunk at batch 1, speech() all of them in one
    # padded batch: f32 sums in another order, so at most one int16 step.
    streamed = np.frombuffer(b"".join(parts[1:]), "<i2").astype(np.int32)
    assert len(streamed) == len(parse_wav(whole))
    assert np.abs(streamed - parse_wav(whole)).max() <= 1


def test_unknown_voice_raises_before_first_yield(setup):
    _, engine = setup
    with port_service(engine) as svc:
        with pytest.raises(KeyError, match="unknown voice"):
            svc.speech_stream("hello", "missing-voice")
        with pytest.raises(KeyError, match="unknown voice"):
            svc.speech("hello", "missing-voice")
        assert svc.metrics.snapshot()["errors"] == 2


def test_mp3_without_encoder_raises_transcode_unavailable(setup, monkeypatch):
    _, engine = setup
    monkeypatch.setitem(sys.modules, "pydub", None)  # import raises ImportError
    monkeypatch.setattr(api.shutil, "which", lambda name: None)
    with port_service(engine) as svc:
        with pytest.raises(TranscodeUnavailable, match="wav"):
            svc.speech(SHORT, "0", response_format="mp3")
        assert parse_wav(svc.speech(SHORT, "0", response_format="")).size  # '' means wav


def test_metrics_snapshot_same_keys_as_jax_and_right_counts(setup):
    jengine, engine = setup
    d = engine.cfg.am.bert_embedding
    fixed = dict(g2p_fn=lambda text: "<sos/eos> [HH] [AH0] <sos/eos>",
                 embed_fn=stand_in_embed(d), speaker2id=VOICES)

    def drive(svc):
        svc.speech("hello", "0")
        svc.speech("world", "0")
        with pytest.raises(KeyError):
            svc.speech("x", "missing-voice")
        list(svc.speech_stream("stream me", "0"))
        return svc.metrics.snapshot(svc._batcher, svc.engine)

    with JTTSService(jengine, batching=True, **fixed) as jsvc:
        want = drive(jsvc)
    with TTSService(engine, batching=True, **fixed) as svc:
        got = drive(svc)

    def keys(x):
        return {k: keys(v) for k, v in x.items()} if isinstance(x, dict) else None

    assert keys(got) == keys(want)
    assert got["requests"] == want["requests"] == 3 and got["errors"] == want["errors"] == 1
    assert got["batching"] == want["batching"] == {
        "dispatches": 3, "batched_requests": 3, "mean_batch": 1.0}
    assert got["duration_overflow"] == want["duration_overflow"]
    assert got["latency_s"]["p50"] > 0 and got["rtf"]["p50"] > 0
    assert got["audio_seconds_served"] == want["audio_seconds_served"] > 0


def test_concurrent_requests_share_dispatches(setup):
    _, engine = setup
    with port_service(engine, batching=True) as svc:
        svc._batcher.max_wait_ms = 300.0
        start = threading.Barrier(4)
        out = [None] * 4

        def call(i):
            start.wait(timeout=60)
            out[i] = svc.speech(SHORT, "0")

        threads = [threading.Thread(target=call, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        snap = svc.metrics.snapshot(svc._batcher, engine)
    assert all(o is not None and o == out[0] for o in out)
    assert snap["batching"]["batched_requests"] == 4
    assert snap["batching"]["dispatches"] < 4
    assert svc._batcher is None  # closed by the context manager


def test_write_wav_takes_a_file_object_and_a_path(tmp_path):
    wav = np.array([0.0, 0.5, -0.5, 1.5, -1.5], np.float32)
    buf = io.BytesIO()
    write_wav(buf, wav, 16000)
    write_wav(str(tmp_path / "a.wav"), wav, 16000)
    want = np.array([0, 16384, -16384, 32767, -32768], np.int16)
    np.testing.assert_array_equal(parse_wav(buf.getvalue()), want)
    np.testing.assert_array_equal(wavfile.read(tmp_path / "a.wav")[1], want)
    assert pcm16_bytes(wav) == want.astype("<i2").tobytes()
    assert buf.getvalue()[44:] == pcm16_bytes(wav)


def test_audio_helpers_same_bytes_as_jax():
    from emotivoice_tpu.utils import audio_io as jio

    wav = np.random.RandomState(0).randn(1000).astype(np.float32)
    assert pcm16_bytes(wav) == jio.pcm16_bytes(wav)
    for sr in (16000, 22050):
        assert wav_stream_header(sr) == jio.wav_stream_header(sr)
    a, b = io.BytesIO(), io.BytesIO()
    write_wav(a, wav, 16000)
    jio.write_wav(b, wav, 16000)
    assert a.getvalue() == b.getvalue()


def test_demo_page_lists_voices():
    from emotivoice_tpu_torch.serving.demo import render_demo_page

    page = render_demo_page(["0", "3"])
    assert page.startswith("<!doctype html>") and "/v1/audio/speech" in page
    assert '"0"' in page or ">0<" in page


# ---------------------------------------------------------------------------
# the stdlib server over a socket
# ---------------------------------------------------------------------------

@pytest.fixture
def server(setup):
    _, engine = setup
    svc = port_service(engine, batching=True)
    srv = make_stdlib_server(svc, "127.0.0.1", 0)
    assert srv.request_queue_size >= 64  # a burst of a full batch fits the listen backlog
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        yield svc, srv.server_address[1]
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(timeout=30)
        batcher_worker = svc._batcher._worker
        svc.close()
        assert not th.is_alive() and not batcher_worker.is_alive()


def request(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        data = json.dumps(body).encode() if body is not None else None
        conn.request(method, path, body=data,
                     headers={"Content-Type": "application/json"} if data else {})
        resp = conn.getresponse()
        return resp.status, resp.reason, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def test_http_get_endpoints(server):
    svc, port = server
    status, _, headers, body = request(port, "GET", "/healthz")
    assert status == 200 and json.loads(body) == {"status": "ok"}
    status, _, _, body = request(port, "GET", "/v1/voices")
    assert status == 200 and json.loads(body) == {"voices": sorted(VOICES)}
    status, _, headers, body = request(port, "GET", "/")
    assert status == 200 and headers["Content-Type"].startswith("text/html")
    assert request(port, "GET", "/nope")[0] == 404
    assert request(port, "POST", "/v1/nope", {"input": "x"})[0] == 404


def test_http_speech_wav_and_chunked_stream(server):
    svc, port = server
    body = {"input": LONG, "voice": "3", "response_format": "wav"}
    status, _, headers, data = request(port, "POST", "/v1/audio/speech", body)
    assert status == 200 and headers["Content-Type"] == "audio/wav"
    assert int(headers["Content-Length"]) == len(data)
    pcm = parse_wav(data)
    assert len(pcm) % 256 == 0 and np.abs(pcm.astype(np.int32)).max() > 100

    status, _, headers, streamed = request(port, "POST", "/v1/audio/speech",
                                           {**body, "stream": True})
    assert status == 200 and headers["Transfer-Encoding"] == "chunked"
    assert "Content-Length" not in headers
    assert streamed[:44] == wav_stream_header(16000)
    # http.client undid the chunk framing; same sample count as the
    # non-streamed answer, samples within one int16 step (batch 1 vs padded)
    spcm = np.frombuffer(streamed[44:], "<i2").astype(np.int32)
    assert len(spcm) == len(pcm) and np.abs(spcm - pcm).max() <= 1

    snap = json.loads(request(port, "GET", "/v1/metrics")[3])
    assert snap["requests"] == 2 and snap["errors"] == 0
    assert snap["batching"]["batched_requests"] >= 4  # >= 2 chunks, twice


def test_http_chunk_framing_on_the_wire(server):
    """HTTP/1.1 status line and hex-length chunk framing, read raw."""
    import socket

    svc, port = server
    payload = json.dumps({"input": SHORT, "voice": "0", "stream": True}).encode()
    with socket.create_connection(("127.0.0.1", port), timeout=120) as s:
        s.sendall(b"POST /v1/audio/speech HTTP/1.1\r\nHost: x\r\nConnection: close\r\n"
                  b"Content-Length: %d\r\n\r\n" % len(payload) + payload)
        raw = b""
        while not raw.endswith(b"0\r\n\r\n"):
            part = s.recv(65536)
            assert part, "connection closed before the last chunk"
            raw += part
    head, rest = raw.split(b"\r\n\r\n", 1)
    assert head.startswith(b"HTTP/1.1 200")
    assert rest.startswith(b"2c\r\n" + wav_stream_header(16000) + b"\r\n")  # 0x2c = 44


def test_http_error_mapping(server):
    svc, port = server
    status, reason, _, _ = request(port, "POST", "/v1/audio/speech",
                                   {"input": SHORT, "voice": "nobody", "response_format": "wav"})
    assert status == 400 and "unknown voice" in reason
    status, reason, _, _ = request(port, "POST", "/v1/audio/speech",
                                   {"input": SHORT, "voice": "nobody", "stream": True})
    assert status == 400 and "unknown voice" in reason
    # a message outside latin-1 still comes back as its status
    status, reason, _, _ = request(port, "POST", "/v1/audio/speech",
                                   {"input": SHORT, "voice": "没有", "response_format": "wav"})
    assert status == 400 and "unknown voice" in reason
    errors = 3
    if not (api.shutil.which("ffmpeg") or _has("pydub")):
        # the HTTP default response_format is mp3
        status, reason, _, _ = request(port, "POST", "/v1/audio/speech",
                                       {"input": SHORT, "voice": "0"})
        assert status == 400 and "retry with response_format='wav'" in reason
        errors += 0  # synthesis succeeded; the transcode failed after it
    if not _HAS_PYPINYIN:
        for text in ("你好世界", "call 911"):  # digits are read as Chinese numerals
            status, reason, _, _ = request(
                port, "POST", "/v1/audio/speech",
                {"input": text, "voice": "0", "response_format": "wav"})
            assert status == 500 and "pypinyin is required" in reason
            errors += 1
    status, _, _, data = request(port, "POST", "/v1/audio/speech",
                                 {"input": SHORT, "voice": "中文", "response_format": "wav"})
    assert status == 200 and parse_wav(data).size
    snap = json.loads(request(port, "GET", "/v1/metrics")[3])
    assert snap["errors"] == errors


def _has(module):
    import importlib.util

    return importlib.util.find_spec(module) is not None


# ---------------------------------------------------------------------------
# warmup and the background daemon
# ---------------------------------------------------------------------------

def _fake_outputs(rows, max_frames, up):
    return np.zeros((rows, max_frames * up), np.float32), np.ones((rows,), np.int64)


def _jax_shapes_seen(jengine, call):
    """(rows, text, mel) of every compiled-function call the JAX engine makes
    during `call`, with the functions themselves replaced by stubs."""
    seen = []

    def compiled(t_text, max_frames):
        def fn(params, tokens, *rest):
            seen.append((tokens.shape[0], tokens.shape[1], max_frames))
            return _fake_outputs(tokens.shape[0], max_frames, jengine.up)
        return fn

    jengine._compiled = compiled
    try:
        call(jengine)
    finally:
        del jengine._compiled
    return seen


def _port_shapes_seen(engine, call, monkeypatch):
    seen = []

    def run(tokens, lengths, speaker, style, content, max_frames, alpha):
        seen.append((tokens.shape[0], tokens.shape[1], max_frames))
        return _fake_outputs(tokens.shape[0], max_frames, engine.up)

    monkeypatch.setattr(engine, "run", run)
    call(engine)
    return seen


@pytest.mark.parametrize("shapes", [
    None,  # the default list
    [(1, 8, 64), (2, 16, 128), (1, 8, 128), (3, 16, 128), (4, 5, 64)],
], ids=["default", "with-non-default-mel-and-padding"])
def test_warmup_runs_the_same_shapes_as_jax(setup, monkeypatch, shapes):
    jengine, engine = setup
    kw = {} if shapes is None else dict(text_buckets=(8, 16), mel_buckets=(64, 128),
                                        batch_buckets=(1, 2, 4))
    je = JEngine(jengine.cfg, jengine.params, jengine.vocab, **kw)
    pe = SynthesisEngine(engine.cfg, engine.model, engine.vocab, device="cpu", **kw)
    want = _jax_shapes_seen(je, lambda e: e.warmup(shapes))
    got = _port_shapes_seen(pe, lambda e: e.warmup(shapes), monkeypatch)
    assert got == want and len(got) == len(shapes or [0] * 4)
    if shapes:
        assert got[3] == (4, 16, 128)  # 3 rows padded to the batch bucket


def _walk_background(e, **kw):
    warmed, done = [], []
    e._warm_one = lambda b, t, m: warmed.append((b, t, m))
    th = e.warmup_background(progress_cb=lambda i, n: done.append((i, n)), **kw)
    th.join(timeout=60)
    assert not th.is_alive()
    return warmed, done


@pytest.mark.parametrize("kw", [{}, {"batches": (1,)}, {"batches": (3, 32)}],
                         ids=["default", "batch-1", "off-ladder"])
def test_background_warmup_walks_the_same_grid_as_jax(setup, kw):
    jengine, engine = setup
    je = JEngine(jengine.cfg, jengine.params, jengine.vocab)  # default ladders
    pe = SynthesisEngine(engine.cfg, engine.model, engine.vocab, device="cpu")
    want, _ = _walk_background(je, **kw)
    got, done = _walk_background(pe, **kw)
    assert got == want == pe.warmup_grid(**kw)
    assert done == [(i + 1, len(got)) for i in range(len(got))]
    assert pe.warmup_failures == 0


def test_background_warm_one_pads_to_the_batch_bucket(setup, monkeypatch):
    _, engine = setup
    pe = SynthesisEngine(engine.cfg, engine.model, engine.vocab, device="cpu",
                         text_buckets=(8,), mel_buckets=(64, 128), batch_buckets=(1, 2, 4))
    seen = _port_shapes_seen(
        pe, lambda e: e.warmup_background(batches=(1, 3)).join(timeout=60), monkeypatch)
    assert seen == [(1, 8, 64), (1, 8, 128), (4, 8, 64), (4, 8, 128)]


def test_background_warmup_waits_for_traffic(setup):
    _, engine = setup
    pe = SynthesisEngine(engine.cfg, engine.model, engine.vocab, device="cpu",
                         text_buckets=(8,), mel_buckets=(64,), batch_buckets=(1,))
    stamps = []
    pe._warm_one = lambda b, t, m: stamps.append(time.monotonic())
    with pe._traffic_lock:
        pe._inflight = 1
    th = pe.warmup_background(batches=(1,))
    time.sleep(0.4)
    assert not stamps and th.is_alive()  # a request is in flight: the daemon waits
    with pe._traffic_lock:
        pe._inflight = 0
        pe._last_traffic = released = time.monotonic()
    th.join(timeout=30)
    assert not th.is_alive() and len(stamps) == 1
    assert stamps[0] - released >= 0.25  # and stays away for idle_s after it


def test_synthesize_batch_keeps_the_traffic_account(setup, monkeypatch):
    _, engine = setup
    inflight = []
    run = engine.run

    def spy(*a, **kw):
        inflight.append(engine._inflight)
        return run(*a, **kw)

    monkeypatch.setattr(engine, "run", spy)
    before = time.monotonic()
    with port_service(engine) as svc:
        svc.speech(SHORT, "0")
    assert inflight and all(n == 1 for n in inflight)
    assert engine._inflight == 0 and engine._last_traffic >= before

    def boom(*a, **kw):
        raise RuntimeError("device lost")

    monkeypatch.setattr(engine, "run", boom)
    with port_service(engine) as svc, pytest.raises(RuntimeError, match="device lost"):
        svc.speech(SHORT, "0")
    assert engine._inflight == 0


def test_background_warmup_counts_failures_and_goes_on(setup, caplog):
    _, engine = setup
    pe = SynthesisEngine(engine.cfg, engine.model, engine.vocab, device="cpu",
                         text_buckets=(8, 16), mel_buckets=(64,), batch_buckets=(1,))
    warmed = []

    def warm(b, t, m):
        if t == 8:
            raise RuntimeError("CUDA error: an illegal memory access")
        warmed.append((b, t, m))

    pe._warm_one = warm
    done = []
    with caplog.at_level("ERROR", logger="emotivoice_tpu_torch.serving"):
        th = pe.warmup_background(batches=(1,), progress_cb=lambda i, n: done.append(i))
        th.join(timeout=30)
    assert not th.is_alive() and pe.warmup_failures == 1
    assert warmed == [(1, 16, 64)] and done == [1, 2]
    assert "illegal memory access" in caplog.text


# ---------------------------------------------------------------------------
# Cog predictor and the CLIs
# ---------------------------------------------------------------------------

def test_predictor_writes_a_wav(setup):
    from emotivoice_tpu_torch.serving.cog_predictor import Predictor

    _, engine = setup
    p = Predictor()
    p.setup(engine=engine)
    assert set(p.speaker2id) >= {"0", "3", "2013"}
    p.embed_fn = stand_in_embed(engine.cfg.am.bert_embedding)
    path = p.predict(prompt="Happy", content="Hello world", language="English", speaker="3")
    sr, pcm = wavfile.read(str(path))
    assert sr == engine.sr and pcm.dtype == np.int16 and len(pcm) % 256 == 0 and len(pcm) > 0
    with pytest.raises(ValueError, match="Chinese"):
        p.predict(content="你好", language="English", speaker="0")
    with pytest.raises(ValueError, match="English"):
        p.predict(content="hello", language="Chinese", speaker="0")
    with pytest.raises(ValueError, match="unknown speaker"):
        p.predict(content="hello", language="English", speaker="nobody")


def test_predictor_needs_a_checkpoint_without_an_engine(monkeypatch):
    from emotivoice_tpu_torch.serving.cog_predictor import Predictor

    monkeypatch.delenv("EMOTIVOICE_CHECKPOINT", raising=False)
    with pytest.raises(AssertionError, match="checkpoint path required"):
        Predictor().setup(device="cpu")


def test_serve_cli_needs_a_card():
    """`--device cuda` (the default) exits non-zero where no card is, before
    it listens."""
    res = subprocess.run(
        [sys.executable, "-m", "emotivoice_tpu_torch.serve", "--device", "cuda", "--smoke-tiny",
         "--no-warmup", "--port", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert res.returncode != 0
    assert "no CUDA device is available" in res.stderr


def test_serve_cli_rejects_the_parallel_flags(capsys):
    """The JAX server's flags the port has no counterpart of, and the
    data-parallel ones in combinations it refuses; the refusal of a model
    split over processes points to the API that serves one."""
    from emotivoice_tpu_torch import serve

    for flags in (["--model-parallel=2", "--multihost", "--device", "cpu"],
                  ["--use-pallas", "--device", "cpu"],
                  ["--data-parallel=2", "--multihost", "--device", "cpu"],
                  ["--data-parallel=2", "--device", "cuda:1"]):
        capsys.readouterr()
        with pytest.raises(SystemExit):
            serve.main(flags)
        if "--multihost" in flags and "--model-parallel=2" in flags:
            err = capsys.readouterr().err
            assert "--model-parallel and --multihost" in err
            assert "SynthesisEngine(model_group=" in err and "make_rank_mesh" in err


def test_serve_cli_serves_on_the_cpu(monkeypatch):
    """main() wires model, warmup, background warmup and service together;
    the server it would block in is replaced by one request."""
    from emotivoice_tpu_torch import serve

    monkeypatch.setitem(sys.modules, "uvicorn", None)  # take the stdlib branch
    served = {}

    def fake_serve(service, host, port):
        with service:
            served["voices"] = len(service.speaker2id)
            served["wav"] = service.speech("Hello world.", "3")
            served["failures"] = service.engine.warmup_failures

    monkeypatch.setattr(api, "serve_stdlib", fake_serve)
    serve.main(["--device", "cpu", "--smoke-tiny", "--no-warmup", "--no-background-warmup",
                "--port", "0", "--seed", "1"])
    assert served["voices"] == 8 and served["failures"] == 0
    assert len(parse_wav(served["wav"])) % 256 == 0


def test_serve_cli_model_parallel_serves_on_the_cpu(monkeypatch):
    """`--model-parallel 2 --device cpu`: one replica split over two CPU
    devices answers a request through the stdlib branch, with the same
    waveform as the one-device server of the same seed."""
    from emotivoice_tpu_torch import serve

    monkeypatch.setitem(sys.modules, "uvicorn", None)
    served = []

    def fake_serve(service, host, port):
        with service:
            served.append((service.engine, service.speech("Hello world.", "3")))

    monkeypatch.setattr(api, "serve_stdlib", fake_serve)
    args = ["--device", "cpu", "--smoke-tiny", "--no-warmup", "--no-background-warmup",
            "--port", "0", "--seed", "1"]
    serve.main(args + ["--model-parallel", "2"])
    serve.main(args)
    (tp, wav_tp), (one, wav_one) = served
    assert tp.groups == [[torch.device("cpu")] * 2] and len(tp.replicas) == 1
    assert type(tp.model.generator.conv_post).__name__ == "RowParallel"
    assert type(one.model.generator.conv_post).__name__ == "WNConv1d"
    pcm_tp, pcm_one = parse_wav(wav_tp), parse_wav(wav_one)
    assert len(pcm_tp) == len(pcm_one) > 0 and len(pcm_tp) % 256 == 0
    assert np.abs(pcm_tp.astype(np.int32) - pcm_one).max() <= 1


def test_synthesize_cli_with_checkpoints(tmp_path, monkeypatch):
    """The batch CLI on two lines with a reference-layout generator
    checkpoint (parametrize weight-norm names, `module.` prefixes) and a
    style-encoder checkpoint: the lines' prompt and content fields reach the
    model, and the output equals the engine's on the same weights."""
    import emotivoice_tpu_torch.config as pcfg
    from emotivoice_tpu_torch import synthesize
    from emotivoice_tpu_torch.models.jets import JETSGenerator, init_random_
    from emotivoice_tpu_torch.serving import style as style_mod
    from emotivoice_tpu_torch.serving.engine import SynthesisRequest
    from emotivoice_tpu_torch.serving.loading import config_and_vocab
    from emotivoice_tpu_torch.serving.style import StyleEmbedder

    plain_tiny = pcfg.tiny_test_config()
    style_params = jax_style_params(both_configs()[0].bert, seed=6)
    tiny, vocab = config_and_vocab(plain_tiny)
    monkeypatch.setattr(pcfg, "EmotiVoiceConfig", lambda: plain_tiny)
    model = init_random_(JETSGenerator(tiny), seed=4)
    sd = {}
    for k, v in model.state_dict().items():
        k = k.replace(".weight_g", ".parametrizations.weight.original0")
        k = k.replace(".weight_v", ".parametrizations.weight.original1")
        sd[f"module.{k}"] = v
    torch.save({"generator": sd}, tmp_path / "g_00000001")
    bert = port_style_encoder(tiny.bert, style_params)
    torch.save({"model": {f"module.{k}": v for k, v in bert.state_dict().items()}},
               tmp_path / "checkpoint_1")
    tok = StandInTokenizer(tiny.bert.vocab_size)
    # the tokenizer path is resolved by transformers; hand the stand-in over
    real = StyleEmbedder.from_checkpoint.__func__

    def from_checkpoint(cls, ckpt, cfg, tokenizer_path=None, device=None):
        emb = real(cls, ckpt, cfg, None, device)
        emb.tokenizer = tok
        return emb

    monkeypatch.setattr(style_mod.StyleEmbedder, "from_checkpoint", classmethod(from_checkpoint))

    lines = tmp_path / "lines.txt"
    lines.write_text("0|Happy|<sos/eos> [HH] [AH0] [L] [OW1] <sos/eos>|hello\n"
                     "3|Sad|<sos/eos> [W] [ER1] [L] [D] <sos/eos>|world\n")
    out = tmp_path / "out"
    synthesize.main(["--test-file", str(lines), "--output-dir", str(out), "--device", "cpu",
                     "--checkpoint", str(tmp_path / "g_00000001"),
                     "--style-encoder", str(tmp_path / "checkpoint_1"), "--tokenizer", "unused"])
    assert sorted(p.name for p in out.iterdir()) == ["0000_0.wav", "0001_3.wav"]

    engine = SynthesisEngine(tiny, model, vocab, device="cpu")
    emb = StyleEmbedder(bert, tiny.bert, tok, device="cpu")
    want = engine.synthesize_batch([
        SynthesisRequest("<sos/eos> [HH] [AH0] [L] [OW1] <sos/eos>".split(), 0,
                         emb.embed("Happy"), emb.embed("hello")),
        SynthesisRequest("<sos/eos> [W] [ER1] [L] [D] <sos/eos>".split(), 3,
                         emb.embed("Sad"), emb.embed("world")),
    ])
    for name, res in zip(("0000_0.wav", "0001_3.wav"), want):
        assert wavfile.read(out / name)[1].tobytes() == pcm16_bytes(res.wav)
    # zero embeddings would have given another waveform: the fields are used
    zeros = np.zeros(tiny.am.bert_embedding, np.float32)
    plain = engine.synthesize(SynthesisRequest(
        "<sos/eos> [HH] [AH0] [L] [OW1] <sos/eos>".split(), 0, zeros, zeros))
    assert pcm16_bytes(plain.wav) != pcm16_bytes(want[0].wav)


def _checkpoint_models():
    """(tiny config, a seeded generator whose weight-norm gains are not
    ||v||, its state dict)."""
    import emotivoice_tpu_torch.config as pcfg
    from emotivoice_tpu_torch.models.jets import JETSGenerator, init_random_

    tiny = pcfg.tiny_test_config()
    model = init_random_(JETSGenerator(tiny), seed=2)
    for p in model.parameters():  # gains that are not ||v||, so the fold matters
        if p.dim() == 3 and p.shape[1:] == (1, 1):
            p.data *= 1.5
    return tiny, model, model.state_dict()


def _folded_checkpoint(sd):
    """The state dict with every weight-norm pair folded into `weight`."""
    folded = {}
    for k, v in sd.items():
        if k.endswith(".weight_g"):
            vv = sd[k[:-2] + "_v"]
            norm = torch.sqrt(torch.sum(vv * vv, dim=(1, 2), keepdim=True))
            folded[k[:-2]] = v * vv / norm
        elif not k.endswith(".weight_v"):
            folded[k] = v
    return folded


def _mel(n_mels: int, seed: int) -> torch.Tensor:
    return torch.randn(1, 12, n_mels, generator=torch.Generator().manual_seed(seed))


def test_generator_checkpoint_layouts(tmp_path):
    """load_jets_generator takes legacy weight-norm names and folded
    weights too, and raises on a checkpoint that lacks a parameter."""
    from emotivoice_tpu_torch.convert.from_reference import load_jets_generator
    from emotivoice_tpu_torch.models.hifigan import WeightNorm
    from emotivoice_tpu_torch.models.jets import JETSGenerator

    tiny, model, sd = _checkpoint_models()
    mel = _mel(tiny.am.n_mels, 0)
    with torch.no_grad():
        want = model.generator(mel)
        legacy = load_jets_generator(JETSGenerator(tiny), {"generator": sd})
        torch.testing.assert_close(legacy.generator(mel), want, rtol=0, atol=0)
        loaded = load_jets_generator(JETSGenerator(tiny), _folded_checkpoint(sd))
        # The checkpoint's folded weights come back within f32 rounding: the
        # loader takes g = ||W||, v = W, and the model folds g v / ||v|| again.
        pairs = [(a, b) for a, b in zip(model.modules(), loaded.modules())
                 if isinstance(a, WeightNorm)]
        assert pairs
        for a, b in pairs:
            torch.testing.assert_close(b.folded(), a.folded(), rtol=1e-6, atol=0)
        got = loaded.generator(mel)
        assert float(want.abs().max()) > 0.05
        # That one extra rounding, amplified through the generator: over 400
        # seeded mels the worst is 1.99e-4 (`PYTHONPATH=.:tests python
        # tests/test_torch_api.py`).
        torch.testing.assert_close(got, want, rtol=0, atol=5e-4)
    del sd["am.to_mel.weight"]
    with pytest.raises(KeyError, match="am.to_mel.weight"):
        load_jets_generator(JETSGenerator(tiny), sd)


if __name__ == "__main__":
    # The sweep behind test_generator_checkpoint_layouts' bound: the same
    # comparison on 400 seeded mels, its worst case and where it fell.
    from emotivoice_tpu_torch.convert.from_reference import load_jets_generator
    from emotivoice_tpu_torch.models.jets import JETSGenerator

    tiny, model, sd = _checkpoint_models()
    loaded = load_jets_generator(JETSGenerator(tiny), _folded_checkpoint(sd))
    with torch.no_grad():
        errs = [float((loaded.generator(m) - model.generator(m)).abs().max())
                for m in (_mel(tiny.am.n_mels, seed) for seed in range(400))]
    print(f"worst {max(errs):.3g} at seed {int(np.argmax(errs))}; "
          f"{sum(e > 1e-4 for e in errs)} of 400 above 1e-4")
