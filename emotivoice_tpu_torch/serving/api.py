"""OpenAI-compatible TTS HTTP API (counterpart of
`emotivoice_tpu/serving/api.py`).

Parity target: reference `openaiapi.py` — `POST /v1/audio/speech` with
`{input, voice, prompt, response_format, speed}` (reference lines 152-184).

Two server frontends over the same handler:
  - FastAPI app factory (`create_fastapi_app`) when fastapi is installed,
  - a dependency-free stdlib `http.server` implementation
    (`make_stdlib_server` / `serve_stdlib`) so serving works in hermetic
    environments.

Speed control: the reference shells out to pyrubberband; we implement
time-scale natively through the duration predictor's `alpha` knob
(alpha = 1/speed), which changes predicted durations instead of
post-processing audio — better quality and no subprocess.
Response formats: wav natively; mp3/opus/etc. require ffmpeg/pydub and are
gated.
"""

from __future__ import annotations

import io
import json
import logging
import shutil
import subprocess
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict

import numpy as np

from emotivoice_tpu_torch.frontend.segment import split_sentences
from emotivoice_tpu_torch.serving.batcher import MicroBatcher
from emotivoice_tpu_torch.serving.demo import render_demo_page
from emotivoice_tpu_torch.serving.engine import SynthesisEngine, SynthesisRequest
from emotivoice_tpu_torch.serving.metrics import ServiceMetrics
from emotivoice_tpu_torch.utils.audio_io import pcm16_bytes, wav_stream_header, write_wav


class TTSService:
    """Request handler shared by both server frontends."""

    def __init__(
        self,
        engine: SynthesisEngine,
        g2p_fn: Callable[[str], str],
        embed_fn: Callable[[str], np.ndarray],
        speaker2id: Dict[str, int],
        default_prompt: str = "",
        longform_chars: int = 120,
        batching: bool = True,
    ):
        self.engine = engine
        self.g2p_fn = g2p_fn
        self.embed_fn = embed_fn
        self.speaker2id = speaker2id
        self.default_prompt = default_prompt
        # Inputs longer than this are sentence-chunked and batched through
        # the engine in one dispatch (see frontend.segment).
        self.longform_chars = longform_chars
        # Cross-request micro-batching: concurrent requests aggregate into
        # one device dispatch (serving/batcher.py). Falls back to a plain
        # lock when disabled.
        self._batcher = None
        if batching:
            self._batcher = MicroBatcher(engine)
        self._lock = threading.Lock()
        self.metrics = ServiceMetrics()
        self._log = logging.getLogger("emotivoice_tpu_torch.serving")

    def close(self):
        """Stop the micro-batcher worker thread (idempotent)."""
        if self._batcher is not None:
            self._batcher.close()
            self._batcher = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _build_requests(self, input_text, voice, prompt, speed):
        if voice not in self.speaker2id:
            raise KeyError(f"unknown voice {voice!r}")
        prompt = prompt or self.default_prompt or input_text
        if len(input_text) > self.longform_chars:
            chunks = split_sentences(input_text, self.longform_chars) or [
                input_text
            ]
        else:
            chunks = [input_text]
        style = self.embed_fn(prompt)
        alpha = 1.0 / max(speed, 1e-3)
        return [
            SynthesisRequest(
                phonemes=self.g2p_fn(c).split(),
                speaker_id=self.speaker2id[voice],
                style_embedding=style,
                content_embedding=self.embed_fn(c),
                alpha=alpha,
            )
            for c in chunks
        ]

    def _synthesize(self, reqs):
        if self._batcher is not None:
            return self._batcher.submit_many(reqs)
        with self._lock:
            return self.engine.synthesize_batch(reqs)

    def speech(
        self,
        input_text: str,
        voice: str,
        prompt: str = "",
        speed: float = 1.0,
        # Programmatic default stays wav (dependency-free); the HTTP layers
        # default to mp3 for schema parity with the reference
        # (openaiapi.py:152-162) and 400 cleanly when no encoder exists.
        response_format: str = "wav",
    ) -> bytes:
        t0 = time.perf_counter()
        try:
            reqs = self._build_requests(input_text, voice, prompt, speed)
            results = self._synthesize(reqs)
        except Exception:
            self.metrics.observe_error()
            raise
        latency = time.perf_counter() - t0
        audio_s = sum(len(r.wav) for r in results) / self.engine.sr
        self.metrics.observe(latency, audio_s)
        self._log.info(
            "speech voice=%s chars=%d chunks=%d audio=%.2fs latency=%.3fs",
            voice, len(input_text), len(reqs), audio_s, latency,
        )
        wav = (
            results[0].wav
            if len(results) == 1
            else np.concatenate([r.wav for r in results])
        )
        buf = io.BytesIO()
        write_wav(buf, wav, self.engine.sr)
        data = buf.getvalue()
        if response_format not in ("wav", "", None):
            data = _transcode(data, response_format)
        return data

    def speech_stream(
        self,
        input_text: str,
        voice: str,
        prompt: str = "",
        speed: float = 1.0,
    ):
        """Returns a generator of wav bytes: header first, then int16 PCM per
        sentence chunk as it finishes synthesis. Time-to-first-audio is one
        chunk, not the whole utterance (the reference has no streaming path).

        Validation (unknown voice, frontend errors) runs eagerly in this
        call — before any HTTP status is committed — so callers see the same
        400-able exceptions as the non-streaming path."""
        t0 = time.perf_counter()
        try:
            reqs = self._build_requests(input_text, voice, prompt, speed)
        except Exception:
            self.metrics.observe_error()
            raise

        def gen():
            yield wav_stream_header(self.engine.sr)
            audio_s = 0.0
            for req in reqs:
                try:
                    result = self._synthesize([req])[0]
                except Exception:
                    self.metrics.observe_error()
                    raise
                audio_s += len(result.wav) / self.engine.sr
                yield pcm16_bytes(result.wav)
            latency = time.perf_counter() - t0
            self.metrics.observe(latency, audio_s)
            self._log.info(
                "speech_stream voice=%s chars=%d chunks=%d audio=%.2fs "
                "latency=%.3fs", voice, len(input_text), len(reqs), audio_s,
                latency,
            )

        return gen()


class TranscodeUnavailable(RuntimeError):
    """Raised when a non-wav response_format has no available encoder;
    HTTP layers map it to a 400 so clients can retry with 'wav'."""


def _transcode(wav_bytes: bytes, fmt: str) -> bytes:
    """wav -> fmt via pydub when installed, else the ffmpeg binary.

    The reference transcodes every response with pydub/ffmpeg and defaults
    to mp3 (`openaiapi.py:152-182`); we keep that request schema but fail
    with a clean, actionable error in environments without an encoder.
    """
    try:  # pragma: no cover - optional dependency
        from pydub import AudioSegment

        seg = AudioSegment.from_wav(io.BytesIO(wav_bytes))
        out = io.BytesIO()
        seg.export(out, format=fmt)
        return out.getvalue()
    except ImportError:
        pass
    ffmpeg = shutil.which("ffmpeg")
    if ffmpeg:  # pragma: no cover - needs ffmpeg binary
        proc = subprocess.run(
            [ffmpeg, "-v", "error", "-i", "pipe:0", "-f", fmt, "pipe:1"],
            input=wav_bytes,
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
        )
        if proc.returncode == 0 and proc.stdout:
            return proc.stdout
        raise TranscodeUnavailable(
            f"ffmpeg failed for response_format={fmt!r}: "
            f"{proc.stderr.decode(errors='replace')[:200]}"
        )
    raise TranscodeUnavailable(
        f"response_format={fmt!r} needs pydub or an ffmpeg binary; "
        "retry with response_format='wav'"
    )


def create_fastapi_app(service: TTSService):  # pragma: no cover - needs fastapi
    from fastapi import FastAPI, HTTPException
    from fastapi.responses import Response
    from pydantic import BaseModel, Field

    class SpeechRequest(BaseModel):
        # Schema parity with the reference (openaiapi.py:152-162): the
        # OpenAI TTS default response_format is mp3.
        input: str
        voice: str = "8051"
        prompt: str = ""
        response_format: str = "mp3"
        speed: float = Field(1.0, ge=0.25, le=4.0)
        stream: bool = False

    app = FastAPI(title="emotivoice-torch")

    @app.get("/")
    def demo():
        return Response(
            content=render_demo_page(sorted(service.speaker2id)),
            media_type="text/html",
        )

    @app.get("/v1/voices")
    def voices():
        return {"voices": sorted(service.speaker2id)}

    @app.get("/v1/metrics")
    def metrics():
        return service.metrics.snapshot(service._batcher, service.engine)

    @app.post("/v1/audio/speech")
    def speech(req: SpeechRequest):
        try:
            if req.stream:
                from fastapi.responses import StreamingResponse

                return StreamingResponse(
                    service.speech_stream(
                        req.input, req.voice, req.prompt, req.speed
                    ),
                    media_type="audio/wav",
                )
            data = service.speech(
                req.input, req.voice, req.prompt, req.speed, req.response_format
            )
        except (KeyError, TranscodeUnavailable) as e:
            raise HTTPException(status_code=400, detail=str(e))
        media = "audio/wav" if req.response_format in ("wav", "") else (
            f"audio/{req.response_format}"
        )
        return Response(content=data, media_type=media)

    return app


def make_stdlib_server(service: TTSService, host: str = "0.0.0.0", port: int = 8000):
    """Dependency-free HTTP server exposing POST /v1/audio/speech, bound but
    not yet serving: call `serve_forever()` (a thread may) and later
    `shutdown()` + `server_close()`. Port 0 picks a free port; read it from
    `server.server_address`."""

    class Handler(BaseHTTPRequestHandler):
        # Chunked transfer-encoding (the streaming path) only exists in
        # HTTP/1.1; the BaseHTTPRequestHandler default is HTTP/1.0, under
        # which spec-compliant clients would read the hex chunk framing as
        # body bytes. Safe: every non-chunked reply sends Content-Length.
        protocol_version = "HTTP/1.1"

        def send_error(self, code, message=None, explain=None):
            # The message goes into the status line, which is latin-1 and one
            # line: an exception text with other characters (a voice name in
            # hanzi) must still come back as this status, not kill the handler.
            if message is not None:
                message = " ".join(message.split()).encode("latin-1", "replace").decode("latin-1")
            super().send_error(code, message, explain)

        def do_POST(self):
            if self.path.rstrip("/") != "/v1/audio/speech":
                self.send_error(404)
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(length) or b"{}")
                if body.get("stream"):
                    self._stream(body)
                    return
                data = service.speech(
                    body.get("input", ""),
                    str(body.get("voice", "8051")),
                    body.get("prompt", ""),
                    float(body.get("speed", 1.0)),
                    body.get("response_format", "mp3"),
                )
            except (KeyError, TranscodeUnavailable) as e:
                self.send_error(400, str(e))
                return
            except Exception as e:  # surface errors as 500 with message
                self.send_error(500, str(e))
                return
            fmt = body.get("response_format", "mp3") or "mp3"
            self.send_response(200)
            self.send_header("Content-Type", f"audio/{fmt}")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def _stream(self, body):
            """Chunked transfer: wav header + PCM per sentence chunk."""
            try:
                gen = service.speech_stream(
                    body.get("input", ""),
                    str(body.get("voice", "8051")),
                    body.get("prompt", ""),
                    float(body.get("speed", 1.0)),
                )
                first = next(gen)  # raises before headers on bad input
            except KeyError as e:
                self.send_error(400, str(e))
                return
            except Exception as e:
                self.send_error(500, str(e))
                return
            self.send_response(200)
            self.send_header("Content-Type", "audio/wav")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()

            def chunk(data: bytes):
                self.wfile.write(b"%x\r\n" % len(data) + data + b"\r\n")

            chunk(first)
            for data in gen:
                if data:
                    chunk(data)
            self.wfile.write(b"0\r\n\r\n")

        def do_GET(self):
            path = self.path.rstrip("/")
            if path == "/healthz":
                self._reply(b'{"status":"ok"}', "application/json")
            elif path == "" or path == "/":
                page = render_demo_page(sorted(service.speaker2id))
                self._reply(page.encode("utf-8"), "text/html; charset=utf-8")
            elif path == "/v1/voices":
                body = json.dumps(
                    {"voices": sorted(service.speaker2id)}
                ).encode()
                self._reply(body, "application/json")
            elif path == "/v1/metrics":
                body = json.dumps(
                    service.metrics.snapshot(service._batcher, service.engine)
                ).encode()
                self._reply(body, "application/json")
            else:
                self.send_error(404)

        def _reply(self, body: bytes, ctype: str):
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):
            pass

    class Server(ThreadingHTTPServer):
        # socketserver's backlog of 5 connections is less than one burst of a
        # batch: with the accept loop waiting its turn behind busy handler
        # threads, further connections were reset before they were accepted.
        request_queue_size = 128

    return Server((host, port), Handler)


def serve_stdlib(service: TTSService, host: str = "0.0.0.0", port: int = 8000):
    """`make_stdlib_server` + `serve_forever()`."""
    make_stdlib_server(service, host, port).serve_forever()
