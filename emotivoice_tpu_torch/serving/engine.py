"""Batched synthesis engine: phoneme ids -> waveform with static-shape
bucketing, on one device, on data-parallel replicas, on replicas that are
each split over a model group of devices, or on one replica split over the
ranks of a model group, one shard per process (counterpart of
`emotivoice_tpu/serving/engine.py` and its mesh's 'data' and 'model' axes).

Requests are padded into (batch, text, mel) buckets from fixed ladders,
and each replica runs one program per bucket (`serving/programs.py`), as
the JAX engine compiles one per bucket: on a card a CUDA graph, captured
at the bucket's second call (its first is the eager warm-up run) or by the
warmup, and replayed after; on the CPU the eager forward on the same static
buffers. A replica split over a model group stays eager:
its collectives and cross-device copies are not captured. Padding rows
carry one token and speaker 0. With several replicas a bucket is padded up
to a multiple of their count and split evenly over them, as the JAX engine
pads a batch to its mesh's data axis.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
import itertools
import logging
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from emotivoice_tpu_torch.config import EmotiVoiceConfig
from emotivoice_tpu_torch.frontend.tokens import TokenVocab
from emotivoice_tpu_torch.models.jets import JETSGenerator
from emotivoice_tpu_torch.ops.cuda.aa_snake import fused_aa_snake
from emotivoice_tpu_torch.parallel.mesh import make_mesh, split_rows
from emotivoice_tpu_torch.parallel.tensor_parallel import RankGroup, tensor_parallel
from emotivoice_tpu_torch.serving import tracing
from emotivoice_tpu_torch.serving.programs import (BucketProgram, HostStaging, ProgramCache,
                                                   to_host)
from emotivoice_tpu_torch.utils.device import resolve_device, resolve_dtype

DEFAULT_TEXT_BUCKETS = (16, 32, 48, 64, 96, 128, 192, 256)
DEFAULT_MEL_BUCKETS = (128, 192, 256, 384, 512, 768, 1024, 1536, 2048)
DEFAULT_BATCH_BUCKETS = (1, 2, 4, 8, 16, 32)

log = logging.getLogger("emotivoice_tpu_torch.serving")


def _bucket(x: int, ladder: Sequence[int]) -> int:
    for b in ladder:
        if x <= b:
            return b
    return ladder[-1]


@dataclasses.dataclass
class SynthesisRequest:
    phonemes: List[str]  # frontend output tokens
    speaker_id: int
    style_embedding: np.ndarray  # (bert_embedding,)
    content_embedding: np.ndarray  # (bert_embedding,)
    alpha: float = 1.0
    # Set by the program (`assign_request_id`) when the request reaches the
    # batcher's queue or the engine, whichever comes first; the spans of
    # one request share it.
    request_id: Optional[int] = None


_request_ids = itertools.count(1)


def assign_request_id(request: SynthesisRequest) -> None:
    if request.request_id is None:
        request.request_id = next(_request_ids)


@dataclasses.dataclass
class SynthesisResult:
    wav: np.ndarray  # float32, trimmed to n_frames * hop
    n_frames: int


class SynthesisEngine:
    """Runs a `JETSGenerator` over bucketed batches on one device, or on one
    replica per entry of `devices`.

    `device` defaults to 'cuda' and raises without a card; pass 'cpu' for
    the plain PyTorch path. `devices` (instead of `device`) holds a full
    replica of the model on each entry, which may repeat a device (two
    replicas on one card) and may be CPU devices; the replicas run their
    shares of each bucket at the same time, one thread each, and the rows
    are gathered back in order. With `model_parallel` N, `devices` is cut
    into `len(devices) // N` model groups of N (`parallel.mesh.make_mesh`)
    and each replica is split over its group (`parallel.tensor_parallel`:
    vocoder channels and attention heads; the MRF kernels run on whole
    weights gathered to the group's first device); its rows enter and its
    waveform leaves there. With `model_group` (a `parallel.tensor_parallel.
    RankGroup`, instead of `device` / `devices`) the one replica is split
    over the ranks of the group, this process holding its shard on the
    group's device: every rank of the group makes the same calls with the
    same requests, as JAX's multi-controller runtime runs one program on
    every process, and each returns the same result. The ranks take the
    group's first rank's frame counts, so they choose the same mel buckets
    and redispatches even where their predicted durations would differ
    (one rank alone in a collective would wait there until the timeout).
    `dtype` is the compute dtype ('f32' / 'bf16' or a torch dtype);
    parameters stay f32 and the waveform comes back f32.

    Each replica on one device keeps its bucket programs in a
    `programs.ProgramCache` (`programs[i]`, at most 128): on a card one
    CUDA graph per (rows, t_text, max_frames) in one graph pool per
    replica. A key's first call is the eager warm-up run, its second
    captures the graph and replays it; the warmup methods, and any call
    inside `capturing()`, capture right after the warm-up run. A replica
    over a model group runs eagerly (`programs` is None).

    `run` is serialized: it holds one lock for the whole model call, so
    callers on several threads (the batcher's worker, the warmup daemon,
    a service with batching off) may rely on at most one bucket being in
    progress on this engine at any time. The graphs of a replica rely on
    it: they share one pool, so a graph's outputs are copied to the host
    before another may replay, and so does each replica's host staging
    buffer (`programs.HostStaging`), which the next call overwrites: what
    `run` returns never aliases it.
    """

    def __init__(
        self,
        cfg: EmotiVoiceConfig,
        model: JETSGenerator,
        vocab: TokenVocab,
        text_buckets: Sequence[int] = DEFAULT_TEXT_BUCKETS,
        mel_buckets: Sequence[int] = DEFAULT_MEL_BUCKETS,
        batch_buckets: Sequence[int] = DEFAULT_BATCH_BUCKETS,
        frames_per_token: float = 8.0,
        dtype: Union[str, torch.dtype] = torch.float32,
        device: Optional[Union[str, torch.device]] = None,
        devices: Optional[Sequence[Union[str, torch.device]]] = None,
        model_parallel: int = 1,
        model_group: Optional[RankGroup] = None,
    ):
        if devices is not None and device is not None:
            raise ValueError("pass device (one replica) or devices (one replica each), not both")
        if devices is not None and not devices:
            raise ValueError("devices must name at least one device")
        if model_group is not None and (devices is not None or device is not None
                                        or model_parallel != 1):
            raise ValueError("model_group places the replica itself: pass no device, "
                             "devices or model_parallel with it")
        self.model_group = model_group
        if model_group is not None:
            self.devices = [model_group.home]
            self.groups = [self.devices]
        else:
            self.devices = [resolve_device(d) for d in (devices or [device])]
            self.groups = make_mesh(self.devices, model_parallel)
        self.device = self.devices[0]
        self.dtype = resolve_dtype(dtype)
        self.cfg = cfg
        copies = [copy.deepcopy(model) for _ in self.groups[1:]]
        self.replicas = [tensor_parallel(m, g).eval() for m, g in
                         zip([model] + copies, [model_group] if model_group else self.groups)]
        self.model = self.replicas[0]
        # By construction, not by catching an error: a replica over a model
        # group runs collectives and cross-device copies, which stay eager.
        self.programs: Optional[List[ProgramCache]] = None
        if model_group is None and model_parallel == 1:
            self.programs = []
            for replica, (dev,) in zip(self.replicas, self.groups):
                pool = torch.cuda.graph_pool_handle() if dev.type == "cuda" else None
                self.programs.append(ProgramCache(functools.partial(
                    BucketProgram, replica, device=dev, dtype=self.dtype, pool=pool), pool))
        # Each replica's copy of its waveforms to the host: its programs',
        # which `_run_eager` shares.
        self.staging = ([c.staging for c in self.programs] if self.programs is not None
                        else [HostStaging() for _ in self.replicas])
        self.vocab = vocab
        self.text_buckets = tuple(text_buckets)
        self.mel_buckets = tuple(mel_buckets)
        self.batch_buckets = tuple(batch_buckets)
        self.frames_per_token = frames_per_token
        self.up = cfg.vocoder.upsample_factor
        self.sr = cfg.audio.sampling_rate
        # Duration-overflow accounting (see synthesize_batch): redispatches
        # escalate to the next mel bucket; truncations mean the largest
        # bucket still saturated and the audio really was cut.
        self.saturation_redispatches = 0
        self.saturation_truncations = 0
        # Traffic-priority handshake for warmup_background: a grid shape must
        # never queue in front of a live request, so the daemon defers while
        # requests are in flight or arrived very recently.
        self._traffic_lock = threading.Lock()
        self._inflight = 0
        self._last_traffic = 0.0
        # Shapes of the background grid that raised. The daemon survives
        # them, but they are counted and logged, never dropped silently.
        self.warmup_failures = 0
        self._capturing = threading.local()  # .on: see capturing()
        # One bucket at a time (see the class docstring): the batcher's
        # worker and the warmup daemon may both be here, and the allocator's
        # peak is only exact when calls do not interleave. The replicas of
        # one bucket run together; the kernels count their launches under
        # a lock.
        self._run_lock = threading.Lock()
        # One thread per replica for the engine's life: PyTorch keeps its
        # cuBLAS and cuDNN handles per thread, so fresh threads per call
        # would pay their set-up on every bucket.
        self._pool = (ThreadPoolExecutor(len(self.replicas), thread_name_prefix="engine-replica")
                      if len(self.replicas) > 1 else None)

    def program_counts(self) -> Optional[Dict[str, int]]:
        """Builds, rebuilds and CUDA graph captures of the bucket programs
        over the replicas, the waveform bytes their calls copied to the host
        and those of the whole padded waveforms (`copy_bytes`,
        `bucket_bytes`: 0 on the CPU, where nothing crosses), and the
        process's count of anti-aliased SnakeBeta launches
        (`fused_aa_snake.launches`: 109 a BigVGAN-v2 generator call, eager
        or replayed); None where the engine runs none."""
        if self.programs is None:
            return None
        out = {name: sum(getattr(c, name) for c in self.programs)
               for name in ("builds", "rebuilds", "captures", "copy_bytes", "bucket_bytes")}
        out["fused_aa_snake_launches"] = fused_aa_snake.launches
        return out

    def padded_rows(self, b: int) -> int:
        """Rows of the bucket `b` requests are padded to: the batch bucket,
        rounded up to a multiple of the replica count."""
        bb = _bucket(b, self.batch_buckets)
        n = len(self.replicas)
        return -(-bb // n) * n

    @contextlib.contextmanager
    def capturing(self):
        """Within it, this thread's calls capture the bucket programs they
        build right after the warm-up run, instead of at their second call:
        for a caller that warms a bucket ahead of the calls it serves or
        times (the warmup methods, a sweep's untimed dispatch)."""
        outer = getattr(self._capturing, "on", False)
        self._capturing.on = True
        try:
            yield
        finally:
            self._capturing.on = outer

    def _run_replica(self, i: int, arrays, max_frames: int, alpha: float, capture: bool):
        """Replica i on its rows: its program for the bucket, or the eager
        forward over a model group. Called under `_run_lock`, which the
        programs of a replica need (see the class docstring)."""
        if self.programs is not None:
            key = (*np.shape(arrays[0]), max_frames)
            return self.programs[i].get(key).run(arrays, alpha, capture)
        return self._run_eager(i, arrays, max_frames, alpha)

    def _run_eager(self, i: int, arrays, max_frames: int, alpha: float):
        """Replica i's forward, launched op by op (inference mode is per
        thread), copied to the host as a program's (`programs.to_host`)."""
        dev = self.groups[i][0]
        tokens, lengths, speaker, style, content = arrays
        with torch.inference_mode():
            out = self.replicas[i](
                torch.as_tensor(tokens, dtype=torch.long, device=dev),
                torch.as_tensor(lengths, dtype=torch.long, device=dev),
                torch.as_tensor(speaker, dtype=torch.long, device=dev),
                torch.as_tensor(style, dtype=torch.float32, device=dev),
                torch.as_tensor(content, dtype=torch.float32, device=dev),
                max_frames=max_frames, alpha=float(alpha), dtype=self.dtype,
            )
            n_frames = out["output_lengths"]
            if self.model_group is not None:
                n_frames = self.model_group.broadcast(n_frames.contiguous())
            wav, n_frames, _ = to_host(out["wav_predictions"], n_frames, max_frames,
                                       self.staging[i])
            return wav, n_frames

    def run(self, tokens, lengths, speaker, style, content, max_frames: int,
            alpha: float) -> Tuple[np.ndarray, np.ndarray]:
        """One padded bucket through the model: numpy in, (wav (B, max_frames
        * hop) f32, n_frames (B,)) numpy out, arrays the caller owns; on a
        card each row holds its first n_frames * hop samples and zeros after.
        With n replicas, B must be a multiple of n: replica i takes rows
        [i B/n, (i+1) B/n)."""
        arrays = (tokens, lengths, speaker, style, content)
        n = len(self.replicas)
        capture = getattr(self._capturing, "on", False)
        with self._run_lock:
            if n == 1:
                return self._run_replica(0, arrays, max_frames, alpha, capture)
            replica = tracing.carried(self._run_replica)  # spans there nest under this call
            futures = [self._pool.submit(replica, i, tuple(a[rows] for a in arrays),
                                         max_frames, alpha, capture)
                       for i, rows in enumerate(split_rows(len(tokens), n))]
            parts = [f.result() for f in futures]
            return (np.concatenate([w for w, _ in parts]),
                    np.concatenate([f for _, f in parts]))

    def synthesize_batch(self, requests: List[SynthesisRequest]) -> List[SynthesisResult]:
        if not requests:
            return []
        for r in requests:
            assign_request_id(r)
        span = tracing.begin("engine.call")
        results: List[SynthesisResult] = []
        with self._traffic_lock:
            self._inflight += 1
        try:
            results = self._synthesize_batch(requests)
            return results
        finally:
            with self._traffic_lock:
                self._inflight -= 1
                self._last_traffic = time.monotonic()
            if span is not None:
                tracing.end(span, requests=[r.request_id for r in requests],
                            frames=sum(r.n_frames for r in results))

    def _synthesize_batch(self, requests: List[SynthesisRequest]) -> List[SynthesisResult]:
        cap = self.batch_buckets[-1]
        if len(requests) > cap:  # larger than the biggest bucket: several dispatches
            out: List[SynthesisResult] = []
            for i in range(0, len(requests), cap):
                out.extend(self.synthesize_batch(requests[i:i + cap]))
            return out
        alpha = requests[0].alpha
        # alpha is one scalar per dispatch; a mixed batch would speed-shift
        # rows 1..n. MicroBatcher groups by alpha; direct callers must too.
        if any(r.alpha != alpha for r in requests[1:]):
            raise ValueError(
                "synthesize_batch requires a uniform alpha per batch; "
                "group requests by alpha (as serving.batcher.MicroBatcher "
                "does) or call synthesize() per request"
            )
        span = tracing.begin("engine.prepare")
        token_ids = [self.vocab.encode(r.phonemes) for r in requests]
        t_text = _bucket(max(len(t) for t in token_ids), self.text_buckets)
        est_frames = int(t_text * self.frames_per_token * max(alpha, 1.0))
        max_frames = _bucket(est_frames, self.mel_buckets)
        tracing.end(span)

        results = self._dispatch(requests, token_ids, t_text, max_frames, alpha)

        # The upsampler clamps mel lengths to the bucket, so n_frames ==
        # max_frames means the row may have been cut: redispatch those rows
        # at the next bucket until they fit or the ladder tops out.
        sat = [i for i, r in enumerate(results) if r.n_frames >= max_frames]
        while sat and max_frames < self.mel_buckets[-1]:
            max_frames = _bucket(max_frames + 1, self.mel_buckets)
            self.saturation_redispatches += 1
            redo = self._dispatch(
                [requests[i] for i in sat], [token_ids[i] for i in sat],
                t_text, max_frames, alpha,
            )
            for i, r in zip(sat, redo):
                results[i] = r
            sat = [i for i in sat if results[i].n_frames >= max_frames]
        if sat:
            self.saturation_truncations += len(sat)
            log.warning(
                "%d request(s) saturated the largest mel bucket (%d frames);"
                " audio may be truncated", len(sat), self.mel_buckets[-1],
            )
        return results

    def _dispatch(self, requests, token_ids, t_text: int, max_frames: int,
                  alpha: float) -> List[SynthesisResult]:
        span = tracing.begin("engine.prepare")
        b = len(requests)
        bb = self.padded_rows(b)
        d = self.cfg.am.bert_embedding
        tokens = np.zeros((bb, t_text), np.int64)
        lengths = np.ones((bb,), np.int64)  # pad rows: 1 token, speaker 0
        speaker = np.zeros((bb,), np.int64)
        style = np.zeros((bb, d), np.float32)
        content = np.zeros((bb, d), np.float32)
        for i, (r, ids) in enumerate(zip(requests, token_ids)):
            n = min(len(ids), t_text)
            tokens[i, :n] = ids[:n]
            lengths[i] = n
            speaker[i] = r.speaker_id
            style[i] = r.style_embedding
            content[i] = r.content_embedding
        tracing.end(span)
        wav, n_frames = self.run(tokens, lengths, speaker, style, content,
                                 max_frames, alpha)
        span = tracing.begin("engine.results")
        results = [
            SynthesisResult(wav=wav[i, : int(n_frames[i]) * self.up],
                            n_frames=int(n_frames[i]))
            for i in range(b)
        ]
        tracing.end(span)
        return results

    def synthesize(self, request: SynthesisRequest) -> SynthesisResult:
        return self.synthesize_batch([request])[0]

    def _run_dummy(self, rows: int, t_text: int, max_frames: int):
        n = len(self.replicas)
        rows = -(-rows // n) * n
        d = self.cfg.am.bert_embedding
        with self.capturing():
            self.run(
            np.zeros((rows, t_text), np.int64), np.ones((rows,), np.int64),
                np.zeros((rows,), np.int64), np.zeros((rows, d), np.float32),
                np.zeros((rows, d), np.float32), max_frames, 1.0,
            )

    def _warm_one(self, b: int, t_text: int, max_frames: int):
        """Run one (batch, text, mel) bucket on dummy inputs, which builds its
        program on every replica."""
        self._run_dummy(self.padded_rows(b), t_text, max_frames)

    def warmup_grid(self, batches: Sequence[int] = (1, 2, 4, 8, 16)) -> List[Tuple[int, int, int]]:
        """The (batch, text, mel) shapes `warmup_background` walks: for every
        batch x text bucket, the mel bucket `synthesize_batch` would pick at
        alpha <= 1 plus the next one up (the duration-overflow redispatch
        target)."""
        work: List[Tuple[int, int, int]] = []
        seen = set()
        for b in batches:
            for t in self.text_buckets:
                m = _bucket(int(t * self.frames_per_token), self.mel_buckets)
                m_next = _bucket(m + 1, self.mel_buckets)
                for mf in (m, m_next):
                    key = (self.padded_rows(b), t, mf)
                    if key not in seen:
                        seen.add(key)
                        work.append(key)
        return work

    def warmup_background(
        self,
        batches: Sequence[int] = (1, 2, 4, 8, 16),
        progress_cb: Optional[Callable[[int, int], None]] = None,
    ) -> threading.Thread:
        """Warm the production bucket grid on a daemon thread.

        `warmup()` covers only a handful of shapes. Warming a shape builds
        its bucket program on every replica (on a card a warm-up run, where
        cuDNN chooses its algorithms and the allocator grows, then the CUDA
        graph's capture); this walks
        `warmup_grid(batches)` in the background while the server is already
        answering, yielding to live traffic before every shape. A shape that
        raises does not end the thread: it adds one to `warmup_failures` and
        is logged with its traceback."""
        work = self.warmup_grid(batches)

        def run():
            for i, (b, t, mf) in enumerate(work):
                self._wait_for_traffic_idle()
                try:
                    self._warm_one(b, t, mf)
                except Exception:
                    self.warmup_failures += 1
                    log.exception("background warmup of (batch %d, text %d, mel %d) failed",
                                  b, t, mf)
                if progress_cb is not None:
                    progress_cb(i + 1, len(work))

        th = threading.Thread(target=run, daemon=True, name="engine-warmup")
        th.start()
        return th

    def _wait_for_traffic_idle(self, idle_s: float = 0.25):
        """Block until no request is in flight and none finished within the
        last `idle_s` seconds: live traffic always outranks a warmup shape."""
        while True:
            with self._traffic_lock:
                busy = self._inflight > 0
                quiet = time.monotonic() - self._last_traffic
            if not busy and quiet >= idle_s:
                return
            time.sleep(0.05)

    def warmup(self, shapes: Optional[List[Tuple[int, int, int]]] = None):
        """Run common (batch, text, mel) buckets once on dummy inputs, so the
        kernel build and the bucket programs' builds are not paid by a user
        request.

        A shape that traffic would pick goes through `synthesize_batch`, so
        warmup touches the same batch-bucket padding as production; a
        non-default mel bucket is run directly."""
        # Includes the production micro-batched bucket (batch 16, the
        # batcher's max_batch).
        shapes = shapes or [(1, 32, 256), (1, 64, 512), (4, 64, 512), (16, 96, 768)]
        d = self.cfg.am.bert_embedding
        for b, t_text, max_frames in shapes:
            t_bucket = _bucket(t_text, self.text_buckets)
            est = int(t_bucket * self.frames_per_token)
            if _bucket(est, self.mel_buckets) != max_frames:
                self._run_dummy(b, t_text, max_frames)
            else:
                req = SynthesisRequest(
                    phonemes=self.vocab.decode([0]) * t_text,  # pad tokens
                    speaker_id=0,
                    style_embedding=np.zeros(d, np.float32),
                    content_embedding=np.zeros(d, np.float32),
                )
                with self.capturing():
                    self.synthesize_batch([req] * b)
