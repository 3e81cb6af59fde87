"""Batched synthesis engine: phoneme ids -> waveform with static-shape
bucketing, on one device (counterpart of `emotivoice_tpu/serving/engine.py`).

Requests are padded into (batch, text, mel) buckets from fixed ladders, so
a later slice can capture one program per bucket. Padding rows carry one
token and speaker 0. The mesh / tensor-parallel branch and background
warmup are later slices.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from emotivoice_tpu_torch.config import EmotiVoiceConfig
from emotivoice_tpu_torch.frontend.tokens import TokenVocab
from emotivoice_tpu_torch.models.jets import JETSGenerator
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


@dataclasses.dataclass
class SynthesisResult:
    wav: np.ndarray  # float32, trimmed to n_frames * hop
    n_frames: int


class SynthesisEngine:
    """Runs a `JETSGenerator` over bucketed batches on one device.

    `device` defaults to 'cuda' and raises without a card; pass 'cpu' for
    the plain PyTorch path. `dtype` is the compute dtype ('f32' / 'bf16' or
    a torch dtype); parameters stay f32 and the waveform comes back f32.
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
    ):
        self.device = resolve_device(device)
        self.dtype = resolve_dtype(dtype)
        self.cfg = cfg
        self.model = model.to(self.device).eval()
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

    def run(self, tokens, lengths, speaker, style, content, max_frames: int,
            alpha: float) -> Tuple[np.ndarray, np.ndarray]:
        """One padded bucket through the model: numpy in, (wav (B, max_frames
        * hop) f32, n_frames (B,)) numpy out."""
        dev = self.device
        with torch.inference_mode():
            out = self.model(
                torch.as_tensor(tokens, dtype=torch.long, device=dev),
                torch.as_tensor(lengths, dtype=torch.long, device=dev),
                torch.as_tensor(speaker, dtype=torch.long, device=dev),
                torch.as_tensor(style, dtype=torch.float32, device=dev),
                torch.as_tensor(content, dtype=torch.float32, device=dev),
                max_frames=max_frames, alpha=float(alpha), dtype=self.dtype,
            )
            return (out["wav_predictions"].cpu().numpy(),
                    out["output_lengths"].cpu().numpy())

    def synthesize_batch(self, requests: List[SynthesisRequest]) -> List[SynthesisResult]:
        if not requests:
            return []
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
        token_ids = [self.vocab.encode(r.phonemes) for r in requests]
        t_text = _bucket(max(len(t) for t in token_ids), self.text_buckets)
        est_frames = int(t_text * self.frames_per_token * max(alpha, 1.0))
        max_frames = _bucket(est_frames, self.mel_buckets)

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
        b = len(requests)
        bb = _bucket(b, self.batch_buckets)
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
        wav, n_frames = self.run(tokens, lengths, speaker, style, content,
                                 max_frames, alpha)
        return [
            SynthesisResult(wav=wav[i, : int(n_frames[i]) * self.up],
                            n_frames=int(n_frames[i]))
            for i in range(b)
        ]

    def synthesize(self, request: SynthesisRequest) -> SynthesisResult:
        return self.synthesize_batch([request])[0]

    def warmup(self, shapes: Optional[List[Tuple[int, int, int]]] = None):
        """Run common (batch, text, mel) buckets once on dummy inputs, so the
        kernel build and first-call costs are not paid by a user request."""
        shapes = shapes or [(1, 32, 256), (1, 64, 512), (4, 64, 512), (16, 96, 768)]
        d = self.cfg.am.bert_embedding
        for b, t_text, max_frames in shapes:
            self.run(
                np.zeros((b, t_text), np.int64), np.ones((b,), np.int64),
                np.zeros((b,), np.int64), np.zeros((b, d), np.float32),
                np.zeros((b, d), np.float32), max_frames, 1.0,
            )
