"""Decides `correct`: a sample of the window's finished requests, drawn from
the seed with the longest among them, each run again through the plain
reference that the configuration names (`reference/<file>`, float32, TF32
off) from the same inputs and weights, and compared with what the timed path
returned.

Numbers compared, each the worst over the sample:
  failed           requests due in the window that raised or never came
  bucket_mismatch  requests served in another (text, mel) bucket than the
                   frozen bucket rule gives for their batch
  dur_mismatch     requests whose durations are not their own log durations
                   rounded (clamp(round(exp(x) - 1), 0)), or whose frame
                   count is not the reference's from those durations
  logd_err         largest |log duration - reference's| over the tokens
  mel_err          ||mel - reference's|| / ||reference's|| over the frames
  wav_err          ||wav - reference's|| / ||reference's|| over the samples

The reference computes the log durations from scratch, and then follows the
program's durations through upsampling, decoder and vocoder: a duration is
a rounding of the log duration, so a log duration within rounding of a
half frame may round either way in another precision and shift the rest of
the waveform. The rounding is checked on its own (`dur_mismatch`).

The control (`control`) puts the reference at the configuration's next
lower precision in the program's place, over the same sample, and is
judged by the same numbers; it has to come out not correct.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from port_bench.probe import Kept
from port_bench.reference import buckets
from port_bench.spec import reference

ORDER = ("failed", "bucket_mismatch", "dur_mismatch", "logd_err", "mel_err", "wav_err")


def rel_rms(got: np.ndarray, want: np.ndarray) -> float:
    den = float(np.sqrt(np.sum(np.square(want, dtype=np.float64))))
    num = float(np.sqrt(np.sum(np.square(got.astype(np.float64) - want))))
    return num / den if den > 0 else (0.0 if num == 0 else float("inf"))


def sample(candidates: List[int], n_tokens: Dict[int, int], size: int, seed: int) -> List[int]:
    """Up to `size` of the candidates: the longest, and the rest drawn from
    the seed."""
    if not candidates:
        return []
    longest = max(candidates, key=lambda r: (n_tokens[r], -r))
    rest = [r for r in candidates if r != longest]
    rng = np.random.default_rng([int(seed), 2])
    pick = rng.choice(len(rest), size=min(size - 1, len(rest)), replace=False) if rest else []
    return [longest] + sorted(rest[i] for i in pick)


@dataclasses.dataclass
class Served:
    """One sampled request: its inputs, and what the program returned."""

    rid: int
    tokens: np.ndarray
    speaker: int
    style: np.ndarray
    content: np.ndarray
    alpha: float
    group_longest: int  # tokens of the longest request of its batch
    n_frames: int
    wav: np.ndarray
    kept: Kept


def _inputs(s: Served, t_text: int, device):
    tok = np.zeros((1, t_text), np.int64)
    tok[0, : len(s.tokens)] = s.tokens
    t = lambda a, dt: torch.as_tensor(np.asarray(a), dtype=dt, device=device)
    return (t(tok, torch.long), t([len(s.tokens)], torch.long), t([s.speaker], torch.long),
            t(s.style[None], torch.float32), t(s.content[None], torch.float32))


def _bucket(group_longest: int, total: int, alpha: float):
    """The frozen rule: the batch's first bucket, then the next mel bucket
    up while the row's frames reach it."""
    t_text, m = buckets.first_bucket(group_longest, alpha)
    while total >= m and m < buckets.MEL[-1]:
        m = buckets.next_mel(m)
    return t_text, m


def compare(s: Served, sd, cfg, device, log_d, durations, mel, wav, n_frames,
            t_text: int, max_frames: int) -> Dict[str, float]:
    """The numbers of one request: what a side (the program, or the
    control) gave, against the f32 reference that follows its durations."""
    n = len(s.tokens)
    ref_model = reference(cfg)
    hop = int(np.prod(cfg["vocoder"]["upsample_rates"]))
    total = int(np.sum(durations[:n], dtype=np.float32) * np.float32(s.alpha))
    want_bucket = _bucket(s.group_longest, total, s.alpha)
    forced = np.zeros((1, want_bucket[0]), np.float32)
    forced[0, :n] = durations[:n]
    ref = ref_model.synthesize(sd, cfg, *_inputs(s, want_bucket[0], device), want_bucket[1],
                               s.alpha, durations=torch.as_tensor(forced, device=device))
    rounded = ref_model.to_durations(torch.as_tensor(log_d[:n])).numpy()
    ref_frames = int(ref["n_frames"][0])
    dur_bad = (not np.array_equal(rounded, durations[:n]) or np.any(durations[n:] != 0)
               or ref_frames != n_frames)
    nf = min(n_frames, ref_frames)
    return {
        "bucket_mismatch": float((t_text, max_frames) != want_bucket),
        "dur_mismatch": float(dur_bad),
        "logd_err": float(np.max(np.abs(log_d[:n] - ref["log_d"][0, :n].cpu().numpy()))),
        "mel_err": rel_rms(mel[:nf], ref["mel"][0, :nf].cpu().numpy()),
        "wav_err": rel_rms(wav[: nf * hop], ref["wav"][0, : nf * hop].cpu().numpy()),
    }


def program_numbers(s: Served, sd, cfg, device) -> Dict[str, float]:
    k = s.kept
    return compare(s, sd, cfg, device, k.log_d, k.durations, k.mel, s.wav, s.n_frames,
                   k.t_text, k.max_frames)


def control_numbers(s: Served, sd, cfg, device, precision: str) -> Dict[str, float]:
    """The reference at `precision` in the program's place: its own
    durations, bucket, mel and waveform."""
    t_text, m = buckets.first_bucket(s.group_longest, s.alpha)
    while True:
        low = reference(cfg).synthesize(sd, cfg, *_inputs(s, t_text, device), m, s.alpha,
                                        precision=precision)
        if int(low["n_frames"][0]) < m or m >= buckets.MEL[-1]:
            break
        m = buckets.next_mel(m)
    nf = int(low["n_frames"][0])
    hop = int(np.prod(cfg["vocoder"]["upsample_rates"]))
    return compare(s, sd, cfg, device, low["log_d"][0].cpu().numpy(),
                   low["durations"][0].cpu().numpy(), low["mel"][0].cpu().numpy(),
                   low["wav"][0, : nf * hop].cpu().numpy(), nf, t_text, m)


def worst(rows: List[Dict[str, float]], failed: int) -> Dict[str, float]:
    out = {"failed": float(failed)}
    for key in ORDER[1:]:
        out[key] = max((r[key] for r in rows), default=0.0)
    return out


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    return all(numbers[k] <= limits[k] for k in ORDER)


def lines(numbers: Dict[str, float], limits: Dict[str, float], prefix: str = "") -> List[str]:
    return [f"{prefix}{k} {numbers[k]!r} limit {limits[k]!r}" for k in ORDER]


def empty(limits: Dict) -> Optional[str]:
    missing = [k for k in ORDER if k not in limits]
    return f"limits file lacks {missing}" if missing else None
