"""Serving metrics: request counts, latency percentiles, audio served (the
port's own copy of `emotivoice_tpu/serving/metrics.py`; same snapshot keys).

The reference's serving layer has no observability at all (SURVEY.md §5: a
`logging.getLogger` that is never used, no structured metrics, no request
logging). Here every request is timed and aggregated in-process;
`GET /v1/metrics` returns the snapshot as JSON, covering the BASELINE.md
"RTF p50 tracked per config" requirement.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional


class ServiceMetrics:
    """Thread-safe rolling metrics over the last ``window`` requests."""

    def __init__(self, window: int = 1024):
        self.window = window
        self._lock = threading.Lock()
        self._lat_s: List[float] = []  # wall latency per request
        self._rtf: List[float] = []  # latency / audio-duration (lower=faster)
        self._count = 0
        self._errors = 0
        self._audio_seconds = 0.0
        self._started = time.time()

    def observe(self, latency_s: float, audio_seconds: float):
        with self._lock:
            self._count += 1
            self._audio_seconds += audio_seconds
            self._lat_s.append(latency_s)
            if audio_seconds > 0:
                self._rtf.append(latency_s / audio_seconds)
            if len(self._lat_s) > self.window:
                del self._lat_s[: -self.window]
            if len(self._rtf) > self.window:
                del self._rtf[: -self.window]

    def observe_error(self):
        with self._lock:
            self._errors += 1

    @staticmethod
    def _pct(values: List[float], q: float) -> Optional[float]:
        if not values:
            return None
        s = sorted(values)
        i = min(len(s) - 1, int(q * (len(s) - 1) + 0.5))
        return s[i]

    def snapshot(self, batcher=None, engine=None) -> Dict:
        with self._lock:
            lat, rtf = list(self._lat_s), list(self._rtf)
            out = {
                "requests": self._count,
                "errors": self._errors,
                "audio_seconds_served": round(self._audio_seconds, 2),
                "uptime_s": round(time.time() - self._started, 1),
                "latency_s": {
                    "p50": self._pct(lat, 0.50),
                    "p95": self._pct(lat, 0.95),
                    "p99": self._pct(lat, 0.99),
                },
                # RTF = synthesis latency / audio duration (p50 < 1 means
                # faster than real time end-to-end including the frontend)
                "rtf": {
                    "p50": self._pct(rtf, 0.50),
                    "p95": self._pct(rtf, 0.95),
                },
            }
        if batcher is not None:
            out["batching"] = {
                "dispatches": batcher.dispatches,
                "batched_requests": batcher.requests,
                "mean_batch": (
                    round(batcher.requests / batcher.dispatches, 2)
                    if batcher.dispatches
                    else None
                ),
            }
        if engine is not None:
            # Duration-overflow accounting (engine.synthesize_batch):
            # redispatches = rows escalated to a larger mel bucket;
            # truncations = rows that saturated the largest bucket (audio cut).
            out["duration_overflow"] = {
                "redispatches": engine.saturation_redispatches,
                "truncations": engine.saturation_truncations,
            }
        return out
