"""Cross-request micro-batching for the synthesis engine (counterpart of
`emotivoice_tpu/serving/batcher.py`).

A worker thread drains a queue, groups requests that share a duration
scale ``alpha``, sends each group to the engine as one batch, and fans the
results back out through futures.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import List, Optional, Tuple

from emotivoice_tpu_torch.serving.engine import (
    SynthesisEngine,
    SynthesisRequest,
    SynthesisResult,
)


class MicroBatcher:
    """Aggregates concurrent ``submit`` calls into batched engine dispatches.

    - ``max_batch``: upper bound per dispatch (align with the engine's
      largest batch bucket).
    - ``max_wait_ms``: how long the first request in a batch waits for
      company.
    """

    def __init__(self, engine: SynthesisEngine, max_batch: int = 16,
                 max_wait_ms: float = 5.0):
        self.engine = engine
        self.max_batch = max_batch
        self.max_wait_ms = max_wait_ms
        self._queue: "queue.Queue[Optional[Tuple[SynthesisRequest, Future]]]" = queue.Queue()
        self.dispatches = 0  # batches sent to the engine
        self.requests = 0
        self._worker = threading.Thread(
            target=self._run, daemon=True, name="microbatcher-worker"
        )
        self._worker.start()

    def submit(self, request: SynthesisRequest) -> SynthesisResult:
        """Blocking: enqueue and wait for the batched result."""
        return self.submit_many([request])[0]

    def submit_many(self, requests: List[SynthesisRequest]) -> List[SynthesisResult]:
        futs = []
        for r in requests:
            f: Future = Future()
            self._queue.put((r, f))
            futs.append(f)
        return [f.result() for f in futs]

    def close(self, timeout: float = 30.0):
        self._queue.put(None)
        self._worker.join(timeout=timeout)
        if self._worker.is_alive():
            raise RuntimeError("microbatcher worker did not stop")

    def _drain(self) -> List[Tuple[SynthesisRequest, Future]]:
        """Block for one item, then gather compatible company."""
        first = self._queue.get()
        if first is None:
            return []
        batch = [first]
        deadline = time.monotonic() + self.max_wait_ms / 1000.0
        while len(batch) < self.max_batch:
            remaining = deadline - time.monotonic()
            try:
                item = (self._queue.get(timeout=remaining) if remaining > 0
                        else self._queue.get_nowait())
            except queue.Empty:
                break
            if item is None:
                self._queue.put(None)  # re-post the sentinel for the outer loop
                break
            if item[0].alpha != batch[0][0].alpha:
                self._queue.put(item)  # engine batches share one alpha
                break
            batch.append(item)
        return batch

    def _run(self):
        while True:
            batch = self._drain()
            if not batch:
                return
            reqs = [r for r, _ in batch]
            self.requests += len(reqs)
            self.dispatches += 1
            try:
                results = self.engine.synthesize_batch(reqs)
            except Exception as e:  # fan the failure out to every waiter
                for _, fut in batch:
                    fut.set_exception(e)
                continue
            for (_, fut), res in zip(batch, results):
                fut.set_result(res)
