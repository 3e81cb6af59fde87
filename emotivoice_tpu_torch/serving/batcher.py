"""Cross-request micro-batching for the synthesis engine (counterpart of
`emotivoice_tpu/serving/batcher.py`).

A worker thread drains a queue, groups requests that share a duration
scale ``alpha``, sends each group to the engine as one batch, and fans the
results back out through futures. The queue stamps each request's arrival,
from which the spans `batcher.wait` are recorded while a profiler runs
(`serving/tracing.py`).
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import List, Optional, Tuple

from emotivoice_tpu_torch.serving import tracing
from emotivoice_tpu_torch.serving.engine import (
    SynthesisEngine,
    SynthesisRequest,
    SynthesisResult,
    assign_request_id,
)

Item = Tuple[SynthesisRequest, Future, int]  # (request, future, arrival_ns)


class ArrivalQueue(queue.Queue):
    """The batcher's queue. A `(request, future)` put on it is stamped with
    its arrival (`time.perf_counter_ns()`) and its request given an id, and
    comes out as `(request, future, arrival_ns)`; an item put back in that
    form (a request of another alpha) keeps its stamp, and so does the
    sentinel None."""

    def _put(self, item):
        if item is not None and len(item) == 2:
            assign_request_id(item[0])
            item = (item[0], item[1], time.perf_counter_ns())
        super()._put(item)


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
        self._queue = ArrivalQueue()
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

    def _drain(self) -> Tuple[List[Item], List[int]]:
        """Block for one item, then gather compatible company. Returns the
        batch and when each of its items was taken off the queue."""
        first = self._queue.get()
        if first is None:
            return [], []
        batch, taken = [first], [time.perf_counter_ns()]
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
            taken.append(time.perf_counter_ns())
        return batch, taken

    def _run(self):
        while True:
            batch, taken = self._drain()
            if not batch:
                return
            reqs = [r for r, _, _ in batch]
            self.requests += len(reqs)
            self.dispatches += 1
            handed = time.perf_counter_ns() if tracing.recording() else None
            try:
                results = self.engine.synthesize_batch(reqs)
            except Exception as e:  # fan the failure out to every waiter
                self._record_waits(batch, taken, handed)
                for _, fut, _ in batch:
                    fut.set_exception(e)
                continue
            call = self._record_waits(batch, taken, handed)
            span = tracing.begin("batcher.fan_out", call=call)
            for (_, fut, _), res in zip(batch, results):
                fut.set_result(res)
            tracing.end(span)

    @staticmethod
    def _record_waits(batch: List[Item], taken: List[int], handed: Optional[int]) -> Optional[int]:
        """The span `batcher.wait` of each request of a batch handed to the
        engine at `handed` (None: nothing records); returns the id of the
        engine call it went into."""
        if handed is None:
            return None
        call = tracing.last_id("engine.call")
        for (req, _, arrived), t in zip(batch, taken):
            tracing.add("batcher.wait", arrived, handed, request=req.request_id, taken_ns=t,
                        call=call)
        return call
