"""queue_wait_ms.interactive: median ms from a request's arrival on the batcher's queue to its batch's hand-off to the engine (program_spans.queue_wait_ms)."""

from port_bench.program_spans import queue_wait_ms as read  # noqa: F401
