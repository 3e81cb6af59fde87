"""copy_out_ms.bulk: median device ms of a bucket program's copy of the waveform to the host (program_spans.copy_out_ms)."""

from port_bench.program_spans import copy_out_ms as read  # noqa: F401
