"""host_ms_per_call.bulk: median host ms of an engine call's encoding, padding and result slicing (program_spans.host_ms_per_call)."""

from port_bench.program_spans import host_ms_per_call


def read(view):
    return host_ms_per_call(view, fan_out=False)
