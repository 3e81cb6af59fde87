"""aa_snake_share.bulk: % of the traced calls' vocoder device ms (their `program.run` spans) that the anti-aliased SnakeBeta kernel took (trace.kernel_seconds)."""

from port_bench import trace
from port_bench.program_spans import VOCODER, calls
from port_bench.spec import launches


def read(view):
    cs = calls(view)
    if view.trace is None or not cs:
        return None
    ms = sum(r.attrs[p] for c in cs.values() for r in c["below"]
             if r.name == "program.run" for p in VOCODER if p in r.attrs)
    seconds = trace.kernel_seconds(view.trace, launches(view.cfg).KERNELS["aa_snake"])
    if ms <= 0 or seconds <= 0:
        return None
    return 100.0 * seconds * 1e3 / ms
