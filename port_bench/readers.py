"""What the per-layer metrics' readers (`metrics/<name>.py`) share. Each
takes the run's `harness.RunView` and returns a number, or None where the
run holds nothing to read (that metric is then left out of the line)."""

from __future__ import annotations

from typing import Optional

from port_bench import trace, work
from port_bench.spec import launches, reference


def pad_share(view) -> Optional[float]:
    """Share of the buckets' rows x frames that no delivered frame covers:
    padding rows, frames past each row's end, and the frames of a row that
    was served again at a larger bucket."""
    if not view.dispatches:
        return None
    last = {}
    for d in view.dispatches:
        for rid in d.rids:
            last[rid] = d
    total = sum(d.rows * d.max_frames for d in view.dispatches)
    covered = sum(f for d in view.dispatches for rid, f in zip(d.rids, d.n_frames)
                  if last[rid] is d)
    return 100.0 * (1.0 - covered / total)


def mfu(view) -> Optional[float]:
    """The model's operations for the requests finished in the window, each
    at its own tokens and frames (its reference module's `request_flops`),
    over the window and the dtype's peak."""
    if not view.completed or view.window_s <= 0:
        return None
    count = reference(view.cfg).request_flops
    flop = sum(count(view.cfg, tok, frames) for tok, frames in view.completed)
    return 100.0 * flop / (view.window_s * work.peak_flops(view.dtype))


def idle_share(view) -> Optional[float]:
    s = view.trace
    if s is None or s.window_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)


def roofline(view, kernel: str) -> Optional[float]:
    """Bound time of the kernel's launches in the traced sub-window (each
    generator call's shapes, the `kernel_launches` of the configuration's
    "launches" module) over the kernel's device time in the trace."""
    if view.trace is None or not view.traced_dispatches:
        return None
    mod = launches(view.cfg)
    seconds = trace.kernel_seconds(view.trace, mod.KERNELS[kernel])
    if seconds <= 0:
        return None
    bound = sum(work.bound_seconds(f, b, view.dtype)
                for d in view.traced_dispatches
                for f, b in mod.kernel_launches(view.cfg, d.rows, d.max_frames, view.dtype)[kernel])
    return 100.0 * bound / seconds


def batch_rows(view) -> Optional[float]:
    """Requests per engine call of the micro-batcher in the window."""
    b = view.batcher
    if not b or not b["dispatches"]:
        return None
    return b["requests"] / b["dispatches"]
