"""Where the parts of the model's forward end, for whoever times them.

The model calls `mark(name)` at the end of each part (`MARKS`, in order
along the forward): the acoustic model after the encoder and conditioning,
and after the variance adaptor and upsampling; the joint model at the mel.
A mark does nothing unless a caller armed this thread's hook (`marking`),
as the serving path's bucket programs do to record a CUDA event there; every
other caller pays one thread-local read.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Optional

MARKS = ("encoder", "variance", "decoder")

_local = threading.local()


def mark(name: str) -> None:
    """A part of the model (`MARKS`) ends here: calls this thread's armed
    hook, if any."""
    hook = getattr(_local, "hook", None)
    if hook is not None:
        hook(name)


@contextlib.contextmanager
def marking(hook: Optional[Callable[[str], None]]):
    """Within it, `mark(name)` on this thread calls `hook(name)` (nothing
    with None)."""
    outer = getattr(_local, "hook", None)
    _local.hook = hook
    try:
        yield
    finally:
        _local.hook = outer
