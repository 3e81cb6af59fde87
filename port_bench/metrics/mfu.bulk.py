"""mfu.bulk: % of the dtype's peak that the delivered work reached over the window (readers.mfu)."""

from port_bench.readers import mfu as read  # noqa: F401
