"""idle_share.interactive: % of the traced sub-window with no operation on the device (readers.idle_share)."""

from port_bench.readers import idle_share as read  # noqa: F401
