"""pad_share.interactive: % of the bucket rows x frames no delivered frame covers (readers.pad_share)."""

from port_bench.readers import pad_share as read  # noqa: F401
