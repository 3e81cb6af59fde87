"""batch_rows.interactive: requests per engine call of the micro-batcher (readers.batch_rows)."""

from port_bench.readers import batch_rows as read  # noqa: F401
