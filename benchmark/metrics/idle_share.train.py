"""Device idle share of the training window: 1 - busy / wall over the profiled
steps (busy: the union of the device operations' intervals)."""
from benchmark.harness.readers import idle_share as read  # noqa: F401
