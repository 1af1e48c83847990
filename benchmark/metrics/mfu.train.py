"""The training step's share of the card's peaks: its parts' operations at
the peaks of their stated precisions over the profiled mean step time, %
(``roofline/model_<config>.py``)."""
from benchmark.harness.readers import mfu_pct as read  # noqa: F401
