"""K1e's share of its roofline, %: the launches' bounds over their device
time in the profiled steps (one launch a layer; ``roofline/k1e.py``)."""
from benchmark.harness.readers import roofline_pct
from benchmark.roofline import k1e, peaks

PATTERN = "lstm_bwd_persist_kernel"


def read(rec):
    b, t, h = rec["mix"]["batch"], rec["mix"]["frames"], rec["config"]["lstm_hidden_size"]
    return roofline_pct(rec, PATTERN, peaks.bound_s(*k1e.cost(b, t, h), k1e.PRECISION))
