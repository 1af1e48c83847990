"""K1d's share of its roofline, %: the launches' bounds over their device
time in the profiled steps (one launch a layer; ``roofline/k1d.py``)."""
from benchmark.harness.readers import roofline_pct
from benchmark.roofline import k1d, peaks

PATTERN = "lstm_fwd_persist_kernel<true"


def read(rec):
    b, t, h = rec["mix"]["batch"], rec["mix"]["frames"], rec["config"]["lstm_hidden_size"]
    return roofline_pct(rec, PATTERN, peaks.bound_s(*k1d.cost(b, t, h), k1d.PRECISION))
