"""K1a's share of its roofline, %: the launches' bounds over their device
time in the profiled steps (one launch a layer at the mix's B, T and the
configuration's H; ``roofline/k1a.py``)."""
from benchmark.harness.readers import roofline_pct
from benchmark.roofline import k1a, peaks

PATTERN = "lstm_infer_persist_kernel<0>"


def read(rec):
    b, t, h = rec["mix"]["batch"], rec["mix"]["frames"], rec["config"]["lstm_hidden_size"]
    return roofline_pct(rec, PATTERN, peaks.bound_s(*k1a.cost(b, t, h), k1a.PRECISION))
