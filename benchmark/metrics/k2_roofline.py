"""K2's share of its roofline, %: the launches' bounds over their device
time in the profiled steps. The launches come eight to a trunk pass, one a
block, over the batch's unique camera-rate frames; each is given the mean
of the eight blocks' bounds (``roofline/k2.py``)."""
from benchmark.harness.readers import roofline_pct
from benchmark.reference.model import frame_schedule
from benchmark.roofline import k2, peaks

PATTERN = "int8_basic_block_kernel"


def read(rec):
    cfg, mix = rec["config"], rec["mix"]
    n = mix["batch"] * frame_schedule(mix["frames"], cfg["video_fps"], cfg["fs"] / cfg["hop"])[0]
    bounds = [peaks.bound_s(ops, nb, k2.PRECISION) for ops, nb in k2.cost(n)]
    return roofline_pct(rec, PATTERN, sum(bounds) / len(bounds))
