"""K3's share of its roofline, %: the launches' bounds over their device
time in the profiled steps, one launch a trunk pass over the batch's unique
camera-rate frames (``roofline/k3.py``)."""
from benchmark.harness.readers import roofline_pct
from benchmark.reference.model import frame_schedule
from benchmark.roofline import k3, peaks

PATTERN = "stem_epilogue_pool_nhwc_kernel"


def read(rec):
    cfg, mix = rec["config"], rec["mix"]
    n = mix["batch"] * frame_schedule(mix["frames"], cfg["video_fps"], cfg["fs"] / cfg["hop"])[0]
    return roofline_pct(rec, PATTERN, peaks.bound_s(*k3.cost(n), k3.PRECISION))
