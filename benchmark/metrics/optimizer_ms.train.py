"""Device ms of Adam's step (optimizer step hooks); the mean over the traced
window's steps."""
from benchmark.harness.readers import stage_ms


def read(rec):
    return stage_ms(rec, "optimizer_start", "optimizer_end")
