"""Device ms of the video tower (forward hooks on ``model.tower``); the mean
over the traced window's steps."""
from benchmark.harness.readers import stage_ms


def read(rec):
    return stage_ms(rec, "tower_start", "tower_end")
