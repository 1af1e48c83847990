"""Device ms of the backward pass: from the logits' gradient to Adam's step;
the mean over the traced window's steps."""
from benchmark.harness.readers import stage_ms


def read(rec):
    return stage_ms(rec, "backward_start", "optimizer_start")
