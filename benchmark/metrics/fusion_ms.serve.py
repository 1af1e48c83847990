"""Device ms from the video tower's end to the LSTM stack's start: the gather
onto the audio timeline, MCB, signed square root, L2 norm and BatchNorm; the
mean over the traced window's steps."""
from benchmark.harness.readers import stage_ms


def read(rec):
    return stage_ms(rec, "tower_end", "lstm_start")
