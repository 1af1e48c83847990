"""Device ms of the LSTM stack's forward in the train step (forward hooks on
it); the mean over the traced window's steps."""
from benchmark.harness.readers import stage_ms


def read(rec):
    return stage_ms(rec, "lstm_start", "lstm_end")
