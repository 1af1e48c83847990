"""Device ms from the step's start to the first model module's start (the
video tower in AVVAD, the LSTM stack in AudioVAD): the STFT frontend and the
input casts; the mean over the traced window's steps."""
from benchmark.harness.readers import stage_ms


def read(rec):
    ms = stage_ms(rec, "start", "tower_start")
    return ms if ms is not None else stage_ms(rec, "start", "lstm_start")
