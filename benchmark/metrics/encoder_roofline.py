"""The WaveNet encoder's share of its roofline, %: the whole encoder's bound
(``roofline/wavenet.py``, compute-bound at the bf16 peak) over the device ms a
step of the program's ``encoder`` span. It reads the span and no kernel
names, so whatever kernels compute the encoder are judged on the same work;
None where the program keeps no such span."""
from benchmark.roofline import peaks, wavenet

from avvad_tpu_torch.utils import profiling

SPAN, STEP = "encoder", "serve.step"


def read(rec):
    spans = profiling.snapshot()["spans"] if hasattr(profiling, "snapshot") else {}
    s, step = spans.get(SPAN), spans.get(STEP)
    if not (s and step and s["device_ms"]):
        return None
    bound_ms = 1e3 * peaks.bound_s(*wavenet.cost(rec["config"], rec["mix"]), wavenet.PRECISION)
    return 100.0 * bound_ms / (s["count"] * s["device_ms"] / step["count"])
