"""Host ms of the program's ``serve.step`` span (``ServingStep.__call__``) a
serving step, the inside twin of ``dispatch_ms.serve``: over the traced
window's profiled steps, from ``avvad_tpu_torch.utils.profiling.snapshot()``;
None where the program keeps no such span."""
from avvad_tpu_torch.utils import profiling

SPAN, STEP = "serve.step", "serve.step"


def read(rec):
    spans = profiling.snapshot()["spans"] if hasattr(profiling, "snapshot") else {}
    s, step = spans.get(SPAN), spans.get(STEP)
    if not (s and step and s["host_ms"] is not None):
        return None
    return s["count"] * s["host_ms"] / step["count"]
