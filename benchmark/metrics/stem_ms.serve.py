"""Device ms a serving step of the program's ``tower.stem`` span: ResNet-18's
stem convolution with its channels-last layout transform, up to K3; over the
traced window's profiled steps, from
``avvad_tpu_torch.utils.profiling.snapshot()``; None where the program keeps
no such span."""
from avvad_tpu_torch.utils import profiling

SPAN, STEP = "tower.stem", "serve.step"


def read(rec):
    spans = profiling.snapshot()["spans"] if hasattr(profiling, "snapshot") else {}
    s, step = spans.get(SPAN), spans.get(STEP)
    if not (s and step and s["device_ms"] is not None):
        return None
    return s["count"] * s["device_ms"] / step["count"]
