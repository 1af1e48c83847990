"""The program's own kernel launches a serving step: the ``launch.*`` counters'
growth over the ``serve.step`` span, over the traced window's profiled steps
(a count), from ``avvad_tpu_torch.utils.profiling.snapshot()``; None where the
program keeps no such span."""
from avvad_tpu_torch.utils import profiling

STEP = "serve.step"


def read(rec):
    spans = profiling.snapshot()["spans"] if hasattr(profiling, "snapshot") else {}
    step = spans.get(STEP)
    if not step:
        return None
    return sum(n for k, n in step["counts"].items() if k.startswith("launch."))
