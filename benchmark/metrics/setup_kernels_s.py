"""Host seconds of the program's ``setup.kernels`` set-up span: the kernel
library's first load, with its nvcc build where the checkout has none, from
``avvad_tpu_torch.utils.profiling.snapshot()``; None where the program keeps
no such span."""
from avvad_tpu_torch.utils import profiling

SPANS = ("setup.kernels",)


def read(rec):
    setup = profiling.snapshot()["setup"] if hasattr(profiling, "snapshot") else {}
    found = [setup[k]["s"] for k in SPANS if k in setup]
    return sum(found) if found else None
