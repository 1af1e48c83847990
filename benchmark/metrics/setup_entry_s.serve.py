"""Host seconds of the serving entry's set-up spans, ``setup.serving_fn``
(``make_waveform_serving_fn``) and ``setup.calibrate`` (the int8 tower's
scales), each less the set-up spans inside it (``setup.kernels`` where
calibration loads the kernel library), from
``avvad_tpu_torch.utils.profiling.snapshot()``; None where the program keeps
no such span."""
from avvad_tpu_torch.utils import profiling

SPANS = ("setup.serving_fn", "setup.calibrate")


def read(rec):
    setup = profiling.snapshot()["setup"] if hasattr(profiling, "snapshot") else {}
    found = [setup[k]["self_s"] for k in SPANS if k in setup]
    return sum(found) if found else None
