"""Host seconds of the training entry's set-up span ``setup.train_state``
(``create_train_state``: the model to the card and Adam, whose constructor
imports ``torch._dynamo``), less the set-up spans inside it, from
``avvad_tpu_torch.utils.profiling.snapshot()``; None where the program keeps
no such span."""
from avvad_tpu_torch.utils import profiling

SPANS = ("setup.train_state",)


def read(rec):
    setup = profiling.snapshot()["setup"] if hasattr(profiling, "snapshot") else {}
    found = [setup[k]["self_s"] for k in SPANS if k in setup]
    return sum(found) if found else None
