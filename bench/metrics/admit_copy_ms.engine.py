"""admit_copy_ms.engine: host-to-device copies a submit over the traced
stretch: the port's ``admit.copy`` span time (each packed lane array, the
diagonal, b and x0 to the card and into the slot) over its ``submit``
spans."""
from pathlib import Path

from harness.spec import load_module

_pack = load_module(Path(__file__).with_name("admit_pack_ms.engine.py"))


def read(run):
    return _pack.per_submit_ms(run.counters, "admit.copy")
