"""admit_self_ms.engine: a submit's self time over the traced stretch:
the port's ``submit`` span less its children (``submit.harvest``,
``admit.pack``, ``admit.grow``, ``admit.copy``, ``admit.warmup``), a
submit: what the spans do not name.  (An escalated retry admits inside
``submit.harvest``; the benchmark's engine never escalates.)"""
from pathlib import Path

from harness.spec import load_module

_pack = load_module(Path(__file__).with_name("admit_pack_ms.engine.py"))
CHILDREN = ("submit.harvest", "admit.pack", "admit.grow", "admit.copy",
            "admit.warmup")


def read(run):
    return _pack.per_submit_ms(run.counters, "submit", less=CHILDREN)
