"""The stream driver (``drivers/stream.py``, run as it is) for a cascade whose
SR net comes from the port's zoo: ``portbench.zoo`` takes the place of
``portbench.cascade`` and ``portbench.flops`` in it, so the weights, the
predictor, the spans, the count of the work and the reference follow the
configuration's ``sr_model``.  Traffic keys: those of ``drivers/stream.py``.
"""
from __future__ import annotations

from portbench import harness, zoo


def run(cell) -> harness.Outcome:
    stream = harness.load_module(harness.BENCH / "drivers" / "stream.py",
                                 "portbench_driver_stream_zoo")
    stream.cs = stream.flops = zoo
    return stream.run(cell)
