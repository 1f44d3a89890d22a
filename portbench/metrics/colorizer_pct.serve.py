"""Share of the card's busy time (kernels, copies, memsets) launched inside
calls of the colorizer (span ``portbench.colorizer``, a forward hook on the
predictor's ``c_model``)."""


def read(trace, counters):
    if trace is None or trace.device_s <= 0 or not trace.span_instances("colorizer"):
        return None
    return 100.0 * trace.span_s("colorizer") / trace.device_s
