"""Share of the card's busy time launched inside calls of the SR net (span
``portbench.sr_net``, a forward hook on the predictor's ``sr_model``)."""


def read(trace, counters):
    if trace is None or trace.device_s <= 0 or not trace.span_instances("sr_net"):
        return None
    return 100.0 * trace.span_s("sr_net") / trace.device_s
