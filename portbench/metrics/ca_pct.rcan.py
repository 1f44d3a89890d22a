"""Share of the card's busy time launched inside calls of RCAN's channel
attentions (span ``portbench.ca``, a forward hook on each ``CALayer``: the
mean over H and W, two 1x1 convs, the sigmoid and the scaling)."""


def read(trace, counters):
    if trace is None or trace.device_s <= 0 or not trace.span_instances("ca"):
        return None
    return 100.0 * trace.span_s("ca") / trace.device_s
