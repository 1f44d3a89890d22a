"""Share of the card's busy time launched inside calls of the colorizer's
GroupNorm modules, their dtype copies included (span
``portbench.group_norm``, a forward hook on each)."""


def read(trace, counters):
    if trace is None or trace.device_s <= 0 or not trace.span_instances("group_norm"):
        return None
    return 100.0 * trace.span_s("group_norm") / trace.device_s
