"""The scenes' share of the space ranks' summed peak: the FLOP count of the
scenes the window served before its profiled slices
(``portbench.flops.cascade_forward`` of the whole scene) over that part's
length and ``ranks`` cards' published peak in the configuration's
precision."""
from portbench import flops


def read(trace, counters):
    if not counters.get("window_s") or "model_flop" not in counters:
        return None
    peak = counters["ranks"] * flops.PEAK_FLOPS[counters["dtype"]]
    return 100.0 * counters["model_flop"] / (counters["window_s"] * peak)
