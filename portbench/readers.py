"""Readers that several per-layer metrics share (each metric's file under
``metrics/`` names the one it uses, so a cell of its own gets a metric of
its own)."""
from portbench import flops


def idle_pct(trace, counters):
    """Share of the device slice in which no kernel, copy or memset ran on
    the card (the union of their intervals against the slice's length);
    nothing where the slice holds no device activity at all."""
    if trace is None or trace.window_s <= 0 or trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)


def mfu(trace, counters):
    """Model FLOPs of the work the window completed before its profiled
    slices (the benchmark's count of the reference's convolutions,
    ``portbench.flops``) over that part's length and the card's published
    peak in the configuration's precision."""
    if not counters.get("window_s") or "model_flop" not in counters:
        return None
    return 100.0 * counters["model_flop"] / (counters["window_s"]
                                             * flops.PEAK_FLOPS[counters["dtype"]])
