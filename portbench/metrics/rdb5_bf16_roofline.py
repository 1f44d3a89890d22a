"""One RDB5 block's least time (five 3x3 convs at bf16 peak, or its input
read once, output written once and weights once at HBM's rate) over the
mean device time launched inside a call of the block (the span
``portbench.rdb5``, a forward hook on each ResidualDenseBlock5)."""
from portbench import flops


def read(trace, counters):
    if trace is None or counters.get("dtype") != "bf16":
        return None
    calls, shapes = trace.span_instances("rdb5"), trace.shapes.get("rdb5", [])
    if not calls or len(shapes) != 1:
        return None
    n, c, h, w = shapes[0]
    px = n * h * w
    least = flops.least_time(flops.rdb5_bytes(px, nf=c), flops.rdb5_per_pixel(nf=c) * px, "bf16")
    return 100.0 * least["seconds"] / (sum(calls) / len(calls))
