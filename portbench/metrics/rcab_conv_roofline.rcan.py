"""One RCAB 3x3 conv's least time (its FLOPs at bf16 peak, or its input read
once, output written once and weights once at HBM's rate;
``portbench.zoo``) over the mean device time launched inside a call of
one (span ``portbench.rcab_conv``, a forward hook on each RCAB's two
convs)."""
from portbench import flops, zoo


def read(trace, counters):
    if trace is None or counters.get("dtype") != "bf16":
        return None
    calls, shapes = trace.span_instances("rcab_conv"), trace.shapes.get("rcab_conv", [])
    if not calls or len(shapes) != 1:
        return None
    n, c, h, w = shapes[0]
    px = n * h * w
    least = flops.least_time(zoo.rcab_conv_bytes(px, nf=c), zoo.rcab_conv_per_pixel(c) * px,
                             "bf16")
    return 100.0 * least["seconds"] / (sum(calls) / len(calls))
