"""The x4 tail's least time (its two k2s2 deconvs and conv_last at bf16 peak,
not the GEMMs of any folded form) over the device time of one forward's
tail launches: the kernels named ``tail_x4_kernel`` and ``finish_kernel``
(no module boundary holds the tail alone), per ``tail_x4_kernel`` launch.
The trunk's shape is the SR net's input (span ``portbench.sr_net``)."""
from portbench import flops


def read(trace, counters):
    if trace is None or counters.get("dtype") != "bf16":
        return None
    main = trace.kernels("tail_x4_kernel")
    shapes = trace.shapes.get("sr_net", [])
    if not main or len(shapes) != 1:
        return None
    n, _, h, w = shapes[0]
    px = n * h * w
    least = flops.least_time(flops.tail_bytes(px), flops.tail_per_trunk_pixel() * px, "bf16")
    device = sum(main) + sum(trace.kernels("finish_kernel"))
    return 100.0 * least["seconds"] / (device / len(main))
