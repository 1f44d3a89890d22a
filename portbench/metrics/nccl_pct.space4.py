"""Share of space rank 0's device time in the device slice (its kernels,
copies and memsets, clipped to the slice) spent in NCCL's kernels: each
scene's broadcast, the halo exchanges, the GroupNorm sums' all-reduces and
the gather of the strips, waits for the other ranks included."""


def read(trace, counters):
    if trace is None:
        return None
    s = trace.device_slice
    total = nccl = 0
    for a, b, name, *_ in s.device:
        t = min(b, s.stop_ns) - max(a, s.start_ns)
        if t > 0:
            total += t
            nccl += t if "nccl" in name.lower() else 0
    return 100.0 * nccl / total if total else None
