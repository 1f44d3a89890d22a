"""Megabytes of halo rows that space rank 0's strip receives a scene: the
program's counter ``space.halo_bytes`` (added once a call by the
space-sharded predictor) over the scenes rank 0's process served, set-up
and traced slices included.  Nothing where the program keeps no such
counter."""


def read(trace, counters):
    try:
        from srcgan_tpu_torch.utils import trace as program
    except ImportError:
        return None
    total = program.counters().get("space.halo_bytes")
    if not total or not counters.get("scenes_served"):
        return None
    return total / counters["scenes_served"] / 1e6
