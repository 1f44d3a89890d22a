"""Share of the output pixels the card computed in the tiled scenes that the
stitched scenes kept: the program's counters ``tiler.kept_px`` over
``tiler.computed_px`` (every row run, the batches' padding rows included).
The rest is the windows' overlap, computed twice, and the padding.

The counters are read from the program (``srcgan_tpu_torch.utils.trace``)
once the run is over, so they cover every scene its process served: the
set-up's warm scene, the window and the profiled slices.  The value is what
the program's window plan and batching give for those scenes, with no time
in it.  Nothing where the program keeps no such counters."""


def read(trace, counters):
    try:
        from srcgan_tpu_torch.utils import trace as program
    except ImportError:
        return None
    seen = program.counters()
    if not seen.get("tiler.computed_px"):
        return None
    return 100.0 * seen["tiler.kept_px"] / seen["tiler.computed_px"]
