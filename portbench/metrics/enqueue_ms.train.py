"""Mean host time for a ``train_step_u8`` call to return, with no
synchronise, over the window's part before its profiled slices: when it
nears the step's device time, the host paces it."""


def read(trace, counters):
    if not counters.get("steps"):
        return None
    return 1e3 * counters["enqueue_s"] / counters["steps"]
