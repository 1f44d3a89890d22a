"""The port's counters: plain integers, always on, kept in memory.

    from srcgan_tpu_torch.utils import trace

    trace.count("tiler.kept_px", 4096)
    trace.counters()        # {"tiler.kept_px": 4096}
    trace.reset()

A counter is added to at most once per scene, batch or step, never per
kernel, so it costs a lock and a dict update where it is added.
"""
from __future__ import annotations

import threading

_counters: dict = {}
_lock = threading.Lock()


def count(name: str, n: int = 1) -> None:
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def counters() -> dict:
    """A copy of the counters added since the last reset."""
    with _lock:
        return dict(_counters)


def reset() -> None:
    with _lock:
        _counters.clear()
