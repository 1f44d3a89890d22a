"""What the probe sweeps and ablations share: the device flag, the header
line, seeded operands and the timing."""
from __future__ import annotations

import argparse
import statistics
import subprocess

import numpy as np
import torch

from srcgan_tpu_torch import config

CPU_ROWS = 256                 # M of a --device cpu run (the plain versions)
L2_BYTES = 50 * 1024 * 1024    # an H100's L2: operands meant to come from HBM must exceed it
# An H100 SXM's dense tensor-core peaks and memory rate (NVIDIA's data sheet):
# operations and bytes a second.
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12}
HBM_BYTES_PER_S = 3.35e12


def parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--device", type=str, default="cuda",
                   help="where to run: the card by default (an error without one); "
                        "'cpu' runs the plain versions at a small M and prints no rate")
    return p


def card_line(dev: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them; every rate a
    sweep prints stands under this line."""
    if dev.type != "cuda":
        return "cpu (plain versions, no rates)"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout
    return out.strip().splitlines()[dev.index or 0]


def max_sm_clock_mhz(dev: torch.device) -> int:
    """The card's highest SM clock in MHz (nvidia-smi clocks.max.sm): the rate
    a bound on shared-memory passes is taken at."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60, check=True).stdout
    return int(out.strip().splitlines()[dev.index or 0])


def operand(rng: np.random.Generator, shape, dtype: torch.dtype, dev) -> torch.Tensor:
    """uniform(-1, 1) as bf16 or integers in [-100, 100) as int8, as the
    JAX package's sweeps draw them."""
    if dtype == torch.int8:
        return torch.from_numpy(rng.integers(-100, 100, shape).astype(np.int8)).to(dev)
    return torch.from_numpy(rng.uniform(-1, 1, shape).astype(np.float32)).to(dev, dtype)


def alternate_int8(x: torch.Tensor, w: torch.Tensor) -> None:
    """In place, at most three entries moved by one: make w[0,0] odd, the sum
    of column 0 of w odd and y[0,0] = x[0] . w[:,0] odd.  Then clip(x + 1)
    gives an even y[0,0], and the int8 chain of ``probe_mxu`` alternates
    between its two operands instead of staying on the first."""
    w[0, 0] |= 1
    if int(w[:, 0].int().sum()) % 2 == 0:
        w[1, 0] += 1
    if int((x[0].int() * w[:, 0].int()).sum()) % 2 == 0:
        x[0, 0] += 1


def graph_ms(calls, reps: int = 15, warmup: int = 2) -> float:
    """Median milliseconds per call of the callables in ``calls`` on the card:
    they are captured once into a CUDA graph (so the host's time to enqueue a
    launch is not in the number) and the graph is replayed ``reps`` times
    between CUDA events."""
    for _ in range(warmup):
        for fn in calls:
            fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for fn in calls:
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / len(calls))
    return statistics.median(times)


def whole_session(events, calls: int) -> bool:
    """Whether a profiler session over ``calls`` calls kept every kernel's
    record: it holds device entries, and each kernel ran a whole number of
    times a call (every ``fn`` timed here launches the same kernels on each
    call once warm, so a count such as 4 of 5 is a lost record)."""
    return bool(events) and all(e.count % calls == 0 for e in events)


def _device_events(fn, calls: int, tries: int = 3) -> list:
    """torch.profiler's device entries over ``calls`` calls of ``fn`` (after
    one that builds and warms it).  Now and then a session records no device
    activity at all, not even a plain PyTorch kernel's (seen on an H100 after
    many sessions in one process), or loses one kernel's record (4 launches
    of 5 calls, seen on an H100); such a session is taken again, up to
    ``tries`` sessions, and the last one's entries returned as they are."""
    from torch import profiler

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profiler.profile(activities=[profiler.ProfilerActivity.CPU,
                                          profiler.ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        if whole_session(events, calls):
            break
    return events


def device_us(fn, match: str, calls: int = 10):
    """Mean device microseconds per call of ``fn`` of the kernels whose name
    holds ``match`` ("" for every kernel; torch.profiler over ``calls``
    calls); None where the profiler reports no device time."""
    # kernels only: an operator's own entry repeats the time of the kernels it launched
    total = sum(getattr(e, "self_device_time_total", 0) for e in _device_events(fn, calls)
                if match in e.key)
    return total / calls if total > 0 else None


def device_kernels(fn, calls: int = 5) -> dict:
    """Device kernels a call of ``fn`` runs: kernel name -> launches a call
    (torch.profiler over ``calls`` calls, after one that builds and warms it)."""
    return {e.key: e.count / calls for e in _device_events(fn, calls)}


def rate(ops: float, ms: float) -> float:
    """Tera-operations per second of ``ops`` operations in ``ms`` milliseconds."""
    return ops / ms / 1e9
