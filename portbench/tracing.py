"""Spans from the benchmark's own hooks, two profiled slices of the window,
and what the per-layer readers take from them.

Spans are ``torch.profiler.record_function`` ranges opened by forward hooks
on modules of the program (``portbench.<name>``), so no span lives inside
the program.  A kernel belongs to a span when the host call that launched
it (the CUDA runtime or driver event it correlates with) ran inside the
span, on the same thread.
"""
from __future__ import annotations

import bisect
import threading
import time
from collections import defaultdict

DEVICE_ACTIVITY = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_ACTIVITY = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
SPAN = "portbench."
# markers at the slice's two ends, on the profiler's own clock
SLICE_OPEN, SLICE_CLOSE = SPAN + "slice_open", SPAN + "slice_close"


def activity(e) -> str:
    """The kind of a profiler event, where the event does not say it
    (``activity_type`` is missing from older builds): device events are
    kernels, copies, memsets or the device's copy of an annotation; host
    events are annotations, CUDA runtime or driver calls, or operators."""
    kind = getattr(e, "activity_type", None)
    if kind is not None:
        return kind()
    name = e.name()
    if "cuda" in str(e.device_type()).lower():
        if name.startswith(SPAN):
            return "gpu_user_annotation"
        if name.startswith("Memcpy"):
            return "gpu_memcpy"
        return "gpu_memset" if name.startswith("Memset") else "kernel"
    if name.startswith(SPAN) or getattr(e, "is_user_annotation", lambda: False)():
        return "user_annotation"
    return "cuda_runtime" if name.startswith(("cuda", "cu")) else "cpu_op"


class Spans:
    """Forward hooks that open ``portbench.<name>`` around module calls and
    record the input shapes each name saw."""

    def __init__(self):
        self.shapes = defaultdict(set)
        self._tl = threading.local()
        self._handles = []

    def on(self, module, name: str) -> None:
        import torch

        label = SPAN + name

        def pre(_mod, args):
            self.shapes[name].add(tuple(args[0].shape))
            rf = torch.profiler.record_function(label)
            rf.__enter__()
            stack = getattr(self._tl, "stack", None)
            if stack is None:
                stack = self._tl.stack = []
            stack.append(rf)

        def post(_mod, _args, _out):
            self._tl.stack.pop().__exit__(None, None, None)

        self._handles += [module.register_forward_pre_hook(pre),
                          module.register_forward_hook(post)]

    def remove(self) -> None:
        for h in self._handles:
            h.remove()
        self._handles = []


class Tracer:
    """Profiles the last ``length`` seconds of the window in two slices, so
    that stopping the profiler and reading its events fall outside it.  The
    first half records the device's activity alone: the profiler then costs
    the host little, and the busy and idle time read as they would without
    it.  The second half records the host's operators and the benchmark's
    spans too: that slows the host, not the device time of a span.  The
    driver calls ``tick()`` from its loop and ``stop()`` as the window
    closes.  Disabled, it does nothing."""

    def __init__(self, enabled: bool, length: float):
        self.enabled, self.length = enabled, length
        self.start_at = self.switch_at = None
        self.phase = None          # None, "device", "spans", "done"
        self.prof = None
        self.slices = {}           # phase -> (profile, [start ns, stop ns])
        self.start_cost = {}       # phase -> seconds that starting the profiler took
        self.untraced = None       # (perf_counter time, work done) as the first slice starts
        self.spans = Spans()
        if enabled:
            self._warm()

    @staticmethod
    def _activities(host: bool) -> list:
        import torch
        from torch.profiler import ProfilerActivity

        activities = [ProfilerActivity.CPU] if host else []
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        return activities or [ProfilerActivity.CPU]

    def _warm(self) -> None:
        """One empty session of each kind in set-up: the profiler's first
        start sets up its device tracing, which takes seconds and would eat
        the slice."""
        import torch
        from torch.profiler import profile

        for host in (False, True):
            with profile(activities=self._activities(host)):
                if torch.cuda.is_available():
                    torch.ones(1, device="cuda").add_(1)
                    torch.cuda.synchronize()

    def open(self, end: float) -> None:
        """The window is to close at perf_counter time ``end``."""
        self.start_at = end - self.length
        self.switch_at = end - self.length / 2

    def _start(self, phase: str, now: float) -> None:
        import torch
        from torch.profiler import profile

        self.prof = profile(activities=self._activities(phase == "spans"))
        self.prof.start()
        self.start_cost[phase] = time.perf_counter() - now
        self.slices[phase] = (self.prof, [time.time_ns(), None])
        with torch.profiler.record_function(SLICE_OPEN):
            pass
        self.phase = phase

    def _close(self) -> None:
        """Wait for the device, mark the end, stop the profiler."""
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        with torch.profiler.record_function(SLICE_CLOSE):
            pass
        self.slices[self.phase][1][1] = time.time_ns()
        self.prof.stop()

    def tick(self, now: float, work=None) -> None:
        """``work``: what the window has done so far, kept as the first
        slice starts: counters are read from the part of the window that the
        profiler does not slow."""
        if not self.enabled or self.phase == "done":
            return
        if self.phase is None and now >= self.start_at:
            self.untraced = (now, work)
            self._start("device", now)
        elif self.phase == "device" and now >= self.switch_at:
            self._close()
            self._start("spans", time.perf_counter())

    def untraced_part(self, t0: float, closed_at: float, work) -> tuple:
        """(seconds, work) of the window before the first slice: the whole
        window where nothing was profiled."""
        if self.untraced is None:
            return closed_at - t0, work
        return self.untraced[0] - t0, self.untraced[1]

    def stop(self) -> None:
        """Close the open slice."""
        if self.phase in ("device", "spans"):
            self._close()
            self.phase = "done"

    def finish(self):
        """The slices' Trace, or None where nothing was profiled."""
        if "device" not in self.slices or self.phase != "done":
            return None
        spans = None
        if "spans" in self.slices:
            prof, (a, b) = self.slices["spans"]
            spans = Summary(prof.profiler.kineto_results.events(), a, b, self.spans.shapes)
        prof, (a, b) = self.slices["device"]
        # a slice without host events has no markers: the span slice's give the clocks' offset
        offset = spans.clock_offset_ns if spans is not None else 0
        device = Summary(prof.profiler.kineto_results.events(), a, b, self.spans.shapes, offset)
        return Trace(device, spans, self.start_cost)


class Trace:
    """What the readers take: busy and idle time from the device slice;
    spans, kernels and shapes from the span slice (the device slice where
    the window closed before it)."""

    def __init__(self, device, spans, start_cost: dict):
        self.device_slice, self.span_slice = device, spans
        self.start_cost = start_cost
        self.busy_s, self.window_s = device.busy_s, device.window_s
        self._src = spans if spans is not None else device
        self.device_s, self.shapes = self._src.device_s, self._src.shapes

    def kernels(self, *needles: str) -> list:
        return self._src.kernels(*needles)

    def span_instances(self, name: str) -> list:
        return self._src.span_instances(name)

    def span_s(self, name: str) -> float:
        return self._src.span_s(name)

    def breakdown(self) -> dict:
        """Device operations of the device slice; idle gaps labelled by the
        host's calls of the span slice."""
        return {"device_ops": self.device_slice.breakdown()["device_ops"],
                "idle_gaps": self._src.breakdown()["idle_gaps"]}

    def describe(self) -> str:
        spans = self.span_slice.describe() if self.span_slice is not None else "none"
        return (f"profiler starts {self.start_cost}; device slice: {self.device_slice.describe()}; "
                f"span slice: {spans}")


class Summary:
    """The profiled slice, reduced: device intervals, kernels by name,
    kernels under each span, host activity for the idle gaps."""

    def __init__(self, events, start_ns: int, stop_ns: int, shapes, offset_ns: int = 0):
        self.shapes = {k: sorted(v) for k, v in shapes.items()}
        device, launches, ops, host, spans = [], {}, {}, [], defaultdict(list)
        marks = {}
        for e in events:
            kind = activity(e)
            if kind in DEVICE_ACTIVITY:
                device.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name(),
                               e.correlation_id(), e.linked_correlation_id()))
            elif kind in HOST_ACTIVITY:
                start, end, tid = e.start_ns(), e.start_ns() + e.duration_ns(), e.start_thread_id()
                if e.name() in (SLICE_OPEN, SLICE_CLOSE):
                    marks[e.name()] = start
                    continue
                if kind in ("cuda_runtime", "cuda_driver"):
                    launches[e.correlation_id()] = (tid, start)
                elif kind == "cpu_op":
                    ops[e.correlation_id()] = (tid, start)
                if kind == "user_annotation" and e.name().startswith(SPAN):
                    spans[e.name()[len(SPAN):]].append((tid, start, end))
                else:
                    host.append((start, end, tid, e.name()))
        self.clock_offset_ns = 0
        if len(marks) == 2:
            # the profiler's clock need not be the host's: its own markers bound the slice
            self.clock_offset_ns = marks[SLICE_OPEN] - start_ns
            start_ns, stop_ns = marks[SLICE_OPEN], marks[SLICE_CLOSE]
        else:
            start_ns, stop_ns = start_ns + offset_ns, stop_ns + offset_ns
        self.start_ns, self.stop_ns = start_ns, stop_ns
        self.window_s = (stop_ns - start_ns) / 1e9
        device.sort()
        self.device = device
        self.host = host
        self.device_s = sum(min(b, stop_ns) - max(a, start_ns)
                            for a, b, *_ in device if b > start_ns and a < stop_ns) / 1e9
        self.intervals = _merge([(max(a, start_ns), min(b, stop_ns)) for a, b, *_ in device
                                 if b > start_ns and a < stop_ns])
        self.busy_s = sum(b - a for a, b in self.intervals) / 1e9
        self._span_time = {name: _attribute(device, launches, ops, inst)
                           for name, inst in spans.items()}
        outside = sum(1 for a, b, *_ in device if a < start_ns or b > stop_ns)
        self.counts = (len(device), outside, len(host), len(launches),
                       {k: len(v) for k, v in spans.items()}, len(marks))

    def describe(self) -> str:
        n_dev, outside, n_host, n_launch, spans, marks = self.counts
        return (f"{self.window_s:.4f} s ({marks} slice markers, clock offset "
                f"{self.clock_offset_ns} ns): {n_dev} device events "
                f"({outside} reaching outside the slice; {self.busy_s:.4f} s busy), {n_host} host "
                f"events, {n_launch} launches, spans {spans}, device s under spans "
                f"{({k: round(sum(v), 6) for k, v in self._span_time.items()})}")

    def kernels(self, *needles: str) -> list:
        """Durations in seconds of the kernels whose name holds any needle."""
        return [(b - a) / 1e9 for a, b, name, *_ in self.device
                if any(n in name for n in needles)]

    def span_instances(self, name: str) -> list:
        """Device seconds launched inside each call of the span ``name``
        (calls that launched nothing left out)."""
        return [s for s in self._span_time.get(name, []) if s > 0]

    def span_s(self, name: str) -> float:
        return sum(self._span_time.get(name, []))

    def breakdown(self) -> dict:
        by_op = defaultdict(float)
        for a, b, name, *_ in self.device:
            by_op[name[:160]] += (b - a) / 1e9
        ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
        gaps, edges = [], [self.start_ns] + [x for iv in self.intervals for x in iv] + [self.stop_ns]
        for a, b in zip(edges[0::2], edges[1::2]):
            if b > a:
                gaps.append((a, b))
        labels = _host_at([(a + b) // 2 for a, b in gaps], self.host)
        idle = defaultdict(float)
        for (a, b), label in zip(gaps, labels):
            idle[label[:160]] += (b - a) / 1e9
        return {"device_ops": [list(kv) for kv in ops],
                "idle_gaps": [list(kv) for kv in sorted(idle.items(), key=lambda kv: -kv[1])[:10]]}


def _merge(intervals: list) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(iv) for iv in out]


def _attribute(device: list, launches: dict, ops: dict, instances: list) -> list:
    """Device seconds per span instance: each kernel goes to the instance, on
    its launching thread, whose interval holds its launch (the runtime call
    of the same correlation id, else the operator it is linked to)."""
    by_thread = defaultdict(list)
    for i, (tid, a, b) in enumerate(instances):
        by_thread[tid].append((a, b, i))
    starts = {}
    for tid, ivs in by_thread.items():
        ivs.sort()
        starts[tid] = [a for a, _, _ in ivs]
    total = [0.0] * len(instances)
    for a, b, _name, corr, linked in device:
        launch = launches.get(corr) if corr else None
        if launch is None and linked:
            launch = ops.get(linked)
        if launch is None or launch[0] not in by_thread:
            continue
        tid, t = launch
        ivs = by_thread[tid]
        k = bisect.bisect_right(starts[tid], t) - 1
        if k >= 0 and ivs[k][0] <= t <= ivs[k][1]:
            total[ivs[k][2]] += (b - a) / 1e9
    return total


def _host_at(points: list, host: list) -> list:
    """For each time point, the name of the innermost host event that spans
    it on any thread (the latest started), or a note that none does."""
    order = sorted(range(len(points)), key=lambda i: points[i])
    events = sorted(host)
    stacks = defaultdict(list)
    labels = [None] * len(points)
    j = 0
    for i in order:
        t = points[i]
        while j < len(events) and events[j][0] <= t:
            a, b, tid, name = events[j]
            st = stacks[tid]
            while st and st[-1][1] < a:
                st.pop()
            st.append((a, b, name))
            j += 1
        best = None
        for st in stacks.values():
            while st and st[-1][1] < t:
                st.pop()
            if st and (best is None or st[-1][0] > best[0]):
                best = st[-1]
        labels[i] = best[2] if best else "host: no profiled call (Python)"
    return labels
