"""The benchmark's spans and the reading of a profiled sub-window.

``Spans`` times named spans on the host clock for a whole window and,
while a profile is open, also marks them with ``record_function`` so that
the device's idle gaps can be labelled by what the host was doing.
``Profile`` holds ``torch.profiler`` (CPU and CUDA activity) open over a
few steady steps of the window and reduces what it saw to device time by
kernel, the union of the device's busy intervals, and its idle gaps; no
trace file is written.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

SPAN_PREFIX = "bench."
WINDOW_SPAN = SPAN_PREFIX + "profiled"


class Spans:
    def __init__(self):
        self.times: Dict[str, List[float]] = defaultdict(list)
        self.marking = False

    @contextlib.contextmanager
    def span(self, name: str):
        mark = None
        if self.marking:
            from torch.profiler import record_function

            mark = record_function(SPAN_PREFIX + name)
            mark.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.times[name].append(time.perf_counter() - t0)
            if mark is not None:
                mark.__exit__(None, None, None)


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


class Profile:
    """Open with ``start()`` after a synchronize, close with ``stop()``
    after another, read with ``finish()`` once the window has closed;
    then ``busy_s``, ``window_s``, ``kernels`` ({name: [seconds,
    launches]}) and ``gaps`` are set, and ``overhead_s`` holds the host
    time that starting and stopping took inside the window."""

    def __init__(self, spans: Spans):
        self.spans = spans
        self.prof = None
        self._mark = None
        self.stopped = False
        self.overhead_s = 0.0  # host time of start() and stop() inside the window
        self.busy_s = self.window_s = None
        self.kernels: Dict[str, List[float]] = {}
        self.gaps: List[Tuple[str, float]] = []

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        t0 = time.perf_counter()
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.start()
        self._mark = record_function(WINDOW_SPAN)
        self._mark.__enter__()
        self.spans.marking = True
        self.overhead_s += time.perf_counter() - t0

    def stop(self) -> None:
        """Close the profile; what it saw is read by ``finish`` after the
        window, so that the reading costs the window nothing."""
        t0 = time.perf_counter()
        self.spans.marking = False
        self._mark.__exit__(None, None, None)
        self.prof.stop()
        self.stopped = True
        self.overhead_s += time.perf_counter() - t0

    def finish(self) -> None:
        if self.prof is not None:
            self._reduce(self.prof.profiler.kineto_results.events())
            self.prof = None

    def _reduce(self, events) -> None:
        from torch.autograd import DeviceType

        window = None
        host_spans: List[Tuple[int, int, str]] = []
        device: List[Tuple[int, int]] = []
        kernels: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
        for e in events:
            name = e.name()
            if name.startswith(SPAN_PREFIX) and e.device_type() != DeviceType.CPU:
                continue  # a benchmark span's shadow on the device's timeline
            if e.device_type() == DeviceType.CUDA:
                a = e.start_ns()
                b = a + e.duration_ns()
                device.append((a, b))
                k = kernels[name]
                k[0] += e.duration_ns() / 1e9
                k[1] += 1
            elif name == WINDOW_SPAN:
                window = (e.start_ns(), e.start_ns() + e.duration_ns())
            elif name.startswith(SPAN_PREFIX):
                host_spans.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                                   name[len(SPAN_PREFIX):]))
        if window is None:
            raise RuntimeError("the profile holds no window span")
        w0, w1 = window
        busy = _union([(max(a, w0), min(b, w1)) for a, b in device if b > w0 and a < w1])
        self.window_s = (w1 - w0) / 1e9
        self.busy_s = sum(b - a for a, b in busy) / 1e9
        self.kernels = dict(kernels)
        edges = [w0] + [x for ab in busy for x in ab] + [w1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        self.gaps = [(self._host_at(host_spans, (a + b) // 2), (b - a) / 1e9)
                     for a, b in gaps]

    @staticmethod
    def _host_at(host_spans, t: int) -> str:
        """The innermost benchmark span open on the host at ``t``."""
        open_ = [(b - a, name) for a, b, name in host_spans if a <= t < b]
        return "host:" + (min(open_)[1] if open_ else "outside any span")

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1][0])[:top]
        gaps = sorted(self.gaps, key=lambda g: -g[1])[:top]
        return {"device_ops": [[name[:160], v[0]] for name, v in ops],
                "idle_gaps": [[name, s] for name, s in gaps]}

    def kernel_time(self, *needles: str) -> Tuple[float, int]:
        """(seconds, launches) of the kernels whose name holds any needle."""
        s, n = 0.0, 0
        for name, (sec, cnt) in self.kernels.items():
            if any(x in name for x in needles):
                s += sec
                n += cnt
        return s, n


class TraceContext:
    """What a per-layer metric's reader gets: the cell's configuration and
    traffic, the window's work (``work``, from the loop, with what ran in
    the profiled sub-window), the spans' host times over the whole window,
    and the profiled sub-window (``profile``)."""

    def __init__(self, config: dict, traffic: dict, work: dict, spans: Spans,
                 profile: Optional[Profile]):
        self.config, self.traffic, self.work = config, traffic, work
        self.spans, self.profile = spans.times, profile
