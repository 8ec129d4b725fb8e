"""The benchmark's profiler window over the device, and what it reads.

A window is opened as the port opens its own (``utils/profiling.py``
``device_profile``), and for the same reason: on the H100 the first
torch.profiler window over CUDA-graph replays crashed inside
``cudaGraphLaunch`` when the graphs had been captured earlier in the
process, and never when they were captured just before the window. So
the port's graphs are made stale first (``engine.graph.invalidate``: their
owners capture again at their next call) and the caller's `warm` call
captures them anew, outside the window. The window is the benchmark's own,
not the port's helper, because it needs the timeline (the idle gaps and
what the host did in them), which the helper does not keep, and because a
yardstick must not move when the program does.

A window that records no device operation is opened again, twice at most;
then the run fails. It never yields an empty reading or a CUDA-event time
in its place.
"""

from __future__ import annotations

import time
from typing import NamedTuple

RETRIES = 2


class Span(NamedTuple):
    name: str
    start: float   # microseconds on the profiler's clock
    end: float


class Window(NamedTuple):
    """One profiled window: every device operation (kernels, copies and
    memsets, those a CUDA graph replays included), every host span (the
    benchmark's own and torch's), and the window's length on the host."""

    device: list   # [Span]
    host: list     # [Span]
    wall_s: float
    first: float   # the window's start and end on the profiler's clock
    last: float

    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device."""
        total, end = 0.0, float("-inf")
        for s in sorted(self.device, key=lambda s: s.start):
            if s.end <= end:
                continue
            total += s.end - max(s.start, end)
            end = s.end
        return total * 1e-6

    def device_span_s(self) -> float:
        """Seconds from the window's first device operation's start to its
        last one's end, on the device's timeline."""
        return (max(s.end for s in self.device) - min(s.start for s in self.device)) * 1e-6

    def device_seconds(self, match=None) -> float:
        """Device seconds of the operations whose name `match` accepts (all)."""
        return sum(s.end - s.start for s in self.device
                   if match is None or match(s.name)) * 1e-6

    def top_ops(self, n: int = 10) -> list:
        """[name, seconds] of the n operation names that took the most
        device time in the window."""
        by = {}
        for s in self.device:
            by[s.name] = by.get(s.name, 0.0) + (s.end - s.start) * 1e-6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list:
        """[what the host was doing, seconds] of the n longest stretches of
        the window in which nothing ran on the device. The host's doing is
        the chain of host spans that covers the middle of the gap, outermost
        first ("outside every span" where none does)."""
        gaps = []
        t = self.first
        for s in sorted(self.device, key=lambda s: s.start):
            if s.start > t:
                gaps.append((t, s.start))
            t = max(t, s.end)
        if self.last > t:
            gaps.append((t, self.last))
        out = []
        for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:n]:
            mid = 0.5 * (a + b)
            cover = sorted((h for h in self.host if h.start <= mid <= h.end),
                           key=lambda h: (h.start, -h.end))
            what = " > ".join(h.name for h in cover) or "outside every span"
            out.append([what, (b - a) * 1e-6])
        return out


def window(body, warm=None, label: str = "portbench.window") -> Window:
    """Profile `body()` (which the caller makes end with the device idle):
    the port's graphs made stale and `warm()` called first, outside the
    window. Retried on an empty window, then RuntimeError."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from ice_halo_sim_tpu_torch.engine import graph as graph_mod

    invalidate = getattr(graph_mod, "invalidate", None)
    for _ in range(1 + RETRIES):
        if invalidate is not None:
            invalidate()
        if warm is not None:
            warm()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            with record_function(label):
                body()
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        device, host = [], []
        first = last = None
        for e in prof.events():
            span = Span(e.name, float(e.time_range.start), float(e.time_range.end))
            if e.device_type == DeviceType.CUDA:
                # A host span's record on the device's timeline is no operation.
                if not (e.name.startswith("portbench.")
                        or getattr(e, "is_user_annotation", False)):
                    device.append(span)
            else:
                host.append(span)
                if e.name == label:
                    first, last = span.start, span.end
        if device and first is not None:
            return Window(device, host, wall, first, last)
    raise RuntimeError(f"the profiler recorded no device operation in {1 + RETRIES} windows")
