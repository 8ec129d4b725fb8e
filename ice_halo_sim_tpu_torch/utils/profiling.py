"""The port's one door to torch.profiler.

Every window in which the port reads device time from the profiler opens
here: ``chip_smoke.py``'s kernel and busy-time windows, ``probe_sandwich``'s
``device_ms``, ``profile_slice.py`` and ``grad_validation.time_modes``.

    with device_profile(warm=fn) as win:
        fn()
        torch.cuda.synchronize()
    win.device_us, win.kernels, win.rows

**Captured graphs are captured again just before a window.** On an H100
(torch 2.11, CUDA 12.8, NVIDIA 580.159.03) the first window over the
engines' CUDA-graph replays crashed the process inside ``cudaGraphLaunch``
(a segmentation fault below PyTorch, in CUPTI or the CUDA stack) in about
half of the runs of ``chip_smoke.py`` cut after [4]'s first fold verdict,
when the graphs it replayed had been captured earlier in the run; the same
run with those graphs captured anew just before the window never crashed
(``python -m ice_halo_sim_tpu_torch.probe_profiler`` repeats every
experiment; PERF.md section 7 has the counts). So every window first makes
the graphs captured before it stale (``engine.graph.invalidate``: their
owners capture again at their next call), then makes the caller's `warm`
call outside the profiler: the graphs that call replays are captured
there, and the window replays those.

A window that recorded no device event says so: its ``device_us`` is 0 and
``empty`` is true, and the caller counts it. On the CPU (no CUDA activity
to trace) a window traces the CPU and records no device time, as it
should.
"""

from __future__ import annotations

import contextlib

import torch
from torch.profiler import ProfilerActivity, profile, supported_activities

from ice_halo_sim_tpu_torch.engine import graph as graph_mod


class Window:
    """What one window recorded. ``rows``: (device us, count, name) per
    operation that took device time, the largest first (kernels, copies
    and memsets, those a CUDA graph replays included)."""

    def __init__(self):
        self.rows = []

    @property
    def device_us(self) -> float:
        return sum(r[0] for r in self.rows)

    @property
    def kernels(self) -> int:
        return sum(r[1] for r in self.rows)

    @property
    def empty(self) -> bool:
        return not self.rows

    def top(self, n: int = 5) -> list:
        """The n operations that took the most device time: (name, us)."""
        return [(key, us) for us, _, key in self.rows[:n]]


def _device_rows(events) -> list:
    rows = []
    for e in events:
        if not str(e.device_type).endswith("CUDA"):
            continue  # CPU operations: their kernels are listed as CUDA events
        us = e.self_device_time_total
        if us > 0:
            rows.append((us, e.count, e.key))
    rows.sort(key=lambda r: (-r[0], r[2]))
    return rows


@contextlib.contextmanager
def device_profile(warm=None):
    """One torch.profiler window over the block's device activity (the
    CPU's where no CUDA activity can be traced); yields a Window, filled
    when the block ends. Every graph captured before it is made stale
    first; then `warm` is called (and the card synchronised) outside the
    window, capturing anew every graph the block will replay: give it the
    block's own call wherever the block replays a captured graph."""
    graph_mod.invalidate()
    if warm is not None:
        warm()
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
    have = supported_activities()
    activities = [ProfilerActivity.CUDA if ProfilerActivity.CUDA in have
                  else ProfilerActivity.CPU]
    win = Window()
    with profile(activities=activities) as prof:
        yield win
    win.rows = _device_rows(prof.key_averages())
