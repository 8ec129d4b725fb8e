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

**The tracer** (off by default): spans on the host and stage timers on the
device, kept in memory, read by ``snapshot()``.

    profiling.tracing(True)          # or: with profiling.tracing(): ...
    engine.run(n_batches=64 * 32)
    snap = profiling.snapshot(engine)
    profiling.tracing(False)

A span (``Span``) is a name, a start and an end on ``time.perf_counter_ns``,
the span it ran inside and the dispatch it belongs to (the batch counter at
the dispatch's start). The engine's spans: ``iht.dispatch`` (a dispatch),
``iht.prologue`` (the counter fill and the state snapshot), ``iht.launch``
(the host inside one ``cudaGraphLaunch``) or ``iht.step`` (an eager batch),
``iht.read`` (the dispatch's host read), ``iht.overflow`` (an overflow's
restore and eager re-run), and inside an eager batch of the general path
``iht.layer`` (one scattering layer, its continuation left out). These are
recorded while the tracer is on, in a bounded ring; with it off a dispatch
pays one flag check. The set-up spans
``iht.setup.engine`` (``Engine.__init__``), ``iht.setup.library`` (the first
load of the kernel library, its build included), ``iht.calibrate`` and
``iht.capture`` (a batch's warm-up and capture) are recorded always, in a
ring of their own. While a torch profiler runs, every span also opens a
``record_function`` range of its name, on or off, so the profiler's timeline
names the program's spans.

Stage timers: with the tracer on, a batch on a CUDA device records timing
events at its stage boundaries (``stage``). On the kernel path: ``trace``
(the trace kernel and its pool tables), ``scatter`` (the block scatter with
the marker tail), ``sort`` (the sort with its pack and unpack), ``scan``
(the fused scan and extraction) and ``rest`` (everything between: the ray
base, the trace's sums, the accumulator update, the running sums). On the
general path: ``layer_trace.<li>`` (layer li's ray draws, pool sampler,
trace, gates and projection), ``continuation.<li>`` (the continuation into
layer li, its own sort included), then the fold's ``sort``, ``scan`` and
``rest``. A stage named ``family.<n>`` counts under ``family`` too. Captured,
they are nodes of the batch's graph (so the engine captures again when the
tracer is switched: ``Engine._graph_key``); with the tracer off the graph
has none. A dispatch records its last batch's stage seconds after its own
host read. While the tracer is on, a general-path batch also adds each
continuation's lanes into the engine's device counter beside its live rows
(``snapshot``: ``cont_live``, ``cont_lanes``), with no host read.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from typing import NamedTuple

import torch
import torch.autograd.profiler as _autograd_profiler
from torch.profiler import ProfilerActivity, profile, record_function, supported_activities


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
    from ice_halo_sim_tpu_torch.engine import graph as graph_mod

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


# ---------------------------------------------------------------------------
# The tracer
# ---------------------------------------------------------------------------

SPANS = 1 << 16          # spans the ring keeps by default (the newest)
SETUP_SPANS = 1 << 10    # set-up spans kept
STAGE_RECORDS = 1 << 14  # dispatches' stage times kept
END = "end"              # the last mark of a batch, which starts no stage


class Span(NamedTuple):
    """One span. start and end: time.perf_counter_ns; parent: the id of the
    span it ran inside (-1: none recorded); dispatch: the batch counter at
    the start of the dispatch it belongs to (-1: none)."""

    name: str
    start: int
    end: int
    parent: int
    dispatch: int
    id: int


class _Tracer:
    """The process's tracer (one, as ``kernels.build.LAUNCHES`` is one)."""

    def __init__(self):
        self.on = False
        self.spans = collections.deque(maxlen=SPANS)
        self.setup = collections.deque(maxlen=SETUP_SPANS)
        self.stages = collections.deque(maxlen=STAGE_RECORDS)
        self.ids = itertools.count()
        self.local = threading.local()

    def open(self) -> list:
        """This thread's open spans: (id, dispatch), the innermost last."""
        st = getattr(self.local, "open", None)
        if st is None:
            st = self.local.open = []
        return st


_T = _Tracer()


class tracing:
    """Turn the tracer on or off (``tracing(True)``); as a context manager
    (``with tracing(): ...``) it puts the previous state back at the end.
    `capacity`: the spans the ring keeps from now on (the newest)."""

    def __init__(self, on: bool = True, capacity: int | None = None):
        self.previous = _T.on
        if capacity is not None and capacity != _T.spans.maxlen:
            _T.spans = collections.deque(_T.spans, maxlen=int(capacity))
        _T.on = bool(on)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        _T.on = self.previous
        return False


def is_tracing() -> bool:
    """Whether the tracer is on (what the stage timers follow)."""
    return _T.on


def live() -> bool:
    """Whether a dispatch's spans are live: the tracer on, or a torch
    profiler running (torch's module flag)."""
    return _T.on or _autograd_profiler._is_profiler_enabled


class span(contextlib.ContextDecorator):
    """A span named `name` around a block (or, as a decorator, a call):
    recorded while the tracer is on, always when `setup`; a
    ``record_function`` range while a torch profiler runs. `dispatch`: the
    dispatch it opens (else its parent's)."""

    def __init__(self, name: str, dispatch: int | None = None, setup: bool = False):
        self.name = name
        self.dispatch = dispatch
        self.setup = setup

    def _recreate_cm(self):
        return span(self.name, self.dispatch, self.setup)

    def __enter__(self):
        self._range = None
        if _autograd_profiler._is_profiler_enabled:
            self._range = record_function(self.name)
            self._range.__enter__()
        self._frame = None
        if _T.on or self.setup:
            stack = _T.open()
            parent, dispatch = stack[-1] if stack else (-1, -1)
            if self.dispatch is not None:
                dispatch = int(self.dispatch)
            self._frame = (next(_T.ids), parent, dispatch)
            stack.append(self._frame[::2])
            self._start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self._frame is not None:
            end = time.perf_counter_ns()
            sid, parent, dispatch = self._frame
            _T.open().pop()
            (_T.setup if self.setup else _T.spans).append(
                Span(self.name, self._start, end, parent, dispatch, sid))
        if self._range is not None:
            self._range.__exit__(*exc)
        return False


_UNTRACED = contextlib.nullcontext()   # shared: it holds no state


def span_if(traced: bool, name: str):
    """``span(name)`` when `traced`, else a context that does nothing."""
    return span(name) if traced else _UNTRACED


def setup_span(name: str) -> span:
    """A set-up span: recorded whether the tracer is on or off."""
    return span(name, setup=True)


def stage(name: str) -> None:
    """Start stage `name` of the batch being timed on this thread (nothing
    when none is: the tracer off, the CPU, or not the kernel path)."""
    armed = getattr(_T.local, "armed", None)
    if armed is not None:
        device, marks = armed
        ev = torch.cuda.Event(enable_timing=True, external=True)
        ev.record(torch.cuda.current_stream(device))
        marks.append((name, ev))


@contextlib.contextmanager
def batch_stages(device):
    """Time the stages of the batch run in the block, which starts in stage
    ``rest``: yields its marks [(stage, event)], or None when the tracer is
    off or `device` is no CUDA device."""
    if not _T.on or device.type != "cuda":
        yield None
        return
    marks = []
    _T.local.armed = (device, marks)
    try:
        stage("rest")
        yield marks
        stage(END)
    finally:
        _T.local.armed = None


def record_stages(marks, synced: bool) -> None:
    """Record a batch's stage seconds for the dispatch open on this thread,
    once its marks have run: `synced` when the host has read since they were
    launched, else this waits on the last one. Nothing while the tracer is
    off."""
    if not _T.on or not marks or marks[-1][0] != END:
        return
    if not synced:
        marks[-1][1].synchronize()
    seconds = {}
    for (name, a), (_, b) in zip(marks, marks[1:]):
        dt = a.elapsed_time(b) * 1e-3
        family = name.split(".")[0]
        seconds[family] = seconds.get(family, 0.0) + dt
        if family != name:
            seconds[name] = seconds.get(name, 0.0) + dt
    stack = _T.open()
    _T.stages.append((stack[-1][1] if stack else -1, seconds))


def snapshot(*engines) -> dict:
    """What the tracer holds, and the port's counters as they stand:
    ``spans`` (every Span kept, set-up spans included, by start),
    ``stages`` [(dispatch, {stage: seconds})], ``capacity`` (of the ring:
    a ring this full has let older spans go), ``launches``
    (``kernels.build.LAUNCHES``), ``build_seconds``, and per engine given
    its ``host_syncs``, ``overflow_replays``, ``batch_counter``, per layer
    ``layer_epilogue`` (the epilogue its last general-path batch took:
    "kernel", KL's emit mode, or "plain: <reason>") and, per layer
    boundary, ``cont_live`` (live continuation rows, summed over every
    batch) and ``cont_lanes`` (the lanes offered, summed over the batches
    run while traced): a host read of each engine's counters."""
    from ice_halo_sim_tpu_torch.kernels import build

    spans = sorted(list(_T.spans) + list(_T.setup), key=lambda s: s.start)
    return {"spans": spans, "stages": list(_T.stages), "capacity": _T.spans.maxlen,
            "launches": dict(build.LAUNCHES),
            "build_seconds": build.build_seconds,
            "engines": [{"host_syncs": e.host_syncs, "overflow_replays": e.overflow_replays,
                         "batch_counter": e.batch_counter,
                         "layer_epilogue": list(e.layer_epilogue),
                         "cont_live": e._dev.cont.tolist(),
                         "cont_lanes": e._dev.lanes.tolist()} for e in engines]}
