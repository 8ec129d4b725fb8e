"""One module per entry point of the port that a cell drives, found by the
workload's ``"driver"`` key (``"engine"`` when it has none), as a
reference is found by its ``"reference"`` key.

A driver holds ``run(job) -> Outcome``: the set-up, the measured window,
with ``job.trace`` the profiled stretch and what the per-layer readers
measure while the program lives, then the check. ``run.py`` turns the
outcome into the result line. A driver never imports ``portbench.run``:
that module runs as ``__main__``, and a second import would start its
clock again.
"""

from __future__ import annotations

import subprocess
import sys
from types import SimpleNamespace
from typing import NamedTuple


class Job(NamedTuple):
    """One run of one cell. ``wl``: the workload file; ``doc``: the
    configuration's scene at the cell's resolution; ``readers``: {metric:
    its module} of the metrics this run reports; ``t0``: the process's
    start on ``time.perf_counter``, where ``setup_s`` begins; ``test``:
    what the CPU tests hand the driver (its docstring says which)."""

    cell: str
    wl: dict
    doc: dict
    seed: int
    seconds: float
    trace: bool
    control: bool
    device: str
    readers: dict
    t0: float
    test: dict


class Outcome(NamedTuple):
    """What a run gave: ``ctx`` (what the readers read), ``checks``
    {name: (value, limit)}, ``failed`` (of the ``ctx.attempted`` units:
    ``correct`` needs none), ``device`` (the result line's, without the
    profile's seconds)."""

    ctx: "Ctx"
    checks: dict
    failed: int
    device: dict


class Ctx(SimpleNamespace):
    """What a metric reads: ``attempted`` (the window's units of work),
    ``window`` (the driver's record of it), ``setup_s``, ``profile`` (a
    ``profiler.Window`` or None), ``profile_batches``, ``scene`` (the
    reference's), ``reference`` (its traced batches and live contribution
    rows per render), ``stash`` (what a metric's ``measure`` left). The
    engine driver's window: wall_s, rays, batches, dispatch_s,
    overflow_replays, host_syncs; the server driver's: its docstring."""


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def card() -> dict:
    """The card as nvidia-smi reads it: name, power limit, SM clock, power
    draw, temperature (empty where it cannot be read)."""
    keys = ("name", "power.limit", "clocks.sm", "power.draw", "temperature.gpu")
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={','.join(keys)}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip().splitlines()[0]
        return dict(zip(keys, (v.strip() for v in out.split(","))))
    except (OSError, IndexError, subprocess.SubprocessError):
        return {}
