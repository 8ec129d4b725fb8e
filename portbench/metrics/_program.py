"""What the port's own spans and stage timers say (its
``utils/profiling.py``), for the readers ``graph_launch_us``,
``dispatch_gap_us``, ``sort_us`` and ``setup_program_s``.

``measure(engine, ctx)``, in a traced run after the profiled window (once
for the four): the port's tracer on, one dispatch that captures the batch
again (with its stage timers) and ``DISPATCHES`` more, each of the engine's
``steps_per_dispatch`` batches, back to back; the tracer back off; then
``profiling.snapshot(engine)`` in ``ctx.stash``. A program without the
tracer stashes nothing, and the readers return None.

The stretch: the dispatches that began after the tracer went on and hold no
capture. A reader whose spans are missing from it fails the run on a CUDA
device, and returns None elsewhere (the CPU's eager batches have no graph
launch and no stage timer).
"""

from __future__ import annotations

import statistics
import time

DISPATCHES = 32
KEY = "program"


def measure(engine, ctx):
    if KEY in ctx.stash:
        return
    ctx.stash[KEY] = None
    from ice_halo_sim_tpu_torch.utils import profiling

    if not hasattr(profiling, "tracing"):
        return
    import torch

    card = engine.device.type == "cuda"
    since = time.perf_counter_ns()
    with profiling.tracing(True):
        for _ in range(1 + DISPATCHES):
            engine.run(n_batches=engine.steps_per_dispatch)
        if card:
            torch.cuda.synchronize(engine.device)
    ctx.stash[KEY] = {"snapshot": profiling.snapshot(engine), "since": since, "card": card}


def record(ctx):
    """The stash ``measure`` left, or None."""
    return ctx.stash.get(KEY)


def stretch(rec) -> list:
    """[(dispatch id, its spans by start)] of the stretch, in order."""
    by = {}
    for s in rec["snapshot"]["spans"]:
        if s.dispatch >= 0 and s.start >= rec["since"]:
            by.setdefault(s.dispatch, []).append(s)
    return [(d, spans) for d, spans in sorted(by.items())
            if any(s.name == "iht.dispatch" for s in spans)
            and not any(s.name == "iht.capture" for s in spans)]


def median(rec, values, what: str):
    """The median of `values`; where there are none, a failed run on a
    CUDA device and None elsewhere."""
    if values:
        return statistics.median(values)
    if rec["card"]:
        raise RuntimeError(f"the port's tracer recorded no {what} in "
                           f"{DISPATCHES} dispatches on the card")
    return None
