"""What the port's stage timers and continuation counters say of its
general trace path (``utils/profiling.py``), for the readers
``layer_trace_us``, ``continuation_us``, ``layer_trace_roofline`` and
``continuation_fill``.

``measure(engine, ctx)``, in a traced run after the profiled window (once
for the four): the port's tracer on, one dispatch of ``BATCHES`` batches
that captures the batch again (with its stage timers and its counter of
continuation lanes), then ``DISPATCHES`` more of ``BATCHES`` batches each,
back to back; the tracer back off; then ``profiling.snapshot(engine)``,
with the engine's continuation counters read after the first dispatch and
at the end, in ``ctx.stash``. A general-path batch is some 3500 device
operations, a hundred times a light batch's time, so the stretch holds
``DISPATCHES`` dispatches of ``BATCHES`` batches, not ``_program``'s 32 of
64; each dispatch records its last batch's stage times.

The stretch: the dispatches that began after the first one and hold no
capture (``_program.stretch``). A program whose snapshot has no
continuation counters (``cont_lanes``) has no general-path stage timers
either: the readers return None there and do not raise. A program that has
them and recorded none on the card fails the run.
"""

from __future__ import annotations

import statistics
import time

from portbench.metrics import _program

DISPATCHES = 8
BATCHES = 8
KEY = "general"


def _counters(engine):
    from ice_halo_sim_tpu_torch.utils import profiling

    e = profiling.snapshot(engine)["engines"][0]
    return (e["cont_live"], e["cont_lanes"]) if "cont_lanes" in e else None


def measure(engine, ctx):
    if KEY in ctx.stash:
        return
    ctx.stash[KEY] = None
    from ice_halo_sim_tpu_torch.utils import profiling

    if not hasattr(profiling, "tracing"):
        return
    import torch

    card = engine.device.type == "cuda"
    with profiling.tracing(True):
        engine.run(n_batches=BATCHES)
        before = _counters(engine)
        since = time.perf_counter_ns()
        for _ in range(DISPATCHES):
            engine.run(n_batches=BATCHES)
        if card:
            torch.cuda.synchronize(engine.device)
        after = _counters(engine)
    ctx.stash[KEY] = {"snapshot": profiling.snapshot(engine), "since": since, "card": card,
                      "counters": None if before is None else (before, after)}


def record(ctx):
    """The stash ``measure`` left where the program has the general path's
    instrumentation, else None."""
    rec = ctx.stash.get(KEY)
    return rec if rec is not None and rec["counters"] is not None else None


def stage_seconds(ctx, stage: str):
    """The median over the stretch of stage `stage`'s seconds in a
    dispatch's last batch; None where the program has no such timers (or
    off the card), and a failed run where it has them on the card and
    recorded none."""
    rec = record(ctx)
    if rec is None:
        return None
    ids = {d for d, _spans in _program.stretch(rec)}
    s = [st[stage] for d, st in rec["snapshot"]["stages"] if d in ids and stage in st]
    if s:
        return statistics.median(s)
    if rec["card"]:
        raise RuntimeError(f"the port recorded no {stage} stage in {DISPATCHES} dispatches "
                           f"on the card")
    return None
