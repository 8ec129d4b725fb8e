"""graph_launch_us (program span, us a launch): the median host time inside
one ``cudaGraphLaunch`` of the captured batch (the port's ``iht.launch``
span, around ``graph.replay()``) over the stretch of ``_program``. The
device waits there when it has nothing queued."""

from portbench.metrics import _program
from portbench.metrics._program import measure  # noqa: F401


def read(ctx):
    rec = _program.record(ctx)
    if rec is None:
        return None
    ns = [s.end - s.start for _d, spans in _program.stretch(rec) for s in spans
          if s.name == "iht.launch"]
    us = _program.median(rec, ns, "iht.launch span")
    return None if us is None else us * 1e-3
