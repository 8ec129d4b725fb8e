"""sort_us (program span, us a batch): the device time of the fold's sort
stage in a captured batch (the port's stage timers: CUDA events at the
stage's bounds inside the graph; both sorts of ``core/accum.py`` with their
pack and unpack), the median over the stretch of ``_program`` of each
dispatch's last batch."""

from portbench.metrics import _program
from portbench.metrics._program import measure  # noqa: F401


def read(ctx):
    rec = _program.record(ctx)
    if rec is None:
        return None
    ids = {d for d, _spans in _program.stretch(rec)}
    s = [st["sort"] for d, st in rec["snapshot"]["stages"] if d in ids and "sort" in st]
    sec = _program.median(rec, s, "sort stage time")
    return None if sec is None else sec * 1e6
