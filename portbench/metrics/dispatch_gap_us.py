"""dispatch_gap_us (program span, us a dispatch): the host's turnaround
between two dispatches, in which the device has nothing queued: from the end
of dispatch i's last ``iht.read`` (its one host read) to the end of dispatch
i + 1's first ``iht.launch`` (the first batch queued), the median over the
consecutive pairs of the stretch of ``_program``."""

from portbench.metrics import _program
from portbench.metrics._program import measure  # noqa: F401


def read(ctx):
    rec = _program.record(ctx)
    if rec is None:
        return None
    gaps = []
    stretch = _program.stretch(rec)
    for (_a, before), (_b, after) in zip(stretch, stretch[1:]):
        reads = [s.end for s in before if s.name == "iht.read"]
        launches = [s.end for s in after if s.name == "iht.launch"]
        if reads and launches:
            gaps.append(min(launches) - max(reads))
    ns = _program.median(rec, gaps, "pair of iht.read and iht.launch spans")
    return None if ns is None else ns * 1e-3
