"""fold_roofline (device trace, %): the fold's least time on the H100 over
its device time per batch.

Least time: the bytes the fold needs, by ``chip_smoke.py``'s rule for a
kernel's bound (``_peaks.least_seconds``): each live contribution row's key
and weight read once (8 bytes) and each pixel's marker key and XYZ written
once (16 bytes), per render. The live rows depend on the data: they are the
reference's own, on the same seed, their mean per batch over the batches
it traced.

Fold time: the device busy time per batch of the profiled window of graph
replays less the trace kernel's (``trace_roofline.stage_seconds``), as
``profile_slice.py`` names it ("the folds are the rest": the compaction,
the sort, the scan and extraction, the block scatter, and the torch glue
between them). A run where that difference is not positive fails.
"""

from portbench.metrics import trace_roofline
from portbench.metrics._peaks import least_seconds


def read(ctx):
    p, ref = ctx.profile, ctx.reference
    if p is None:
        return None
    fold = p.busy_s() / ctx.profile_batches - trace_roofline.stage_seconds(ctx)
    if not fold > 0 or not ref["batches"]:
        raise RuntimeError(f"fold_roofline: fold time {fold} s a batch over "
                           f"{ref['batches']} reference batches")
    nbytes = sum(8.0 * n / ref["batches"] + 16.0 * pp.height * pp.width
                 for n, pp in zip(ref["live_rows"], ctx.scene.proj_plans))
    least, _by = least_seconds(nbytes)
    return 100.0 * least / fold
