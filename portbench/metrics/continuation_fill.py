"""continuation_fill (program counter, fraction): the live continuation
rows over the lanes the next layer traced for them, summed over the layer
boundaries and the batches of the stretch of ``_general`` (the port's
device counters, read before and after it). The lanes left empty are traced
all the same; a fill near 1 leaves the continuation no room, and an
overflowing batch is run again (``overflow_replays``)."""

from portbench.metrics import _general
from portbench.metrics._general import measure  # noqa: F401


def read(ctx):
    rec = _general.record(ctx)
    if rec is None:
        return None
    (live0, lanes0), (live1, lanes1) = rec["counters"]
    lanes = sum(lanes1) - sum(lanes0)
    if not lanes > 0:
        if rec["card"]:
            raise RuntimeError("continuation_fill: no continuation lanes counted on the card")
        return None
    return (sum(live1) - sum(live0)) / lanes
