"""continuation_us (program span, us a batch): the device time of the
general path's continuations in a captured batch (the port's stage timers
``continuation.<li>``: the continuing exits keyed, each block sorted and
packed into the next layer's lanes, the dropped weight), the median over
the stretch of ``_general`` of each dispatch's last batch. Its sort is its
own: the fold's ``sort`` stage does not hold it."""

from portbench.metrics import _general
from portbench.metrics._general import measure  # noqa: F401


def read(ctx):
    sec = _general.stage_seconds(ctx, "continuation")
    return None if sec is None else sec * 1e6
