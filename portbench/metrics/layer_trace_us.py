"""layer_trace_us (program span, us a batch): the device time of the
general path's layer stages in a captured batch (the port's stage timers
``layer_trace.<li>``, summed over the layers: each layer's ray draws, pool
sampler, trace, probability and emit-floor gates, slot cap and projection),
the median over the stretch of ``_general`` of each dispatch's last
batch."""

from portbench.metrics import _general
from portbench.metrics._general import measure  # noqa: F401


def read(ctx):
    sec = _general.stage_seconds(ctx, "layer_trace")
    return None if sec is None else sec * 1e6
