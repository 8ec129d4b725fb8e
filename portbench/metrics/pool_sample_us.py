"""pool_sample_us (program span, us a batch): the device time of the general
path's crystal pool samplers in a captured batch (the port's stage timers
``layer_trace.<li>.pool``, inside ``layer_trace.<li>``: each layer's shapes
drawn and built, their faces and entry triangles), summed over the layers
in each dispatch's last batch, the median over the stretch of
``_general``.

A program whose snapshot has no ``pool_shapes`` has no pool stage timers:
the reader returns None there and does not raise; one that has them and
recorded none on the card fails the run.
"""

import statistics

from portbench.metrics import _general, _program
from portbench.metrics._general import measure  # noqa: F401

SUFFIX = ".pool"


def read(ctx):
    rec = _general.record(ctx)
    if rec is None or "pool_shapes" not in rec["snapshot"]["engines"][0]:
        return None
    ids = {d for d, _spans in _program.stretch(rec)}
    per_batch = [sum(v for k, v in st.items() if k.endswith(SUFFIX))
                 for d, st in rec["snapshot"]["stages"]
                 if d in ids and any(k.endswith(SUFFIX) for k in st)]
    if per_batch:
        return statistics.median(per_batch) * 1e6
    if rec["card"]:
        raise RuntimeError(f"the port recorded no pool stage in {_general.DISPATCHES} "
                           f"dispatches on the card")
    return None
