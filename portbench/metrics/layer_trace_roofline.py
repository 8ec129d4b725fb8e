"""layer_trace_roofline (program span, %): the least time of a batch's
layer trace work on the H100 (``_peaks``), over the general path's
``layer_trace`` stage time per batch (``layer_trace_us``'s reading).

The work is counted from the cell's configuration through the reference's
plan (``reference/two_layer.py``), never from the port's, with
``trace_roofline.trace_work``'s per-lane count of the trace kernel's loops:
  - layer 1 over its B root-ray lanes, every later layer over the
    reference's own live continuation rows into it (their mean per batch
    over the batches it traced): the least lanes any implementation
    traces, not the port's padded lanes;
  - a layer's crystal as the entry triangles of nonzero area and the face
    slots of its first pool shape;
  - a layer that continues every exit (prob 1, not the last) emits
    nothing: no emit floor and no projection; a continued lane draws no
    wavelength and no sun direction (``SUN_WL`` below is that part of
    trace_work's set-up);
  - bytes: every live emitted row's key and weight written once (8 bytes),
    every live continuation row's weight, pool index and direction written
    and read once (40 bytes).
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np

from portbench.metrics import _general
from portbench.metrics._peaks import least_seconds
from portbench.metrics.trace_roofline import trace_work

# trace_work's set-up draws a continued lane does not make: the wavelength
# (U + 6) and the sun cap (2 U + 20, a square root, a sincos), with U = 24,
# a square root 8 + 1 special-function operation, a sincos 30.
SUN_WL = (24 + 6 + 2 * 24 + 20 + 8 + 30, 1)


def lane_work(scene, li: int):
    """(operations, special-function operations) of one lane of layer li."""
    layer = scene.layers[li]
    pool = scene._pool(0, li, layer)
    last = li == len(scene.layers) - 1
    emits = last or layer.prob < 1.0
    tris = int((pool.tri_cross_half[0].abs().sum(dim=-1) > 0).sum())
    plan = SimpleNamespace(
        pool_k=0, tris=range(tris), axis_params=layer.axis_params,
        nf=int(pool.face_present[0].sum()), h=scene.max_hits,
        emit_frac=scene.min_emit_frac if emits else 0.0,
        prob=0.0 if last else layer.prob,
        renders=scene.proj_plans if emits else [],
        n_blocks=0, rows_block=[0], ftab=lambda: (np.zeros(0),), batch=1)
    _bytes, ops, sfu = trace_work(plan)
    if li > 0:
        ops, sfu = ops - SUN_WL[0], sfu - SUN_WL[1]
    return ops, sfu


def batch_work(scene, ref) -> tuple:
    """(bytes, operations, special-function operations) of a batch's layer
    trace, from the reference's record."""
    batches = sorted(scene.cont_live)
    if not batches or not ref["batches"]:
        raise RuntimeError("layer_trace_roofline: the reference traced no batch")
    lanes = [float(scene.batch_size)] + [
        float(np.mean([scene.cont_live[c][i] for c in batches]))
        for i in range(len(scene.layers) - 1)]
    ops = sfu = 0.0
    for li, n in enumerate(lanes):
        o, s = lane_work(scene, li)
        ops += o * n
        sfu += s * n
    nbytes = 8.0 * sum(ref["live_rows"]) / ref["batches"] + 40.0 * sum(lanes[1:])
    return nbytes, ops, sfu


def read(ctx):
    sec = _general.stage_seconds(ctx, "layer_trace")
    if sec is None:
        return None
    least, _by = least_seconds(*batch_work(ctx.scene, ctx.reference))
    return 100.0 * least / sec
