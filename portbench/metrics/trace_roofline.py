"""trace_roofline (device trace, %): the least time of the trace work of a
batch's root rays on the H100 (``_peaks``), over the trace kernel's device
time per batch.

The work is counted from the cell's configuration through the reference's
plan (``reference/scene.py``), never from the port's: ``trace_work`` below
is a copy of ``chip_smoke.py``'s per-operation count of one trace_emit
call, which counts every ray of the plan through every loop (nothing in it
depends on the data).

The stage's device time: the trace kernel's own time (``KERNEL``, the
port's name for it) inside the profiled window of graph replays. A window
without it fails the run.
"""

from __future__ import annotations

from portbench.metrics._peaks import least_seconds

# The port's names that this reader needs.
KERNEL = "trace_emit_kernel<"   # csrc/trace_emit.cu: K2 and K2b, in the name


def trace_work(plan):
    """(bytes, arithmetic operations, special-function operations) of one
    trace_emit call, counted from the plan's loops (every ray runs every
    loop to its end: nothing here depends on the data).

    Units per ray. U = 24: one uniform draw (two PCG hashes of 9 integer
    operations, the index mix, the convert and scale). A float division or
    square root counts 1 special-function operation (rcp/rsqrt) plus 8
    arithmetic ones (its Newton steps); a lone sin, cos or log counts 20
    arithmetic ones (range reduction and polynomial), a sine and cosine of
    one angle (sincosf) 30. With multiply-add contraction off, every
    multiply and add is one operation.
      set-up: epoch seed 12, wavelength U + 6, refractive index 12 + 5
        div/sqrt, sun cap 2 U + 20 + 1 sqrt + 1 sincos;
      orientation: 5 U, the latitude path (inverse-CDF table: 5 per node
        + 12 + 2 div and 3 sincos; uniform: about 30 + 1 sqrt and 2
        sincos), rotation 22, its inverse apply 15;
      entry: 16 per triangle row (two passes of a dot, max, add and the
        CDF compare), 3 U, point 12, plane distances 7 per face slot;
      Fresnel split (entry and every bounce): 42 + 7 div/sqrt;
      bounce (max_hits - 1): per face slot 15 + 1 div and 2 for the
        distance update (the function's need, with the denominators held;
        the kernel recomputes them, which is its own cost); exit cosine 5,
        rotation 15, state selects 8;
      emit slot (max_hits): segment 2, roulette U + 4 when the floor is
        on, gate U + 2 when prob > 0; per render: a dual fisheye pass 16 +
        2 div/sqrt (two passes with the overlap band), a single lens or
        globe 20 + 18 camera rotation + 2 div/sqrt.
    The pack in the kernel is counted by its bytes only: a stable compaction
    needs no arithmetic beyond moving each row once.
    Bytes: each render's packed rows written once (8 per row of rows_block,
    the tail included) and its counts, the tables read once."""
    from portbench.reference.plain.core import sampling
    from portbench.reference.plain.core.latlut import N_NODES

    U, DS, SINCOS = 24, 8, 30
    n_tris = plan.n_tris if plan.pool_k else len(plan.tris)
    ops = 12 + (U + 6) + 12 + 5 * DS + 2 * U + 20 + DS + SINCOS
    sfu = 5 + 1
    lut = int(plan.axis_params.lat_path[0]) == sampling.LAT_LUT_INVERSE_CDF
    ops += 5 * U + (5 * N_NODES + 12 + 2 * DS + 3 * SINCOS if lut else 30 + DS + 2 * SINCOS)
    ops += 22 + 15
    sfu += 2 if lut else 1
    ops += 16 * n_tris + 3 * U + 12 + 7 * plan.nf
    fres_ops, fres_sfu = 42 + 7 * DS, 7
    bounce_ops = plan.nf * (15 + DS + 2) + fres_ops + 5 + 15 + 8
    bounce_sfu = plan.nf + fres_sfu
    ops += fres_ops + (plan.h - 1) * bounce_ops
    sfu += fres_sfu + (plan.h - 1) * bounce_sfu
    slot_ops = 2 + (U + 4 if plan.emit_frac > 0 else 0) + (U + 2 if plan.prob > 0 else 0)
    slot_sfu = 0
    for pp in plan.renders:
        if pp.lens_type in (4, 9):
            passes = 2 if pp.max_abs_dz > 0 else 1
            slot_ops += passes * (16 + 2 * DS)
            slot_sfu += passes * 2
        else:
            slot_ops += 20 + 18 + 2 * DS
            slot_sfu += 2
    ops += plan.h * slot_ops
    sfu += plan.h * slot_sfu
    rows = plan.n_blocks * sum(plan.rows_block)
    nbytes = 8 * rows + 4 * plan.n_blocks * len(plan.renders) + 4 * plan.ftab()[0].size
    if plan.pool_k:
        nbytes += 4 * plan.pool_k * (plan.nf * 5 + plan.n_tris * 13)
    return nbytes, ops * plan.batch, sfu * plan.batch


def stage_seconds(ctx):
    """The trace kernel's device seconds per batch in the profiled window;
    a window without it fails the run."""
    s = ctx.profile.device_seconds(lambda name: KERNEL in name)
    if not s > 0:
        raise RuntimeError(f"trace_roofline: no {KERNEL}...> operation in the profiled window")
    return s / ctx.profile_batches


def read(ctx):
    if ctx.profile is None:
        return None
    least, _by = least_seconds(*trace_work(ctx.scene._trace_plan))
    return 100.0 * least / stage_seconds(ctx)
