#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises; the exit code is then non-zero):
  1. device: a CUDA device must be present; prints the card's name and
     power limit (nvidia-smi);
  2. build: compiles the port's CUDA kernels from csrc/ (nvcc, ctypes) and
     prints the trace and sandwich kernels' register and spill reports;
  3. kernels: each kernel against its plain PyTorch twin on the card, at
     the main paths' shapes, with its error, both device times per call
     (torch.profiler) and its bound (the least time the card could take).
     The static trace kernel and the block and scan kernels run at
     BENCH_CFG's shapes (batch 229376 = 112 x 2048 rays, P = 131072
     pixels, K = 64); the blocked-pool trace kernel at POOL_CFG's (the same
     batch as 1792 sampled pyramids, NF = 20 face slots, two renders); the
     fold prepass (pack_valid_blocks with one column, and scatter_blocks
     after it) at the rows of MS_CFG's dual render, and pack_valid_blocks
     with two columns at COLOR_CFG's; the sandwich kernels (K7 lane, K8
     sublane) at the one-channel count pass of the calibration batch (the
     raw rows of MS_CFG's dual render over all 1024 chunks) and, printed as
     extra lines, at the raw rows against the 256 chunks that hold most of
     them, plain and two-term; the probe forms P1 and P2 at their probes'
     shapes. The entries of K7 and K8 in the kernels line are taken after
     the ms-sandwich slice of [4] has calibrated: one steady batch's rows go
     through every level of both renders' cascades as the engine routes
     them (compacted to the level's keep, decoded, misses onward), and at
     each (rows, chunk list) pair the kernel is held against its plain
     version and timed beside it and beside index_add_ on the same rows;
  4. slices: Engine(cfg, device="cuda") renders BENCH_CFG and POOL_CFG (the
     trace kernel path), then MS_CFG and COLOR_CFG (the general trace
     path), each with the launch counters reset just before and read just
     after; every kernel of the path must have launched, on its steady
     batches too; image, lanes and stats must match kernels="plain" on the
     card; each fixture configuration must match its committed JAX render
     (tests/data/torch_port_*_ref.npz) within the CPU tests' tolerances;
     and BENCH_CFG through the general path must match the kernel path
     (emit floor and slot cap off). These engines fold by sort
     (IHT_FOLD=sort), as the JAX fixtures were. Then MS_CFG under
     IHT_FOLD=sandwich (slice ms-sandwich): one calibration batch and
     three steady ones, K7 launched on every steady batch, held against
     kernels="plain" on the card and against the sort fold of the ms slice;
     the same through K8; MS_CFG and BENCH_CFG (general path) under
     IHT_FOLD=auto with the dispatch's decision and modeled costs; and the
     two probes' own main paths (P1, P2);
  5. steady rays/s of the five slices (informational).

The last lines of standard output are the kernels JSON object, the card
(nvidia-smi) and the device JSON object. Imports nothing of JAX and
nothing of the JAX package.
"""

from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
BATCH = 112 * 2048
FIXTURES = {
    "bench": os.path.join(ROOT, "tests", "data", "torch_port_bench_ref.npz"),
    "pool": os.path.join(ROOT, "tests", "data", "torch_port_pool_ref.npz"),
    "ms": os.path.join(ROOT, "tests", "data", "torch_port_ms_ref.npz"),
}

# Tolerances (shared with tests/test_torch_engine.py for the fixtures).
IMG_RTOL, IMG_ATOL_FRAC = 1e-4, 1e-6   # per pixel, atol = frac * image max
SUM_RTOL = 1e-5                        # image sum and landed weight
SCAN_RTOL = 1e-6                       # K4 kernel vs twin: both sum in f64
FLIP_ROWS = 64                         # K2 rows allowed to move (float flips)
# The pool fixture's budget (the sampled heights go through logf/cosf, which
# differ by an ulp between XLA-CPU and CUDA; a ray at an edge may flip).
POOL_FIX_PIXELS, POOL_FIX_SEGMENTS = 8, 8
# The general path against JAX: a direction on a pixel edge may land one
# pixel over (the projection's last bit), a ray on a face edge may flip.
EDGE_PIXELS, EDGE_SEGMENTS = 8, 8
DROPPED_ATOL_FRAC = 1e-6               # of the landed weight
# Sandwich tile entries, kernel against plain version: the tensor cores add
# the products of a 16-row step and the running float32 sum without the
# rounding of a sequential IEEE sum, and the row splits' partial tiles are
# added in float32; the plain version sums in float64 and rounds once.
# atol is a fraction of the largest entry. `matched` is bit-equal.
TILE_RTOL, TILE_ATOL_FRAC = 1e-4, 1e-5
# The sandwich fold against the sort fold: each row's values are rounded to
# bf16 (about 0.4% per row, unbiased, averaging down per pixel).
BF16_MASS, BF16_L1 = 2e-3, 6e-3

# Peak rates of one H100 SXM (NVIDIA's data sheet): device memory, float32
# outside the tensor cores. The special-function rate follows from the SM's
# layout: 16 special-function lanes beside 128 float32 lanes that count two
# operations (multiply-add) each, so 1/16 of the float32 rate.
HBM_BYTES_S = 3.35e12
FP32_OPS_S = 67e12
SFU_OPS_S = FP32_OPS_S / 16
TC_BF16_OPS_S = 989e12                 # dense bf16 on the tensor cores


class _Ms(float):
    """A time in ms that remembers how it was taken."""
    by = "profiler"


def _time_ms(fn, reps: int = 10) -> float:
    """Device milliseconds per call: the CUDA time of every kernel, copy and
    memset that `reps` calls put on the card (torch.profiler), over reps.
    A wall-clock or CUDA-event time would measure the host's launch
    overhead for kernels shorter than their Python wrapper; the port's
    `device_ms` falls back to events only when the profiler returns nothing,
    and the time then says so (`by`, `timed_by` in the kernels line)."""
    from ice_halo_sim_tpu_torch.probe_sandwich import device_ms, timed_by

    timed_by()
    ms = _Ms(device_ms(fn, reps))
    ms.by = timed_by()
    return ms


def _timed_by(*times) -> str:
    return "cuda events" if any(getattr(t, "by", "profiler") != "profiler"
                                for t in times) else "profiler"


def _bits_equal(x, y) -> bool:
    import torch

    return x.shape == y.shape and bool(torch.equal(x.view(torch.int32), y.view(torch.int32)))


def _max_abs(x, y) -> float:
    return float((x.double() - y.double()).abs().max()) if x.numel() else 0.0


def _bound(nbytes: float, ops: float = 0.0, sfu: float = 0.0, tc: float = 0.0):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over their peak rates (float32, special functions, bf16 on
    the tensor cores)."""
    t_bytes = nbytes / HBM_BYTES_S
    t_ops = max(ops / FP32_OPS_S, sfu / SFU_OPS_S, tc / TC_BF16_OPS_S)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def trace_work(plan):
    """(bytes, arithmetic operations, special-function operations) of one
    trace_emit call, counted from the plan's loops (every ray runs every
    loop to its end: nothing here depends on the data).

    Units per ray. U = 24: one uniform draw (two PCG hashes of 9 integer
    operations, the index mix, the convert and scale). A float division or
    square root counts 1 special-function operation (rcp/rsqrt) plus 8
    arithmetic ones (its Newton steps); sin, cos and log count 20
    arithmetic ones (range reduction and polynomial). With multiply-add
    contraction off, every multiply and add is one operation.
      set-up: epoch seed 12, wavelength U + 6, refractive index 12 + 5
        div/sqrt, sun cap 2 U + 20 + 1 sqrt + 2 trig;
      orientation: 5 U, the latitude path (inverse-CDF table: 5 per node
        + 12 + 2 div; else about 30 + 1 sqrt), 6 trig, rotation 22, its
        inverse apply 15;
      entry: 16 per triangle row (two passes of a dot, max, add and the
        CDF compare), 3 U, point 12, plane distances 7 per face slot;
      Fresnel split (entry and every bounce): 42 + 7 div/sqrt;
      bounce (max_hits - 1): per face slot 15 + 1 div and 2 for the
        distance update; exit cosine 5, rotation 15, state selects 8;
      emit slot (max_hits): segment 2, roulette U + 4 when the floor is
        on, gate U + 2 when prob > 0; per render: a dual fisheye pass 22 +
        2 div/sqrt (two passes with the overlap band), a single lens or
        globe 26 + 18 camera rotation + 2 div/sqrt.
    Bytes: the slabs written (8 per row), the tables read once."""
    from ice_halo_sim_tpu_torch.core import sampling
    from ice_halo_sim_tpu_torch.core.latlut import N_NODES

    U, DS, TRIG = 24, 8, 20
    n_tris = plan.n_tris if plan.pool_k else len(plan.tris)
    ops = 12 + (U + 6) + 12 + 5 * DS + 2 * U + 20 + DS + 2 * TRIG
    sfu = 5 + 1
    lut = int(plan.axis_params.lat_path[0]) == sampling.LAT_LUT_INVERSE_CDF
    ops += 5 * U + (5 * N_NODES + 12 + 2 * DS if lut else 30 + DS) + 6 * TRIG + 22 + 15
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
            slot_ops += passes * (22 + 2 * DS)
            slot_sfu += passes * 2
        else:
            slot_ops += 26 + 18 + 2 * DS
            slot_sfu += 2
    ops += plan.h * slot_ops
    sfu += plan.h * slot_sfu
    rows = plan.n_blocks * sum(plan.rows_block)
    nbytes = 8 * rows + 4 * plan.ftab()[0].size
    if plan.pool_k:
        nbytes += 4 * plan.pool_k * (plan.nf * 5 + plan.n_tris * 13)
    return nbytes, ops * plan.batch, sfu * plan.batch


def _trace_bound(name, plan):
    """The bound of one trace_emit call, with its counts written out."""
    nbytes, ops, sfu = trace_work(plan)
    print(f"  {name} work: {nbytes} bytes; per ray {ops // plan.batch} arithmetic and "
          f"{sfu // plan.batch} special-function operations "
          f"({1e3 * nbytes / HBM_BYTES_S:.5f} ms of bytes, {1e3 * ops / FP32_OPS_S:.5f} ms "
          f"of arithmetic, {1e3 * sfu / SFU_OPS_S:.5f} ms of special functions)", flush=True)
    return _bound(nbytes, ops, sfu)


def _add(res: list, name, source, replaces, err, ms, plain_ms, bound, why_no_library=None,
         library_ms=None, library=None):
    """Append one entry of the kernels line. Where one PyTorch call computes
    the same function, its time on the same inputs and its name (it is
    timed here and used nowhere in the port); else the entry says why there
    is none."""
    bound_ms, bound_by = bound
    res.append({
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": 0, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
        "library": library, "why_no_library": why_no_library,
        "timed_by": _timed_by(ms, plain_ms, library_ms)})
    lib = f"{library} {library_ms:.4f} ms" if library_ms is not None else \
        f"none: {why_no_library}"
    print(f"  {name}: max_abs_err {err:.3g}, kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {bound_ms:.5f} ms by {bound_by}, library {lib}, "
          f"timed by {res[-1]['timed_by']}", flush=True)


def _check_trace(name, out_k, out_p):
    """Hold one trace_emit output against its twin's; returns max_abs_err."""
    import torch

    from ice_halo_sim_tpu_torch.core import trace_emit

    d = trace_emit.trace_output_diff(out_k[0], out_p[0])
    if d["rows_diff"] > FLIP_ROWS:
        raise AssertionError(f"{name} rows differ beyond the flip budget: {d}")
    if d["rows_diff"] == 0 and d["w_rel"] > 1e-6:
        raise AssertionError(f"{name} weights differ: {d}")
    if int(out_k[3]) != int(out_p[3]) and d["rows_diff"] == 0:
        raise AssertionError(f"{name} segments {int(out_k[3])} != {int(out_p[3])}")
    # landed: sums of positive weights; dropped: a difference of two large
    # float32 sums (the roulette adds mass as well as removing it), so its
    # tolerance is absolute, a millionth of the landed weight.
    landed_tot = float(out_p[1].double().sum())
    if not torch.allclose(out_k[1].double(), out_p[1].double(), rtol=SUM_RTOL):
        raise AssertionError(f"{name} landed differs: {out_k[1]} vs {out_p[1]}")
    if abs(float(out_k[2]) - float(out_p[2])) > 1e-6 * landed_tot:
        raise AssertionError(f"{name} dropped differs: {out_k[2]} vs {out_p[2]}")
    live = [int(c.sum()) for _, _, c in out_k[0]]
    print(f"  {name} diff {d}, live rows {live}", flush=True)
    if d["rows_diff"]:
        return float(d["w_rel"])
    return max(_max_abs(a[1], b[1]) for a, b in zip(out_k[0], out_p[0]))


def phase_kernels(cfg, device, res: list):
    import torch

    from ice_halo_sim_tpu_torch.core import accum, block_ops, seg_scan, trace_emit
    from ice_halo_sim_tpu_torch.engine.simulator import Engine

    eng = Engine(cfg, seed=7, batch_size=BATCH, device=device)
    plan = eng._trace_plan
    P = eng.proj_plans[0].height * eng.proj_plans[0].width
    K = eng.k_pool
    shift = accum.key_shift(K)
    base = 5 * BATCH * 2
    no_lib_pack = ("a per-block stable partition takes a sort of flags plus a "
                   "gather, no single call")

    # K2 (+ K1 inside the wrapper) against the plain twin.
    args = (plan, base & 0xFFFFFFFF, base >> 32, BATCH, device)
    out_k = trace_emit.trace_emit(*args)
    out_p = trace_emit.trace_emit_plain(*args)
    err = _check_trace("trace_emit", out_k, out_p)
    keys, wts, counts = out_k[0][0]
    _add(res, "trace_emit", "ice_halo_sim_tpu_torch/csrc/trace_emit.cu",
            "ice_halo_sim_tpu/core/pallas_trace.py:318", err,
            _time_ms(lambda: trace_emit.trace_emit(*args), 5),
            _time_ms(lambda: trace_emit.trace_emit_plain(*args), 2),
            _trace_bound("trace_emit", plan),
            "a per-ray Monte-Carlo trace loop is no library function")

    # K1: the trace rows' in-block pack, on the uncompacted slab.
    slabs, *_ = trace_emit.trace_rows_plain(*args)
    sk_, sw_ = slabs[0][0].reshape(-1), slabs[0][1].reshape(-1)
    rb = plan.rows_block[0]
    a = block_ops.pack_rows(sk_, sw_, rb)
    b = block_ops.pack_rows_plain(sk_, sw_, rb)
    if not all(_bits_equal(x, y) for x, y in zip(a, b)):
        raise AssertionError("pack_rows (K1) differs from its plain twin")
    n = sk_.numel()
    _add(res, "pack_rows", "ice_halo_sim_tpu_torch/csrc/block_ops.cu",
            "ice_halo_sim_tpu/core/pallas_ops.py:245", 0.0,
            _time_ms(lambda: block_ops.pack_rows(sk_, sw_, rb)),
            _time_ms(lambda: block_ops.pack_rows_plain(sk_, sw_, rb)),
            _bound(16 * n + 4 * (n // rb), 2 * n), no_lib_pack)

    # K3 with V=2 and the marker tail (the premerged fold's input), V=1.
    live = int(counts.sum())
    keep = -(-int(live * 1.06) // accum.BLOCK) * accum.BLOCK
    out_total = -(-(keep + P) // accum.BLOCK) * accum.BLOCK
    start = (torch.cumsum(counts.long(), 0) - counts.long()).int()
    tail = (keep, P, shift, 2 * K - 1)
    sargs = ([keys, wts], start, out_total, rb)
    a = block_ops.scatter_blocks_multi(*sargs, marker_tail=tail)
    b = block_ops.scatter_blocks_multi_plain(*sargs, marker_tail=tail)
    if not all(_bits_equal(x, y) for x, y in zip(a, b)):
        raise AssertionError("scatter_blocks_multi (K3) differs from its plain twin")
    a1 = block_ops.scatter_blocks(wts, start, keep, rb)
    b1 = block_ops.scatter_blocks_plain(wts, start, keep, rb)
    if not _bits_equal(a1, b1):
        raise AssertionError("scatter_blocks (K3', V=1) differs from its plain twin")
    # The scatter reads the live rows it places and writes every output row.
    _add(res, "scatter_blocks_multi", "ice_halo_sim_tpu_torch/csrc/block_ops.cu",
            "ice_halo_sim_tpu/core/pallas_ops.py:436", 0.0,
            _time_ms(lambda: block_ops.scatter_blocks_multi(*sargs, marker_tail=tail)),
            _time_ms(lambda: block_ops.scatter_blocks_multi_plain(*sargs, marker_tail=tail)),
            _bound(8 * live + 4 * start.numel() + 8 * out_total, 2 * out_total),
            "blocks overwrite each other in order; scatter_ and "
                           "index_copy_ leave overlapping writes undefined")
    k3p = _time_ms(lambda: block_ops.scatter_blocks(wts, start, keep, rb))
    k3p_plain = _time_ms(lambda: block_ops.scatter_blocks_plain(wts, start, keep, rb))
    k3p_bound = _bound(4 * live + 4 * start.numel() + 4 * keep, keep)
    print(f"  scatter_blocks (K3', V=1, the K3 kernel) at the bench rows: kernel {k3p:.4f} "
          f"ms, plain {k3p_plain:.4f} ms, bound {k3p_bound[0]:.5f} ms by {k3p_bound[1]}",
          flush=True)

    # K4 with key2, on the sorted premerged rows.
    ck, cw = a
    sk, sw = accum.sort_keys(ck, cw)
    tbl = eng.basis_tbl
    (ca, k2a) = seg_scan.fused_scan_call(sk, sw, tbl, shift, K, emit_key2=True)
    (cb, k2b) = seg_scan.fused_scan_call_plain(sk, sw, tbl, shift, K, emit_key2=True)
    if not _bits_equal(k2a, k2b):
        raise AssertionError("fused_scan key2 differs from its plain twin")
    err = max(_max_abs(x, y) for x, y in zip(ca, cb))
    for x, y in zip(ca, cb):
        if not torch.allclose(x, y, rtol=SCAN_RTOL, atol=1e-6):
            raise AssertionError(f"fused_scan channels differ (max abs {err})")
    m = sk.numel()
    _add(res, "fused_scan", "ice_halo_sim_tpu_torch/csrc/seg_scan.cu",
            "ice_halo_sim_tpu/core/pallas_scan.py:144", err,
            _time_ms(lambda: seg_scan.fused_scan_call(sk, sw, tbl, shift, K, True)),
            _time_ms(lambda: seg_scan.fused_scan_call_plain(sk, sw, tbl, shift, K, True)),
            _bound(8 * m + 4 * tbl.numel() + 16 * m, 8 * m),
            "a segmented scan with a basis expansion; cumsum has "
                           "no segments")

    # K5 on the scan output (the marker extraction's pack).
    a = block_ops.pack_payload_blocks(k2a, ca, P, accum.BLOCK)
    b = block_ops.pack_payload_blocks_plain(k2a, ca, P, accum.BLOCK)
    if not (all(_bits_equal(x, y) for x, y in zip(a[0], b[0])) and _bits_equal(a[1], b[1])):
        raise AssertionError("pack_payload_blocks (K5) differs from its plain twin")
    _add(res, "pack_payload_blocks", "ice_halo_sim_tpu_torch/csrc/block_ops.cu",
            "ice_halo_sim_tpu/core/pallas_ops.py:365", 0.0,
            _time_ms(lambda: block_ops.pack_payload_blocks(k2a, ca, P, accum.BLOCK)),
            _time_ms(lambda: block_ops.pack_payload_blocks_plain(k2a, ca, P, accum.BLOCK)),
            _bound(16 * m + 12 * m + 4 * (m // accum.BLOCK), 2 * m),
            no_lib_pack)


def phase_kernel_pool(cfg, device, res: list):
    """K2b at POOL_CFG's full width: 1792 sampled pyramids (NF = 20, T = 80)
    of one batch, kernel against twin on the same tables."""
    import torch

    from ice_halo_sim_tpu_torch.core import trace_emit
    from ice_halo_sim_tpu_torch.engine.simulator import Engine

    eng = Engine(cfg, seed=7, batch_size=BATCH, device=device)
    plan = eng._trace_plan
    if (plan.pool_k, plan.nf, plan.n_tris) != (BATCH // 128, 20, 80):
        raise AssertionError(f"pool plan {plan.pool_k}, {plan.nf}, {plan.n_tris}")
    bc = 5
    base = bc * BATCH * 2
    ptbl, ttbl = eng._pool_tables(bc)
    present = ptbl.view(plan.pool_k, plan.nf, 5)[..., 4]
    print(f"  pool: {plan.pool_k} shapes, present faces per shape "
          f"{float(present.sum(1).mean()):.2f}, ptbl {ptbl.numel() * 4 / 1e6:.2f} MB, "
          f"ttbl {ttbl.numel() * 4 / 1e6:.2f} MB", flush=True)
    args = (plan, base & 0xFFFFFFFF, base >> 32, BATCH, device, ptbl, ttbl)
    out_k = trace_emit.trace_emit(*args)
    torch.cuda.synchronize()
    out_p = trace_emit.trace_emit_plain(*args)
    err = _check_trace("trace_emit_pool", out_k, out_p)
    _add(res, "trace_emit_pool", "ice_halo_sim_tpu_torch/csrc/trace_emit.cu",
            "ice_halo_sim_tpu/core/pallas_trace.py:382", err,
            _time_ms(lambda: trace_emit.trace_emit(*args), 5),
            _time_ms(lambda: trace_emit.trace_emit_plain(*args), 1),
            _trace_bound("trace_emit_pool", plan),
            "a per-ray Monte-Carlo trace loop is no library function")
    sampler_ms = _time_ms(lambda: eng._pool_tables(bc), 3)
    print(f"  pool sampler (plain torch, {plan.pool_k} pyramids): {sampler_ms:.4f} ms "
          "device time per batch", flush=True)


def _fold_rows(eng, render: int, batch_counter: int):
    """One steady batch's packed fold rows of a general-path engine: (key,
    weight, mask or None), padded to the 4096-row block."""
    import torch

    from ice_halo_sim_tpu_torch.core import accum
    from ice_halo_sim_tpu_torch.core.bits import to_bits

    base = eng.ray_base(batch_counter)
    contribs = eng._trace_batch_impl(base & 0xFFFFFFFF, base >> 32, batch_counter)[0]
    pix, w, wl_idx, mask = contribs[render]
    P = eng.accum[render].shape[0]
    key, wz = accum.pack_spectral_keys(pix, w, wl_idx, P, eng.k_pool)
    cols = [wz]
    if eng.color_classes:
        cols.append(to_bits(torch.where(key != -1, mask, 0)))
    key, cols = accum._pad_cols(key, cols, accum.BLOCK)
    return key, cols


def phase_kernels_general(ms_cfg, color_cfg, device, res: list):
    """K6 against pack_valid_blocks_plain at the rows of MS_CFG's dual render
    (one column) and of COLOR_CFG's render (two columns), and K3' at
    compact_valid's shape after it. Bit-equal or the run fails."""
    import torch

    from ice_halo_sim_tpu_torch.core import accum, block_ops
    from ice_halo_sim_tpu_torch.engine.simulator import Engine

    block = accum.BLOCK
    no_lib_pack = ("a per-block stable partition takes a sort of flags plus a "
                   "gather, no single call")
    for name, cfg in (("ms", ms_cfg), ("color", color_cfg)):
        eng = Engine(cfg, seed=7, batch_size=BATCH, device=device)
        if eng.trace_path != "general":
            raise AssertionError(f"{name}: trace path {eng.trace_path}")
        eng.run(n_batches=1)                         # calibrates cap, lanes, keep
        keep = eng._compact_keep[0] if eng._compact_keep else None
        key, cols = _fold_rows(eng, 0, 5)
        N, G, C = key.numel(), key.numel() // block, len(cols)
        print(f"  {name}: rows per render {eng._rows_per_render} (slot cap {eng._slot_cap}, "
              f"lanes per layer {[l.cont_cap for l in eng.layers]}), K6 input N = {N} rows "
              f"in {G} blocks, {C} column(s), keep {eng._compact_keep}", flush=True)
        if N < eng._rows_per_render[0] or N - eng._rows_per_render[0] >= block:
            raise AssertionError(f"{name}: K6 rows {N} vs plan {eng._rows_per_render[0]}")
        a = block_ops.pack_valid_blocks(key, cols, 0xFFFFFFFF, block)
        b = block_ops.pack_valid_blocks_plain(key, cols, 0xFFFFFFFF, block)
        flat_a = [a[0], *a[1], a[2]]
        flat_b = [b[0], *b[1], b[2]]
        if not all(_bits_equal(x, y) for x, y in zip(flat_a, flat_b)):
            raise AssertionError(f"pack_valid_blocks (K6) differs from its plain version "
                                 f"at the {name} rows")
        # A general threshold besides: rows below a pixel's first key.
        thresh = (eng.accum[0].shape[0] // 3) << accum.key_shift(eng.k_pool)
        a2 = block_ops.pack_valid_blocks(key, cols, thresh, block)
        b2 = block_ops.pack_valid_blocks_plain(key, cols, thresh, block)
        if not all(_bits_equal(x, y) for x, y in
                   zip([a2[0], *a2[1], a2[2]], [b2[0], *b2[1], b2[2]])):
            raise AssertionError(f"pack_valid_blocks (K6) differs at threshold {thresh}")
        live = int(a[2].sum())
        ms_k = _time_ms(lambda: block_ops.pack_valid_blocks(key, cols, 0xFFFFFFFF, block))
        ms_p = _time_ms(lambda: block_ops.pack_valid_blocks_plain(key, cols, 0xFFFFFFFF, block), 3)
        bound = _bound((1 + C) * 8 * N + 4 * G, 2 * N)
        if name == "ms":
            _add(res, "pack_valid_blocks", "ice_halo_sim_tpu_torch/csrc/block_ops.cu",
                 "ice_halo_sim_tpu/core/pallas_ops.py:301", 0.0, ms_k, ms_p, bound, no_lib_pack)
            res[-1]["rows"] = N
        else:
            print(f"  pack_valid_blocks at the color rows (two columns): bit-equal, kernel "
                  f"{ms_k:.4f} ms, plain {ms_p:.4f} ms, bound {bound[0]:.5f} ms by {bound[1]}",
                  flush=True)
        print(f"  {name}: live rows {live} of {N}", flush=True)
        if name != "ms":
            continue
        # K3' as compact_valid calls it: one column, out_len = keep.
        if keep is None or live > keep:
            raise AssertionError(f"ms: keep {keep} does not hold the {live} live rows")
        start = accum._exclusive_starts(a[2])
        col = a[1][0].view(G, block)
        x = block_ops.scatter_blocks(col, start, keep, block)
        y = block_ops.scatter_blocks_plain(col, start, keep, block)
        if not _bits_equal(x, y):
            raise AssertionError("scatter_blocks (K3') differs from its plain version")
        _add(res, "scatter_blocks", "ice_halo_sim_tpu_torch/csrc/block_ops.cu",
             "ice_halo_sim_tpu/core/pallas_ops.py:549", 0.0,
             _time_ms(lambda: block_ops.scatter_blocks(col, start, keep, block)),
             _time_ms(lambda: block_ops.scatter_blocks_plain(col, start, keep, block)),
             _bound(4 * live + 4 * G + 4 * keep, keep),
             "blocks overwrite each other in order; scatter_ and index_copy_ leave "
             "overlapping writes undefined")
        # compact_valid whole against its plain composition.
        cv = accum.compact_valid(key, cols, keep, eng.ks)
        from ice_halo_sim_tpu_torch.kernels import kernel_set
        cp = accum.compact_valid(key, cols, keep, kernel_set("plain"))
        if not all(_bits_equal(p, q) for p, q in zip(cv[0], cp[0])) or int(cv[1]) != int(cp[1]):
            raise AssertionError("compact_valid differs between the kernel sets")
        del eng
        torch.cuda.empty_cache()


SANDWICH_SRC = "ice_halo_sim_tpu_torch/csrc/sandwich.cu"


def _tile_err(what, got, want, gm=None, wm=None) -> float:
    """Hold a sandwich tile (and `matched`) against the plain version's;
    returns the largest absolute difference."""
    import torch

    if gm is not None and not _bits_equal(gm, wm):
        raise AssertionError(f"{what}: matched differs from the plain version")
    top = float(want.abs().max())
    if not torch.allclose(got, want, rtol=TILE_RTOL, atol=TILE_ATOL_FRAC * top):
        raise AssertionError(f"{what}: tile differs from the plain version (max abs "
                             f"{_max_abs(got, want):.3g}, largest entry {top:.3g})")
    return _max_abs(got, want)


def _sandwich_bound(n, n_matched, nc, c_out, k_pool, terms=1, matched_out=True):
    """((bound_ms, bound_by), product_ms). The bound is the function's: a
    scatter-add. Bytes: the three row operands read and `matched` written
    once, the list, the table, the tile read and written. Operations: one
    multiply and one add per channel and term of each row in the list
    (float32). product_ms is not a bound of the function but the ceiling of
    this design, which computes it as a one-hot product on the tensor cores:
    2 * rows in the list * NC * C * 128 bf16 operations per term at the
    card's peak (a row outside the list is a zero column and needs none)."""
    nbytes = 12 * n + (4 * n if matched_out else 0) + 4 * nc + 4 * k_pool * c_out \
        + 2 * 4 * nc * c_out * 128
    product_ms = 1e3 * 2.0 * n_matched * nc * c_out * 128 * terms / TC_BF16_OPS_S
    return _bound(nbytes, ops=2.0 * n_matched * c_out * terms), product_ms


def phase_kernels_sandwich(ms_cfg, device, res: list):
    """K7 and K8 against sandwich_pass_plain at the calibration batch's count
    pass and, as extra lines, at the raw rows of MS_CFG's dual render (no
    steady launch has that shape: see phase_kernels_cascade for those); P1
    and P2 at their probes' shapes."""
    import torch

    from ice_halo_sim_tpu_torch import probe_sandwich, probe_scatter
    from ice_halo_sim_tpu_torch.core import accum, sandwich
    from ice_halo_sim_tpu_torch.core.bits import from_bits
    from ice_halo_sim_tpu_torch.engine.simulator import Engine

    F32, I32 = torch.float32, torch.int32
    NLO = sandwich.NLO
    eng = Engine(ms_cfg, seed=7, batch_size=BATCH, device=device)
    eng.run(n_batches=1)                             # calibrates the slot cap and lanes
    K, tbl = eng.k_pool, eng.basis_tbl
    P = eng.proj_plans[0].height * eng.proj_plans[0].width
    n_chunks = P // NLO
    key, cols = _fold_rows(eng, 0, 5)
    wz = cols[0]
    shift = accum.key_shift(K)
    kk = from_bits(key)
    pix, wl = (kk >> shift).to(I32), ((kk >> 1) & (K - 1)).to(I32)
    N = key.numel()
    live = wz > 0.0
    n_live = int(live.sum())
    chunk = torch.div(pix[live], NLO, rounding_mode="floor").long()
    rows_per_chunk = torch.bincount(chunk, minlength=n_chunks)
    hot = torch.sort(torch.argsort(rows_per_chunk, descending=True)[:256])[0].to(I32)
    full = torch.arange(n_chunks, dtype=I32, device=device)
    n_hot = int(rows_per_chunk[hot.long()].sum())
    print(f"  ms dual render: {N} decoded rows, {n_live} live, {n_hot} of them in the 256 "
          f"chunks that hold most rows (of {n_chunks})", flush=True)

    tile256 = torch.zeros((256, 3 * NLO), dtype=F32, device=device)
    for name, layout in (("sandwich_lane", "lane"), ("sandwich_sublane", "sublane")):
        def run(t=tile256, cl=hot, p=pix, w=wz, l=wl, tb=tbl, precise=False, lay=layout):
            return sandwich.sandwich_pass(t, cl, p, w, l, tb, k_pool=K, precise=precise,
                                          layout=lay)

        # Extra lines, not a shape of the path: every raw row against the 256
        # hottest chunks, with one bf16 term and with two.
        for precise in (False, True):
            got, gm = run(precise=precise)
            want, wm = sandwich.sandwich_pass_plain(tile256, hot, pix, wz, wl, tbl, k_pool=K,
                                                    precise=precise)
            torch.cuda.synchronize()
            err = _tile_err(f"{name} raw rows, NC 256, precise {precise}", got, want, gm, wm)
            if int(gm.sum()) != n_hot:
                raise AssertionError(f"{name}: {int(gm.sum())} rows matched, {n_hot} expected")
            bound, product = _sandwich_bound(N, n_hot, 256, 3, K, terms=2 if precise else 1)
            print(f"  {name} at the {N} raw rows, NC 256, {'two bf16 terms' if precise else 'one term'}"
                  f" (extra: no launch of the path has this shape): max_abs_err {err:.3g}, "
                  f"kernel {_time_ms(lambda: run(precise=precise), 3):.4f} ms, bound "
                  f"{bound[0]:.5f} ms by {bound[1]}, one-hot product at peak {product:.5f} ms",
                  flush=True)

        # The calibration batch's count pass, at its shape on the path: one
        # channel, an all-ones table, the raw rows over every chunk. Exact.
        ones = torch.ones((K, 1), dtype=F32, device=device)
        tile_cnt = torch.zeros((n_chunks, NLO), dtype=F32, device=device)
        flags = live.to(F32)
        got, gm = run(tile_cnt, full, pix, flags, wl, ones)
        want, wm = sandwich.sandwich_pass_plain(tile_cnt, full, pix, flags, wl, ones, k_pool=K)
        if not _bits_equal(got, want) or not _bits_equal(gm, wm) or int(got.sum()) != n_live:
            raise AssertionError(f"{name}: the count pass is not exact")
        b4, p4 = _sandwich_bound(N, n_live, n_chunks, 1, K)
        print(f"  {name} count pass (C = 1, {N} rows, NC {n_chunks}): exact, kernel "
              f"{_time_ms(lambda: run(tile_cnt, full, pix, flags, wl, ones), 5):.4f} ms, bound "
              f"{b4[0]:.5f} ms by {b4[1]}, one-hot product at peak {p4:.5f} ms", flush=True)
    del eng
    torch.cuda.empty_cache()

    # P1 at the probe's shape: N = 3342336 rows over 131072 pixels, K = 64.
    PP, PK, PN = 512 * 256, 64, 3_342_336
    rows = [torch.as_tensor(x).to(device) for x in probe_sandwich.probe_rows(PN, PP, PK)]
    ppix, pw, pwl, ptbl = rows
    for nhi in (256, 1024):
        got = probe_sandwich.sandwich_iota(ppix, pw, pwl, ptbl, nhi=nhi, k_pool=PK)
        want = probe_sandwich.sandwich_iota_plain(ppix, pw, pwl, ptbl, nhi=nhi, k_pool=PK)
        err = _tile_err(f"sandwich_iota NHI {nhi}", got, want)
        inside = (ppix >= 0) & (ppix < nhi * NLO)
        pidx = torch.where(inside, ppix.long(), torch.arange(PN, device=device) % (nhi * NLO))
        pimg = torch.zeros((nhi * NLO, 3), dtype=F32, device=device)
        pvals = torch.where(inside[:, None], ptbl[pwl.long()] * pw[:, None], 0.0)
        ms_k = _time_ms(lambda: probe_sandwich.sandwich_iota(ppix, pw, pwl, ptbl, nhi=nhi,
                                                             k_pool=PK), 5)
        ms_p = _time_ms(lambda: probe_sandwich.sandwich_iota_plain(ppix, pw, pwl, ptbl, nhi=nhi,
                                                                   k_pool=PK), 2)
        ms_l = _time_ms(lambda: pimg.index_add_(0, pidx, pvals), 5)
        bound, product = _sandwich_bound(PN, int(inside.sum()), nhi, 3, PK, matched_out=False)
        if nhi == 256:
            _add(res, "sandwich_iota", SANDWICH_SRC, "scripts/probe_sandwich.py:90", err, ms_k,
                 ms_p, bound, library_ms=ms_l, library="index_add_")
            res[-1].update(rows=PN, listed_chunks=nhi, product_bound_ms=product)
        else:
            print(f"  sandwich_iota NHI {nhi}: max_abs_err {err:.3g}, kernel {ms_k:.4f} ms, "
                  f"plain {ms_p:.4f} ms, bound {bound[0]:.5f} ms by {bound[1]}, one-hot "
                  f"product at peak {product:.5f} ms, index_add_ {ms_l:.4f} ms", flush=True)

    # P2 at the probe's shape: G = 192 blocks of 16384 into P = 131072.
    vals, start, n_out, block = probe_scatter.probe_inputs(device)
    got = probe_scatter.extract_blocks(vals, start, n_out, block)
    want = probe_scatter.extract_blocks_plain(vals, start, n_out, block)
    if not _bits_equal(got, want):
        raise AssertionError("extract_blocks (P2) differs from its plain version")
    _add(res, "extract_blocks", "ice_halo_sim_tpu_torch/csrc/block_ops.cu",
         "scripts/probe_pallas_scatter.py:121", 0.0,
         _time_ms(lambda: probe_scatter.extract_blocks(vals, start, n_out, block)),
         _time_ms(lambda: probe_scatter.extract_blocks_plain(vals, start, n_out, block), 3),
         # Each output entry takes one value of the block that wrote it last.
         _bound(4 * n_out + 4 * start.numel() + 4 * n_out, n_out),
         "blocks overwrite each other in order; scatter_ and index_copy_ leave overlapping "
         "writes undefined")


def _images_off(a, b, what) -> int:
    """Pixels outside the per-pixel tolerance, after the image-sum check."""
    import numpy as np

    if not np.isclose(a.sum(), b.sum(), rtol=SUM_RTOL):
        raise AssertionError(f"{what}: image sum {a.sum()} vs {b.sum()}")
    tol = IMG_RTOL * np.abs(b) + IMG_ATOL_FRAC * np.abs(b).max()
    return int((np.abs(a - b) > tol).any(-1).sum())


def phase_slice(name, cfg, device, path_kernels, steady: int = 3,
                path: str = "cuda-trace-kernel"):
    """Render `cfg` through the CUDA kernels with the launch counters reset
    just before and read just after; compare with kernels="plain" on the
    card. Every kernel of path_kernels must have launched, and on the steady
    (calibrated) batches too. Returns (engine, launch counts, launches per
    steady batch)."""
    import numpy as np
    import torch

    from ice_halo_sim_tpu_torch.engine.simulator import Engine
    from ice_halo_sim_tpu_torch.kernels import build

    eng = Engine(cfg, seed=7, batch_size=BATCH, device=device)
    if eng.trace_path != path:
        raise AssertionError(f"{name}: trace path {eng.trace_path}, not {path}")
    build.reset_launch_counts()
    eng.run(n_batches=1)
    first = dict(build.LAUNCHES)
    eng.run(n_batches=steady)
    torch.cuda.synchronize()
    counts = dict(build.LAUNCHES)
    per_batch = {k: (counts[k] - first[k]) / steady for k in counts}
    print(f"  {name}: launches {counts}, keep {eng._compact_keep}, slot cap "
          f"{eng._slot_cap}, lanes per layer {[l.cont_cap for l in eng.layers]}, "
          f"host syncs {eng.host_syncs}", flush=True)
    print(f"  {name}: launches per steady batch {per_batch}", flush=True)
    for k in path_kernels:
        if counts[k] <= 0 or per_batch[k] <= 0:
            raise AssertionError(f"kernel {k} was not launched on the {name} path "
                                 f"(total {counts[k]}, per steady batch {per_batch[k]})")
    st = eng.drain_stats()

    ref = Engine(cfg, seed=7, batch_size=BATCH, device=device, kernels="plain")
    ref.run(n_batches=1)
    ref.run(n_batches=steady)
    rst = ref.drain_stats()
    seg_diff = abs(st.ray_segments - rst.ray_segments)
    for r in range(len(eng.proj_plans)):
        bad = _images_off(eng.raw_xyz(r), ref.raw_xyz(r), f"{name} render {r} cuda vs plain")
        print(f"  {name} render {r} cuda vs plain: pixels off {bad}", flush=True)
        if bad > FLIP_ROWS:
            raise AssertionError(f"{name}: cuda slice differs from the plain slice")
        if eng.color_classes:
            la, lb = eng.lane_y(r), ref.lane_y(r)
            tol = IMG_RTOL * np.abs(lb) + IMG_ATOL_FRAC * np.abs(lb).max()
            lbad = int((np.abs(la - lb) > tol).any(0).sum())
            print(f"  {name} render {r} class lanes cuda vs plain: pixels off {lbad}, lane "
                  f"sums {la.sum((1, 2)).tolist()}", flush=True)
            if lbad > 0 or not np.allclose(la.sum((1, 2)), lb.sum((1, 2)), rtol=SUM_RTOL):
                raise AssertionError(f"{name}: class lanes differ between the kernel sets")
    print(f"  {name} cuda vs plain: segments {st.ray_segments} / {rst.ray_segments}, "
          f"landed {st.landed_weight} / {rst.landed_weight}, dropped "
          f"{st.dropped_cont_weight} / {rst.dropped_cont_weight}, shape samples "
          f"{st.stochastic_crystal_samples}", flush=True)
    if abs(st.dropped_cont_weight - rst.dropped_cont_weight) > \
            DROPPED_ATOL_FRAC * rst.landed_weight:
        raise AssertionError(f"{name}: dropped weight differs")
    if (eng._slot_cap, eng._compact_keep, [l.cont_cap for l in eng.layers]) != \
            (ref._slot_cap, ref._compact_keep, [l.cont_cap for l in ref.layers]):
        raise AssertionError(f"{name}: calibration differs between the kernel sets")
    if seg_diff > FLIP_ROWS * 7 or st.stochastic_crystal_samples != rst.stochastic_crystal_samples:
        raise AssertionError(f"{name}: cuda slice differs from the plain slice")
    if not np.isclose(st.landed_weight, rst.landed_weight, rtol=SUM_RTOL):
        raise AssertionError(f"{name}: landed weight differs")
    for r, img in enumerate(eng.snapshot()):
        if img.max() == 0:
            raise AssertionError(f"{name}: snapshot {r} is black")
        print(f"  {name} snapshot {r}: max {img.max()}, mean {img.mean():.3f}", flush=True)
    return eng, counts, per_batch


def _sandwich_agrees_with_sort(what, eng, sort_eng):
    """An engine that folded (some batches) by sandwich against the sort fold
    of the same batches: segments and landed weight equal, image mass and L1
    within the bf16 tolerance."""
    import numpy as np

    st, rst = eng.drain_stats(), sort_eng.drain_stats()
    if st.ray_segments != rst.ray_segments or not np.isclose(
            st.landed_weight, rst.landed_weight, rtol=1e-6):
        raise AssertionError(f"{what}: segments {st.ray_segments} / {rst.ray_segments}, landed "
                             f"{st.landed_weight} / {rst.landed_weight} against the sort fold")
    for r in range(len(eng.proj_plans)):
        a, b = eng.raw_xyz(r).astype(np.float64), sort_eng.raw_xyz(r).astype(np.float64)
        mass = abs(a.sum() - b.sum()) / b.sum()
        l1 = np.abs(a - b).sum() / np.abs(b).sum()
        print(f"  {what} render {r} against the sort fold: mass off {mass:.3g}, L1 {l1:.3g}",
              flush=True)
        if mass > BF16_MASS or l1 > BF16_L1:
            raise AssertionError(f"{what}: render {r} differs from the sort fold")


class _layout:
    """Set core/sandwich.LAYOUT, the kernel a pass launches when its caller
    names no layout (the engine names none), and restore it."""

    def __init__(self, layout: str):
        self.layout = layout

    def __enter__(self):
        from ice_halo_sim_tpu_torch.core import sandwich

        self.old, sandwich.LAYOUT = sandwich.LAYOUT, self.layout

    def __exit__(self, *exc):
        from ice_halo_sim_tpu_torch.core import sandwich

        sandwich.LAYOUT = self.old


def phase_sandwich(name, cfg, device, sort_eng, steady: int = 3):
    """MS_CFG under IHT_FOLD=sandwich through the kernel that
    core/sandwich.LAYOUT names (K7 for "lane", the default; K8 for
    "sublane"): one calibration batch, `steady` batches with the kernel
    launched on each, the launch counters reset just before and read just
    after; against kernels="plain" on the card and against `sort_eng` (the
    ms slice after as many batches). Returns (engine, counts, per batch)."""
    import numpy as np
    import torch

    from ice_halo_sim_tpu_torch.core import sandwich
    from ice_halo_sim_tpu_torch.engine.simulator import Engine
    from ice_halo_sim_tpu_torch.kernels import build

    counter = "sandwich_lane" if sandwich.LAYOUT == "lane" else "sandwich_sublane"
    with _knobs(IHT_FOLD="sandwich"):
        eng = Engine(cfg, seed=7, batch_size=BATCH, device=device)
        ref = Engine(cfg, seed=7, batch_size=BATCH, device=device, kernels="plain")
    if eng.fold_kind != "sandwich" or eng._trace_plan is not None:
        raise AssertionError(f"{name}: fold {eng.fold_kind} ({eng.fold_decision})")
    build.reset_launch_counts()
    eng.run(n_batches=1)
    first = dict(build.LAUNCHES)
    syncs = eng.host_syncs
    for _ in range(steady):
        before = build.LAUNCHES[counter]
        eng.run(n_batches=1)
        if build.LAUNCHES[counter] <= before:
            raise AssertionError(f"{name}: {counter} was not launched on a steady batch")
    torch.cuda.synchronize()
    counts = dict(build.LAUNCHES)
    per_batch = {k: (counts[k] - first[k]) / steady for k in counts}
    levels = [[(int(cl.shape[0]), keep) for cl, keep in lv] for lv in eng._levels]
    print(f"  {name}: fold {eng.fold_kind} ({eng.fold_decision}), levels (listed chunks, "
          f"keep) {levels}, rows into the last level {[int(n) for n in eng.last_level_rows]}, "
          f"host syncs per steady batch {(eng.host_syncs - syncs) / steady:.1f}", flush=True)
    print(f"  {name}: launches {counts}", flush=True)
    print(f"  {name}: launches per steady batch {per_batch}", flush=True)
    if eng.fold_kind != "sandwich":
        raise AssertionError(f"{name}: the engine left the sandwich fold")
    compacts = any(keep is not None for lv in eng._levels for _cl, keep in lv)
    for k in [counter] + (["pack_valid_blocks", "scatter_blocks"] if compacts else []):
        if per_batch[k] <= 0:
            raise AssertionError(f"kernel {k} was not launched on the steady {name} batches")
    ref.run(n_batches=1)
    ref.run(n_batches=steady)
    if levels != [[(int(cl.shape[0]), keep) for cl, keep in lv] for lv in ref._levels] or any(
            not torch.equal(a[0], b[0]) for la, lb in zip(eng._levels, ref._levels)
            for a, b in zip(la, lb)):
        raise AssertionError(f"{name}: the planned levels differ between the kernel sets")
    for r in range(len(eng.proj_plans)):
        a, b = eng.raw_xyz(r), ref.raw_xyz(r)
        err = float(np.abs(a - b).max())
        print(f"  {name} render {r} cuda vs plain: max abs {err:.3g} of {float(b.max()):.3g}",
              flush=True)
        if not np.allclose(a, b, rtol=TILE_RTOL, atol=TILE_ATOL_FRAC * float(b.max())):
            raise AssertionError(f"{name}: render {r} differs from the plain kernel set")
    _sandwich_agrees_with_sort(name, eng, sort_eng)
    for r, img in enumerate(eng.snapshot()):
        if img.max() == 0:
            raise AssertionError(f"{name}: snapshot {r} is black")
    return eng, counts, per_batch


def phase_kernels_cascade(eng, device, res: list, batch_counter: int = 5):
    """K7 and K8 at the shapes the ms-sandwich path gives them: the rows of
    one steady batch go through every level of both renders' calibrated
    cascades (`eng._levels`) as `_sandwich_fold_r` routes them: compacted to
    the level's keep (K6 + K3'), decoded, folded, the misses sent onward. At
    each (rows, chunk list) pair both kernels are held against the plain
    version and timed beside it and beside one index_add_ of the same rows
    into the image. The kernels line takes a kernel's largest launch (render
    0, level 0) as its entry, every launch under "levels", and the sums over
    the batch's launches under "batch"."""
    import torch

    from ice_halo_sim_tpu_torch.core import accum, sandwich
    from ice_halo_sim_tpu_torch.core.bits import from_bits

    F32, I32 = torch.float32, torch.int32
    NLO = sandwich.NLO
    K, tbl = eng.k_pool, eng.basis_tbl
    shift = accum.key_shift(K)
    kernels = (("sandwich_lane", "lane", "ice_halo_sim_tpu/core/pallas_sandwich.py:283"),
               ("sandwich_sublane", "sublane", "ice_halo_sim_tpu/core/pallas_sandwich.py:314"))
    levels_of = {name: [] for name, _l, _r in kernels}
    base = eng.ray_base(batch_counter)
    contribs = eng._trace_batch_impl(base & 0xFFFFFFFF, base >> 32, batch_counter)[0]
    for r, (cpix, cw_, cwl, _mask) in enumerate(contribs):
        P = eng.proj_plans[r].height * eng.proj_plans[r].width
        img = torch.zeros((P, 3), dtype=F32, device=device)
        carry_key, carry_w = accum.pack_spectral_keys(cpix, cw_, cwl, P, K)
        for li, (clist, keep) in enumerate(eng._levels[r]):
            ck, cw = carry_key, carry_w
            n_in = int((carry_w > 0.0).sum())
            if keep is not None and keep < carry_key.shape[0]:
                if n_in > keep:
                    raise AssertionError(f"render {r} level {li}: {n_in} entrants overflow "
                                         f"keep {keep} on the captured batch")
                (ck, cw), _ = accum.compact_valid(carry_key, [carry_w], keep, eng.ks)
            kk = from_bits(ck)
            pix, wl = (kk >> shift).to(I32), ((kk >> 1) & (K - 1)).to(I32)
            n, nc = ck.shape[0], int(clist.shape[0])
            tile = torch.zeros((nc, 3 * NLO), dtype=F32, device=device)
            want, wm = sandwich.sandwich_pass_plain(tile, clist, pix, cw, wl, tbl, k_pool=K)
            hit = (wm == 1) & (cw > 0.0)
            n_hit = int(hit.sum())
            ms_p = _time_ms(lambda: sandwich.sandwich_pass_plain(tile, clist, pix, cw, wl, tbl,
                                                                 k_pool=K), 2)
            # The library call on the same rows: a row outside the list adds
            # zeros to a pixel of its own, not to one dump row on which
            # millions of atomic adds would queue.
            vals = torch.where(hit[:, None], tbl[wl.long()] * cw[:, None], 0.0)
            idx = torch.where(hit, pix.long(), torch.arange(n, device=device) % P)
            ms_l = _time_ms(lambda: img.index_add_(0, idx, vals), 5)
            bound, product = _sandwich_bound(n, n_hit, nc, 3, K)
            for name, layout, _replaces in kernels:
                def run(lay=layout):
                    return sandwich.sandwich_pass(tile, clist, pix, cw, wl, tbl, k_pool=K,
                                                  layout=lay)

                got, gm = run()
                torch.cuda.synchronize()
                err = _tile_err(f"{name} render {r} level {li}", got, want, gm, wm)
                if not _bits_equal(run()[0], got):
                    raise AssertionError(f"{name}: two runs on the same rows differ")
                ms_k = _time_ms(run, 5)
                levels_of[name].append({
                    "render": r, "level": li, "rows": n, "entrants": n_in,
                    "listed_chunks": nc, "rows_in_list": n_hit, "max_abs_err": err,
                    "ms": ms_k, "plain_ms": ms_p, "bound_ms": bound[0], "bound_by": bound[1],
                    "product_bound_ms": product, "library_ms": ms_l,
                    "timed_by": _timed_by(ms_k, ms_p, ms_l)})
                print(f"  {name} render {r} level {li}: {n} rows ({n_in} entrants, {n_hit} in "
                      f"the list of {nc}), max_abs_err {err:.3g}, kernel {ms_k:.4f} ms, plain "
                      f"{ms_p:.4f} ms, bound {bound[0]:.5f} ms by {bound[1]}, one-hot product "
                      f"at peak {product:.5f} ms, index_add_ {ms_l:.4f} ms", flush=True)
            miss = wm == 0
            carry_key = torch.where(miss & (cw > 0.0), ck, -1)
            carry_w = torch.where(miss, cw, 0.0)
        if int((carry_w > 0.0).sum()) != 0:
            raise AssertionError(f"render {r}: live rows left after the full-coverage level")
    for name, _layout_name, replaces in kernels:
        lv = levels_of[name]
        top = lv[0]
        _add(res, name, SANDWICH_SRC, replaces, max(x["max_abs_err"] for x in lv),
             top["ms"], top["plain_ms"], (top["bound_ms"], top["bound_by"]),
             library_ms=top["library_ms"], library="index_add_")
        res[-1].update(
            rows=top["rows"], listed_chunks=top["listed_chunks"],
            product_bound_ms=top["product_bound_ms"], timed_by=top["timed_by"], levels=lv,
            batch={k: sum(x[k] for x in lv) for k in
                   ("ms", "plain_ms", "bound_ms", "product_bound_ms", "library_ms")})
        print(f"  {name}: the {len(lv)} launches of one steady batch: "
              f"{json.dumps(res[-1]['batch'])}", flush=True)


def phase_fold_auto(scenes, device, n_after: int = 3):
    """IHT_FOLD=auto on general-path scenes: what calibration decides, with
    both modeled costs, and beside them what the card takes: the device time
    of one steady batch of the auto engine and of an IHT_FOLD=sort engine of
    the same scene. Whatever it decides, the image agrees with the sort
    fold's (a demotion carries the settled tiles over once). `scenes` holds
    (name, config, sort engine after 1 + n_after batches or None)."""
    from ice_halo_sim_tpu_torch.engine.simulator import Engine

    for what, cfg, other in scenes:
        with _knobs(IHT_FOLD="auto", IHT_PALLAS_TRACE="0"):
            eng = Engine(cfg, seed=7, batch_size=BATCH, device=device)
        if eng.fold_kind != "sandwich" or eng.fold_decision != "startup":
            raise AssertionError(f"auto {what}: starts on {eng.fold_kind} ({eng.fold_decision})")
        eng.run(n_batches=1)
        eng.run(n_batches=n_after)
        if other is None:
            with _knobs(IHT_FOLD="sort", IHT_PALLAS_TRACE="0"):
                other = Engine(cfg, seed=7, batch_size=BATCH, device=device)
            other.run(n_batches=1)
            other.run(n_batches=n_after)
        print(f"  IHT_FOLD=auto on {what}: fold {eng.fold_kind}; {eng.fold_decision}; modeled "
              f"ms per batch {eng.fold_costs}; rows per render {eng._rows_per_render}, sort "
              f"fold's keep {other._compact_keep}", flush=True)
        if not eng.fold_decision.startswith("calibrated: ") or eng.fold_costs is None:
            raise AssertionError(f"auto {what}: no calibrated decision")
        if eng.fold_kind == "sandwich":
            print(f"  auto {what} keeps the cascade: levels (listed chunks, keep) "
                  f"{[[(int(cl.shape[0]), keep) for cl, keep in lv] for lv in eng._levels]}",
                  flush=True)
        _sandwich_agrees_with_sort(f"auto {what}", eng, other)
        # One more batch on each engine, under the profiler: the whole batch's
        # device time, trace and fold; the difference is the folds'.
        t_auto = _time_ms(lambda: eng.run(n_batches=1), 3)
        t_sort = _time_ms(lambda: other.run(n_batches=1), 3)
        print(f"  auto {what}: device ms per steady batch {t_auto:.4f} as decided "
              f"({eng.fold_kind}), {t_sort:.4f} under IHT_FOLD=sort (timed by "
              f"{_timed_by(t_auto, t_sort)})", flush=True)


def phase_probe(name, main_fn):
    """A probe's own main path, the launch counters reset just before and
    read just after."""
    from ice_halo_sim_tpu_torch.kernels import build

    build.reset_launch_counts()
    rc = main_fn()
    counts = dict(build.LAUNCHES)
    if rc != 0 or counts[name] <= 0:
        raise AssertionError(f"probe of {name}: exit code {rc}, launches {counts[name]}")
    return counts


class _knobs:
    """Set environment knobs for the construction of an Engine (the engine
    reads them in its constructor), and restore them."""

    def __init__(self, **kv):
        self.kv = kv

    def __enter__(self):
        self.old = {k: os.environ.get(k) for k in self.kv}
        os.environ.update(self.kv)

    def __exit__(self, *exc):
        for k, v in self.old.items():
            if v is None:
                del os.environ[k]
            else:
                os.environ[k] = v


def phase_paths_agree(cfg, device, n_after: int = 2):
    """BENCH_CFG's scene through the general path against the trace kernel
    path on the card, with the emit floor and the slot cap off (the two
    paths differ there on purpose). Tolerances of the CPU test: segments
    exact, landed weight rtol 1e-5, no pixel outside rtol 1e-4 / atol 1e-6
    of the maximum."""
    import numpy as np

    from ice_halo_sim_tpu_torch.engine.simulator import Engine

    with _knobs(IHT_MIN_EMIT_W="0", IHT_SLOT_CAP="off"):
        k = Engine(cfg, seed=7, batch_size=BATCH, device=device)
        with _knobs(IHT_PALLAS_TRACE="0", IHT_FOLD="sort"):
            g = Engine(cfg, seed=7, batch_size=BATCH, device=device)
    if (k.trace_path, g.trace_path) != ("cuda-trace-kernel", "general"):
        raise AssertionError(f"paths {k.trace_path}, {g.trace_path}")
    for eng in (k, g):
        eng.run(n_batches=1)
        eng.run(n_batches=n_after)
    ks, gs = k.drain_stats(), g.drain_stats()
    bad = _images_off(g.raw_xyz(0), k.raw_xyz(0), "general vs kernel path")
    print(f"  bench general path vs kernel path: segments {gs.ray_segments} / "
          f"{ks.ray_segments}, landed {gs.landed_weight} / {ks.landed_weight}, pixels off "
          f"{bad}, keep {g._compact_keep} / {k._compact_keep}", flush=True)
    if bad or gs.ray_segments != ks.ray_segments or not np.isclose(
            gs.landed_weight, ks.landed_weight, rtol=SUM_RTOL):
        raise AssertionError("the general path and the kernel path disagree on BENCH_CFG")


def phase_fixture(name, cfg, device, pixel_budget: int, segment_budget: int,
                  emit_floor_off: bool = True):
    """The small-batch fixture configuration against the committed JAX
    render (made by scripts/make_torch_port_ref.py: bench and pool with the
    emit floor off, ms at the default knobs)."""
    import numpy as np

    from ice_halo_sim_tpu_torch.engine.simulator import Engine

    ref = np.load(FIXTURES[name])
    with _knobs(**({"IHT_MIN_EMIT_W": "0"} if emit_floor_off else {})):
        eng = Engine(cfg, seed=int(ref["seed"]), batch_size=int(ref["batch_size"]),
                     device=device)
    eng.run(n_batches=1)
    eng.run(n_batches=int(ref["n_batches"]) - 1)
    st = eng.drain_stats()
    bad = 0
    for r in range(len(eng.proj_plans)):
        key = "raw_xyz" if r == 0 else f"raw_xyz_{r}"
        bad += _images_off(eng.raw_xyz(r), ref[key], f"{name} fixture render {r}")
    seg_diff = abs(st.ray_segments - int(ref["ray_segments"]))
    print(f"  {name} fixture: segments {st.ray_segments} / {int(ref['ray_segments'])}, "
          f"landed {st.landed_weight} / {float(ref['landed_weight'])}, pixels off {bad}",
          flush=True)
    if bad > pixel_budget or seg_diff > segment_budget:
        raise AssertionError(f"the CUDA {name} slice does not match the JAX fixture")
    if not np.isclose(st.landed_weight, float(ref["landed_weight"]), rtol=SUM_RTOL):
        raise AssertionError(f"{name}: landed weight differs from the fixture")
    if "slot_cap" in ref.files and eng._slot_cap != int(ref["slot_cap"]):
        raise AssertionError(f"{name}: slot cap {eng._slot_cap} != {int(ref['slot_cap'])}")
    if "dropped_cont_weight" in ref.files and abs(
            st.dropped_cont_weight - float(ref["dropped_cont_weight"])) > \
            DROPPED_ATOL_FRAC * float(ref["landed_weight"]):
        raise AssertionError(f"{name}: dropped weight differs from the fixture")


def phase_rate(eng, n: int = 20):
    import torch

    eng.run(n_batches=2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run(n_batches=n)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return n * eng.batch_size / dt


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from ice_halo_sim_tpu_torch.config.loader import load_project
    from ice_halo_sim_tpu_torch.kernels import build
    from ice_halo_sim_tpu_torch.scenes import BENCH_CFG, COLOR_CFG, MS_CFG, POOL_CFG

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"[1] device: {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
          f"cuda {torch.version.cuda}", flush=True)
    device = torch.device("cuda", 0)

    t_start = t0 = time.time()
    path = build.build()
    build.lib()
    print(f"[2] build: {time.time() - t0:.1f} s -> {os.path.relpath(path, ROOT)}",
          flush=True)
    for kernel in ("trace_emit_kernel", "sandwich_lane_kernel", "sandwich_sublane_kernel"):
        for line in build.ptxas_report(kernel):
            print(f"  {line}", flush=True)

    bench, pool = load_project(BENCH_CFG), load_project(POOL_CFG)
    ms, colour = load_project(MS_CFG), load_project(COLOR_CFG)
    ms_first = copy.deepcopy(MS_CFG)
    ms_first["scene"]["scattering"] = ms_first["scene"]["scattering"][:1]
    ms_first["filter"] = []
    print("[3] kernels vs plain twins at the main paths' shapes", flush=True)
    res = []
    phase_kernels(bench, device, res)
    phase_kernel_pool(pool, device, res)
    with _knobs(IHT_FOLD="sort"):
        phase_kernels_general(ms, colour, device, res)
        phase_kernels_sandwich(ms, device, res)

    print("[4] slices", flush=True)
    common = ["pack_rows", "pack_payload_blocks", "scatter_blocks_multi", "fused_scan"]
    prepass = ["pack_valid_blocks", "scatter_blocks", "pack_payload_blocks",
               "scatter_blocks_multi"]
    engines, counts, per_batch = {}, {}, {}
    # These slices and fixtures fold by sort, as the JAX fixtures did (the
    # knob touches only the general path); the sandwich fold has slices of
    # its own below.
    with _knobs(IHT_FOLD="sort"):
        for name, cfg, kernels, steady, path in (
                ("bench", bench, ["trace_emit"] + common, 3, "cuda-trace-kernel"),
                ("pool", pool, ["trace_emit_pool"] + common, 2, "cuda-trace-kernel"),
                ("ms", ms, prepass + ["fused_scan"], 3, "general"),
                ("color", colour, prepass, 2, "general")):
            engines[name], counts[name], per_batch[name] = phase_slice(
                name, cfg, device, kernels, steady, path)
            if name == "bench":
                phase_fixture("bench", bench, device, 0, 0)
                phase_paths_agree(bench, device)
            elif name == "pool":
                phase_fixture("pool", pool, device, POOL_FIX_PIXELS, POOL_FIX_SEGMENTS)
            elif name == "ms":
                phase_fixture("ms", load_project(ms_first), device, EDGE_PIXELS, EDGE_SEGMENTS,
                              emit_floor_off=False)
    # MS_CFG through the sandwich cascade: K7, then the A/B form K8, each
    # against the plain kernel set and the ms slice's sort fold (1 + 3 batches).
    engines["ms-sandwich"], counts["ms-sandwich"], per_batch["ms-sandwich"] = phase_sandwich(
        "ms-sandwich", ms, device, engines["ms"])
    print("[3, after calibration] K7 and K8 vs plain at every launch of a steady ms-sandwich "
          "batch", flush=True)
    phase_kernels_cascade(engines["ms-sandwich"], device, res)
    with _layout("sublane"):
        _, counts["ms-sandwich-sublane"], _ = phase_sandwich(
            "ms-sandwich-sublane", ms, device, engines["ms"])
    # A scene whose rows are few and concentrated, where the dispatch's model
    # favours the cascade most: one population of horizontal plates, only the
    # ray path 3-5 (the parhelia), on BENCH_CFG's render.
    sundog = copy.deepcopy(BENCH_CFG)
    sundog["crystal"] = [copy.deepcopy(MS_CFG["crystal"][0])]
    sundog["filter"] = copy.deepcopy(MS_CFG["filter"])
    sundog["scene"]["scattering"][0]["entries"][0]["filter"] = 1
    phase_fold_auto([("ms", ms, engines["ms"]), ("bench (general path)", bench, None),
                     ("sundog (plates, ray path 3-5)", load_project(sundog), None)], device)
    from ice_halo_sim_tpu_torch import probe_sandwich, probe_scatter
    counts["probe_sandwich"] = phase_probe("sandwich_iota", probe_sandwich.main)
    counts["probe_scatter"] = phase_probe("extract_blocks", probe_scatter.main)
    # Launches of a kernel on the main path that runs it: the pool scene for
    # the blocked-pool trace, MS_CFG for the fold prepass, MS_CFG under the
    # sandwich fold for K7 and K8, the probes' own runs for P1 and P2, else
    # BENCH_CFG.
    home = {"trace_emit_pool": "pool", "pack_valid_blocks": "ms", "scatter_blocks": "ms",
            "sandwich_lane": "ms-sandwich", "sandwich_sublane": "ms-sandwich-sublane",
            "sandwich_iota": "probe_sandwich", "extract_blocks": "probe_scatter"}
    for k in res:
        k["launches"] = counts[home.get(k["name"], "bench")][k["name"]]
        k["launches_per_steady_batch"] = {n: per_batch[n][k["name"]] for n in per_batch}

    for name, eng in engines.items():
        rate = phase_rate(eng, 20 if name in ("bench", "pool") else 8)
        print(f"[5] {name} steady rate: {rate:.6g} rays/s (batch {BATCH}, "
              f"{eng.trace_path}, fold {eng.fold_kind}) on {smi}", flush=True)
    print(f"total {time.time() - t_start:.1f} s", flush=True)

    print(json.dumps({"kernels": res}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
