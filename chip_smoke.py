#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises; the exit code is then non-zero):
  1. device: a CUDA device must be present; prints the card's name and
     power limit (nvidia-smi);
  2. build: compiles the port's CUDA kernels from csrc/ (nvcc, ctypes) and
     prints the trace kernel's register and spill report;
  3. kernels: each kernel against its plain PyTorch twin on the card, at
     the main paths' shapes, with its error, both device times per call
     (torch.profiler) and its bound (the least time the card could take).
     The static trace kernel and the block and scan kernels run at
     BENCH_CFG's shapes (batch 229376 = 112 x 2048 rays, P = 131072
     pixels, K = 64); the blocked-pool trace kernel at POOL_CFG's (the same
     batch as 1792 sampled pyramids, NF = 20 face slots, two renders); the
     fold prepass (pack_valid_blocks with one column, and scatter_blocks
     after it) at the rows of MS_CFG's dual render, and pack_valid_blocks
     with two columns at COLOR_CFG's;
  4. slices: Engine(cfg, device="cuda") renders BENCH_CFG and POOL_CFG (the
     trace kernel path), then MS_CFG and COLOR_CFG (the general trace
     path), each with the launch counters reset just before and read just
     after; every kernel of the path must have launched, on its steady
     batches too; image, lanes and stats must match kernels="plain" on the
     card; each fixture configuration must match its committed JAX render
     (tests/data/torch_port_*_ref.npz) within the CPU tests' tolerances;
     and BENCH_CFG through the general path must match the kernel path
     (emit floor and slot cap off);
  5. steady rays/s of the four slices (informational).

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

# Peak rates of one H100 SXM (NVIDIA's data sheet): device memory, float32
# outside the tensor cores. The special-function rate follows from the SM's
# layout: 16 special-function lanes beside 128 float32 lanes that count two
# operations (multiply-add) each, so 1/16 of the float32 rate.
HBM_BYTES_S = 3.35e12
FP32_OPS_S = 67e12
SFU_OPS_S = FP32_OPS_S / 16


def _time_ms(fn, reps: int = 10) -> float:
    """Device milliseconds per call: the CUDA time of every kernel, copy and
    memset that `reps` calls put on the card (torch.profiler), over reps.
    A wall-clock or CUDA-event time would measure the host's launch
    overhead for kernels shorter than their Python wrapper."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if str(e.device_type).endswith("CUDA"))
    if us <= 0:
        raise RuntimeError("the profiler recorded no device time")
    return us / 1e3 / reps


def _bits_equal(x, y) -> bool:
    import torch

    return x.shape == y.shape and bool(torch.equal(x.view(torch.int32), y.view(torch.int32)))


def _max_abs(x, y) -> float:
    return float((x.double() - y.double()).abs().max()) if x.numel() else 0.0


def _bound(nbytes: float, ops: float = 0.0, sfu: float = 0.0):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over their peak rates."""
    t_bytes = nbytes / HBM_BYTES_S
    t_ops = max(ops / FP32_OPS_S, sfu / SFU_OPS_S)
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


def _add(res: list, name, source, replaces, err, ms, plain_ms, bound, why_no_library):
    """Append one entry of the kernels line. No kernel here has a library
    call (one PyTorch call that computes the same function); the entry
    says why."""
    bound_ms, bound_by = bound
    res.append({
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": 0, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        "why_no_library": why_no_library})
    print(f"  {name}: max_abs_err {err:.3g}, kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {bound_ms:.5f} ms by {bound_by}, library "
          f"none: {why_no_library}", flush=True)


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
        with _knobs(IHT_PALLAS_TRACE="0"):
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
    for line in build.ptxas_report("trace_emit_kernel"):
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
    phase_kernels_general(ms, colour, device, res)

    print("[4] slices", flush=True)
    common = ["pack_rows", "pack_payload_blocks", "scatter_blocks_multi", "fused_scan"]
    prepass = ["pack_valid_blocks", "scatter_blocks", "pack_payload_blocks",
               "scatter_blocks_multi"]
    engines, counts, per_batch = {}, {}, {}
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
    # Launches of a kernel on the main path that runs it: the pool scene for
    # the blocked-pool trace, MS_CFG for the fold prepass, else BENCH_CFG.
    home = {"trace_emit_pool": "pool", "pack_valid_blocks": "ms", "scatter_blocks": "ms"}
    for k in res:
        k["launches"] = counts[home.get(k["name"], "bench")][k["name"]]
        k["launches_per_steady_batch"] = {n: per_batch[n][k["name"]] for n in per_batch}

    for name, eng in engines.items():
        rate = phase_rate(eng, 20 if name in ("bench", "pool") else 8)
        print(f"[5] {name} steady rate: {rate:.6g} rays/s (batch {BATCH}, "
              f"{eng.trace_path}) on {smi}", flush=True)
    print(f"total {time.time() - t_start:.1f} s", flush=True)

    print(json.dumps({"kernels": res}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
