#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises; the exit code is then non-zero):
  1. device: a CUDA device must be present; prints the card's name and
     power limit (nvidia-smi);
  2. build: compiles the port's CUDA kernels from csrc/ (nvcc, ctypes) and
     prints the trace, scan and sandwich kernels' register and spill
     reports;
  3. kernels: each kernel against its plain PyTorch twin on the card, at
     the main paths' shapes, with its error, both device times per call
     (torch.profiler; a timing that falls back to CUDA events is repeated
     and listed) and its bound (the least time the card could take), and
     the trace and scan kernels give the same bits twice.
     The static trace kernel (which packs its own blocks), the block kernels
     and the scan in both forms (per row; with the marker extraction) run at
     BENCH_CFG's shapes (batch 229376 = 112 x 2048 rays, P = 131072
     pixels, K = 64); the blocked-pool trace kernel at POOL_CFG's (the same
     batch as 1792 sampled pyramids, NF = 20 face slots, two renders); the
     fold prepass compact_rows (K6 and K3' in one pass, beside masked_select)
     and K6 alone (on no path now) at the rows of MS_CFG's dual render (one
     column) and of COLOR_CFG's render (two columns); the block scatter K3'
     at compact_valid's old shape and, with every column and the in-block
     permutation, at MS_CFG's steady continuation; the layer trace KL at
     the two calls of a steady batch of light_two_layer.r512's configuration
     (229376 and some 1.4 M lanes), its six outputs bit-equal to
     trace_layer_soa's, and KL's emit mode at the same calls, its outputs
     bit-equal to its plain twin's (trace_layer_soa, then layer_epilogue),
     each entry summing both layers; the fold's radix sort at
     BENCH_CFG's premerged rows at 512 x 256 and 2048 x 1024, beside
     torch.sort of the packed int64 word it replaced; the sandwich kernels (K7 lane, K8
     sublane), on no path of the engine, at 1388544 generated rows over a
     512 x 256 image against the 256 chunks that hold most of them, beside
     index_add_ on the same rows, plain and (extra lines) two-term; a
     stress launch of both on hot pixels (2^21 rows, 90% on three pixels:
     the plain version and the same bits twice), timed beside the same count
     of rows spread over the image, with the bound ("stress" in their
     entries of the kernels line); the fused scan on 2^21 rows crowded on
     one pixel and spread, each timed with its bound ("crowded" in its
     entry); the probe forms P1 and P2 at their probes' shapes;
  4. slices: Engine(cfg, device="cuda") renders BENCH_CFG and POOL_CFG (the
     trace kernel path), then MS_CFG, COLOR_CFG and light_two_layer.r512's
     configuration (the general trace path), each with the launch counters
     reset just before and read just
     after; every kernel of the path must have launched, on its steady
     batches too, and none that the path no longer runs (K1 after the trace
     kernel, K5 and the per-row scan on the spectral folds, K6 after
     compact_rows; K3' runs only in the continuations, one launch per
     layer boundary), the compactions' launches per steady batch printed
     for every slice, and KL's (one a layer on the general path, none on
     the trace kernel's: its emit mode on the two-layer document's layers,
     its render mode with the plain epilogue on MS_CFG's and COLOR_CFG's,
     each layer's epilogue and reason as Engine.layer_epilogue records
     them); image, lanes and stats must match kernels="plain" on the
     card; each fixture configuration must match its committed JAX render
     (tests/data/torch_port_*_ref.npz) within the CPU tests' tolerances;
     and BENCH_CFG through the general path must match the kernel path
     (emit floor and slot cap off). Then the two probes' own main paths
     (P1, P2);
  5. steady rays/s of the five slices (informational); then per scene
     (BENCH_CFG, POOL_CFG, MS_CFG, COLOR_CFG) the host loop: an eager and a
     CUDA-graph engine at IHT_STEPS_PER_DISPATCH=8, one calibrating and two
     steady dispatches each, bit for bit equal, one host read per steady
     dispatch and none per batch, each engine's rays/s, device busy time,
     kernels per batch and idle share, and overflow_replays;
  6. the bench entry (python -m ice_halo_sim_tpu_torch.bench) with three
     windows of 2 s; its JSON line;
  7. gradients: the differentiable render (engine/gradient.py, plain
     PyTorch on autograd, no kernel of its own), compiled as JAX compiles
     it (each form a captured forward and backward, engine/graph.py), on
     the tilted scene against the committed JAX render
     (tests/data/torch_port_grad_ref.npz, batch 16384) within the CPU tests'
     tolerances (grad_validation.fixture_check): frozen with the recorded
     choices, free (score term) and soft_tau; each compiled form against
     its eager body at batch 65536 (grad_validation.graph_check: images
     within the splat's tolerance, recorded choices bit for bit, seed_as_arg
     at two seeds); one call of each table function (per parameter the
     gradient and the loss through the captured seed_as_arg programs)
     against the eager step; then per mode at batch 65536 and per form
     (eager, graph) the ms per forward and per forward + backward, rays/s,
     device kernels, busy time, idle share, peak memory and the capture's
     ms;
  8. serving (engine/server.py, engine/checkpoint.py, gui/app.py):
     BENCH_CFG at full width through Server(device="cuda") (its default
     batch 229376), 64 batches from commit to wait_idle, the frame's raw
     XYZ and landed weights bit-equal to an Engine driven by the pump's own
     run calls (Server.grains(): one calibrating batch, then calls of
     PUMP_SECONDS over the last call's wall a batch; every CUDA graph
     captured in the pump's first two calls, none when the grain changes
     after them), the launch counters
     reset just before each served scene and read just after (every kernel
     of its path launched; listed as "launches_served" in the kernels
     line); the steady rays/s of Engine.run and of one batch a call, in
     turns; the Server's steady rate (an infinite budget) alone, with a
     reader at 4 Hz, and at the JAX server's grain (one batch a pump), and
     its share of Engine.run's (at least SERVER_SHARE_MIN); host reads per
     batch; acquire_frame at 512x256 and at COLOR_CFG's 1024x512, with the
     snapshot's post-process on the card and, in turns, on the host as
     before, and the uint8 images of the two within 1 level on at most
     POST_LEVEL_FRAC of the values; an
     appearance-only recommit (reused, generation kept); layout commits
     while pumping, BENCH_CFG -> MS_CFG (8 batches, its frame bit-equal to
     its Engine twin, which then times Engine.run on MS_CFG) -> MS_CFG
     (infinite: the Server's share of Engine.run's, at least
     SERVER_SHARE_MIN, and its grains) -> BENCH_CFG, whose latency may
     exceed the same commit on an idle server (the engine build) by at most
     PUMP_SECONDS and one MS_CFG batch, and the peak memory of the sequence;
     COLOR_CFG and POOL_CFG served for their launches; checkpoints of
     BENCH_CFG and MS_CFG (4 batches, save, load on the card, 4 more)
     bit-equal to 8 uninterrupted; the web GUI on the card (every
     endpoint); and a CUDA graph captured on a second thread while the main
     thread runs CUDA work;
  9. debug and C API: dump_rays (engine/debug.py) at full width on
     BENCH_CFG and POOL_CFG (every ray of the batch; its ms and records),
     the AoS trace under it against the SoA trace of the general path on
     the same inputs (entry_ok and paths exact, weights and live
     directions at rtol/atol 2e-5), and BENCH_CFG's first 4096 rays'
     records against the same dump on the CPU (rays, slots, paths and
     wavelengths exact); then the C API (kernels/capi.py builds libiht.so
     and iht_smoke from ice_halo_sim_tpu_torch/native/ with the host
     compiler): in this process through ctypes, IHT_CreateServer (cuda)
     commits BENCH_CFG for 64 batches, its sRGB bytes equal a
     Server(device="cuda")'s with the same seed and budget, the launch
     counters around its commit show K2, K3 and K4 ("launches_capi" in the
     kernels line), the steady rays/s of both; and iht_smoke in its own
     process on the card (exit 0, "iht_smoke OK");
 10. data parallel (parallel/sharding.py, parallel/distributed.py): a
     ShardedEngine over the mesh [cuda:0, cuda:0] (two shards on the one
     card; batch i launched on every shard before batch i + 1, checked on
     the first call) at full width renders BENCH_CFG (16 batches a shard:
     K2, K3, K4, graphs), POOL_CFG (2: K2b) and MS_CFG (4: compact_rows,
     K3', K4, the continuation), each in two calls with the launch counters
     reset just before and read just after (every kernel of the path
     launched; "launches_sharded" in the kernels line); every render and the
     landed weights bit-equal to two Engines at shards (0, 2) and (1, 2)
     given the same calls, summed in shard order; the graph mode, host reads
     per dispatch, the sharded rays/s against one Engine.run of as many batches in turns, and the
     drain's ms. Then two ranks on the one card: this script as two worker
     processes (--rank-worker), each a MultiHostEngine of one shard on
     cuda:0 through gloo, BENCH_CFG for 8 batches and MS_CFG for 2; their
     images bit-equal to each other and to the single-process run's after
     as many batches, and their combined rays/s. A rank that fails or
     outlives RANK_TIMEOUT fails the phase. With more than one card
     (phase_cards), the mesh of all cards runs the three scenes the
     same way (one Engine per card as the twins), and one NCCL rank per
     card runs the two rank scenes (bit-equal between the ranks, within
     rtol 1e-6 of the single-process run); with one card it prints that
     this part did not run;
 11. the reference bench scenes (scenes.py's stand-ins): MULTI_CFG,
     COMPLEX_CFG and BD_CFG at full width (229376 rays a batch) and
     PYRAMID3_CFG (32768: its fan-out makes a root ray about 100 times the
     work) through the sort fold, one calibrating and two steady batches
     each, the launch counters reset just before and read just after (K3'
     at every layer boundary, compact_rows and K4 on the steady batches
     too; "launches_scenes" in the kernels line); each kernel they launch
     against its plain twin at their own shapes (compact_rows and K3'
     bit-equal and the same bits twice, the fold through K4 within
     SCAN_RTOL); the three two-layer ones also against kernels="plain"
     engines on the card, the pyramid so at 2048 rays a batch; the
     pyramid's peak memory. BENCH_CFG at 2048 x 1024 (P = 2^21) through K2,
     K3 and K4 against the plain path, and K3 with the marker tail and K4
     at those shapes ("at_2048x1024").

The last lines of standard output are the kernels JSON object, the card
(nvidia-smi) and the device JSON object. Imports nothing of JAX and
nothing of the JAX package.
"""

from __future__ import annotations

import copy
import faulthandler
import gc
import json
import os
import subprocess
import sys
import time

from portbench.metrics._peaks import FP32_OPS_S, HBM_BYTES_S, SFU_OPS_S, least_seconds
from portbench.metrics.trace_roofline import trace_work

# A fault in native code prints every thread's Python stack to stderr.
faulthandler.enable()

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
# Sandwich tile entries, kernel against plain version: a block adds its rows
# to a cell one by one in float32, and the row splits' partial tiles are
# added in float32; the plain version sums in float64 and rounds once.
# atol is a fraction of the largest entry. `matched` is bit-equal.
TILE_RTOL, TILE_ATOL_FRAC = 1e-4, 1e-5
# Batches per dispatch of phase [5]'s eager and graph engines.
GRAPH_K = 8


class _Ms(float):
    """A time in ms that remembers how it was taken."""
    by = "profiler"


# Every timing whose first measurement fell back to CUDA events: (what,
# reps, how the repeats went). Printed at the end of the run.
FALLBACKS: list = []


def _time_ms(fn, reps: int = 10, what: str = "") -> float:
    """Device milliseconds per call: the CUDA time of every kernel, copy and
    memset that `reps` calls put on the card (torch.profiler), over reps.
    A wall-clock or CUDA-event time would measure the host's launch
    overhead for kernels shorter than their Python wrapper; the port's
    `device_ms` falls back to events only when the profiler returns nothing,
    and the time then says so (`by`, `timed_by` in the kernels line). A
    measurement that fell back is repeated, up to twice, and the fallback
    recorded in FALLBACKS."""
    from ice_halo_sim_tpu_torch.probe_sandwich import device_ms, timed_by

    tries = []
    for _ in range(3):
        timed_by()
        ms = _Ms(device_ms(fn, reps))
        ms.by = timed_by()
        tries.append(ms.by)
        if ms.by == "profiler":
            break
    if len(tries) > 1 or tries[0] != "profiler":
        FALLBACKS.append({"what": what, "reps": reps, "tries": tries})
    return ms


def _timed_by(*times) -> str:
    return "cuda events" if any(getattr(t, "by", "profiler") != "profiler"
                                for t in times) else "profiler"


def _bits_equal(x, y) -> bool:
    import torch

    return x.shape == y.shape and bool(torch.equal(x.view(torch.int32), y.view(torch.int32)))


def _max_abs(x, y) -> float:
    return float((x.double() - y.double()).abs().max()) if x.numel() else 0.0


def _trace_bound(name, plan):
    """The bound of one trace_emit call, with its counts written out."""
    nbytes, ops, sfu = trace_work(plan)
    print(f"  {name} work: {nbytes} bytes; per ray {ops // plan.batch} arithmetic and "
          f"{sfu // plan.batch} special-function operations "
          f"({1e3 * nbytes / HBM_BYTES_S:.5f} ms of bytes, {1e3 * ops / FP32_OPS_S:.5f} ms "
          f"of arithmetic, {1e3 * sfu / SFU_OPS_S:.5f} ms of special functions)", flush=True)
    return least_seconds(nbytes, ops, sfu)


def _add(res: list, name, source, replaces, err, ms, plain_ms, bound, why_no_library=None,
         library_ms=None, library=None):
    """Append one entry of the kernels line. Where one PyTorch call computes
    the same function, its time on the same inputs and its name (it is
    timed here and used nowhere in the port); else the entry says why there
    is none."""
    bound_ms, bound_by = 1e3 * bound[0], bound[1]
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


def _check_trace(name, out_k, out_p, again):
    """Hold one trace_emit output against its twin's, and against `again`,
    a second launch on the same inputs (the same bits); returns
    max_abs_err."""
    import torch

    from ice_halo_sim_tpu_torch.core import trace_emit

    same = all(_bits_equal(x, y) for ra, rb in zip(out_k[0], again[0]) for x, y in zip(ra, rb))
    if not same or not all(_bits_equal(x.reshape(-1), y.reshape(-1))
                           for x, y in zip(out_k[1:3], again[1:3])):
        raise AssertionError(f"{name}: two launches on the same inputs differ")
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


def _packed_word_sort(keys, w):
    """The fold's sort before the radix sort, as its yardstick (used nowhere
    in the port): torch.sort of one int64 per row (the key XOR 2^31 in the
    high word, the weight's bits in the low word), with its pack and unpack."""
    import torch

    hi = (keys ^ -(1 << 31)).to(torch.int64)
    lo = w.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    s, _ = torch.sort(hi * (1 << 32) + lo)
    sw = s & 0xFFFFFFFF
    sw = torch.where(sw >= 1 << 31, sw - (1 << 32), sw).to(torch.int32).view(torch.float32)
    return (s >> 32).to(torch.int32) ^ -(1 << 31), sw


def _radix_sort_check(keys, w, end_bit: int, what: str) -> dict:
    """The radix sort on the premerged fold's rows against its plain twin
    (bit for bit), twice the same bits, the same key order as the packed
    word's sort; its time, the twin's and the packed word sort's; bounds:
    one read and one write of key and weight (16 B a row), and its passes'
    traffic (16 B a row a pass and the histogram's 4 B)."""
    from ice_halo_sim_tpu_torch.core import radix_sort

    got = radix_sort.sort_pairs(keys, w, end_bit)
    want = radix_sort.sort_pairs_plain(keys, w, end_bit)
    again = radix_sort.sort_pairs(keys, w, end_bit)
    if not (_bits_equal(got[0], want[0]) and _bits_equal(got[1], want[1])
            and _bits_equal(again[0], got[0]) and _bits_equal(again[1], got[1])):
        raise AssertionError(f"radix_sort at {what} differs from its plain twin or itself")
    if not _bits_equal(got[0], _packed_word_sort(keys, w)[0]):
        raise AssertionError(f"radix_sort at {what} orders the keys unlike the packed sort")
    m, n = keys.numel(), radix_sort.passes(end_bit)
    out = {"rows": m, "end_bit": end_bit, "passes": n, "max_abs_err": 0.0,
           "ms": _time_ms(lambda: radix_sort.sort_pairs(keys, w, end_bit), 10,
                          f"radix_sort {what}"),
           "plain_ms": _time_ms(lambda: radix_sort.sort_pairs_plain(keys, w, end_bit), 5),
           "library_ms": _time_ms(lambda: _packed_word_sort(keys, w), 10,
                                  f"packed word sort {what}"),
           "bound": least_seconds(16 * m), "bound_passes": least_seconds((16 * n + 4) * m)}
    print(f"  radix_sort at {what}: {m} rows, end_bit {end_bit}, {n} passes, kernel "
          f"{out['ms']:.4f} ms, plain {out['plain_ms']:.4f} ms, packed word sort "
          f"{out['library_ms']:.4f} ms, bound {1e3 * out['bound'][0]:.5f} ms (one pass), "
          f"{1e3 * out['bound_passes'][0]:.5f} ms ({n} passes)", flush=True)
    return out


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

    # K2 (with the block pack inside) against the plain twin.
    args = (plan, base, BATCH, device)
    out_k = trace_emit.trace_emit(*args)
    out_p = trace_emit.trace_emit_plain(*args)
    err = _check_trace("trace_emit", out_k, out_p, trace_emit.trace_emit(*args))
    keys, wts, counts = out_k[0][0]
    _add(res, "trace_emit", "ice_halo_sim_tpu_torch/csrc/trace_emit.cu",
            "ice_halo_sim_tpu/core/pallas_trace.py:318", err,
            _time_ms(lambda: trace_emit.trace_emit(*args), 5, "trace_emit"),
            _time_ms(lambda: trace_emit.trace_emit_plain(*args), 2),
            _trace_bound("trace_emit", plan),
            "a per-ray Monte-Carlo trace loop is no library function")

    # K1: the in-block pack on the uncompacted slab (its kernel serves K5
    # and K6; the trace kernel packs its own rows).
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
            least_seconds(16 * n + 4 * (n // rb), 2 * n), no_lib_pack)

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
    _scatter_same_bits("the bench rows", [wts], start, keep, rb)
    # The scatter reads the live rows it places and writes every output row.
    _add(res, "scatter_blocks_multi", "ice_halo_sim_tpu_torch/csrc/block_ops.cu",
            "ice_halo_sim_tpu/core/pallas_ops.py:436", 0.0,
            _time_ms(lambda: block_ops.scatter_blocks_multi(*sargs, marker_tail=tail)),
            _time_ms(lambda: block_ops.scatter_blocks_multi_plain(*sargs, marker_tail=tail)),
            least_seconds(8 * live + 4 * start.numel() + 8 * out_total, 2 * out_total),
            "blocks overwrite each other in order; scatter_ and "
                           "index_copy_ leave overlapping writes undefined")
    k3p = _time_ms(lambda: block_ops.scatter_blocks([wts], start, keep, rb))
    k3p_plain = _time_ms(lambda: block_ops.scatter_blocks_plain([wts], start, keep, rb))
    k3p_bound = _scatter_bound(1, _covered_rows(start, keep, rb), keep, start.numel(), False)
    print(f"  scatter_blocks (K3', one column) at the bench rows: kernel {k3p:.4f} "
          f"ms, plain {k3p_plain:.4f} ms, bound {1e3 * k3p_bound[0]:.5f} ms by {k3p_bound[1]}",
          flush=True)

    # The radix sort of the premerged rows; K4 with key2 on its output.
    ck, cw = a
    rs = _radix_sort_check(ck, cw, accum.sort_end_bit(P, K), "512 x 256")
    _add(res, "radix_sort", "ice_halo_sim_tpu_torch/csrc/radix_sort.cu",
         "none: XLA's lax.sort in ice_halo_sim_tpu/core/accum.py", 0.0, rs["ms"],
         rs["plain_ms"], rs["bound"], library_ms=rs["library_ms"],
         library="torch.sort of the packed int64 word, with its pack and unpack")
    res[-1].update(rows=rs["rows"], end_bit=rs["end_bit"], passes=rs["passes"],
                   bound_passes_ms=1e3 * rs["bound_passes"][0])
    sk, sw = accum.sort_keys(ck, cw, eng.ks, accum.sort_end_bit(P, K))
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
    if not _bits_equal(seg_scan.fused_scan_call(sk, sw, tbl, shift, K, True)[0][1], ca[1]):
        raise AssertionError("fused_scan: two launches on the same rows differ")
    # Per row: 8 bytes read, three channels and key2 written (16 bytes).
    _add(res, "fused_scan", "ice_halo_sim_tpu_torch/csrc/seg_scan.cu",
            "ice_halo_sim_tpu/core/pallas_scan.py:144", err,
            _time_ms(lambda: seg_scan.fused_scan_call(sk, sw, tbl, shift, K, True), 10,
                     "fused_scan"),
            _time_ms(lambda: seg_scan.fused_scan_call_plain(sk, sw, tbl, shift, K, True)),
            least_seconds(8 * m + 4 * tbl.numel() + 16 * m, 8 * m),
            "a segmented scan with a basis expansion; cumsum has "
                           "no segments")
    res[-1]["rows"] = m

    # K4 in its extract form, as both spectral folds call it: the scan and
    # the marker extraction in one launch, against the per-row scan + K5 +
    # K3 (plain), and the same bits twice.
    img_k = seg_scan.fused_scan_extract(sk, sw, tbl, shift, K, P)
    img_p = seg_scan.fused_scan_extract_plain(sk, sw, tbl, shift, K, P)
    err = _max_abs(img_k, img_p)
    if not torch.allclose(img_k, img_p, rtol=SCAN_RTOL, atol=1e-6):
        raise AssertionError(f"fused_scan_extract differs from its plain twin (max abs {err})")
    if not _bits_equal(seg_scan.fused_scan_extract(sk, sw, tbl, shift, K, P), img_k):
        raise AssertionError("fused_scan_extract: two launches on the same rows differ")
    ks = eng.ks

    def per_row_then_k5_k3():
        chans, key2 = seg_scan.fused_scan_call(sk, sw, tbl, shift, K, True)
        return accum._marker_extract(key2, chans, P, ks)

    if not torch.allclose(per_row_then_k5_k3(), img_k, rtol=SCAN_RTOL, atol=1e-6):
        raise AssertionError("fused_scan_extract differs from the per-row scan + K5 + K3")
    # Bytes: the rows read once (8 each), the image written once (12 per
    # pixel), the table; operations: the basis product and the float64 add
    # of three channels per row.
    _add(res, "fused_scan_extract", "ice_halo_sim_tpu_torch/csrc/seg_scan.cu",
         "ice_halo_sim_tpu/core/pallas_scan.py:144", err,
         _time_ms(lambda: seg_scan.fused_scan_extract(sk, sw, tbl, shift, K, P), 10,
                  "fused_scan_extract"),
         _time_ms(lambda: seg_scan.fused_scan_extract_plain(sk, sw, tbl, shift, K, P)),
         least_seconds(8 * m + 12 * P + 4 * tbl.numel(), 6 * m),
         "a segmented scan with a basis expansion and a write at the run ends; "
         "cumsum has no segments")
    res[-1].update(rows=m, pixels=P)
    res[-1]["crowded"] = _scan_crowded(device, tbl, shift, K, P)
    ms_old = _time_ms(per_row_then_k5_k3, 10, "per-row scan + K5 + K3")
    print(f"  the same image by the per-row scan, then K5 + K3 (the marker extraction "
          f"before the fused form): {ms_old:.4f} ms", flush=True)

    # K5 on the scan output (the marker extraction's pack).
    a = block_ops.pack_payload_blocks(k2a, ca, P, accum.BLOCK)
    b = block_ops.pack_payload_blocks_plain(k2a, ca, P, accum.BLOCK)
    if not (all(_bits_equal(x, y) for x, y in zip(a[0], b[0])) and _bits_equal(a[1], b[1])):
        raise AssertionError("pack_payload_blocks (K5) differs from its plain twin")
    _add(res, "pack_payload_blocks", "ice_halo_sim_tpu_torch/csrc/block_ops.cu",
            "ice_halo_sim_tpu/core/pallas_ops.py:365", 0.0,
            _time_ms(lambda: block_ops.pack_payload_blocks(k2a, ca, P, accum.BLOCK)),
            _time_ms(lambda: block_ops.pack_payload_blocks_plain(k2a, ca, P, accum.BLOCK)),
            least_seconds(16 * m + 12 * m + 4 * (m // accum.BLOCK), 2 * m),
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
    args = (plan, base, BATCH, device, ptbl, ttbl)
    out_k = trace_emit.trace_emit(*args)
    torch.cuda.synchronize()
    out_p = trace_emit.trace_emit_plain(*args)
    err = _check_trace("trace_emit_pool", out_k, out_p, trace_emit.trace_emit(*args))
    _add(res, "trace_emit_pool", "ice_halo_sim_tpu_torch/csrc/trace_emit.cu",
            "ice_halo_sim_tpu/core/pallas_trace.py:382", err,
            _time_ms(lambda: trace_emit.trace_emit(*args), 5, "trace_emit_pool"),
            _time_ms(lambda: trace_emit.trace_emit_plain(*args), 1),
            _trace_bound("trace_emit_pool", plan),
            "a per-ray Monte-Carlo trace loop is no library function")
    sampler_ms = _time_ms(lambda: eng._pool_tables(bc), 3)
    print(f"  pool sampler (plain torch, {plan.pool_k} pyramids): {sampler_ms:.4f} ms "
          "device time per batch", flush=True)


def layer_work(B: int, H: int, nf: int, T: int):
    """(bytes, arithmetic operations, special-function operations) of one
    KL call over B lanes, in the units of trace_work (portbench's count of
    the trace kernel: U, DS and the per-face and Fresnel counts are the
    trace kernel's; nothing depends on the data).
    Bytes: each input read once (72 per lane: seed and ray index as int64,
    direction, weight, refractive index and 9 rotation components), each
    output written once (20 per exit slot and the entry flag), the shape's
    tables once. Operations per lane: inverse rotation 15; entry 16 per
    triangle row, 3 U, point 12; the entry Fresnel split and slot 0's
    rotation; plane distances 7 per face slot; per bounce per face slot
    15 + 1 division and 2 for the distance update, a Fresnel split, exit
    cosine 5, rotation 15, state selects 8."""
    U, DS = 24, 8
    fres_ops, fres_sfu = 42 + 7 * DS, 7
    ops = 15 + 16 * T + 3 * U + 12 + fres_ops + 15 + 7 * nf
    ops += (H - 1) * (nf * (15 + DS + 2) + fres_ops + 5 + 15 + 8)
    sfu = fres_sfu + (H - 1) * (nf + fres_sfu)
    nbytes = B * (72 + 20 * H + 1) + 4 * (5 * nf + 13 * T)
    return nbytes, ops * B, sfu * B


def layer_emit_bytes(B: int, H: int, rows: int, n_rp: int, last: bool, nf: int, T: int) -> int:
    """Bytes of one call of KL's emit mode over B lanes: the render mode's
    inputs and shape tables once; per lane a pixel and a weight per kept row
    of each (render, pass) column, its segment count and dropped mass, and,
    on a layer that is not the last, the continuation's direction and
    weight per exit slot."""
    return B * (72 + 8 * rows * n_rp + 8 + (0 if last else 16 * H)) + 4 * (5 * nf + 13 * T)


def _two_layer_doc() -> dict:
    with open(os.path.join(ROOT, "portbench", "configs", "light_two_layer_ms.json")) as f:
        return json.load(f)["document"]


def phase_kernel_layer(device, res: list):
    """KL (csrc/trace_layer.cu) at light_two_layer.r512's shapes: the two
    layer-trace calls of a steady batch of the cell's configuration
    (portbench/configs/light_two_layer_ms.json, batch 229376), recorded from
    an engine on the plain kernel set (the emit mode's calls). Per call, the
    render mode's six outputs bit-equal to trace_layer_soa's and the emit
    mode's to its plain twin's (trace_layer_soa, then layer_epilogue), each
    the same bits twice; each kernel, its bound and the plain function timed
    per layer; each entry sums both layers."""
    import torch

    from ice_halo_sim_tpu_torch.config.loader import load_project
    from ice_halo_sim_tpu_torch.core import trace_soa
    from ice_halo_sim_tpu_torch.engine.simulator import Engine

    eng = Engine(load_project(_two_layer_doc()), seed=7, batch_size=BATCH, device=device,
                 kernels="plain")
    calls = []
    real = eng.ks.trace_layer_emit

    def record(*args, **kw):
        calls.append((args, kw))
        return real(*args, **kw)

    eng.ks = eng.ks._replace(trace_layer_emit=record)
    eng.run(n_batches=1)                         # calibrates cap and lanes
    calls.clear()
    eng.run(n_batches=1)
    if len(calls) != 2 or eng.layer_epilogue != ["kernel", "kernel"]:
        raise AssertionError(f"two_layer: {len(calls)} emit-mode calls in a steady batch, "
                             f"epilogues {eng.layer_epilogue}")

    def raw(x):
        return x.view(torch.int32) if x.dtype == torch.float32 else x

    def same(what, outs):
        for field, *xs in outs:
            if not all(torch.equal(raw(xs[0]), raw(x)) for x in xs[1:]):
                raise AssertionError(f"{what}: {field} differs from the plain function or "
                                     f"between two launches")

    def rows_fields(r):
        return ([("pix", x) for x in r.pix] + [("w", x) for x in r.w]
                + [("seg", r.seg), ("dropped", r.dropped)] + [("cont", x) for x in r.cont or ()])

    tot = {m: {"ms": 0.0, "plain_ms": 0.0, "bytes": 0, "ops": 0, "sfu": 0, "by": [],
               "layers": []} for m in ("trace_layer", "trace_layer_emit")}
    for li, (args, kw) in enumerate(calls):
        blocks = kw["setting_blocks"]
        got = trace_soa.trace_layer_cuda(*args, setting_blocks=blocks)
        again = trace_soa.trace_layer_cuda(*args, setting_blocks=blocks)
        torch.cuda.synchronize()
        want = trace_soa.trace_layer_soa(*args, setting_blocks=blocks)
        same(f"trace_layer layer {li + 1}", zip(want._fields, got, want, again))
        e_got = trace_soa.trace_layer_emit_cuda(*args, **kw)
        e_again = trace_soa.trace_layer_emit_cuda(*args, **kw)
        torch.cuda.synchronize()
        e_want = trace_soa.trace_layer_emit_plain(*args, **kw)
        same(f"trace_layer_emit layer {li + 1}",
             [(f, a, b, c) for (f, a), (_, b), (_, c) in
              zip(rows_fields(e_got), rows_fields(e_want), rows_fields(e_again))])
        B, H = args[1].shape[0], args[7]
        nf, T = args[5].plane_n.shape[1], args[5].tri_face.shape[1]
        spec = kw["spec"]
        nbytes, ops, sfu = layer_work(B, H, nf, T)
        emit_bytes = layer_emit_bytes(B, H, spec.cap, len(e_got.pix), spec.last, nf, T)
        live = int((args[3] > 0).sum())
        for mode, fn, plain, nb in (
                ("trace_layer", lambda: trace_soa.trace_layer_cuda(*args, setting_blocks=blocks),
                 lambda: trace_soa.trace_layer_soa(*args, setting_blocks=blocks), nbytes),
                ("trace_layer_emit", lambda: trace_soa.trace_layer_emit_cuda(*args, **kw),
                 lambda: trace_soa.trace_layer_emit_plain(*args, **kw), emit_bytes)):
            ms = _time_ms(fn, 10, f"{mode} layer {li + 1}")
            plain_ms = _time_ms(plain, 3)
            bound = least_seconds(nb, ops, sfu)
            print(f"  {mode} layer {li + 1}: {B} lanes ({live} of weight > 0), max_hits {H}, "
                  f"NF {nf}, T {T}, cap {spec.cap}, prob {spec.prob}, last {spec.last}: "
                  f"bit-equal, the same bits twice; kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, bound {1e3 * bound[0]:.5f} ms by {bound[1]} ({nb} bytes, "
                  f"{ops // B} operations and {sfu // B} special-function operations a lane)",
                  flush=True)
            t = tot[mode]
            t["layers"].append({"lanes": B, "ms": ms, "plain_ms": plain_ms,
                                "bound_ms": 1e3 * bound[0]})
            t["by"].append(ms)
            for k, v in (("ms", ms), ("plain_ms", plain_ms), ("bytes", nb), ("ops", ops),
                         ("sfu", sfu)):
                t[k] += v
    for mode, replaces in (
            ("trace_layer", "none (the JAX general trace is XLA: ice_halo_sim_tpu/core/trace_soa.py)"),
            ("trace_layer_emit", "none (the JAX general trace and its gates, slot cap and "
             "projection are XLA: ice_halo_sim_tpu/engine/simulator.py)")):
        t = tot[mode]
        ms = _Ms(t["ms"])
        ms.by = _timed_by(*t["by"])
        _add(res, mode, "ice_halo_sim_tpu_torch/csrc/trace_layer.cu", replaces, 0.0, ms,
             t["plain_ms"], least_seconds(t["bytes"], t["ops"], t["sfu"]),
             "a per-lane Monte-Carlo trace loop is no library function")
        res[-1]["layers"] = t["layers"]
    del eng, calls
    torch.cuda.empty_cache()


def _fold_rows(eng, render: int, batch_counter: int):
    """One steady batch's packed fold rows of a general-path engine: (key,
    weight, mask or None), padded to the 4096-row block."""
    from ice_halo_sim_tpu_torch.core import accum
    from ice_halo_sim_tpu_torch.engine.simulator import pack_rows

    contribs = eng._trace_batch_impl(batch_counter)[0]
    P = eng.accum[render].shape[0]
    key, wz, mcol = pack_rows(contribs[render], P, eng.k_pool, bool(eng.color_classes))
    cols = [wz] + ([mcol] if mcol is not None else [])
    key, cols = accum._pad_cols(key, cols, accum.BLOCK)
    return key, cols


def _covered_rows(start, out_len: int, blk: int) -> int:
    """Output rows of a block scatter that take a value of a block (the rest
    are zero): the rows it reads, per column."""
    import torch

    p = torch.arange(out_len, device=start.device, dtype=torch.int64)
    st = start.long()
    g = torch.searchsorted(st, p, right=True) - 1
    return int(((g >= 0) & (p - st[g.clamp_min(0)] < blk)).sum())


def _scatter_bound(ncols: int, covered: int, out_len: int, n_blocks: int, perm: bool):
    """The block scatter's bound: every output row written once per column,
    every covered row read once per column (and its permutation entry), the
    starts read once."""
    return least_seconds(4 * ncols * (out_len + covered) + (4 * covered if perm else 0)
                         + 4 * n_blocks)


def _continuation_scatter(eng, batch_counter: int) -> list:
    """The block scatter's arguments at every layer boundary of one steady
    batch of a general-path engine (the continuation's compact_by_key),
    captured from the engine's own calls."""
    calls = []
    ks = eng.ks

    def capture(vals, start, out_len, block, perm=None):
        calls.append((vals, start, out_len, block, perm))
        return ks.scatter_blocks(vals, start, out_len, block, perm=perm)

    eng.ks = ks._replace(scatter_blocks=capture)
    try:
        eng._trace_batch_impl(batch_counter)
    finally:
        eng.ks = ks
    return calls


def _scatter_same_bits(what, vals, start, out_len, block, perm=None):
    """The block scatter (K3') against its plain version and against its own
    second launch: bit-equal or the run fails."""
    from ice_halo_sim_tpu_torch.core import block_ops

    a = block_ops.scatter_blocks(vals, start, out_len, block, perm=perm)
    b = block_ops.scatter_blocks_plain(vals, start, out_len, block, perm=perm)
    again = block_ops.scatter_blocks(vals, start, out_len, block, perm=perm)
    if not all(_bits_equal(x, y) for x, y in zip(a, b)):
        raise AssertionError(f"scatter_blocks (K3') at {what} differs from its plain version")
    if not all(_bits_equal(x, y) for x, y in zip(a, again)):
        raise AssertionError(f"scatter_blocks (K3') at {what}: two launches differ")


def phase_kernels_general(ms_cfg, color_cfg, device, res: list):
    """The general path's compactions at its shapes. compact_rows (K6 and K3'
    in one pass) against its plain version (the plain K6 and K3' composed)
    at the fold rows of MS_CFG's dual render (one column) and of COLOR_CFG's
    render (two columns), beside masked_select of every column; K6 at the
    same rows (no path runs it since compact_rows); the block scatter K3' at
    compact_valid's old shape (K6's packed column to keep) and at every layer
    boundary of MS_CFG's steady continuation (every column with the in-block
    permutation, one launch). Bit-equal and the same bits twice, or the run
    fails."""
    import torch

    from ice_halo_sim_tpu_torch.core import accum, block_ops
    from ice_halo_sim_tpu_torch.engine.simulator import Engine
    from ice_halo_sim_tpu_torch.kernels import kernel_set

    block = accum.BLOCK
    src = "ice_halo_sim_tpu_torch/csrc/block_ops.cu"
    no_lib_pack = ("a per-block stable partition takes a sort of flags plus a "
                   "gather, no single call")
    no_lib_scatter = ("blocks overwrite each other in order; scatter_ and index_copy_ "
                      "leave overlapping writes undefined")
    for name, cfg in (("ms", ms_cfg), ("color", color_cfg)):
        eng = Engine(cfg, seed=7, batch_size=BATCH, device=device)
        if eng.trace_path != "general":
            raise AssertionError(f"{name}: trace path {eng.trace_path}")
        eng.run(n_batches=1)                         # calibrates cap, lanes, keep
        keep = eng._compact_keep[0] if eng._compact_keep else None
        key, cols = _fold_rows(eng, 0, 5)
        N, G, C = key.numel(), key.numel() // block, len(cols)
        print(f"  {name}: rows per render {eng._rows_per_render} (slot cap {eng._slot_cap}, "
              f"lanes per layer {[l.cont_cap for l in eng.layers]}), fold rows N = {N} in "
              f"{G} blocks, {C} column(s), keep {eng._compact_keep}", flush=True)
        if N < eng._rows_per_render[0] or N - eng._rows_per_render[0] >= block:
            raise AssertionError(f"{name}: fold rows {N} vs plan {eng._rows_per_render[0]}")

        # compact_rows, as compact_valid calls it.
        a, na = block_ops.compact_rows(key, cols, keep, block)
        b, nb = block_ops.compact_rows_plain(key, cols, keep, block)
        again, _ = block_ops.compact_rows(key, cols, keep, block)
        if int(na) != int(nb) or not all(_bits_equal(x, y) for x, y in zip(a, b)):
            raise AssertionError(f"compact_rows differs from its plain version at the {name} rows")
        if not all(_bits_equal(x, y) for x, y in zip(a, again)):
            raise AssertionError(f"compact_rows: two launches at the {name} rows differ")
        live = int(na)
        if live > keep:
            raise AssertionError(f"{name}: keep {keep} does not hold the {live} live rows")

        def masked():
            kept = key != -1
            return [x.masked_select(kept) for x in (key, *cols)]

        ms_b = _time_ms(lambda: block_ops.compact_rows(key, cols, keep, block), 10,
                        f"compact_rows {name}")
        ms_bp = _time_ms(lambda: block_ops.compact_rows_plain(key, cols, keep, block), 3)
        ms_lib = _time_ms(masked)
        bound = least_seconds(4 * (1 + C) * (N + keep))
        if name == "ms":
            _add(res, "compact_rows", src, "ice_halo_sim_tpu/core/accum.py:326", 0.0, ms_b,
                 ms_bp, bound, library_ms=ms_lib, library="masked_select of every column")
            res[-1].update(rows=N, keep=keep, columns=1 + C)
        else:
            print(f"  compact_rows at the color rows (key and two columns): bit-equal, the "
                  f"same bits twice, kernel {ms_b:.4f} ms, plain {ms_bp:.4f} ms, bound "
                  f"{1e3 * bound[0]:.5f} ms by {bound[1]}, masked_select {ms_lib:.4f} ms",
                  flush=True)
        print(f"  {name}: live rows {live} of {N}", flush=True)

        # K6 (its kernel and wrapper stay; no path runs them).
        pk = block_ops.pack_valid_blocks(key, cols, 0xFFFFFFFF, block)
        pp = block_ops.pack_valid_blocks_plain(key, cols, 0xFFFFFFFF, block)
        if not all(_bits_equal(x, y) for x, y in zip([pk[0], *pk[1], pk[2]],
                                                     [pp[0], *pp[1], pp[2]])):
            raise AssertionError(f"pack_valid_blocks (K6) differs from its plain version "
                                 f"at the {name} rows")
        # A general threshold besides: rows below a pixel's first key.
        thresh = (eng.accum[0].shape[0] // 3) << accum.key_shift(eng.k_pool)
        a2 = block_ops.pack_valid_blocks(key, cols, thresh, block)
        b2 = block_ops.pack_valid_blocks_plain(key, cols, thresh, block)
        if not all(_bits_equal(x, y) for x, y in
                   zip([a2[0], *a2[1], a2[2]], [b2[0], *b2[1], b2[2]])):
            raise AssertionError(f"pack_valid_blocks (K6) differs at threshold {thresh}")
        ms_k = _time_ms(lambda: block_ops.pack_valid_blocks(key, cols, 0xFFFFFFFF, block))
        ms_p = _time_ms(lambda: block_ops.pack_valid_blocks_plain(key, cols, 0xFFFFFFFF, block), 3)
        bound = least_seconds((1 + C) * 8 * N + 4 * G, 2 * N)
        if name == "ms":
            _add(res, "pack_valid_blocks", src, "ice_halo_sim_tpu/core/pallas_ops.py:301", 0.0,
                 ms_k, ms_p, bound, no_lib_pack)
            res[-1]["rows"] = N
        else:
            print(f"  pack_valid_blocks at the color rows (two columns): bit-equal, kernel "
                  f"{ms_k:.4f} ms, plain {ms_p:.4f} ms, bound {1e3 * bound[0]:.5f} ms by "
                  f"{bound[1]}", flush=True)
        if name != "ms":
            continue

        # K3' at compact_valid's old shape: K6's packed column, out_len = keep.
        start = accum._exclusive_starts(pk[2])
        col = [pk[1][0].view(G, block)]
        _scatter_same_bits("compact_valid's old shape", col, start, keep, block)
        cov = _covered_rows(start, keep, block)
        k3p_bound = _scatter_bound(1, cov, keep, G, False)
        print(f"  scatter_blocks (K3') at compact_valid's old shape (one column, {G} blocks "
              f"to keep {keep}, {cov} rows covered): bit-equal, the same bits twice, kernel "
              f"{_time_ms(lambda: block_ops.scatter_blocks(col, start, keep, block)):.4f} ms, "
              f"plain {_time_ms(lambda: block_ops.scatter_blocks_plain(col, start, keep, block), 3):.4f}"
              f" ms, bound {1e3 * k3p_bound[0]:.5f} ms by {k3p_bound[1]}", flush=True)
        # compact_valid whole against its plain composition.
        cv = accum.compact_valid(key, cols, keep, eng.ks)
        cp = accum.compact_valid(key, cols, keep, kernel_set("plain"))
        if not all(_bits_equal(p, q) for p, q in zip(cv[0], cp[0])) or int(cv[1]) != int(cp[1]):
            raise AssertionError("compact_valid differs between the kernel sets")

        # K3' at the steady continuation: every column, the block order.
        calls = _continuation_scatter(eng, 5)
        if not calls or any(c[4] is None for c in calls):
            raise AssertionError(f"ms: the continuation made no permuted block scatter ({calls})")
        for li, (vals, start, out_len, blk, perm) in enumerate(calls):
            _scatter_same_bits(f"the continuation (boundary {li})", vals, start, out_len, blk,
                               perm)
            cov = _covered_rows(start, out_len, blk)
            bound = _scatter_bound(len(vals), cov, out_len, start.numel(), True)
            ms_k = _time_ms(lambda: block_ops.scatter_blocks(vals, start, out_len, blk,
                                                             perm=perm), 10, "scatter_blocks")
            ms_p = _time_ms(lambda: block_ops.scatter_blocks_plain(vals, start, out_len, blk,
                                                                   perm=perm), 3)
            print(f"  scatter_blocks (K3') at the continuation, boundary {li}: {len(vals)} "
                  f"columns and the permutation, {start.numel()} blocks of {blk} to {out_len} "
                  f"rows ({cov} covered): kernel {ms_k:.4f} ms, plain {ms_p:.4f} ms, bound "
                  f"{1e3 * bound[0]:.5f} ms by {bound[1]}", flush=True)
            if li == 0:
                _add(res, "scatter_blocks", src, "ice_halo_sim_tpu/core/pallas_ops.py:549", 0.0,
                     ms_k, ms_p, bound, no_lib_scatter)
                res[-1].update(rows=out_len, columns=len(vals), permutation=True)
        del eng
        torch.cuda.empty_cache()


SANDWICH_SRC = "ice_halo_sim_tpu_torch/csrc/sandwich.cu"
# Rows of K7's and K8's entries: the first cascade level of MS_CFG's dual
# render at batch 229376.
SANDWICH_ROWS = 1388544


def _scan_rows(device, P: int, K: int, shift: int, n: int, hot: float):
    """Sorted fold rows as the spectral fold makes them: n rows, a share
    `hot` of them on pixel 377 and the rest spread over P pixels, each with
    a wavelength of K, and one zero-weight marker row per pixel (the last
    row of its run)."""
    import torch

    g = torch.Generator(device=device).manual_seed(13)
    pix = torch.randint(0, P, (n,), generator=g, device=device, dtype=torch.int64)
    pix = torch.where(torch.rand(n, generator=g, device=device) < hot, 377, pix)
    wl = torch.randint(0, K, (n,), generator=g, device=device, dtype=torch.int64)
    markers = (torch.arange(P, device=device, dtype=torch.int64) << shift) | (2 * K - 1)
    key = torch.sort(torch.cat([(pix << shift) | (wl << 1), markers]))[0]
    w = torch.rand(key.numel(), generator=g, device=device) * 2
    w = torch.where((key & (2 * K - 1)) == 2 * K - 1, 0.0, w)
    return key.to(torch.int32), w


def _scan_crowded(device, tbl, shift: int, K: int, P: int, n: int = 1 << 21) -> dict:
    """K4's extract form on n rows crowded on one pixel (92% of them: one
    run of some 940 tiles) and on n rows spread over the image, each
    against its plain twin (SCAN_RTOL) and timed, with its bound."""
    import torch

    from ice_halo_sim_tpu_torch.core import seg_scan

    out = {}
    for what, hot in (("crowded", 0.92), ("spread", 0.0)):
        sk, sw = _scan_rows(device, P, K, shift, n, hot)
        got = seg_scan.fused_scan_extract(sk, sw, tbl, shift, K, P)
        want = seg_scan.fused_scan_extract_plain(sk, sw, tbl, shift, K, P)
        if not torch.allclose(got, want, rtol=SCAN_RTOL, atol=1e-6):
            raise AssertionError(f"fused_scan_extract on {what} rows differs from its plain "
                                 f"twin (max abs {_max_abs(got, want)})")
        m = sk.numel()
        ms = _time_ms(lambda: seg_scan.fused_scan_extract(sk, sw, tbl, shift, K, P), 10,
                      f"fused_scan_extract {what}")
        bound = least_seconds(8 * m + 12 * P + 4 * tbl.numel(), 6 * m)
        out[what] = {"rows": m, "on_one_pixel": int(((sk.long() >> shift) == 377).sum()),
                     "ms": ms, "bound_ms": 1e3 * bound[0], "bound_by": bound[1],
                     "max_abs_err": _max_abs(got, want), "timed_by": _timed_by(ms)}
        print(f"  fused_scan_extract (K4) on {m} rows {what} ({out[what]['on_one_pixel']} on "
              f"pixel 377): max_abs_err {out[what]['max_abs_err']:.3g}, kernel {ms:.4f} ms, "
              f"bound {1e3 * bound[0]:.5f} ms by {bound[1]}", flush=True)
    return out


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
    """least_seconds of one pass: a scatter-add. Bytes: the three row
    operands read and `matched` written once, the list, the table, the tile
    read and written. Operations: one multiply and one add per channel and
    term of each row in the list (float32)."""
    nbytes = 12 * n + (4 * n if matched_out else 0) + 4 * nc + 4 * k_pool * c_out \
        + 2 * 4 * nc * c_out * 128
    return least_seconds(nbytes, ops=2.0 * n_matched * c_out * terms)


def phase_sandwich_stress(device, K, tbl, n_chunks, n: int = 1 << 21) -> dict:
    """Hot pixels: n rows, 90% of them on three pixels (at least 2^20 on
    them), the rest spread over the image, against every chunk of the
    image. K7 and K8 against the plain version, `matched` bit-equal, and a
    second run with the same bits; printed with their times beside
    index_add_ on the same rows, and beside their times on n rows spread
    over the whole image (held to the plain version too), with the bound
    of either (the same: the bound counts rows, not where they land).
    Returns per kernel {"stress_ms", "spread_ms", "bound_ms", "bound_by"}."""
    import torch

    from ice_halo_sim_tpu_torch.core import sandwich

    NLO = sandwich.NLO
    g = torch.Generator(device=device).manual_seed(11)
    hot = torch.tensor([77, 5 * NLO + 3, (n_chunks - 1) * NLO + 127], dtype=torch.int32,
                       device=device)
    pix = hot[torch.randint(0, 3, (n,), generator=g, device=device)]
    spread = torch.rand(n, generator=g, device=device) < 0.1
    pix = torch.where(spread, torch.randint(0, n_chunks * NLO, (n,), generator=g,
                                            device=device, dtype=torch.int32), pix)
    w = torch.rand(n, generator=g, device=device) + 0.5
    wl = torch.randint(0, K, (n,), generator=g, device=device, dtype=torch.int32)
    on_hot = int((~spread).sum())
    out = {}
    if on_hot < (1 << 20):
        raise AssertionError(f"stress: {on_hot} rows on the hot pixels")
    full = torch.arange(n_chunks, dtype=torch.int32, device=device)
    tile = torch.zeros((n_chunks, 3 * NLO), dtype=torch.float32, device=device)
    want, wm = sandwich.sandwich_pass_plain(tile, full, pix, w, wl, tbl, k_pool=K)
    img = torch.zeros((n_chunks * NLO, 3), dtype=torch.float32, device=device)
    vals = tbl[wl.long()] * w[:, None]
    ms_l = _time_ms(lambda: img.index_add_(0, pix.long(), vals), 5)
    for name, layout in (("sandwich_lane", "lane"), ("sandwich_sublane", "sublane")):
        def run(lay=layout):
            return sandwich.sandwich_pass(tile, full, pix, w, wl, tbl, k_pool=K, layout=lay)

        got, gm = run()
        torch.cuda.synchronize()
        err = _tile_err(f"{name} stress", got, want, gm, wm)
        if not _bits_equal(run()[0], got):
            raise AssertionError(f"{name} stress: two runs on the same rows differ")
        ms_hot = _time_ms(run, 5, f"{name} stress")
        print(f"  {name} stress ({n} rows, {on_hot} on three pixels, NC {n_chunks}): "
              f"max_abs_err {err:.3g} of {float(want.abs().max()):.4g}, same bits twice, "
              f"kernel {ms_hot:.4f} ms, index_add_ {ms_l:.4f} ms", flush=True)
        out[name] = {"rows": n, "on_three_pixels": on_hot, "stress_ms": ms_hot,
                     "index_add_ms": ms_l}
    # The same count of rows spread over the image.
    pix_s = torch.randint(0, n_chunks * NLO, (n,), generator=g, device=device,
                          dtype=torch.int32)
    want_s, wm_s = sandwich.sandwich_pass_plain(tile, full, pix_s, w, wl, tbl, k_pool=K)
    bound = _sandwich_bound(n, n, n_chunks, 3, K)
    ms_ls = _time_ms(lambda: img.index_add_(0, pix_s.long(), vals), 5)
    for name, layout in (("sandwich_lane", "lane"), ("sandwich_sublane", "sublane")):
        def run_s(lay=layout):
            return sandwich.sandwich_pass(tile, full, pix_s, w, wl, tbl, k_pool=K, layout=lay)

        got, gm = run_s()
        err = _tile_err(f"{name} spread", got, want_s, gm, wm_s)
        ms_s = _time_ms(run_s, 5, f"{name} spread")
        out[name].update(spread_ms=ms_s, spread_index_add_ms=ms_ls, bound_ms=1e3 * bound[0],
                         bound_by=bound[1], timed_by=_timed_by(out[name]["stress_ms"], ms_s))
        print(f"  {name} on {n} rows spread over NC {n_chunks}: max_abs_err {err:.3g}, "
              f"kernel {ms_s:.4f} ms (stress {out[name]['stress_ms']:.4f}), index_add_ "
              f"{ms_ls:.4f} ms, bound {1e3 * bound[0]:.5f} ms by {bound[1]}", flush=True)
    return out


def phase_kernels_sandwich(device, res: list):
    """K7 and K8 against sandwich_pass_plain, no engine path launching them:
    SANDWICH_ROWS rows over a 512 x 256 image (the probe's ring of rows, a
    quarter dead, K = 64) against the 256 of its 1024 chunks that hold most
    rows, with one bf16 term (the kernels line's entries, beside index_add_
    of the same rows) and with two (extra lines); then the hot-pixel stress
    (phase_sandwich_stress, under "stress" in their entries) and P1 and P2
    at their probes' shapes."""
    import torch

    from ice_halo_sim_tpu_torch import probe_sandwich, probe_scatter
    from ice_halo_sim_tpu_torch.core import sandwich

    F32, I32 = torch.float32, torch.int32
    NLO = sandwich.NLO
    K, N, P = 64, SANDWICH_ROWS, 512 * 256
    n_chunks = P // NLO
    pix, wz, wl, tbl = (torch.as_tensor(x).to(device)
                        for x in probe_sandwich.probe_rows(N, P, K))
    chunk = torch.div(pix, NLO, rounding_mode="floor")
    rows_per_chunk = torch.bincount(chunk[pix >= 0].long(), minlength=n_chunks)
    hot = torch.sort(torch.argsort(rows_per_chunk, descending=True)[:256])[0].to(I32)
    listed = torch.isin(chunk, hot)
    n_hot = int(listed.sum())
    print(f"  sandwich rows: {N}, {int((pix >= 0).sum())} live, {n_hot} of them in the 256 "
          f"chunks that hold most rows (of {n_chunks})", flush=True)
    tile = torch.zeros((256, 3 * NLO), dtype=F32, device=device)
    # The library call on the same rows: a row outside the list adds zeros to
    # a pixel of its own, not to one dump row on which its atomic adds queue.
    vals = torch.where(listed[:, None], tbl[wl.long()] * wz[:, None], 0.0)
    idx = torch.where(listed, pix.long(), torch.arange(N, device=device) % P)
    img = torch.zeros((P, 3), dtype=F32, device=device)
    ms_l = _time_ms(lambda: img.index_add_(0, idx, vals), 5)
    for name, layout, replaces in (
            ("sandwich_lane", "lane", "ice_halo_sim_tpu/core/pallas_sandwich.py:283"),
            ("sandwich_sublane", "sublane", "ice_halo_sim_tpu/core/pallas_sandwich.py:314")):
        for precise in (False, True):
            def run(precise=precise, lay=layout):
                return sandwich.sandwich_pass(tile, hot, pix, wz, wl, tbl, k_pool=K,
                                              precise=precise, layout=lay)

            def plain(precise=precise):
                return sandwich.sandwich_pass_plain(tile, hot, pix, wz, wl, tbl, k_pool=K,
                                                    precise=precise)

            got, gm = run()
            want, wm = plain()
            torch.cuda.synchronize()
            what = f"{name} at {N} rows, NC 256, {'two bf16 terms' if precise else 'one term'}"
            err = _tile_err(what, got, want, gm, wm)
            if int(gm.sum()) != n_hot:
                raise AssertionError(f"{what}: {int(gm.sum())} rows matched, {n_hot} expected")
            if not _bits_equal(run()[0], got):
                raise AssertionError(f"{what}: two runs on the same rows differ")
            ms = _time_ms(run, 5, what)
            bound = _sandwich_bound(N, n_hot, 256, 3, K, terms=2 if precise else 1)
            if precise:
                print(f"  {what} (extra): max_abs_err {err:.3g}, kernel {ms:.4f} ms, bound "
                      f"{1e3 * bound[0]:.5f} ms by {bound[1]}", flush=True)
                continue
            _add(res, name, SANDWICH_SRC, replaces, err, ms, _time_ms(plain, 2), bound,
                 library_ms=ms_l, library="index_add_")
            res[-1].update(rows=N, listed_chunks=256, rows_in_list=n_hot)
    stress = phase_sandwich_stress(device, K, tbl, n_chunks)
    for k in res:
        if k["name"] in stress:
            k["stress"] = stress[k["name"]]

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
        bound = _sandwich_bound(PN, int(inside.sum()), nhi, 3, PK, matched_out=False)
        if nhi == 256:
            _add(res, "sandwich_iota", SANDWICH_SRC, "scripts/probe_sandwich.py:90", err, ms_k,
                 ms_p, bound, library_ms=ms_l, library="index_add_")
            res[-1].update(rows=PN, listed_chunks=nhi)
        else:
            print(f"  sandwich_iota NHI {nhi}: max_abs_err {err:.3g}, kernel {ms_k:.4f} ms, "
                  f"plain {ms_p:.4f} ms, bound {1e3 * bound[0]:.5f} ms by {bound[1]}, "
                  f"index_add_ {ms_l:.4f} ms", flush=True)

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
         least_seconds(4 * n_out + 4 * start.numel() + 4 * n_out, n_out),
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
                path: str = "cuda-trace-kernel", absent=(), batch: int = BATCH):
    """Render `cfg` through the CUDA kernels with the launch counters reset
    just before and read just after; compare with kernels="plain" on the
    card. Every kernel of path_kernels must have launched, and on the steady
    (calibrated) batches too; no kernel of `absent` may have. Returns
    (engine, launch counts, launches per steady batch)."""
    import numpy as np
    import torch

    from ice_halo_sim_tpu_torch.engine.simulator import Engine
    from ice_halo_sim_tpu_torch.kernels import build

    eng = Engine(cfg, seed=7, batch_size=batch, device=device)
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
    for k in absent:
        if counts[k]:
            raise AssertionError(f"kernel {k} was launched on the {name} path ({counts[k]})")
    st = eng.drain_stats()

    ref = Engine(cfg, seed=7, batch_size=batch, device=device, kernels="plain")
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


def _busy_and_kernels(fn, what: str = ""):
    """(device busy ms, device kernels) of one call of fn under the
    profiler (kernels, copies and memsets; those a CUDA graph replays
    included), after one call outside the window (utils/profiling.py:
    `warm`), or (None, 0) when the profiler saw no device event (the window
    is then counted in FALLBACKS)."""
    import torch

    from ice_halo_sim_tpu_torch.utils.profiling import device_profile

    with device_profile(warm=fn) as win:
        fn()
        torch.cuda.synchronize()
    if win.empty:
        FALLBACKS.append({"what": what, "reps": 1, "tries": ["no device event"]})
        return None, 0
    return win.device_us / 1e3, win.kernels


def phase_graphs(name, cfg, device, k: int = GRAPH_K, tag: str = "[5]"):
    """One scene eagerly (graphs=False) and with CUDA graphs, k batches per
    dispatch (IHT_STEPS_PER_DISPATCH): one calibrating dispatch and two
    steady dispatches each; the images, landed weights and stats must be
    equal bit for bit, a steady dispatch must read the host once (an
    overflowing batch adds its own reads, counted in overflow_replays) and
    the graph engine must replay. Then per engine a timed steady dispatch
    (wall clock to a synchronise: rays/s) and a profiled one (device busy
    time and kernels per batch; idle share = 1 - busy / wall of the timed
    one). Returns both engines' numbers ({"eager": ..., "graph": ...})."""
    import torch

    from ice_halo_sim_tpu_torch.engine.simulator import Engine

    out = {}
    numbers = {}
    for graphs in (False, True):
        with _knobs(IHT_STEPS_PER_DISPATCH=str(k)):
            eng = Engine(cfg, seed=7, batch_size=BATCH, device=device, graphs=graphs)
        eng.run(n_batches=k)
        syncs = eng.host_syncs
        eng.run(n_batches=k)
        eng.run(n_batches=k)
        steady_syncs = eng.host_syncs - syncs
        if not eng.overflow_replays and steady_syncs != 2:
            raise AssertionError(f"{name}: {steady_syncs} host reads in two steady dispatches")
        st = eng.drain_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.run(n_batches=k)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / k
        busy, kernels = _busy_and_kernels(lambda: eng.run(n_batches=k),
                                          f"{tag} {name} {'graph' if graphs else 'eager'}")
        busy = None if busy is None else busy / k
        out[graphs] = (eng, st)
        idle = "not measured" if busy is None else f"{1.0 - busy / (wall * 1e3):.4f}"
        numbers[graphs] = {"rays_per_s": BATCH / wall, "wall_ms": wall * 1e3, "busy_ms": busy,
                           "kernels_per_batch": kernels / k,
                           "reads_per_steady_dispatch": steady_syncs / 2,
                           "overflow_replays": eng.overflow_replays,
                           "graph_mode": eng.graph_mode}
        print(f"{tag} {name} {'graph' if graphs else 'eager'}: {eng.graph_mode}; "
              f"{BATCH / wall:.6g} rays/s, wall {wall * 1e3:.4f} ms/batch, device busy "
              f"{'not measured' if busy is None else f'{busy:.4f}'} ms/batch in "
              f"{kernels / k:.0f} device kernels per batch, idle share {idle}; host reads "
              f"{steady_syncs / 2:.1f} per steady dispatch, {steady_syncs / (2 * k):.3f} per "
              f"steady batch; overflow_replays {eng.overflow_replays}", flush=True)
    (e, se), (g, sg) = out[False], out[True]
    if g.graph_mode != "cuda graph" or g._graph is None:
        raise AssertionError(f"{name}: the graph engine did not replay ({g.graph_mode})")
    if se != sg:
        raise AssertionError(f"{name}: graph stats {sg} != eager {se}")
    # The two engines ran the same batches (a timed dispatch, and the
    # profiled one with the call before it, after the stats were drained):
    # every accumulator bit for bit.
    for i, (a, b) in enumerate(zip(e.accum, g.accum)):
        if not _bits_equal(a, b):
            raise AssertionError(f"{name}: graph accumulator {i} differs from eager")
    print(f"{tag} {name}: graph == eager bit for bit over {5 * k} batches (one calibrating, "
          f"three steady dispatches, the profiled one and the call before it, of {k})",
          flush=True)
    return {"eager": numbers[False], "graph": numbers[True]}


def phase_bench(smi):
    """The bench entry with a short window; prints its line."""
    import contextlib
    import io

    from ice_halo_sim_tpu_torch import bench

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = bench.main(["--window", "2", "--windows", "3"])
    line = buf.getvalue().strip().splitlines()[-1]
    res = json.loads(line)
    if rc != 0 or res["platform"] != "cuda" or not res["value"] > 0 or res["card"] != smi:
        raise AssertionError(f"bench entry: rc {rc}, {line}")
    print(f"[6] bench entry (3 windows of 2 s): {line}", flush=True)


def phase_gradients():
    """[7]: the gradient path, compiled (captured programs), against its
    JAX fixture; each compiled form against its eager body; one call of
    each table function against the eager step; then the timings, eager
    and graph, per mode."""
    import torch

    from ice_halo_sim_tpu_torch import grad_validation as gv
    from ice_halo_sim_tpu_torch.engine.gradient import default_params, make_render_fn

    t0 = time.time()
    errs = gv.fixture_check("cuda")
    print(f"[7] gradients (compiled forms) against {gv.FIXTURE} (seed 3, batch 16384), "
          f"errors within tolerance: {json.dumps(errs)}", flush=True)
    errs = gv.graph_check("cuda", batch=1 << 16)
    if set(errs["graph_mode"].values()) != {"cuda graph"}:
        raise AssertionError(f"[7] a form did not run as a CUDA graph: {errs['graph_mode']}")
    print(f"[7] compiled forms against eager (batch 65536; images by the splat's tolerance, "
          f"choices bit for bit): {json.dumps(errs)}", flush=True)
    dev = torch.device("cuda", 0)
    cfg = gv.tilted_cfg()
    params = default_params(cfg, dev)
    batch = 1 << 16
    for name, rep, eps, tau in gv.PARAMS:
        v0 = float(params.face_distance[0] if name == "face_d0" else getattr(params, name))
        grad_fn, loss_fn, programs = gv.table_programs(cfg, params, rep, tau, batch, dev)
        (g,) = grad_fn(v0, 1000)
        loss = loss_fn(v0 + eps, 1000)
        hard = make_render_fn(cfg, batch_size=batch, seed_as_arg=True, device=dev)
        soft = make_render_fn(cfg, batch_size=batch, soft_tau=tau, seed_as_arg=True,
                              device=dev) if tau else hard
        v = torch.tensor(v0, device=dev, requires_grad=True)
        (want,) = torch.autograd.grad(gv.smooth_loss(soft.body(rep(params, v), 1000)), v)
        with torch.no_grad():
            want_l = gv.smooth_loss(hard.body(rep(params, torch.tensor(v0 + eps, device=dev)),
                                              1000))
        g_err = gv.grad_err(g.cpu().numpy(), want.cpu().numpy())
        l_err = abs(float(loss) - float(want_l)) / abs(float(want_l))
        if g_err > gv.GRAD_RTOL["soft" if tau else "free"] or l_err > 2 * gv.IMG_RTOL:
            raise AssertionError(f"[7] table functions of {name}: gradient off by {g_err:.3g}, "
                                 f"loss by {l_err:.3g}")
        print(f"[7] table functions of {name} ({json.dumps(gv._captured(programs))}): one "
              f"call each against the eager step, gradient {float(g):.6g} (error "
              f"{g_err:.3g}), loss {float(loss):.6g} (error {l_err:.3g})", flush=True)
        del grad_fn, loss_fn, programs
    for row in gv.time_modes(batch, "cuda"):
        print(f"[7] {json.dumps(row)}", flush=True)
    print(f"[7]: {time.time() - t0:.1f} s", flush=True)


def phase_rate(eng, n: int = 20):
    import torch

    eng.run(n_batches=2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run(n_batches=n)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return n * eng.batch_size / dt


# Kernels each served scene runs (phase [8]): BENCH_CFG through the trace
# kernel path, MS_CFG and COLOR_CFG through the general path.
SERVED_KERNELS = {
    "bench": ["trace_emit", "scatter_blocks_multi", "fused_scan_extract"],
    "pool": ["trace_emit_pool", "scatter_blocks_multi", "fused_scan_extract"],
    "ms": ["compact_rows", "scatter_blocks", "fused_scan_extract"],
    "color": ["compact_rows", "pack_payload_blocks", "scatter_blocks_multi"],
}
ACQUIRE_HZ = 4.0     # the GUI's poll rate (gui/app.py GuiApp.frame)
SERVER_SHARE_MIN = 0.8  # the Server's steady rays/s over Engine.run's, BENCH_CFG and MS_CFG
RATE_WINDOW_S = 2.0  # the windows of the Server's rate with and without a reader


def _budget(doc, batches: int, batch: int):
    """A copy of a scene document with a budget of `batches` batches (-1:
    infinite)."""
    doc = copy.deepcopy(doc)
    doc["scene"]["ray_num"] = -1 if batches < 0 else batches * batch
    return doc


def _served_counts(name, counts):
    """The launch counts of a served scene: every kernel of its path ran."""
    from ice_halo_sim_tpu_torch.kernels import build

    got = {k: v for k, v in build.LAUNCHES.items() if v}
    for k in SERVED_KERNELS[name]:
        if got.get(k, 0) <= 0:
            raise AssertionError(f"served {name}: kernel {k} was not launched ({got})")
    counts[name] = got
    print(f"[8] served {name}: launches {got}", flush=True)


def _twin_equal(what, frame, eng):
    """A served frame against an Engine driven by the same run calls: raw
    XYZ and landed weights bit for bit."""
    import numpy as np

    for r in range(len(eng.proj_plans)):
        if not np.array_equal(frame.raw_xyz[r], eng.raw_xyz(r)):
            raise AssertionError(f"{what}: render {r} differs from its Engine twin")
    landed = tuple(float(x) for x in eng.accum[-1].cpu())
    if frame.landed != landed:
        raise AssertionError(f"{what}: landed {frame.landed} != twin {landed}")


def _twin(cfg, batch, device, calls):
    """An Engine (seed 7) driven by `calls`; (engine, seconds from its
    build to done)."""
    import torch

    from ice_halo_sim_tpu_torch.engine.simulator import Engine

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng = Engine(cfg, seed=7, batch_size=batch, device=device)
    for n in calls:
        eng.run(n_batches=n)
    torch.cuda.synchronize()
    return eng, time.perf_counter() - t0


def _acquire_ms(srv, reps: int = 5) -> float:
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        srv.acquire_frame()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[reps // 2]


# uint8 values that may differ by one level between the post-process on the
# card and on the host (powf and the 3 x 3 products differ in their last
# bits), as a fraction of the values.
POST_LEVEL_FRAC = 1e-3


def _acquire_before_after(srv, res: str, out: dict, what: str = "") -> None:
    """acquire_frame with the snapshot's post-process on the accumulator's
    device and, in turns (device, host, host, device; median of 5 each),
    with it on the host as before (the XYZ image copied to the host and
    post-processed there); then each render's uint8 image, device against
    host, within 1 level on at most POST_LEVEL_FRAC of the values."""
    import numpy as np
    import torch

    from ice_halo_sim_tpu_torch.core import color
    from ice_halo_sim_tpu_torch.engine.simulator import Engine

    on_device = Engine._xyz
    times = {"device": [], "host": []}
    for form in ("device", "host", "host", "device"):
        if form == "host":
            Engine._xyz = lambda self, r=0: torch.as_tensor(on_device(self, r)).cpu()
        try:
            times[form].append(_acquire_ms(srv))
        finally:
            Engine._xyz = on_device
    with srv._engine_held():
        eng = srv._engine
        landed = eng.accum[-1].cpu().numpy()
        levels = []
        for r, rc in enumerate(eng.cfg.renders):
            args = (rc.intensity_factor, float(landed[r]), rc.background, rc.ray_color)
            a = color.post_process(eng._xyz(r), *args, use_real_color=rc.ray_color[0] < 0)
            b = color.post_process(eng.raw_xyz(r), *args, use_real_color=rc.ray_color[0] < 0)
            d = np.abs(a.astype(int) - b.astype(int))
            levels.append((int(d.max()), int((d > 0).sum()), d.size))
            if d.max() > 1 or (d > 0).sum() > POST_LEVEL_FRAC * d.size:
                raise AssertionError(f"[8] post-process at {res}, render {r}: device against "
                                     f"host {levels[-1]} (max level, values off, values)")
    dev_ms, host_ms = float(np.median(times["device"])), float(np.median(times["host"]))
    out[f"acquire_ms_{res}"] = dev_ms
    out[f"acquire_ms_{res}_host_post_process"] = host_ms
    print(f"[8] acquire_frame at {res}{f' ({what})' if what else ''}: post-process on the "
          f"card {dev_ms:.4f} ms, on the host (as before) {host_ms:.4f} ms (medians of two "
          f"medians of 5, in turns: {times}); uint8 device against host per render (max "
          f"level, values off, values): {levels}", flush=True)


def _rate_window(srv, seconds: float) -> float:
    """Rays/s of a pumping Server over about `seconds` (host clock), from
    the end of one pump call to the end of another: sim_ray_count moves
    once a call, by the call's batches."""
    def call_end():
        n = srv.sim_ray_count()
        deadline = time.time() + 60
        while (m := srv.sim_ray_count()) == n:
            if time.time() > deadline:
                raise AssertionError("the Server's pump made no call in 60 s")
            time.sleep(0.0002)
        return m, time.perf_counter()

    n0, t0 = call_end()
    time.sleep(seconds)
    n1, t1 = call_end()
    return (n1 - n0) / (t1 - t0)


def _wait_rays(srv, rays: int, timeout: float = 120.0) -> None:
    deadline = time.time() + timeout
    while srv.sim_ray_count() < rays:
        if time.time() > deadline:
            raise AssertionError(f"the Server traced {srv.sim_ray_count()} of {rays} rays "
                                 f"in {timeout} s")
        time.sleep(0.0005)


class _Captures:
    """Records, for every CUDA graph captured while it is entered, how many
    run calls the Server's pump had finished (the grain of the call it falls
    in is the next one): a change of grain must capture nothing again, so
    every capture falls in an engine's first two calls (the uncalibrated
    batch, and the first batch under the calibrated plan)."""

    def __init__(self, srv, what):
        self.srv, self.what, self.calls = srv, what, []

    def __enter__(self):
        from ice_halo_sim_tpu_torch.engine import graph as graph_mod

        self.cls = graph_mod.BatchGraph
        self.orig = orig = self.cls.__init__
        calls = self.calls

        def init(graph, *a, **kw):
            calls.append(len(self.srv.grains()))
            orig(graph, *a, **kw)

        self.cls.__init__ = init
        return self

    def __exit__(self, *exc):
        self.cls.__init__ = self.orig
        if exc[0] is None and any(c > 1 for c in self.calls):
            raise AssertionError(f"{self.what}: a graph was captured again after the "
                                 f"pump's second call (calls {self.calls}, grains "
                                 f"{self.srv.grains()})")


def _one_batch_server(**kw):
    """A Server at the JAX server's grain, one batch a pump: the grain the
    Server does not take, measured beside the one it takes."""
    from ice_halo_sim_tpu_torch.engine.server import Server

    class OneBatchServer(Server):
        def _grain_locked(self) -> int:
            return 1

    return OneBatchServer(**kw)


def phase_serving_bench(srv, device, counts: dict, out: dict) -> None:
    """BENCH_CFG at full width through the Server: 64 batches from commit
    to idle, against an Engine built and driven by the same run calls (1,
    then 63); the steady rates of Engine.run (64-batch calls) and of the
    JAX server's grain (one batch a call), each twice in turns; then
    acquire_frame, an appearance-only recommit, and the Server's steady rate
    (an infinite budget) with and without a reader at 4 Hz."""
    import threading

    import torch

    from ice_halo_sim_tpu_torch.config.loader import load_project
    from ice_halo_sim_tpu_torch.kernels import build
    from ice_halo_sim_tpu_torch.scenes import BENCH_CFG

    n = 64
    doc = _budget(BENCH_CFG, n, BATCH)
    cfg = load_project(doc)
    # Calibrated, captured engines (every first-use cost paid before a
    # timing); then each grain timed twice, in turns.
    e_run = _twin(cfg, BATCH, device, [1, n])[0]
    e_one = _twin(cfg, BATCH, device, [1, 1, 1])[0]
    steady = {"run": [], "one": []}
    for what in ("run", "one", "one", "run"):
        eng_, calls = (e_run, [n]) if what == "run" else (e_one, [1] * n)
        steady[what].append(n * BATCH / _twin_run(eng_, calls)[1])
    one_reads = e_one.host_syncs
    del e_run, e_one

    build.reset_launch_counts()
    torch.cuda.synchronize()
    with _Captures(srv, "served bench") as captures:
        t0 = time.perf_counter()
        if srv.commit(doc):
            raise AssertionError("the first commit reused nothing there was")
        _wait_rays(srv, BATCH)
        t1 = time.perf_counter()
        if not srv.wait_idle(timeout=120):
            raise AssertionError("served bench: not idle within 120 s")
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    _served_counts("bench", counts)
    frame = srv.acquire_frame()
    eng = srv._engine
    if eng.batch_size != BATCH:
        raise AssertionError(f"the Server's default batch is {eng.batch_size}, not {BATCH}")
    reads = eng.host_syncs / eng.batch_counter
    grains = srv.grains()
    if grains[0] != 1 or sum(grains) != n:
        raise AssertionError(f"served bench: the pump's calls {grains} are not 1 then {n - 1}")
    twin, twin_s = _twin(cfg, BATCH, device, grains)
    _twin_equal("served bench", frame, twin)
    del twin
    run_rate = sum(steady["run"]) / 2
    one_rate = sum(steady["one"]) / 2
    out.update(server_commit_to_idle=n * BATCH / (t2 - t0), twin_build_to_done=n * BATCH / twin_s,
               server_second_pump_to_idle=(n - 1) * BATCH / (t2 - t1), run_steady=run_rate,
               one_batch_steady=one_rate, reads_per_batch=reads)
    print(f"[8] served bench (batch {BATCH}, {n} batches): commit to idle {t2 - t0:.4f} s, "
          f"{n * BATCH / (t2 - t0):.6g} rays/s (the Engine twin, build to done, "
          f"{n * BATCH / twin_s:.6g}); second pump (its capture included) to idle "
          f"{(n - 1) * BATCH / (t2 - t1):.6g} rays/s; host reads per batch {reads:.4f} "
          f"({eng.host_syncs} in {eng.batch_counter}); the pump's grains {grains}, graphs "
          f"captured in its calls {captures.calls}; frame == Engine twin (the same run calls) "
          f"bit for bit", flush=True)
    print(f"[8] steady rays/s, in turns: Engine.run of {n} batches {steady['run']}, one batch a "
          f"call (the JAX server's grain) {steady['one']}: {one_rate / run_rate:.4f} of run "
          f"({one_reads} host reads in {3 + 2 * n} batches)", flush=True)

    _acquire_before_after(srv, "512x256", out)

    gen = srv.generation()
    app = copy.deepcopy(doc)
    app["render"][0]["intensity_factor"] = 2.0 * doc["render"][0].get("intensity_factor", 1.0)
    if not srv.commit(app) or srv.generation() != gen:
        raise AssertionError("appearance-only recommit did not reuse the accumulation")
    again = srv.acquire_frame()
    if not all((a == b).all() for a, b in zip(frame.raw_xyz, again.raw_xyz)) or (
            again.images[0] == frame.images[0]).all():
        raise AssertionError("appearance-only recommit changed the accumulation or "
                             "did not re-tone-map")
    print(f"[8] appearance-only recommit: reused, generation {gen} kept, raw XYZ equal, "
          f"image re-tone-mapped", flush=True)

    srv.commit(_budget(BENCH_CFG, -1, BATCH))
    _wait_rays(srv, 2 * BATCH)
    time.sleep(0.5)
    alone = _rate_window(srv, RATE_WINDOW_S)
    stop = threading.Event()
    frames = []

    def reader():
        while not stop.wait(1.0 / ACQUIRE_HZ):
            t = time.perf_counter()
            srv.acquire_frame()
            frames.append((time.perf_counter() - t) * 1e3)

    th = threading.Thread(target=reader, daemon=True)
    th.start()
    try:
        read = _rate_window(srv, RATE_WINDOW_S)
    finally:
        stop.set()
        th.join(timeout=30)
    if th.is_alive() or not frames:
        raise AssertionError(f"the 4 Hz reader did not run ({len(frames)} frames)")
    # The same Server at the JAX server's grain (one batch a pump), between
    # two windows of the grouped grain.
    srv.stop()
    srv.wait_idle(timeout=60)
    one = _one_batch_server(seed=7, batch_size=BATCH, device=device)
    try:
        one.commit(_budget(BENCH_CFG, -1, BATCH))
        _wait_rays(one, 2 * BATCH)
        time.sleep(0.5)
        one_server = _rate_window(one, RATE_WINDOW_S)
    finally:
        one.shutdown()
    if not srv.commit(_budget(BENCH_CFG, -1, BATCH)):
        raise AssertionError("recommitting the stopped scene did not reuse it")
    time.sleep(0.5)
    again = _rate_window(srv, RATE_WINDOW_S)
    share = (alone + again) / 2 / run_rate
    out.update(server_steady=[alone, again], server_steady_reader=read,
               server_one_batch_steady=one_server, server_share_bench=share,
               grains_bench_infinite=srv.grains()[-4:])
    print(f"[8] served bench, infinite budget (the Server's steady rate): {alone:.6g} and "
          f"{again:.6g} rays/s alone ({(alone + again) / 2 / run_rate:.4f} of Engine.run's), "
          f"{read:.6g} rays/s with a reader at {ACQUIRE_HZ:g} Hz ({read / alone:.4f}; "
          f"{len(frames)} frames, acquire_frame median "
          f"{sorted(frames)[len(frames) // 2]:.4f} ms); at one batch a pump (the JAX "
          f"server's grain) {one_server:.6g} rays/s ({one_server / run_rate:.4f} of "
          f"Engine.run's); the pump's last grains {srv.grains()[-4:]}", flush=True)
    if share < SERVER_SHARE_MIN:
        raise AssertionError(f"served bench: the Server's steady rate is {share:.4f} of "
                             f"Engine.run's (< {SERVER_SHARE_MIN})")


def _twin_run(eng, calls):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for n in calls:
        eng.run(n_batches=n)
    torch.cuda.synchronize()
    return eng, time.perf_counter() - t0


def phase_serving_layouts(srv, device, counts: dict, out: dict) -> None:
    """Layout commits while pumping: BENCH_CFG (infinite, pumping) -> MS_CFG
    (8 batches; its frame against an Engine given the pump's run calls,
    which then times Engine.run on MS_CFG) -> MS_CFG (infinite: the
    Server's steady rate and its grains) -> BENCH_CFG (4 batches); the
    latency of each commit, and of the same BENCH_CFG commit on an idle
    server (the engine build alone, no pump to wait for): a commit while
    MS_CFG pumps may wait at most PUMP_SECONDS and one MS_CFG batch (the
    grain's rounding) more than that; the peak memory of the sequence; then
    COLOR_CFG's acquire_frame at 1024 x 512, and POOL_CFG (2 batches) for its
    launches."""
    import torch

    from ice_halo_sim_tpu_torch.config.loader import load_project
    from ice_halo_sim_tpu_torch.engine.server import PUMP_SECONDS
    from ice_halo_sim_tpu_torch.kernels import build
    from ice_halo_sim_tpu_torch.scenes import BENCH_CFG, COLOR_CFG, MS_CFG, POOL_CFG

    gen = srv.generation()
    ms_doc = _budget(MS_CFG, 8, BATCH)
    resident = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    build.reset_launch_counts()
    t0 = time.perf_counter()
    if srv.commit(ms_doc) or srv.generation() != gen + 1:
        raise AssertionError("the layout commit to MS_CFG did not reset")
    lat_bench = time.perf_counter() - t0
    if srv.acquire_frame().generation != gen + 1:
        raise AssertionError("the frame after a layout commit has the old generation")
    if not srv.wait_idle(timeout=120):
        raise AssertionError("served ms: not idle within 120 s")
    _served_counts("ms", counts)
    frame, ms_grains = srv.acquire_frame(), srv.grains()
    twin, _ = _twin(load_project(ms_doc), BATCH, device, ms_grains)
    _twin_equal("served ms", frame, twin)
    ms_run = 24 * BATCH / _twin_run(twin, [24])[1]
    del twin
    with _Captures(srv, "served ms, infinite budget") as captures:
        srv.commit(_budget(MS_CFG, -1, BATCH))
        _wait_rays(srv, 2 * BATCH)
        time.sleep(1.0)
        ms_server = _rate_window(srv, RATE_WINDOW_S)
        ms_infinite = srv.grains()
    time.sleep(0.1)
    bench4 = _budget(BENCH_CFG, 4, BATCH)
    t0 = time.perf_counter()
    srv.commit(bench4)
    lat_ms = time.perf_counter() - t0
    if not srv.wait_idle(timeout=120):
        raise AssertionError("served bench after ms: not idle within 120 s")
    peak = torch.cuda.max_memory_allocated(device)
    # The same BENCH_CFG commit with nothing pumping: MS_CFG for one batch
    # (run to idle) in between, so that the commit builds a new engine.
    srv.commit(_budget(MS_CFG, 1, BATCH))
    if not srv.wait_idle(timeout=120):
        raise AssertionError("served ms (1 batch): not idle within 120 s")
    t0 = time.perf_counter()
    srv.commit(bench4)
    lat_idle = time.perf_counter() - t0
    if not srv.wait_idle(timeout=120):
        raise AssertionError("served bench after an idle commit: not idle within 120 s")
    ms_wall = BATCH / ms_run
    share = ms_server / ms_run
    out.update(commit_latency_bench=lat_bench, commit_latency_ms=lat_ms,
               commit_latency_idle=lat_idle, peak_bytes=peak, ms_run_steady=ms_run,
               ms_server_steady=ms_server, server_share_ms=share, grains_ms=ms_grains,
               grains_ms_infinite=ms_infinite[-6:])
    print(f"[8] layout commits while pumping: BENCH_CFG -> MS_CFG (8 batches) "
          f"{lat_bench:.4f} s, generation {gen} -> {gen + 1}, the pump's grains {ms_grains}, "
          f"the MS_CFG frame == Engine twin bit for bit; peak memory across BENCH_CFG -> "
          f"MS_CFG -> BENCH_CFG {peak} bytes (max_memory_allocated; {resident} allocated "
          f"before, with the pumping BENCH_CFG engine; reserved "
          f"{torch.cuda.memory_reserved(device)})", flush=True)
    print(f"[8] MS_CFG: Engine.run of 24 batches {ms_run:.6g} rays/s ({ms_wall * 1e3:.4f} ms a "
          f"batch); the Server, infinite budget, {ms_server:.6g} rays/s ({share:.4f} of "
          f"Engine.run's), grains {ms_infinite[:3]} ... {ms_infinite[-6:]} "
          f"({len(ms_infinite)} calls), graphs captured in its calls {captures.calls}",
          flush=True)
    print(f"[8] commit MS_CFG (infinite, pumping) -> BENCH_CFG: {lat_ms:.4f} s; the same "
          f"commit on an idle server (the engine build) {lat_idle:.4f} s; waited for the pump "
          f"{lat_ms - lat_idle:.4f} s (PUMP_SECONDS {PUMP_SECONDS}, one MS_CFG batch "
          f"{ms_wall:.4f} s)", flush=True)
    if share < SERVER_SHARE_MIN:
        raise AssertionError(f"served ms: the Server's steady rate is {share:.4f} of "
                             f"Engine.run's (< {SERVER_SHARE_MIN})")
    if lat_ms > PUMP_SECONDS + ms_wall + lat_idle:
        raise AssertionError(f"commit MS_CFG -> BENCH_CFG took {lat_ms:.4f} s, more than "
                             f"PUMP_SECONDS + one batch + the engine build "
                             f"({PUMP_SECONDS + ms_wall + lat_idle:.4f} s)")

    build.reset_launch_counts()
    srv.commit(_budget(COLOR_CFG, 2, BATCH))
    if not srv.wait_idle(timeout=120):
        raise AssertionError("served color: not idle within 120 s")
    _served_counts("color", counts)
    _acquire_before_after(srv, "1024x512", out, "COLOR_CFG's, three colour classes, composite")
    build.reset_launch_counts()
    srv.commit(_budget(POOL_CFG, 2, BATCH))
    if not srv.wait_idle(timeout=120):
        raise AssertionError("served pool: not idle within 120 s")
    _served_counts("pool", counts)


def phase_serving_checkpoint(device) -> None:
    """BENCH_CFG and MS_CFG: 4 batches, save_checkpoint, load_checkpoint on
    the card, 4 more; accumulators and stats bit-equal to 8 batches
    uninterrupted (the same 4 + 4 run calls)."""
    import tempfile

    import torch

    from ice_halo_sim_tpu_torch.config.loader import load_project
    from ice_halo_sim_tpu_torch.engine.checkpoint import load_checkpoint, save_checkpoint
    from ice_halo_sim_tpu_torch.engine.simulator import Engine
    from ice_halo_sim_tpu_torch.scenes import BENCH_CFG, MS_CFG

    with tempfile.TemporaryDirectory() as tmp:
        for name, doc in (("bench", BENCH_CFG), ("ms", MS_CFG)):
            path = os.path.join(tmp, f"{name}.npz")
            a = Engine(load_project(doc), seed=7, batch_size=BATCH, device=device)
            a.run(n_batches=4)
            save_checkpoint(path, a)
            a.run(n_batches=4)
            b = load_checkpoint(path, device=device)
            b.run(n_batches=4)
            same = [bool(torch.equal(x, y)) for x, y in zip(a.accum, b.accum)]
            sa, sb = a.drain_stats(), b.drain_stats()
            print(f"[8] checkpoint {name}: 4 + save + load + 4 against 8 uninterrupted: "
                  f"accumulators equal {same}, stats equal {sa == sb}, keep {a._compact_keep}"
                  f" / {b._compact_keep}, file {os.path.getsize(path)} bytes", flush=True)
            if not all(same) or sa != sb:
                raise AssertionError(f"checkpoint {name}: the resumed run differs")


def phase_serving_gui(device) -> None:
    """gui.app.serve on the card with a small budget; every endpoint."""
    import urllib.request

    from ice_halo_sim_tpu_torch.gui.app import serve
    from ice_halo_sim_tpu_torch.scenes import BENCH_CFG

    httpd, gui = serve(json.dumps(_budget(BENCH_CFG, 2, BATCH)), port=0, seed=7,
                       batch_size=BATCH, block=False, device=device)
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        if not gui.server.wait_idle(timeout=120):
            raise AssertionError("gui: not idle within 120 s")
        got = {}
        for path in ("/status", "/frame/0.png", "/frame/0.png?ev=2", "/project",
                     "/crystal/1.json"):
            with urllib.request.urlopen(base + path, timeout=60) as resp:
                got[path] = (resp.status, resp.read())
        status = json.loads(got["/status"][1])
        ok = (all(code == 200 for code, _ in got.values())
              and got["/frame/0.png"][1][:8] == b"\x89PNG\r\n\x1a\n"
              and got["/frame/0.png"][1] != got["/frame/0.png?ev=2"][1]
              and status["ray_count"] == 2 * BATCH and status["is_idle"]
              and len(json.loads(got["/crystal/1.json"][1])["triangles"]) == 20
              and "scene" in json.loads(got["/project"][1]))
        print(f"[8] gui on {device}: {json.dumps(status)}; bytes "
              f"{ {p: len(b) for p, (_, b) in got.items()} }", flush=True)
        if not ok:
            raise AssertionError("gui: an endpoint failed")
    finally:
        httpd.shutdown()
        httpd.server_close()
        gui.server.shutdown()


def phase_capture_thread(device) -> None:
    """A CUDA graph captured on one thread (a server's pump) while the main
    thread uses the card: both succeed (capture_error_mode="thread_local"),
    and the graph replays the batch as the eager engine runs it."""
    import threading

    import torch

    from ice_halo_sim_tpu_torch.config.loader import load_project
    from ice_halo_sim_tpu_torch.engine import graph as graph_mod
    from ice_halo_sim_tpu_torch.engine.simulator import Engine
    from ice_halo_sim_tpu_torch.scenes import BENCH_CFG

    cfg = load_project(BENCH_CFG)
    eng = Engine(cfg, seed=7, batch_size=BATCH, device=device)
    ref = Engine(cfg, seed=7, batch_size=BATCH, device=device, graphs=False)
    for e in (eng, ref):
        e.run(n_batches=1)
    inside, release = threading.Event(), threading.Event()
    calls, box = [0], {}

    def step():
        calls[0] += 1
        if calls[0] == 2:        # the capture (the first call is the warm-up)
            inside.set()
            release.wait(60)
        eng._batch()

    def capture():
        try:
            eng._dev.counter.fill_(eng.batch_counter)
            box["graph"] = graph_mod.BatchGraph(step, eng._graph_key(), device)
        except Exception as e:  # reported below
            box["error"] = e

    th = threading.Thread(target=capture)
    th.start()
    main_ops = 0
    try:
        if not inside.wait(120):
            raise AssertionError("the capture thread did not reach its capture")
        x = torch.arange(1 << 20, dtype=torch.float32, device=device)
        for _ in range(20):
            y = float((x * 2.0).sum().item())
            main_ops += 1
    finally:
        release.set()
        th.join(timeout=120)
    if th.is_alive() or "error" in box:
        raise AssertionError(f"capture on a second thread failed: {box.get('error')}")
    box["graph"].replay()
    ref._dev.counter.fill_(ref.batch_counter)
    ref._batch()
    ref._batch()     # the warm-up batch and the replayed one
    torch.cuda.synchronize()
    same = all(_bits_equal(a, b) for a, b in zip(eng.accum, ref.accum))
    print(f"[8] capture on a second thread while the main thread ran {main_ops} CUDA ops "
          f"(sum {y:.6g}): captured, replayed, accumulators == eager bit for bit: {same}",
          flush=True)
    if not same:
        raise AssertionError("the graph captured on a second thread differs from eager")


def phase_serving(smi, res: list) -> None:
    """[8]: the serving path on the card."""
    import torch

    from ice_halo_sim_tpu_torch.engine.server import Server

    device = torch.device("cuda", 0)
    t0 = time.time()
    counts, out = {}, {}
    srv = Server(seed=7, device="cuda")
    try:
        phase_serving_bench(srv, device, counts, out)
        phase_serving_layouts(srv, device, counts, out)
    finally:
        srv.shutdown()
    if srv._thread.is_alive():
        raise AssertionError("the server's pump did not stop")
    for k in res:
        k["launches_served"] = {n: c.get(k["name"], 0) for n, c in counts.items()}
    phase_serving_checkpoint(device)
    phase_serving_gui(device)
    phase_capture_thread(device)
    print(f"[8] serving: {json.dumps(out)} on {smi}", flush=True)
    print(f"[8]: {time.time() - t0:.1f} s", flush=True)


# [9]: the kernels the C API's served BENCH_CFG must launch (K2, K3, K4).
CAPI_KERNELS = ["trace_emit", "scatter_blocks_multi", "fused_scan_extract"]
# Dump records, the card against the CPU: the first rays of the batch.
DUMP_SLICE = 4096
# Weights (of the largest initial weight) and directions, AoS against SoA:
# tests/test_trace_soa.py's contract.
AOS_TOL = 2e-5
# Card against CPU: rtol and atol DUMP_TOL but for DUMP_EDGE_FRAC of the
# records, within DUMP_EDGE_ATOL (tests/test_torch_debug.py's rule: the
# orientations' cos, sin and arcsin differ by an ulp between the devices,
# which the square root near the TIR limit turns into up to 3e-4).
DUMP_TOL, DUMP_EDGE_FRAC, DUMP_EDGE_ATOL = 1e-5, 2e-3, 1e-3


def _dump_close(what, got, want, scale):
    import numpy as np

    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    off = (np.abs(got - want) > DUMP_TOL * (scale + np.abs(want)))
    off = off.reshape(len(off), -1).any(axis=1)
    worst = float(np.abs(got - want).max()) if got.size else 0.0
    if off.sum() > DUMP_EDGE_FRAC * len(off) or worst > DUMP_EDGE_ATOL * scale + DUMP_TOL * float(
            np.abs(want).max()):
        raise AssertionError(f"{what}: {int(off.sum())} of {len(off)} records off, worst "
                             f"{worst:.3g}")
    return int(off.sum()), worst


def _aos_against_soa(name, eng):
    """The dump's inputs through the AoS trace and through the SoA trace of
    the general path, on the card: entry_ok and paths exact, weights and the
    directions of live exits at rtol and atol AOS_TOL."""
    import torch

    from ice_halo_sim_tpu_torch.core import sampling, trace, trace_soa
    from ice_halo_sim_tpu_torch.engine import debug

    inp = debug.dump_inputs(eng)
    plan = eng.layers[0]
    aos = trace.trace_layer(inp.layer_seed, inp.ray_idx, inp.d_world, inp.w0,
                            sampling.build_rotation(inp.lon, inp.lat, inp.roll), None,
                            inp.pool, inp.n_ior, eng.max_hits)
    soa = trace_soa.trace_layer_soa(
        inp.layer_seed, inp.ray_idx, tuple(inp.d_world.unbind(-1)), inp.w0,
        trace_soa.rot_components(inp.lon, inp.lat, inp.roll), inp.pool, inp.n_ior,
        eng.max_hits, setting_blocks=tuple(zip(plan.k_per_setting, plan.setting_counts)))
    scale = float(inp.w0.abs().max())
    live = aos.w > 0
    checks = {
        "entry_ok": torch.equal(aos.entry_ok, soa.entry_ok),
        "path": torch.equal(aos.path, soa.path.T),
        "w": bool(torch.allclose(soa.w.T, aos.w, rtol=AOS_TOL, atol=AOS_TOL * scale)),
    }
    for c, comp in enumerate((soa.dx, soa.dy, soa.dz)):
        checks["d" + "xyz"[c]] = bool(torch.allclose(
            comp.T[live], aos.d_world[..., c][live], rtol=AOS_TOL, atol=AOS_TOL))
    bits = all(torch.equal(a, b) for a, b in (
        (aos.w, soa.w.T), (aos.d_world[..., 0], soa.dx.T)))
    print(f"[9] {name}: AoS trace_layer vs SoA trace_layer_soa on the dump's "
          f"{inp.ray_idx.shape[0]} rays x {eng.max_hits} slots, {int(live.sum())} live exits, "
          f"pool K = {inp.pool.plane_n.shape[0]}: {checks}; weights and x bit-equal {bits}",
          flush=True)
    if not all(checks.values()):
        raise AssertionError(f"{name}: the AoS trace differs from the SoA trace: {checks}")


def phase_debug(device, out: dict) -> None:
    """The debug ray dump at full width on BENCH_CFG (one shared prism) and
    POOL_CFG (the blocked pool of 1792 pyramids): its time and records, the
    AoS trace under it against the SoA trace, and (BENCH_CFG) the first
    DUMP_SLICE rays' records against the same dump on the CPU."""
    import numpy as np
    import torch

    from ice_halo_sim_tpu_torch.config.loader import load_project
    from ice_halo_sim_tpu_torch.engine.debug import dump_rays, format_rays
    from ice_halo_sim_tpu_torch.engine.simulator import Engine
    from ice_halo_sim_tpu_torch.scenes import BENCH_CFG, POOL_CFG

    for name, doc in (("bench", BENCH_CFG), ("pool", POOL_CFG)):
        cfg = load_project(doc)
        eng = Engine(cfg, seed=7, batch_size=BATCH, device=device)
        dump_rays(eng, n_rays=BATCH)
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rec = dump_rays(eng, n_rays=BATCH)
            times.append((time.perf_counter() - t0) * 1e3)
        ms = sorted(times)[1]
        out[f"dump_ms_{name}"] = ms
        out[f"dump_records_{name}"] = len(rec.ray_idx)
        print(f"[9] dump_rays {name} (batch {BATCH}, every ray): {ms:.4f} ms (median of 3, "
              f"records to the host included), {len(rec.ray_idx)} records\n"
              + format_rays(rec, 4), flush=True)
        if not (len(rec.ray_idx) > BATCH and (rec.path_len == rec.exit_slot + 1).all()
                and np.isfinite(rec.direction).all()):
            raise AssertionError(f"dump {name}: records malformed")
        _aos_against_soa(name, eng)
        if name != "bench":
            continue
        cpu = dump_rays(Engine(cfg, seed=7, batch_size=BATCH, device="cpu"), n_rays=DUMP_SLICE)
        card = dump_rays(eng, n_rays=DUMP_SLICE)
        for f in ("ray_idx", "exit_slot", "path", "path_len", "wavelength"):
            if not np.array_equal(getattr(card, f), getattr(cpu, f)):
                raise AssertionError(f"dump {name}: {f} of the card's first {DUMP_SLICE} rays "
                                     f"differs from the CPU's")
        w_off = _dump_close("dump weights, card vs CPU", card.weight, cpu.weight,
                            float(eng._w0_tbl.max()))
        d_off = _dump_close("dump directions, card vs CPU", card.direction, cpu.direction, 1.0)
        print(f"[9] dump {name}, first {DUMP_SLICE} rays: {len(card.ray_idx)} records, rays, "
              f"slots, paths and wavelengths == the CPU's; weights and directions off rtol/atol "
              f"{DUMP_TOL} on (records, worst) {w_off} / {d_off}", flush=True)


def _capi(lib_path):
    import ctypes

    lib = ctypes.CDLL(lib_path)
    lib.IHT_LastError.restype = ctypes.c_char_p
    lib.IHT_CreateServer.argtypes = [ctypes.POINTER(ctypes.c_void_p), ctypes.c_uint,
                                     ctypes.c_int]
    lib.IHT_CommitSceneJson.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                        ctypes.POINTER(ctypes.c_int)]
    lib.IHT_WaitIdle.argtypes = [ctypes.c_void_p, ctypes.c_double]
    lib.IHT_GetSimRayCount.argtypes = [ctypes.c_void_p]
    lib.IHT_GetSimRayCount.restype = ctypes.c_longlong
    lib.IHT_AcquireResultFrame.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p)]
    lib.IHT_FrameGetRenderSize.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                           ctypes.POINTER(ctypes.c_int),
                                           ctypes.POINTER(ctypes.c_int)]
    lib.IHT_FrameGetRender.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p,
                                       ctypes.c_size_t]
    lib.IHT_ReleaseResultFrame.argtypes = [ctypes.c_void_p]
    lib.IHT_DestroyServer.argtypes = [ctypes.c_void_p]
    return lib


def _served_rate(ray_count, wait_idle, n: int) -> tuple:
    """(rays/s from the end of the first batch to idle, seconds from the
    commit's return to idle) of a committed budget of n batches."""
    import torch

    t0 = time.perf_counter()
    deadline = time.time() + 120
    while ray_count() < BATCH:
        if time.time() > deadline:
            raise AssertionError("the first batch did not end within 120 s")
        time.sleep(0.0005)
    t1 = time.perf_counter()
    if not wait_idle():
        raise AssertionError("not idle within 300 s")
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return (n - 1) * BATCH / (t2 - t1), t2 - t0


def phase_capi(smi, res: list, out: dict) -> None:
    """The C API on the card: libiht.so and iht_smoke built from the
    sources; in this process through ctypes, IHT_CreateServer (IHT_PLATFORM
    unset: cuda) commits BENCH_CFG for 64 batches and its frame's sRGB bytes
    equal those of a Server(device="cuda") with the same seed and budget;
    the launch counters around the C API's commit (K2, K3, K4 launched);
    the steady rays/s of both; then iht_smoke in its own process."""
    import ctypes
    import tempfile

    import torch

    from ice_halo_sim_tpu_torch.engine.server import Server
    from ice_halo_sim_tpu_torch.kernels import build, capi
    from ice_halo_sim_tpu_torch.scenes import BENCH_CFG

    t0 = time.time()
    paths = capi.build()
    print(f"[9] C API build: {time.time() - t0:.1f} s -> "
          f"{[os.path.relpath(p, ROOT) for p in paths.values()]}", flush=True)
    os.environ.pop("IHT_PLATFORM", None)
    lib = _capi(paths["lib"])
    n = 64
    doc = json.dumps(_budget(BENCH_CFG, n, BATCH)).encode()
    server = ctypes.c_void_p()
    if lib.IHT_CreateServer(ctypes.byref(server), 7, BATCH) != 0:
        raise AssertionError(f"IHT_CreateServer: {lib.IHT_LastError()}")
    try:
        build.reset_launch_counts()
        if lib.IHT_CommitSceneJson(server, doc, None) != 0:
            raise AssertionError(f"IHT_CommitSceneJson: {lib.IHT_LastError()}")
        capi_rate, capi_s = _served_rate(lambda: lib.IHT_GetSimRayCount(server),
                                         lambda: lib.IHT_WaitIdle(server, 300.0) == 0, n)
        launches = {k: v for k, v in build.LAUNCHES.items() if v}
        frame = ctypes.c_void_p()
        if lib.IHT_AcquireResultFrame(server, ctypes.byref(frame)) != 0:
            raise AssertionError(f"IHT_AcquireResultFrame: {lib.IHT_LastError()}")
        w, h = ctypes.c_int(), ctypes.c_int()
        lib.IHT_FrameGetRenderSize(frame, 0, ctypes.byref(w), ctypes.byref(h))
        buf = ctypes.create_string_buffer(w.value * h.value * 3)
        if lib.IHT_FrameGetRender(frame, 0, buf, len(buf)) != 0:
            raise AssertionError(f"IHT_FrameGetRender: {lib.IHT_LastError()}")
        lib.IHT_ReleaseResultFrame(frame)
    finally:
        if lib.IHT_DestroyServer(server) != 0:
            raise AssertionError(f"IHT_DestroyServer: {lib.IHT_LastError()}")
    for k in CAPI_KERNELS:
        if launches.get(k, 0) <= 0:
            raise AssertionError(f"C API: kernel {k} was not launched ({launches})")
    for k in res:
        k["launches_capi"] = launches.get(k["name"], 0)

    srv = Server(seed=7, batch_size=BATCH, device="cuda")
    try:
        srv.commit(doc.decode())
        direct_rate, direct_s = _served_rate(srv.sim_ray_count,
                                             lambda: srv.wait_idle(timeout=300), n)
        direct = srv.acquire_frame().images[0]
        grains = srv.grains()
    finally:
        srv.shutdown()
    same = (w.value, h.value) == (direct.shape[1], direct.shape[0]) and \
        buf.raw == direct.tobytes()
    out.update(capi_steady=capi_rate, direct_steady=direct_rate, launches_capi=launches)
    print(f"[9] C API (ctypes, in process) BENCH_CFG {n} batches of {BATCH}: launches "
          f"{launches}; steady rays/s (first batch's end to idle) {capi_rate:.6g} against the "
          f"direct Server's {direct_rate:.6g} ({capi_rate / direct_rate:.4f}); commit's return "
          f"to idle {capi_s:.4f} s / {direct_s:.4f} s; the direct Server's grains {grains}; "
          f"sRGB {w.value}x{h.value} bytes == the direct Server's: {same}", flush=True)
    if not same:
        raise AssertionError("the C API's frame differs from the direct Server's")

    # iht_smoke embeds its own interpreter: it is given this one's import
    # path, and runs on the card (IHT_PLATFORM unset) at its batch of 16384.
    with tempfile.TemporaryDirectory() as tmp:
        scene = os.path.join(tmp, "scene.json")
        with open(scene, "w") as f:
            json.dump(_budget(BENCH_CFG, 2, 16384), f)
        env = dict(os.environ, PYTHONPATH=os.pathsep.join([ROOT] + [p for p in sys.path if p]))
        env.pop("IHT_PLATFORM", None)
        t0 = time.time()
        smoke = subprocess.run([paths["smoke"], scene], env=env, capture_output=True, text=True,
                               timeout=300)
    lines = smoke.stdout.strip().splitlines()
    print(f"[9] iht_smoke (its own process, on the card): exit {smoke.returncode} in "
          f"{time.time() - t0:.1f} s: {lines}", flush=True)
    if smoke.returncode != 0 or not any(line.startswith("iht_smoke OK") for line in lines):
        raise AssertionError(f"iht_smoke failed: {smoke.stderr[-2000:]}")
    torch.cuda.synchronize()


def phase_debug_capi(smi, res: list) -> None:
    """[9]: the debug ray dump and the C API on the card."""
    import torch

    t0 = time.time()
    out = {}
    phase_debug(torch.device("cuda", 0), out)
    phase_capi(smi, res, out)
    print(f"[9] debug and C API: {json.dumps(out)} on {smi}", flush=True)
    print(f"[9]: {time.time() - t0:.1f} s", flush=True)


# [10]: data parallel (parallel/sharding.py, parallel/distributed.py).
# Per sharded scene: its batches per shard (run as two calls), the batches
# of its timed turns and the kernels its sharded run must launch.
SHARDED = (
    ("bench", "BENCH_CFG", 16, 64, ["trace_emit", "scatter_blocks_multi", "fused_scan_extract"]),
    ("pool", "POOL_CFG", 2, 4, ["trace_emit_pool", "scatter_blocks_multi", "fused_scan_extract"]),
    ("ms", "MS_CFG", 4, 4, ["compact_rows", "scatter_blocks", "fused_scan_extract"]),
)
# The two-rank run on one card: the scenes and batches each rank runs (the
# first call of the single-process run gives the image they must equal),
# the batches of its timed run, and each worker's time limit.
RANK_SCENES = (("bench", "BENCH_CFG", 8, 64), ("ms", "MS_CFG", 2, 4))
RANK_TIMEOUT = 300
SEED_SHARDED = 7


def _sync_all():
    import torch

    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def _shard_sum(engines, r: int):
    """Render r of engines (one per shard) summed in shard order, as a
    ShardedEngine drains it: the accumulators on the first shard's device."""
    e0 = engines[0]
    p = e0.proj_plans[r]
    acc = e0.accum[r].clone()
    for e in engines[1:]:
        acc.add_(e.accum[r].to(acc.device))
    return acc[:, :3].cpu().numpy().reshape(p.height, p.width, 3)


def _turns(fns, reps: int = 2):
    """Wall seconds of each fn, in turns a, b, b, a (reps times)."""
    out = [[] for _ in fns]
    order = list(range(len(fns)))
    for _ in range(reps):
        for i in order + order[::-1]:
            _sync_all()
            t0 = time.perf_counter()
            fns[i]()
            _sync_all()
            out[i].append(time.perf_counter() - t0)
    return out


def _launch_order(se, n: int) -> str:
    """se.run(n_batches=n) with Engine._step and Engine._read instrumented:
    before the first read, batch i must launch on every shard before batch
    i + 1. Returns the order seen, for the log."""
    from ice_halo_sim_tpu_torch.engine.simulator import Engine

    step, read = Engine._step, Engine._read
    events = []
    Engine._step = lambda self, graph: (events.append(self.shard[0]), step(self, graph))[1]
    Engine._read = lambda self: (events.append("read"), read(self))[1]
    try:
        se.run(n_batches=n)
    finally:
        Engine._step, Engine._read = step, read
    launched = events[:events.index("read")]
    k = min(n, se.engine.steps_per_dispatch)
    want = [e.shard[0] for e in se.engines] * k
    if launched != want:
        raise AssertionError(f"sharded launch order {launched}, not batch by batch {want}")
    return f"{len(se.engines)} shards x {k} batches launched batch by batch before a read"


def phase_sharded(name, cfg, mesh, batches: int, timed: int, kernels, smi,
                  keep_first: bool = False):
    """One scene through ShardedEngine over `mesh` at full width, in two
    calls, with the launch counters reset just before and read just after;
    every render, the landed weights, rays and segments against one Engine
    per shard at shard (d, n) given the same calls, summed in shard order
    (bit for bit); then the sharded rate against one Engine.run of as many
    batches in turns, the host reads per dispatch and the drain's ms.
    Returns (launch counts, the first call's images when keep_first)."""
    import numpy as np
    import torch

    from ice_halo_sim_tpu_torch.engine.simulator import Engine
    from ice_halo_sim_tpu_torch.kernels import build
    from ice_halo_sim_tpu_torch.parallel import ShardedEngine

    n = len(mesh)
    calls = (batches // 2, batches - batches // 2)
    se = ShardedEngine(cfg, mesh, seed=SEED_SHARDED, per_device_batch=BATCH)
    twins = [Engine(cfg, seed=SEED_SHARDED, batch_size=BATCH, device=d) for d in mesh]
    for d, t in enumerate(twins):
        t.run(n_batches=1)
        t.reset()
        t.shard = (d, n)
    build.reset_launch_counts()
    order = _launch_order(se, calls[0])
    _sync_all()
    first = [se.raw_xyz(r) for r in range(len(se.engine.proj_plans))] if keep_first else None
    se.run(n_batches=calls[1])
    _sync_all()
    counts = dict(build.LAUNCHES)
    for k in kernels:
        if counts[k] <= 0:
            raise AssertionError(f"kernel {k} was not launched on the sharded {name} run")
    segs = dropped = 0
    for t in twins:
        for c in calls:
            t.run(n_batches=c)
        st = t.drain_stats()
        segs += st.ray_segments
        dropped += st.dropped_cont_weight
    if se.rays_traced != batches * n * BATCH or se.ray_segments != segs:
        raise AssertionError(f"sharded {name}: rays {se.rays_traced}, segments "
                             f"{se.ray_segments} against the shard engines' {segs}")
    landed = twins[0].accum[-1].clone()
    for t in twins[1:]:
        landed.add_(t.accum[-1].to(landed.device))
    bits = _bits_equal(se.drained_accum()[-1], landed)
    if not bits:
        raise AssertionError(f"sharded {name}: landed weights differ from the shard engines")
    for r in range(len(se.engine.proj_plans)):
        a, b = se.raw_xyz(r), _shard_sum(twins, r)
        if not np.array_equal(a.view(np.int32), b.view(np.int32)):
            raise AssertionError(f"sharded {name} render {r}: not bit-equal to its shard "
                                 f"engines, max abs {float(np.abs(a - b).max()):.3g} of "
                                 f"{float(b.max()):.3g}")
    for img in se.snapshot():
        if img.max() == 0:
            raise AssertionError(f"sharded {name}: a snapshot is black")
    ref = twins[0]
    syncs = sum(e.host_syncs for e in se.engines)
    (t_one, t_sh) = _turns([lambda: ref.run(n_batches=n * timed),
                            lambda: se.run(n_batches=timed)])
    dispatches = 2 * 2 * n * -(-timed // se.engine.steps_per_dispatch)
    reads = (sum(e.host_syncs for e in se.engines) - syncs) / dispatches
    drain = []
    for _ in range(5):
        _sync_all()
        t0 = time.perf_counter()
        se.drained_accum()
        _sync_all()
        drain.append(time.perf_counter() - t0)
    rate_one = n * timed * BATCH / float(np.median(t_one))
    rate_sh = n * timed * BATCH / float(np.median(t_sh))
    print(f"[10] sharded {name} on {[str(d) for d in mesh]}: {batches} batches a shard "
          f"({calls[0]} + {calls[1]}), bit-equal "
          f"to {n} shard engines summed in shard order (every render and the landed "
          f"weights; rays {se.rays_traced}, segments {se.ray_segments}); {order}; launches "
          f"{ {k: v for k, v in counts.items() if v} }; {se.engine.graph_mode}; host reads "
          f"{reads:.2f} per dispatch and shard; sharded {rate_sh:.6g} rays/s against one "
          f"Engine.run of {n * timed} batches {rate_one:.6g} rays/s: "
          f"{rate_sh / rate_one:.4f} (walls {[round(x, 5) for x in t_sh]} / "
          f"{[round(x, 5) for x in t_one]} s); drain {float(np.median(drain)) * 1e3:.4f} ms "
          f"(median of 5) on {smi}", flush=True)
    del se, twins, ref
    torch.cuda.empty_cache()
    return counts, first


def rank_worker(argv) -> int:
    """One rank of a run of several processes (started by phase_ranks):
    a MultiHostEngine of one shard on cuda:<device> through `backend`;
    each scene's images to <out>/rank<r>_<scene>.npz, then a timed run
    between two barriers. argv: rank, world, port, out, backend, device."""
    import numpy as np
    import torch
    import torch.distributed as dist

    rank, world, port, out, backend, dev = (int(argv[0]), int(argv[1]), argv[2], argv[3],
                                            argv[4], int(argv[5]))
    sys.path.insert(0, ROOT)
    from ice_halo_sim_tpu_torch import scenes
    from ice_halo_sim_tpu_torch.config.loader import load_project
    from ice_halo_sim_tpu_torch.parallel.distributed import MultiHostEngine, init_multi_host

    torch.cuda.set_device(dev)
    init_multi_host(f"localhost:{port}", world, rank, local_device_ids=[dev], backend=backend)
    result = {}
    try:
        for name, attr, batches, timed in RANK_SCENES:
            eng = MultiHostEngine(load_project(getattr(scenes, attr)), seed=SEED_SHARDED,
                                  per_device_batch=BATCH)
            if (eng.n_dev, [e.shard for e in eng.engines]) != (world, [(rank, world)]):
                raise AssertionError(f"rank {rank}: shards {[e.shard for e in eng.engines]}")
            eng.run(n_batches=batches)
            np.savez(os.path.join(out, f"rank{rank}_{name}.npz"),
                     *[eng.raw_xyz(r) for r in range(len(eng.engine.proj_plans))],
                     landed=eng.drained_accum()[-1].cpu().numpy(),
                     rays=eng.rays_traced, segs=eng.ray_segments)
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.run(n_batches=timed)
            torch.cuda.synchronize()
            dist.barrier()
            result[name] = {"wall": time.perf_counter() - t0, "timed": timed,
                            "graph_mode": eng.engine.graph_mode}
            del eng
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    print("RANK " + json.dumps(result), flush=True)
    return 0


def phase_ranks(single: dict, smi, world: int = 2, backend: str = "gloo",
                cards: bool = False) -> None:
    """`world` ranks: worker processes of this script, each a
    MultiHostEngine of one shard, all on cuda:0 through gloo (NCCL refuses
    two ranks on one device), or with `cards` one card each. The ranks'
    images must be bit-equal to each other, and to the single-process run's
    after as many batches (`single`): bit for bit for two ranks (with two
    terms the sum is the same in either order), else to rtol 1e-6 (the
    all-reduce adds in another order). A rank that fails or outlives
    RANK_TIMEOUT fails the phase; every rank is stopped."""
    import socket
    import tempfile

    import numpy as np

    s = socket.socket()
    s.bind(("localhost", 0))
    port = str(s.getsockname()[1])
    s.close()
    where = f"{world} cards ({backend})" if cards else f"one card ({backend})"
    env = dict(os.environ)
    if backend == "nccl":
        env.setdefault("NCCL_SOCKET_IFNAME", "lo")   # one host: bootstrap on the loopback
    t0 = time.time()
    with tempfile.TemporaryDirectory() as out:
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--rank-worker", str(rank), str(world),
             port, out, backend, str(rank if cards else 0)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT, env=env)
            for rank in range(world)]
        results = []
        try:
            for rank, p in enumerate(procs):
                so, se = p.communicate(timeout=max(1.0, RANK_TIMEOUT - (time.time() - t0)))
                if p.returncode != 0:
                    raise AssertionError(f"rank {rank} exited {p.returncode}:\n{se[-4000:]}")
                results.append(json.loads([ln for ln in so.splitlines()
                                           if ln.startswith("RANK ")][-1][5:]))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        for name, _attr, batches, _timed in RANK_SCENES:
            ranks = [np.load(os.path.join(out, f"rank{r}_{name}.npz")) for r in range(world)]
            a = ranks[0]
            imgs = sorted((k for k in a.files if k.startswith("arr_")), key=lambda x: int(x[4:]))
            for b in ranks[1:]:
                for k in imgs + ["landed"]:
                    if not np.array_equal(a[k].view(np.int32), b[k].view(np.int32)):
                        raise AssertionError(f"ranks {name}: {k} differs between the ranks")
            worst = 0.0
            for r, k in enumerate(imgs):
                want = single[name][r]
                if world == 2 and not np.array_equal(a[k].view(np.int32), want.view(np.int32)):
                    raise AssertionError(f"ranks {name}: render {r} differs from the "
                                         "single-process run")
                if not np.allclose(a[k], want, rtol=1e-6, atol=0.0):
                    raise AssertionError(f"ranks {name}: render {r} differs from the "
                                         "single-process run beyond rtol 1e-6")
                worst = max(worst, float((np.abs(a[k] - want) / np.maximum(
                    np.abs(want), 1e-30)).max()))
            if int(a["rays"]) != world * batches * BATCH:
                raise AssertionError(f"ranks {name}: rays {int(a['rays'])}")
            wall = max(res[name]["wall"] for res in results)
            timed = results[0][name]["timed"]
            print(f"[10] {world} ranks on {where}, {name}: {batches} batches a rank, images "
                  f"bit-equal between the ranks and "
                  f"{'bit-equal' if worst == 0.0 else f'to rel {worst:.3g}'} to the "
                  f"single-process {world}-shard run; {results[0][name]['graph_mode']}; "
                  f"combined {world * timed * BATCH / wall:.6g} rays/s ({timed} batches a "
                  f"rank, walls {[round(res[name]['wall'], 5) for res in results]} s) on {smi}",
                  flush=True)
    print(f"[10] ranks on {where}: {time.time() - t0:.1f} s", flush=True)


def phase_cards(smi) -> None:
    """Every card of the host (more than one): ShardedEngine over the mesh
    of all cards on BENCH_CFG, POOL_CFG and MS_CFG, each bit-equal to one
    Engine per card at its shard and timed against one Engine.run of as
    many batches; then one NCCL rank per card."""
    import torch

    from ice_halo_sim_tpu_torch import scenes
    from ice_halo_sim_tpu_torch.config.loader import load_project
    from ice_halo_sim_tpu_torch.parallel import make_mesh

    mesh = make_mesh()
    rank_batches = {n: b for n, _attr, b, _timed in RANK_SCENES}
    single = {}
    for name, attr, batches, timed, kernels in SHARDED:
        _counts, first = phase_sharded(
            name, load_project(getattr(scenes, attr)), mesh, batches, timed, kernels,
            smi, keep_first=name in rank_batches)
        if first is not None:
            single[name] = first
    phase_ranks(single, smi, world=torch.cuda.device_count(), backend="nccl", cards=True)


def phase_parallel(smi, res: list) -> None:
    """[10]: two shards on one card, each scene bit-equal to its shard
    engines; two ranks on one card through gloo; where the host has more
    than one card, the mesh of all cards and one NCCL rank per card."""
    import torch

    from ice_halo_sim_tpu_torch import scenes
    from ice_halo_sim_tpu_torch.config.loader import load_project

    t0 = time.time()
    mesh = [torch.device("cuda", 0)] * 2
    counts, single = {}, {}
    rank_batches = {n: b for n, _attr, b, _timed in RANK_SCENES}
    for name, attr, batches, timed, kernels in SHARDED:
        keep = name in rank_batches
        if keep and batches // 2 != rank_batches[name]:
            raise AssertionError(f"{name}: the ranks' batches are not the first call's")
        counts[name], first = phase_sharded(
            name, load_project(getattr(scenes, attr)), mesh, batches, timed, kernels,
            smi, keep_first=keep)
        if keep:
            single[name] = first
    for k in res:
        k["launches_sharded"] = {n: c[k["name"]] for n, c in counts.items()}
    phase_ranks(single, smi)
    if torch.cuda.device_count() > 1:
        phase_cards(smi)
    else:
        print("[10] the mesh over several cards (and NCCL) did not run: this host has one "
              "CUDA device", flush=True)
    print(f"[10]: {time.time() - t0:.1f} s", flush=True)


# [11]: the reference bench scenes. Each stand-in of scenes.py at full width:
# (name, constant, batch, steady batches); PYRAMID3_CFG's fan-out makes a root
# ray about 100 times the work, so it takes 32768 rays a batch.
STAND_INS = (("ms_multi", "MULTI_CFG", BATCH, 2), ("complex_sop", "COMPLEX_CFG", BATCH, 2),
             ("filtered_bd", "BD_CFG", BATCH, 2), ("pyramid", "PYRAMID3_CFG", 32768, 2))
# The pyramid's cuda-against-plain engine pair runs at this batch: the plain
# scan over its first, uncompacted batch at full width (about 9.4e7 rows)
# would take most of a minute.
PYRAMID_SMALL_BATCH = 2048
BIG_RES = (2048, 1024)
GENERAL_ABSENT = ["pack_rows", "pack_payload_blocks", "fused_scan", "pack_valid_blocks",
                  "scatter_blocks_multi"]


def _with_res(doc: dict, res) -> dict:
    out = copy.deepcopy(doc)
    for r in out["render"]:
        r["resolution"] = list(res)
    return out


def _stand_in_kernels(name, eng) -> dict:
    """Every kernel a calibrated general-path engine launches on the sort
    fold, at its own shapes (one steady batch), against its plain twin:
    compact_rows inside compact_valid at each render's fold rows
    (bit-equal, and the same bits twice), the fold of the compacted rows
    through K4's extract form (within SCAN_RTOL; the sort between is
    torch's), and K3' at every layer boundary of the continuation (bit-equal,
    the same bits twice). Returns {kernel: max_abs_err} and prints the
    kernels' times at these shapes."""
    import torch

    from ice_halo_sim_tpu_torch.core import accum
    from ice_halo_sim_tpu_torch.kernels import kernel_set

    plain = kernel_set("plain")
    errs = {"fused_scan_extract": 0.0}
    for r in range(len(eng.proj_plans)):
        key, cols = _fold_rows(eng, r, 5)
        keep = eng._compact_keep[r] if eng._compact_keep else None
        ck, cw = key, cols[0]
        if keep is not None:
            a, b = (accum.compact_valid(key, cols, keep, ks) for ks in (eng.ks, plain))
            again = accum.compact_valid(key, cols, keep, eng.ks)
            if int(a[1]) != int(b[1]) or not all(_bits_equal(x, y) for x, y in zip(a[0], b[0])):
                raise AssertionError(f"{name} render {r}: compact_rows differs from its plain "
                                     "version")
            if not all(_bits_equal(x, y) for x, y in zip(a[0], again[0])):
                raise AssertionError(f"{name} render {r}: compact_rows, two launches differ")
            if int(a[1]) > keep:
                raise AssertionError(f"{name} render {r}: {int(a[1])} live rows overflow keep "
                                     f"{keep} on the checked batch")
            ck, cw = a[0]
            errs["compact_rows"] = 0.0
            ms_c = _time_ms(lambda: accum.compact_valid(key, cols, keep, eng.ks), 5,
                            f"compact_rows {name}")
        acc0 = torch.zeros_like(eng.accum[r])
        got, want = (accum.fold_spectral_keys(acc0, ck, cw, eng.k_pool, eng.basis_tbl, ks)
                     for ks in (eng.ks, plain))
        err = _max_abs(got, want)
        if not torch.allclose(got, want, rtol=SCAN_RTOL, atol=1e-6):
            raise AssertionError(f"{name} render {r}: the fold through K4 differs from its plain "
                                 f"version (max abs {err})")
        errs["fused_scan_extract"] = max(errs["fused_scan_extract"], err)
        ms_f = _time_ms(lambda: accum.fold_spectral_keys(acc0, ck, cw, eng.k_pool,
                                                         eng.basis_tbl, eng.ks), 5,
                        f"fold {name}")
        print(f"  {name} render {r}: fold rows {key.numel()}, keep {keep}, compact_rows "
              f"{'bit-equal, ' + format(ms_c, '.4f') + ' ms' if keep is not None else 'not run'}"
              f"; the fold (sort + K4) of {ck.numel()} rows within {err:.3g} of plain, "
              f"{ms_f:.4f} ms", flush=True)
    calls = _continuation_scatter(eng, 5)
    if len(calls) != len(eng.layers) - 1 or any(c[4] is None for c in calls):
        raise AssertionError(f"{name}: {len(calls)} permuted block scatters at "
                             f"{len(eng.layers) - 1} layer boundaries")
    for li, (vals, start, out_len, blk, perm) in enumerate(calls):
        _scatter_same_bits(f"{name}'s continuation (boundary {li})", vals, start, out_len, blk,
                           perm)
        print(f"  {name} continuation boundary {li}: K3' bit-equal over {len(vals)} columns, "
              f"{start.numel()} blocks to {out_len} lanes", flush=True)
    errs["scatter_blocks"] = 0.0
    return errs


def _render_full_width(name, cfg, device, batch: int, steady: int, kernels):
    """`cfg` through the CUDA kernels at full width, the launch counters
    reset just before and read just after; every kernel of `kernels` must
    have launched on the steady batches too, none of the general path's
    absent ones; the image finite and not black. Returns (engine, counts,
    per steady batch)."""
    import numpy as np
    import torch

    from ice_halo_sim_tpu_torch.engine.simulator import Engine
    from ice_halo_sim_tpu_torch.kernels import build

    eng = Engine(cfg, seed=7, batch_size=batch, device=device)
    if eng.trace_path != "general":
        raise AssertionError(f"{name}: trace path {eng.trace_path}")
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    build.reset_launch_counts()
    eng.run(n_batches=1)
    first = dict(build.LAUNCHES)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    eng.run(n_batches=steady)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    counts = dict(build.LAUNCHES)
    per_batch = {k: (counts[k] - first[k]) / steady for k in counts}
    for k in kernels:
        if counts[k] <= 0 or per_batch[k] <= 0:
            raise AssertionError(f"kernel {k} was not launched on the {name} path")
    for k in GENERAL_ABSENT:
        if counts[k]:
            raise AssertionError(f"kernel {k} was launched on the {name} path ({counts[k]})")
    st = eng.drain_stats()
    img = eng.raw_xyz(0)
    if not np.isfinite(img).all() or img.max() <= 0 or eng.snapshot()[0].max() == 0:
        raise AssertionError(f"{name}: the image is not finite or is black")
    print(f"  {name}: batch {eng.batch_size}, {len(eng.layers)} layers, lanes per layer "
          f"{[l.cont_cap for l in eng.layers]}, slot cap {eng._slot_cap}, keep "
          f"{eng._compact_keep}; calibrating batch {t1 - t0:.3f} s, {steady} steady "
          f"{t2 - t1:.3f} s; peak memory {torch.cuda.max_memory_allocated(device)} B; segments "
          f"{st.ray_segments} ({st.ray_segments / (batch * (1 + steady)):.1f}"
          f" a root ray), landed {st.landed_weight}, dropped {st.dropped_cont_weight}; "
          f"launches per steady batch { {k: v for k, v in per_batch.items() if v} }", flush=True)
    return eng, counts, per_batch


def _bench_kernels_at(cfg, device) -> dict:
    """K3 with the marker tail, the radix sort and K4's extract form at
    BENCH_CFG's shapes at 2048 x 1024 (P = 2^21): bit-equal and within
    SCAN_RTOL of their plain versions, the same bits twice, and their times."""
    import torch

    from ice_halo_sim_tpu_torch.core import accum, block_ops, seg_scan, trace_emit
    from ice_halo_sim_tpu_torch.engine.simulator import Engine

    eng = Engine(cfg, seed=7, batch_size=BATCH, device=device)
    plan = eng._trace_plan
    P = eng.proj_plans[0].height * eng.proj_plans[0].width
    K = eng.k_pool
    shift = accum.key_shift(K)
    (keys, wts, counts), *_ = trace_emit.trace_emit(plan, 5 * eng.span, BATCH, device)[0]
    live = int(counts.sum())
    keep = -(-int(live * 1.06) // accum.BLOCK) * accum.BLOCK
    out_total = -(-(keep + P) // accum.BLOCK) * accum.BLOCK
    start = (torch.cumsum(counts.long(), 0) - counts.long()).int()
    tail = (keep, P, shift, 2 * K - 1)
    sargs = ([keys, wts], start, out_total, plan.rows_block[0])
    a = block_ops.scatter_blocks_multi(*sargs, marker_tail=tail)
    b = block_ops.scatter_blocks_multi_plain(*sargs, marker_tail=tail)
    if not all(_bits_equal(x, y) for x, y in zip(a, b)) or not all(
            _bits_equal(x, y) for x, y in
            zip(a, block_ops.scatter_blocks_multi(*sargs, marker_tail=tail))):
        raise AssertionError("K3 with the marker tail at 2048 x 1024 differs from its plain "
                             "version or from itself")
    rs = _radix_sort_check(*a, accum.sort_end_bit(P, K), "2048 x 1024")
    sk, sw = accum.sort_keys(*a, eng.ks, accum.sort_end_bit(P, K))
    tbl = eng.basis_tbl
    img_k = seg_scan.fused_scan_extract(sk, sw, tbl, shift, K, P)
    img_p = seg_scan.fused_scan_extract_plain(sk, sw, tbl, shift, K, P)
    err = _max_abs(img_k, img_p)
    if not torch.allclose(img_k, img_p, rtol=SCAN_RTOL, atol=1e-6) or not _bits_equal(
            seg_scan.fused_scan_extract(sk, sw, tbl, shift, K, P), img_k):
        raise AssertionError(f"K4 at 2048 x 1024 differs from its plain version (max abs "
                             f"{err}) or from itself")
    m = sk.numel()
    out = {
        "scatter_blocks_multi": {
            "rows": out_total, "pixels": P, "max_abs_err": 0.0,
            "ms": _time_ms(lambda: block_ops.scatter_blocks_multi(*sargs, marker_tail=tail),
                           10, "K3 2048x1024"),
            "bound": least_seconds(8 * live + 4 * start.numel() + 8 * out_total,
                                   2 * out_total)},
        "fused_scan_extract": {
            "rows": m, "pixels": P, "max_abs_err": err,
            "ms": _time_ms(lambda: seg_scan.fused_scan_extract(sk, sw, tbl, shift, K, P), 10,
                           "K4 2048x1024"),
            "bound": least_seconds(8 * m + 12 * P + 4 * tbl.numel(), 6 * m)},
        "trace_emit": {
            "max_abs_err": None,
            "ms": _time_ms(lambda: trace_emit.trace_emit(plan, 5 * eng.span, BATCH, device), 5,
                           "K2 2048x1024"),
            "bound": _trace_bound("trace_emit 2048x1024", plan)},
        "radix_sort": rs,
    }
    rs["bound_passes_ms"] = 1e3 * rs.pop("bound_passes")[0]
    for k, v in out.items():
        bound_s, v["bound_by"] = v.pop("bound")
        v["bound_ms"] = 1e3 * bound_s
        print(f"  {k} at 2048 x 1024: kernel {v['ms']:.4f} ms, bound {v['bound_ms']:.5f} ms by "
              f"{v['bound_by']}, max_abs_err {v['max_abs_err']}", flush=True)
    return out


def phase_scenes(smi, res: list, device=None) -> None:
    """[11] The reference bench scenes on the card: each stand-in of
    scenes.py at full width through the sort fold with
    the launch counters reset just before and read just after, each kernel
    it launched against its plain twin at its shapes; MULTI_CFG, COMPLEX_CFG
    and BD_CFG also against kernels="plain" engines on the card, PYRAMID3_CFG
    so at a small batch; BENCH_CFG at 2048 x 1024 through K2, K3 and K4
    against the plain path and its kernels at those shapes."""
    import torch

    from ice_halo_sim_tpu_torch import scenes
    from ice_halo_sim_tpu_torch.config.loader import load_project

    device = torch.device("cuda", 0) if device is None else device
    t_phase = time.time()
    print(f"[11] the reference bench scenes (stand-ins) on {smi}", flush=True)
    launches, per_steady, errs = {}, {}, {}
    for name, const, batch, steady in STAND_INS:
        cfg = load_project(getattr(scenes, const))
        if name == "pyramid":
            eng, counts, per_batch = _render_full_width(
                name, cfg, device, batch, steady, ["scatter_blocks", "fused_scan_extract"])
            phase_slice("pyramid (small batch)", cfg, device,
                        ["scatter_blocks", "fused_scan_extract"], steady, "general",
                        GENERAL_ABSENT, batch=PYRAMID_SMALL_BATCH)
        else:
            eng, counts, per_batch = phase_slice(
                name, cfg, device, ["scatter_blocks", "fused_scan_extract"], steady,
                "general", GENERAL_ABSENT, batch=batch)
        if eng._compact_keep is not None and per_batch["compact_rows"] <= 0:
            raise AssertionError(f"{name}: compact_rows was not launched on a steady batch")
        launches[name], per_steady[name] = counts, per_batch
        for k, e in _stand_in_kernels(name, eng).items():
            errs[k] = max(errs.get(k, 0.0), e)
        print(f"[11] {name}: {time.time() - t_phase:.1f} s into [11]", flush=True)
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    big = load_project(_with_res(scenes.BENCH_CFG, BIG_RES))
    _eng, launches["bench 2048x1024"], per_steady["bench 2048x1024"] = phase_slice(
        "bench 2048x1024", big, device,
        ["trace_emit", "scatter_blocks_multi", "radix_sort", "fused_scan_extract"], 2,
        absent=["pack_rows", "pack_payload_blocks", "fused_scan", "pack_valid_blocks",
                "compact_rows", "scatter_blocks"])
    del _eng
    big_kernels = _bench_kernels_at(big, device)
    print(f"[11] stand-ins' kernels against their plain twins at their shapes: max_abs_err "
          f"{errs}; {time.time() - t_phase:.1f} s into [11]", flush=True)
    for k in res:
        k["launches_scenes"] = {n: c[k["name"]] for n, c in launches.items() if c[k["name"]]}
        k["launches_per_steady_batch_scenes"] = {
            n: c[k["name"]] for n, c in per_steady.items() if c[k["name"]]}
        if k["name"] in errs:
            k["max_abs_err_scenes"] = errs[k["name"]]
        if k["name"] in big_kernels:
            k["at_2048x1024"] = big_kernels[k["name"]]
    print(f"[11]: {time.time() - t_phase:.1f} s", flush=True)


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
    for kernel in ("trace_emit_kernel", "trace_layer", "scan_kernel", "sandwich_"):
        for line in build.ptxas_report(kernel):
            print(f"  {line}", flush=True)
    lib = build.lib()
    print("  sandwich blocks' dynamic shared memory (bytes, C = 3 / 1, one or two bf16 "
          f"terms): {[lib.iht_sandwich_smem(c, t) for c in (3, 1) for t in (0, 1)]}", flush=True)

    bench, pool = load_project(BENCH_CFG), load_project(POOL_CFG)
    ms, colour = load_project(MS_CFG), load_project(COLOR_CFG)
    two_layer = load_project(_two_layer_doc())
    ms_first = copy.deepcopy(MS_CFG)
    ms_first["scene"]["scattering"] = ms_first["scene"]["scattering"][:1]
    ms_first["filter"] = []
    print("[3] kernels vs plain twins at the main paths' shapes", flush=True)
    res = []
    phase_kernels(bench, device, res)
    phase_kernel_pool(pool, device, res)
    phase_kernels_general(ms, colour, device, res)
    phase_kernel_layer(device, res)
    phase_kernels_sandwich(device, res)

    print("[4] slices", flush=True)
    # The trace kernel packs its rows (no K1), and the spectral folds extract
    # their images in the scan (no K5, no per-row scan).
    # The general path compacts in one pass (compact_rows: no K6, no K3'
    # before the fold); the continuation's block scatter is K3'.
    common = ["scatter_blocks_multi", "radix_sort", "fused_scan_extract"]
    gone = ["pack_rows", "pack_payload_blocks", "fused_scan", "pack_valid_blocks",
            "compact_rows", "scatter_blocks"]
    prepass = ["compact_rows"]
    engines, counts, per_batch = {}, {}, {}
    for name, cfg, kernels, steady, path, absent in (
            ("bench", bench, ["trace_emit"] + common, 3, "cuda-trace-kernel", gone),
            ("pool", pool, ["trace_emit_pool"] + common, 2, "cuda-trace-kernel", gone),
            ("ms", ms, prepass + ["scatter_blocks", "radix_sort", "fused_scan_extract"], 3,
             "general",
             ["pack_rows", "pack_payload_blocks", "fused_scan", "pack_valid_blocks",
              "scatter_blocks_multi"]),
            ("color", colour, prepass + ["pack_payload_blocks", "scatter_blocks_multi"], 2,
             "general", ["pack_rows", "fused_scan", "fused_scan_extract",
                         "pack_valid_blocks", "scatter_blocks"]),
            ("two_layer", two_layer, prepass + ["trace_layer_emit", "scatter_blocks",
                                                "radix_sort", "fused_scan_extract"], 2,
             "general", ["pack_rows", "pack_payload_blocks", "fused_scan", "pack_valid_blocks",
                         "scatter_blocks_multi"])):
        engines[name], counts[name], per_batch[name] = phase_slice(
            name, cfg, device, kernels, steady, path, absent)
        if name == "bench":
            phase_fixture("bench", bench, device, 0, 0)
            phase_paths_agree(bench, device)
        elif name == "pool":
            phase_fixture("pool", pool, device, POOL_FIX_PIXELS, POOL_FIX_SEGMENTS)
        elif name == "ms":
            phase_fixture("ms", load_project(ms_first), device, EDGE_PIXELS, EDGE_SEGMENTS,
                          emit_floor_off=False)
    from ice_halo_sim_tpu_torch import probe_sandwich, probe_scatter
    counts["probe_sandwich"] = phase_probe("sandwich_iota", probe_sandwich.main)
    counts["probe_scatter"] = phase_probe("extract_blocks", probe_scatter.main)
    # Launches of a kernel on the main path that runs it: the pool scene for
    # the blocked-pool trace, MS_CFG for the fold prepass, COLOR_CFG for K5
    # (the colour lanes' extraction), the probes' own runs for P1 and P2, else
    # BENCH_CFG (0 for K1, the per-row scan, K7 and K8, which no path
    # launches now).
    home = {"trace_emit_pool": "pool", "pack_valid_blocks": "ms", "scatter_blocks": "ms",
            "compact_rows": "ms",
            "pack_payload_blocks": "color",
            "sandwich_iota": "probe_sandwich", "extract_blocks": "probe_scatter",
            "trace_layer": "ms", "trace_layer_emit": "two_layer"}
    # KL: one launch a layer on the general path's steady batches, none on
    # the trace kernel's: its emit mode where the layer's epilogue is the
    # kernel's (the two-layer document), the render mode where it is plain
    # (MS_CFG's filter and fisheye equidistant, COLOR_CFG's colour classes).
    epilogues = {n: engines[n].layer_epilogue for n in per_batch}
    epi_want = {"bench": [None], "pool": [None], "ms": ["plain: lens 2", "plain: filter"],
                "color": ["plain: colour"], "two_layer": ["kernel", "kernel"]}
    kl = {n: (per_batch[n]["trace_layer"], per_batch[n]["trace_layer_emit"]) for n in per_batch}
    kl_want = {n: (float(sum(e not in (None, "kernel") for e in epi_want[n])),
                   float(epi_want[n].count("kernel"))) for n in per_batch}
    print(f"  trace_layer (KL) and its emit mode, launches per steady batch: {kl} (one a "
          f"layer on the general path: {kl_want}); epilogues {epilogues}", flush=True)
    if kl != kl_want or epilogues != epi_want:
        raise AssertionError(f"KL launches per steady batch {kl}, not {kl_want}; epilogues "
                             f"{epilogues}, not {epi_want}")
    for k in res:
        k["launches"] = counts[home.get(k["name"], "bench")][k["name"]]
        k["launches_per_steady_batch"] = {n: per_batch[n][k["name"]] for n in per_batch}
    print("  launches per steady batch of the compactions (K6 pack_valid_blocks, K3' "
          "scatter_blocks, compact_rows): " + "; ".join(
              f"{n} {[per_batch[n][k] for k in ('pack_valid_blocks', 'scatter_blocks', 'compact_rows')]}"
              for n in per_batch), flush=True)

    for name, eng in engines.items():
        rate = phase_rate(eng, 20 if name in ("bench", "pool") else 8)
        print(f"[5] {name} steady rate: {rate:.6g} rays/s (batch {BATCH}, "
              f"{eng.trace_path}, fold {eng.fold_kind}, {eng.graph_mode}) on {smi}", flush=True)
    del engines
    t5 = time.time()
    for name, cfg in (("bench", bench), ("pool", pool), ("ms", ms), ("color", colour)):
        phase_graphs(name, cfg, device)
    phase_bench(smi)
    print(f"[5] and [6]: {time.time() - t5:.1f} s", flush=True)
    phase_gradients()
    phase_serving(smi, res)
    phase_debug_capi(smi, res)
    phase_parallel(smi, res)
    phase_scenes(smi, res)
    print(f"timings that fell back to CUDA events: {len(FALLBACKS)} "
          f"{json.dumps(FALLBACKS)}", flush=True)
    print(f"total {time.time() - t_start:.1f} s", flush=True)

    print(json.dumps({"kernels": res}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank-worker"]:
        sys.exit(rank_worker(sys.argv[2:]))
    sys.exit(main())
