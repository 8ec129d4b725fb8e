#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises; the exit code is then non-zero):
  1. device: a CUDA device must be present; prints the card's name and
     power limit (nvidia-smi);
  2. build: compiles the port's CUDA kernels from csrc/ (nvcc, ctypes);
  3. kernels: each kernel against its plain PyTorch twin on the card, at
     the main path's shapes (bench.py's BENCH_CFG, batch 229376 = 112 x
     2048 rays, P = 131072 pixels, K = 64), with its error and both
     device times per call (torch.profiler);
  4. slice: Engine(BENCH_CFG, device="cuda") renders several batches with
     the launch counters reset first; every kernel must have launched; the
     image and stats must match kernels="plain" on the card, and the
     fixture configuration must match tests/data/torch_port_bench_ref.npz
     (the JAX engine's render) within the CPU test's tolerance;
  5. steady rays/s of the slice (informational).

The last two lines of standard output are the kernels JSON object and the
device JSON object. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
BATCH = 112 * 2048
FIXTURE = os.path.join(ROOT, "tests", "data", "torch_port_bench_ref.npz")

# Tolerances (shared with tests/test_torch_engine.py for the fixture).
IMG_RTOL, IMG_ATOL_FRAC = 1e-4, 1e-6   # per pixel, atol = frac * image max
SUM_RTOL = 1e-5                        # image sum and landed weight
SCAN_RTOL = 1e-6                       # K4 kernel vs twin: both sum in f64
FLIP_ROWS = 64                         # K2 rows allowed to move (float flips)


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


def phase_kernels(cfg, device):
    import torch

    from ice_halo_sim_tpu_torch.core import accum, block_ops, seg_scan, trace_emit
    from ice_halo_sim_tpu_torch.engine.simulator import Engine

    eng = Engine(cfg, seed=7, batch_size=BATCH, device=device)
    plan = eng._trace_plan
    P = eng.proj_plans[0].height * eng.proj_plans[0].width
    K = eng.k_pool
    shift = accum.key_shift(K)
    base = 5 * BATCH * 2
    results = []

    def entry(name, source, replaces, err, ms, plain_ms):
        results.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": 0, "max_abs_err": err,
                        "ms": ms, "plain_ms": plain_ms})
        print(f"  {name}: max_abs_err {err:.3g}, kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms", flush=True)

    # K2 (+ K1 inside the wrapper) against the plain twin.
    args = (plan, base & 0xFFFFFFFF, base >> 32, BATCH, device)
    out_k = trace_emit.trace_emit(*args)
    out_p = trace_emit.trace_emit_plain(*args)
    d = trace_emit.trace_output_diff(out_k[0], out_p[0])
    if d["rows_diff"] > FLIP_ROWS:
        raise AssertionError(f"trace_emit rows differ beyond the flip budget: {d}")
    if d["rows_diff"] == 0 and d["w_rel"] > 1e-6:
        raise AssertionError(f"trace_emit weights differ: {d}")
    if int(out_k[3]) != int(out_p[3]) and d["rows_diff"] == 0:
        raise AssertionError(f"segments {int(out_k[3])} != {int(out_p[3])}")
    # landed: sums of positive weights; dropped: a difference of two large
    # float32 sums (the roulette adds mass as well as removing it), so its
    # tolerance is absolute, a millionth of the landed weight.
    landed_tot = float(out_p[1].double().sum())
    if not torch.allclose(out_k[1].double(), out_p[1].double(), rtol=SUM_RTOL):
        raise AssertionError(f"trace_emit landed differs: {out_k[1]} vs {out_p[1]}")
    if abs(float(out_k[2]) - float(out_p[2])) > 1e-6 * landed_tot:
        raise AssertionError(f"trace_emit dropped differs: {out_k[2]} vs {out_p[2]}")
    keys, wts, counts = out_k[0][0]
    err = _max_abs(wts, out_p[0][0][1]) if d["rows_diff"] == 0 else float(d["w_rel"])
    print(f"  trace_emit diff {d}, live rows {int(counts.sum())}", flush=True)
    entry("trace_emit", "ice_halo_sim_tpu_torch/csrc/trace_emit.cu",
          "ice_halo_sim_tpu/core/pallas_trace.py:318", err,
          _time_ms(lambda: trace_emit.trace_emit(*args), 5),
          _time_ms(lambda: trace_emit.trace_emit_plain(*args), 2))

    # K1: the trace rows' in-block pack, on the uncompacted slab.
    slabs, *_ = trace_emit.trace_rows_plain(*args)
    sk_, sw_ = slabs[0][0].reshape(-1), slabs[0][1].reshape(-1)
    rb = plan.rows_block[0]
    a = block_ops.pack_rows(sk_, sw_, rb)
    b = block_ops.pack_rows_plain(sk_, sw_, rb)
    if not all(_bits_equal(x, y) for x, y in zip(a, b)):
        raise AssertionError("pack_rows (K1) differs from its plain twin")
    entry("pack_rows", "ice_halo_sim_tpu_torch/csrc/block_ops.cu",
          "ice_halo_sim_tpu/core/pallas_ops.py:245", 0.0,
          _time_ms(lambda: block_ops.pack_rows(sk_, sw_, rb)),
          _time_ms(lambda: block_ops.pack_rows_plain(sk_, sw_, rb)))

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
    entry("scatter_blocks_multi", "ice_halo_sim_tpu_torch/csrc/block_ops.cu",
          "ice_halo_sim_tpu/core/pallas_ops.py:436", 0.0,
          _time_ms(lambda: block_ops.scatter_blocks_multi(*sargs, marker_tail=tail)),
          _time_ms(lambda: block_ops.scatter_blocks_multi_plain(*sargs, marker_tail=tail)))

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
    entry("fused_scan", "ice_halo_sim_tpu_torch/csrc/seg_scan.cu",
          "ice_halo_sim_tpu/core/pallas_scan.py:144", err,
          _time_ms(lambda: seg_scan.fused_scan_call(sk, sw, tbl, shift, K, True)),
          _time_ms(lambda: seg_scan.fused_scan_call_plain(sk, sw, tbl, shift, K, True)))

    # K5 on the scan output (the marker extraction's pack).
    a = block_ops.pack_payload_blocks(k2a, ca, P, accum.BLOCK)
    b = block_ops.pack_payload_blocks_plain(k2a, ca, P, accum.BLOCK)
    if not (all(_bits_equal(x, y) for x, y in zip(a[0], b[0])) and _bits_equal(a[1], b[1])):
        raise AssertionError("pack_payload_blocks (K5) differs from its plain twin")
    entry("pack_payload_blocks", "ice_halo_sim_tpu_torch/csrc/block_ops.cu",
          "ice_halo_sim_tpu/core/pallas_ops.py:365", 0.0,
          _time_ms(lambda: block_ops.pack_payload_blocks(k2a, ca, P, accum.BLOCK)),
          _time_ms(lambda: block_ops.pack_payload_blocks_plain(k2a, ca, P, accum.BLOCK)))
    del eng
    return results


def _close_images(a, b, what):
    import numpy as np

    if not np.isclose(a.sum(), b.sum(), rtol=SUM_RTOL):
        raise AssertionError(f"{what}: image sum {a.sum()} vs {b.sum()}")
    tol = IMG_RTOL * np.abs(b) + IMG_ATOL_FRAC * np.abs(b).max()
    bad = int((np.abs(a - b) > tol).any(-1).sum())
    return bad


def phase_slice(cfg, device, counts_out):
    import numpy as np
    import torch

    from ice_halo_sim_tpu_torch.engine.simulator import Engine
    from ice_halo_sim_tpu_torch.kernels import build

    eng = Engine(cfg, seed=7, batch_size=BATCH, device=device)
    if eng.trace_path != "cuda-trace-kernel":
        raise AssertionError(f"trace path {eng.trace_path}")
    build.reset_launch_counts()
    eng.run(n_batches=1)
    eng.run(n_batches=3)
    torch.cuda.synchronize()
    counts_out.update(build.LAUNCHES)
    print(f"  launches {build.LAUNCHES}, keep {eng._compact_keep}, "
          f"host syncs {eng.host_syncs}", flush=True)
    for name, n in build.LAUNCHES.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched on the main path")
    st = eng.drain_stats()

    ref = Engine(cfg, seed=7, batch_size=BATCH, device=device, kernels="plain")
    ref.run(n_batches=1)
    ref.run(n_batches=3)
    rst = ref.drain_stats()
    a, b = eng.raw_xyz(0), ref.raw_xyz(0)
    bad = _close_images(a, b, "cuda vs plain")
    seg_diff = abs(st.ray_segments - rst.ray_segments)
    print(f"  cuda vs plain: segments {st.ray_segments} / {rst.ray_segments}, "
          f"landed {st.landed_weight} / {rst.landed_weight}, pixels off {bad}",
          flush=True)
    if bad > FLIP_ROWS or seg_diff > FLIP_ROWS * 7:
        raise AssertionError("cuda slice differs from the plain slice")
    if not np.isclose(st.landed_weight, rst.landed_weight, rtol=SUM_RTOL):
        raise AssertionError("landed weight differs")
    img = eng.snapshot()[0]
    if img.max() == 0:
        raise AssertionError("snapshot is black")
    print(f"  snapshot max {img.max()}, mean {img.mean():.3f}", flush=True)
    return eng


def phase_fixture(cfg, device):
    import numpy as np

    from ice_halo_sim_tpu_torch.engine.simulator import Engine

    ref = np.load(FIXTURE)
    old = os.environ.get("IHT_MIN_EMIT_W")
    os.environ["IHT_MIN_EMIT_W"] = "0"
    try:
        eng = Engine(cfg, seed=int(ref["seed"]), batch_size=int(ref["batch_size"]),
                     device=device)
    finally:
        if old is None:
            del os.environ["IHT_MIN_EMIT_W"]
        else:
            os.environ["IHT_MIN_EMIT_W"] = old
    eng.run(n_batches=1)
    eng.run(n_batches=int(ref["n_batches"]) - 1)
    st = eng.drain_stats()
    a, b = eng.raw_xyz(0), ref["raw_xyz"]
    bad = _close_images(a, b, "fixture")
    print(f"  fixture: segments {st.ray_segments} / {int(ref['ray_segments'])}, "
          f"landed {st.landed_weight} / {float(ref['landed_weight'])}, "
          f"image sum {a.sum()} / {b.sum()}, pixels off {bad}", flush=True)
    if bad or st.ray_segments != int(ref["ray_segments"]):
        raise AssertionError("the CUDA slice does not match the JAX fixture")
    if not np.isclose(st.landed_weight, float(ref["landed_weight"]), rtol=SUM_RTOL):
        raise AssertionError("landed weight differs from the fixture")


def phase_rate(eng):
    import torch

    eng.run(n_batches=2)
    torch.cuda.synchronize()
    n = 20
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
    from bench import BENCH_CFG
    from ice_halo_sim_tpu.config.loader import load_project
    from ice_halo_sim_tpu_torch.kernels import build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"[1] device: {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
          f"cuda {torch.version.cuda}", flush=True)
    device = torch.device("cuda", 0)

    t0 = time.time()
    path = build.build()
    build.lib()
    print(f"[2] build: {time.time() - t0:.1f} s -> {os.path.relpath(path, ROOT)}",
          flush=True)

    cfg = load_project(BENCH_CFG)
    print("[3] kernels vs plain twins at the main path's shapes", flush=True)
    kernels = phase_kernels(cfg, device)

    print("[4] slice", flush=True)
    counts = {}
    eng = phase_slice(cfg, device, counts)
    phase_fixture(cfg, device)
    for k in kernels:
        k["launches"] = counts[k["name"]]

    rate = phase_rate(eng)
    print(f"[5] steady rate: {rate:.6g} rays/s (batch {BATCH}) on {smi}", flush=True)

    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
