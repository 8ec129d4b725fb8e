"""Profile one of the port's main paths on one CUDA device: BENCH_CFG (the
static trace mode), POOL_CFG (the blocked-pool mode with its per-batch pool
sampler), MS_CFG or COLOR_CFG (the general trace path) of scenes.py, at batch
229376, calibrated steady state, under torch.profiler.

    python -m ice_halo_sim_tpu_torch.profile_slice [--scene bench|pool|ms|color]
        [--batches 10] [--out FILE]

Prints the card (nvidia-smi name and power limit), the wall time per
batch, the device time per kernel name (CUDA time summed over the window)
and the device idle share = 1 - (sum of kernel time) / wall time (kernels
of one stream do not overlap here). The plain-torch stages that have no
kernel of the port are also run alone under the profiler, so that each reads
off one line: the pool sampler (every layer's), and on the general path the
whole general trace (samplers, trace, gates, projection, continuation) and
the continuation alone (on the inputs of a captured batch); the folds are
the rest. On the general path the report names the fold (``Engine.fold_kind``
and ``fold_decision``; the knob IHT_FOLD=sandwich|sort|auto chooses, as for
any run of the engine) and, on the sandwich fold, its levels.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", choices=("bench", "pool", "ms", "color"), default="bench")
    ap.add_argument("--batches", type=int, default=10)
    ap.add_argument("--batch-size", type=int, default=112 * 2048)
    ap.add_argument("--out", default=None, help="also write the report here")
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_slice: no CUDA device", file=sys.stderr)
        return 1
    from ice_halo_sim_tpu_torch import scenes
    from ice_halo_sim_tpu_torch.config.loader import load_project
    from ice_halo_sim_tpu_torch.engine.simulator import Engine

    doc = {"bench": scenes.BENCH_CFG, "pool": scenes.POOL_CFG, "ms": scenes.MS_CFG,
           "color": scenes.COLOR_CFG}[args.scene]

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    eng = Engine(load_project(doc), seed=7, batch_size=args.batch_size,
                 device="cuda")
    eng.run(n_batches=1)
    eng.run(n_batches=3)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        syncs = eng.host_syncs
        eng.run(n_batches=args.batches)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        syncs = eng.host_syncs - syncs
    rows = []
    for e in prof.key_averages():
        if not str(e.device_type).endswith("CUDA"):
            continue  # CPU ops: their kernels are listed as CUDA events
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append((dev_us, e.count, e.key))
    rows.sort(reverse=True)
    busy_us = sum(r[0] for r in rows)
    def alone(fn):
        """(device us, device kernels) of args.batches calls of fn(i)."""
        with profile(activities=[ProfilerActivity.CUDA]) as sprof:
            for i in range(args.batches):
                fn(i)
            torch.cuda.synchronize()
        ev = [e for e in sprof.key_averages() if str(e.device_type).endswith("CUDA")]
        return sum(e.self_device_time_total for e in ev), sum(e.count for e in ev)

    def line(what, us, n):
        return (f"{what} alone: {us / 1e3 / args.batches:.4f} ms/batch device time in "
                f"{n / args.batches:.0f} device kernels per batch "
                f"({us / busy_us:.3f} of device busy)")

    label_lines = []
    if any(not all(l.deterministic_shape) for l in eng.layers):
        # The pool samplers (plain torch ops, no kernel of the port).
        label_lines.append(line("pool sampler", *alone(lambda i: [
            eng._sample_layer_pool(1000 + i, li=li) for li in range(len(eng.layers))])))
    if eng._trace_plan is None:
        def trace(i):
            base = eng.ray_base(2000 + i)
            eng._trace_batch_impl(base & 0xFFFFFFFF, base >> 32, 2000 + i)

        label_lines.append(line("general trace (samplers, trace, gates, projection, "
                                "continuation)", *alone(trace)))
        if len(eng.layers) > 1:
            captured = []
            inner = eng._continuation
            eng._continuation = lambda *a: captured.append(a) or inner(*a)
            trace(0)
            eng._continuation = inner
            label_lines.append(line(f"continuation ({len(captured)} per batch)", *alone(
                lambda i: [inner(*a) for a in captured])))
        costs = "" if eng.fold_costs is None else (
            f"; modeled ms per batch: sandwich {eng.fold_costs['sandwich_ms']:.4f}, sort "
            f"{eng.fold_costs['sort_ms']:.4f}")
        label_lines.append(f"fold {eng.fold_kind} ({eng.fold_decision}){costs}")
        if eng.fold_kind == "sandwich":
            label_lines.append("sandwich levels (listed chunks, keep) per render: " + str(
                [[(int(cl.shape[0]), keep) for cl, keep in lv] for lv in eng._levels])
                + f"; rows into the last level {[int(n) for n in eng.last_level_rows]}")
        label_lines.append(
            f"trace path {eng.trace_path}: slot cap {eng._slot_cap}, keep {eng._compact_keep}, "
            f"lanes per layer {[l.cont_cap for l in eng.layers]}, host syncs per batch "
            f"{syncs / args.batches:.1f}")
    lines = [
        f"card: {card}",
        f"scene {args.scene}, batch {args.batch_size}, {args.batches} batches, wall {wall * 1e3 / args.batches:.4f} "
        f"ms/batch, {args.batches * args.batch_size / wall:.6g} rays/s",
        f"device busy {busy_us / 1e3 / args.batches:.4f} ms/batch, idle share "
        f"{1.0 - busy_us / 1e6 / wall:.4f}",
        f"device kernels per batch: {sum(r[1] for r in rows) / args.batches:.0f}",
    ] + label_lines + [
        "device time by kernel (ms/batch, share of busy, launches):",
    ]
    for us, n, key in rows:
        lines.append(f"  {us / 1e3 / args.batches:9.4f}  {us / busy_us:6.3f}  {n:5d}  {key[:90]}")
    report = "\n".join(lines)
    print(report)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(report + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
