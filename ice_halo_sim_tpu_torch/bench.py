"""The port's benchmark: steady rays/s of BENCH_CFG (the reference's
``bench_light_single_ms`` scene, field for field) on one CUDA device.

    python -m ice_halo_sim_tpu_torch.bench [--window 8] [--windows 5]
        [--device cuda|cpu] [--kernels cuda|plain] [--batch-size N]

The measurement is the repository's bench.py's, on the port's engine:
batch 229376 (112 trace-kernel blocks of 2048 rays) on the card; a warm-up
of run(n_batches=1), which calibrates, and run(n_batches=steps_per_dispatch),
which captures the CUDA graph; then windows of about `window` seconds, each
a whole number of dispatches of IHT_STEPS_PER_DISPATCH batches ended by a
host copy of the landed weights (the sync). The rate of a window is its
rays over its wall time; ``value`` is the median window, with the windows'
coefficient of variation beside it.

Prints one JSON line with bench.py's keys (``platform`` is "cuda", or "cpu"
when asked for) and, added: every window's rate, ``median`` and ``cov``,
the host reads per batch and per dispatch in the windows (``host_syncs``,
the engine's count: calibration, the one read per dispatch, and an
overflowing batch's), ``overflow_replays``, ``graph_mode``, the dispatch
size and the card (nvidia-smi name and power limit). It runs on the card
unless asked for the CPU, and fails without one; it writes no file.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

BASELINE_CPU_RAYS_PER_SEC = 10.45e6   # the reference's legacy CPU backend on this scene
CARD_BATCH = 112 * 2048


def card() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` of the first card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def measure(engine, window: float, windows: int) -> list:
    """Rates (rays/s) of `windows` windows of whole dispatches, each at
    least `window` seconds of wall time, ended by a host copy."""
    chunk = engine.steps_per_dispatch
    rates = []
    for _ in range(windows):
        t0 = time.perf_counter()
        batches = 0
        while True:
            engine.run(n_batches=chunk)
            batches += chunk
            if time.perf_counter() - t0 >= window:
                break
        engine.accum[-1].cpu()
        rates.append(batches * engine.batch_size / (time.perf_counter() - t0))
    return rates


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--window", type=float, default=8.0, help="seconds per window")
    ap.add_argument("--windows", type=int, default=5)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--kernels", choices=("cuda", "plain"), default=None)
    ap.add_argument("--batch-size", type=int, default=None,
                    help=f"rays per batch (default {CARD_BATCH} on the card, 4096 on the CPU)")
    args = ap.parse_args(argv)
    if args.windows < 1:
        raise SystemExit("--windows must be at least 1")

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("bench: no CUDA device", file=sys.stderr)
        return 1
    from ice_halo_sim_tpu_torch.config.loader import load_project
    from ice_halo_sim_tpu_torch.engine.simulator import Engine
    from ice_halo_sim_tpu_torch.scenes import BENCH_CFG

    batch = args.batch_size or (CARD_BATCH if args.device == "cuda" else 4096)
    cfg = load_project(BENCH_CFG)
    engine = Engine(cfg, seed=7, batch_size=batch, device=args.device, kernels=args.kernels)
    engine.run(n_batches=1)
    engine.run(n_batches=engine.steps_per_dispatch)
    engine.accum[-1].cpu()

    syncs0, batches0 = engine.host_syncs, engine.batch_counter
    t0 = time.perf_counter()
    rates = measure(engine, args.window, args.windows)
    seconds = time.perf_counter() - t0
    n_batches = engine.batch_counter - batches0
    syncs = engine.host_syncs - syncs0
    median = statistics.median(rates)
    cov = statistics.pstdev(rates) / statistics.fmean(rates)
    print(json.dumps({
        "metric": "light_single_ms_rays_per_sec_per_chip",
        "value": median,
        "unit": "rays/s",
        "vs_baseline": median / BASELINE_CPU_RAYS_PER_SEC,
        "rays": n_batches * batch,
        "seconds": round(seconds, 3),
        "batch_size": batch,
        "resolution": list(cfg.renders[0].resolution),
        "platform": args.device,
        "max_hits": int(cfg.scene.max_hits),
        "fold": engine.fold_kind,
        "fold_decision": engine.fold_decision,
        "trace_path": engine.trace_path,
        "windows": rates,
        "median": median,
        "cov": cov,
        "host_syncs_per_batch": syncs / n_batches,
        "host_syncs_per_dispatch": syncs * engine.steps_per_dispatch / n_batches,
        "overflow_replays": engine.overflow_replays,
        "graph_mode": engine.graph_mode,
        "steps_per_dispatch": engine.steps_per_dispatch,
        "card": card() if args.device == "cuda" else None,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
