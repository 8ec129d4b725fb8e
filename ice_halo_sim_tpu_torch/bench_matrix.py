"""The port's benchmark matrix: steady rays/s of the reference bench scenes,
scene x resolution, on one CUDA device.

    python -m ice_halo_sim_tpu_torch.bench_matrix [--scenes light,ms_multi,...]
        [--res 512x256,2048x1024] [--reps 5] [--batch 229376]
        [--rep-seconds 2] [--device cuda|cpu] [--quick]

A twin of the JAX package's ``scripts/bench_matrix.py`` with its
discipline: a steady rate that leaves out the build, the calibration and
the first captures; at least five repetitions with their median and
coefficient of variation (a CoV of 5% or more is printed as it is); the
resolution always stated; one JSON line per cell. Each render of the scene
takes the cell's resolution, as in ``run_cell``.

Scenes (``scenes.py``):
  light          BENCH_CFG (the reference's bench_light_single_ms, field for field)
  ms_multi       MULTI_CFG, a stand-in for ms_multi_crystal
  complex_sop    COMPLEX_CFG, a stand-in for ms_multi_crystal_complex_filter
  filtered_bd    BD_CFG, a stand-in for ms_multi_crystal_filtered_bd
  pyramid        PYRAMID3_CFG, a stand-in for ms3_mixed_pyramid_heavy
  raypath_color  COLOR_CFG, the port's three-class scene (a stand-in for
                 raypath_color_three_arcs)
A stand-in is built from the repo's description of the reference scene
(``scenes.py``), so its rate is not compared with the reference's legacy
CPU rate (``vs_baseline_cpu`` is null); only ``light`` carries it.

A cell: an Engine at the cell's batch (``--batch``; halved, at most three
times and not below 8192, only where the card runs out of memory, which
``batch_decision`` records; any other error raises); a warm-up of one
calibrating dispatch (run(n_batches=1)) and two full dispatches of
IHT_STEPS_PER_DISPATCH batches, the second timed; then ``--reps``
repetitions of the whole number of dispatches closest to ``--rep-seconds``
(at least one: the rep length is rounded to the dispatch grain), each ended
by a host copy of the landed weights; the card's SM clock, power draw and
temperature after them (``card_after_reps``).

``--quick``: light only, at 512x256, one repetition (what a CPU test runs
at a small batch). The matrix runs on the card unless asked for the CPU,
and fails without one; it writes no file. ``--small-scene`` of the JAX
script is left out: its scene file is not in the repository.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import statistics
import sys
import time

CARD_BATCH = 112 * 2048
MIN_BATCH = 8192
SCENES = ("light", "ms_multi", "complex_sop", "filtered_bd", "pyramid", "raypath_color")
# scene -> (constant of scenes.py, a stand-in?)
SCENE_DOCS = {
    "light": ("BENCH_CFG", False),
    "ms_multi": ("MULTI_CFG", True),
    "complex_sop": ("COMPLEX_CFG", True),
    "filtered_bd": ("BD_CFG", True),
    "pyramid": ("PYRAMID3_CFG", True),
    "raypath_color": ("COLOR_CFG", True),
}
# The reference's legacy-CPU rate of the one scene the port renders field
# for field (the JAX script's BASELINES["light"]).
BASELINE_CPU_LIGHT = 10.45e6


def _is_oom(exc: BaseException) -> bool:
    import torch

    msg = str(exc)
    return isinstance(exc, torch.cuda.OutOfMemoryError) or any(
        s in msg for s in ("out of memory", "can't allocate memory"))


def _cfg(scene: str, res):
    """The scene's project config with every render at `res` (w, h)."""
    from ice_halo_sim_tpu_torch import scenes
    from ice_halo_sim_tpu_torch.config.loader import load_project

    cfg = load_project(copy.deepcopy(getattr(scenes, SCENE_DOCS[scene][0])))
    return cfg.replace(renders=tuple(dataclasses.replace(r, resolution=tuple(res))
                                     for r in cfg.renders))


def _sync(engine) -> None:
    engine.accum[-1].cpu()


def _card_state(device: str):
    """The card's SM clock, power draw and temperature as nvidia-smi reads
    them right after a cell's repetitions (a card under its power limit
    slows under load, so a rate is read beside its clock); None on the
    CPU."""
    if device == "cpu":
        return None
    import subprocess

    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def run_cell(scene: str, res, batch: int, reps: int, rep_seconds: float,
             device: str) -> dict:
    """One cell at `batch` rays a batch. Raises what the engine raises."""
    from ice_halo_sim_tpu_torch.engine.simulator import Engine

    engine = Engine(_cfg(scene, res), seed=3, batch_size=batch, device=device)
    spd = engine.steps_per_dispatch
    cell = {
        "scene": scene, "stand_in": SCENE_DOCS[scene][1], "resolution": list(res),
        "batch_size": engine.batch_size, "steps_per_dispatch": spd,
        "trace_path": engine.trace_path,
    }
    engine.run(n_batches=1)
    _sync(engine)
    engine.run(n_batches=spd)
    _sync(engine)
    t0 = time.perf_counter()
    engine.run(n_batches=spd)
    _sync(engine)
    dispatch_s = time.perf_counter() - t0
    n_dispatches = max(1, round(rep_seconds / max(dispatch_s, 1e-9)))
    n_batches = n_dispatches * spd
    syncs = engine.host_syncs
    rates = []
    for _ in range(reps):
        t0 = time.perf_counter()
        engine.run(n_batches=n_batches)
        _sync(engine)
        rates.append(n_batches * engine.batch_size / (time.perf_counter() - t0))
    state = _card_state(device)
    med = statistics.median(rates)
    cell.update(
        fold=engine.fold_kind, fold_decision=engine.fold_decision,
        graph_mode=engine.graph_mode,
        rays_per_rep=n_batches * engine.batch_size, reps=reps, rates=rates,
        median_rays_per_sec=med, cov=statistics.pstdev(rates) / statistics.fmean(rates),
        host_reads_per_dispatch=(engine.host_syncs - syncs) / (reps * n_dispatches),
        overflow_replays=engine.overflow_replays, card_after_reps=state,
        vs_baseline_cpu=med / BASELINE_CPU_LIGHT if scene == "light" else None)
    return cell


def measure_cell(scene: str, res, batch: int, reps: int, rep_seconds: float,
                 device: str) -> dict:
    """run_cell at `batch`, halved after each out-of-memory error (at most
    three times, not below MIN_BATCH), as the JAX script measures a fit;
    any other error raises. A cell that never fits says so in ``error``."""
    import torch

    b = batch
    for attempt in range(4):
        try:
            cell = run_cell(scene, res, b, reps, rep_seconds, device)
            cell["batch_decision"] = (
                "requested" if b == batch else
                f"measured fit: halved from {batch} after {attempt} out-of-memory error(s)")
            return cell
        except (RuntimeError, MemoryError) as exc:
            if not _is_oom(exc):
                raise
            msg = str(exc)
        if device != "cpu":
            torch.cuda.empty_cache()
        if attempt == 3 or b // 2 < MIN_BATCH:
            break
        b //= 2
    return {"scene": scene, "stand_in": SCENE_DOCS[scene][1], "resolution": list(res),
            "batch_size": b, "error": msg[:300],
            "batch_decision": f"no fit down to {b} ({attempt} halvings from {batch})"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenes", default=",".join(SCENES))
    ap.add_argument("--res", default="512x256,2048x1024")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--batch", type=int, default=None,
                    help=f"rays per batch (default {CARD_BATCH} on the card, 4096 on the CPU)")
    ap.add_argument("--rep-seconds", type=float, default=2.0,
                    help="wall seconds a repetition aims at, in whole dispatches")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--quick", action="store_true",
                    help="light only, at 512x256, one repetition")
    args = ap.parse_args(argv)
    if args.quick:
        args.scenes, args.res, args.reps = "light", "512x256", 1
    scenes = [s.strip() for s in args.scenes.split(",") if s.strip()]
    unknown = [s for s in scenes if s not in SCENE_DOCS]
    if unknown:
        raise SystemExit(f"unknown scenes {unknown}; known: {', '.join(SCENES)}")
    if args.reps < 1:
        raise SystemExit("--reps must be at least 1")

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("bench_matrix: no CUDA device", file=sys.stderr)
        return 1
    card = None
    if args.device == "cuda":
        from ice_halo_sim_tpu_torch.bench import card as query_card

        card = query_card()
    batch = args.batch or (CARD_BATCH if args.device == "cuda" else 4096)
    for scene in scenes:
        for res_s in args.res.split(","):
            w, h = (int(x) for x in res_s.split("x"))
            cell = measure_cell(scene, (w, h), batch, args.reps, args.rep_seconds,
                                args.device)
            cell.update(platform=args.device, card=card)
            print(json.dumps(cell), flush=True)
            if args.device == "cuda":
                torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
