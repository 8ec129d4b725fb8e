"""Profile the port's steady batches, scene by scene, on one CUDA device:
every scene of scenes.py at batch 229376 (the pyramid at the batch that
fits, as the bench matrix fits it), calibrated steady state, under
torch.profiler (``utils.profiling``).

    python -m ice_halo_sim_tpu_torch.profile_slice [--scene bench,pool,...|all]
        [--batches 10] [--graphs on|off] [--out FILE] [--device cuda|cpu]

Scenes: bench (BENCH_CFG, the static trace mode), pool (POOL_CFG, the
blocked-pool mode with its per-batch pool sampler), ms, color, sundog
(MS_CFG, COLOR_CFG, SUNDOG_CFG: the general trace path), multi, complex,
bd, pyramid (the stand-ins of the reference's bench scenes).

Per window (one scene) the report prints the card (nvidia-smi name and
power limit), the wall time per batch, the device time per operation name
(CUDA time summed over the window) and the device idle share = 1 - (sum of
device time) / wall time (the operations of one stream do not overlap
here). The wall is that of a dispatch timed just before the window,
outside the profiler (which adds host time to every launch); the wall
inside the window is reported beside it. The plain-torch stages that have
no kernel of the port are also run alone under the profiler, so that each
reads off one line: the pool sampler (every layer's), and on the general
path the whole general trace (samplers, trace, gates, projection,
continuation) and the continuation alone (on the inputs of a captured
batch); the fold is the rest. On the general path the report names the
fold (``Engine.fold_kind`` and ``fold_decision``). Each window also
prints one JSON line: wall (and wall in the window), busy, kernels and
idle share per batch, the five operations that took the most device
time, host reads per dispatch.

The profiled window is one dispatch of --batches batches (IHT_STEPS_PER_DISPATCH
is raised to it): with --graphs on (the engine's default on the card) its
batches are replays of the captured CUDA graph, with off the same loop
eagerly. An engine that runs out of device memory is built again at half
the batch, at most three times and not below 8192 rays (bench_matrix's
rule), and the report says so. ``--device cpu`` runs the same report on
the CPU, where no device time is recorded ("not measured").
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

SCENES = {"bench": "BENCH_CFG", "pool": "POOL_CFG", "ms": "MS_CFG", "color": "COLOR_CFG",
          "sundog": "SUNDOG_CFG", "multi": "MULTI_CFG", "complex": "COMPLEX_CFG",
          "bd": "BD_CFG", "pyramid": "PYRAMID3_CFG"}
BATCH = 112 * 2048


@contextlib.contextmanager
def _knobs(kv: dict):
    """Environment knobs set while an Engine is built (it reads them in its
    constructor), then restored."""
    old = {k: os.environ.get(k) for k in kv}
    os.environ.update(kv)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                del os.environ[k]
            else:
                os.environ[k] = v


def _engine(doc, batch: int, device: str, graphs: bool, batches: int):
    """A calibrated Engine in steady state (one calibrating batch, then a
    dispatch of three), at `batch` halved after each out-of-memory error
    (bench_matrix.measure_cell's rule). Returns (engine, batch, how the batch
    was decided)."""
    import torch

    from ice_halo_sim_tpu_torch.bench_matrix import MIN_BATCH, _is_oom
    from ice_halo_sim_tpu_torch.config.loader import load_project
    from ice_halo_sim_tpu_torch.engine.simulator import Engine

    knobs = {"IHT_STEPS_PER_DISPATCH": str(batches)}
    b = batch
    for attempt in range(4):
        eng = None
        try:
            with _knobs(knobs):
                eng = Engine(load_project(doc), seed=7, batch_size=b, device=device,
                             graphs=graphs)
            eng.run(n_batches=1)
            eng.run(n_batches=3)
            decided = ("requested" if b == batch else
                       f"measured fit: halved from {batch} after {attempt} out-of-memory "
                       f"error(s)")
            return eng, b, decided
        except (RuntimeError, MemoryError) as exc:
            if not _is_oom(exc) or attempt == 3 or b // 2 < MIN_BATCH:
                raise
        del eng
        torch.cuda.empty_cache()
        b //= 2
    raise AssertionError("unreachable")


def profile_window(scene: str, batches: int, batch: int, graphs: bool, device: str,
                   card: str):
    """(report lines, summary dict) of one scene."""
    import torch

    from ice_halo_sim_tpu_torch import scenes
    from ice_halo_sim_tpu_torch.utils.profiling import device_profile

    cuda = device != "cpu"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    eng, batch, decided = _engine(getattr(scenes, SCENES[scene]), batch, device, graphs,
                                  batches)
    head = {"scene": scene, "fold": eng.fold_kind, "fold_decision": eng.fold_decision,
            "batch": batch, "batch_decision": decided, "graph_mode": eng.graph_mode,
            "card": card}
    # The wall: one dispatch of `batches` timed outside the profiler, which
    # adds host time to every launch; the window then profiles the next one.
    eng.run(n_batches=1)
    sync()
    t0 = time.perf_counter()
    syncs = eng.host_syncs
    eng.run(n_batches=batches)
    sync()
    wall = time.perf_counter() - t0
    syncs = eng.host_syncs - syncs
    with device_profile(warm=lambda: eng.run(n_batches=1)) as win:
        graph_before = eng._graph
        t0 = time.perf_counter()
        eng.run(n_batches=batches)
        sync()
        wall_in_window = time.perf_counter() - t0
    captured = eng._graph is not graph_before
    busy_us = win.device_us
    # The stages below run eagerly: release the captured batch and its
    # private pool first (tens of GB on the pyramid at full batch).
    eng._graph = graph_before = None
    if cuda:
        torch.cuda.empty_cache()

    def alone(fn):
        """(device us, device operations) of `batches` calls of fn(i)."""
        with device_profile() as w:
            for i in range(batches):
                fn(i)
            sync()
        return w.device_us, w.kernels

    def line(what, us, n):
        share = f"{us / busy_us:.3f}" if busy_us else "not measured"
        return (f"{what} alone: {us / 1e3 / batches:.4f} ms/batch device time in "
                f"{n / batches:.0f} device kernels per batch ({share} of device busy)")

    label_lines = []
    if any(not all(l.deterministic_shape) for l in eng.layers):
        # The pool samplers (plain torch ops, no kernel of the port).
        label_lines.append(line("pool sampler", *alone(lambda i: [
            eng._sample_layer_pool(1000 + i, li=li) for li in range(len(eng.layers))])))
    if eng._trace_plan is None:
        def trace(i):
            eng._trace_batch_impl(2000 + i)

        label_lines.append(line("general trace (samplers, trace, gates, projection, "
                                "continuation)", *alone(trace)))
        if len(eng.layers) > 1:
            got = []
            inner = eng._continuation
            eng._continuation = lambda *a: got.append(a) or inner(*a)
            trace(0)
            eng._continuation = inner
            label_lines.append(line(f"continuation ({len(got)} per batch)", *alone(
                lambda i: [inner(*a) for a in got])))
        label_lines.append(f"fold {eng.fold_kind} ({eng.fold_decision})")
        label_lines.append(
            f"trace path {eng.trace_path}: slot cap {eng._slot_cap}, keep {eng._compact_keep}, "
            f"lanes per layer {[l.cont_cap for l in eng.layers]}")
    busy = busy_us / 1e3 / batches if busy_us else None
    idle = 1.0 - busy_us / 1e6 / wall if busy_us else None
    dispatches = -(-batches // eng.steps_per_dispatch)
    summary = {**head, "batches": batches, "wall_ms": wall * 1e3 / batches,
               "wall_in_window_ms": wall_in_window * 1e3 / batches,
               "rays_per_s": batches * batch / wall, "busy_ms": busy,
               "kernels_per_batch": win.kernels / batches, "idle_share": idle,
               "top5": [[key, us / 1e3 / batches] for key, us in win.top(5)],
               "host_reads_per_dispatch": syncs / dispatches,
               "captured_in_window": captured, "overflow_replays": eng.overflow_replays}
    not_measured = "not measured"
    lines = [
        f"card: {card}",
        f"scene {scene}, batch {batch} ({decided}), {batches} batches, "
        f"wall {wall * 1e3 / batches:.4f} ms/batch, {batches * batch / wall:.6g} rays/s "
        f"(in the profiled window {wall_in_window * 1e3 / batches:.4f} ms/batch)",
        f"device busy {not_measured if busy is None else f'{busy:.4f}'} ms/batch, idle share "
        f"{not_measured if idle is None else f'{idle:.4f}'}",
        f"device kernels per batch: {win.kernels / batches:.0f}",
        f"host loop: {eng.graph_mode}, {batches} batches per dispatch, host reads "
        f"{syncs / batches:.3f} per batch ({syncs} in the timed dispatch), overflow replays "
        f"{eng.overflow_replays}, captured in the window: {captured}",
    ] + label_lines + [
        "device time by operation (ms/batch, share of busy, launches):",
    ]
    for us, n, key in win.rows:
        lines.append(f"  {us / 1e3 / batches:9.4f}  {us / busy_us:6.3f}  {n:5d}  {key[:90]}")
    del eng
    if cuda:
        torch.cuda.empty_cache()
    return lines, summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default="bench",
                    help=f"comma-separated, of {', '.join(SCENES)}; or all")
    ap.add_argument("--batches", type=int, default=10)
    ap.add_argument("--batch-size", type=int, default=BATCH)
    ap.add_argument("--graphs", choices=("on", "off"), default="on")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--out", default=None, help="also write the reports here")
    args = ap.parse_args(argv)
    names = list(SCENES) if args.scene == "all" else args.scene.split(",")
    unknown = [s for s in names if s not in SCENES]
    if unknown:
        ap.error(f"unknown scenes {unknown}; known: {', '.join(SCENES)}")

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("profile_slice: no CUDA device", file=sys.stderr)
        return 1
    card = "cpu" if args.device == "cpu" else subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    reports = []
    for scene in names:
        lines, summary = profile_window(scene, args.batches, args.batch_size,
                                        args.graphs == "on", args.device, card)
        lines.append(json.dumps(summary))
        print("\n".join(lines), flush=True)
        reports += lines + [""]
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write("\n".join(reports))
    return 0


if __name__ == "__main__":
    sys.exit(main())
