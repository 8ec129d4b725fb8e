"""Run one cell of the port's benchmark once, on one CUDA device.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell is ``portbench/workloads/<cell>.json``
(its configuration, the resolution of every render, the batch, the IHT_*
knobs it sets, its check span and profile size); the configuration is
``portbench/configs/<config>.json`` (the scene document, frozen here); each
metric is ``portbench/metrics/<metric>.py``; which metrics a cell reports is
read from ``BENCHMARK.json``. A new cell, configuration or metric is a new
file and an entry there: nothing in this file names one.

The timed path, in a fresh process:
  1. set-up: ``Engine(cfg, seed, batch_size=<the cell's batch>,
     device="cuda")`` with the card's defaults (the sort fold, CUDA graphs,
     IHT_STEPS_PER_DISPATCH batches a dispatch), one calibrating
     ``run(n_batches=1)`` and one full dispatch, which captures the graph;
     ``setup_s`` ends there;
  2. the window: ``Engine.run(n_batches=steps_per_dispatch)`` again and
     again, each call timed, until ``--seconds`` have passed, ended by a
     host copy of every render's image. Around one dispatch drawn from the
     seed the window copies the images and the engine's stats to the host
     (twice, or once when the drawn dispatch is its first): what the check
     below compares, with the same copy taken just before the window;
  3. after the window: the peak device memory; with ``--trace 1`` a
     profiled dispatch of graph replays (``profiler.py``) and what the
     per-layer metrics measure while the engine lives; then the engine is
     freed;
  4. the check (the module under ``reference/`` that the cell names, by
     default ``scene``): the reference works the rays of every batch out
     again from the configuration and the seed and folds them in float64.
     From zero over the set-up's batches (the start), and from the port's
     own images and stats before the drawn dispatch over that dispatch's
     batches, it must land on the port's images and its landed and
     dropped weights to the limits of the cell (``limits``) and on its
     traced segments exactly.

The last line of standard output is one JSON object: ``correct``,
``attempted`` (the window's batches), ``failed`` (the batches of checks
that failed), ``metrics``, ``device`` and with ``--trace 1`` ``breakdown``,
then ``checks``: each number compared, with its limit. The numbers compared
are also the last lines of standard error. Without a CUDA device, or with
fewer than the cell's chips, the run prints no result and exits with 2; if
jax, jaxlib, flax or the JAX package are loaded when the window has closed,
with 3.

``--control`` (never in the benchmark's own runs) puts the cell's control
in the program's place: the program with the cell's ``control`` knobs, or
the reference folding bfloat16 rows; it has to come out not correct.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import copy  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "ice_halo_sim_tpu")
NAME = 160   # characters kept of an operation's name in the breakdown


def load(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def spec() -> dict:
    return load(ROOT, "BENCHMARK.json")


def workload(name: str) -> dict:
    return load(HERE, "workloads", f"{name}.json")


def config(name: str) -> dict:
    return load(HERE, "configs", f"{name}.json")


def cell_metrics(bench: dict, cell: str, trace: bool) -> list:
    """(name, unit) of the metrics this cell reports in a run: the
    end-to-end ones without trace, the per-layer ones with it."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [(m["name"], m["unit"]) for m in group if cell in m.get("workloads", [cell])]


def scene_document(wl: dict, cfg: dict) -> dict:
    """The configuration's scene at the cell's resolution of every render."""
    doc = copy.deepcopy(cfg["document"])
    if len(wl["resolution"]) != len(doc["render"]):
        raise ValueError(f"{wl['name']}: {len(wl['resolution'])} resolutions for "
                         f"{len(doc['render'])} renders")
    for render, res in zip(doc["render"], wl["resolution"]):
        render["resolution"] = list(res)
    return doc


def forbidden_modules() -> list:
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def card() -> dict:
    """The card as nvidia-smi reads it: name, power limit, SM clock, power
    draw, temperature (empty where it cannot be read)."""
    keys = ("name", "power.limit", "clocks.sm", "power.draw", "temperature.gpu")
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={','.join(keys)}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip().splitlines()[0]
        return dict(zip(keys, (v.strip() for v in out.split(","))))
    except (OSError, IndexError, subprocess.SubprocessError):
        return {}


class Ctx(SimpleNamespace):
    """What a metric reads: ``window`` (wall_s, rays, batches,
    dispatch_s, overflow_replays, host_syncs), ``setup_s``, ``profile`` (a
    ``profiler.Window`` or None), ``profile_batches``, ``scene`` (the
    reference's), ``reference`` (its traced batches and live contribution
    rows per render), ``stash`` (what a metric's ``measure`` left)."""


def capture(engine, n_renders: int) -> dict:
    """The host's copy of every render's image and of the engine's stats."""
    import torch

    images = [torch.from_numpy(engine.raw_xyz(r).reshape(-1, 3).copy())
              for r in range(n_renders)]
    st = engine.drain_stats()
    return {"images": images, "counter": int(engine.batch_counter),
            "segments": int(st.ray_segments), "landed": float(st.landed_weight),
            "dropped": float(st.dropped_cont_weight)}


def measure_window(engine, seconds: float, drawn: int, n_renders: int, sync) -> dict:
    """The timed window (module docstring, step 2). `drawn`: the index of
    the window's dispatch that the check replays. ``after[k]``: the copy
    after the window's dispatch k, -1 the one just before the window."""
    spd = engine.steps_per_dispatch
    batch = engine.batch_size
    after, dispatch_s = {-1: capture(engine, n_renders)}, []
    b0, r0, s0 = engine.batch_counter, engine.overflow_replays, engine.host_syncs
    t0 = time.perf_counter()
    k = 0
    while True:
        t = time.perf_counter()
        engine.run(n_batches=spd)
        dispatch_s.append(time.perf_counter() - t)
        if k in (drawn - 1, drawn):
            after[k] = capture(engine, n_renders)
        k += 1
        if k > drawn and time.perf_counter() - t0 >= seconds:
            break
    for r in range(n_renders):
        engine.raw_xyz(r)
    sync()
    wall = time.perf_counter() - t0
    batches = engine.batch_counter - b0
    return {"wall_s": wall, "batches": batches, "rays": batches * batch,
            "dispatch_s": dispatch_s, "dispatches": k,
            "overflow_replays": engine.overflow_replays - r0,
            "host_syncs": engine.host_syncs - s0, "after": after}


def profile(engine, n: int):
    """A profiled dispatch of n graph replays (``profiler.window``), the
    port's graphs captured anew just before it."""
    from torch.profiler import record_function

    from portbench import profiler

    def dispatch():
        with record_function("portbench.dispatch"):
            engine.run(n_batches=n)

    return profiler.window(dispatch, warm=lambda: engine.run(n_batches=n))


def check(scene, wl: dict, win: dict, control: str) -> tuple:
    """(checks {name: (value, limit)}, failed batches, reference record,
    every number worked out {name: value}). The numbers compared are those
    that the cell's ``limits`` name, and the traced segments, exactly.
    `control`: "" (the program's own images and stats), "reference_bf16"
    (the reference one precision lower in the program's place), "program"
    (the program under the control's knobs: its own)."""
    import torch

    from portbench.reference import oracle

    after = win["after"]
    drawn = max(k for k in after)
    first, before, last = after[-1], after[drawn - 1], after[drawn]
    zeros = [torch.zeros_like(t) for t in first["images"]]
    nothing = {"images": zeros, "segments": 0, "landed": 0.0, "dropped": 0.0}
    spans = [(range(0, first["counter"]), nothing, first),
             (range(before["counter"], last["counter"]), before, last)]
    worst = {"image_gap_l1": 0.0, "image_gap_ulp": 0.0, "landed_gap": 0.0,
             "dropped_gap": 0.0, "segments_off": 0}
    limits = dict(wl["limits"], segments_off=0)
    failed, gap_l1, added_l1 = 0, 0.0, 0.0
    ref = {"batches": 0, "live_rows": None}
    for batches, base, port in spans:
        l0, d0 = base["landed"], base["dropped"]
        rep = oracle.replay(scene, base["images"], batches, landed0=l0, dropped0=d0)
        if control == "reference_bf16":
            low = oracle.replay(scene, base["images"], batches, bf16=True, landed0=l0,
                                dropped0=d0)
            port = dict(port, images=low["images"], landed=low["landed"],
                        dropped=low["dropped"], segments=base["segments"] + low["segs"])
        g = oracle.image_gap(port["images"], rep["images"], base["images"])
        st = oracle.stats_gap(port["landed"], port["dropped"], rep, l0, d0)
        span = {"image_gap_l1": g["gap_l1"] / g["added_l1"] if g["added_l1"] > 0 else math.inf,
                "image_gap_ulp": g["ulp_max"], "landed_gap": st["landed"],
                "dropped_gap": st["dropped"],
                "segments_off": abs(port["segments"] - base["segments"] - rep["segs"])}
        failed += len(batches) if any(span[k] > limits[k] for k in limits) else 0
        worst = {k: max(worst[k], span[k]) for k in worst}
        gap_l1 += g["gap_l1"]
        added_l1 += g["added_l1"]
        ref["batches"] += rep["batches"]
        ref["live_rows"] = (rep["live_rows"] if ref["live_rows"] is None else
                            [a + b for a, b in zip(ref["live_rows"], rep["live_rows"])])
    worst["image_gap_l1"] = gap_l1 / added_l1 if added_l1 > 0 else math.inf
    return {k: (worst[k], limits[k]) for k in limits}, failed, ref, worst


def run_cell(cell: str, seed: int, seconds: float, trace: bool, control: bool = False,
             device: str = "cuda", kernels=None, batch=None, check_span=None,
             engine_hook=None) -> dict:
    """One run of one cell: the result line as a dict (module docstring).
    device, kernels, batch, check_span and engine_hook serve the CPU tests
    (the plain kernels, a small batch, an early checked dispatch, a planted
    fault)."""
    import torch

    bench = spec()
    wl = workload(cell)
    if check_span is not None:
        wl["check_span"] = check_span
    cfg = config(wl["config"])
    doc = scene_document(wl, cfg)
    knobs = dict(wl.get("knobs", {}))
    if control and wl["control"]["kind"] == "program":
        knobs.update(wl["control"]["knobs"])
    os.environ.update({k: str(v) for k, v in knobs.items()})
    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    log = lambda *a: print(*a, file=sys.stderr, flush=True)  # noqa: E731

    from ice_halo_sim_tpu_torch.config.loader import load_project
    from ice_halo_sim_tpu_torch.engine.simulator import Engine
    from ice_halo_sim_tpu_torch.kernels import build

    if cuda:
        torch.cuda.reset_peak_memory_stats()
    b = int(batch or wl["batch"])
    engine = Engine(load_project(copy.deepcopy(doc)), seed=seed, batch_size=b, device=device,
                    kernels=kernels)
    if engine.batch_size != b:
        raise RuntimeError(f"the engine took batch {engine.batch_size}, not the cell's {b}")
    if engine_hook is not None:
        engine_hook(engine)
    n_renders = len(doc["render"])
    engine.run(n_batches=1)
    engine.run(n_batches=engine.steps_per_dispatch)
    sync()
    setup_s = time.perf_counter() - T0
    log(f"portbench: cell {cell}, seed {seed}, batch {b}, {engine.steps_per_dispatch} batches "
        f"a dispatch, trace path {engine.trace_path}, fold {engine.fold_kind} "
        f"({engine.fold_decision}), graphs {engine.graph_mode}; kernel build "
        f"{build.build_seconds} s in set-up {setup_s:.3f} s")

    drawn = random.Random(seed).randrange(max(1, wl["check_span"]))
    card0 = card() if cuda else {}
    win = measure_window(engine, seconds, drawn, n_renders, sync)
    card1 = card() if cuda else {}
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    d_ms = sorted(1e3 * t for t in win["dispatch_s"])
    log(f"portbench: window {win['wall_s']:.4f} s, {win['dispatches']} dispatches, "
        f"{win['batches']} batches, host reads {win['host_syncs'] / win['dispatches']:.4f} "
        f"a dispatch, overflow replays {win['overflow_replays']}, checked dispatch {drawn}; "
        f"dispatch ms: median {d_ms[len(d_ms) // 2]}, 95th {d_ms[(95 * len(d_ms)) // 100]}")
    log(f"portbench: card before the window {card0}, after {card1}; peak memory {peak} B")

    from portbench.reference.plain.config.loader import load_project as ref_load

    reference = importlib.import_module(f"portbench.reference.{wl['reference']}")
    scene = reference.Scene(ref_load(copy.deepcopy(doc)), seed, b, device, wl.get("knobs", {}))
    ctx = Ctx(window=win, setup_s=setup_s, profile=None,
              profile_batches=wl["profile_batches"], scene=scene, reference=None, stash={})
    names = cell_metrics(bench, cell, trace)
    readers = {n: importlib.import_module(f"portbench.metrics.{n}") for n, _ in names}
    if trace:
        ctx.profile = profile(engine, ctx.profile_batches)
        for mod in readers.values():
            if hasattr(mod, "measure"):
                mod.measure(engine, ctx)
        sync()
    engine = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t = time.perf_counter()
    kind = wl["control"]["kind"] if control else ""
    checks, failed, ctx.reference, numbers = check(scene, wl, win, kind)
    log(f"portbench: reference {time.perf_counter() - t:.3f} s over "
        f"{ctx.reference['batches']} batches; every number worked out {numbers}")
    dev = {"platform": "gpu" if cuda else device,
           "kind": torch.cuda.get_device_name() if cuda else device,
           "count": 1, "memory_peak_bytes": peak}
    if trace:
        p = ctx.profile
        log(f"portbench: profiled {ctx.profile_batches} batches: busy {p.busy_s()} s, device "
            f"span {p.device_span_s()} s, window {p.wall_s} s, {len(p.device)} device "
            f"operations; power limit {card1.get('power.limit')}")
    out = result(ctx, names, readers, checks, failed, dev)
    for k, (v, lim) in checks.items():
        log(f"check {k} {v!r} limit {lim!r}")
    return out


def result(ctx, names, readers, checks, failed, dev) -> dict:
    """The result line: ``correct``, ``attempted``, ``failed``, ``metrics``
    (each metric its reader gave a value), ``device`` (with the profiled
    window's busy and wall seconds in a traced run), ``breakdown`` in a
    traced run, and ``checks`` last: {name: (value, limit)} as given."""
    metrics = {}
    for name, unit in names:
        value = readers[name].read(ctx)
        if value is not None:
            metrics[name] = {"value": value, "unit": unit}
    correct = failed == 0 and all(v <= lim for v, lim in checks.values())
    out = {"correct": correct, "attempted": ctx.window["batches"], "failed": failed,
           "metrics": metrics, "device": dict(dev)}
    p = ctx.profile
    if p is not None:
        out["device"]["busy_s"] = p.busy_s()
        out["device"]["window_s"] = p.wall_s
        out["breakdown"] = {"device_ops": [[n[:NAME], v] for n, v in p.top_ops(10)],
                            "idle_gaps": [[n[:NAME], v] for n, v in p.idle_gaps(10)]}
    out["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Run one cell of the port's benchmark once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    chips = workload(args.workload)["chips"]

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 2
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), args.control)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: modules of jax or the JAX package were loaded: {bad}",
              file=sys.stderr)
        return 3
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
