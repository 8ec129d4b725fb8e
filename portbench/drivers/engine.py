"""The engine driver: the batch loop, ``Engine.run``, on one CUDA device.

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
  4. the check (the module under ``reference/`` that the cell names): the
     reference works the rays of every batch out again from the
     configuration and the seed and folds them in float64. From zero over
     the set-up's batches (the start), and from the port's own images and
     stats before the drawn dispatch over that dispatch's batches, it must
     land on the port's images and its landed and dropped weights to the
     limits of the cell (``limits``) and on its traced segments exactly
     (``oracle.compare``).

``attempted`` counts the window's batches, ``failed`` the batches of the
checked spans that broke a limit.

The workload's keys: ``batch``, ``check_span`` (the dispatches among which
the checked one is drawn), ``profile_batches``, ``limits``. ``job.test``
(the CPU tests): ``kernels`` (the plain kernels), ``batch`` (a small one),
``check_span`` (an early checked dispatch), ``engine_hook`` (a planted
fault, called with the engine before its first batch).
"""

from __future__ import annotations

import copy
import gc
import importlib
import random
import time

from portbench.drivers import Ctx, Outcome, card, log


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
    every number worked out {name: value}) of the two spans of step 4."""
    import torch

    from portbench.reference import oracle

    after = win["after"]
    drawn = max(k for k in after)
    first, before, last = after[-1], after[drawn - 1], after[drawn]
    zeros = [torch.zeros_like(t) for t in first["images"]]
    nothing = {"images": zeros, "segments": 0, "landed": 0.0, "dropped": 0.0}
    spans = [(scene, range(0, first["counter"]), nothing, first),
             (scene, range(before["counter"], last["counter"]), before, last)]
    checks, bad, ref, numbers = oracle.compare(spans, wl["limits"], control)
    failed = sum(len(s[1]) for s, b in zip(spans, bad) if b)
    return checks, failed, ref, numbers


def run(job) -> Outcome:
    import torch

    wl = dict(job.wl)
    opts = job.test
    if opts.get("check_span") is not None:
        wl["check_span"] = opts["check_span"]
    doc, seed, cuda = job.doc, job.seed, job.device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)

    from ice_halo_sim_tpu_torch.config.loader import load_project
    from ice_halo_sim_tpu_torch.engine.simulator import Engine
    from ice_halo_sim_tpu_torch.kernels import build

    if cuda:
        torch.cuda.reset_peak_memory_stats()
    b = int(opts.get("batch") or wl["batch"])
    engine = Engine(load_project(copy.deepcopy(doc)), seed=seed, batch_size=b,
                    device=job.device, kernels=opts.get("kernels"))
    if engine.batch_size != b:
        raise RuntimeError(f"the engine took batch {engine.batch_size}, not the cell's {b}")
    if opts.get("engine_hook") is not None:
        opts["engine_hook"](engine)
    n_renders = len(doc["render"])
    engine.run(n_batches=1)
    engine.run(n_batches=engine.steps_per_dispatch)
    sync()
    setup_s = time.perf_counter() - job.t0
    log(f"portbench: cell {job.cell}, seed {seed}, batch {b}, {engine.steps_per_dispatch} "
        f"batches a dispatch, trace path {engine.trace_path}, fold {engine.fold_kind} "
        f"({engine.fold_decision}), graphs {engine.graph_mode}; kernel build "
        f"{build.build_seconds} s in set-up {setup_s:.3f} s")

    drawn = random.Random(seed).randrange(max(1, wl["check_span"]))
    card0 = card() if cuda else {}
    win = measure_window(engine, job.seconds, drawn, n_renders, sync)
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
    scene = reference.Scene(ref_load(copy.deepcopy(doc)), seed, b, job.device,
                            wl.get("knobs", {}))
    ctx = Ctx(attempted=win["batches"], window=win, setup_s=setup_s, profile=None,
              profile_batches=wl["profile_batches"], scene=scene, reference=None, stash={})
    if job.trace:
        ctx.profile = profile(engine, ctx.profile_batches)
        for mod in job.readers.values():
            if hasattr(mod, "measure"):
                mod.measure(engine, ctx)
        sync()
    engine = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t = time.perf_counter()
    kind = wl["control"]["kind"] if job.control else ""
    checks, failed, ctx.reference, numbers = check(scene, wl, win, kind)
    log(f"portbench: reference {time.perf_counter() - t:.3f} s over "
        f"{ctx.reference['batches']} batches; every number worked out {numbers}")
    dev = {"platform": "gpu" if cuda else job.device,
           "kind": torch.cuda.get_device_name() if cuda else job.device,
           "count": 1, "memory_peak_bytes": peak}
    if job.trace:
        p = ctx.profile
        log(f"portbench: profiled {ctx.profile_batches} batches: busy {p.busy_s()} s, device "
            f"span {p.device_span_s()} s, window {p.wall_s} s, {len(p.device)} device "
            f"operations; power limit {card1.get('power.limit')}")
    return Outcome(ctx, checks, failed, dev)
