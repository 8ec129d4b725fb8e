"""The server driver: the GUI's path, the port's ``Server``
(``engine/server.py``) behind ``GuiApp`` (``gui/app.py``), driven as the
GUI's page drives it.

What the page (``gui/app.py``'s ``_PAGE``) does, and what stands for it:
  - its poll: GET /status, whose handler calls ``GuiApp.frame()`` (an
    ``acquire_frame`` when the cached frame was dropped by a commit, or is
    older than 0.25 s and not final); while that frame is not idle, GET
    /frame/0.png (``GuiApp.render_png(0, 0.0)``, the cached frame's PNG);
    the next poll ``poll_period_s`` after the reply (the page's
    ``setTimeout(poll, 1000)``). Here: one page thread that does the same
    calls;
  - a load ("load project"): POST /commit, whose handler calls
    ``Server.commit`` and ``GuiApp.drop_frame()``, then the page's
    ``refresh()``, GET /frame/0.png. Here: ``commit`` and ``drop_frame`` in
    the driver's thread, the refresh in a thread of its own, as the
    browser's fetch runs beside the page's poll;
  - the user: loads the next scene at the first poll after the last load's
    reply that reads idle (the page's status line: "idle"). No think time
    and no rate is assumed: the page's own poll sets the pace.

The timed path, in a fresh process:
  1. set-up: ``Server(seed, batch_size=<the cell's batch>, device="cuda")``,
     a commit of the cell's document as published, ``wait_idle()`` and one
     ``acquire_frame()``; ``setup_s`` ends there;
  2. the window, from its start t0, the page's first poll: load i is the
     document at the next of ``altitudes`` (the sun's; each a layout
     change, so a new generation and a new Engine), sent as JSON text, as
     /commit receives it; loads go on while the poll that calls for the
     next one reads idle inside ``--seconds``. After a load's reply the
     driver calls ``wait_idle()`` and ``acquire_frame()``: that frame is
     the generation's final frame, which holds the whole ray budget. A load
     is timed from its start to the return of that frame. The window closes
     when the last load's final frame is in hand, and not before
     ``--seconds`` have passed;
  3. after the window: the peak device memory; with ``--trace 1`` a
     profiled stretch of ``profile_commits`` more loads of the same traffic
     (``profiler.py``: the graphs of each load's Engine are captured inside
     it) and what the per-layer readers measure; then the Server is shut
     down;
  4. the check (the module under ``reference/`` that the cell names): the
     final frames of two loads, the last one and one drawn from the seed
     among those at the other altitude, each against the reference's
     replay from zero of that generation's batches (the document at its
     altitude, the same seed and batch, ``ray_num`` over the batch rounded
     up: the pump runs whole batches), by the cell's ``limits`` and the
     traced segments exactly (``oracle.compare``); and the Server's
     guarantees on every frame of the window (``stale_frames``, limit 0):
     a page fetch begun after a load's reply carries that load's
     generation or a later one, and a final frame carries its load's
     generation, is idle and holds the budget's rays.

``attempted`` counts the window's loads; ``failed`` the checked loads
whose final frame broke a limit, and the loads whose frames broke a
guarantee. A final frame that does not come within ``WAIT_S`` of its load
fails the run.

The window's record (``ctx.window``): ``t0``, ``wall_s``, ``commits``
[{start, returned (the /commit reply: after ``drop_frame``), idle (by
wait_idle), done (by the final frame's acquire_frame), generation,
frame_generation, rays, frame_idle, reused, allocated}] (host clock:
``time.perf_counter``; ``allocated``: the device memory allocated once the
final frame was in hand), ``fetches`` [(kind, start, end, generation,
idle, acquired)]: kind ``status`` (a poll) or ``refresh`` (after a load),
acquired when the fetch called ``acquire_frame`` rather than reading
GuiApp's cache. The run's log breaks a load's time down by these stamps
and by the port's set-up spans, and lists every load's.

Its cell, ``workloads/light_single.r2048.viewer.json``, is not in
``BENCHMARK.json``: its end-to-end metric has no bound that holds
(``PERF.md``), so a run of it reports ``setup_s`` and logs the rest.

The workload's keys: ``batch``, ``altitudes``, ``poll_period_s``,
``profile_commits``, ``limits``. ``job.test`` (the CPU tests): ``kernels``
(the plain kernels), ``server_hook`` (a planted fault, called with the
Server before the set-up's commit).
"""

from __future__ import annotations

import copy
import gc
import importlib
import json
import math
import random
import statistics
import threading
import time

from portbench.drivers import Ctx, Outcome, card, log

WAIT_S = 60.0   # the longest wait for a final frame, or for the page to read it


class Page(threading.Thread):
    """The GUI page over ``gui``: its poll loop in this thread, and a
    refresh after each load (``refresh``). Every fetch is timed and its
    frame's generation kept; ``idle_read`` is the start of the latest poll
    that read idle."""

    def __init__(self, gui, period: float):
        super().__init__(name="portbench-page", daemon=True)
        self.gui, self.period = gui, period
        self.fetches = []
        self.error = None
        self.idle_read = -math.inf
        self.shown = threading.Condition()
        self.done = threading.Event()

    def fetch(self, kind: str):
        from torch.profiler import record_function

        wall, start = time.time(), time.perf_counter()
        with record_function(f"portbench.{kind}"):
            frame = self.gui.frame()
            if kind == "refresh" or not frame.is_idle:
                self.gui.render_png(0, 0.0)
        # A frame stamped after the fetch began was acquired by it, and not
        # served from GuiApp's cache.
        self.fetches.append((kind, start, time.perf_counter(), frame.generation,
                             frame.is_idle, frame.timestamp >= wall))
        if kind == "status" and frame.is_idle:
            with self.shown:
                self.idle_read = start
                self.shown.notify_all()

    def _failed(self, e: Exception) -> None:
        with self.shown:
            self.error = self.error or e
            self.shown.notify_all()

    def run(self):
        try:
            while not self.done.is_set():
                self.fetch("status")
                self.done.wait(self.period)
        except Exception as e:  # raised again by the driver
            self._failed(e)

    def refresh(self) -> threading.Thread:
        def body():
            try:
                self.fetch("refresh")
            except Exception as e:  # raised again by the driver
                self._failed(e)

        t = threading.Thread(target=body, name="portbench-refresh", daemon=True)
        t.start()
        return t

    def idle_after(self, t: float) -> float:
        """Wait for a poll begun at `t` or later that reads idle; the time
        the driver saw it."""
        with self.shown:
            deadline = time.perf_counter() + WAIT_S
            while self.idle_read < t:
                self.raise_error()
                left = deadline - time.perf_counter()
                if left <= 0:
                    raise RuntimeError(f"no poll read idle {WAIT_S} s after the last load")
                self.shown.wait(left)
        return time.perf_counter()

    def raise_error(self) -> None:
        if self.error is not None:
            raise RuntimeError("a fetch of the page failed") from self.error

    def stop(self) -> None:
        self.done.set()
        self.join()
        self.raise_error()


def traffic(server, gui, texts: list, first: int, wl: dict, seconds=None, n=None,
            keep=None, memory=None) -> dict:
    """Loads of the window's traffic from load index `first` (step 2) with
    the page polling beside them, for `seconds` or for `n` loads: the
    window's record. `keep(i, frame)` is called with each load's final
    frame. `memory`: a function giving the device memory allocated."""
    from torch.profiler import record_function

    page = Page(gui, float(wl["poll_period_s"]))
    commits = []
    t0 = time.perf_counter()
    page.start()
    try:
        after = t0
        while n is None or len(commits) < n:
            woke = page.idle_after(after)
            if seconds is not None and woke - t0 >= seconds:
                break
            i = len(commits)
            start = time.perf_counter()
            with record_function("portbench.commit"):
                reused = server.commit(texts[(first + i) % len(texts)])
                gui.drop_frame()
            returned = after = time.perf_counter()
            generation = server.generation()
            refresh = page.refresh()
            with record_function("portbench.wait_idle"):
                if not server.wait_idle(timeout=WAIT_S):
                    raise RuntimeError(f"load {i}: no final frame {WAIT_S} s after it")
            idle = time.perf_counter()
            with record_function("portbench.final_frame"):
                frame = server.acquire_frame()
            done = time.perf_counter()
            refresh.join()
            commits.append({"start": start, "returned": returned, "idle": idle, "done": done,
                            "generation": generation, "frame_generation": frame.generation,
                            "rays": frame.ray_count, "frame_idle": frame.is_idle,
                            "reused": reused, "allocated": memory() if memory else 0})
            if keep is not None:
                keep(i, frame)
        if seconds is not None:
            time.sleep(max(0.0, t0 + seconds - time.perf_counter()))
    finally:
        page.stop()
    return {"t0": t0, "wall_s": time.perf_counter() - t0, "commits": commits,
            "fetches": page.fetches}


class Kept:
    """The final frames the check compares: the last load's, and at each
    altitude one drawn from the seed, uniformly over that altitude's loads
    (a reservoir of one, so no more than three frames are held)."""

    def __init__(self, seed: int, altitudes: int):
        self.rng = random.Random(seed)
        self.n = altitudes
        self.seen = [0] * altitudes
        self.drawn = [None] * altitudes
        self.last = None

    def __call__(self, i: int, frame) -> None:
        a = i % self.n
        self.seen[a] += 1
        if self.rng.randrange(self.seen[a]) == 0:
            self.drawn[a] = (i, frame)
        self.last = (i, frame)

    def checked(self) -> dict:
        """{load index: final frame}: the last, and the drawn one at the
        altitude after the last's."""
        last, frame = self.last
        out = {last: frame}
        other = self.drawn[(last + 1) % self.n]
        if other is not None:
            out[other[0]] = other[1]
        return out


def stale_frames(win: dict, rays: int) -> int:
    """The window's frames that break the Server's guarantees (step 4). A
    fetch is held to the generation of the last load whose reply was
    stamped before the fetch began."""
    returned = [(c["returned"], c["generation"]) for c in win["commits"]]
    n = 0
    for _kind, start, _end, gen, _idle, _acquired in win["fetches"]:
        floor = max((g for t, g in returned if t <= start), default=0)
        n += gen < floor
    return n + sum(1 for c in win["commits"]
                   if c["frame_generation"] != c["generation"] or not c["frame_idle"]
                   or c["rays"] != rays or c["reused"])


def port_record(frame) -> dict:
    """A final frame as ``oracle.compare`` reads the program's record."""
    import numpy as np
    import torch

    return {"images": [torch.from_numpy(np.array(x, np.float32).reshape(-1, 3))
                       for x in frame.raw_xyz],
            "segments": int(frame.stats.ray_segments),
            "landed": float(frame.stats.landed_weight),
            "dropped": float(frame.stats.dropped_cont_weight)}


def run(job) -> Outcome:
    import torch

    wl, seed, cuda = job.wl, job.seed, job.device == "cuda"
    opts = job.test

    from ice_halo_sim_tpu_torch.engine.server import Server
    from ice_halo_sim_tpu_torch.gui.app import GuiApp
    from ice_halo_sim_tpu_torch.kernels import build

    docs = []
    for alt in wl["altitudes"]:
        d = copy.deepcopy(job.doc)
        d["scene"]["light_source"]["altitude"] = float(alt)
        docs.append(d)
    texts = [json.dumps(d) for d in docs]
    kept = Kept(seed, len(texts))

    if cuda:
        torch.cuda.reset_peak_memory_stats()
    b = int(wl["batch"])
    server = Server(seed=seed, batch_size=b, device=job.device, kernels=opts.get("kernels"))
    try:
        if opts.get("server_hook") is not None:
            opts["server_hook"](server)
        server.commit(json.dumps(job.doc))
        server.wait_idle()
        server.acquire_frame()
        if cuda:
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - job.t0
        log(f"portbench: cell {job.cell}, seed {seed}, batch {b}, loads at altitudes "
            f"{wl['altitudes']}, a poll every {wl['poll_period_s']} s after its reply; "
            f"kernel build {build.build_seconds} s in set-up {setup_s:.3f} s")

        card0 = card() if cuda else {}
        memory = torch.cuda.memory_allocated if cuda else None
        win = traffic(server, GuiApp(server), texts, 0, wl, seconds=job.seconds, keep=kept,
                      memory=memory)
        card1 = card() if cuda else {}
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        n = len(win["commits"])
        if n < len(texts):
            raise RuntimeError(f"{n} loads in the window: the check needs one at each of "
                               f"{len(texts)} altitudes")
        _log_window(win, peak, card0, card1)

        ctx = Ctx(attempted=n, window=win, setup_s=setup_s, profile=None, profile_batches=None,
                  scene=None, reference=None, stash={})
        if job.trace:
            from portbench import profiler

            k = int(wl["profile_commits"])
            gui = GuiApp(server)
            ctx.profile = profiler.window(lambda: traffic(server, gui, texts, n, wl, n=k))
            for mod in job.readers.values():
                if hasattr(mod, "measure"):
                    mod.measure(server, ctx)
    finally:
        server.shutdown()
    server = None
    frames = kept.checked()
    kept = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t = time.perf_counter()
    from portbench.reference import oracle
    from portbench.reference.plain.config.loader import load_project as ref_load

    reference = importlib.import_module(f"portbench.reference.{wl['reference']}")
    spans, rays = [], None
    for i in sorted(frames):
        scene = reference.Scene(ref_load(copy.deepcopy(docs[i % len(docs)])), seed, b,
                                job.device, wl.get("knobs", {}))
        n_batches = -(-int(docs[0]["scene"]["ray_num"]) // scene.batch_size)
        rays = n_batches * scene.batch_size
        port = port_record(frames[i])
        nothing = {"images": [torch.zeros_like(x) for x in port["images"]], "segments": 0,
                   "landed": 0.0, "dropped": 0.0}
        spans.append((scene, range(n_batches), nothing, port))
    kind = wl["control"]["kind"] if job.control else ""
    checks, bad, ctx.reference, numbers = oracle.compare(spans, wl["limits"], kind)
    ctx.scene = spans[-1][0]
    stale = stale_frames(win, rays)
    checks["stale_frames"] = (stale, 0)
    log(f"portbench: reference {time.perf_counter() - t:.3f} s over "
        f"{ctx.reference['batches']} batches of loads {sorted(frames)}; every number worked "
        f"out {numbers}; stale frames {stale}")
    dev = {"platform": "gpu" if cuda else job.device,
           "kind": torch.cuda.get_device_name() if cuda else job.device,
           "count": 1, "memory_peak_bytes": peak}
    if job.trace:
        p = ctx.profile
        log(f"portbench: profiled {wl['profile_commits']} loads: busy {p.busy_s()} s, "
            f"device span {p.device_span_s()} s, window {p.wall_s} s, {len(p.device)} device "
            f"operations; power limit {card1.get('power.limit')}")
    return Outcome(ctx, checks, stale + sum(bad), dev)


def _median_spans(win: dict) -> dict:
    """{name: median seconds} of the port's set-up spans (recorded whether
    its tracer is on or off) that began inside the window."""
    from ice_halo_sim_tpu_torch.utils import profiling

    lo, hi = win["t0"], win["t0"] + win["wall_s"]
    by = {}
    for s in profiling.snapshot()["spans"]:
        if lo <= s.start * 1e-9 < hi:
            by.setdefault(s.name, []).append((s.end - s.start) * 1e-9)
    return {k: statistics.median(v) for k, v in sorted(by.items())}


def _log_window(win: dict, peak: int, card0: dict, card1: dict) -> None:
    cs = win["commits"]
    final = sorted(c["done"] - c["start"] for c in cs)
    commit = sorted(c["returned"] - c["start"] for c in cs)
    gaps = [b["start"] - a["done"] for a, b in zip(cs, cs[1:])] or [math.nan]
    alloc = [c["allocated"] for c in cs]
    by = {}
    for kind, start, end, _gen, idle, acquired in win["fetches"]:
        name = f"{kind}{'' if idle else ', not idle'}{'' if acquired else ', cached'}"
        by.setdefault(name, []).append(end - start)
    fetches = {k: (len(v), statistics.median(v), max(v)) for k, v in sorted(by.items())}
    log(f"portbench: a load's time, medians in s: commit {statistics.median(commit)}, to idle "
        f"{statistics.median(c['idle'] - c['returned'] for c in cs)}, final frame "
        f"{statistics.median(c['done'] - c['idle'] for c in cs)}; the port's set-up spans "
        f"{_median_spans(win)}")
    log(f"portbench: window {win['wall_s']:.4f} s, {len(cs)} loads: final frame s median "
        f"{statistics.median(final)}, mean {statistics.fmean(final)}, 75th "
        f"{final[math.ceil(0.75 * len(final)) - 1]}, max "
        f"{final[-1]}; commit s median {statistics.median(commit)}, max {commit[-1]}; from a "
        f"final frame to the next load s median {statistics.median(gaps)}, max {max(gaps)}; "
        f"page fetches (count, median s, max s) {fetches}")
    refreshes = [f for f in win["fetches"] if f[0] == "refresh"]
    log("portbench: every load (final frame s, commit s, to idle s, refresh began after the "
        "reply s, refresh read idle): " + " ".join(
            f"{c['done'] - c['start']:.4f},{c['returned'] - c['start']:.4f},"
            f"{c['idle'] - c['returned']:.4f},"
            + ",".join(f"{f[1] - c['returned']:.4f},{int(f[4])}" for f in refreshes
                       if f[3] == c["generation"])
            for c in cs))
    log(f"portbench: card before the window {card0}, after {card1}; peak memory {peak} B; "
        f"allocated at each final frame: first {alloc[0]}, last {alloc[-1]}, "
        f"max {max(alloc)} B")
