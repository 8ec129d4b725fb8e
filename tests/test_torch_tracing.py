"""The port's tracer (``utils/profiling.py``): spans of the engine's host
loop, its set-up spans, the ring that keeps them, the graph key that follows
the tracer, the profiler's ranges of the same names, and on the card the
stage timers inside a captured batch.

    python -m pytest tests/test_torch_tracing.py -q -p no:cacheprovider

On the CPU the engine runs the plain kernels eagerly (batch 4096, four
batches a dispatch): its batches are ``iht.step`` spans, and no stage is
timed. The test marked ``cuda`` runs on the card only.
"""

import copy
import time

import pytest
import torch

from ice_halo_sim_tpu_torch import scenes
from ice_halo_sim_tpu_torch.config.loader import load_project
from ice_halo_sim_tpu_torch.engine.simulator import Engine
from ice_halo_sim_tpu_torch.parallel.sharding import ShardedEngine
from ice_halo_sim_tpu_torch.utils import profiling

# Tier-1 runs six workers; keep each one to two torch threads.
torch.set_num_threads(2)

B = 4096
K = 4
PER_DISPATCH = {"iht.dispatch", "iht.prologue", "iht.launch", "iht.step", "iht.read",
                "iht.overflow"}


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("IHT_STEPS_PER_DISPATCH", str(K))
    monkeypatch.delenv("IHT_PALLAS_TRACE", raising=False)
    assert not profiling.is_tracing()
    yield
    assert not profiling.is_tracing()


def _engine(device="cpu", batch=B):
    return Engine(load_project(copy.deepcopy(scenes.BENCH_CFG)), seed=7, batch_size=batch,
                  device=device)


def _two_layers(device="cpu", batch=B):
    """BENCH_CFG's prism in two layers, the first continuing every exit: the
    general path."""
    doc = copy.deepcopy(scenes.BENCH_CFG)
    layer = doc["scene"]["scattering"][0]
    doc["scene"]["scattering"] = [dict(layer, prob=1.0), dict(layer)]
    return Engine(load_project(doc), seed=7, batch_size=batch, device=device)


def _since(t0, names=None):
    return [s for s in profiling.snapshot()["spans"]
            if s.start >= t0 and (names is None or s.name in names)]


def test_tracing_off_records_set_up_spans_only():
    """Off, eight batches record no dispatch, launch or step span; the
    engine's set-up and its calibration are there once each."""
    t0 = time.perf_counter_ns()
    eng = _engine()
    eng.run(n_batches=2 * K)
    spans = _since(t0)
    assert not [s for s in spans if s.name in PER_DISPATCH]
    assert [s.name for s in spans] == ["iht.setup.engine", "iht.calibrate"]
    assert all(s.end > s.start and s.parent == -1 and s.dispatch == -1 for s in spans)


def _check_dispatches(spans, n_dispatches, k, shards=1):
    """Every dispatch one iht.dispatch whose children, by parent link and
    dispatch id, are per shard a prologue, k steps and a read."""
    roots = [s for s in spans if s.name == "iht.dispatch"]
    assert len(roots) == n_dispatches
    for root in roots:
        kids = [s for s in spans if s.parent == root.id]
        assert all(s.dispatch == root.dispatch for s in kids)
        assert all(root.start <= s.start <= s.end <= root.end for s in kids)
        names = [s.name for s in kids]
        assert names.count("iht.prologue") == shards and names.count("iht.read") == shards
        assert names.count("iht.step") == k * shards and len(names) == (k + 2) * shards
    ids = [r.dispatch for r in roots]
    assert ids == sorted(ids) and len(set(ids)) == len(ids)
    assert not [s for s in spans if s.name in PER_DISPATCH and s.dispatch not in ids]


def test_tracing_on_records_every_dispatch_and_its_parts():
    eng = _engine()
    eng.run(n_batches=K)                     # calibrates
    t0 = time.perf_counter_ns()
    with profiling.tracing():
        eng.run(n_batches=3 * K)
    spans = _since(t0)
    _check_dispatches(spans, 3, K)
    assert [s.dispatch for s in spans if s.name == "iht.dispatch"] == [K, 2 * K, 3 * K]
    # The dispatch's parts in order: the prologue, the steps, the read.
    root = next(s for s in spans if s.name == "iht.dispatch")
    kids = sorted((s for s in spans if s.parent == root.id), key=lambda s: s.start)
    assert [s.name for s in kids] == ["iht.prologue"] + ["iht.step"] * K + ["iht.read"]
    # No stage is timed on the CPU.
    assert not [d for d, _ in profiling.snapshot()["stages"] if d in (K, 2 * K, 3 * K)]


def test_sharded_dispatch_holds_every_shards_parts():
    se = ShardedEngine(load_project(copy.deepcopy(scenes.BENCH_CFG)), ["cpu"] * 2, seed=7,
                       per_device_batch=B)
    t0 = time.perf_counter_ns()
    with profiling.tracing():
        se.run(n_batches=2 * K)
    _check_dispatches(_since(t0), 2, K, shards=2)


def test_every_overflow_replay_is_one_overflow_span():
    """keep forced below every batch's live rows: each batch of a dispatch
    overflows, and each replay is one iht.overflow span of its dispatch."""
    eng = _engine()
    eng.run(n_batches=K)
    assert eng._compact_keep is not None
    eng._compact_keep = (1024,)
    replays = eng.overflow_replays
    t0 = time.perf_counter_ns()
    with profiling.tracing():
        eng.run(n_batches=2 * K)
    spans = _since(t0)
    over = [s for s in spans if s.name == "iht.overflow"]
    assert eng.overflow_replays - replays == len(over) > 0
    roots = {s.id: s for s in spans if s.name == "iht.dispatch"}
    assert len(roots) == 2 and all(s.parent in roots for s in over)
    assert all(s.dispatch == roots[s.parent].dispatch for s in over)


def test_the_graph_key_follows_the_tracer():
    eng = _engine()
    eng.run(n_batches=K)
    key = eng._graph_key()
    with profiling.tracing():
        traced = eng._graph_key()
    assert traced != key and eng._graph_key() == key
    profiling.tracing(True)
    try:
        assert eng._graph_key() == traced
    finally:
        profiling.tracing(False)
    assert eng._graph_key() == key


def test_a_running_profiler_sees_the_spans_with_the_tracer_off(monkeypatch):
    """Off, with torch.profiler running: iht.dispatch is a host range that
    encloses the dispatch's aten operations, and the ring records none of
    it. The benchmark's window (portbench/profiler.py) over such a run keeps
    the ranges on the host and none among the device operations, here with
    every host event also given as the device-side record the card's trace
    holds (the user annotation of a range, an operation's kernel)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from portbench import profiler as bench_profiler

    eng = _engine()
    eng.run(n_batches=K)
    t0 = time.perf_counter_ns()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.run(n_batches=K)
    assert not _since(t0, PER_DISPATCH)
    events = list(prof.events())
    disp = [e for e in events if e.name == "iht.dispatch"]
    assert len(disp) == 1
    lo, hi = disp[0].time_range.start, disp[0].time_range.end
    inside = [e for e in events if e.name.startswith("aten::")
              and lo <= e.time_range.start and e.time_range.end <= hi]
    assert len(inside) > 100
    names = {e.name for e in events}
    assert {"iht.prologue", "iht.step", "iht.read"} <= names

    class Recorded:
        def __init__(self, *a, **k):
            self.inner = profile(activities=[ProfilerActivity.CPU])

        def __enter__(self):
            self.inner.__enter__()
            return self

        def __exit__(self, *exc):
            return self.inner.__exit__(*exc)

        def events(self):
            out = []
            for e in self.inner.events():
                out.append(e)
                dev = copy.copy(e)
                dev.device_type = DeviceType.CUDA
                dev.is_user_annotation = not e.name.startswith("aten::")
                out.append(dev)
            return out

    monkeypatch.setattr(torch.profiler, "profile", Recorded)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    win = bench_profiler.window(lambda: eng.run(n_batches=K))
    assert win.device and all(s.name.startswith("aten::") for s in win.device)
    assert not [s for s in win.device if s.name.startswith("iht.")]
    assert [s for s in win.host if s.name == "iht.dispatch"]


def test_the_ring_keeps_the_newest_spans():
    """More spans than the ring holds: it keeps the newest; a set-up span
    lives in a ring of its own."""
    t0 = time.perf_counter_ns()
    with profiling.tracing(True, capacity=16):
        with profiling.setup_span("t.setup"):
            for i in range(100):
                with profiling.span(f"t{i}"):
                    pass
        snap = profiling.snapshot()
    try:
        mine = [s.name for s in snap["spans"] if s.start >= t0]
        assert mine == ["t.setup"] + [f"t{i}" for i in range(84, 100)]
        assert snap["capacity"] == 16
    finally:
        profiling.tracing(False, capacity=profiling.SPANS)


def test_snapshot_reads_the_counters_in_place():
    eng = _engine()
    eng.run(n_batches=2 * K)
    snap = profiling.snapshot(eng)
    assert snap["engines"] == [{"host_syncs": eng.host_syncs,
                                "overflow_replays": eng.overflow_replays,
                                "batch_counter": 2 * K, "layer_epilogue": [None],
                                "cont_live": [], "cont_lanes": []}]
    assert set(snap["launches"]) >= {"trace_emit", "fused_scan_extract"}


def test_a_traced_general_batch_records_its_layers_and_lanes():
    """On the general path with the tracer on, every eager batch holds one
    ``iht.layer`` span a layer, and the device counter of continuation lanes
    grows by the next layer's lanes a batch beside the live rows; with the
    tracer off it stays at zero."""
    eng = _two_layers()
    eng.run(n_batches=K)
    eng.run(n_batches=K)
    assert eng.trace_path == "plain-torch (general)"
    assert eng._dev.lanes.tolist() == [0]
    live0 = eng._dev.cont.tolist()[0]
    t0 = time.perf_counter_ns()
    with profiling.tracing():
        eng.run(n_batches=K)
        snap = profiling.snapshot(eng)
    spans = [s for s in snap["spans"] if s.start >= t0]
    steps = {s.id for s in spans if s.name == "iht.step"}
    layers = [s for s in spans if s.name == "iht.layer"]
    assert len(steps) == K and len(layers) == 2 * K
    assert all(s.parent in steps for s in layers)
    e = snap["engines"][0]
    assert e["cont_lanes"] == [K * eng.layers[1].cont_cap]
    assert 0.5 < (e["cont_live"][0] - live0) / e["cont_lanes"][0] <= 1.0
    eng.run(n_batches=K)
    assert profiling.snapshot(eng)["engines"][0]["cont_lanes"] == e["cont_lanes"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the stage timers time a captured batch)")


@pytest.mark.cuda
def test_stage_timers_of_a_captured_batch(card, monkeypatch):
    """BENCH_CFG at batch 229376, captured with the tracer on: each of the
    five stages of its last batch is positive, and their sum is within 10% of
    the batch's device time from events around a replay."""
    monkeypatch.setenv("IHT_STEPS_PER_DISPATCH", "8")
    eng = _engine("cuda", 229376)
    eng.run(n_batches=8)
    with profiling.tracing():
        eng.run(n_batches=8)                 # captures anew, with the timers
        assert eng.graph_mode == "cuda graph" and eng._graph_marks is not None
        n = len(profiling.snapshot()["stages"])
        eng.run(n_batches=8)
        dispatch, stages = profiling.snapshot()["stages"][n]
        assert dispatch == 16
        assert set(stages) == {"trace", "scatter", "sort", "scan", "rest"}
        assert all(v > 0 for v in stages.values()), stages
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        times = []
        for _ in range(5):
            a.record()
            eng._graph.replay()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) * 1e-3)
    batch = sorted(times)[2]
    assert abs(sum(stages.values()) - batch) <= 0.1 * batch, (stages, times)


@pytest.mark.cuda
def test_a_traced_captured_batch_sorts_once_a_render(card, monkeypatch):
    """BENCH_CFG captured with the tracer on: the captured batch's launches
    hold one radix sort a render with the passes that sort_end_bit implies,
    and the tracer's snapshot counts them once a replayed batch."""
    from ice_halo_sim_tpu_torch.core import accum, radix_sort

    monkeypatch.setenv("IHT_STEPS_PER_DISPATCH", "8")
    eng = _engine("cuda", 65536)
    eng.run(n_batches=8)
    R = len(eng.proj_plans)
    P = eng.proj_plans[0].height * eng.proj_plans[0].width
    n_pass = radix_sort.passes(accum.sort_end_bit(P, eng.k_pool))
    with profiling.tracing():
        eng.run(n_batches=8)                 # captures anew, with the timers
        assert eng.graph_mode == "cuda graph" and eng._graph_marks is not None
        assert eng._graph.launches["radix_sort"] == R
        assert eng._graph.launches["radix_sort_pass"] == R * n_pass == R * 4
        before, replays = profiling.snapshot()["launches"], eng.overflow_replays
        eng.run(n_batches=8)
        after = profiling.snapshot()["launches"]
    batches = 8 + eng.overflow_replays - replays
    assert after["radix_sort"] - before["radix_sort"] == batches * R
    assert after["radix_sort_pass"] - before["radix_sort_pass"] == batches * R * n_pass


@pytest.mark.cuda
def test_stage_timers_of_a_captured_general_batch(card, monkeypatch):
    """The two-layer scene at batch 65536, captured with the tracer on: each
    layer's and the continuation's stage and the fold's are positive, each
    counted under its family too, and the families' sum is within 10% of a
    replay's device time; the lanes counter counts every replayed batch."""
    monkeypatch.setenv("IHT_STEPS_PER_DISPATCH", "8")
    eng = _two_layers("cuda", 65536)
    eng.run(n_batches=8)
    with profiling.tracing():
        eng.run(n_batches=8)                 # captures anew, with the timers
        assert eng.graph_mode == "cuda graph" and eng._graph_marks is not None
        snap = profiling.snapshot(eng)
        n, lanes0 = len(snap["stages"]), snap["engines"][0]["cont_lanes"][0]
        replays = eng.overflow_replays
        eng.run(n_batches=8)
        snap = profiling.snapshot(eng)
        _dispatch, stages = snap["stages"][n]
        families = ("layer_trace", "continuation", "sort", "scan", "rest")
        assert set(stages) == set(families) | {"layer_trace.0", "layer_trace.1",
                                               "continuation.1"}
        assert all(stages[f] > 0 for f in families), stages
        assert stages["layer_trace"] == pytest.approx(stages["layer_trace.0"]
                                                      + stages["layer_trace.1"])
        assert stages["continuation"] == stages["continuation.1"]
        batches = 8 + eng.overflow_replays - replays
        assert (snap["engines"][0]["cont_lanes"][0] - lanes0
                == batches * eng.layers[1].cont_cap)
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        times = []
        for _ in range(5):
            a.record()
            eng._graph.replay()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) * 1e-3)
    batch = sorted(times)[2]
    total = sum(stages[f] for f in families)
    assert abs(total - batch) <= 0.1 * batch, (stages, times)
