"""The general-path cell ``light_two_layer.r512`` on the CPU: a run end to
end through the harness, the readers of the general path's stage timers and
counters (``metrics/_general.py``: ``layer_trace_us``, ``continuation_us``,
``layer_trace_roofline``, ``continuation_fill``) on a recorded card snapshot,
a CPU engine and a program without them, planted faults of the general
path, and the scenes its reference refuses.

    python -m pytest portbench/tests -q -p no:cacheprovider
"""

import copy
import importlib
import json

import pytest
import torch

from portbench import run
from portbench.metrics import _general
from portbench.reference import oracle
from portbench.reference.plain.config.loader import load_project as ref_load
from portbench.reference.two_layer import Scene

CELL = "light_two_layer.r512"
READERS = ("layer_trace_us", "continuation_us", "layer_trace_roofline", "continuation_fill")
SEED = 4000000007
CPU = dict(device="cpu", kernels="plain", batch=4096, check_span=2)

torch.set_num_threads(2)


def _cpu_run(monkeypatch, control=False, hook=None):
    """The cell on the CPU: 4096 rays a batch, 3 batches a dispatch; the CPU
    plain scan's ulp limit, as the light cells' CPU runs take it
    (``test_portbench_harness.py``)."""
    monkeypatch.setenv("IHT_STEPS_PER_DISPATCH", "3")
    real = run.workload

    def workload(name):
        wl = real(name)
        wl["limits"] = dict(wl["limits"], image_gap_ulp=1000.0)
        return wl

    monkeypatch.setattr(run, "workload", workload)
    return run.run_cell(CELL, SEED, 0.2, False, control=control, engine_hook=hook, **CPU)


def test_the_cell_reports_its_metrics():
    bench = run.spec()
    assert run.cell_metrics(bench, CELL, False) == [("rays_per_s", "rays/s"), ("setup_s", "s")]
    assert [n for n, _ in run.cell_metrics(bench, CELL, True)] == list(READERS)
    wl = run.workload(CELL)
    assert wl["reference"] == "two_layer" and wl["batch"] == 229376 and wl["chips"] == 1
    assert wl["resolution"] == [[512, 256]] and wl["control"]["kind"] == "reference_bf16"
    cfg = run.config(wl["config"])
    assert cfg["reduced"] == [] and cfg["stands_in"] is False
    layers = cfg["document"]["scene"]["scattering"]
    assert [l["prob"] for l in layers] == [1.0, 0.0]
    assert set(cfg["guarantees"]) >= {"emit_floor", "slot_cap", "continuation", "lanes",
                                      "stats"}


def test_a_sound_cpu_run_is_correct(monkeypatch):
    out = json.loads(json.dumps(_cpu_run(monkeypatch)))
    assert out["correct"] is True, out["checks"]
    assert set(out["metrics"]) == {"rays_per_s", "setup_s"}
    assert out["metrics"]["rays_per_s"]["value"] > 0 and out["attempted"] % 3 == 0
    assert out["checks"]["segments_off"]["value"] == 0


def test_the_bfloat16_control_is_not_correct(monkeypatch):
    out = _cpu_run(monkeypatch, control=True)
    assert out["correct"] is False
    assert out["checks"]["image_gap_l1"]["value"] > 1e-5


def _slot_cap_off(eng):
    """Every exit slot folded: the rays past the calibrated cap land."""
    calibrate = eng._maybe_calibrate

    def without_cap(*a, **k):
        calibrate(*a, **k)
        eng._slot_cap = eng.max_hits
        eng._recompute_rows_per_render()
        eng._compact_keep = None

    eng._maybe_calibrate = without_cap


def _continuation_dropped(eng):
    """The continuation's lanes cut to 1024 after calibration: the
    overflowing rows are dropped as the rule says, but the reference's lanes
    are not the port's."""
    calibrate = eng._maybe_calibrate

    def fewer_lanes(*a, **k):
        calibrate(*a, **k)
        eng._build_plan(cont_caps=[None, 1024])
        eng._recompute_rows_per_render()
        eng._compact_keep = None

    eng._maybe_calibrate = fewer_lanes


@pytest.mark.parametrize("fault", [_slot_cap_off, _continuation_dropped])
def test_a_planted_general_path_fault_is_not_correct(fault, monkeypatch):
    out = _cpu_run(monkeypatch, hook=fault)
    assert out["correct"] is False, out["checks"]
    assert out["failed"] > 0


def _ctx():
    """A run's record at batch 4096 with the reference's replay of two
    batches."""
    wl = run.workload(CELL)
    doc = run.scene_document(wl, run.config(wl["config"]))
    scene = Scene(ref_load(copy.deepcopy(doc)), SEED, 4096, "cpu")
    zeros = [torch.zeros((pp.height * pp.width, 3)) for pp in scene.proj_plans]
    rep = oracle.replay(scene, zeros, range(2))
    window = {"wall_s": 10.0, "batches": 4608, "rays": 4608 * 229376, "dispatch_s": [],
              "dispatches": 72, "overflow_replays": 0, "host_syncs": 72, "after": {}}
    return run.Ctx(attempted=4608, window=window, setup_s=12.0, profile=None,
                   profile_batches=wl["profile_batches"], scene=scene,
                   reference={"batches": rep["batches"], "live_rows": rep["live_rows"]},
                   stash={})


def _span(name, start, end, parent, dispatch, sid):
    from ice_halo_sim_tpu_torch.utils.profiling import Span

    return Span(name, start, end, parent, dispatch, sid)


def _card_record(stages=True):
    """``_general.measure``'s stash as a card run leaves it: the first
    dispatch (before the stretch) captures, then three dispatches whose last
    batch's layers take 20 + i ms, its continuation 0.5 ms; live
    continuation rows 0.8 of the 3 x 8 x 1400832 lanes."""
    spans, stage_rows, ids = [], [], iter(range(1000))
    since = 10_000_000
    for i, d in enumerate((8, 16, 24)):
        t = since + (i + 1) * 1_000_000
        root = next(ids)
        spans.append(_span("iht.dispatch", t, t + 900_000, -1, d, root))
        spans.append(_span("iht.launch", t + 10_000, t + 20_000, root, d, next(ids)))
        if stages:
            s = {"layer_trace.0": 3e-3, "layer_trace.1": (17 + i) * 1e-3,
                 "continuation.1": 5e-4, "sort": 2e-4, "scan": 1e-4, "rest": 1e-3}
            s["layer_trace"] = s["layer_trace.0"] + s["layer_trace.1"]
            s["continuation"] = s["continuation.1"]
            stage_rows.append((d, s))
    lanes = 24 * 1400832
    snap = {"spans": spans, "stages": stage_rows, "capacity": 1 << 16, "launches": {},
            "build_seconds": None, "engines": []}
    return {"snapshot": snap, "since": since, "card": True,
            "counters": (([1000], [500]), ([1000 + int(0.8 * lanes)], [500 + lanes]))}


def _read_all(ctx):
    return {n: importlib.import_module(f"portbench.metrics.{n}").read(ctx) for n in READERS}


def test_the_readers_of_a_card_record():
    from portbench.metrics import layer_trace_roofline
    from portbench.metrics._peaks import least_seconds

    ctx = _ctx()
    ctx.stash[_general.KEY] = _card_record()
    got = _read_all(ctx)
    assert got["layer_trace_us"] == pytest.approx(21e3)
    assert got["continuation_us"] == pytest.approx(500.0)
    assert got["continuation_fill"] == pytest.approx(0.8, abs=1e-6)
    least, by = least_seconds(*layer_trace_roofline.batch_work(ctx.scene, ctx.reference))
    assert by == "operations"
    assert got["layer_trace_roofline"] == pytest.approx(100 * least / 21e-3)
    assert 0 < got["layer_trace_roofline"] < 100


def test_the_roofline_counts_the_references_lanes():
    """Layer 1's lanes are the batch's, layer 2's the reference's live
    continuation rows; a continued lane does not draw a sun or wavelength
    and a layer that continues every exit projects nothing."""
    from portbench.metrics import layer_trace_roofline as m

    ctx = _ctx()
    scene = ctx.scene
    _b, ops, _s = m.batch_work(scene, ctx.reference)
    live = sum(scene.cont_live[c][0] for c in (0, 1)) / 2
    (o1, _s1), (o2, _s2) = m.lane_work(scene, 0), m.lane_work(scene, 1)
    assert ops == pytest.approx(o1 * scene.batch_size + o2 * live)
    assert 4 * scene.batch_size < live < scene.layers[1].lanes
    assert o1 < o2       # layer 1 emits nothing: no floor, no projection


def test_a_card_record_without_its_stages_fails_the_run():
    ctx = _ctx()
    ctx.stash[_general.KEY] = _card_record(stages=False)
    for name in ("layer_trace_us", "continuation_us", "layer_trace_roofline"):
        with pytest.raises(RuntimeError):
            importlib.import_module(f"portbench.metrics.{name}").read(ctx)


def test_a_program_without_the_counters_gives_nothing(monkeypatch):
    """The parent of the general path's timers and counters: its snapshot
    has no ``cont_lanes``; ``measure`` still runs and no reader raises."""
    from ice_halo_sim_tpu_torch.utils import profiling

    real = profiling.snapshot

    def old_snapshot(*engines):
        snap = real(*engines)
        for e in snap["engines"]:
            del e["cont_live"], e["cont_lanes"]
        return snap

    monkeypatch.setattr(profiling, "snapshot", old_snapshot)
    eng = _engine(monkeypatch)
    ctx = _ctx()
    _general.measure(eng, ctx)
    assert ctx.stash[_general.KEY]["counters"] is None
    assert _read_all(ctx) == dict.fromkeys(READERS)


def _engine(monkeypatch):
    from ice_halo_sim_tpu_torch.config.loader import load_project
    from ice_halo_sim_tpu_torch.engine.simulator import Engine

    monkeypatch.setenv("IHT_STEPS_PER_DISPATCH", "2")
    monkeypatch.setattr(_general, "DISPATCHES", 2)
    monkeypatch.setattr(_general, "BATCHES", 2)
    doc = run.config(run.workload(CELL)["config"])["document"]
    eng = Engine(load_project(copy.deepcopy(doc)), seed=SEED, batch_size=4096, device="cpu")
    eng.run(n_batches=1)
    return eng


def test_a_cpu_engine_measured(monkeypatch):
    """On the CPU the batches are eager and untimed: the three stage
    readers give None, the counters give the fill; the tracer is off again
    after ``measure``, which runs once for the four readers."""
    from ice_halo_sim_tpu_torch.utils import profiling

    eng = _engine(monkeypatch)
    ctx = _ctx()
    _general.measure(eng, ctx)
    _general.measure(eng, ctx)
    assert not profiling.is_tracing() and eng.batch_counter == 1 + 2 + 2 * 2
    rec = ctx.stash[_general.KEY]
    assert rec["card"] is False
    (live0, lanes0), (live1, lanes1) = rec["counters"]
    assert lanes1[0] - lanes0[0] == 2 * 2 * eng.layers[1].cont_cap
    got = _read_all(ctx)
    assert got["layer_trace_us"] is None and got["continuation_us"] is None
    assert got["layer_trace_roofline"] is None
    assert 0.5 < got["continuation_fill"] <= 1.0


@pytest.mark.parametrize("change", ["filter", "two_settings"])
def test_the_reference_refuses_a_filtered_or_two_setting_scene(change):
    doc = copy.deepcopy(run.config(run.workload(CELL)["config"])["document"])
    entries = doc["scene"]["scattering"][0]["entries"]
    if change == "filter":
        doc["filter"] = [{"id": 1, "type": "raypath", "raypath": [3, 5], "symmetry": "P",
                          "action": "filter_in"}]
        entries[0]["filter"] = 1
    else:
        entries.append({"crystal": 1, "proportion": 3})
    with pytest.raises(NotImplementedError):
        Scene(ref_load(doc), SEED, 4096, "cpu")
