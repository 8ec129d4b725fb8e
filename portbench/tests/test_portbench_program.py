"""The readers of the port's own spans and stage timers
(``metrics/_program.py``: ``graph_launch_us``, ``dispatch_gap_us``,
``sort_us``, ``setup_program_s``), on the CPU: a recorded snapshot as the
card gives one, a CPU engine's, a program without the tracer, and a card
run whose spans are missing.

    python -m pytest portbench/tests -q -p no:cacheprovider
"""

import copy
import importlib
import json

import pytest
import torch

from portbench import run
from portbench.metrics import _program
from portbench.tests.test_portbench_harness import _recorded_ctx

READERS = ("graph_launch_us", "dispatch_gap_us", "sort_us", "setup_program_s")
US = 1000   # ns

torch.set_num_threads(2)


def _span(name, start, end, parent, dispatch, sid):
    from ice_halo_sim_tpu_torch.utils.profiling import Span

    return Span(name, start, end, parent, dispatch, sid)


def _card_record():
    """A snapshot as a card run's ``measure`` leaves it: set-up spans, one
    dispatch that captures, then three of two launches each; dispatch i
    starts i + 1 ms after the stretch's start; its launches take 10 + i and
    20 + i us, its read ends 900 us after its start; the sort stage of its
    last batch takes 200 + i us."""
    spans, ids = [], iter(range(1000))
    since = 10_000_000
    spans += [_span("iht.setup.engine", 0, 2_000_000, -1, -1, next(ids)),
              _span("iht.setup.library", 2_500_000, 3_000_000, -1, -1, next(ids)),
              _span("iht.calibrate", 4_000_000, 4_100_000, -1, -1, next(ids)),
              _span("iht.capture", 5_000_000, 6_000_000, -1, -1, next(ids))]
    stages = []
    for i, d in enumerate((64, 128, 192, 256)):
        t = since + (i + 1) * 1_000_000
        root = next(ids)
        spans.append(_span("iht.dispatch", t, t + 950 * US, -1, d, root))
        spans.append(_span("iht.prologue", t + 10 * US, t + 20 * US, root, d, next(ids)))
        if i == 0:
            spans.append(_span("iht.capture", t + 30 * US, t + 500 * US, root, d, next(ids)))
        spans.append(_span("iht.launch", t + 600 * US, t + (610 + i) * US, root, d, next(ids)))
        spans.append(_span("iht.launch", t + 700 * US, t + (720 + i) * US, root, d, next(ids)))
        spans.append(_span("iht.read", t + 800 * US, t + 900 * US, root, d, next(ids)))
        stages.append((d, {"trace": 1e-4, "scatter": 1e-5, "sort": (200 + i) * 1e-6,
                           "scan": 1.4e-5, "rest": 2e-5}))
    snap = {"spans": sorted(spans, key=lambda s: s.start), "stages": stages, "capacity": 1 << 16,
            "launches": {}, "build_seconds": None, "engines": []}
    return {"snapshot": snap, "since": since, "card": True}


def test_the_readers_of_a_card_record():
    ctx = _recorded_ctx(True)
    ctx.stash[_program.KEY] = _card_record()
    names = [(n, u) for n, u in run.cell_metrics(run.spec(), "light_single.r512", True)
             if n in READERS]
    assert [n for n, _ in names] == list(READERS)
    readers = {n: importlib.import_module(f"portbench.metrics.{n}") for n, _ in names}
    out = json.loads(json.dumps(run.result(ctx, names, readers, {}, 0, {})))
    got = {n: m["value"] for n, m in out["metrics"].items()}
    # The capture's dispatch (64) is left out: launches of 11 to 13 and 21
    # to 23 us.
    assert got["graph_launch_us"] == pytest.approx(17.0)
    # From a read's end to the next dispatch's first launch's end: 712, 713 us.
    assert got["dispatch_gap_us"] == pytest.approx(712.5)
    assert got["sort_us"] == pytest.approx(202.0)
    # The union of the four first set-up spans: 2.0 + 0.5 + 0.1 + 1.0 ms.
    assert got["setup_program_s"] == pytest.approx(3.6e-3)
    assert got["setup_program_s"] < ctx.setup_s


def test_a_card_record_without_its_spans_fails_the_run():
    ctx = _recorded_ctx(True)
    rec = _card_record()
    rec["snapshot"]["spans"] = [s for s in rec["snapshot"]["spans"]
                                if s.name not in ("iht.launch", "iht.setup.library")]
    rec["snapshot"]["stages"] = []
    ctx.stash[_program.KEY] = rec
    for name in READERS:
        with pytest.raises(RuntimeError):
            importlib.import_module(f"portbench.metrics.{name}").read(ctx)


def test_a_program_without_the_tracer_gives_nothing(monkeypatch):
    """The parent of the tracer's change: ``measure`` stashes nothing and
    no reader raises."""
    from ice_halo_sim_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "tracing")
    ctx = _recorded_ctx(True)
    _program.measure(None, ctx)
    assert ctx.stash == {_program.KEY: None}
    for name in READERS:
        assert importlib.import_module(f"portbench.metrics.{name}").read(ctx) is None


def test_a_cpu_engine_measured(monkeypatch):
    """On the CPU the batches are eager: no launch, no stage timer, so three
    readers give None; the set-up reader sums the engine and its
    calibration. The tracer is off again after ``measure``."""
    from ice_halo_sim_tpu_torch import scenes
    from ice_halo_sim_tpu_torch.config.loader import load_project
    from ice_halo_sim_tpu_torch.engine.simulator import Engine
    from ice_halo_sim_tpu_torch.utils import profiling

    monkeypatch.setenv("IHT_STEPS_PER_DISPATCH", "2")
    monkeypatch.setattr(_program, "DISPATCHES", 3)
    eng = Engine(load_project(copy.deepcopy(scenes.BENCH_CFG)), seed=7, batch_size=2048,
                 device="cpu")
    eng.run(n_batches=2)
    ctx = _recorded_ctx(False)
    _program.measure(eng, ctx)
    _program.measure(eng, ctx)                  # once for the four readers
    assert not profiling.is_tracing() and eng.batch_counter == 2 + 2 * 4
    rec = ctx.stash[_program.KEY]
    assert rec["card"] is False and len(_program.stretch(rec)) == 4
    values = {n: importlib.import_module(f"portbench.metrics.{n}").read(ctx) for n in READERS}
    assert values["graph_launch_us"] is None and values["dispatch_gap_us"] is None
    assert values["sort_us"] is None and 0 < values["setup_program_s"] < 60
