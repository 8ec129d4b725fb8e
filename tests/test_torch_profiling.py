"""The port's one door to torch.profiler (``utils/profiling.py``), the
probe that repeats the replay-under-profiler experiments
(``probe_profiler``), and the per-scene profile (``profile_slice``), on
the CPU: no device time is recorded here, and none is reported."""

import json
from types import SimpleNamespace

import pytest
import torch

from ice_halo_sim_tpu_torch import probe_profiler, profile_slice
from ice_halo_sim_tpu_torch.utils import profiling

# Tier-1 runs six workers; keep each one to two torch threads.
torch.set_num_threads(2)


def test_device_profile_of_a_cpu_call_records_no_device_time():
    """A window over a plain CPU call opens and closes without raising,
    records no device time and no kernel, and says it is empty."""
    x = torch.arange(64, dtype=torch.float32)
    with profiling.device_profile() as win:
        y = (x * 2.0).sum()
    assert float(y) == 4032.0
    assert win.device_us == 0 and win.kernels == 0 and win.empty and win.top() == []


def test_window_rows_keep_device_operations_largest_first():
    """Device operations with time, the largest first (ties by name); CPU
    operations and operations without device time are left out."""
    def ev(key, device, us, count=1):
        return SimpleNamespace(key=key, device_type=f"DeviceType.{device}",
                               self_device_time_total=us, count=count)

    win = profiling.Window()
    win.rows = profiling._device_rows([
        ev("aten::mul", "CPU", 50.0), ev("void k1<float>(...)", "CUDA", 3.0, 4),
        ev("Memset (Device)", "CUDA", 0.0, 2), ev("sort_kernel", "CUDA", 7.5, 1),
        ev("a_copy", "CUDA", 3.0, 2)])
    assert win.rows == [(7.5, 1, "sort_kernel"), (3.0, 2, "a_copy"),
                        (3.0, 4, "void k1<float>(...)")]
    assert win.device_us == 13.5 and win.kernels == 7 and not win.empty
    assert win.top(2) == [("sort_kernel", 7.5), ("a_copy", 3.0)]


def test_probe_profiler_lists_its_experiments(capsys):
    assert probe_profiler.main(["--list"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert [line.split(":")[0] for line in out] == list(probe_profiler.EXPERIMENTS)
    for name in ("toy", "toy-destroy", "before", "parent", "before-eager-modules",
                 "before-window-first", "before-fresh-capture"):
        assert name in probe_profiler.EXPERIMENTS
    with pytest.raises(SystemExit):
        probe_profiler.main(["--list", "--only", "no-such-experiment"])


def test_probe_profiler_cut_runs_and_missing_checkouts():
    """A cut run is chip_smoke.main() of its checkout with the verdict cut
    after its first call; an experiment on a checkout that was not given
    is reported as not run, without running anything."""
    argv, cwd = probe_profiler._command("cut", "before+fresh", {"before": "/x/before"})
    assert cwd == "/x/before" and argv[1] == "-c"
    code = argv[2]
    compile(code, "<cut run>", "exec")
    assert "FRESH = True" in code and "WINDOW_FIRST = False" in code
    assert "TREE = '/x/before'" in code and "c.main()" in code
    assert probe_profiler._command("cut", "parent", {"parent": None}) is None
    row = probe_profiler.run_experiment("parent", 20, 2, {}, None, 10.0)
    assert row["runs"] == 0 and "not_run" in row


def test_profile_slice_reports_without_device_time_on_the_cpu(capsys):
    """The per-scene profile on the CPU at a small batch: one report and one
    JSON line per window, no device time ("not measured"), one host read a
    dispatch, the fold and why."""
    assert profile_slice.main(["--device", "cpu", "--scene", "bench", "--batch-size", "2048",
                               "--batches", "2", "--graphs", "off"]) == 0
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]
    assert [(r["scene"], r["fold"]) for r in rows] == [("bench", "sort")]
    r = rows[0]
    assert r["fold_decision"] == "sort fold: the trace kernel emits packed sort keys"
    assert r["busy_ms"] is None and r["idle_share"] is None and r["top5"] == []
    assert r["host_reads_per_dispatch"] == 1.0 and r["batch"] == 2048
    assert r["wall_ms"] > 0 and r["wall_in_window_ms"] > 0 and r["card"] == "cpu"


def test_a_window_makes_earlier_captures_stale(monkeypatch):
    """Every window makes the graphs captured before it stale
    (engine/graph.py ``invalidate``): an Engine replays its captured batch
    until a window opens, captures it anew in the window's warm call
    (outside the profiler), and the window replays that capture. The
    graphs are stand-ins that record their captures and replays, so that
    the Engine's choice runs here on the CPU."""
    from ice_halo_sim_tpu_torch.config.loader import load_project
    from ice_halo_sim_tpu_torch.engine import graph as graph_mod
    from ice_halo_sim_tpu_torch.engine.simulator import Engine
    from ice_halo_sim_tpu_torch.scenes import BENCH_CFG

    log = []

    class Recorded(graph_mod.BatchGraph):
        def __init__(self, step, key, device):
            graph_mod._Capture.__init__(self)
            self.key = key
            log.append(("capture", self))

        def replay(self):
            log.append(("replay", self))

    monkeypatch.setattr(graph_mod, "BatchGraph", Recorded)
    eng = Engine(load_project(BENCH_CFG), seed=7, batch_size=2048, device="cpu")
    eng._step(True)
    eng._step(True)
    first = eng._graph
    assert [e for e, _ in log] == ["capture", "replay"] and not first.stale
    with profiling.device_profile(warm=lambda: eng._step(True)):
        assert first.stale and not eng._graph.stale and eng._graph is not first
        eng._step(True)
    assert [e for e, _ in log] == ["capture", "replay", "capture", "replay"]
    assert log[3][1] is log[2][1] is eng._graph
