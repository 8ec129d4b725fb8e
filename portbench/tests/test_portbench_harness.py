"""The benchmark's harness, on the CPU: the files it finds by name, the
contract of ``BENCHMARK.json``, the result line, the refusal without a
card, the modules a run loads, planted faults that ``correct`` must catch,
and the copy of ``chip_smoke.py``'s work count. The server driver's own
tests are in ``test_portbench_server.py``.

    python -m pytest portbench/tests -q -p no:cacheprovider

A CPU run drives the harness's own functions (``run.run_cell``) with the
port's plain kernels at a small batch; ``main`` itself refuses to start
without a card. The test marked ``cuda`` runs one cell on the card.
"""

import copy
import importlib
import json
import os
import re
import subprocess
import sys

import pytest
import torch

from portbench import profiler, run

HERE = os.path.dirname(os.path.abspath(__file__))
PB = os.path.dirname(HERE)
ROOT = os.path.dirname(PB)
BENCH = run.spec()
CELLS = [w["name"] for w in BENCH["workloads"]]
DRIVER = {c: run.workload(c).get("driver", "engine") for c in CELLS}
ENGINE_CELLS = [c for c in CELLS if DRIVER[c] == "engine"]
SEED = 4000000007
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")

torch.set_num_threads(2)


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_resolves(cell):
    """A cell's workload file names a configuration of BENCHMARK.json whose
    file is there, and every metric the cell reports has a reader."""
    wl = run.workload(cell)
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert wl["name"] == cell and wl["config"] == entry["config"]
    assert wl["chips"] == entry["chips"] and wl["why"] == entry["why"]
    cfg = next(c for c in BENCH["configs"] if c["name"] == wl["config"])
    assert cfg["file"] == f"portbench/configs/{wl['config']}.json"
    doc = run.config(wl["config"])
    assert doc["name"] == cfg["name"] and doc["source"] == cfg["source"]
    assert doc["reduced"] == cfg["reduced"]
    run.scene_document(wl, doc)
    assert os.path.isfile(os.path.join(PB, "drivers", f"{DRIVER[cell]}.py"))
    if DRIVER[cell] == "engine":
        assert wl["batch"] > 0 and wl["profile_batches"] > 0 and wl["check_span"] > 0
    assert set(wl["limits"]) == {"image_gap_l1", "image_gap_ulp", "landed_gap", "dropped_gap"}
    assert os.path.isfile(os.path.join(PB, "reference", f"{wl['reference']}.py"))
    for trace in (False, True):
        names = run.cell_metrics(BENCH, cell, trace)
        assert names
        for name, _unit in names:
            mod = importlib.import_module(f"portbench.metrics.{name}")
            assert callable(mod.read)


def test_benchmark_json_keeps_to_the_contract():
    b = BENCH
    assert list(b) == ["command", "paths", "run_seconds", "configs", "workloads",
                       "end_to_end", "per_layer"]
    assert b["command"] == ["python3", "-m", "portbench.run"]
    assert b["paths"] == ["portbench"] and 1 <= b["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    line = re.compile(r"^[^\n\t]{1,200}$")
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line.match(c["source"]) and line.match(c["why"])
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        assert any(w["config"] == c["name"] for w in b["workloads"])
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and line.match(w["why"])
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(b["workloads"]) <= 24
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and line.match(m["layer"])
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        # Every cell a metric names reports the end-to-end metric it moves.
        assert set(m.get("workloads", CELLS)) <= set(e2e[m["moves"]].get("workloads", CELLS))
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(set(names)) == len(names)
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                                                   "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for cell in CELLS:
        e = [n for n, _ in run.cell_metrics(b, cell, False)]
        assert "setup_s" in e and len(e) >= 2 and run.cell_metrics(b, cell, True)
    for d, _, files in os.walk(PB):
        if "__pycache__" in d:
            continue
        for f in files:
            rel = os.path.relpath(os.path.join(d, f), ROOT)
            assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel


def _recorded_ctx(trace):
    """A run's record with numbers as a card run writes them."""
    from portbench.reference.plain.config.loader import load_project
    from portbench.reference.scene import Scene

    wl = run.workload("light_single.r512")
    doc = run.scene_document(wl, run.config(wl["config"]))
    scene = Scene(load_project(copy.deepcopy(doc)), SEED, 4096, "cpu")
    window = {"wall_s": 15.0123, "batches": 16384, "rays": 16384 * 229376,
              "dispatch_s": [0.0271 + 1e-5 * i for i in range(256)], "dispatches": 256,
              "overflow_replays": 0, "host_syncs": 256, "after": {}}
    prof = None
    if trace:
        dev = [profiler.Span("trace_emit_kernel<8>(TraceParams)", 10.0 + 400 * i, 110.0 + 400 * i)
               for i in range(4)]
        dev += [profiler.Span("DeviceRadixSortOnesweepKernel", 120.0 + 400 * i, 380.0 + 400 * i)
                for i in range(4)]
        host = [profiler.Span("portbench.window", 0.0, 1700.0),
                profiler.Span("portbench.dispatch", 1.0, 1650.0),
                profiler.Span("cudaGraphLaunch", 380.0, 415.0)]
        prof = profiler.Window(dev, host, 0.0017, 0.0, 1700.0)
    ref = {"batches": 3, "live_rows": [3 * 700000]}
    return run.Ctx(attempted=16384, window=window, setup_s=11.5, profile=prof,
                   profile_batches=4, scene=scene, reference=ref, stash={})


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_holds_the_contracts_keys(trace):
    from portbench.metrics import _program
    from portbench.tests.test_portbench_program import _card_record

    ctx = _recorded_ctx(trace)
    if trace:
        ctx.stash[_program.KEY] = _card_record()
    names = run.cell_metrics(BENCH, "light_single.r512", trace)
    readers = {n: importlib.import_module(f"portbench.metrics.{n}") for n, _ in names}
    checks = {"image_gap_l1": (0.0, 1e-6), "image_gap_ulp": (0.0, 64.0),
              "landed_gap": (2e-6, 1e-2), "dropped_gap": (1e-14, 5e-12), "segments_off": (0, 0)}
    dev = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
           "memory_peak_bytes": 311777280}
    out = json.loads(json.dumps(run.result(ctx, names, readers, checks, 0, dev)))
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out) == keys + (["breakdown"] if trace else []) + ["checks"]
    assert out["correct"] is True and out["attempted"] == 16384 and out["failed"] == 0
    assert set(out["metrics"]) == {n for n, _ in names}
    for name, unit in names:
        m = out["metrics"][name]
        assert list(m) == ["value", "unit"] and m["unit"] == unit
        assert m["value"] == m["value"] and abs(m["value"]) != float("inf")
    want_dev = {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(out["device"]) == want_dev | ({"busy_s", "window_s"} if trace else set())
    if trace:
        assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
        assert 0 <= out["metrics"]["idle_share"]["value"] < 1
        assert 0 < out["metrics"]["trace_roofline"]["value"] <= 100
        assert 0 < out["metrics"]["fold_roofline"]["value"] <= 100
        for k in ("device_ops", "idle_gaps"):
            rows = out["breakdown"][k]
            assert 0 < len(rows) <= 10 and all(isinstance(v, float) for _, v in rows)
        assert out["breakdown"]["idle_gaps"][0][0].startswith("portbench.window")
    else:
        assert out["metrics"]["rays_per_s"]["value"] == pytest.approx(16384 * 229376 / 15.0123)
    checks["segments_off"] = (1, 0)
    assert run.result(ctx, names, readers, checks, 64, dev)["correct"] is False
    checks["segments_off"] = (0, 0)
    # A failed unit makes the run not correct, with every number in its limit.
    failed = run.result(ctx, names, readers, checks, 3, dev)
    assert failed["correct"] is False and failed["failed"] == 3


def test_main_refuses_without_a_card(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "light_single.r512", "--seed", str(SEED), "--seconds", "1",
                   "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "CUDA" in out.err


# A CPU run: the plain kernels, 4096 rays a batch, 3 batches a dispatch, the
# checked dispatch among the window's first two. The CPU's plain scan sums a
# pixel as a difference of float64 running sums, a few dozen float32 ulps
# off on the dimmest pixels: its runs read the ulp gap to 1000. The CPU's
# plain trace twin sums the dropped weight as a difference of two float32
# sums of every row (some 1e-8 of the landed weight off; the card's kernel
# sums the terms, 1e-14 off): its runs read that gap to 1e-7.
CPU = dict(device="cpu", kernels="plain", batch=4096, check_span=2)


def _cpu_run(monkeypatch, cell, hook=None, control=False):
    monkeypatch.setenv("IHT_STEPS_PER_DISPATCH", "3")
    real = run.workload

    def workload(name):
        wl = real(name)
        wl["limits"] = dict(wl["limits"], image_gap_ulp=1000.0, dropped_gap=1e-7)
        return wl

    monkeypatch.setattr(run, "workload", workload)
    return run.run_cell(cell, SEED, 0.2, False, control=control, engine_hook=hook, **CPU)


@pytest.mark.parametrize("cell", ENGINE_CELLS)
def test_a_sound_cpu_run_is_correct(cell, monkeypatch):
    out = _cpu_run(monkeypatch, cell)
    assert out["correct"] is True, out["checks"]
    assert out["checks"]["segments_off"]["value"] == 0


# The result line of each light cell's CPU run (``_cpu_run``, seed SEED)
# as the harness gave it before its set-up, window and check moved into
# ``drivers/engine.py``. attempted, rays_per_s and setup_s follow the
# CPU's clock; every other key and value is the same.
BEFORE = os.path.join(HERE, "light_cpu_lines.json")


@pytest.mark.parametrize("cell", ENGINE_CELLS)
def test_the_light_line_is_as_before_the_split(cell, monkeypatch):
    with open(BEFORE) as f:
        before = json.load(f)[cell]
    out = json.loads(json.dumps(_cpu_run(monkeypatch, cell)))
    assert list(out) == list(before)
    assert out["correct"] is before["correct"] and out["failed"] == before["failed"]
    assert out["checks"] == before["checks"] and out["device"] == before["device"]
    assert list(out["metrics"]) == list(before["metrics"])
    for name, m in out["metrics"].items():
        assert m["unit"] == before["metrics"][name]["unit"] and m["value"] > 0
    assert out["attempted"] > 0 and out["attempted"] % 3 == 0


def _rows_of(eng, fault):
    """Plant `fault` where the rows of a batch are produced: the trace
    kernel's output."""
    def alter(w):
        w = w.clone()
        if fault == "half":
            # Half of the batch left out, the mean taken over the rest.
            flat = w.view(-1)
            flat[1::2] = 0.0
            flat[0::2] *= 2.0
        else:
            # One answer altered: the first live row's weight.
            flat = w.view(-1)
            i = int(torch.nonzero(flat > 0)[0])
            flat[i] = flat[i] * 1.5
        return w

    assert eng._trace_plan is not None
    inner = eng.ks.trace_emit

    def trace_emit(*a, **k):
        per_render, landed, dropped, segs = inner(*a, **k)
        if fault == "landed":
            return per_render, landed * 1.1, dropped, segs
        return [(kk, alter(w), c) for kk, w, c in per_render], landed, dropped, segs

    eng.ks = eng.ks._replace(trace_emit=trace_emit)


def _unchanged(eng):
    """A step that returns its state unchanged (its counter still moves)."""
    eng._batch = lambda n_active=None, host_choice=False: eng._dev.counter.add_(1)


FAULTS = {"state_unchanged": _unchanged,
          "half_the_batch": lambda eng: _rows_of(eng, "half"),
          "one_answer_altered": lambda eng: _rows_of(eng, "one"),
          "landed_weight_altered": lambda eng: _rows_of(eng, "landed")}


@pytest.mark.parametrize("fault", list(FAULTS))
@pytest.mark.parametrize("cell", ENGINE_CELLS)
def test_a_planted_fault_is_not_correct(cell, fault, monkeypatch):
    out = _cpu_run(monkeypatch, cell, hook=FAULTS[fault])
    assert out["correct"] is False, out["checks"]
    assert out["failed"] > 0


@pytest.mark.parametrize("cell", ENGINE_CELLS)
def test_the_bfloat16_control_is_not_correct(cell, monkeypatch):
    """The reference one precision lower in the program's place: bfloat16
    rows and landed weight."""
    out = _cpu_run(monkeypatch, cell, control=True)
    assert out["correct"] is False
    assert out["checks"]["image_gap_l1"]["value"] > 1e-5
    assert out["checks"]["landed_gap"]["value"] > 1e-3


def test_a_run_loads_no_jax():
    """After a run, no module whose top-level name, compared whole, is jax,
    jaxlib, flax or the JAX package (the port's own name begins with the
    JAX package's, so a prefix test would be wrong both ways)."""
    code = (
        "import os, sys\n"
        "os.environ['IHT_STEPS_PER_DISPATCH'] = '2'\n"
        "from portbench import run\n"
        f"out = run.run_cell('light_single.r512', {SEED}, 0.1, False, device='cpu', "
        "kernels='plain', batch=2048, check_span=1)\n"
        "assert 'ice_halo_sim_tpu_torch' in sys.modules\n"
        "print(run.forbidden_modules())\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.parametrize("scene", ["BENCH_CFG", "POOL_CFG"])
def test_the_work_count_is_chip_smokes(scene):
    """portbench/metrics holds a copy of chip_smoke.py's trace_work and
    _bound: on the port's plan of BENCH_CFG and POOL_CFG they count what the
    copy counts on the reference's plan of the same scene."""
    sys.path.insert(0, ROOT)
    import chip_smoke
    from ice_halo_sim_tpu_torch import scenes
    from ice_halo_sim_tpu_torch.config.loader import load_project
    from ice_halo_sim_tpu_torch.engine.simulator import Engine

    from portbench.metrics import _peaks, trace_roofline
    from portbench.reference.plain.config.loader import load_project as ref_load
    from portbench.reference.scene import Scene

    doc = getattr(scenes, scene)
    batch = 16384
    eng = Engine(load_project(copy.deepcopy(doc)), seed=SEED, batch_size=batch, device="cpu")
    ref = Scene(ref_load(copy.deepcopy(doc)), SEED, batch, "cpu")
    assert ref._trace_plan is not None and eng._trace_plan is not None
    want = chip_smoke.trace_work(eng._trace_plan)
    assert trace_roofline.trace_work(ref._trace_plan) == want
    ms, by = chip_smoke._bound(*want)
    s, by2 = _peaks.least_seconds(*want)
    assert by == by2 and s * 1e3 == pytest.approx(ms, rel=1e-12)
    assert (_peaks.HBM_BYTES_S, _peaks.FP32_OPS_S, _peaks.SFU_OPS_S) == (
        chip_smoke.HBM_BYTES_S, chip_smoke.FP32_OPS_S, chip_smoke.SFU_OPS_S)


def test_the_reference_refuses_a_general_path_scene():
    """A scene the trace kernel refuses (here three crystals in two layers)
    needs a reference of its own: this one says so instead of answering."""
    from ice_halo_sim_tpu_torch import scenes

    from portbench.reference.plain.config.loader import load_project as ref_load
    from portbench.reference.scene import Scene

    with pytest.raises(NotImplementedError, match="trace kernel"):
        Scene(ref_load(copy.deepcopy(scenes.MULTI_CFG)), SEED, 4096, "cpu")


@pytest.mark.cuda
def test_a_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                          "light_single.r512", "--seed", str(SEED), "--seconds", "2",
                          "--trace", "1"], cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
