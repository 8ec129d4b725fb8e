"""The server driver (``drivers/server.py``), on the CPU: its cell's
workload file; a short viewer run with the plain kernels at a small size
comes out correct; planted faults (a generation's image scaled, a frame of
the old generation served after a load, and the light cells' faults of
the timed path in every engine the Server builds) and the bfloat16
control come out not correct; the draw of the checked loads and the
stale-frame rule on a recorded window; a run loads no JAX.

    python -m pytest portbench/tests -q -p no:cacheprovider

A CPU run keeps the cell's traffic (the GUI page's poll, a load at
alternating altitudes whenever a poll reads idle) and shrinks its sizes:
512x256, 4096 rays a batch, a budget of three batches, a poll 0.5 s after
each reply, a window of six seconds (a loaded CPU's load takes up to a
second): two loads or more.
"""

import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch

from portbench import run

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
BENCH = run.spec()
# The server driver's cell. It is not in BENCHMARK.json (its end-to-end
# metric has no bound that holds: PERF.md), so a run of it reports setup_s
# alone and logs the rest.
CELLS = ["light_single.r2048.viewer"]
SEED = 4000000007
BATCH = 4096
RAYS = 3 * BATCH - 100       # three batches, the last one not whole

torch.set_num_threads(2)


def small(wl: dict, doc: dict) -> None:
    """The CPU's sizes, in place. Its plain scan and trace twin read the
    ulp and dropped-weight gaps higher than the card's kernels
    (``test_portbench_harness``): their limits are the CPU's."""
    wl.update(resolution=[[512, 256]], batch=BATCH, poll_period_s=0.5)
    wl["limits"] = dict(wl["limits"], image_gap_ulp=1000.0, dropped_gap=1e-7)
    doc["document"]["scene"]["ray_num"] = RAYS


def _cpu_run(monkeypatch, cell, control=False, seconds=6.0, **test):
    real_w, real_c = run.workload, run.config
    sized = {}

    def workload(name):
        wl = real_w(name)
        sized["wl"] = wl
        return wl

    def config(name):
        doc = real_c(name)
        small(sized["wl"], doc)
        return doc

    monkeypatch.setattr(run, "workload", workload)
    monkeypatch.setattr(run, "config", config)
    return run.run_cell(cell, SEED, seconds, False, control=control, device="cpu",
                        kernels="plain", **test)


@pytest.mark.parametrize("cell", CELLS)
def test_the_viewer_cell_resolves(cell):
    wl = run.workload(cell)
    assert wl["name"] == cell and wl["driver"] == "server" and wl["chips"] == 1
    doc = run.scene_document(wl, run.config(wl["config"]))
    assert wl["batch"] > 0 and wl["poll_period_s"] > 0 and wl["profile_commits"] > 0
    assert len(wl["altitudes"]) == 2 and wl["altitudes"][0] != wl["altitudes"][1]
    assert doc["scene"]["light_source"]["altitude"] in wl["altitudes"]
    assert set(wl["limits"]) == {"image_gap_l1", "image_gap_ulp", "landed_gap", "dropped_gap"}
    assert wl["control"]["kind"] == "reference_bf16"


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_viewer_run_is_correct(cell, monkeypatch):
    out = json.loads(json.dumps(_cpu_run(monkeypatch, cell)))
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] >= 2 and out["failed"] == 0
    assert list(out["checks"]) == ["image_gap_l1", "image_gap_ulp", "landed_gap",
                                   "dropped_gap", "segments_off", "stale_frames"]
    assert out["checks"]["segments_off"]["value"] == 0
    assert out["checks"]["stale_frames"]["value"] == 0
    m = out["metrics"]
    assert set(m) == {n for n, _ in run.cell_metrics(BENCH, cell, False)} == {"setup_s"}
    assert m["setup_s"]["value"] > 0


def _scaled(server):
    """A generation's image scaled by 1.1 where the frame is made: every
    frame of an even generation (the checked commits, one after the
    other, hold one)."""
    inner = server.acquire_frame

    def acquire_frame():
        f = inner()
        if f.generation % 2:
            return f
        return dataclasses.replace(f, raw_xyz=tuple(x * 1.1 for x in f.raw_xyz))

    server.acquire_frame = acquire_frame


def _stale(server):
    """After each commit, the frame that was current before it served to
    every caller until the next commit: the new generation never shows."""
    commit, acquire = server.commit, server.acquire_frame
    held = {"last": None, "stale": None}

    def commit_(text):
        before = held["last"]
        out = commit(text)
        held["stale"] = before
        return out

    def acquire_frame():
        if held["stale"] is not None:
            return held["stale"]
        held["last"] = acquire()
        return held["last"]

    server.commit, server.acquire_frame = commit_, acquire_frame


def _in_every_engine(monkeypatch, fault):
    """`fault` planted in every engine the Server builds, before its first
    batch: the light cells' faults of the timed path
    (``test_portbench_harness.FAULTS``)."""
    from ice_halo_sim_tpu_torch.engine import server as server_mod

    from portbench.tests.test_portbench_harness import FAULTS

    real = server_mod.Engine

    def engine(*a, **k):
        eng = real(*a, **k)
        FAULTS[fault](eng)
        return eng

    monkeypatch.setattr(server_mod, "Engine", engine)


VIEWER_FAULTS = ["image_scaled", "stale_frame", "state_unchanged", "half_the_batch",
                 "one_answer_altered"]


@pytest.mark.parametrize("fault", VIEWER_FAULTS)
@pytest.mark.parametrize("cell", CELLS)
def test_a_planted_viewer_fault_is_not_correct(cell, fault, monkeypatch):
    hook = {"image_scaled": _scaled, "stale_frame": _stale}.get(fault)
    if hook is None:
        _in_every_engine(monkeypatch, fault)
    out = _cpu_run(monkeypatch, cell, server_hook=hook)
    assert out["correct"] is False, out["checks"]
    assert out["failed"] > 0
    checks = out["checks"]
    if fault == "stale_frame":
        assert checks["stale_frames"]["value"] > 0
    else:
        assert checks["image_gap_ulp"]["value"] > checks["image_gap_ulp"]["limit"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_viewer_bfloat16_control_is_not_correct(cell, monkeypatch):
    out = _cpu_run(monkeypatch, cell, control=True)
    assert out["correct"] is False
    assert out["checks"]["image_gap_l1"]["value"] > 1e-5
    assert out["checks"]["landed_gap"]["value"] > 1e-3


def _window(n=10):
    """A recorded window of n loads: load i starts at 100 + i, its reply
    0.1 + 0.01 i s later, idle after 0.25 + 0.01 i s, its final frame after
    0.3 + 0.01 i s; a poll of 0.02 s that reads the previous generation idle
    just before each load, one from the cache 0.5 s after it, and a
    refresh of 0.04 s after each reply."""
    commits, fetches = [], []
    for i in range(n):
        start = 100.0 + i
        returned = start + 0.1 + 0.01 * i
        commits.append({"start": start, "returned": returned, "idle": start + 0.25 + 0.01 * i,
                        "done": start + 0.3 + 0.01 * i, "generation": i + 2,
                        "frame_generation": i + 2, "rays": 3, "frame_idle": True,
                        "reused": False, "allocated": 0})
        fetches += [("status", start - 0.03, start - 0.01, i + 1, True, True),
                    ("status", start + 0.5, start + 0.5001, i + 2, True, False),
                    ("refresh", returned, returned + 0.04, i + 2, False, True)]
    return {"t0": 99.9, "wall_s": n + 0.1, "commits": commits, "fetches": fetches}


def test_kept_draws_from_the_seed_at_the_other_altitude():
    """The checked loads: the last, and one at the other altitude drawn
    from the seed uniformly over that altitude's loads."""
    from portbench.drivers.server import Kept

    def checked(seed, n):
        k = Kept(seed, 2)
        for i in range(n):
            k(i, f"frame {i}")
        return k.checked()

    got = checked(SEED, 43)
    assert 42 in got and len(got) == 2
    (other,) = set(got) - {42}
    assert other % 2 == 1 and got[other] == f"frame {other}"
    assert checked(SEED, 43) == got
    assert {i for s in range(200) for i in checked(s, 43) if i != 42} == set(range(1, 42, 2))
    assert set(checked(SEED, 2)) == {0, 1}


def test_stale_frames_by_the_stamps():
    """A fetch is held to the last load whose reply came before it began;
    a final frame to its own load, idle and with the budget's rays."""
    from portbench.drivers.server import stale_frames

    win = _window(n=3)
    assert stale_frames(win, 3) == 0
    c1 = win["commits"][1]
    # Began before load 1's reply: the older generation is allowed.
    win["fetches"].append(("status", c1["returned"] - 1e-6, c1["returned"] + 0.05, 2, True,
                           True))
    assert stale_frames(win, 3) == 0
    win["fetches"].append(("status", c1["returned"] + 1e-6, c1["returned"] + 0.05, 2, True,
                           False))
    assert stale_frames(win, 3) == 1
    win["commits"][2]["frame_idle"] = False
    assert stale_frames(win, 3) == 2
    assert stale_frames(win, 4) == 1 + 3


def test_a_viewer_run_loads_no_jax():
    """As ``test_a_run_loads_no_jax``, through the server driver."""
    code = (
        "import sys\n"
        "from portbench import run\n"
        "from portbench.tests import test_portbench_server as t\n"
        "class Patch:\n"
        "    def setattr(self, obj, name, value):\n"
        "        setattr(obj, name, value)\n"
        f"out = t._cpu_run(Patch(), {CELLS[0]!r}, seconds=4.0)\n"
        "assert out['correct'], out\n"
        "assert 'ice_halo_sim_tpu_torch' in sys.modules\n"
        "print(run.forbidden_modules())\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
