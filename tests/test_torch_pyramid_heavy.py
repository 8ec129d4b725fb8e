"""The pyramid-heavy three-layer scene (the benchmark's ``pyramid_heavy_ms3``:
three layers of a stochastic pyramid and a column at 70 / 30, max_hits 14)
on the port's general trace path, held against its plain reference
(``portbench/reference/mixed_layers.py``) on the CPU.

The port's Engine at batch 1024, 128 x 64, two batches a dispatch, runs the
benchmark's set-up (a calibrating batch, then one dispatch); the reference
works the same batches out again from the configuration, the seed and the
batch index, and ``oracle.compare`` holds the port's image, landed and
dropped weights and traced segments against it, to the cell's limits but
the one the CPU's plain scan sets (below). The reference one precision
lower, and a port with a planted fault, must come out not correct; the
reference's lane blocks must give the rows of one block.

    python -m pytest tests/test_torch_pyramid_heavy.py -q -p no:cacheprovider
"""

import copy
import json
import os

import pytest
import torch

from ice_halo_sim_tpu_torch.config.loader import load_project
from ice_halo_sim_tpu_torch.engine import simulator
from ice_halo_sim_tpu_torch.engine.simulator import Engine
from portbench.reference import mixed_layers, oracle
from portbench.reference.plain.config.loader import load_project as ref_load

# Tier-1 runs six workers; keep each one to two torch threads.
torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 1024
STEPS = 2
SEEDS = [7, 3100000019]


def _load(*parts):
    with open(os.path.join(ROOT, "portbench", *parts)) as f:
        return json.load(f)


DOC = _load("configs", "pyramid_heavy_ms3.json")["document"]
DOC["render"][0]["resolution"] = [128, 64]
# The cell's limits, but one: the CPU's plain scan takes a pixel's sum as a
# difference of float64 running sums, some dozens of float32 ulps off on the
# dimmest pixels (the card's scan kernel: 0 ulps).
LIMITS = dict(_load("workloads", "pyramid_heavy.r512.json")["limits"], image_gap_ulp=1000.0)

# Per seed, the reference scene (its batches traced once, then kept) and the
# port's record after its set-up: the tests of one file share a worker.
_RUNS = {}


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("IHT_STEPS_PER_DISPATCH", str(STEPS))
    for knob in ("IHT_PALLAS_TRACE", "IHT_SLOT_CAP", "IHT_MIN_EMIT_W"):
        monkeypatch.delenv(knob, raising=False)


def _record(eng):
    images = [torch.from_numpy(eng.raw_xyz(r).reshape(-1, 3).copy())
              for r in range(len(eng.proj_plans))]
    st = eng.drain_stats()
    return {"images": images, "counter": eng.batch_counter, "segments": st.ray_segments,
            "landed": st.landed_weight, "dropped": st.dropped_cont_weight}


def _port(seed, dispatch=True):
    """The port's set-up (a calibrating batch, then one dispatch unless
    `dispatch` is False): (engine, record)."""
    eng = Engine(load_project(copy.deepcopy(DOC)), seed=seed, batch_size=B, device="cpu")
    eng.run(n_batches=1)
    if dispatch:
        eng.run(n_batches=STEPS)
    return eng, _record(eng)


def _scene(seed):
    """The reference's scene whose batch_rows keeps every batch it traced."""
    scene = mixed_layers.Scene(ref_load(copy.deepcopy(DOC)), seed, B, "cpu")
    traced = {}
    real = scene.batch_rows

    def batch_rows(c):
        if c not in traced:
            traced[c] = real(c)
        return traced[c]

    scene.batch_rows = batch_rows
    return scene


def _run(seed):
    if seed not in _RUNS:
        eng, rec = _port(seed)
        _RUNS[seed] = (eng, rec, _scene(seed))
    return _RUNS[seed]


def _compare(scene, rec, control=""):
    zeros = {"images": [torch.zeros_like(t) for t in rec["images"]], "segments": 0,
             "landed": 0.0, "dropped": 0.0}
    checks, _bad, _ref, _numbers = oracle.compare(
        [(scene, range(0, rec["counter"]), zeros, rec)], LIMITS, control)
    return checks


def _correct(checks) -> bool:
    return all(v <= lim for v, lim in checks.values())


@pytest.mark.parametrize("seed", SEEDS)
def test_the_port_lands_on_the_reference(seed):
    eng, rec, scene = _run(seed)
    assert eng.trace_path == "plain-torch (general)" and eng.fold_kind == "sort"
    checks = _compare(scene, rec)
    assert _correct(checks), checks
    assert checks["segments_off"][0] == 0
    # The calibration and the plan, worked out apart: the slot cap, every
    # layer's lanes, each setting's lanes and pool shapes.
    assert eng._slot_cap == scene.slot_cap < eng.max_hits
    assert [l.cont_cap for l in eng.layers] == [l.lanes for l in scene.layers]
    assert [(l.setting_counts, l.k_per_setting) for l in eng.layers] == [
        ([s.lanes for s in l.settings], [s.k for s in l.settings]) for l in scene.layers]
    assert eng.overflow_replays == 0
    assert all(s.lanes > 0 and s.k == s.lanes // 32 for l in scene.layers for s in l.settings)
    # Layer 3 traces tens of lanes a root ray, none of the continuations lost.
    live = [scene.cont_live[c] for c in range(1, 1 + STEPS)]
    assert all(n2 > 20 * B and n2 <= scene.layers[2].lanes for _n1, n2 in live)


def test_the_bfloat16_control_is_not_correct():
    _eng, rec, scene = _run(SEEDS[1])
    checks = _compare(scene, rec, control="reference_bf16")
    assert not _correct(checks)
    assert checks["image_gap_l1"][0] > 10 * LIMITS["image_gap_l1"]
    assert checks["image_gap_ulp"][0] > 10 * LIMITS["image_gap_ulp"]


def test_a_wrong_setting_segment_is_not_correct(monkeypatch):
    """The port's lanes of a layer split one block of 32 lanes off: the
    pyramid's segment one block short, the column's one block long. Its
    calibrating batch is held against the reference's."""
    real = simulator.largest_remainder_partition

    def shifted(total, proportions):
        out = real(total, proportions)
        if len(out) == 2 and out[0] > 1:
            out = [out[0] - 1, out[1] + 1]
        return out

    _eng, _rec, scene = _run(SEEDS[1])
    monkeypatch.setattr(simulator, "largest_remainder_partition", shifted)
    eng, rec = _port(SEEDS[1], dispatch=False)
    assert eng.layers[0].setting_counts[0] == scene.layers[0].settings[0].lanes - 32
    assert not _correct(_compare(scene, rec))


def _sorted_rows(rows):
    out = []
    for pix, w, wl in rows:
        order = torch.argsort(pix * (1 << 40) + w.view(torch.int32).long() * 64 + wl,
                              stable=True)
        out.append((pix[order], w[order], wl[order]))
    return out


def test_lane_blocks_give_the_rows_of_one_block(monkeypatch):
    """A calibrated batch traced in blocks of 512 lanes (16 shapes) gives the
    rows, the segments and the continuation counts of one block a setting;
    the float64 sums agree to their rounding."""
    _eng, _rec, scene = _run(SEEDS[0])
    whole = scene.batch_rows(1)
    monkeypatch.setattr(mixed_layers, "LANE_BLOCK", 512)
    small = mixed_layers.Scene(ref_load(copy.deepcopy(DOC)), SEEDS[0], B, "cpu")
    small.slot_cap, small.layers = scene.slot_cap, scene._steady
    small._steady = scene._steady
    blocks = [list(small._blocks(layer)) for layer in small.layers]
    assert [len(b) for b in blocks] == [3, 33, 129]
    assert all(n <= 512 for b in blocks for _s, _a, n, _r, _k in b)
    blocked = small.batch_rows(1)
    for a, b in zip(_sorted_rows(whole[0]), _sorted_rows(blocked[0])):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    assert blocked[3] == whole[3]
    assert small.cont_live[1] == scene.cont_live[1]
    for x, y in zip(blocked[1], whole[1]):
        assert x == pytest.approx(y, rel=1e-12)
    assert blocked[2] == pytest.approx(whole[2], rel=1e-9, abs=1e-12)


@pytest.mark.parametrize("change", ["filter", "colour", "one_layer_one_setting"])
def test_the_reference_refuses_what_it_does_not_cover(change):
    doc = copy.deepcopy(DOC)
    layers = doc["scene"]["scattering"]
    if change == "filter":
        doc["filter"] = [{"id": 1, "type": "raypath", "raypath": [3, 5], "symmetry": "P",
                          "action": "filter_in"}]
        layers[1]["entries"][0]["filter"] = 1
    elif change == "colour":
        doc["raypath_color"] = {"mode": "dominant", "classes": [
            {"name": "35", "color": [1.0, 0.3, 0.2],
             "match": [{"crystal": 1, "raypath": [3, 5], "symmetry": "P"}]}]}
    else:
        doc["scene"]["scattering"] = [dict(layers[2], entries=layers[2]["entries"][:1])]
    with pytest.raises(NotImplementedError, match="layers of any settings"):
        mixed_layers.Scene(ref_load(doc), SEEDS[0], B, "cpu")
