"""Two-layer full scattering (the benchmark's ``light_two_layer_ms``) on the
port's general trace path, held against the benchmark's plain reference of
that path (``portbench/reference/two_layer.py``) on the CPU.

The port's Engine at batch 4096 runs the benchmark's set-up (a calibrating
batch, then one dispatch) and one dispatch more; the reference works the
same batches out again from the configuration, the seed and the batch index
and ``oracle.compare`` holds the port's images, landed and dropped weights
and traced segments against it over both spans, to the cell's limits but
one that the CPU's plain scan sets (below). The reference one precision
lower, and a port with a planted fault, must come out not correct.

    python -m pytest tests/test_torch_two_layer.py -q -p no:cacheprovider
"""

import copy
import json
import os

import pytest
import torch

from ice_halo_sim_tpu_torch.config.loader import load_project
from ice_halo_sim_tpu_torch.engine import simulator
from ice_halo_sim_tpu_torch.engine.simulator import Engine
from portbench.reference import oracle, two_layer
from portbench.reference.plain.config.loader import load_project as ref_load

# Tier-1 runs six workers; keep each one to two torch threads.
torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 4096
STEPS = 3
SEEDS = [7, 3000000019, 4000000007]


def _load(*parts):
    with open(os.path.join(ROOT, "portbench", *parts)) as f:
        return json.load(f)


DOC = _load("configs", "light_two_layer_ms.json")["document"]
# The cell's limits, but one: the CPU's plain scan takes a pixel's sum as a
# difference of float64 running sums, some dozens of float32 ulps off on the
# dimmest pixels (the card's scan kernel: 0 ulps). The benchmark's CPU runs
# read that gap to 1000 ulps.
LIMITS = dict(_load("workloads", "light_two_layer.r512.json")["limits"], image_gap_ulp=1000.0)


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


def _compare(seed, port_doc=DOC, control=""):
    """The port's set-up and one dispatch against the reference, as the
    benchmark's engine driver compares them. Returns (checks, engine,
    reference scene)."""
    eng = Engine(load_project(copy.deepcopy(port_doc)), seed=seed, batch_size=B, device="cpu")
    eng.run(n_batches=1)
    eng.run(n_batches=STEPS)
    first = _record(eng)
    eng.run(n_batches=STEPS)
    second = _record(eng)
    scene = two_layer.Scene(ref_load(copy.deepcopy(DOC)), seed, B, "cpu")
    zeros = {"images": [torch.zeros_like(t) for t in first["images"]], "segments": 0,
             "landed": 0.0, "dropped": 0.0}
    spans = [(scene, range(0, first["counter"]), zeros, first),
             (scene, range(first["counter"], second["counter"]), first, second)]
    checks, _bad, _ref, _numbers = oracle.compare(spans, LIMITS, control)
    return checks, eng, scene


def _correct(checks) -> bool:
    return all(v <= lim for v, lim in checks.values())


@pytest.mark.parametrize("seed", SEEDS)
def test_the_port_lands_on_the_reference(seed):
    checks, eng, scene = _compare(seed)
    assert eng.trace_path == "plain-torch (general)" and eng.fold_kind == "sort"
    assert _correct(checks), checks
    assert checks["segments_off"][0] == 0
    # The calibration: the same slot cap and lanes, worked out apart.
    assert eng._slot_cap == scene.slot_cap < eng.max_hits
    assert [l.cont_cap for l in eng.layers] == [l.lanes for l in scene.layers]
    assert eng.overflow_replays == 0
    # Layer 2 traces some five lanes a root ray, every one of them live.
    live = [n for c in range(1, 1 + 2 * STEPS) for n in scene.cont_live[c]]
    assert all(4 * B < n <= scene.layers[1].lanes for n in live)


def test_the_bfloat16_control_is_not_correct():
    checks, _eng, _scene = _compare(SEEDS[1], control="reference_bf16")
    assert not _correct(checks)
    assert checks["image_gap_l1"][0] > 10 * LIMITS["image_gap_l1"]
    assert checks["image_gap_ulp"][0] > 10 * LIMITS["image_gap_ulp"]


def _salt_changed(monkeypatch):
    """The continuation key's hash salted otherwise: the layer-2 lanes take
    the exits in another order."""
    real = simulator.shuffle_hash
    monkeypatch.setattr(simulator, "shuffle_hash",
                        lambda n, layer_seed, counter, device:
                        real(n, layer_seed ^ 0x1, counter, device))
    return DOC


def _second_axis(monkeypatch):
    """Layer 2 given a crystal whose axis stays near the zenith."""
    doc = copy.deepcopy(DOC)
    other = copy.deepcopy(doc["crystal"][0])
    other["id"] = 2
    other["axis"]["zenith"] = {"type": "gauss", "mean": 0.0, "std": 1.0}
    doc["crystal"].append(other)
    doc["scene"]["scattering"][1]["entries"][0]["crystal"] = 2
    return doc


@pytest.mark.parametrize("fault", [_salt_changed, _second_axis])
def test_a_planted_fault_is_not_correct(fault, monkeypatch):
    checks, _eng, _scene = _compare(SEEDS[2], port_doc=fault(monkeypatch))
    assert not _correct(checks), checks


@pytest.mark.parametrize("change", ["filter", "two_settings", "one_layer"])
def test_the_reference_refuses_what_it_does_not_cover(change):
    doc = copy.deepcopy(DOC)
    layers = doc["scene"]["scattering"]
    if change == "filter":
        doc["filter"] = [{"id": 1, "type": "raypath", "raypath": [3, 5], "symmetry": "P",
                          "action": "filter_in"}]
        layers[1]["entries"][0]["filter"] = 1
    elif change == "two_settings":
        layers[1]["entries"].append({"crystal": 1, "proportion": 5})
    else:
        doc["scene"]["scattering"] = layers[1:]
    with pytest.raises(NotImplementedError, match="several layers"):
        two_layer.Scene(ref_load(doc), SEEDS[0], B, "cpu")
