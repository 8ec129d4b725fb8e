"""The stand-ins for the reference bench scenes (``scenes.py``: MULTI_CFG,
COMPLEX_CFG, BD_CFG, PYRAMID3_CFG) in both packages, and the port's bench
matrix (``python -m ice_halo_sim_tpu_torch.bench_matrix``) on the CPU.

Each stand-in loads through both packages' ``load_project`` and renders at a
small size (64 x 32, 2048 rays a batch; 512 for the three-layer pyramid,
whose fan-out makes a root ray about 100 times the work) in both engines,
with IHT_MIN_EMIT_W=0 and IHT_SLOT_CAP=off (the two trace paths differ
there on purpose) and one batch each. Tolerances are PERF.md §2's:

- The first layer exactly: the scene cut to its first layer (a last layer
  with prob > 0 drops the exits that would continue, so the cut image is the
  first layer's part of the whole scene's). Every stand-in holds a
  stochastic shape (MS_CFG's Gaussian column; the pyramid), so segments
  within EDGE_SEGMENTS and at most EDGE_PIXELS pixels outside rtol 1e-4 /
  atol 1e-6 of the maximum (the last bit of log and cos in the shape
  sampler, of the projection); landed weight and image sum rtol 1e-5.
- The later layers statistically, as tests/test_torch_multilayer.py holds
  them: the continuation's block sort breaks ties otherwise than the JAX
  one (whose sort is unstable), so up to TIE_RAYS rays may swap lanes. A
  swapped ray carries at most the largest initial weight, and its subtree
  at most max_hits segments a later layer (max_hits + max_hits^2 with three
  layers). Images after an 8 x 8 box sum to rtol 1e-3 with that allowance.
"""

import copy
import json

import numpy as np
import pytest
import torch

from ice_halo_sim_tpu.config.loader import load_project as jax_load_project
from ice_halo_sim_tpu.config.schema import ComplexFilter as JComplexFilter
from ice_halo_sim_tpu.engine.simulator import Engine as JEngine
from ice_halo_sim_tpu_torch import bench_matrix, scenes
from ice_halo_sim_tpu_torch.config.loader import load_project
from ice_halo_sim_tpu_torch.config.schema import (ComplexFilter, CrystalFilter,
                                                  EntryExitFilter, RaypathFilter, Symmetry)
from ice_halo_sim_tpu_torch.engine.simulator import Engine

# Tier-1 runs six workers; keep each one to two torch threads.
torch.set_num_threads(2)

STAND_INS = ("MULTI_CFG", "COMPLEX_CFG", "BD_CFG", "PYRAMID3_CFG")
RES = (64, 32)
SUM_RTOL = 1e-5
PIX_RTOL, PIX_ATOL_FRAC = 1e-4, 1e-6
EDGE_PIXELS, EDGE_SEGMENTS = 8, 8
TIE_RAYS = 16
MATRIX_FIELDS = {
    "scene", "stand_in", "resolution", "batch_size", "batch_decision", "rays_per_rep",
    "reps", "median_rays_per_sec", "cov", "platform", "card", "fold", "fold_decision",
    "trace_path", "graph_mode", "host_reads_per_dispatch", "vs_baseline_cpu"}


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    for k, v in {"IHT_MIN_EMIT_W": "0", "IHT_SLOT_CAP": "off", "IHT_PALLAS_TRACE": "0",
                 "IHT_FOLD": "sort", "IHT_STEPS_PER_DISPATCH": "1"}.items():
        monkeypatch.setenv(k, v)


def _doc(name, first_layer_only=False):
    doc = copy.deepcopy(getattr(scenes, name))
    for r in doc["render"]:
        r["resolution"] = list(RES)
    if first_layer_only:
        doc["scene"]["scattering"] = doc["scene"]["scattering"][:1]
    return doc


def _engines(name, first_layer_only=False):
    """Both engines after one batch of the same rays."""
    doc = _doc(name, first_layer_only)
    batch = 512 if name == "PYRAMID3_CFG" else 2048
    t = Engine(load_project(doc), seed=7, batch_size=batch, device="cpu")
    j = JEngine(jax_load_project(doc), seed=7, batch_size=batch, accum_method="sort")
    assert [l.cont_cap for l in t.layers] == [l.cont_cap for l in j.layers]
    assert t.trace_path == "plain-torch (general)"
    for eng in (t, j):
        eng.run(n_batches=1)
    return t, j


def _box(img, k=8):
    h, w, c = img.shape
    return img.reshape(h // k, k, w // k, k, c).sum(axis=(1, 3))


@pytest.mark.parametrize("name", STAND_INS)
def test_stand_in_loads_in_both_packages(name):
    """What each stand-in holds (scenes.py's docstring), read back through
    both packages' load_project."""
    doc = getattr(scenes, name)
    cfg, jcfg = load_project(copy.deepcopy(doc)), jax_load_project(copy.deepcopy(doc))
    layers = cfg.scene.layers
    assert [l.prob for l in layers] == [l.prob for l in jcfg.scene.layers]
    assert sorted(cfg.crystals) == sorted(jcfg.crystals)
    assert cfg.renders[0].resolution == (512, 256) and len(cfg.renders) == 1
    assert cfg.light.sun.altitude == 20.0 and cfg.light.illuminant is not None
    assert doc["render"] == scenes.BENCH_CFG["render"]
    if name == "PYRAMID3_CFG":
        assert [l.prob for l in layers] == [0.8, 0.75, 0.0] and cfg.scene.max_hits == 14
        assert [[(e.crystal_id, e.proportion) for e in l.entries] for l in layers] == \
            [[(1, 70), (2, 30)]] * 3
        assert doc["crystal"][0] == scenes.POOL_CFG["crystal"][0]
        assert doc["crystal"][1] == scenes.MS_CFG["crystal"][1]
        return
    assert [l.prob for l in layers] == [0.5, 0.0] and cfg.scene.max_hits == 7
    assert [[(e.crystal_id, e.proportion) for e in l.entries] for l in layers] == \
        [[(1, 40), (2, 30), (3, 30)]] * 2
    assert doc["crystal"][:2] == scenes.MS_CFG["crystal"]
    assert {k: v for k, v in doc["crystal"][2].items() if k != "id"} == \
        {k: v for k, v in scenes.BENCH_CFG["crystal"][0].items() if k != "id"}
    fids = {e.filter_id for l in layers for e in l.entries}
    if name == "MULTI_CFG":
        assert fids == {0} and not cfg.filters
    elif name == "BD_CFG":
        f = cfg.filters[fids.pop()]
        assert f.param == RaypathFilter(raypath=(3, 5)) and f.symmetry == Symmetry.B | Symmetry.D
    else:
        f = cfg.filters[fids.pop()]
        assert f.param == ComplexFilter(composition=((1, 2), (3,)))
        assert jcfg.filters[f.id].param == JComplexFilter(composition=((1, 2), (3,)))
        raypath, crystal, ee = (cfg.filters[i] for i in (1, 2, 3))
        assert raypath.param == RaypathFilter(raypath=(3, 5)) and raypath.symmetry == Symmetry.P
        assert crystal.param == CrystalFilter(crystal_id=1)
        assert ee.param == EntryExitFilter(entry=1, exit=3) and ee.symmetry == Symmetry.P


@pytest.mark.parametrize("name", STAND_INS)
def test_stand_in_first_layer_matches_jax(name):
    """The scene cut to its first layer: segments, landed weight, image sum
    and pixels within the exact tolerances."""
    t, j = _engines(name, first_layer_only=True)
    ts, js = t.drain_stats(), j.drain_stats()
    assert ts.rays_traced == js.rays_traced
    assert ts.stochastic_crystal_samples == js.stochastic_crystal_samples > 0
    assert abs(ts.ray_segments - js.ray_segments) <= EDGE_SEGMENTS
    np.testing.assert_allclose(ts.landed_weight, js.landed_weight, rtol=SUM_RTOL)
    a, b = t.raw_xyz(0), np.asarray(j.raw_xyz(0))
    assert b.max() > 0
    np.testing.assert_allclose(a.sum(), b.sum(), rtol=SUM_RTOL)
    tol = PIX_RTOL * np.abs(b) + PIX_ATOL_FRAC * float(np.abs(b).max())
    assert int((np.abs(a - b) > tol).any(-1).sum()) <= EDGE_PIXELS


@pytest.mark.parametrize("name", STAND_INS)
def test_stand_in_layers_match_jax(name):
    """The whole scene: rays and samples exact; segments, landed and dropped
    weight, and the 8 x 8 box sums within TIE_RAYS swapped rays."""
    t, j = _engines(name)
    H = t.max_hits
    per_ray = H + (H * H if len(t.layers) > 2 else 0)
    ts, js = t.drain_stats(), j.drain_stats()
    w_ray = float(t._w0_tbl.max())
    assert (ts.rays_traced, ts.stochastic_crystal_samples,
            ts.stochastic_orientation_samples) == (
        js.rays_traced, js.stochastic_crystal_samples, js.stochastic_orientation_samples)
    assert abs(ts.ray_segments - js.ray_segments) <= TIE_RAYS * per_ray
    assert abs(ts.landed_weight - js.landed_weight) <= \
        SUM_RTOL * js.landed_weight + TIE_RAYS * w_ray
    assert abs(ts.dropped_cont_weight - js.dropped_cont_weight) <= \
        1e-6 * js.landed_weight + TIE_RAYS * w_ray
    a, b = _box(t.raw_xyz(0)), _box(np.asarray(j.raw_xyz(0)))
    assert b.max() > 0
    np.testing.assert_allclose(a.sum(), b.sum(), rtol=1e-4)
    np.testing.assert_allclose(a, b, rtol=1e-3, atol=TIE_RAYS * w_ray * float(t.basis_tbl.max()))


def test_bench_matrix_quick_line(monkeypatch, capsys):
    """`--quick` on the CPU: one JSON line for light at 512 x 256, one
    repetition, with every field of a cell."""
    monkeypatch.delenv("IHT_PALLAS_TRACE")
    monkeypatch.setenv("IHT_STEPS_PER_DISPATCH", "2")
    rc = bench_matrix.main(["--quick", "--device", "cpu", "--batch", "4096",
                            "--rep-seconds", "0.1"])
    assert rc == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    cell = json.loads(lines[0])
    assert MATRIX_FIELDS <= set(cell)
    assert cell["scene"] == "light" and cell["stand_in"] is False
    assert cell["resolution"] == [512, 256] and cell["batch_size"] == 4096
    assert cell["batch_decision"] == "requested" and cell["reps"] == 1
    assert cell["rays_per_rep"] % (2 * 4096) == 0 and cell["median_rays_per_sec"] > 0
    assert cell["cov"] == 0.0 and cell["platform"] == "cpu" and cell["card"] is None
    assert cell["card_after_reps"] is None
    assert cell["fold"] == "sort" and cell["trace_path"] == "plain-torch"
    assert cell["graph_mode"] == "eager (graphs off)" and cell["host_reads_per_dispatch"] == 1.0
    assert cell["vs_baseline_cpu"] == cell["median_rays_per_sec"] / bench_matrix.BASELINE_CPU_LIGHT


@pytest.mark.parametrize("error", ["out of memory", "another error"])
def test_bench_matrix_halves_only_on_out_of_memory(monkeypatch, error):
    """The JAX script's rule: the batch halves after an out-of-memory error
    (recorded in batch_decision); any other error raises."""
    tried = []

    def run_cell(scene, res, batch, *a):
        tried.append(batch)
        if error == "another error":
            raise RuntimeError("index out of range")
        if batch > 60000:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2 GiB")
        return {"scene": scene, "batch_size": batch}

    monkeypatch.setattr(bench_matrix, "run_cell", run_cell)
    args = ("pyramid", (512, 256), 229376, 5, 2.0, "cpu")
    if error == "another error":
        with pytest.raises(RuntimeError, match="index out of range"):
            bench_matrix.measure_cell(*args)
        assert tried == [229376]
        return
    cell = bench_matrix.measure_cell(*args)
    assert tried == [229376, 114688, 57344] and cell["batch_size"] == 57344
    assert cell["batch_decision"] == ("measured fit: halved from 229376 after 2 "
                                      "out-of-memory error(s)")
