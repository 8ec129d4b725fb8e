"""The slice end to end: the port's Engine (CPU, plain twins) against the
JAX Engine on bench.py's BENCH_CFG, seed 7, batch 4096, three batches (one
full fold before calibration, then two calibrated premerged folds).

The JAX side runs its XLA trace path with the emit floor and slot cap off
(scripts/make_torch_port_ref.py), which tests/test_pallas_trace.py holds
equal to its trace megakernel; one module-scoped JAX run serves every
comparison here and re-checks the committed fixture.

Tolerances: integer stats (traced segments, rays) exact; image sum and
landed weight rtol 1e-5 (the folds sum in other orders); per pixel rtol
1e-4 with atol 1e-6 of the image maximum (the JAX package's own kernel-vs-
XLA parity tolerance, tests/test_pallas_trace.py).

Stochastic crystal shapes (the blocked-pool trace mode) have a budget
besides: the sampled heights go through log and cos, which XLA and torch
round differently in the last bit, so a ray at a face edge or at the TIR
limit may flip. Segments may differ by FLIP_SEGMENTS and at most
FLIP_PIXELS pixels may fall outside the per-pixel tolerance, each by no
more than one ray's weight (a flipped ray moves its rows, it adds no mass).
"""

import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

from bench import BENCH_CFG
from ice_halo_sim_tpu.config.loader import load_project as jax_load_project
from ice_halo_sim_tpu_torch import scenes
from ice_halo_sim_tpu_torch.config.loader import load_project
from ice_halo_sim_tpu_torch.engine.checkpoint import load_jax_checkpoint
from ice_halo_sim_tpu_torch.engine.simulator import DEFAULT_GEOM_CLOCK, Engine

# Tier-1 runs six workers; keep each one to two torch threads.
torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUM_RTOL = 1e-5
PIX_RTOL, PIX_ATOL_FRAC = 1e-4, 1e-6


def _ref_module():
    spec = importlib.util.spec_from_file_location(
        "make_torch_port_ref", os.path.join(ROOT, "scripts", "make_torch_port_ref.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    mod = _ref_module()
    ckpt = str(tmp_path_factory.mktemp("ckpt") / "after2.npz")
    with pytest.MonkeyPatch.context() as mp:
        for k, v in mod.ENV.items():
            mp.setenv(k, v)
        ref = mod.jax_reference(ckpt_path=ckpt)
    return ref, ckpt, mod


@pytest.fixture(autouse=True)
def _port_env(monkeypatch):
    monkeypatch.setenv("IHT_MIN_EMIT_W", "0")


def _assert_image_close(img, ref):
    np.testing.assert_allclose(img.sum(), ref.sum(), rtol=SUM_RTOL)
    np.testing.assert_allclose(img, ref, rtol=PIX_RTOL,
                               atol=PIX_ATOL_FRAC * float(np.abs(ref).max()))


def test_fixture_is_current(jax_run):
    ref, _, mod = jax_run
    fix = np.load(mod.OUT)
    for k in ("ray_segments", "rays_traced", "seed", "batch_size", "n_batches"):
        assert int(fix[k]) == int(ref[k]), k
    np.testing.assert_allclose(float(fix["landed_weight"]), float(ref["landed_weight"]),
                               rtol=1e-6)
    np.testing.assert_allclose(fix["raw_xyz"], ref["raw_xyz"], rtol=1e-6,
                               atol=1e-6 * float(ref["raw_xyz"].max()))


def test_engine_matches_jax_engine(jax_run):
    ref = jax_run[0]
    eng = Engine(load_project(BENCH_CFG), seed=7, batch_size=4096, device="cpu")
    assert eng.trace_path == "plain-torch" and eng.fold_kind == "sort"
    eng.run(n_batches=1)
    assert eng._compact_keep == (24576,)
    eng.run(n_batches=2)
    st = eng.drain_stats()
    # The calibration read, then one read per dispatch (the first
    # overflowing batch): run(n_batches=2) is one dispatch of two batches.
    assert eng.host_syncs == 2
    assert st.rays_traced == int(ref["rays_traced"])
    assert st.ray_segments == int(ref["ray_segments"])
    np.testing.assert_allclose(st.landed_weight, float(ref["landed_weight"]),
                               rtol=SUM_RTOL)
    _assert_image_close(eng.raw_xyz(0), ref["raw_xyz"])
    img = eng.snapshot()[0]
    assert img.shape == (256, 512, 3) and img.dtype == np.uint8 and img.max() > 0


def test_resume_jax_checkpoint(jax_run):
    ref, ckpt, _ = jax_run
    eng = load_jax_checkpoint(ckpt, device="cpu")
    assert eng.batch_counter == 2
    eng.run(n_batches=1)
    st = eng.drain_stats()
    assert st.ray_segments == int(ref["ray_segments"])
    assert st.rays_traced == int(ref["rays_traced"])
    np.testing.assert_allclose(st.landed_weight, float(ref["landed_weight"]),
                               rtol=SUM_RTOL)
    _assert_image_close(eng.raw_xyz(0), ref["raw_xyz"])


def test_exact_ray_budget_tail_batch():
    eng = Engine(load_project(BENCH_CFG), seed=7, batch_size=4096, device="cpu")
    st = eng.run(total_rays=5000)
    assert st.rays_traced == 5000 and eng.batch_counter == 2
    full = Engine(load_project(BENCH_CFG), seed=7, batch_size=4096, device="cpu")
    full.run(n_batches=2)
    # The tail batch traces only its first 904 lanes.
    assert 0 < eng.drain_stats().landed_weight < full.drain_stats().landed_weight


def test_kernel_choice_and_scene_refusals():
    """What the trace kernel refuses (the JAX build_plan's reasons) takes the
    general trace path; nothing of it raises any more."""
    cfg = load_project(BENCH_CFG)
    with pytest.raises(ValueError):
        Engine(cfg, batch_size=4096, device="cpu", kernels="cuda")
    with pytest.raises(ValueError):
        Engine(cfg, batch_size=4096, device="cpu", accum_method="sandwich")
    general = "plain-torch (general)"
    doc = dict(BENCH_CFG)
    doc["render"] = [dict(BENCH_CFG["render"][0], lens={"type": "rectangular", "fov": 360.0})]
    eng = Engine(load_project(doc), batch_size=4096, device="cpu")
    assert eng.trace_path == general
    assert eng._kernel_reason == "lens type needs inverse trig (no Mosaic lowering)"
    doc = dict(BENCH_CFG)
    doc["render"] = [dict(BENCH_CFG["render"][0], lens={"type": "linear", "fov": 90.0})]
    assert Engine(load_project(doc), batch_size=4096, device="cpu").trace_path == "plain-torch"
    doc = dict(BENCH_CFG)
    doc["scene"] = dict(BENCH_CFG["scene"], scattering=[
        {"prob": 0.5, "entries": [{"crystal": 1, "proportion": 10}]},
        {"prob": 0.0, "entries": [{"crystal": 1, "proportion": 10}]}])
    eng = Engine(load_project(doc), batch_size=4096, device="cpu")
    assert eng.trace_path == general and eng._kernel_reason.startswith("multi-layer scattering")
    eng = Engine(cfg, batch_size=5000, device="cpu")
    assert eng.trace_path == general and "not a multiple of 2048" in eng._kernel_reason
    assert eng.batch_size == 5024                   # whole geom-clock blocks of 32
    assert Engine(cfg, batch_size=4096, device="cpu",
                  accum_method="scatter").fold_kind == "scatter"


def test_cli_writes_png(tmp_path):
    import json

    from ice_halo_sim_tpu_torch import cli

    path = tmp_path / "bench.json"
    doc = dict(BENCH_CFG)
    doc["render"] = [dict(BENCH_CFG["render"][0], resolution=[128, 64])]
    path.write_text(json.dumps(doc))
    rc = cli.main([str(path), "-o", str(tmp_path), "--ray-num", "4096",
                   "--device", "cpu", "--seed", "3"])
    assert rc == 0
    png = tmp_path / "bench_render1.png"
    assert png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert "jax" in sys.modules  # this test module imports JAX; the port does not


def test_discrete_spectrum_matches_jax_engine(monkeypatch):
    """A 4-line discrete spectrum (the trace kernel's other wavelength
    mode: wl index = ray index mod 4), one batch, against the JAX engine's
    XLA path."""
    import copy

    from ice_halo_sim_tpu.engine.simulator import Engine as JEngine

    doc = copy.deepcopy(BENCH_CFG)
    doc["scene"]["light_source"] = {
        "type": "sun", "altitude": 20.0,
        "spectrum": [{"wavelength": w, "weight": 1.0 + i}
                     for i, w in enumerate([450.0, 500.0, 550.0, 600.0])]}
    cfg = load_project(doc)
    monkeypatch.setenv("IHT_PALLAS_TRACE", "0")
    monkeypatch.setenv("IHT_SLOT_CAP", "off")
    j = JEngine(jax_load_project(doc), seed=5, batch_size=4096, accum_method="sort")
    j.run(n_batches=1)
    jst = j.drain_stats()
    monkeypatch.delenv("IHT_PALLAS_TRACE")          # the port reads the same knob
    t = Engine(cfg, seed=5, batch_size=4096, device="cpu")
    assert t.trace_path == "plain-torch"
    t.run(n_batches=1)
    tst = t.drain_stats()
    assert tst.ray_segments == jst.ray_segments
    np.testing.assert_allclose(tst.landed_weight, jst.landed_weight, rtol=SUM_RTOL)
    _assert_image_close(t.raw_xyz(0), j.raw_xyz(0))


# --------------------------------------------------------------------------
# Stochastic crystal shapes: the blocked-pool trace mode
# --------------------------------------------------------------------------

FLIP_SEGMENTS = 8
FLIP_PIXELS = 8


def _stochastic_doc(kind):
    """The inline scene of tests/test_pallas_trace.py (_stochastic_cfg)."""
    return _ref_module().stochastic_doc(kind)


def _assert_image_close_flips(img, ref, ray_weight):
    """Per-pixel tolerance with the flipped-ray budget; returns the count
    of pixels outside the tolerance."""
    np.testing.assert_allclose(img.sum(), ref.sum(), rtol=SUM_RTOL)
    diff = np.abs(img - ref)
    off = (diff > PIX_RTOL * np.abs(ref) + PIX_ATOL_FRAC * float(np.abs(ref).max())).any(-1)
    assert int(off.sum()) <= FLIP_PIXELS, int(off.sum())
    # A flipped ray moves one ray's rows: no pixel is off by more than that.
    assert float(diff[off].max(initial=0.0)) <= ray_weight, diff[off].max()
    return int(off.sum())


def _ray_weight(eng):
    """Upper bound of one ray's contribution to a pixel channel."""
    w = eng._trace_plan
    w_max = float(max(np.max(w.spd, initial=0.0), np.max(w.wl_weights, initial=0.0)))
    return w_max * float(eng.basis_tbl.max()) * eng.max_hits


@pytest.mark.parametrize("kind", ["prism", "pyramid"])
def test_stochastic_engine_matches_jax_engine(monkeypatch, kind):
    """Batch 4096 x 2 against the JAX engine's XLA path at geom_clock 128
    (which tests/test_pallas_trace.py holds equal to its blocked-pool
    kernel)."""
    from ice_halo_sim_tpu.engine.simulator import Engine as JEngine

    doc = _stochastic_doc(kind)
    monkeypatch.setenv("IHT_PALLAS_TRACE", "0")
    monkeypatch.setenv("IHT_SLOT_CAP", "off")
    j = JEngine(jax_load_project(doc), seed=11, batch_size=4096, accum_method="sort",
                geom_clock=128)
    j.run(n_batches=2)
    jst = j.drain_stats()
    monkeypatch.delenv("IHT_PALLAS_TRACE")          # the port reads the same knob
    t = Engine(load_project(doc), seed=11, batch_size=4096, device="cpu")
    assert t.geom_clock == 128                      # moved from the default of 32
    plan = t._trace_plan
    assert (plan.pool_k, plan.gc) == (32, 128)
    assert (plan.nf, plan.n_tris) == ((8, 32) if kind == "prism" else (20, 80))
    t.run(n_batches=1)
    t.run(n_batches=1)
    tst = t.drain_stats()
    assert abs(tst.ray_segments - jst.ray_segments) <= FLIP_SEGMENTS
    assert tst.stochastic_crystal_samples == jst.stochastic_crystal_samples == 64
    assert tst.stochastic_orientation_samples == jst.stochastic_orientation_samples
    np.testing.assert_allclose(tst.landed_weight, jst.landed_weight, rtol=SUM_RTOL)
    _assert_image_close_flips(t.raw_xyz(0), j.raw_xyz(0), _ray_weight(t))


def test_geom_clock_auto_bump_and_pinned_refusal():
    cfg = load_project(_stochastic_doc("prism"))
    assert DEFAULT_GEOM_CLOCK == 32
    assert Engine(cfg, batch_size=4096, device="cpu").geom_clock == 128
    assert Engine(cfg, batch_size=4096, device="cpu", geom_clock=128).geom_clock == 128
    # A pinned clock is respected: the scene then takes the general path.
    eng = Engine(cfg, batch_size=4096, device="cpu", geom_clock=64)
    assert eng.geom_clock == 64 and eng.trace_path == "plain-torch (general)"
    assert eng._kernel_reason.startswith("stochastic crystal shape needs geom_clock == 128")
    assert eng.layers[0].k_per_setting == [64]
    # A deterministic shape keeps whatever clock it is given, and the batch
    # is rounded up to whole clock blocks.
    eng = Engine(load_project(BENCH_CFG), batch_size=6100, device="cpu", geom_clock=48)
    assert eng.geom_clock == 48 and eng._trace_plan.pool_k == 0
    assert eng.batch_size == 6144
    assert eng.stats.deterministic_crystal_count == 1


def test_port_scenes_match_bench_and_load():
    assert scenes.BENCH_CFG == BENCH_CFG
    cfg = load_project(scenes.POOL_CFG)
    assert len(cfg.renders) == 2 and not cfg.crystals[1].shape.is_deterministic()


@pytest.fixture(scope="module")
def pool_fixture():
    return np.load(os.path.join(ROOT, "tests", "data", "torch_port_pool_ref.npz"))


def test_pool_scene_matches_jax_fixture(pool_fixture):
    """POOL_CFG (a stochastic pyramid, NF = 20; two renders) at the
    fixture's small batch against the committed render of the JAX trace
    megakernel in blocked-pool mode (scripts/make_torch_port_ref.py)."""
    fix = pool_fixture
    eng = Engine(load_project(scenes.POOL_CFG), seed=int(fix["seed"]),
                 batch_size=int(fix["batch_size"]), device="cpu")
    eng.run(n_batches=1)
    assert eng._compact_keep is not None
    eng.run(n_batches=int(fix["n_batches"]) - 1)
    st = eng.drain_stats()
    assert st.rays_traced == int(fix["rays_traced"])
    assert st.stochastic_crystal_samples == int(fix["stochastic_crystal_samples"])
    assert abs(st.ray_segments - int(fix["ray_segments"])) <= FLIP_SEGMENTS
    np.testing.assert_allclose(st.landed_weight, float(fix["landed_weight"]),
                               rtol=SUM_RTOL)
    for r, key in enumerate(("raw_xyz", "raw_xyz_1")):
        _assert_image_close_flips(eng.raw_xyz(r), fix[key], _ray_weight(eng))


def test_pool_fixture_is_current(pool_fixture, monkeypatch):
    """The committed pool fixture against a live JAX run. The fixture came
    from the trace megakernel in the Pallas interpreter (many minutes for
    this scene); the live run takes the XLA trace path at geom_clock 128,
    which the JAX package's own tests hold equal to that kernel."""
    from ice_halo_sim_tpu.engine.simulator import Engine as JEngine

    fix = pool_fixture
    monkeypatch.setenv("IHT_PALLAS_TRACE", "0")
    monkeypatch.setenv("IHT_SLOT_CAP", "off")
    j = JEngine(jax_load_project(scenes.POOL_CFG), seed=int(fix["seed"]),
                batch_size=int(fix["batch_size"]), accum_method="sort", geom_clock=128)
    for _ in range(int(fix["n_batches"])):
        j.run(n_batches=1)
    st = j.drain_stats()
    assert st.ray_segments == int(fix["ray_segments"])
    assert st.stochastic_crystal_samples == int(fix["stochastic_crystal_samples"])
    np.testing.assert_allclose(st.landed_weight, float(fix["landed_weight"]), rtol=SUM_RTOL)
    for r, key in enumerate(("raw_xyz", "raw_xyz_1")):
        _assert_image_close(j.raw_xyz(r), fix[key])


def test_resume_jax_checkpoint_carries_geom_clock(tmp_path, monkeypatch):
    """A JAX checkpoint of a stochastic scene saves the raised geom_clock;
    the resumed port engine samples the same pool."""
    from ice_halo_sim_tpu.engine.checkpoint import save_checkpoint
    from ice_halo_sim_tpu.engine.simulator import Engine as JEngine

    doc = _stochastic_doc("prism")
    monkeypatch.setenv("IHT_PALLAS_TRACE", "0")
    monkeypatch.setenv("IHT_SLOT_CAP", "off")
    j = JEngine(jax_load_project(doc), seed=11, batch_size=4096, accum_method="sort",
                geom_clock=128)
    j.run(n_batches=1)
    path = str(tmp_path / "after1.npz")
    save_checkpoint(path, j)
    j.run(n_batches=1)
    jst = j.drain_stats()
    monkeypatch.delenv("IHT_PALLAS_TRACE")          # the port reads the same knob
    eng = load_jax_checkpoint(path, device="cpu")
    assert eng.geom_clock == 128 and eng.batch_counter == 1
    eng.run(n_batches=1)
    st = eng.drain_stats()
    assert abs(st.ray_segments - jst.ray_segments) <= FLIP_SEGMENTS
    assert st.stochastic_crystal_samples == jst.stochastic_crystal_samples
    _assert_image_close_flips(eng.raw_xyz(0), j.raw_xyz(0), _ray_weight(eng))


def test_cli_geom_clock_flag(tmp_path):
    import json

    from ice_halo_sim_tpu_torch import cli

    path = tmp_path / "stoch.json"
    path.write_text(json.dumps(_stochastic_doc("prism")))
    args = [str(path), "-o", str(tmp_path), "--ray-num", "4096", "--device", "cpu"]
    assert cli.main(args) == 0
    assert cli.main(args + ["--geom-clock", "128"]) == 0
    # A pinned clock the trace kernel cannot take renders on the general path.
    assert cli.main(args + ["--geom-clock", "16"]) == 0


@pytest.mark.parametrize("lens, fov", [("linear", 90.0), ("globe", 40.0),
                                       ("fisheye_orthographic", 170.0)])
def test_static_pyramid_and_lenses_match_jax_engine(monkeypatch, lens, fov):
    """The static trace mode with a deterministic pyramid (20 face slots)
    through the single-lens maps, one batch against the JAX XLA path.

    These wide views spread the light thinly (image maximum about 5), so
    the absolute pixel tolerance is 4e-6 of the maximum here: the JAX
    fold's prefix-sum differences leave a rounding residue of up to 8e-6
    in a pixel (and -4e-6 in pixels no ray reached), which the port's
    float64 scan does not have."""
    from ice_halo_sim_tpu.engine.simulator import Engine as JEngine

    doc = _stochastic_doc("pyramid")
    doc["crystal"][0]["shape"] = {"upper_h": 0.3, "prism_h": 0.9, "lower_h": 0.3}
    doc["render"] = [{"id": 1, "lens": {"type": lens, "fov": fov},
                      "resolution": [64, 48], "lens_shift": [3, -2],
                      "view": {"azimuth": 20.0, "elevation": 65.0, "roll": 5.0},
                      "visible": "full"}]
    monkeypatch.setenv("IHT_PALLAS_TRACE", "0")
    monkeypatch.setenv("IHT_SLOT_CAP", "off")
    j = JEngine(jax_load_project(doc), seed=5, batch_size=4096, accum_method="sort")
    j.run(n_batches=1)
    jst = j.drain_stats()
    monkeypatch.delenv("IHT_PALLAS_TRACE")          # the port reads the same knob
    t = Engine(load_project(doc), seed=5, batch_size=4096, device="cpu")
    plan = t._trace_plan
    assert plan.pool_k == 0 and plan.nf == 20 and t.geom_clock == DEFAULT_GEOM_CLOCK
    assert len(plan.planes) == 20 and 0 < len(plan.tris) <= 80
    t.run(n_batches=1)
    tst = t.drain_stats()
    assert tst.ray_segments == jst.ray_segments
    assert tst.stochastic_crystal_samples == jst.stochastic_crystal_samples == 0
    np.testing.assert_allclose(tst.landed_weight, jst.landed_weight, rtol=SUM_RTOL)
    img, ref = t.raw_xyz(0), j.raw_xyz(0)
    assert ref.sum() > 0
    np.testing.assert_allclose(img.sum(), ref.sum(), rtol=SUM_RTOL)
    np.testing.assert_allclose(img, ref, rtol=PIX_RTOL, atol=4e-6 * float(ref.max()))
