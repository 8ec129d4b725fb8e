"""The port's general trace path end to end against the JAX engine's XLA
path: single-layer scenes with two crystal settings, a ray-path filter, a
stochastic shape, discrete and D65 light, the slot cap pinned and
calibrated, and colour classes; the port's general path against its own
trace-kernel path; and the fold each engine takes, and why, on the scenes
that once chose between the JAX engine's folds.

Both engines run at batch 4096 with the sort fold; the JAX side has
IHT_PALLAS_TRACE=0 (which the port reads too), IHT_FOLD=sort and
IHT_STEPS_PER_DISPATCH=1 (one compile of its step; the port runs its
default, and either calibrates after the one-batch first dispatch). The main render keeps 512 x 256 pixels: at that size the JAX
engine's sort-size snap of ``keep`` (tuned to another accelerator, not
ported) cannot apply, so the calibrated ``keep`` must be equal.

Tolerances (PERF.md section 2): traced segments exact, or within
FLIP_SEGMENTS for a stochastic shape; landed weight and image sum rtol 1e-5;
per pixel rtol 1e-4 with atol 1e-6 of the image maximum, with at most
FLIP_PIXELS pixels outside: XLA and torch round the projection's last bit
differently (sqrt and divide under XLA's contraction; arccos, tan, arctan2
and arcsin of the general path's lenses), so a direction on a pixel edge
lands one pixel over and moves one ray's row between two neighbouring
pixels. The dropped weight is a
difference of two float32 sums of the whole batch (the roulette adds mass as
well as removing it), so it is held to 1e-6 of the landed weight, absolute.
"""

import copy

import numpy as np
import pytest
import torch

from ice_halo_sim_tpu.config.loader import load_project as jax_load_project
from ice_halo_sim_tpu.engine.simulator import Engine as JEngine
from ice_halo_sim_tpu_torch import scenes
from ice_halo_sim_tpu_torch.config.loader import load_project
from ice_halo_sim_tpu_torch.engine import compositor
from ice_halo_sim_tpu_torch.engine.simulator import Engine
from tests.test_torch_sandwich import _mini_cfg

# Tier-1 runs six workers; keep each one to two torch threads.
torch.set_num_threads(2)

SUM_RTOL = 1e-5
PIX_RTOL, PIX_ATOL_FRAC = 1e-4, 1e-6
DROPPED_ATOL_FRAC = 1e-6
FLIP_SEGMENTS = 8
FLIP_PIXELS = 8
GENERAL = "plain-torch (general)"


@pytest.fixture(autouse=True)
def _general_env(monkeypatch):
    monkeypatch.setenv("IHT_PALLAS_TRACE", "0")
    monkeypatch.setenv("IHT_FOLD", "sort")
    monkeypatch.setenv("IHT_STEPS_PER_DISPATCH", "1")


def _pixels_off(img, ref):
    np.testing.assert_allclose(img.sum(), ref.sum(), rtol=SUM_RTOL)
    tol = PIX_RTOL * np.abs(ref) + PIX_ATOL_FRAC * float(np.abs(ref).max())
    return int((np.abs(img - ref) > tol).any(-1).sum())


def _lanes_off(a, b, rtol=1e-4):
    """Pixels where any class lane [C, H, W] is outside rtol with atol 1e-6
    of the maximum."""
    tol = rtol * np.abs(b) + 1e-6 * float(np.abs(b).max())
    return int((np.abs(a - b) > tol).any(0).sum())


def _run_pair(doc, seed, geom_clock=32, n_after=2):
    """Both engines: one batch (calibration), then n_after more."""
    j = JEngine(jax_load_project(doc), seed=seed, batch_size=4096, accum_method="sort",
                geom_clock=geom_clock)
    assert j.trace_path == "xla" and j.fold_kind == "sort"
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("IHT_STEPS_PER_DISPATCH")
        t = Engine(load_project(doc), seed=seed, batch_size=4096, device="cpu",
                   geom_clock=geom_clock)
    assert t.trace_path == GENERAL and t.fold_kind == "sort"
    for eng in (j, t):
        eng.run(n_batches=1)
        eng.run(n_batches=n_after)
    return j, t


def _assert_stats(j, t, flips=0):
    js, ts = j.drain_stats(), t.drain_stats()
    assert ts.rays_traced == js.rays_traced
    assert abs(ts.ray_segments - js.ray_segments) <= flips
    np.testing.assert_allclose(ts.landed_weight, js.landed_weight, rtol=SUM_RTOL)
    assert abs(ts.dropped_cont_weight - js.dropped_cont_weight) <= \
        DROPPED_ATOL_FRAC * js.landed_weight
    for f in ("stochastic_crystal_samples", "stochastic_orientation_samples",
              "deterministic_crystal_count", "deterministic_orientation_count"):
        assert getattr(ts, f) == getattr(js, f), f
    return js, ts


def _assert_calibration(j, t):
    assert t._slot_cap == j._slot_cap
    assert t._compact_keep == j._compact_keep
    assert [l.cont_cap for l in t.layers] == [l.cont_cap for l in j.layers]
    assert t._rows_per_render == j._rows_per_render


def _single_layer_ms():
    """MS_CFG's second layer alone: a plate and a stochastic column (two
    settings, a pool of column shapes), the raypath filter on the column,
    D65 light, both renders (dual fisheye with overlap, equidistant)."""
    doc = copy.deepcopy(scenes.MS_CFG)
    doc["scene"]["scattering"] = [doc["scene"]["scattering"][1]]
    return doc


def test_two_settings_filter_calibrated_cap_match_jax():
    """Default knobs: the emit floor in roulette mode, the slot cap
    calibrated from the first batch's mass histogram, keep calibrated."""
    j, t = _run_pair(_single_layer_ms(), seed=7, geom_clock=128)
    assert t.layers[0].k_per_setting == j.layers[0].k_per_setting == [1, 16]
    assert t.layers[0].filter_plans[0] is None and t.layers[0].filter_plans[1] is not None
    _assert_stats(j, t, flips=FLIP_SEGMENTS)
    _assert_calibration(j, t)
    assert t._slot_cap < t.max_hits and t._compact_keep is not None
    for r in range(2):
        assert _pixels_off(t.raw_xyz(r), j.raw_xyz(r)) <= FLIP_PIXELS
    # The calibration read, then one read per dispatch: run(n_batches=2)
    # is one dispatch (the first one cannot overflow: no keep yet).
    assert t.host_syncs == 2


def test_discrete_light_pinned_cap_complex_filter_match_jax(monkeypatch):
    """A 3-line discrete spectrum (not a power of two: pool of 4), the slot
    cap pinned to 3, a complex filter (two clauses) with filter_out, the
    floor in drop mode, a deterministic shape shared by every ray."""
    monkeypatch.setenv("IHT_SLOT_CAP", "3")
    monkeypatch.setenv("IHT_EMIT_FLOOR", "drop")
    doc = copy.deepcopy(scenes.BENCH_CFG)
    doc["scene"]["light_source"] = {
        "type": "sun", "altitude": 20.0,
        "spectrum": [{"wavelength": w, "weight": 1.0 + i}
                     for i, w in enumerate([450.0, 550.0, 620.0])]}
    doc["filter"] = [
        {"id": 1, "type": "raypath", "raypath": [3, 5], "symmetry": "P"},
        {"id": 2, "type": "entry_exit", "entry": 1, "exit": 2, "symmetry": "B"},
        {"id": 3, "type": "direction", "az": 0.0, "el": -20.0, "radii": 60.0},
        {"id": 4, "type": "complex", "composition": [[1], [2, 3]], "action": "filter_out"},
    ]
    doc["scene"]["scattering"][0]["entries"][0]["filter"] = 4
    j, t = _run_pair(doc, seed=5)
    assert t.k_pool == j.k_pool == 4 and t.wl_mode == "discrete"
    _assert_stats(j, t)
    _assert_calibration(j, t)
    assert t._slot_cap == 3
    assert _pixels_off(t.raw_xyz(0), j.raw_xyz(0)) <= FLIP_PIXELS


def test_colour_classes_match_jax():
    """COLOR_CFG (three classes, one combining two predicates with "all",
    one rectangular render of 1024 x 512): the XYZ image, the Y lane of
    every class (rtol 1e-4, atol 1e-6 of the maximum), the whole-crystal
    lane equal to the Y image, and the composite."""
    j, t = _run_pair(copy.deepcopy(scenes.COLOR_CFG), seed=7, n_after=1)
    assert t.color_classes == j.color_classes and len(t.color_classes) == 3
    assert t.color_overflow_count == j.color_overflow_count == 0
    _assert_stats(j, t)
    _assert_calibration(j, t)
    assert t._compact_keep is not None      # the second batch rode compact_valid with the mask
    assert _pixels_off(t.raw_xyz(0), j.raw_xyz(0)) <= FLIP_PIXELS
    jl, tl = j.lane_y(0), t.lane_y(0)
    assert tl.shape == jl.shape == (3, 512, 1024)
    np.testing.assert_allclose(tl.sum((1, 2)), jl.sum((1, 2)), rtol=SUM_RTOL)
    assert _lanes_off(tl, jl) <= FLIP_PIXELS
    assert 0 < tl[1].sum() < tl[0].sum() < tl[2].sum()
    np.testing.assert_allclose(tl[2], t.raw_xyz(0)[..., 1], rtol=1e-6,
                               atol=1e-6 * float(tl.max()))
    # The compositor is a copy of the JAX package's numpy module: on equal
    # lanes it gives the equal image, in every mode. It is held on equal lanes
    # only: its exposure is anchored to a percentile of the nonzero lane
    # values and its dominant mode picks a class per pixel, and one ray that
    # lands a pixel over moves both.
    from ice_halo_sim_tpu.engine import compositor as jcomp

    classes = t.cfg.raypath_color.classes
    for mode in ("dominant", "additive", "painter"):
        np.testing.assert_array_equal(
            compositor.composite_color_classes(jl, classes, mode, 1.5, 0.8),
            jcomp.composite_color_classes(jl, j.cfg.raypath_color.classes, mode, 1.5, 0.8))
    own = t.composite(0, display_exposure_scale=0.9)
    assert own.shape == (512, 1024, 3) and own.max() > 0
    np.testing.assert_array_equal(own, compositor.composite_color_classes(
        tl, classes, t.cfg.raypath_color.composite_mode, 1.0, 0.9))
    assert Engine(load_project(scenes.BENCH_CFG), batch_size=4096,
                  device="cpu").composite(0) is None


def test_colour_predicate_cap_degrades():
    """Predicates past the 32-bit component mask produce no bit and are
    counted, as in the JAX engine."""
    doc = copy.deepcopy(scenes.COLOR_CFG)
    doc["raypath_color"]["classes"] = [
        {"name": f"c{i}", "match": [{"crystal": 1, "raypath": [3, 4 + i % 4]}]}
        for i in range(35)]
    t = Engine(load_project(doc), batch_size=4096, device="cpu")
    j = JEngine(jax_load_project(doc), batch_size=4096, accum_method="sort")
    assert t.color_overflow_count == j.color_overflow_count == 3
    assert t.color_classes == j.color_classes and t.color_classes[-1] == (0, False)


def test_general_path_equals_kernel_path_on_bench_scene(monkeypatch):
    """The port's two trace paths on BENCH_CFG's scene with the emit floor
    and the slot cap off (they differ there on purpose). The tolerances are
    those of the JAX package's own kernel-against-XLA parity test: segments
    exact, landed weight rtol 1e-5, pixels rtol 1e-4 with atol 1e-6 of the
    maximum."""
    monkeypatch.setenv("IHT_MIN_EMIT_W", "0")
    monkeypatch.setenv("IHT_SLOT_CAP", "off")
    cfg = load_project(scenes.BENCH_CFG)
    g = Engine(cfg, seed=7, batch_size=4096, device="cpu")
    monkeypatch.delenv("IHT_PALLAS_TRACE")
    k = Engine(cfg, seed=7, batch_size=4096, device="cpu")
    assert (g.trace_path, k.trace_path) == (GENERAL, "plain-torch")
    assert g._kernel_reason.startswith("trace kernel switched off")
    for eng in (g, k):
        eng.run(n_batches=1)
        eng.run(n_batches=2)
    gs, ks = g.drain_stats(), k.drain_stats()
    assert gs.ray_segments == ks.ray_segments
    np.testing.assert_allclose(gs.landed_weight, ks.landed_weight, rtol=SUM_RTOL)
    assert gs.dropped_cont_weight == ks.dropped_cont_weight == 0.0
    assert _pixels_off(g.raw_xyz(0), k.raw_xyz(0)) == 0
    assert g._compact_keep == k._compact_keep           # the same live rows


def test_scatter_fold_is_the_sort_folds_oracle():
    """accum_method="scatter" (index_add_) renders the same image as the
    sort fold, with the lanes."""
    doc = copy.deepcopy(scenes.COLOR_CFG)
    doc["render"][0]["resolution"] = [256, 128]
    a = Engine(load_project(doc), seed=3, batch_size=4096, device="cpu")
    b = Engine(load_project(doc), seed=3, batch_size=4096, device="cpu",
               accum_method="scatter")
    for eng in (a, b):
        eng.run(n_batches=2)
    assert b.fold_kind == "scatter" and b._compact_keep is None
    assert a.drain_stats().ray_segments == b.drain_stats().ray_segments
    assert _pixels_off(a.raw_xyz(0), b.raw_xyz(0)) == 0
    np.testing.assert_allclose(a.lane_y(0), b.lane_y(0), rtol=1e-4,
                               atol=1e-6 * float(b.lane_y(0).max()))


def test_overflowing_batch_takes_the_full_fold():
    """compact_valid is exact only when the live rows fit keep; the engine
    guards it: with keep set too small the batch takes the full fold and the
    image is the uncompacted one."""
    doc = _single_layer_ms()
    cfg = load_project(doc)
    a = Engine(cfg, seed=9, batch_size=4096, device="cpu", geom_clock=128)
    b = Engine(cfg, seed=9, batch_size=4096, device="cpu", geom_clock=128)
    a.run(n_batches=1)
    b.run(n_batches=1)
    assert a._compact_keep is not None and a._compact_keep == b._compact_keep
    b._compact_keep = (4096, 4096)                       # far below the live rows
    a.run(n_batches=1)
    b.run(n_batches=1)
    for r in range(2):
        assert _pixels_off(b.raw_xyz(r), a.raw_xyz(r)) == 0


def test_resume_jax_checkpoint_with_lanes_and_slot_cap(tmp_path):
    """A JAX checkpoint of a colour-class scene: [P, 3 + L] accumulators and
    the calibrated slot cap carry over."""
    from ice_halo_sim_tpu.engine.checkpoint import save_checkpoint
    from ice_halo_sim_tpu_torch.engine.checkpoint import load_jax_checkpoint

    doc = copy.deepcopy(scenes.COLOR_CFG)
    doc["render"][0]["resolution"] = [256, 128]
    j = JEngine(jax_load_project(doc), seed=4, batch_size=4096, accum_method="sort")
    j.run(n_batches=1)
    path = str(tmp_path / "color.npz")
    save_checkpoint(path, j)
    j.run(n_batches=1)
    eng = load_jax_checkpoint(path, device="cpu")
    assert eng._slot_cap == j._slot_cap and eng.batch_counter == 1
    assert tuple(eng.accum[0].shape) == (256 * 128, 6)
    eng.run(n_batches=1)
    _assert_stats(j, eng)
    assert _pixels_off(eng.raw_xyz(0), j.raw_xyz(0)) <= FLIP_PIXELS
    assert _lanes_off(eng.lane_y(0), j.lane_y(0)) <= FLIP_PIXELS


def _ms_ref_module():
    import importlib.util
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "make_torch_port_ref", os.path.join(root, "scripts", "make_torch_port_ref.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_ms_first_layer_matches_jax_fixture_and_fixture_is_current():
    """MS_CFG's first layer (two settings, a stochastic column, the drop rule
    of a last layer with prob > 0) at default knobs: the port against the
    committed JAX render (scripts/make_torch_port_ref.py ms), which the card
    is held against too, and the fixture against a live JAX run."""
    mod = _ms_ref_module()
    fix = np.load(mod.MS_OUT)
    doc = mod.ms_first_layer_doc()
    t = Engine(load_project(doc), seed=int(fix["seed"]), batch_size=int(fix["batch_size"]),
               device="cpu")
    t.run(n_batches=1)
    t.run(n_batches=int(fix["n_batches"]) - 1)
    st = t.drain_stats()
    assert t._slot_cap == int(fix["slot_cap"]) and t.geom_clock == 32
    assert st.rays_traced == int(fix["rays_traced"])
    assert st.stochastic_crystal_samples == int(fix["stochastic_crystal_samples"])
    assert abs(st.ray_segments - int(fix["ray_segments"])) <= FLIP_SEGMENTS
    np.testing.assert_allclose(st.landed_weight, float(fix["landed_weight"]), rtol=SUM_RTOL)
    assert abs(st.dropped_cont_weight - float(fix["dropped_cont_weight"])) <= \
        DROPPED_ATOL_FRAC * float(fix["landed_weight"])
    for r, key in enumerate(("raw_xyz", "raw_xyz_1")):
        assert _pixels_off(t.raw_xyz(r), fix[key]) <= FLIP_PIXELS
    ref = mod.jax_ms_reference()
    for k in ("ray_segments", "rays_traced", "slot_cap", "stochastic_crystal_samples"):
        assert int(ref[k]) == int(fix[k]), k
    np.testing.assert_allclose(float(ref["landed_weight"]), float(fix["landed_weight"]),
                               rtol=1e-6)
    for key in ("raw_xyz", "raw_xyz_1"):
        np.testing.assert_allclose(ref[key], fix[key], rtol=1e-6,
                                   atol=1e-6 * float(fix[key].max()))


def test_cli_renders_a_built_in_general_scene(tmp_path, monkeypatch):
    from ice_halo_sim_tpu_torch import cli

    monkeypatch.delenv("IHT_PALLAS_TRACE")
    rc = cli.main(["--scene", "color", "-o", str(tmp_path), "--ray-num", "4096",
                   "--device", "cpu", "--batch-size", "4096"])
    assert rc == 0
    for name in ("color_render1.png", "color_render1_classes.png"):
        assert (tmp_path / name).read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert cli.main(["--scene", "ms", "-o", str(tmp_path), "--ray-num", "2048",
                     "--device", "cpu"]) == 0
    assert cli.main(["-o", str(tmp_path)]) == 2


def _colour_mini():
    doc = _mini_cfg((96, 96))
    doc["raypath_color"] = {"mode": "dominant", "classes": [
        {"name": "35", "color": [1.0, 0.3, 0.2],
         "match": [{"crystal": 1, "raypath": [3, 5], "symmetry": "P"}]}]}
    return doc


# case: (document, environment, engine keywords, the port's fold_decision)
FOLD_CASES = {
    "kernel-path": (scenes.BENCH_CFG, {"IHT_MIN_EMIT_W": "0", "IHT_SLOT_CAP": "off"}, {},
                    "sort fold: the trace kernel emits packed sort keys"),
    "general-96": (_mini_cfg((96, 96)), {}, {}, "sort fold"),
    "general-256": (_mini_cfg((256, 256)), {}, {}, "sort fold"),
    "colour-classes": (_colour_mini(), {}, {}, "sort fold"),
    "scatter": (_mini_cfg((96, 96)), {}, {"accum_method": "scatter"}, "accum method 'scatter'"),
    "pool-256": (_mini_cfg((96, 96)), {"IHT_WL_POOL": "256"}, {}, "sort fold"),
    "chunks-1024": (_mini_cfg((1024, 1024)), {}, {}, "sort fold"),
}


@pytest.mark.parametrize("case", list(FOLD_CASES))
def test_fold_and_image_match_jax(monkeypatch, case):
    """The scenes on which the JAX engine chose between its folds (the trace
    kernel's path, small and large renders, colour classes, the scatter
    oracle, a pool of 256 wavelengths, 8192 image chunks), each on the
    port's one packed-key fold against the JAX engine with IHT_FOLD=sort:
    the same fold_kind, the port's reason in fold_decision, and after two
    batches the image, landed weight and segments at this file's
    tolerances."""
    doc, env, kw, decision = FOLD_CASES[case]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    j = JEngine(jax_load_project(doc), seed=5, batch_size=4096,
                **{"accum_method": "sort", **kw})
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("IHT_STEPS_PER_DISPATCH")
        if case == "kernel-path":
            mp.delenv("IHT_PALLAS_TRACE")
        t = Engine(load_project(doc), seed=5, batch_size=4096, device="cpu", **kw)
    assert j.trace_path == "xla"
    assert t.trace_path == ("plain-torch" if case == "kernel-path" else GENERAL)
    assert t.fold_kind == j.fold_kind == kw.get("accum_method", "sort")
    assert t.fold_decision == decision
    assert t.k_pool == j.k_pool == (256 if case == "pool-256" else 64)
    for eng in (j, t):
        eng.run(n_batches=1)
        eng.run(n_batches=1)
    _assert_stats(j, t)
    assert _pixels_off(t.raw_xyz(0), np.asarray(j.raw_xyz(0))) <= FLIP_PIXELS
    if t.color_classes:
        assert _lanes_off(t.lane_y(0), j.lane_y(0)) <= FLIP_PIXELS
