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
"""

import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

from bench import BENCH_CFG
from ice_halo_sim_tpu.config.loader import load_project
from ice_halo_sim_tpu_torch.engine.checkpoint import load_jax_checkpoint
from ice_halo_sim_tpu_torch.engine.simulator import Engine

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
    assert eng.host_syncs == 3      # calibration + one live read per batch after
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
    cfg = load_project(BENCH_CFG)
    with pytest.raises(ValueError):
        Engine(cfg, batch_size=4096, device="cpu", kernels="cuda")
    doc = dict(BENCH_CFG)
    doc["render"] = [dict(BENCH_CFG["render"][0], lens={"type": "rectangular", "fov": 360.0})]
    with pytest.raises(NotImplementedError, match="lens type needs inverse trig"):
        Engine(load_project(doc), batch_size=4096, device="cpu")
    doc = dict(BENCH_CFG)
    doc["render"] = [dict(BENCH_CFG["render"][0], lens={"type": "linear", "fov": 90.0})]
    with pytest.raises(NotImplementedError, match="not ported yet"):
        Engine(load_project(doc), batch_size=4096, device="cpu")
    doc = dict(BENCH_CFG)
    doc["scene"] = dict(BENCH_CFG["scene"], scattering=[
        {"prob": 0.5, "entries": [{"crystal": 1, "proportion": 10}]},
        {"prob": 0.0, "entries": [{"crystal": 1, "proportion": 10}]}])
    with pytest.raises(NotImplementedError, match="multi-layer scattering"):
        Engine(load_project(doc), batch_size=4096, device="cpu")
    with pytest.raises(NotImplementedError, match="not a multiple of 2048"):
        Engine(cfg, batch_size=5000, device="cpu")


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
    j = JEngine(cfg, seed=5, batch_size=4096, accum_method="sort")
    j.run(n_batches=1)
    jst = j.drain_stats()
    t = Engine(cfg, seed=5, batch_size=4096, device="cpu")
    t.run(n_batches=1)
    tst = t.drain_stats()
    assert tst.ray_segments == jst.ray_segments
    np.testing.assert_allclose(tst.landed_weight, jst.landed_weight, rtol=SUM_RTOL)
    _assert_image_close(t.raw_xyz(0), j.raw_xyz(0))
