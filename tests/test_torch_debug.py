"""The port's debug ray dump (engine/debug.py) on the CPU: the twin of
tests/test_builder_debug.py::test_dump_rays, the dump held record for
record against the JAX package's dump_rays at batch 8192 (one shared
prism, and a pool of sampled pyramids), and a render after a dump equal to
one without.

Tolerances against JAX: the records (ray, slot, path, path length) and the
wavelengths are exact; weights and directions rtol 1e-5 with atol 1e-5 (of
the largest initial weight for weights), but for EDGE_FRAC of the records,
which stay within atol EDGE_ATOL. The orientations come from each side's
own sampler here (arcsin, cos, sin differ by an ulp between XLA and torch),
and near the TIR limit the refracted direction and the reflectance go
through the square root of a difference near 0, which turns that ulp into
up to its square root, some 3e-4 (of the largest weight for weights). A ray on a float edge
(entry triangle, face, TIR) could also flip its record; these seeds have
none, and the exact comparison says so if one appears.
"""

import copy

import numpy as np
import pytest
import torch

from ice_halo_sim_tpu.config.builder import SceneBuilder, prism, uniform
from ice_halo_sim_tpu.config.loader import load_project as jload
from ice_halo_sim_tpu.config.serialize import project_to_dict
from ice_halo_sim_tpu.engine import debug as jdebug
from ice_halo_sim_tpu.engine.simulator import Engine as JEngine
from ice_halo_sim_tpu_torch import scenes
from ice_halo_sim_tpu_torch.config.loader import load_project
from ice_halo_sim_tpu_torch.engine.debug import dump_rays, format_rays
from ice_halo_sim_tpu_torch.engine.simulator import Engine

# Tier-1 runs six workers; keep each one to two torch threads.
torch.set_num_threads(2)

TOL = 1e-5
EDGE_FRAC, EDGE_ATOL = 2e-3, 1e-3
BATCH = 1 << 13


def _close_but_edges(got, want, scale):
    """rtol and atol TOL (atol times `scale`) on all but EDGE_FRAC of the
    rows; those within EDGE_ATOL times `scale`."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    off = np.abs(got - want) > TOL * (scale + np.abs(want))
    off = off.reshape(len(off), -1).any(axis=1)
    assert off.sum() <= EDGE_FRAC * len(off), (int(off.sum()), len(off))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=EDGE_ATOL * scale)


def _builder_doc():
    b = (
        SceneBuilder()
        .add_crystal(1, prism(height=1.2), zenith=uniform(90, 360), azimuth=uniform(0, 360))
        .sun(altitude=25)
        .spectrum_wavelength(550)
        .sim_params(ray_num=65536, max_hits=6)
        .add_scatter_layer([(1, 100.0)])
        .add_render(lens="fisheye_equal_area", fov=120, resolution=(64, 64), elevation=25)
    )
    return project_to_dict(b.build())


def _pool_doc():
    """POOL_CFG's sampled pyramids and D65 light, one render of 64 x 32."""
    doc = copy.deepcopy(scenes.POOL_CFG)
    doc["render"] = [dict(doc["render"][0], resolution=[64, 32])]
    return doc


def test_dump_rays():
    eng = Engine(load_project(_builder_doc()), seed=5, batch_size=BATCH, device="cpu")
    rec = dump_rays(eng, n_rays=512)
    assert len(rec.ray_idx) > 0
    assert rec.direction.shape == (len(rec.ray_idx), 3)
    assert (rec.ray_idx < 512).all()
    np.testing.assert_allclose(np.linalg.norm(rec.direction, axis=-1), 1.0, atol=1e-3)
    assert (rec.weight > 0).all() and (rec.weight <= 1.0 + 1e-6).all()
    assert (rec.path_len == rec.exit_slot + 1).all()
    faces = rec.path[rec.path > 0]
    assert np.isin(faces, np.arange(1, 9)).all()
    text = format_rays(rec)
    assert "weight" in text and "-" in text
    assert text.splitlines()[-1] == f"... {len(rec.ray_idx) - 20} more"


@pytest.mark.parametrize("case", ["prism", "pool"])
def test_dump_rays_matches_jax_record_for_record(monkeypatch, case):
    monkeypatch.setenv("IHT_PALLAS_TRACE", "0")
    doc, gc = (_builder_doc(), 32) if case == "prism" else (_pool_doc(), 128)
    j = JEngine(jload(doc), seed=5, batch_size=BATCH, geom_clock=gc)
    t = Engine(load_project(doc), seed=5, batch_size=BATCH, device="cpu", geom_clock=gc)
    assert [sum(p.k_per_setting) for p in t.layers] == [sum(p.k_per_setting) for p in j.layers]
    want = jdebug.dump_rays(j, n_rays=BATCH)
    got = dump_rays(t, n_rays=BATCH)
    assert len(got.ray_idx) == len(want.ray_idx) > 3 * BATCH, (len(got.ray_idx),
                                                               len(want.ray_idx))
    for f in ("ray_idx", "exit_slot", "path", "path_len", "wavelength"):
        a, b = getattr(got, f), np.asarray(getattr(want, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    _close_but_edges(got.weight, want.weight, float(t._w0_tbl.max()))
    _close_but_edges(got.direction, want.direction, 1.0)
    if case == "pool":
        assert (got.path >= 13).any()


def test_dump_does_not_move_the_render():
    cfg = load_project(_builder_doc())
    a = Engine(cfg, seed=5, batch_size=BATCH, device="cpu")
    b = Engine(cfg, seed=5, batch_size=BATCH, device="cpu")
    a.run(n_batches=1)
    b.run(n_batches=1)
    first = dump_rays(b, n_rays=BATCH)
    a.run(n_batches=2)
    b.run(n_batches=2)
    assert torch.equal(a.accum[0], b.accum[0]) and a.drain_stats() == b.drain_stats()
    again = dump_rays(b, n_rays=BATCH)
    for x, y in zip(first, again):
        np.testing.assert_array_equal(x, y)
