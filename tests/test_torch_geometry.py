"""Twins of tests/test_geometry.py, tests/test_pyramid.py and
tests/test_optics.py on the port (core/geometry.py, core/pyramid.py,
core/optics.py), with their closed-form oracles: regular-hexagon areas and
plane constants, face presence under degenerate distances, containment and
winding invariants, the pyramid's face counts, apex and truncation heights;
the ice refractive index, Fresnel's normal incidence and energy balance,
Snell's law, the TIR limit, and the slab's exit face on a hand-checked
prism.
"""

import numpy as np
import pytest
import torch

from ice_halo_sim_tpu_torch.core import geometry as geo
from ice_halo_sim_tpu_torch.core import optics
from ice_halo_sim_tpu_torch.core import pyramid as pyr
from ice_halo_sim_tpu_torch.core import sampling, trace

# Tier-1 runs six workers; keep each one to two torch threads.
torch.set_num_threads(2)

HEX_AREA = 3.0 * np.sqrt(3.0) / 2.0 * 0.25


def regular_prism(h=1.0):
    return geo.prism_geom(h, [1.0] * 6)


# --- geometry ---------------------------------------------------------------

def test_regular_prism_planes():
    g = regular_prism(1.2)
    n, d = g.plane_n.numpy(), g.plane_d.numpy()
    np.testing.assert_allclose(np.linalg.norm(n, axis=-1), 1.0, atol=1e-6)
    assert d[0] == pytest.approx(-0.6) and d[1] == pytest.approx(-0.6)
    np.testing.assert_allclose(d[2:], -geo.SQRT3_4, atol=1e-6)
    np.testing.assert_array_equal(g.face_number.numpy(), [1, 2, 3, 4, 5, 6, 7, 8])
    assert bool(g.face_present.all())


def test_regular_prism_areas():
    h = 1.2
    areas = geo.polygon_areas(regular_prism(h)).numpy()
    assert areas[0] == pytest.approx(HEX_AREA, rel=1e-5)
    assert areas[1] == pytest.approx(HEX_AREA, rel=1e-5)
    np.testing.assert_allclose(areas[2:], 0.5 * h, rtol=1e-5)


def _check_on_planes(g, nf, tol, label=""):
    n, d = g.plane_n.numpy(), g.plane_d.numpy()
    vtx, cnt, present = g.face_vtx.numpy(), g.face_vtx_cnt.numpy(), g.face_present.numpy()
    for f in range(nf):
        if not present[f]:
            continue
        for k in range(cnt[f]):
            v = vtx[f, k]
            assert abs(v @ n[f] + d[f]) < tol, (label, f, k)
            assert (v @ n.T + d).max() < tol, (label, f, k)


def test_prism_vertices_on_planes():
    _check_on_planes(geo.prism_geom(0.9, [1.0, 1.3, 0.8, 1.1, 0.9, 1.2]), 8, 1e-4)


def test_prism_ccw_winding():
    g = geo.prism_geom(1.4, [1.0, 0.9, 1.2, 1.0, 1.1, 0.7])
    n, vtx = g.plane_n.numpy(), g.face_vtx.numpy()
    cnt, present = g.face_vtx_cnt.numpy(), g.face_present.numpy()
    for f in range(8):
        if not present[f]:
            continue
        for k in range(1, cnt[f] - 1):
            tri_n = np.cross(vtx[f, k] - vtx[f, 0], vtx[f, k + 1] - vtx[f, 0])
            if np.linalg.norm(tri_n) < 1e-9:
                continue
            assert tri_n @ n[f] > 0, (f, k)


def test_face_distance_drops_face():
    g = geo.prism_geom(1.0, [1.0, 1.0, 1.0, 1.0, 1.0, 10.0])
    present = g.face_present.numpy()
    assert not present[2 + 5] and present[:7].all()
    assert g.face_vtx_cnt.numpy()[2 + 5] == 0


def test_zero_height_degenerate():
    assert not bool(geo.prism_geom(0.0, [1.0] * 6).face_present.any())


def test_empty_cross_section():
    assert not bool(geo.prism_geom(1.0, [-2.0] * 6).face_present.any())


def test_triangle_cross_section():
    g = geo.prism_geom(1.0, [1.0, 5.0, 1.0, 5.0, 1.0, 5.0])
    present = g.face_present.numpy()
    assert present[0] and present[1]
    np.testing.assert_array_equal(present[2:], [True, False, True, False, True, False])
    r = geo.SQRT3_4
    assert geo.polygon_areas(g).numpy()[0] == pytest.approx(3 * np.sqrt(3) * r * r, rel=1e-4)


def test_batched_construction():
    h = torch.tensor([1.0, 0.5, 2.0])
    g = geo.prism_geom_batch(h, torch.ones(3, 6))
    assert tuple(g.plane_n.shape) == (3, 8, 3)
    np.testing.assert_allclose(geo.polygon_areas(g).numpy()[:, 2], 0.5 * h.numpy(), rtol=1e-5)


def test_geometry_is_differentiable():
    """d(basal area) / d(uniform distance scale) at 1 is twice the area."""
    s = torch.tensor(1.0, requires_grad=True)
    area = geo.polygon_areas(geo.prism_geom(1.0, s * torch.ones(6)))[0]
    (grad,) = torch.autograd.grad(area, s)
    assert float(grad) == pytest.approx(2 * HEX_AREA, rel=1e-3)


# --- pyramid ----------------------------------------------------------------

def build(h1=0.3, h2=1.0, h3=0.3, au=28.0, al=28.0, dist=None):
    return pyr.pyramid_geom(h1, h2, h3, au, al, dist if dist is not None else [1.0] * 6)


def test_regular_pyramid_all_faces():
    g = build(h1=0.5, h2=1.0, h3=0.5)
    assert bool(g.face_present.all())
    np.testing.assert_array_equal(
        g.face_number.numpy(),
        [1, 2] + list(range(3, 9)) + list(range(13, 19)) + list(range(23, 29)))
    _check_on_planes(g, 20, 3e-4, "regular")
    cnt = g.face_vtx_cnt.numpy()
    assert cnt[0] == 6 and cnt[1] == 6
    assert (cnt[2:] == 4).all()


def test_symmetry_of_regular_pyramid():
    areas = geo.polygon_areas(build(h1=0.4, h2=0.8, h3=0.4, au=30.0, al=30.0)).numpy()
    for lo, hi in ((2, 8), (8, 14), (14, 20)):
        np.testing.assert_allclose(areas[lo:hi], areas[lo], rtol=2e-3)
    np.testing.assert_allclose(areas[8:14], areas[14:20], rtol=2e-3)
    assert areas[0] == pytest.approx(areas[1], rel=2e-3)


def test_full_apex_collapse():
    g = build(h1=1.0, h2=0.0, h3=0.0, au=45.0, al=0.0)
    present = g.face_present.numpy()
    assert not present[0] and present[1]
    assert not present[2:8].any() and present[8:14].all() and not present[14:20].any()
    assert (g.face_vtx_cnt.numpy()[8:14] == 3).all()
    _check_on_planes(g, 20, 3e-4, "apex")
    z_max = g.face_vtx.numpy()[present].reshape(-1, 3)[:, 2].max()
    assert z_max == pytest.approx(geo.SQRT3_4, rel=1e-3)


def test_truncation_height():
    au, h1, h2 = 35.0, 0.6, 0.9
    g = build(h1=h1, h2=h2, h3=0.2, au=au)
    a1 = geo.SQRT3_4 / np.tan(np.radians(au))
    vtx, cnt = g.face_vtx.numpy(), g.face_vtx_cnt.numpy()
    np.testing.assert_allclose(vtx[0, : cnt[0], 2], h2 / 2 + a1 * h1, rtol=1e-3)
    r_top = np.hypot(vtx[0, : cnt[0], 0], vtx[0, : cnt[0], 1])
    np.testing.assert_allclose(r_top, geo.SQRT3_4 * 0.4 * 2 / np.sqrt(3), rtol=2e-3)


def test_no_cones_matches_prism():
    g = build(h1=0.5, h2=1.2, h3=0.5, au=0.0, al=95.0)
    gp = geo.prism_geom(1.2, [1.0] * 6)
    present = g.face_present.numpy()
    assert present[:8].all() and not present[8:].any()
    np.testing.assert_allclose(geo.polygon_areas(g).numpy()[:8],
                               geo.polygon_areas(gp).numpy()[:8], rtol=1e-3)
    np.testing.assert_allclose(g.plane_d.numpy()[:8], gp.plane_d.numpy(), atol=1e-5)


def test_face_distance_drop_on_pyramid():
    g = build(h1=0.3, h2=1.0, h3=0.3, dist=[1.0, 1.0, 1.0, 1.0, 1.0, 8.0])
    present = g.face_present.numpy()
    assert not present[2 + 5] and not present[8 + 5] and not present[14 + 5]
    assert present[0] and present[1]
    _check_on_planes(g, 20, 3e-4, "drop")


def test_irregular_distances_invariants():
    rs = np.random.default_rng(5)
    for trial in range(12):
        dist = rs.uniform(0.4, 1.6, 6).astype(np.float32)
        h1, h2, h3 = rs.uniform(0.05, 0.95), rs.uniform(0.1, 2.0), rs.uniform(0.05, 0.95)
        au, al = rs.uniform(15, 75), rs.uniform(15, 75)
        g = build(h1=h1, h2=h2, h3=h3, au=float(au), al=float(al), dist=dist)
        _check_on_planes(g, 20, 3e-4, f"trial{trial}")


def test_batched_pyramid():
    g = pyr.pyramid_geom_batch(torch.tensor([0.3, 0.6]), torch.tensor([1.0, 0.5]),
                               torch.tensor([0.3, 0.2]), 28.0, 28.0, torch.ones(2, 6))
    assert tuple(g.plane_n.shape) == (2, 20, 3)
    assert bool(g.face_present.all())


def _random_pyramids(k, seed=3):
    g = torch.Generator().manual_seed(seed)
    h1, h3 = (torch.rand(k, generator=g) * 0.6 for _ in range(2))
    h2 = torch.rand(k, generator=g) * 1.5 + 0.05
    dist = torch.rand(k, 6, generator=g) * 0.5 + 0.75
    dist[: k // 4] = 1.0
    return h1, h2, h3, dist


def _geom_bits(g):
    return [x.contiguous().view(torch.int32) if x.dtype == torch.float32 else x for x in g]


@pytest.mark.parametrize("angles", [(28.0, 28.0), (28.0, 0.0), (60.0, 10.0)])
def test_pyramid_pool_equals_the_frozen_plain_copy(angles):
    """The vertex enumeration with the normals' work done once for the pool
    and the vertex components apart gives the frozen plain copy's geometry
    (portbench/reference/plain/core/pyramid.py: a pass over [K, 20, 171, 3]
    per shape) bit for bit."""
    from portbench.reference.plain.core import pyramid as frozen

    h1, h2, h3, dist = _random_pyramids(200)
    got = pyr.pyramid_geom_batch(h1, h2, h3, *angles, dist)
    want = frozen.pyramid_geom_batch(h1, h2, h3, *angles, dist)
    for a, b in zip(_geom_bits(got), _geom_bits(want)):
        assert torch.equal(a, b)


def test_pyramid_pool_in_passes_equals_one_pass(monkeypatch):
    """A pool built in passes of GEOM_CHUNK shapes equals it built in one."""
    h1, h2, h3, dist = _random_pyramids(100, seed=5)
    monkeypatch.setitem(pyr.GEOM_CHUNK, "cpu", 1 << 30)
    whole = pyr.pyramid_geom_batch(h1, h2, h3, 28.0, 28.0, dist)
    monkeypatch.setitem(pyr.GEOM_CHUNK, "cpu", 16)
    passes = pyr.pyramid_geom_batch(h1, h2, h3, 28.0, 28.0, dist)
    for a, b in zip(_geom_bits(passes), _geom_bits(whole)):
        assert torch.equal(a, b)


def test_pyramid_traces():
    """A pyramid plugs into the AoS trace; energy behaves; pyramid face
    numbers appear in the paths."""
    g = pyr.pyramid_geom_batch(torch.tensor([0.25]), torch.tensor([1.0]), torch.tensor([0.25]),
                               28.0, 28.0, torch.ones(1, 6))
    pool = trace.make_geom_pool(g, sampling.build_entry_tris(g))
    n = 2000
    rs = np.random.default_rng(2)
    ang = [torch.as_tensor(a, dtype=torch.float32) for a in (
        rs.uniform(0, 2 * np.pi, n), np.arcsin(rs.uniform(-1, 1, n)), rs.uniform(0, 2 * np.pi, n))]
    exits = trace.trace_layer(3, torch.arange(n), torch.tensor([[0.0, 0.0, -1.0]]).repeat(n, 1),
                              torch.ones(n), sampling.build_rotation(*ang),
                              torch.zeros(n, dtype=torch.int32), pool, torch.full((n,), 1.31),
                              20)
    total = trace.total_exit_weight(exits).numpy()
    assert bool(exits.entry_ok.all())
    assert (total <= 1 + 1e-5).all() and total.mean() > 0.95
    paths = exits.path.numpy()
    assert ((paths >= 13) & (paths <= 28)).any()


# --- optics -----------------------------------------------------------------

def test_ice_ior_anchors():
    n = optics.ice_refractive_index(torch.tensor([400.0, 550.0, 700.0])).numpy()
    assert 1.30 < n[1] < 1.32
    assert n[0] > n[1] > n[2]
    assert float(optics.ice_refractive_index(300.0)) == 1.0
    assert float(optics.ice_refractive_index(1000.0)) == 1.0


def _split(d, n_face=(0.0, 0.0, 1.0), w=1.0, n_ior=1.31):
    d = torch.as_tensor(np.asarray(d, np.float32)).reshape(-1, 3)
    m = d.shape[0]
    return optics.fresnel_split(d, torch.tensor([n_face]).repeat(m, 1),
                                torch.full((m,), w), n_ior)


def test_fresnel_normal_incidence():
    n_ior = 1.31
    d_r, d_t, w_r, w_t, tir = _split([0.0, 0.0, -1.0], n_ior=n_ior)
    r = ((n_ior - 1) / (n_ior + 1)) ** 2
    assert float(w_r[0]) == pytest.approx(r, rel=1e-5)
    assert float(w_t[0]) == pytest.approx(1 - r, rel=1e-5)
    assert not bool(tir[0])
    np.testing.assert_allclose(d_r[0].numpy(), [0, 0, 1], atol=1e-6)
    np.testing.assert_allclose(d_t[0].numpy(), [0, 0, -1], atol=1e-6)


def test_fresnel_energy_conservation():
    d = np.random.default_rng(0).normal(size=(1000, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    _, _, w_r, w_t, tir = _split(d)
    w_r, w_t, tir = w_r.numpy(), w_t.numpy(), tir.numpy()
    np.testing.assert_allclose(w_r + w_t, np.where(tir, w_r, 1.0), atol=1e-5)
    assert (w_r >= -1e-6).all() and (w_t >= -1e-6).all()


def test_snells_law():
    n_ior, theta1 = 1.31, np.deg2rad(35.0)
    _, d_t, _, _, tir = _split([np.sin(theta1), 0.0, -np.cos(theta1)], n_ior=n_ior)
    assert not bool(tir[0])
    dt = d_t[0].numpy() / np.linalg.norm(d_t[0].numpy())
    assert np.hypot(dt[0], dt[1]) == pytest.approx(np.sin(theta1) / n_ior, rel=1e-5)


def test_tir_critical_angle():
    crit = np.arcsin(1.0 / 1.31)
    for theta, expect_tir in [(crit - 0.01, False), (crit + 0.01, True)]:
        _, _, w_r, w_t, tir = _split([np.sin(theta), 0.0, np.cos(theta)])
        assert bool(tir[0]) == expect_tir, theta
        if expect_tir:
            assert float(w_r[0]) == pytest.approx(1.0)
            assert float(w_t[0]) == pytest.approx(0.0)


def _slab(g, p, d, from_face):
    m = len(p)
    rep = lambda a: a[None].expand((m,) + tuple(a.shape))  # noqa: E731
    return optics.slab_next_face(torch.tensor(p, dtype=torch.float32),
                                 torch.tensor(d, dtype=torch.float32),
                                 torch.tensor(from_face, dtype=torch.int32),
                                 rep(g.plane_n), rep(g.plane_d), rep(g.face_present))


def test_slab_next_face_prism():
    t, idx, found = _slab(regular_prism(2.0), [[0.0, 0, 0], [0, 0, 0]],
                          [[1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], [-1, -1])
    assert bool(found.all())
    assert int(idx[0]) == 2 and float(t[0]) == pytest.approx(geo.SQRT3_4, rel=1e-5)
    assert int(idx[1]) == 0 and float(t[1]) == pytest.approx(1.0, rel=1e-5)


def test_slab_excludes_source_face():
    _, _, found = _slab(regular_prism(2.0), [[0.0, 0.0, 1.0]], [[0.0, 0.0, 1.0]], [0])
    assert not bool(found[0])


def test_slab_interior_always_finds_exit():
    g = geo.prism_geom(1.3, [1.0, 0.9, 1.1, 1.0, 0.8, 1.2])
    rng = np.random.default_rng(7)
    n = 500
    plane_n, plane_d = g.plane_n.numpy(), g.plane_d.numpy()
    pts = []
    while len(pts) < n:
        c = rng.uniform(-0.7, 0.7, size=3).astype(np.float32)
        if (plane_n @ c + plane_d).max() < -1e-3:
            pts.append(c)
    p = np.stack(pts)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t, idx, found = _slab(g, p, d, [-1] * n)
    assert bool(found.all())
    slack = (p + t.numpy()[:, None] * d) @ plane_n.T + plane_d
    assert slack.max() < 1e-3
    np.testing.assert_allclose(slack[np.arange(n), idx.numpy()], 0.0, atol=1e-3)
