"""Twins of tests/test_sampling.py and tests/test_incidence_oracle.py on the
port's samplers (core/sampling.py): the sun cone, the rotation convention,
orientation distributions and the projected-area entry law.

Oracles: closed-form cone geometry, rotation algebra, the sin-weighted
latitude density, and the incidence battery's analytic targets (float64
numpy, fan triangles re-derived from the geometry independently of the
sampler) with its comparators and their red-state check, on the committed
tests/data/golden_closed_form.npz shapes.
"""

import numpy as np
import pytest
import torch

from ice_halo_sim_tpu_torch.config.schema import AxisDistribution, DistType, Distribution
from ice_halo_sim_tpu_torch.core import geometry as geo
from ice_halo_sim_tpu_torch.core import pyramid
from ice_halo_sim_tpu_torch.core import sampling as smp
from ice_halo_sim_tpu_torch.core.latlut import build_lat_lut
from tests.test_incidence_oracle import DIRS, check_ac1, check_ac2

# Tier-1 runs six workers; keep each one to two torch threads.
torch.set_num_threads(2)

DATA = np.load("tests/data/golden_closed_form.npz")


def test_sun_cap_geometry():
    n = 20000
    alt, az, diam = 25.0, 40.0, 0.5
    d = smp.sample_sun_dirs(3, torch.arange(n), az, alt, diam).numpy()
    np.testing.assert_allclose(np.linalg.norm(d, axis=-1), 1.0, atol=1e-5)
    lon, lat = np.deg2rad(az + 180), np.deg2rad(-alt)
    center = np.array([np.cos(lon) * np.cos(lat), np.sin(lon) * np.cos(lat), np.sin(lat)])
    assert (d @ center).min() >= np.cos(np.deg2rad(diam / 2)) - 1e-6
    assert (d[:, 2] < 0).all()


def test_rotation_orthonormal_and_convention():
    f = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    r = smp.build_rotation(f(np.pi), f(np.pi / 2), f(0.0)).numpy()
    np.testing.assert_allclose(r, np.eye(3), atol=1e-6)
    lon, lat, roll = 0.7, 0.3, 1.9
    r = smp.build_rotation(f(lon), f(lat), f(roll)).numpy()
    np.testing.assert_allclose(r @ r.T, np.eye(3), atol=1e-5)
    expect = np.array([np.cos(lon) * np.cos(lat), np.sin(lon) * np.cos(lat), np.sin(lat)])
    np.testing.assert_allclose(r @ np.array([0.0, 0.0, 1.0]), expect, atol=1e-5)


def test_rotate_inverse_roundtrip():
    n = 100
    rs = np.random.default_rng(0)
    ang = [torch.as_tensor(rs.uniform(a, b, n), dtype=torch.float32)
           for a, b in ((0, 2 * np.pi), (-np.pi / 2, np.pi / 2), (0, 2 * np.pi))]
    rot = smp.build_rotation(*ang)
    v = torch.as_tensor(rs.normal(size=(n, 3)), dtype=torch.float32)
    np.testing.assert_allclose(smp.rotate(rot, smp.rotate_inv(rot, v)).numpy(), v.numpy(),
                               atol=1e-4)


def _params(axis):
    return smp.make_axis_params([axis], [build_lat_lut(axis.latitude)])


def _axis(lat):
    return AxisDistribution(azimuth=Distribution(DistType.UNIFORM, 0.0, 360.0), latitude=lat,
                            roll=Distribution(DistType.UNIFORM, 0.0, 360.0))


def test_full_sphere_uniform_z():
    params = _params(_axis(Distribution(DistType.UNIFORM, 90.0, 360.0)))
    n = 50000
    _, lat, _ = smp.sample_lat_lon_roll(5, torch.arange(n), params, torch.zeros(n))
    z = np.sin(lat.numpy())
    assert abs(z.mean()) < 0.01
    hist, _ = np.histogram(z, bins=10, range=(-1, 1))
    assert hist.min() > 0.9 * n / 10 * 0.9


def test_gauss_latitude_area_measure():
    """zenith ~ gauss(0, sigma): the colatitude is Rayleigh(sigma) (the
    sin-weighted density), mean sigma sqrt(pi / 2)."""
    sigma = 2.0
    params = _params(_axis(Distribution(DistType.GAUSS, 90.0, sigma)))
    n = 100000
    _, lat, _ = smp.sample_lat_lon_roll(9, torch.arange(n), params, torch.zeros(n))
    theta_deg = np.rad2deg(np.pi / 2 - lat.numpy())
    assert theta_deg.mean() == pytest.approx(sigma * np.sqrt(np.pi / 2), rel=0.05)


def test_no_random_latitude():
    params = _params(_axis(Distribution(DistType.NO_RANDOM, 90.0, 0.0)))
    _, lat, _ = smp.sample_lat_lon_roll(1, torch.arange(100), params, torch.zeros(100))
    np.testing.assert_allclose(lat.numpy(), np.pi / 2, atol=1e-6)


def test_latitude_lookup_in_passes_equals_one_pass(monkeypatch):
    """The inverse-CDF latitude lookup over more than LUT_CHUNK rays, in
    passes, gives each ray the value of one pass."""
    lut = build_lat_lut(Distribution(DistType.GAUSS, 90.0, 1.2))
    xi = torch.rand(5000, generator=torch.Generator().manual_seed(2))
    whole = smp._invert_lat_lut_loop(xi, lut.theta, lut.cdf)
    monkeypatch.setattr(smp, "LUT_CHUNK", 700)
    passes = smp._invert_lat_lut_loop(xi, lut.theta, lut.cdf)
    assert torch.equal(whole.view(torch.int32), passes.view(torch.int32))


def _tris(geom, n):
    tris = smp.build_entry_tris(geom)
    return smp.EntryTris(*[a.expand((n,) + tuple(a.shape)) for a in tris])


def test_entry_sampling_projected_area():
    """Straight down: always the top basal face (slot 0); along -x: side
    slots 2, 3, 7 at 1/2, 1/4, 1/4; 45 degrees: by projected area."""
    g = geo.prism_geom(1.0, [1.0] * 6)
    n = 20000
    idx = torch.arange(n)
    bt = _tris(g, n)
    ray = lambda v: torch.tensor([v], dtype=torch.float32).repeat(n, 1)  # noqa: E731
    p, face, ok, _ = smp.sample_entry(2, idx, ray([0.0, 0.0, -1.0]), bt)
    assert bool(ok.all()) and (face.numpy() == 0).all()
    pn = p.numpy()
    np.testing.assert_allclose(pn[:, 2], 0.5, atol=1e-5)
    assert abs(pn[:, 0].mean()) < 0.01 and abs(pn[:, 1].mean()) < 0.01

    _, face, _, _ = smp.sample_entry(2, idx, ray([-1.0, 0.0, 0.0]), bt)
    f = face.numpy()
    assert set(np.unique(f)) == {2, 3, 7}
    assert (f == 2).mean() == pytest.approx(0.5, abs=0.02)
    assert (f == 3).mean() == pytest.approx(0.25, abs=0.02)

    s, c = np.sin(np.deg2rad(45.0)), np.cos(np.deg2rad(45.0))
    _, face, _, _ = smp.sample_entry(2, idx, ray([-s, 0.0, -c]), bt)
    f = face.numpy()
    w_top = 3 * np.sqrt(3) / 2 * 0.25 * c
    w_side0 = 0.5 * s
    total = w_top + w_side0 + 2 * 0.5 * s * 0.5
    assert (f == 0).mean() == pytest.approx(w_top / total, abs=0.02)
    assert (f == 2).mean() == pytest.approx(w_side0 / total, abs=0.02)


def test_entry_sampling_empty_crystal():
    n = 16
    _, _, ok, _ = smp.sample_entry(0, torch.arange(n),
                                   torch.tensor([[0.0, 0.0, -1.0]]).repeat(n, 1),
                                   _tris(geo.prism_geom(0.0, [1.0] * 6), n))
    assert not bool(ok.any())


# --- the incidence oracle (tests/test_incidence_oracle.py's comparators) ---

def drive_sampler(geom, d, n, seed):
    d_local = torch.as_tensor(np.asarray(d, np.float32))[None, :].expand(n, 3)
    p, face, ok = smp.sample_entry(seed, torch.arange(n), d_local, _tris(geom, n))[:3]
    ok = ok.numpy()
    return p.numpy().astype(np.float64)[ok], face.numpy()[ok]


def _prism():
    return geo.prism_geom(1.2, DATA["kPrismWellConditionedSamples"][0])


@pytest.mark.parametrize("di", range(len(DIRS)))
def test_prism_entry_distribution_matches_oracle(di):
    geom, d, n = _prism(), DIRS[di], 200_000
    p, face = drive_sampler(geom, d, n, seed=17 + di)
    assert not check_ac1(geom, d, p, face, n), check_ac1(geom, d, p, face, n)
    assert not check_ac2(geom, d, p, face), check_ac2(geom, d, p, face)


def test_pyramid_entry_distribution_matches_oracle():
    s = DATA["kPyramidWellConditionedSamples"][0]
    geom = pyramid.pyramid_geom(float(s[2]), float(s[3]), float(s[4]), float(s[0]),
                                float(s[1]), s[5:11])
    d, n = DIRS[1], 200_000
    p, face = drive_sampler(geom, d, n, seed=29)
    assert not check_ac1(geom, d, p, face, n), check_ac1(geom, d, p, face, n)
    assert not check_ac2(geom, d, p, face), check_ac2(geom, d, p, face)


def test_red_state_comparator_has_teeth():
    """A wrong target (unprojected areas) is flagged for an oblique ray."""
    geom, d, n = _prism(), DIRS[1], 200_000
    p, face = drive_sampler(geom, d, n, seed=31)
    assert check_ac1(geom, d, p, face, n, projected=False)
