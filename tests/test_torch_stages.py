"""Port per-ray stages against the JAX package on the same inputs (made
with numpy from a seed).

Tolerances: float stages agree within a few float32 ulps (rtol 2e-6, atol
a few ulps of the values' scale), because torch and XLA round sin, cos,
log, sqrt, atan2 and acos differently in the last bit on some inputs.
Discrete outputs (triangle choice, pixel) must agree except at a reported
handful of boundary cases where such an ulp crosses the decision."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bench import BENCH_CFG
from ice_halo_sim_tpu.config.loader import load_project
from ice_halo_sim_tpu_torch.config.loader import load_project as port_load_project
from ice_halo_sim_tpu.config.schema import AxisDistribution, Distribution, DistType, LensType
from ice_halo_sim_tpu.core import color as jcolor
from ice_halo_sim_tpu.core import geometry as jgeom
from ice_halo_sim_tpu.core import latlut
from ice_halo_sim_tpu.core import optics as joptics
from ice_halo_sim_tpu.core import projection as jproj
from ice_halo_sim_tpu.core import sampling as jsamp
from ice_halo_sim_tpu.core import trace_soa as jsoa
from ice_halo_sim_tpu_torch.core import color, geometry, optics, projection, sampling
from ice_halo_sim_tpu_torch.core import trace_soa

# Tier-1 runs six workers; keep each one to two torch threads.
torch.set_num_threads(2)

RTOL = 2e-6


def _close(got, want, scale=1.0, rtol=RTOL, ulps=4):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=ulps * 6e-8 * scale)


@pytest.fixture(scope="module")
def g():
    return np.random.default_rng(2024)


def test_optics(g):
    wl = g.uniform(300.0, 950.0, 4096).astype(np.float32)
    _close(optics.ice_refractive_index(torch.as_tensor(wl)),
           joptics.ice_refractive_index(jnp.asarray(wl)))
    delta = g.uniform(0.0, 3.0, 4096).astype(np.float32)
    rr = g.uniform(0.7, 1.4, 4096).astype(np.float32)
    _close(optics.reflect_ratio(torch.as_tensor(delta), torch.as_tensor(rr)),
           joptics.reflect_ratio(jnp.asarray(delta), jnp.asarray(rr)))


def test_color(g):
    wl = g.uniform(350.0, 840.0, 4096).astype(np.float32)
    _close(color.cmf_eval(torch.as_tensor(wl)), jcolor.cmf_eval(jnp.asarray(wl)),
           scale=2.0, rtol=1e-5)
    for name in ("D65", "D50", "E", "A"):
        _close(color.illuminant_spd_fast(name, torch.as_tensor(wl)),
               jcolor.illuminant_spd_fast(name, jnp.asarray(wl)), scale=100.0,
               rtol=1e-5)
    xyz = g.uniform(0.0, 50.0, (16, 32, 3)).astype(np.float32)
    for real in (True, False):
        a = color.post_process(torch.as_tensor(xyz), 1.0, 2.0e4, (0.0, 0.0, 0.1),
                               (1.0, 0.8, 0.6), use_real_color=real)
        b = np.asarray(jcolor.post_process(jnp.asarray(xyz), 1.0, 2.0e4,
                                           (0.0, 0.0, 0.1), (1.0, 0.8, 0.6),
                                           use_real_color=real))
        # uint8 output: a float ulp can cross a level boundary.
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1


@pytest.mark.parametrize("h, dist", [(1.2, [1.0] * 6), (0.3, [1.0, 0.6, 1.3, 0.9, 1.1, 0.8])])
def test_geometry_and_entry_tris(h, dist):
    tg = geometry.prism_geom(h, dist)
    jg = jgeom.prism_geom(jnp.float32(h), jnp.asarray(dist, jnp.float32))
    for f in ("plane_n", "plane_d", "face_vtx"):
        _close(getattr(tg, f), getattr(jg, f), scale=2.0)
    for f in ("face_present", "face_vtx_cnt", "face_number"):
        np.testing.assert_array_equal(getattr(tg, f).numpy(), np.asarray(getattr(jg, f)))
    tt = sampling.build_entry_tris(tg)
    jt = jsamp.build_entry_tris(jg)
    for f in ("v0", "e1", "e2", "cross_half"):
        _close(getattr(tt, f), getattr(jt, f), scale=2.0)
    np.testing.assert_array_equal(tt.face_idx.numpy(), np.asarray(jt.face_idx))
    pg = geometry.pad_geom_faces(tg, 20)
    jpg = jgeom.pad_geom_faces(jg, 20)
    np.testing.assert_array_equal(pg.face_present.numpy(), np.asarray(jpg.face_present))
    _close(pg.plane_d, jpg.plane_d, scale=1e6)


def _axes():
    D, T = Distribution, DistType
    full = D(T.UNIFORM, 0.0, 360.0)
    return {
        "full_sphere": AxisDistribution(azimuth=full, latitude=full, roll=full),
        "no_random": AxisDistribution(latitude=D(T.NO_RANDOM, 30.0, 0.0),
                                      azimuth=D(T.GAUSS, 10.0, 5.0),
                                      roll=D(T.ZIGZAG, 0.0, 20.0)),
        "gauss_legacy": AxisDistribution(latitude=D(T.GAUSS_LEGACY, 80.0, 30.0),
                                         roll=D(T.LAPLACIAN, 5.0, 3.0)),
        "lut": AxisDistribution(latitude=D(T.GAUSS, 70.0, 10.0), roll=full),
    }


@pytest.mark.parametrize("kind", list(_axes()))
def test_sample_rot_row_lut_loop(kind):
    axis = _axes()[kind]
    params = sampling.make_axis_params([axis], [latlut.build_lat_lut(axis.latitude)])
    jparams = jsamp.make_axis_params([axis], [latlut.build_lat_lut(axis.latitude)])
    assert int(params.lat_path[0]) == int(jparams.lat_path[0])
    for f in params._fields:
        np.testing.assert_array_equal(getattr(params, f), np.asarray(getattr(jparams, f)))
    idx = np.arange(4096, dtype=np.uint32) * 7919 + 5
    seed = 0x1234ABCD
    got = sampling.sample_rot_row(seed, torch.as_tensor(idx.astype(np.int64)), params, 0)
    want = jsamp.sample_rot_row(jnp.uint32(seed), jnp.asarray(idx), jparams, 0,
                                lut_loop=True)
    for a, b in zip(got, want):
        # Rotation entries in [-1, 1] from products of sin/cos; the LUT
        # path's pole flip is a discrete decision (rare ulp crossings).
        diff = np.abs(a.numpy() - np.asarray(b))
        bad = int((diff > 1e-5).sum())
        assert bad <= 2, (kind, bad)
        assert np.median(diff) < 1e-7


def test_sun_dirs_and_rot_apply():
    idx = np.arange(8192, dtype=np.uint32) + 99
    t = sampling.sample_sun_dirs_soa(0xBEEF, torch.as_tensor(idx.astype(np.int64)),
                                     30.0, 20.0, 0.5)
    j = jsamp.sample_sun_dirs_soa(jnp.uint32(0xBEEF), jnp.asarray(idx), 30.0, 20.0, 0.5)
    for a, b in zip(t, j):
        _close(a, b)
    r = [np.float32(x) for x in np.random.default_rng(3).normal(size=9)]
    _close(torch.stack(trace_soa.rot_apply(r, *t)),
           jnp.stack(jsoa.rot_apply(r, *[jnp.asarray(x.numpy()) for x in t])), scale=4)
    _close(torch.stack(trace_soa.rot_apply_inv(r, *t)),
           jnp.stack(jsoa.rot_apply_inv(r, *[jnp.asarray(x.numpy()) for x in t])), scale=4)


def test_fresnel_split_soa(g):
    d = g.normal(size=(3, 8192)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0)
    n = g.normal(size=(3, 8192)).astype(np.float32)
    n /= np.linalg.norm(n, axis=0)
    w = g.uniform(0.0, 100.0, 8192).astype(np.float32)
    nior = g.uniform(1.3, 1.33, 8192).astype(np.float32)
    got = trace_soa._fresnel_split_soa(*[torch.as_tensor(x) for x in (*d, *n, w, nior)])
    want = jsoa._fresnel_split_soa(*[jnp.asarray(x) for x in (*d, *n, w, nior)])
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))
    for a, b in zip(got[0] + got[1], want[0] + want[1]):
        _close(a, b, scale=4)
    _close(got[2], want[2], scale=100.0, rtol=1e-5)
    _close(got[3], want[3], scale=100.0, rtol=1e-5)


@pytest.mark.parametrize("lens", ["dual_fisheye_equal_area", "dual_fisheye_orthographic"])
def test_project_components_dual_fisheye(g, lens):
    doc = dict(BENCH_CFG)
    doc["render"] = [dict(BENCH_CFG["render"][0], lens={"type": lens, "fov": 180.0})]
    cfg = load_project(doc)
    tp = projection.make_proj_plan(port_load_project(doc).renders[0])
    jp = jproj.make_proj_plan(cfg.renders[0])
    for f in ("lens_type", "width", "height", "scale", "r_scale", "max_abs_dz"):
        assert getattr(tp, f) == getattr(jp, f)
    d = g.normal(size=(3, 1 << 16)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0)
    got = projection.project_components(tp, *[torch.as_tensor(x) for x in d])
    want = jproj.project_components(jp, *[jnp.asarray(x) for x in d])
    for a, b in zip(got, want):
        # Pixel = floor(...): an ulp of sqrt can cross a pixel edge.
        assert int((a.numpy() != np.asarray(b)).sum()) <= 4
    # Orthographic overlap is unsupported by design (no overlap band).
    n_ov = int((got.overlap.numpy() >= 0).sum())
    assert (n_ov > 0) == (lens == "dual_fisheye_equal_area")


_SINGLE_LENSES = [
    ("linear", 90.0, "full", [0, 0], {"azimuth": 0.0, "elevation": 0.0, "roll": 0.0}),
    ("linear", 60.0, "upper", [7, -5], {"azimuth": 30.0, "elevation": 20.0, "roll": 10.0}),
    ("fisheye_equal_area", 165.0, "full", [0, 0], {"elevation": 90.0}),
    ("fisheye_equal_area", 180.0, "lower", [-9, 4],
     {"azimuth": -40.0, "elevation": -60.0, "roll": 5.0}),
    ("fisheye_orthographic", 170.0, "upper", [3, 3], {"elevation": 90.0}),
    ("fisheye_orthographic", 120.0, "full", [0, 0],
     {"azimuth": 100.0, "elevation": 10.0, "roll": -20.0}),
    ("globe", 40.0, "full", [0, 0], {"azimuth": 0.0, "elevation": 0.0, "roll": 0.0}),
    ("globe", 30.0, "upper", [11, -6], {"azimuth": 60.0, "elevation": 35.0, "roll": 15.0}),
]


@pytest.mark.parametrize("lens, fov, visible, shift, view", _SINGLE_LENSES,
                         ids=[f"{c[0]}-{c[2]}-{i}" for i, c in enumerate(_SINGLE_LENSES)])
def test_project_components_single_lenses_and_globe(lens, fov, visible, shift, view):
    """Linear, fisheye equal-area / orthographic and globe: pixel indices
    EXACT on 10k seeded directions, invalid ones (behind the camera, outside
    the visible range or the image) included. These maps take no
    transcendental but sqrt and the divide, which round alike."""
    doc = dict(BENCH_CFG)
    doc["render"] = [{"id": 1, "lens": {"type": lens, "fov": fov}, "resolution": [192, 128],
                      "view": view, "visible": visible, "lens_shift": shift}]
    tp = projection.make_proj_plan(port_load_project(doc).renders[0])
    jp = jproj.make_proj_plan(load_project(doc).renders[0])
    assert tp.lens_type in projection.SUPPORTED_LENSES
    for f in ("lens_type", "width", "height", "visible", "shift_x", "shift_y", "scale",
              "r_scale", "max_abs_dz"):
        assert getattr(tp, f) == getattr(jp, f), f
    np.testing.assert_array_equal(tp.rot, jp.rot)
    d = np.random.default_rng(11).normal(size=(3, 10_000)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0)
    got = projection.project_components(tp, *[torch.as_tensor(x) for x in d])
    want = jproj.project_components(jp, *[jnp.asarray(x) for x in d])
    np.testing.assert_array_equal(got.main.numpy(), np.asarray(want.main))
    np.testing.assert_array_equal(got.overlap.numpy(), np.asarray(want.overlap))
    n_hit = int((got.main.numpy() >= 0).sum())
    assert 0 < n_hit < d.shape[1]           # valid and invalid rays both occur
    assert int(got.main.max()) < 192 * 128 and bool((got.overlap == -1).all())


def test_other_lenses_not_ported():
    """The lenses with inverse trig in their forward map stay outside the
    trace kernel path (SUPPORTED_LENSES is the kernel's set), in the port as
    in the JAX kernel; the general path projects them."""
    assert projection.SUPPORTED_LENSES == frozenset(
        int(t) for t in (LensType.LINEAR, LensType.FISHEYE_EQUAL_AREA,
                         LensType.FISHEYE_ORTHOGRAPHIC, LensType.DUAL_FISHEYE_EQUAL_AREA,
                         LensType.DUAL_FISHEYE_ORTHOGRAPHIC, LensType.GLOBE))
    z = torch.zeros(4)
    for lens in ("fisheye_equidistant", "fisheye_stereographic", "rectangular",
                 "dual_fisheye_equidistant", "dual_fisheye_stereographic"):
        doc = dict(BENCH_CFG)
        doc["render"] = [dict(BENCH_CFG["render"][0], lens={"type": lens, "fov": 120.0})]
        tp = projection.make_proj_plan(port_load_project(doc).renders[0])
        assert tp.lens_type not in projection.SUPPORTED_LENSES
        hits = projection.project_components(tp, z, z, z - 1)
        assert hits.main.dtype == torch.int32 and hits.main.shape == (4,)


_TRIG_LENSES = [
    ("fisheye_equidistant", 180.0, "full", [0, 0], {"elevation": 90.0}, 0.0),
    ("fisheye_equidistant", 120.0, "upper", [5, -3],
     {"azimuth": 30.0, "elevation": 40.0, "roll": 10.0}, 0.0),
    ("fisheye_stereographic", 180.0, "full", [0, 0], {"elevation": 90.0}, 0.0),
    ("fisheye_stereographic", 150.0, "lower", [-4, 6],
     {"azimuth": -70.0, "elevation": -50.0, "roll": 5.0}, 0.0),
    ("dual_fisheye_equidistant", 180.0, "full", [0, 0], {}, 0.0872),
    ("dual_fisheye_equidistant", 180.0, "full", [0, 0], {}, 0.0),
    ("dual_fisheye_stereographic", 180.0, "full", [0, 0], {}, 0.0872),
    ("rectangular", 360.0, "full", [0, 0], {"azimuth": 0.0, "elevation": 0.0, "roll": 0.0}, 0.0),
    ("rectangular", 360.0, "full", [0, 0], {"azimuth": 50.0, "elevation": 20.0, "roll": 0.0}, 0.0),
]
# arccos, tan, arctan2 and arcsin differ in the last bit between XLA and
# torch, so a direction on a pixel edge lands one pixel over: at most
# TRIG_FLIPS of the 20000 directions, each by one pixel in x or in y.
TRIG_FLIPS = 8


@pytest.mark.parametrize("lens, fov, visible, shift, view, overlap", _TRIG_LENSES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(_TRIG_LENSES)])
def test_project_components_inverse_trig_lenses(lens, fov, visible, shift, view, overlap):
    """The five lenses of the general path (fisheye equidistant and
    stereographic, their dual forms with the overlap band, rectangular)
    against the JAX function: equal plans; equal pixels but for the flip
    budget, a flipped direction moving by one pixel."""
    W, Hh = 256, 128
    doc = dict(BENCH_CFG)
    doc["render"] = [{"id": 1, "lens": {"type": lens, "fov": fov}, "resolution": [W, Hh],
                      "view": view, "visible": visible, "lens_shift": shift,
                      "overlap": overlap}]
    tp = projection.make_proj_plan(port_load_project(doc).renders[0])
    jp = jproj.make_proj_plan(load_project(doc).renders[0])
    for f in ("lens_type", "width", "height", "visible", "shift_x", "shift_y", "scale", "az0",
              "r_scale", "max_abs_dz"):
        assert getattr(tp, f) == getattr(jp, f), f
    np.testing.assert_array_equal(tp.rot, jp.rot)
    assert tp.lens_type not in projection.SUPPORTED_LENSES
    d = np.random.default_rng(13).normal(size=(3, 20_000)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0)
    d[:, :4] = [[0, 0, 1e-12, 1], [0, 0, 1e-12, 0], [1, -1, 0, 0]]      # the poles and the seam
    got = projection.project_components(tp, *[torch.as_tensor(x) for x in d])
    want = jproj.project_components(jp, *[jnp.asarray(x) for x in d])
    flips = 0
    for a, b in zip(got, want):
        a, b = a.numpy(), np.asarray(b)
        assert a.dtype == np.int32
        diff = a != b
        flips += int(diff.sum())
        both = diff & (a >= 0) & (b >= 0)
        dx = np.abs(a[both] % W - b[both] % W)
        dy = np.abs(a[both] // W - b[both] // W)
        # One pixel in x (or across the rectangular map's wrap) or in y.
        assert (((dx == 1) | (dx == W - 1)) & (dy == 0) | (dx == 0) & (dy == 1)).all()
    print(f"{lens}: {flips} of {d.shape[1]} directions flipped a pixel")
    assert flips <= TRIG_FLIPS, flips
    n_hit = int((got.main.numpy() >= 0).sum())
    assert n_hit > 2000 and int(got.main.max()) < W * Hh
    assert (int((got.overlap.numpy() >= 0).sum()) > 0) == (overlap > 0)
