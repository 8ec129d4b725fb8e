"""The port's AoS layer (the JAX package's reference formulation under the
debug ray dump) against the JAX functions on the same inputs, made with
numpy from a seed: the Feistel bijection, the Fresnel split and the slab
exit face, the illuminant SPDs and the Chebyshev and lerp helpers, polygon
areas, the [B, 3] samplers and rotations, the entry sampler, trace_layer in
its three lowerings, and project.

Tolerances (those of tests/test_torch_stages.py and
tests/test_torch_trace_soa.py): integer and RNG outputs exact; float stages
rtol 2e-6 with an absolute floor of a few float32 ulps of the values'
scale, since torch and XLA round sin, cos, log, arcsin and a contracted
multiply-add differently in the last bit. Discrete decisions fed by floats
(the entry triangle, the slab's face, TIR, a pixel) may flip on a float
edge: EDGE_RAYS of the rays may differ there; all others agree, with the
trace's weights and directions at rtol 1e-5 (atol 1e-5 on directions, W_ATOL
on weights: near the TIR limit a square root of a difference near 0 turns an
ulp of a cosine into 1e-5 absolute).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ice_halo_sim_tpu.config.schema import AxisDistribution, Distribution, DistType
from ice_halo_sim_tpu.config.loader import load_project as jload
from ice_halo_sim_tpu.core import color as jcolor
from ice_halo_sim_tpu.core import geometry as jgeom
from ice_halo_sim_tpu.core import latlut
from ice_halo_sim_tpu.core import optics as joptics
from ice_halo_sim_tpu.core import projection as jproj
from ice_halo_sim_tpu.core import pyramid as jpyr
from ice_halo_sim_tpu.core import rng as jrng
from ice_halo_sim_tpu.core import sampling as jsamp
from ice_halo_sim_tpu.core import trace as jtrace
from ice_halo_sim_tpu_torch.config.loader import load_project
from ice_halo_sim_tpu_torch.core import (color, geometry, optics, projection, pyramid, rng,
                                         sampling, trace)

# Tier-1 runs six workers; keep each one to two torch threads.
torch.set_num_threads(2)

RTOL = 2e-6
EDGE_RAYS = 4
W_ATOL = 1e-5


def _close(got, want, scale=1.0, rtol=RTOL, ulps=4):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=ulps * 6e-8 * scale)


def _t(x):
    """A JAX or numpy array as a torch tensor (u32 as int64)."""
    a = np.array(x)
    return torch.as_tensor(a.astype(np.int64) if a.dtype == np.uint32 else a)


def _unit(g, n):
    d = g.normal(size=(n, 3)).astype(np.float32)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


@pytest.mark.parametrize("n", [2, 3, 5, 7, 16, 100, 1000, 4097])
def test_feistel_bijection_matches_jax(n):
    i = np.arange(n, dtype=np.uint32)
    for seed in (42, 0xDEADBEEF):
        want = np.asarray(jrng.feistel_bijection(jnp.asarray(i), n, jnp.uint32(seed)))
        got = rng.feistel_bijection(_t(i), n, seed).numpy()
        np.testing.assert_array_equal(got, want.astype(np.int64))


FRESNEL_OUTPUTS = ("d_reflect", "d_refract", "w_reflect", "w_refract", "is_tir")


def _fresnel_mismatch(name, got, want, cos, delta, atol=0.0, rtol=0.0):
    """None when got equals want within atol + rtol * |want| (NaN only
    against NaN), else a message naming the output, how many elements
    differ, and the first five with got, want and their ray's cos theta and
    delta."""
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape:
        return f"{name}: shape {got.shape} != {want.shape}"
    g64, w64 = got.astype(np.float64), want.astype(np.float64)
    nan = np.isnan(g64) | np.isnan(w64)
    bad = np.where(nan, np.isnan(g64) != np.isnan(w64),
                   np.abs(g64 - w64) > atol + rtol * np.abs(w64))
    if not bad.any():
        return None
    idx = np.argwhere(bad)
    lines = [f"{name}: {len(idx)} of {bad.size} elements differ (atol {atol:.3g}, rtol {rtol:.3g})"]
    for i in idx[:5]:
        ray, at = int(i[0]), tuple(i)
        lines.append(f"  {list(at)} got {got[at].item()!r} want {want[at].item()!r}"
                     f" cos {cos[ray]:.9g} delta {delta[ray]:.9g}")
    return "\n".join(lines)


def test_fresnel_split_matches_jax():
    """The TIR mask is compared bit for bit: these inputs keep every ray's
    |delta| at 1e-4 or more (8.7e-4 at seed 3, n 4096, over 1335 TIR
    rays), far beyond any rounding of cos theta, so no ray sits on the TIR
    edge. The four float outputs hold at rtol 1e-5: eagerly JAX and the
    port differ only where torch's CPU sqrt (MKL, within an ulp) rounds
    otherwise than XLA's, and under jit XLA also contracts multiply-adds."""
    g = np.random.default_rng(3)
    n = 4096
    d = _unit(g, n)
    nf = _unit(g, n)
    w = g.uniform(0.1, 2.0, n).astype(np.float32)
    ior = g.uniform(1.30, 1.32, n).astype(np.float32)
    cos = np.einsum("ij,ij->i", d.astype(np.float64), nf.astype(np.float64))
    rr = np.where(cos > 0, ior, 1.0 / ior.astype(np.float64))
    delta = (1.0 - rr * rr) / np.maximum(cos * cos, 1e-20) + rr * rr
    margin = np.abs(delta).min()
    assert margin >= 1e-4, f"a ray sits near the TIR edge: min |delta| {margin}"
    want = joptics.fresnel_split(jnp.asarray(d), jnp.asarray(nf), jnp.asarray(w),
                                 jnp.asarray(ior))
    got = optics.fresnel_split(_t(d), _t(nf), _t(w), _t(ior))
    errors = [_fresnel_mismatch(FRESNEL_OUTPUTS[4], got[4].numpy(), want[4], cos, delta)]
    errors += [_fresnel_mismatch(name, a.numpy(), b, cos, delta, atol=4 * 6e-8 * 2.0, rtol=1e-5)
               for name, a, b in zip(FRESNEL_OUTPUTS, got[:4], want[:4])]
    errors = [e for e in errors if e]
    assert not errors, "\n".join(errors)
    assert 0 < int(got[4].sum()) < n


def test_slab_next_face_matches_jax():
    g = np.random.default_rng(5)
    jg = jgeom.prism_geom(jnp.float32(1.3), jnp.asarray([1.0, 0.9, 1.1, 1.0, 0.8, 1.2],
                                                        jnp.float32))
    n = 2048
    p = g.uniform(-0.3, 0.3, (n, 3)).astype(np.float32)
    d = _unit(g, n)
    frm = g.integers(-1, 8, n).astype(np.int32)
    tile = lambda a: np.broadcast_to(np.asarray(a)[None], (n,) + np.asarray(a).shape)  # noqa
    args = (p, d, frm, tile(jg.plane_n), tile(jg.plane_d), tile(jg.face_present))
    want = joptics.slab_next_face(*(jnp.asarray(a) for a in args))
    got = optics.slab_next_face(*(_t(a) for a in args))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    _close(got[0], want[0], scale=4.0, rtol=1e-5)


@pytest.mark.parametrize("name", ["D50", "D55", "D65", "D75", "E", "A"])
def test_illuminant_spd_matches_jax_and_fast_form(name):
    wl = np.random.default_rng(7).uniform(300.0, 840.0, 4096).astype(np.float32)
    got = color.illuminant_spd(name, _t(wl))
    _close(got, jcolor.illuminant_spd(name, jnp.asarray(wl)), scale=150.0, rtol=1e-5)
    _close(color.illuminant_spd_fast(name, _t(wl)), got, scale=150.0)
    if name in color.ILLUMINANT_CCT:
        cct = color.ILLUMINANT_CCT[name]
        _close(color.daylight_cct_spd(cct, _t(wl)), jcolor.daylight_cct_spd(cct, jnp.asarray(wl)),
               scale=150.0, rtol=1e-5)
    with pytest.raises(ValueError):
        color.illuminant_spd("F2", _t(wl))


def test_chebyshev_helpers_and_dense_lerp_match_jax():
    g = np.random.default_rng(9)
    xs = np.linspace(380.0, 780.0, 401)
    ys = np.sin(xs / 37.0) + 0.1 * xs / 400.0
    coefs = color._chebfit_domain(xs, ys, 12, 380.0, 780.0)
    np.testing.assert_array_equal(coefs, jcolor._chebfit_domain(xs, ys, 12, 380.0, 780.0))
    t = g.uniform(-1.0, 1.0, 4096).astype(np.float32)
    _close(color._clenshaw(coefs, _t(t)), jcolor._clenshaw(coefs, jnp.asarray(t)), scale=2.0,
           rtol=1e-5)
    table = g.uniform(0.0, 3.0, 64).astype(np.float32)
    x = g.uniform(370.0, 1100.0, 4096).astype(np.float32)
    _close(color.dense_lerp(_t(x), 380.0, 10.0, table),
           jcolor.dense_lerp(jnp.asarray(x), 380.0, 10.0, table), scale=3.0)


@pytest.mark.parametrize("kind", ["prism", "pyramid"])
def test_polygon_areas_matches_jax(kind):
    g = np.random.default_rng(11)
    k = 16
    dist = g.uniform(0.5, 1.5, (k, 6)).astype(np.float32)
    h = g.uniform(0.2, 2.0, (3, k)).astype(np.float32)
    if kind == "prism":
        jg = jgeom.prism_geom_batch(jnp.asarray(h[0]), jnp.asarray(dist))
        tg = geometry.prism_geom_batch(_t(h[0]), _t(dist))
    else:
        h[0] /= 2.0
        h[2] /= 2.0
        jg = jpyr.pyramid_geom_batch(*(jnp.asarray(x) for x in h), 28.0, 35.0, jnp.asarray(dist))
        tg = pyramid.pyramid_geom_batch(*(_t(x) for x in h), 28.0, 35.0, _t(dist))
    _close(geometry.polygon_areas(tg), jax.vmap(jgeom.polygon_areas)(jg), scale=4.0, rtol=1e-5)


def test_sun_dirs_rotation_and_rotate_match_jax():
    g = np.random.default_rng(13)
    n = 4096
    idx = g.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    _close(sampling.sample_sun_dirs(0x1234, _t(idx), 40.0, 25.0, 0.5),
           jsamp.sample_sun_dirs(jnp.uint32(0x1234), jnp.asarray(idx), 40.0, 25.0, 0.5))
    lon, lat, roll = (g.uniform(-4.0, 4.0, n).astype(np.float32) for _ in range(3))
    rot_j = jsamp.build_rotation(*(jnp.asarray(a) for a in (lon, lat, roll)))
    rot = sampling.build_rotation(_t(lon), _t(lat), _t(roll))
    assert tuple(rot.shape) == (n, 3, 3)
    _close(rot, rot_j)
    v = g.normal(size=(n, 3)).astype(np.float32)
    _close(sampling.rotate(rot, _t(v)), jsamp.rotate(rot_j, jnp.asarray(v)), scale=4.0,
           rtol=1e-5)
    _close(sampling.rotate_inv(rot, _t(v)), jsamp.rotate_inv(rot_j, jnp.asarray(v)), scale=4.0,
           rtol=1e-5)


def _axis(kind):
    full = Distribution(DistType.UNIFORM, 0.0, 360.0)
    lat = {"full": Distribution(DistType.UNIFORM, 90.0, 360.0),
           "none": Distribution(DistType.NO_RANDOM, 70.0, 0.0),
           "legacy": Distribution(DistType.GAUSS_LEGACY, 80.0, 20.0),
           "lut": Distribution(DistType.GAUSS, 90.0, 2.0)}[kind]
    roll = Distribution(DistType.GAUSS, 10.0, 3.0)
    return AxisDistribution(azimuth=full, latitude=lat, roll=roll)


@pytest.mark.parametrize("kind", ["full", "none", "legacy", "lut"])
def test_lat_lon_roll_row_matches_jax(kind):
    """Each latitude path; the LUT path's inverse CDF and bin as well."""
    from ice_halo_sim_tpu_torch.core import latlut as tlatlut

    axis = _axis(kind)
    jparams = jsamp.make_axis_params([axis], [latlut.build_lat_lut(axis.latitude)])
    from ice_halo_sim_tpu_torch.config import schema

    taxis = schema.AxisDistribution(
        **{f: schema.Distribution(schema.DistType(int(getattr(axis, f).type)),
                                  getattr(axis, f).center, getattr(axis, f).spread)
           for f in ("azimuth", "latitude", "roll")})
    params = sampling.make_axis_params([taxis], [tlatlut.build_lat_lut(taxis.latitude)])
    n = 8192
    idx = np.random.default_rng(17).integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    want = jsamp.sample_lat_lon_roll_row(jnp.uint32(77), jnp.asarray(idx), jparams, 0)
    got = sampling.sample_lat_lon_roll_row(77, _t(idx), params, 0)
    for a, b in zip(got, want):
        _close(a, b, scale=8.0, rtol=1e-5)
    for a, b in zip(sampling.sample_lat_lon_roll(77, _t(idx), params), got):
        assert torch.equal(a, b)
    if kind == "lut":
        xi = np.random.default_rng(19).uniform(0.0, 1.0, n).astype(np.float32)
        th, cdf = params.lut_theta[0], params.lut_cdf[0]
        colat = sampling.invert_lat_lut(_t(xi), th, cdf)
        _close(colat, jsamp.invert_lat_lut(jnp.asarray(xi), jnp.asarray(th), jnp.asarray(cdf)),
               rtol=1e-5)
        np.testing.assert_array_equal(
            sampling.lat_lut_bin(colat, th).numpy(),
            np.asarray(jsamp.lat_lut_bin(jnp.asarray(colat.numpy()), jnp.asarray(th))))


def test_sample_entry_matches_jax():
    g = np.random.default_rng(23)
    jg = jgeom.prism_geom(jnp.float32(1.2), jnp.asarray([1.0, 0.8, 1.1, 1.0, 0.9, 1.2],
                                                        jnp.float32))
    jt = jsamp.build_entry_tris(jg)
    n = 4096
    bt_j = jsamp.EntryTris(*[jnp.broadcast_to(a, (n,) + a.shape) for a in jt])
    bt = sampling.EntryTris(*[_t(a) for a in bt_j])
    d = _unit(g, n)
    idx = np.arange(n, dtype=np.uint32)
    want = jsamp.sample_entry(jnp.uint32(5), jnp.asarray(idx), jnp.asarray(d), bt_j)
    got = sampling.sample_entry(5, _t(idx), _t(d), bt)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    same = got[1].numpy() == np.asarray(want[1])
    assert (~same).sum() <= EDGE_RAYS
    _close(got[0].numpy()[same], np.asarray(want[0])[same], scale=2.0, rtol=1e-5)
    _close(got[3].numpy()[same], np.asarray(want[3])[same], scale=8.0, rtol=1e-5)


def _jax_pool(kind, k):
    if kind == "one":
        g = jgeom.prism_geom_batch(jnp.asarray([1.1]), jnp.ones((1, 6), jnp.float32))
    elif kind == "prisms":
        g = jgeom.prism_geom_batch(jnp.linspace(0.4, 1.6, k),
                                   jnp.stack([jnp.linspace(0.8, 1.2, 6)] * k))
    else:
        g = jpyr.pyramid_geom_batch(jnp.linspace(0.1, 0.4, k), jnp.linspace(0.5, 1.2, k),
                                    jnp.full((k,), 0.25), 28.0, 28.0,
                                    jnp.ones((k, 6), jnp.float32))
    return jtrace.make_geom_pool(g, jax.vmap(jsamp.build_entry_tris)(g))


CASES = {
    # (pool kind, K, shape_idx, setting_blocks)
    "shared": ("one", 1, False, None),
    "shape-idx": ("prisms", 5, True, None),
    "geom-clock": ("prisms", 8, False, None),
    "setting-blocks": ("prisms", 8, False, ((3, 768), (5, 1280))),
    "pyramids": ("pyramids", 16, False, None),
}


@pytest.mark.parametrize("case", list(CASES))
def test_trace_layer_matches_jax(case):
    kind, k, by_idx, blocks = CASES[case]
    B, H = 2048, 7
    g = np.random.default_rng(29)
    jpool = _jax_pool(kind, k)
    pool = trace.GeomPool(*[_t(a) for a in jpool])
    idx = ((np.arange(B) + 4_294_960_000) & 0xFFFFFFFF).astype(np.uint32)
    d = -_unit(g, B)
    w0 = g.uniform(0.2, 2.0, B).astype(np.float32)
    w0[::97] = 0.0
    ior = g.uniform(1.305, 1.32, B).astype(np.float32)
    lon, lat, roll = (g.uniform(0, 2 * np.pi, B).astype(np.float32) for _ in range(3))
    shape_idx = g.integers(0, k, B).astype(np.int32) if by_idx else None
    rot_j = jsamp.build_rotation(*(jnp.asarray(a) for a in (lon, lat - np.pi / 2, roll)))
    want = jtrace.trace_layer(
        jnp.uint32(0x1234ABCD), jnp.asarray(idx), jnp.asarray(d), jnp.asarray(w0), rot_j,
        None if shape_idx is None else jnp.asarray(shape_idx), jpool, jnp.asarray(ior), H,
        setting_blocks=blocks)
    got = trace.trace_layer(
        0x1234ABCD, _t(idx), _t(d), _t(w0), _t(rot_j),
        None if shape_idx is None else _t(shape_idx), pool, _t(ior), H, setting_blocks=blocks)
    assert tuple(got.w.shape) == (B, H) and got.path.dtype == torch.int32
    np.testing.assert_array_equal(got.entry_ok.numpy(), np.asarray(want.entry_ok))
    gpath, wpath = got.path.numpy(), np.asarray(want.path)
    glive, wlive = got.w.numpy() > 0, np.asarray(want.w) > 0
    bad = (gpath != wpath).any(axis=1) | (glive != wlive).any(axis=1)
    assert int(bad.sum()) <= EDGE_RAYS, int(bad.sum())
    ok = ~bad
    assert wlive[ok].sum() > 2 * B
    np.testing.assert_array_equal(got.path_len.numpy()[ok], np.asarray(want.path_len)[ok])
    np.testing.assert_allclose(got.w.numpy()[ok], np.asarray(want.w)[ok], rtol=1e-5,
                               atol=W_ATOL * 2.0)
    gd, wd = got.d_world.numpy()[ok], np.asarray(want.d_world)[ok]
    np.testing.assert_allclose(gd[wlive[ok]], wd[wlive[ok]], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(trace.total_exit_weight(got).numpy()[ok],
                               np.asarray(jtrace.total_exit_weight(want))[ok], rtol=1e-5,
                               atol=W_ATOL * 2.0 * H)
    if case == "shared":
        scored = trace.trace_layer(
            0x1234ABCD, _t(idx), _t(d), _t(w0), _t(rot_j), None, pool, _t(ior), H,
            score_grad=True)
        assert torch.equal(scored.w, got.w) and torch.equal(scored.path, got.path)


@pytest.mark.parametrize("lens", ["linear", "fisheye_equal_area", "dual_fisheye_equal_area",
                                  "globe", "rectangular"])
def test_project_matches_jax(lens):
    """project on [B, 3] directions: exact pixels but on float edges (the
    rectangular map goes through arctan2 and arcsin)."""
    from ice_halo_sim_tpu_torch.scenes import BENCH_CFG

    doc = dict(BENCH_CFG)
    doc["render"] = [dict(BENCH_CFG["render"][0], lens={"type": lens, "fov": 80.0},
                          resolution=[192, 128])]
    jplan = jproj.make_proj_plan(jload(doc).renders[0])
    tplan = projection.make_proj_plan(load_project(doc).renders[0])
    d = _unit(np.random.default_rng(31), 8192)
    want = jproj.project(jplan, jnp.asarray(d))
    got = projection.project(tplan, _t(d))
    for a, b in zip(got, want):
        assert (a.numpy() != np.asarray(b)).sum() <= EDGE_RAYS
    assert (got.main.numpy() >= 0).sum() > 100


def test_d65_spd():
    """Twin of test_color.py's: D65 about 100 at 560 nm, E flat 1, A (2856
    K) rising toward red and about 100 at 560 nm."""
    wl = torch.tensor([450.0, 560.0, 700.0])
    spd = color.illuminant_spd("D65", wl).numpy()
    assert spd[1] == pytest.approx(100.0, rel=0.02) and (spd > 0).all()
    np.testing.assert_allclose(color.illuminant_spd("E", wl).numpy(), 1.0)
    a = color.illuminant_spd("A", wl).numpy()
    assert a[2] > a[1] > a[0]
    assert a[1] == pytest.approx(100.0, rel=0.05)
