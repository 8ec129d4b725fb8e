"""The port's differentiable render (``engine/gradient.py``) and its parts:
the CMF lookup, the continuous projection and the bilinear splat against
the JAX functions (values, and autograd against jax.grad); the shape
geometry's graph; the whole render in each gradient mode against the
committed JAX render (tests/data/torch_port_grad_ref.npz, the tolerances of
``grad_validation``); and twins of tests/test_gradient.py on the port.

Tolerances: float32 functions in the same operation order agree to rtol
1e-6 (values) and 1e-5 (gradients, which go through a few more roundings);
XLA may contract a multiply and an add where torch does not.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ice_halo_sim_tpu.config.loader import load_project as jax_load_project
from ice_halo_sim_tpu.core import color as jcolor
from ice_halo_sim_tpu.core import geometry as jgeometry
from ice_halo_sim_tpu.core import projection as jprojection
from ice_halo_sim_tpu.core import sampling as jsampling
from ice_halo_sim_tpu.core import trace_soa as jtrace_soa
from ice_halo_sim_tpu_torch import grad_validation
from ice_halo_sim_tpu_torch.config.loader import load_project
from ice_halo_sim_tpu_torch.core import color, geometry, projection, sampling, trace_soa
from ice_halo_sim_tpu_torch.engine import gradient
from ice_halo_sim_tpu_torch.engine.gradient import RenderParams, default_params, make_render_fn

# Tier-1 runs six workers; keep each one to two torch threads.
torch.set_num_threads(2)

# tests/test_gradient.py's plate scene.
CFG = {
    "crystal": [
        {"id": 1, "type": "prism", "shape": {"height": 0.3},
         "axis": {"zenith": {"type": "gauss", "mean": 90, "std": 1.5},
                  "azimuth": {"type": "uniform", "mean": 0, "std": 360},
                  "roll": {"type": "uniform", "mean": 0, "std": 360}}}
    ],
    "filter": [],
    "scene": {
        "light_source": {"type": "sun", "altitude": 25, "azimuth": 0, "diameter": 0.5,
                         "spectrum": [{"wavelength": 550, "weight": 1.0}]},
        "ray_num": 100000, "max_hits": 5,
        "scattering": [{"prob": 0.0, "entries": [{"crystal": 1, "proportion": 100}]}],
    },
    "render": [
        {"id": 1, "lens": {"type": "fisheye_equal_area", "fov": 150},
         "resolution": [96, 96], "view": {"elevation": 90}, "visible": "full"}
    ],
}

LENSES = ["linear", "fisheye_equal_area", "fisheye_equidistant", "fisheye_stereographic",
          "fisheye_orthographic"]


def smooth_loss(img):
    """tests/test_gradient.py's Gaussian-window-weighted radiance."""
    h, w, _ = img.shape
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32),
                            torch.arange(w, dtype=torch.float32), indexing="ij")
    win = torch.exp(-(((xx - w / 2) ** 2 + (yy - h * 0.3) ** 2) / (2 * 8.0**2)))
    return torch.sum(img[..., 1] * win)


def _render_doc(lens, visible="upper"):
    return {**CFG, "render": [{"id": 1, "lens": {"type": lens, "fov": 120},
                               "resolution": [64, 48], "view": {"elevation": 60},
                               "visible": visible, "lens_shift": [3, -2]}]}


def _dirs(n, seed):
    d = np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32)
    return d / np.linalg.norm(d, axis=1, keepdims=True)


def test_cmf_lookup_matches_jax_exactly():
    wl = np.concatenate([np.linspace(340.0, 850.0, 2003), [359.5, 359.49, 830.49, 830.5,
                                                          550.5, 549.5]]).astype(np.float32)
    got = color.cmf_lookup(torch.as_tensor(wl)).numpy()
    want = np.asarray(jcolor.cmf_lookup(jnp.asarray(wl)))
    assert got.shape == (wl.shape[0], 3) and (got[0] == 0).all() and (got[-3] == 0).all() \
        and (got[-2] > 0).all()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("lens", LENSES)
def test_project_continuous_matches_jax(lens):
    """Validity equals the JAX function's; pixel coordinates and the
    gradient of a weighted sum of (fx, fy) to the directions agree (rtol
    1e-5 and 1e-4: arccos and tan differ in the last bit between XLA and
    torch)."""
    jplan = jprojection.make_proj_plan(jax_load_project(_render_doc(lens)).renders[0])
    plan = projection.make_proj_plan(load_project(_render_doc(lens)).renders[0])
    d = _dirs(4096, 5)
    a, b = np.random.default_rng(6).uniform(-1, 1, (2, 4096)).astype(np.float32)

    def jloss(w):
        fx, fy, valid = jprojection.project_continuous(jplan, w)
        return jnp.sum(jnp.where(valid, a * fx + b * fy, 0.0))

    jfx, jfy, jvalid = jprojection.project_continuous(jplan, jnp.asarray(d))
    jg = np.asarray(jax.grad(jloss)(jnp.asarray(d)))
    w = torch.as_tensor(d).requires_grad_(True)
    fx, fy, valid = projection.project_continuous(plan, w)
    (g,) = torch.autograd.grad(torch.sum(torch.where(valid, torch.as_tensor(a) * fx
                                                     + torch.as_tensor(b) * fy, 0.0)), w)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    # Rays that land on or near the image (a ray at the lens's horizon
    # lands thousands of pixels out, where one ulp is a large distance).
    v = valid.numpy() & (np.abs(np.asarray(jfx) - 32) < 64) & (np.abs(np.asarray(jfy) - 24) < 48)
    assert 0.1 < v.mean() < 0.9
    np.testing.assert_allclose(fx.detach().numpy()[v], np.asarray(jfx)[v], rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(fy.detach().numpy()[v], np.asarray(jfy)[v], rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(g.numpy()[v], jg[v], rtol=1e-4, atol=1e-5 * np.abs(jg[v]).max())


def test_project_continuous_rejects_other_lenses():
    plan = projection.make_proj_plan(load_project(_render_doc("dual_fisheye_equal_area"))
                                     .renders[0])
    with pytest.raises(NotImplementedError, match="single-lens family"):
        projection.project_continuous(plan, torch.as_tensor(_dirs(8, 1)))


def test_splat_bilinear_matches_jax():
    """The image equals the JAX splat's up to the order of the additions,
    and the gradients to fx, fy and the values agree (rows off the image,
    on its edges and invalid rows included)."""
    W, H, n = 24, 16, 3000
    g = np.random.default_rng(9)
    fx = g.uniform(-2.0, W + 2.0, n).astype(np.float32)
    fy = g.uniform(-2.0, H + 2.0, n).astype(np.float32)
    fx[:20] = np.round(fx[:20]) + 0.5                    # on pixel centres
    valid = g.random(n) < 0.9
    vals = g.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    wimg = g.normal(size=(H * W, 3)).astype(np.float32)

    def jloss(fx, fy, v):
        acc = jprojection.splat_bilinear(jnp.zeros((H * W, 3)), fx, fy, jnp.asarray(valid),
                                         v, W, H)
        return jnp.sum(acc * wimg), acc

    (_, jacc), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(fx), jnp.asarray(fy), jnp.asarray(vals))
    ts = [torch.as_tensor(x).requires_grad_(True) for x in (fx, fy, vals)]
    acc = projection.splat_bilinear(torch.zeros((H * W, 3)), ts[0], ts[1],
                                    torch.as_tensor(valid), ts[2], W, H)
    tg = torch.autograd.grad(torch.sum(acc * torch.as_tensor(wimg)), ts)
    np.testing.assert_allclose(acc.detach().numpy(), np.asarray(jacc), rtol=1e-5, atol=1e-6)
    for a, b in zip(tg, jg):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=1e-5 * np.abs(b).max())


def test_rot_components_matches_jax():
    g = np.random.default_rng(2)
    ang = [g.uniform(-7, 7, 1000).astype(np.float32) for _ in range(3)]
    got = trace_soa.rot_components(*[torch.as_tensor(a) for a in ang])
    want = jtrace_soa.rot_components(*[jnp.asarray(a) for a in ang])
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)


def test_prism_geometry_keeps_the_graph():
    """Plane distances, vertices and entry triangles carry the gradient of
    height and face distances (through the cross-section's sort and
    gathers) as the JAX functions do."""
    h0 = np.float32(0.7)
    fd0 = np.array([1.0, 0.8, 1.2, 0.9, 1.1, 0.6], np.float32)
    g = np.random.default_rng(4)
    w = {k: g.normal(size=s).astype(np.float32) for k, s in
         (("d", (8,)), ("v", (8, 12, 3)), ("c", (32, 3)), ("v0", (32, 3)), ("e1", (32, 3)))}

    def jloss(h, fd):
        geo = jgeometry.prism_geom(h, fd)
        tr = jsampling.build_entry_tris(geo)
        return (jnp.sum(geo.plane_d * w["d"]) + jnp.sum(geo.face_vtx * w["v"])
                + jnp.sum(tr.cross_half * w["c"]) + jnp.sum(tr.v0 * w["v0"])
                + jnp.sum(tr.e1 * w["e1"]))

    jg = jax.grad(jloss, argnums=(0, 1))(jnp.float32(h0), jnp.asarray(fd0))
    h = torch.tensor(h0, requires_grad=True)
    fd = torch.tensor(fd0, requires_grad=True)
    geo = geometry.prism_geom(h, fd)
    tr = sampling.build_entry_tris(geo)
    t = {k: torch.as_tensor(v) for k, v in w.items()}
    loss = (torch.sum(geo.plane_d * t["d"]) + torch.sum(geo.face_vtx * t["v"])
            + torch.sum(tr.cross_half * t["c"]) + torch.sum(tr.v0 * t["v0"])
            + torch.sum(tr.e1 * t["e1"]))
    gh, gfd = torch.autograd.grad(loss, (h, fd))
    assert float(gh) != 0.0 and (gfd.numpy() != 0).all()
    np.testing.assert_allclose(float(gh), float(jg[0]), rtol=1e-5)
    np.testing.assert_allclose(gfd.numpy(), np.asarray(jg[1]), rtol=1e-5, atol=1e-5)


def test_the_port_matches_the_committed_jax_render():
    """Every mode against tests/data/torch_port_grad_ref.npz: recorded
    choices within FLIP_RAYS, the frozen and hard images at the engine's
    tolerance, the soft image within IMG_L1, every gradient within
    GRAD_RTOL (the file's base params go through params_from_jax, its
    choices through choices_from_jax)."""
    errs = grad_validation.fixture_check("cpu")
    assert errs["flipped_rays"] <= grad_validation.FLIP_RAYS


def test_render_fn_runs_and_is_finite():
    cfg = load_project(CFG)
    img = make_render_fn(cfg, batch_size=1 << 13, seed=3, device="cpu")(
        default_params(cfg, device="cpu"))
    assert tuple(img.shape) == (96, 96, 3)
    assert torch.isfinite(img).all()
    assert float(img.sum()) > 0


def test_gradient_wrt_orientation_distribution():
    cfg = load_project(CFG)
    fn = make_render_fn(cfg, batch_size=1 << 14, seed=9, device="cpu")
    params = default_params(cfg, device="cpu")
    m = params.zenith_mean_deg.clone().requires_grad_(True)
    s = params.zenith_std_deg.clone().requires_grad_(True)
    g = torch.autograd.grad(
        smooth_loss(fn(params._replace(zenith_mean_deg=m, zenith_std_deg=s))), (m, s))
    assert all(np.isfinite(float(x)) for x in g)
    assert any(float(x) != 0.0 for x in g)


def test_gradient_wrt_face_distance():
    cfg = load_project(CFG)
    fn = make_render_fn(cfg, batch_size=1 << 14, seed=7, device="cpu")
    params = default_params(cfg, device="cpu")
    fd = params.face_distance.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(smooth_loss(fn(params._replace(face_distance=fd))), fd)
    assert torch.isfinite(g).all()
    assert float(g.abs().sum()) > 0


def test_smooth_transport_gradient_matches_fd_tightly():
    """Fresnel + rotation + continuous projection + bilinear splat with no
    discrete choice: autograd equals centred finite differences within
    2.5% at eps = 1e-3 (f32 FD carries about 1% roundoff of its own)."""
    pplan = projection.make_proj_plan(load_project(CFG).renders[0])
    B = 512
    g = np.random.default_rng(3)
    d = g.normal(size=(B, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    dx, dy, dz = (torch.as_tensor(d[:, i]) for i in range(3))
    w = torch.as_tensor(g.uniform(0.2, 1.0, B).astype(np.float32))
    n = np.array([0.2673, 0.5345, 0.8018], np.float32)
    n = [torch.tensor(c) for c in n / np.float32(np.sqrt((n * n).sum()))]

    def loss(theta):
        c, s = torch.cos(theta), torch.sin(theta)
        rx = c * dx + s * dz
        rz = -s * dx + c * dz
        _, (tx, ty, tz), _, w_t, _ = trace_soa._fresnel_split_soa(
            rx, dy, rz, *n, w, torch.tensor(1.31))
        dd = torch.stack([tx, ty, tz], dim=-1)
        dd = dd / torch.linalg.norm(dd, dim=-1, keepdim=True)
        fx, fy, valid = projection.project_continuous(pplan, dd)
        acc = projection.splat_bilinear(
            torch.zeros((pplan.height * pplan.width, 3)), fx, fy, valid & (w_t > 0),
            torch.stack([w_t, w_t, w_t], dim=-1), pplan.width, pplan.height)
        return smooth_loss(acc.reshape(pplan.height, pplan.width, 3))

    theta = torch.tensor(0.2, requires_grad=True)
    (gr,) = torch.autograd.grad(loss(theta), theta)
    eps = 1e-3
    with torch.no_grad():
        fd = (float(loss(torch.tensor(0.2 + eps))) - float(loss(torch.tensor(0.2 - eps)))) / (
            2 * eps)
    assert abs(fd) > 0
    assert abs(float(gr) - fd) <= 0.025 * abs(fd) + 1e-6, (float(gr), fd)


def test_entry_points_refuse_without_a_cuda_device(monkeypatch):
    """The default device is CUDA: with none, every entry point raises
    instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = load_project(CFG)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_render_fn(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        default_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        gradient.params_from_jax([np.float32(1.0)] * 5)
    with pytest.raises(RuntimeError, match="CUDA"):
        grad_validation.main(["table", "--rays", "4", "--batch", "4"])


# --- Twins of tests/test_gradient.py's slow tests ---------------------------

def _blur_loss(img):
    """tests/test_gradient.py's smooth_loss over a sigma = 2 px Gaussian blur
    of the Y channel (zero padding, 'same' size)."""
    k = torch.as_tensor(np.exp(-np.arange(-6, 7) ** 2 / (2 * 2.0**2)), dtype=torch.float32)
    k = k / k.sum()
    y = img[..., 1]
    yb = torch.nn.functional.conv2d(y[None, None], k.reshape(1, 1, 1, 13), padding=(0, 6))
    yb = torch.nn.functional.conv2d(yb, k.reshape(1, 1, 13, 1), padding=(6, 0))[0, 0]
    return smooth_loss(torch.stack([yb, yb, yb], dim=-1))


@pytest.fixture(scope="module")
def frozen_setup():
    cfg = load_project(CFG)
    render_frozen, record = make_render_fn(cfg, batch_size=1 << 16, seed=11, frozen_mode=True,
                                           device="cpu")
    params = default_params(cfg, device="cpu")._replace(
        zenith_mean_deg=torch.tensor(87.0))
    with torch.no_grad():
        _, choices = record(params)
    return render_frozen, params, choices


@pytest.mark.slow
@pytest.mark.parametrize("field,eps,tol", [
    ("sun_altitude_deg", 1.0, 0.05),
    ("zenith_mean_deg", 0.25, 0.10),
    ("zenith_std_deg", 0.01, 0.10),
])
def test_frozen_selection_fd_per_parameter(frozen_setup, field, eps, tol):
    render_frozen, params, choices = frozen_setup

    def loss(v):
        return _blur_loss(render_frozen(params._replace(**{field: v}), choices))

    v = getattr(params, field).clone().requires_grad_(True)
    (g,) = torch.autograd.grad(loss(v), v)
    v0 = float(getattr(params, field))
    with torch.no_grad():
        fd = (float(loss(torch.tensor(v0 + eps))) - float(loss(torch.tensor(v0 - eps)))) / (
            2 * eps)
    assert abs(fd) > 0, field
    assert np.isfinite(float(g))
    assert abs(float(g) - fd) <= tol * abs(fd) + 1e-6, (field, float(g), fd)


@pytest.mark.slow
def test_frozen_shape_transport_is_exactly_zero(frozen_setup):
    """For a prism, exit directions and Fresnel weights depend only on the
    face normals, so with every choice frozen the image does not depend on
    the shape scalars: autograd finds no path from them to the image (its
    gradient is 0, as jax.grad's is) and FD is exactly 0."""
    render_frozen, params, choices = frozen_setup
    h = params.height.clone().requires_grad_(True)
    fd = params.face_distance.clone().requires_grad_(True)
    loss = _blur_loss(render_frozen(params._replace(height=h, face_distance=fd), choices))
    assert not loss.requires_grad
    with torch.no_grad():
        lp = float(_blur_loss(render_frozen(params._replace(height=torch.tensor(0.35)),
                                            choices)))
        lm = float(_blur_loss(render_frozen(params._replace(height=torch.tensor(0.25)),
                                            choices)))
    assert lp == lm


def test_render_params_fields_match_jax():
    from ice_halo_sim_tpu.engine.gradient import RenderParams as JRenderParams

    assert RenderParams._fields == JRenderParams._fields
    assert trace_soa.FrozenChoices._fields == jtrace_soa.FrozenChoices._fields


def test_time_modes_measures_every_mode():
    """The card's timing of the gradient path (chip_smoke.py [7]) runs its
    three modes; on the CPU it reports the host clock only, under the CPU's
    name."""
    rows = grad_validation.time_modes(1024, "cpu", reps=1)
    assert [r["mode"] for r in rows] == ["hard", "soft_tau=0.005", "frozen"]
    for r in rows:
        assert r["device"] == "cpu" and "kernels" not in r and "card" not in r
        assert r["fwd_ms"] > 0 and r["fwd_bwd_ms"] > 0
