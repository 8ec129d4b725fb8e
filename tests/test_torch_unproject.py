"""The port's inverse projection (core/projection.py ``unproject``) and
display overlays (engine/overlay.py) on the CPU: twins of
tests/test_unproject.py over every lens, and ``unproject`` against the JAX
package's on every pixel of a 64 x 32 plan per lens (dual fisheyes with an
overlap of 0.2, so both halves and the overlap scale are exercised).

Tolerances: directions within 1e-5 (float32; both packages compute in the
same operation order, the rotation's sum aside); valid masks equal but for
pixels within one pixel of a lens edge, where a last-bit difference can
move a pixel across the edge: on these plans no pixel differs
(EDGE_FLIPS = 0 on every lens).
"""

import numpy as np
import pytest
import torch

from ice_halo_sim_tpu.config import schema as jax_schema
from ice_halo_sim_tpu.core import projection as jax_projection
from ice_halo_sim_tpu_torch.config import schema as port_schema
from ice_halo_sim_tpu_torch.config.schema import (
    GridLineParam,
    LensParam,
    LensType,
    RenderConfig,
    ViewParam,
    VisibleRange,
)
from ice_halo_sim_tpu_torch.core import projection
from ice_halo_sim_tpu_torch.engine.overlay import draw_overlays, draw_overlays_u8

ALL_LENSES = list(LensType)
DIR_ATOL = 1e-5
EDGE_FLIPS = 0


def _project_main(plan, w):
    return projection.project_components(plan, *w.unbind(-1)).main.numpy()


@pytest.mark.parametrize("lens_type", ALL_LENSES, ids=[t.name for t in ALL_LENSES])
def test_unproject_project_roundtrip(lens_type):
    cfg = RenderConfig(
        id=1,
        lens=LensParam(type=lens_type,
                       fov=120.0 if lens_type != LensType.RECTANGULAR else 360.0),
        resolution=(64, 32) if lens_type == LensType.RECTANGULAR else (48, 40),
        view=ViewParam(az=30, el=25, ro=10),
        visible=VisibleRange.FULL,
    )
    plan = projection.make_proj_plan(cfg)
    ys, xs = np.mgrid[0 : plan.height, 0 : plan.width]
    w, valid = projection.unproject(
        plan, xs.ravel().astype(np.float32), ys.ravel().astype(np.float32)
    )
    valid = valid.numpy()
    assert valid.any(), "no valid pixels"
    norms = np.linalg.norm(w.numpy()[valid], axis=-1)
    np.testing.assert_allclose(norms, 1.0, atol=1e-4)
    main = _project_main(plan, w)
    want = ys.ravel() * plan.width + xs.ravel()
    exact = (main[valid] == want[valid]).mean()
    assert exact > 0.95, f"round-trip exact rate {exact:.3f}"


def test_unproject_matches_known_direction():
    """Centre pixel of an el=90 fisheye looks at the zenith."""
    cfg = RenderConfig(
        id=1,
        lens=LensParam(type=LensType.FISHEYE_EQUAL_AREA, fov=120.0),
        resolution=(64, 64),
        view=ViewParam(az=0, el=90, ro=0),
        visible=VisibleRange.FULL,
    )
    plan = projection.make_proj_plan(cfg)
    w, valid = projection.unproject(plan, np.float32(32.0), np.float32(32.0))
    assert bool(valid)
    np.testing.assert_allclose(w.numpy(), [0.0, 0.0, -1.0], atol=1e-3)


def test_overlay_draws_22_degree_ring():
    cfg = RenderConfig(
        id=1,
        lens=LensParam(type=LensType.FISHEYE_EQUAL_AREA, fov=120.0),
        resolution=(128, 128),
        view=ViewParam(az=0, el=20, ro=0),
        visible=VisibleRange.FULL,
        central_grid=(GridLineParam(value=22.0, width=1.5, opacity=1.0,
                                    color=(1.0, 0.0, 0.0)),),
        celestial_outline=True,
    )
    plan = projection.make_proj_plan(cfg)
    img = np.zeros((128, 128, 3), np.float32)
    draw_overlays(img, cfg, plan, sun_azimuth_deg=0.0, sun_altitude_deg=20.0)
    red = (img[..., 0] > 0.5) & (img[..., 1] < 0.1)
    assert red.sum() > 50, "no 22-degree ring drawn"
    ys, xs = np.nonzero(red)
    w, _ = projection.unproject(plan, xs.astype(np.float32), ys.astype(np.float32))
    s = -w.numpy()
    alt = np.deg2rad(20.0)
    sun = np.array([np.cos(alt), 0.0, np.sin(alt)])
    ang = np.degrees(np.arccos(np.clip(s @ sun, -1, 1)))
    assert np.abs(ang - 22.0).max() < 2.0
    white = (img[..., 0] > 0.2) & (img[..., 1] > 0.2) & (img[..., 2] > 0.2)
    assert white.sum() > 20, "no celestial outline drawn"
    # The uint8 form draws the same lines onto a tone-mapped image.
    u8 = draw_overlays_u8(np.zeros((128, 128, 3), np.uint8), cfg, plan, 0.0, 20.0)
    assert u8.dtype == np.uint8 and (((u8[..., 0] > 127) & (u8[..., 1] < 26)) == red).all()


def test_overlay_noop_without_grids():
    cfg = RenderConfig(
        id=1,
        lens=LensParam(type=LensType.FISHEYE_EQUAL_AREA, fov=120.0),
        resolution=(32, 32),
        view=ViewParam(el=45),
        celestial_outline=False,
    )
    plan = projection.make_proj_plan(cfg)
    img = np.zeros((32, 32, 3), np.float32)
    out = draw_overlays(img, cfg, plan, 0.0, 45.0)
    assert (out == 0).all()


def _plan_pair(lens_type):
    def cfg(s):
        return s.RenderConfig(
            id=1,
            lens=s.LensParam(type=s.LensType(int(lens_type)),
                             fov=360.0 if lens_type == LensType.RECTANGULAR else 120.0),
            resolution=(64, 32), view=s.ViewParam(az=30, el=25, ro=10),
            visible=s.VisibleRange.FULL,
            overlap=0.2 if lens_type.name.startswith("DUAL") else 0.0,
        )
    return projection.make_proj_plan(cfg(port_schema)), \
        jax_projection.make_proj_plan(cfg(jax_schema))


def _near_edge(valid):
    """Pixels with a neighbour (8-connected) of the other validity."""
    v = np.pad(valid, 1, mode="edge")
    near = np.zeros_like(valid)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            near |= v[1 + dy:1 + dy + valid.shape[0], 1 + dx:1 + dx + valid.shape[1]] != valid
    return near


@pytest.mark.parametrize("lens_type", ALL_LENSES, ids=[t.name for t in ALL_LENSES])
def test_unproject_matches_jax(lens_type):
    plan, jplan = _plan_pair(lens_type)
    assert plan.r_scale == pytest.approx(jplan.r_scale) and plan.scale == pytest.approx(jplan.scale)
    ys, xs = np.mgrid[0:32, 0:64].astype(np.float32)
    w, valid = projection.unproject(plan, xs, ys)
    jw, jvalid = (np.asarray(a) for a in jax_projection.unproject(jplan, xs, ys))
    valid = valid.numpy()
    differ = valid != jvalid
    assert (differ <= _near_edge(jvalid)).all() and differ.sum() <= EDGE_FLIPS
    both = valid & jvalid
    assert both.sum() > 0
    np.testing.assert_allclose(w.numpy()[both], jw[both], rtol=0, atol=DIR_ATOL)
    assert w.dtype == torch.float32
