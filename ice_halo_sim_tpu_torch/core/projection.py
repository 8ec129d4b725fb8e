"""Lens projection (port of the forward maps of
``ice_halo_sim_tpu.core.projection``, all eleven lenses).

``make_proj_plan`` resolves a render's parameters on the host exactly as
the JAX package does. ``project_components`` maps exit directions to pixels
in the same float32 operation order as the JAX function (``project`` on
[B, 3] directions). The six lenses
without inverse trig in their forward math (``SUPPORTED_LENSES``: linear,
fisheye equal-area and orthographic, their dual forms, globe) are the ones
the trace kernel takes; fisheye equidistant and stereographic, their dual
forms and rectangular go through arccos, tan, arctan2 and arcsin, whose last
bit differs between XLA, torch on the CPU and CUDA, so a direction on a
pixel edge may land one pixel over. ``unproject`` maps pixel centres back
to world directions for every lens (the display-time overlays of
engine/overlay.py).

``project_continuous`` and ``splat_bilinear`` are the differentiable
projection of the gradient path (engine/gradient.py): continuous pixel
coordinates of the single-lens family and a bilinear 4-neighbour
scatter-add, through which autograd reaches the ray directions.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

from ice_halo_sim_tpu_torch.config.schema import LensType, RenderConfig, VisibleRange
from ice_halo_sim_tpu_torch.core.bits import I32, I64, sdiv

# Lenses the trace kernel takes (plain twin and CUDA): the six of the JAX
# trace kernel. The general trace path renders all eleven.
SUPPORTED_LENSES = frozenset(
    int(t) for t in (
        LensType.LINEAR,
        LensType.FISHEYE_EQUAL_AREA,
        LensType.FISHEYE_ORTHOGRAPHIC,
        LensType.DUAL_FISHEYE_EQUAL_AREA,
        LensType.DUAL_FISHEYE_ORTHOGRAPHIC,
        LensType.GLOBE,
    )
)

# Renders a CUDA kernel projects into at once (csrc/projection.cuh kMaxR).
MAX_RENDERS = 4

GLOBE_CAMERA_D = 4.0
PI_F = float(np.float32(np.pi))
HALF_PI_F = float(np.float32(np.pi / 2))
TWO_PI_F = float(np.float32(2 * np.pi))


class ProjPlan(NamedTuple):
    lens_type: int
    width: int
    height: int
    visible: int
    shift_x: int
    shift_y: int
    scale: float
    az0: float
    r_scale: float
    max_abs_dz: float
    rot: np.ndarray


def _rotation_z(rad):
    c, s = math.cos(rad), math.sin(rad)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float64)


def _rotation_y(rad):
    c, s = math.cos(rad), math.sin(rad)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float64)


def camera_rotation(view) -> np.ndarray:
    rad = math.radians
    return (
        _rotation_z(rad(view.az))
        @ _rotation_y(rad(90.0 - view.el))
        @ _rotation_z(rad(-90.0 + view.ro))
    )


def compute_scale_az0(lens_type, fov_deg, short_pix, res_w, res_h, rot) -> tuple:
    fov = math.radians(fov_deg)
    scale, az0 = 1.0, 0.0
    if lens_type in (LensType.LINEAR, LensType.GLOBE):
        scale = short_pix / 2.0 / math.tan(fov / 2.0)
    elif lens_type == LensType.FISHEYE_EQUAL_AREA:
        scale = short_pix / 2.0 / math.sqrt(2.0) / math.sin(fov / 4.0)
    elif lens_type == LensType.FISHEYE_EQUIDISTANT:
        scale = short_pix * (math.pi / 2.0) / fov
    elif lens_type == LensType.FISHEYE_STEREOGRAPHIC:
        scale = short_pix / 2.0 / math.tan(fov / 4.0)
    elif lens_type == LensType.FISHEYE_ORTHOGRAPHIC:
        scale = short_pix / 2.0 / math.sin(fov / 2.0)
    elif lens_type == LensType.RECTANGULAR:
        short_res = min(res_w // 2, res_h)
        scale = short_res / math.pi
        ax_z = rot @ np.array([0.0, 0.0, 1.0])
        az0 = math.atan2(ax_z[1], ax_z[0])
    return scale, az0


def dual_fisheye_r_scale(lens_type, overlap: float) -> tuple:
    if overlap <= 0:
        return 1.0, 0.0
    if lens_type == LensType.DUAL_FISHEYE_EQUAL_AREA:
        return 1.0 / math.sqrt(1.0 + overlap), overlap
    if lens_type == LensType.DUAL_FISHEYE_EQUIDISTANT:
        return (math.pi / 2) / (math.pi / 2 + math.asin(overlap)), overlap
    if lens_type == LensType.DUAL_FISHEYE_STEREOGRAPHIC:
        return 1.0 / math.tan((math.pi / 2 + math.asin(overlap)) / 2.0), overlap
    return 1.0, 0.0


def make_proj_plan(cfg: RenderConfig) -> ProjPlan:
    rot = camera_rotation(cfg.view)
    short_pix = float(min(cfg.resolution[0], cfg.resolution[1]))
    scale, az0 = compute_scale_az0(cfg.lens.type, cfg.lens.fov, short_pix,
                                   cfg.resolution[0], cfg.resolution[1], rot)
    r_scale, max_abs_dz = 1.0, 0.0
    if cfg.lens.type in (
        LensType.DUAL_FISHEYE_EQUAL_AREA,
        LensType.DUAL_FISHEYE_EQUIDISTANT,
        LensType.DUAL_FISHEYE_STEREOGRAPHIC,
        LensType.DUAL_FISHEYE_ORTHOGRAPHIC,
    ):
        r_scale, max_abs_dz = dual_fisheye_r_scale(cfg.lens.type, cfg.overlap)
    return ProjPlan(
        lens_type=int(cfg.lens.type),
        width=int(cfg.resolution[0]),
        height=int(cfg.resolution[1]),
        visible=int(cfg.visible),
        shift_x=int(cfg.lens_shift[0]),
        shift_y=int(cfg.lens_shift[1]),
        scale=float(scale),
        az0=float(az0),
        r_scale=float(r_scale),
        max_abs_dz=float(max_abs_dz),
        rot=rot.astype(np.float32),
    )


class RenderConsts(ctypes.Structure):
    """Mirror of struct Renders in csrc/projection.cuh: the per-render
    constants the CUDA kernels project with."""

    _fields_ = [("n", ctypes.c_int32)] + [
        (n, ctypes.c_int32 * MAX_RENDERS) for n in ("lens", "width", "height", "visible")] + [
        (n, ctypes.c_float * MAX_RENDERS) for n in (
            "r_scale", "max_abs_dz", "scale", "shift_x", "shift_y")] + [
        ("rot", ctypes.c_float * (9 * MAX_RENDERS))] + [
        (n, ctypes.c_float * MAX_RENDERS) for n in (
            "half_w", "half_h", "dual_r", "dual_cy", "dual_cxu", "dual_cxl")] + [
        ("passes", ctypes.c_int32 * MAX_RENDERS)]


def render_consts(plans) -> RenderConsts:
    """The kernels' projection constants of up to MAX_RENDERS plans (lenses of
    SUPPORTED_LENSES): the plan's fields as float32, and W / 2, H / 2 and of
    the dual lenses short_res / 2, H / 2, W / 2 -+ short_res / 2 computed in
    double and rounded once, as ``project_components`` adds them."""
    if len(plans) > MAX_RENDERS:
        raise ValueError(f"the kernels project into at most {MAX_RENDERS} renders, "
                         f"not {len(plans)}")
    f32 = np.float32
    c = RenderConsts()
    c.n = len(plans)
    for r, pp in enumerate(plans):
        W, H = pp.width, pp.height
        c.lens[r], c.width[r], c.height[r] = pp.lens_type, W, H
        c.visible[r] = pp.visible
        c.r_scale[r], c.max_abs_dz[r] = pp.r_scale, pp.max_abs_dz
        c.scale[r], c.shift_x[r], c.shift_y[r] = pp.scale, pp.shift_x, pp.shift_y
        for i in range(9):
            c.rot[9 * r + i] = float(pp.rot[i // 3, i % 3])
        short = min(W // 2, H)
        c.half_w[r], c.half_h[r] = f32(W / 2.0), f32(H / 2.0)
        c.dual_r[r], c.dual_cy[r] = f32(short / 2.0), f32(H / 2.0)
        c.dual_cxu[r] = f32(W / 2.0 - short / 2.0)
        c.dual_cxl[r] = f32(W / 2.0 + short / 2.0)
        c.passes[r] = 2 if pp.max_abs_dz > 0.0 else 1
    return c


def _fisheye_forward(lens_type: int, dx, dy, dz, r_scale: float):
    """The four fisheye forwards; returns (x, y, valid)."""
    all_ok = torch.ones_like(dz, dtype=torch.bool)
    if lens_type in (LensType.FISHEYE_EQUAL_AREA, LensType.DUAL_FISHEYE_EQUAL_AREA):
        k = sdiv(r_scale, torch.sqrt(1.0 + torch.clamp(dz, -1.0 + 1e-6, 1.0)))
        return k * dx, k * dy, all_ok
    if lens_type in (LensType.FISHEYE_ORTHOGRAPHIC, LensType.DUAL_FISHEYE_ORTHOGRAPHIC):
        return r_scale * dx, r_scale * dy, dz >= 0.0
    rho = torch.sqrt(dx * dx + dy * dy)
    safe_rho = torch.clamp_min(rho, 1e-10)
    theta = torch.arccos(torch.clamp(dz, -1.0, 1.0))
    if lens_type in (LensType.FISHEYE_EQUIDISTANT, LensType.DUAL_FISHEYE_EQUIDISTANT):
        s = r_scale * theta / (HALF_PI_F * safe_rho)
    elif lens_type in (LensType.FISHEYE_STEREOGRAPHIC,
                       LensType.DUAL_FISHEYE_STEREOGRAPHIC):
        s = r_scale * torch.tan(theta * 0.5) / safe_rho
    else:
        raise ValueError(f"not a fisheye lens: {lens_type}")
    s = torch.where(rho < 1e-10, 0.0, s)
    return s * dx, s * dy, all_ok


def _dual_fisheye_pixel(x_norm, y_norm, is_upper, width: int, height: int):
    short_res = min(width // 2, height)
    r = short_res / 2.0
    cy = height / 2.0
    cx_u = width / 2.0 - r
    cx_l = width / 2.0 + r
    fx = torch.where(is_upper, -y_norm * r + cx_u, y_norm * r + cx_l)
    fy = x_norm * r + cy
    return torch.floor(fx + 0.5).to(I32), torch.floor(fy + 0.5).to(I32)


class PixelHits(NamedTuple):
    main: torch.Tensor     # int32 flattened pixel or -1
    overlap: torch.Tensor  # int32 flattened pixel or -1


def _camera(plan: ProjPlan, wx, wy, wz):
    """Camera frame c = R^T (-w), componentwise."""
    r = plan.rot
    return (
        -(float(r[0, 0]) * wx + float(r[1, 0]) * wy + float(r[2, 0]) * wz),
        -(float(r[0, 1]) * wx + float(r[1, 1]) * wy + float(r[2, 1]) * wz),
        -(float(r[0, 2]) * wx + float(r[1, 2]) * wy + float(r[2, 2]) * wz),
    )


def project(plan: ProjPlan, w_dir) -> PixelHits:
    """World exit directions [B, 3] -> pixel hits (the AoS form of
    ``project_components``)."""
    return project_components(plan, w_dir[..., 0], w_dir[..., 1], w_dir[..., 2])


def project_components(plan: ProjPlan, wx, wy, wz) -> PixelHits:
    """World exit directions (components) -> pixel hits."""
    t = plan.lens_type
    W, H = plan.width, plan.height

    def in_bounds(px, py, valid):
        ok = valid & (px >= 0) & (px < W) & (py >= 0) & (py < H)
        return torch.where(ok, py * W + px, -1).to(I32)

    def pixel(x, y):
        px = torch.floor(x * plan.scale + W / 2.0 + 0.5 + plan.shift_x).to(I32)
        py = torch.floor(y * plan.scale + H / 2.0 + 0.5 + plan.shift_y).to(I32)
        return px, py

    if t in (LensType.LINEAR, LensType.FISHEYE_EQUAL_AREA, LensType.FISHEYE_EQUIDISTANT,
             LensType.FISHEYE_STEREOGRAPHIC, LensType.FISHEYE_ORTHOGRAPHIC):
        valid = torch.ones_like(wx, dtype=torch.bool)
        if plan.visible == VisibleRange.UPPER:
            valid = valid & (wz <= 0.0)
        elif plan.visible == VisibleRange.LOWER:
            valid = valid & (wz >= 0.0)
        cx, cy, cz = _camera(plan, wx, wy, wz)
        valid = valid & (cz > 0.0)
        if t == LensType.LINEAR:
            # An invalid ray divides by 1, never by a non-positive cz.
            safe_cz = torch.where(cz > 0, cz, 1.0)
            x, y = cx / safe_cz, cy / safe_cz
        else:
            x, y, v2 = _fisheye_forward(t, cx, cy, cz, 1.0)
            valid = valid & v2
        px, py = pixel(-x, y)  # screen handedness
        return PixelHits(main=in_bounds(px, py, valid),
                         overlap=torch.full_like(px, -1))

    if t == LensType.GLOBE:
        cx, cy, cz = _camera(plan, wx, wy, wz)
        # Valid rays have cz in [-1, -1/D), so their denominator is > 0; an
        # invalid ray's quotient (possibly inf) is masked by in_bounds.
        valid = cz < -1.0 / GLOBE_CAMERA_D
        denom = GLOBE_CAMERA_D + cz
        px, py = pixel(-cx / denom, cy / denom)
        return PixelHits(main=in_bounds(px, py, valid),
                         overlap=torch.full_like(px, -1))

    if t == LensType.RECTANGULAR:
        sx, sy, sz = -wx, -wy, -wz
        lon = torch.arctan2(sy, sx) - plan.az0
        lon = torch.remainder(lon + PI_F, TWO_PI_F) - PI_F
        lat = torch.arcsin(torch.clamp(sz, -1.0, 1.0))
        raw_x = torch.floor(lon * plan.scale + W / 2.0 + 0.5).to(I32)
        px = torch.remainder(raw_x, W)
        py = torch.floor(-lat * plan.scale + H / 2.0 + 0.5).to(I32)
        valid = (py >= 0) & (py < H)
        return PixelHits(main=torch.where(valid, py * W + px, -1).to(I32),
                         overlap=torch.full_like(px, -1))

    if t not in (LensType.DUAL_FISHEYE_EQUAL_AREA, LensType.DUAL_FISHEYE_EQUIDISTANT,
                 LensType.DUAL_FISHEYE_STEREOGRAPHIC, LensType.DUAL_FISHEYE_ORTHOGRAPHIC):
        raise ValueError(f"unknown lens type {t}")
    sx, sy, sz = -wx, -wy, -wz
    is_upper = sz >= 0.0
    z_hemi = torch.abs(sz)
    x, y, _ = _fisheye_forward(t, sx, sy, z_hemi, plan.r_scale)
    px, py = _dual_fisheye_pixel(x, y, is_upper, W, H)
    main = in_bounds(px, py, torch.ones_like(is_upper))
    overlap = torch.full_like(main, -1)
    if plan.max_abs_dz > 0.0:
        x2, y2, _ = _fisheye_forward(t, sx, sy, -z_hemi, plan.r_scale)
        px2, py2 = _dual_fisheye_pixel(x2, y2, ~is_upper, W, H)
        band = torch.abs(sz) < plan.max_abs_dz
        overlap = in_bounds(px2, py2, band)
    return PixelHits(main=main, overlap=overlap)


def project_continuous(plan: ProjPlan, w_dir):
    """Continuous pixel coordinates (fx, fy, valid) of world directions
    w_dir [..., 3], single-lens family: the differentiable projection that
    bilinear splatting reads (integer binning blocks the gradient)."""
    t = plan.lens_type
    wx, wy, wz = w_dir.unbind(-1)
    W, H = plan.width, plan.height
    valid = torch.ones_like(wx, dtype=torch.bool)
    if plan.visible == VisibleRange.UPPER:
        valid = valid & (wz <= 0.0)
    elif plan.visible == VisibleRange.LOWER:
        valid = valid & (wz >= 0.0)
    cx, cy, cz = _camera(plan, wx, wy, wz)
    if t == LensType.LINEAR:
        safe_cz = torch.where(cz > 0, cz, 1.0)
        x, y = cx / safe_cz, cy / safe_cz
        valid = valid & (cz > 0.0)
    elif t in (LensType.FISHEYE_EQUAL_AREA, LensType.FISHEYE_EQUIDISTANT,
               LensType.FISHEYE_STEREOGRAPHIC, LensType.FISHEYE_ORTHOGRAPHIC):
        valid = valid & (cz > 0.0)
        safe_cz = torch.where(valid, cz, 1.0)
        x, y, v2 = _fisheye_forward(t, cx, cy, safe_cz, 1.0)
        valid = valid & v2
    else:
        raise NotImplementedError(
            "project_continuous supports the single-lens family; "
            f"lens type {t} uses the discrete path"
        )
    x = -x
    fx = x * plan.scale + W / 2.0 + 0.5 + plan.shift_x
    fy = y * plan.scale + H / 2.0 + 0.5 + plan.shift_y
    return fx, fy, valid


def splat_bilinear(acc, fx, fy, valid, values, width: int, height: int):
    """Bilinear 4-neighbour scatter-add of `values` [N, C] into a flat
    [H*W, C] accumulator at continuous pixel coordinates; differentiable in
    fx/fy (the weights) and the values. Out-of-image neighbours add 0 to
    pixel 0. The sums are float additions in an unspecified order (atomics
    on CUDA), so the image is held by tolerance, not by bits."""
    x0 = torch.floor(fx - 0.5)
    y0 = torch.floor(fy - 0.5)
    tx = (fx - 0.5) - x0
    ty = (fy - 0.5) - y0
    x0i, y0i = x0.to(I64), y0.to(I64)
    for dx, dy, w in (
        (0, 0, (1 - tx) * (1 - ty)),
        (1, 0, tx * (1 - ty)),
        (0, 1, (1 - tx) * ty),
        (1, 1, tx * ty),
    ):
        px = x0i + dx
        py = y0i + dy
        ok = valid & (px >= 0) & (px < width) & (py >= 0) & (py < height)
        pix = torch.where(ok, py * width + px, 0)
        contrib = torch.where(ok[..., None], values * w[..., None], 0.0)
        acc = acc.index_add(0, pix, contrib)
    return acc


# --------------------------------------------------------------------------
# Inverse projection (pixel -> world exit direction)
# --------------------------------------------------------------------------

def _fisheye_inverse(lens_type: int, x, y, r_scale: float):
    """Normalized image plane (x, y) -> unit camera/sky direction (dx, dy,
    dz) and validity: the inverse of _fisheye_forward."""
    x = x / r_scale
    y = y / r_scale
    r2 = x * x + y * y
    r = torch.sqrt(r2)
    safe_r = torch.clamp_min(r, 1e-10)
    if lens_type in (LensType.FISHEYE_EQUAL_AREA, LensType.DUAL_FISHEYE_EQUAL_AREA):
        dz = 1.0 - r2
        s = torch.sqrt(torch.clamp_min(1.0 + dz, 0.0))
        return x * s, y * s, dz, r2 <= 2.0
    if lens_type in (LensType.FISHEYE_EQUIDISTANT, LensType.DUAL_FISHEYE_EQUIDISTANT):
        theta = r * HALF_PI_F
        sin_t = torch.sin(torch.clamp_max(theta, PI_F))
        return (x / safe_r) * sin_t, (y / safe_r) * sin_t, torch.cos(theta), theta <= PI_F
    if lens_type in (LensType.FISHEYE_STEREOGRAPHIC, LensType.DUAL_FISHEYE_STEREOGRAPHIC):
        theta = 2.0 * torch.arctan(r)
        sin_t = torch.sin(theta)
        return ((x / safe_r) * sin_t, (y / safe_r) * sin_t, torch.cos(theta),
                torch.ones_like(r, dtype=torch.bool))
    if lens_type in (LensType.FISHEYE_ORTHOGRAPHIC, LensType.DUAL_FISHEYE_ORTHOGRAPHIC):
        dz = torch.sqrt(torch.clamp_min(1.0 - r2, 0.0))
        return x, y, dz, r2 <= 1.0
    raise ValueError(f"not a fisheye lens: {lens_type}")


def _to_world(plan: ProjPlan, c):
    """World propagation direction w = -(R c) of camera directions c [..., 3]."""
    rot = torch.as_tensor(plan.rot, dtype=torch.float32, device=c.device)
    return -torch.einsum("ij,...j->...i", rot, c)


def _unit(s):
    return s / torch.clamp_min(torch.linalg.vector_norm(s, dim=-1, keepdim=True), 1e-10)


def unproject(plan: ProjPlan, px, py):
    """Pixel centres -> world exit directions, the inverse of
    ``project_components``: (w_dir [..., 3], valid), float32 on the device
    of px (numpy input: the CPU). Wherever valid, the forward projection of
    w_dir recovers the pixel py * W + px."""
    t = plan.lens_type
    W, H = plan.width, plan.height
    px = torch.as_tensor(px, dtype=torch.float32)
    py = torch.as_tensor(py, dtype=torch.float32, device=px.device)

    if t in (LensType.LINEAR, LensType.FISHEYE_EQUAL_AREA, LensType.FISHEYE_EQUIDISTANT,
             LensType.FISHEYE_STEREOGRAPHIC, LensType.FISHEYE_ORTHOGRAPHIC):
        x = (px - W / 2.0 - plan.shift_x) / plan.scale
        y = (py - H / 2.0 - plan.shift_y) / plan.scale
        x = -x  # undo the screen handedness
        if t == LensType.LINEAR:
            dz = 1.0 / torch.sqrt(1.0 + x * x + y * y)
            c = torch.stack([x * dz, y * dz, dz], dim=-1)
            valid = torch.ones_like(x, dtype=torch.bool)
        else:
            cx, cy, cz, valid = _fisheye_inverse(t, x, y, 1.0)
            c = torch.stack([cx, cy, cz], dim=-1)
            valid = valid & (cz > 0.0)
        return _to_world(plan, c), valid

    if t == LensType.RECTANGULAR:
        lon = (px - W / 2.0) / plan.scale + plan.az0
        lat = (H / 2.0 - py) / plan.scale
        valid = torch.abs(lat) <= HALF_PI_F
        s = torch.stack([torch.cos(lat) * torch.cos(lon), torch.cos(lat) * torch.sin(lon),
                         torch.sin(lat)], dim=-1)
        return -s, valid

    if t in (LensType.DUAL_FISHEYE_EQUAL_AREA, LensType.DUAL_FISHEYE_EQUIDISTANT,
             LensType.DUAL_FISHEYE_STEREOGRAPHIC, LensType.DUAL_FISHEYE_ORTHOGRAPHIC):
        r0 = min(W // 2, H) / 2.0
        cx_u = W / 2.0 - r0
        cx_l = W / 2.0 + r0
        is_upper = px < W / 2.0
        x_norm = (py - H / 2.0) / r0
        y_norm = torch.where(is_upper, (cx_u - px) / r0, (px - cx_l) / r0)
        sx, sy, z_hemi, valid = _fisheye_inverse(t, x_norm, y_norm, plan.r_scale)
        sz = torch.where(is_upper, z_hemi, -z_hemi)
        # The horizontal part renormalised to the hemisphere's height.
        return -_unit(torch.stack([sx, sy, sz], dim=-1)), valid & (z_hemi >= 0.0)

    if t == LensType.GLOBE:
        u = -(px - W / 2.0 - plan.shift_x) / plan.scale
        v = (py - H / 2.0 - plan.shift_y) / plan.scale
        q = u * u + v * v
        D = GLOBE_CAMERA_D
        disc = 1.0 + q * (1.0 - D * D)
        root = torch.sqrt(torch.clamp_min(disc, 0.0))
        cz = (-q * D - root) / (q + 1.0)  # the camera-near surface point
        denom = D + cz
        c = _unit(torch.stack([u * denom, v * denom, cz], dim=-1))
        return _to_world(plan, c), (disc >= 0.0) & (cz < -1.0 / D)

    raise ValueError(f"unknown lens type {t}")
