"""Lens projection (port of the forward maps of
``ice_halo_sim_tpu.core.projection``, all eleven lenses).

``make_proj_plan`` resolves a render's parameters on the host exactly as
the JAX package does. ``project_components`` maps exit directions to pixels
in the same float32 operation order as the JAX function. The six lenses
without inverse trig in their forward math (``SUPPORTED_LENSES``: linear,
fisheye equal-area and orthographic, their dual forms, globe) are the ones
the trace kernel takes; fisheye equidistant and stereographic, their dual
forms and rectangular go through arccos, tan, arctan2 and arcsin, whose last
bit differs between XLA, torch on the CPU and CUDA, so a direction on a
pixel edge may land one pixel over. ``unproject`` is not ported (only the
overlay of the host side calls it).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ice_halo_sim_tpu_torch.config.schema import LensType, RenderConfig, VisibleRange
from ice_halo_sim_tpu_torch.core.bits import I32, sdiv

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


def project_components(plan: ProjPlan, wx, wy, wz) -> PixelHits:
    """World exit directions (components) -> pixel hits."""
    t = plan.lens_type
    W, H = plan.width, plan.height
    r = plan.rot

    def cam(wx, wy, wz):
        """Camera frame c = R^T (-w), componentwise."""
        return (
            -(float(r[0, 0]) * wx + float(r[1, 0]) * wy + float(r[2, 0]) * wz),
            -(float(r[0, 1]) * wx + float(r[1, 1]) * wy + float(r[2, 1]) * wz),
            -(float(r[0, 2]) * wx + float(r[1, 2]) * wy + float(r[2, 2]) * wz),
        )

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
        cx, cy, cz = cam(wx, wy, wz)
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
        cx, cy, cz = cam(wx, wy, wz)
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
