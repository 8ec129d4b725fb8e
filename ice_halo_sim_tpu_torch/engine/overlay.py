"""Display-time overlays: grid lines + celestial outline.

A port of the JAX package's engine/overlay.py: the level sets are numpy on
the host, the pixel directions come from the port's ``unproject``.

The reference draws coordinate grids and the celestial (horizon) outline at
DISPLAY time — in the GUI's inverse-projection shader
(src/gui/preview_renderer.cpp:322-340), configured by RenderConfig's
central_grid / elevation_grid / grid.outline fields — not in the committed
render path (the CLI-saved image has no grid). Same split here: the engine
accumulates pure radiance; this module rasterizes overlays onto a snapshot
on demand (CLI --draw-overlays, preview tooling).

Line rendering: each overlay is a level set of a smooth per-pixel angular
quantity q (elevation, or angular distance from the sun). A pixel is on the
line when |q - value| < width * |grad q| (screen-space thickness via the
local angular footprint), giving uniform on-screen width under any lens.
"""

from __future__ import annotations

import numpy as np

from ice_halo_sim_tpu_torch.config.schema import RenderConfig
from ice_halo_sim_tpu_torch.core.projection import ProjPlan, unproject


def _pixel_sky_quantities(plan: ProjPlan, sun_azimuth_deg: float,
                          sun_altitude_deg: float):
    """Per-pixel (elevation_deg, sun_distance_deg, valid) maps."""
    ys, xs = np.mgrid[0 : plan.height, 0 : plan.width]
    w, valid = unproject(plan, xs.astype(np.float32), ys.astype(np.float32))
    w = w.cpu().numpy()
    valid = valid.cpu().numpy()
    s = -w  # sky point direction
    elevation = np.degrees(np.arcsin(np.clip(s[..., 2], -1.0, 1.0)))
    az = np.radians(sun_azimuth_deg)
    alt = np.radians(sun_altitude_deg)
    sun = np.array([np.cos(alt) * np.cos(az), np.cos(alt) * np.sin(az), np.sin(alt)])
    cosd = np.clip(s @ sun, -1.0, 1.0)
    sun_dist = np.degrees(np.arccos(cosd))
    return elevation, sun_dist, valid


def _footprint(q: np.ndarray) -> np.ndarray:
    """Per-pixel |grad q| in quantity-units per pixel (screen-space width)."""
    gy, gx = np.gradient(q)
    g = np.hypot(gx, gy)
    # Suppress seam spikes (image borders, lens-circle edges, az wrap).
    cap = np.nanpercentile(g[np.isfinite(g)], 95) if np.isfinite(g).any() else 1.0
    return np.clip(np.nan_to_num(g, nan=0.0), 1e-6, max(cap, 1e-6))


def _blend_line(img: np.ndarray, mask: np.ndarray, color, opacity: float):
    a = np.clip(opacity, 0.0, 1.0)
    c = np.asarray(color, np.float32)
    img[mask] = (1.0 - a) * img[mask] + a * c
    return img


def draw_overlays(image: np.ndarray, render_cfg: RenderConfig, plan: ProjPlan,
                  sun_azimuth_deg: float, sun_altitude_deg: float) -> np.ndarray:
    """Overlay grid lines onto a linear-RGB float image [H, W, 3] in place.

    - central_grid: circles of constant angular distance from the sun
      (e.g. value=22 marks the 22-degree halo).
    - elevation_grid: circles of constant elevation.
    - celestial_outline: the horizon (elevation = 0), thin half-opacity
      white, like the reference GUI default.
    """
    if image.ndim != 3 or image.shape[:2] != (plan.height, plan.width):
        raise ValueError("image shape does not match projection plan")
    need = (render_cfg.central_grid or render_cfg.elevation_grid
            or render_cfg.celestial_outline)
    if not need:
        return image
    elevation, sun_dist, valid = _pixel_sky_quantities(
        plan, sun_azimuth_deg, sun_altitude_deg
    )
    el_fp = _footprint(elevation)
    sd_fp = _footprint(sun_dist)

    for g in render_cfg.central_grid:
        mask = valid & (np.abs(sun_dist - g.value) < 0.5 * g.width * sd_fp)
        _blend_line(image, mask, g.color, g.opacity)
    for g in render_cfg.elevation_grid:
        mask = valid & (np.abs(elevation - g.value) < 0.5 * g.width * el_fp)
        _blend_line(image, mask, g.color, g.opacity)
    if render_cfg.celestial_outline:
        mask = valid & (np.abs(elevation) < 0.5 * el_fp)
        _blend_line(image, mask, (1.0, 1.0, 1.0), 0.5)
    return image


def draw_overlays_u8(image_u8: np.ndarray, render_cfg: RenderConfig,
                     plan: ProjPlan, sun_azimuth_deg: float,
                     sun_altitude_deg: float) -> np.ndarray:
    """Overlay onto a tone-mapped uint8 sRGB image (returns a new array)."""
    img = image_u8.astype(np.float32) / 255.0
    draw_overlays(img, render_cfg, plan, sun_azimuth_deg, sun_altitude_deg)
    return np.clip(img * 255.0 + 0.5, 0, 255).astype(np.uint8)
