"""Color-class compositor: per-class Y lanes -> linear RGB.

A copy of ``ice_halo_sim_tpu.engine.compositor`` (numpy only, no JAX in it):
  - participating set: solo classes if any are solo, else visible classes.
  - self-anchored exposure A = intensity_factor * target_linear / p99 where
    p99 is the 99th percentile of NON-ZERO raw lane Y over participating
    classes (target white 135/255 through the inverse sRGB transform).
  - dominant: argmax of exposed lane Y (ties to earlier class), color * ey.
  - additive: sum of color * ey, clamped per channel.
  - painter: Porter-Duff over, front-to-back ascending z_order, alpha =
    min(ey, 1) with the class's pure hue in the color slot; the display
    exposure multiplies AFTER compositing (alpha uses the self-anchor only).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

TARGET_WHITE = 135.0 / 255.0
TARGET_LINEAR = (
    TARGET_WHITE / 12.92 if TARGET_WHITE <= 0.04045 else ((TARGET_WHITE + 0.055) / 1.055) ** 2.4
)


def participating_exposure_scale(intensity_factor: float, p99_y: float) -> float:
    if p99_y <= 0.0:
        return 0.0
    return intensity_factor * TARGET_LINEAR / p99_y


def participating_p99(lanes: np.ndarray, participating: np.ndarray) -> float:
    """P99 of non-zero raw Y over the participating classes' lanes."""
    vals = lanes[participating]
    vals = vals[vals > 0]
    if vals.size == 0:
        return 0.0
    return float(np.percentile(vals, 99.0))


def composite_color_classes(
    lanes: np.ndarray,          # [C, H, W] raw Y lanes
    classes,                    # sequence of schema.ColorClass
    mode: str,
    intensity_factor: float = 1.0,
    display_exposure_scale: float = 1.0,
) -> Optional[np.ndarray]:
    """Returns linear RGB [H, W, 3], or None when nothing composites."""
    c, h, w = lanes.shape
    if c == 0:
        return None
    solo = np.array([getattr(cls, "solo", False) for cls in classes], bool)
    visible = np.array([cls.visible for cls in classes], bool)
    participating = solo if solo.any() else visible
    if not participating.any():
        return None
    p99 = participating_p99(lanes, participating)
    a = participating_exposure_scale(intensity_factor, p99)
    if a <= 0.0:
        return None

    order = np.argsort([cls.z_order for cls in classes], kind="stable")
    colors = np.array([cls.color for cls in classes], np.float32)

    if mode in ("dominant", "additive"):
        ey = lanes * (a * display_exposure_scale)
        ey = np.where(participating[:, None, None], ey, 0.0)
        if mode == "dominant":
            best = np.argmax(ey, axis=0)            # ties -> earlier class
            best_ey = np.take_along_axis(ey, best[None], axis=0)[0]
            rgb = colors[best] * best_ey[..., None]
            rgb[best_ey <= 0] = 0.0
        else:
            rgb = np.einsum("chw,cx->hwx", ey, colors)
        return np.clip(rgb, 0.0, 1.0)

    # painter: front-to-back "over" in ascending z_order.
    out = np.zeros((h, w, 3), np.float32)
    acc_alpha = np.zeros((h, w), np.float32)
    for ci in order:
        if not participating[ci]:
            continue
        ey = lanes[ci] * a
        alpha = np.minimum(ey, 1.0)
        contrib = (1.0 - acc_alpha)[..., None] * alpha[..., None] * colors[ci]
        out += contrib
        acc_alpha = acc_alpha + (1.0 - acc_alpha) * alpha
    out *= display_exposure_scale
    return np.clip(out, 0.0, 1.0)
