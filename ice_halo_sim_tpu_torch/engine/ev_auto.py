"""Adaptive-brightness (EV-auto) anchor.

Library form of the reference GUI's always-on adaptive brightness
(reference/src/gui/gui_ev_auto.hpp, algorithm spec
doc/adaptive-brightness.md §2):

  1. p99_raw_y = 99th percentile of the POSITIVE Y values in the raw
     accumulated XYZ buffer.
  2. p99_norm  = p99_raw_y / snapshot_intensity, where snapshot_intensity is
     the render's total landed weight (render.cpp:482 snapshot_intensity_ =
     total_intensity_, the sum of per-batch landed weights).
  3. target_linear = inverse-sRGB of target_white/255 (target_white = 135).
  4. ev_auto = log2(target_linear / p99_norm), clamped to [-6, +6]; 0 when
     there is no data yet.

The returned EV adds to the manual EV (intensity_factor = 2^ev) before the
post-processing pass — `color.post_process` consumes it as a plain
intensity_factor multiplier.
"""

from __future__ import annotations

import math

import numpy as np

TARGET_WHITE_DEFAULT = 135.0
EV_CLAMP = 6.0


def srgb_inverse(t: float) -> float:
    """sRGB transfer inverse (display value in [0,1] -> linear)."""
    return t / 12.92 if t <= 0.04045 else ((t + 0.055) / 1.055) ** 2.4


def compute_p99_y(xyz: np.ndarray) -> float:
    """P99 of positive Y-channel values of a raw XYZ buffer [..., 3]
    (ComputeP99Y, gui_ev_auto.hpp)."""
    y = np.asarray(xyz)[..., 1].ravel()
    y = y[y > 0]
    if y.size == 0:
        return 0.0
    return float(np.percentile(y, 99.0))


def compute_ev_auto(p99_raw_y: float, snapshot_intensity: float,
                    target_white: float = TARGET_WHITE_DEFAULT) -> float:
    """EV offset in stops, clamped to [-6, +6]; 0 when no data
    (ComputeEvAuto, gui_ev_auto.hpp / doc/adaptive-brightness.md:36-60)."""
    if p99_raw_y <= 0.0 or snapshot_intensity <= 0.0:
        return 0.0
    target_linear = srgb_inverse(target_white / 255.0)
    p99_norm = p99_raw_y / snapshot_intensity
    if p99_norm <= 0.0:
        return 0.0
    ev = math.log2(target_linear / p99_norm)
    return max(-EV_CLAMP, min(EV_CLAMP, ev))


def ev_auto_for_frame(raw_xyz: np.ndarray, landed_weight: float,
                      target_white: float = TARGET_WHITE_DEFAULT) -> float:
    """Convenience: EV-auto straight from a frame's raw XYZ + landed weight."""
    return compute_ev_auto(compute_p99_y(raw_xyz), landed_weight, target_white)
