"""Component-form rotation and the Fresnel split of the general trace (port
of ``ice_halo_sim_tpu.core.trace_soa``), the two pieces of it that the
trace kernel's plain statement (``trace_emit.trace_rows_plain``) calls.
Same float32 operation order as the port's; the rest of the general trace
is not copied (the reference covers the trace kernel's scenes only).
"""

from __future__ import annotations

import torch

from portbench.reference.plain.core import optics
from portbench.reference.plain.core.bits import sdiv


def rot_apply(r, x, y, z):
    """world = R @ crystal, componentwise (r: 9 row-major entries)."""
    r00, r01, r02, r10, r11, r12, r20, r21, r22 = r
    return (
        r00 * x + r01 * y + r02 * z,
        r10 * x + r11 * y + r12 * z,
        r20 * x + r21 * y + r22 * z,
    )


def rot_apply_inv(r, x, y, z):
    """crystal = R^T @ world, componentwise."""
    r00, r01, r02, r10, r11, r12, r20, r21, r22 = r
    return (
        r00 * x + r10 * y + r20 * z,
        r01 * x + r11 * y + r21 * z,
        r02 * x + r12 * y + r22 * z,
    )


def _fresnel_split_soa(dx, dy, dz, nx, ny, nz, w, n_ior, tir_in=None):
    """Fresnel interaction on component arrays (HitSurface).
    Returns (reflect d, refract d, w_r, w_t, is_tir).

    tir_in: a frozen TIR decision. Where it says "not TIR" at params that
    are TIR, delta clamps to 0 and the refracted weight goes to 0
    smoothly."""
    cos_theta = dx * nx + dy * ny + dz * nz
    rr = torch.where(cos_theta > 0, n_ior, sdiv(1.0, n_ior))
    cos_sq = cos_theta * cos_theta
    delta = (1.0 - rr * rr) / torch.clamp_min(cos_sq, 1e-20) + rr * rr
    is_tir = (delta <= 0.0) if tir_in is None else tir_in
    delta_safe = torch.where(is_tir, 1.0, torch.clamp_min(delta, 0.0))
    r_ratio = torch.where(is_tir, 1.0, optics.reflect_ratio(delta_safe, rr))
    w_reflect = r_ratio * w
    w_refract = torch.where(is_tir, 0.0, w - w_reflect)

    two_ct = 2.0 * cos_theta
    rx = dx - two_ct * nx
    ry = dy - two_ct * ny
    rz = dz - two_ct * nz
    k = (rr - torch.sqrt(delta_safe)) * cos_theta
    tx = torch.where(is_tir, rx, rr * dx - k * nx)
    ty = torch.where(is_tir, ry, rr * dy - k * ny)
    tz = torch.where(is_tir, rz, rr * dz - k * nz)
    return (rx, ry, rz), (tx, ty, tz), w_reflect, w_refract, is_tir
