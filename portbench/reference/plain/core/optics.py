"""Optics (port of ``ice_halo_sim_tpu.core.optics``): the ice refractive
index, the unpolarized Fresnel ratio and split, and the convex-slab exit
face, float32 in the JAX functions' operation order.

A dot product over the last axis of 3 is written out as x*nx + y*ny + z*nz
(the order of the SoA trace, core/trace_soa.py), so the [..., 3] forms here
and the component forms there give the same bits on every device."""

from __future__ import annotations

import torch

from portbench.reference.plain.core.bits import F32, I32, divs, sdiv

_SELLMEIER = (0.701777, 1.091144, 0.884400, 0.796950)
WL_MIN = 350.0
WL_MAX = 900.0

SLAB_EPS = 1e-5
_BIG = 1e30


def ice_refractive_index(wl_nm):
    """n(lambda) for ice; 1.0 outside [350, 900] nm."""
    wl_nm = torch.as_tensor(wl_nm, dtype=F32)
    um = divs(wl_nm, 1e3)
    um2 = um * um
    b1, b2, c1, c2 = _SELLMEIER
    n_sq = (
        1.0
        + sdiv(b1, 1.0 - sdiv(c1 * 1e-2, um2))
        + sdiv(b2, 1.0 - sdiv(c2 * 1e2, um2))
    )
    n = torch.sqrt(torch.clamp_min(n_sq, 1.0))
    return torch.where((wl_nm < WL_MIN) | (wl_nm > WL_MAX), 1.0, n)


def reflect_ratio(delta, rr):
    """R = (Rs + Rp) / 2; delta >= 0 (caller clamps)."""
    d_sqrt = torch.sqrt(delta)
    rs = (rr - d_sqrt) / (rr + d_sqrt)
    rp = (1.0 - rr * d_sqrt) / (1.0 + rr * d_sqrt)
    return 0.5 * (rs * rs + rp * rp)


def dot3(a, b):
    """Dot product over the last axis (3) of broadcastable a and b."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def fresnel_split(d, n_face, w, n_ior):
    """Fresnel interaction of rays `d` [..., 3] with faces of outward normal
    `n_face` [..., 3] at refractive index n_ior [...] (or a scalar).
    Returns (d_reflect, d_refract, w_reflect, w_refract, is_tir); cos > 0
    means the ray travels outward. Under TIR the refracted child has zero
    weight and the reflected direction."""
    n_ior = torch.as_tensor(n_ior, dtype=F32, device=d.device)
    cos_theta = dot3(d, n_face)
    rr = torch.where(cos_theta > 0, n_ior, sdiv(1.0, n_ior))
    cos_sq = cos_theta * cos_theta
    delta = (1.0 - rr * rr) / torch.clamp_min(cos_sq, 1e-20) + rr * rr
    is_tir = delta <= 0.0
    delta_safe = torch.where(is_tir, 1.0, torch.clamp_min(delta, 0.0))
    r_ratio = torch.where(is_tir, 1.0, reflect_ratio(delta_safe, rr))
    w_reflect = r_ratio * w
    w_refract = torch.where(is_tir, 0.0, w - w_reflect)

    ct = cos_theta[..., None]
    d_reflect = d - 2.0 * ct * n_face
    sd = torch.sqrt(delta_safe)[..., None]
    rr_b = rr[..., None]
    d_refract = torch.where(is_tir[..., None], d_reflect, rr_b * d - (rr_b - sd) * ct * n_face)
    return d_reflect, d_refract, w_reflect, w_refract, is_tir


def slab_next_face(p, d, from_face, plane_n, plane_d, face_present):
    """Next exit face of a convex slab from origin p [..., 3] along d
    [..., 3], skipping face from_face [...] (-1: none); planes [..., NF, 3],
    [..., NF], presence [..., NF]. Returns (t, face index int32, found):
    the least t over the faces whose denominator passes SLAB_EPS; found is
    False when none does (the ray leaves the hull) or t <= -SLAB_EPS."""
    denom = dot3(d[..., None, :], plane_n)
    dist = dot3(p[..., None, :], plane_n) + plane_d
    t_face = -dist / torch.where(torch.abs(denom) > 1e-30, denom, 1e-30)
    face_ids = torch.arange(plane_n.shape[-2], dtype=I32, device=d.device)
    candidate = (denom > SLAB_EPS) & face_present & (face_ids != from_face[..., None])
    t, face_idx = torch.min(torch.where(candidate, t_face, _BIG), dim=-1)
    found = (t < _BIG * 0.5) & (t > -SLAB_EPS)
    return t, face_idx.to(I32), found
