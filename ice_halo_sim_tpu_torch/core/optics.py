"""Ice refractive index and unpolarized Fresnel ratio (port of
``ice_halo_sim_tpu.core.optics``), float32, same operation order."""

from __future__ import annotations

import torch

from ice_halo_sim_tpu_torch.core.bits import F32, divs, sdiv

_SELLMEIER = (0.701777, 1.091144, 0.884400, 0.796950)
WL_MIN = 350.0
WL_MAX = 900.0

SLAB_EPS = 1e-5


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
