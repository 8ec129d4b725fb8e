"""Spectral color (port of ``ice_halo_sim_tpu.core.color``): the
piecewise-Chebyshev CMF fit, the tabulated CMF lookup of the gradient path, the illuminant SPDs (the
daylight series from the tables and in the engine's form), the Chebyshev
helpers and the table lerp, and the sRGB snapshot post-process.

The CIE tables are read from the port's own copy of the JAX package's data
file (``data/cie_data.npz``); the Chebyshev coefficients are fitted from
them with the same numpy code, so they are the same float32 values.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ice_halo_sim_tpu_torch.core.bits import F32, I32, const, divs, sdiv

_DATA = np.load(
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                 "data", "cie_data.npz")
)

CMF_WL_MIN = int(_DATA["cmf_wl_min"])
CMF_WL_MAX = int(_DATA["cmf_wl_max"])
CMF_X = _DATA["cmf_x"].astype(np.float32)
CMF_Y = _DATA["cmf_y"].astype(np.float32)
CMF_Z = _DATA["cmf_z"].astype(np.float32)
XYZ_TO_RGB = _DATA["xyz_to_rgb"].astype(np.float32)
WHITE_D65 = _DATA["white_d65"].astype(np.float32)
NORM_SCALE = 0.08

_DAYLIGHT_S = np.stack(
    [_DATA["daylight_s0"], _DATA["daylight_s1"], _DATA["daylight_s2"]]
)
_DAYLIGHT_WL_MIN = int(_DATA["daylight_wl_min"])
_DAYLIGHT_WL_STEP = int(_DATA["daylight_wl_step"])

ILLUMINANT_CCT = {"D50": 5003.0, "D55": 5503.0, "D65": 6504.0, "D75": 7504.0}

_CMF_GRID = np.arange(CMF_WL_MIN, CMF_WL_MAX + 1, dtype=np.float64)
_CMF_NSEG = 8
_CMF_DEG = 20


def _build_cmf_piecewise():
    edges = np.linspace(CMF_WL_MIN, CMF_WL_MAX, _CMF_NSEG + 1)
    coefs = np.zeros((_CMF_NSEG, 3 * (_CMF_DEG + 1)), np.float32)
    for s in range(_CMF_NSEG):
        m = (_CMF_GRID >= edges[s]) & (_CMF_GRID <= edges[s + 1])
        t = (2 * _CMF_GRID[m] - (edges[s] + edges[s + 1])) / (edges[s + 1] - edges[s])
        for c, tbl in enumerate((CMF_X, CMF_Y, CMF_Z)):
            fit = np.polynomial.chebyshev.chebfit(
                t, np.asarray(tbl, np.float64)[m], _CMF_DEG
            )
            coefs[s, c * (_CMF_DEG + 1) : (c + 1) * (_CMF_DEG + 1)] = fit
    return coefs


_CMF_PIECEWISE = _build_cmf_piecewise()


def cmf_lookup(wl_nm):
    """CMF triple [..., 3] from the tables: the wavelength rounds to the
    nearest nm (floor(wl + 0.5)); out of the table's range gives 0."""
    wl = torch.as_tensor(wl_nm, dtype=F32)
    key = torch.floor(wl + 0.5).to(I32)
    in_range = (key >= CMF_WL_MIN) & (key <= CMF_WL_MAX)
    idx = torch.clamp(key - CMF_WL_MIN, 0, CMF_WL_MAX - CMF_WL_MIN).long()
    tbl = const(np.stack([CMF_X, CMF_Y, CMF_Z], axis=-1), wl.device)
    return torch.where(in_range[..., None], tbl[idx], 0.0)


def _clenshaw_rows(coefs, t):
    b1 = torch.zeros_like(t)
    b2 = torch.zeros_like(t)
    for k in range(coefs.shape[-1] - 1, 0, -1):
        b1, b2 = coefs[..., k] + 2.0 * t * b1 - b2, b1
    return coefs[..., 0] + t * b1 - b2


def cmf_eval(wl_nm):
    """CMF triple [B, 3] from the piecewise Chebyshev fit."""
    wl = torch.as_tensor(wl_nm, dtype=F32)
    seg_w = (CMF_WL_MAX - CMF_WL_MIN) / _CMF_NSEG
    pos = divs(wl - CMF_WL_MIN, seg_w)
    s = torch.clamp(torch.floor(pos).to(I32), 0, _CMF_NSEG - 1)
    t = torch.clamp((pos - s) * 2.0 - 1.0, -1.0, 1.0)
    coefs = torch.as_tensor(_CMF_PIECEWISE, device=wl.device)[s.long()]
    n = _CMF_DEG + 1
    triple = torch.stack(
        [_clenshaw_rows(coefs[..., c * n : (c + 1) * n], t) for c in range(3)],
        dim=-1,
    )
    in_range = (wl >= CMF_WL_MIN - 0.5) & (wl <= CMF_WL_MAX + 0.5)
    return torch.where(in_range[..., None], torch.clamp_min(triple, 0.0), 0.0)


def daylight_components(wl_nm):
    """Daylight S0/S1/S2 at wavelengths [B] -> [3, B] (linear interp)."""
    tbl = np.stack([np.asarray(_DAYLIGHT_S[i], np.float32) for i in range(3)], axis=-1)
    pairs = torch.as_tensor(np.concatenate([tbl[:-1], tbl[1:]], axis=-1))
    n = pairs.shape[0]
    wl = torch.as_tensor(wl_nm, dtype=F32)
    pos = divs(wl - float(_DAYLIGHT_WL_MIN), float(_DAYLIGHT_WL_STEP))
    i0 = torch.clamp(torch.floor(pos).to(I32), 0, n - 1)
    f = torch.clamp(pos - i0, 0.0, 1.0)
    v = pairs.to(wl.device)[i0.long()]
    out = v[..., :3] * (1.0 - f)[..., None] + v[..., 3:] * f[..., None]
    return torch.movedim(out, -1, 0)


def daylight_cct_spd(cct: float, wl_nm):
    """Daylight-series SPD at correlated colour temperature `cct` for
    wavelengths [B] (CIE method: S0 + m1 S1 + m2 S2, linearly interpolated
    in the tables)."""
    t = cct
    if t <= 7000:
        xd = -4.607e9 / t**3 + 2.9678e6 / t**2 + 0.09911e3 / t + 0.244063
    else:
        xd = -2.0064e9 / t**3 + 1.9018e6 / t**2 + 0.24748e3 / t + 0.23704
    yd = -3.0 * xd * xd + 2.87 * xd - 0.275
    m = 0.0241 + 0.2562 * xd - 0.7341 * yd
    m1 = (-1.3515 - 1.7703 * xd + 5.9114 * yd) / m
    m2 = (0.03 - 31.4424 * xd + 30.0717 * yd) / m
    wl = torch.as_tensor(wl_nm, dtype=F32)
    s = const(np.asarray(_DAYLIGHT_S, np.float32), wl.device)
    pos = divs(wl - _DAYLIGHT_WL_MIN, _DAYLIGHT_WL_STEP)
    i0 = torch.clamp(torch.floor(pos).to(I32), 0, s.shape[1] - 2)
    f = torch.clamp(pos - i0, 0.0, 1.0)
    i0 = i0.long()
    interp = s[:, i0] * (1 - f) + s[:, i0 + 1] * f
    return interp[0] + float(np.float32(m1)) * interp[1] + float(np.float32(m2)) * interp[2]


def illuminant_spd(name: str, wl_nm):
    """SPD weight of a standard illuminant at wavelengths [B]: the daylight
    series D50-D75 from the tables, E flat, A the 2856 K blackbody (100 at
    560 nm)."""
    name = name.upper()
    wl = torch.as_tensor(wl_nm, dtype=F32)
    if name in ILLUMINANT_CCT:
        return daylight_cct_spd(ILLUMINANT_CCT[name], wl)
    if name == "E":
        return torch.ones(wl.shape, dtype=F32, device=wl.device)
    if name == "A":
        c2 = 1.435e7
        temp = 2856.0
        ratio = sdiv(560.0, wl)
        num = np.exp(c2 / (temp * 560.0)) - 1.0
        den = torch.exp(sdiv(c2, temp * wl)) - 1.0
        return 100.0 * ratio**5 * num / den
    raise ValueError(f"unknown illuminant {name!r}")


def illuminant_spd_fast(name: str, wl_nm):
    """Illuminant SPD at wavelengths [B] on the engine's path: the daylight
    series through ``daylight_components``, E and A as ``illuminant_spd``."""
    name = name.upper()
    wl = torch.as_tensor(wl_nm, dtype=F32)
    if name in ILLUMINANT_CCT:
        cct = ILLUMINANT_CCT[name]
        if cct <= 7000:
            xd = -4.607e9 / cct**3 + 2.9678e6 / cct**2 + 0.09911e3 / cct + 0.244063
        else:
            xd = -2.0064e9 / cct**3 + 1.9018e6 / cct**2 + 0.24748e3 / cct + 0.23704
        yd = -3.0 * xd * xd + 2.87 * xd - 0.275
        m = 0.0241 + 0.2562 * xd - 0.7341 * yd
        m1 = (-1.3515 - 1.7703 * xd + 5.9114 * yd) / m
        m2 = (0.03 - 31.4424 * xd + 30.0717 * yd) / m
        s = daylight_components(wl)
        return s[0] + float(np.float32(m1)) * s[1] + float(np.float32(m2)) * s[2]
    return illuminant_spd(name, wl)


def _chebfit_domain(xs, ys, deg, lo, hi):
    """Chebyshev fit (float64 numpy) of ys over xs mapped from [lo, hi] to
    [-1, 1]."""
    t = (2.0 * np.asarray(xs, np.float64) - (lo + hi)) / (hi - lo)
    return np.polynomial.chebyshev.chebfit(t, np.asarray(ys, np.float64), deg)


def _clenshaw(coeffs, t):
    """A Chebyshev series with host coefficients at t in [-1, 1]."""
    b1 = torch.zeros_like(t)
    b2 = torch.zeros_like(t)
    for ck in coeffs[:0:-1]:
        b1, b2 = float(np.float32(ck)) + 2.0 * t * b1 - b2, b1
    return float(np.float32(coeffs[0])) + t * b1 - b2


def dense_lerp(x, lo, step, table):
    """Linear interpolation in the table [N] (host array) at x [B]:
    table[i0] * (1 - f) + table[i0 + 1] * f, i0 clamped to [0, N - 2]."""
    x = torch.as_tensor(x, dtype=F32)
    tbl = const(np.asarray(table, np.float32), x.device)
    n = tbl.shape[0]
    pos = divs(x - lo, step)
    i0 = torch.clamp(torch.floor(pos).to(I32), 0, n - 2)
    f = torch.clamp(pos - i0, 0.0, 1.0)
    i0 = i0.long()
    return tbl[i0] * (1.0 - f) + tbl[i0 + 1] * f


def exposure_scale(intensity_factor: float, total_pix: int,
                   snapshot_intensity: float) -> float:
    if total_pix <= 0 or snapshot_intensity <= 0:
        return 0.0
    return intensity_factor * NORM_SCALE * total_pix / snapshot_intensity


def gamut_clip_xyz(xyz):
    white = const(WHITE_D65, xyz.device)
    m = const(XYZ_TO_RGB, xyz.device)
    gray = white * xyz[..., 1:2]
    diff = xyz - gray
    a = -(gray @ m.T)
    b = diff @ m.T
    big = torch.abs(b) > 1e-30
    ratio = torch.where(big, a / torch.where(big, b, 1.0), torch.inf)
    cand = torch.where(a * b > 0, ratio, torch.inf)
    s = torch.clamp_max(torch.min(cand, dim=-1).values, 1.0)
    return diff * s[..., None] + gray


def xyz_to_linear_rgb(xyz):
    return torch.clamp(xyz @ const(XYZ_TO_RGB, xyz.device).T, 0.0, 1.0)


def linear_to_srgb(x):
    return torch.where(
        x < 0.0031308, x * 12.92,
        1.055 * torch.pow(torch.clamp_min(x, 1e-12), 1.0 / 2.4) - 0.055,
    )


def post_process(xyz_image, intensity_factor: float, snapshot_intensity: float,
                 background, ray_color, use_real_color: bool = True):
    """Snapshot post-processing: XYZ [H, W, 3] -> uint8 sRGB [H, W, 3]
    numpy, computed in float32 on the device of `xyz_image` (a tensor; an
    array is taken on the CPU), as JAX computes it on its device; only the
    uint8 image is copied to the host."""
    xyz_image = torch.as_tensor(xyz_image, dtype=F32)
    dev = xyz_image.device
    h, w, _ = xyz_image.shape
    xyz = xyz_image * exposure_scale(intensity_factor, h * w, snapshot_intensity)
    if use_real_color:
        rgb = xyz_to_linear_rgb(gamut_clip_xyz(xyz))
    else:
        gray = const(WHITE_D65, dev) * xyz[..., 1:2]
        rgb = gray @ const(XYZ_TO_RGB, dev).T
        rgb = rgb * torch.as_tensor(ray_color, dtype=F32, device=dev)
    rgb = torch.clamp(rgb + torch.as_tensor(background, dtype=F32, device=dev), 0.0, 1.0)
    return (linear_to_srgb(rgb) * 255.0).to(torch.uint8).cpu().numpy()
