"""Ray and orientation sampling (port of the trace-kernel subset of
``ice_halo_sim_tpu.core.sampling``): sun-cap directions, the orientation
sampler in its ``lut_loop`` form, axis parameters and entry fan triangles.

Same RNG slots, same float32 operation order as the JAX functions."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ice_halo_sim_tpu_torch.config.schema import AxisDistribution, DistType
from ice_halo_sim_tpu_torch.core.latlut import N_NODES
from ice_halo_sim_tpu_torch.core import rng
from ice_halo_sim_tpu_torch.core.bits import F32, I32, const, divs
from ice_halo_sim_tpu_torch.core.geometry import CrystalGeom

LAT_FULL_SPHERE = 0
LAT_NO_RANDOM = 1
LAT_GAUSS_LEGACY = 3
LAT_LUT_INVERSE_CDF = 6

PI_F = float(np.float32(np.pi))
HALF_PI_F = float(np.float32(np.pi / 2))
TWO_PI_F = float(np.float32(2 * np.pi))


def select_lat_path(axis: AxisDistribution) -> int:
    if axis.is_full_sphere_uniform():
        return LAT_FULL_SPHERE
    if axis.latitude.type == DistType.NO_RANDOM:
        return LAT_NO_RANDOM
    if axis.latitude.type == DistType.GAUSS_LEGACY:
        return LAT_GAUSS_LEGACY
    return LAT_LUT_INVERSE_CDF


class AxisParams(NamedTuple):
    """Per-setting orientation parameters, host numpy [S, ...]."""

    lat_path: np.ndarray
    lat_mean: np.ndarray
    lat_std: np.ndarray
    az_type: np.ndarray
    az_mean: np.ndarray
    az_std: np.ndarray
    roll_type: np.ndarray
    roll_mean: np.ndarray
    roll_std: np.ndarray
    lut_theta: np.ndarray
    lut_cdf: np.ndarray
    lut_flip: np.ndarray


def make_axis_params(axes, luts) -> AxisParams:
    deg = np.pi / 180.0
    return AxisParams(
        lat_path=np.array([select_lat_path(a) for a in axes], np.int32),
        lat_mean=np.asarray([a.latitude.center * deg for a in axes], np.float32),
        lat_std=np.asarray([a.latitude.spread * deg for a in axes], np.float32),
        az_type=np.asarray([int(a.azimuth.type) for a in axes], np.int32),
        az_mean=np.asarray([a.azimuth.center * deg for a in axes], np.float32),
        az_std=np.asarray([a.azimuth.spread * deg for a in axes], np.float32),
        roll_type=np.asarray([int(a.roll.type) for a in axes], np.int32),
        roll_mean=np.asarray([a.roll.center * deg for a in axes], np.float32),
        roll_std=np.asarray([a.roll.spread * deg for a in axes], np.float32),
        lut_theta=np.stack([l.theta for l in luts]).astype(np.float32),
        lut_cdf=np.stack([l.cdf for l in luts]).astype(np.float32),
        lut_flip=np.stack([l.flip_prob for l in luts]).astype(np.float32),
    )


def sun_constants(sun_azimuth_deg: float, sun_altitude_deg: float,
                  sun_diameter_deg: float) -> dict:
    """The scalar float32 constants of the sun-cap sampler, computed once
    on the host in float32 (the CUDA kernel takes the same values)."""
    f = lambda v: torch.tensor(v, dtype=F32)  # noqa: E731
    lon = torch.deg2rad(f(sun_azimuth_deg + 180.0))
    lat = torch.deg2rad(f(-sun_altitude_deg))
    half = torch.deg2rad(f(sun_diameter_deg / 2.0))
    c_lon, s_lon = torch.cos(lon), torch.sin(lon)
    c_lat, s_lat = torch.cos(lat), torch.sin(lat)
    return {
        "c_cap": float(torch.cos(half)),
        "a0": float(c_lon * c_lat), "a1": float(s_lon), "a2": float(c_lon * s_lat),
        "b0": float(s_lon * c_lat), "b1": float(c_lon), "b2": float(s_lon * s_lat),
        "c0": float(s_lat), "c1": float(c_lat),
    }


def sample_sun_dirs_soa(seed, idx, sun_azimuth_deg: float, sun_altitude_deg: float,
                        sun_diameter_deg: float):
    """Propagation directions within the sun cone, (dx, dy, dz); slots 0-1."""
    k = sun_constants(sun_azimuth_deg, sun_altitude_deg, sun_diameter_deg)
    u = rng.uniform(seed, idx, 0)
    x = u + (1.0 - u) * k["c_cap"]
    r = torch.sqrt(torch.clamp_min(1.0 - x * x, 0.0))
    phi = rng.uniform(seed, idx, 1) * TWO_PI_F
    y = torch.cos(phi) * r
    z = torch.sin(phi) * r
    return (
        k["a0"] * x - k["a1"] * y - k["a2"] * z,
        k["b0"] * x + k["b1"] * y - k["b2"] * z,
        k["c0"] * x + k["c1"] * z,
    )


def normalize_latitude(phi):
    """Spherical latitude fold -> (phi_norm, flip); jnp.mod semantics."""
    theta = HALF_PI_F - phi
    rem = torch.fmod(theta, TWO_PI_F)
    theta = torch.where((rem != 0) & ((rem < 0) != (TWO_PI_F < 0)), rem + TWO_PI_F, rem)
    flip = theta > PI_F
    theta = torch.where(flip, TWO_PI_F - theta, theta)
    return HALF_PI_F - theta, flip


def _invert_lat_lut_loop(xi, theta_nodes, cdf_nodes):
    """Inverse-CDF latitude lookup; the values of the JAX node loop (the
    masked max/min over the monotone CDF), evaluated as one [B, N] pass."""
    cdf = const(np.asarray(cdf_nodes, np.float32), xi.device)
    n = cdf.shape[0]
    c_first, c_last = float(cdf_nodes[0]), float(cdf_nodes[-1])
    xi = torch.clamp(xi, c_first, c_last)
    cmp = cdf[None, :] <= xi[:, None]
    lo_cnt = cmp.to(I32).sum(dim=1)
    not_last = torch.arange(n, device=xi.device) < n - 1
    c0 = torch.where(cmp & not_last[None, :], cdf[None, :], -3.0e38).max(dim=1).values
    c1 = torch.where(~cmp, cdf[None, :], 3.0e38).min(dim=1).values
    c1 = torch.clamp_max(c1, c_last)
    lo = torch.clamp(lo_cnt - 1, 0, n - 2)
    t0 = float(theta_nodes[0])
    dt = (float(theta_nodes[-1]) - t0) / float(n - 1)
    denom = c1 - c0
    w = torch.where(denom > 0, (xi - c0) / torch.where(denom > 0, denom, 1.0), 0.0)
    return float(np.float32(t0)) + (lo.to(F32) + w) * float(np.float32(dt))


def _flip_prob_loop(theta, theta_nodes, flip_tbl):
    """Flip probability of theta's LUT bin."""
    t0 = float(theta_nodes[0])
    span = float(theta_nodes[-1]) - t0
    if span > 0:
        t = divs(theta - float(np.float32(t0)), float(np.float32(span)))
    else:
        t = torch.zeros_like(theta)
    idx = torch.clamp((t * (N_NODES - 1)).to(I32), 0, N_NODES - 2)
    tbl = const(np.asarray(flip_tbl, np.float32)[: N_NODES - 1], theta.device)
    return tbl[idx.long()]


def _rot9(ca, sa, cb, sb, cc, sc):
    return (
        ca * cb * cc - sa * sc, -ca * cb * sc - sa * cc, ca * sb,
        sa * cb * cc + ca * sc, -sa * cb * sc + ca * cc, sa * sb,
        -sb * cc, sb * sc, cb,
    )


def sample_rot_row(seed, idx, params: AxisParams, s: int, lut_loop: bool = True):
    """Orientation sample -> the 9 rotation components (slots 0-9), for rays
    of setting `s`. Only the ``lut_loop`` form exists here."""
    if not lut_loop:
        raise NotImplementedError("the port implements sample_rot_row(lut_loop=True)")
    lat_path = int(params.lat_path[s])
    flip = None
    if lat_path == LAT_FULL_SPHERE:
        u_fs = torch.clamp(rng.uniform(seed, idx, 0) * 2.0 - 1.0, -1.0, 1.0)
        cb = u_fs
        sb = -torch.sqrt(torch.clamp_min(1.0 - u_fs * u_fs, 0.0))
        lon = rng.uniform(seed, idx, 1) * TWO_PI_F
    else:
        if lat_path == LAT_NO_RANDOM:
            phi = torch.full(idx.shape, float(params.lat_mean[s]), dtype=F32,
                             device=idx.device)
        elif lat_path == LAT_GAUSS_LEGACY:
            raw = rng.sample_dist(seed, idx, 2, int(DistType.GAUSS_LEGACY),
                                  params.lat_mean[s], params.lat_std[s])
            phi, flip = normalize_latitude(raw)
        else:
            xi = rng.uniform(seed, idx, 4)
            colat = _invert_lat_lut_loop(xi, params.lut_theta[s], params.lut_cdf[s])
            flip_p = _flip_prob_loop(colat, params.lut_theta[s], params.lut_flip[s])
            phi = HALF_PI_F - colat
            flip = rng.uniform(seed, idx, 5) < flip_p
        b = phi - float(np.float32(PI_F / 2))
        cb = torch.cos(b)
        sb = torch.sin(b)
        lon = rng.sample_dist(seed, idx, 6, int(params.az_type[s]),
                              params.az_mean[s], params.az_std[s])
    roll = rng.sample_dist(seed, idx, 8, int(params.roll_type[s]),
                           params.roll_mean[s], params.roll_std[s])
    if flip is not None:
        lon = torch.where(flip, lon + PI_F, lon)
        roll = torch.where(flip, roll + PI_F, roll)
    a = lon - PI_F
    return _rot9(torch.cos(a), torch.sin(a), cb, sb, torch.cos(roll), torch.sin(roll))


class EntryTris(NamedTuple):
    """Per-shape fan sub-triangle table, [..., T, ...] with T = NF * 4."""

    v0: torch.Tensor          # [..., T, 3]
    e1: torch.Tensor          # [..., T, 3]
    e2: torch.Tensor          # [..., T, 3]
    cross_half: torch.Tensor  # [..., T, 3]
    face_idx: torch.Tensor    # [..., T] int32


def build_entry_tris(geom: CrystalGeom) -> EntryTris:
    """Fan sub-triangles (v0, v[k], v[k+1]) of every face, T = NF * 4; any
    leading pool dimensions of `geom` carry through (the JAX package maps
    this function over the pool with jax.vmap). Absent faces and triangles
    past a face's vertex count keep their rows with a zero cross_half."""
    nf = geom.face_vtx.shape[-3]
    mv = min(geom.face_vtx.shape[-2], 6)
    lead = tuple(geom.face_vtx.shape[:-3])
    dev = geom.face_vtx.device
    face_vtx = geom.face_vtx[..., :mv, :]
    v0 = face_vtx[..., 0:1, :]
    e1 = face_vtx[..., 1:-1, :] - v0
    e2 = face_vtx[..., 2:, :] - v0
    cross_half = 0.5 * torch.linalg.cross(e1, e2, dim=-1)
    k = torch.arange(1, mv - 1, device=dev)
    valid = (k + 1 < geom.face_vtx_cnt[..., None]) & geom.face_present[..., None]
    cross_half = torch.where(valid[..., None], cross_half, 0.0)
    t = nf * (mv - 2)
    face_idx = torch.arange(nf, dtype=I32, device=dev)[:, None].expand(
        lead + (nf, mv - 2))
    return EntryTris(
        v0=v0.expand(e1.shape).reshape(lead + (t, 3)),
        e1=e1.reshape(lead + (t, 3)),
        e2=e2.reshape(lead + (t, 3)),
        cross_half=cross_half.reshape(lead + (t, 3)),
        face_idx=face_idx.reshape(lead + (t,)),
    )
