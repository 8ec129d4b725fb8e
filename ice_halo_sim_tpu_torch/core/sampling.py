"""Ray and orientation sampling (port of ``ice_halo_sim_tpu.core.sampling``):
sun-cap directions, axis parameters, the orientation sampler (the rotation
components of ``sample_rot_row`` in its ``lut_loop`` form, and the angles of
``sample_lat_lon_roll_row`` with the [B, N] latitude lookup), rotation
matrices and entry fan triangles with the entry sampler.

Same RNG slots, same float32 operation order as the JAX functions. The [B,
3] forms (``sample_sun_dirs``, ``build_rotation``, ``rotate``,
``sample_entry``) are the AoS layer of core/trace.py; their dot products and
running sums are written out in the order of the component forms, so both
give the same bits. The TPU's row reads by one-hot sums (``hw.take_rows``)
are gathers here."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ice_halo_sim_tpu_torch.config.schema import AxisDistribution, DistType
from ice_halo_sim_tpu_torch.core.latlut import N_NODES
from ice_halo_sim_tpu_torch.core import optics, rng
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


# Rays of one [B, N] pass of the latitude lookup: its temporaries hold some
# 2.5 KB a ray, so a layer of 20 M lanes goes through in passes of this many.
LUT_CHUNK = 1 << 20


def _invert_lat_lut_loop(xi, theta_nodes, cdf_nodes):
    """Inverse-CDF latitude lookup; the values of the JAX node loop (the
    masked max/min over the monotone CDF), evaluated as one [B, N] pass, or
    for more than LUT_CHUNK rays one pass of each LUT_CHUNK (each ray's
    value is its own)."""
    if xi.shape[0] > LUT_CHUNK:
        return torch.cat([_invert_lat_lut_loop(x, theta_nodes, cdf_nodes)
                          for x in xi.split(LUT_CHUNK)])
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


# --------------------------------------------------------------------------
# The AoS forms ([B, 3] directions, [B, 3, 3] rotations)
# --------------------------------------------------------------------------

def sample_sun_dirs(seed, idx, sun_azimuth_deg: float, sun_altitude_deg: float,
                    sun_diameter_deg: float) -> torch.Tensor:
    """Propagation directions within the sun cone [B, 3]; slots 0-1."""
    return torch.stack(sample_sun_dirs_soa(
        seed, idx, sun_azimuth_deg, sun_altitude_deg, sun_diameter_deg), dim=-1)


def invert_lat_lut(xi, theta_nodes, cdf_nodes):
    """Inverse-CDF latitude lookup of xi [B] in one [B, N] pass over the
    (strictly monotone) CDF nodes: cdf[lo] is the greatest node <= xi but
    the last, cdf[lo + 1] the least node above it; the theta nodes are
    uniformly spaced."""
    theta = torch.as_tensor(theta_nodes, dtype=F32, device=xi.device)
    cdf = torch.as_tensor(cdf_nodes, dtype=F32, device=xi.device)
    xi = torch.minimum(torch.maximum(xi, cdf[0]), cdf[-1])
    n = cdf.shape[0]
    node_i = torch.arange(n, device=xi.device)
    cmp = cdf <= xi[..., None]
    lo = torch.clamp(cmp.to(I32).sum(dim=-1) - 1, 0, n - 2)
    c0 = torch.where(cmp & (node_i < n - 1), cdf, -3.0e38).max(dim=-1).values
    c1 = torch.where(~cmp, cdf, 3.0e38).min(dim=-1).values
    c1 = torch.minimum(c1, cdf[-1])
    dt = divs(theta[-1] - theta[0], float(n - 1))
    denom = c1 - c0
    w = torch.where(denom > 0, (xi - c0) / torch.where(denom > 0, denom, 1.0), 0.0)
    return theta[0] + (lo.to(F32) + w) * dt


def lat_lut_bin(theta, theta_nodes):
    """The uniform-theta LUT bin of theta, clamped to [0, N_NODES - 2]."""
    nodes = torch.as_tensor(theta_nodes, dtype=F32, device=theta.device)
    span = nodes[-1] - nodes[0]
    t = torch.where(span > 0, (theta - nodes[0]) / torch.where(span > 0, span, 1.0), 0.0)
    return torch.clamp((t * (N_NODES - 1)).to(I32), 0, N_NODES - 2)


def sample_lat_lon_roll_row(seed, idx, params: AxisParams, s: int):
    """Orientation (lon, lat, roll) in radians for rays of setting `s`
    (slots 0-9). A pole flip adds pi to lon and roll."""
    lat_path = int(params.lat_path[s])
    flip = torch.zeros(idx.shape, dtype=torch.bool, device=idx.device)
    if lat_path == LAT_FULL_SPHERE:
        u_fs = rng.uniform(seed, idx, 0) * 2.0 - 1.0
        phi = torch.arcsin(torch.clamp(u_fs, -1.0, 1.0))
    elif lat_path == LAT_NO_RANDOM:
        phi = torch.full(idx.shape, float(params.lat_mean[s]), dtype=F32, device=idx.device)
    elif lat_path == LAT_GAUSS_LEGACY:
        raw = rng.sample_dist(seed, idx, 2, int(DistType.GAUSS_LEGACY),
                              params.lat_mean[s], params.lat_std[s])
        phi, flip = normalize_latitude(raw)
    else:
        xi = rng.uniform(seed, idx, 4)
        colat = invert_lat_lut(xi, params.lut_theta[s], params.lut_cdf[s])
        phi = HALF_PI_F - colat
        fbin = lat_lut_bin(colat, params.lut_theta[s])
        flip_p = const(np.asarray(params.lut_flip[s], np.float32), idx.device)[fbin.long()]
        flip = rng.uniform(seed, idx, 5) < flip_p
    if lat_path == LAT_FULL_SPHERE:
        lon = rng.uniform(seed, idx, 1) * TWO_PI_F
    else:
        lon = rng.sample_dist(seed, idx, 6, int(params.az_type[s]),
                              params.az_mean[s], params.az_std[s])
    roll = rng.sample_dist(seed, idx, 8, int(params.roll_type[s]),
                           params.roll_mean[s], params.roll_std[s])
    lon = torch.where(flip, lon + PI_F, lon)
    roll = torch.where(flip, roll + PI_F, roll)
    return lon, phi, roll


def sample_lat_lon_roll(seed, idx, params: AxisParams, setting_idx=None):
    """Single-setting parameters only (the engine samples per contiguous
    setting segment with the row form); setting_idx is not read."""
    return sample_lat_lon_roll_row(seed, idx, params, 0)


def build_rotation(lon, lat, roll):
    """Row-major R = Rz(lon - pi) Ry(lat - pi/2) Rz(roll) [..., 3, 3];
    world = R @ crystal."""
    a = lon - PI_F
    b = lat - HALF_PI_F
    r = _rot9(torch.cos(a), torch.sin(a), torch.cos(b), torch.sin(b),
              torch.cos(roll), torch.sin(roll))
    return torch.stack([torch.stack(r[3 * i:3 * i + 3], dim=-1) for i in range(3)], dim=-2)


def rotate(rot, v):
    """world = R @ crystal; rot [..., 3, 3], v [..., 3]."""
    return (rot[..., 0] * v[..., 0:1] + rot[..., 1] * v[..., 1:2]
            + rot[..., 2] * v[..., 2:3])


def rotate_inv(rot, v):
    """crystal = R^T @ world."""
    return (rot[..., 0, :] * v[..., 0:1] + rot[..., 1, :] * v[..., 1:2]
            + rot[..., 2, :] * v[..., 2:3])


def _pick_entry(seed, idx, wt, v0, e1, e2, face_idx):
    """The entry sampler's choice (slots 10-12) from the projected-area
    weights wt [..., T] and the per-ray triangle tables [..., T, 3] (face
    [..., T]), or shared [T, 3] / [T] tables. The CDF is a float32 running
    sum in triangle order. Returns (p, face, has_entry, log_p)."""
    T = wt.shape[-1]
    run = torch.zeros(wt.shape[:-1], dtype=F32, device=wt.device)
    cdf = []
    for t in range(T):
        run = run + wt[..., t]
        cdf.append(run)
    total = run
    has_entry = total > 0.0
    target = rng.uniform(seed, idx, 10) * total
    sel = torch.clamp((torch.stack(cdf, dim=-1) <= target[..., None]).sum(dim=-1), 0, T - 1)

    def rows(tab):
        if tab.dim() == 2:
            return tab[sel]
        return tab.gather(-2, sel[..., None, None].expand(sel.shape + (1, 3)))[..., 0, :]

    u = rng.uniform(seed, idx, 11)
    v = rng.uniform(seed, idx, 12)
    over = u + v > 1.0
    u = torch.where(over, 1.0 - u, u)[..., None]
    v = torch.where(over, 1.0 - v, v)[..., None]
    p = rows(v0) + u * rows(e1) + v * rows(e2)
    face = face_idx[sel] if face_idx.dim() == 1 else face_idx.gather(-1, sel[..., None])[..., 0]
    w_sel = wt.gather(-1, sel[..., None])[..., 0]
    safe_total = torch.where(has_entry, total, 1.0)
    log_p = torch.where(
        has_entry & (w_sel > 0),
        torch.log(torch.where(w_sel > 0, w_sel, 1.0)) - torch.log(safe_total), 0.0)
    return p, face, has_entry, log_p


def sample_entry(seed, idx, d_local, tris: EntryTris):
    """Entry point and face of rays with crystal-frame direction d_local
    [B, 3] over per-ray triangle tables [B, T, ...]: a triangle by its
    projected area max(-d . cross_half, 0), a point by the folded (u, v)
    draw (slots 10-12). Returns (p [B, 3], face [B] int32, has_entry [B],
    log p of the chosen triangle [B])."""
    wt = torch.clamp_min(-optics.dot3(d_local[..., None, :], tris.cross_half), 0.0)
    return _pick_entry(seed, idx, wt, tris.v0, tris.e1, tris.e2, tris.face_idx)

