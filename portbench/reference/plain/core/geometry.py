"""Closed-form hexagonal prism geometry (port of
``ice_halo_sim_tpu.core.geometry``), float32 tensors with the same layout:
8 face slots [top, bottom, 6 sides] (20 for the pyramid layout, see
core/pyramid.py), MAX_FACE_VTX vertex slots per face.

Where the JAX package maps ``prism_geom`` over a shape pool with
``jax.vmap``, every function here carries the pool as a leading K dimension
(``prism_geom_batch``); ``prism_geom`` is the K = 1 case. Tensors live on
the device of the shape scalars."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from portbench.reference.plain.core.bits import F32, I32, const

SQRT3 = float(np.sqrt(3.0))
SQRT3_4 = SQRT3 / 4.0

HEX_COS = np.array([1.0, 0.5, -0.5, -1.0, -0.5, 0.5], np.float32)
HEX_SIN = np.array([0.0, SQRT3 / 2, SQRT3 / 2, 0.0, -SQRT3 / 2, -SQRT3 / 2], np.float32)

_PAIRS = np.array(
    [(i, j) for i in range(6) for j in range(i + 1, 6) if j != i + 3], np.int64
)
N_CANDIDATES = len(_PAIRS)
# Which two of the six side lines each candidate corner lies on.
_ON_LINE = np.zeros((N_CANDIDATES, 6), bool)
_ON_LINE[np.arange(N_CANDIDATES), _PAIRS[:, 0]] = True
_ON_LINE[np.arange(N_CANDIDATES), _PAIRS[:, 1]] = True

PRISM_FACES = 8
PYRAMID_FACES = 20
MAX_FACE_VTX = 12
PRISM_FACE_NUMBER = np.array([1, 2, 3, 4, 5, 6, 7, 8], np.int32)
# Pyramid slots: 0/1 basal, 2+i prism side (3+i), 8+i upper cone (13+i),
# 14+i lower cone (23+i).
PYRAMID_FACE_NUMBER = np.array(
    [1, 2] + [3 + i for i in range(6)] + [13 + i for i in range(6)]
    + [23 + i for i in range(6)],
    np.int32,
)
# Face normals of the prism's 8 slots: basal (+z, -z), then the six sides.
_PRISM_PLANE_N = np.concatenate(
    [np.array([[0.0, 0.0, 1.0], [0.0, 0.0, -1.0]], np.float32),
     np.stack([HEX_COS, HEX_SIN, np.zeros(6, np.float32)], axis=-1)])

_EPS = 1e-5


class CrystalGeom(NamedTuple):
    """Flat fixed-shape crystal geometry; a pool carries a leading K."""

    plane_n: torch.Tensor       # [..., NF, 3]
    plane_d: torch.Tensor       # [..., NF]
    face_number: torch.Tensor   # [..., NF] int32
    face_present: torch.Tensor  # [..., NF] bool
    face_vtx: torch.Tensor      # [..., NF, MV, 3]
    face_vtx_cnt: torch.Tensor  # [..., NF] int32


class HexCrossSection(NamedTuple):
    corner_xy: torch.Tensor     # [K, 12, 2]
    corner_valid: torch.Tensor  # [K, 12]
    side_present: torch.Tensor  # [K, 6]
    side_lo: torch.Tensor       # [K, 6, 2]
    side_hi: torch.Tensor       # [K, 6, 2]
    is_bounded: torch.Tensor    # [K]


def hex_cross_section(r) -> HexCrossSection:
    """Intersection of the six half-planes x.dir_i <= r_i, r: [K, 6]."""
    dev = r.device
    cos_t = const(HEX_COS, dev)
    sin_t = const(HEX_SIN, dev)
    i_idx = const(_PAIRS[:, 0], dev)
    j_idx = const(_PAIRS[:, 1], dev)
    ci, si, ri = cos_t[i_idx], sin_t[i_idx], r[:, i_idx]
    cj, sj, rj = cos_t[j_idx], sin_t[j_idx], r[:, j_idx]
    det = ci * sj - si * cj
    px = (ri * sj - rj * si) / det
    py = (rj * ci - ri * cj) / det
    corners = torch.stack([px, py], dim=-1)                       # [K, 12, 2]

    scale = torch.clamp_min(torch.max(torch.abs(r), dim=-1).values, 1.0)
    tol = (_EPS * scale * 8.0)[:, None]                           # [K, 1]
    proj = corners[..., 0:1] * cos_t + corners[..., 1:2] * sin_t  # [K, 12, 6]
    valid = torch.all(proj <= r[:, None, :] + tol[:, None, :], dim=-1)

    use = const(_ON_LINE, dev)[None] & valid[..., None]           # [K, 12, 6]
    tang_u = -corners[..., 0:1] * sin_t + corners[..., 1:2] * cos_t
    big = 1e30
    u_min = torch.min(torch.where(use, tang_u, big), dim=1).values
    u_max = torch.max(torch.where(use, tang_u, -big), dim=1).values
    any_on = torch.any(use, dim=1)
    side_present = any_on & ((u_max - u_min) > tol)

    foot = torch.stack([cos_t * r, sin_t * r], dim=-1)            # [K, 6, 2]
    tang = torch.stack([-sin_t, cos_t], dim=-1)                   # [6, 2]
    u_min_c = torch.where(any_on, u_min, 0.0)
    u_max_c = torch.where(any_on, u_max, 0.0)
    side_lo = foot + u_min_c[..., None] * tang
    side_hi = foot + u_max_c[..., None] * tang
    is_bounded = torch.sum(side_present.to(I32), dim=-1) >= 3
    return HexCrossSection(corners, valid, side_present, side_lo, side_hi, is_bounded)


def _sorted_polygon_ccw(corners, valid, flip: bool, max_vtx: int):
    """Feasible corners [K, 12, 2] in CCW order around their centroid (a
    stable sort, as jnp.argsort is: duplicate corners tie)."""
    cnt = torch.sum(valid.to(I32), dim=-1)
    w = valid.to(F32)
    centroid = torch.sum(corners * w[..., None], dim=1) / torch.clamp_min(
        torch.sum(w, dim=-1), 1.0)[:, None]
    d = corners - centroid[:, None, :]
    ang = torch.atan2(d[..., 1], d[..., 0])
    if flip:
        ang = -ang
    ang = torch.where(valid, ang, 1e9)
    order = torch.argsort(ang, dim=-1, stable=True)
    sorted_c = torch.gather(corners, 1, order[..., None].expand(-1, -1, 2))
    sorted_v = torch.gather(valid, 1, order)
    first = sorted_c[:, 0:1, :]
    out = torch.where(sorted_v[..., None], sorted_c, first)[:, :max_vtx]
    pad = max_vtx - out.shape[1]
    if pad > 0:
        out = torch.cat([out, first.expand(-1, pad, -1)], dim=1)
    return out, torch.clamp_max(cnt, max_vtx)


def prism_geom_batch(h, dist) -> CrystalGeom:
    """Closed-form hexagonal prisms: h [K] height ratios, dist [K, 6] face
    distances."""
    h = torch.as_tensor(h, dtype=F32)
    dist = torch.as_tensor(dist, dtype=F32, device=h.device)
    dev = h.device
    K = h.shape[0]
    r_side = SQRT3_4 * dist
    xs = hex_cross_section(r_side)

    h_half = 0.5 * h
    plane_n = const(_PRISM_PLANE_N, dev)[None].expand(K, -1, -1)
    plane_d = torch.cat([torch.stack([-h_half, -h_half], dim=-1), -r_side], dim=-1)

    degenerate = h <= _EPS
    present_basal = xs.is_bounded & ~degenerate
    face_present = torch.cat(
        [torch.stack([present_basal, present_basal], dim=-1),
         xs.side_present & present_basal[:, None]], dim=-1)
    top2d, top_cnt = _sorted_polygon_ccw(xs.corner_xy, xs.corner_valid, False, MAX_FACE_VTX)
    bot2d, bot_cnt = _sorted_polygon_ccw(xs.corner_xy, xs.corner_valid, True, MAX_FACE_VTX)
    ones = torch.ones((K, MAX_FACE_VTX, 1), dtype=F32, device=dev)
    hh = h_half[:, None, None]
    top_vtx = torch.cat([top2d, ones * hh], dim=-1)
    bot_vtx = torch.cat([bot2d, -ones * hh], dim=-1)

    one6 = torch.ones((K, 6, 1), dtype=F32, device=dev)
    lo3b = torch.cat([xs.side_lo, -hh * one6], dim=-1)
    hi3b = torch.cat([xs.side_hi, -hh * one6], dim=-1)
    hi3t = torch.cat([xs.side_hi, hh * one6], dim=-1)
    lo3t = torch.cat([xs.side_lo, hh * one6], dim=-1)
    side_vtx4 = torch.stack([lo3b, hi3b, hi3t, lo3t], dim=2)      # [K, 6, 4, 3]
    side_vtx = torch.cat(
        [side_vtx4, side_vtx4[:, :, :1, :].expand(-1, -1, MAX_FACE_VTX - 4, -1)], dim=2)
    face_vtx = torch.cat([top_vtx[:, None], bot_vtx[:, None], side_vtx], dim=1)
    face_vtx_cnt = torch.cat(
        [torch.stack([top_cnt, bot_cnt], dim=-1).to(I32),
         torch.full((K, 6), 4, dtype=I32, device=dev)], dim=-1)
    face_vtx_cnt = torch.where(face_present, face_vtx_cnt, 0).to(I32)
    return CrystalGeom(
        plane_n=plane_n,
        plane_d=plane_d,
        face_number=const(PRISM_FACE_NUMBER, dev)[None].expand(K, -1),
        face_present=face_present,
        face_vtx=face_vtx,
        face_vtx_cnt=face_vtx_cnt,
    )


def squeeze_geom(geom: CrystalGeom) -> CrystalGeom:
    """The single shape of a K = 1 pool."""
    return CrystalGeom(*(x[0] for x in geom))


def prism_geom(h, dist) -> CrystalGeom:
    """One closed-form hexagonal prism (h: height ratio, dist: [6])."""
    h = torch.as_tensor(h, dtype=F32).reshape(1)
    dist = torch.as_tensor(dist, dtype=F32).reshape(1, 6)
    return squeeze_geom(prism_geom_batch(h, dist))


def pad_geom_faces(geom: CrystalGeom, nf: int) -> CrystalGeom:
    """Pad the face dimension to `nf` slots (absent faces)."""
    cur = geom.plane_n.shape[-2]
    if cur == nf:
        return geom
    pad = nf - cur

    def pad_axis(a, axis, fill=0):
        shape = list(a.shape)
        shape[axis] = pad
        return torch.cat(
            [a, torch.full(shape, fill, dtype=a.dtype, device=a.device)], dim=axis)

    return CrystalGeom(
        plane_n=pad_axis(geom.plane_n, -2),
        plane_d=pad_axis(geom.plane_d, -1, fill=-1e6),
        face_number=pad_axis(geom.face_number, -1),
        face_present=pad_axis(geom.face_present, -1, fill=False),
        face_vtx=pad_axis(geom.face_vtx, -3),
        face_vtx_cnt=pad_axis(geom.face_vtx_cnt, -1),
    )


def polygon_areas(geom: CrystalGeom) -> torch.Tensor:
    """Area of every face polygon [..., NF], summed over its fan triangles
    (v0, v[k], v[k+1]). The inner where keeps sqrt's gradient finite on
    the zero-area padding triangles."""
    v0 = geom.face_vtx[..., 0:1, :]
    a = geom.face_vtx[..., 1:-1, :] - v0
    b = geom.face_vtx[..., 2:, :] - v0
    cross = torch.linalg.cross(a, b, dim=-1)
    cross_sq = (cross * cross).sum(dim=-1)
    nonzero = cross_sq > 0
    tri_area = torch.where(
        nonzero, 0.5 * torch.sqrt(torch.where(nonzero, cross_sq, 1.0)), 0.0)
    k = torch.arange(1, geom.face_vtx.shape[-2] - 1, device=geom.face_vtx.device)
    mask = k + 1 < geom.face_vtx_cnt[..., None]
    return torch.where(mask, tri_area, 0.0).sum(dim=-1)
