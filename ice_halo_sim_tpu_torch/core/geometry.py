"""Closed-form hexagonal prism geometry (port of the prism subset of
``ice_halo_sim_tpu.core.geometry``), float32 tensors with the same layout:
8 face slots [top, bottom, 6 sides], MAX_FACE_VTX vertex slots per face."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ice_halo_sim_tpu_torch.core.bits import F32, I32

SQRT3 = float(np.sqrt(3.0))
SQRT3_4 = SQRT3 / 4.0

HEX_COS = np.array([1.0, 0.5, -0.5, -1.0, -0.5, 0.5], np.float32)
HEX_SIN = np.array([0.0, SQRT3 / 2, SQRT3 / 2, 0.0, -SQRT3 / 2, -SQRT3 / 2], np.float32)

_PAIRS = np.array(
    [(i, j) for i in range(6) for j in range(i + 1, 6) if j != i + 3], np.int64
)
N_CANDIDATES = len(_PAIRS)

PRISM_FACES = 8
PYRAMID_FACES = 20
MAX_FACE_VTX = 12
PRISM_FACE_NUMBER = np.array([1, 2, 3, 4, 5, 6, 7, 8], np.int32)

_EPS = 1e-5


class CrystalGeom(NamedTuple):
    plane_n: torch.Tensor       # [NF, 3]
    plane_d: torch.Tensor       # [NF]
    face_number: torch.Tensor   # [NF] int32
    face_present: torch.Tensor  # [NF] bool
    face_vtx: torch.Tensor      # [NF, MV, 3]
    face_vtx_cnt: torch.Tensor  # [NF] int32


class HexCrossSection(NamedTuple):
    corner_xy: torch.Tensor
    corner_valid: torch.Tensor
    side_present: torch.Tensor
    side_lo: torch.Tensor
    side_hi: torch.Tensor
    is_bounded: torch.Tensor


def hex_cross_section(r) -> HexCrossSection:
    r = torch.as_tensor(r, dtype=F32)
    cos_t = torch.as_tensor(HEX_COS)
    sin_t = torch.as_tensor(HEX_SIN)
    i_idx = torch.as_tensor(_PAIRS[:, 0])
    j_idx = torch.as_tensor(_PAIRS[:, 1])
    ci, si, ri = cos_t[i_idx], sin_t[i_idx], r[i_idx]
    cj, sj, rj = cos_t[j_idx], sin_t[j_idx], r[j_idx]
    det = ci * sj - si * cj
    px = (ri * sj - rj * si) / det
    py = (rj * ci - ri * cj) / det
    corners = torch.stack([px, py], dim=-1)

    scale = torch.clamp_min(torch.max(torch.abs(r)), 1.0)
    tol = _EPS * scale * 8.0
    proj = corners[:, 0:1] * cos_t[None, :] + corners[:, 1:2] * sin_t[None, :]
    valid = torch.all(proj <= r[None, :] + tol, dim=-1)

    on_line = torch.zeros((N_CANDIDATES, 6), dtype=torch.bool)
    rows = torch.arange(N_CANDIDATES)
    on_line[rows, i_idx] = True
    on_line[rows, j_idx] = True
    use = on_line & valid[:, None]
    tang_u = -corners[:, 0:1] * sin_t[None, :] + corners[:, 1:2] * cos_t[None, :]
    big = 1e30
    u_min = torch.min(torch.where(use, tang_u, big), dim=0).values
    u_max = torch.max(torch.where(use, tang_u, -big), dim=0).values
    any_on = torch.any(use, dim=0)
    side_present = any_on & ((u_max - u_min) > tol)

    foot = torch.stack([cos_t * r, sin_t * r], dim=-1)
    tang = torch.stack([-sin_t, cos_t], dim=-1)
    u_min_c = torch.where(any_on, u_min, 0.0)
    u_max_c = torch.where(any_on, u_max, 0.0)
    side_lo = foot + u_min_c[:, None] * tang
    side_hi = foot + u_max_c[:, None] * tang
    is_bounded = torch.sum(side_present.to(I32)) >= 3
    return HexCrossSection(corners, valid, side_present, side_lo, side_hi, is_bounded)


def _sorted_polygon_ccw(corners, valid, flip: bool, max_vtx: int):
    cnt = torch.sum(valid.to(I32))
    w = valid.to(F32)
    centroid = torch.sum(corners * w[:, None], dim=0) / torch.clamp_min(torch.sum(w), 1.0)
    d = corners - centroid
    ang = torch.atan2(d[:, 1], d[:, 0])
    if flip:
        ang = -ang
    ang = torch.where(valid, ang, 1e9)
    order = torch.argsort(ang, stable=True)
    sorted_c = corners[order]
    sorted_v = valid[order]
    first = sorted_c[0]
    out = torch.where(sorted_v[:, None], sorted_c, first[None, :])[:max_vtx]
    pad = max_vtx - out.shape[0]
    if pad > 0:
        out = torch.cat([out, first[None, :].repeat(pad, 1)], dim=0)
    return out, torch.clamp_max(cnt, max_vtx)


def prism_geom(h, dist) -> CrystalGeom:
    """Closed-form hexagonal prism (h: height ratio, dist: [6] face
    distances); host-side, float32."""
    h = torch.as_tensor(h, dtype=F32)
    dist = torch.as_tensor(dist, dtype=F32)
    r_side = SQRT3_4 * dist
    xs = hex_cross_section(r_side)

    h_half = 0.5 * h
    plane_n = torch.cat(
        [
            torch.tensor([[0.0, 0.0, 1.0], [0.0, 0.0, -1.0]], dtype=F32),
            torch.stack(
                [torch.as_tensor(HEX_COS), torch.as_tensor(HEX_SIN), torch.zeros(6)],
                dim=-1,
            ),
        ],
        dim=0,
    )
    plane_d = torch.cat([torch.stack([-h_half, -h_half]), -r_side])

    degenerate = h <= _EPS
    present_basal = xs.is_bounded & ~degenerate
    face_present = torch.cat(
        [torch.stack([present_basal, present_basal]), xs.side_present & present_basal]
    )
    top2d, top_cnt = _sorted_polygon_ccw(xs.corner_xy, xs.corner_valid, False, MAX_FACE_VTX)
    bot2d, bot_cnt = _sorted_polygon_ccw(xs.corner_xy, xs.corner_valid, True, MAX_FACE_VTX)
    ones = torch.ones((MAX_FACE_VTX, 1), dtype=F32)
    top_vtx = torch.cat([top2d, ones * h_half], dim=-1)
    bot_vtx = torch.cat([bot2d, -ones * h_half], dim=-1)

    one6 = torch.ones((6, 1), dtype=F32)
    lo3b = torch.cat([xs.side_lo, -h_half * one6], dim=-1)
    hi3b = torch.cat([xs.side_hi, -h_half * one6], dim=-1)
    hi3t = torch.cat([xs.side_hi, h_half * one6], dim=-1)
    lo3t = torch.cat([xs.side_lo, h_half * one6], dim=-1)
    side_vtx4 = torch.stack([lo3b, hi3b, hi3t, lo3t], dim=1)
    side_vtx = torch.cat(
        [side_vtx4, side_vtx4[:, :1, :].repeat(1, MAX_FACE_VTX - 4, 1)], dim=1
    )
    face_vtx = torch.cat([top_vtx[None], bot_vtx[None], side_vtx], dim=0)
    face_vtx_cnt = torch.cat(
        [torch.stack([top_cnt, bot_cnt]).to(I32), torch.full((6,), 4, dtype=I32)]
    )
    face_vtx_cnt = torch.where(face_present, face_vtx_cnt, 0).to(I32)
    return CrystalGeom(
        plane_n=plane_n,
        plane_d=plane_d,
        face_number=torch.as_tensor(PRISM_FACE_NUMBER),
        face_present=face_present,
        face_vtx=face_vtx,
        face_vtx_cnt=face_vtx_cnt,
    )


def pad_geom_faces(geom: CrystalGeom, nf: int) -> CrystalGeom:
    """Pad the face dimension to `nf` slots (absent faces)."""
    cur = geom.plane_n.shape[-2]
    if cur == nf:
        return geom
    pad = nf - cur

    def pad_axis(a, axis, fill=0):
        shape = list(a.shape)
        shape[axis] = pad
        return torch.cat([a, torch.full(shape, fill, dtype=a.dtype)], dim=axis)

    return CrystalGeom(
        plane_n=pad_axis(geom.plane_n, -2),
        plane_d=pad_axis(geom.plane_d, -1, fill=-1e6),
        face_number=pad_axis(geom.face_number, -1),
        face_present=pad_axis(geom.face_present, -1, fill=False),
        face_vtx=pad_axis(geom.face_vtx, -3),
        face_vtx_cnt=pad_axis(geom.face_vtx_cnt, -1),
    )
