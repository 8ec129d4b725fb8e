"""Closed-form hexagonal pyramid geometry (port of
``ice_halo_sim_tpu.core.pyramid``).

Model: at every height z the cross section is the fixed-direction hex
half-plane problem with offsets (sqrt(3)/4) * (dist_i - m(z)), where the
inset m(z) is piecewise linear:

    m(z) = 0                 |z| <= h2/2
         = (z - h2/2) / a1   z > h2/2   (upper cone)
         = (-h2/2 - z) / a2  z < -h2/2  (lower cone)

with a = (sqrt(3)/4) / tan(wedge_alpha). The cone truncation heights are
fractions of the natural apex inset m_apex, the LP maximum of m over the
C(6,3) = 20 direction triples.

Each face's polygon is recovered from the full 20-plane set by exact convex
vertex enumeration (face plane x pairs of other planes -> feasibility ->
angular sort -> dedup), one uniform fixed-shape rule. Slot layout: 0/1
basal, 2+i prism side (fn 3+i), 8+i upper cone (fn 13+i), 14+i lower cone
(fn 23+i).

Where the JAX package maps ``pyramid_geom`` over a pool with ``jax.vmap``,
the functions here carry the pool as a leading K dimension. The feasibility
test stays componentwise float32, plane by plane (a matrix product at
reduced precision once marked every cone face absent in the JAX package):
no matmul or einsum, and the loop over the 20 planes keeps the working set
at [K, 20, 171] instead of [K, 20, 171, 20].
"""

from __future__ import annotations

import numpy as np
import torch

from ice_halo_sim_tpu_torch.core.bits import F32, I32, I64, const, divs
from ice_halo_sim_tpu_torch.core.geometry import (
    HEX_COS,
    HEX_SIN,
    MAX_FACE_VTX,
    PYRAMID_FACES,
    PYRAMID_FACE_NUMBER,
    SQRT3_4,
    CrystalGeom,
    squeeze_geom,
)

_INSET_K = SQRT3_4
# Shapes of one pass of the vertex enumeration, by device type: its
# [K, 20, 171] candidate tensors hold some 0.7 MB a shape at their peak, so
# on a card a pool of 300 K pyramids (a layer of 14 M lanes) goes through in
# passes of 8192; on the CPU a pass of 256 stays in the caches.
GEOM_CHUNK = {"cuda": 8192, "cpu": 256}
_MIN_ALPHA = 0.1
_MAX_ALPHA = 89.9
_EPS = 1e-5

# All C(6,3) direction triples for the apex LP.
_TRIPLES = np.array(
    [(i, j, k) for i in range(6) for j in range(i + 1, 6) for k in range(j + 1, 6)],
    np.int64,
)

# Per-face candidate plane pairs for vertex enumeration: for face f, all pairs
# (g, h) with g < h drawn from the other 19 planes.
_NF = PYRAMID_FACES
_pairs = [(g, h) for g in range(_NF) for h in range(g + 1, _NF)]
_FACE_PAIRS = np.zeros((_NF, (_NF - 1) * (_NF - 2) // 2, 2), np.int64)
for _f in range(_NF):
    _FACE_PAIRS[_f] = np.asarray(
        [(g, h) for (g, h) in _pairs if g != _f and h != _f], np.int64)
N_CAND = _FACE_PAIRS.shape[1]  # 171
_EX = np.array([1.0, 0.0, 0.0], np.float32)
_EY = np.array([0.0, 1.0, 0.0], np.float32)
_N_BASAL = np.array([[0.0, 0.0, 1.0], [0.0, 0.0, -1.0]], np.float32)


def _cross(a, b):
    """a x b on the last axis, componentwise (the jnp.cross formula)."""
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1)


def _apex_lp(dist_scaled):
    """Max feasible inset (scaled units) over the 20 direction triples;
    dist_scaled [K, 6] -> [K]."""
    dev = dist_scaled.device
    cs = const(HEX_COS, dev)
    sn = const(HEX_SIN, dev)
    i, j, k = (const(_TRIPLES[:, c], dev) for c in range(3))
    det = cs[i] * (sn[j] - sn[k]) - sn[i] * (cs[j] - cs[k]) + (cs[j] * sn[k] - cs[k] * sn[j])
    di, dj, dk = dist_scaled[:, i], dist_scaled[:, j], dist_scaled[:, k]
    safe_det = torch.where(torch.abs(det) > 1e-9, det, 1.0)
    u = (di * (sn[j] - sn[k]) - sn[i] * (dj - dk) + (dj * sn[k] - dk * sn[j])) / safe_det
    v = (cs[i] * (dj - dk) - di * (cs[j] - cs[k]) + (cs[j] * dk - cs[k] * dj)) / safe_det
    m = (
        cs[i] * (sn[j] * dk - sn[k] * dj)
        - sn[i] * (cs[j] * dk - cs[k] * dj)
        + di * (cs[j] * sn[k] - cs[k] * sn[j])
    ) / safe_det
    scale = torch.clamp_min(torch.max(torch.abs(dist_scaled), dim=-1).values, 0.1)
    tol = 1e-5 * scale * 8
    slack = (
        cs * u[..., None] + sn * v[..., None] + m[..., None] - dist_scaled[:, None, :]
    )                                                             # [K, 20, 6]
    feasible = (torch.abs(det) > 1e-9) & torch.all(slack <= tol[:, None, None], dim=-1)
    return torch.max(torch.where(feasible, m, -1e30), dim=-1).values


def _face_polygons(plane_n, plane_d, ref_scale):
    """Exact convex-face polygons from the 20-plane set.

    plane_n [K, NF, 3] unit outward normals, the same for every shape (a
    pyramid's planes differ by their constants alone), plane_d [K, NF],
    ref_scale [K]. Returns (face_vtx [K, NF, MV, 3], face_vtx_cnt [K, NF],
    areas [K, NF]).

    What depends on the normals alone (each candidate's cross products and
    determinant) is worked out once for the pool, and each candidate
    vertex's three components are separate [K, NF, C] tensors until the
    feasibility test is done: the same float32 operations on the same
    values as a pass per shape over [K, NF, C, 3].
    """
    dev = plane_n.device
    K = plane_n.shape[0]
    pairs = const(_FACE_PAIRS, dev)                               # [NF, C, 2]
    n_f = plane_n                                                 # [K, NF, 3]
    normals = plane_n[0]                                          # [NF, 3]
    n_g = normals[pairs[..., 0]]                                  # [NF, C, 3]
    d_g = plane_d[:, pairs[..., 0]]                               # [K, NF, C]
    n_h = normals[pairs[..., 1]]
    d_h = plane_d[:, pairs[..., 1]]

    # Solve the 3-plane system [n_f; n_g; n_h] x = -[d_f; d_g; d_h] by Cramer.
    a = normals[:, None, :].expand_as(n_g)
    cross_gh = _cross(n_g, n_h)
    det = torch.sum(a * cross_gh, dim=-1)                         # [NF, C]
    ok_det = torch.abs(det) > 1e-7
    safe_det = torch.where(ok_det, det, 1.0)
    b0 = -plane_d[:, :, None]                                     # [K, NF, 1]
    b1, b2 = -d_g, -d_h
    cross_ha = _cross(n_h, a)
    cross_ag = _cross(a, n_g)
    x0, x1, x2 = ((b0 * cross_gh[..., c] + b1 * cross_ha[..., c]
                   + b2 * cross_ag[..., c]) / safe_det for c in range(3))   # [K, NF, C]

    # Feasibility: inside every half-space (slack <= tol), componentwise
    # float32, one plane at a time (the running max is exact).
    tol = (5e-5 * torch.clamp_min(ref_scale, 0.1))[:, None]       # [K, 1]
    max_slack = torch.full_like(x0, -torch.inf)
    for p in range(_NF):
        pn = normals[p]
        slack = x0 * pn[0] + x1 * pn[1] + x2 * pn[2] + plane_d[:, p, None, None]
        max_slack = torch.maximum(max_slack, slack)
    feasible = ok_det & (max_slack <= tol[:, :, None])            # [K, NF, C]
    x = torch.stack([x0, x1, x2], dim=-1)                         # [K, NF, C, 3]

    # Angular sort in the face plane around the feasible centroid.
    ex = const(_EX, dev)
    ey = const(_EY, dev)
    t1 = torch.where(torch.abs(n_f[..., 0:1]) < 0.9, ex, ey)
    t1 = t1 - torch.sum(t1 * n_f, dim=-1, keepdim=True) * n_f
    t1 = t1 / torch.sqrt(torch.sum(t1 * t1, dim=-1, keepdim=True))
    t2 = _cross(n_f, t1)
    wsum = torch.clamp_min(torch.sum(feasible, dim=-1, keepdim=True), 1)
    centroid = torch.sum(torch.where(feasible[..., None], x, 0.0), dim=2) / wsum
    rel = x - centroid[:, :, None, :]
    ang = torch.atan2(
        torch.sum(rel * t2[:, :, None, :], dim=-1),
        torch.sum(rel * t1[:, :, None, :], dim=-1),
    )
    ang = torch.where(feasible, ang, 1e9)
    # Stable, as jnp.argsort is: duplicate corners (apex collapse) tie.
    order = torch.argsort(ang, dim=-1, stable=True)
    xs = torch.gather(x, 2, order[..., None].expand(-1, -1, -1, 3))
    fs = torch.gather(feasible, 2, order)

    # Dedup: a sorted candidate is a NEW vertex if it differs from the
    # previous one; duplicates are angle-adjacent.
    prev = torch.cat([xs[:, :, :1] + 1e9, xs[:, :, :-1]], dim=2)
    dist2 = torch.sum((xs - prev) ** 2, dim=-1)
    tol4sq = ((tol * 4.0) ** 2)[:, :, None]
    distinct = fs & (dist2 > tol4sq)
    rank = torch.cumsum(distinct.to(I32), dim=-1).to(I32) - 1
    cnt = torch.max(torch.where(distinct, rank + 1, 0), dim=-1).values

    # Scatter the first MAX_FACE_VTX distinct vertices per face; everything
    # else goes to an overflow slot that is cut off.
    keep = distinct & (rank < MAX_FACE_VTX)
    slot = torch.where(keep, rank, MAX_FACE_VTX).to(I64)
    face_vtx = torch.zeros((K, _NF, MAX_FACE_VTX + 1, 3), dtype=F32, device=dev)
    face_vtx.scatter_(2, slot[..., None].expand(-1, -1, -1, 3),
                      torch.where(keep[..., None], xs, 0.0))
    face_vtx = face_vtx[:, :, :MAX_FACE_VTX]
    cnt = torch.clamp_max(cnt, MAX_FACE_VTX)
    # Wraparound dedup: duplicates of one vertex can land at BOTH ends of
    # the angular order (atan2 seam at +-pi); compare last-kept with first.
    last_idx = torch.clamp_min(cnt - 1, 0).to(I64)[..., None, None].expand(-1, -1, 1, 3)
    last = torch.gather(face_vtx, 2, last_idx)[:, :, 0, :]
    wrap_dup = (cnt >= 2) & (
        torch.sum((last - face_vtx[:, :, 0, :]) ** 2, dim=-1) <= (tol * 4.0) ** 2
    )
    cnt = torch.where(wrap_dup, cnt - 1, cnt)
    # Pad empty slots with vertex 0 (harmless zero-area fans).
    k_ids = torch.arange(MAX_FACE_VTX, device=dev)
    pad_mask = k_ids >= cnt[..., None]
    face_vtx = torch.where(pad_mask[..., None], face_vtx[:, :, :1, :], face_vtx)

    # Areas from the fan (counted only when >= 3 vertices).
    v0 = face_vtx[:, :, 0:1, :]
    e1 = face_vtx[:, :, 1:-1, :] - v0
    e2 = face_vtx[:, :, 2:, :] - v0
    cr = _cross(e1, e2)
    tri_area = 0.5 * torch.sqrt(torch.clamp_min(torch.sum(cr * cr, dim=-1), 0.0))
    kk = torch.arange(1, MAX_FACE_VTX - 1, device=dev)
    amask = kk + 1 < cnt[..., None]
    areas = torch.sum(torch.where(amask, tri_area, 0.0), dim=-1)

    # Width gate: reject faces whose area/perimeter width is at the dedup
    # resolution (zero-width slivers with >= 3 distinct vertices).
    nxt = torch.roll(face_vtx, -1, dims=2)
    edge_valid = (k_ids < cnt[..., None] - 1) | (
        (k_ids == cnt[..., None] - 1) & (cnt[..., None] >= 3)
    )
    ed = torch.where(edge_valid[..., None], nxt - face_vtx, 0.0)
    edge_len = torch.sqrt(torch.sum(ed * ed, dim=-1))
    perimeter = torch.sum(edge_len, dim=-1)
    width = 2.0 * areas / torch.clamp_min(perimeter, 1e-20)
    thin = width <= 8.0 * tol
    cnt = torch.where(thin, 0, cnt)
    areas = torch.where(thin, 0.0, areas)
    return face_vtx, cnt.to(I32), areas


def _fix_winding(face_vtx, cnt, plane_n):
    """Ensure CCW-from-outside: if the fan normal opposes the plane normal,
    reverse the vertex order (the entry sampler relies on raw fan winding)."""
    dev = face_vtx.device
    v0 = face_vtx[:, :, 0:1, :]
    e1 = face_vtx[:, :, 1:-1, :] - v0
    e2 = face_vtx[:, :, 2:, :] - v0
    kk = torch.arange(1, MAX_FACE_VTX - 1, device=dev)
    amask = (kk + 1 < cnt[..., None])[..., None]
    n_fan = torch.sum(torch.where(amask, _cross(e1, e2), 0.0), dim=2)
    flip = torch.sum(n_fan * plane_n, dim=-1) < 0.0
    idx = torch.arange(MAX_FACE_VTX, device=dev)
    # Reversed order keeping v0 first: [0, cnt-1, cnt-2, ..., 1, pads...].
    rev = torch.where(idx == 0, 0, cnt[..., None] - idx)
    rev = torch.clamp(rev, 0, MAX_FACE_VTX - 1).to(I64)
    reversed_vtx = torch.gather(face_vtx, 2, rev[..., None].expand(-1, -1, -1, 3))
    return torch.where(flip[..., None, None], reversed_vtx, face_vtx)


def pyramid_geom_batch(h1, h2, h3, alpha_u_deg: float, alpha_l_deg: float,
                       dist) -> CrystalGeom:
    """Closed-form hexagonal pyramids.

    h1/h3 [K]: relative cone heights in [0, 1]; h2 [K]: prism height ratio;
    alpha_*: wedge angles in degrees (python floats; outside [0.1, 89.9] the
    cone is skipped); dist [K, 6]: signed face distances. Every shape is
    built alone, so a pool is built in passes of GEOM_CHUNK shapes (the
    device's), with the same values.
    """
    h1 = torch.clamp(torch.as_tensor(h1, dtype=F32), 0.0, 1.0)
    dev = h1.device
    h3 = torch.clamp(torch.as_tensor(h3, dtype=F32, device=dev), 0.0, 1.0)
    h2 = torch.as_tensor(h2, dtype=F32, device=dev)
    dist = torch.as_tensor(dist, dtype=F32, device=dev)
    n = GEOM_CHUNK.get(dev.type, GEOM_CHUNK["cuda"])
    if h1.shape[0] <= n:
        return _pyramid_geoms(h1, h2, h3, alpha_u_deg, alpha_l_deg, dist)
    parts = [_pyramid_geoms(h1[i:i + n], h2[i:i + n], h3[i:i + n], alpha_u_deg, alpha_l_deg,
                            dist[i:i + n])
             for i in range(0, h1.shape[0], n)]
    return CrystalGeom(*(torch.cat(xs) for xs in zip(*parts)))


def _pyramid_geoms(h1, h2, h3, alpha_u_deg: float, alpha_l_deg: float,
                   dist) -> CrystalGeom:
    """pyramid_geom_batch of one pass: float32 [K] and [K, 6] tensors on one
    device, h1 and h3 clamped."""
    dev = h1.device
    K = h1.shape[0]

    cs = const(HEX_COS, dev)
    sn = const(HEX_SIN, dev)
    dist_scaled = float(np.float32(_INSET_K)) * dist
    m_apex_scaled = _apex_lp(dist_scaled)
    m_apex = divs(m_apex_scaled, float(np.float32(_INSET_K)))
    region_ok = m_apex_scaled > -1e29

    has_u = _MIN_ALPHA <= alpha_u_deg <= _MAX_ALPHA
    has_l = _MIN_ALPHA <= alpha_l_deg <= _MAX_ALPHA
    tan_u = float(np.tan(np.radians(alpha_u_deg))) if has_u else 0.0
    tan_l = float(np.tan(np.radians(alpha_l_deg))) if has_l else 0.0
    a1 = float(np.float32(_INSET_K / tan_u)) if has_u else 0.0
    a2 = float(np.float32(_INSET_K / tan_l)) if has_l else 0.0

    zero = torch.zeros(K, dtype=F32, device=dev)
    h2_half = 0.5 * h2
    m_top = torch.clamp_min(h1 * m_apex if has_u else zero, 0.0)
    m_bot = torch.clamp_min(h3 * m_apex if has_l else zero, 0.0)
    z_top = h2_half + a1 * m_top
    z_bot = -h2_half - a2 * m_bot

    # Plane set (unit normals + constants): basal, prism sides n = (cs, sn,
    # 0), d = -(sqrt3/4) dist; cones with unit normal (cs cosA, sn cosA,
    # +-sinA).
    zeros6 = torch.zeros(6, dtype=F32, device=dev)
    n_basal = const(_N_BASAL, dev)
    d_basal = torch.stack([-z_top, z_bot], dim=-1)
    n_prism = torch.stack([cs, sn, zeros6], dim=-1)
    d_prism = -dist_scaled
    inert_d = torch.full((K, 6), -1e6, dtype=F32, device=dev)
    if has_u:
        cos_u = float(np.cos(np.radians(alpha_u_deg)))
        sin_u = float(np.sin(np.radians(alpha_u_deg)))
        n_up = torch.stack([cs * cos_u, sn * cos_u, zeros6 + sin_u], dim=-1)
        d_up = -(dist_scaled + (tan_u * h2_half)[:, None]) * cos_u
    else:
        n_up, d_up = n_prism, inert_d
    if has_l:
        cos_l = float(np.cos(np.radians(alpha_l_deg)))
        sin_l = float(np.sin(np.radians(alpha_l_deg)))
        n_lo = torch.stack([cs * cos_l, sn * cos_l, zeros6 - sin_l], dim=-1)
        d_lo = -(dist_scaled + (tan_l * h2_half)[:, None]) * cos_l
    else:
        n_lo, d_lo = n_prism, inert_d

    plane_n = torch.cat([n_basal, n_prism, n_up, n_lo], dim=0)[None].expand(K, -1, -1)
    plane_d = torch.cat([d_basal, d_prism, d_up, d_lo], dim=-1)   # [K, 20]

    # Polygons + presence by exact vertex enumeration.
    ref_scale = torch.maximum(torch.max(torch.abs(dist), dim=-1).values,
                              torch.abs(z_top - z_bot))
    face_vtx, cnt, areas = _face_polygons(plane_n, plane_d, ref_scale)
    tol_a = 1e-8 * torch.clamp_min(ref_scale, 0.1) ** 2
    degenerate = (z_top - z_bot <= _EPS) | ~region_ok
    face_present = (cnt >= 3) & (areas > tol_a[:, None]) & ~degenerate[:, None]
    face_vtx = _fix_winding(face_vtx, cnt, plane_n)
    cnt = torch.where(face_present, cnt, 0).to(I32)

    return CrystalGeom(
        plane_n=plane_n,
        plane_d=plane_d,
        face_number=const(PYRAMID_FACE_NUMBER, dev)[None].expand(K, -1),
        face_present=face_present,
        face_vtx=face_vtx,
        face_vtx_cnt=cnt,
    )


def pyramid_geom(h1, h2, h3, alpha_u_deg: float, alpha_l_deg: float, dist) -> CrystalGeom:
    """One closed-form hexagonal pyramid (scalars and dist [6])."""
    one = lambda v: torch.as_tensor(v, dtype=F32).reshape(1)  # noqa: E731
    return squeeze_geom(pyramid_geom_batch(
        one(h1), one(h2), one(h3), alpha_u_deg, alpha_l_deg,
        torch.as_tensor(dist, dtype=F32).reshape(1, 6)))
