"""The general trace of one scattering layer, render mode only: a frozen copy
of the port's ``core/trace_soa.trace_layer_soa`` (with ``lane_pool_rows``
and ``_pick_row``) as of commit 8eb2fd2, its gradient modes (``score_grad``,
``frozen``, ``record``, ``soft_tau``) left out and its imports pointed here.
The reference of a cell on the general trace (``reference/two_layer.py``)
calls it; the rotation and the Fresnel split are ``trace_soa.py``'s.

Slot-major exits: [H, B] arrays, slot 0 the entry reflection, slot k the
refracted exit of bounce k, with the face-number path.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from portbench.reference.plain.core import optics, rng
from portbench.reference.plain.core.bits import F32, I32, I64
from portbench.reference.plain.core.trace import GeomPool
from portbench.reference.plain.core.trace_soa import (
    _fresnel_split_soa,
    rot_apply,
    rot_apply_inv,
)

SLAB_EPS = optics.SLAB_EPS
_BIG = 1e30


class SoAExits(NamedTuple):
    """Slot-major exits of one scattering layer: dx/dy/dz/w [H, B]; path
    [H, B] int32 face numbers (slot h's raypath is path[:h+1, i], 0 on a
    dead lane); entry_ok [B]."""

    dx: torch.Tensor
    dy: torch.Tensor
    dz: torch.Tensor
    w: torch.Tensor
    path: torch.Tensor
    entry_ok: torch.Tensor


def lane_pool_rows(setting_blocks, B: int, device):
    """Pool row of every lane under the per-setting blocked assignment: ray
    i of setting s (lanes off_s .. off_s + count_s) reads pool row
    row0_s + (i - off_s) // g_s, with g_s = count_s // k_s."""
    parts = []
    row = 0
    for k_s, count_s in setting_blocks:
        if count_s:
            g_s = count_s // k_s
            parts.append(row + torch.arange(count_s, dtype=I64, device=device) // g_s)
        row += k_s
    sidx = parts[0] if len(parts) == 1 else torch.cat(parts)
    if sidx.shape[0] != B:
        raise ValueError(f"setting blocks cover {sidx.shape[0]} lanes, not {B}")
    return sidx


def _pick_row(tab, idx):
    """tab[idx[b], b] for a [N, B] table, tab[idx[b], 0] for a shared [N, 1]."""
    if tab.shape[1] == 1:
        return tab[idx, 0]
    return tab.gather(0, idx[None, :])[0]


def trace_layer_soa(seed, ray_idx, d_world, w0, rot, pool: GeomPool, n_ior,
                    max_hits: int, setting_blocks: Optional[tuple] = None):
    """One scattering layer.

    seed: the layer's per-ray seed (int64-held u32, [B] or scalar); ray_idx
    [B]; d_world (dx, dy, dz) world directions; w0 [B]; rot the 9 rotation
    components; pool the layer's K shapes; setting_blocks ((k_s, count_s),
    ...) maps lanes to pool rows (K == 1 with one setting is shared by
    every lane)."""
    B = ray_idx.shape[0]
    dev = ray_idx.device
    entry_seed = rng._t(seed, ray_idx) ^ rng.NONCE_ENTRY
    K, NF = pool.plane_n.shape[0], pool.plane_n.shape[1]
    T = pool.tri_face.shape[1]
    shared = K == 1 and (setting_blocks is None or len(setting_blocks) == 1)

    wx, wy, wz = d_world
    dx, dy, dz = rot_apply_inv(rot, wx, wy, wz)

    if shared:
        sidx = None

        def cols(a):                    # [1, N] -> [N, 1]
            return a[0][:, None]
    else:
        if setting_blocks is None:
            raise ValueError("a pool of several shapes needs setting_blocks")
        sidx = lane_pool_rows(setting_blocks, B, dev)

        def cols(a):                    # [K, N] -> [N, B]
            return a.t().index_select(1, sidx)

    nx, ny, nz = (cols(pool.plane_n[..., c]) for c in range(3))
    pd = cols(pool.plane_d)
    present = cols(pool.face_present)
    face_num = cols(pool.face_number)

    # Entry triangle: slots 10-12. The CDF is a float32 running sum in
    # triangle order (the order of the trace kernel's plain version).
    chx, chy, chz = (cols(pool.tri_cross_half[..., c]) for c in range(3))
    wt = torch.clamp_min(-(chx * dx[None, :] + chy * dy[None, :] + chz * dz[None, :]), 0.0)
    run = torch.zeros(B, dtype=F32, device=dev)
    cdf = []
    for t in range(T):
        run = run + wt[t]
        cdf.append(run)
    total = run
    has_entry = total > 0.0
    target = rng.uniform(entry_seed, ray_idx, 10) * total
    sel = torch.clamp((torch.stack(cdf) <= target[None, :]).sum(dim=0), 0, T - 1)
    entry_ok = has_entry
    u = rng.uniform(entry_seed, ray_idx, 11)
    v = rng.uniform(entry_seed, ray_idx, 12)
    over = u + v > 1.0
    u = torch.where(over, 1.0 - u, u)
    v = torch.where(over, 1.0 - v, v)
    prow = torch.zeros_like(sel) if shared else sidx
    v0, e1, e2 = (t3[prow, sel] for t3 in (pool.tri_v0, pool.tri_e1, pool.tri_e2))
    px = v0[:, 0] + u * e1[:, 0] + v * e2[:, 0]
    py = v0[:, 1] + u * e1[:, 1] + v * e2[:, 1]
    pz = v0[:, 2] + u * e1[:, 2] + v * e2[:, 2]
    f0 = pool.tri_face[prow, sel].to(I64)

    w = torch.where(entry_ok, w0, 0.0)
    n0x, n0y, n0z = _pick_row(nx, f0), _pick_row(ny, f0), _pick_row(nz, f0)
    fn0 = _pick_row(face_num, f0)

    # Entry Fresnel (air -> ice): the reflected child exits as slot 0.
    (rx, ry, rz), (tx, ty, tz), w_r, w_t, _ = _fresnel_split_soa(
        dx, dy, dz, n0x, n0y, n0z, w, n_ior)
    e0x, e0y, e0z = rot_apply(rot, rx, ry, rz)
    exit0_w = torch.where(entry_ok, w_r, 0.0)

    # Plane distances of the entry point, updated per bounce.
    dist = px[None, :] * nx + py[None, :] * ny + pz[None, :] * nz + pd
    face_iota = torch.arange(NF, dtype=I64, device=dev)[:, None]
    cx, cy, cz, cw = tx, ty, tz, w_t
    prev_f = f0
    ex_l, ey_l, ez_l, ew_l, fn_l = [e0x], [e0y], [e0z], [exit0_w], [fn0]
    for _k in range(max_hits - 1):
        denom = cx[None, :] * nx + cy[None, :] * ny + cz[None, :] * nz
        t_face = -dist / torch.where(torch.abs(denom) > 1e-30, denom, 1e-30)
        candidate = (denom > SLAB_EPS) & present & (face_iota != prev_f[None, :])
        # Ties and the no-candidate case go to the lowest face slot.
        t, fi = torch.min(torch.where(candidate, t_face, _BIG), dim=0)
        found = (t < _BIG * 0.5) & (t > -SLAB_EPS)
        alive = found & (cw > 0.0)
        nfx, nfy, nfz = _pick_row(nx, fi), _pick_row(ny, fi), _pick_row(nz, fi)
        fn = _pick_row(face_num, fi)
        dist = torch.where(alive[None, :], dist + t[None, :] * denom, dist)
        (rx, ry, rz), (tx, ty, tz), w_r, w_t, is_tir = _fresnel_split_soa(
            cx, cy, cz, nfx, nfy, nfz, cw, n_ior)
        cos_exit = tx * nfx + ty * nfy + tz * nfz
        emit_ok = alive & ~is_tir & (cos_exit > 0.0)
        ex, ey, ez = rot_apply(rot, tx, ty, tz)
        ex_l.append(ex)
        ey_l.append(ey)
        ez_l.append(ez)
        ew_l.append(torch.where(emit_ok, w_t, 0.0))
        fn_l.append(torch.where(alive, fn, 0))
        cx = torch.where(alive, rx, cx)
        cy = torch.where(alive, ry, cy)
        cz = torch.where(alive, rz, cz)
        cw = torch.where(alive, w_r, 0.0)
        prev_f = torch.where(alive, fi, prev_f)
    return SoAExits(
        dx=torch.stack(ex_l), dy=torch.stack(ey_l), dz=torch.stack(ez_l),
        w=torch.stack(ew_l), path=torch.stack(fn_l).to(I32), entry_ok=entry_ok)
