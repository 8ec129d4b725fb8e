"""The general trace of one scattering layer (port of
``ice_halo_sim_tpu.core.trace_soa``): component-form rotation, the Fresnel
split, ``trace_layer_soa`` with its gradient modes and ``compact_slots``.

Plain PyTorch on the engine's device, as the trace is XLA (not Pallas) in the
JAX package. Same RNG streams, the same float32 operation order and the same
exits: [H, B] slot-major arrays, slot 0 the entry reflection, slot k the
refracted exit of bounce k, with the face-number path.

TPU workarounds dropped, values kept:
  - the one-hot masked sums that pick a face's normal or a triangle's
    corners (no gathers on the TPU) are indexed reads here; a one-hot sum of
    one value and zeros is that value;
  - the [K, N] -> [N, B] broadcast expansion of the pool tables is an index
    by the ray's pool row;
  - ``compact_slots`` routes by a butterfly of rolls along the slot axis
    there; here it is one indexed write per live slot at its exclusive live
    rank.

``trace_layer_cuda`` is the render mode's CUDA kernel KL
(csrc/trace_layer.cu): one launch a layer, bit-equal to ``trace_layer_soa``
on the card. The engine's "cuda" kernel set takes it; the "plain" set and
the gradient path take ``trace_layer_soa``.

``layer_epilogue`` is what the general path does with a layer's exits: the
filter, probability and emit-floor gates, colour bits, the slot cap and the
projection into every render, as contribution rows (``LayerRows``).
``trace_layer_emit_cuda`` is KL's emit mode, the trace and that epilogue in
one launch where the layer has no filter and no colour class and the
renders' lenses are the trace kernel's (``emit_refusal``); its plain twin
``trace_layer_emit_plain`` is ``trace_layer_soa`` then ``layer_epilogue``.

The gradient modes (``score_grad``, ``frozen``, ``record``, ``soft_tau``;
engine/gradient.py) run on torch autograd. Without them the ops are the
render mode's: the face index carry and indexed reads. ``soft_tau`` alone
carries the previous face as a soft [NF, B] weight and blends by one-hot
sums, as the JAX function does in every mode: a soft weight is not an index.
"""

from __future__ import annotations

import ctypes
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ice_halo_sim_tpu_torch.core import optics, projection, rng
from ice_halo_sim_tpu_torch.core.bits import F32, I32, I64, MASK32, divs, sdiv
from ice_halo_sim_tpu_torch.core.sampling import HALF_PI_F, PI_F, _rot9
from ice_halo_sim_tpu_torch.core.trace import GeomPool
from ice_halo_sim_tpu_torch.kernels import build

SLAB_EPS = optics.SLAB_EPS
_BIG = 1e30


class FrozenChoices(NamedTuple):
    """The trace's discrete decisions at one (seed, params) base point.

    Re-running the trace at perturbed params with these choices reused
    (``frozen=``) removes every discontinuous branch (entry triangle, slab
    argmin face, TIR, emit gates) from a finite-difference comparison."""

    entry_sel: torch.Tensor   # [B] int32 entry sub-triangle index
    entry_ok: torch.Tensor    # [B] bool
    faces: torch.Tensor       # [H-1, B] int32 slab argmin face slot
    alive: torch.Tensor       # [H-1, B] bool lane alive after the hit
    is_tir: torch.Tensor      # [H-1, B] bool internal TIR decision
    emit_ok: torch.Tensor     # [H-1, B] bool refracted exit emitted


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


def compact_slots(live, cols, cap: int):
    """Per-ray stable live-first compaction along the slot axis.

    live: [H, B] bool; cols: list of [H, B] tensors. Returns (out_cols
    [cap, B], keep_mask [cap, B], n_live [B]): each ray's live rows move to
    its slot prefix in their original order. Rows past a ray's live count
    are masked by keep_mask (their payloads are unspecified, 0 here)."""
    H, B = live.shape
    lv = live.to(I64)
    rank = torch.cumsum(lv, dim=0) - lv
    # Dead rows are routed to a spare row H that is cut off.
    dst = torch.where(live, rank, H)
    outs = []
    for c in cols:
        out = torch.zeros((H + 1, B), dtype=c.dtype, device=c.device)
        out.scatter_(0, dst, c)
        outs.append(out[:cap])
    n_live = lv.sum(dim=0)
    keep = torch.arange(cap, device=live.device)[:, None] < n_live[None, :]
    return outs, keep, n_live.to(I32)


def rot_components(lon, lat, roll):
    """The 9 rotation components (row-major, world = R @ crystal) of the
    orientation angles (radians)."""
    a = lon - PI_F
    b = lat - HALF_PI_F
    return _rot9(torch.cos(a), torch.sin(a), torch.cos(b), torch.sin(b),
                 torch.cos(roll), torch.sin(roll))


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
                    max_hits: int, setting_blocks: Optional[tuple] = None,
                    score_grad: bool = False, frozen: Optional[FrozenChoices] = None,
                    record: bool = False, soft_tau: Optional[float] = None):
    """One scattering layer.

    seed: the layer's per-ray seed (int64-held u32, [B] or scalar); ray_idx
    [B]; d_world (dx, dy, dz) world directions; w0 [B]; rot the 9 rotation
    components; pool the layer's K shapes; setting_blocks ((k_s, count_s),
    ...) maps lanes to pool rows (K == 1 with one setting is shared by
    every lane).

    Gradient modes (all off in rendering):
      score_grad: the weights carry the REINFORCE score term of the entry
        triangle's choice, w * exp(log_p - log_p.detach()) (value w);
      frozen: reuse a recording's FrozenChoices (entry triangle, faces,
        alive, TIR, emit gates); t is that of the frozen face;
      record: return (exits, FrozenChoices);
      soft_tau: the face pick becomes a softmin over exit t at temperature
        soft_tau (crystal units): normals and t blend across a face
        reassignment boundary, so autodiff carries the boundary flux that
        the hard argmin drops (bias O(soft_tau)). Face numbers stay hard."""
    B = ray_idx.shape[0]
    dev = ray_idx.device
    entry_seed = rng._t(seed, ray_idx) ^ rng.NONCE_ENTRY
    K, NF = pool.plane_n.shape[0], pool.plane_n.shape[1]
    T = pool.tri_face.shape[1]
    shared = K == 1 and (setting_blocks is None or len(setting_blocks) == 1)
    soft = soft_tau is not None and frozen is None

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
    if frozen is None:
        target = rng.uniform(entry_seed, ray_idx, 10) * total
        sel = torch.clamp((torch.stack(cdf) <= target[None, :]).sum(dim=0), 0, T - 1)
        entry_ok = has_entry
    else:
        sel = frozen.entry_sel.to(I64)
        entry_ok = frozen.entry_ok
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
    if score_grad:
        # log p of the chosen triangle; the inner where keeps log's
        # gradient finite where w_sel is 0.
        w_sel = wt.gather(0, sel[None, :])[0]
        safe_total = torch.where(has_entry, total, 1.0)
        log_p = torch.where(
            has_entry & (w_sel > 0),
            torch.log(torch.where(w_sel > 0, w_sel, 1.0)) - torch.log(safe_total), 0.0)
        w = w * torch.exp(log_p - log_p.detach())
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
    if soft:
        prev_oh = (face_iota == f0[None, :]).to(F32)
    ex_l, ey_l, ez_l, ew_l, fn_l = [e0x], [e0y], [e0z], [exit0_w], [fn0]
    rec = []
    for k in range(max_hits - 1):
        denom = cx[None, :] * nx + cy[None, :] * ny + cz[None, :] * nz
        t_face = -dist / torch.where(torch.abs(denom) > 1e-30, denom, 1e-30)
        if frozen is None:
            excl = (prev_oh < 0.5) if soft else (face_iota != prev_f[None, :])
            candidate = (denom > SLAB_EPS) & present & excl
            # Ties and the no-candidate case go to the lowest face slot.
            t_hard, fi = torch.min(torch.where(candidate, t_face, _BIG), dim=0)
            found = (t_hard < _BIG * 0.5) & (t_hard > -SLAB_EPS)
            alive = found & (cw > 0.0)
            t = t_hard
        else:
            fi = frozen.faces[k].to(I64)
            alive = frozen.alive[k]
            t = t_face.gather(0, fi[None, :])[0]
        if soft:
            # Softmin over the candidates' exit t; exp is taken on
            # candidate rows within 20 tau of the nearest only.
            dt = torch.where(candidate, t_face, _BIG) - t_hard[None, :]
            s_raw = torch.where(candidate & (dt < 20.0 * soft_tau),
                                torch.exp(divs(-dt, soft_tau)), 0.0)
            oh = s_raw / torch.clamp_min(s_raw.sum(dim=0), 1e-30)[None, :]
            t = (oh * torch.where(candidate, t_face, 0.0)).sum(dim=0)
            nfx, nfy, nfz = (oh * nx).sum(dim=0), (oh * ny).sum(dim=0), (oh * nz).sum(dim=0)
        else:
            nfx, nfy, nfz = _pick_row(nx, fi), _pick_row(ny, fi), _pick_row(nz, fi)
        fn = _pick_row(face_num, fi)
        dist = torch.where(alive[None, :], dist + t[None, :] * denom, dist)
        (rx, ry, rz), (tx, ty, tz), w_r, w_t, is_tir = _fresnel_split_soa(
            cx, cy, cz, nfx, nfy, nfz, cw, n_ior,
            tir_in=None if frozen is None else frozen.is_tir[k])
        if frozen is None:
            cos_exit = tx * nfx + ty * nfy + tz * nfz
            emit_ok = alive & ~is_tir & (cos_exit > 0.0)
        else:
            emit_ok = frozen.emit_ok[k]
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
        if soft:
            prev_oh = torch.where(alive[None, :], oh, prev_oh)
        else:
            prev_f = torch.where(alive, fi, prev_f)
        if record:
            rec.append((fi.to(I32), alive, is_tir, emit_ok))
    exits = SoAExits(
        dx=torch.stack(ex_l), dy=torch.stack(ey_l), dz=torch.stack(ez_l),
        w=torch.stack(ew_l), path=torch.stack(fn_l).to(I32), entry_ok=entry_ok)
    if not record:
        return exits
    return exits, FrozenChoices(sel.to(I32), entry_ok, *(torch.stack(c) for c in zip(*rec)))


def uniform_slots(seed_vec, ray_idx, slots):
    """One uniform draw per (slot, ray): stream (seed, ray index), draw slot
    slots[h] ([H, 1] int64). Returns [H, B]."""
    idx = rng._t(ray_idx)[None, :]
    inner = rng.pcg_hash((idx * 1000003 + slots) & MASK32)
    return rng.u01(rng.pcg_hash(rng._t(seed_vec)[None, :] ^ inner))


class EmitSpec(NamedTuple):
    """The epilogue of one layer: its probability gate (``prob``; on the
    ``last`` layer what would continue is dropped), the emit floor
    (``emit_frac`` of the batch's mean initial weight, 0: off; ``rr``:
    Russian roulette, else a drop), the slot cap (None: the calibrating
    batch, which keeps every slot and measures the mass per live rank) and
    the renders (ProjPlans) the kept exits are projected into."""

    prob: float
    last: bool
    emit_frac: float
    rr: bool
    cap: Optional[int]
    renders: tuple


class LayerRows(NamedTuple):
    """One layer's contribution rows and the per-lane parts of its stats.

    pix, w: per (render, pass) -- each render's main pass, then its overlap
      pass where it has one -- [rows, B] int32 pixels (-1: nothing lands)
      and float32 weights (0 there); rows = the cap, each lane's live exits
      first in slot order, or every slot in its own row when the cap is
      max_hits;
    mask: [rows, B] int64 component masks (colour classes), else None (0);
    seg: [B] int32 deepest live raw exit slot + 1 (0: none);
    dropped: [B] float32 mass the emit floor changed and the cap dropped, a
      running sum in slot order;
    cont: (w, dx, dy, dz) [H, B], the continuation's inputs (the continuing
      weight of every exit slot, uncapped); None on the last layer;
    exit_mask: [H, B] int64 component masks of every exit (colour classes),
      the continuation's, else None;
    slot_mass: [H] float32 mass per live rank (the calibrating batch), else
      None."""

    pix: tuple
    w: tuple
    mask: Optional[torch.Tensor]
    seg: torch.Tensor
    dropped: torch.Tensor
    cont: Optional[tuple]
    exit_mask: Optional[torch.Tensor]
    slot_mass: Optional[torch.Tensor]


def layer_epilogue(exits: SoAExits, seed, ray_idx, w_scale, spec: EmitSpec,
                   filter_gate: Optional[Callable] = None,
                   color_bits: Optional[Callable] = None,
                   carried_mask=None) -> LayerRows:
    """The general path's epilogue of one layer's exits (plain PyTorch; the
    twin of KL's emit mode, bit for bit where that mode applies).

    seed: the layer's per-ray seed [B] (int64-held u32); ray_idx [B];
    w_scale: the batch's mean initial weight (a 0-dim float32 tensor), the
    emit floor's scale. filter_gate(live [H, B] bool) -> [H, B] bool: the
    raypath filters' verdict, a failing exit neither accumulates nor
    continues; color_bits(live) -> [H, B] int64: this layer's colour
    predicate bits; carried_mask [B] int64: the component bits carried in,
    given whenever the scene has colour classes."""
    exit_w = exits.w
    H, B = exit_w.shape
    dev = exit_w.device
    slot_ids = torch.arange(H, dtype=I64, device=dev)[:, None]
    # Traced segments: the deepest live raw exit slot of each lane.
    seg = torch.where(exit_w > 0.0, slot_ids + 1, 0).amax(dim=0).to(I32)
    if filter_gate is not None:
        exit_w = torch.where(filter_gate(exit_w > 0.0), exit_w, 0.0)

    # Probability gate per exit slot (stream: ray index, slot 100 + h).
    to_continue = acc_mask = None
    if spec.prob > 0.0:
        u = uniform_slots(seed ^ rng.NONCE_GATE, ray_idx, 100 + slot_ids)
        if spec.last:
            acc_mask = u >= spec.prob      # would-continue rays are dropped
        else:
            to_continue = (u < spec.prob) & (exit_w > 0.0)
            acc_mask = ~to_continue

    # Component mask per exit: the carried bits OR this layer's predicates'.
    exit_mask = None
    if carried_mask is not None:
        exit_mask = carried_mask[None, :].expand(H, B)
        if color_bits is not None:
            exit_mask = exit_mask | color_bits(exit_w > 0.0)

    acc_w = exit_w if acc_mask is None else torch.where(acc_mask, exit_w, 0.0)
    floor_drop = None
    if spec.emit_frac > 0.0:
        # Emit-time weight floor: sub-threshold exits are thinned from
        # accumulation only, never from continuation.
        w_cut = w_scale * float(np.float32(spec.emit_frac))
        tiny = (acc_w > 0.0) & (acc_w < w_cut)
        if spec.rr:
            u_rr = uniform_slots(seed ^ rng.NONCE_EMIT, ray_idx, slot_ids)
            new_w = torch.where(tiny, torch.where(u_rr * w_cut < acc_w, w_cut, 0.0), acc_w)
        else:
            new_w = torch.where(tiny, 0.0, acc_w)
        floor_drop = acc_w - new_w
        acc_w = new_w
    lv = acc_w > 0.0
    rank = torch.cumsum(lv.to(I64), dim=0) - lv.to(I64)
    slot_mass = None
    if spec.cap is None:
        # Calibrating: mass per live rank; rank c's mass is what a cap of c
        # would drop from that slot downward.
        slot_mass = torch.stack([
            torch.sum(torch.where(lv & (rank == c), acc_w, 0.0)) for c in range(H)])
    cap = H if spec.cap is None else spec.cap
    # The dropped mass per lane, in slot order: the floor's net change, then
    # the live exits past the cap.
    dropped = torch.zeros(B, dtype=F32, device=dev)
    for h in range(H):
        if floor_drop is not None:
            dropped = dropped + floor_drop[h]
        if cap < H:
            dropped = dropped + torch.where(lv[h] & (rank[h] >= cap), acc_w[h], 0.0)

    if cap < H:
        # Per-lane live-first slot compaction; lanes with more than `cap`
        # live exits lose their deepest ones (accounted above).
        cols = [acc_w, exits.dx, exits.dy, exits.dz]
        comp, keep_m, _ = compact_slots(
            lv, cols + ([exit_mask] if exit_mask is not None else []), cap)
        row_w = torch.where(keep_m, comp[0], 0.0)
        row_d = comp[1:4]
        row_mask = torch.where(keep_m, comp[4], 0) if exit_mask is not None else None
    else:
        row_w, row_d, row_mask = acc_w, (exits.dx, exits.dy, exits.dz), exit_mask
    pix, w = [], []
    for pp in spec.renders:
        hits = projection.project_components(pp, *row_d)
        passes = [hits.main] + ([hits.overlap] if pp.max_abs_dz > 0.0 else [])
        for hit in passes:
            ok = (hit >= 0) & (row_w > 0.0)
            pix.append(torch.where(ok, hit, -1))
            w.append(torch.where(ok, row_w, 0.0))
    cont = None
    if not spec.last:
        cont_w = (torch.zeros((H, B), dtype=F32, device=dev) if to_continue is None
                  else torch.where(to_continue, exit_w, 0.0))
        cont = (cont_w, exits.dx, exits.dy, exits.dz)
    return LayerRows(tuple(pix), tuple(w), row_mask, seg, dropped, cont, exit_mask, slot_mass)


def emit_refusal(renders) -> Optional[str]:
    """Why KL's emit mode cannot project into these renders (ProjPlans), or
    None: it takes the trace kernel's lenses (projection.SUPPORTED_LENSES,
    no inverse trig) and at most projection.MAX_RENDERS renders."""
    for pp in renders:
        if pp.lens_type not in projection.SUPPORTED_LENSES:
            return f"lens {pp.lens_type}"
    if len(renders) > projection.MAX_RENDERS:
        return f"{len(renders)} renders"
    return None


def trace_layer_emit_plain(seed, ray_idx, d_world, w0, rot, pool: GeomPool, n_ior,
                           max_hits: int, setting_blocks: Optional[tuple] = None, *,
                           w_scale, spec: EmitSpec) -> LayerRows:
    """The emit mode's plain twin: ``trace_layer_soa``, then
    ``layer_epilogue`` with no filter and no colour class."""
    exits = trace_layer_soa(seed, ray_idx, d_world, w0, rot, pool, n_ior, max_hits,
                            setting_blocks)
    return layer_epilogue(exits, seed, ray_idx, w_scale, spec)


_VP = ctypes.c_void_p


class _LayerArgs(ctypes.Structure):
    """KL's argument block (csrc/trace_layer.cu LayerArgs)."""

    _fields_ = [
        ("seed", _VP), ("ray_idx", _VP), ("d", _VP * 3), ("w0", _VP), ("n_ior", _VP),
        ("rot", _VP * 9), ("rows", _VP),
        ("plane_n", _VP), ("plane_d", _VP), ("present", _VP), ("face_num", _VP),
        ("tri_ch", _VP), ("tri_v0", _VP), ("tri_e1", _VP), ("tri_e2", _VP), ("tri_face", _VP),
        ("out_d", _VP * 3), ("out_w", _VP), ("out_path", _VP), ("entry_ok", _VP),
        ("b", ctypes.c_longlong), ("h", ctypes.c_int32), ("nf", ctypes.c_int32),
        ("t", ctypes.c_int32),
    ]


# The pool's tables as KL reads them: (field, dtype, trailing shape after
# [K, NF] or [K, T]).
_POOL_TABLES = (
    ("plane_n", F32, (3,)), ("plane_d", F32, ()), ("face_present", torch.bool, ()),
    ("face_number", I32, ()), ("tri_cross_half", F32, (3,)), ("tri_v0", F32, (3,)),
    ("tri_e1", F32, (3,)), ("tri_e2", F32, (3,)), ("tri_face", I32, ()),
)


def check_layer_inputs(seed, ray_idx, d_world, w0, rot, pool: GeomPool, n_ior,
                       max_hits: int) -> int:
    """Raise ValueError where KL cannot take a call of trace_layer_soa's
    render mode; return its lane count B. Every lane column is a contiguous
    [B] tensor on one device (seed and ray index int64, the rest float32);
    the pool's tables have trace.GeomPool's dtypes, 8 or 20 face slots."""
    if not isinstance(ray_idx, torch.Tensor) or ray_idx.dim() != 1:
        raise ValueError("KL takes the ray index as a [B] tensor")
    if len(d_world) != 3 or len(rot) != 9:
        raise ValueError("KL takes 3 direction and 9 rotation components")
    B = ray_idx.shape[0]
    cols = [("seed", seed, I64), ("ray_idx", ray_idx, I64), ("w0", w0, F32),
            ("n_ior", n_ior, F32)]
    cols += [(f"d_world[{c}]", x, F32) for c, x in enumerate(d_world)]
    cols += [(f"rot[{c}]", x, F32) for c, x in enumerate(rot)]
    for name, x, dtype in cols:
        if not isinstance(x, torch.Tensor) or x.shape != (B,) or x.dtype != dtype:
            got = (tuple(x.shape), x.dtype) if isinstance(x, torch.Tensor) else type(x)
            raise ValueError(f"KL takes {name} as a [{B}] {dtype} tensor, not {got}")
        if not x.is_contiguous():
            raise ValueError(f"KL takes contiguous lane columns; {name} is strided "
                             f"{tuple(x.stride())}")
        if x.device != ray_idx.device:
            raise ValueError(f"KL takes every column on one device: {name} is on "
                             f"{x.device}, the ray index on {ray_idx.device}")
    K, NF = pool.plane_n.shape[0], pool.plane_n.shape[1]
    T = pool.tri_face.shape[1]
    if NF not in (8, 20):
        raise ValueError(f"KL is built for 8 or 20 face slots, not {NF}")
    for field, dtype, tail in _POOL_TABLES:
        x = getattr(pool, field)
        lead = (K, T) if field.startswith("tri_") else (K, NF)
        if x.dtype != dtype or tuple(x.shape) != lead + tail or x.device != ray_idx.device:
            raise ValueError(f"KL takes pool.{field} as a {list(lead + tail)} {dtype} "
                             f"tensor on {ray_idx.device}, not {list(x.shape)} {x.dtype} "
                             f"on {x.device}")
    if int(max_hits) < 1:
        raise ValueError(f"max_hits must be at least 1, got {max_hits}")
    return B


def _layer_args(seed, ray_idx, d_world, w0, rot, pool: GeomPool, n_ior, max_hits: int,
                setting_blocks, out, path, entry_ok):
    """KL's argument block of a checked call; out: the exits' (dx, dy, dz,
    w), [H, B] each, or None; path and entry_ok or None."""
    B = ray_idx.shape[0]
    dev = ray_idx.device
    K, NF = pool.plane_n.shape[0], pool.plane_n.shape[1]
    shared = K == 1 and (setting_blocks is None or len(setting_blocks) == 1)
    if not shared and setting_blocks is None:
        raise ValueError("a pool of several shapes needs setting_blocks")
    rows = None if shared else lane_pool_rows(setting_blocks, B, dev)
    tabs = [getattr(pool, f).contiguous() for f, _, _ in _POOL_TABLES]
    ptr = build.ptr
    a = _LayerArgs()
    a.seed, a.ray_idx, a.w0, a.n_ior = ptr(seed), ptr(ray_idx), ptr(w0), ptr(n_ior)
    for c in range(3):
        a.d[c] = ptr(d_world[c])
        a.out_d[c] = ptr(None if out is None else out[c])
    for c in range(9):
        a.rot[c] = ptr(rot[c])
    a.rows = ptr(rows)
    (a.plane_n, a.plane_d, a.present, a.face_num, a.tri_ch, a.tri_v0, a.tri_e1, a.tri_e2,
     a.tri_face) = (ptr(t) for t in tabs)
    a.out_w = ptr(None if out is None else out[3])
    a.out_path, a.entry_ok = ptr(path), ptr(entry_ok)
    a.b, a.h, a.nf, a.t = B, int(max_hits), NF, pool.tri_face.shape[1]
    # The block keeps the pool tables and the row index alive until launch.
    return a, (tabs, rows)


def trace_layer_cuda(seed, ray_idx, d_world, w0, rot, pool: GeomPool, n_ior,
                     max_hits: int, setting_blocks: Optional[tuple] = None) -> SoAExits:
    """KL (csrc/trace_layer.cu): the render mode of ``trace_layer_soa`` in
    one launch on CUDA tensors, every output bit-equal to it. Same
    arguments; raises ValueError where ``check_layer_inputs`` does or the
    tensors lie on the CPU (the plain function is the CPU's). The outputs
    are allocated here and the launch goes on the current stream without a
    sync, so a CUDA graph captures it."""
    B = check_layer_inputs(seed, ray_idx, d_world, w0, rot, pool, n_ior, max_hits)
    dev = ray_idx.device
    if dev.type == "cpu":
        raise ValueError("KL runs on CUDA tensors; trace_layer_soa is the CPU's trace")
    H = int(max_hits)
    out = torch.empty((4, H, B), dtype=F32, device=dev).unbind(0)
    path = torch.empty((H, B), dtype=I32, device=dev)
    entry_ok = torch.empty(B, dtype=torch.bool, device=dev)
    a, _keep = _layer_args(seed, ray_idx, d_world, w0, rot, pool, n_ior, H, setting_blocks,
                           out, path, entry_ok)
    lib = build.lib()
    with torch.cuda.device(dev):
        code = lib.iht_trace_layer(ctypes.addressof(a), build.stream_ptr(dev))
    build.check(code, "trace_layer")
    build.LAUNCHES["trace_layer"] += 1
    return SoAExits(dx=out[0], dy=out[1], dz=out[2], w=out[3], path=path, entry_ok=entry_ok)


class _EmitArgs(ctypes.Structure):
    """The emit mode's argument block (csrc/trace_layer.cu EmitArgs)."""

    _fields_ = [
        ("w_scale", _VP), ("out_pix", _VP * (2 * projection.MAX_RENDERS)),
        ("out_w", _VP * (2 * projection.MAX_RENDERS)), ("out_seg", _VP), ("out_drop", _VP),
        ("prob", ctypes.c_float), ("emit_frac", ctypes.c_float), ("emit_mode", ctypes.c_int32),
        ("last", ctypes.c_int32), ("cap", ctypes.c_int32), ("ren", projection.RenderConsts),
    ]


def check_emit_spec(spec: EmitSpec, w_scale, max_hits: int, device) -> None:
    """Raise ValueError where KL's emit mode cannot take this epilogue: the
    calibrating batch (no cap), a cap outside 1..max_hits, renders it does
    not project into (``emit_refusal``), an emit floor without its scale as
    a 0-dim float32 tensor on the lanes' device."""
    if spec.cap is None:
        raise ValueError("the emit mode needs a slot cap; the calibrating batch takes "
                         "layer_epilogue")
    if not 1 <= int(spec.cap) <= int(max_hits):
        raise ValueError(f"the slot cap {spec.cap} is outside 1..{max_hits}")
    if not spec.renders:
        raise ValueError("the emit mode projects into at least one render")
    reason = emit_refusal(spec.renders)
    if reason is not None:
        raise ValueError(f"the emit mode cannot project here: {reason}")
    if spec.emit_frac > 0.0 and not (
            isinstance(w_scale, torch.Tensor) and w_scale.shape == () and w_scale.dtype == F32
            and w_scale.device == device):
        raise ValueError(f"the emit floor's scale must be a 0-dim float32 tensor on {device}")


def trace_layer_emit_cuda(seed, ray_idx, d_world, w0, rot, pool: GeomPool, n_ior,
                          max_hits: int, setting_blocks: Optional[tuple] = None, *,
                          w_scale, spec: EmitSpec) -> LayerRows:
    """KL's emit mode: the layer's trace and ``layer_epilogue`` (no filter,
    no colour class) in one launch on CUDA tensors, every output bit-equal
    to ``trace_layer_emit_plain``'s. Raises ValueError where
    ``check_layer_inputs`` or ``check_emit_spec`` does, or on CPU tensors.
    The emit floor's scale is read from device memory at launch, so a
    captured graph replays the batch's own."""
    B = check_layer_inputs(seed, ray_idx, d_world, w0, rot, pool, n_ior, max_hits)
    dev = ray_idx.device
    check_emit_spec(spec, w_scale, max_hits, dev)
    if dev.type == "cpu":
        raise ValueError("KL runs on CUDA tensors; trace_layer_emit_plain is the CPU's")
    H, rows = int(max_hits), int(spec.cap)
    ren = projection.render_consts(spec.renders)
    n_rp = sum(ren.passes[r] for r in range(ren.n))
    # One tensor a (render, pass), as the plain twin's: the fold and the
    # landed weight's torch.sum read each column from its own allocation.
    pix = [torch.empty((rows, B), dtype=I32, device=dev) for _ in range(n_rp)]
    wts = [torch.empty((rows, B), dtype=F32, device=dev) for _ in range(n_rp)]
    seg = torch.empty(B, dtype=I32, device=dev)
    dropped = torch.empty(B, dtype=F32, device=dev)
    out = None
    if not spec.last:
        # The continuing weight in its own allocation, as the plain twin's:
        # the engine sums it.
        out = (*torch.empty((3, H, B), dtype=F32, device=dev).unbind(0),
               torch.empty((H, B), dtype=F32, device=dev))
    a, _keep = _layer_args(seed, ray_idx, d_world, w0, rot, pool, n_ior, H, setting_blocks,
                           out, None, None)
    e = _EmitArgs()
    e.w_scale = build.ptr(w_scale if spec.emit_frac > 0.0 else None)
    for k in range(n_rp):
        e.out_pix[k], e.out_w[k] = build.ptr(pix[k]), build.ptr(wts[k])
    e.out_seg, e.out_drop = build.ptr(seg), build.ptr(dropped)
    e.prob, e.emit_frac = float(spec.prob), float(np.float32(spec.emit_frac))
    e.emit_mode = 0 if spec.emit_frac <= 0.0 else (1 if spec.rr else 2)
    e.last, e.cap, e.ren = int(spec.last), rows, ren
    lib = build.lib()
    with torch.cuda.device(dev):
        code = lib.iht_trace_layer_emit(ctypes.addressof(a), ctypes.addressof(e),
                                        build.stream_ptr(dev))
    build.check(code, "trace_layer_emit")
    build.LAUNCHES["trace_layer_emit"] += 1
    cont = None if out is None else (out[3], out[0], out[1], out[2])
    return LayerRows(tuple(pix), tuple(wts), None, seg, dropped, cont, None, None)
