"""Trace-and-emit: sample -> trace -> project -> key-pack -> block pack
(port of K2 and K2b, ``ice_halo_sim_tpu.core.pallas_trace.make_trace_emit``
in its static-geometry and blocked-pool modes, with K1
``pallas_ops._pack_one_block``).

``build_plan`` resolves the scene into a host-side TracePlan, refusing
exactly the scenes the JAX ``pallas_trace.build_plan`` refuses (same reason
text, ``refusal_reason``); the engine sends a refused scene down its general
trace path.
A deterministic crystal shape gives the static mode (one geometry, baked
into the plan's tables); a stochastic one gives the blocked-pool mode: the
engine samples a K-shape pool per batch and hands it over as ``ptbl``
[K, NF*5] and ``ttbl`` [K, T*13], and rays 128 s .. 128 s + 127 trace
shape s.

``trace_emit_plain`` is the plain PyTorch twin (the uncompacted rows, then
the K1 pack); ``trace_emit`` runs it on the CPU and, on a CUDA device, the
CUDA kernel csrc/trace_emit.cu, which packs each block inside itself. Both
return, per render, the rows of every 2048-ray block (slot-major; main then
overlap pass; ray within that), stably compacted with tail (0xFFFFFFFF, 0)
-- the JAX kernel's counts and order -- plus landed weight per render,
dropped weight and traced segments.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field

import numpy as np
import torch

from ice_halo_sim_tpu_torch.core.latlut import N_NODES
from ice_halo_sim_tpu_torch.core import (
    block_ops,
    geometry,
    optics,
    projection,
    rng,
    sampling,
    trace_soa,
)
from ice_halo_sim_tpu_torch.core.accum import key_shift
from ice_halo_sim_tpu_torch.core.bits import F32, I32, I64, MASK32, from_bits, to_bits
from ice_halo_sim_tpu_torch.kernels import build
from ice_halo_sim_tpu_torch.utils import profiling

LAYER_NONCE = 0xA5A5
MAX_RENDERS = projection.MAX_RENDERS
_THREADS = 128  # trace kernel block size (csrc/trace_emit.cu kThreads)
_MAX_ENTRIES = 32  # (slot, render, pass) entries the kernel stages at once (kMaxEntries)
# Blocked-pool mode: one shape per thread block, so the engine's geom_clock
# must equal the block size.
POOL_GEOM_CLOCK = _THREADS


@dataclass
class TracePlan:
    """Host-side plan of one scene; tables are float32 numpy."""

    batch: int
    nr: int
    h: int
    k_pool: int
    seed: int
    prob: float
    wl_mode: str
    spd: np.ndarray           # [K] SPD weight per pool stratum (illuminant)
    wl_values: np.ndarray     # [n_wl] (discrete)
    wl_weights: np.ndarray    # [n_wl] (discrete)
    sun_az: float
    sun_alt: float
    sun_diam: float
    axis_params: sampling.AxisParams
    planes: np.ndarray        # static: [n_planes, 5] slot, nx, ny, nz, d per present face
    tris: np.ndarray          # static: [T, 13] cross_half, v0, e1, e2, face slot (live)
    emit_frac: float
    emit_mode: str
    w_scale: float
    renders: tuple
    rows_block: tuple
    nf: int = geometry.PRISM_FACES  # face slots per shape (8, or 20 with a pyramid)
    pool_k: int = 0           # 0 = static geometry; else pool rows per batch
    n_tris: int = 0           # blocked-pool mode: triangle rows per shape (nf * 4)
    gc: int = 0               # blocked-pool mode: geom clock (128)
    _cache: dict = field(default_factory=dict, repr=False)

    @property
    def n_blocks(self) -> int:
        return self.batch // self.nr

    @property
    def emit_cut(self) -> float:
        return float(np.float32(self.emit_frac * self.w_scale))

    def face_table(self) -> np.ndarray:
        """The kernel's face table [nf, 5]: nx, ny, nz, d, present, indexed
        by face slot (the layout of a ptbl row). Static mode: the plan's
        present faces, every other slot zero; blocked-pool mode: zeros that
        each thread block overwrites with its shape's row."""
        tbl = np.zeros((self.nf, 5), np.float32)
        if not self.pool_k:
            for slot, nx, ny, nz, d in self.planes:
                tbl[int(slot)] = (nx, ny, nz, d, 1.0)
        return tbl

    def ftab(self):
        """The kernel's float table and section offsets."""
        parts, offs, pos = [], {}, 0
        lut_cdf = np.asarray(self.axis_params.lut_cdf[0], np.float32)
        lut_flip = np.asarray(self.axis_params.lut_flip[0], np.float32)[: N_NODES - 1]
        tris = np.zeros((self.n_tris, 13), np.float32) if self.pool_k else self.tris
        for name, arr in (
            ("planes", self.face_table()), ("tris", tris), ("spd", self.spd),
            ("wl", self.wl_values), ("wlw", self.wl_weights),
            ("cdf", lut_cdf), ("flip", lut_flip),
        ):
            a = np.asarray(arr, np.float32).reshape(-1)
            offs[name] = pos
            parts.append(a)
            pos += a.size
        return np.concatenate(parts), offs

    def device_table(self, device) -> torch.Tensor:
        key = str(device)
        if key not in self._cache:
            self._cache[key] = torch.as_tensor(self.ftab()[0]).to(device)
        return self._cache[key]


def refusal_reason(engine):
    """Why the trace kernel cannot render this scene, or None: the JAX
    ``pallas_trace.build_plan`` refusals, same text."""
    cfg = engine.cfg
    layers = cfg.scene.layers
    if not engine.spectral_ok:
        return "needs the sort fold with packable spectral keys"
    if len(layers) != 1:
        return "multi-layer scattering (continuation emit not in kernel v1)"
    if len(layers[0].entries) != 1:
        return "multiple crystal settings per layer"
    if (not engine.layer0.deterministic_shape[0]
            and engine.geom_clock != POOL_GEOM_CLOCK):
        return ("stochastic crystal shape needs geom_clock == 128 "
                "(one shape per 128-lane row; engine auto-bumps the "
                "default, a pinned IHT_GEOM_CLOCK is respected)")
    if layers[0].entries[0].filter_id != 0:
        return "ray-path filter attached"
    if cfg.raypath_color is not None and cfg.raypath_color.classes:
        return "raypath-color classes need the mask column"
    if any(int(r.lens.type) not in projection.SUPPORTED_LENSES for r in cfg.renders):
        return "lens type needs inverse trig (no Mosaic lowering)"
    if engine.wl_mode == "discrete":
        n_wl = len(engine.wl_values)
        if n_wl & (n_wl - 1):
            return "discrete spectrum size not a power of two (lane % n_wl)"
    if len(cfg.renders) > MAX_RENDERS:
        return "more than 4 renderers (kernel VMEM slab budget)"
    nr = min(2048, engine.batch_size)
    if engine.batch_size % nr:
        return f"batch size {engine.batch_size} not a multiple of {nr}"
    return None


def build_plan(engine) -> TracePlan:
    """TracePlan of a port Engine; raises NotImplementedError for scenes
    outside the kernel path."""
    reason = refusal_reason(engine)
    if reason is not None:
        raise NotImplementedError(f"scene outside the trace kernel path: {reason}")
    cfg = engine.cfg
    plan0 = engine.layer0
    nf = geometry.PYRAMID_FACES if engine.any_pyramid else geometry.PRISM_FACES
    planes = np.zeros((0, 5), np.float32)
    tt = np.zeros((0, 13), np.float32)
    pool_k = n_tris = gc = 0
    if plan0.deterministic_shape[0]:
        # One geometry for every batch (NO_RANDOM draws ignore the seed and
        # the counter): sample the K = 1 pool once on the host and keep its
        # present faces and live triangles.
        pool = engine._sample_layer_pool(0, device="cpu")
        present = pool.face_present[0].numpy()
        pn, pd = pool.plane_n[0].numpy(), pool.plane_d[0].numpy()
        planes = np.array(
            [(f, *pn[f], pd[f]) for f in range(pn.shape[0]) if present[f]], np.float32
        ).reshape(-1, 5)
        ch = pool.tri_cross_half[0].numpy()
        live = np.abs(ch).sum(axis=1) > 0
        tt = np.concatenate(
            [ch, pool.tri_v0[0].numpy(), pool.tri_e1[0].numpy(), pool.tri_e2[0].numpy(),
             pool.tri_face[0].numpy().astype(np.float32)[:, None]], axis=1
        )[live].astype(np.float32)
        if not len(tt) or not len(planes):
            raise NotImplementedError(
                "scene outside the trace kernel path: degenerate geometry (no live "
                "entry faces)"
            )
    else:
        pool_k = plan0.k_per_setting[0]
        gc = engine.geom_clock
        n_tris = nf * 4   # build_entry_tris: T = NF * (6 - 2)

    if engine.wl_mode == "illuminant":
        spd = engine.spd_table.cpu().numpy().astype(np.float32)
        wl_values = wl_weights = np.zeros(0, np.float32)
        w_scale = float(np.mean(spd.astype(np.float64)))
    else:
        spd = np.zeros(0, np.float32)
        wl_values = np.asarray(engine.wl_values, np.float32)
        wl_weights = np.asarray(engine.wl_weights, np.float32)
        w_scale = float(np.mean(wl_weights.astype(np.float64)))

    nr = min(2048, engine.batch_size)
    H = engine.max_hits
    rows_block = []
    for pp in engine.proj_plans:
        passes = 2 if pp.max_abs_dz > 0.0 else 1
        r0 = H * passes * nr
        rows_block.append(max(1024, 1 << (r0 - 1).bit_length()))
    sun = cfg.light.sun
    return TracePlan(
        batch=engine.batch_size, nr=nr, h=H, k_pool=engine.k_pool,
        seed=engine.seed, prob=float(plan0.prob), wl_mode=engine.wl_mode,
        spd=spd, wl_values=wl_values, wl_weights=wl_weights,
        sun_az=float(sun.azimuth), sun_alt=float(sun.altitude),
        sun_diam=float(sun.diameter), axis_params=engine.axis_params,
        planes=planes, tris=tt, emit_frac=float(engine.min_emit_frac),
        emit_mode=str(engine.emit_floor_mode), w_scale=w_scale,
        renders=tuple(engine.proj_plans), rows_block=tuple(rows_block),
        nf=nf, pool_k=pool_k, n_tris=n_tris, gc=gc,
    )


# --------------------------------------------------------------------------
# Plain PyTorch twin
# --------------------------------------------------------------------------

def _pack_spectral(pix, w, wl_idx, P: int, K: int, shift: int):
    valid = (pix >= 0) & (pix < P) & (w > 0.0)
    key = torch.where(valid, (pix.to(I64) << shift) | ((wl_idx & (K - 1)) << 1), MASK32)
    return to_bits(key), torch.where(valid, w, 0.0)


def _check_pool_tables(plan: TracePlan, ptbl, ttbl, device) -> None:
    """Raise unless the tables are what the plan's mode takes."""
    if not plan.pool_k:
        if ptbl is not None or ttbl is not None:
            raise ValueError("pool tables given to a static-geometry plan")
        return
    if plan.gc != POOL_GEOM_CLOCK or plan.pool_k * plan.gc != plan.batch:
        raise ValueError(
            f"blocked-pool plan needs batch == pool_k * {POOL_GEOM_CLOCK}, got "
            f"batch {plan.batch}, pool_k {plan.pool_k}, geom clock {plan.gc}")
    for name, t, cols in (("ptbl", ptbl, plan.nf * 5), ("ttbl", ttbl, plan.n_tris * 13)):
        on_device = t is not None and t.device.type == device.type and (
            device.index is None or t.device.index == device.index)
        if (not on_device or t.dtype != F32 or tuple(t.shape) != (plan.pool_k, cols)
                or not t.is_contiguous()):
            raise ValueError(
                f"{name} must be a contiguous float32 [{plan.pool_k}, {cols}] tensor "
                f"on {device}")


def base_words(base, device) -> torch.Tensor:
    """A batch's 64-bit ray base as the trace kernel reads it: int32 [2],
    the u32 bit patterns of its low and high words, on `device`. `base` is
    a python int, or such a tensor already (returned as it is: the engine
    derives it on the device from its batch counter)."""
    if isinstance(base, torch.Tensor):
        if base.dtype != I32 or tuple(base.shape) != (2,):
            raise ValueError(f"a base tensor must be int32 [2], got {base.dtype} "
                             f"{tuple(base.shape)}")
        return base
    b = int(base)
    return to_bits(torch.tensor([b & MASK32, (b >> 32) & MASK32], dtype=I64)).to(device)


def trace_rows_plain(plan: TracePlan, base, n_active: int, device, ptbl=None, ttbl=None):
    """The uncompacted slabs: per render keys/w [G, rows_block] in slab
    order, plus (landed [R], dropped, segs). `base`: the 64-bit ray base
    (``base_words``). Blocked-pool plans take the batch's ptbl/ttbl; ray
    `lane` reads row lane // 128 of both."""
    device = torch.device(device)
    _check_pool_tables(plan, ptbl, ttbl, device)
    B, NR, H, K = plan.batch, plan.nr, plan.h, plan.k_pool
    G = B // NR
    shift = key_shift(K)
    lane = torch.arange(B, dtype=I64, device=device)
    words = from_bits(base_words(base, device))
    base_lo, base_hi = words[0], words[1]
    ray_idx = (lane + base_lo) & MASK32
    hi = (base_hi + (ray_idx < base_lo).to(I64)) & MASK32
    seed0 = plan.seed
    seed_vec = torch.where(hi == 0, seed0, seed0 ^ rng.pcg_hash(hi))

    if plan.wl_mode == "illuminant":
        wseed = seed_vec ^ rng.NONCE_WL ^ 0x6A09E667
        uwl = rng.uniform(wseed, ray_idx, 0)
        wl = 380.0 + uwl * 400.0
        wl_idx = torch.clamp_max((uwl * K).to(I32), K - 1).to(I64)
        w0 = torch.as_tensor(plan.spd, device=device)[wl_idx]
    else:
        wl_idx = ray_idx & (len(plan.wl_values) - 1)
        wl = torch.as_tensor(plan.wl_values, device=device)[wl_idx]
        w0 = torch.as_tensor(plan.wl_weights, device=device)[wl_idx]
    n_ior = optics.ice_refractive_index(wl)
    w0 = torch.where(lane < int(n_active), w0, 0.0)

    wx, wy, wz = sampling.sample_sun_dirs_soa(
        seed_vec ^ rng.NONCE_SUN, ray_idx, plan.sun_az, plan.sun_alt, plan.sun_diam
    )
    layer_seed = seed_vec ^ LAYER_NONCE
    rot = sampling.sample_rot_row(layer_seed ^ rng.NONCE_ORIENT, ray_idx,
                                  plan.axis_params, 0, lut_loop=True)
    dx, dy, dz = trace_soa.rot_apply_inv(rot, wx, wy, wz)

    # Geometry accessors: the plan's static tables (python floats), or the
    # ray's row of the pool tables (every face slot and triangle row stays,
    # absent faces masked by their `present` column, dead triangles adding
    # a zero cross_half to the CDF).
    if plan.pool_k:
        sidx = lane // plan.gc
        face_ids = list(range(plan.nf))
        fgeo = {f: (ptbl[sidx, 5 * f], ptbl[sidx, 5 * f + 1], ptbl[sidx, 5 * f + 2],
                    ptbl[sidx, 5 * f + 3], ptbl[sidx, 5 * f + 4] > 0.5)
                for f in face_ids}
        T = plan.n_tris

        def tri_val(t, c):
            return ttbl[sidx, 13 * t + c]

        def tri_pick(sel, c):
            return ttbl[sidx, 13 * sel + c]

        def normal_of(fidx):
            col = 5 * torch.clamp(fidx.to(I64), 0, plan.nf - 1)
            return ptbl[sidx, col], ptbl[sidx, col + 1], ptbl[sidx, col + 2]
    else:
        face_ids = [int(r[0]) for r in plan.planes]
        fgeo = {int(r[0]): (float(r[1]), float(r[2]), float(r[3]), float(r[4]), None)
                for r in plan.planes}
        tri_rows = [tuple(float(x) for x in row) for row in plan.tris]
        T = len(tri_rows)
        tris_dev = torch.as_tensor(plan.tris, device=device)
        normals = torch.as_tensor(plan.face_table()[:, :3].copy(), device=device)

        def tri_val(t, c):
            return tri_rows[t][c]

        def tri_pick(sel, c):
            return tris_dev[sel, c]

        def normal_of(fidx):
            n = normals[torch.clamp(fidx.to(I64), 0, plan.nf - 1)]
            return n[:, 0], n[:, 1], n[:, 2]

    # Entry-face sampling over the fan-triangle table (slots 10-12).
    entry_seed = layer_seed ^ rng.NONCE_ENTRY
    ws = []
    total = torch.zeros(B, dtype=F32, device=device)
    for t in range(T):
        wt = torch.clamp_min(
            -(tri_val(t, 0) * dx + tri_val(t, 1) * dy + tri_val(t, 2) * dz), 0.0)
        ws.append(wt)
        total = total + wt
    entry_ok = total > 0.0
    target = rng.uniform(entry_seed, ray_idx, 10) * total
    cdf = torch.zeros(B, dtype=F32, device=device)
    sel = torch.zeros(B, dtype=I64, device=device)
    for wt in ws:
        cdf = cdf + wt
        sel = sel + (cdf <= target).to(I64)
    sel = torch.clamp(sel, 0, T - 1)
    u = rng.uniform(entry_seed, ray_idx, 11)
    v = rng.uniform(entry_seed, ray_idx, 12)
    over = u + v > 1.0
    u = torch.where(over, 1.0 - u, u)
    v = torch.where(over, 1.0 - v, v)
    px = tri_pick(sel, 3) + u * tri_pick(sel, 6) + v * tri_pick(sel, 9)
    py = tri_pick(sel, 4) + u * tri_pick(sel, 7) + v * tri_pick(sel, 10)
    pz = tri_pick(sel, 5) + u * tri_pick(sel, 8) + v * tri_pick(sel, 11)
    f0 = (tri_pick(sel, 12) + 0.5).to(I32)
    w = torch.where(entry_ok, w0, 0.0)

    n0x, n0y, n0z = normal_of(f0)
    (rx, ry, rz), (tx, ty, tz), w_r, w_t, _ = trace_soa._fresnel_split_soa(
        dx, dy, dz, n0x, n0y, n0z, w, n_ior
    )
    e0x, e0y, e0z = trace_soa.rot_apply(rot, rx, ry, rz)
    exit0_w = torch.where(entry_ok, w_r, 0.0)
    dists = {f: px * fgeo[f][0] + py * fgeo[f][1] + pz * fgeo[f][2] + fgeo[f][3]
             for f in face_ids}

    n_r = len(plan.renders)
    slabs = [[] for _ in range(n_r)]
    landed = [torch.zeros((), dtype=F32, device=device) for _ in range(n_r)]
    dropped = torch.zeros((), dtype=F32, device=device)
    segs = torch.zeros(B, dtype=I32, device=device)
    gate_seed = layer_seed ^ rng.NONCE_GATE
    rr_seed = layer_seed ^ rng.NONCE_EMIT
    cut = plan.emit_cut

    def emit_slot(h_slot, ex, ey, ez, w_raw):
        nonlocal dropped, segs
        segs = torch.where(w_raw > 0.0, h_slot + 1, segs).to(I32)
        acc_w = w_raw
        if plan.prob > 0.0:
            ug = rng.uniform(gate_seed, ray_idx, 100 + h_slot)
            acc_w = torch.where(ug >= plan.prob, w_raw, 0.0)
        if plan.emit_frac > 0.0:
            tiny = (acc_w > 0.0) & (acc_w < cut)
            if plan.emit_mode == "rr":
                urr = rng.uniform(rr_seed, ray_idx, h_slot)
                new_w = torch.where(tiny, torch.where(urr * cut < acc_w, cut, 0.0), acc_w)
            else:
                new_w = torch.where(tiny, 0.0, acc_w)
            dropped = dropped + torch.sum(acc_w) - torch.sum(new_w)
            acc_w = new_w
        for r, pp in enumerate(plan.renders):
            P = pp.height * pp.width
            hits = projection.project_components(pp, ex, ey, ez)
            main_ok = (hits.main >= 0) & (acc_w > 0.0)
            key, wz_row = _pack_spectral(
                torch.where(main_ok, hits.main, -1), torch.where(main_ok, acc_w, 0.0),
                wl_idx, P, K, shift,
            )
            landed[r] = landed[r] + torch.sum(wz_row)
            slabs[r].append((key, wz_row))
            if pp.max_abs_dz > 0.0:
                ov_ok = (hits.overlap >= 0) & (acc_w > 0.0)
                slabs[r].append(_pack_spectral(
                    torch.where(ov_ok, hits.overlap, -1),
                    torch.where(ov_ok, acc_w, 0.0), wl_idx, P, K, shift,
                ))

    emit_slot(0, e0x, e0y, e0z, exit0_w)
    cx, cy, cz, cw = tx, ty, tz, w_t
    prev_f = f0
    for h_slot in range(1, H):
        t_best = torch.full((B,), 1e30, dtype=F32, device=device)
        fi = torch.zeros(B, dtype=I32, device=device)
        denoms = {}
        for f in face_ids:
            nx, ny, nz, _d, pres = fgeo[f]
            denom = cx * nx + cy * ny + cz * nz
            denoms[f] = denom
            t_f = -dists[f] / torch.where(torch.abs(denom) > 1e-30, denom, 1e-30)
            cand = (denom > optics.SLAB_EPS) & (prev_f != f)
            if pres is not None:
                cand = cand & pres
            t_m = torch.where(cand, t_f, 1e30)
            upd = t_m < t_best
            fi = torch.where(upd, f, fi).to(I32)
            t_best = torch.where(upd, t_m, t_best)
        found = (t_best < 5e29) & (t_best > -optics.SLAB_EPS)
        alive = found & (cw > 0.0)
        nfx, nfy, nfz = normal_of(fi)
        for f in face_ids:
            dists[f] = torch.where(alive, dists[f] + t_best * denoms[f], dists[f])
        (rx, ry, rz), (tx2, ty2, tz2), w_r, w_t2, is_tir = trace_soa._fresnel_split_soa(
            cx, cy, cz, nfx, nfy, nfz, cw, n_ior
        )
        cos_exit = tx2 * nfx + ty2 * nfy + tz2 * nfz
        emit_ok = alive & (~is_tir) & (cos_exit > 0.0)
        emit_w = torch.where(emit_ok, w_t2, 0.0)
        ex, ey, ez = trace_soa.rot_apply(rot, tx2, ty2, tz2)
        emit_slot(h_slot, ex, ey, ez, emit_w)
        cx = torch.where(alive, rx, cx)
        cy = torch.where(alive, ry, cy)
        cz = torch.where(alive, rz, cz)
        cw = torch.where(alive, w_r, 0.0)
        prev_f = torch.where(alive, fi, prev_f)

    out = []
    for r in range(n_r):
        keys = torch.stack([k for k, _ in slabs[r]]).view(-1, G, NR)
        wts = torch.stack([x for _, x in slabs[r]]).view(-1, G, NR)
        keys = keys.permute(1, 0, 2).reshape(G, -1)
        wts = wts.permute(1, 0, 2).reshape(G, -1)
        pad = plan.rows_block[r] - keys.shape[1]
        if pad:
            keys = torch.cat([keys, torch.full((G, pad), -1, dtype=I32, device=device)], 1)
            wts = torch.cat([wts, torch.zeros((G, pad), dtype=F32, device=device)], 1)
        out.append((keys, wts))
    return out, torch.stack(landed), dropped, segs.to(I64).sum()


def trace_emit_plain(plan: TracePlan, base, n_active: int, device, ptbl=None, ttbl=None):
    """Plain twin: per_render [(keys [G, rb] int32, w [G, rb], counts [G])],
    landed [R], dropped, segs."""
    slabs, landed, dropped, segs = trace_rows_plain(plan, base, n_active, device, ptbl,
                                                    ttbl)
    per_render = []
    for (keys, wts), rb in zip(slabs, plan.rows_block):
        G = keys.shape[0]
        pk, pw, counts = block_ops.pack_rows_plain(keys.reshape(-1), wts.reshape(-1), rb)
        per_render.append((pk.view(G, rb), pw.view(G, rb), counts))
    return per_render, landed, dropped, segs


# --------------------------------------------------------------------------
# CUDA wrapper
# --------------------------------------------------------------------------

class TraceParams(ctypes.Structure):
    """Mirror of struct TraceParams in csrc/trace_emit.cu."""

    _fields_ = [
        ("slab_off", ctypes.c_longlong * MAX_RENDERS),
        ("seed", ctypes.c_uint32),
    ] + [(n, ctypes.c_int32) for n in (
        "n_active", "batch", "nr", "h", "k_pool", "wl_discrete", "n_wl")] + [
        ("prob", ctypes.c_float), ("emit_cut", ctypes.c_float),
        ("emit_mode", ctypes.c_int32),
    ] + [(n, ctypes.c_float) for n in (
        "c_cap", "a0", "a1", "a2", "b0", "b1", "b2", "c0", "c1")] + [
        ("lat_path", ctypes.c_int32), ("lat_mean", ctypes.c_float),
        ("lat_std", ctypes.c_float), ("az_type", ctypes.c_int32),
        ("az_mean", ctypes.c_float), ("az_std", ctypes.c_float),
        ("roll_type", ctypes.c_int32), ("roll_mean", ctypes.c_float),
        ("roll_std", ctypes.c_float),
    ] + [(n, ctypes.c_float) for n in (
        "lut_t0", "lut_dt", "lut_tspan0", "lut_span", "lut_c_first", "lut_c_last")] + [
        ("lut_n", ctypes.c_int32), ("lut_has_span", ctypes.c_int32),
        ("nf", ctypes.c_int32), ("n_tris", ctypes.c_int32),
        ("pool", ctypes.c_int32), ("ren", projection.RenderConsts),
        ("rows_block", ctypes.c_int32 * MAX_RENDERS),
    ] + [(n, ctypes.c_int32) for n in (
        "off_planes", "off_tris", "off_spd", "off_wl", "off_wlw", "off_cdf",
        "off_flip", "n_ftab")] + [
        ("rp_off", ctypes.c_int32 * MAX_RENDERS),
    ] + [(n, ctypes.c_int32) for n in ("rp", "hg", "ncta", "key_shift", "grid_blocks")]


def make_params(plan: TracePlan, n_active: int):
    """The kernel's parameter block: the plan's part is filled once and
    kept, the batch's active lanes are set per call (a launch copies the
    block, so the next call may overwrite it). The ray base is not in it:
    the kernel reads it from device memory."""
    p = plan._cache.get("params")
    if p is None:
        p = plan._cache["params"] = _plan_params(plan)
    p.n_active = int(n_active)
    return p


def _plan_params(plan: TracePlan):
    p = TraceParams()
    ftab, offs = plan.ftab()
    G = plan.n_blocks
    off = 0
    for r, rb in enumerate(plan.rows_block):
        p.slab_off[r] = off
        off += G * rb
    p.seed = plan.seed
    p.batch, p.nr, p.h = plan.batch, plan.nr, plan.h
    p.k_pool = plan.k_pool
    p.wl_discrete = int(plan.wl_mode != "illuminant")
    p.n_wl = len(plan.wl_values)
    p.prob = plan.prob
    p.emit_cut = plan.emit_cut
    p.emit_mode = 0 if plan.emit_frac <= 0.0 else (1 if plan.emit_mode == "rr" else 2)
    for k, val in sampling.sun_constants(plan.sun_az, plan.sun_alt, plan.sun_diam).items():
        setattr(p, k, val)
    ap = plan.axis_params
    p.lat_path = int(ap.lat_path[0])
    p.lat_mean, p.lat_std = float(ap.lat_mean[0]), float(ap.lat_std[0])
    p.az_type, p.az_mean, p.az_std = int(ap.az_type[0]), float(ap.az_mean[0]), float(ap.az_std[0])
    p.roll_type = int(ap.roll_type[0])
    p.roll_mean, p.roll_std = float(ap.roll_mean[0]), float(ap.roll_std[0])
    theta, cdf = ap.lut_theta[0], ap.lut_cdf[0]
    t0 = float(theta[0])
    span = float(theta[-1]) - t0
    p.lut_t0 = p.lut_tspan0 = t0
    p.lut_dt = (float(theta[-1]) - t0) / float(len(cdf) - 1)
    p.lut_span = span
    p.lut_has_span = int(span > 0)
    p.lut_c_first, p.lut_c_last = float(cdf[0]), float(cdf[-1])
    p.lut_n = N_NODES
    p.nf = plan.nf
    p.n_tris = plan.n_tris if plan.pool_k else len(plan.tris)
    p.pool = int(plan.pool_k > 0)
    p.ren = projection.render_consts(plan.renders)
    for r, rb in enumerate(plan.rows_block):
        p.rows_block[r] = rb
    p.off_planes, p.off_tris, p.off_spd = offs["planes"], offs["tris"], offs["spd"]
    p.off_wl, p.off_wlw = offs["wl"], offs["wlw"]
    p.off_cdf, p.off_flip = offs["cdf"], offs["flip"]
    p.n_ftab = int(ftab.size)
    rp = 0
    for r in range(len(plan.renders)):
        p.rp_off[r] = rp
        rp += p.ren.passes[r]
    p.rp = rp
    p.hg = max(1, min(plan.h, _MAX_ENTRIES // rp))
    p.ncta = -(-plan.nr // _THREADS)
    p.key_shift = key_shift(plan.k_pool)
    p.grid_blocks = plan.n_blocks * p.ncta
    return p


def trace_emit(plan: TracePlan, base, n_active: int, device, ptbl=None, ttbl=None):
    """K2/K2b wrapper: the plain twin on the CPU; on a CUDA device the trace
    kernel (static mode, or blocked-pool mode when the plan has a pool and
    the batch's ptbl/ttbl are given), which packs each 2048-ray block
    itself. `base`: the 64-bit ray base, a python int or the int32 [2]
    words on the device (``base_words``), which the kernel reads there."""
    device = torch.device(device)
    if device.type == "cpu":
        return trace_emit_plain(plan, base, n_active, device, ptbl, ttbl)
    _check_pool_tables(plan, ptbl, ttbl, device)
    if plan.nf not in (geometry.PRISM_FACES, geometry.PYRAMID_FACES):
        raise ValueError(f"the trace kernel is built for 8 or 20 face slots, not {plan.nf}")
    words = base_words(base, device)
    if words.device.type != device.type or (
            device.index is not None and words.device.index != device.index):
        raise ValueError(f"the ray base words must lie on {device}, not {words.device}")
    params = make_params(plan, n_active)
    ftab = plan.device_table(device)
    G = plan.n_blocks
    R = len(plan.renders)
    keys = torch.empty(G * sum(plan.rows_block), dtype=I32, device=device)
    wts = torch.empty(G * sum(plan.rows_block), dtype=F32, device=device)
    counts = torch.empty((R, G), dtype=I32, device=device)
    n_tb = params.grid_blocks
    fpart = torch.empty(n_tb * (R + 1), dtype=F32, device=device)
    spart = torch.empty(n_tb, dtype=I32, device=device)
    lib = build.lib()
    if plan.pool_k:
        with torch.cuda.device(device):
            code = lib.iht_trace_emit_pool(
                ctypes.addressof(params), words.data_ptr(), ftab.data_ptr(), ptbl.data_ptr(),
                ttbl.data_ptr(), keys.data_ptr(), wts.data_ptr(), counts.data_ptr(),
                fpart.data_ptr(), spart.data_ptr(), build.stream_ptr(device),
            )
        build.check(code, "trace_emit_pool")
        build.LAUNCHES["trace_emit_pool"] += 1
    else:
        with torch.cuda.device(device):
            code = lib.iht_trace_emit(
                ctypes.addressof(params), words.data_ptr(), ftab.data_ptr(), keys.data_ptr(),
                wts.data_ptr(), counts.data_ptr(), fpart.data_ptr(), spart.data_ptr(),
                build.stream_ptr(device),
            )
        build.check(code, "trace_emit")
        build.LAUNCHES["trace_emit"] += 1
    profiling.stage("rest")   # the trace stage ends with the kernel (utils/profiling.py)
    per_render = []
    off = 0
    for r, rb in enumerate(plan.rows_block):
        n = G * rb
        per_render.append((keys[off:off + n].view(G, rb), wts[off:off + n].view(G, rb),
                           counts[r]))
        off += n
    fp = fpart.view(n_tb, R + 1)
    return per_render, fp[:, 1:].sum(dim=0), fp[:, 0].sum(), spart.to(I64).sum()


def _np(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def trace_output_diff(a, b) -> dict:
    """Compare two trace_emit per-render outputs (numpy or torch).

    rows_diff: size of the multiset difference of (block, key) over live
    rows -- rays whose float-fed decision (entry triangle, TIR, pixel
    floor) flipped move rows between keys or blocks; blocks_diff: blocks
    whose live counts differ; w_rel: largest relative difference of the
    weights, key by key, where rows_diff == 0 (else of the block sums)."""
    rows_diff = blocks_diff = 0
    w_rel = 0.0
    for (ka, wa, ca), (kb, wb, cb) in zip(a, b):
        ka, wa, ca, kb, wb, cb = (_np(x) for x in
                                  (ka, wa, ca, kb, wb, cb))
        blocks_diff += int((ca != cb).sum())
        G, R = ka.shape
        blk = np.repeat(np.arange(G, dtype=np.int64), R).reshape(G, R)

        def rows(k, c, w):
            live = np.arange(R)[None, :] < c[:, None]
            kk = (blk << 32) | (k.view(np.uint32).astype(np.int64))
            order = np.lexsort((w[live], kk[live]))
            return kk[live][order], w[live][order]

        ra, va = rows(ka, ca, wa)
        rb, vb = rows(kb, cb, wb)
        ua, na = np.unique(ra, return_counts=True)
        ub, nb = np.unique(rb, return_counts=True)
        allk = np.union1d(ua, ub)
        ca_ = np.zeros(allk.size, np.int64)
        cb_ = np.zeros(allk.size, np.int64)
        ca_[np.searchsorted(allk, ua)] = na
        cb_[np.searchsorted(allk, ub)] = nb
        rows_diff += int(np.abs(ca_ - cb_).sum())
        if ra.shape == rb.shape and np.array_equal(ra, rb):
            den = np.maximum(np.abs(vb), 1e-30)
            w_rel = max(w_rel, float((np.abs(va - vb) / den).max(initial=0.0)))
        else:
            sa, sb = wa.astype(np.float64).sum(1), wb.astype(np.float64).sum(1)
            w_rel = max(w_rel, float((np.abs(sa - sb) / np.maximum(sb, 1e-30)).max()))
    return {"rows_diff": rows_diff, "blocks_diff": blocks_diff, "w_rel": w_rel}
