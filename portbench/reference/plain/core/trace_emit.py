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

In this frozen copy only the plain statement of the rows is kept
(``trace_rows_plain``: per render the uncompacted rows of every 2048-ray
block, slot-major, main then overlap pass, ray within that), and its
landed weight per render and dropped weight are float64 sums of their
float32 terms, where the port sums them in float32.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from portbench.reference.plain.core.latlut import N_NODES
from portbench.reference.plain.core import (
    geometry,
    optics,
    projection,
    rng,
    sampling,
    trace_soa,
)
from portbench.reference.plain.core.accum import key_shift
from portbench.reference.plain.core.bits import F32, I32, I64, MASK32, from_bits, to_bits

F64 = torch.float64

LAYER_NONCE = 0xA5A5
MAX_RENDERS = 4
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
    order, plus (landed [R], dropped: float64 sums of the float32 terms;
    segs). `base`: the 64-bit ray base
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
    landed = [torch.zeros((), dtype=F64, device=device) for _ in range(n_r)]
    dropped = torch.zeros((), dtype=F64, device=device)
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
            dropped = dropped + torch.sum(acc_w.to(F64) - new_w.to(F64))
            acc_w = new_w
        for r, pp in enumerate(plan.renders):
            P = pp.height * pp.width
            hits = projection.project_components(pp, ex, ey, ez)
            main_ok = (hits.main >= 0) & (acc_w > 0.0)
            key, wz_row = _pack_spectral(
                torch.where(main_ok, hits.main, -1), torch.where(main_ok, acc_w, 0.0),
                wl_idx, P, K, shift,
            )
            landed[r] = landed[r] + torch.sum(wz_row.to(F64))
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

