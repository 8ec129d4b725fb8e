"""Trace-and-emit: sample -> trace -> project -> key-pack -> block pack
(port of K2, ``ice_halo_sim_tpu.core.pallas_trace.make_trace_emit``, in its
static-geometry mode, with K1 ``pallas_ops._pack_one_block``).

``build_plan`` resolves the scene into a host-side TracePlan, refusing
exactly the scenes the JAX ``pallas_trace.build_plan`` refuses (same reason
text) plus what the port does not implement yet (stochastic-shape
blocked-pool mode, pyramids, lenses other than the dual fisheyes); a
refusal raises NotImplementedError, there is no other trace path.

``trace_emit_plain`` is the plain PyTorch twin; ``trace_emit`` runs it on
the CPU and, on a CUDA device, the CUDA kernel csrc/trace_emit.cu followed
by the K1 pack kernel. Both return, per render, the rows of every 2048-ray
block (slot-major; main then overlap pass; ray within that), stably
compacted with tail (0xFFFFFFFF, 0) -- the JAX kernel's counts and order --
plus landed weight per render, dropped weight and traced segments.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field

import numpy as np
import torch

from ice_halo_sim_tpu.config.schema import LensType, PrismShape
from ice_halo_sim_tpu.core.latlut import N_NODES
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
from ice_halo_sim_tpu_torch.core.bits import F32, I32, I64, MASK32, to_bits
from ice_halo_sim_tpu_torch.kernels import build

LAYER_NONCE = 0xA5A5
MAX_RENDERS = 4
_THREADS = 128  # trace kernel block size (csrc/trace_emit.cu kThreads)

# Lenses the JAX kernel accepts (no inverse trig in their forward math).
_JAX_KERNEL_LENSES = frozenset(
    int(t) for t in (
        LensType.LINEAR, LensType.FISHEYE_EQUAL_AREA, LensType.FISHEYE_ORTHOGRAPHIC,
        LensType.DUAL_FISHEYE_EQUAL_AREA, LensType.DUAL_FISHEYE_ORTHOGRAPHIC,
        LensType.GLOBE,
    )
)


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
    planes: np.ndarray        # [n_planes, 5]: slot, nx, ny, nz, d per present face
    tris: np.ndarray          # [T, 13]: cross_half, v0, e1, e2, face slot
    emit_frac: float
    emit_mode: str
    w_scale: float
    renders: tuple
    rows_block: tuple
    _dev_tables: dict = field(default_factory=dict, repr=False)

    @property
    def n_blocks(self) -> int:
        return self.batch // self.nr

    @property
    def emit_cut(self) -> float:
        return float(np.float32(self.emit_frac * self.w_scale))

    def ftab(self):
        """The kernel's float table and section offsets."""
        parts, offs, pos = [], {}, 0
        lut_cdf = np.asarray(self.axis_params.lut_cdf[0], np.float32)
        lut_flip = np.asarray(self.axis_params.lut_flip[0], np.float32)[: N_NODES - 1]
        for name, arr in (
            ("planes", self.planes), ("tris", self.tris), ("spd", self.spd),
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
        if key not in self._dev_tables:
            self._dev_tables[key] = torch.as_tensor(self.ftab()[0]).to(device)
        return self._dev_tables[key]


def refusal_reason(engine):
    """Why the trace kernel cannot render this scene, or None. The first
    checks are the JAX ``pallas_trace.build_plan`` refusals, same text."""
    cfg = engine.cfg
    layers = cfg.scene.layers
    if not engine.spectral_ok:
        return "needs the sort fold with packable spectral keys"
    if len(layers) != 1:
        return "multi-layer scattering (continuation emit not in kernel v1)"
    if len(layers[0].entries) != 1:
        return "multiple crystal settings per layer"
    crystal = cfg.crystals[layers[0].entries[0].crystal_id]
    if not crystal.shape.is_deterministic():
        return ("stochastic crystal shape: the blocked-pool trace mode is not "
                "ported yet")
    if layers[0].entries[0].filter_id != 0:
        return "ray-path filter attached"
    if cfg.raypath_color is not None and cfg.raypath_color.classes:
        return "raypath-color classes need the mask column"
    if any(int(r.lens.type) not in _JAX_KERNEL_LENSES for r in cfg.renders):
        return "lens type needs inverse trig (no Mosaic lowering)"
    if any(int(r.lens.type) not in projection.SUPPORTED_LENSES for r in cfg.renders):
        return "lens type not ported yet (dual fisheye equal-area/orthographic only)"
    if engine.wl_mode == "discrete":
        n_wl = len(engine.wl_values)
        if n_wl & (n_wl - 1):
            return "discrete spectrum size not a power of two (lane % n_wl)"
    if len(cfg.renders) > MAX_RENDERS:
        return "more than 4 renderers (kernel VMEM slab budget)"
    if not isinstance(crystal.shape, PrismShape):
        return "pyramid geometry not ported yet"
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
    ms = cfg.scene.layers[0]
    crystal = cfg.crystals[ms.entries[0].crystal_id]
    shape = crystal.shape
    h = abs(float(np.float32(shape.height.center)))
    dists = [float(np.float32(d.center)) for d in shape.face_distance]
    g = geometry.pad_geom_faces(geometry.prism_geom(h, dists), geometry.PRISM_FACES)
    tris = sampling.build_entry_tris(g)
    present = g.face_present.numpy()
    pn, pd = g.plane_n.numpy(), g.plane_d.numpy()
    planes = np.array(
        [(f, *pn[f], pd[f]) for f in range(pn.shape[0]) if present[f]], np.float32
    ).reshape(-1, 5)
    ch = tris.cross_half.numpy()
    live = np.abs(ch).sum(axis=1) > 0
    tt = np.concatenate(
        [ch, tris.v0.numpy(), tris.e1.numpy(), tris.e2.numpy(),
         tris.face_idx.numpy().astype(np.float32)[:, None]], axis=1
    )[live].astype(np.float32)
    if not len(tt) or not len(planes):
        raise NotImplementedError(
            "scene outside the trace kernel path: degenerate geometry (no live "
            "entry faces)"
        )

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
        seed=engine.seed, prob=float(ms.prob), wl_mode=engine.wl_mode,
        spd=spd, wl_values=wl_values, wl_weights=wl_weights,
        sun_az=float(sun.azimuth), sun_alt=float(sun.altitude),
        sun_diam=float(sun.diameter), axis_params=engine.axis_params,
        planes=planes, tris=tt, emit_frac=float(engine.min_emit_frac),
        emit_mode=str(engine.emit_floor_mode), w_scale=w_scale,
        renders=tuple(engine.proj_plans), rows_block=tuple(rows_block),
    )


# --------------------------------------------------------------------------
# Plain PyTorch twin
# --------------------------------------------------------------------------

def _pack_spectral(pix, w, wl_idx, P: int, K: int, shift: int):
    valid = (pix >= 0) & (pix < P) & (w > 0.0)
    key = torch.where(valid, (pix.to(I64) << shift) | ((wl_idx & (K - 1)) << 1), MASK32)
    return to_bits(key), torch.where(valid, w, 0.0)


def trace_rows_plain(plan: TracePlan, base_lo: int, base_hi: int, n_active: int,
                     device):
    """The uncompacted slabs: per render keys/w [G, rows_block] in slab
    order, plus (landed [R], dropped, segs)."""
    B, NR, H, K = plan.batch, plan.nr, plan.h, plan.k_pool
    G = B // NR
    shift = key_shift(K)
    lane = torch.arange(B, dtype=I64, device=device)
    base_lo = int(base_lo) & MASK32
    base_hi = int(base_hi) & MASK32
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

    # Entry-face sampling over the fan-triangle table (slots 10-12).
    tri_rows = [tuple(float(x) for x in row) for row in plan.tris]
    T = len(tri_rows)
    entry_seed = layer_seed ^ rng.NONCE_ENTRY
    ws = []
    total = torch.zeros(B, dtype=F32, device=device)
    for tr in tri_rows:
        wt = torch.clamp_min(-(tr[0] * dx + tr[1] * dy + tr[2] * dz), 0.0)
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
    tt = torch.as_tensor(plan.tris, device=device)[sel]
    px = tt[:, 3] + u * tt[:, 6] + v * tt[:, 9]
    py = tt[:, 4] + u * tt[:, 7] + v * tt[:, 10]
    pz = tt[:, 5] + u * tt[:, 8] + v * tt[:, 11]
    f0 = (tt[:, 12] + 0.5).to(I32)
    w = torch.where(entry_ok, w0, 0.0)

    planes = [(int(r[0]), float(r[1]), float(r[2]), float(r[3]), float(r[4]))
              for r in plan.planes]
    normals = torch.zeros((geometry.PRISM_FACES + 1, 3), dtype=F32, device=device)
    for f, nx, ny, nz, _d in planes:
        normals[f] = torch.tensor([nx, ny, nz], dtype=F32)

    def normal_of(fidx):
        n = normals[torch.clamp(fidx.to(I64), 0, geometry.PRISM_FACES)]
        return n[:, 0], n[:, 1], n[:, 2]

    n0x, n0y, n0z = normal_of(f0)
    (rx, ry, rz), (tx, ty, tz), w_r, w_t, _ = trace_soa._fresnel_split_soa(
        dx, dy, dz, n0x, n0y, n0z, w, n_ior
    )
    e0x, e0y, e0z = trace_soa.rot_apply(rot, rx, ry, rz)
    exit0_w = torch.where(entry_ok, w_r, 0.0)
    dists = {f: px * nx + py * ny + pz * nz + d for f, nx, ny, nz, d in planes}

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
        for f, nx, ny, nz, _d in planes:
            denom = cx * nx + cy * ny + cz * nz
            denoms[f] = denom
            t_f = -dists[f] / torch.where(torch.abs(denom) > 1e-30, denom, 1e-30)
            cand = (denom > optics.SLAB_EPS) & (prev_f != f)
            t_m = torch.where(cand, t_f, 1e30)
            upd = t_m < t_best
            fi = torch.where(upd, f, fi).to(I32)
            t_best = torch.where(upd, t_m, t_best)
        found = (t_best < 5e29) & (t_best > -optics.SLAB_EPS)
        alive = found & (cw > 0.0)
        nfx, nfy, nfz = normal_of(fi)
        for f, *_ in planes:
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


def trace_emit_plain(plan: TracePlan, base_lo: int, base_hi: int, n_active: int,
                     device):
    """Plain twin: per_render [(keys [G, rb] int32, w [G, rb], counts [G])],
    landed [R], dropped, segs."""
    slabs, landed, dropped, segs = trace_rows_plain(plan, base_lo, base_hi,
                                                    n_active, device)
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
        ("seed", ctypes.c_uint32), ("base_lo", ctypes.c_uint32),
        ("base_hi", ctypes.c_uint32),
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
        ("n_planes", ctypes.c_int32), ("n_tris", ctypes.c_int32),
        ("n_renders", ctypes.c_int32),
        ("lens", ctypes.c_int32 * MAX_RENDERS), ("width", ctypes.c_int32 * MAX_RENDERS),
        ("height", ctypes.c_int32 * MAX_RENDERS),
        ("rows_block", ctypes.c_int32 * MAX_RENDERS),
        ("r_scale", ctypes.c_float * MAX_RENDERS),
        ("max_abs_dz", ctypes.c_float * MAX_RENDERS),
    ] + [(n, ctypes.c_int32) for n in (
        "off_planes", "off_tris", "off_spd", "off_wl", "off_wlw", "off_cdf",
        "off_flip", "n_ftab")]


def make_params(plan: TracePlan, base_lo: int, base_hi: int, n_active: int):
    p = TraceParams()
    ftab, offs = plan.ftab()
    G = plan.n_blocks
    off = 0
    for r, rb in enumerate(plan.rows_block):
        p.slab_off[r] = off
        off += G * rb
    p.seed, p.base_lo, p.base_hi = plan.seed, int(base_lo) & MASK32, int(base_hi) & MASK32
    p.n_active, p.batch, p.nr, p.h = int(n_active), plan.batch, plan.nr, plan.h
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
    p.n_planes, p.n_tris = len(plan.planes), len(plan.tris)
    p.n_renders = len(plan.renders)
    for r, (pp, rb) in enumerate(zip(plan.renders, plan.rows_block)):
        p.lens[r], p.width[r], p.height[r] = pp.lens_type, pp.width, pp.height
        p.rows_block[r] = rb
        p.r_scale[r], p.max_abs_dz[r] = pp.r_scale, pp.max_abs_dz
    p.off_planes, p.off_tris, p.off_spd = offs["planes"], offs["tris"], offs["spd"]
    p.off_wl, p.off_wlw = offs["wl"], offs["wlw"]
    p.off_cdf, p.off_flip = offs["cdf"], offs["flip"]
    p.n_ftab = int(ftab.size)
    return p


def trace_emit(plan: TracePlan, base_lo: int, base_hi: int, n_active: int, device):
    """K2 wrapper: the plain twin on the CPU; on a CUDA device the trace
    kernel, then the K1 pack kernel per render."""
    device = torch.device(device)
    if device.type == "cpu":
        return trace_emit_plain(plan, base_lo, base_hi, n_active, device)
    params = make_params(plan, base_lo, base_hi, n_active)
    ftab = plan.device_table(device)
    G = plan.n_blocks
    R = len(plan.renders)
    total = G * sum(plan.rows_block)
    keys = torch.empty(total, dtype=I32, device=device)
    wts = torch.empty(total, dtype=F32, device=device)
    n_tb = -(-plan.batch // _THREADS)
    fpart = torch.empty(n_tb * (R + 1), dtype=F32, device=device)
    spart = torch.empty(n_tb, dtype=I32, device=device)
    code = build.lib().iht_trace_emit(
        ctypes.addressof(params), ftab.data_ptr(), keys.data_ptr(), wts.data_ptr(),
        fpart.data_ptr(), spart.data_ptr(), build.stream_ptr(device),
    )
    build.check(code, "trace_emit")
    build.LAUNCHES["trace_emit"] += 1
    per_render = []
    off = 0
    for rb in plan.rows_block:
        n = G * rb
        pk, pw, counts = block_ops.pack_rows(keys[off:off + n], wts[off:off + n], rb)
        per_render.append((pk.view(G, rb), pw.view(G, rb), counts))
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
