"""The reference's scene on the general trace: the rays of one batch of a
port Engine through several scattering layers, worked out again from the
configuration, the seed and the batch index.

Cover: two or more layers, one crystal setting per layer, no filter, no
raypath-colour class, keys that pack into 32 bits (the sort fold). Every
other scene is refused (NotImplementedError): one layer is the trace
kernel's path (``scene.py``); several settings in a layer, filters and
colour classes are not stated here.

What decides the answer is the configuration's ``guarantees``, stated as
rules of the port's general path at its defaults, and computed here with
none of the port's code: a layer loop of its own over the frozen plain
modules (``plain/``: RNG, sampling, geometry, optics, projection, and
``plain/core/trace_layer.py``, the layer trace), its own gates, slot cap
and continuation, and the float64 fold of ``oracle.py``. Per batch:
  - layer 1: B root rays (the wavelength and sun draws), traced to their
    exits;
  - the probability gate of each exit slot (a draw per slot; a layer with
    prob p continues an exit where the draw is below p and emits it
    elsewhere; the last layer emits where the draw is p or more);
  - the emit floor on the emitted exits: below w_cut = (the float32 mean
    of the batch's initial weights) x 1e-3, an exit is raised to w_cut
    where u x w_cut < w and zeroed elsewhere (Russian roulette), the net
    change dropped;
  - the exit-slot cap: per ray the first `cap` live emitted slots kept,
    the rest dropped. `cap` comes from the first batch (which runs with
    every slot): the smallest c whose mass at live rank c and deeper is
    at most 1e-4 of the emitted mass;
  - the continuation: every continuing exit keyed (255 - weight bucket)
    << 23 | 23 bits of a row hash, the bucket floor(log2 w) + 130 clipped
    to [2, 255], the hash PCG of the row's index (h x B + lane) salted by
    the batch counter and the layer; where the live rows fit the next
    layer's lanes, each block of 4096 rows sorted by (key, row) and the
    blocks packed in order; where they do not, one sort of every live row
    by (key, row) and the first `lanes` kept, the rest dropped. The
    lanes: the expected continuations with slack, rounded up to 256 x 32
    lanes; after the first batch trimmed to 1.25 times its live rows
    where that is under 0.85 of them;
  - layer k + 1: lane j traces the j-th packed row from the ray index
    base + k x B + j, its wavelength the pool wavelength of the row;
  - projection of the kept rows into every render (the overlap band's
    second pixel folds but does not land).
Landed weight: the main pixel's rows. Dropped weight: the emit floor's
net, the slot cap's and the continuation's dropped rows. Segments: per
ray and layer the deepest live exit slot.

IHT_* knobs come from the workload file (``knobs``), never from the
environment: IHT_MIN_EMIT_W, IHT_EMIT_FLOOR, IHT_WL_POOL and IHT_SLOT_CAP
change the rays; every other knob chooses a path to the same image.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from portbench.reference.plain.config.schema import (
    PrismShape,
    ProjectConfig,
    PyramidShape,
    sync_group_leaders,
)
from portbench.reference.plain.core import (
    color,
    geometry,
    latlut,
    optics,
    projection,
    pyramid,
    rng,
    sampling,
    trace,
    trace_layer,
)
from portbench.reference.plain.core.accum import spectral_key_bits
from portbench.reference.plain.core.bits import F32, I32, I64, MASK32, const

GEOM_CLOCK = 32          # rays per sampled crystal shape on the general path
LAYER_NONCE = 0xA5A5
BLOCK = 4096             # rows of a continuation block
SLOT_TAIL = 1e-4         # the slot cap's dropped mass, of the emitted mass
LANES_MARGIN = 1.25      # continuation lanes over the first batch's live rows


class Layer(NamedTuple):
    """One scattering layer: its probability, lanes, crystal shape and
    orientation."""

    prob: float
    lanes: int
    k: int                      # shapes in the layer's pool
    axis_params: sampling.AxisParams
    kind: str                   # "prism" | "pyramid"
    shape: dict                 # distribution params and RNG slots


def _dist(d) -> tuple:
    return (int(d.type), float(d.center), float(d.spread))


def _shape_params(shape) -> tuple:
    """(kind, params) of a crystal shape: its distributions and RNG slots
    (a synced member reads its group leader's slot)."""
    leaders = sync_group_leaders(shape.sync_group)
    if isinstance(shape, PrismShape):
        slot_of = [0] + [2 + 2 * i for i in range(6)]
        return "prism", {"h": _dist(shape.height),
                         "d": [_dist(x) for x in shape.face_distance],
                         "h_slot": slot_of[leaders[0]],
                         "d_slots": [slot_of[leaders[1 + i]] for i in range(6)]}
    if isinstance(shape, PyramidShape):
        slot_of = [0, 2, 4] + [6 + 2 * i for i in range(6)]
        return "pyramid", {"u": _dist(shape.upper_h), "p": _dist(shape.prism_h),
                           "l": _dist(shape.lower_h), "au": float(shape.wedge_angle_u),
                           "al": float(shape.wedge_angle_l),
                           "d": [_dist(x) for x in shape.face_distance],
                           "u_slot": slot_of[leaders[0]], "p_slot": slot_of[leaders[1]],
                           "l_slot": slot_of[leaders[2]],
                           "d_slots": [slot_of[leaders[3 + i]] for i in range(6)]}
    raise NotImplementedError(f"the reference covers prisms and pyramids, not {type(shape)}")


def _slot_draws(seed, ray_idx, first_slot: int, n: int):
    """[n, B] uniform draws of stream (seed, ray) at slots first_slot + h."""
    return torch.stack([rng.uniform(seed, ray_idx, first_slot + h) for h in range(n)])


def weight_bucket(w):
    """floor(log2 w) + 130 clipped to [2, 255] for float32 weights >= 1e-30
    (smaller ones count as 1e-30): frexp's exponent less one is the floor of
    log2 for every positive normal float."""
    _m, e = torch.frexp(torch.clamp_min(w, 1e-30))
    return torch.clamp(e.to(I64) - 1 + 130, 2, 255)


def continuation_order(w, cap: int, layer_seed: int, batch: int):
    """Rows of a layer's continuing exits (`w` [N] float32, 0 where none)
    in the order the next layer's lanes take them, at most `cap`, and the
    number of live rows. The rule of the module docstring: block-major
    when the live rows fit, heaviest first overall when they do not."""
    n = w.shape[0]
    dev = w.device
    row = torch.arange(n, dtype=I64, device=dev)
    live = torch.nonzero(w > 0.0)[:, 0]
    salt = int(rng.pcg_hash(batch & MASK32)) ^ ((layer_seed ^ rng.NONCE_SHUFFLE) & MASK32)
    hashed = rng.pcg_hash(row[live] ^ salt) & 0x7FFFFF
    key = ((255 - weight_bucket(w[live])) << 23) | hashed
    fits = live.shape[0] <= min(cap, n)
    if fits:
        key = (live // BLOCK) * (1 << 32) + key
    # A stable sort over live rows in row order: ties go by row.
    order = torch.sort(key, stable=True)[1]
    return live[order][:min(cap, n)], int(live.shape[0])


class Scene:
    """One configuration at one seed and batch size, on one device."""

    def __init__(self, cfg: ProjectConfig, seed: int, batch_size: int, device,
                 knobs: Optional[dict] = None):
        self.cfg = cfg
        self.knobs = dict(knobs or {})
        self.seed = int(seed) & 0xFFFFFFFF
        self.device = torch.device(device)
        self.max_hits = int(cfg.scene.max_hits)
        self.batch_size = -(-int(batch_size) // GEOM_CLOCK) * GEOM_CLOCK
        self.min_emit_frac = float(self.knobs.get("IHT_MIN_EMIT_W", 1e-3))
        self.emit_floor_rr = str(self.knobs.get("IHT_EMIT_FLOOR", "rr")).lower() == "rr"
        cap = str(self.knobs.get("IHT_SLOT_CAP", "auto")).lower()
        self._auto_cap = cap == "auto"
        self.slot_cap = (None if self._auto_cap else self.max_hits if cap in ("off", "0")
                         else max(1, min(self.max_hits, int(cap))))
        self._build_wavelengths()
        self.proj_plans = [projection.make_proj_plan(r) for r in cfg.renders]
        self._refuse_outside_cover()
        # The first batch's layers, and from the second batch on the layers
        # its calibration gives (None until then).
        self.layers = self._first = self._plan_layers([None] * len(cfg.scene.layers))
        self._steady = None
        # Per batch traced: the live continuation rows at each layer boundary.
        self.cont_live = {}

    def _refuse_outside_cover(self) -> None:
        cfg = self.cfg
        layers = cfg.scene.layers
        why = None
        if len(layers) < 2:
            why = "one layer is the trace kernel's path (reference/scene.py)"
        elif any(len(l.entries) != 1 for l in layers):
            why = "several crystal settings in a layer"
        elif any(e.filter_id != 0 for l in layers for e in l.entries):
            why = "a ray-path filter"
        elif cfg.raypath_color is not None and cfg.raypath_color.classes:
            why = "raypath-colour classes"
        elif not self.spectral_ok:
            why = "keys that do not pack into 32 bits"
        if why is not None:
            raise NotImplementedError(
                f"the reference covers several layers of one setting each: {why}")

    def _plan_layers(self, trimmed) -> list:
        """Every layer's lanes (module docstring) and crystal. `trimmed`: per
        layer the lanes the first batch asks for, or None."""
        H, g = self.max_hits, GEOM_CLOCK
        out = []
        b_prev = self.batch_size
        for li, ms in enumerate(self.cfg.scene.layers):
            if li == 0:
                lanes = self.batch_size
            else:
                p_prev = self.cfg.scene.layers[li - 1].prob
                expect = b_prev * min(1.3 * p_prev * 0.67 * H, float(H))
                lanes = int(min(max(expect, 1024), b_prev * H))
                if trimmed[li] is not None:
                    lanes = min(lanes, max(int(trimmed[li]), 1024))
                lanes = -(-lanes // (256 * g)) * (256 * g)
            crystal = self.cfg.crystals[ms.entries[0].crystal_id]
            kind, shape = _shape_params(crystal.shape)
            axis = crystal.axis
            out.append(Layer(
                prob=float(ms.prob), lanes=lanes,
                k=1 if crystal.shape.is_deterministic() else lanes // g,
                axis_params=sampling.make_axis_params([axis],
                                                      [latlut.build_lat_lut(axis.latitude)]),
                kind=kind, shape=shape))
            b_prev = lanes
        return out

    def _build_wavelengths(self) -> None:
        light = self.cfg.light
        if light.illuminant is not None:
            self.wl_values = None
            k_pool = int(self.knobs.get("IHT_WL_POOL", 64))
            k_pool = 1 << max(0, k_pool.bit_length() - 1)
        else:
            self.wl_values = np.asarray([w.wl for w in light.spectrum], np.float32)
            n_wl = len(self.wl_values)
            k_pool = 1 << (n_wl - 1).bit_length() if n_wl > 1 else 1
        p_max = max((r.resolution[0] * r.resolution[1] for r in self.cfg.renders), default=1)
        while k_pool > 1 and not spectral_key_bits(p_max, k_pool):
            k_pool //= 2
        self.k_pool = k_pool
        self.spectral_ok = spectral_key_bits(p_max, k_pool) and (
            self.wl_values is None or len(self.wl_values) <= k_pool)
        pool_wl = self._wl_of(torch.arange(k_pool))
        if self.wl_values is None:
            self._w0_tbl = color.illuminant_spd_fast(light.illuminant, pool_wl).to(self.device)
        else:
            self._w0_tbl = torch.as_tensor(
                np.asarray([w.weight for w in light.spectrum], np.float32)).to(self.device)
        self.basis_tbl = color.cmf_eval(pool_wl).to(self.device)

    def _wl_of(self, wl_idx):
        """Wavelength of pool entry wl_idx (float32)."""
        if self.wl_values is not None:
            n = len(self.wl_values)
            return const(self.wl_values, wl_idx.device)[torch.clamp(wl_idx.long(), max=n - 1)]
        k = float(np.float32(400.0 / self.k_pool))
        return 380.0 + (wl_idx.to(F32) + 0.5) * k

    def _root_draws(self, ray_idx, seed_vec):
        """Per root ray (wavelength, initial weight, pool index)."""
        if self.wl_values is not None:
            wl_idx = ray_idx % len(self.wl_values)
            return const(self.wl_values, ray_idx.device)[wl_idx], self._w0_tbl[wl_idx], wl_idx
        u = rng.uniform(seed_vec ^ rng.NONCE_WL ^ 0x6A09E667, ray_idx, 0)
        wl_idx = torch.clamp_max((u * self.k_pool).to(I32), self.k_pool - 1).to(I64)
        return 380.0 + u * 400.0, self._w0_tbl[wl_idx], wl_idx

    def _pool(self, batch: int, li: int, layer: Layer) -> trace.GeomPool:
        """The pool of crystal shapes of `layer`, layer li, in batch `batch`."""
        dev = self.device
        seed0 = self.seed ^ rng.NONCE_GEOM_SHAPE ^ ((li * 0x9E37) & MASK32)
        kb = (batch & MASK32) * layer.k
        kb_lo, kb_hi = kb & MASK32, (kb >> 32) & MASK32
        k_idx = (kb_lo + torch.arange(layer.k, dtype=I64, device=dev)) & MASK32
        seed = rng.epoch_seed(seed0, kb_lo, kb_hi, k_idx)
        sp = layer.shape

        def draw(slot, dist):
            return rng.sample_dist(seed, k_idx, slot, *dist)

        dists = torch.stack([draw(sp["d_slots"][i], sp["d"][i]) for i in range(6)], dim=-1)
        if layer.kind == "prism":
            g = geometry.prism_geom_batch(torch.abs(draw(sp["h_slot"], sp["h"])), dists)
            g = geometry.pad_geom_faces(g, geometry.PRISM_FACES)
        else:
            h1, h2, h3 = (torch.abs(draw(sp[c + "_slot"], sp[c])) for c in "upl")
            g = pyramid.pyramid_geom_batch(h1, h2, h3, sp["au"], sp["al"], dists)
            g = geometry.pad_geom_faces(g, geometry.PYRAMID_FACES)
        return trace.make_geom_pool(g, sampling.build_entry_tris(g))

    @property
    def span(self) -> int:
        """Ray indices a batch owns: batch_size * (layers + 1)."""
        return self.batch_size * (len(self.layers) + 1)

    def _calibrate(self, first: dict) -> None:
        """The slot cap and the continuation lanes from the first batch's
        record `first`, as the module docstring states them."""
        if self.slot_cap is None:
            mass = first["slot_mass"]
            total = float(mass.sum())
            cap = self.max_hits
            if total > 0:
                tail = np.cumsum(mass[::-1])[::-1]
                for c in range(1, self.max_hits):
                    if tail[c] <= SLOT_TAIL * total:
                        cap = c
                        break
            self.slot_cap = cap
        trimmed = [None]
        for li in range(1, len(self.layers)):
            want = int(first["cont_live"][li - 1] * LANES_MARGIN)
            trimmed.append(want if want < 0.85 * self._first[li].lanes else None)
        self.layers = self._steady = self._plan_layers(trimmed)

    def batch_rows(self, c: int):
        """Batch c: its live contribution rows per render (pixel int64,
        weight float32, wavelength-pool index int64), its landed weight per
        render and its dropped weight, each the float64 sum of its terms,
        and its traced segments. Float32 matrix products in float32, not
        TF32 (set here, in the check, where the program's engine is gone)."""
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if c != 0 and self._steady is None:
            self._calibrate(self._trace(0))
        out = self._trace(c)
        if c == 0 and self._steady is None:
            self._calibrate(out)
        return out["rows"], out["landed"], out["dropped"], out["segs"]

    def _trace(self, c: int) -> dict:
        """One batch through every layer: the first batch with every slot
        (unless the cap is pinned) and the lanes before the trim, every
        later one with the calibration's."""
        dev, B, H = self.device, self.batch_size, self.max_hits
        first = c == 0
        layers = self._first if first else self._steady
        cap = self.slot_cap if self.slot_cap is not None and not (first and self._auto_cap) else H
        base = c * self.span
        base_lo, base_hi = base & MASK32, (base >> 32) & MASK32
        ray_idx = (base_lo + torch.arange(B, dtype=I64, device=dev)) & MASK32
        seed_vec = rng.epoch_seed(self.seed, base_lo, base_hi, ray_idx)
        wl, w0, wl_idx = self._root_draws(ray_idx, seed_vec)
        w_cut = torch.mean(w0) * float(np.float32(self.min_emit_frac))
        n_ior = optics.ice_refractive_index(wl)
        sun = self.cfg.light.sun
        d_world = sampling.sample_sun_dirs_soa(seed_vec ^ rng.NONCE_SUN, ray_idx, sun.azimuth,
                                               sun.altitude, sun.diameter)
        rows = [[] for _ in self.proj_plans]
        landed = [0.0] * len(self.proj_plans)
        dropped, segs = 0.0, 0
        slot_mass = np.zeros(H)
        cont_live = []
        for li, layer in enumerate(layers):
            lseed = seed_vec ^ ((LAYER_NONCE * (li + 1)) & MASK32)
            rot = sampling.sample_rot_row(lseed ^ rng.NONCE_ORIENT, ray_idx,
                                          layer.axis_params, 0, lut_loop=True)
            ex = trace_layer.trace_layer_soa(lseed, ray_idx, d_world, w0, rot,
                                             self._pool(c, li, layer), n_ior, H,
                                             setting_blocks=((layer.k, layer.lanes),))
            depth = torch.arange(1, H + 1, dtype=I64, device=dev)[:, None]
            segs += int(torch.where(ex.w > 0.0, depth, 0).amax(dim=0).sum())
            last = li == len(layers) - 1
            go_on = torch.zeros_like(ex.w, dtype=torch.bool)
            emit = ex.w
            if layer.prob > 0.0:
                u = _slot_draws(lseed ^ rng.NONCE_GATE, ray_idx, 100, H)
                if last:
                    emit = torch.where(u >= layer.prob, ex.w, 0.0)
                else:
                    go_on = (u < layer.prob) & (ex.w > 0.0)
                    emit = torch.where(go_on, 0.0, ex.w)
            if self.min_emit_frac > 0.0:
                tiny = (emit > 0.0) & (emit < w_cut)
                if self.emit_floor_rr:
                    u_rr = _slot_draws(lseed ^ rng.NONCE_EMIT, ray_idx, 0, H)
                    floored = torch.where(tiny, torch.where(u_rr * w_cut < emit, w_cut, 0.0),
                                          emit)
                else:
                    floored = torch.where(tiny, 0.0, emit)
                dropped += float((emit.double() - floored.double()).sum())
                emit = floored
            lv = emit > 0.0
            rank = torch.cumsum(lv.to(I64), dim=0) - lv.to(I64)
            if first:
                for k in range(H):
                    slot_mass[k] += float(torch.where(lv & (rank == k), emit, 0.0)
                                          .double().sum())
            kept = lv & (rank < cap)
            dropped += float(torch.where(lv & ~kept, emit, 0.0).double().sum())
            w_k = emit[kept]
            wl_k = wl_idx[None, :].expand(H, -1)[kept] & (self.k_pool - 1)
            dirs = [x[kept] for x in (ex.dx, ex.dy, ex.dz)]
            for r, pp in enumerate(self.proj_plans):
                hits = projection.project_components(pp, *dirs)
                ok = hits.main >= 0
                rows[r].append((hits.main[ok].to(I64), w_k[ok], wl_k[ok]))
                landed[r] += float(w_k[ok].double().sum())
                if pp.max_abs_dz > 0.0:
                    ok = hits.overlap >= 0
                    rows[r].append((hits.overlap[ok].to(I64), w_k[ok], wl_k[ok]))
            if last:
                break
            nxt = layers[li + 1]
            w_c = torch.where(go_on, ex.w, 0.0).reshape(-1)
            layer_seed = self.seed ^ ((LAYER_NONCE * (li + 1)) & MASK32)
            picked, n_live = continuation_order(w_c, nxt.lanes, layer_seed, c)
            cont_live.append(n_live)
            left = torch.ones_like(go_on).reshape(-1)
            left[picked] = False
            dropped += float(w_c[left].double().sum())
            n = picked.shape[0]

            def lanes_of(x):
                out = torch.zeros(nxt.lanes, dtype=x.dtype, device=dev)
                out[:n] = x.reshape(-1)[picked]
                return out

            w0 = lanes_of(w_c)
            wl_idx = lanes_of(wl_idx[None, :].expand(H, -1))
            d_world = tuple(lanes_of(x) for x in (ex.dx, ex.dy, ex.dz))
            ray_idx = (base_lo + B * (li + 1)
                       + torch.arange(nxt.lanes, dtype=I64, device=dev)) & MASK32
            seed_vec = rng.epoch_seed(self.seed, base_lo, base_hi, ray_idx)
            n_ior = optics.ice_refractive_index(self._wl_of(wl_idx))
        self.cont_live[c] = cont_live
        out_rows = []
        for parts in rows:
            pix, w, wl_r = (torch.cat(x) for x in zip(*parts))
            live = w > 0.0
            out_rows.append((pix[live], w[live], wl_r[live]))
        return {"rows": out_rows, "landed": landed, "dropped": dropped, "segs": segs,
                "slot_mass": slot_mass, "cont_live": cont_live}
