"""The reference's scene on the general trace with several crystal settings
in a layer and any number of layers: the rays of one batch of a port Engine,
worked out again from the configuration, the seed and the batch index.

Cover: every scene of the general path without a ray-path filter or a
raypath-colour class whose keys pack into 32 bits (the sort fold), with
prisms and pyramids. Refused (NotImplementedError): one layer of one
setting (the trace kernel's path, ``scene.py``), filters, colour classes,
keys that do not pack.

The rules are the configuration's ``guarantees``, stated as the port's
general path at its defaults, and computed here with none of the port's
code: the frozen plain modules (``plain/``) for the draws, the crystal
shapes, the layer trace (``plain/core/trace_layer.py``) and the projection,
``two_layer.py``'s helpers for the gates' draws and the continuation's
order, its wavelengths, calibration and batch loop (``two_layer.Scene``,
whose one-setting rules this widens), and the float64 fold of
``oracle.py``. Per batch and layer:
  - the lanes of a layer (B for the first, the continuation's for a later
    one; two_layer.py states how many) split between the layer's settings
    by a largest-remainder partition of the blocks of GEOM_CLOCK lanes by
    the settings' proportions, setting after setting in their order;
  - the crystal pool: per setting one shape per block of GEOM_CLOCK lanes
    (one shape in all for a fixed shape), drawn from the stream (seed ^
    the shape nonce ^ the layer's, the batch's first shape index + the
    setting's offset + k), every setting's faces padded to the layer's
    widest (20 slots where the layer holds a pyramid, else 8); lane i of a
    setting takes its setting's shape (i - the setting's first lane) //
    GEOM_CLOCK;
  - the orientation of a lane from its setting's axis distribution, on the
    lane's own stream;
  - the trace, the probability gate, the emit floor, the slot cap, the
    projection and the continuation as ``two_layer.py`` states them, over
    every lane of the layer whatever its setting.
Landed weight: the main pixel's rows. Dropped weight: the emit floor's net,
the slot cap's and the continuation's dropped rows. Segments: per lane and
layer the deepest live exit slot.

Ray indices: layer li of batch c traces from c x span + li x B on (span = B
x (layers + 1)), lane j of the layer the index + j. A later layer has more
lanes than the span (on pyramid_heavy_ms3 layer 3 some 60 B against 4 B),
so lane span + m of a layer of batch c has the ray index, the epoch seed
and the layer nonce of lane m of the same layer of batch c + 1: the same
orientation, gate and roulette draws (each layer-3 stream serves some 15
lanes). The draws are so correlated between lanes, not biased. This is
the port's rule and the JAX package's
(``ice_halo_sim_tpu/engine/simulator.py``), and the reference keeps it.

Departures from the upstream (LoveDaisy/ice_halo_sim), all the port's:
the emit floor, the slot cap and the continuation's fixed lanes (weight
kept in expectation or dropped and counted, never silently lost); one
crystal shape per GEOM_CLOCK lanes, not per ray; wavelengths from a pool of
64 entries for an illuminant.

The work is in blocks of at most LANE_BLOCK lanes, a block inside one
setting and on whole shapes: every draw is keyed by the ray index, so a
block's rows are the rows of the whole layer's lanes it holds. Only the
continuation's order takes the whole layer. The pyramids of a pool are
built in passes of GEOM_CHUNK (each shape alone, the same values).

IHT_* knobs come from the workload file (``knobs``), as in
``two_layer.py``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from portbench.reference import two_layer
from portbench.reference.plain.core import (
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
from portbench.reference.plain.core.bits import I64, MASK32
from portbench.reference.two_layer import (
    GEOM_CLOCK,
    LAYER_NONCE,
    _shape_params,
    _slot_draws,
    continuation_order,
)

LANE_BLOCK = 1 << 20     # lanes of one block of the trace and its epilogue
# Pyramids of one pass of the vertex enumeration, by device type (the
# port's passes: the same values in fewer bytes, and on the CPU the same
# vector lanes as the port's).
GEOM_CHUNK = {"cuda": 8192, "cpu": 256}


class Setting(NamedTuple):
    """One crystal setting of a layer (its index is its axis's in the
    layer's axis_params): its lanes, pool shapes and shape."""

    lanes: int
    k: int
    kind: str                   # "prism" | "pyramid"
    shape: dict                 # distribution params and RNG slots
    deterministic: bool


class Layer(NamedTuple):
    """One scattering layer: its probability, lanes, settings, their axes
    and the layer's face slots."""

    prob: float
    lanes: int
    settings: tuple
    axis_params: sampling.AxisParams
    nf: int


def largest_remainder(total: int, proportions) -> list:
    """Exact integer split of `total` by proportions, the largest
    fractional parts rounded up first."""
    props = np.maximum(np.asarray(proportions, np.float64), 0.0)
    s = props.sum()
    if s <= 0 or total == 0:
        return [0] * len(props)
    ideal = props / s * total
    alloc = np.floor(ideal).astype(np.int64)
    order = np.argsort(-(ideal - alloc))
    for i in range(int(total - alloc.sum())):
        alloc[order[i % len(props)]] += 1
    return [int(x) for x in alloc]


def _pyramids(sp: dict, draw, k: int, device):
    """Pyramid geometry of k shapes, in passes of GEOM_CHUNK."""
    h1, h2, h3 = (torch.abs(draw(sp[c + "_slot"], sp[c])) for c in "upl")
    dists = torch.stack([draw(sp["d_slots"][i], sp["d"][i]) for i in range(6)], dim=-1)
    n = GEOM_CHUNK.get(device.type, GEOM_CHUNK["cuda"])
    parts = [pyramid.pyramid_geom_batch(h1[i:i + n], h2[i:i + n], h3[i:i + n], sp["au"],
                                        sp["al"], dists[i:i + n])
             for i in range(0, k, n)]
    return geometry.CrystalGeom(*(torch.cat(xs) for xs in zip(*parts)))


def _sub_pool(pool: trace.GeomPool, r0: int, r1: int) -> trace.GeomPool:
    return trace.GeomPool(*(t[r0:r1] for t in pool))


class Scene(two_layer.Scene):
    """One configuration at one seed and batch size, on one device."""

    def _refuse_outside_cover(self) -> None:
        cfg = self.cfg
        layers = cfg.scene.layers
        why = None
        if len(layers) == 1 and len(layers[0].entries) == 1:
            why = "one layer of one setting is the trace kernel's path (reference/scene.py)"
        elif any(e.filter_id != 0 for l in layers for e in l.entries):
            why = "a ray-path filter"
        elif cfg.raypath_color is not None and cfg.raypath_color.classes:
            why = "raypath-colour classes"
        elif not self.spectral_ok:
            why = "keys that do not pack into 32 bits"
        if why is not None:
            raise NotImplementedError(
                f"the reference covers layers of any settings without filters: {why}")

    def _plan_layers(self, trimmed) -> list:
        """Every layer's lanes (two_layer.py's rule), its settings' lanes
        and pool shapes, and its axes. `trimmed`: per layer the lanes the
        first batch asks for, or None."""
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
            blocks = largest_remainder(lanes // g, [e.proportion for e in ms.entries])
            settings, axes = [], []
            for e, b in zip(ms.entries, blocks):
                crystal = self.cfg.crystals[e.crystal_id]
                kind, shape = _shape_params(crystal.shape)
                det = crystal.shape.is_deterministic()
                settings.append(Setting(lanes=b * g, k=0 if b == 0 else 1 if det else b,
                                        kind=kind, shape=shape, deterministic=det))
                axes.append(crystal.axis)
            out.append(Layer(
                prob=float(ms.prob), lanes=lanes, settings=tuple(settings),
                axis_params=sampling.make_axis_params(
                    axes, [latlut.build_lat_lut(a.latitude) for a in axes]),
                nf=geometry.PYRAMID_FACES if any(s.kind == "pyramid" for s in settings)
                else geometry.PRISM_FACES))
            b_prev = lanes
        return out

    def _pool(self, batch: int, li: int, layer: Layer) -> trace.GeomPool:
        """The pool of crystal shapes of layer li in batch `batch`: every
        setting's shapes in setting order."""
        dev = self.device
        seed0 = self.seed ^ rng.NONCE_GEOM_SHAPE ^ ((li * 0x9E37) & MASK32)
        kb = (batch & MASK32) * sum(s.k for s in layer.settings)
        kb_lo, kb_hi = kb & MASK32, (kb >> 32) & MASK32
        geoms, k_off = [], 0
        for st in layer.settings:
            k_idx = (kb_lo + k_off + torch.arange(st.k, dtype=I64, device=dev)) & MASK32
            seed = rng.epoch_seed(seed0, kb_lo, kb_hi, k_idx)
            sp = st.shape

            def draw(slot, dist):
                return rng.sample_dist(seed, k_idx, slot, *dist)

            if st.kind == "prism":
                dists = torch.stack([draw(sp["d_slots"][i], sp["d"][i]) for i in range(6)],
                                    dim=-1)
                g = geometry.prism_geom_batch(torch.abs(draw(sp["h_slot"], sp["h"])), dists)
            else:
                g = _pyramids(sp, draw, st.k, dev)
            geoms.append(geometry.pad_geom_faces(g, layer.nf))
            k_off += st.k
        g = geometry.CrystalGeom(*(torch.cat(xs) for xs in zip(*geoms)))
        return trace.make_geom_pool(g, sampling.build_entry_tris(g))

    def _blocks(self, layer: Layer):
        """(setting index, first lane, lanes, first pool row, pool rows) of
        every block of the layer: inside one setting, on whole shapes, at
        most LANE_BLOCK lanes (a fixed shape's lanes share its one row)."""
        lane = row = 0
        for s, st in enumerate(layer.settings):
            if st.lanes:
                per = 1 if st.deterministic else st.lanes // st.k     # lanes a shape
                step = max(per, LANE_BLOCK // per * per)
                for a in range(0, st.lanes, step):
                    n = min(step, st.lanes - a)
                    if st.deterministic:
                        yield s, lane + a, n, row, 1
                    else:
                        yield s, lane + a, n, row + a // per, n // per
            lane += st.lanes
            row += st.k

    def _trace(self, c: int) -> dict:
        """One batch through every layer, block by block: the first batch
        with every slot (unless the cap is pinned) and the lanes before the
        trim, every later one with the calibration's."""
        # Float32 matrix products in float32, not TF32 (two_layer.Scene's
        # batch_rows sets the same before it calls here).
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
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
        depth = torch.arange(1, H + 1, dtype=I64, device=dev)[:, None]
        for li, layer in enumerate(layers):
            last = li == len(layers) - 1
            lseed = seed_vec ^ ((LAYER_NONCE * (li + 1)) & MASK32)
            pool = self._pool(c, li, layer)
            n_l = layer.lanes
            if not last:
                w_c = torch.zeros((H, n_l), dtype=torch.float32, device=dev)
                d_c = torch.zeros((3, H, n_l), dtype=torch.float32, device=dev)
            for s, a, n, r0, k in self._blocks(layer):
                sl = slice(a, a + n)
                rot = sampling.sample_rot_row(lseed[sl] ^ rng.NONCE_ORIENT, ray_idx[sl],
                                              layer.axis_params, s, lut_loop=True)
                ex = trace_layer.trace_layer_soa(
                    lseed[sl], ray_idx[sl], tuple(x[sl] for x in d_world), w0[sl], rot,
                    _sub_pool(pool, r0, r0 + k), n_ior[sl], H, setting_blocks=((k, n),))
                segs += int(torch.where(ex.w > 0.0, depth, 0).amax(dim=0).sum())
                go_on = torch.zeros_like(ex.w, dtype=torch.bool)
                emit = ex.w
                if layer.prob > 0.0:
                    u = _slot_draws(lseed[sl] ^ rng.NONCE_GATE, ray_idx[sl], 100, H)
                    if last:
                        emit = torch.where(u >= layer.prob, ex.w, 0.0)
                    else:
                        go_on = (u < layer.prob) & (ex.w > 0.0)
                        emit = torch.where(go_on, 0.0, ex.w)
                if self.min_emit_frac > 0.0:
                    tiny = (emit > 0.0) & (emit < w_cut)
                    if self.emit_floor_rr:
                        u_rr = _slot_draws(lseed[sl] ^ rng.NONCE_EMIT, ray_idx[sl], 0, H)
                        floored = torch.where(
                            tiny, torch.where(u_rr * w_cut < emit, w_cut, 0.0), emit)
                    else:
                        floored = torch.where(tiny, 0.0, emit)
                    dropped += float((emit.double() - floored.double()).sum())
                    emit = floored
                lv = emit > 0.0
                rank = torch.cumsum(lv.to(I64), dim=0) - lv.to(I64)
                if first:
                    for h in range(H):
                        slot_mass[h] += float(torch.where(lv & (rank == h), emit, 0.0)
                                              .double().sum())
                kept = lv & (rank < cap)
                dropped += float(torch.where(lv & ~kept, emit, 0.0).double().sum())
                w_k = emit[kept]
                wl_k = wl_idx[sl][None, :].expand(H, -1)[kept] & (self.k_pool - 1)
                dirs = [x[kept] for x in (ex.dx, ex.dy, ex.dz)]
                for r, pp in enumerate(self.proj_plans):
                    hits = projection.project_components(pp, *dirs)
                    ok = hits.main >= 0
                    rows[r].append((hits.main[ok].to(I64), w_k[ok], wl_k[ok]))
                    landed[r] += float(w_k[ok].double().sum())
                    if pp.max_abs_dz > 0.0:
                        ok = hits.overlap >= 0
                        rows[r].append((hits.overlap[ok].to(I64), w_k[ok], wl_k[ok]))
                if not last:
                    w_c[:, sl] = torch.where(go_on, ex.w, 0.0)
                    for i, x in enumerate((ex.dx, ex.dy, ex.dz)):
                        d_c[i, :, sl] = x
            if last:
                break
            nxt = layers[li + 1]
            w_c = w_c.reshape(-1)
            layer_seed = self.seed ^ ((LAYER_NONCE * (li + 1)) & MASK32)
            picked, n_live = continuation_order(w_c, nxt.lanes, layer_seed, c)
            cont_live.append(n_live)
            left = torch.ones_like(w_c, dtype=torch.bool)
            left[picked] = False
            dropped += float(w_c[left].double().sum())
            n = picked.shape[0]

            def lanes_of(x):
                out = torch.zeros(nxt.lanes, dtype=x.dtype, device=dev)
                out[:n] = x.reshape(-1)[picked]
                return out

            w0 = lanes_of(w_c)
            wl_idx = lanes_of(wl_idx[None, :].expand(H, -1))
            d_world = tuple(lanes_of(x) for x in d_c)
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
