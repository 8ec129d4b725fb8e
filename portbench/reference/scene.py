"""The reference's scene: the rays of one batch of a port Engine on the
trace kernel's path, worked out again from the configuration, the seed and
the batch index.

What decides the answer is the configuration's semantics as the repository
states them: the plan of the one layer, the wavelength and sun draws, the
crystal pool of a stochastic shape, and the per-ray trace with its emit
floor (``core/trace_emit.trace_rows_plain``, the plain statement of the
trace kernel's arithmetic, kept here as a frozen copy in
``portbench/reference/plain``). Nothing of the port's host loop, fold,
calibration, compaction or graphs is in it: every live exit row is kept,
and the fold is the reference's own (``oracle.py``). That frozen copy was
held once against the JAX package on the same seeds (PERF.md).

Scenes the trace kernel refuses (several layers or settings, filters,
raypath-colour classes) are refused here too: a cell on the general trace
needs a reference of its own (a module named by its workload's
``reference`` key).

IHT_* knobs come from the workload file (``knobs``), never from the
environment: a knob that changes which rays are traced or kept changes
the reference with it; those that choose a fold or a path of the same
image are ignored.
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
    projection,
    pyramid,
    rng,
    sampling,
    trace,
    trace_emit,
)
from portbench.reference.plain.core.accum import key_shift, spectral_key_bits
from portbench.reference.plain.core.bits import F32, I64, MASK32, const, from_bits

DEFAULT_GEOM_CLOCK = 32

def largest_remainder_partition(total: int, proportions) -> list:
    """Exact integer split of `total` by proportions."""
    props = np.maximum(np.asarray(proportions, np.float64), 0.0)
    s = props.sum()
    if s <= 0 or total == 0:
        return [0] * len(props)
    ideal = props / s * total
    alloc = np.floor(ideal).astype(np.int64)
    deficit = total - alloc.sum()
    order = np.argsort(-(ideal - alloc))
    for i in range(int(deficit)):
        alloc[order[i % len(props)]] += 1
    return [int(x) for x in alloc]


class LayerPlan(NamedTuple):
    """Host-side plan of one scattering layer, per crystal setting."""

    prob: float
    n_settings: int
    setting_idx: np.ndarray     # [B_layer] lane -> setting
    shape_base: np.ndarray      # [B_layer] lane -> geom-clock block
    setting_counts: list        # rays per setting
    k_per_setting: list         # shapes per setting in the pool
    axis_params: sampling.AxisParams
    shape_kinds: list           # "prism" | "pyramid" per setting
    shape_param_arrays: list    # per setting: distribution params and RNG slots
    deterministic_shape: list   # per setting bool
    deterministic_axis: list    # per setting bool
    crystal_ids: list           # per setting crystal id of the config


def _dist_params(d) -> tuple:
    return (int(d.type), float(d.center), float(d.spread))


def _sample_shape_scalars(seed, k_idx, slot0, dist_tuple):
    dtype, center, spread = dist_tuple
    return rng.sample_dist(seed, k_idx, slot0, dtype, center, spread)


class Scene:
    """One configuration at one seed and batch size, on one device."""

    def __init__(self, cfg: ProjectConfig, seed: int, batch_size: int, device,
                 knobs: Optional[dict] = None):
        self.cfg = cfg
        self.knobs = dict(knobs or {})
        self.shard = (0, 1)
        self.seed = int(seed) & 0xFFFFFFFF
        self.batch_size = int(batch_size)
        self.geom_clock = DEFAULT_GEOM_CLOCK
        self.device = torch.device(device)
        self.min_emit_frac = float(self.knob("IHT_MIN_EMIT_W", 1e-3))
        self.emit_floor_mode = str(self.knob("IHT_EMIT_FLOOR", "rr")).lower()
        self._build_plan()
        self._build_wavelengths()
        self._build_renders()
        self._choose_trace_path()

    def knob(self, name: str, default=None):
        return self.knobs.get(name, default)

    def batch_rows(self, c: int):
        """Batch c: its live contribution rows per render (pixel int64,
        weight float32, wavelength-pool index int64), its landed weight per
        render and its dropped weight, each the float64 sum of its terms
        (``trace_emit.trace_rows_plain``), and its traced segments."""
        tables = self._pool_tables(c) if self._trace_plan.pool_k else ()
        slabs, landed, dropped, segs = trace_emit.trace_rows_plain(
            self._trace_plan, self.ray_base(c), self.batch_size, self.device, *tables)
        shift = key_shift(self.k_pool)
        rows = []
        for keys, wts in slabs:
            k = from_bits(keys.reshape(-1))
            w = wts.reshape(-1)
            live = (k != MASK32) & (w > 0.0)
            k = k[live]
            rows.append((k >> shift, w[live], (k >> 1) & (self.k_pool - 1)))
        return rows, [float(x) for x in landed], float(dropped), int(segs)

    def _choose_trace_path(self) -> None:
        """The trace kernel's plan; a scene that the kernel refuses is
        refused (NotImplementedError)."""
        reason = trace_emit.refusal_reason(self)
        if (reason is not None and reason.startswith("stochastic crystal")
                and self.geom_clock == DEFAULT_GEOM_CLOCK):
            # The blocked-pool trace mode needs one shape per 128 rays;
            # geom_clock is a sharing granularity that does not change the
            # image's expectation, so the default moves, as the engine's does.
            self.geom_clock = trace_emit.POOL_GEOM_CLOCK
            self._build_plan()
            reason = trace_emit.refusal_reason(self)
        if reason is not None:
            raise NotImplementedError(f"the reference covers the trace kernel's scenes: {reason}")
        self._trace_plan = trace_emit.build_plan(self)

    def _build_plan(self) -> None:
        """Per-layer plans (the trace kernel's path has one layer; a scene
        with more is refused after this) and the two-rule stats constants."""
        cfg = self.cfg
        self.max_hits = int(cfg.scene.max_hits)
        g = self.geom_clock
        # Whole geom-clock blocks, so the ray -> pool-shape map is exactly
        # lane // geom_clock.
        self.batch_size = -(-self.batch_size // g) * g
        layers = []
        b_prev = self.batch_size
        det_crystals = det_orients = 0
        for li, ms in enumerate(cfg.scene.layers):
            if li == 0:
                b_layer = self.batch_size
            else:
                # Continuation capacity: the expected continuations with
                # slack (a prism ray leaves about 0.67 * max_hits exit slots
                # live, each continuing with probability p), clamped by the
                # hard maximum. Overflow drops the lowest-weight rows first
                # and is accounted in dropped_cont_weight.
                p_prev = cfg.scene.layers[li - 1].prob
                expect = b_prev * min(1.3 * p_prev * 0.67 * self.max_hits,
                                      float(self.max_hits))
                b_layer = int(min(max(expect, 1024), b_prev * self.max_hits))
                b_layer = -(-b_layer // (256 * g)) * (256 * g)
            blocks = largest_remainder_partition(
                b_layer // g, [e.proportion for e in ms.entries])
            counts = [b * g for b in blocks]
            axes, kinds, params, det_shape, det_axis = [], [], [], [], []
            crystal_ids = []
            for e in ms.entries:
                crystal = cfg.crystals[e.crystal_id]
                axes.append(crystal.axis)
                det_axis.append(crystal.axis.is_deterministic())
                det_orients += crystal.axis.is_deterministic()
                shape = crystal.shape
                det_shape.append(shape.is_deterministic())
                det_crystals += shape.is_deterministic()
                # A synced member consumes its group leader's RNG slot, so the
                # group shares one raw draw per crystal instance.
                leaders = sync_group_leaders(shape.sync_group)
                if isinstance(shape, PrismShape):
                    kinds.append("prism")
                    slot_of = [0] + [2 + 2 * i for i in range(6)]
                    params.append({
                        "h": _dist_params(shape.height),
                        "d": [_dist_params(x) for x in shape.face_distance],
                        "h_slot": slot_of[leaders[0]],
                        "d_slots": [slot_of[leaders[1 + i]] for i in range(6)],
                    })
                elif isinstance(shape, PyramidShape):
                    kinds.append("pyramid")
                    slot_of = [0, 2, 4] + [6 + 2 * i for i in range(6)]
                    params.append({
                        "u": _dist_params(shape.upper_h),
                        "p": _dist_params(shape.prism_h),
                        "l": _dist_params(shape.lower_h),
                        "au": float(shape.wedge_angle_u),
                        "al": float(shape.wedge_angle_l),
                        "d": [_dist_params(x) for x in shape.face_distance],
                        "u_slot": slot_of[leaders[0]],
                        "p_slot": slot_of[leaders[1]],
                        "l_slot": slot_of[leaders[2]],
                        "d_slots": [slot_of[leaders[3 + i]] for i in range(6)],
                    })
                else:
                    raise ValueError(f"unsupported shape {type(shape)}")
                crystal_ids.append(e.crystal_id)
            luts = [latlut.build_lat_lut(a.latitude) for a in axes]
            # A deterministic shape is ONE pool row: every geom-clock block
            # would sample the identical crystal.
            k_per = [0 if c == 0 else (1 if det else max(1, b))
                     for c, b, det in zip(counts, blocks, det_shape)]
            layers.append(LayerPlan(
                prob=float(ms.prob), n_settings=len(ms.entries),
                setting_idx=np.repeat(np.arange(len(ms.entries), dtype=np.int32), counts),
                shape_base=np.arange(b_layer, dtype=np.int32) // g,
                setting_counts=counts, k_per_setting=k_per,
                axis_params=sampling.make_axis_params(axes, luts),
                shape_kinds=kinds, shape_param_arrays=params,
                deterministic_shape=det_shape, deterministic_axis=det_axis,
                crystal_ids=crystal_ids,
            ))
            b_prev = b_layer
        self.layers = layers
        self.layer0 = layers[0]
        self.axis_params = self.layer0.axis_params
        self.det_crystal_count = int(det_crystals)
        self.det_orientation_count = int(det_orients)
        self.any_pyramid = any(k == "pyramid" for l in layers for k in l.shape_kinds)

    def _build_wavelengths(self) -> None:
        light = self.cfg.light
        if light.illuminant is not None:
            self.wl_mode = "illuminant"
            self.illuminant = light.illuminant
            self.wl_values = self.wl_weights = None
            k_pool = int(self.knob("IHT_WL_POOL", 64))
            k_pool = 1 << max(0, k_pool.bit_length() - 1)
        else:
            self.wl_mode = "discrete"
            self.wl_values = np.asarray([w.wl for w in light.spectrum], np.float32)
            self.wl_weights = np.asarray([w.weight for w in light.spectrum], np.float32)
            n_wl = len(self.wl_values)
            k_pool = 1 << (n_wl - 1).bit_length() if n_wl > 1 else 1
        p_max = max((r.resolution[0] * r.resolution[1] for r in self.cfg.renders),
                    default=1)
        while k_pool > 1 and not spectral_key_bits(p_max, k_pool):
            k_pool //= 2
        self.k_pool = k_pool
        self.spectral_ok = spectral_key_bits(p_max, k_pool) and (
            self.wl_mode == "illuminant" or len(self.wl_values) <= k_pool
        )
        pool_wl = self._wl_from_idx(torch.arange(k_pool))
        self.spd_table = (color.illuminant_spd_fast(self.illuminant, pool_wl)
                          if self.wl_mode == "illuminant" else None)
        self.basis_tbl = color.cmf_eval(pool_wl).to(self.device)
        # Device copies of the per-ray wavelength tables.
        if self.wl_mode == "illuminant":
            self._w0_tbl = self.spd_table.to(self.device)
            self._wl_tbl = None
        else:
            self._w0_tbl = torch.as_tensor(self.wl_weights).to(self.device)
            self._wl_tbl = torch.as_tensor(self.wl_values).to(self.device)

    def _wl_from_idx(self, wl_idx):
        """Wavelength of pool entry wl_idx (float32, on wl_idx's device)."""
        if self.wl_mode == "discrete":
            # Pool entries past the table clamp to its last wavelength, as
            # the JAX gather does.
            n = len(self.wl_values)
            return const(self.wl_values, wl_idx.device)[torch.clamp(wl_idx.long(), max=n - 1)]
        k = float(np.float32(400.0 / self.k_pool))
        return 380.0 + (wl_idx.to(F32) + 0.5) * k

    def _build_renders(self) -> None:
        self.proj_plans = [projection.make_proj_plan(r) for r in self.cfg.renders]

    def _sample_layer_pool(self, batch_counter, device=None, li: int = 0) -> trace.GeomPool:
        """Layer li's K-shape geometry pool of one batch (plain torch on
        `device`; the JAX package samples it in XLA, outside any kernel).
        batch_counter: a python int or the engine's int64 counter tensor.

        The shape index is 64 bits wide: batch_counter * k_total passes
        2^32 within a long render, and its high word is mixed into the seed
        as the ray-base epoch is."""
        plan = self.layers[li]
        device = self.device if device is None else device
        seed0 = self.seed ^ rng.NONCE_GEOM_SHAPE ^ ((li * 0x9E37) & MASK32)
        kb = (rng._t(batch_counter) & MASK32) * sum(plan.k_per_setting)
        kb_lo, kb_hi = kb & MASK32, (kb >> 32) & MASK32
        layer_nf = geometry.PYRAMID_FACES if "pyramid" in plan.shape_kinds \
            else geometry.PRISM_FACES
        geoms = []
        k_off = 0
        for s, kind in enumerate(plan.shape_kinds):
            k = plan.k_per_setting[s]
            k_idx = (kb_lo + k_off + torch.arange(k, dtype=I64, device=device)) & MASK32
            seed = rng.epoch_seed(seed0, kb_lo, kb_hi, k_idx)
            sp = plan.shape_param_arrays[s]
            dists = torch.stack(
                [_sample_shape_scalars(seed, k_idx, sp["d_slots"][i], sp["d"][i])
                 for i in range(6)], dim=-1)
            if kind == "prism":
                h = torch.abs(_sample_shape_scalars(seed, k_idx, sp["h_slot"], sp["h"]))
                g = geometry.prism_geom_batch(h, dists)
            else:
                h1, h2, h3 = (
                    torch.abs(_sample_shape_scalars(seed, k_idx, sp[c + "_slot"], sp[c]))
                    for c in "upl")
                g = pyramid.pyramid_geom_batch(h1, h2, h3, sp["au"], sp["al"], dists)
            geoms.append(geometry.pad_geom_faces(g, layer_nf))
            k_off += k
        g = geoms[0] if len(geoms) == 1 else geometry.CrystalGeom(
            *(torch.cat(xs, dim=0) for xs in zip(*geoms)))
        return trace.make_geom_pool(g, sampling.build_entry_tris(g))

    def _pool_tables(self, batch_counter):
        """The blocked-pool kernel inputs of one batch: ptbl [K, NF*5] rows
        of (nx, ny, nz, d, present) per face, ttbl [K, T*13] rows of
        (cross_half, v0, e1, e2, face) per entry triangle."""
        pool = self._sample_layer_pool(batch_counter)
        feat = torch.cat(
            [pool.plane_n, pool.plane_d[..., None],
             pool.face_present.to(F32)[..., None]], dim=-1)          # [K, NF, 5]
        tfeat = torch.cat(
            [pool.tri_cross_half, pool.tri_v0, pool.tri_e1, pool.tri_e2,
             pool.tri_face.to(F32)[..., None]], dim=-1)              # [K, T, 13]
        return (feat.reshape(feat.shape[0], -1).contiguous(),
                tfeat.reshape(tfeat.shape[0], -1).contiguous())

    @property
    def span(self) -> int:
        """Ray indices one shard's batch owns: batch_size * (layers + 1)
        (layer li of the batch takes those from li * batch_size on)."""
        return self.batch_size * max(1, len(self.layers) + 1)

    def ray_base(self, batch_counter: int) -> int:
        """64-bit ray base of this shard's batch c: (c * count + index) *
        span, so layer li owns the ray indices base + li * batch_size + lane.
        For shard (d, n) that is the JAX sharded step's c * n * span + d *
        span with its carry into the high word; for (0, 1), c * span."""
        index, count = self.shard
        return (int(batch_counter) * count + index) * self.span
