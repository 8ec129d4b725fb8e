"""The port's engine: host loop over batches on one torch device (the
kernel-path subset of ``ice_halo_sim_tpu.engine.simulator.Engine``).

One batch = [the K-shape pool sampler, for a stochastic crystal shape] ->
trace_emit (K2 or K2b, + K1) -> per render: the sort fold. Before
calibration the fold takes every trace row (``fold_spectral_keys``); after
the first batch, ``keep`` = the measured live rows times _KEEP_MARGIN,
rounded up to the 4096-row extraction block, and a batch whose live rows
fit runs the block scatter (K3) with the marker tail straight into the
premerged fold. The live count needs one device-to-host read per batch
and render (``host_syncs`` counts them).

Differences from the JAX engine, all deliberate:
  - no silent degrade: a scene outside the kernel path raises
    NotImplementedError, a failing kernel raises, the engine never moves
    to another device;
  - batches are a Python loop (no multi-batch dispatch), so calibration
    reads the first batch alone;
  - the premerged fold runs whenever keep is set (the JAX engine also
    needs its scatter's VMEM output budget), and the v5e sort-size snap
    of keep is gone.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ice_halo_sim_tpu_torch.config.schema import (
    PrismShape,
    ProjectConfig,
    PyramidShape,
    sync_group_leaders,
)
from ice_halo_sim_tpu_torch.core import latlut
from ice_halo_sim_tpu_torch.utils import env_knobs
from ice_halo_sim_tpu_torch.core import accum as accum_mod
from ice_halo_sim_tpu_torch.core import (
    color,
    geometry,
    projection,
    pyramid,
    rng,
    sampling,
    trace,
    trace_emit,
)
from ice_halo_sim_tpu_torch.core.bits import F32, I32, I64, MASK32
from ice_halo_sim_tpu_torch.kernels import kernel_set

DEFAULT_BATCH = 1 << 17
DEFAULT_GEOM_CLOCK = 32
LAYER_STRIDE = 2  # ray-base stride in batches: batch_size * (n_layers + 1)


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
    """Host-side plan of the first scattering layer, per crystal setting."""

    prob: float
    setting_counts: list        # rays per setting
    k_per_setting: list         # shapes per setting in the pool
    axis_params: sampling.AxisParams
    shape_kinds: list           # "prism" | "pyramid" per setting
    shape_param_arrays: list    # per setting: distribution params and RNG slots
    deterministic_shape: list   # per setting bool
    deterministic_axis: list    # per setting bool


def _dist_params(d) -> tuple:
    return (int(d.type), float(d.center), float(d.spread))


def _sample_shape_scalars(seed, k_idx, slot0, dist_tuple):
    dtype, center, spread = dist_tuple
    return rng.sample_dist(seed, k_idx, slot0, dtype, center, spread)


class Stats(NamedTuple):
    rays_traced: int = 0
    ray_segments: int = 0
    landed_weight: float = 0.0
    dropped_cont_weight: float = 0.0
    stochastic_crystal_samples: int = 0
    stochastic_orientation_samples: int = 0
    deterministic_crystal_count: int = 0
    deterministic_orientation_count: int = 0


class Engine:
    """Commit a config, pump batches, snapshot images.

    device: the torch device everything lives on (default "cuda").
    geom_clock: rays per sampled crystal shape; a stochastic shape needs
    128 (one shape per 128-thread block of the trace kernel), and the
    default is raised to that, while a pinned other value raises.
    kernels: "cuda" (the CUDA kernels; the default on a CUDA device) or
    "plain" (the plain PyTorch twins; the only choice on the CPU).
    """

    _KEEP_MARGIN = 1.06

    def __init__(self, cfg: ProjectConfig, seed: int = 1,
                 batch_size: int = DEFAULT_BATCH, device="cuda",
                 kernels: Optional[str] = None,
                 geom_clock: int = DEFAULT_GEOM_CLOCK):
        self.cfg = cfg
        self.seed = int(seed) & 0xFFFFFFFF
        self.batch_size = int(batch_size)
        self.geom_clock = int(geom_clock)
        self.device = torch.device(device)
        if kernels is None:
            kernels = "cuda" if self.device.type == "cuda" else "plain"
        if kernels == "cuda" and self.device.type != "cuda":
            raise ValueError("kernels='cuda' needs a CUDA device; use kernels='plain'")
        self.ks = kernel_set(kernels)
        self.max_hits = int(cfg.scene.max_hits)
        self.min_emit_frac = float(env_knobs.get("IHT_MIN_EMIT_W", 1e-3))
        self.emit_floor_mode = str(env_knobs.get("IHT_EMIT_FLOOR", "rr")).lower()
        self._compact_enabled = str(env_knobs.get("IHT_COMPACT", "1")) not in (
            "0", "off", "false",
        )
        self._build_plan()
        self._build_wavelengths()
        self._build_renders()
        reason = trace_emit.refusal_reason(self)
        if (reason is not None and reason.startswith("stochastic crystal")
                and self.geom_clock == DEFAULT_GEOM_CLOCK):
            # The blocked-pool trace mode needs one shape per 128 rays;
            # geom_clock is a sharing granularity that does not change the
            # image's expectation, so the default moves. A pinned value is
            # respected (and refused).
            self.geom_clock = trace_emit.POOL_GEOM_CLOCK
            self._build_plan()
        self._trace_plan = trace_emit.build_plan(self)
        self._compact_keep = None
        self._calibrated = False
        self.host_syncs = 0
        self.reset()

    # ------------------------------------------------------------------
    # Plan build (host)
    # ------------------------------------------------------------------

    def _build_plan(self) -> None:
        """The first layer's per-setting plan (the trace kernel path takes
        single-layer, single-setting scenes; build_plan refuses the rest)
        and the two-rule stats constants over every layer."""
        cfg = self.cfg
        g = self.geom_clock
        # Whole geom-clock blocks, so the ray -> pool-shape map is exactly
        # lane // geom_clock.
        self.batch_size = -(-self.batch_size // g) * g
        ms = cfg.scene.layers[0]
        blocks = largest_remainder_partition(
            self.batch_size // g, [e.proportion for e in ms.entries])
        counts = [b * g for b in blocks]
        axes, kinds, params, det_shape, det_axis = [], [], [], [], []
        for e in ms.entries:
            crystal = cfg.crystals[e.crystal_id]
            axes.append(crystal.axis)
            det_axis.append(crystal.axis.is_deterministic())
            shape = crystal.shape
            det_shape.append(shape.is_deterministic())
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
        luts = [latlut.build_lat_lut(a.latitude) for a in axes]
        # A deterministic shape is ONE pool row: every geom-clock block
        # would sample the identical crystal.
        k_per = [0 if c == 0 else (1 if det else max(1, b))
                 for c, b, det in zip(counts, blocks, det_shape)]
        self.layer0 = LayerPlan(
            prob=float(ms.prob),
            setting_counts=counts, k_per_setting=k_per,
            axis_params=sampling.make_axis_params(axes, luts),
            shape_kinds=kinds, shape_param_arrays=params,
            deterministic_shape=det_shape, deterministic_axis=det_axis,
        )
        self.axis_params = self.layer0.axis_params
        entries = [cfg.crystals[e.crystal_id] for l in cfg.scene.layers for e in l.entries]
        self.det_crystal_count = sum(c.shape.is_deterministic() for c in entries)
        self.det_orientation_count = sum(c.axis.is_deterministic() for c in entries)
        self.any_pyramid = any(isinstance(c.shape, PyramidShape) for c in entries)

    def _build_wavelengths(self) -> None:
        light = self.cfg.light
        if light.illuminant is not None:
            self.wl_mode = "illuminant"
            self.illuminant = light.illuminant
            self.wl_values = self.wl_weights = None
            k_pool = int(env_knobs.get("IHT_WL_POOL", 64))
            k_pool = 1 << max(0, k_pool.bit_length() - 1)
        else:
            self.wl_mode = "discrete"
            self.wl_values = np.asarray([w.wl for w in light.spectrum], np.float32)
            self.wl_weights = np.asarray([w.weight for w in light.spectrum], np.float32)
            n_wl = len(self.wl_values)
            k_pool = 1 << (n_wl - 1).bit_length() if n_wl > 1 else 1
        p_max = max((r.resolution[0] * r.resolution[1] for r in self.cfg.renders),
                    default=1)
        while k_pool > 1 and not accum_mod.spectral_key_bits(p_max, k_pool):
            k_pool //= 2
        self.k_pool = k_pool
        self.spectral_ok = accum_mod.spectral_key_bits(p_max, k_pool) and (
            self.wl_mode == "illuminant" or len(self.wl_values) <= k_pool
        )
        pool_wl = self._wl_from_idx(torch.arange(k_pool))
        self.spd_table = (color.illuminant_spd_fast(self.illuminant, pool_wl)
                          if self.wl_mode == "illuminant" else None)
        self.basis_tbl = color.cmf_eval(pool_wl).to(self.device)

    def _wl_from_idx(self, wl_idx):
        """Wavelength of pool entry wl_idx (host, float32)."""
        if self.wl_mode == "discrete":
            # Pool entries past the table clamp to its last wavelength, as
            # the JAX gather does (only a refused, non-power-of-two table
            # has them).
            n = len(self.wl_values)
            return torch.as_tensor(self.wl_values)[torch.clamp(wl_idx.long(), max=n - 1)]
        k = float(np.float32(400.0 / self.k_pool))
        return 380.0 + (wl_idx.to(F32) + 0.5) * k

    def _build_renders(self) -> None:
        self.proj_plans = [projection.make_proj_plan(r) for r in self.cfg.renders]

    def reset(self) -> None:
        self.accum = [
            torch.zeros((p.height * p.width, 3), dtype=F32, device=self.device)
            for p in self.proj_plans
        ] + [torch.zeros(len(self.proj_plans), dtype=F32, device=self.device)]
        self.stats = Stats(
            deterministic_crystal_count=self.det_crystal_count,
            deterministic_orientation_count=self.det_orientation_count,
        )
        self.batch_counter = 0
        self._pending_dropped = []
        self._pending_segments = []

    # ------------------------------------------------------------------
    # Attribution
    # ------------------------------------------------------------------

    @property
    def trace_path(self) -> str:
        """'cuda-trace-kernel' or 'plain-torch'."""
        return "cuda-trace-kernel" if self.ks.name == "cuda" else "plain-torch"

    @property
    def fold_kind(self) -> str:
        return "sort"

    # ------------------------------------------------------------------
    # Batch step
    # ------------------------------------------------------------------

    def _sample_layer_pool(self, batch_counter: int, device=None) -> trace.GeomPool:
        """The first layer's K-shape geometry pool of one batch (plain torch
        on `device`; the JAX package samples it in XLA, outside any kernel).

        The shape index is 64 bits wide: batch_counter * k_total passes
        2^32 within a long render, and its high word is mixed into the seed
        as the ray-base epoch is."""
        plan = self.layer0
        device = self.device if device is None else device
        seed0 = self.seed ^ rng.NONCE_GEOM_SHAPE
        kb = (int(batch_counter) & MASK32) * sum(plan.k_per_setting)
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

    def _pool_tables(self, batch_counter: int):
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

    def _step_kernel_impl(self, base_lo: int, base_hi: int, n_active: int,
                          keep) -> list:
        """One batch through trace_emit and the fold; returns the live row
        count per render (host ints when keep is set, else tensors)."""
        tables = self._pool_tables(self.batch_counter) if self._trace_plan.pool_k else ()
        per_render, landed_add, dropped, segs = self.ks.trace_emit(
            self._trace_plan, base_lo, base_hi, n_active, self.device, *tables
        )
        self.accum[-1] = self.accum[-1] + landed_add
        self._pending_dropped.append(dropped)
        self._pending_segments.append(segs)
        k_pool = self.k_pool
        shift = accum_mod.key_shift(k_pool)
        lives = []
        for r, (keys, wvals, counts) in enumerate(per_render):
            _g, blk = keys.shape
            live = counts.to(I64).sum()
            kr = keep[r] if keep is not None else None
            acc = self.accum[r]
            if kr is None:
                self.accum[r] = accum_mod.fold_spectral_keys(
                    acc, keys.reshape(-1), wvals.reshape(-1), k_pool,
                    self.basis_tbl, self.ks,
                )
                lives.append(live)
                continue
            live_host = int(live)
            self.host_syncs += 1
            lives.append(live_host)
            if live_host > kr:
                self.accum[r] = accum_mod.fold_spectral_keys(
                    acc, keys.reshape(-1), wvals.reshape(-1), k_pool,
                    self.basis_tbl, self.ks,
                )
                continue
            P = acc.shape[0]
            block = accum_mod.BLOCK
            out_total = -(-(kr + P) // block) * block
            start = torch.cumsum(counts.to(I64), 0) - counts.to(I64)
            ck, cw = self.ks.scatter_blocks_multi(
                [keys, wvals], start.to(I32), out_total, blk,
                marker_tail=(kr, P, shift, 2 * k_pool - 1),
            )
            self.accum[r] = accum_mod.fold_spectral_keys_premerged(
                acc, ck, cw, k_pool, self.basis_tbl, self.ks
            )
        return lives

    def run(self, total_rays: Optional[int] = None,
            n_batches: Optional[int] = None) -> Stats:
        """Trace `n_batches` batches, or `total_rays` rays exactly (the last
        batch traces only the remainder lanes), default the scene's
        ray_num."""
        tail = 0
        if n_batches is None:
            total = int(total_rays if total_rays is not None else self.cfg.scene.ray_num)
            n_batches = max(1, -(-total // self.batch_size))
            tail = total - (n_batches - 1) * self.batch_size
            if tail == self.batch_size or n_batches * self.batch_size == total:
                tail = 0
            rays_requested = total
        else:
            rays_requested = n_batches * self.batch_size
        stride = self.batch_size * LAYER_STRIDE
        for i in range(n_batches):
            is_tail = bool(tail) and i == n_batches - 1
            base = self.batch_counter * stride
            lives = self._step_kernel_impl(
                base & 0xFFFFFFFF, (base >> 32) & 0xFFFFFFFF,
                tail if is_tail else self.batch_size, self._compact_keep,
            )
            self.batch_counter += 1
            if not self._calibrated and not is_tail:
                self._maybe_calibrate(lives)
        self.stats = self.stats._replace(
            rays_traced=self.stats.rays_traced + rays_requested,
            stochastic_crystal_samples=self.stats.stochastic_crystal_samples
            + n_batches * sum(
                k for k, det in zip(self.layer0.k_per_setting,
                                    self.layer0.deterministic_shape) if not det),
            stochastic_orientation_samples=self.stats.stochastic_orientation_samples
            + n_batches * sum(
                c for c, det in zip(self.layer0.setting_counts,
                                    self.layer0.deterministic_axis) if not det),
        )
        return self.stats

    def _maybe_calibrate(self, lives) -> None:
        """keep per render from the first batch's live rows (one host read);
        None where compaction would not shorten the fold enough."""
        self._calibrated = True
        self.host_syncs += 1
        if not self._compact_enabled:
            return
        block = accum_mod.BLOCK
        G = self._trace_plan.n_blocks
        keep = []
        for r, live in enumerate(lives):
            n_rows = G * self._trace_plan.rows_block[r]
            target = int(np.ceil(int(live) * self._KEEP_MARGIN / block)) * block
            if n_rows >= 2 * block and target <= 0.6 * n_rows:
                keep.append(max(block, target))
            else:
                keep.append(None)
        self._compact_keep = tuple(keep) if any(k is not None for k in keep) else None

    # ------------------------------------------------------------------
    # Host readout
    # ------------------------------------------------------------------

    def drain_stats(self) -> Stats:
        """Fold pending device-side counters into stats (one sync)."""
        if self._pending_dropped:
            total = float(torch.stack(self._pending_dropped).to(torch.float64).sum())
            self._pending_dropped = []
            self.stats = self.stats._replace(
                dropped_cont_weight=self.stats.dropped_cont_weight + total
            )
        if self._pending_segments:
            segs = int(torch.stack(self._pending_segments).sum())
            self._pending_segments = []
            self.stats = self.stats._replace(
                ray_segments=self.stats.ray_segments + segs
            )
        self.stats = self.stats._replace(
            landed_weight=float(self.accum[-1].to(torch.float64).sum())
        )
        return self.stats

    def raw_xyz(self, render_idx: int = 0) -> np.ndarray:
        p = self.proj_plans[render_idx]
        return self.accum[render_idx].cpu().numpy().reshape(p.height, p.width, 3)

    def snapshot(self):
        """uint8 sRGB image per render."""
        landed = self.accum[-1].cpu().numpy()
        images = []
        for r, (pplan, rcfg) in enumerate(zip(self.proj_plans, self.cfg.renders)):
            images.append(color.post_process(
                self.raw_xyz(r), rcfg.intensity_factor, float(landed[r]),
                rcfg.background, rcfg.ray_color,
                use_real_color=rcfg.ray_color[0] < 0,
            ))
        return images

    def plan_arrays(self) -> dict:
        """The static tables as numpy, for comparison with the JAX engine:
        face planes, entry tris, SPD pool, CIE basis table, axis LUT and the
        projection plan of each render."""
        tp = self._trace_plan
        out = {
            "planes": tp.planes.copy(),
            "tris": tp.tris.copy(),
            "spd": tp.spd.copy(),
            "basis_tbl": self.basis_tbl.cpu().numpy(),
            "lut_theta": np.asarray(self.axis_params.lut_theta[0]),
            "lut_cdf": np.asarray(self.axis_params.lut_cdf[0]),
            "lut_flip": np.asarray(self.axis_params.lut_flip[0]),
            "w_scale": np.float64(tp.w_scale),
        }
        for r, pp in enumerate(self.proj_plans):
            out[f"proj_{r}"] = np.array(
                [pp.lens_type, pp.width, pp.height, pp.scale, pp.r_scale,
                 pp.max_abs_dz], np.float64,
            )
            out[f"proj_rot_{r}"] = np.asarray(pp.rot)
        return out
