"""The port's engine: host loop over batches on one torch device (port of
``ice_halo_sim_tpu.engine.simulator.Engine``).

A scene takes one of two trace paths, as in the JAX engine:
  - the trace kernel (K2 or K2b, + K1) when ``trace_emit.refusal_reason`` is
    None: one layer, one crystal setting, no filter, no colour class, a lens
    the kernel takes. One batch = [the K-shape pool sampler, for a
    stochastic shape] -> trace_emit -> per render the sort fold; after
    calibration the block scatter (K3) with the marker tail feeds the
    premerged fold;
  - the general path otherwise, or when IHT_PALLAS_TRACE is 0/off: every
    layer's pool sampler in plain torch on the device and its trace
    ``ks.trace_layer`` (KL, one launch a layer, on the CUDA kernel set;
    ``trace_soa.trace_layer_soa`` on the plain one: both are XLA, not
    Pallas, in the JAX package), its epilogue ``trace_soa.layer_epilogue``
    (the filter, probability and emit-floor gates, colour bits, the slot
    cap, projection into every render) -- both in KL's emit mode
    (``ks.trace_layer_emit``) where ``_epilogue_reason`` finds none -- the
    continuation between layers, then per render
    ``pack_spectral_keys`` and the sort fold; after calibration
    ``accum.compact_valid`` (one pass of ``block_ops.compact_rows``) shortens
    the rows to ``keep`` first.
``Engine.trace_path`` says which one ran, ``Engine.fold_kind`` and
``Engine.fold_decision`` which fold: the sort fold on both paths, or, for
keys that do not pack into 32 bits, the dense-value fold
``accum.sort_accumulate`` (``sort-legacy``). The two trace paths differ on
purpose, as in the JAX package: the emit-floor scale is analytic on the
kernel path and the batch mean of the initial weights on the general path,
and only the general path has a slot cap. With IHT_MIN_EMIT_W=0 and
IHT_SLOT_CAP=off they give the same image.

The host loop is the JAX engine's: ``run`` runs IHT_STEPS_PER_DISPATCH
batches (default 64) per dispatch, full batches first and an exact-budget
tail batch alone. The batch counter lives on the device (``self._dev``) and
every batch derives its ray base, the pool sampler's shape index and the
continuation's shuffle salt from it there; the accumulators and the running
sums (dropped weight, segments, live rows, continuation demand, slot mass)
are updated in place. Calibration after the first dispatch (one host read):
the exit-slot cap from the per-rank mass histogram, the continuation
capacities from the mean demand, and ``keep`` per render = the mean live
rows times _KEEP_MARGIN rounded up to the 4096-row block. On a CUDA device
with the CUDA kernels a steady batch is replayed from a CUDA graph
(engine/graph.py, ``graphs=``).

The in-step overflow choice (JAX: ``lax.cond`` on live <= keep per render,
and on the continuation's live count per layer boundary) is made without a
host read inside the dispatch: a batch of a dispatch always takes the
compacted branch and records on the device the first batch whose live rows
overflowed. After the dispatch the engine reads that one index
(``host_syncs``); if a batch overflowed it restores the accumulators and
sums from a snapshot taken before the dispatch, runs the batches before it
again, runs the overflowing batch eagerly with host reads (the full fold,
the global continuation sort) and goes on after it (``overflow_replays``).
The image equals a per-batch choice in batch order, bit for bit. A
dispatch is a launch part (``_launch``: a prologue with the snapshot, the
batches one ``_step`` each, an epilogue) and a read part (``_read``: that
one read and the replay), so a data-parallel run (parallel/sharding.py)
queues batch i of every shard before batch i + 1 and reads after them all.
An engine is one shard ``(index, count)`` of such a run (default (0, 1)):
its batch c traces the rays from (c * count + index) * span on, and samples
the crystal shapes and the continuation salt of the plain counter c.

Differences from the JAX engine, all deliberate:
  - no silent degrade: a failing kernel raises, the engine never moves to
    another device or path;
  - the overflow choice is the replay above, not a branch inside the
    step (JAX: ``lax.cond``);
  - the sort-size snap of ``keep``, tuned to another accelerator's memory,
    is gone;
  - the JAX engine's sandwich cascade and its choice between folds are not
    carried over: on the H100 the cascade never beat the sort fold by more
    than its spread. Its kernels stay in core/sandwich.py, held by the
    tests, on no path of the engine;
  - the continuation's order inside a block is a function of the rows (the
    JAX block sort is unstable), so the CPU and the card agree with each
    other; against JAX a multi-layer image agrees statistically, not ray
    for ray.
"""

from __future__ import annotations

import zlib
from typing import NamedTuple, Optional

import numpy as np
import torch

from ice_halo_sim_tpu_torch.config.schema import (
    FilterAction,
    FilterConfig,
    NoneFilter,
    PrismShape,
    ProjectConfig,
    PyramidShape,
    RaypathFilter,
    sync_group_leaders,
)
from ice_halo_sim_tpu_torch.core import latlut
from ice_halo_sim_tpu_torch.utils import env_knobs
from ice_halo_sim_tpu_torch.core import accum as accum_mod
from ice_halo_sim_tpu_torch.core import (
    color,
    filters,
    geometry,
    optics,
    projection,
    pyramid,
    rng,
    sampling,
    trace,
    trace_emit,
    trace_soa,
)
from ice_halo_sim_tpu_torch.core.bits import F32, I32, I64, MASK32, const, from_bits, to_bits
from ice_halo_sim_tpu_torch.engine import graph as graph_mod
from ice_halo_sim_tpu_torch.kernels import kernel_set
from ice_halo_sim_tpu_torch.utils import profiling

DEFAULT_BATCH = 1 << 17
DEFAULT_GEOM_CLOCK = 32
# Component-mask bit budget of the colour classes; predicates past it stop
# producing bits (colouring degrades, the commit does not fail).
COLOR_PREDICATE_CAP = 32
LAYER_NONCE = 0xA5A5
DIGEST_LEN = 64          # entries of Engine._calibration_digest


def _or(a, b):
    """a | b for optional device bools (None: no flag)."""
    return b if a is None else a if b is None else a | b


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
    filter_plans: list          # per setting Optional[filters.FilterPlan]
    color_plans: list           # per setting [(bit index, filters.FilterPlan)]
    crystal_ids: list           # per setting crystal id of the config
    cont_cap: int               # lanes of the continuation buffer feeding this layer


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


def weight_bucket(w):
    """clip(floor(log2(max(w, 1e-30))) + 130, 2, 255) of float32 weights, as
    int64: the continuation's weight bucket. floor(log2) of a positive
    normal float32 is its exponent field less 127, so this is an integer
    stage with no transcendental in it, the same on every device. (A log2
    rounded to float32 gives the integer above for the last float32 below a
    power of two; the exponent field gives the exact floor there.)"""
    bits = torch.clamp_min(w, 1e-30).contiguous().view(I32).to(I64)
    return torch.clamp(((bits >> 23) & 0xFF) - 127 + 130, 2, 255)


def shuffle_hash(n_rows: int, layer_seed: int, batch_counter, device):
    """The continuation's per-row hash: fresh per layer and per batch.
    batch_counter: a python int or an int64 tensor (the engine's, on the
    device)."""
    salt = rng.pcg_hash(rng._t(batch_counter) & MASK32) ^ (
        (int(layer_seed) ^ rng.NONCE_SHUFFLE) & MASK32)
    return rng.pcg_hash(torch.arange(n_rows, dtype=I64, device=device) ^ salt)


class DeviceState(NamedTuple):
    """What the batches of a dispatch carry on the device (the JAX carry):
    the batch counter, then the running sums that stats and calibration
    read, and the first overflowing batch of the dispatch (-1: none)."""

    counter: torch.Tensor     # int64 []
    dropped: torch.Tensor     # float64 []: dropped continuation weight
    segs: torch.Tensor        # int64 []: traced segments
    live: torch.Tensor        # int64 [R]: live fold rows per render
    cont: torch.Tensor        # int64 [layers - 1]: live continuation rows
    slot_mass: torch.Tensor   # float32 [max_hits]: calibration histogram
    first_over: torch.Tensor  # int64 []: batch counter of the first overflow
    lanes: torch.Tensor       # int64 [layers - 1]: continuation lanes, added while traced


class Engine:
    """Commit a config, pump batches, snapshot images.

    device: the torch device everything lives on (default "cuda").
    geom_clock: rays per sampled crystal shape; on the kernel path a
    stochastic shape needs 128 (one shape per 128-thread block of the trace
    kernel), and the default is raised to that.
    kernels: "cuda" (the CUDA kernels; the default on a CUDA device) or
    "plain" (the plain PyTorch versions; the only choice on the CPU).
    accum_method: "sort" (the default on every device) or "scatter"
    (index_add_, the oracle of the tests; general path only).
    graphs: replay each steady batch from a CUDA graph (engine/graph.py).
    None: on for a CUDA device with the CUDA kernels, off otherwise (the
    plain twins have data-dependent shapes and do not capture). Without
    graphs the same dispatch loop runs each batch eagerly. The calibrating
    dispatch, and batches that cannot be captured (a dense-value fold), run
    eagerly; ``graph_mode`` says which.
    shard: (index, count) of a data-parallel run (parallel/sharding.py):
    the shard traces its own rays of every batch (``ray_base``) and the
    same crystal shapes and continuation salt as every other shard; (0, 1)
    is the whole stream.
    """

    _KEEP_MARGIN = 1.06

    @profiling.setup_span("iht.setup.engine")
    def __init__(self, cfg: ProjectConfig, seed: int = 1,
                 batch_size: int = DEFAULT_BATCH, device="cuda",
                 kernels: Optional[str] = None,
                 geom_clock: int = DEFAULT_GEOM_CLOCK,
                 accum_method: str = "sort", graphs: Optional[bool] = None,
                 shard: tuple = (0, 1)):
        self.cfg = cfg
        self.shard = shard
        self.seed = int(seed) & 0xFFFFFFFF
        self.batch_size = int(batch_size)
        self.geom_clock = int(geom_clock)
        self.device = torch.device(device)
        if kernels is None:
            kernels = "cuda" if self.device.type == "cuda" else "plain"
        if kernels == "cuda" and self.device.type != "cuda":
            raise ValueError("kernels='cuda' needs a CUDA device; use kernels='plain'")
        if accum_method not in ("sort", "scatter"):
            raise ValueError(f"accum_method must be 'sort' or 'scatter', got {accum_method!r}")
        self.accum_method = accum_method
        self.ks = kernel_set(kernels)
        if graphs is None:
            graphs = self.ks.name == "cuda"
        if graphs and self.ks.name != "cuda":
            raise ValueError("graphs=True needs a CUDA device and the CUDA kernels")
        self.graphs = bool(graphs)
        self.steps_per_dispatch = max(1, int(env_knobs.get("IHT_STEPS_PER_DISPATCH", 64)))
        # Batches that overflowed a compacted branch inside a dispatch and
        # were run again eagerly (the replay of the in-step choice).
        self.overflow_replays = 0
        self.min_emit_frac = float(env_knobs.get("IHT_MIN_EMIT_W", 1e-3))
        self.emit_floor_mode = str(env_knobs.get("IHT_EMIT_FLOOR", "rr")).lower()
        self._compact_enabled = str(env_knobs.get("IHT_COMPACT", "1")) not in (
            "0", "off", "false",
        )
        self._build_plan()
        self._build_wavelengths()
        self._build_renders()
        # Exit-slot cap of the general path. None = calibrating: the first
        # batch measures the per-live-rank mass histogram and the smallest
        # cap whose dropped tail is under 1e-4 of the emitted mass is taken.
        # IHT_SLOT_CAP: "off" disables, an int pins it.
        cap_knob = env_knobs.get("IHT_SLOT_CAP")
        if cap_knob is None or str(cap_knob) == "auto":
            self._slot_cap = None
        elif str(cap_knob).lower() in ("off", "0"):
            self._slot_cap = self.max_hits
        else:
            self._slot_cap = max(1, min(self.max_hits, int(cap_knob)))
        self._choose_trace_path()
        self._recompute_rows_per_render()
        self._compact_keep = None
        self._calibrated = False
        self.host_syncs = 0
        # Stage marks (utils/profiling.py, the tracer on): of the last batch
        # run, and of the batch the current graph replays.
        self._marks = self._graph_marks = None
        # Per layer, the epilogue the last general-path batch took: "kernel"
        # (KL's emit mode) or "plain: <first reason>" (_epilogue_reason).
        self.layer_epilogue = [None] * len(self.layers)
        self.reset()

    def _choose_trace_path(self) -> None:
        """The trace kernel when it takes the scene, the general path
        otherwise; IHT_PALLAS_TRACE=0 (or off) forces the general path."""
        self._trace_plan = None
        if str(env_knobs.get("IHT_PALLAS_TRACE", "auto")).lower() in ("0", "off"):
            self._kernel_reason = "trace kernel switched off (IHT_PALLAS_TRACE)"
            return
        if self.accum_method != "sort":
            self._kernel_reason = "needs the sort fold with packable spectral keys"
            return
        reason = trace_emit.refusal_reason(self)
        if (reason is not None and reason.startswith("stochastic crystal")
                and self.geom_clock == DEFAULT_GEOM_CLOCK):
            # The blocked-pool trace mode needs one shape per 128 rays;
            # geom_clock is a sharing granularity that does not change the
            # image's expectation, so the default moves. A pinned value is
            # respected (the scene then takes the general path).
            self.geom_clock = trace_emit.POOL_GEOM_CLOCK
            self._build_plan()
            reason = trace_emit.refusal_reason(self)
        self._kernel_reason = reason
        if reason is None:
            self._trace_plan = trace_emit.build_plan(self)
            # The kernel keeps every live exit row: no slot cap there.
            self._slot_cap = self.max_hits

    # ------------------------------------------------------------------
    # Plan build (host)
    # ------------------------------------------------------------------

    def _build_color_bits(self):
        """One component bit per raypath-colour predicate, with its match
        plan. Returns ({(layer, crystal_id): [(bit, plan)]}, [(class mask,
        combine_all)]). Predicates past COLOR_PREDICATE_CAP produce no bit
        and are counted in color_overflow_count."""
        by_placement = {}
        class_defs = []
        bit = 0
        self.color_overflow_count = 0
        rc = self.cfg.raypath_color
        if rc is None:
            return by_placement, class_defs
        for cls in rc.classes:
            mask = 0
            for pred in cls.predicates:
                if bit >= COLOR_PREDICATE_CAP:
                    self.color_overflow_count += 1
                    continue
                crystal = self.cfg.crystals[pred.crystal_id]
                param = RaypathFilter(raypath=pred.raypath) if pred.raypath else NoneFilter()
                plan = filters.build_filter_plan(
                    FilterConfig(id=0, param=param, symmetry=pred.symmetry,
                                 action=FilterAction.FILTER_IN),
                    crystal.axis, self.cfg.filters, pred.crystal_id,
                )
                by_placement.setdefault((pred.layer, pred.crystal_id), []).append((bit, plan))
                mask |= 1 << bit
                bit += 1
            class_defs.append((mask, cls.combine_all))
        return by_placement, class_defs

    def _build_plan(self, cont_caps=None) -> None:
        """Per-layer plans and the two-rule stats constants. cont_caps:
        optional per-layer lane counts (index >= 1) that override the
        continuation-capacity heuristic (the calibrated path)."""
        cfg = self.cfg
        self.max_hits = int(cfg.scene.max_hits)
        color_by_placement, self.color_classes = self._build_color_bits()
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
                if cont_caps is not None and cont_caps[li] is not None:
                    b_layer = min(b_layer, max(int(cont_caps[li]), 1024))
                b_layer = -(-b_layer // (256 * g)) * (256 * g)
            blocks = largest_remainder_partition(
                b_layer // g, [e.proportion for e in ms.entries])
            counts = [b * g for b in blocks]
            axes, kinds, params, det_shape, det_axis = [], [], [], [], []
            filter_plans, color_plans, crystal_ids = [], [], []
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
                filter_plans.append(
                    None if e.filter_id == 0 else filters.build_filter_plan(
                        cfg.filters[e.filter_id], crystal.axis, cfg.filters, e.crystal_id))
                color_plans.append(color_by_placement.get((li, e.crystal_id), []))
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
                filter_plans=filter_plans, color_plans=color_plans,
                crystal_ids=crystal_ids, cont_cap=b_layer,
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

    def _wavelength_draw(self, ray_idx, seed_vec):
        """Per-ray (wavelength, initial weight, pool index). Discrete
        spectra cycle through their table by ray index; an illuminant draws
        a continuous wavelength for the physics, and its pool stratum
        quantises only the SPD weight and the fold's CIE basis."""
        if self.wl_mode == "discrete":
            wl_idx = ray_idx % len(self.wl_values)
            return self._wl_tbl[wl_idx], self._w0_tbl[wl_idx], wl_idx
        seed = seed_vec ^ rng.NONCE_WL ^ 0x6A09E667
        u = rng.uniform(seed, ray_idx, 0)
        wl = 380.0 + u * 400.0
        wl_idx = torch.clamp_max((u * self.k_pool).to(I32), self.k_pool - 1).to(I64)
        return wl, self._w0_tbl[wl_idx], wl_idx

    def _build_renders(self) -> None:
        self.proj_plans = [projection.make_proj_plan(r) for r in self.cfg.renders]

    def _recompute_rows_per_render(self) -> None:
        """Contribution rows per render and batch (static)."""
        if self._trace_plan is not None:
            g = self._trace_plan.n_blocks
            self._rows_per_render = [g * rb for rb in self._trace_plan.rows_block]
            return
        cap = min(self._slot_cap if self._slot_cap is not None else self.max_hits,
                  self.max_hits)
        self._rows_per_render = [
            sum(plan.cont_cap * cap for plan in self.layers)
            * (2 if p.max_abs_dz > 0.0 else 1)
            for p in self.proj_plans
        ]

    def reset(self) -> None:
        """One accumulator per render, [H*W, 3 + n_classes] (XYZ plus one Y
        lane per colour class), then the [R] landed weights."""
        dev = self.device
        n_ch = 3 + len(self.color_classes)
        self.accum = [
            torch.zeros((p.height * p.width, n_ch), dtype=F32, device=dev)
            for p in self.proj_plans
        ]
        self.accum.append(torch.zeros(len(self.proj_plans), dtype=F32, device=dev))
        self.stats = Stats(
            deterministic_crystal_count=self.det_crystal_count,
            deterministic_orientation_count=self.det_orientation_count,
        )
        # The host's count of the batches it launched; the device counter is
        # set from it at the start of every dispatch and never read back.
        self.batch_counter = 0
        self._dev = DeviceState(
            counter=torch.zeros((), dtype=I64, device=dev),
            dropped=torch.zeros((), dtype=torch.float64, device=dev),
            segs=torch.zeros((), dtype=I64, device=dev),
            live=torch.zeros(len(self.proj_plans), dtype=I64, device=dev),
            cont=torch.zeros(max(0, len(self.layers) - 1), dtype=I64, device=dev),
            slot_mass=torch.zeros(self.max_hits, dtype=F32, device=dev),
            first_over=torch.full((), -1, dtype=I64, device=dev),
            lanes=torch.zeros(max(0, len(self.layers) - 1), dtype=I64, device=dev),
        )
        self._graph = None
        self._snap = None
        self._pending = None

    # ------------------------------------------------------------------
    # Attribution
    # ------------------------------------------------------------------

    @property
    def trace_path(self) -> str:
        """'cuda-trace-kernel', 'general', or 'plain-torch' with the path
        named when the plain kernel set runs."""
        path = "trace-kernel" if self._trace_plan is not None else "general"
        if self.ks.name == "cuda":
            return "cuda-trace-kernel" if path == "trace-kernel" else "general"
        return "plain-torch" if path == "trace-kernel" else "plain-torch (general)"

    @property
    def fold_kind(self) -> str:
        """The fold this engine runs: 'sort', 'scatter', or 'sort-legacy'
        when the sort fold was asked for and the (pixel, wavelength) keys do
        not pack into 32 bits."""
        if self.accum_method == "sort" and not self.spectral_ok:
            return "sort-legacy"
        return self.accum_method

    @property
    def fold_decision(self) -> str:
        """Why the engine folds as ``fold_kind`` says."""
        method = self.fold_kind
        if method == "sort-legacy":
            return "sort-legacy: (pixel, wavelength) keys do not pack into 32 bits"
        if method != "sort":
            return f"accum method {method!r}"
        if self._trace_plan is not None:
            return "sort fold: the trace kernel emits packed sort keys"
        return "sort fold"

    # ------------------------------------------------------------------
    # Pool sampler
    # ------------------------------------------------------------------

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

    # ------------------------------------------------------------------
    # General trace path
    # ------------------------------------------------------------------

    def _segment_masks(self, plan: LayerPlan, per_setting, H: int):
        """Concatenate one [H, count_s] tensor per non-empty setting."""
        parts = []
        off = 0
        for s, c in enumerate(plan.setting_counts):
            if c == 0:
                continue
            parts.append(per_setting(s, slice(off, off + c), c))
            off += c
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)

    def _ray_base_words(self, batch_counter):
        """(low, high) u32 words of the batch's 64-bit ray base: python ints
        for a python counter, int64 tensors on its device for a tensor."""
        index, count = self.shard
        base = (batch_counter * count + index) * self.span
        return base & MASK32, (base >> 32) & MASK32

    def _epilogue_reason(self, plan: LayerPlan) -> Optional[str]:
        """Why layer `plan` takes the plain epilogue after its trace
        (trace_soa.layer_epilogue) rather than KL's emit mode, or None (the
        emit mode; its plain twin on the "plain" kernel set): the
        calibrating batch measures the slot mass, and the kernel has no
        raypath filter, no colour bits, no lens with inverse trig and at most
        four renders."""
        if self._slot_cap is None:
            return "calibrating"
        if any(fp is not None for fp in plan.filter_plans):
            return "filter"
        if self.color_classes:
            return "colour"
        return trace_soa.emit_refusal(self.proj_plans)

    def _plain_epilogue(self, plan: LayerPlan, exits, spec, layer_seed_vec, ray_idx,
                        w_scale, carried_mask):
        """trace_soa.layer_epilogue of one layer's exits with the layer's
        raypath filters and colour predicates, matched per setting on each
        exit's path."""
        H = exits.w.shape[0]

        def check(fplan, sl, live_slots):
            return filters.check_exits_prefix_soa(
                fplan, exits.path[:, sl], live_slots[:, sl],
                (exits.dx[:, sl], exits.dy[:, sl], exits.dz[:, sl]))

        filter_gate = color_bits = None
        if any(fp is not None for fp in plan.filter_plans):
            def filter_gate(live_slots):
                def verdict(s, sl, c):
                    fp = plan.filter_plans[s]
                    if fp is None:
                        return torch.ones((H, c), dtype=torch.bool, device=self.device)
                    return check(fp, sl, live_slots)
                return self._segment_masks(plan, verdict, H)
        if self.color_classes and any(plan.color_plans):
            def color_bits(live_slots):
                def bits_of(s, sl, c):
                    bits = torch.zeros((H, c), dtype=I64, device=self.device)
                    for bit_idx, cplan in plan.color_plans[s]:
                        bits = bits | torch.where(check(cplan, sl, live_slots), 1 << bit_idx, 0)
                    return bits
                return self._segment_masks(plan, bits_of, H)
        return trace_soa.layer_epilogue(
            exits, layer_seed_vec, ray_idx, w_scale, spec, filter_gate=filter_gate,
            color_bits=color_bits, carried_mask=carried_mask if self.color_classes else None)

    def _trace_batch_impl(self, batch_counter, n_active: Optional[int] = None,
                          host_choice: bool = False):
        """One batch through every layer: sample -> trace -> gates ->
        project. batch_counter: a python int or the engine's counter tensor.
        Returns (contribs, landed_add [R], dropped_w, seg_count, cont_demand,
        slot_mass, overflow); contribs holds per render the spectral
        contribution rows (pix int32, w, wl_idx, mask), cont_demand the live
        continuation count of every layer boundary (device tensors), and
        overflow a device bool (None for one layer): some boundary's live
        rows exceeded its lanes. host_choice: read each boundary's count and
        take the global sort where it overflows; else always the block
        compaction (exact when overflow is False). Lanes >= n_active start
        with zero weight (the exact-budget tail batch). With the tracer on
        (utils/profiling.py) layer li is the stage ``layer_trace.<li>`` (its
        ray draws, pool sampler, trace, gates and projection) and an
        ``iht.layer`` span, the continuation into it ``continuation.<li>``."""
        dev = self.device
        B = self.batch_size
        H = self.max_hits
        profiling.stage("layer_trace.0")
        base_lo, base_hi = self._ray_base_words(batch_counter)
        seed0 = self.seed
        lane = torch.arange(B, dtype=I64, device=dev)
        ray_idx = (base_lo + lane) & MASK32
        seed_vec = rng.epoch_seed(seed0, base_lo, base_hi, ray_idx)
        wl, w0, wl_idx = self._wavelength_draw(ray_idx, seed_vec)
        # Emit-floor scale of the general path: the batch's mean initial
        # weight (the kernel path takes the analytic mean of the table).
        w_scale = torch.mean(w0)
        if n_active is not None:
            w0 = torch.where(lane < int(n_active), w0, 0.0)
        n_ior = optics.ice_refractive_index(wl)
        sun = self.cfg.light.sun
        d_world = sampling.sample_sun_dirs_soa(
            seed_vec ^ rng.NONCE_SUN, ray_idx, sun.azimuth, sun.altitude, sun.diameter)

        n_renders = len(self.proj_plans)
        n_classes = len(self.color_classes)
        contrib_rows = [[] for _ in range(n_renders)]
        landed_add = [torch.zeros((), dtype=F32, device=dev) for _ in range(n_renders)]
        dropped_w = torch.zeros((), dtype=F32, device=dev)
        carried_mask = torch.zeros(B, dtype=I64, device=dev)
        seg_count = torch.zeros((), dtype=I64, device=dev)
        slot_mass = torch.zeros(H, dtype=F32, device=dev)
        cont_demand = []
        overflow = None
        n_layers = len(self.layers)
        for li, plan in enumerate(self.layers):
            with profiling.span("iht.layer"):
                layer_nonce = (LAYER_NONCE * (li + 1)) & MASK32
                layer_seed = seed0 ^ layer_nonce          # scalar: the shuffle hash
                pool = self._sample_layer_pool(batch_counter, li=li)
                layer_seed_vec = seed_vec ^ layer_nonce

                # Orientation: one contiguous segment of lanes per setting.
                rot_parts = []
                off = 0
                for s, c in enumerate(plan.setting_counts):
                    if c == 0:
                        continue
                    rot_parts.append(sampling.sample_rot_row(
                        layer_seed_vec[off:off + c] ^ rng.NONCE_ORIENT,
                        ray_idx[off:off + c], plan.axis_params, s, lut_loop=True))
                    off += c
                rot = tuple(rot_parts[0][i] if len(rot_parts) == 1
                            else torch.cat([p[i] for p in rot_parts]) for i in range(9))

                is_last = li == n_layers - 1
                spec = trace_soa.EmitSpec(
                    prob=plan.prob, last=is_last, emit_frac=self.min_emit_frac,
                    rr=self.emit_floor_mode == "rr", cap=self._slot_cap,
                    renders=tuple(self.proj_plans))
                args = (layer_seed_vec, ray_idx, d_world, w0, rot, pool, n_ior, H)
                blocks = tuple(zip(plan.k_per_setting, plan.setting_counts))
                reason = self._epilogue_reason(plan)
                self.layer_epilogue[li] = "kernel" if reason is None else f"plain: {reason}"
                if reason is None:
                    # KL's emit mode: the trace and the epilogue in one launch.
                    rows = self.ks.trace_layer_emit(*args, setting_blocks=blocks,
                                                    w_scale=w_scale, spec=spec)
                else:
                    rows = self._plain_epilogue(
                        plan, self.ks.trace_layer(*args, setting_blocks=blocks), spec,
                        layer_seed_vec, ray_idx, w_scale, carried_mask)
                b_l = ray_idx.shape[0]
                seg_count = seg_count + rows.seg.sum()
                dropped_w = dropped_w + torch.sum(rows.dropped)
                if rows.slot_mass is not None:
                    slot_mass = slot_mass + rows.slot_mass
                n_rows = rows.w[0].shape[0]
                flat_idx = wl_idx[None, :].expand(n_rows, b_l).reshape(-1)
                flat_mask = (rows.mask.reshape(-1) if rows.mask is not None
                             else torch.zeros(n_rows * b_l, dtype=I64, device=dev))
                k = 0
                for r, pplan in enumerate(self.proj_plans):
                    # The main pass, then the overlap pass, whose writes do
                    # not enter the landed weight.
                    for p in range(2 if pplan.max_abs_dz > 0.0 else 1):
                        w_row = rows.w[k].reshape(-1)
                        contrib_rows[r].append(
                            (rows.pix[k].reshape(-1), w_row, flat_idx, flat_mask))
                        if p == 0:
                            landed_add[r] = landed_add[r] + torch.sum(w_row)
                        k += 1

            if not is_last:
                profiling.stage(f"continuation.{li + 1}")
                cap_next = self.layers[li + 1].cont_cap
                cont_w, cdx, cdy, cdz = rows.cont
                cont_w_all = cont_w.reshape(-1)
                # The columns come from the uncapped [H, B] exits: the slot
                # cap trims accumulation rows only.
                # (32-bit columns: the block scatter moves 32-bit payloads.)
                cols = [cont_w_all, wl_idx[None, :].expand(H, b_l).reshape(-1).to(I32)]
                if n_classes:
                    cols.append(to_bits(rows.exit_mask.reshape(-1)))
                cols += [cdx.reshape(-1), cdy.reshape(-1), cdz.reshape(-1)]
                picked, n_live = self._continuation(
                    cont_w_all, cols, cap_next, layer_seed, batch_counter, host_choice)
                cont_demand.append(n_live)
                o = n_live > min(cap_next, cont_w_all.shape[0])
                overflow = o if overflow is None else overflow | o
                s_w = picked[0]
                live = s_w > 0.0
                cont_wv = torch.where(live, s_w, 0.0)
                # Empty lanes keep pool entry 0 (any pool wavelength is
                # benign there: the weight is zero).
                wl_idx = torch.where(live, picked[1], 0).to(I64)
                carried_mask = (torch.where(live, from_bits(picked[2]), 0) if n_classes
                                else torch.zeros_like(wl_idx))
                d_world = tuple(torch.where(live, x, 0.0) for x in picked[-3:])
                dropped_w = dropped_w + torch.sum(cont_w_all) - torch.sum(cont_wv)
                profiling.stage(f"layer_trace.{li + 1}")
                w0 = cont_wv
                ray_idx = (base_lo + B * (li + 1)
                           + torch.arange(cap_next, dtype=I64, device=dev)) & MASK32
                seed_vec = rng.epoch_seed(seed0, base_lo, base_hi, ray_idx)
                n_ior = optics.ice_refractive_index(self._wl_from_idx(wl_idx))

        profiling.stage("rest")
        contribs = []
        for parts in contrib_rows:
            contribs.append(parts[0] if len(parts) == 1 else tuple(
                torch.cat([p[c] for p in parts]) for c in range(4)))
        return (contribs, torch.stack(landed_add), dropped_w, seg_count,
                cont_demand, slot_mass, overflow)

    def _continuation(self, cont_w_all, cols, cap: int, layer_seed: int,
                      batch_counter, host_choice: bool = True):
        """Compact the continuing exits of one layer into the next layer's
        `cap` lanes. Live rows key to (inverted weight bucket) << 23 | 23
        bits of a hash of the row, dead rows to 0xFFFFFFFF: a sort by that
        key puts heavier rows first and shuffles within a bucket, which
        decorrelates the ray -> crystal pairing of the next layer.

        When the live rows fit, each 4096-row block is sorted by the key and
        the blocks are packed (``accum.compact_by_key``). When they
        overflow, one global sort by the key keeps the heaviest rows; the
        lowest-weight rows are dropped (the caller accounts them). With
        host_choice the live count is read on the host, once, to choose;
        without, the block compaction runs whatever the count (it writes
        the first `cap` packed rows and nothing past them; the caller
        records the overflow and runs the batch again). Returns (columns
        [cap] without the key, live count as a device tensor)."""
        n_rows = cont_w_all.shape[0]
        dev = cont_w_all.device
        cont_live = cont_w_all > 0.0
        n_live = cont_live.sum()
        eff_cap = min(cap, n_rows)
        fits = True
        if host_choice:
            self.host_syncs += 1
            fits = int(n_live) <= eff_cap
        key = to_bits(torch.where(
            cont_live,
            ((255 - weight_bucket(cont_w_all)) << 23)
            | (shuffle_hash(n_rows, layer_seed, batch_counter, dev) & 0x7FFFFF),
            MASK32))
        if fits:
            outs, _ = accum_mod.compact_by_key(key, cols, eff_cap, self.ks, with_key=False)
            picked = list(outs)
        else:
            row = torch.arange(n_rows, dtype=I64, device=dev)
            s, _ = torch.sort(accum_mod._sort_word(from_bits(key), row))
            order = s[:eff_cap] & MASK32
            picked = [c[order] for c in cols]
        if eff_cap < cap:
            picked = [torch.cat([c, torch.zeros(cap - eff_cap, dtype=c.dtype, device=dev)])
                      for c in picked]
        return picked, n_live

    def _expand_vals(self, w, wl_idx, mask):
        """Dense [N, 3 + L] channel rows from spectral rows (the scatter
        fold of the tests)."""
        basis = self.basis_tbl[wl_idx]
        chans = [basis * w[:, None]]
        y = basis[:, 1] * w
        chans += [torch.where(m, y, 0.0)[:, None]
                  for m in accum_mod.lane_members(mask, self.color_classes)]
        return torch.cat(chans, dim=-1)

    def _fold_batch(self, contribs, keep, host_choice: bool = False):
        """Fold one batch's contribution rows into every render's
        accumulator, in place. Returns (live rows per render [R] int64 on
        the device, overflow: a device bool, True when some render's live
        rows exceed its keep, or None without keep). host_choice: read the
        live counts (once for all renders) and take the full fold where they
        overflow; else always the compacted fold."""
        n_classes = len(self.color_classes)
        lanes = tuple(self.color_classes)
        method = self.fold_kind
        if method != "sort":
            # Dense value rows: the scatter oracle, or the sort fold of keys
            # that do not pack.
            lives = []
            for r, (pix, w, wl_idx, mask) in enumerate(contribs):
                lives.append((w > 0.0).sum())
                self.accum[r].copy_(accum_mod.accumulate(
                    self.accum[r], pix, self._expand_vals(w, wl_idx, mask),
                    "sort" if method == "sort-legacy" else method, self.ks))
            return torch.stack(lives), None
        packed = []
        for r, (pix, w, wl_idx, mask) in enumerate(contribs):
            P = self.accum[r].shape[0]
            key, wz = accum_mod.pack_spectral_keys(pix, w, wl_idx, P, self.k_pool)
            mcol = to_bits(torch.where(key != -1, mask, 0)) if n_classes else None
            packed.append((key, wz, mcol))
        lives = torch.stack([p[1].gt(0.0).sum() for p in packed])
        fits = self._fits(lives, keep, host_choice)
        over = None
        for r, (key, wz, mcol) in enumerate(packed):
            kr = keep[r] if keep is not None else None
            if kr is not None and fits[r]:
                # Compaction prepass (one pass: the live rows, dense, in
                # order); the fold's sort then runs on keep + P rows instead
                # of every contribution row.
                (key, wz, *rest), _ = accum_mod.compact_valid(
                    key, [wz] + ([mcol] if n_classes else []), kr, self.ks)
                mcol = rest[0] if n_classes else None
                over = _or(over, lives[r] > kr)
            self.accum[r].copy_(accum_mod.fold_spectral_keys(
                self.accum[r], key, wz, self.k_pool, self.basis_tbl, self.ks,
                lane_specs=lanes, mask=mcol))
        return lives, over

    def _fits(self, lives, keep, host_choice: bool) -> list:
        """Per render, whether to take the compacted branch: always without
        host_choice; with it, where the live count (one host read for every
        render) fits keep."""
        if keep is None or not host_choice:
            return [True] * len(lives)
        self.host_syncs += 1
        return [k is None or n <= k for n, k in zip(lives.tolist(), keep)]

    # ------------------------------------------------------------------
    # Kernel trace path
    # ------------------------------------------------------------------

    def _step_kernel_impl(self, n_active: int, keep, host_choice: bool = False):
        """One batch at the device counter through trace_emit and the fold,
        into the accumulators in place. Returns (live rows per render [R],
        overflow or None, landed_add [R], dropped, segs), as _fold_batch."""
        counter = self._dev.counter
        lo, hi = self._ray_base_words(counter)
        words = to_bits(torch.stack([lo, hi]))
        profiling.stage("trace")
        tables = self._pool_tables(counter) if self._trace_plan.pool_k else ()
        per_render, landed_add, dropped, segs = self.ks.trace_emit(
            self._trace_plan, words, n_active, self.device, *tables
        )
        k_pool = self.k_pool
        shift = accum_mod.key_shift(k_pool)
        lives = torch.stack([counts.to(I64).sum() for _k, _w, counts in per_render])
        fits = self._fits(lives, keep, host_choice)
        over = None
        for r, (keys, wvals, counts) in enumerate(per_render):
            _g, blk = keys.shape
            kr = keep[r] if keep is not None else None
            acc = self.accum[r]
            if kr is None or not fits[r]:
                acc.copy_(accum_mod.fold_spectral_keys(
                    acc, keys.reshape(-1), wvals.reshape(-1), k_pool,
                    self.basis_tbl, self.ks,
                ))
                continue
            profiling.stage("scatter")
            P = acc.shape[0]
            block = accum_mod.BLOCK
            out_total = -(-(kr + P) // block) * block
            # Live rows past kr land under the marker tail or past the
            # output and are lost (the scatter writes nothing past
            # out_total); the overflow flag sends such a batch to the full
            # fold.
            ck, cw = self.ks.scatter_blocks_multi(
                [keys, wvals], accum_mod._exclusive_starts(counts), out_total, blk,
                marker_tail=(kr, P, shift, 2 * k_pool - 1),
            )
            acc.copy_(accum_mod.fold_spectral_keys_premerged(
                acc, ck, cw, k_pool, self.basis_tbl, self.ks
            ))
            over = _or(over, lives[r] > kr)
        return lives, over, landed_add, dropped, segs

    # ------------------------------------------------------------------
    # Host loop
    # ------------------------------------------------------------------

    @property
    def shard(self) -> tuple:
        """(index, count): this engine's shard of a data-parallel run."""
        return self._shard

    @shard.setter
    def shard(self, value) -> None:
        index, count = (int(v) for v in value)
        if not 0 <= index < count:
            raise ValueError(f"shard index {index} out of range for {count} shards")
        self._shard = (index, count)

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

    def _batch(self, n_active: Optional[int] = None, host_choice: bool = False) -> None:
        """One batch at the device counter: trace, fold into the
        accumulators, add its counts into the running sums, advance the
        counter, all on the device and in place (what a CUDA graph
        captures). host_choice: the eager batch, which reads its live counts
        and takes the full fold or the global continuation sort where they
        overflow; else the compacted branches always, an overflow recorded
        in first_over. With the tracer on, its stages are timed
        (utils/profiling.py)."""
        with profiling.batch_stages(self.device) as marks:
            self._batch_body(n_active, host_choice)
        if marks is not None and torch.cuda.is_current_stream_capturing():
            self._graph_marks = marks
        else:
            self._marks = marks

    def _batch_body(self, n_active: Optional[int], host_choice: bool) -> None:
        d = self._dev
        keep = self._compact_keep
        if self._trace_plan is not None:
            lives, over, landed, dropped, segs = self._step_kernel_impl(
                self.batch_size if n_active is None else n_active, keep, host_choice)
            cont, smass = (), None
        else:
            contribs, landed, dropped, segs, cont, smass, c_over = self._trace_batch_impl(
                d.counter, n_active, host_choice)
            lives, f_over = self._fold_batch(contribs, keep, host_choice)
            over = _or(c_over, f_over)
        self.accum[-1].add_(landed)
        d.dropped.add_(dropped.to(torch.float64))
        d.segs.add_(segs)
        d.live.add_(lives)
        if len(cont):
            d.cont.add_(torch.stack(cont))
            if profiling.is_tracing():
                d.lanes.add_(const(np.array([l.cont_cap for l in self.layers[1:]]), self.device))
        if smass is not None:
            d.slot_mass.add_(smass)
        if over is not None and not host_choice:
            d.first_over.copy_(torch.where(over & (d.first_over < 0), d.counter, d.first_over))
        d.counter.add_(1)

    @property
    def graph_mode(self) -> str:
        """How the steady batches of a dispatch run: 'cuda graph' or
        'eager (reason)'."""
        if not self.graphs:
            return "eager (graphs off)"
        if not self._calibrated:
            # Its plan goes at calibration: a capture would be used by this
            # dispatch alone and would hold a second copy of the batch's
            # memory beside the warm-up's.
            return "eager (the calibrating dispatch; captured once calibrated)"
        if self.fold_kind != "sort":
            return f"eager (the {self.fold_kind} fold does not capture)"
        return "cuda graph"

    def _graph_key(self):
        """What a captured batch assumed: the plan it was built under, the
        shard (its ray base is a constant of the graph), the addresses it
        reads and writes, and whether the tracer was on (its stage timers
        are nodes of the graph)."""
        return (self._compact_keep, self._slot_cap, tuple(l.cont_cap for l in self.layers),
                self.fold_kind, self.shard, tuple(t.data_ptr() for t in self.accum),
                tuple(t.data_ptr() for t in self._dev), profiling.is_tracing())

    def _step(self, graph: bool, traced: bool = False) -> None:
        """One batch with no host read: a replay of the captured batch (a new
        capture, which runs one batch itself, when the plan or an address
        changed or the capture is stale: graph.invalidate) when `graph`, else
        an eager batch that chooses on the device. `traced`: in a span,
        ``iht.launch`` (the replay's launch) or ``iht.step``."""
        if not graph:
            with profiling.span_if(traced, "iht.step"):
                self._batch()
        elif (self._graph is None or self._graph.stale
              or self._graph.key != self._graph_key()):
            self._graph = None
            self._graph = graph_mod.BatchGraph(self._batch, self._graph_key(), self.device)
        elif traced:
            self._graph.replay(traced=True)
            self._marks = self._graph_marks
        else:
            self._graph.replay()

    def _steady(self, n: int, traced: bool = False) -> None:
        """n batches with no host read (``_step``), traced or not."""
        graph = self.graph_mode == "cuda graph"
        if traced:
            for _ in range(n):
                self._step(graph, True)
        else:
            for _ in range(n):
                self._step(graph)

    def _overflow_possible(self) -> bool:
        """Whether a batch can take a compacted branch that its rows
        overflow: a render with keep, or a continuation between layers."""
        keep = self._compact_keep
        return (keep is not None and any(k is not None for k in keep)) or (
            self._trace_plan is None and len(self.layers) > 1)

    def _state(self) -> list:
        """The tensors a dispatch updates, besides the counter."""
        d = self._dev
        return list(self.accum) + [d.dropped, d.segs, d.live, d.cont, d.slot_mass, d.lanes]

    def _dispatch(self, k: int) -> None:
        """k full batches from the host count on, as one JAX dispatch: the
        launch part, then the read part; in an ``iht.dispatch`` span, and
        its parts in theirs, while spans are live (utils/profiling.py)."""
        if not self._calibrated:
            d = self._dev
            for t in (d.live, d.cont, d.slot_mass):
                t.zero_()
        if not profiling.live():
            self._launch(k)
            self._read()
            return
        with profiling.span("iht.dispatch", dispatch=self.batch_counter):
            self._launch(k, traced=True)
            self._read(traced=True)

    def _launch(self, k: int, traced: bool = False) -> None:
        """The launch part of a dispatch of k full batches from the host
        count on, with no host read: the prologue, the k batches
        (``_step``), the epilogue. A data-parallel run does the three parts
        itself, so as to launch batch i on every shard before batch i + 1,
        and reads every shard after (``_read``)."""
        guard = self._launch_prologue(traced)
        self._steady(k, traced)
        self._launch_epilogue(k, guard)

    def _launch_prologue(self, traced: bool = False) -> bool:
        """The device counter from the host count, and a snapshot of the
        state when a batch can overflow; returns whether it took one."""
        with profiling.span_if(traced, "iht.prologue"):
            d = self._dev
            d.counter.fill_(self.batch_counter)
            guard = self._overflow_possible()
            if guard:
                state = self._state()
                if self._snap is None or [t.shape for t in self._snap] != [
                        t.shape for t in state]:
                    self._snap = [torch.empty_like(t) for t in state]
                for s, t in zip(self._snap, state):
                    s.copy_(t)
                d.first_over.fill_(-1)
        return guard

    def _launch_epilogue(self, k: int, guard: bool) -> None:
        """What ``_read`` needs of the k batches just launched."""
        self._pending = (self.batch_counter, k, guard)

    def _read(self, traced: bool = False) -> None:
        """The read part of the dispatch ``_launch`` started: one read of
        the first overflowing batch (when a batch can overflow). If one did,
        the state goes back to the snapshot, the batches before it run
        again, it runs eagerly with the host's choice, and the rest follows
        as a new dispatch. `traced`: the read in an ``iht.read`` span, the
        replay in ``iht.overflow``, and the last batch's stage times
        recorded."""
        start, k, guard = self._pending
        self._pending = None
        d = self._dev
        first = -1
        if guard:
            self.host_syncs += 1
            with profiling.span_if(traced, "iht.read"):
                first = int(d.first_over)
        if first < 0:
            self.batch_counter = start + k
            if traced:
                profiling.record_stages(self._marks, synced=guard)
            return
        with profiling.span_if(traced, "iht.overflow"):
            j = first - start
            for s, t in zip(self._snap, self._state()):
                t.copy_(s)
            d.counter.fill_(start)
            self._steady(j)
            self._batch(host_choice=True)
            self.overflow_replays += 1
            self.batch_counter = start + j + 1
        if k > j + 1:
            self._launch(k - j - 1, traced)
            if traced:
                self._read(True)
            else:
                self._read()
        elif traced:
            profiling.record_stages(self._marks, synced=False)

    def run(self, total_rays: Optional[int] = None,
            n_batches: Optional[int] = None) -> Stats:
        """Trace `n_batches` batches, or `total_rays` rays exactly (the last
        batch traces only the remainder lanes), default the scene's
        ray_num: dispatches of up to steps_per_dispatch full batches, then
        the exact-budget tail batch alone, eagerly. Calibrates after the
        first dispatch."""
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
        done = 0
        while done < n_batches:
            k = min(self.steps_per_dispatch, n_batches - done)
            is_tail = bool(tail) and done + k == n_batches
            if is_tail and k > 1:
                k -= 1          # the full batches now, the tail alone next
                is_tail = False
            if is_tail:
                self._dev.counter.fill_(self.batch_counter)
                self._batch(n_active=tail, host_choice=True)
                self.batch_counter += 1
            else:
                self._dispatch(k)
            done += k
            if not self._calibrated and not is_tail:
                self._maybe_calibrate(k)
        self.stats = self.stats._replace(
            rays_traced=self.stats.rays_traced + rays_requested,
            stochastic_crystal_samples=self.stats.stochastic_crystal_samples
            + n_batches * sum(
                k for plan in self.layers
                for k, det in zip(plan.k_per_setting, plan.deterministic_shape) if not det),
            stochastic_orientation_samples=self.stats.stochastic_orientation_samples
            + n_batches * sum(
                c for plan in self.layers
                for c, det in zip(plan.setting_counts, plan.deterministic_axis) if not det),
        )
        return self.stats

    @profiling.setup_span("iht.calibrate")
    def _maybe_calibrate(self, n_steps: int = 1) -> None:
        """One-shot calibration from the first dispatch's counts, averaged
        over its n_steps batches (one host read): the exit-slot cap, the
        continuation capacities and `keep` per render. All are functions of
        (scene, seed, batch size, first dispatch size), so equal runs stay
        comparable; a bad calibration costs speed, never correctness (an
        overflowing batch takes the full fold)."""
        self._calibrated = True
        self.host_syncs += 1
        d = self._dev
        R, nb = d.live.shape[0], d.cont.shape[0]
        sums = torch.cat([d.live.double(), d.cont.double(), d.slot_mass.double()]).cpu().numpy()
        live_avg = sums[:R] / max(1, n_steps)
        cont_avg = sums[R:R + nb] / max(1, n_steps)
        H = self.max_hits
        if self._slot_cap is None:
            # The smallest cap whose dropped per-ray live-rank tail is under
            # 1e-4 of the emitted mass (and is still accounted every batch).
            m = sums[R + nb:]
            total = float(m.sum())
            cap = H
            if total > 0:
                tail = np.cumsum(m[::-1])[::-1]        # tail[c] = mass at rank >= c
                for c in range(1, H):
                    if tail[c] <= 1e-4 * total:
                        cap = c
                        break
            self._slot_cap = cap
        if nb:
            # Trim the continuation buffers to 1.25 times the mean measured
            # demand (never grow).
            caps = [None]
            for li in range(1, len(self.layers)):
                cur = self.layers[li].cont_cap
                want = int(cont_avg[li - 1] * 1.25)
                caps.append(want if want < 0.85 * cur else None)
            if any(c is not None for c in caps):
                self._build_plan(cont_caps=caps)
        self._recompute_rows_per_render()
        if not self._compact_enabled or self.fold_kind != "sort":
            return
        block = accum_mod.BLOCK
        keep = []
        for n_rows, live in zip(self._rows_per_render, live_avg):
            # The compaction prepass pays when well under 60% of the
            # contribution rows are live; the margin absorbs the batch-to-
            # batch fluctuation of the live count.
            target = int(np.ceil(live * self._KEEP_MARGIN / block)) * block
            if n_rows >= 2 * block and target <= 0.6 * n_rows:
                keep.append(max(block, target))
            else:
                keep.append(None)
        self._compact_keep = tuple(keep) if any(k is not None for k in keep) else None

    def _calibration_digest(self) -> np.ndarray:
        """int64 [DIGEST_LEN] digest of the calibrated plan, which every
        shard of a data-parallel run must share (JAX
        ``ShardedEngine._calibration_digest``): the slot cap, keep per
        render, the continuation lanes per layer, the fold and the trace path
        (CRC-32 of their names). Fixed length, so that an all-gather of
        digests cannot mismatch in shape where the plans diverged; the last
        entry counts the fields."""
        parts = [-1 if self._slot_cap is None else self._slot_cap,
                 zlib.crc32(self.fold_kind.encode()), zlib.crc32(self.trace_path.encode())]
        keep = self._compact_keep or (None,) * len(self.proj_plans)
        parts += [len(keep)] + [-1 if k is None else k for k in keep]
        parts += [len(self.layers)] + [plan.cont_cap for plan in self.layers]
        out = np.zeros(DIGEST_LEN, np.int64)
        n = min(DIGEST_LEN - 1, len(parts))
        out[:n] = parts[:n]
        out[-1] = len(parts)
        return out

    # ------------------------------------------------------------------
    # Host readout
    # ------------------------------------------------------------------

    def drain_stats(self) -> Stats:
        """Fold the device-side running sums into stats (one sync)."""
        d = self._dev
        dropped, segs = float(d.dropped), int(d.segs)
        d.dropped.zero_()
        d.segs.zero_()
        self.stats = self.stats._replace(
            dropped_cont_weight=self.stats.dropped_cont_weight + dropped,
            ray_segments=self.stats.ray_segments + segs,
            landed_weight=float(self.accum[-1].to(torch.float64).sum()),
        )
        return self.stats

    def raw_xyz(self, render_idx: int = 0) -> np.ndarray:
        return self._xyz(render_idx).cpu().numpy()

    def _xyz(self, render_idx: int = 0):
        """``raw_xyz`` on the engine's device: a float32 [H, W, 3] view of
        the accumulator."""
        p = self.proj_plans[render_idx]
        return self.accum[render_idx][:, :3].reshape(p.height, p.width, 3)

    def lane_y(self, render_idx: int = 0) -> Optional[np.ndarray]:
        """Raw per-colour-class Y lanes [C, H, W] of one render."""
        if not self.color_classes:
            return None
        p = self.proj_plans[render_idx]
        arr = self.accum[render_idx][:, 3:].cpu().numpy()           # [P, C]
        return arr.T.reshape(len(self.color_classes), p.height, p.width)

    def composite(self, render_idx: int = 0, display_exposure_scale: float = 1.0):
        """Colour-class composite image (linear RGB [H, W, 3]) or None."""
        from ice_halo_sim_tpu_torch.engine.compositor import composite_color_classes

        lanes = self.lane_y(render_idx)
        if lanes is None or self.cfg.raypath_color is None:
            return None
        rcfg = self.cfg.renders[render_idx]
        return composite_color_classes(
            lanes, self.cfg.raypath_color.classes,
            self.cfg.raypath_color.composite_mode,
            intensity_factor=rcfg.intensity_factor,
            display_exposure_scale=display_exposure_scale,
        )

    def snapshot(self):
        """uint8 sRGB image per render, post-processed on the engine's
        device; only the uint8 image comes to the host."""
        landed = self.accum[-1].cpu().numpy()
        images = []
        for r, rcfg in enumerate(self.cfg.renders):
            images.append(color.post_process(
                self._xyz(r), rcfg.intensity_factor,
                float(landed[r]),
                rcfg.background, rcfg.ray_color,
                use_real_color=rcfg.ray_color[0] < 0,
            ))
        return images

    def plan_arrays(self) -> dict:
        """The static tables of the trace kernel path as numpy, for
        comparison with the JAX engine: face planes, entry tris, SPD pool,
        CIE basis table, axis LUT and the projection plan of each render."""
        tp = self._trace_plan
        if tp is None:
            raise ValueError("plan_arrays: the scene is not on the trace kernel path")
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
