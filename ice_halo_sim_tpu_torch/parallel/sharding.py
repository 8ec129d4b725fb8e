"""Data parallel: rays sharded over a list of devices (port of
``ice_halo_sim_tpu.parallel.sharding``).

Rays are embarrassingly parallel. Every shard runs the same batch on its own
rays with its own accumulators, and the accumulators are summed only at
drain. In torch idiom that is one ``Engine`` per shard over a plain list of
devices, with no mesh object.

Shard d of n, at the batch counter c that every shard shares, traces the rays
from the base (c * n + d) * span on, span = batch_size * (layers + 1): JAX's
``c * n * span + d * span`` with its carry into the high word
(``Engine.ray_base``). The counter itself is not sharded, so every shard
samples the same crystal shapes and the same continuation salt and differs
only in its rays, as in JAX.

``run`` launches batch i on every shard before batch i + 1, and reads the
shards only after the dispatch's last batch (the Engine's launch prologue,
one ``_step`` a batch, its epilogue, then ``_read``), so on several cards
every card starts at once, as in JAX's one ``shard_map`` program; a device
listed twice (two shards on one card) queues both shards' batches on that
card's stream in turn.

Differences from the JAX module, all deliberate:
  - the trace kernel path runs sharded (JAX's ``shard_map`` body never ran
    its kernel, and its ``check_vma=False`` leaves the sharded result to the
    sequential oracle of its slow tests);
  - the dropped weight and the segments are read once per ``run`` (JAX sums
    them over devices per batch and reads once);
  - the drain sums the shards in shard order on the first shard's device;
    on the sandwich fold ``raw_xyz`` sums each shard's dense float64 image.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ice_halo_sim_tpu_torch.config.schema import ProjectConfig
from ice_halo_sim_tpu_torch.core import color
from ice_halo_sim_tpu_torch.engine.simulator import DEFAULT_GEOM_CLOCK, Engine
from ice_halo_sim_tpu_torch.utils import profiling


def make_mesh(devices=None) -> list:
    """The shards' devices as a list of ``torch.device``. Default: every
    visible CUDA device; without one this raises (pass devices such as
    ``["cpu"] * n``). A device may be listed more than once: two shards on
    one card."""
    if devices is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() == 0:
            raise RuntimeError("make_mesh: no CUDA device is visible; pass the devices, "
                               "such as make_mesh(['cpu'] * n)")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    mesh = [torch.device(d) for d in devices]
    if not mesh:
        raise ValueError("make_mesh: no devices given")
    return mesh


class ShardedEngine:
    """Data-parallel engine: one Engine per shard, summed at drain.

    calibrate=True: each shard's Engine calibrates on the unsharded stream,
    as JAX's one inner engine does (one batch at shard (0, 1), then
    ``reset()``, which keeps the plan), then takes its shard; the shards'
    calibration digests must agree. calibrate=False: uncapped, uncompacted
    and exact (the sandwich fold keeps its levels from before calibration).
    """

    def __init__(self, cfg: ProjectConfig, mesh: Optional[list] = None, seed: int = 1,
                 per_device_batch: int = 1 << 17, geom_clock: int = DEFAULT_GEOM_CLOCK,
                 accum_method: str = "sort", calibrate: bool = True):
        self.mesh = make_mesh(mesh)
        first, self.n_dev = self._shard_layout(len(self.mesh))
        self.engines = []
        for i, dev in enumerate(self.mesh):
            eng = Engine(cfg, seed=seed, batch_size=per_device_batch, device=dev,
                         geom_clock=geom_clock, accum_method=accum_method)
            if calibrate:
                eng.run(n_batches=1)
                eng.reset()
            else:
                if eng._sandwich_on:
                    # The levels from before calibration, which are exact by
                    # construction (misses cascade to the full-coverage
                    # level); no count tiles.
                    eng._calibrating = False
                    eng._calibrated = True
                    eng.reset()
                if eng._slot_cap is None:
                    eng._slot_cap = eng.max_hits
                eng._calibrated = True
            eng.shard = (first + i, self.n_dev)
            self.engines.append(eng)
        self.engine = self.engines[0]
        self.cfg = cfg
        self.per_device_batch = per_device_batch
        self.span = self.engine.span
        self._assert_calibration_agreement()
        self.reset()

    # Hooks of a run over several processes (parallel/distributed.py).

    def _shard_layout(self, n_local: int) -> tuple:
        """(global index of the first local shard, global shard count)."""
        return 0, n_local

    def _gather_digests(self, digests: np.ndarray) -> np.ndarray:
        """The digests every shard of the run is to be compared with."""
        return digests

    def _reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of `t` over processes (one process: `t`)."""
        return t

    def _assert_calibration_agreement(self) -> None:
        """Every shard must run the same calibrated plan: calibration is a
        deterministic function of (scene, seed, batch size), but a
        heterogeneous set of devices or nondeterministic counts would give
        shards different plans, whose sum is no image of one plan."""
        table = self._gather_digests(np.stack([e._calibration_digest() for e in self.engines]))
        if not (table == table[0]).all():
            raise RuntimeError(
                "calibrated plans diverged across shards: "
                f"{table.tolist()} — heterogeneous local devices or "
                "nondeterministic calibration counts; pin IHT_SLOT_CAP / "
                "IHT_COMPACT=0 or use calibrate=False")

    def reset(self) -> None:
        """Zero every shard's accumulators and counters; the plans stay."""
        for eng in self.engines:
            eng.reset()
        self.dropped_weight = 0.0
        self.ray_segments = 0

    @property
    def batch_counter(self) -> int:
        return self.engine.batch_counter

    def run(self, n_batches: int = 1):
        """n_batches batches on every shard from the shared counter: per
        dispatch every shard's launch prologue, then batch i on every shard
        in turn for each i, then every shard's epilogue and read part (its
        overflow replay, if any, its own). The dropped weight and the
        segments are summed over shards once."""
        spd = self.engine.steps_per_dispatch
        done = 0
        while done < n_batches:
            k = min(spd, n_batches - done)
            if profiling.live():
                with profiling.span("iht.dispatch", dispatch=self.batch_counter):
                    self._dispatch(k, traced=True)
            else:
                self._dispatch(k)
            done += k
        dev0 = self.engine.device
        tot = torch.zeros(2, dtype=torch.float64, device=dev0)
        for eng in self.engines:
            d = eng._dev
            tot += torch.stack([d.dropped, d.segs.to(torch.float64)]).to(dev0)
            d.dropped.zero_()
            d.segs.zero_()
        dropped, segs = self._reduce(tot).tolist()
        self.dropped_weight += dropped
        self.ray_segments += int(segs)
        return self

    def _dispatch(self, k: int, traced: bool = False) -> None:
        """One dispatch of k batches on every shard (``run``); `traced`:
        each shard's parts in their spans (utils/profiling.py)."""
        more = (True,) if traced else ()   # untraced: the engine's plain calls
        guards = [eng._launch_prologue(*more) for eng in self.engines]
        graphs = [eng.graph_mode == "cuda graph" for eng in self.engines]
        for _ in range(k):
            for eng, graph in zip(self.engines, graphs):
                eng._step(graph, *more)
        for eng, guard in zip(self.engines, guards):
            eng._launch_epilogue(k, guard)
        for eng in self.engines:
            eng._read(*more)

    @property
    def rays_traced(self) -> int:
        return self.batch_counter * self.n_dev * self.per_device_batch

    def drained_accum(self) -> list:
        """The accumulators summed over shards in shard order, on the first
        shard's device. (On the sandwich fold these are the level tiles and
        the landed weights; ``raw_xyz`` gives the image.)"""
        dev0 = self.engine.device
        out = [a.to(dev0, copy=True) for a in self.engine.accum]
        for eng in self.engines[1:]:
            for o, a in zip(out, eng.accum):
                o.add_(a.to(dev0))
        return [self._reduce(o) for o in out]

    def _xyz(self, r: int, drained=None):
        """Render r's summed XYZ image [H, W, 3] float32 where it lies: on
        the first shard's device, or on the sandwich fold the numpy image
        summed on the host in float64."""
        p = self.engine.proj_plans[r]
        if self.engine._sandwich_on:
            img = self.engines[0]._sandwich_dense64(r)
            for eng in self.engines[1:]:
                img = img + eng._sandwich_dense64(r)
            img = self._reduce(torch.from_numpy(img)).numpy().astype(np.float32)
            return img.reshape(p.height, p.width, 3)
        if drained is None:
            drained = self.drained_accum()
        return drained[r][:, :3].reshape(p.height, p.width, 3)

    def raw_xyz(self, render_idx: int = 0) -> np.ndarray:
        xyz = self._xyz(render_idx)
        return xyz if isinstance(xyz, np.ndarray) else xyz.cpu().numpy()

    def snapshot(self):
        """uint8 sRGB image per render, from the drained accumulators,
        post-processed on the first shard's device (as Engine.snapshot)."""
        drained = self.drained_accum()
        landed = drained[-1].cpu().numpy()
        images = []
        for r, rcfg in enumerate(self.cfg.renders):
            images.append(color.post_process(
                torch.as_tensor(self._xyz(r, drained)).to(self.engine.device),
                rcfg.intensity_factor, float(landed[r]),
                rcfg.background, rcfg.ray_color, use_real_color=rcfg.ray_color[0] < 0,
            ))
        return images
