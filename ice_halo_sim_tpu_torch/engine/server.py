"""Async render server: the commit/poll lifecycle over the port's Engine.

A port of the JAX package's engine/server.py, with the same semantics:

  - ``commit()`` with a value-equal config reuses the accumulated image; an
    appearance-only render change (background, ray_color, intensity_factor,
    grids, outline) keeps the accumulators and re-tone-maps; anything else
    resets and bumps the generation.
  - Stale work cannot leak across generations: the engine is the pump's
    for the whole of each ``Engine.run`` call, and commit swaps it only
    between two calls.
  - ``acquire_frame()`` returns an immutable snapshot tagged with its
    generation.
  - ``state()`` reports RUNNING while committed work remains, IDLE when the
    ray budget is drained, STOPPED after shutdown or a failed pump.

What the port does differently:

  - The pump's grain. The first pump after a commit runs one batch, so the
    engine calibrates from one batch as the JAX server's does; every later
    pump runs about PUMP_SECONDS of batches in one ``Engine.run``:
    clamp(round(PUMP_SECONDS / batch wall), 1, steps_per_dispatch)
    batches, no more than the budget has left, where the batch wall is the
    wall time of the engine's last run call (its host read included) over
    its batches. A commit waits for the pump's current call, so it waits
    about PUMP_SECONDS at most, whatever a batch costs; a fast scene still
    groups a dispatch's worth of batches in one call (a dispatch of the
    port reads the host once at its end, so one batch per pump would read
    it every batch). Grouping batches into calls changes no bit; the
    grains of the current engine's calls are in ``grains()``.
  - The pump runs the engine outside the server's lock, and a caller that
    needs the engine (commit, acquire_frame, the colour controls) gets it
    before the pump's next call: a lock that the pump released and took
    again at once would starve the callers (the port's run holds the
    interpreter for its whole call, where a JAX dispatch returns at once).
  - A layout commit drops the old engine (its buffers and its CUDA graph's
    private pool) before it builds the new one.
  - A pump that raises keeps its exception: ``wait_idle``, ``acquire_frame``
    and ``commit`` raise it again (as the cause of a RuntimeError), and
    ``state()`` is STOPPED. Nothing falls back to another kernel set.
  - ``device`` and ``kernels`` are passed to every Engine the server
    builds. ``device=None`` (the default, and what the C API passes) takes
    IHT_PLATFORM when it is set ("cpu" or "cuda"), else "cuda"; without a
    card a CUDA server raises.
"""

from __future__ import annotations

import contextlib
import dataclasses
import enum
import gc
import threading
import time
from typing import Optional, Union

import numpy as np
import torch

from ice_halo_sim_tpu_torch.config.loader import load_project, load_project_file
from ice_halo_sim_tpu_torch.config.schema import ProjectConfig
from ice_halo_sim_tpu_torch.engine.simulator import DEFAULT_GEOM_CLOCK, Engine, Stats

# Seconds of batches in one pump after calibration: one poll of the GUI
# (gui/app.py), and about the longest a commit waits for the pump.
PUMP_SECONDS = 0.25


class SimState(enum.Enum):
    IDLE = "idle"
    RUNNING = "running"
    STOPPED = "stopped"


@dataclasses.dataclass(frozen=True)
class ResultFrame:
    """Immutable result snapshot."""

    generation: int
    ray_count: int
    images: tuple          # per renderer: uint8 [H, W, 3]
    raw_xyz: tuple         # per renderer: float32 [H, W, 3]
    composites: tuple      # per renderer: float [H, W, 3] or None
    stats: Stats
    is_idle: bool
    timestamp: float
    landed: tuple = ()     # per renderer: total landed weight
    ev_auto: tuple = ()    # per renderer: adaptive-brightness EV offset


@dataclasses.dataclass(frozen=True)
class ColorClassDisplay:
    """Display-time appearance of one color class (color/visible/solo
    change without re-simulation; match/combine are structural)."""

    color: tuple
    visible: bool = True
    solo: bool = False


@dataclasses.dataclass(frozen=True)
class DrainStatus:
    """Consumer-side drain status: totals are final once drained_epoch ==
    current_epoch."""

    current_epoch: int
    drained_epoch: int


def _layout_key(cfg: ProjectConfig):
    """Config with appearance-only render fields masked to fixed values."""
    renders = tuple(
        dataclasses.replace(
            r,
            background=(0.0, 0.0, 0.0),
            ray_color=(-1.0, -1.0, -1.0),
            opacity=1.0,
            intensity_factor=1.0,
            central_grid=(),
            elevation_grid=(),
            celestial_outline=True,
        )
        for r in cfg.renders
    )
    return dataclasses.replace(cfg, renders=renders)


class Server:
    """Commit-and-poll renderer server.

    One background pump thread advances the active Engine until the
    committed ray budget is met (ray_num < 0 = run forever).
    """

    def __init__(self, seed: Optional[int] = None, batch_size: Optional[int] = None,
                 geom_clock: Optional[int] = None, device=None,
                 kernels: Optional[str] = None):
        from ice_halo_sim_tpu_torch.utils import env_knobs

        if device is None:
            device = env_knobs.get("IHT_PLATFORM") or "cuda"
            if device not in ("cpu", "cuda"):
                raise ValueError(f"IHT_PLATFORM must be 'cpu' or 'cuda', not {device!r}")
        self._device = torch.device(device)
        if self._device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Server(device='cuda') needs a CUDA device; "
                               "pass device='cpu' to run on the CPU")
        self._kernels = kernels
        self._seed = seed if seed is not None else env_knobs.get("IHT_SEED", 1)
        self._batch_size = (
            batch_size if batch_size is not None
            else env_knobs.get("IHT_BATCH_SIZE")
        )
        self._geom_clock = (
            geom_clock if geom_clock is not None
            else env_knobs.get("IHT_GEOM_CLOCK", DEFAULT_GEOM_CLOCK)
        )
        # Pump batches between implicit stat drains.
        self._snapshot_every = int(env_knobs.get("IHT_SNAPSHOT_EVERY", 64))
        self._since_drain = 0
        # Guards the fields below; never held across an Engine.run.
        self._cv = threading.Condition(threading.RLock())
        self._busy = False      # the pump is inside Engine.run
        self._arrived = 0       # callers that asked for the engine
        self._served = 0        # callers that are done with it
        self._engine: Optional[Engine] = None
        self._batch_wall: Optional[float] = None  # seconds a batch, last run call
        self._grains: list = []                   # batches of each run call
        self._cfg: Optional[ProjectConfig] = None
        self._generation = 0
        self._target_rays: Optional[int] = 0   # None = infinite
        self._composite_ev = 0.0               # display-time composite EV
        self._shutdown = False
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._pump, daemon=True,
                                        name="iht-server-pump")
        self._thread.start()

    def _raise_if_failed(self) -> None:
        if self._error is not None:
            raise RuntimeError("the server's pump failed") from self._error

    @contextlib.contextmanager
    def _engine_held(self):
        """The lock, with the engine out of the pump's hands: waits for the
        pump's current call to end; the pump serves every caller that came
        before its call ended before it starts another."""
        with self._cv:
            self._arrived += 1
            try:
                while self._busy:
                    self._cv.wait()
                yield
            finally:
                self._served += 1
                self._cv.notify_all()

    # -- commit protocol ----------------------------------------------------

    def commit(self, config: Union[ProjectConfig, dict, str]) -> bool:
        """Commit a scene (ProjectConfig, dict, JSON text, or a file path).
        Returns True if the previous accumulation was reused (value-equal
        layout), False if simulation restarted."""
        if isinstance(config, str):
            if config.lstrip().startswith("{"):
                import json as _json

                cfg = load_project(_json.loads(config))
            else:
                cfg = load_project_file(config)
        elif isinstance(config, dict):
            cfg = load_project(config)
        else:
            cfg = config

        with self._engine_held():
            if self._shutdown:
                raise RuntimeError("server is shut down")
            self._raise_if_failed()
            reused = False
            if self._cfg is not None and self._engine is not None:
                if cfg == self._cfg:
                    reused = True          # identical: nothing to do
                elif _layout_key(cfg) == _layout_key(self._cfg):
                    # Appearance-only change: keep accumulators, swap config.
                    self._engine.cfg = cfg
                    reused = True
            if not reused:
                bs = self._batch_size
                if bs is None:
                    bs = 112 * 2048 if self._device.type == "cuda" else 1 << 17
                # The old engine's buffers and graph go before the new ones
                # are allocated.
                if self._engine is not None:
                    self._engine = self._cfg = None
                    gc.collect()
                self._engine = Engine(cfg, seed=self._seed, batch_size=bs,
                                      device=self._device, kernels=self._kernels,
                                      geom_clock=self._geom_clock)
                self._batch_wall = None
                self._grains = []
                self._generation += 1
            self._cfg = cfg
            rn = cfg.scene.ray_num
            self._target_rays = None if rn < 0 else int(rn)
            return reused

    # -- pump ---------------------------------------------------------------

    def _work_remaining_locked(self) -> bool:
        if self._engine is None or self._error is not None:
            return False
        if self._target_rays is None:
            return True
        return self._engine.stats.rays_traced < self._target_rays

    def _grain_locked(self) -> int:
        """Batches of the next pump: one while the engine calibrates, then
        PUMP_SECONDS over the last call's batch wall (1 to
        steps_per_dispatch), no more than the budget has left."""
        eng = self._engine
        if not eng._calibrated or self._batch_wall is None:
            return 1
        n = max(1, min(eng.steps_per_dispatch, round(PUMP_SECONDS / self._batch_wall)))
        if self._target_rays is None:
            return n
        left = -(-(self._target_rays - eng.stats.rays_traced) // eng.batch_size)
        return max(1, min(n, left))

    def _pump(self) -> None:
        while True:
            with self._cv:
                owed = self._arrived
                while not self._shutdown and (
                        self._served < owed or not self._work_remaining_locked()):
                    self._cv.wait()
                if self._shutdown:
                    return
                engine = self._engine
                n = self._grain_locked()
                self._busy = True
            error = None
            wall = None
            try:
                t0 = time.perf_counter()
                engine.run(n_batches=n)
                wall = (time.perf_counter() - t0) / n
                self._since_drain += n
                if self._since_drain >= self._snapshot_every:
                    engine.drain_stats()
                    self._since_drain = 0
            except BaseException as e:  # kept, and raised again to every caller
                error = e
            finally:
                with self._cv:
                    self._busy = False
                    self._error = error
                    if wall is not None:
                        self._batch_wall = wall
                        self._grains.append(n)
                    self._cv.notify_all()
            if error is not None:
                if not isinstance(error, Exception):
                    raise error
                return

    # -- results ------------------------------------------------------------

    def acquire_frame(self) -> Optional[ResultFrame]:
        """Immutable snapshot of the current accumulation (None before the
        first commit)."""
        from ice_halo_sim_tpu_torch.engine import ev_auto as ev_mod

        with self._engine_held():
            self._raise_if_failed()
            eng = self._engine
            if eng is None:
                return None
            images = tuple(np.array(i) for i in eng.snapshot())
            raw = tuple(eng.raw_xyz(r) for r in range(len(eng.proj_plans)))
            ev_scale = float(2.0 ** self._composite_ev)
            comps = tuple(
                (np.asarray(c, np.float32)
                 if (c := eng.composite(r, display_exposure_scale=ev_scale))
                 is not None else None)
                for r in range(len(eng.proj_plans))
            )
            stats = eng.drain_stats()
            landed = tuple(float(x) for x in eng.accum[-1].cpu().numpy())
            evs = tuple(
                ev_mod.ev_auto_for_frame(raw[r], landed[r])
                for r in range(len(raw))
            )
            return ResultFrame(
                generation=self._generation,
                ray_count=stats.rays_traced,
                images=images,
                raw_xyz=raw,
                composites=comps,
                stats=stats,
                is_idle=not self._work_remaining_locked(),
                timestamp=time.time(),
                landed=landed,
                ev_auto=evs,
            )

    def device(self) -> torch.device:
        """The device the server's engines run on."""
        return self._device

    def config(self):
        """The committed ProjectConfig (None before the first commit)."""
        with self._cv:
            return self._cfg

    def sim_ray_count(self) -> int:
        with self._cv:
            return 0 if self._engine is None else self._engine.stats.rays_traced

    def state(self) -> SimState:
        with self._cv:
            if self._shutdown or self._error is not None:
                return SimState.STOPPED
            return SimState.RUNNING if self._work_remaining_locked() else SimState.IDLE

    def generation(self) -> int:
        with self._cv:
            return self._generation

    def wait_idle(self, timeout: Optional[float] = None) -> bool:
        """Block until the committed ray budget is drained (False when the
        timeout passes first); raises if the pump failed."""
        deadline = None if timeout is None else time.time() + timeout
        with self._cv:
            while True:
                self._raise_if_failed()
                if not self._work_remaining_locked():
                    return True
                remaining = None if deadline is None else deadline - time.time()
                if remaining is not None and remaining <= 0:
                    return False
                self._cv.wait(timeout=remaining)

    # -- display-time color control ------------------------------------------

    def set_raypath_colors(self, displays, z_order=None, mode: Optional[str] = None) -> None:
        """Display-time update of color-class appearance WITHOUT re-simulation:
        `displays` is a sequence of ColorClassDisplay, one per committed class
        (count must match); `z_order`, when given, must be a permutation of
        [0, class_count) assigning each class its new drawing rank; `mode`
        optionally switches the composite mode. All-or-nothing validation."""
        with self._engine_held():
            if self._engine is None or self._cfg is None:
                raise RuntimeError("no scene committed")
            rc = self._cfg.raypath_color
            classes = rc.classes if rc is not None else ()
            n = len(classes)
            if len(displays) != n:
                raise ValueError(
                    f"class count mismatch: {len(displays)} != committed {n}"
                )
            if z_order is not None:
                if sorted(z_order) != list(range(n)):
                    raise ValueError("z_order must be a permutation of [0, n)")
            if mode is not None and mode not in ("dominant", "additive", "painter"):
                raise ValueError(f"unknown composite mode {mode!r}")
            if rc is None:
                return
            new_classes = tuple(
                dataclasses.replace(
                    cls,
                    color=tuple(float(x) for x in d.color),
                    visible=bool(d.visible),
                    solo=bool(d.solo),
                    z_order=(int(z_order[i]) if z_order is not None else cls.z_order),
                )
                for i, (cls, d) in enumerate(zip(classes, displays))
            )
            new_rc = dataclasses.replace(
                rc,
                classes=new_classes,
                composite_mode=mode if mode is not None else rc.composite_mode,
            )
            self._cfg = dataclasses.replace(self._cfg, raypath_color=new_rc)
            # Display fields only: the engine's structural plan (match bits)
            # is untouched; accumulators are kept.
            self._engine.cfg = self._cfg

    def set_raypath_colors_json(self, text: str) -> None:
        """JSON form of set_raypath_colors (the C-API entry point):
        ``{"classes": [{"color": [r,g,b], "visible": true, "solo": false},
        ...], "z_order": [...], "mode": "dominant"}``; classes is required,
        z_order/mode optional."""
        import json as _json

        obj = _json.loads(text)
        if not isinstance(obj, dict) or "classes" not in obj:
            raise ValueError('expected {"classes": [...], ...}')
        displays = [
            ColorClassDisplay(
                color=tuple(float(x) for x in d["color"]),
                visible=bool(d.get("visible", True)),
                solo=bool(d.get("solo", False)),
            )
            for d in obj["classes"]
        ]
        self.set_raypath_colors(
            displays, z_order=obj.get("z_order"), mode=obj.get("mode")
        )

    def set_composite_exposure(self, ev_total: float) -> None:
        """Display-time EV for the composite path only (2^ev inside the
        composite bake; the mono path is unaffected)."""
        with self._cv:
            self._composite_ev = float(ev_total)

    def color_class_signal(self) -> list:
        """Per-class has-signal flags: 1 iff the class's Y lane has any
        non-zero pixel on any renderer."""
        with self._engine_held():
            eng = self._engine
            if eng is None or not eng.color_classes:
                return []
            flags = [0] * len(eng.color_classes)
            for r in range(len(eng.proj_plans)):
                lanes = eng.lane_y(r)
                if lanes is None:
                    continue
                for c in range(lanes.shape[0]):
                    if flags[c] == 0 and np.any(lanes[c] > 0):
                        flags[c] = 1
            return flags

    def color_overflow_info(self) -> dict:
        """Color-predicate capacity overflow of the most recent commit:
        predicates beyond the component-mask bit budget stop producing bits
        (coloring degrades, never fails)."""
        from ice_halo_sim_tpu_torch.engine.simulator import COLOR_PREDICATE_CAP

        with self._cv:
            count = 0 if self._engine is None else self._engine.color_overflow_count
            return {"component_overflow_count": count,
                    "component_capacity": COLOR_PREDICATE_CAP}

    # -- lifecycle ----------------------------------------------------------

    def drain_status(self) -> DrainStatus:
        """O(1) drain status: the epoch is the commit generation; it reads as
        drained when the committed budget is traced."""
        with self._cv:
            done = not self._work_remaining_locked()
            return DrainStatus(
                current_epoch=self._generation,
                drained_epoch=self._generation if done else self._generation - 1,
            )

    def lifecycle(self) -> dict:
        """Explicit lifecycle and epoch; state() is a projection of this."""
        with self._cv:
            return {"state": self.state().value, "epoch": self._generation}

    def grains(self) -> list:
        """The batches of each run call the pump made on the current
        engine, in order: an Engine given the same calls gives the same
        frame."""
        with self._cv:
            return list(self._grains)

    def stop(self) -> None:
        """Stop pumping (keeps state; a new commit restarts): halt work,
        keep results readable."""
        with self._cv:
            self._target_rays = 0
            self._cv.notify_all()

    def shutdown(self) -> None:
        with self._cv:
            self._shutdown = True
            self._cv.notify_all()
        self._thread.join(timeout=30)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
        return False
