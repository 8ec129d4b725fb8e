"""Differentiable rendering: image gradients with respect to scene
parameters (port of ``ice_halo_sim_tpu.engine.gradient``), on torch autograd.

The forward trace is plain PyTorch, so autograd flows through the Fresnel
weights, refraction directions, crystal plane geometry and rotations, and,
through the bilinear splat (projection.splat_bilinear), through the
projected pixel positions, which integer binning would block. The render
runs the engine's bounce loop (core/trace_soa.trace_layer_soa) with
``score_grad=True``: the REINFORCE score term of the entry triangle's
choice.

Differentiable parameters (RenderParams):
  - sun_altitude_deg: smooth transport;
  - zenith_mean_deg / zenith_std_deg: the orientation distribution,
    reparameterised (zenith = mean + std * eps with the latitude pole fold,
    the gauss-legacy measure; the area-measure LUT sampler of the engine is
    not differentiable in its distribution);
  - height / face_distance: crystal shape scalars, through the plane
    coefficients and entry triangles. The slab face reassignment boundary
    (the argmin switch) is estimated by the ``soft_tau`` softmin: bias
    O(tau), variance O(1/(N tau)), so shape gradients need large batches.

``frozen_mode`` records a base point's discrete decisions and re-renders
with them reused (frozen-selection finite differences): the score term is
off and the boundary terms are excluded by construction.

Compiled as JAX compiles it: ``make_render_fn`` returns, for each of JAX's
``jax.jit`` forms (the plain render, ``seed_as_arg``, and ``frozen_mode``'s
``render_frozen`` and ``record``), a ``RenderProgram``. On a CUDA device its
forward and its backward are each a CUDA graph (engine/graph.py
``GradGraph``), captured at the first call and replayed at every later one,
so the render is one launch for the host instead of some 3000; on the CPU
the same body runs eagerly (``graph_mode``). ``RenderProgram.body`` is that
body. grad_validation's table and demo run the programs, with the loss and
``torch.autograd.grad`` eager between them.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; without a CUDA device they raise.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ice_halo_sim_tpu_torch.config.schema import ProjectConfig
from ice_halo_sim_tpu_torch.core import (
    color,
    geometry,
    optics,
    projection,
    rng,
    sampling,
    trace,
    trace_soa,
)
from ice_halo_sim_tpu_torch.core.bits import F32, I64, MASK32
from ice_halo_sim_tpu_torch.core.sampling import PI_F, TWO_PI_F
from ice_halo_sim_tpu_torch.engine import graph as graph_mod


class RenderParams(NamedTuple):
    """Differentiable scene parameters, float32 tensors."""

    sun_altitude_deg: torch.Tensor   # scalar
    height: torch.Tensor             # scalar prism height ratio
    face_distance: torch.Tensor      # [6]
    zenith_mean_deg: torch.Tensor    # scalar orientation-distribution mean
    zenith_std_deg: torch.Tensor     # scalar orientation-distribution std


def resolve_device(device) -> torch.device:
    """The device a gradient entry point runs on; a CUDA device must exist."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the gradient render runs on a CUDA device and none is available; "
            "pass device='cpu' to run it on the CPU")
    return dev


def _f32(x, dev):
    return torch.as_tensor(x, dtype=F32, device=dev)


def default_params(cfg: ProjectConfig, device="cuda") -> RenderParams:
    dev = resolve_device(device)
    crystal = next(iter(cfg.crystals.values()))
    h = crystal.shape.height.center if hasattr(crystal.shape, "height") else 1.0
    fd = [d.center for d in crystal.shape.face_distance]
    lat = crystal.axis.latitude
    return RenderParams(
        sun_altitude_deg=_f32(cfg.light.sun.altitude, dev),
        height=_f32(h, dev),
        face_distance=_f32(fd, dev),
        zenith_mean_deg=_f32(90.0 - lat.center, dev),
        zenith_std_deg=_f32(max(lat.spread, 1e-3), dev),
    )


def params_from_jax(np_params, device="cuda") -> RenderParams:
    """The JAX package's RenderParams (fields as numpy arrays) as the
    port's."""
    dev = resolve_device(device)
    return RenderParams(*(_f32(np.array(x, np.float32), dev) for x in np_params))


def choices_from_jax(np_choices, device="cuda") -> trace_soa.FrozenChoices:
    """The JAX package's FrozenChoices (fields as numpy arrays) as the
    port's: int32 indices, bool decisions."""
    dev = resolve_device(device)
    sel, ok, faces, alive, tir, emit = (np.asarray(x) for x in np_choices)
    i32 = lambda a: torch.as_tensor(a.astype(np.int32), device=dev)  # noqa: E731
    b = lambda a: torch.as_tensor(a.astype(bool), device=dev)        # noqa: E731
    return trace_soa.FrozenChoices(i32(sel), b(ok), i32(faces), b(alive), b(tir), b(emit))


def make_render_fn(cfg: ProjectConfig, render_idx: int = 0, batch_size: int = 1 << 15,
                   seed: int = 1, max_hits: int = None, frozen_mode: bool = False,
                   soft_tau: float = None, seed_as_arg: bool = False, device="cuda"):
    """A differentiable params -> XYZ image [H, W, 3] function.

    Scope: one scattering layer, one crystal setting, a fixed-shape prism;
    the orientation zenith is reparameterised from the params (azimuth and
    roll are the uniform draws). Per-ray randomness is fixed by the seed, so
    gradients are of a fixed Monte-Carlo estimate (common random numbers),
    which is what a finite-difference check needs.

    Returns fn(params); with seed_as_arg fn(params, seed) (seed an int or
    an int64 tensor, read as u32); with frozen_mode the pair
    (render_frozen, record): record(params) -> (img, FrozenChoices) and
    render_frozen(params, choices) re-renders with those choices reused.
    Each is a ``RenderProgram``: differentiable in params; on a CUDA device
    a captured forward and backward, replayed per call.
    """
    dev = resolve_device(device)
    pplan = projection.make_proj_plan(cfg.renders[render_idx])
    mh = max_hits if max_hits is not None else cfg.scene.max_hits
    B = batch_size
    sun = cfg.light.sun

    # Per-ray tables that depend on neither the params nor the seed.
    idx = torch.arange(B, dtype=I64, device=dev)
    wl = _f32([w.wl for w in cfg.light.spectrum], dev)
    wl_w = _f32([w.weight for w in cfg.light.spectrum], dev)
    wl_idx = idx % wl.shape[0]
    ray_wl = wl[wl_idx]
    w0 = wl_w[wl_idx]
    n_ior = optics.ice_refractive_index(ray_wl)
    cmf_rows = color.cmf_lookup(ray_wl)[None].expand(mh, B, 3).reshape(-1, 3)
    lon_s = torch.deg2rad(_f32(sun.azimuth + 180.0, dev))
    half = torch.deg2rad(_f32(sun.diameter / 2.0, dev))
    c_lon, s_lon, c_half = torch.cos(lon_s), torch.sin(lon_s), torch.cos(half)

    def render_impl(params: RenderParams, frozen=None, record=False, seed_v=None):
        p = RenderParams(*(_f32(x, dev) for x in params))
        seed_u = rng._t(seed if seed_v is None else seed_v, idx) & MASK32

        # Sun direction with a differentiable altitude: the cap rotation
        # re-derived from the parameter (sampling.sample_sun_dirs_soa's math).
        lat_s = -torch.deg2rad(p.sun_altitude_deg)
        s_sun = seed_u ^ rng.NONCE_SUN
        u = rng.uniform(s_sun, idx, 0)
        x = u + (1.0 - u) * c_half
        r = torch.sqrt(torch.clamp_min(1.0 - x * x, 0.0))
        phi = rng.uniform(s_sun, idx, 1) * TWO_PI_F
        y, z = torch.cos(phi) * r, torch.sin(phi) * r
        c_lat, s_lat = torch.cos(lat_s), torch.sin(lat_s)
        dwx = c_lon * c_lat * x - s_lon * y - c_lon * s_lat * z
        dwy = s_lon * c_lat * x + c_lon * y - s_lon * s_lat * z
        dwz = s_lat * x + c_lat * z

        # Orientation: reparameterised gauss-legacy zenith (differentiable
        # in mean and std), uniform azimuth and roll; the pole fold turns
        # lon and roll by pi.
        s_or = seed_u ^ rng.NONCE_ORIENT
        eps = rng.gaussian(s_or, idx, 2)
        lat_raw = torch.deg2rad(90.0 - (p.zenith_mean_deg + p.zenith_std_deg * eps))
        lat_o, flip = sampling.normalize_latitude(lat_raw)
        lon_o = rng.uniform(s_or, idx, 0) * TWO_PI_F
        roll_o = rng.uniform(s_or, idx, 6) * TWO_PI_F
        lon_o = torch.where(flip, lon_o + PI_F, lon_o)
        roll_o = torch.where(flip, roll_o + PI_F, roll_o)
        rot = trace_soa.rot_components(lon_o, lat_o, roll_o)

        g = geometry.prism_geom_batch(p.height.reshape(1), p.face_distance.reshape(1, 6))
        pool = trace.make_geom_pool(g, sampling.build_entry_tris(g))

        out = trace_soa.trace_layer_soa(
            seed_u, idx, (dwx, dwy, dwz), w0, rot, pool, n_ior, mh,
            score_grad=frozen is None and not record, frozen=frozen, record=record,
            soft_tau=None if (frozen is not None or record) else soft_tau)
        exits, choices = out if record else (out, None)

        flat_w = exits.w.reshape(-1)                              # [H*B]
        flat_d = torch.stack(
            [exits.dx.reshape(-1), exits.dy.reshape(-1), exits.dz.reshape(-1)], dim=-1)
        fx, fy, valid = projection.project_continuous(pplan, flat_d)
        acc = torch.zeros((pplan.height * pplan.width, 3), dtype=F32, device=dev)
        acc = projection.splat_bilinear(acc, fx, fy, valid & (flat_w > 0),
                                        cmf_rows * flat_w[:, None], pplan.width,
                                        pplan.height)
        img = acc.reshape(pplan.height, pplan.width, 3)
        return (img, choices) if record else img

    if frozen_mode:
        return (RenderProgram(lambda params, choices: render_impl(params, frozen=choices), dev,
                              "choices"),
                RenderProgram(lambda params: render_impl(params, record=True), dev))
    if seed_as_arg:
        return RenderProgram(lambda params, seed_v: render_impl(params, seed_v=seed_v), dev,
                             "seed")
    return RenderProgram(render_impl, dev)


class RenderProgram:
    """One compiled form of the differentiable render (JAX: a ``jax.jit``
    of ``render_impl``): ``prog(params)``, ``prog(params, seed)`` (`extra`
    "seed") or ``prog(params, choices)`` (`extra` "choices"), returning the
    image, or for ``record`` (image, FrozenChoices).

    On a CUDA device the first call captures the body's forward and backward
    (graph.GradGraph) with the params, the seed and the choices as static
    inputs: a seed given as a number is written into its int64 input by
    ``fill_``, never baked into the graph, and the choices are copied into
    theirs. Every later call replays (one after ``graph.invalidate``
    captures again); the result is
    differentiable in the params (a backward replays the backward graph,
    and must run before the next call of the same program). On the CPU the
    body runs eagerly.
    ``body`` is the eager body itself."""

    def __init__(self, body, device: torch.device, extra: str = None):
        self.body = body
        self.device = device
        self.extra = extra
        self.graph = None

    @property
    def graph_mode(self) -> str:
        """'cuda graph' on a CUDA device, 'eager' on the CPU."""
        return "cuda graph" if self.device.type == "cuda" else "eager"

    def _flat_body(self, *args):
        """The body over flat tensors (5 params, then the seed or the six
        choice fields), returning the image and any recorded choices flat."""
        p = RenderParams(*args[:5])
        x = args[5:]
        out = self.body(p, trace_soa.FrozenChoices(*x)) if self.extra == "choices" else \
            self.body(p, *x)
        return out if isinstance(out, torch.Tensor) else (out[0], *out[1])

    def __call__(self, params, *extra):
        if self.device.type != "cuda":
            return self.body(params, *extra)
        dev = self.device
        args = [_f32(x, dev) for x in params]
        if self.extra == "choices":
            args += list(extra[0])
        elif self.extra == "seed":
            seed = extra[0]
            args.append(seed if isinstance(seed, torch.Tensor) else int(seed) & MASK32)
        if self.graph is None or self.graph.stale:
            examples = [a if isinstance(a, torch.Tensor)
                        else torch.full((), a, dtype=I64, device=dev) for a in args]
            self.graph = None
            self.graph = graph_mod.GradGraph(self._flat_body, examples, dev, diff=range(5))
        outs = graph_mod.GradGraph.apply(self.graph, *args)
        return outs[0] if len(outs) == 1 else (outs[0], trace_soa.FrozenChoices(*outs[1:]))
