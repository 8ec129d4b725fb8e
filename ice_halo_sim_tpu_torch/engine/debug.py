"""Debug ray dump (port of ``ice_halo_sim_tpu.engine.debug``): trace one
layer's width of rays with the engine's own plan (its pools, orientations
and RNG streams) through the AoS trace (core/trace.py) and return every
exit as host records, ready to print or to assert on.

The dump draws from its own stream, far from the render's: ray indices
0xDEB0_0000 + lane, the pool sampled at batch counter 0xDEB0, the
wavelengths from the engine's scalar seed. It reads the engine and changes
nothing in it, so a render after a dump equals one without, bit for bit.
It runs on the engine's device; the records come back as numpy arrays.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ice_halo_sim_tpu_torch.core import optics, sampling, trace
from ice_halo_sim_tpu_torch.core import rng as rng_mod
from ice_halo_sim_tpu_torch.core.bits import I64, MASK32

DEBUG_EPOCH = 0xDEB0_0000
DEBUG_COUNTER = 0xDEB0


class RayRecord(NamedTuple):
    """One row per exit event (the fields of the reference's exit record)."""

    ray_idx: np.ndarray      # [N] source ray lane
    exit_slot: np.ndarray    # [N] bounce index at exit
    direction: np.ndarray    # [N, 3] world exit direction
    weight: np.ndarray       # [N]
    wavelength: np.ndarray   # [N] nm
    path: np.ndarray         # [N, max_hits] face numbers (0-padded)
    path_len: np.ndarray     # [N]


class DumpInputs(NamedTuple):
    """What the dump traces for one layer: its u32 seed, the rays [B] of
    the layer's whole width (indices, world directions, initial weights,
    wavelengths, refractive indices), their orientation angles (radians)
    and the layer's pool."""

    layer_seed: int
    ray_idx: torch.Tensor
    d_world: torch.Tensor   # [B, 3]
    w0: torch.Tensor
    wavelength: torch.Tensor
    n_ior: torch.Tensor
    lon: torch.Tensor
    lat: torch.Tensor
    roll: torch.Tensor
    pool: trace.GeomPool


def dump_inputs(engine, layer: int = 0) -> DumpInputs:
    """The rays, orientations and pool that ``dump_rays`` traces."""
    plan = engine.layers[layer]
    B = len(plan.setting_idx)
    seed0 = engine.seed
    layer_seed = (seed0 ^ (0xA5A5 * (layer + 1))) & MASK32
    lane = torch.arange(B, dtype=I64, device=engine.device)
    ray_idx = (DEBUG_EPOCH + lane) & MASK32

    wl, w0, _ = engine._wavelength_draw(ray_idx, seed0)
    sun = engine.cfg.light.sun
    d_world = sampling.sample_sun_dirs(seed0 ^ rng_mod.NONCE_SUN, ray_idx, sun.azimuth,
                                       sun.altitude, sun.diameter)
    pool = engine._sample_layer_pool(DEBUG_COUNTER, li=layer)

    angles = []
    off = 0
    for s, c in enumerate(plan.setting_counts):
        c = min(c, max(0, B - off))
        if c == 0:
            continue
        angles.append(sampling.sample_lat_lon_roll_row(
            layer_seed ^ rng_mod.NONCE_ORIENT, ray_idx[off:off + c], plan.axis_params, s))
        off += c
    lon, lat, roll = (torch.cat(a) for a in zip(*angles))
    return DumpInputs(layer_seed, ray_idx, d_world, w0, wl,
                      optics.ice_refractive_index(wl), lon, lat, roll, pool)


def dump_rays(engine, n_rays: int = 256, layer: int = 0,
              min_weight: float = 1e-6) -> RayRecord:
    """Trace the first ``n_rays`` of one layer of the engine's plan and
    return every exit with weight above ``min_weight``. The pool's blocked
    ray -> shape map needs the layer's whole width, so the dump traces all
    of it and keeps the first n_rays rays' records."""
    inp = dump_inputs(engine, layer)
    B = inp.ray_idx.shape[0]
    keep = min(int(n_rays), B)
    rot = sampling.build_rotation(inp.lon, inp.lat, inp.roll)
    exits = trace.trace_layer(inp.layer_seed, inp.ray_idx, inp.d_world, inp.w0, rot, None,
                              inp.pool, inp.n_ior, engine.max_hits)

    w = exits.w[:keep].cpu().numpy()                  # [keep, H]
    d = exits.d_world[:keep].cpu().numpy()            # [keep, H, 3]
    plen = exits.path_len[:keep].cpu().numpy()
    path = exits.path[:keep].cpu().numpy()            # [keep, H]
    ray_i, slot = np.nonzero(w > min_weight)
    rec_len = plen[ray_i, slot]
    head = np.arange(engine.max_hits)[None, :] < rec_len[:, None]
    return RayRecord(
        ray_idx=ray_i.astype(np.int64),
        exit_slot=slot.astype(np.int32),
        direction=d[ray_i, slot],
        weight=w[ray_i, slot],
        wavelength=inp.wavelength[:keep].cpu().numpy()[ray_i],
        path=np.where(head, path[ray_i], 0).astype(path.dtype),
        path_len=rec_len.astype(np.int32),
    )


def format_rays(rec: RayRecord, limit: int = 20) -> str:
    """Human-readable table of the first `limit` records."""
    lines = ["ray  slot  weight    wl     path                      direction"]
    for k in range(min(limit, len(rec.ray_idx))):
        p = "-".join(str(int(x)) for x in rec.path[k, : rec.path_len[k]])
        d = rec.direction[k]
        lines.append(
            f"{rec.ray_idx[k]:<4d} {rec.exit_slot[k]:<5d} "
            f"{rec.weight[k]:<9.4f} {rec.wavelength[k]:<6.1f} {p:<25s} "
            f"({d[0]:+.3f}, {d[1]:+.3f}, {d[2]:+.3f})"
        )
    if len(rec.ray_idx) > limit:
        lines.append(f"... {len(rec.ray_idx) - limit} more")
    return "\n".join(lines)
