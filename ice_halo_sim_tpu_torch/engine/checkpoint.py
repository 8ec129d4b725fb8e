"""Resume a JAX-package checkpoint in the port.

The JAX package's checkpoint (``ice_halo_sim_tpu.engine.checkpoint``) is an
.npz with a JSON ``header`` (format_version, project, seed, batch_size,
geom_clock, batch_counter, stats, n_accum, slot_cap) and
``accum_0..accum_{n-1}``: one [P, 3 + L] image per render (XYZ and one Y lane
per colour class; float64 [P, 3] when a sandwich engine saved it), then the
[R] landed weights. A port engine on the sandwich fold takes the images into
its settled host images, any other into its dense accumulators. It is read here with numpy
alone; the returned port Engine continues the same random streams from the
saved batch counter. A JAX engine that raised its geom_clock to 128 for a
stochastic shape saved 128, so the resumed engine samples the same pool.
The saved exit-slot cap changes which (accounted) exit rows accumulate, so
the resumed engine takes it instead of calibrating its own.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ice_halo_sim_tpu_torch.config.loader import load_project
from ice_halo_sim_tpu_torch.engine.simulator import DEFAULT_GEOM_CLOCK, Engine, Stats

FORMAT_VERSION = 1


def load_jax_checkpoint(path: str, device="cuda", kernels=None) -> Engine:
    with np.load(path, allow_pickle=False) as data:
        header = json.loads(str(data["header"]))
        if header["format_version"] != FORMAT_VERSION:
            raise ValueError(
                f"checkpoint format {header['format_version']} != {FORMAT_VERSION}"
            )
        cfg = load_project(header["project"])
        engine = Engine(cfg, seed=header["seed"], batch_size=header["batch_size"],
                        device=device, kernels=kernels,
                        geom_clock=header.get("geom_clock", DEFAULT_GEOM_CLOCK))
        arrays = [np.asarray(data[f"accum_{i}"]) for i in range(header["n_accum"])]
    landed = arrays[-1]
    if landed.shape != tuple(engine.accum[-1].shape):
        raise ValueError(f"checkpoint landed shape {landed.shape} mismatch")
    landed = torch.as_tensor(landed.astype(np.float32)).to(engine.device)
    if engine._sandwich_on:
        # Dense images into a sandwich engine: the mass goes to the settled
        # host images (float64, as a sandwich engine saves them); the tiles
        # on the device stay zero.
        if len(arrays) != len(engine.proj_plans) + 1:
            raise ValueError("checkpoint accumulator count mismatch")
        for saved, p in zip(arrays[:-1], engine.proj_plans):
            want = (p.height * p.width, 3)
            if tuple(saved.shape[:2]) != want:
                raise ValueError(f"checkpoint accumulator shape {saved.shape} != {want}")
        engine._settled = [np.asarray(a, np.float64)[:, :3] for a in arrays[:-1]]
        engine.accum = engine.accum[:-1] + [landed]
    else:
        if len(arrays) != len(engine.accum):
            raise ValueError("checkpoint accumulator count mismatch")
        accum = []
        for saved, fresh in zip(arrays[:-1], engine.accum[:-1]):
            if saved.shape != tuple(fresh.shape):
                raise ValueError(
                    f"checkpoint accumulator shape {saved.shape} != {tuple(fresh.shape)}")
            accum.append(torch.as_tensor(saved.astype(np.float32)).to(engine.device))
        engine.accum = accum + [landed]
    engine.batch_counter = int(header["batch_counter"])
    fields = set(Stats._fields)
    engine.stats = Stats(**{k: v for k, v in header["stats"].items() if k in fields})
    if header.get("slot_cap") is not None and engine._trace_plan is None:
        engine._slot_cap = int(header["slot_cap"])
        engine._recompute_rows_per_render()
    return engine

