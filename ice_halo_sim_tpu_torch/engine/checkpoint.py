"""Checkpoint and resume of the render accumulation, in the JAX package's
format 1 (``ice_halo_sim_tpu.engine.checkpoint``), so that each package
resumes the other's file.

The file is an .npz with a JSON ``header`` (format_version, project, seed,
batch_size, geom_clock, batch_counter, stats, n_accum, slot_cap) and
``accum_0..accum_{n-1}``: one [P, 3 + L] image per render (XYZ and one Y
lane per colour class; float64 [P, 3] when a JAX sandwich engine saved it,
its dense form), then the [R] landed weights. It is written and read with
numpy alone.

A loaded engine continues the same random streams from the saved batch
counter (the host count, from which each dispatch sets the device counter).
The images go into the engine's accumulators in place, which keep their
addresses (a captured CUDA graph writes there). A JAX engine
that raised its geom_clock to 128 for a stochastic shape saved 128, so the
resumed engine samples the same pool. The saved exit-slot cap changes which
(accounted) exit rows accumulate, so the resumed engine takes it instead of
calibrating its own.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ice_halo_sim_tpu_torch.config.loader import load_project
from ice_halo_sim_tpu_torch.config.serialize import project_to_dict
from ice_halo_sim_tpu_torch.engine.simulator import DEFAULT_GEOM_CLOCK, Engine, Stats

FORMAT_VERSION = 1


def save_checkpoint(path: str, engine: Engine) -> None:
    """Write the engine's resumable state to ``path`` (.npz)."""
    stats = engine.drain_stats()
    R = len(engine.proj_plans)
    images = [a.cpu().numpy() for a in engine.accum[:-1]]
    arrays = {f"accum_{i}": a for i, a in enumerate(images)}
    arrays[f"accum_{R}"] = engine.accum[-1].cpu().numpy()
    header = {
        "format_version": FORMAT_VERSION,
        "project": project_to_dict(engine.cfg),
        "seed": engine.seed,
        "batch_size": engine.batch_size,
        "geom_clock": engine.geom_clock,
        "batch_counter": engine.batch_counter,
        "stats": stats._asdict(),
        "n_accum": R + 1,
        "slot_cap": engine._slot_cap,
    }
    np.savez_compressed(path, header=json.dumps(header), **arrays)


def load_checkpoint(path: str, device="cuda", kernels=None) -> Engine:
    """Build an Engine on `device` from a checkpoint of either package; it
    resumes where the file was saved."""
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
    landed = torch.as_tensor(landed.astype(np.float32))
    if len(arrays) != len(engine.accum):
        raise ValueError("checkpoint accumulator count mismatch")
    for saved, acc in zip(arrays[:-1], engine.accum[:-1]):
        if saved.shape != tuple(acc.shape):
            raise ValueError(
                f"checkpoint accumulator shape {saved.shape} != {tuple(acc.shape)}")
        acc.copy_(torch.as_tensor(saved.astype(np.float32)))
    engine.accum[-1].copy_(landed)
    engine.batch_counter = int(header["batch_counter"])
    fields = set(Stats._fields)
    engine.stats = Stats(**{k: v for k, v in header["stats"].items() if k in fields})
    if header.get("slot_cap") is not None and engine._trace_plan is None:
        engine._slot_cap = int(header["slot_cap"])
        engine._recompute_rows_per_render()
    return engine


# The reader of the JAX package's files is the same function.
load_jax_checkpoint = load_checkpoint
