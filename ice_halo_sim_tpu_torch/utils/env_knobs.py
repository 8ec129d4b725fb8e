"""Central registry of IHT_* environment knobs.

The reference funnels every ``LUMICE_*`` getenv through one registered site
(reference/src/util/env_knobs.hpp:34-115) and CI bans stray getenv
calls (scripts/check_policies.py:12-15). Same discipline here: all
environment-variable reads in this package go through this module, every
knob is declared in ``KNOBS`` with a docstring and read somewhere in the
package, and tests enumerate the registry (tests/test_torch_policies.py).

Knobs (all optional; unset means "use the code default"):
  IHT_BATCH_SIZE     rays a batch for the CLI and the Server when the caller
                     gives none (reference LUMICE_DISPATCH_RAY_NUM).
  IHT_GEOM_CLOCK     rays sharing one sampled crystal shape, for the CLI and
                     the Server (reference LUMICE_GEOM_CLOCK, default 32).
  IHT_PLATFORM       the torch device ("cpu" or "cuda", default "cuda") the
                     Server, and so the C API, builds its engines on.
  IHT_SEED           default RNG seed of the CLI and the Server.
  IHT_SNAPSHOT_EVERY Server pump batches between implicit stat drains.
  IHT_WL_POOL        wavelength-pool entries for a continuous spectrum
                     (power of two, reference LUMICE_WL_POOL_SIZE analog;
                     halved until the fold's (pixel, wavelength) keys pack
                     into 32 bits).
  IHT_COMPACT        "0"/"off" disables the calibrated compaction of the
                     live rows before the sort fold (``keep``).
  IHT_MIN_EMIT_W     emit-time weight floor (fraction of the batch's mean
                     initial ray weight); 0 disables.
  IHT_EMIT_FLOOR     floor mechanism: "rr" (default, unbiased Russian
                     roulette) or "drop" (biased hard drop).
  IHT_PALLAS_TRACE   "auto" (default) takes the trace kernel (K2, K2b) on
                     the scenes it takes; "0"/"off" sends every scene down
                     the general path. The name is the JAX package's.
  IHT_SLOT_CAP       per-ray exit-slot cap of the general path: "auto"
                     (calibrated; dropped tail < 1e-4 of emitted mass),
                     "off", or an integer pin. Dropped mass is accounted
                     into dropped_cont_weight.
  IHT_STEPS_PER_DISPATCH
                     batches per dispatch (default 64): the engine reads the
                     host once a dispatch, and on a CUDA device replays each
                     steady batch from a CUDA graph.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable, Dict, Optional


@dataclass(frozen=True)
class Knob:
    name: str
    doc: str
    parse: Callable[[str], object]
    lo: Optional[float] = None
    hi: Optional[float] = None


def _clamp(v, lo, hi):
    if lo is not None and v < lo:
        return lo
    if hi is not None and v > hi:
        return hi
    return v


KNOBS: Dict[str, Knob] = {
    k.name: k
    for k in [
        Knob("IHT_BATCH_SIZE", "rays a batch for the CLI and the Server when the caller "
             "gives none", int, lo=4096, hi=1 << 24),
        Knob("IHT_GEOM_CLOCK", "rays per sampled crystal shape for the CLI and the Server",
             int, lo=1, hi=64),
        Knob("IHT_PLATFORM", "the torch device ('cpu' or 'cuda') the Server and the C API "
             "build their engines on", str),
        Knob("IHT_SEED", "default RNG seed of the CLI and the Server", int, lo=0),
        Knob("IHT_SNAPSHOT_EVERY", "Server pump batches between stat drains", int, lo=1),
        Knob(
            "IHT_COMPACT",
            "disable ('0'/'off') the calibrated compaction of the live rows "
            "before the sort fold",
            str,
        ),
        Knob(
            "IHT_WL_POOL",
            "wavelength-pool entries for a continuous spectrum (power of "
            "two; reference LUMICE_WL_POOL_SIZE analog), halved until the "
            "fold's (pixel, wavelength) keys pack into 32 bits",
            int,
            lo=1,
            hi=1 << 16,
        ),
        Knob(
            "IHT_SLOT_CAP",
            "per-ray exit-slot cap of the general path: 'auto' (default — "
            "calibrate the smallest cap whose dropped live-rank tail is "
            "< 1e-4 of emitted mass), 'off' (keep all max_hits slots), or "
            "an integer pin. Dropped mass is accounted into "
            "dropped_cont_weight either way.",
            str,
        ),
        Knob(
            "IHT_MIN_EMIT_W",
            "emit-time weight floor as a fraction of the batch's mean "
            "initial ray weight; exits below it are thinned from the "
            "fold (see IHT_EMIT_FLOOR for the mechanism; net mass delta "
            "accounted into dropped weight). 0 disables. Default 1e-3.",
            float,
            lo=0.0,
            hi=0.1,
        ),
        Knob(
            "IHT_PALLAS_TRACE",
            "trace kernel (K2, K2b): 'auto' (default — taken when the scene "
            "qualifies: one layer, one crystal setting, no filter or colour "
            "class, a lens the kernel takes), '0'/'off' to send every scene "
            "down the general path",
            str,
        ),
        Knob(
            "IHT_STEPS_PER_DISPATCH",
            "batches per dispatch. The engine reads the host once a "
            "dispatch (its overflow check) and, on a CUDA device, replays "
            "each steady batch from a CUDA graph, so the grain amortises "
            "the read (reference LUMICE_DISPATCH_RAY_NUM analog). Default 64.",
            int,
            lo=1,
            hi=1024,
        ),
        Knob(
            "IHT_EMIT_FLOOR",
            "emit-floor mechanism: 'rr' (default — Russian roulette: a "
            "sub-threshold exit survives with probability w/cut at weight "
            "cut; UNBIASED, expected image identical to floorless) or "
            "'drop' (biased hard drop, ~1e-5 relative mass loss at the "
            "default threshold, mass accounted).",
            str,
        ),
    ]
}


def get(name: str, default=None):
    """Read one registered knob (the single getenv site)."""
    knob = KNOBS[name]  # KeyError = unregistered knob: a bug by policy
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    try:
        v = knob.parse(raw)
    except (TypeError, ValueError):
        return default
    if isinstance(v, (int, float)):
        v = _clamp(v, knob.lo, knob.hi)
    return v


def describe() -> str:
    return "\n".join(f"{k.name}: {k.doc}" for k in KNOBS.values())
