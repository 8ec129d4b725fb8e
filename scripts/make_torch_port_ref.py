#!/usr/bin/env python
"""Write tests/data/torch_port_bench_ref.npz: the JAX engine's render of
bench.py's BENCH_CFG (seed 7, batch 4096, three batches: one full fold,
then two calibrated ones) for the PyTorch port to be held against.

The JAX side runs its XLA trace path with the emit floor and the slot cap
off (IHT_PALLAS_TRACE=0, IHT_MIN_EMIT_W=0, IHT_SLOT_CAP=off), which
tests/test_pallas_trace.py holds equal to its trace megakernel.

    JAX_PLATFORMS=cpu python scripts/make_torch_port_ref.py
"""

from __future__ import annotations

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "data", "torch_port_bench_ref.npz")
SEED = 7
BATCH = 4096
ENV = {"IHT_PALLAS_TRACE": "0", "IHT_MIN_EMIT_W": "0", "IHT_SLOT_CAP": "off"}


def jax_reference(ckpt_path=None) -> dict:
    """Run the JAX engine (env knobs in ENV must already be set). With
    ckpt_path, a checkpoint is saved after the second batch."""
    sys.path.insert(0, ROOT)
    from bench import BENCH_CFG
    from ice_halo_sim_tpu.config.loader import load_project
    from ice_halo_sim_tpu.engine.checkpoint import save_checkpoint
    from ice_halo_sim_tpu.engine.simulator import Engine

    eng = Engine(load_project(BENCH_CFG), seed=SEED, batch_size=BATCH,
                 accum_method="sort")
    assert eng.trace_path == "xla"
    eng.run(n_batches=1)
    eng.run(n_batches=1)
    if ckpt_path is not None:
        save_checkpoint(ckpt_path, eng)
    eng.run(n_batches=1)
    st = eng.drain_stats()
    return {
        "raw_xyz": eng.raw_xyz(0).astype(np.float32),
        "landed_weight": np.float64(st.landed_weight),
        "ray_segments": np.int64(st.ray_segments),
        "rays_traced": np.int64(st.rays_traced),
        "seed": np.int64(SEED),
        "batch_size": np.int64(BATCH),
        "n_batches": np.int64(3),
    }


def main() -> int:
    os.environ.update(ENV)
    ref = jax_reference()
    np.savez_compressed(OUT, **ref)
    print(f"wrote {OUT}: image sum {ref['raw_xyz'].sum():.6g}, "
          f"segments {int(ref['ray_segments'])}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
