#!/usr/bin/env python
"""Write the JAX engine's renders that the PyTorch port is held against
(seed 7, batch 4096, three batches: one full fold, then two calibrated
ones):

  tests/data/torch_port_bench_ref.npz  bench.py's BENCH_CFG. The JAX side
    runs its XLA trace path with the emit floor and the slot cap off
    (IHT_PALLAS_TRACE=0, IHT_MIN_EMIT_W=0, IHT_SLOT_CAP=off), which
    tests/test_pallas_trace.py holds equal to its trace megakernel.
  tests/data/torch_port_pool_ref.npz  the port's POOL_CFG (a stochastic
    pyramid, two renders). The JAX side runs its trace megakernel in
    blocked-pool mode in the Pallas interpreter (emit floor off), at the
    geom_clock of 128 that its engine moves to.

  tests/data/torch_port_pool_kernel_ref.npz  the trace megakernel alone in
    blocked-pool mode, in the Pallas interpreter, on the stochastic prism
    and pyramid scenes of tests/test_pallas_trace.py (one 2048-ray block,
    batch counter 3): the pool tables it was fed and the rows it returned.

  tests/data/torch_port_ms_ref.npz  the first layer of the port's MS_CFG as
    a scene of its own (a plate and a stochastic column, two settings; prob
    0.3 on what is now the last layer, so would-continue exits are dropped;
    both renders), through the JAX engine's XLA trace path at its default
    knobs: roulette emit floor, the slot cap and keep calibrated after the
    first batch (IHT_STEPS_PER_DISPATCH=1), sort fold.

    JAX_PLATFORMS=cpu python scripts/make_torch_port_ref.py [bench|pool|kernel|ms]
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


POOL_OUT = os.path.join(ROOT, "tests", "data", "torch_port_pool_ref.npz")
POOL_ENV = {"IHT_PALLAS_TRACE": "auto", "IHT_MIN_EMIT_W": "0", "IHT_SLOT_CAP": "off"}


def jax_pool_reference(ckpt_path=None) -> dict:
    """Run the JAX engine on POOL_CFG through its trace megakernel in the
    Pallas interpreter (env knobs in POOL_ENV must already be set)."""
    sys.path.insert(0, ROOT)
    from ice_halo_sim_tpu.config.loader import load_project
    from ice_halo_sim_tpu.core import pallas_ops, pallas_scan, pallas_trace
    from ice_halo_sim_tpu.engine.checkpoint import save_checkpoint
    from ice_halo_sim_tpu.engine.simulator import Engine
    from ice_halo_sim_tpu_torch.scenes import POOL_CFG

    mods = (pallas_trace, pallas_ops, pallas_scan)
    old = [m.INTERPRET for m in mods]
    for m in mods:
        m.INTERPRET = True
    try:
        eng = Engine(load_project(POOL_CFG), seed=SEED, batch_size=BATCH,
                     accum_method="sort")
        assert eng.trace_path == "pallas-megakernel", eng._kernel_reason
        assert eng.geom_clock == 128 and eng._trace_plan.pool_k == BATCH // 128
        eng.run(n_batches=1)
        eng.run(n_batches=1)
        if ckpt_path is not None:
            save_checkpoint(ckpt_path, eng)
        eng.run(n_batches=1)
        st = eng.drain_stats()
    finally:
        for m, v in zip(mods, old):
            m.INTERPRET = v
    return {
        "raw_xyz": eng.raw_xyz(0).astype(np.float32),
        "raw_xyz_1": eng.raw_xyz(1).astype(np.float32),
        "landed_weight": np.float64(st.landed_weight),
        "ray_segments": np.int64(st.ray_segments),
        "rays_traced": np.int64(st.rays_traced),
        "stochastic_crystal_samples": np.int64(st.stochastic_crystal_samples),
        "seed": np.int64(SEED),
        "batch_size": np.int64(BATCH),
        "n_batches": np.int64(3),
    }


KERNEL_OUT = os.path.join(ROOT, "tests", "data", "torch_port_pool_kernel_ref.npz")
KERNEL_SEED, KERNEL_BATCH, KERNEL_COUNTER = 11, 2048, 3


def stochastic_doc(kind: str) -> dict:
    """The inline scene of tests/test_pallas_trace.py (_stochastic_cfg)."""
    shape = (
        {"height": {"type": "gauss", "mean": 1.1, "std": 0.15}}
        if kind == "prism"
        else {"upper_h": {"type": "gauss", "mean": 0.3, "std": 0.05},
              "prism_h": 0.9, "lower_h": 0.3}
    )
    return {
        "crystal": [
            {"id": 1, "type": kind, "shape": shape,
             "axis": {"zenith": {"type": "gauss", "mean": 90, "std": 1.2},
                      "azimuth": {"type": "uniform", "mean": 0, "std": 360}}}
        ],
        "filter": [],
        "scene": {
            "light_source": {"type": "sun", "altitude": 25,
                             "spectrum": [{"wavelength": 550, "weight": 1.0},
                                          {"wavelength": 650, "weight": 0.8}]},
            "ray_num": 10000, "max_hits": 5,
            "scattering": [{"prob": 0.0,
                            "entries": [{"crystal": 1, "proportion": 1}]}],
        },
        "render": [{"id": 1,
                    "lens": {"type": "fisheye_equal_area", "fov": 165},
                    "resolution": [128, 64], "view": {"elevation": 90},
                    "visible": "full"}],
    }


def jax_pool_kernel_reference(kind: str) -> dict:
    """One call of the JAX trace megakernel in blocked-pool mode, in the
    Pallas interpreter (IHT_MIN_EMIT_W=0 must already be set): the pool
    tables of batch KERNEL_COUNTER as the JAX engine builds them, and the
    kernel's rows for that batch's ray base."""
    sys.path.insert(0, ROOT)
    import jax
    import jax.numpy as jnp

    from ice_halo_sim_tpu.config.loader import load_project
    from ice_halo_sim_tpu.core import pallas_ops, pallas_scan, pallas_trace
    from ice_halo_sim_tpu.engine.simulator import Engine

    mods = (pallas_trace, pallas_ops, pallas_scan)
    old = [m.INTERPRET for m in mods]
    for m in mods:
        m.INTERPRET = True
    try:
        eng = Engine(load_project(stochastic_doc(kind)), seed=KERNEL_SEED,
                     batch_size=KERNEL_BATCH, accum_method="sort")
        assert eng.trace_path == "pallas-megakernel", eng._kernel_reason
        pool = eng._sample_layer_pool(0, eng.layers[0], jnp.uint32(KERNEL_COUNTER))
        feat = jnp.concatenate(
            [pool.plane_n, pool.plane_d[..., None],
             pool.face_present.astype(jnp.float32)[..., None]], axis=-1)
        ptbl = feat.reshape(feat.shape[0], -1)
        tfeat = jnp.concatenate(
            [pool.tri_cross_half, pool.tri_v0, pool.tri_e1, pool.tri_e2,
             pool.tri_face.astype(jnp.float32)[..., None]], axis=-1)
        ttbl = tfeat.reshape(tfeat.shape[0], -1)
        base = KERNEL_COUNTER * KERNEL_BATCH * 2
        per_render, landed, dropped, segs = jax.jit(eng._trace_emit)(
            jnp.uint32(base), jnp.uint32(0), jnp.uint32(KERNEL_BATCH), ptbl, ttbl)
    finally:
        for m, v in zip(mods, old):
            m.INTERPRET = v
    keys, w, counts = per_render[0]
    return {
        "ptbl": np.asarray(ptbl), "ttbl": np.asarray(ttbl),
        "keys": np.asarray(keys).view(np.int32), "w": np.asarray(w),
        "counts": np.asarray(counts), "landed": np.asarray(landed),
        "dropped": np.float32(dropped), "segs": np.int64(segs),
    }


MS_OUT = os.path.join(ROOT, "tests", "data", "torch_port_ms_ref.npz")
MS_ENV = {"IHT_PALLAS_TRACE": "0", "IHT_FOLD": "sort", "IHT_STEPS_PER_DISPATCH": "1"}


def ms_first_layer_doc() -> dict:
    """MS_CFG cut to its first scattering layer."""
    import copy

    sys.path.insert(0, ROOT)
    from ice_halo_sim_tpu_torch.scenes import MS_CFG

    doc = copy.deepcopy(MS_CFG)
    doc["scene"]["scattering"] = doc["scene"]["scattering"][:1]
    doc["filter"] = []
    return doc


def jax_ms_reference() -> dict:
    """Run the JAX engine's XLA path on MS_CFG's first layer (env knobs in
    MS_ENV must already be set; every other knob at its default)."""
    sys.path.insert(0, ROOT)
    from ice_halo_sim_tpu.config.loader import load_project
    from ice_halo_sim_tpu.engine.simulator import Engine

    eng = Engine(load_project(ms_first_layer_doc()), seed=SEED, batch_size=BATCH,
                 accum_method="sort")
    assert eng.trace_path == "xla" and eng.fold_kind == "sort"
    eng.run(n_batches=1)
    eng.run(n_batches=2)
    st = eng.drain_stats()
    return {
        "raw_xyz": eng.raw_xyz(0).astype(np.float32),
        "raw_xyz_1": eng.raw_xyz(1).astype(np.float32),
        "landed_weight": np.float64(st.landed_weight),
        "dropped_cont_weight": np.float64(st.dropped_cont_weight),
        "ray_segments": np.int64(st.ray_segments),
        "rays_traced": np.int64(st.rays_traced),
        "stochastic_crystal_samples": np.int64(st.stochastic_crystal_samples),
        "slot_cap": np.int64(eng._slot_cap),
        "seed": np.int64(SEED),
        "batch_size": np.int64(BATCH),
        "n_batches": np.int64(3),
    }


def main(argv=None) -> int:
    which = (argv if argv is not None else sys.argv[1:]) or ["bench", "pool", "kernel", "ms"]
    if "kernel" in which:
        os.environ["IHT_MIN_EMIT_W"] = "0"
        out = {}
        for kind in ("prism", "pyramid"):
            ref = jax_pool_kernel_reference(kind)
            out.update({f"{k}_{kind}": v for k, v in ref.items()})
            print(f"{kind}: live rows {int(ref['counts'].sum())}, segments "
                  f"{int(ref['segs'])}")
        np.savez_compressed(KERNEL_OUT, **out)
        print(f"wrote {KERNEL_OUT}")
    if "bench" in which:
        os.environ.update(ENV)
        ref = jax_reference()
        np.savez_compressed(OUT, **ref)
        print(f"wrote {OUT}: image sum {ref['raw_xyz'].sum():.6g}, "
              f"segments {int(ref['ray_segments'])}")
    if "pool" in which:
        os.environ.update(POOL_ENV)
        ref = jax_pool_reference()
        np.savez_compressed(POOL_OUT, **ref)
        print(f"wrote {POOL_OUT}: image sums {ref['raw_xyz'].sum():.6g}, "
              f"{ref['raw_xyz_1'].sum():.6g}, segments {int(ref['ray_segments'])}")
    if "ms" in which:
        os.environ.update(MS_ENV)
        ref = jax_ms_reference()
        np.savez_compressed(MS_OUT, **ref)
        print(f"wrote {MS_OUT}: image sums {ref['raw_xyz'].sum():.6g}, "
              f"{ref['raw_xyz_1'].sum():.6g}, segments {int(ref['ray_segments'])}, "
              f"slot cap {int(ref['slot_cap'])}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
