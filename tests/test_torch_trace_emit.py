"""Port trace_emit (plain twin of the CUDA trace kernel) against the JAX
trace megakernel run in the Pallas interpreter, on bench.py's BENCH_CFG at
one 2048-ray block, with the default Russian-roulette emit floor.

Tolerances:
  - rows: the (block, key) multisets must be equal; torch and XLA round a
    few transcendentals differently in the last bit, which could flip a
    float-fed decision (entry triangle, TIR, pixel floor) -- such a ray
    would move rows, and the test names it. The budget is FLIP_ROWS.
  - weights of matching rows: rtol 1e-3 per row (ulp-level differences in
    sin/cos of the orientation reach the Fresnel weights, and near the
    critical angle the weight's derivative is large: 2.5e-4 was measured);
    the per-block weight sums hold to rtol 1e-5.
  - landed and dropped weight: rtol 1e-5 (block sums in another order).

The blocked-pool mode (stochastic crystal shapes) is held against the
committed output of the JAX kernel in the Pallas interpreter on the
stochastic prism and pyramid scenes of tests/test_pallas_trace.py
(tests/data/torch_port_pool_kernel_ref.npz; the interpreter needs minutes
for these), FED THE JAX RUN'S ptbl/ttbl: keys and counts exact, weights as
above. One test re-checks the fixture's prism half against a live JAX run.
"""

import numpy as np
import pytest
import torch

import importlib.util
import os

from bench import BENCH_CFG
from ice_halo_sim_tpu.config.loader import load_project as jax_load_project
from ice_halo_sim_tpu_torch.config.loader import load_project
from ice_halo_sim_tpu_torch.core import trace_emit
from ice_halo_sim_tpu_torch.engine.simulator import Engine as TEngine

# Tier-1 runs six workers; keep each one to two torch threads.
torch.set_num_threads(2)

BATCH = 2048
FLIP_ROWS = 4
W_RTOL = 1e-3
SUM_RTOL = 1e-5


@pytest.fixture(scope="module")
def jax_engine():
    from ice_halo_sim_tpu.core import pallas_ops, pallas_scan, pallas_trace
    from ice_halo_sim_tpu.engine.simulator import Engine

    with pytest.MonkeyPatch.context() as mp:
        for mod in (pallas_trace, pallas_ops, pallas_scan):
            mp.setattr(mod, "INTERPRET", True)
        mp.delenv("IHT_MIN_EMIT_W", raising=False)
        eng = Engine(jax_load_project(BENCH_CFG), seed=7, batch_size=BATCH,
                     accum_method="sort")
        assert eng.trace_path == "pallas-megakernel", eng._kernel_reason
        yield eng


@pytest.fixture(scope="module")
def port_engine():
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("IHT_MIN_EMIT_W", raising=False)
        yield TEngine(load_project(BENCH_CFG), seed=7, batch_size=BATCH, device="cpu")


def test_plan_arrays_match_jax_trace_plan(jax_engine, port_engine):
    import jax.numpy as jnp

    from ice_halo_sim_tpu.core import color

    jp = jax_engine._trace_plan
    pa = port_engine.plan_arrays()
    # Geometry tables: closed-form prism in float32 on both sides; XLA and
    # torch round a few products/cross terms differently (1 ulp, ~6e-8 at
    # the unit scale of these coordinates).
    np.testing.assert_allclose(pa["planes"], np.asarray(jp.planes, np.float32),
                               rtol=0, atol=2e-7)
    np.testing.assert_allclose(pa["tris"], np.asarray(jp.tris, np.float32),
                               rtol=0, atol=2e-7)
    np.testing.assert_array_equal(pa["spd"], np.asarray(jp.spd, np.float32))
    assert pa["w_scale"] == jp.w_scale
    assert port_engine._trace_plan.rows_block == jp.rows_block
    assert port_engine._trace_plan.emit_cut == np.float32(jp.emit_frac * jp.w_scale)
    tbl = np.asarray(color.cmf_eval(jax_engine._wl_from_idx(
        jnp.arange(jax_engine.k_pool, dtype=jnp.uint32), jnp.uint32(0))))
    # Chebyshev evaluation: float32 Clenshaw in both, same coefficients.
    np.testing.assert_allclose(pa["basis_tbl"], tbl, rtol=1e-6, atol=1e-7)
    ap = jax_engine.layers[0].axis_params
    np.testing.assert_array_equal(pa["lut_cdf"], ap.lut_cdf[0])
    np.testing.assert_array_equal(pa["lut_flip"], ap.lut_flip[0])
    for r, pp in enumerate(jax_engine.proj_plans):
        np.testing.assert_array_equal(
            pa[f"proj_{r}"],
            [pp.lens_type, pp.width, pp.height, pp.scale, pp.r_scale, pp.max_abs_dz],
        )
        np.testing.assert_array_equal(pa[f"proj_rot_{r}"], pp.rot)


def _named_flips(port_plan, jax_rows, port_slabs, base_lo, base_hi, n_active):
    """Rays (by lane) whose uncompacted port rows hold keys absent from the
    JAX rows: the float flips the tolerance allows."""
    jk = set(np.asarray(jax_rows).view(np.uint32).ravel().tolist())
    keys = port_slabs[0][0].numpy().view(np.uint32)[0]
    nr = port_plan.nr
    lanes = sorted({i % nr for i, k in enumerate(keys)
                    if k != 0xFFFFFFFF and int(k) not in jk})
    return lanes


@pytest.mark.parametrize(
    "base_lo, base_hi, n_active",
    [(0, 0, BATCH), (0xFFFFFC00, 1, 1500)],
    ids=["batch0", "hi-epoch-wrap-tail"],
)
def test_trace_emit_matches_jax_megakernel(jax_engine, port_engine, base_lo,
                                           base_hi, n_active):
    import jax
    import jax.numpy as jnp

    run = jax.jit(jax_engine._trace_emit)
    per_render, landed, dropped, segs = run(
        jnp.uint32(base_lo), jnp.uint32(base_hi), jnp.uint32(n_active)
    )
    jax_out = [tuple(np.asarray(x) for x in pr) for pr in per_render]
    jax_out = [(k.view(np.int32), w, c) for k, w, c in jax_out]

    plan = port_engine._trace_plan
    base = (base_hi << 32) | base_lo
    out = trace_emit.trace_emit_plain(plan, base, n_active, torch.device("cpu"))
    port_out = [tuple(x.numpy() for x in pr) for pr in out[0]]
    d = trace_emit.trace_output_diff(port_out, jax_out)
    flips = []
    if d["rows_diff"]:
        slabs, *_ = trace_emit.trace_rows_plain(plan, base, n_active, torch.device("cpu"))
        flips = _named_flips(plan, jax_out[0][0], slabs, base_lo, base_hi, n_active)
    assert d["rows_diff"] <= FLIP_ROWS, (d, "flipped lanes", flips)
    assert d["blocks_diff"] == 0 or d["rows_diff"], d
    if d["rows_diff"] == 0:
        assert d["w_rel"] <= W_RTOL, d
        assert int(out[3]) == int(segs)
    else:
        assert abs(int(out[3]) - int(segs)) <= 7 * len(flips), (int(out[3]), int(segs))
    for (_, wp, _), (_, wj, _) in zip(port_out, jax_out):
        np.testing.assert_allclose(wp.astype(np.float64).sum(1),
                                   wj.astype(np.float64).sum(1), rtol=SUM_RTOL)
    np.testing.assert_allclose(out[1].numpy(), np.asarray(landed), rtol=SUM_RTOL)
    np.testing.assert_allclose(float(out[2]), float(dropped), rtol=1e-4,
                               atol=1e-6 * float(np.asarray(landed).sum()))
    assert int(port_out[0][2].sum()) > 0


# --------------------------------------------------------------------------
# Blocked-pool mode
# --------------------------------------------------------------------------

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _ref_module():
    spec = importlib.util.spec_from_file_location(
        "make_torch_port_ref", os.path.join(ROOT, "scripts", "make_torch_port_ref.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def pool_ref():
    mod = _ref_module()
    return mod, np.load(mod.KERNEL_OUT)


def _pool_engine(mod, kind):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("IHT_MIN_EMIT_W", "0")
        return TEngine(load_project(mod.stochastic_doc(kind)), seed=mod.KERNEL_SEED,
                       batch_size=mod.KERNEL_BATCH, device="cpu")


@pytest.mark.parametrize("kind", ["prism", "pyramid"])
def test_pool_trace_emit_matches_jax_kernel_on_its_tables(pool_ref, kind):
    mod, fix = pool_ref
    eng = _pool_engine(mod, kind)
    plan = eng._trace_plan
    nf = 8 if kind == "prism" else 20
    assert (plan.pool_k, plan.nf, plan.n_tris, plan.gc) == (16, nf, nf * 4, 128)
    ptbl = torch.as_tensor(fix[f"ptbl_{kind}"].copy())
    ttbl = torch.as_tensor(fix[f"ttbl_{kind}"].copy())
    base = mod.KERNEL_COUNTER * mod.KERNEL_BATCH * 2
    out = trace_emit.trace_emit_plain(plan, base, mod.KERNEL_BATCH, torch.device("cpu"),
                                      ptbl, ttbl)
    keys, w, counts = (x.numpy() for x in out[0][0])
    # Keys and counts exact (the same tables: no float-fed decision moved).
    np.testing.assert_array_equal(counts, fix[f"counts_{kind}"])
    np.testing.assert_array_equal(keys, fix[f"keys_{kind}"])
    np.testing.assert_allclose(w, fix[f"w_{kind}"], rtol=W_RTOL)
    np.testing.assert_allclose(w.astype(np.float64).sum(1),
                               fix[f"w_{kind}"].astype(np.float64).sum(1), rtol=SUM_RTOL)
    assert int(out[3]) == int(fix[f"segs_{kind}"])
    np.testing.assert_allclose(out[1].numpy(), fix[f"landed_{kind}"], rtol=SUM_RTOL)
    assert int(counts.sum()) > 0
    # The port's own sampler gives the same tables within float tolerance.
    own_p, own_t = eng._pool_tables(mod.KERNEL_COUNTER)
    np.testing.assert_allclose(own_p.numpy(), ptbl.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(own_t.numpy(), ttbl.numpy(), rtol=1e-5, atol=1e-6)


def test_pool_kernel_fixture_is_current(pool_ref):
    mod, fix = pool_ref
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("IHT_MIN_EMIT_W", "0")
        mp.setenv("IHT_PALLAS_TRACE", "auto")
        live = mod.jax_pool_kernel_reference("prism")
    for k in ("ptbl", "ttbl", "keys", "w", "counts", "landed", "segs"):
        np.testing.assert_array_equal(live[k], fix[f"{k}_prism"], err_msg=k)


def test_pool_mode_dead_slots_and_table_checks(pool_ref):
    """Absent faces and dead triangles stay in the tables: a prism pool
    padded to the 20-slot pyramid layout traces the same rays as the 8-slot
    one (the triangle rows renumbered), and wrong tables raise."""
    mod, fix = pool_ref
    eng = _pool_engine(mod, "prism")
    plan = eng._trace_plan
    ptbl = torch.as_tensor(fix["ptbl_prism"].copy())
    ttbl = torch.as_tensor(fix["ttbl_prism"].copy())
    args = (0, mod.KERNEL_BATCH, torch.device("cpu"))
    want = trace_emit.trace_emit_plain(plan, *args, ptbl, ttbl)
    import dataclasses

    wide = dataclasses.replace(plan, nf=20, n_tris=80, _cache={})
    pad_p = torch.zeros(16, 20, 5)
    pad_p[:, :8] = ptbl.view(16, 8, 5)
    pad_p[:, 8:, 3] = -1e6
    pad_t = torch.zeros(16, 80, 13)
    pad_t[:, :32] = ttbl.view(16, 32, 13)
    pad_t[:, 32:, 12] = torch.arange(32, 80) // 4
    got = trace_emit.trace_emit_plain(wide, *args, pad_p.view(16, 100).contiguous(),
                                      pad_t.view(16, 1040).contiguous())
    d = trace_emit.trace_output_diff(got[0], want[0])
    assert d == {"rows_diff": 0, "blocks_diff": 0, "w_rel": 0.0}, d
    assert int(got[3]) == int(want[3])
    with pytest.raises(ValueError, match="ptbl must be"):
        trace_emit.trace_emit(plan, *args, ptbl[:8], ttbl)
    with pytest.raises(ValueError, match="ttbl must be"):
        trace_emit.trace_emit(plan, *args, ptbl, ttbl.double())
    with pytest.raises(ValueError, match="ptbl must be"):
        trace_emit.trace_emit(plan, *args)
    static = TEngine(load_project(BENCH_CFG), seed=7, batch_size=BATCH, device="cpu")
    with pytest.raises(ValueError, match="static-geometry plan"):
        trace_emit.trace_emit(static._trace_plan, *args, ptbl, ttbl)
