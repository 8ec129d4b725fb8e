"""The port's general trace of one layer (``trace_soa.trace_layer_soa``,
forward render mode) against the JAX function on the same rays, rotations
and geometry pool, and ``compact_slots``.

The rays (directions, weights, rotation angles, refractive indices) come
from numpy with a seed; the pool is the JAX engine's sampled pool of one
batch, handed to both as the same float32 arrays.

Tolerances: the face-number path and the pattern of live slots are integer
decisions fed by float32 arithmetic that both sides do in the same order;
XLA may contract a multiply and an add where torch does not, so a ray whose
hit lies on a face edge or at the TIR limit may flip. EDGE_RAYS of the 4096
rays may differ in path or live pattern; on all other rays directions and
weights agree to rtol 1e-5, with an absolute floor besides: 1e-5 on the
direction components (unit vectors) and W_ATOL = 1e-5 of the largest
initial weight on the weights. Close to the TIR limit the refracted
direction and the reflectance go through the square root of a difference
near 0, which turns one ulp of the cosine into some 1e-5 absolute of a
direction and some 1e-4 relative of a weight that is itself small.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ice_halo_sim_tpu.config.loader import load_project as jax_load_project
from ice_halo_sim_tpu.core import trace_soa as jsoa
from ice_halo_sim_tpu.engine.simulator import Engine as JEngine
from ice_halo_sim_tpu_torch import scenes
from ice_halo_sim_tpu_torch.core import trace, trace_soa

# Tier-1 runs six workers; keep each one to two torch threads.
torch.set_num_threads(2)

B, H = 4096, 7
EDGE_RAYS = 4
W_ATOL = 1e-5 * 2.0


def _doc(case):
    doc = copy.deepcopy(scenes.BENCH_CFG)
    plate = {"id": 1, "type": "prism", "shape": {"height": 0.4},
             "axis": scenes.MS_CFG["crystal"][0]["axis"]}
    column = copy.deepcopy(scenes.MS_CFG["crystal"][1])
    pyramid = dict(copy.deepcopy(scenes.POOL_CFG["crystal"][0]), id=2)
    if case == "shared":
        return doc, 32
    if case == "stochastic":
        doc["crystal"] = [dict(column, id=1)]
    elif case == "two-settings":
        doc["crystal"] = [plate, column]
    elif case == "two-settings-nf20":
        doc["crystal"] = [plate, pyramid]
    if len(doc["crystal"]) == 2:
        doc["scene"]["scattering"] = [{"prob": 0.0, "entries": [
            {"crystal": 1, "proportion": 25}, {"crystal": 2, "proportion": 75}]}]
    return doc, 128


def _rays(seed):
    g = np.random.default_rng(seed)
    d = g.normal(size=(3, B)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0)
    lon, lat, roll = (g.uniform(0, 2 * np.pi, B).astype(np.float32) for _ in range(3))
    w0 = g.uniform(0.2, 2.0, B).astype(np.float32)
    w0[::97] = 0.0
    n_ior = g.uniform(1.305, 1.32, B).astype(np.float32)
    return d, (lon, lat * 0.5, roll), w0, n_ior


@pytest.mark.parametrize("case", ["shared", "stochastic", "two-settings", "two-settings-nf20"])
def test_trace_layer_soa_matches_jax(monkeypatch, case):
    monkeypatch.setenv("IHT_PALLAS_TRACE", "0")
    doc, gc = _doc(case)
    j = JEngine(jax_load_project(doc), seed=5, batch_size=B, accum_method="sort",
                geom_clock=gc)
    plan = j.layers[0]
    jpool = j._sample_layer_pool(0, plan, jnp.uint32(3))
    blocks = tuple(zip(plan.k_per_setting, plan.setting_counts))
    nf = 20 if case.endswith("nf20") else 8
    assert jpool.plane_n.shape[1] == nf
    assert jpool.plane_n.shape[0] == {"shared": 1, "stochastic": 32}.get(case, 1 + 24)

    d, angles, w0, n_ior = _rays(17)
    rot_j = jsoa.rot_components(*[jnp.asarray(a) for a in angles])
    rot = tuple(np.array(r) for r in rot_j)
    seed = 0x1234ABCD
    idx = (np.arange(B, dtype=np.int64) + 4_294_960_000) & 0xFFFFFFFF   # wraps past 2^32
    want = jsoa.trace_layer_soa(
        jnp.uint32(seed), jnp.asarray(idx.astype(np.uint32)),
        tuple(jnp.asarray(x) for x in d), jnp.asarray(w0), rot_j, jpool,
        jnp.asarray(n_ior), H, setting_blocks=blocks)

    pool = trace.GeomPool(*[torch.as_tensor(np.array(x)) for x in jpool])
    got = trace_soa.trace_layer_soa(
        seed, torch.as_tensor(idx), tuple(torch.as_tensor(x) for x in d),
        torch.as_tensor(w0), tuple(torch.as_tensor(r) for r in rot), pool,
        torch.as_tensor(n_ior), H, setting_blocks=blocks)

    assert tuple(got.w.shape) == (H, B) and got.path.dtype == torch.int32
    np.testing.assert_array_equal(got.entry_ok.numpy(), np.asarray(want.entry_ok))
    gpath, wpath = got.path.numpy(), np.asarray(want.path)
    glive, wlive = got.w.numpy() > 0, np.asarray(want.w) > 0
    bad = (gpath != wpath).any(axis=0) | (glive != wlive).any(axis=0)
    print(f"{case}: {int(bad.sum())} of {B} rays differ in path or live pattern")
    assert int(bad.sum()) <= EDGE_RAYS, int(bad.sum())
    ok = ~bad
    assert wlive[:, ok].sum() > 3 * B                   # the trace did trace
    assert (gpath[:, ok][~wlive[:, ok]] >= 0).all()
    np.testing.assert_allclose(got.w.numpy()[:, ok], np.asarray(want.w)[:, ok], rtol=1e-5,
                               atol=W_ATOL)
    for a, b in ((got.dx, want.dx), (got.dy, want.dy), (got.dz, want.dz)):
        a, b = a.numpy()[:, ok], np.asarray(b)[:, ok]
        np.testing.assert_allclose(a[wlive[:, ok]], b[wlive[:, ok]], rtol=1e-5, atol=1e-5)
    # fn_rec is 0 from the bounce a lane died on.
    dead_lane = np.asarray(want.w)[0] == 0
    assert (gpath[1:, dead_lane & ok & (w0 == 0)] == 0).all()


def test_lane_pool_rows_is_the_blocked_assignment():
    blocks = ((1, 1024), (0, 0), (24, 3072))
    sidx = trace_soa.lane_pool_rows(blocks, 4096, "cpu").numpy()
    assert (sidx[:1024] == 0).all()
    np.testing.assert_array_equal(sidx[1024:], 1 + np.arange(3072) // 128)
    a = np.random.default_rng(0).normal(size=(25, 6)).astype(np.float32)
    want = np.asarray(jsoa._expand_cols(jnp.asarray(a), blocks, 4096))
    np.testing.assert_array_equal(a.T[:, sidx], want)
    with pytest.raises(ValueError):
        trace_soa.lane_pool_rows(blocks, 4000, "cpu")


@pytest.mark.parametrize("cap", [1, 3, 5, 7])
def test_compact_slots_matches_jax(cap):
    """Stable live-first compaction per ray: kept rows, keep mask and live
    counts equal the JAX function's (rows past a ray's live count are
    unspecified there and not compared)."""
    g = np.random.default_rng(23)
    live = g.random((H, 1000)) < 0.45
    live[:, :3] = [[True] * 3] * H                       # full rays
    live[:, 3:6] = False                                 # empty rays
    cols = [g.normal(size=live.shape).astype(np.float32),
            g.integers(0, 1 << 31, live.shape).astype(np.int32)]
    want, wkeep, wn = jsoa.compact_slots(jnp.asarray(live), [jnp.asarray(c) for c in cols], cap)
    got, gkeep, gn = trace_soa.compact_slots(torch.as_tensor(live),
                                             [torch.as_tensor(c) for c in cols], cap)
    np.testing.assert_array_equal(gn.numpy(), np.asarray(wn))
    np.testing.assert_array_equal(gkeep.numpy(), np.asarray(wkeep))
    keep = np.asarray(wkeep)
    for a, b in zip(got, want):
        assert tuple(a.shape) == (cap, live.shape[1])
        np.testing.assert_array_equal(a.numpy()[keep], np.asarray(b)[keep])
