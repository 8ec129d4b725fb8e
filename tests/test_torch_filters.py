"""The port's ray-path filters against the JAX package's: the host-side
canonical forms and plans, and the slot-major match on tensors. Every stage
is integer (the direction filter compares a float32 dot product with a
constant), so verdicts must be equal."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ice_halo_sim_tpu.config import schema as jschema
from ice_halo_sim_tpu.core import filters as jfilters
from ice_halo_sim_tpu_torch.config import schema
from ice_halo_sim_tpu_torch.core import filters

# Tier-1 runs six workers; keep each one to two torch threads.
torch.set_num_threads(2)

SYMS = ["".join(c) for n in range(4) for c in itertools.combinations("PBD", n)]


def _sym(mod, text):
    s = mod.Symmetry.NONE
    for ch in text:
        s |= getattr(mod.Symmetry, ch)
    return s


def _axis(mod, roll_mean=30.0, az_uniform=True):
    d = mod.Distribution
    full = d(type=mod.DistType.UNIFORM, center=0.0, spread=360.0)
    return mod.AxisDistribution(
        azimuth=full if az_uniform else d(type=mod.DistType.GAUSS, center=10.0, spread=5.0),
        latitude=d(type=mod.DistType.GAUSS, center=0.0, spread=1.0),
        roll=d(type=mod.DistType.NO_RANDOM, center=roll_mean, spread=0.0),
    )


PATHS = [(3, 5), (1, 3, 2), (4, 1, 8, 2, 6), (13, 25, 2), (2,), (7, 3, 1, 24, 16)]


@pytest.mark.parametrize("sym", SYMS, ids=[s or "none" for s in SYMS])
def test_reduce_raypath_and_plans_match_jax(sym):
    """reduce_raypath on every subset of P, B, D (D applicable and not), and
    build_filter_plan for a raypath filter: equal canonical forms."""
    for path in PATHS:
        for sigma_a, d_app in ((0, False), (2, True), (5, True)):
            assert filters.reduce_raypath(path, _sym(schema, sym), sigma_a, d_app) == \
                jfilters.reduce_raypath(path, _sym(jschema, sym), sigma_a, d_app)
    for roll_mean, az_uniform in ((30.0, True), (60.0, True), (45.0, True), (30.0, False)):
        ax, jax_ = _axis(schema, roll_mean, az_uniform), _axis(jschema, roll_mean, az_uniform)
        assert filters.is_d_applicable(ax) == jfilters.is_d_applicable(jax_)
        assert filters.compute_sigma_a(roll_mean) == jfilters.compute_sigma_a(roll_mean)
        for path in PATHS:
            f = schema.FilterConfig(id=1, param=schema.RaypathFilter(raypath=path),
                                    symmetry=_sym(schema, sym),
                                    action=schema.FilterAction.FILTER_IN)
            jf = jschema.FilterConfig(id=1, param=jschema.RaypathFilter(raypath=path),
                                      symmetry=_sym(jschema, sym),
                                      action=jschema.FilterAction.FILTER_IN)
            p = filters.build_filter_plan(f, ax, {1: f}, 1)
            jp = jfilters.build_filter_plan(jf, jax_, {1: jf}, 1)
            s, js = p.clauses[0][0], jp.clauses[0][0]
            assert (s.kind, s.canonical, s.sigma_a, s.d_applicable, int(s.symmetry)) == \
                (js.kind, js.canonical, js.sigma_a, js.d_applicable, int(js.symmetry))


def _exits(seed, faces, H=6, B=3000):
    """Random [H, B] face-number paths, live slots and unit directions. Paths
    cycle through short popular raypaths so that matches do occur."""
    g = np.random.default_rng(seed)
    path = g.choice(np.asarray(faces, np.int32), size=(H, B)).astype(np.int32)
    for i, p in enumerate(PATHS):
        if all(f in faces for f in p):
            cols = slice(i * 200, i * 200 + 150)
            path[:len(p), cols] = np.asarray(p, np.int32)[:, None]
    # A dead lane records face 0 from its death on.
    depth = g.integers(1, H + 1, B)
    path = np.where(np.arange(H)[:, None] < depth[None, :], path, 0).astype(np.int32)
    live = (g.random((H, B)) < 0.7) & (np.arange(H)[:, None] < depth[None, :])
    d = g.normal(size=(3, H, B)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0)
    return path, live, d


def _filter_set(mod, sym):
    F, A = mod.FilterConfig, mod.FilterAction
    s = _sym(mod, sym)
    return {
        1: F(id=1, param=mod.RaypathFilter(raypath=(3, 5)), symmetry=s, action=A.FILTER_IN),
        2: F(id=2, param=mod.RaypathFilter(raypath=(1, 3, 2)), symmetry=s, action=A.FILTER_OUT),
        3: F(id=3, param=mod.EntryExitFilter(entry=3, exit=5, min_len=2, max_len=4),
             symmetry=s, action=A.FILTER_IN),
        4: F(id=4, param=mod.EntryExitFilter(entry=None, exit=1, min_len=1, max_len=None),
             symmetry=s, action=A.FILTER_IN),
        5: F(id=5, param=mod.DirectionFilter(az=40.0, el=20.0, radii=50.0),
             symmetry=mod.Symmetry.NONE, action=A.FILTER_IN),
        6: F(id=6, param=mod.CrystalFilter(crystal_id=2), symmetry=mod.Symmetry.NONE,
             action=A.FILTER_IN),
        7: F(id=7, param=mod.NoneFilter(), symmetry=mod.Symmetry.NONE, action=A.FILTER_OUT),
        8: F(id=8, param=mod.ComplexFilter(composition=((1, 5), (3,), (6, 4))),
             symmetry=mod.Symmetry.NONE, action=A.FILTER_IN),
        9: F(id=9, param=mod.ComplexFilter(composition=((4, 5), (2,))),
             symmetry=mod.Symmetry.NONE, action=A.FILTER_OUT),
        10: F(id=10, param=mod.EntryExitFilter(entry=None, exit=None, min_len=2, max_len=3),
              symmetry=s, action=A.FILTER_IN),
    }


@pytest.mark.parametrize("faces", ["prism", "pyramid"])
@pytest.mark.parametrize("sym", ["", "P", "PB", "PBD", "D"])
def test_check_exits_prefix_soa_matches_jax(faces, sym):
    """All five simple kinds, two complex filters and filter_out, on random
    paths over faces 1-8 and over the pyramid's face numbers: exact."""
    face_set = list(range(1, 9)) if faces == "prism" else \
        [1, 2] + list(range(3, 9)) + list(range(13, 19)) + list(range(23, 29))
    path, live, d = _exits(7 + len(sym), face_set)
    tp, tl = torch.as_tensor(path), torch.as_tensor(live)
    td = tuple(torch.as_tensor(x) for x in d)
    jd = tuple(jnp.asarray(x) for x in d)
    fset, jfset = _filter_set(schema, sym), _filter_set(jschema, sym)
    ax, jax_ = _axis(schema), _axis(jschema)
    n_match = 0
    for fid in fset:
        for crystal in (1, 2):
            plan = filters.build_filter_plan(fset[fid], ax, fset, crystal)
            jplan = jfilters.build_filter_plan(jfset[fid], jax_, jfset, crystal)
            got = filters.check_exits_prefix_soa(plan, tp, tl, td)
            want = jfilters.check_exits_prefix_soa(jplan, jnp.asarray(path),
                                                   jnp.asarray(live), jd)
            assert got.dtype == torch.bool and tuple(got.shape) == path.shape
            np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=str(fid))
            n_match += int(got.sum())
    assert n_match > 0
    assert bool(filters.check_exits_prefix_soa(None, tp, tl, td).all())


def test_reduce_paths_t_matches_jax():
    path, live, _ = _exits(3, list(range(1, 9)) + [13, 15, 23, 28])
    valid = np.broadcast_to(live[-1][None, :], path.shape)
    for sym in SYMS:
        got = filters.reduce_paths_t(torch.as_tensor(path), torch.as_tensor(valid.copy()),
                                     _sym(schema, sym), 2, True)
        want = jfilters.reduce_paths_t(jnp.asarray(path), jnp.asarray(valid),
                                       _sym(jschema, sym), 2, True)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=sym)
