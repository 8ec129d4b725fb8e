"""The port's sandwich fold against the JAX package's, on the CPU.

Kernel level: ``sandwich_pass_plain`` (the plain version of K7 and K8, with
the kernels' bf16 rounding) against the JAX Pallas kernels in interpret mode,
both layouts, ``precise`` on and off; against the exact oracle and a bincount
at the JAX tests' tolerances; the probe forms P1 and P2.

Engine level: with the CPU test hook on (the counterpart of the JAX module's
INTERPRET), the port's engine folds by sandwich through the plain version and
is held against its own scatter oracle and against the JAX engine under
interpret mode: equal startup levels, equal rows-per-chunk histogram at
calibration, equal planned levels with the JAX cost constants patched in, an
image within the bf16 tolerance; demotion and level overflow; every
condition that makes a scene ineligible; checkpoints of a JAX sandwich
engine; and the dense-value fold of keys that do not pack.

Tolerances. Tile entries against the JAX kernel: rtol 1e-5, atol 1e-5 of the
maximum (float32 sums in another order; both sides round to bf16 at the same
place); ``matched`` equal. Against the exact oracle: 6e-3 (one bf16 term),
1e-4 (two). Engine against the scatter oracle: image mass 2e-3, L1 6e-3 (bf16
rounding of each row's values, about 0.4% per row, averaging down per pixel),
landed weight rtol 1e-6.
"""

import functools
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ice_halo_sim_tpu.config.loader import load_project as jax_load_project
from ice_halo_sim_tpu.core import pallas_sandwich as ps
from ice_halo_sim_tpu.engine import checkpoint as jcheckpoint
from ice_halo_sim_tpu.engine.simulator import Engine as JEngine
from ice_halo_sim_tpu_torch import probe_sandwich, probe_scatter
from ice_halo_sim_tpu_torch.config.loader import load_project
from ice_halo_sim_tpu_torch.core import sandwich
from ice_halo_sim_tpu_torch.engine.checkpoint import load_jax_checkpoint
from ice_halo_sim_tpu_torch.engine.simulator import Engine

# Tier-1 runs six workers; keep each one to two torch threads.
torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NLO = sandwich.NLO
COST_NAMES = ("_C_PREP", "_C_BASE", "_C_CHUNKROW", "_C_PACK", "_C_SORT_FIX", "_C_SORT_ROW")


@pytest.fixture()
def interpret(monkeypatch):
    """Both packages fold by sandwich on the CPU: the JAX kernels through the
    Pallas interpreter, the port through its plain version."""
    monkeypatch.setattr(ps, "INTERPRET", True)
    monkeypatch.setattr(sandwich, "CPU_TEST_HOOK", True)


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    # The general trace path in both packages; the JAX engine calibrates after
    # its first batch, as the port does.
    monkeypatch.setenv("IHT_PALLAS_TRACE", "0")
    monkeypatch.setenv("IHT_STEPS_PER_DISPATCH", "1")
    monkeypatch.delenv("IHT_FOLD", raising=False)


def _script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "scripts", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rows(n, P, K, seed=0, dead_frac=0.3, c_out=3):
    rng = np.random.default_rng(seed)
    pix = rng.integers(0, P, n).astype(np.int32)
    dead = rng.random(n) < dead_frac
    pix[dead] = -1
    w = (rng.random(n) * 2).astype(np.float32)
    w[dead] = 0.0
    wl = rng.integers(0, K, n).astype(np.int32)
    tbl = rng.random((K, c_out)).astype(np.float32)
    return pix, w, wl, tbl


def _t(*arrays):
    return tuple(torch.as_tensor(a) for a in arrays)


def _jax_pass(cl, pix, w, wl, tbl, K, layout, precise, rb=512):
    c_out = tbl.shape[1]
    tile0 = jnp.zeros((len(cl), c_out * NLO), jnp.float32)
    prepped = ps.prep_rows(jnp.asarray(pix), jnp.asarray(w), jnp.asarray(wl), rb, layout=layout)
    out, m = ps.sandwich_pass_prepped(tile0, jnp.asarray(cl), prepped, jnp.asarray(tbl),
                                      k_pool=K, precise=precise)
    return np.asarray(out), np.asarray(m)


def _plain_pass(cl, pix, w, wl, tbl, K, precise, layout="lane"):
    tile0 = torch.zeros((len(cl), tbl.shape[1] * NLO))
    out, m = sandwich.sandwich_pass(tile0, *_t(cl, pix, w, wl, tbl), k_pool=K,
                                    precise=precise, layout=layout)
    return out.numpy(), m.numpy()


def _assert_tiles_close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max() + 1e-30))


def _bincount_img(pix, w, wl, tbl, P):
    return probe_sandwich.bincount_image(pix, w, wl, tbl, P)


# --------------------------------------------------------------------------
# Kernel level
# --------------------------------------------------------------------------

@pytest.mark.parametrize("precise", [False, True])
@pytest.mark.parametrize("layout", ["lane", "sublane"])
def test_plain_matches_jax_kernel_interpret(interpret, layout, precise):
    P, K, n = 16 * NLO, 16, 3 * 512
    pix, w, wl, tbl = _rows(n, P, K, seed=3)
    cl = np.asarray([5, 2, 11, 0, 7, 15, -1, -1], np.int32)   # shuffled, two padding slots
    want, wm = _jax_pass(cl, pix, w, wl, tbl, K, layout, precise)
    got, gm = _plain_pass(cl, pix, w, wl, tbl, K, precise, layout)
    np.testing.assert_array_equal(gm, wm)
    assert gm.dtype == np.int32 and gm.sum() > 0
    _assert_tiles_close(got, want)


@pytest.mark.parametrize("case", ["count-tile", "ragged-n", "all-dead", "no-match"])
def test_plain_matches_jax_kernel_special_cases(interpret, case):
    """One channel with an all-ones table (the calibration count tile), a row
    count that is no multiple of any block, an all-dead input, and a list
    that holds none of the rows' chunks."""
    P, K = 16 * NLO, 16
    n = 1000 if case == "ragged-n" else 1024
    pix, w, wl, tbl = _rows(n, P, K, seed=11, c_out=1 if case == "count-tile" else 3)
    cl = np.asarray([5, 2, 11, 0, 7, 15, -1, 3], np.int32)
    if case == "count-tile":
        tbl = np.ones((K, 1), np.float32)
        w = (w > 0).astype(np.float32)
    elif case == "all-dead":
        pix[:] = -1
        w[:] = 0.0
    elif case == "no-match":
        pix = np.where(pix >= 0, pix % NLO + 9 * NLO, pix).astype(np.int32)  # chunk 9 only
    want, wm = _jax_pass(cl, pix, w, wl, tbl, K, "lane", False)
    got, gm = _plain_pass(cl, pix, w, wl, tbl, K, False)
    np.testing.assert_array_equal(gm, wm)
    _assert_tiles_close(got, want)
    if case == "count-tile":
        # Counts are exact: ones survive bf16, and float32 holds the sums.
        live = (pix >= 0) & np.isin(pix // NLO, cl[cl >= 0])
        assert got.sum() == live.sum() and np.array_equal(got, want)
    if case in ("all-dead", "no-match"):
        assert gm.sum() == 0 and not got.any()


@pytest.mark.parametrize("precise", [False, True])
def test_plain_matches_oracle_and_bincount(precise):
    P, K, n = 16 * NLO, 16, 3 * 512
    pix, w, wl, tbl = _rows(n, P, K, seed=3)
    cl = np.asarray([5, 2, 11, 0, 7, 15, -1, -1], np.int32)
    tile0 = jnp.zeros((8, 3 * NLO), jnp.float32)
    want, wm = ps.sandwich_oracle(tile0, jnp.asarray(cl), jnp.asarray(pix), jnp.asarray(w),
                                  jnp.asarray(wl), jnp.asarray(tbl))
    got, gm = _plain_pass(cl, pix, w, wl, tbl, K, precise)
    np.testing.assert_array_equal(gm, np.asarray(wm))
    tol = 1e-4 if precise else 6e-3
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol,
                               atol=tol * float(np.abs(np.asarray(want)).max() + 1))
    # The whole image over an iota list against an exact bincount.
    full = np.arange(16, dtype=np.int32)
    out, m = _plain_pass(full, pix, w, wl, tbl, K, precise)
    np.testing.assert_array_equal(m, ((pix >= 0) & (pix < P)).astype(np.int32))
    img = sandwich.assemble_image([(out, full)], P, 3)
    ref = _bincount_img(pix, w, wl, tbl, P)
    np.testing.assert_allclose(img, ref, rtol=tol, atol=tol * float(ref.max()))
    np.testing.assert_array_equal(
        img, ps.assemble_image([(out, full)], P, 3))


def test_two_pass_split_is_exact():
    """A pass over some chunks and all rows, then a pass over the other
    chunks and only the rows the first one missed, give the whole image."""
    P, K, n = 12 * NLO, 8, 2048
    pix, w, wl, tbl = _rows(n, P, K, seed=9, dead_frac=0.2)
    hot = np.asarray([3, 0, 9, 10], np.int32)
    cold = np.asarray([1, 2, 4, 5, 6, 7, 8, 11], np.int32)
    hot_tile, m = _plain_pass(hot, pix, w, wl, tbl, K, True)
    np.testing.assert_array_equal(m == 1, np.isin(pix // NLO, hot))
    pix_c = np.where(m == 1, -1, pix).astype(np.int32)
    w_c = np.where(m == 1, 0.0, w).astype(np.float32)
    cold_tile, _ = _plain_pass(cold, pix_c, w_c, wl, tbl, K, True)
    img = sandwich.assemble_image([(hot_tile, hot), (cold_tile, cold)], P, 3)
    np.testing.assert_allclose(img, _bincount_img(pix, w, wl, tbl, P), rtol=2e-5, atol=1e-4)


def test_sandwich_iota_plain_matches_probe_kernel(monkeypatch):
    """P1: the probe's kernel (iota list, no matched) in interpret mode."""
    from jax.experimental import pallas as pl

    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    probe = _script("probe_sandwich")
    NHI, K, RB, n = 8, 16, 512, 2 * 512
    pix, w, wl, tbl = _rows(n, 12 * NLO, K, seed=5)      # chunks 8..11 are outside the tile
    run = probe.make_sandwich(NHI, NLO, RB, K)
    want = np.asarray(run(jnp.asarray(pix), jnp.asarray(w), jnp.asarray(wl.astype(np.uint32)),
                          jnp.asarray(tbl)))
    got = probe_sandwich.sandwich_iota(*_t(pix, w, wl, tbl), nhi=NHI, k_pool=K).numpy()
    assert got.shape == (NHI, 3 * NLO)
    _assert_tiles_close(got, want)
    img = sandwich.assemble_image([(got, np.arange(NHI))], NHI * NLO, 3)
    ref = _bincount_img(pix, w, wl, tbl, 12 * NLO)[:NHI * NLO]
    assert np.abs(img - ref).sum() / ref.sum() < 6e-3


def test_extract_blocks_plain_matches_np_reference():
    """P2: forward-overwrite block scatter; also as the gather that the CUDA
    kernel computes (the block scatter's plain version)."""
    from ice_halo_sim_tpu_torch.core import block_ops

    probe = _script("probe_pallas_scatter")
    vals, start, n_out, block = probe_scatter.probe_inputs("cpu", seed=3, n_out=8192,
                                                           block=1024, n_rows=24 * 1024)
    assert vals.shape == (24, 1024) and bool((start[1:] >= start[:-1]).all())
    want = probe.np_reference(vals.numpy(), start.numpy(), n_out, block)
    got = probe_scatter.extract_blocks(vals, start, n_out, block)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        block_ops.scatter_blocks_plain(vals, start, n_out, block).numpy(), want)
    # A start at the end of the output, and equal starts: the later block wins.
    start2 = torch.tensor([0, 100, 100, n_out], dtype=torch.int32)
    want2 = probe.np_reference(vals[:4].numpy(), start2.numpy(), n_out, block)
    np.testing.assert_array_equal(
        probe_scatter.extract_blocks(vals[:4], start2, n_out, block).numpy(), want2)
    np.testing.assert_array_equal(
        block_ops.scatter_blocks_plain(vals[:4], start2, n_out, block).numpy(), want2)


# --------------------------------------------------------------------------
# Engine level
# --------------------------------------------------------------------------

def _mini_cfg(res):
    return {
        "crystal": [
            {"id": 1, "type": "prism", "shape": {"height": 1.2},
             "axis": {"zenith": {"type": "uniform", "mean": 90, "std": 360},
                      "azimuth": {"type": "uniform", "mean": 0, "std": 360}}}
        ],
        "filter": [],
        "scene": {
            "light_source": {"type": "sun", "altitude": 20, "spectrum": "D65"},
            "ray_num": 100000, "max_hits": 5,
            "scattering": [{"prob": 0.0, "entries": [{"crystal": 1, "proportion": 10}]}],
        },
        "render": [
            {"id": 1, "lens": {"type": "fisheye_equal_area", "fov": 165},
             "resolution": list(res), "view": {"elevation": 90}, "visible": "full"},
        ],
    }


def _port(res, seed=3, **kw):
    return Engine(load_project(_mini_cfg(res)), seed=seed, batch_size=1 << 12, device="cpu",
                  **kw)


def _levels_np(eng):
    return [[(np.asarray(cl.cpu() if isinstance(cl, torch.Tensor) else cl), keep)
             for cl, keep in levels] for levels in eng._levels]


def _assert_levels_equal(a, b):
    la, lb = _levels_np(a), _levels_np(b)
    assert [[k for _, k in lv] for lv in la] == [[k for _, k in lv] for lv in lb]
    for lv_a, lv_b in zip(la, lb):
        for (ca, _), (cb, _) in zip(lv_a, lv_b):
            np.testing.assert_array_equal(ca, cb)


def _assert_images_close(ia, ib):
    mass_a, mass_b = float(ia.sum()), float(ib.sum())
    assert mass_b > 0
    assert abs(mass_a - mass_b) / mass_b < 2e-3
    assert np.abs(ia - ib).sum() / np.abs(ib).sum() < 6e-3


@pytest.mark.parametrize("res", [(96, 96), (256, 256)])
def test_engine_sandwich_matches_scatter_oracle(interpret, res):
    """One full-coverage level for the small render, a cascade for the large
    one; across calibration (new lists, tiles settled) the image equals the
    scatter fold's to bf16 rounding."""
    a = _port(res)
    assert a._sandwich_on and a.fold_kind == "sandwich" and a.fold_decision == "startup"
    assert (len(a._levels[0]) == 1) == (res == (96, 96))
    b = _port(res, accum_method="scatter")
    assert b.fold_kind == "scatter" and "accum method 'scatter'" in b.fold_decision
    for eng in (a, b):
        eng.run(n_batches=2)
        eng.run(n_batches=2)
    assert a._calibrated and not a._calibrating and a.fold_kind == "sandwich"
    assert a.fold_decision.startswith("calibrated: sandwich cascade")
    assert set(a.fold_costs) == {"sandwich_ms", "sort_ms"}
    _assert_images_close(a.raw_xyz(0), b.raw_xyz(0))
    np.testing.assert_allclose(a.accum[-1].numpy(), b.accum[-1].numpy(), rtol=1e-6)
    assert a.snapshot()[0].max() > 0
    assert a.drain_stats().ray_segments == b.drain_stats().ray_segments
    # reset() gives zero tiles in the calibrated layout and no count tile.
    a.reset()
    assert len(a.accum) == len(a._levels[0]) + 1 and not a.raw_xyz(0).any()


def test_sandwich_is_off_on_the_cpu_without_the_hook():
    a = _port((96, 96))
    assert not a._sandwich_on and a.fold_kind == "sort"
    assert a.fold_decision == ("sort fold (sandwich ineligible: sandwich kernel unavailable "
                               "on this device)")


@pytest.mark.parametrize("res", [(96, 96), (256, 256)])
def test_engine_matches_jax_engine(interpret, res):
    """Startup levels, the calibration histogram, the planned levels (with
    the JAX cost constants in the port's model) and the image, against the
    JAX engine under the Pallas interpreter."""
    j = JEngine(jax_load_project(_mini_cfg(res)), seed=3, batch_size=1 << 12,
                accum_method="sort")
    t = _port(res)
    assert j._sandwich_on and t._sandwich_on
    assert j.fold_decision == t.fold_decision == "startup"
    assert j._n_chunks == t._n_chunks and j._rows_per_render == t._rows_per_render
    _assert_levels_equal(t, j)
    for name in COST_NAMES:
        setattr(t, name, getattr(j, name))
    hist = {}
    for tag, eng in (("jax", j), ("port", t)):
        inner = eng._sandwich_recalibrate

        def spy(*a, _eng=eng, _tag=tag, _inner=inner, **kw):
            ci = _eng._count_tile_index(0)
            if ci is not None:
                x = _eng.accum[ci]
                hist[_tag] = np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)
            return _inner(*a, **kw)

        eng._sandwich_recalibrate = spy
        eng.run(n_batches=1)
    if res == (256, 256):
        assert hist["jax"].shape == hist["port"].shape == (512, NLO)
        np.testing.assert_array_equal(hist["port"], hist["jax"])
        assert hist["port"].sum() > 0
    else:
        assert not hist                                  # one level: no histogram
    assert j._slot_cap == t._slot_cap and j._rows_per_render == t._rows_per_render
    _assert_levels_equal(t, j)
    assert len(t._levels[0]) == (1 if res == (96, 96) else len(j._levels[0]))
    assert t.fold_decision.startswith("calibrated: sandwich cascade")
    assert j.fold_decision.startswith("calibrated: sandwich cascade")
    for eng in (j, t):
        eng.run(n_batches=2)
    ia, ib = t.raw_xyz(0), np.asarray(j.raw_xyz(0))
    _assert_images_close(ia, ib)
    # Both round each row to bf16 at the same place: far inside that bound,
    # up to a ray on a pixel edge that lands one pixel over (XLA and torch
    # round the projection's last bit differently).
    assert np.abs(ia - ib).sum() / np.abs(ib).sum() < 1e-3
    np.testing.assert_allclose(t.accum[-1].numpy(), np.asarray(j.accum[-1]), rtol=1e-6)
    assert t.drain_stats().ray_segments == j.drain_stats().ray_segments


@pytest.mark.parametrize("seed, nc, n_rows, live_frac", [
    (0, 512, 81920, 0.2), (1, 1024, 655360, 0.5), (2, 300, 40960, 0.9), (3, 2048, 327680, 0.05)])
def test_plan_levels_matches_jax(interpret, seed, nc, n_rows, live_frac):
    """`_sandwich_plan_levels` as a pure function of (nc, n_rows, live rows,
    rows per chunk), with the JAX constants patched in: equal lists, budgets
    and cost."""
    j = JEngine(jax_load_project(_mini_cfg((96, 96))), seed=3, batch_size=1 << 12,
                accum_method="sort")
    t = _port((96, 96))
    for name in COST_NAMES:
        setattr(t, name, getattr(j, name))
    g = np.random.default_rng(seed)
    live = n_rows * live_frac
    share = g.dirichlet(np.full(nc, 0.05))           # a few chunks hold most rows
    rows_per_chunk = np.floor(share * live)
    lj, cj = j._sandwich_plan_levels(nc, n_rows, live, rows_per_chunk)
    lt, ct = t._sandwich_plan_levels(nc, n_rows, live, rows_per_chunk)
    assert [k for _, k in lt] == [k for _, k in lj] and len(lt) >= 2
    for (a, _), (b, _) in zip(lt, lj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert a.dtype == torch.int32
    np.testing.assert_array_equal(lt[-1][0].numpy(), np.arange(nc))
    assert ct == pytest.approx(cj, rel=1e-12)


def test_demotion_preserves_mass(interpret):
    """With the sort fold's modeled cost forced low, calibration demotes to
    it; the settled tile mass is carried into the dense accumulator once."""
    a = _port((96, 96), seed=5)
    assert a._sandwich_on
    a._C_SORT_FIX = -1e9
    b = _port((96, 96), seed=5, accum_method="scatter")
    a.run(n_batches=2)
    assert not a._sandwich_on and a.fold_kind == "sort"
    assert "sort fold" in a.fold_decision and a.fold_decision.startswith("calibrated")
    assert tuple(a.accum[0].shape) == (96 * 96, 3)
    a.run(n_batches=2)
    b.run(n_batches=2)
    b.run(n_batches=2)
    _assert_images_close(a.raw_xyz(0), b.raw_xyz(0))
    np.testing.assert_allclose(a.accum[-1].numpy(), b.accum[-1].numpy(), rtol=1e-6)
    # Two of the four batches were folded exactly (sort): closer than bf16 alone.
    c = _port((96, 96), seed=5)
    c.run(n_batches=2)
    c.run(n_batches=2)
    assert c._sandwich_on
    ia, ib, ic = a.raw_xyz(0), b.raw_xyz(0), c.raw_xyz(0)
    assert np.abs(ia - ib).sum() < np.abs(ic - ib).sum()


def test_level_overflow_is_exact(interpret):
    """A keep forced too small at either level: the entrants all go into the
    full-coverage tile, and the image is the one of the untouched cascade."""
    ref = _port((256, 256))
    ref.run(n_batches=1)
    ref.run(n_batches=2)
    assert len(ref._levels[0]) >= 2
    for li in range(len(ref._levels[0])):
        a = _port((256, 256))
        a.run(n_batches=1)
        levels = list(a._levels[0])
        if levels[li][1] is None:
            continue
        levels[li] = (levels[li][0], 4096 if li == 0 else 2048)
        a._levels[0] = levels
        syncs = a.host_syncs
        a.run(n_batches=2)
        assert a.host_syncs > syncs
        assert all(n > levels[li][1] for n in a.last_level_rows)     # diverted whole
        ia, ib = a.raw_xyz(0), ref.raw_xyz(0)
        np.testing.assert_allclose(ia, ib, rtol=1e-5, atol=1e-6 * float(ib.max()))
        np.testing.assert_array_equal(a.accum[-1].numpy(), ref.accum[-1].numpy())


def _colour_doc():
    doc = _mini_cfg((96, 96))
    doc["raypath_color"] = {"mode": "dominant", "classes": [
        {"name": "35", "color": [1.0, 0.3, 0.2],
         "match": [{"crystal": 1, "raypath": [3, 5], "symmetry": "P"}]}]}
    return doc


INELIGIBLE = {
    # name: (document, environment, engine keywords, words of the reason in either package)
    "pinned-sort": (_mini_cfg((96, 96)), {"IHT_FOLD": "sort"}, {}, "pinned by IHT_FOLD=sort"),
    "accum-method": (_mini_cfg((96, 96)), {}, {"accum_method": "scatter"}, "accum method"),
    "pool-size": (_mini_cfg((96, 96)), {"IHT_WL_POOL": "256"}, {}, "wavelength pool 256 > 128"),
    "chunks": (_mini_cfg((1024, 1024)), {}, {}, "image chunks 8192 > 4096"),
    "switched-off": (_mini_cfg((96, 96)), {"IHT_SANDWICH": "0"}, {}, "unavailable"),
    "pallas-off": (_mini_cfg((96, 96)), {"IHT_PALLAS": "off"}, {}, "unavailable"),
}


@pytest.mark.parametrize("case", sorted(INELIGIBLE))
def test_ineligibility_matches_jax(interpret, monkeypatch, case):
    """Every condition of `_sandwich_setup`: both engines leave the sandwich
    off and name the same condition first."""
    doc, env, kw, words = INELIGIBLE[case]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    j = JEngine(jax_load_project(doc), seed=3, batch_size=1 << 12,
                **{"accum_method": "sort", **kw})
    t = Engine(load_project(doc), seed=3, batch_size=1 << 12, device="cpu", **kw)
    assert not j._sandwich_on and not t._sandwich_on
    for eng in (j, t):
        assert eng.fold_decision.startswith("sort fold (sandwich ineligible: ")
        assert words in eng.fold_decision, eng.fold_decision
    assert t.fold_kind == j.fold_kind


def test_ineligibility_colour_classes_and_kernel_path(interpret, monkeypatch):
    """The two conditions that need another scene or path: colour classes,
    and the trace kernel path (which comes first of all)."""
    doc = _colour_doc()
    j = JEngine(jax_load_project(doc), seed=3, batch_size=1 << 12, accum_method="sort")
    t = Engine(load_project(doc), seed=3, batch_size=1 << 12, device="cpu")
    for eng in (j, t):
        assert eng.color_classes and not eng._sandwich_on
        assert "raypath_color classes" in eng.fold_decision
    # The order: a pinned sort fold is named before the colour classes.
    monkeypatch.setenv("IHT_FOLD", "sort")
    t = Engine(load_project(doc), seed=3, batch_size=1 << 12, device="cpu")
    assert "pinned by IHT_FOLD=sort" in t.fold_decision
    monkeypatch.delenv("IHT_PALLAS_TRACE")
    k = Engine(load_project(_mini_cfg((96, 96))), seed=3, batch_size=1 << 12, device="cpu")
    assert k._trace_plan is not None and not k._sandwich_on
    assert "trace kernel emits packed sort keys" in k.fold_decision


def test_engine_takes_the_layout_from_the_module(interpret, monkeypatch):
    """The engine names no layout in any pass of its fold, the calibration
    count pass among them, so the wrapper's choice is sandwich.LAYOUT, as
    the JAX engine follows pallas_sandwich.LAYOUT. A layout that does not
    exist raises in the wrapper, from the module as from the argument."""
    seen = []
    real = sandwich.sandwich_pass_plain

    def spy(*args, **kw):
        seen.append(kw.get("layout"))
        return real(*args, **kw)

    monkeypatch.setattr(sandwich, "sandwich_pass_plain", spy)
    eng = Engine(load_project(_mini_cfg((256, 256))), seed=3, batch_size=1 << 12, device="cpu")
    assert eng._sandwich_on
    eng.run(n_batches=2)
    assert len(seen) >= 4 and set(seen) == {None}
    monkeypatch.setattr(sandwich, "sandwich_pass_plain", real)
    K = 16
    pix, w, wl, tbl = _rows(1000, 16 * NLO, K)
    cl = np.arange(8, dtype=np.int32)
    tile = torch.zeros((cl.shape[0], 3 * NLO))
    want = sandwich.sandwich_pass(tile, *_t(cl, pix, w, wl, tbl), k_pool=K, layout="lane")
    for layout in ("lane", "sublane"):
        monkeypatch.setattr(sandwich, "LAYOUT", layout)
        got = sandwich.sandwich_pass(tile, *_t(cl, pix, w, wl, tbl), k_pool=K)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    monkeypatch.setattr(sandwich, "LAYOUT", "rows")
    with pytest.raises(ValueError, match="layout"):
        sandwich.sandwich_pass(tile, *_t(cl, pix, w, wl, tbl), k_pool=K)


def test_device_ms_records_how_a_time_was_taken(monkeypatch):
    """timed_by drains the methods of the device_ms calls before it: one
    fallback to CUDA events marks the record, the next record starts clean."""
    from ice_halo_sim_tpu_torch import probe_sandwich

    monkeypatch.setattr(probe_sandwich, "_METHODS", ["profiler", "cuda events", "profiler"])
    assert probe_sandwich.timed_by() == "cuda events"
    assert probe_sandwich._METHODS == [] and probe_sandwich.timed_by() == "profiler"


@pytest.fixture()
def jax_sandwich_checkpoint(interpret, tmp_path):
    j = JEngine(jax_load_project(_mini_cfg((96, 96))), seed=4, batch_size=1 << 12,
                accum_method="sort")
    assert j._sandwich_on
    j.run(n_batches=2)
    path = str(tmp_path / "sandwich.npz")
    jcheckpoint.save_checkpoint(path, j)
    return path, j


def test_load_jax_sandwich_checkpoint(jax_sandwich_checkpoint, monkeypatch):
    """A checkpoint a JAX sandwich engine saved (dense float64 images) into a
    port sandwich engine (settled images, zero tiles) and into a port sort
    engine (dense accumulators); both go on from the saved batch counter."""
    path, j = jax_sandwich_checkpoint
    want = np.asarray(j.raw_xyz(0))
    with np.load(path) as data:
        assert data["accum_0"].dtype == np.float64 and data["accum_0"].shape == (96 * 96, 3)
    a = load_jax_checkpoint(path, device="cpu")
    assert a._sandwich_on and a.batch_counter == 2
    assert a._settled[0].dtype == np.float64 and not any(t.any() for t in a.accum[:-1])
    np.testing.assert_allclose(a.raw_xyz(0), want, rtol=1e-6, atol=0)
    np.testing.assert_allclose(a.accum[-1].numpy(), np.asarray(j.accum[-1]), rtol=1e-6)
    monkeypatch.setattr(sandwich, "CPU_TEST_HOOK", False)
    b = load_jax_checkpoint(path, device="cpu")
    assert not b._sandwich_on and b.fold_kind == "sort" and b.batch_counter == 2
    np.testing.assert_allclose(b.raw_xyz(0), want, rtol=1e-6, atol=0)
    # Both resume: two more batches give the same image to bf16 rounding.
    for eng in (a, b, j):
        eng.run(n_batches=2)
    _assert_images_close(a.raw_xyz(0), b.raw_xyz(0))
    assert np.abs(a.raw_xyz(0) - np.asarray(j.raw_xyz(0))).sum() / want.sum() < 1e-3


def test_load_jax_sandwich_checkpoint_wrong_shape(jax_sandwich_checkpoint, tmp_path):
    path, _ = jax_sandwich_checkpoint
    with np.load(path) as data:
        arrays = {k: data[k] for k in data.files}
    arrays["accum_0"] = arrays["accum_0"][:-NLO]
    bad = str(tmp_path / "bad.npz")
    np.savez_compressed(bad, **arrays)
    with pytest.raises(ValueError, match="checkpoint accumulator shape"):
        load_jax_checkpoint(bad, device="cpu")


def test_keys_that_do_not_pack_take_the_dense_value_fold():
    """`spectral_ok` forced false on both sides: the port no longer raises;
    both engines fold dense value rows by sort and agree."""
    doc = _mini_cfg((96, 96))
    j = JEngine(jax_load_project(doc), seed=3, batch_size=1 << 12, accum_method="sort")
    t = Engine(load_project(doc), seed=3, batch_size=1 << 12, device="cpu")
    s = Engine(load_project(doc), seed=3, batch_size=1 << 12, device="cpu",
               accum_method="scatter")
    for eng in (j, t):
        eng.spectral_ok = False
        assert eng.fold_kind == "sort-legacy"
    for eng in (j, t, s):
        eng.run(n_batches=1)
        eng.run(n_batches=1)
    it, ij = t.raw_xyz(0), np.asarray(j.raw_xyz(0))
    np.testing.assert_allclose(it.sum(), ij.sum(), rtol=1e-5)
    np.testing.assert_allclose(it, ij, rtol=1e-4, atol=1e-6 * float(ij.max()))
    np.testing.assert_allclose(it, s.raw_xyz(0), rtol=1e-5, atol=1e-6 * float(ij.max()))
    assert t.drain_stats().ray_segments == j.drain_stats().ray_segments
    assert t._compact_keep is None
