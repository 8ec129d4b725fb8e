"""The port's sandwich kernels against the JAX package's, on the CPU.

Kernel level: ``sandwich_pass_plain`` (the plain version of K7 and K8, with
the kernels' bf16 rounding) against the JAX Pallas kernels in interpret mode,
both layouts, ``precise`` on and off; against the exact oracle and a bincount
at the JAX tests' tolerances; the probe forms P1 and P2. The port's engine
runs none of them (it folds by sort).

Engine level: a checkpoint of a JAX engine that folded by sandwich (the
Pallas interpreter) resumes in the port, and the dense-value fold of keys
that do not pack.

Tolerances. Tile entries against the JAX kernel: rtol 1e-5, atol 1e-5 of the
maximum (float32 sums in another order; both sides round to bf16 at the same
place); ``matched`` equal. Against the exact oracle: 6e-3 (one bf16 term),
1e-4 (two). The port's sort fold against the JAX sandwich fold: image mass
2e-3, L1 6e-3 (bf16 rounding of each row's values, about 0.4% per row,
averaging down per pixel).
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


@pytest.fixture()
def interpret(monkeypatch):
    """The JAX package's sandwich kernels run on the CPU, through the Pallas
    interpreter."""
    monkeypatch.setattr(ps, "INTERPRET", True)


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    # The general trace path in both packages (the JAX engine's sandwich fold
    # takes no other); the JAX engine calibrates after its first batch, as
    # the port does.
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
    """P2: forward-overwrite block scatter; also through the block scatter's
    plain version (one column), which the CUDA kernel is held to."""
    from ice_halo_sim_tpu_torch.core import block_ops

    probe = _script("probe_pallas_scatter")
    vals, start, n_out, block = probe_scatter.probe_inputs("cpu", seed=3, n_out=8192,
                                                           block=1024, n_rows=24 * 1024)
    assert vals.shape == (24, 1024) and bool((start[1:] >= start[:-1]).all())
    want = probe.np_reference(vals.numpy(), start.numpy(), n_out, block)
    got = probe_scatter.extract_blocks(vals, start, n_out, block)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        block_ops.scatter_blocks_plain([vals], start, n_out, block)[0].numpy(), want)
    # A start at the end of the output, and equal starts: the later block wins.
    start2 = torch.tensor([0, 100, 100, n_out], dtype=torch.int32)
    want2 = probe.np_reference(vals[:4].numpy(), start2.numpy(), n_out, block)
    np.testing.assert_array_equal(
        probe_scatter.extract_blocks(vals[:4], start2, n_out, block).numpy(), want2)
    np.testing.assert_array_equal(
        block_ops.scatter_blocks_plain([vals[:4]], start2, n_out, block)[0].numpy(), want2)


# --------------------------------------------------------------------------
# The wrapper's host-side plan (the CUDA kernels themselves run only on the
# card: tests/test_torch_cuda.py)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n_rows, nc, c_out", [
    (1388544, 256, 3), (243712, 2048, 3), (6553600, 1024, 1), (1, 1, 3), (1000, 4096, 1),
    (3342336, 1024, 3), (1 << 21, 1024, 3), (255, 129, 3)])
def test_splits_plan(n_rows, nc, c_out):
    """Every row in exactly one split, splits that start on a slab (16-byte
    loads of four rows), a padded list of whole slices; one wave of blocks
    (one per multiprocessor) that fills the card where the rows allow it."""
    sms = 132
    n_split, per, nc_pad = sandwich._splits(n_rows, nc, c_out, sms)
    s = sandwich.list_block(c_out)
    assert s * c_out == 384 and nc_pad % s == 0 and nc <= nc_pad < nc + s
    assert per % sandwich._SLAB == 0 and (n_split - 1) * per < n_rows <= n_split * per
    n_slices = nc_pad // s
    assert 1 <= n_split <= max(1, sms // n_slices)
    n_slabs = -(-n_rows // sandwich._SLAB)
    if n_slabs >= 4 * sms:
        assert n_split * n_slices > 0.9 * sms - n_slices


@pytest.mark.parametrize("n_rows, nc, c_out", [(1, 1, 3), (4097, 129, 3), (6553600, 1024, 1),
                                                (243712, 2048, 3)])
def test_sublane_scratch_holds_every_part(n_rows, nc, c_out):
    """K8's scratch: the sorted list (ids and positions), the rows' list
    positions, the counts per (tile, slice) plus the total, and the grouped
    key, weight and pool index, each part rounded to 16 bytes."""
    nc_pad = sandwich._splits(n_rows, nc, c_out, 132)[2]
    n_tiles = -(-n_rows // sandwich._GROUP_TILE)
    parts = [sandwich._pow2_at_least(nc)] * 2 + [n_rows] * 4 + \
        [n_tiles * (nc_pad // sandwich.list_block(c_out)) + 1]
    assert sandwich._sublane_scratch_ints(n_rows, nc, nc_pad, c_out) == \
        sum(-(-x // 4) * 4 for x in parts)
    assert sandwich._pow2_at_least(nc) >= nc > sandwich._pow2_at_least(nc) // 2


@pytest.mark.parametrize("c_out", [3, 1])
@pytest.mark.parametrize("nc", [1, 127, 128, 129, 383, 384, 385, 1000])
def test_slice_slots_plain_matches_list_slots(c_out, nc):
    """The kernels' slot search (binary search of each sorted slice) finds
    the list position `_list_slots` finds, for listed rows, dead rows (chunk
    -1), padding ids and ids outside the image."""
    g = np.random.default_rng(nc * 7 + c_out)
    cl = g.permutation(nc + 50)[:nc].astype(np.int32)
    cl[g.random(nc) < 0.1] = -1
    chunk = torch.as_tensor(g.integers(-1, nc + 60, 20000))
    pos = sandwich.slice_slots_plain(torch.as_tensor(cl), chunk, c_out)
    k, hit = sandwich._list_slots(torch.as_tensor(cl), chunk)
    assert torch.equal(pos, torch.where(hit, k, -1))
    assert int((pos >= 0).sum()) > 0 or (cl < 0).all()


def test_aligned_copies_only_misaligned_rows():
    x = torch.arange(64, dtype=torch.int32)
    assert sandwich._aligned(x) is x
    y = x[1:]
    z = sandwich._aligned(y)
    assert z is not y and z.data_ptr() % 16 == 0 and torch.equal(z, y)


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


def _assert_images_close(ia, ib):
    mass_a, mass_b = float(ia.sum()), float(ib.sum())
    assert mass_b > 0
    assert abs(mass_a - mass_b) / mass_b < 2e-3
    assert np.abs(ia - ib).sum() / np.abs(ib).sum() < 6e-3


def test_wrapper_takes_the_layout_from_the_module(monkeypatch):
    """A pass whose caller names no layout launches the kernel that
    sandwich.LAYOUT names, as the JAX module follows pallas_sandwich.LAYOUT.
    A layout that does not exist raises in the wrapper, from the module as
    from the argument."""
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


def test_load_jax_sandwich_checkpoint(jax_sandwich_checkpoint):
    """A checkpoint a JAX sandwich engine saved (dense float64 images) into a
    port engine, which folds by sort: its accumulators take the images
    (rounded once to float32), and it goes on from the saved batch counter."""
    path, j = jax_sandwich_checkpoint
    want = np.asarray(j.raw_xyz(0))
    with np.load(path) as data:
        assert data["accum_0"].dtype == np.float64 and data["accum_0"].shape == (96 * 96, 3)
    b = load_jax_checkpoint(path, device="cpu")
    assert b.fold_kind == "sort" and b.batch_counter == 2
    assert tuple(b.accum[0].shape) == (96 * 96, 3) and b.accum[0].dtype == torch.float32
    np.testing.assert_allclose(b.raw_xyz(0), want, rtol=1e-6, atol=0)
    np.testing.assert_allclose(b.accum[-1].numpy(), np.asarray(j.accum[-1]), rtol=1e-6)
    # It resumes: two more batches in each give the same image to bf16
    # rounding (the JAX engine goes on folding by sandwich).
    for eng in (b, j):
        eng.run(n_batches=2)
    _assert_images_close(b.raw_xyz(0), np.asarray(j.raw_xyz(0)))
    assert b.batch_counter == 4 and b.raw_xyz(0).sum() > want.sum()


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
    assert t.fold_decision.startswith("sort-legacy: (pixel, wavelength) keys do not pack")
    for eng in (j, t, s):
        eng.run(n_batches=1)
        eng.run(n_batches=1)
    it, ij = t.raw_xyz(0), np.asarray(j.raw_xyz(0))
    np.testing.assert_allclose(it.sum(), ij.sum(), rtol=1e-5)
    np.testing.assert_allclose(it, ij, rtol=1e-4, atol=1e-6 * float(ij.max()))
    np.testing.assert_allclose(it, s.raw_xyz(0), rtol=1e-5, atol=1e-6 * float(ij.max()))
    assert t.drain_stats().ray_segments == j.drain_stats().ray_segments
    assert t._compact_keep is None
