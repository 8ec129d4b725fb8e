"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Marked ``cuda``: skipped where no CUDA device exists. On a machine with a
card:  python -m pytest -m cuda tests/test_torch_cuda.py -q
Shapes are small; chip_smoke.py repeats the comparison at the main path's
shapes. Integer outputs must be bit-equal; the scan's floats within rtol
1e-6 (both versions sum in float64 and round once). The sandwich kernels'
tile entries: rtol 1e-4 with atol 1e-5 of the largest entry (the tensor
cores add the products of a 16-row step and the running float32 sum without
the rounding of a sequential IEEE sum, and the partial tiles of the row
splits are added in float32; the plain version sums in float64 and rounds
once); ``matched`` is bit-equal.
"""

import numpy as np
import pytest
import torch

from ice_halo_sim_tpu_torch.config.loader import load_project
from ice_halo_sim_tpu_torch.core import accum, block_ops, seg_scan, trace_emit
from ice_halo_sim_tpu_torch.scenes import BENCH_CFG, POOL_CFG
from ice_halo_sim_tpu_torch.engine.simulator import Engine

# Tier-1 runs six workers; keep each one to two torch threads.
torch.set_num_threads(2)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _eq(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_trace_emit_kernel(dev):
    eng = Engine(load_project(BENCH_CFG), seed=7, batch_size=8192, device=dev)
    for base in ((0, 0, 8192), (0xFFFFF000, 2, 5000)):
        a = trace_emit.trace_emit(eng._trace_plan, *base, dev)
        b = trace_emit.trace_emit_plain(eng._trace_plan, *base, dev)
        d = trace_emit.trace_output_diff(a[0], b[0])
        assert d["rows_diff"] == 0 and d["w_rel"] <= 1e-6, d
        assert int(a[3]) == int(b[3])


def _stochastic_prism_doc():
    import copy

    doc = copy.deepcopy(POOL_CFG)
    doc["crystal"][0] = {
        "id": 1, "type": "prism",
        "shape": {"height": {"type": "gauss", "mean": 1.1, "std": 0.15}},
        "axis": doc["crystal"][0]["axis"]}
    return doc


@pytest.mark.parametrize("kind", ["pyramid", "prism"])
def test_trace_emit_pool_kernel(dev, kind):
    """K2b against its twin on the engine's own pool tables: NF = 20
    (POOL_CFG's pyramid, two renders) and NF = 8 (a stochastic prism)."""
    doc = POOL_CFG if kind == "pyramid" else _stochastic_prism_doc()
    eng = Engine(load_project(doc), seed=7, batch_size=8192, device=dev)
    plan = eng._trace_plan
    assert plan.pool_k == 64 and plan.nf == (20 if kind == "pyramid" else 8)
    for bc, base in ((0, (0, 0, 8192)), (9, (0xFFFFF000, 2, 5000))):
        ptbl, ttbl = eng._pool_tables(bc)
        a = trace_emit.trace_emit(plan, *base, dev, ptbl, ttbl)
        b = trace_emit.trace_emit_plain(plan, *base, dev, ptbl, ttbl)
        d = trace_emit.trace_output_diff(a[0], b[0])
        assert d["rows_diff"] == 0 and d["w_rel"] <= 1e-6, d
        assert int(a[3]) == int(b[3])
    with pytest.raises(ValueError, match="ptbl must be"):
        trace_emit.trace_emit(plan, 0, 0, 8192, dev, ptbl.cpu(), ttbl)


@pytest.mark.parametrize("lens, view", [
    ("linear", {"azimuth": 30.0, "elevation": 20.0, "roll": 10.0}),
    ("fisheye_equal_area", {"elevation": 90.0}),
    ("fisheye_orthographic", {"elevation": 90.0}),
    ("globe", {"azimuth": 60.0, "elevation": 35.0, "roll": 15.0}),
    ("dual_fisheye_orthographic", {"azimuth": 0.0, "elevation": 0.0, "roll": 0.0}),
])
def test_trace_emit_kernel_lenses(dev, lens, view):
    """The static kernel's other lens branches against the twin."""
    import copy

    doc = copy.deepcopy(BENCH_CFG)
    doc["render"] = [{"id": 1, "lens": {"type": lens, "fov": 120.0 if lens != "globe" else 40.0},
                      "resolution": [256, 192], "view": view, "visible": "upper",
                      "lens_shift": [5, -3]}]
    eng = Engine(load_project(doc), seed=7, batch_size=8192, device=dev)
    a = trace_emit.trace_emit(eng._trace_plan, 0, 0, 8192, dev)
    b = trace_emit.trace_emit_plain(eng._trace_plan, 0, 0, 8192, dev)
    d = trace_emit.trace_output_diff(a[0], b[0])
    assert d["rows_diff"] == 0 and d["w_rel"] <= 1e-6, d
    assert int(a[0][0][2].sum()) > 0


def test_pack_and_scatter_kernels(dev):
    g = np.random.default_rng(1)
    key = torch.as_tensor(g.integers(-(1 << 31), 1 << 31, 3 * 4096, dtype=np.int64)
                          .astype(np.int32), device=dev)
    cols = [torch.randn(3 * 4096, device=dev) for _ in range(3)]
    a = block_ops.pack_payload_blocks(key, cols, 1 << 31, 4096)
    b = block_ops.pack_payload_blocks_plain(key, cols, 1 << 31, 4096)
    assert all(_eq(x, y) for x, y in zip(a[0], b[0])) and _eq(a[1], b[1])
    vals = [torch.randn(5, 1024, device=dev), key[:5 * 1024].view(5, 1024)]
    start = torch.tensor([0, 700, 700, 1500, 9000], dtype=torch.int32, device=dev)
    for tail in (None, (4096, 2048, 7, 127)):
        a = block_ops.scatter_blocks_multi(vals, start, 8192, 1024, marker_tail=tail)
        b = block_ops.scatter_blocks_multi_plain(vals, start, 8192, 1024, marker_tail=tail)
        assert all(_eq(x, y) for x, y in zip(a, b))


def test_fused_scan_kernel(dev):
    g = np.random.default_rng(2)
    key = np.sort(g.integers(0, 1 << 20, 100_000, dtype=np.int64)).astype(np.int32)
    sk = torch.as_tensor(key, device=dev)
    sw = torch.rand(sk.numel(), device=dev)
    tbl = torch.rand(64, 3, device=dev)
    a, ka = seg_scan.fused_scan_call(sk, sw, tbl, 7, 64, emit_key2=True)
    b, kb = seg_scan.fused_scan_call_plain(sk, sw, tbl, 7, 64, emit_key2=True)
    assert _eq(ka, kb)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("spectrum", ["D65", "discrete-4", "pool"])
def test_engine_cuda_matches_plain(dev, spectrum):
    import copy

    doc = copy.deepcopy(POOL_CFG if spectrum == "pool" else BENCH_CFG)
    if spectrum == "discrete-4":
        doc["scene"]["light_source"] = {
            "type": "sun", "altitude": 20.0,
            "spectrum": [{"wavelength": w, "weight": 1.0 + i}
                         for i, w in enumerate([450.0, 500.0, 550.0, 600.0])]}
    cfg = load_project(doc)
    imgs = []
    for kernels in ("cuda", "plain"):
        eng = Engine(cfg, seed=3, batch_size=8192, device=dev, kernels=kernels)
        eng.run(n_batches=1)
        eng.run(n_batches=2)
        imgs.append([eng.raw_xyz(r) for r in range(len(eng.proj_plans))])
    for a, b in zip(*imgs):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6 * b.max())
    assert accum.BLOCK == 4096


@pytest.mark.parametrize("ncols, thresh", [(1, 0xFFFFFFFF), (2, 0xFFFFFFFF), (2, 1 << 20)])
def test_pack_valid_blocks_kernel(dev, ncols, thresh):
    """K6 against its plain version: one and two columns (float32, u32
    bits), the all-live threshold and a smaller one, with full, empty and
    one-row blocks; bit-equal. Then compact_valid and compact_by_key through
    both kernel sets."""
    from ice_halo_sim_tpu_torch.kernels import kernel_set

    g = torch.Generator().manual_seed(5)
    block, G = 4096, 5
    key = torch.randint(0, 1 << 21, (G * block,), generator=g, dtype=torch.int64)
    key[torch.rand(G * block, generator=g) < 0.6] = 0xFFFFFFFF
    key[block:2 * block] = 0xFFFFFFFF                    # an empty block
    key[2 * block:3 * block] = 7                         # a full block
    key[3 * block:4 * block] = 0xFFFFFFFF
    key[3 * block + 99] = 3                              # one row
    key = torch.where(key >= 1 << 31, key - (1 << 32), key).to(torch.int32).to(dev)
    cols = [torch.rand(G * block, generator=g).to(dev)]
    if ncols == 2:
        cols.append(torch.randint(-(1 << 31), 1 << 31, (G * block,), generator=g,
                                  dtype=torch.int64).to(torch.int32).to(dev))
    a = block_ops.pack_valid_blocks(key, cols, thresh, block)
    b = block_ops.pack_valid_blocks_plain(key, cols, thresh, block)
    assert _eq(a[0], b[0]) and _eq(a[2], b[2])
    assert all(_eq(x, y) for x, y in zip(a[1], b[1]))
    assert a[2].tolist()[1:4] == [0, block, 1]
    with pytest.raises(ValueError):
        block_ops.pack_valid_blocks(key[:-1], [c[:-1] for c in cols], thresh, block)
    with pytest.raises(ValueError):
        block_ops.pack_valid_blocks(key, cols * 3, thresh, block)
    for fn in (accum.compact_valid, accum.compact_by_key):
        x = fn(key, cols, 3 * block, kernel_set("cuda"))
        y = fn(key, cols, 3 * block, kernel_set("plain"))
        assert int(x[1]) == int(y[1])
        assert all(_eq(p, q) for p, q in zip(x[0], y[0]))


def test_general_path_engine_cuda_matches_plain(dev, monkeypatch):
    """The general trace path (two layers, two settings, a filter; then
    colour classes) through the CUDA kernel set against the plain set on the
    card: the same torch trace, so segments and images agree."""
    from ice_halo_sim_tpu_torch.scenes import COLOR_CFG, MS_CFG

    monkeypatch.setenv("IHT_FOLD", "sort")
    for doc in (MS_CFG, COLOR_CFG):
        a = Engine(load_project(doc), seed=3, batch_size=16384, device=dev)
        b = Engine(load_project(doc), seed=3, batch_size=16384, device=dev, kernels="plain")
        assert (a.trace_path, b.trace_path) == ("general", "plain-torch (general)")
        for eng in (a, b):
            eng.run(n_batches=1)
            eng.run(n_batches=2)
        assert a._compact_keep == b._compact_keep and a._compact_keep is not None
        assert a.drain_stats().ray_segments == b.drain_stats().ray_segments
        for r in range(len(a.proj_plans)):
            x, y = a.raw_xyz(r), b.raw_xyz(r)
            np.testing.assert_allclose(x, y, rtol=1e-4, atol=1e-6 * float(y.max()))
        if a.color_classes:
            np.testing.assert_allclose(a.lane_y(0), b.lane_y(0), rtol=1e-4,
                                       atol=1e-6 * float(b.lane_y(0).max()))


TILE_RTOL, TILE_ATOL_FRAC = 1e-4, 1e-5


def _sandwich_rows(dev, n, n_pixels, k_pool, c_out=3, seed=0):
    g = np.random.default_rng(seed)
    pix = g.integers(0, n_pixels, n).astype(np.int32)
    dead = g.random(n) < 0.3
    pix[dead] = -1
    w = (g.random(n) * 2).astype(np.float32)
    w[dead] = 0.0
    wl = g.integers(0, k_pool, n).astype(np.int32)
    tbl = g.random((k_pool, c_out)).astype(np.float32)
    return tuple(torch.as_tensor(x).to(dev) for x in (pix, w, wl, tbl))


def _assert_tile_close(got, want):
    torch.testing.assert_close(got, want, rtol=TILE_RTOL,
                               atol=TILE_ATOL_FRAC * float(want.abs().max()) + 1e-30)


@pytest.mark.parametrize("layout", ["lane", "sublane"])
@pytest.mark.parametrize("c_out, precise, n, nc", [
    (3, False, 100_000, 8), (3, True, 33_333, 100), (1, False, 70_001, 300),
    (3, False, 255, 64), (3, False, 1, 1), (3, False, 60_000, 4096), (1, False, 60_000, 4096)])
def test_sandwich_kernels(dev, layout, c_out, precise, n, nc):
    """K7 (lane) and K8 (sublane) against the plain version: a shuffled list
    with padding ids and ids outside the image, row counts that are no
    multiple of a slab, lists shorter and longer than a block's 64 entries
    up to the engine's limits (4096 chunks, 128 pool entries), a running tile
    that is not zero."""
    from ice_halo_sim_tpu_torch.core import sandwich

    n_chunks, K = (4096, 128) if nc == 4096 else (400, 64)
    pix, w, wl, tbl = _sandwich_rows(dev, n, n_chunks * sandwich.NLO, K, c_out, seed=n)
    g = np.random.default_rng(nc)
    cl = g.permutation(n_chunks + 20)[:nc].astype(np.int32)    # some ids hold no pixel
    cl[g.random(nc) < 0.1] = -1
    cl = torch.as_tensor(cl).to(dev)
    tile = torch.rand((nc, c_out * sandwich.NLO), device=dev)
    got, gm = sandwich.sandwich_pass(tile, cl, pix, w, wl, tbl, k_pool=K, precise=precise,
                                     layout=layout)
    want, wm = sandwich.sandwich_pass_plain(tile, cl, pix, w, wl, tbl, k_pool=K,
                                            precise=precise)
    torch.cuda.synchronize()
    assert gm.dtype == torch.int32 and torch.equal(gm, wm)
    _assert_tile_close(got, want)
    # Run after run the same bits: the partial tiles are summed in a fixed order.
    again, _ = sandwich.sandwich_pass(tile, cl, pix, w, wl, tbl, k_pool=K, precise=precise,
                                      layout=layout)
    assert torch.equal(again, got)


def test_sandwich_dead_rows_and_decoded_dead_keys(dev):
    """A dead row's pixel -1 (chunk -1 by floor division) and the decoded
    dead key (a pixel past every chunk) match no list, chunk 0 included."""
    from ice_halo_sim_tpu_torch.core import sandwich

    K = 16
    pix = torch.tensor([-1, -128, -129, (1 << 25) - 1, 5, 127, 128], dtype=torch.int32,
                       device=dev)
    w = torch.ones(7, device=dev)
    wl = torch.zeros(7, dtype=torch.int32, device=dev)
    tbl = torch.ones((K, 3), device=dev)
    cl = torch.tensor([0, -1], dtype=torch.int32, device=dev)
    tile = torch.zeros((2, 384), device=dev)
    for layout in ("lane", "sublane"):
        out, m = sandwich.sandwich_pass(tile, cl, pix, w, wl, tbl, k_pool=K, layout=layout)
        assert m.tolist() == [0, 0, 0, 0, 1, 1, 0]
        assert float(out.sum()) == 6.0 and float(out[0, 5]) == 1.0 and not out[1].any()


@pytest.mark.parametrize("nhi, n", [(8, 50_000), (256, 200_000), (100, 777)])
def test_sandwich_iota_kernel(dev, nhi, n):
    """P1 against its plain version; rows of chunks past the tile drop."""
    from ice_halo_sim_tpu_torch import probe_sandwich

    K = 64
    pix, w, wl, tbl = _sandwich_rows(dev, n, (nhi + 40) * 128, K, seed=nhi)
    got = probe_sandwich.sandwich_iota(pix, w, wl, tbl, nhi=nhi, k_pool=K)
    want = probe_sandwich.sandwich_iota_plain(pix, w, wl, tbl, nhi=nhi, k_pool=K)
    assert got.shape == (nhi, 384)
    _assert_tile_close(got, want)


def test_extract_blocks_kernel(dev):
    """P2 against its plain version at a small shape and with equal starts
    (the later block wins) and a start at the end of the output; bit-equal."""
    from ice_halo_sim_tpu_torch import probe_scatter

    vals, start, n_out, block = probe_scatter.probe_inputs(dev, seed=3, n_out=8192, block=1024,
                                                           n_rows=24 * 1024)
    assert _eq(probe_scatter.extract_blocks(vals, start, n_out, block),
               probe_scatter.extract_blocks_plain(vals, start, n_out, block))
    start2 = torch.tensor([0, 100, 100, n_out], dtype=torch.int32, device=dev)
    assert _eq(probe_scatter.extract_blocks(vals[:4], start2, n_out, block),
               probe_scatter.extract_blocks_plain(vals[:4], start2, n_out, block))
    vals, start, n_out, block = probe_scatter.probe_inputs(dev)
    assert vals.shape == (192, 16384)
    assert _eq(probe_scatter.extract_blocks(vals, start, n_out, block),
               probe_scatter.extract_blocks_plain(vals, start, n_out, block))


@pytest.mark.parametrize("fold", ["sandwich", "auto"])
def test_sandwich_engine_cuda_matches_plain_and_sort(dev, monkeypatch, fold):
    """MS_CFG through the sandwich cascade (K7, with K6 + K3' before each
    compacted level) against the plain kernel set on the card (the tile
    tolerance) and against the sort fold (bf16 rounding of each row's values:
    image mass within 2e-3, L1 within 6e-3; landed weight and segments
    equal). Under IHT_FOLD=auto the engine may demote at calibration; both
    kernel sets then decide alike."""
    from ice_halo_sim_tpu_torch.kernels import build
    from ice_halo_sim_tpu_torch.scenes import MS_CFG

    monkeypatch.setenv("IHT_FOLD", fold)
    a = Engine(load_project(MS_CFG), seed=3, batch_size=16384, device=dev)
    b = Engine(load_project(MS_CFG), seed=3, batch_size=16384, device=dev, kernels="plain")
    monkeypatch.setenv("IHT_FOLD", "sort")
    s = Engine(load_project(MS_CFG), seed=3, batch_size=16384, device=dev)
    assert a.fold_kind == b.fold_kind == "sandwich" and s.fold_kind == "sort"
    before = build.LAUNCHES["sandwich_lane"]
    for eng in (a, b, s):
        eng.run(n_batches=1)
        eng.run(n_batches=2)
    assert build.LAUNCHES["sandwich_lane"] > before
    assert a.fold_kind == b.fold_kind and a.fold_decision == b.fold_decision
    if fold == "sandwich":
        assert a.fold_kind == "sandwich" and a.fold_decision == "pinned by IHT_FOLD=sandwich"
    sa, sb, ss = a.drain_stats(), b.drain_stats(), s.drain_stats()
    assert sa.ray_segments == sb.ray_segments == ss.ray_segments
    np.testing.assert_allclose(sa.landed_weight, ss.landed_weight, rtol=1e-6)
    for r in range(len(a.proj_plans)):
        x, y, z = a.raw_xyz(r), b.raw_xyz(r), s.raw_xyz(r)
        np.testing.assert_allclose(x, y, rtol=TILE_RTOL, atol=TILE_ATOL_FRAC * float(y.max()))
        assert abs(float(x.sum()) - float(z.sum())) / float(z.sum()) < 2e-3
        assert np.abs(x - z).sum() / np.abs(z).sum() < 6e-3
