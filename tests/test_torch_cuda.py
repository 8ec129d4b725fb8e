"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Marked ``cuda``: skipped where no CUDA device exists. On a machine with a
card:  python -m pytest -m cuda tests/test_torch_cuda.py -q
Shapes are small; chip_smoke.py repeats the comparison at the main path's
shapes. Integer outputs must be bit-equal; the scan's floats within rtol
1e-6 (both versions sum in float64 and round once). The sandwich kernels'
tile entries: rtol 1e-4 with atol 1e-5 of the largest entry (each block adds
its rows to a cell one by one in float32, and the partial tiles of the row
splits are added in float32; the plain version sums in float64 and rounds
once); ``matched`` is bit-equal, and two runs give the same bits.
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


def _same_bits(a, b):
    """Two trace_emit outputs bit for bit: per render keys, weights and
    counts, then landed, dropped and segments."""
    return all(_eq(x, y) for ra, rb in zip(a[0], b[0]) for x, y in zip(ra, rb)) and all(
        _eq(x.reshape(-1), y.reshape(-1)) for x, y in zip(a[1:3], b[1:3])) and int(a[3]) == int(b[3])


def _trace_case(plan, base, dev, tables=()):
    """Kernel against twin (rows equal, weights within 1e-6, segments
    equal), and a second launch with the same bits. base: (low word, high
    word, n_active). Returns the kernel's output."""
    lo, hi, n_active = base
    base = ((hi << 32) | lo, n_active)
    a = trace_emit.trace_emit(plan, *base, dev, *tables)
    b = trace_emit.trace_emit_plain(plan, *base, dev, *tables)
    d = trace_emit.trace_output_diff(a[0], b[0])
    assert d["rows_diff"] == 0 and d["blocks_diff"] == 0 and d["w_rel"] <= 1e-6, d
    assert int(a[3]) == int(b[3])
    for (ka, wa, ca), (kb, wb, cb) in zip(a[0], b[0]):
        assert _eq(ka, kb) and _eq(ca, cb)              # the tail too
    assert _same_bits(trace_emit.trace_emit(plan, *base, dev, *tables), a)
    return a


def test_trace_emit_kernel(dev):
    """K2 with its pack against the twin: BENCH_CFG's dual fisheye with the
    overlap pass, a 64-bit ray base, and n_active 5000 of 8192 (the last
    two 2048-ray blocks hold no live row)."""
    eng = Engine(load_project(BENCH_CFG), seed=7, batch_size=8192, device=dev)
    assert eng._trace_plan.renders[0].max_abs_dz > 0
    for base in ((0, 0, 8192), (0xFFFFF000, 2, 5000)):
        a = _trace_case(eng._trace_plan, base, dev)
    counts = a[0][0][2]
    assert counts[:2].min() > 0 and int(counts[3]) == 0
    assert (a[0][0][0][3] == -1).all() and not a[0][0][1][3].any()


@pytest.mark.parametrize("what", ["four renders", "batch 1000"])
def test_trace_emit_kernel_pack_shapes(dev, what):
    """The pack's other shapes: four dual renders with the overlap pass (8
    rows per ray and slot: the kernel stages the slots in two groups), and a
    batch of 1000 rays (one block of a cluster of 8, the last partly
    idle)."""
    import copy

    doc = copy.deepcopy(BENCH_CFG)
    batch = 8192
    if what == "four renders":
        doc["render"] = [dict(copy.deepcopy(doc["render"][0]), id=i + 1) for i in range(4)]
    else:
        batch = 1000
    eng = Engine(load_project(doc), seed=7, batch_size=batch, device=dev)
    plan = eng._trace_plan
    p = trace_emit.make_params(plan, batch)
    assert (p.rp, p.hg, p.ncta) == ((8, 4, 16) if what == "four renders" else (2, 7, 8))
    _trace_case(plan, (0, 0, batch), dev)


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
        _trace_case(plan, base, dev, (ptbl, ttbl))
    with pytest.raises(ValueError, match="ptbl must be"):
        trace_emit.trace_emit(plan, 0, 8192, dev, ptbl.cpu(), ttbl)


@pytest.mark.parametrize("mode", ["static", "pool"])
@pytest.mark.parametrize("lens, view", [
    ("linear", {"azimuth": 30.0, "elevation": 20.0, "roll": 10.0}),
    ("fisheye_equal_area", {"elevation": 90.0}),
    ("fisheye_orthographic", {"elevation": 90.0}),
    ("globe", {"azimuth": 60.0, "elevation": 35.0, "roll": 15.0}),
    ("dual_fisheye_orthographic", {"azimuth": 0.0, "elevation": 0.0, "roll": 0.0}),
])
def test_trace_emit_kernel_lenses(dev, lens, view, mode):
    """The kernel's other lens branches against the twin, in the static
    mode (BENCH_CFG's prism) and the blocked-pool mode (POOL_CFG's
    pyramids); BENCH_CFG's dual equal-area lens is the tests above."""
    import copy

    doc = copy.deepcopy(BENCH_CFG if mode == "static" else POOL_CFG)
    doc["render"] = [{"id": 1, "lens": {"type": lens, "fov": 120.0 if lens != "globe" else 40.0},
                      "resolution": [256, 192], "view": view, "visible": "upper",
                      "lens_shift": [5, -3]}]
    eng = Engine(load_project(doc), seed=7, batch_size=8192, device=dev)
    plan = eng._trace_plan
    assert bool(plan.pool_k) == (mode == "pool")
    a = _trace_case(plan, (0, 0, 8192), dev, eng._pool_tables(0) if plan.pool_k else ())
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


# (block length, starts, out_len, columns, permutation, marker tail): the
# shapes that reach the block scatter's tile logic (tiles of 2048 rows).
SCATTER_TILE_CASES = {
    "below one tile": (1024, [0, 500, 900], 1500, 1, False, None),
    "ragged last tile": (1024, [0, 1000, 2000, 2500, 3000, 3100], 5000, 2, False, None),
    "one block over tiles": (16384, [0], 16384 + 3000, 1, False, None),
    "million-row zero region": (1024, [0, 700, 1500], 1_000_000 + 2524, 3, False, None),
    "2000 empty blocks": (1024, [0, 100] + [1000] * 2000 + [1500, 2500], 4000, 2, False, None),
    "G = 1": (4096, [37], 5000, 1, False, None),
    "marker tail over tile edges": (2048, [0, 1500, 2100, 4000, 4000, 7000], 8192, 2, False,
                                    (1000, 5000, 7, 127)),
    "perm, seven columns": (4096, [0, 3000, 3000, 5000, 9000, 9100, 12000], 14000, 7, True,
                            None),
}


@pytest.mark.parametrize("case", list(SCATTER_TILE_CASES))
def test_block_scatter_kernel(dev, case):
    """The block scatter (K3' with every column and a permutation, K3 with
    the marker tail) against its plain version: bit-equal, and a second
    launch gives the same bits."""
    blk, starts, out_len, ncols, with_perm, tail = SCATTER_TILE_CASES[case]
    g = torch.Generator().manual_seed(len(starts) + ncols)
    G = len(starts)
    vals = [torch.rand((G, blk), generator=g) if c % 2 == 0 else
            torch.randint(-(1 << 31), 1 << 31, (G, blk), generator=g, dtype=torch.int64)
            .to(torch.int32) for c in range(ncols)]
    vals = [v.to(dev) for v in vals]
    start = torch.tensor(starts, dtype=torch.int32, device=dev)
    perm = (torch.argsort(torch.rand((G, blk), generator=g), dim=1).to(torch.int32).to(dev)
            if with_perm else None)
    if tail is None:
        a = block_ops.scatter_blocks(vals, start, out_len, blk, perm=perm)
        b = block_ops.scatter_blocks_plain(vals, start, out_len, blk, perm=perm)
        again = block_ops.scatter_blocks(vals, start, out_len, blk, perm=perm)
    else:
        a = block_ops.scatter_blocks_multi(vals, start, out_len, blk, marker_tail=tail)
        b = block_ops.scatter_blocks_multi_plain(vals, start, out_len, blk, marker_tail=tail)
        again = block_ops.scatter_blocks_multi(vals, start, out_len, blk, marker_tail=tail)
    torch.cuda.synchronize()
    assert len(a) == ncols
    assert all(x.shape == (out_len,) and x.dtype == v.dtype for x, v in zip(a, vals))
    assert all(_eq(x, y) for x, y in zip(a, b))
    assert all(_eq(x, y) for x, y in zip(a, again))


# (rows, live fraction, keep, columns)
COMPACT_TILE_CASES = {
    "no live row": (3 * 4096 + 77, 0.0, 4096, 1),
    "every row live": (5 * 4096, 1.0, 5 * 4096, 2),
    "live over keep": (9 * 4096 + 5, 0.4, 2 * 4096, 2),
    "ragged, keep past the rows": (4096 + 10, 0.6, 40000, 3),
    "many tiles": (600 * 4096 + 123, 0.25, 160 * 4096, 1),
}


@pytest.mark.parametrize("case", list(COMPACT_TILE_CASES))
def test_compact_rows_kernel(dev, case):
    """compact_rows (K6 and K3' in one pass) against its plain version, the
    composition of the plain K6 and K3': every column and n_valid bit-equal,
    and a second launch gives the same bits."""
    n, frac, keep, ncols = COMPACT_TILE_CASES[case]
    g = torch.Generator().manual_seed(n)
    key = torch.randint(0, 1 << 30, (n,), generator=g, dtype=torch.int64).to(torch.int32)
    key[torch.rand(n, generator=g) >= frac] = -1
    cols = [torch.rand(n, generator=g), torch.randint(-9, 9, (n,), generator=g,
                                                      dtype=torch.int32),
            torch.rand(n, generator=g)][:ncols]
    key, cols = key.to(dev), [c.to(dev) for c in cols]
    a, na = block_ops.compact_rows(key, cols, keep, 4096)
    b, nb = block_ops.compact_rows_plain(key, cols, keep, 4096)
    again, _ = block_ops.compact_rows(key, cols, keep, 4096)
    torch.cuda.synchronize()
    assert int(na) == int(nb) == int((key != -1).sum())
    assert len(a) == 1 + ncols and all(x.shape == (keep,) for x in a)
    assert all(x.dtype == y.dtype for x, y in zip(a, b))
    assert all(_eq(x, y) for x, y in zip(a, b))
    assert all(_eq(x, y) for x, y in zip(a, again))


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
    again, _ = seg_scan.fused_scan_call(sk, sw, tbl, 7, 64, emit_key2=True)
    assert all(_eq(x, y) for x, y in zip(again, a))


def _scan_rows(case, K=64, shift=7):
    """Sorted fold rows with one marker per pixel (the last row of its run)
    and dead rows at the end, as the spectral fold makes them."""
    g = np.random.default_rng(11)
    if case == "hot pixel":
        n, n_pixels = 1 << 21, 1000
        pix = np.where(g.random(n) < 0.92, 377, g.integers(0, n_pixels, n))
    elif case == "ragged":
        n, n_pixels = 100_003 - 1000, 1000      # rows no multiple of the tile
        pix = g.integers(0, n_pixels, n)
    else:
        n, n_pixels = 300_000, 40_000
        pix = g.integers(0, n_pixels, n)
        pix[g.random(n) < 0.3] = n_pixels       # pixels past the image: dead
    wl = g.integers(0, K, n)
    key = np.where(pix < n_pixels, (pix << shift) | (wl << 1), 0xFFFFFFFF)
    markers = (np.arange(n_pixels) << shift) | (2 * K - 1)
    key = np.sort(np.concatenate([key, markers]).astype(np.uint64)).astype(np.uint32)
    w = (g.random(key.size) * 2).astype(np.float32)
    w[(key & (2 * K - 1)) == 2 * K - 1] = 0.0
    if case == "all dead":
        key[:] = 0xFFFFFFFF
        w[:] = 0.0
    return key, w, n_pixels


@pytest.mark.parametrize("case", ["spread", "hot pixel", "ragged", "all dead"])
def test_fused_scan_extract_kernel(dev, case):
    """The fused K4 (scan + marker extraction) against its plain twin (the
    per-row scan, each marker's totals stored at its pixel): spread rows with dead ones; one pixel
    with more than 90% of 2^21 rows (about 940 tiles in one run); a row
    count that is no multiple of the 2048-row tile; every row dead. Rtol
    1e-6 (both sum in float64), and a second launch with the same bits."""
    key, w, n_pixels = _scan_rows(case)
    sk = torch.as_tensor(key.view(np.int32), device=dev)
    sw = torch.as_tensor(w, device=dev)
    tbl = torch.rand(64, 3, device=dev)
    got = seg_scan.fused_scan_extract(sk, sw, tbl, 7, 64, n_pixels)
    want = seg_scan.fused_scan_extract_plain(sk, sw, tbl, 7, 64, n_pixels)
    torch.cuda.synchronize()
    assert got.shape == (n_pixels, 3)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    assert _eq(seg_scan.fused_scan_extract(sk, sw, tbl, 7, 64, n_pixels), got)
    if case == "hot pixel":
        assert int((key >> 7 == 377).sum()) > 0.9 * (1 << 21) and float(got[377].min()) > 0
    if case == "all dead":
        assert not got.any()
    if case == "ragged":
        assert key.size % 2048


# (rows, pixels P or None, end_bit, keys): the premerged fold's rows at both
# bench cells (live keys of K = 64 with dead ones among them, (0, 0) filler,
# the P marker tail, dead padding); rows none, one, below a tile, no
# multiple of a tile; all keys equal; one and 32 sorted bits; keys on the
# top sorted bit only.
RADIX_CASES = {
    "r512": (1_081_344, 1 << 17, 25, "fold"), "r2048": (3_043_328, 1 << 21, 29, "fold"),
    "no rows": (0, None, 32, "random"), "one row": (1, None, 25, "random"),
    "below a tile": (1000, None, 25, "random"), "ragged": (3 * 4096 + 1234, None, 29, "fold"),
    "all equal": (50_000, None, 25, "equal"), "end_bit 1": (70_001, None, 1, "random"),
    "end_bit 32": (200_000, None, 32, "random"), "top bit only": (200_000, None, 29, "top"),
}


def _radix_rows(case, g):
    n, P, end_bit, kind = RADIX_CASES[case]
    if kind == "random":
        k = g.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    elif kind == "equal":
        k = np.full(n, 0x1234567, np.uint32)
    elif kind == "top":
        k = (g.integers(0, 2, n, dtype=np.uint64) << (end_bit - 1)).astype(np.uint32)
    else:
        P = P or 2000
        assert accum.sort_end_bit(P, 64) == end_bit or case == "ragged"
        tail = -(-P // 4096) * 4096 + 4096
        live = (n - tail) * 9 // 10
        keep = n - tail
        k = np.full(n, 0xFFFFFFFF, np.uint32)
        pix = g.integers(0, P, live, dtype=np.uint64)
        k[:live] = (pix << 7 | g.integers(0, 64, live, dtype=np.uint64) << 1).astype(np.uint32)
        k[:live][g.random(live) < 0.02] = 0xFFFFFFFF
        k[live:keep] = 0
        k[keep:keep + P] = (np.arange(P, dtype=np.uint64) << 7 | 127).astype(np.uint32)
    w = np.where(k == 0xFFFFFFFF, 0.0, g.random(n) + 0.5).astype(np.float32)
    return k, w, end_bit


@pytest.mark.parametrize("case", list(RADIX_CASES) + ["graph"])
def test_radix_sort_kernel(dev, case, monkeypatch):
    """The radix sort (csrc/radix_sort.cu) against its plain twin, bit for
    bit, at both bench cells' shapes and at the edges; a second call on the
    same input gives the same bits and the input is not written; the
    launch counters add one sort and its passes. "graph": BENCH_CFG's
    batches replayed from a CUDA graph give the eager run's image bit for
    bit, one sort a batch."""
    from ice_halo_sim_tpu_torch.core import radix_sort
    from ice_halo_sim_tpu_torch.kernels import build

    if case == "graph":
        monkeypatch.setenv("IHT_STEPS_PER_DISPATCH", "4")
        imgs = []
        for graphs in (False, True):
            eng = Engine(load_project(BENCH_CFG), seed=7, batch_size=65536, device=dev,
                         graphs=graphs)
            eng.run(n_batches=4)
            before, replays = build.LAUNCHES["radix_sort"], eng.overflow_replays
            eng.run(n_batches=8)
            # An overflowing batch is folded again, eagerly, by the full fold.
            assert build.LAUNCHES["radix_sort"] - before == (
                8 + eng.overflow_replays - replays) * len(eng.proj_plans)
            imgs.append([a.clone() for a in eng.accum])
        assert eng.graph_mode == "cuda graph"
        assert all(_eq(a, b) for a, b in zip(*imgs))
        return
    k, w, end_bit = _radix_rows(case, np.random.default_rng(29))
    keys = torch.as_tensor(k.view(np.int32), device=dev)
    vals = torch.as_tensor(w, device=dev)
    k0, v0 = keys.clone(), vals.clone()
    n0 = dict(build.LAUNCHES)
    got = radix_sort.sort_pairs(keys, vals, end_bit)
    torch.cuda.synchronize()
    want = radix_sort.sort_pairs_plain(keys, vals, end_bit)
    assert _eq(got[0], want[0]) and _eq(got[1], want[1])
    again = radix_sort.sort_pairs(keys, vals, end_bit)
    assert _eq(again[0], got[0]) and _eq(again[1], got[1])
    assert _eq(keys, k0) and _eq(vals, v0)
    runs = 2 if k.size else 0
    assert build.LAUNCHES["radix_sort"] - n0["radix_sort"] == runs
    assert build.LAUNCHES["radix_sort_pass"] - n0["radix_sort_pass"] == runs * radix_sort.passes(
        end_bit)


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
    one-row blocks; bit-equal. Then compact_valid and compact_by_key (with
    and without the key column) through both kernel sets."""
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
    x = accum.compact_by_key(key, cols, 3 * block, kernel_set("cuda"), with_key=False)
    assert all(_eq(p, q) for p, q in zip(x[0], y[0][1:])) and len(x[0]) == ncols


def test_general_path_engine_cuda_matches_plain(dev):
    """The general trace path (two layers, two settings, a filter; then
    colour classes) through the CUDA kernel set against the plain set on the
    card: the same torch trace, so segments and images agree."""
    from ice_halo_sim_tpu_torch.scenes import COLOR_CFG, MS_CFG

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
    (3, False, 255, 64), (3, False, 1, 1), (3, False, 60_000, 4096), (1, False, 60_000, 4096),
    (1, True, 50_000, 390)])
def test_sandwich_kernels(dev, layout, c_out, precise, n, nc):
    """K7 (lane) and K8 (sublane) against the plain version: a shuffled list
    with padding ids and ids outside the image, row counts that are no
    multiple of a slab, lists shorter and longer than a block's slice of the
    list up to the engine's limits (4096 chunks, 128 pool entries), a
    running tile that is not zero, one channel with two bf16 terms."""
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
    # Run after run the same bits: every add has a fixed place in the order.
    again, _ = sandwich.sandwich_pass(tile, cl, pix, w, wl, tbl, k_pool=K, precise=precise,
                                      layout=layout)
    assert torch.equal(again, got)


def _sandwich_case(dev, layout, pix, w, wl, tbl, cl, K, precise=False, tile=None):
    """Kernel against plain version: matched equal, tile close, and a second
    run with the same bits. Returns the kernel's tile."""
    from ice_halo_sim_tpu_torch.core import sandwich

    c_out = tbl.shape[1]
    if tile is None:
        tile = torch.zeros((cl.shape[0], c_out * sandwich.NLO), device=dev)
    got, gm = sandwich.sandwich_pass(tile, cl, pix, w, wl, tbl, k_pool=K, precise=precise,
                                     layout=layout)
    want, wm = sandwich.sandwich_pass_plain(tile, cl, pix, w, wl, tbl, k_pool=K,
                                            precise=precise)
    torch.cuda.synchronize()
    assert torch.equal(gm, wm)
    _assert_tile_close(got, want)
    again, am = sandwich.sandwich_pass(tile, cl, pix, w, wl, tbl, k_pool=K, precise=precise,
                                       layout=layout)
    assert torch.equal(again.view(torch.int32), got.view(torch.int32)) and torch.equal(am, gm)
    return got


@pytest.mark.parametrize("layout", ["lane", "sublane"])
@pytest.mark.parametrize("c_out", [3, 1])
@pytest.mark.parametrize("extra", [-1, 0, 1, "2S+1"])
def test_sandwich_slice_edges(dev, layout, c_out, extra):
    """List lengths S - 1, S, S + 1 and 2S + 1 around the block's slice of
    S = list_block(C) entries (128 at three channels, 384 at one), the list
    shuffled, rows on every listed chunk and on chunks outside the list."""
    from ice_halo_sim_tpu_torch.core import sandwich

    S = sandwich.list_block(c_out)
    nc = 2 * S + 1 if extra == "2S+1" else S + extra
    K = 32
    pix, w, wl, tbl = _sandwich_rows(dev, 200_003, (nc + 30) * sandwich.NLO, K, c_out,
                                     seed=nc)
    cl = torch.as_tensor(np.random.default_rng(nc).permutation(nc + 30)[:nc].astype(np.int32),
                         device=dev)
    _sandwich_case(dev, layout, pix, w, wl, tbl, cl, K)


@pytest.mark.parametrize("layout", ["lane", "sublane"])
def test_sandwich_hot_pixel(dev, layout):
    """2^20 + 5 live rows on one pixel (one warp's cell takes them all, in
    order) beside a few elsewhere: the tile close to the plain sum and the
    same bits twice."""
    from ice_halo_sim_tpu_torch.core import sandwich

    K, n = 16, (1 << 20) + 5
    g = np.random.default_rng(4)
    pix = np.full(n, 5 * sandwich.NLO + 77, np.int32)
    pix[::100_000] = g.integers(0, 8 * sandwich.NLO, pix[::100_000].shape[0])
    w = (g.random(n) + 0.5).astype(np.float32)
    wl = g.integers(0, K, n).astype(np.int32)
    tbl = g.random((K, 3)).astype(np.float32)
    rows = [torch.as_tensor(x, device=dev) for x in (pix, w, wl, tbl)]
    cl = torch.tensor([3, 5, 0, 7], dtype=torch.int32, device=dev)
    got = _sandwich_case(dev, layout, *rows, cl, K)
    assert float(got[1, 77]) > 0.25 * n * float(tbl[:, 0].min())


@pytest.mark.parametrize("layout", ["lane", "sublane"])
def test_sandwich_all_dead(dev, layout):
    """Every row dead (pix -1, weight 0): nothing matches, the tile passes
    through unchanged."""
    K, n = 16, 70_000
    pix = torch.full((n,), -1, dtype=torch.int32, device=dev)
    w = torch.zeros(n, device=dev)
    wl = torch.zeros(n, dtype=torch.int32, device=dev)
    tbl = torch.rand((K, 3), device=dev)
    cl = torch.arange(300, dtype=torch.int32, device=dev)
    tile = torch.rand((300, 384), device=dev)
    got = _sandwich_case(dev, layout, pix, w, wl, tbl, cl, K, tile=tile)
    assert torch.equal(got, tile)


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


def test_trace_emit_reads_base_from_device(dev):
    """K2 and K2b read the ray base from device memory: the kernel with the
    words tensor equals the twin at a base whose low word wraps inside the
    batch (the carry into the high word), and rewriting the words in place
    (as a replayed CUDA graph's batch does) moves the launch to the new
    base."""
    for doc in (BENCH_CFG, POOL_CFG):
        eng = Engine(load_project(doc), seed=7, batch_size=8192, device=dev, graphs=False)
        plan = eng._trace_plan
        tables = eng._pool_tables(3) if plan.pool_k else ()
        base = (2 << 32) | 0xFFFFF000
        words = trace_emit.base_words(base, dev)
        a = trace_emit.trace_emit(plan, words, 8192, dev, *tables)
        b = trace_emit.trace_emit_plain(plan, base, 8192, dev, *tables)
        d = trace_emit.trace_output_diff(a[0], b[0])
        assert d["rows_diff"] == 0 and d["blocks_diff"] == 0 and d["w_rel"] <= 1e-6, d
        words.copy_(trace_emit.base_words(5 << 12, dev))
        again = trace_emit.trace_emit(plan, words, 8192, dev, *tables)
        assert _same_bits(again, trace_emit.trace_emit(plan, 5 << 12, 8192, dev, *tables))
        assert not _same_bits(again, a)


@pytest.mark.parametrize("scene", ["bench", "ms"])
def test_graph_replay_equals_eager(dev, monkeypatch, scene):
    """Batches replayed from a CUDA graph give the eager batches' bits:
    one calibrating dispatch and two steady dispatches of four, images,
    landed weight and stats; one host read per steady dispatch."""
    from ice_halo_sim_tpu_torch.scenes import MS_CFG

    monkeypatch.setenv("IHT_STEPS_PER_DISPATCH", "4")
    doc = {"bench": BENCH_CFG, "ms": MS_CFG}[scene]
    out = []
    for graphs in (False, True):
        eng = Engine(load_project(doc), seed=7, batch_size=16384, device=dev, graphs=graphs)
        eng.run(n_batches=4)
        syncs = eng.host_syncs
        eng.run(n_batches=4)
        eng.run(n_batches=4)
        if not eng.overflow_replays:
            assert eng.host_syncs - syncs == 2
        out.append((eng, eng.drain_stats()))
    (e, se), (g, sg) = out
    assert g.graph_mode == "cuda graph" and g._graph is not None
    assert se == sg and e.overflow_replays == g.overflow_replays
    for a, b in zip(e.accum, g.accum):
        assert _eq(a, b)


@pytest.mark.parametrize("what", ["compact_rows", "marker tail", "compact_by_key"])
def test_compactions_with_overflow_stay_in_bounds(dev, what):
    """The three compacted branches with more live rows than they keep (a
    captured batch takes them before its overflow is known): the kernel
    equals the plain twin, and tensors allocated right after the output are
    untouched."""
    g = np.random.default_rng(5)
    n = 6 * 4096
    live = g.random(n) < 0.6
    key_np = np.where(live, g.integers(0, 1 << 20, n), 0xFFFFFFFF).astype(np.uint32)
    key = torch.as_tensor(key_np.view(np.int32), device=dev)
    w = torch.as_tensor(np.where(live, g.random(n) + 0.5, 0).astype(np.float32), device=dev)
    keep = int(live.sum()) // 3
    ks_c, ks_p = accum_kernel_sets()
    if what == "compact_rows":
        run = lambda ks, k, c: accum.compact_valid(k, [c], keep, ks)[0]  # noqa: E731
    elif what == "compact_by_key":
        run = lambda ks, k, c: accum.compact_by_key(k, [c], keep, ks)[0]  # noqa: E731
    else:
        pk, pw, counts = block_ops.pack_rows_plain(key.cpu(), w.cpu(), 4096)
        pk, pw, counts = pk.to(dev), pw.to(dev), counts.to(dev)
        start = accum._exclusive_starts(counts)
        out_total = -(-(keep + 3000) // 4096) * 4096

        def run(ks, k, c):
            return ks.scatter_blocks_multi([pk.view(6, 4096), pw.view(6, 4096)], start,
                                           out_total, 4096, marker_tail=(keep, 3000, 7, 127))
    got = run(ks_c, key, w)
    canary = [torch.full((4096,), 7, dtype=torch.int32, device=dev) for _ in range(8)]
    got = run(ks_c, key, w)
    torch.cuda.synchronize()
    want = run(ks_p, key.cpu(), w.cpu())
    assert all(_eq(x, y.to(dev)) for x, y in zip(got, want))
    assert all(bool((c == 7).all()) for c in canary)


def accum_kernel_sets():
    from ice_halo_sim_tpu_torch.kernels import kernel_set

    return kernel_set("cuda"), kernel_set("plain")


# --- The compiled gradient render (engine/gradient.py over engine/graph.py) --
# Graph against eager on the card: images by grad_validation.image_errors
# (the splat adds with float atomics: a tolerance, never bits), gradients
# within GRAD_RTOL of the mode, recorded choices bit for bit.

def test_gradient_forms_graph_against_eager(dev):
    """Each of make_render_fn's four forms (plain, free and soft_tau;
    seed_as_arg at two seeds; record; render_frozen) as captured programs
    against its eager body (grad_validation.graph_check), and the graph
    mode of each is a CUDA graph."""
    from ice_halo_sim_tpu_torch import grad_validation

    errs = grad_validation.graph_check(dev, batch=1 << 14)
    assert errs["record_flipped_rays"] == 0
    assert set(errs["graph_mode"].values()) == {"cuda graph"}


def test_gradient_graph_takes_each_seed(dev):
    """The seed_as_arg program replayed at two seeds, numbers and an int64
    tensor in turn: each image equals eager at its own seed (a seed baked
    into the capture would repeat the first image), and the two differ."""
    from ice_halo_sim_tpu_torch import grad_validation as gv
    from ice_halo_sim_tpu_torch.engine.gradient import default_params, make_render_fn

    cfg = gv.tilted_cfg()
    params = default_params(cfg, dev)
    fn = make_render_fn(cfg, batch_size=1 << 14, seed_as_arg=True, device=dev)
    with torch.no_grad():
        imgs = [fn(params, 11), fn(params, torch.tensor(12, device=dev)), fn(params, 11)]
        for img, sd in zip(imgs, (11, 12, 11)):
            e = gv.image_errors("free", img.cpu().numpy(), fn.body(params, sd).cpu().numpy())
            assert e["ok"], (sd, e)
    assert fn.graph_mode == "cuda graph" and fn.graph is not None
    assert not torch.equal(imgs[0], imgs[1])
    assert gv.image_errors("free", imgs[2].cpu().numpy(), imgs[0].cpu().numpy())["ok"]


def test_table_programs_replay_against_eager(dev):
    """Per parameter, the table's gradient and loss functions (over one
    capture of each seed_as_arg program) called at two seeds against the
    eager step at the same (v, seed): gradients within GRAD_RTOL, the loss
    within 2 * IMG_RTOL."""
    from ice_halo_sim_tpu_torch import grad_validation as gv
    from ice_halo_sim_tpu_torch.engine.gradient import default_params, make_render_fn

    cfg = gv.tilted_cfg()
    params = default_params(cfg, dev)
    B = 1 << 14
    for name, rep, eps, tau in gv.PARAMS:
        v0 = float(params.face_distance[0] if name == "face_d0" else getattr(params, name))
        grad_fn, loss_fn, programs = gv.table_programs(cfg, params, rep, tau, B, dev)
        assert {p.graph_mode for p in programs} == {"cuda graph"}
        hard = make_render_fn(cfg, batch_size=B, seed_as_arg=True, device=dev)
        soft = make_render_fn(cfg, batch_size=B, soft_tau=tau, seed_as_arg=True,
                              device=dev) if tau else hard
        for sd in (1000, 1001):
            (g,) = grad_fn(v0, sd)
            loss = loss_fn(v0 + eps, sd)
            v = torch.tensor(v0, device=dev, requires_grad=True)
            (want,) = torch.autograd.grad(gv.smooth_loss(soft.body(rep(params, v), sd)), v)
            with torch.no_grad():
                want_l = gv.smooth_loss(hard.body(rep(params, torch.tensor(
                    v0 + eps, device=dev)), sd))
            err = gv.grad_err(g.cpu().numpy(), want.cpu().numpy())
            assert err <= gv.GRAD_RTOL["soft" if tau else "free"], (name, sd, err)
            assert abs(float(loss) - float(want_l)) <= 2 * gv.IMG_RTOL * abs(float(want_l))


def test_grad_graph_backward_after_a_later_forward_raises(dev):
    """A backward needs the tensors its forward saved in the graph's pool:
    after a later call of the same program has replayed over them, it
    raises instead of returning the later call's gradient."""
    from ice_halo_sim_tpu_torch.engine.graph import GradGraph

    g = GradGraph(lambda x: (x * x).sum(), (torch.ones(4, device=dev),), dev, diff=(0,))
    a = torch.full((4,), 2.0, device=dev, requires_grad=True)
    b = torch.full((4,), 3.0, device=dev, requires_grad=True)
    (ya,) = GradGraph.apply(g, a)
    (yb,) = GradGraph.apply(g, b)
    assert float(ya.detach()) == 16.0 and float(yb.detach()) == 36.0
    (gb,) = torch.autograd.grad(yb, b)
    assert torch.equal(gb, torch.full((4,), 6.0, device=dev))
    with pytest.raises(RuntimeError, match="later forward"):
        torch.autograd.grad(ya, a)


def test_post_process_on_the_card_against_the_host(dev):
    """post_process of a card tensor (the device form) against the same
    image on the host: uint8 within 1 level, on at most POST_LEVEL_FRAC of
    the values (powf and the 3 x 3 products differ in their last bits)."""
    from ice_halo_sim_tpu_torch.core import color

    g = np.random.default_rng(21)
    xyz = (g.uniform(0.0, 50.0, (256, 512, 3)) * g.uniform(size=(256, 512, 1)) ** 3).astype(
        np.float32)
    for real in (True, False):
        args = (1.0, 2.0e4, (0.0, 0.0, 0.1), (1.0, 0.8, 0.6))
        a = color.post_process(torch.as_tensor(xyz, device=dev), *args, use_real_color=real)
        b = color.post_process(xyz, *args, use_real_color=real)
        d = np.abs(a.astype(int) - b.astype(int))
        assert d.max() <= 1 and (d > 0).sum() <= POST_LEVEL_FRAC * d.size, (real, (d > 0).sum())


# uint8 values that may differ by one level between the card's post_process
# and the host's, as a fraction of the values.
POST_LEVEL_FRAC = 1e-3


def test_viewer_exposure_post_processes_on_the_card(dev, monkeypatch):
    """The viewer's PNG at a nonzero EV re-tone-maps the frame's XYZ on the
    server's device, as JAX's viewer does on its device; its uint8 image
    within 1 level of the host's post-process."""
    from ice_halo_sim_tpu_torch.core import color
    from ice_halo_sim_tpu_torch.engine.server import Server
    from ice_halo_sim_tpu_torch.gui.app import GuiApp

    real, handed = color.post_process, []

    def spy(xyz, *args, **kw):
        out = real(xyz, *args, **kw)
        handed.append((xyz, args, kw, out))
        return out

    cfg = dict(BENCH_CFG, scene=dict(BENCH_CFG["scene"], ray_num=1 << 16))
    with Server(seed=3, batch_size=1 << 14, device=dev) as srv:
        srv.commit(cfg)
        assert srv.wait_idle(timeout=300)
        gui = GuiApp(srv)
        gui.frame()
        monkeypatch.setattr(color, "post_process", spy)
        png = gui.render_png(0, 1.5)
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    ((xyz, args, kw, out),) = handed
    assert isinstance(xyz, torch.Tensor) and xyz.device.type == "cuda"
    d = np.abs(out.astype(int) - real(xyz.cpu().numpy(), *args, **kw).astype(int))
    assert d.max() <= 1 and (d > 0).sum() <= POST_LEVEL_FRAC * d.size


def test_capture_failure_raises(dev):
    """A step that reads a value back to the host cannot be captured: the
    capture raises (no fallback to eager), and the card still works."""
    from ice_halo_sim_tpu_torch.engine.graph import GradGraph

    with pytest.raises(RuntimeError):
        GradGraph(lambda x: x * float(x.sum()), (torch.ones(3, device=dev),), dev, diff=(0,))
    torch.cuda.synchronize(dev)
    assert float((torch.ones(3, device=dev) * 2).sum()) == 6.0


def test_graph_replays_inside_profiler_windows(dev, monkeypatch):
    """An Engine's steady batch (MS_CFG, the general path, some 5000
    kernels) replayed inside profiler windows, 20 times in one process:
    each window's warm call captures the batch anew just before it (a
    window makes every earlier capture stale: utils/profiling.py), the
    window replays that graph and captures nothing, and records the
    replays' device work and the launches they counted."""
    from ice_halo_sim_tpu_torch.kernels import build
    from ice_halo_sim_tpu_torch.scenes import MS_CFG
    from ice_halo_sim_tpu_torch.utils.profiling import device_profile

    monkeypatch.setenv("IHT_STEPS_PER_DISPATCH", "2")
    eng = Engine(load_project(MS_CFG), seed=7, batch_size=16384, device=dev)
    eng.run(n_batches=2)
    eng.run(n_batches=2)
    assert eng.graph_mode == "cuda graph" and eng._graph is not None
    graphs = []
    for i in range(20):
        with device_profile(warm=lambda: eng.run(n_batches=2)) as first:
            eng.run(n_batches=2)
            torch.cuda.synchronize(dev)
        with device_profile(warm=lambda: eng.run(n_batches=1)) as win:
            graph = eng._graph
            before = dict(build.LAUNCHES)
            eng.run(n_batches=2)
            torch.cuda.synchronize(dev)
        assert eng._graph is graph and graph not in graphs
        graphs.append(graph)
        assert graph.launches.get("fused_scan_extract", 0) > 0
        assert {k: v - before[k] for k, v in build.LAUNCHES.items() if v != before[k]} == {
            k: 2 * v for k, v in graph.launches.items()}
        assert not first.empty and not win.empty and win.kernels > 1000, (i, win.kernels)


def test_render_program_captures_again_for_a_window(dev):
    """A RenderProgram's graph goes stale when a profiler window opens: the
    window's warm call captures the program anew (outside the profiler),
    the window replays that capture, and the replayed forward and backward
    equal the eager body's at the same seed."""
    from ice_halo_sim_tpu_torch import grad_validation as gv
    from ice_halo_sim_tpu_torch.engine.gradient import default_params, make_render_fn
    from ice_halo_sim_tpu_torch.utils.profiling import device_profile

    cfg = gv.tilted_cfg()
    params = default_params(cfg, dev)
    fn = make_render_fn(cfg, batch_size=1 << 14, seed_as_arg=True, device=dev)

    def step(body=None):
        v = params.zenith_std_deg.detach().clone().requires_grad_(True)
        p = params._replace(zenith_std_deg=v)
        img = (fn if body is None else body)(p, 21)
        (g,) = torch.autograd.grad(gv.smooth_loss(img), v)
        return img.detach(), g

    step()
    first = fn.graph
    with device_profile(warm=step) as win:
        captured = fn.graph
        img, g = step()
        torch.cuda.synchronize(dev)
    assert first.stale and captured is not first and not captured.stale
    assert fn.graph is captured and not win.empty
    want_img, want_g = step(fn.body)
    assert gv.image_errors("free", img.cpu().numpy(), want_img.cpu().numpy())["ok"]
    assert gv.grad_err(g.cpu().numpy(), want_g.cpu().numpy()) <= gv.GRAD_RTOL["free"]
