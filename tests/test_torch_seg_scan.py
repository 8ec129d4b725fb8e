"""Port fused basis + segmented scan (plain twin of csrc/seg_scan.cu)
against the JAX Pallas kernel run in the interpreter, with pixel runs that
cross the TPU kernel's 32768-row blocks.

key2 must be bit-equal. Channels: rtol 1e-5 -- the TPU kernel sums in
float32 by a Hillis-Steele tree per block plus a carried run total, the
port in float64 rounded once; both are run-local sums of nonnegative
terms, so only the summation order (a few float32 ulps per run) differs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ice_halo_sim_tpu.core import pallas_scan
from ice_halo_sim_tpu_torch.core import seg_scan

# Tier-1 runs six workers; keep each one to two torch threads.
torch.set_num_threads(2)

K = 64
SHIFT = 7  # log2(2K)


def _rows(seed):
    g = np.random.default_rng(seed)
    # Run lengths: mostly short, a few long enough to span blocks.
    lens = np.concatenate([g.integers(1, 40, 1500), [40000, 70000, 5]])
    g.shuffle(lens)
    pix = np.repeat(np.arange(lens.size, dtype=np.uint64) * 3 + 1, lens)
    wl = g.integers(0, K, pix.size).astype(np.uint64)
    key = (pix << SHIFT) | (wl << 1)
    run_end = np.cumsum(lens) - 1
    key[run_end] = (pix[run_end] << SHIFT) | (2 * K - 1)     # markers
    key = np.sort(key).astype(np.uint32)
    w = g.uniform(0.0, 50.0, key.size).astype(np.float32)
    w[(key & (2 * K - 1)) == 2 * K - 1] = 0.0
    return key, w


def test_fused_scan_matches_pallas_kernel(monkeypatch):
    monkeypatch.setattr(pallas_scan, "INTERPRET", True)
    key, w = _rows(3)
    assert key.size > 3 * 32768 and key.size % 32768
    tbl = np.random.default_rng(4).uniform(0.0, 2.0, (K, 3)).astype(np.float32)
    (jc, jk2) = pallas_scan.fused_scan_call(jnp.asarray(key), jnp.asarray(w),
                                            jnp.asarray(tbl), SHIFT, K, emit_key2=True)
    tc, tk2 = seg_scan.fused_scan_call(torch.as_tensor(key.view(np.int32)),
                                       torch.as_tensor(w), torch.as_tensor(tbl),
                                       SHIFT, K, emit_key2=True)
    np.testing.assert_array_equal(tk2.numpy().view(np.uint32), np.asarray(jk2))
    for a, b in zip(tc, jc):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("seed", [1, 2])
def test_fused_scan_plain_equals_float64_oracle(seed):
    key, w = _rows(seed)
    tbl = np.random.default_rng(seed).uniform(0.0, 2.0, (K, 3)).astype(np.float32)
    chans = seg_scan.fused_scan_call(torch.as_tensor(key.view(np.int32)),
                                     torch.as_tensor(w), torch.as_tensor(tbl),
                                     SHIFT, K)
    vals = (tbl[(key >> 1) & (K - 1)] * w[:, None]).astype(np.float64)
    pix = key >> SHIFT
    out = np.empty_like(vals)
    run = np.zeros(3)
    for i in range(key.size):
        run = vals[i] if i == 0 or pix[i] != pix[i - 1] else run + vals[i]
        out[i] = run
    for c in range(3):
        np.testing.assert_allclose(chans[c].numpy(), out[:, c], rtol=2e-7, atol=1e-6)


def _fold_rows(seed, n_pixels=3000, long_run=40000):
    """Sorted fold rows as the spectral fold makes them: contribution rows
    on about two thirds of the pixels (one pixel with a run of `long_run`
    rows, longer than a tile of either kernel), one zero-weight marker per
    pixel behind its contributions, dead rows (0xFFFFFFFF, 0) at the end.
    Returns (key u32, w f32, live contribution rows)."""
    g = np.random.default_rng(seed)
    lens = g.integers(1, 30, n_pixels)
    lens[g.random(n_pixels) < 0.35] = 0                  # pixels with no rows
    lens[n_pixels // 2] = long_run
    pix = np.repeat(np.arange(n_pixels, dtype=np.uint64), lens)
    wl = g.integers(0, K, pix.size).astype(np.uint64)
    contrib = (pix << SHIFT) | (wl << 1)
    markers = (np.arange(n_pixels, dtype=np.uint64) << SHIFT) | (2 * K - 1)
    key = np.sort(np.concatenate([contrib, markers])).astype(np.uint32)
    w = g.uniform(0.0, 50.0, key.size).astype(np.float32)
    w[(key & (2 * K - 1)) == 2 * K - 1] = 0.0
    n_dead = 4096 * 3 - key.size % 4096 + 123
    key = np.concatenate([key, np.full(n_dead, 0xFFFFFFFF, np.uint32)])
    w = np.concatenate([w, np.zeros(n_dead, np.float32)])
    return key, w, contrib.size


def _jax_extract(key, w, tbl, n_pixels):
    """JAX: the Pallas scan (interpreted), then accum._marker_extract on the
    rows padded to its block."""
    from ice_halo_sim_tpu.core import accum as jaccum

    jc, jk2 = pallas_scan.fused_scan_call(jnp.asarray(key), jnp.asarray(w),
                                          jnp.asarray(tbl), SHIFT, K, emit_key2=True)
    pad = -key.size % jaccum.BLOCK
    jk2 = jnp.concatenate([jk2, jnp.full(pad, 0xFFFFFFFF, jk2.dtype)])
    jc = [jnp.concatenate([c, jnp.zeros(pad, c.dtype)]) for c in jc]
    return np.asarray(jaccum._marker_extract(jk2, jc, n_pixels))


@pytest.mark.parametrize("cut", [False, True])
def test_fused_scan_extract_matches_pallas_and_marker_extract(monkeypatch, cut):
    """The plain fused_scan_extract (per-row scan, then the marker
    extraction) against JAX fused_scan_call + _marker_extract, and against a
    float64 bincount of the contributions: pixels with no rows are zero, the
    long run crosses tiles. With `cut` the rows are cut to a prefix of
    live rows + P rounded up to the block (fold_spectral_keys' prefix_len,
    exact there): the dead tail goes and the image does not change. Rtol
    1e-5 against JAX (float32 sums in another order), 2e-7 against the
    float64 oracle."""
    monkeypatch.setattr(pallas_scan, "INTERPRET", True)
    n_pixels = 3000
    key, w, live = _fold_rows(5)
    if cut:
        n = -(-(live + n_pixels) // 4096) * 4096
        assert n < key.size
        key, w = key[:n], w[:n]
    tbl = np.random.default_rng(6).uniform(0.0, 2.0, (K, 3)).astype(np.float32)
    got = seg_scan.fused_scan_extract(torch.as_tensor(key.view(np.int32)), torch.as_tensor(w),
                                      torch.as_tensor(tbl), SHIFT, K, n_pixels).numpy()
    want = _jax_extract(key, w, tbl, n_pixels)
    assert got.shape == want.shape == (n_pixels, 3)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * float(want.max()))
    vals = tbl[(key >> 1) & (K - 1)].astype(np.float64) * w[:, None].astype(np.float64)
    pix = (key >> SHIFT).astype(np.int64)
    ok = pix < n_pixels
    oracle = np.stack([np.bincount(pix[ok], weights=vals[ok, c], minlength=n_pixels)
                       for c in range(3)], axis=1)
    np.testing.assert_allclose(got, oracle, rtol=2e-7, atol=1e-6)
    assert (got[oracle.sum(1) == 0] == 0).all() and (oracle.sum(1) == 0).sum() > 100


def test_fused_scan_extract_drops_pixels_whose_marker_is_cut():
    """A prefix that ends inside the rows: the pixels whose markers are in
    the prefix keep their totals, the rest are zero."""
    key, w, _live = _fold_rows(7, n_pixels=500, long_run=3000)
    tbl = np.random.default_rng(8).uniform(0.0, 2.0, (K, 3)).astype(np.float32)
    args = (torch.as_tensor(tbl), SHIFT, K, 500)
    full = seg_scan.fused_scan_extract(torch.as_tensor(key.view(np.int32)),
                                       torch.as_tensor(w), *args).numpy()
    n = 4096
    part = seg_scan.fused_scan_extract(torch.as_tensor(key[:n].view(np.int32)),
                                       torch.as_tensor(w[:n]), *args).numpy()
    kept = int(((key[:n] & (2 * K - 1)) == 2 * K - 1).sum())
    assert 0 < kept < 500
    np.testing.assert_array_equal(part[:kept], full[:kept])
    assert not part[kept:].any()


@pytest.mark.parametrize("n_rows", [None, 4096, 12288])
def test_fused_scan_extract_equals_per_row_scan_and_marker_extract(n_rows):
    """The plain fused form stores each marker's totals at its pixel; on
    sorted rows that equals the per-row scan followed by the block pack and
    block scatter of the markers (accum._marker_extract, plain kernels) bit
    for bit, on all the rows and on prefixes that end inside them."""
    from ice_halo_sim_tpu_torch.core import accum
    from ice_halo_sim_tpu_torch.kernels import kernel_set

    key, w, _live = _fold_rows(9, n_pixels=800, long_run=5000)
    if n_rows is not None:
        key, w = key[:n_rows], w[:n_rows]
    sk, sw = torch.as_tensor(key.view(np.int32)), torch.as_tensor(w)
    tbl = torch.as_tensor(np.random.default_rng(10).uniform(0.0, 2.0, (K, 3)).astype(np.float32))
    got = seg_scan.fused_scan_extract_plain(sk, sw, tbl, SHIFT, K, 800)
    chans, key2 = seg_scan.fused_scan_call_plain(sk, sw, tbl, SHIFT, K, emit_key2=True)
    key2, chans = accum._pad_cols(key2, chans, accum.BLOCK)
    want = accum._marker_extract(key2, chans, 800, kernel_set("plain"))
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert got.abs().sum() > 0
