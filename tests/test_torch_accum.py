"""Port spectral sort fold against its index_add_ oracle and the JAX key
packer. Keys are bit-equal; images agree to float32 summation order
(rtol 1e-5, atol 1e-6 of the maximum: per-pixel sums of nonnegative terms
in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ice_halo_sim_tpu.core import accum as jaccum
from ice_halo_sim_tpu_torch.core import accum
from ice_halo_sim_tpu_torch.kernels import kernel_set

# Tier-1 runs six workers; keep each one to two torch threads.
torch.set_num_threads(2)

P, K = 96 * 64, 64


def _rows(seed, n=20000):
    g = np.random.default_rng(seed)
    pix = g.integers(-50, P + 50, n).astype(np.int32)
    w = np.where(g.random(n) < 0.8, g.uniform(0.0, 3.0, n), 0.0).astype(np.float32)
    wl = g.integers(0, K, n).astype(np.uint32)
    tbl = g.uniform(0.0, 2.0, (K, 3)).astype(np.float32)
    return pix, w, wl, tbl


def test_pack_spectral_keys_bit_equal():
    pix, w, wl, _ = _rows(1)
    jk, jw = jaccum.pack_spectral_keys(jnp.asarray(pix), jnp.asarray(w), jnp.asarray(wl), P, K)
    tk, tw = accum.pack_spectral_keys(torch.as_tensor(pix), torch.as_tensor(w),
                                      torch.as_tensor(wl.astype(np.int64)), P, K)
    np.testing.assert_array_equal(tk.numpy().view(np.uint32), np.asarray(jk))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    assert accum.spectral_key_bits(P, K) == jaccum.spectral_key_bits(P, K)
    assert accum.spectral_key_bits(512 * 256, 16384) == jaccum.spectral_key_bits(512 * 256, 16384)


def test_sort_keys_orders_u32_and_keeps_pairs():
    g = np.random.default_rng(2)
    k = g.integers(0, 1 << 32, 5000, dtype=np.uint64).astype(np.uint32)
    w = g.random(5000).astype(np.float32)
    sk, sw = accum.sort_keys(torch.as_tensor(k.view(np.int32)), torch.as_tensor(w))
    order = np.argsort(k, kind="stable")
    np.testing.assert_array_equal(sk.numpy().view(np.uint32), k[order])
    assert sorted(zip(k.tolist(), w.tolist())) == sorted(
        zip(sk.numpy().view(np.uint32).tolist(), sw.numpy().tolist()))


@pytest.mark.parametrize("premerged", [False, True])
def test_fold_matches_index_add_oracle(premerged):
    pix, w, wl, tbl = _rows(3)
    ks = kernel_set("plain")
    key, wz = accum.pack_spectral_keys(torch.as_tensor(pix), torch.as_tensor(w),
                                       torch.as_tensor(wl.astype(np.int64)), P, K)
    acc0 = torch.full((P, 3), 0.5)
    tbl_t = torch.as_tensor(tbl)
    if premerged:
        # Rows as the marker-tail scatter leaves them: live rows, (0, 0)
        # filler, then the P marker keys, padded to the 4096-row block.
        live = key != -1
        n = int(live.sum())
        keep = -(-n // 4096) * 4096
        M = -(-(keep + P) // 4096) * 4096
        keys = torch.zeros(M, dtype=torch.int32)
        ws = torch.zeros(M)
        keys[:n], ws[:n] = key[live], wz[live]
        keys[keep:keep + P] = accum.marker_keys(P, K, "cpu")
        out = accum.fold_spectral_keys_premerged(acc0, keys, ws, K, tbl_t, ks)
    else:
        out = accum.fold_spectral_keys(acc0, key, wz, K, tbl_t, ks)
    vals = tbl_t[torch.as_tensor(wl.astype(np.int64))] * torch.as_tensor(w)[:, None]
    ok = torch.as_tensor(w) > 0
    want = accum.scatter_accumulate(acc0, torch.as_tensor(pix)[ok].long(), vals[ok])
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-6 * float(want.max()))


# --------------------------------------------------------------------------
# The general path's folds: compaction prepasses and colour-class lanes
# --------------------------------------------------------------------------

def _packed_rows(seed, n, dead_frac):
    """Packed fold rows as pack_spectral_keys leaves them: (key u32, w, mask)."""
    g = np.random.default_rng(seed)
    live = g.random(n) >= dead_frac
    key = np.where(live, g.integers(0, P * 2 * K, n, dtype=np.uint64) & ~np.uint64(1),
                   0xFFFFFFFF).astype(np.uint32)
    w = np.where(live, g.uniform(0.1, 3.0, n), 0.0).astype(np.float32)
    mask = np.where(live, g.integers(0, 8, n), 0).astype(np.uint32)
    return key, w, mask


@pytest.mark.parametrize("ncols, n", [(1, 3 * 4096), (2, 2 * 4096 + 1000)])
def test_compact_valid_equals_jax(monkeypatch, ncols, n):
    """compact_valid (K6 plain, then K3' plain per column) against the JAX
    function with its Pallas kernels in the interpreter: equal arrays, with
    one and two columns and with rows that need padding to the block."""
    from ice_halo_sim_tpu.core import pallas_ops

    monkeypatch.setattr(pallas_ops, "INTERPRET", True)
    key, w, mask = _packed_rows(31, n, 0.7)
    keep = 2 * 4096
    jcols = [jnp.asarray(w)] + ([jnp.asarray(mask)] if ncols == 2 else [])
    want, jn = jaccum.compact_valid(jnp.asarray(key), jcols, keep)
    tcols = [torch.as_tensor(w)] + ([torch.as_tensor(mask.view(np.int32))] if ncols == 2 else [])
    got, tn = accum.compact_valid(torch.as_tensor(key.view(np.int32)), tcols, keep,
                                  kernel_set("plain"))
    assert int(tn) == int(jn) == int((key != 0xFFFFFFFF).sum()) <= keep
    assert len(got) == len(want) == 1 + ncols
    for a, b in zip(got, want):
        assert a.shape == (keep,)
        np.testing.assert_array_equal(a.numpy().view(np.uint32), np.asarray(b).view(np.uint32))


def test_compact_by_key_prefix_is_the_same_multiset():
    """compact_by_key against the JAX function. The JAX block sort is
    unstable, so rows with equal keys may come in either order: per block the
    prefix holds the same multiset of rows with the keys in the same
    (nondecreasing) order, the tail is zero, and n_valid is equal."""
    g = np.random.default_rng(32)
    n, block, keep = 3 * 4096, 4096, 2 * 4096
    live = g.random(n) < 0.4
    # Few distinct keys, so equal keys are common.
    key = np.where(live, g.integers(0, 50, n) << 23, 0xFFFFFFFF).astype(np.uint32)
    w = np.where(live, g.uniform(0.1, 3.0, n), 0.0).astype(np.float32)
    idx = g.integers(0, K, n).astype(np.int32)
    want, jn = jaccum.compact_by_key(jnp.asarray(key), [jnp.asarray(w), jnp.asarray(idx)], keep)
    got, tn = accum.compact_by_key(torch.as_tensor(key.view(np.int32)),
                                   [torch.as_tensor(w), torch.as_tensor(idx)], keep,
                                   kernel_set("plain"))
    n_valid = int(live.sum())
    assert int(tn) == int(jn) == n_valid <= keep
    gk, gw, gi = (x.numpy() for x in got)
    wk, ww, wi = (np.asarray(x) for x in want)
    gk = gk.view(np.uint32)
    np.testing.assert_array_equal(gk[:n_valid], wk[:n_valid])      # keys in the same order
    off = 0
    for b in range(n // block):
        c = int(live[b * block:(b + 1) * block].sum())
        seg = slice(off, off + c)
        assert (np.diff(gk[seg].astype(np.int64)) >= 0).all()
        assert sorted(zip(gk[seg], gw[seg], gi[seg])) == sorted(zip(wk[seg], ww[seg], wi[seg]))
        off += c
    # Past the live rows: the last block's dead rows, then zeros; no weight.
    assert (gw[n_valid:] == 0).all() and (ww[n_valid:] == 0).all()
    assert (gk[n_valid + (block - c):] == 0).all()


LANES = ((0b001, False), (0b110, True), (0b100, False))
# The JAX XLA scan takes per-pixel sums as differences of float32 running sums
# over 2048-row chunks; its absolute error is an ulp of a chunk's prefix sum
# (accum.py's own bound): 2048 rows of up to 6 (weight 3 x basis 2) < 2^14,
# whose ulp is 2^-9. The port sums in float64.
JAX_SCAN_ATOL = 2.0 ** -9


def test_fold_with_lanes_matches_jax_and_oracle():
    """fold_spectral_keys with colour-class lanes (mask column, any / all
    classes) against the index_add_ oracle (rtol 1e-5 with atol 1e-6 of the
    maximum: float32 sums in another order) and against the JAX fold (rtol
    1e-5 with JAX_SCAN_ATOL)."""
    pix, w, wl, tbl = _rows(4)
    g = np.random.default_rng(5)
    mask = g.integers(0, 8, pix.size).astype(np.uint32)
    ks = kernel_set("plain")
    key, wz = accum.pack_spectral_keys(torch.as_tensor(pix), torch.as_tensor(w),
                                       torch.as_tensor(wl.astype(np.int64)), P, K)
    tmask = torch.where(key != -1, torch.as_tensor(mask.view(np.int32)), 0)
    acc0 = torch.full((P, 3 + len(LANES)), 0.25)
    tbl_t = torch.as_tensor(tbl)
    out = accum.fold_spectral_keys(acc0, key, wz, K, tbl_t, ks, lane_specs=LANES, mask=tmask)

    jkey, jwz = jaccum.pack_spectral_keys(jnp.asarray(pix), jnp.asarray(w), jnp.asarray(wl), P, K)
    jmask = jnp.where(jkey != jnp.uint32(0xFFFFFFFF), jnp.asarray(mask), 0)
    want = jaccum.fold_spectral_keys(
        jnp.full((P, 3 + len(LANES)), 0.25, jnp.float32), jkey, jwz, K,
        lambda i: jnp.asarray(tbl)[i.astype(jnp.int32)], lane_specs=LANES, mask=jmask)
    want = np.asarray(want)
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-5, atol=JAX_SCAN_ATOL)

    basis = tbl_t[torch.as_tensor(wl.astype(np.int64))]
    y = basis[:, 1] * torch.as_tensor(w)
    m = torch.as_tensor(mask.astype(np.int64))
    vals = torch.cat([basis * torch.as_tensor(w)[:, None]]
                     + [torch.where(mem, y, 0.0)[:, None]
                        for mem in accum.lane_members(m, LANES)], dim=1)
    ok = torch.as_tensor(w) > 0
    oracle = accum.scatter_accumulate(acc0, torch.as_tensor(pix)[ok].long(), vals[ok])
    np.testing.assert_allclose(out.numpy(), oracle.numpy(), rtol=1e-5,
                               atol=1e-6 * float(oracle.max()))
    # A prefix of the sorted rows that holds every live row and marker is exact.
    n_live = int((key != -1).sum())
    prefix = -(-(n_live + P) // accum.BLOCK) * accum.BLOCK
    cut = accum.fold_spectral_keys(acc0, key, wz, K, tbl_t, ks, lane_specs=LANES,
                                   mask=tmask, prefix_len=prefix)
    np.testing.assert_array_equal(cut.numpy(), out.numpy())
    with pytest.raises(ValueError):
        accum.fold_spectral_keys(acc0, key, wz, K, tbl_t, ks, lane_specs=LANES,
                                 mask=tmask, prefix_len=prefix - 1)
    with pytest.raises(ValueError):
        accum.fold_spectral_keys(acc0, key, wz, K, tbl_t, ks, lane_specs=LANES)


def test_segmented_totals_matches_jax():
    g = np.random.default_rng(6)
    M, shift = 4 * 2048, 7
    sk = np.sort(g.integers(0, 300 << shift, M).astype(np.uint32))
    chans = [g.uniform(0.0, 2.0, M).astype(np.float32) for _ in range(4)]
    got = accum._segmented_totals(torch.as_tensor(sk.view(np.int32)),
                                  [torch.as_tensor(c) for c in chans], shift, 300)
    want = jaccum._segmented_totals(jnp.asarray(sk), [jnp.asarray(c) for c in chans],
                                    lambda k: k >> shift, 2048)
    last = np.concatenate([(sk[1:] >> shift) != (sk[:-1] >> shift), [True]])
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy()[last], np.asarray(b)[last], rtol=1e-5,
                                   atol=JAX_SCAN_ATOL)


@pytest.mark.parametrize("n, n_ch", [(20000, 3), (5000, 5), (0, 3)])
def test_sort_accumulate_matches_jax_and_scatter(n, n_ch):
    """The dense-value fold of keys that do not pack: against the JAX
    function (rtol 1e-5 with JAX_SCAN_ATOL, the JAX scan's own error) and the
    index_add_ oracle (rtol 1e-5: per-pixel sums in another order; the port
    sums in float64 and rounds once). Five channels go through the marker
    extraction in two groups."""
    g = np.random.default_rng(17)
    pix = g.integers(-50, P + 50, n).astype(np.int32)
    vals = g.uniform(0.0, 3.0, (n, n_ch)).astype(np.float32)
    acc0 = g.uniform(0.0, 1.0, (P, n_ch)).astype(np.float32)
    ks = kernel_set("plain")
    got = accum.sort_accumulate(torch.as_tensor(acc0), torch.as_tensor(pix),
                                torch.as_tensor(vals), ks)
    oracle = accum.scatter_accumulate(torch.as_tensor(acc0), torch.as_tensor(pix),
                                      torch.as_tensor(vals))
    np.testing.assert_allclose(got.numpy(), oracle.numpy(), rtol=1e-5, atol=1e-6)
    if n:
        want = jaccum.sort_accumulate(jnp.asarray(acc0), jnp.asarray(pix), jnp.asarray(vals))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=JAX_SCAN_ATOL)
    for method, ref in (("sort", got), ("scatter", oracle), ("auto", oracle)):
        out = accum.accumulate(torch.as_tensor(acc0), torch.as_tensor(pix),
                               torch.as_tensor(vals), method, ks)
        np.testing.assert_array_equal(out.numpy(), ref.numpy())
    with pytest.raises(ValueError, match="method must be"):
        accum.accumulate(torch.as_tensor(acc0), torch.as_tensor(pix), torch.as_tensor(vals),
                         "bincount", ks)
