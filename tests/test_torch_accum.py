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
