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
