"""Port RNG streams against the JAX package's core/rng: integer stages are
bit-equal; float stages built on transcendentals (gaussian, zigzag,
laplacian) agree to a few float32 ulps, because torch and XLA round
log/cos/sin differently in the last bit on some inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ice_halo_sim_tpu.config.schema import DistType
from ice_halo_sim_tpu.core import rng as jrng
from ice_halo_sim_tpu_torch.core import rng as trng

# Tier-1 runs six workers; keep each one to two torch threads.
torch.set_num_threads(2)

N = 1 << 20


@pytest.fixture(scope="module")
def pairs():
    g = np.random.default_rng(11)
    idx = g.integers(0, 1 << 32, size=N, dtype=np.uint64).astype(np.uint32)
    idx[:4] = [0, 1, 0xFFFFFFFF, 0x80000000]
    seed = g.integers(0, 1 << 32, size=N, dtype=np.uint64).astype(np.uint32)
    return idx, seed


def _t(a):
    return torch.as_tensor(a.astype(np.int64))


def test_pcg_hash_bit_equal(pairs):
    idx, _ = pairs
    want = np.asarray(jax.jit(jrng.pcg_hash)(jnp.asarray(idx)))
    got = trng.pcg_hash(_t(idx)).numpy().astype(np.uint32)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("slot", [0, 10, 106])
def test_uniform_bit_equal(pairs, slot):
    idx, seed = pairs
    want = np.asarray(jax.jit(lambda s, i: jrng.uniform(s, i, slot))(
        jnp.asarray(seed), jnp.asarray(idx)))
    got = trng.uniform(_t(seed), _t(idx), slot).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("base_lo, base_hi", [(0, 0), (0xFFFFF000, 0), (0xFFFFF000, 3),
                                              (12345, 0xFFFFFFFF)])
def test_epoch_seed_bit_equal_with_wrap(base_lo, base_hi):
    off = np.arange(1 << 14, dtype=np.uint64)
    idx = ((base_lo + off) & 0xFFFFFFFF).astype(np.uint32)
    seed = 0xDEADBEEF
    want = np.asarray(jrng.epoch_seed(jnp.uint32(seed), jnp.uint32(base_lo),
                                      jnp.uint32(base_hi), jnp.asarray(idx)))
    got = trng.epoch_seed(seed, base_lo, base_hi, _t(idx)).numpy().astype(np.uint32)
    np.testing.assert_array_equal(got, want)
    if base_lo == 0xFFFFF000:
        assert len(np.unique(got)) == 2  # the u32 wrap moved rays into hi + 1
    wh = np.asarray(jrng.hi_epoch_seed(jnp.uint32(seed), jnp.uint32(base_hi)))
    assert int(trng.hi_epoch_seed(seed, base_hi)) == int(wh)


def test_mul_u32_split_bit_equal(pairs):
    idx, _ = pairs
    for s in (1, 229376 * 2, 0xFFFFFFFF, 1000003):
        lo, hi = jrng.mul_u32_split(jnp.asarray(idx[:4096]), s)
        tlo, thi = trng.mul_u32_split(_t(idx[:4096]), s)
        np.testing.assert_array_equal(tlo.numpy().astype(np.uint32), np.asarray(lo))
        np.testing.assert_array_equal(thi.numpy().astype(np.uint32), np.asarray(hi))
        full = idx[:4096].astype(np.uint64) * np.uint64(s)
        np.testing.assert_array_equal(tlo.numpy(), (full & 0xFFFFFFFF).astype(np.int64))


def test_u01_value(pairs):
    idx, _ = pairs
    h = trng.pcg_hash(_t(idx))
    want = np.asarray(jrng.u01(jnp.asarray(h.numpy().astype(np.uint32))))
    np.testing.assert_array_equal(trng.u01(h).numpy(), want)


@pytest.mark.parametrize(
    "dtype, center, spread",
    [(DistType.NO_RANDOM, 0.3, 0.0), (DistType.UNIFORM, 0.0, 6.2831855),
     (DistType.GAUSS, 0.5, 0.25), (DistType.GAUSS_LEGACY, -0.1, 0.5),
     (DistType.ZIGZAG, 0.2, 1.5), (DistType.LAPLACIAN, 0.0, 0.3)],
    ids=lambda v: str(v),
)
def test_sample_dist(pairs, dtype, center, spread):
    idx, seed = pairs
    n = 1 << 16
    c32, s32 = float(np.float32(center)), float(np.float32(spread))
    want = np.asarray(jrng.sample_dist(jnp.asarray(seed[:n]), jnp.asarray(idx[:n]), 8,
                                       int(dtype), c32, s32))
    got = trng.sample_dist(_t(seed[:n]), _t(idx[:n]), 8, int(dtype), c32, s32).numpy()
    if dtype in (DistType.NO_RANDOM, DistType.UNIFORM):
        np.testing.assert_array_equal(got, want)
    else:
        # log / cos / sin: a few ulps apart between torch and XLA.
        np.testing.assert_allclose(got, want, rtol=2e-6, atol=4e-7 * max(1.0, abs(s32)))


@pytest.mark.parametrize(
    "dtype", [DistType.UNIFORM, DistType.GAUSS, DistType.GAUSS_LEGACY, DistType.ZIGZAG,
              DistType.LAPLACIAN], ids=lambda v: v.name)
def test_sample_dist_at_pool_shape_indices(dtype):
    """The K-shape pool sampler's inputs: shape index = batch_counter * K
    as 64 bits (mul_u32_split), the low word wrapping inside the batch's K
    indices, the high word mixed into the seed (epoch_seed). The port's
    engine forms the product with python ints; here both forms are held
    against the JAX functions."""
    k_total, counter = 1792, (1 << 32) // 1792          # the wrap falls inside this batch
    lo, hi = jrng.mul_u32_split(jnp.uint32(counter), k_total)
    tlo, thi = trng.mul_u32_split(torch.tensor(counter), k_total)
    prod = counter * k_total
    assert (int(lo), int(hi)) == (int(tlo), int(thi)) == (prod & 0xFFFFFFFF, prod >> 32)
    k_idx = ((prod & 0xFFFFFFFF) + np.arange(k_total, dtype=np.uint64)) & 0xFFFFFFFF
    assert k_idx.min() == 0                             # wrapped
    seed0 = 7 ^ trng.NONCE_GEOM_SHAPE
    jseed = jrng.epoch_seed(jnp.uint32(seed0), lo, hi, jnp.asarray(k_idx.astype(np.uint32)))
    tseed = trng.epoch_seed(seed0, int(tlo), int(thi), _t(k_idx))
    np.testing.assert_array_equal(tseed.numpy().astype(np.uint32), np.asarray(jseed))
    assert len(np.unique(np.asarray(jseed))) == 2       # two hi epochs in one pool
    want = np.asarray(jrng.sample_dist(jseed, jnp.asarray(k_idx.astype(np.uint32)), 2,
                                       int(dtype), 0.9, 0.1))
    got = trng.sample_dist(tseed, _t(k_idx), 2, int(dtype), 0.9, 0.1).numpy()
    if dtype == DistType.UNIFORM:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=2e-6, atol=4e-7)
