"""Several scattering layers: the ray-base stride, the continuation between
layers, and the port's engine against the JAX engine on two and three layers.

Why a multi-layer image is not held ray for ray. The continuation sorts each
4096-row block by a key of (inverted weight bucket) << 23 | 23 hash bits; the
JAX block sort is unstable, so two live rows of a block with equal keys may
take either of two lanes of the next layer, and the lane decides the ray's
orientation draw there. The port breaks the tie by row index, so that the CPU
and the card agree with each other. Equal keys need the same bucket and equal
23-bit hashes: with n live rows in a block that is about n^2 / 2^24 pairs,
0.04 for the 800 live rows of a block at batch 4096, a few tenths per run
here. So the first layer is held exactly (rows, live count of the
continuation), and the later layers by totals with an allowance of TIE_RAYS
swapped rays per run.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ice_halo_sim_tpu.config.loader import load_project as jax_load_project
from ice_halo_sim_tpu.core import rng as jrng
from ice_halo_sim_tpu.engine.simulator import Engine as JEngine
from ice_halo_sim_tpu_torch import scenes
from ice_halo_sim_tpu_torch.config.loader import load_project
from ice_halo_sim_tpu_torch.core import rng
from ice_halo_sim_tpu_torch.engine import simulator
from ice_halo_sim_tpu_torch.engine.simulator import Engine

# Tier-1 runs six workers; keep each one to two torch threads.
torch.set_num_threads(2)

B, H = 4096, 7
SUM_RTOL = 1e-5
TIE_RAYS = 16           # up to 8 swapped pairs per run, far above the expectation


@pytest.fixture(autouse=True)
def _general_env(monkeypatch):
    monkeypatch.setenv("IHT_PALLAS_TRACE", "0")
    monkeypatch.setenv("IHT_FOLD", "sort")
    monkeypatch.setenv("IHT_STEPS_PER_DISPATCH", "1")


def _doc(n_layers):
    doc = copy.deepcopy(scenes.MS_CFG)
    if n_layers == 3:
        layers = doc["scene"]["scattering"]
        doc["scene"]["scattering"] = [layers[0], copy.deepcopy(layers[0]), layers[1]]
    return doc


@pytest.mark.parametrize("n_layers", [2, 3])
def test_ray_base_stride_matches_jax(monkeypatch, n_layers):
    """The ray base of batch c is c * batch_size * (layers + 1), and layer li
    of that batch draws from the ray indices base + li * batch_size + lane:
    equal ray_idx and epoch_seed in both packages, below and past 2^32."""
    doc = _doc(n_layers)
    j = JEngine(jax_load_project(doc), seed=9, batch_size=B, accum_method="sort",
                geom_clock=128)
    t = Engine(load_project(doc), seed=9, batch_size=B, device="cpu", geom_clock=128)
    assert len(t.layers) == len(j.layers) == n_layers
    assert [l.cont_cap for l in t.layers] == [l.cont_cap for l in j.layers]
    stride = j.batch_size * (len(j.layers) + 1)
    seen = []

    def batch(n_active=None, host_choice=False):
        # The words the engine derives on the device from its counter.
        seen.append(tuple(int(x) for x in t._ray_base_words(t._dev.counter)))
        t._dev.counter.add_(1)

    monkeypatch.setattr(t, "_batch", batch)
    monkeypatch.setattr(t, "_maybe_calibrate", lambda *a: None)
    for c0 in (0, 5, (1 << 32) // stride - 1):
        t.batch_counter = c0
        seen.clear()
        t.run(n_batches=3)
        for k, (lo, hi) in enumerate(seen):
            base = (c0 + k) * stride
            assert t.ray_base(c0 + k) == base
            jlo, jhi = jrng.mul_u32_split(jnp.uint32(c0 + k), stride)
            assert (lo, hi) == (int(jlo), int(jhi)) == (base & 0xFFFFFFFF, base >> 32)
            for li in range(n_layers):
                cap = t.layers[li].cont_cap
                tidx = (lo + B * li + torch.arange(cap, dtype=torch.int64)) & 0xFFFFFFFF
                jidx = jlo + jnp.uint32(B * li) + jnp.arange(cap, dtype=jnp.uint32)
                np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
                np.testing.assert_array_equal(
                    rng.epoch_seed(t.seed, lo, hi, tidx).numpy(),
                    np.asarray(jrng.epoch_seed(jnp.uint32(j.seed), jlo, jhi, jidx)))
    assert any(hi > 0 for _, hi in seen)


def test_continuation_key_is_an_integer_stage():
    """The weight bucket clip(floor(log2(max(w, 1e-30))) + 130, 2, 255) and
    the row hash against the JAX expressions: exact on random weights, at the
    powers of two and just above them. The port reads the bucket from the
    float's exponent field, which is floor(log2 w) exactly; the JAX
    expression rounds log2 to float32 first, which for the last float32
    below a power of two gives the integer above (a bucket one higher). Such
    a weight (a few in 2^23) sorts one bucket earlier in its block, which the
    engine tests hold like a tie. Powers of two go up to 2^12 here: a ray's
    weight never passes the largest initial weight (about 1.2e2 for D65), and
    XLA's log2 on the CPU falls below the integer at some larger powers of
    two (2^13, 2^15, ...), where it gives the bucket below."""
    g = np.random.default_rng(41)
    p2 = (2.0 ** np.arange(-126, 13, dtype=np.float64)).astype(np.float32)

    def jax_bucket(w):
        return np.asarray(jnp.clip(
            jnp.floor(jnp.log2(jnp.maximum(jnp.asarray(w), 1e-30))).astype(jnp.int32) + 130,
            2, 255))

    w = np.concatenate([
        g.uniform(0.0, 200.0, 50_000).astype(np.float32),
        np.exp(g.uniform(-90.0, 20.0, 50_000)).astype(np.float32),
        p2, np.nextafter(p2, np.float32(np.inf)),
        np.asarray([0.0, 1e-30, 1e-38, 1e-45], np.float32)])
    below = (np.abs(w) > 0) & (np.nextafter(w, np.float32(np.inf)).view(np.int32) & 0x7FFFFF == 0)
    w = w[~below]                                   # (none, but for a rare draw)
    np.testing.assert_array_equal(simulator.weight_bucket(torch.as_tensor(w)).numpy(),
                                  jax_bucket(w))
    w = np.nextafter(p2, np.float32(0))
    got, want = simulator.weight_bucket(torch.as_tensor(w)).numpy(), jax_bucket(w)
    assert ((want - got) >= 0).all() and ((want - got) <= 1).all()
    exact = np.clip(np.floor(np.log2(w.astype(np.float64))).astype(np.int64) + 130, 2, 255)
    np.testing.assert_array_equal(got[w >= 1e-30], exact[w >= 1e-30])
    for layer_seed, counter in ((0x1234 ^ 0xA5A5, 0), (77 ^ (0xA5A5 * 2), (1 << 31) + 9)):
        n = 28672
        want = jrng.pcg_hash(jnp.arange(n, dtype=jnp.uint32)
                             ^ (jnp.uint32(layer_seed) ^ jrng.NONCE_SHUFFLE)
                             ^ jrng.pcg_hash(jnp.uint32(counter)))
        got = simulator.shuffle_hash(n, layer_seed, counter, "cpu")
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_first_layer_rows_and_continuation_count_exact():
    """One batch of the two-layer MS_CFG through both packages' batch trace:
    the first layer's contribution rows (pixel of every row; weights to rtol
    1e-5 with an absolute floor of 2e-5 of the largest initial weight, for
    rows close to the TIR limit, where the reflectance goes through the
    square root of a difference near 0) are equal, and so is the live count of the
    continuation. The JAX engine exposes the continuation by its count only;
    that the carried weight is equal follows from the equal rows: the same
    exits pass the same gate draws. The later layer's live rows, weight and
    segments are held within the tie allowance."""
    doc = _doc(2)
    j = JEngine(jax_load_project(doc), seed=7, batch_size=B, accum_method="sort",
                geom_clock=128)
    t = Engine(load_project(doc), seed=7, batch_size=B, device="cpu", geom_clock=128)
    c = 3
    base = t.ray_base(c)
    jout = j._trace_batch_impl(jnp.uint32(base), jnp.uint32(c), None, jnp.uint32(0))
    syncs = t.host_syncs
    tout = t._trace_batch_impl(torch.tensor(c))
    assert t.host_syncs == syncs                        # no read at a layer boundary
    assert bool(tout[6]) is False                       # the continuation fits its lanes
    assert [int(x) for x in tout[4]] == [int(x) for x in np.asarray(jout[4])]
    assert int(tout[4][0]) > 1000
    w_ray = float(t._w0_tbl.max())
    assert abs(int(tout[3]) - int(jout[3])) <= TIE_RAYS * H
    for r, pp in enumerate(t.proj_plans):
        n1 = B * H * (2 if pp.max_abs_dz > 0 else 1)    # rows of the first layer
        jp, jw = np.asarray(jout[0][r][0]), np.asarray(jout[0][r][1])
        tp, tw = tout[0][r][0].numpy(), tout[0][r][1].numpy()
        assert tp.shape == jp.shape
        np.testing.assert_array_equal(tp[:n1], jp[:n1])
        np.testing.assert_allclose(tw[:n1], jw[:n1], rtol=1e-5, atol=2e-5 * w_ray)
        assert (tw[:n1] > 0).sum() > B
        assert abs(int((tw[n1:] > 0).sum()) - int((jw[n1:] > 0).sum())) <= TIE_RAYS * H
        assert abs(float(tw[n1:].sum()) - float(jw[n1:].sum())) <= TIE_RAYS * w_ray
    np.testing.assert_allclose(tout[1].numpy(), np.asarray(jout[1]), rtol=SUM_RTOL,
                               atol=TIE_RAYS * w_ray)
    # Calibrating: the slot-mass histogram of every layer.
    np.testing.assert_allclose(tout[5].numpy(), np.asarray(jout[5]), rtol=1e-4,
                               atol=TIE_RAYS * w_ray)


def _box(img, k=8):
    h, w, c = img.shape
    return img.reshape(h // k, k, w // k, k, c).sum(axis=(1, 3))


@pytest.mark.parametrize("n_layers, geom_clock", [(2, 128), (3, 32)])
def test_layers_match_jax_engine(n_layers, geom_clock):
    """One batch, calibration, two more batches in both engines. Equal
    calibration (slot cap, continuation capacities, keep); rays exact;
    segments, landed and dropped weight within TIE_RAYS swapped rays (a ray
    has at most max_hits segments and at most the largest initial weight);
    the images after an 8 x 8 box sum to rtol 1e-3 with the same allowance
    (the box keeps a ray that lands a pixel over inside one cell, mostly).
    Capacities come in steps of 256 geom-clock blocks, so at this batch the
    calibration rebuilds the plan without changing them."""
    doc = _doc(n_layers)
    j = JEngine(jax_load_project(doc), seed=7, batch_size=B, accum_method="sort",
                geom_clock=geom_clock)
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("IHT_STEPS_PER_DISPATCH")     # the port at its default
        t = Engine(load_project(doc), seed=7, batch_size=B, device="cpu",
                   geom_clock=geom_clock)
    before = [l.cont_cap for l in t.layers]
    assert before == [l.cont_cap for l in j.layers]
    for eng in (j, t):
        eng.run(n_batches=1)
        eng.run(n_batches=2)
    assert t._slot_cap == j._slot_cap
    assert [l.cont_cap for l in t.layers] == [l.cont_cap for l in j.layers]
    # Capacities come in steps of 256 geom-clock blocks: at clock 32 the
    # measured demand trims the heuristic, at 128 one step already holds it.
    assert all(a <= b for a, b in zip([l.cont_cap for l in t.layers], before))
    assert t._rows_per_render == j._rows_per_render
    # keep: the JAX engine snaps the dual render's keep to a sort size tuned
    # to another accelerator (its rows reach 2^18 - P here), which the port
    # does not carry; the zenith render's, which it cannot snap, is equal.
    assert t._compact_keep is not None and t._compact_keep[1] == j._compact_keep[1]
    # One read per dispatch (the first overflowing batch: the continuation
    # can overflow from the first dispatch on), none per batch or layer
    # boundary, and one for the calibration.
    assert t.host_syncs == 2 + 1 and t.overflow_replays == 0
    js, ts = j.drain_stats(), t.drain_stats()
    w_ray = float(t._w0_tbl.max())
    assert ts.rays_traced == js.rays_traced
    assert ts.stochastic_crystal_samples == js.stochastic_crystal_samples
    assert ts.stochastic_orientation_samples == js.stochastic_orientation_samples
    assert abs(ts.ray_segments - js.ray_segments) <= TIE_RAYS * H
    assert abs(ts.landed_weight - js.landed_weight) <= \
        SUM_RTOL * js.landed_weight + TIE_RAYS * w_ray
    assert abs(ts.dropped_cont_weight - js.dropped_cont_weight) <= \
        1e-6 * js.landed_weight + TIE_RAYS * w_ray
    cell = TIE_RAYS * w_ray * float(t.basis_tbl.max())
    for r in range(2):
        a, b = _box(t.raw_xyz(r)), _box(j.raw_xyz(r))
        np.testing.assert_allclose(a.sum(), b.sum(), rtol=1e-4)
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=cell)


def test_overflowing_continuation_takes_the_global_sort():
    """When the live rows exceed the next layer's lanes the heaviest rows are
    kept (one global sort by the key) and the rest is accounted as dropped."""
    doc = _doc(2)
    doc["scene"]["scattering"][0]["prob"] = 0.9
    t = Engine(load_project(doc), seed=7, batch_size=B, device="cpu", geom_clock=128)
    j = JEngine(jax_load_project(doc), seed=7, batch_size=B, accum_method="sort",
                geom_clock=128)
    for caps in ([None, 1024], [None, 40_000], [None, None]):
        t._build_plan(cont_caps=caps)
        j._build_plan(cont_caps=caps)
        assert [l.cont_cap for l in t.layers] == [l.cont_cap for l in j.layers]
    g = np.random.default_rng(3)
    n = B * H
    w = torch.as_tensor(np.where(g.random(n) < 0.5, 0.0,
                                 2.0 ** g.integers(-6, 7, n)).astype(np.float32))
    cols = [w, torch.arange(n, dtype=torch.int32)]
    small = 8192
    picked, n_live = t._continuation(w, cols, small, 0x55, 4)
    assert n_live == int((w > 0).sum()) > small
    kept = picked[0].numpy()
    assert kept.shape == (small,) and (kept > 0).all()
    # Energy-least-first truncation: no dropped row is heavier than a kept one.
    dropped = np.delete(w.numpy(), picked[1].numpy())
    assert dropped.max() <= kept.min()
    np.testing.assert_array_equal(w.numpy()[picked[1].numpy()], kept)
    # The fitting case pads to the capacity with dead lanes.
    fit, n_fit = t._continuation(w, cols, 2 * n, 0x55, 4)
    assert n_fit == n_live and fit[0].shape == (2 * n,)
    assert int((fit[0] > 0).sum()) == n_live
    assert sorted(fit[1][fit[0] > 0].tolist()) == torch.nonzero(w > 0)[:, 0].tolist()
