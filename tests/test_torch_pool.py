"""The K-shape pool sampler of the blocked-pool trace mode against the JAX
package, on shape scalars made with numpy from a seed: the batched prism
and pyramid geometry, the entry fan triangles and the engine's per-batch
pool (``Engine._sample_layer_pool``).

Tolerances: plane and triangle tables rtol 1e-5 / atol 1e-6 (closed-form
float32 on both sides; XLA and torch round a few products and the corner
sort's atan2 differently in the last bit); ``face_present``, vertex counts,
``face_number`` and ``tri_face`` exact. The vertex slots of an ABSENT face
(a sliver at the vertex-dedup resolution, which the width gate rejects)
hold whichever of its near-duplicate corners the angular sort met first,
so they are held to the dedup tolerance (4 x 5e-5 of the crystal's scale)
only; no live triangle reads them. The pool's shape scalars go through
log and cos (Gaussian heights), whose last bit differs between XLA and
torch, so the engine's pool is held to the same float tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ice_halo_sim_tpu.config.loader import load_project as jax_load_project
from ice_halo_sim_tpu.core import geometry as jgeom
from ice_halo_sim_tpu.core import pyramid as jpyr
from ice_halo_sim_tpu.core import sampling as jsamp
from ice_halo_sim_tpu.core import trace as jtrace
from ice_halo_sim_tpu.engine.simulator import Engine as JEngine
from ice_halo_sim_tpu_torch.config.loader import load_project
from ice_halo_sim_tpu_torch.core import geometry, pyramid, sampling, trace
from ice_halo_sim_tpu_torch.engine.simulator import Engine, largest_remainder_partition

# The suite runs under several xdist workers; keep each to two torch threads.
torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-6
DEDUP_ATOL = 4 * 5e-5 * 2.0
K = 48


def _assert_same(got, want, absent=None):
    """Field by field; `absent` [K, NF] marks the faces whose vertex slots
    (face_vtx, or the T = NF * 4 triangle rows v0/e1/e2) get DEDUP_ATOL."""
    for f in got._fields:
        a, b = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert a.shape == b.shape, f
        if a.dtype == np.bool_ or np.issubdtype(a.dtype, np.integer):
            np.testing.assert_array_equal(a, b, err_msg=f)
            continue
        if absent is not None and f in ("face_vtx", "v0", "e1", "e2", "tri_v0",
                                        "tri_e1", "tri_e2"):
            m = absent if f == "face_vtx" else np.repeat(absent, 4, axis=1)
            np.testing.assert_allclose(a[m], b[m], rtol=RTOL, atol=DEDUP_ATOL, err_msg=f)
            a, b = a[~m], b[~m]
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=f)


@pytest.fixture(scope="module")
def scalars():
    g = np.random.default_rng(77)
    d = np.ones((K, 6), np.float32)
    d[K // 2:] += g.normal(0.0, 0.15, (K - K // 2, 6)).astype(np.float32)
    h1 = np.abs(g.normal(0.3, 0.05, K)).astype(np.float32)
    h1[:4] = [0.0, 1.0, 0.999, 1e-4]          # no cap, full apex, near apex, sliver
    h3 = np.full(K, 0.3, np.float32)
    h3[4:8] = [0.0, 1.0, 1.0, 0.5]
    return {
        "h": np.abs(g.normal(1.1, 0.15, K)).astype(np.float32),
        "h1": h1, "h2": np.abs(g.normal(0.9, 0.1, K)).astype(np.float32), "h3": h3,
        "d": d,
    }


def test_prism_geom_batch_and_entry_tris(scalars):
    h, d = scalars["h"].copy(), scalars["d"]
    h[0] = 0.0                                  # a degenerate plate: no face present
    tg = geometry.prism_geom_batch(torch.as_tensor(h), torch.as_tensor(d))
    jg = jgeom.prism_geom_batch(jnp.asarray(h), jnp.asarray(d))
    _assert_same(tg, jg)
    assert not tg.face_present[0].any() and tg.face_present[1:].any()
    _assert_same(sampling.build_entry_tris(tg), jax.vmap(jsamp.build_entry_tris)(jg))
    one = geometry.prism_geom(float(h[5]), d[5])
    np.testing.assert_array_equal(one.face_vtx.numpy(), tg.face_vtx[5].numpy())


@pytest.mark.parametrize("alpha", [(28.0, 28.0), (0.0, 45.0)],
                         ids=["both-cones", "lower-only"])
def test_pyramid_geom_batch_and_entry_tris(scalars, alpha):
    args = [scalars[k] for k in ("h1", "h2", "h3")]
    tg = pyramid.pyramid_geom_batch(*[torch.as_tensor(a) for a in args], *alpha,
                                    torch.as_tensor(scalars["d"]))
    jg = jpyr.pyramid_geom_batch(*[jnp.asarray(a) for a in args], *alpha,
                                 jnp.asarray(scalars["d"]))
    absent = ~np.asarray(jg.face_present)
    _assert_same(tg, jg, absent)
    assert tuple(tg.plane_n.shape) == (K, geometry.PYRAMID_FACES, 3)
    np.testing.assert_array_equal(tg.face_number[0].numpy(), geometry.PYRAMID_FACE_NUMBER)
    tt = sampling.build_entry_tris(tg)
    _assert_same(tt, jax.vmap(jsamp.build_entry_tris)(jg), absent)
    assert tuple(tt.cross_half.shape) == (K, 80, 3)
    # Padding a prism pool to the pyramid layout keeps the absent slots dead.
    pg = geometry.pad_geom_faces(
        geometry.prism_geom_batch(torch.as_tensor(scalars["h"]), torch.as_tensor(scalars["d"])),
        geometry.PYRAMID_FACES)
    jpg = jgeom.pad_geom_faces(
        jgeom.prism_geom_batch(jnp.asarray(scalars["h"]), jnp.asarray(scalars["d"])),
        geometry.PYRAMID_FACES)
    _assert_same(pg, jpg)
    _assert_same(trace.make_geom_pool(pg, sampling.build_entry_tris(pg)),
                 jtrace.make_geom_pool(jpg, jax.vmap(jsamp.build_entry_tris)(jpg)))


def _doc(kind, sync=False):
    if kind == "prism":
        shape = {"height": {"type": "gauss", "mean": 1.1, "std": 0.15},
                 "face_distance": [{"type": "uniform", "mean": 1.0, "std": 0.2}, 1.0,
                                   {"type": "laplacian", "mean": 1.0, "std": 0.05},
                                   1.0, {"type": "zigzag", "mean": 1.0, "std": 0.1}, 1.0]}
    else:
        shape = {"upper_h": {"type": "gauss", "mean": 0.3, "std": 0.05},
                 "prism_h": {"type": "gauss", "mean": 0.9, "std": 0.1}, "lower_h": 0.3}
    return {
        "crystal": [{"id": 1, "type": kind, "shape": shape,
                     "axis": {"zenith": {"type": "gauss", "mean": 90, "std": 1.2},
                              "azimuth": {"type": "uniform", "mean": 0, "std": 360}}}],
        "filter": [],
        "scene": {"light_source": {"type": "sun", "altitude": 25, "spectrum": "D65"},
                  "ray_num": 10000, "max_hits": 5,
                  "scattering": [{"prob": 0.0, "entries": [{"crystal": 1, "proportion": 1}]}]},
        "render": [{"id": 1, "lens": {"type": "fisheye_equal_area", "fov": 165},
                    "resolution": [128, 64], "view": {"elevation": 90}, "visible": "full"}],
    }


# 2^27 + 5 batches of 32 shapes: the 64-bit shape index has passed 2^32, so
# the high word reaches the seed (and the low word restarts at 160).
@pytest.mark.parametrize("kind, batch_counter",
                         [("prism", 0), ("prism", (1 << 27) + 5), ("pyramid", 3)],
                         ids=["prism-0", "prism-past-2^32", "pyramid-3"])
def test_sample_layer_pool_matches_jax(monkeypatch, kind, batch_counter):
    monkeypatch.setenv("IHT_PALLAS_TRACE", "0")
    doc = _doc(kind)
    j = JEngine(jax_load_project(doc), seed=11, batch_size=4096, accum_method="sort",
                geom_clock=128)
    t = Engine(load_project(doc), seed=11, batch_size=4096, device="cpu", geom_clock=128)
    assert t.layer0.k_per_setting == j.layers[0].k_per_setting == [32]
    assert t.layer0.shape_param_arrays == j.layers[0].shape_param_arrays
    want = j._sample_layer_pool(0, j.layers[0], jnp.uint32(batch_counter))
    got = t._sample_layer_pool(batch_counter)
    _assert_same(got, want)
    assert got.face_present.any(dim=1).all()
    if batch_counter:
        first = t._sample_layer_pool(0)
        assert not torch.equal(first.plane_d, got.plane_d)
    ptbl, ttbl = t._pool_tables(batch_counter)
    nf = 8 if kind == "prism" else 20
    assert tuple(ptbl.shape) == (32, nf * 5) and tuple(ttbl.shape) == (32, nf * 4 * 13)
    np.testing.assert_array_equal(ptbl.view(32, nf, 5)[..., 4].numpy(),
                                  got.face_present.numpy().astype(np.float32))
    np.testing.assert_array_equal(ttbl.view(32, nf * 4, 13)[..., 12].numpy(),
                                  got.tri_face.numpy().astype(np.float32))


def test_sync_groups_and_partition():
    """A synced face distance consumes its group leader's RNG slot."""
    doc = _doc("prism")
    doc["crystal"][0]["shape"]["face_distance"] = [
        {"type": "uniform", "mean": 1.0, "std": 0.2}, 1.0,
        {"type": "uniform", "mean": 1.0, "std": 0.2}, 1.0, 1.0, 1.0]
    doc["crystal"][0]["shape"]["sync_group"] = {"face_distance": [1, 0, 1, 0, 0, 0]}
    j = JEngine(jax_load_project(doc), seed=3, batch_size=4096, accum_method="sort",
                geom_clock=128)
    t = Engine(load_project(doc), seed=3, batch_size=4096, device="cpu")
    assert t.layer0.shape_param_arrays == j.layers[0].shape_param_arrays
    sp = t.layer0.shape_param_arrays[0]
    assert sp["d_slots"][0] == sp["d_slots"][2]
    pool = t._sample_layer_pool(1)
    np.testing.assert_array_equal(pool.plane_d[:, 2].numpy(), pool.plane_d[:, 4].numpy())
    assert largest_remainder_partition(32, [1, 1, 1]) == [11, 11, 10]
    assert largest_remainder_partition(0, [1.0]) == [0]
