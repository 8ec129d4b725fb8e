"""Twins of tests/test_trace.py on the port's AoS trace (core/trace.py):
energy conservation and the physical halo anchors, closed-form oracles of
the geometry and the optics alone.

The 22-degree anchor: alternating side faces of a hexagonal prism form a
60-degree prism, whose minimum deviation is 2 asin(n sin 30) - 60 degrees;
side-to-basal paths form a 90-degree prism (the 46-degree halo).
"""

import numpy as np
import torch

from ice_halo_sim_tpu_torch.core import geometry as geo
from ice_halo_sim_tpu_torch.core import sampling, trace

# Tier-1 runs six workers; keep each one to two torch threads.
torch.set_num_threads(2)


def make_pool(h=1.0, dist=None):
    d = torch.as_tensor(dist if dist is not None else [1.0] * 6, dtype=torch.float32)
    g = geo.prism_geom_batch(torch.tensor([h], dtype=torch.float32), d[None])
    return trace.make_geom_pool(g, sampling.build_entry_tris(g))


def run_trace(n, d_world, rot, max_hits=8, seed=7, n_ior=1.31, h=1.0):
    pool = make_pool(h=h)
    idx = torch.arange(n, dtype=torch.int64)
    return trace.trace_layer(seed, idx, d_world, torch.ones(n), rot,
                             torch.zeros(n, dtype=torch.int32), pool,
                             torch.full((n,), n_ior), max_hits)


def random_rotations(n, seed=3):
    rs = np.random.default_rng(seed)
    lon = torch.as_tensor(rs.uniform(0, 2 * np.pi, n), dtype=torch.float32)
    lat = torch.as_tensor(np.arcsin(rs.uniform(-1, 1, n)), dtype=torch.float32)
    roll = torch.as_tensor(rs.uniform(0, 2 * np.pi, n), dtype=torch.float32)
    return sampling.build_rotation(lon, lat, roll)


def down(n, v=(0.0, 0.0, -1.0)):
    return torch.tensor([v], dtype=torch.float32).repeat(n, 1)


def test_energy_conservation():
    """Emitted weight approaches the input weight as max_hits grows."""
    n = 4000
    rot = random_rotations(n)
    exits = run_trace(n, down(n), rot, max_hits=24)
    total = trace.total_exit_weight(exits).numpy()
    assert exits.entry_ok.all()
    assert (total <= 1.0 + 1e-5).all()
    assert total.mean() > 0.98
    total_short = trace.total_exit_weight(run_trace(n, down(n), rot, max_hits=3)).numpy()
    assert (total_short <= total + 1e-5).all()


def test_normal_incidence_plate():
    """Plate, sun overhead: entry through the top basal face (fn 1), out
    through the bottom (fn 2); the external reflection weighs Fresnel's
    normal-incidence R."""
    n = 64
    rot = torch.eye(3)[None].repeat(n, 1, 1)
    n_ior = 1.31
    exits = run_trace(n, down(n), rot, max_hits=8, n_ior=n_ior)
    path, w, d_out = exits.path.numpy(), exits.w.numpy(), exits.d_world.numpy()
    r0 = ((n_ior - 1) / (n_ior + 1)) ** 2
    np.testing.assert_allclose(w[:, 0], r0, rtol=1e-5)
    assert np.allclose(d_out[:, 0], np.array([0, 0, 1.0]), atol=1e-5)
    assert (path[:, 0] == 1).all()
    assert (path[:, 1] == 2).all()
    np.testing.assert_allclose(w[:, 1], (1 - r0) ** 2, rtol=1e-4)
    assert np.allclose(d_out[:, 1], np.array([0, 0, -1.0]), atol=1e-5)
    np.testing.assert_allclose(w[:, 2], (1 - r0) ** 2 * r0, rtol=1e-3)
    assert np.allclose(d_out[:, 2], np.array([0, 0, 1.0]), atol=1e-5)
    assert (path[:, 2] == 1).all()


def test_22_degree_minimum_deviation():
    n = 200000
    n_ior = 1.31
    d_in = np.array([0.0, 0.0, -1.0], np.float32)
    exits = run_trace(n, down(n), random_rotations(n, seed=11), max_hits=4, n_ior=n_ior)
    w, plen = exits.w.numpy(), exits.path_len.numpy()
    path, d_out = exits.path.numpy(), exits.d_world.numpy()
    f_in, f_out = path[:, 0], path[:, 1]
    side = (f_in >= 3) & (f_out >= 3)
    dpri = (f_in - f_out) % 6
    prism60 = side & ((dpri == 2) | (dpri == 4)) & (plen[:, 1] == 2) & (w[:, 1] > 1e-4)
    assert prism60.sum() > 1000
    dev = np.degrees(np.arccos(np.clip(d_out[prism60, 1, :] @ d_in, -1, 1)))
    delta_min = np.degrees(2 * np.arcsin(n_ior * 0.5)) - 60.0
    w_sel = w[prism60, 1]
    assert w_sel[dev < delta_min - 0.3].sum() < 1e-3 * w_sel.sum()
    band1 = w_sel[(dev >= delta_min) & (dev < delta_min + 2)].sum()
    band2 = w_sel[(dev >= delta_min + 8) & (dev < delta_min + 10)].sum()
    assert band1 > 3 * band2


def test_basal_90deg_prism_anchor():
    n = 200000
    n_ior = 1.31
    d_in = np.array([0.0, 0.0, -1.0], np.float32)
    exits = run_trace(n, down(n), random_rotations(n, seed=13), max_hits=4, n_ior=n_ior)
    w, plen = exits.w.numpy(), exits.path_len.numpy()
    path, d_out = exits.path.numpy(), exits.d_world.numpy()
    f_in, f_out = path[:, 0], path[:, 1]
    side_basal = ((f_in >= 3) & (f_out <= 2)) | ((f_in <= 2) & (f_out >= 3))
    sel = side_basal & (plen[:, 1] == 2) & (w[:, 1] > 1e-4)
    assert sel.sum() > 500
    dev = np.degrees(np.arccos(np.clip(d_out[sel, 1, :] @ d_in, -1, 1)))
    delta_min = np.degrees(2 * np.arcsin(n_ior * np.sin(np.deg2rad(45)))) - 90.0
    w_sel = w[sel, 1]
    assert w_sel[dev < delta_min - 0.5].sum() < 1e-3 * w_sel.sum()


def test_dead_lane_zero_weight():
    """Lanes that miss every crystal (an empty shape) emit nothing."""
    g = geo.prism_geom_batch(torch.zeros(1), torch.ones(1, 6))
    pool = trace.make_geom_pool(g, sampling.build_entry_tris(g))
    n = 32
    exits = trace.trace_layer(1, torch.arange(n), down(n), torch.ones(n),
                              torch.eye(3)[None].repeat(n, 1, 1),
                              torch.zeros(n, dtype=torch.int32), pool, torch.full((n,), 1.31), 6)
    assert not bool(exits.entry_ok.any())
    assert float(exits.w.sum()) == 0.0


def test_trace_is_deterministic():
    n = 256
    d = down(n, (0.6, 0.0, -0.8))
    rot = random_rotations(n, seed=5)
    pool = make_pool()
    idx = torch.arange(n)
    args = (3, idx, d, torch.ones(n), rot, torch.zeros(n, dtype=torch.int32), pool,
            torch.full((n,), 1.31), 6)
    e1, e2 = trace.trace_layer(*args), trace.trace_layer(*args)
    assert torch.equal(e1.w, e2.w) and torch.equal(e1.path, e2.path)
