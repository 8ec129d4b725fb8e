"""Area-measure inverse-CDF latitude LUT (host-side build).

Numpy port of BuildLatLut (reference/src/core/lat_lut.cpp): a
257-node uniform-colatitude inverse-CDF table for zonal-band zenith sampling
with per-bin pole-flip probability. Built once per axis distribution on the
host (deterministic quadrature, no RNG) and shipped to the device as three
float32 arrays consumed by the vectorized sampler in sampling.py.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from ice_halo_sim_tpu_torch.config.schema import DistType, Distribution

N_NODES = 257  # LatLut::kNodes (256 intervals -> 8-step fixed binary search)
_FINE = 4096
_QUAD = 1 << 16


class LatLut(NamedTuple):
    theta: np.ndarray      # [N_NODES] colatitude nodes (uniform spacing)
    cdf: np.ndarray        # [N_NODES] strictly-increasing CDF values
    flip_prob: np.ndarray  # [N_NODES] per-interval pole-flip probability


def _normalize_latitude(phi: float) -> tuple:
    """Spherical fold of an arbitrary latitude (math.cpp:542-553)."""
    theta = np.pi / 2 - phi
    theta = np.fmod(theta, 2 * np.pi)
    if theta < 0:
        theta += 2 * np.pi
    flip = theta > np.pi
    if flip:
        theta = 2 * np.pi - theta
    return np.pi / 2 - theta, flip


def _proposal_lat_from_u(dtype: DistType, mean: float, scale: float, u: np.ndarray) -> np.ndarray:
    """Deterministic single-uniform transform per family (lat_lut.cpp:31-44)."""
    if dtype == DistType.UNIFORM:
        return (u - 0.5) * scale + mean
    if dtype == DistType.ZIGZAG:
        return np.abs(scale * np.sin(u * 2 * np.pi) + mean)
    if dtype == DistType.LAPLACIAN:
        sgn = np.where(u < 0.5, -1.0, 1.0)
        arg = np.maximum(1.0 - 2.0 * np.abs(u - 0.5), 1e-30)
        return mean - scale * sgn * np.log(arg)
    return np.full_like(u, mean)


def _degenerate_lut(colat: float) -> LatLut:
    c = float(np.clip(colat, 0.0, np.pi))
    theta = np.full(N_NODES, c, np.float32)
    cdf = (np.arange(N_NODES) / (N_NODES - 1)).astype(np.float32)
    return LatLut(theta, cdf, np.zeros(N_NODES, np.float32))


def build_lat_lut(lat_dist: Distribution) -> LatLut:
    """Deterministic quadrature of the area-measure latitude density.

    Mirrors BuildLatLut (lat_lut.cpp:73-180): accumulate sin(theta)-weighted
    mass (+ flipped mass) over fine colatitude bins, bracket [1e-7, 1-1e-7],
    resample N_NODES uniform-theta nodes, lift the CDF to strict monotonicity.
    """
    mean = np.deg2rad(lat_dist.center)
    scale = np.deg2rad(lat_dist.spread)
    dtheta = np.pi / _FINE
    mass = np.zeros(_FINE)
    flip_mass = np.zeros(_FINE)

    def accumulate(lats: np.ndarray, weights: np.ndarray) -> None:
        theta0 = np.pi / 2 - lats
        theta0 = np.fmod(theta0, 2 * np.pi)
        theta0 = np.where(theta0 < 0, theta0 + 2 * np.pi, theta0)
        flip = theta0 > np.pi
        theta_z = np.where(flip, 2 * np.pi - theta0, theta0)
        w = weights * np.sin(theta_z)
        keep = w > 0
        bins = np.clip((theta_z / dtheta).astype(np.int64), 0, _FINE - 1)
        np.add.at(mass, bins[keep], w[keep])
        fk = keep & flip
        np.add.at(flip_mass, bins[fk], w[fk])

    if lat_dist.type == DistType.GAUSS:
        lo, hi = mean - 12 * scale, mean + 12 * scale
        dL = (hi - lo) / _QUAD
        L = lo + (np.arange(_QUAD) + 0.5) * dL
        d = L - mean
        inv2s2 = 1.0 / (2 * scale * scale) if scale > 0 else 0.0
        accumulate(L, np.exp(-d * d * inv2s2) * dL)
    else:
        u = (np.arange(_QUAD) + 0.5) / _QUAD
        accumulate(_proposal_lat_from_u(lat_dist.type, mean, scale, u), np.full(_QUAD, 1.0 / _QUAD))

    cum_mass = np.concatenate([[0.0], np.cumsum(mass)])
    cum_flip = np.concatenate([[0.0], np.cumsum(flip_mass)])
    total = cum_mass[-1]
    if not total > 0:
        phi, _ = _normalize_latitude(mean)
        return _degenerate_lut(np.pi / 2 - phi)

    rel = cum_mass / total
    lo_idx = int(np.argmax(rel >= 1e-7))
    hi_candidates = np.nonzero(rel <= 1.0 - 1e-7)[0]
    hi_idx = int(hi_candidates[-1]) if len(hi_candidates) else _FINE
    theta_lo = lo_idx * dtheta
    theta_hi = hi_idx * dtheta
    if not theta_hi > theta_lo:
        return _degenerate_lut(0.5 * (theta_lo + theta_hi))

    def lerp_cum(cum: np.ndarray, t: np.ndarray) -> np.ndarray:
        x = t / dtheta
        i = np.clip(x.astype(np.int64), 0, _FINE - 1)
        f = np.clip(x - i, 0.0, 1.0)
        return cum[i] * (1 - f) + cum[i + 1] * f

    t_nodes = theta_lo + (theta_hi - theta_lo) * np.arange(N_NODES) / (N_NODES - 1)
    cdf = (lerp_cum(cum_mass, t_nodes) / total).astype(np.float32)
    # Strict monotonicity lift (binary-search predicate totality).
    for n in range(1, N_NODES):
        if cdf[n] <= cdf[n - 1]:
            cdf[n] = np.nextafter(cdf[n - 1], np.float32(np.inf))
    m0 = lerp_cum(cum_mass, t_nodes[:-1])
    m1 = lerp_cum(cum_mass, t_nodes[1:])
    f0 = lerp_cum(cum_flip, t_nodes[:-1])
    f1 = lerp_cum(cum_flip, t_nodes[1:])
    dm = m1 - m0
    flip_prob = np.zeros(N_NODES, np.float32)
    good = dm > 0
    flip_prob[:-1][good] = np.clip((f1 - f0)[good] / dm[good], 0.0, 1.0)
    flip_prob[-1] = flip_prob[-2]
    return LatLut(t_nodes.astype(np.float32), cdf, flip_prob)
