"""One scattering layer in the AoS layout (port of
``ice_halo_sim_tpu.core.trace``): the K-shape geometry pool and the bounce
loop ``trace_layer``, the JAX package's reference formulation, which the
debug ray dump (engine/debug.py) runs and which the SoA trace of the general
path (core/trace_soa.py) is held to.

Per bounce the child that leaves the convex crystal is emitted with its
Fresnel weight and the internal child continues, so a batch traces in
lockstep: slot 0 is the entry reflection, slot k the refracted exit of
internal bounce k; a TIR emits nothing; dead lanes carry zero weight. The
face-number path is one [B, max_hits] buffer, exit k its prefix of k + 1.

Two lowerings, as in the JAX function: one shared crystal (K == 1 and no
per-ray shape index) reads [NF, ...] / [T, ...] tables broadcast over the
rays; a pool of K shapes expands each table to [B, NF, ...] by the ray's
pool row (``shape_idx``, the per-setting blocks of ``setting_blocks``, or
the geom-clock block ray // (B / K)).

TPU workarounds dropped, values kept: the one-hot products that read a
face's normal, a face number or a triangle's corners (matmuls on the TPU)
are indexed reads; the ``lax.scan`` over bounces is a loop. Dot products
and the entry CDF are written out in the order of the SoA trace, so the two
layouts give the same bits on one device.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ice_halo_sim_tpu_torch.core import optics, rng, sampling
from ice_halo_sim_tpu_torch.core.bits import F32, I32, I64

SLAB_EPS = optics.SLAB_EPS
_BIG = 1e30


class GeomPool(NamedTuple):
    """K sampled crystal shapes: face planes and entry fan triangles."""

    plane_n: torch.Tensor         # [K, NF, 3]
    plane_d: torch.Tensor         # [K, NF]
    face_present: torch.Tensor    # [K, NF] bool
    face_number: torch.Tensor     # [K, NF] int32
    tri_v0: torch.Tensor          # [K, T, 3] entry fan sub-triangles
    tri_e1: torch.Tensor          # [K, T, 3]
    tri_e2: torch.Tensor          # [K, T, 3]
    tri_cross_half: torch.Tensor  # [K, T, 3]
    tri_face: torch.Tensor        # [K, T] int32


def make_geom_pool(geoms, entry_tris) -> GeomPool:
    """Pack batched CrystalGeom [K, ...] + EntryTris [K, ...] into a pool."""
    return GeomPool(
        plane_n=geoms.plane_n,
        plane_d=geoms.plane_d,
        face_present=geoms.face_present,
        face_number=geoms.face_number,
        tri_v0=entry_tris.v0,
        tri_e1=entry_tris.e1,
        tri_e2=entry_tris.e2,
        tri_cross_half=entry_tris.cross_half,
        tri_face=entry_tris.face_idx,
    )


class TraceExits(NamedTuple):
    """Per-ray exit slots of one layer (H = max_hits): slot 0 the entry
    reflection, slot k >= 1 the refracted exit of internal bounce k; weight
    0 marks a dead slot."""

    d_world: torch.Tensor   # [B, H, 3] exit directions (world frame)
    w: torch.Tensor         # [B, H]
    path_len: torch.Tensor  # [B, H] int32 prefix length of `path` (0: dead)
    path: torch.Tensor      # [B, H] int32 face numbers
    entry_ok: torch.Tensor  # [B] bool: the lane hit its crystal


def _entry_shared(seed, idx, d_local, pool: GeomPool):
    """The entry sampler against the one shape's [T, ...] tables (slots
    10-12, the distribution of sampling.sample_entry)."""
    wt = torch.clamp_min(-optics.dot3(d_local[:, None, :], pool.tri_cross_half[0]), 0.0)
    return sampling._pick_entry(seed, idx, wt, pool.tri_v0[0], pool.tri_e1[0],
                                pool.tri_e2[0], pool.tri_face[0])


def trace_layer(seed, ray_idx, d_world, w0, rot, shape_idx, pool: GeomPool, n_ior,
                max_hits: int, score_grad: bool = False,
                setting_blocks: Optional[tuple] = None) -> TraceExits:
    """Trace B rays through one scattering layer's crystals.

    seed: the layer's u32 seed (python int or int64 tensor, scalar or [B]);
    ray_idx [B] u32 ray indices (the RNG streams); d_world [B, 3] incident
    directions; w0 [B]; rot [B, 3, 3] crystal -> world; shape_idx [B] pool
    rows, or None for the blocked assignment (``setting_blocks`` ((k_s,
    count_s), ...) per setting, else ray i on row i // (B / K)); n_ior [B]
    or a scalar; max_hits interactions in all (entry + max_hits - 1).
    score_grad: the weights carry the entry choice's score term,
    w * exp(log p - log p.detach()), whose value is w."""
    B = d_world.shape[0]
    dev = d_world.device
    entry_seed = rng._t(seed, ray_idx) ^ rng.NONCE_ENTRY
    K, NF = pool.plane_n.shape[0], pool.plane_n.shape[1]
    shared = shape_idx is None and K == 1
    n_ior = torch.as_tensor(n_ior, dtype=F32, device=dev)

    d_local = sampling.rotate_inv(rot, d_world)

    if shared:
        plane_n = pool.plane_n[0]                     # [NF, 3]
        face_num = pool.face_number[0]                # [NF]
        present_row = pool.face_present[0][None, :]
        plane_d_row = pool.plane_d[0][None, :]
        p, f0, entry_ok, log_p = _entry_shared(entry_seed, ray_idx, d_local, pool)

        def normal(fi):                               # face index [B] -> [B, 3]
            return plane_n[fi]

        def number(fi):
            return face_num[fi]
    else:
        if shape_idx is not None:
            row = torch.as_tensor(shape_idx, device=dev).long()
        elif setting_blocks is not None:
            from ice_halo_sim_tpu_torch.core.trace_soa import lane_pool_rows

            row = lane_pool_rows(setting_blocks, B, dev)
        else:
            if B % K:
                raise ValueError(f"a pool of {K} shapes does not split {B} rays into blocks")
            row = torch.arange(B, dtype=I64, device=dev) // (B // K)
        plane_n = pool.plane_n[row]                   # [B, NF, 3]
        face_num = pool.face_number[row]              # [B, NF]
        present_row = pool.face_present[row]
        plane_d_row = pool.plane_d[row]
        tris = sampling.EntryTris(pool.tri_v0[row], pool.tri_e1[row], pool.tri_e2[row],
                                  pool.tri_cross_half[row], pool.tri_face[row])
        p, f0, entry_ok, log_p = sampling.sample_entry(entry_seed, ray_idx, d_local, tris)

        def normal(fi):
            return plane_n.gather(1, fi[:, None, None].expand(B, 1, 3))[:, 0]

        def number(fi):
            return face_num.gather(1, fi[:, None])[:, 0]

    def dot_faces(v):                                 # [B, 3] -> [B, NF]
        return optics.dot3(v[:, None, :], plane_n)

    w = torch.where(entry_ok, w0, 0.0)
    if score_grad:
        w = w * torch.exp(log_p - log_p.detach())

    f0 = f0.long()
    d_r, d_t, w_r, w_t, _ = optics.fresnel_split(d_local, normal(f0), w, n_ior)
    ex_d = [sampling.rotate(rot, d_r)]
    ex_w = [torch.where(entry_ok, w_r, 0.0)]
    fns = [number(f0)]

    # Plane distances of the entry point, carried from bounce to bounce:
    # dist' = dist + t * denom (the position itself is never needed).
    dist = dot_faces(p) + plane_d_row
    face_iota = torch.arange(NF, dtype=I64, device=dev)
    d, w, prev_f = d_t, w_t, f0
    for _ in range(1, max_hits):
        denom = dot_faces(d)
        t_face = -dist / torch.where(torch.abs(denom) > 1e-30, denom, 1e-30)
        candidate = (denom > SLAB_EPS) & present_row & (face_iota != prev_f[:, None])
        # Ties and the no-candidate case go to the lowest face slot.
        t, fi = torch.min(torch.where(candidate, t_face, _BIG), dim=-1)
        # Slightly negative t: a TIR-edge hit just inside the source face.
        found = (t < _BIG * 0.5) & (t > -SLAB_EPS)
        alive = found & (w > 0.0)
        n_face = normal(fi)
        dist = torch.where(alive[:, None], dist + t[:, None] * denom, dist)
        d_r, d_t, w_r, w_t, is_tir = optics.fresnel_split(d, n_face, w, n_ior)
        cos_exit = optics.dot3(d_t, n_face)
        ex_w.append(torch.where(alive & ~is_tir & (cos_exit > 0.0), w_t, 0.0))
        ex_d.append(sampling.rotate(rot, d_t))
        fns.append(torch.where(alive, number(fi), 0))
        d = torch.where(alive[:, None], d_r, d)
        w = torch.where(alive, w_r, 0.0)
        prev_f = torch.where(alive, fi, prev_f)

    exit_w = torch.stack(ex_w, dim=1)
    slot_len = torch.arange(1, max_hits + 1, dtype=I32, device=dev)
    return TraceExits(
        d_world=torch.stack(ex_d, dim=1),
        w=exit_w,
        path_len=torch.where(exit_w > 0.0, slot_len, 0).to(I32),
        path=torch.stack(fns, dim=1).to(I32),
        entry_ok=entry_ok,
    )


def total_exit_weight(exits: TraceExits) -> torch.Tensor:
    """Sum of emitted weights per ray [B] (energy accounting)."""
    return exits.w.sum(dim=-1)
