"""The K-shape geometry pool of one scattering layer (the ``GeomPool`` part
of ``ice_halo_sim_tpu.core.trace``; the XLA bounce loop ``trace_layer`` of
that module belongs to the general trace path and is not ported here)."""

from __future__ import annotations

from typing import NamedTuple

import torch


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
