"""ProjectConfig -> JSON serialization (inverse of loader.py).

The reference exposes scene serialization through its C API value builder
(LUMICE_SceneToJson, reference/src/include/lumice.h:734-818). Here the
same capability is a pure function: ``project_to_dict`` emits the on-disk
project JSON schema, and ``load_project(project_to_dict(cfg)) == cfg`` holds
for every loadable config (round-trip tested).
"""

from __future__ import annotations

from typing import Any

from ice_halo_sim_tpu_torch.config.schema import (
    ComplexFilter,
    CrystalFilter,
    DirectionFilter,
    DistType,
    Distribution,
    EntryExitFilter,
    FilterAction,
    FilterConfig,
    LensType,
    NoneFilter,
    PrismShape,
    ProjectConfig,
    PyramidShape,
    RaypathFilter,
    RenderConfig,
    Symmetry,
    VisibleRange,
)

_DIST_NAMES = {
    DistType.UNIFORM: "uniform",
    DistType.GAUSS: "gauss",
    DistType.ZIGZAG: "zigzag",
    DistType.LAPLACIAN: "laplacian",
    DistType.GAUSS_LEGACY: "gauss_legacy",
}

_LENS_NAMES = {
    LensType.LINEAR: "linear",
    LensType.FISHEYE_EQUAL_AREA: "fisheye_equal_area",
    LensType.FISHEYE_EQUIDISTANT: "fisheye_equidistant",
    LensType.FISHEYE_STEREOGRAPHIC: "fisheye_stereographic",
    LensType.FISHEYE_ORTHOGRAPHIC: "fisheye_orthographic",
    LensType.DUAL_FISHEYE_EQUAL_AREA: "dual_fisheye_equal_area",
    LensType.DUAL_FISHEYE_EQUIDISTANT: "dual_fisheye_equidistant",
    LensType.DUAL_FISHEYE_STEREOGRAPHIC: "dual_fisheye_stereographic",
    LensType.DUAL_FISHEYE_ORTHOGRAPHIC: "dual_fisheye_orthographic",
    LensType.RECTANGULAR: "rectangular",
    LensType.GLOBE: "globe",
}


def dist_to_json(d: Distribution) -> Any:
    if d.type == DistType.NO_RANDOM:
        return d.center
    return {"type": _DIST_NAMES[d.type], "mean": d.center, "std": d.spread}


def _zenith_to_json(lat: Distribution) -> Any:
    """Internal latitude -> external zenith (zenith = 90 - latitude)."""
    if lat.type == DistType.NO_RANDOM:
        return 90.0 - lat.center
    return {"type": _DIST_NAMES[lat.type], "mean": 90.0 - lat.center, "std": lat.spread}


def symmetry_to_json(s: Symmetry) -> str:
    out = ""
    if s & Symmetry.P:
        out += "P"
    if s & Symmetry.B:
        out += "B"
    if s & Symmetry.D:
        out += "D"
    return out


def _face_distance_json(fd: tuple) -> list:
    return [dist_to_json(d) for d in fd]


def _sync_group_json(groups: tuple, scalar_keys: tuple) -> dict:
    """"sync_group" sub-map, written only when something is synced so
    existing configs stay byte-identical (crystal_config.cpp:204-227)."""
    sg: dict = {}
    for i, key in enumerate(scalar_keys):
        if groups[i] != 0:
            sg[key] = groups[i]
    faces = list(groups[len(scalar_keys):])
    if any(faces):
        sg["face_distance"] = faces
    return sg


def crystal_to_json(c) -> dict:
    axis = {
        "zenith": _zenith_to_json(c.axis.latitude),
        "azimuth": dist_to_json(c.axis.azimuth),
        "roll": dist_to_json(c.axis.roll),
    }
    if isinstance(c.shape, PrismShape):
        shape = {
            "height": dist_to_json(c.shape.height),
            "face_distance": _face_distance_json(c.shape.face_distance),
        }
        sg = _sync_group_json(c.shape.sync_group, ("height",))
        ctype = "prism"
    elif isinstance(c.shape, PyramidShape):
        shape = {
            "upper_h": dist_to_json(c.shape.upper_h),
            "prism_h": dist_to_json(c.shape.prism_h),
            "lower_h": dist_to_json(c.shape.lower_h),
            "upper_wedge_angle": c.shape.wedge_angle_u,
            "lower_wedge_angle": c.shape.wedge_angle_l,
            "face_distance": _face_distance_json(c.shape.face_distance),
        }
        sg = _sync_group_json(
            c.shape.sync_group, ("upper_h", "prism_h", "lower_h")
        )
        ctype = "pyramid"
    else:
        raise ValueError(f"unsupported shape {type(c.shape)}")
    if sg:
        shape["sync_group"] = sg
    return {"id": c.id, "type": ctype, "shape": shape, "axis": axis}


def filter_to_json(f: FilterConfig) -> dict:
    out: dict = {"id": f.id}
    p = f.param
    if isinstance(p, NoneFilter):
        out["type"] = "none"
    elif isinstance(p, RaypathFilter):
        out["type"] = "raypath"
        out["raypath"] = list(p.raypath)
    elif isinstance(p, EntryExitFilter):
        out["type"] = "entry_exit"
        if p.entry is not None:
            out["entry"] = p.entry
        if p.exit is not None:
            out["exit"] = p.exit
        out["min_len"] = p.min_len
        if p.max_len is not None:
            out["max_len"] = p.max_len
    elif isinstance(p, DirectionFilter):
        out["type"] = "direction"
        out.update(az=p.az, el=p.el, radii=p.radii)
    elif isinstance(p, CrystalFilter):
        out["type"] = "crystal"
        out["crystal_id"] = p.crystal_id
    elif isinstance(p, ComplexFilter):
        out["type"] = "complex"
        out["composition"] = [list(clause) for clause in p.composition]
    else:
        raise ValueError(f"unsupported filter param {type(p)}")
    sym = symmetry_to_json(f.symmetry)
    if sym:
        out["symmetry"] = sym
    if f.action == FilterAction.FILTER_OUT:
        out["action"] = "filter_out"
    return out


def light_to_json(light) -> dict:
    out = {
        "type": "sun",
        "altitude": light.sun.altitude,
        "azimuth": light.sun.azimuth,
        "diameter": light.sun.diameter,
    }
    if light.illuminant is not None:
        out["spectrum"] = light.illuminant
    else:
        out["spectrum"] = [
            {"wavelength": w.wl, "weight": w.weight} for w in light.spectrum
        ]
    return out


def render_to_json(r: RenderConfig) -> dict:
    visible = {
        VisibleRange.UPPER: "upper",
        VisibleRange.LOWER: "lower",
        VisibleRange.FULL: "full",
    }[r.visible]
    out: dict = {
        "id": r.id,
        "lens": {"type": _LENS_NAMES[r.lens.type], "fov": r.lens.fov},
        "resolution": list(r.resolution),
        "lens_shift": list(r.lens_shift),
        "view": {"azimuth": r.view.az, "elevation": r.view.el, "roll": r.view.ro},
        "visible": visible,
        "background": list(r.background),
        "ray_color": list(r.ray_color),
        "opacity": r.opacity,
        "intensity_factor": r.intensity_factor,
        "overlap": r.overlap,
    }
    grid: dict = {"outline": r.celestial_outline}
    for key, lines in (("central", r.central_grid), ("elevation", r.elevation_grid)):
        if lines:
            grid[key] = [
                {
                    "value": g.value,
                    "width": g.width,
                    "opacity": g.opacity,
                    "color": list(g.color),
                }
                for g in lines
            ]
    out["grid"] = grid
    return out


def raypath_color_to_json(rc) -> Any:
    if rc is None:
        return None
    return {
        "mode": rc.composite_mode,
        "classes": [
            {
                "name": c.name,
                "match": [
                    {
                        "layer": p.layer,
                        "crystal": p.crystal_id,
                        "raypath": list(p.raypath),
                        "symmetry": symmetry_to_json(p.symmetry),
                    }
                    for p in c.predicates
                ],
                "combine": "all" if c.combine_all else "any",
                "color": list(c.color),
                "visible": c.visible,
                "solo": c.solo,
                "z_order": c.z_order,
            }
            for c in rc.classes
        ],
    }


def project_to_dict(cfg: ProjectConfig) -> dict:
    doc = {
        "crystal": [crystal_to_json(c) for c in cfg.crystals.values()],
        "filter": [filter_to_json(f) for f in cfg.filters.values()],
        "scene": {
            "light_source": light_to_json(cfg.light),
            "ray_num": cfg.scene.ray_num if cfg.scene.ray_num >= 0 else "infinite",
            "max_hits": cfg.scene.max_hits,
            "scattering": [
                {
                    "prob": layer.prob,
                    "entries": [
                        {
                            "crystal": e.crystal_id,
                            "filter": e.filter_id,
                            "proportion": e.proportion,
                        }
                        for e in layer.entries
                    ],
                }
                for layer in cfg.scene.layers
            ],
        },
        "render": [render_to_json(r) for r in cfg.renders],
    }
    rc = raypath_color_to_json(cfg.raypath_color)
    if rc is not None:
        doc["raypath_color"] = rc
    return doc


def project_to_json(cfg: ProjectConfig, indent: int = 2) -> str:
    import json

    return json.dumps(project_to_dict(cfg), indent=indent)
