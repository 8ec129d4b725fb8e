"""JSON project loader.

Parses the reference's project JSON format (crystal / filter / scene / render
sections — reference/examples/config_example.json,
reference/doc/configuration.md) into the typed schema. Semantics mirror
the reference parsers: src/config/config_manager.cpp,
src/config/crystal_config.cpp:302-430, src/config/filter_config.cpp,
src/core/math.cpp:594-740 (Distribution / axis parsing),
src/config/render_config.cpp:60-141 (lens f->fov).
"""

from __future__ import annotations

import json
from typing import Any, Optional

from portbench.reference.plain.utils.log import get_logger

from portbench.reference.plain.config.schema import (
    DIST_TYPE_NAMES,
    LENS_TYPE_NAMES,
    AxisDistribution,
    ComplexFilter,
    ColorClass,
    ColorPredicate,
    CrystalConfig,
    CrystalFilter,
    DirectionFilter,
    DistType,
    Distribution,
    EntryExitFilter,
    FilterAction,
    FilterConfig,
    GridLineParam,
    LensParam,
    LensType,
    LightSource,
    MsLayer,
    NoneFilter,
    PrismShape,
    ProjectConfig,
    PyramidShape,
    prepare_sync_groups,
    RaypathColorConfig,
    RaypathFilter,
    RenderConfig,
    ScatterEntry,
    SceneConfig,
    SunParam,
    Symmetry,
    ViewParam,
    VisibleRange,
    WlParam,
    focal_to_fov,
    max_fov,
    miller_to_alpha,
)

MAX_HITS_CAP = 64  # reference def.hpp:24 kMaxHits


def parse_distribution(obj: Any) -> Distribution:
    """Number -> NoRandom; object requires "type" (math.cpp:594-630)."""
    if isinstance(obj, (int, float)):
        return Distribution(DistType.NO_RANDOM, float(obj), 0.0)
    if isinstance(obj, dict):
        if "type" not in obj:
            raise ValueError(
                'distribution object is missing required key "type". Write either a bare '
                'number (e.g. 20) or an object naming the distribution '
                '(e.g. {"type": "gauss", "mean": 20, "std": 5}).'
            )
        t = DIST_TYPE_NAMES.get(obj["type"])
        if t is None:
            raise ValueError(f"unknown distribution type {obj['type']!r}")
        return Distribution(t, float(obj.get("mean", 0.0)), float(obj.get("std", 0.0)))
    raise ValueError(f"cannot recognize distribution: {obj!r}")


def parse_axis(obj: Optional[dict]) -> AxisDistribution:
    """`axis` absent -> default fixed orientation; present requires `zenith`.

    zenith (external) -> latitude (internal) via latitude = 90 - zenith; when
    azimuth / roll keys are absent they default to uniform full-360
    (math.cpp:687-739).
    """
    if obj is None:
        return AxisDistribution()
    if "zenith" not in obj:
        raise ValueError('axis is present but has no "zenith"')
    lat = parse_distribution(obj["zenith"])
    lat = Distribution(lat.type, 90.0 - lat.center, lat.spread)
    az = Distribution(DistType.UNIFORM, 0.0, 360.0)
    roll = Distribution(DistType.UNIFORM, 0.0, 360.0)
    if "azimuth" in obj:
        az = parse_distribution(obj["azimuth"])
    if "roll" in obj:
        roll = parse_distribution(obj["roll"])
    return AxisDistribution(azimuth=az, latitude=lat, roll=roll)


def _parse_face_distance(shape: dict) -> tuple:
    fd = [Distribution.fixed(1.0)] * 6
    if "face_distance" in shape:
        for i, elem in enumerate(shape["face_distance"][:6]):
            fd[i] = parse_distribution(elem)
    return tuple(fd)


def _parse_sync_group(shape: dict, scalar_keys: tuple) -> tuple:
    """Optional "sync_group" sub-map: scalar keys name shape scalars with the
    same strings as their distributions; "face_distance" is a 6-int array
    (crystal_config.cpp:172-201). Absent = every scalar independent."""
    n = len(scalar_keys) + 6
    groups = [0] * n
    sg = shape.get("sync_group")
    if not isinstance(sg, dict):
        return tuple(groups)
    for i, key in enumerate(scalar_keys):
        if key in sg:
            groups[i] = int(sg[key])
    for i, elem in enumerate(sg.get("face_distance", ())[:6]):
        groups[len(scalar_keys) + i] = int(elem)
    return tuple(groups)


def parse_crystal(obj: dict) -> CrystalConfig:
    cid = int(obj["id"])
    ctype = obj["type"]
    shape_obj = obj["shape"]
    if ctype == "prism":
        shape = PrismShape(
            height=parse_distribution(shape_obj["height"]),
            face_distance=_parse_face_distance(shape_obj),
            sync_group=_parse_sync_group(shape_obj, ("height",)),
        )
    elif ctype == "pyramid":
        # Wedge angle: explicit wedge_angle wins, else Miller indices
        # [i1, i2, i4] -> alpha (crystal_config.cpp:372-381), else 28 deg.
        def wedge(upper: bool) -> float:
            angle_key = "upper_wedge_angle" if upper else "lower_wedge_angle"
            idx_key = "upper_indices" if upper else "lower_indices"
            if angle_key in shape_obj:
                return float(shape_obj[angle_key])
            if idx_key in shape_obj and isinstance(shape_obj[idx_key], list) and len(shape_obj[idx_key]) == 3:
                idx = shape_obj[idx_key]
                return miller_to_alpha(int(idx[0]), int(idx[2]))
            return 28.0

        shape = PyramidShape(
            upper_h=parse_distribution(shape_obj.get("upper_h", 0.0)),
            prism_h=parse_distribution(shape_obj["prism_h"]),
            lower_h=parse_distribution(shape_obj.get("lower_h", 0.0)),
            wedge_angle_u=wedge(True),
            wedge_angle_l=wedge(False),
            face_distance=_parse_face_distance(shape_obj),
            sync_group=_parse_sync_group(
                shape_obj, ("upper_h", "prism_h", "lower_h")
            ),
        )
    else:
        raise ValueError(f"unknown crystal type {ctype!r}")
    shape, sync_warnings = prepare_sync_groups(shape)
    for group, slot, leader in sync_warnings:
        get_logger("config").warning(
            "crystal %d sync group %d: member slot %d declared a different "
            "distribution than its leader slot %d; the leader's is used",
            cid, group, slot, leader,
        )
    return CrystalConfig(id=cid, shape=shape, axis=parse_axis(obj.get("axis")))


def parse_symmetry(s: str) -> Symmetry:
    sym = Symmetry.NONE
    for ch in s:
        if ch in "Pp":
            sym |= Symmetry.P
        elif ch in "Bb":
            sym |= Symmetry.B
        elif ch in "Dd":
            sym |= Symmetry.D
    return sym


def parse_filter(obj: dict) -> FilterConfig:
    fid = int(obj["id"])
    ftype = obj["type"]
    if ftype == "none":
        param = NoneFilter()
    elif ftype == "raypath":
        param = RaypathFilter(raypath=tuple(int(x) for x in obj["raypath"]))
    elif ftype == "entry_exit":
        min_len = int(obj.get("min_len", 1))
        max_len = obj.get("max_len")
        if min_len < 1:
            raise ValueError("entry_exit filter: min_len must be >= 1")
        if max_len is not None:
            max_len = int(max_len)
            if max_len < min_len:
                raise ValueError("entry_exit filter: max_len must be >= min_len")
            if max_len > MAX_HITS_CAP:
                raise ValueError(f"entry_exit filter: max_len exceeds {MAX_HITS_CAP}")
        param = EntryExitFilter(
            entry=int(obj["entry"]) if obj.get("entry") is not None else None,
            exit=int(obj["exit"]) if obj.get("exit") is not None else None,
            min_len=min_len,
            max_len=max_len,
        )
    elif ftype == "direction":
        param = DirectionFilter(az=float(obj["az"]), el=float(obj["el"]), radii=float(obj["radii"]))
    elif ftype == "crystal":
        param = CrystalFilter(crystal_id=int(obj["crystal_id"]))
    elif ftype == "complex":
        comp = []
        for clause in obj["composition"]:
            if isinstance(clause, list):
                comp.append(tuple(int(x) for x in clause))
            else:
                comp.append((int(clause),))
        param = ComplexFilter(composition=tuple(comp))
    else:
        raise ValueError(f"unknown filter type {ftype!r}")

    sym = parse_symmetry(obj.get("symmetry", ""))
    action = FilterAction.FILTER_OUT if obj.get("action") == "filter_out" else FilterAction.FILTER_IN
    return FilterConfig(id=fid, param=param, symmetry=sym, action=action)


def parse_light(obj: dict) -> LightSource:
    sun = SunParam(
        altitude=float(obj.get("altitude", 20.0)),
        azimuth=float(obj.get("azimuth", 0.0)),
        # Absent diameter = POINT sun (the reference value-initializes
        # SunParam{} — light_config.cpp:58-66); a 0.5 default blurred every
        # sharp halo edge by +-0.25 deg and cost the cza scene 1.2 dB of
        # reference parity (round-4 finding).
        diameter=float(obj.get("diameter", 0.0)),
    )
    spectrum_obj = obj.get("spectrum", [{"wavelength": 550.0, "weight": 1.0}])
    if isinstance(spectrum_obj, str):
        return LightSource(sun=sun, spectrum=(), illuminant=spectrum_obj.upper())
    spectrum = tuple(
        WlParam(float(e["wavelength"]), float(e.get("weight", 1.0))) for e in spectrum_obj
    )
    return LightSource(sun=sun, spectrum=spectrum, illuminant=None)


def parse_scene(obj: dict) -> SceneConfig:
    ray_num_obj = obj["ray_num"]
    if isinstance(ray_num_obj, str) and ray_num_obj == "infinite":
        ray_num = -1
    else:
        ray_num = int(ray_num_obj)
    max_hits = int(obj["max_hits"])
    if max_hits <= 0 or max_hits > MAX_HITS_CAP:
        raise ValueError(f"max_hits must be in [1, {MAX_HITS_CAP}]")
    layers = []
    for i, j_layer in enumerate(obj["scattering"]):
        if "prob" not in j_layer:
            raise ValueError(f'scene.scattering[{i}] is missing required field "prob"')
        entries = []
        for e in j_layer["entries"]:
            entries.append(
                ScatterEntry(
                    crystal_id=int(e["crystal"]),
                    filter_id=int(e.get("filter", 0)),
                    proportion=float(e.get("proportion", 100.0)),
                )
            )
        layers.append(MsLayer(prob=float(j_layer["prob"]), entries=tuple(entries)))
    return SceneConfig(ray_num=ray_num, max_hits=max_hits, layers=tuple(layers))


def parse_render(obj: dict) -> RenderConfig:
    j_lens = obj["lens"]
    lens_type = LENS_TYPE_NAMES[j_lens["type"]]
    if "fov" in j_lens:
        fov = float(j_lens["fov"])
    elif "f" in j_lens:
        fov = focal_to_fov(lens_type, float(j_lens["f"]))
    else:
        fov = 90.0
    if lens_type != LensType.RECTANGULAR and (fov <= 0 or fov > max_fov(lens_type)):
        raise ValueError(f"fov must be in (0, {max_fov(lens_type)}] for lens type {lens_type.name}")

    view_obj = obj.get("view", {})
    view = ViewParam(
        az=float(view_obj.get("azimuth", 0.0)),
        el=float(view_obj.get("elevation", 0.0)),
        ro=float(view_obj.get("roll", 0.0)),
    )
    visible = {
        "upper": VisibleRange.UPPER,
        "lower": VisibleRange.LOWER,
        "full": VisibleRange.FULL,
    }[obj.get("visible", "upper")]

    def grid_lines(key: str) -> tuple:
        out = []
        for g in obj.get("grid", {}).get(key, []):
            out.append(
                GridLineParam(
                    value=float(g["value"]),
                    width=float(g.get("width", 1.0)),
                    opacity=float(g.get("opacity", 1.0)),
                    color=tuple(float(c) for c in g.get("color", (1.0, 1.0, 1.0))),
                )
            )
        return tuple(out)

    return RenderConfig(
        id=int(obj.get("id", 0)),
        lens=LensParam(type=lens_type, fov=fov),
        resolution=tuple(int(x) for x in obj["resolution"]),
        lens_shift=tuple(int(x) for x in obj.get("lens_shift", (0, 0))),
        view=view,
        visible=visible,
        background=tuple(float(x) for x in obj.get("background", (0.0, 0.0, 0.0))),
        ray_color=tuple(float(x) for x in obj.get("ray_color", (-1.0, -1.0, -1.0))),
        opacity=float(obj.get("opacity", 1.0)),
        intensity_factor=float(obj.get("intensity_factor", 1.0)),
        overlap=float(obj.get("overlap", 0.0)),
        central_grid=grid_lines("central"),
        elevation_grid=grid_lines("elevation"),
        celestial_outline=bool(obj.get("grid", {}).get("outline", True)),
    )


def parse_raypath_color(obj) -> Optional[RaypathColorConfig]:
    """Wire forms (raypath_color_config.cpp:75-99): bare list of classes
    (default composite mode), or {"mode": ..., "classes": [...]}."""
    if not obj:
        return None
    if isinstance(obj, list):
        mode = "dominant"
        class_objs = obj
    else:
        mode = str(obj.get("mode", "dominant"))
        class_objs = obj.get("classes", [])
    classes = []
    for c in class_objs:
        preds = []
        for p in c.get("match", []):
            preds.append(
                ColorPredicate(
                    layer=int(p.get("layer", 0)),
                    crystal_id=int(p["crystal"]),
                    raypath=tuple(int(x) for x in p.get("raypath", ())),
                    symmetry=parse_symmetry(p.get("symmetry", "")),
                )
            )
        classes.append(
            ColorClass(
                name=str(c.get("name", f"class{len(classes)}")),
                predicates=tuple(preds),
                combine_all=(c.get("combine", "any") == "all"),
                color=tuple(float(x) for x in c.get("color", (1.0, 1.0, 1.0))),
                visible=bool(c.get("visible", True)),
                solo=bool(c.get("solo", False)),
                z_order=int(c.get("z_order", len(classes))),
            )
        )
    return RaypathColorConfig(classes=tuple(classes), composite_mode=mode)


def load_project(doc: dict) -> ProjectConfig:
    crystals = {}
    for j_crystal in doc["crystal"]:
        c = parse_crystal(j_crystal)
        crystals[c.id] = c
    filters = {}
    for j_filter in doc.get("filter", []):
        f = parse_filter(j_filter)
        filters[f.id] = f
    # Validate complex filter composition references (config_manager.cpp:196-210).
    for f in filters.values():
        if isinstance(f.param, ComplexFilter):
            for clause in f.param.composition:
                for ref in clause:
                    if ref not in filters:
                        raise ValueError(f"complex filter {f.id} references unknown filter {ref}")
                    if isinstance(filters[ref].param, ComplexFilter):
                        raise ValueError(f"complex filter {f.id} may not nest complex filter {ref}")
    scene_obj = doc["scene"]
    scene = parse_scene(scene_obj)
    light = parse_light(scene_obj.get("light_source", {}))
    # Validate scatter entry references.
    for li, layer in enumerate(scene.layers):
        for e in layer.entries:
            if e.crystal_id not in crystals:
                raise ValueError(f"scattering[{li}] references unknown crystal {e.crystal_id}")
            if e.filter_id != 0 and e.filter_id not in filters:
                raise ValueError(f"scattering[{li}] references unknown filter {e.filter_id}")
    renders = tuple(parse_render(r) for r in doc.get("render", []))
    return ProjectConfig(
        crystals=crystals,
        filters=filters,
        scene=scene,
        renders=renders,
        light=light,
        raypath_color=parse_raypath_color(doc.get("raypath_color")),
    )


def load_project_file(path: str) -> ProjectConfig:
    with open(path, "r") as f:
        return load_project(json.load(f))
