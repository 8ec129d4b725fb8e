"""Programmatic scene builder.

Mirrors the reference C API's value-semantics scene building
(LUMICE_SceneCreate / SceneAdd{Crystal,Filter,Renderer,ScatterLayer,
ColorClass} / SceneSet{LightSource,SimParams} / SceneToJson —
reference/src/include/lumice.h:734-818) as a fluent Python builder.
The builder emits the same dict the JSON loader consumes, so everything
built here round-trips through files and the C API alike.

Example:
    scene = (SceneBuilder()
             .add_crystal(1, prism(height=1.2), zenith=uniform(90, 360))
             .sun(altitude=25)
             .spectrum_wavelength(550)
             .sim_params(ray_num=1_000_000, max_hits=8)
             .add_scatter_layer([(1, 100.0)])
             .add_render(lens="fisheye_equal_area", fov=120,
                         resolution=(512, 512), elevation=25))
    cfg = scene.build()
"""

from __future__ import annotations

import copy
from typing import Optional, Sequence, Tuple, Union

from ice_halo_sim_tpu_torch.config.loader import load_project
from ice_halo_sim_tpu_torch.config.schema import ProjectConfig

Number = Union[int, float]
DistLike = Union[Number, dict]


# -- distribution helpers ----------------------------------------------------

def uniform(mean: Number, full_range: Number) -> dict:
    return {"type": "uniform", "mean": mean, "std": full_range}


def gauss(mean: Number, std: Number) -> dict:
    return {"type": "gauss", "mean": mean, "std": std}


def zigzag(center: Number, amplitude: Number) -> dict:
    return {"type": "zigzag", "mean": center, "std": amplitude}


def laplacian(mu: Number, b: Number) -> dict:
    return {"type": "laplacian", "mean": mu, "std": b}


# -- shape helpers -----------------------------------------------------------

def prism(height: DistLike = 1.0,
          face_distance: Optional[Sequence[DistLike]] = None) -> dict:
    shape: dict = {"height": height}
    if face_distance is not None:
        shape["face_distance"] = list(face_distance)
    return {"type": "prism", "shape": shape}


def pyramid(upper_h: DistLike = 0.0, prism_h: DistLike = 1.0,
            lower_h: DistLike = 0.0,
            upper_indices: Optional[Tuple[int, int, int]] = None,
            lower_indices: Optional[Tuple[int, int, int]] = None,
            upper_wedge_angle: Optional[Number] = None,
            lower_wedge_angle: Optional[Number] = None,
            face_distance: Optional[Sequence[DistLike]] = None) -> dict:
    shape: dict = {"upper_h": upper_h, "prism_h": prism_h, "lower_h": lower_h}
    if upper_indices is not None:
        shape["upper_indices"] = list(upper_indices)
    if lower_indices is not None:
        shape["lower_indices"] = list(lower_indices)
    if upper_wedge_angle is not None:
        shape["upper_wedge_angle"] = upper_wedge_angle
    if lower_wedge_angle is not None:
        shape["lower_wedge_angle"] = lower_wedge_angle
    if face_distance is not None:
        shape["face_distance"] = list(face_distance)
    return {"type": "pyramid", "shape": shape}


class SceneBuilder:
    """Accumulates a project document; ``build()`` validates via the loader."""

    def __init__(self):
        self._doc: dict = {
            "crystal": [],
            "filter": [],
            "scene": {
                "light_source": {"type": "sun", "altitude": 20.0},
                "ray_num": 1_000_000,
                "max_hits": 8,
                "scattering": [],
            },
            "render": [],
        }

    # -- crystals ------------------------------------------------------------

    def add_crystal(self, cid: int, shape: dict,
                    zenith: DistLike = 90.0,
                    azimuth: Optional[DistLike] = None,
                    roll: Optional[DistLike] = None) -> "SceneBuilder":
        axis: dict = {"zenith": zenith}
        if azimuth is not None:
            axis["azimuth"] = azimuth
        if roll is not None:
            axis["roll"] = roll
        self._doc["crystal"].append({"id": cid, **shape, "axis": axis})
        return self

    # -- filters -------------------------------------------------------------

    def add_filter(self, fid: int, ftype: str, symmetry: str = "",
                   action: str = "filter_in", **params) -> "SceneBuilder":
        obj: dict = {"id": fid, "type": ftype, **params}
        if symmetry:
            obj["symmetry"] = symmetry
        if action != "filter_in":
            obj["action"] = action
        self._doc["filter"].append(obj)
        return self

    def add_raypath_filter(self, fid: int, raypath: Sequence[int],
                           symmetry: str = "", **kw) -> "SceneBuilder":
        return self.add_filter(fid, "raypath", symmetry=symmetry,
                               raypath=list(raypath), **kw)

    def add_complex_filter(self, fid: int,
                           composition: Sequence[Sequence[int]],
                           **kw) -> "SceneBuilder":
        return self.add_filter(fid, "complex",
                               composition=[list(c) for c in composition], **kw)

    # -- light ---------------------------------------------------------------

    def sun(self, altitude: Number, azimuth: Number = 0.0,
            diameter: Number = 0.5) -> "SceneBuilder":
        ls = self._doc["scene"]["light_source"]
        ls.update(type="sun", altitude=altitude, azimuth=azimuth,
                  diameter=diameter)
        return self

    def spectrum_wavelength(self, *wavelengths: Number,
                            weights: Optional[Sequence[Number]] = None
                            ) -> "SceneBuilder":
        w = weights if weights is not None else [1.0] * len(wavelengths)
        self._doc["scene"]["light_source"]["spectrum"] = [
            {"wavelength": wl, "weight": ww} for wl, ww in zip(wavelengths, w)
        ]
        return self

    def spectrum_illuminant(self, name: str) -> "SceneBuilder":
        self._doc["scene"]["light_source"]["spectrum"] = name
        return self

    # -- sim params / scattering --------------------------------------------

    def sim_params(self, ray_num: Optional[int] = None,
                   max_hits: Optional[int] = None) -> "SceneBuilder":
        if ray_num is not None:
            self._doc["scene"]["ray_num"] = ray_num
        if max_hits is not None:
            self._doc["scene"]["max_hits"] = max_hits
        return self

    def add_scatter_layer(self, entries: Sequence[tuple],
                          prob: float = 0.0) -> "SceneBuilder":
        """entries: (crystal_id, proportion) or (crystal_id, proportion,
        filter_id) tuples."""
        layer_entries = []
        for e in entries:
            ent = {"crystal": e[0], "proportion": e[1]}
            if len(e) > 2 and e[2]:
                ent["filter"] = e[2]
            layer_entries.append(ent)
        self._doc["scene"]["scattering"].append(
            {"prob": prob, "entries": layer_entries}
        )
        return self

    # -- renderers -----------------------------------------------------------

    def add_render(self, lens: str = "fisheye_equal_area", fov: Number = 120,
                   resolution: Tuple[int, int] = (512, 512),
                   azimuth: Number = 0.0, elevation: Number = 0.0,
                   roll: Number = 0.0, rid: Optional[int] = None,
                   **extra) -> "SceneBuilder":
        obj = {
            "id": rid if rid is not None else len(self._doc["render"]) + 1,
            "lens": {"type": lens, "fov": fov},
            "resolution": list(resolution),
            "view": {"azimuth": azimuth, "elevation": elevation, "roll": roll},
            **extra,
        }
        self._doc["render"].append(obj)
        return self

    # -- raypath color -------------------------------------------------------

    def add_color_class(self, name: str, matches: Sequence[dict],
                        color: Tuple[float, float, float] = (1, 1, 1),
                        combine: str = "any") -> "SceneBuilder":
        rc = self._doc.setdefault("raypath_color",
                                  {"mode": "dominant", "classes": []})
        rc["classes"].append(
            {"name": name, "match": list(matches), "color": list(color),
             "combine": combine}
        )
        return self

    def composite_mode(self, mode: str) -> "SceneBuilder":
        self._doc.setdefault("raypath_color",
                             {"mode": mode, "classes": []})["mode"] = mode
        return self

    # -- output --------------------------------------------------------------

    def to_dict(self) -> dict:
        return copy.deepcopy(self._doc)

    def build(self) -> ProjectConfig:
        """Validate + return the typed config (raises on bad references)."""
        return load_project(self.to_dict())

    def clone(self) -> "SceneBuilder":
        b = SceneBuilder()
        b._doc = self.to_dict()
        return b
