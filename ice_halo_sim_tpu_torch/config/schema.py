"""Typed scene configuration schema.

Mirrors the reference's JSON schema semantics (crystal / filter / scene /
render sections — reference/src/config/*.hpp and
reference/doc/configuration.md) as plain Python dataclasses. These are
host-side value objects; the engine compiles them into static trace plans +
device arrays. Nothing here imports JAX.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from dataclasses import dataclass, field
from typing import Optional, Union


# --------------------------------------------------------------------------
# Distributions (reference: src/core/math.hpp:125-205)
# --------------------------------------------------------------------------

class DistType(enum.IntEnum):
    NO_RANDOM = 0
    UNIFORM = 1      # center = midpoint, spread = FULL range
    GAUSS = 2        # center = mean, spread = std
    ZIGZAG = 3       # |A sin(2 pi U) + B|, center = tilt B, spread = amplitude A
    LAPLACIAN = 4    # center = location mu, spread = scale b
    GAUSS_LEGACY = 5  # gaussian without area-measure Jacobian correction


DIST_TYPE_NAMES = {
    "uniform": DistType.UNIFORM,
    "gauss": DistType.GAUSS,
    "zigzag": DistType.ZIGZAG,
    "laplacian": DistType.LAPLACIAN,
    "gauss_legacy": DistType.GAUSS_LEGACY,
}


@dataclass(frozen=True)
class Distribution:
    type: DistType = DistType.NO_RANDOM
    center: float = 0.0
    spread: float = 0.0

    @property
    def is_random(self) -> bool:
        return self.type != DistType.NO_RANDOM

    @staticmethod
    def fixed(value: float) -> "Distribution":
        return Distribution(DistType.NO_RANDOM, float(value), 0.0)


@dataclass(frozen=True)
class AxisDistribution:
    """Crystal c-axis orientation distribution.

    ``latitude`` is internal (latitude = 90 - zenith, degrees); the JSON wire
    key is ``zenith``. Defaults match the reference's AxisDistribution ctor
    (src/core/math.cpp:537-539): all-NoRandom, latitude 90 (c-axis vertical).
    """

    azimuth: Distribution = Distribution(DistType.NO_RANDOM, 0.0, 0.0)
    latitude: Distribution = Distribution(DistType.NO_RANDOM, 90.0, 0.0)
    roll: Distribution = Distribution(DistType.NO_RANDOM, 0.0, 0.0)

    def is_full_sphere_uniform(self) -> bool:
        # src/core/math.cpp:556-560. The reference stores the config's
        # zenith values verbatim (center 90 = horizontal axis); OUR
        # latitude convention is latitude = 90 - zenith (loader.parse_axis),
        # so the reference's center==90 test is center==0 here. Round-4
        # finding: testing 90 in the converted convention sent every
        # full-random scene (the BENCH scene included) through the LUT
        # inverse-CDF sampler — identical distribution (area-weighted
        # full-range uniform == uniform over the sphere) but ~2 ms/batch
        # of [B, 257] masked scans instead of one arcsin.
        a, l = self.azimuth, self.latitude
        eps = 1e-5
        return (
            a.type == DistType.UNIFORM
            and abs(a.center) < eps
            and abs(a.spread - 360.0) < eps
            and l.type == DistType.UNIFORM
            and abs(l.center) < eps
            and abs(l.spread - 360.0) < eps
        )

    def is_az_rotationally_symmetric(self) -> bool:
        return self.azimuth.type == DistType.UNIFORM and abs(self.azimuth.spread - 360.0) < 1e-5

    def is_deterministic(self) -> bool:
        return (
            self.azimuth.type == DistType.NO_RANDOM
            and self.latitude.type == DistType.NO_RANDOM
            and self.roll.type == DistType.NO_RANDOM
        )


# --------------------------------------------------------------------------
# Crystal shapes (reference: src/config/crystal_config.hpp:31-129)
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class PrismShape:
    """Hexagonal prism: height ratio h plus six signed face distances."""

    height: Distribution = Distribution.fixed(1.0)
    face_distance: tuple = tuple(Distribution.fixed(1.0) for _ in range(6))
    # Sync groups: slots sharing a group id (>0) share one raw RNG draw per
    # crystal instance (crystal_config.hpp:184-198). Slot order:
    # [height, fd0..fd5].
    sync_group: tuple = (0, 0, 0, 0, 0, 0, 0)

    def is_deterministic(self) -> bool:
        return not self.height.is_random and not any(d.is_random for d in self.face_distance)


def miller_to_alpha(i1: int, i4: int) -> float:
    """Miller index (i1, i4) -> wedge angle degrees (crystal_config.cpp:331-339)."""
    if i1 == 0:
        return 28.0
    k_sqrt3_2 = 0.866025403784
    k_ice_c = 1.629
    return math.degrees(math.atan(k_sqrt3_2 * i4 / i1 / k_ice_c))


@dataclass(frozen=True)
class PyramidShape:
    """Hexagonal pyramid: prism segment + upper/lower pyramidal cones.

    upper_h/lower_h are relative heights in [0,1] of each cone segment
    (fraction of that cone's natural apex height); prism_h is the prism
    segment height ratio. Wedge angles in degrees (angle between pyramidal
    face and the c-axis); outside [0.1, 89.9] the segment is skipped.
    """

    upper_h: Distribution = Distribution.fixed(0.0)
    prism_h: Distribution = Distribution.fixed(1.0)
    lower_h: Distribution = Distribution.fixed(0.0)
    wedge_angle_u: float = 28.0
    wedge_angle_l: float = 28.0
    face_distance: tuple = tuple(Distribution.fixed(1.0) for _ in range(6))
    # Slot order: [upper_h, prism_h, lower_h, fd0..fd5].
    sync_group: tuple = (0, 0, 0, 0, 0, 0, 0, 0, 0)

    def is_deterministic(self) -> bool:
        return (
            not self.upper_h.is_random
            and not self.prism_h.is_random
            and not self.lower_h.is_random
            and not any(d.is_random for d in self.face_distance)
        )


CrystalShape = Union[PrismShape, PyramidShape]


# Sync-group slot layouts (our per-type tuples carry only the slots the type
# actually has, so the reference's "zero inapplicable slots" canonicalization
# rule is structural here). Tuple order mirrors the reference's ShapeScalar
# draw order scoped per type (crystal_config.hpp:31-43): prism
# [height, fd0..5]; pyramid [upper_h, prism_h, lower_h, fd0..5].
_PRISM_SYNC_FIELDS = ("height",) + tuple(f"face_distance[{i}]" for i in range(6))
_PYRAMID_SYNC_FIELDS = (
    "upper_h", "prism_h", "lower_h",
) + tuple(f"face_distance[{i}]" for i in range(6))


def canonicalize_sync_groups(groups: tuple) -> tuple:
    """Canonical form of a sync-group tuple (crystal_config.cpp:45-96):
    singleton groups become 0 (a lone member IS independence), surviving
    groups renumber 1..N by first appearance in slot order."""
    groups = list(groups)
    n = len(groups)
    for i in range(n):
        if groups[i] == 0:
            continue
        if sum(1 for g in groups if g == groups[i]) < 2:
            groups[i] = 0
    mapping: dict = {}
    for i in range(n):
        if groups[i] == 0:
            continue
        if groups[i] not in mapping:
            mapping[groups[i]] = len(mapping) + 1
        groups[i] = mapping[groups[i]]
    return tuple(groups)


def _shape_slot_dists(shape) -> list:
    if isinstance(shape, PrismShape):
        return [shape.height, *shape.face_distance]
    return [shape.upper_h, shape.prism_h, shape.lower_h, *shape.face_distance]


def _shape_with_slot_dists(shape, dists, groups):
    if isinstance(shape, PrismShape):
        return dataclasses.replace(
            shape, height=dists[0], face_distance=tuple(dists[1:7]),
            sync_group=tuple(groups),
        )
    return dataclasses.replace(
        shape, upper_h=dists[0], prism_h=dists[1], lower_h=dists[2],
        face_distance=tuple(dists[3:9]), sync_group=tuple(groups),
    )


def sync_group_leaders(groups: tuple) -> tuple:
    """Per slot: the index of the slot whose RNG draw this slot consumes —
    its own index when independent, the group's lowest member index (the
    leader, drawn first) otherwise (crystal_config.cpp:100-128)."""
    leaders = []
    for i, g in enumerate(groups):
        if g == 0:
            leaders.append(i)
        else:
            leaders.append(min(k for k, gg in enumerate(groups) if gg == g))
    return tuple(leaders)


def prepare_sync_groups(shape: CrystalShape):
    """Canonicalize + leader-normalize a shape's sync groups
    (crystal_config.hpp:184-198; both passes, one entry point).

    Returns (new_shape, warnings): warnings lists (group, slot, leader_slot)
    for members whose declared distribution differed from their leader's
    and was overwritten (the reference LOG_WARNINGs, never rejects)."""
    groups = canonicalize_sync_groups(shape.sync_group)
    dists = _shape_slot_dists(shape)
    leaders = sync_group_leaders(groups)
    warnings = []
    for i, leader in enumerate(leaders):
        if leader != i and dists[i] != dists[leader]:
            warnings.append((groups[i], i, leader))
        if leader != i:
            dists[i] = dists[leader]
    return _shape_with_slot_dists(shape, dists, groups), warnings


@dataclass(frozen=True)
class CrystalConfig:
    id: int
    shape: CrystalShape
    axis: AxisDistribution = AxisDistribution()


# --------------------------------------------------------------------------
# Filters (reference: src/config/filter_config.hpp)
# --------------------------------------------------------------------------

class Symmetry(enum.IntFlag):
    NONE = 0
    P = 1  # prism-face rotation (period-6 shift)
    B = 2  # basal mirror
    D = 4  # direction (sigma) mirror


class FilterAction(enum.IntEnum):
    FILTER_IN = 0
    FILTER_OUT = 1


@dataclass(frozen=True)
class NoneFilter:
    pass


@dataclass(frozen=True)
class RaypathFilter:
    raypath: tuple  # face-number sequence

@dataclass(frozen=True)
class EntryExitFilter:
    entry: Optional[int] = None  # None = wildcard
    exit: Optional[int] = None
    min_len: int = 1
    max_len: Optional[int] = None


@dataclass(frozen=True)
class DirectionFilter:
    az: float = 0.0   # degrees
    el: float = 0.0   # degrees
    radii: float = 0.0  # degrees (cone half-angle)


@dataclass(frozen=True)
class CrystalFilter:
    crystal_id: int = 0


@dataclass(frozen=True)
class ComplexFilter:
    # OR of AND-clauses of simple filter ids: ((1,), (2, 6), (5,)) means
    # 1 OR (2 AND 6) OR 5. (filter_config: "composition": [1, [2, 6], 5])
    composition: tuple = ()


FilterParam = Union[NoneFilter, RaypathFilter, EntryExitFilter, DirectionFilter,
                    CrystalFilter, ComplexFilter]


@dataclass(frozen=True)
class FilterConfig:
    id: int
    param: FilterParam = NoneFilter()
    symmetry: Symmetry = Symmetry.NONE
    action: FilterAction = FilterAction.FILTER_IN


# --------------------------------------------------------------------------
# Light source / scene (reference: src/config/light_config.hpp, proj_config.hpp)
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class SunParam:
    altitude: float = 20.0  # degrees
    azimuth: float = 0.0    # degrees
    diameter: float = 0.0   # degrees; 0 = point sun (SunParam{} default,
    #                         light_config.cpp:58-66)


@dataclass(frozen=True)
class WlParam:
    wl: float      # nm
    weight: float


@dataclass(frozen=True)
class LightSource:
    sun: SunParam = SunParam()
    # Discrete spectrum list, or a standard illuminant name ("D65", "A", ...).
    spectrum: tuple = (WlParam(550.0, 1.0),)
    illuminant: Optional[str] = None


@dataclass(frozen=True)
class ScatterEntry:
    crystal_id: int
    filter_id: int = 0       # 0 = no filter
    proportion: float = 1.0


@dataclass(frozen=True)
class MsLayer:
    prob: float = 0.0
    entries: tuple = ()


@dataclass(frozen=True)
class SceneConfig:
    ray_num: int = 100000  # TOTAL across wavelengths (server.cpp:1477-1495)
    max_hits: int = 8
    layers: tuple = ()     # MsLayer sequence


# --------------------------------------------------------------------------
# Render (reference: src/config/render_config.hpp)
# --------------------------------------------------------------------------

class LensType(enum.IntEnum):
    # Integer values match LensParam::LensType and the projection wire values
    # (projection_shared.h:139-150).
    LINEAR = 0
    FISHEYE_EQUAL_AREA = 1
    FISHEYE_EQUIDISTANT = 2
    FISHEYE_STEREOGRAPHIC = 3
    DUAL_FISHEYE_EQUAL_AREA = 4
    DUAL_FISHEYE_EQUIDISTANT = 5
    DUAL_FISHEYE_STEREOGRAPHIC = 6
    RECTANGULAR = 7
    FISHEYE_ORTHOGRAPHIC = 8
    DUAL_FISHEYE_ORTHOGRAPHIC = 9
    GLOBE = 10


LENS_TYPE_NAMES = {
    "linear": LensType.LINEAR,
    "fisheye_equal_area": LensType.FISHEYE_EQUAL_AREA,
    "fisheye_equidistant": LensType.FISHEYE_EQUIDISTANT,
    "fisheye_stereographic": LensType.FISHEYE_STEREOGRAPHIC,
    "dual_fisheye_equal_area": LensType.DUAL_FISHEYE_EQUAL_AREA,
    "dual_fisheye_equidistant": LensType.DUAL_FISHEYE_EQUIDISTANT,
    "dual_fisheye_stereographic": LensType.DUAL_FISHEYE_STEREOGRAPHIC,
    "rectangular": LensType.RECTANGULAR,
    "fisheye_orthographic": LensType.FISHEYE_ORTHOGRAPHIC,
    "dual_fisheye_orthographic": LensType.DUAL_FISHEYE_ORTHOGRAPHIC,
    "globe": LensType.GLOBE,
}


def max_fov(lens_type: LensType) -> float:
    # render_config.cpp:127-141
    if lens_type == LensType.LINEAR:
        return 179.0
    if lens_type == LensType.FISHEYE_STEREOGRAPHIC:
        return 359.0
    if lens_type in (LensType.FISHEYE_ORTHOGRAPHIC, LensType.DUAL_FISHEYE_ORTHOGRAPHIC):
        return 180.0
    if lens_type == LensType.GLOBE:
        return 90.0
    return 360.0


def focal_to_fov(lens_type: LensType, f_mm: float) -> float:
    """35mm-film focal length -> field of view (render_config.cpp:62-116)."""
    d = 12.0  # half short edge of 35mm film
    if lens_type == LensType.LINEAR:
        return math.degrees(math.atan2(d, f_mm)) * 2
    if lens_type in (LensType.FISHEYE_EQUAL_AREA, LensType.DUAL_FISHEYE_EQUAL_AREA):
        x = d / (2 * f_mm)
        if x > 1.0:
            raise ValueError("focal length too short for equal area fisheye (f >= 6mm required)")
        return math.degrees(math.asin(x)) * 4
    if lens_type in (LensType.FISHEYE_EQUIDISTANT, LensType.DUAL_FISHEYE_EQUIDISTANT):
        return math.degrees(d / f_mm)
    if lens_type in (LensType.FISHEYE_STEREOGRAPHIC, LensType.DUAL_FISHEYE_STEREOGRAPHIC):
        return math.degrees(math.atan(d / (2 * f_mm))) * 4
    if lens_type == LensType.RECTANGULAR:
        return 0.0
    if lens_type in (LensType.FISHEYE_ORTHOGRAPHIC, LensType.DUAL_FISHEYE_ORTHOGRAPHIC):
        x = d / f_mm
        if x > 1.0:
            raise ValueError("focal length too short for orthographic fisheye")
        return math.degrees(math.asin(x)) * 2
    if lens_type == LensType.GLOBE:
        return math.degrees(math.atan2(d, f_mm)) * 2
    raise ValueError(f"unknown lens type {lens_type}")


class VisibleRange(enum.IntEnum):
    UPPER = 0
    LOWER = 1
    FULL = 2


@dataclass(frozen=True)
class LensParam:
    type: LensType = LensType.LINEAR
    fov: float = 90.0  # degrees


@dataclass(frozen=True)
class ViewParam:
    az: float = 0.0
    el: float = 0.0
    ro: float = 0.0


@dataclass(frozen=True)
class GridLineParam:
    value: float = 0.0
    width: float = 1.0
    opacity: float = 1.0
    color: tuple = (1.0, 1.0, 1.0)


@dataclass(frozen=True)
class RenderConfig:
    id: int = 0
    lens: LensParam = LensParam()
    resolution: tuple = (800, 400)         # (width, height)
    lens_shift: tuple = (0, 0)
    view: ViewParam = ViewParam()
    visible: VisibleRange = VisibleRange.UPPER
    background: tuple = (0.0, 0.0, 0.0)
    ray_color: tuple = (-1.0, -1.0, -1.0)  # negative => true spectral color
    opacity: float = 1.0
    intensity_factor: float = 1.0
    overlap: float = 0.0                   # dual-fisheye |sky.z| overlap threshold
    central_grid: tuple = ()
    elevation_grid: tuple = ()
    celestial_outline: bool = True


# --------------------------------------------------------------------------
# Raypath color classes (reference: src/config/raypath_color_config.hpp)
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class ColorPredicate:
    """One (layer, crystal) -> raypath predicate producing a component bit."""

    layer: int
    crystal_id: int
    raypath: tuple       # face-number sequence; () = whole-crystal
    symmetry: Symmetry = Symmetry.NONE


@dataclass(frozen=True)
class ColorClass:
    name: str
    predicates: tuple    # ColorPredicate sequence
    combine_all: bool = False  # False = any, True = all
    color: tuple = (1.0, 1.0, 1.0)
    visible: bool = True
    solo: bool = False   # restrict composite to solo'd classes (display-time)
    z_order: int = 0


@dataclass(frozen=True)
class RaypathColorConfig:
    classes: tuple = ()
    composite_mode: str = "dominant"  # dominant | additive | painter


# --------------------------------------------------------------------------
# Project root
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class ProjectConfig:
    crystals: dict            # id -> CrystalConfig
    filters: dict             # id -> FilterConfig
    scene: SceneConfig
    renders: tuple            # RenderConfig sequence
    light: LightSource = LightSource()
    raypath_color: Optional[RaypathColorConfig] = None

    def replace(self, **kw) -> "ProjectConfig":
        return dataclasses.replace(self, **kw)
