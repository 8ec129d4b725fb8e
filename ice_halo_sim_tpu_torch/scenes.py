"""The port's full-width scenes, as project documents for ``load_project``.

``BENCH_CFG`` is bench.py's scene of the same name, field for field (the
reference's ``bench_light_single_ms``): one fixed h = 1.2 prism, so the
trace kernel runs in its static-geometry mode.

``POOL_CFG`` is the same light and ray depth with a stochastic pyramid (a
Gaussian upper cap and prism height), so every 128-ray group traces its own
sampled shape (the trace kernel's blocked-pool mode, NF = 20 face slots),
seen through two renders: the dual fisheye of ``BENCH_CFG`` and a single
equal-area fisheye looking at the zenith.

``MS_CFG``, ``COLOR_CFG`` and ``SUNDOG_CFG`` take the general trace path.

``MS_CFG``: the same light and depth through two scattering layers, the
first continuing with probability 0.3. Each layer mixes two crystal settings:
a plate (h = 0.4, nearly horizontal) and a column (a Gaussian height around
2.0, axis nearly in the horizontal plane), so every batch samples a pool of
column shapes. The second layer's columns carry a ray-path filter ([3, 5]
under the P symmetry, filter_in). Two renders: the dual fisheye of
``BENCH_CFG`` and an equidistant fisheye at the zenith. No colour class, so
its folds run the pack, scatter and scan kernels.

``COLOR_CFG``: ``BENCH_CFG``'s crystal and light in one layer with three
colour classes: the raypath [3, 5], the raypaths [1, 3, 2] and the whole
crystal combined with "all", and the whole crystal; one rectangular render
of 1024 x 512. Its fold carries the class mask and the Y lanes. The layer
drops would-continue exits with probability 0.3 (the rule of a last layer
with prob > 0): a rectangular map takes every direction, and without the
gate more than 0.6 of the contribution rows are live, where the calibration
leaves the compaction prepass off and the mask column would never ride it.

``SUNDOG_CFG``: ``BENCH_CFG``'s light and render with ``MS_CFG``'s plates
and its ray-path filter ([3, 5], the parhelia) on the one layer: few
contribution rows, crowded into few image chunks.

The reference bench scenes: ``MULTI_CFG``, ``COMPLEX_CFG``, ``BD_CFG`` and
``PYRAMID3_CFG`` are stand-ins built from the repo's description of the
reference's bench set (``scripts/bench_matrix.py:10-16``,
``doc/perf-notes.md:136-139,254-262``), not copies of the reference's files,
which the repository does not hold. Each has ``BENCH_CFG``'s light (D65 sun
at 20 degrees) and its one dual fisheye render at 512 x 256.

``MULTI_CFG`` stands in for ``ms_multi`` ("3 crystals, 2 MS layers, prob
0.5"): ``MS_CFG``'s plate (id 1), ``MS_CFG``'s Gaussian column (id 2) and
``BENCH_CFG``'s randomly oriented h = 1.2 prism (id 3); two layers, each
with the three crystals at 40/30/30, the first continuing with probability
0.5; max_hits 7; no filter.

``COMPLEX_CFG`` stands in for ``complex_sop`` (a complex sum-of-products
filter): ``MULTI_CFG`` with one complex filter (filter_in) on every entry of
both layers, (raypath [3, 5] under P AND crystal 1) OR (entry 1, exit 3
under P). The schema has no ray-path filter restricted to a crystal, so the
first clause is the AND of two simple filters, a raypath and a crystal
filter, as the schema composes them (a complex filter's composition is an
OR of AND-clauses of simple filter ids); the entry-exit filter is the
schema's ``entry_exit``.

``BD_CFG`` stands in for ``filtered_bd`` (a raypath filter under B/D
symmetry): ``MULTI_CFG`` with one raypath filter [3, 5] under the symmetry
"BD" (filter_in) on every entry of both layers.

``PYRAMID3_CFG`` stands in for ``ms3_mixed_pyramid_heavy`` (three layers
with probabilities 0.8 and 0.75, max_hits 14, NF = 20): three layers with
probabilities 0.8, 0.75 and 0, each mixing ``POOL_CFG``'s stochastic
pyramid (id 1) with ``MS_CFG``'s column (id 2) at 70/30; max_hits 14. Its
fan-out makes one root ray some 100 times the work of a ``BENCH_CFG`` ray.
"""

from __future__ import annotations

import copy

BENCH_CFG = {
    "crystal": [
        {
            "id": 1,
            "type": "prism",
            "shape": {"height": 1.2},
            "axis": {
                "zenith": {"type": "uniform", "mean": 90.0, "std": 360.0},
                "azimuth": {"type": "uniform", "mean": 0.0, "std": 360.0},
            },
        }
    ],
    "filter": [],
    "scene": {
        "light_source": {"type": "sun", "altitude": 20.0, "spectrum": "D65"},
        "ray_num": 10000000,
        "max_hits": 7,
        "scattering": [{"prob": 0.0, "entries": [{"crystal": 1, "proportion": 10}]}],
    },
    "render": [
        {
            "id": 1,
            "lens": {"type": "dual_fisheye_equal_area", "fov": 180.0},
            "overlap": 0.0872,
            "resolution": [512, 256],
            "view": {"azimuth": 0.0, "elevation": 0.0, "roll": 0.0},
            "visible": "full",
        }
    ],
}

POOL_CFG = copy.deepcopy(BENCH_CFG)
POOL_CFG["crystal"] = [
    {
        "id": 1,
        "type": "pyramid",
        "shape": {
            "upper_h": {"type": "gauss", "mean": 0.3, "std": 0.05},
            "prism_h": {"type": "gauss", "mean": 0.9, "std": 0.1},
            "lower_h": 0.3,
        },
        "axis": {
            "zenith": {"type": "gauss", "mean": 90.0, "std": 1.2},
            "azimuth": {"type": "uniform", "mean": 0.0, "std": 360.0},
        },
    }
]
POOL_CFG["render"] = [
    copy.deepcopy(BENCH_CFG["render"][0]),
    {
        "id": 2,
        "lens": {"type": "fisheye_equal_area", "fov": 165.0},
        "resolution": [512, 512],
        "view": {"elevation": 90.0},
        "visible": "full",
    },
]

MS_CFG = copy.deepcopy(BENCH_CFG)
MS_CFG["crystal"] = [
    {
        "id": 1,
        "type": "prism",
        "shape": {"height": 0.4},
        "axis": {
            "zenith": {"type": "gauss", "mean": 0.0, "std": 1.0},
            "azimuth": {"type": "uniform", "mean": 0.0, "std": 360.0},
        },
    },
    {
        "id": 2,
        "type": "prism",
        "shape": {"height": {"type": "gauss", "mean": 2.0, "std": 0.2}},
        "axis": {
            "zenith": {"type": "gauss", "mean": 90.0, "std": 1.0},
            "azimuth": {"type": "uniform", "mean": 0.0, "std": 360.0},
        },
    },
]
MS_CFG["filter"] = [
    {"id": 1, "type": "raypath", "raypath": [3, 5], "symmetry": "P", "action": "filter_in"},
]
MS_CFG["scene"]["scattering"] = [
    {"prob": 0.3, "entries": [{"crystal": 1, "proportion": 50},
                              {"crystal": 2, "proportion": 50}]},
    {"prob": 0.0, "entries": [{"crystal": 1, "proportion": 50},
                              {"crystal": 2, "proportion": 50, "filter": 1}]},
]
MS_CFG["render"] = [
    copy.deepcopy(BENCH_CFG["render"][0]),
    {
        "id": 2,
        "lens": {"type": "fisheye_equidistant", "fov": 180.0},
        "resolution": [512, 512],
        "view": {"elevation": 90.0},
        "visible": "full",
    },
]

COLOR_CFG = copy.deepcopy(BENCH_CFG)
COLOR_CFG["scene"]["scattering"][0]["prob"] = 0.3
COLOR_CFG["raypath_color"] = {
    "mode": "dominant",
    "classes": [
        {"name": "35", "color": [1.0, 0.3, 0.2],
         "match": [{"crystal": 1, "raypath": [3, 5], "symmetry": "P"}]},
        {"name": "132", "color": [0.2, 1.0, 0.3], "combine": "all",
         "match": [{"crystal": 1, "raypath": [1, 3, 2], "symmetry": "P"},
                   {"crystal": 1}]},
        {"name": "all", "color": [0.3, 0.4, 1.0], "match": [{"crystal": 1}]},
    ],
}
COLOR_CFG["render"] = [
    {
        "id": 1,
        "lens": {"type": "rectangular", "fov": 360.0},
        "resolution": [1024, 512],
        "view": {"azimuth": 0.0, "elevation": 0.0, "roll": 0.0},
        "visible": "full",
    }
]

SUNDOG_CFG = copy.deepcopy(BENCH_CFG)
SUNDOG_CFG["crystal"] = [copy.deepcopy(MS_CFG["crystal"][0])]
SUNDOG_CFG["filter"] = copy.deepcopy(MS_CFG["filter"])
SUNDOG_CFG["scene"]["scattering"][0]["entries"][0]["filter"] = 1

MULTI_CFG = copy.deepcopy(BENCH_CFG)
MULTI_CFG["crystal"] = [copy.deepcopy(MS_CFG["crystal"][0]),
                        copy.deepcopy(MS_CFG["crystal"][1]),
                        dict(copy.deepcopy(BENCH_CFG["crystal"][0]), id=3)]
MULTI_CFG["scene"]["scattering"] = [
    {"prob": prob, "entries": [{"crystal": 1, "proportion": 40},
                               {"crystal": 2, "proportion": 30},
                               {"crystal": 3, "proportion": 30}]}
    for prob in (0.5, 0.0)
]


def _filtered(doc: dict, filters: list, fid: int) -> dict:
    """`doc` with `filters` and filter `fid` on every entry of every layer."""
    out = copy.deepcopy(doc)
    out["filter"] = filters
    for layer in out["scene"]["scattering"]:
        for entry in layer["entries"]:
            entry["filter"] = fid
    return out


COMPLEX_CFG = _filtered(MULTI_CFG, [
    {"id": 1, "type": "raypath", "raypath": [3, 5], "symmetry": "P"},
    {"id": 2, "type": "crystal", "crystal_id": 1},
    {"id": 3, "type": "entry_exit", "entry": 1, "exit": 3, "symmetry": "P"},
    {"id": 4, "type": "complex", "composition": [[1, 2], 3], "action": "filter_in"},
], 4)

BD_CFG = _filtered(MULTI_CFG, [
    {"id": 1, "type": "raypath", "raypath": [3, 5], "symmetry": "BD", "action": "filter_in"},
], 1)

PYRAMID3_CFG = copy.deepcopy(BENCH_CFG)
PYRAMID3_CFG["crystal"] = [copy.deepcopy(POOL_CFG["crystal"][0]),
                           copy.deepcopy(MS_CFG["crystal"][1])]
PYRAMID3_CFG["scene"]["max_hits"] = 14
PYRAMID3_CFG["scene"]["scattering"] = [
    {"prob": prob, "entries": [{"crystal": 1, "proportion": 70},
                               {"crystal": 2, "proportion": 30}]}
    for prob in (0.8, 0.75, 0.0)
]
