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
contribution rows, crowded into few image chunks, the scene on which the
fold dispatch's model favours the sandwich cascade most.
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
