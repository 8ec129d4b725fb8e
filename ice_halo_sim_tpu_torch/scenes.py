"""The port's full-width scenes, as project documents for ``load_project``.

``BENCH_CFG`` is bench.py's scene of the same name, field for field (the
reference's ``bench_light_single_ms``): one fixed h = 1.2 prism, so the
trace kernel runs in its static-geometry mode.

``POOL_CFG`` is the same light and ray depth with a stochastic pyramid (a
Gaussian upper cap and prism height), so every 128-ray group traces its own
sampled shape (the trace kernel's blocked-pool mode, NF = 20 face slots),
seen through two renders: the dual fisheye of ``BENCH_CFG`` and a single
equal-area fisheye looking at the zenith.
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
