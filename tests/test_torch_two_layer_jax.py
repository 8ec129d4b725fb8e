"""The witness of the benchmark's general-path reference
(``portbench/reference/two_layer.py``): the reference against the JAX
package's engine on the CPU, for the benchmark's two-layer scene
(``light_two_layer_ms``), on a few seeds at a small batch. The reference
holds no code of either package; this holds its statement of the port's
rules to the JAX engine, independently of the port.

Tolerances are ``tests/test_torch_multilayer.py``'s for ``MS_CFG``: the JAX
block sort of the continuation is unstable, so two live rows of a block
with equal keys may take either of two lanes of the next layer (the
reference breaks the tie by row, as the port does), and the later layer is
held by totals with an allowance of TIE_RAYS swapped rays and by 8 x 8 box
sums of the image.

    python -m pytest tests/test_torch_two_layer_jax.py -q -p no:cacheprovider
"""

import copy
import json
import os

import numpy as np
import pytest
import torch

from ice_halo_sim_tpu.config.loader import load_project as jax_load_project
from ice_halo_sim_tpu.engine.simulator import Engine as JEngine
from portbench.reference import oracle, two_layer
from portbench.reference.plain.config.loader import load_project as ref_load
from tests.test_torch_multilayer import SUM_RTOL, TIE_RAYS, _box

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 4096
SEEDS = [7, 3000000019]

with open(os.path.join(ROOT, "portbench", "configs", "light_two_layer_ms.json")) as f:
    DOC = json.load(f)["document"]


@pytest.fixture(autouse=True)
def _general_env(monkeypatch):
    monkeypatch.setenv("IHT_PALLAS_TRACE", "0")
    monkeypatch.setenv("IHT_FOLD", "sort")
    monkeypatch.setenv("IHT_STEPS_PER_DISPATCH", "1")


@pytest.mark.parametrize("seed", SEEDS)
def test_the_reference_agrees_with_the_jax_engine(seed):
    """One calibrating batch and two more in the JAX engine; the reference
    replays the three. Equal calibration (slot cap, lanes); segments,
    landed and dropped weight within TIE_RAYS swapped rays; the images
    after an 8 x 8 box sum to rtol 1e-3 with the same allowance."""
    j = JEngine(jax_load_project(copy.deepcopy(DOC)), seed=seed, batch_size=B,
                accum_method="sort", geom_clock=two_layer.GEOM_CLOCK)
    scene = two_layer.Scene(ref_load(copy.deepcopy(DOC)), seed, B, "cpu")
    assert [l.cont_cap for l in j.layers] == [l.lanes for l in scene.layers]
    j.run(n_batches=1)
    j.run(n_batches=2)
    zeros = [torch.zeros((pp.height * pp.width, 3)) for pp in scene.proj_plans]
    ref = oracle.replay(scene, zeros, range(3))
    assert j._slot_cap == scene.slot_cap
    assert [l.cont_cap for l in j.layers] == [l.lanes for l in scene.layers]
    js = j.drain_stats()
    w_ray = float(scene._w0_tbl.max())
    H = scene.max_hits
    assert abs(js.ray_segments - ref["segs"]) <= TIE_RAYS * H
    assert abs(js.landed_weight - ref["landed"]) <= \
        SUM_RTOL * ref["landed"] + TIE_RAYS * w_ray
    assert abs(js.dropped_cont_weight - ref["dropped"]) <= \
        1e-6 * ref["landed"] + TIE_RAYS * w_ray
    cell = TIE_RAYS * w_ray * float(scene.basis_tbl.max())
    for r, pp in enumerate(scene.proj_plans):
        a = _box(ref["images"][r].numpy().reshape(pp.height, pp.width, 3))
        b = _box(np.array(j.raw_xyz(r)))
        np.testing.assert_allclose(a.sum(), b.sum(), rtol=1e-4)
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=cell)
