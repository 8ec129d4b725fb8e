"""The witness of the benchmark's mixed-layer reference
(``portbench/reference/mixed_layers.py``): the reference against the JAX
package's engine on the CPU, for the benchmark's pyramid-heavy scene
(``pyramid_heavy_ms3``: three layers of a pyramid and a column at 70 / 30)
at batch 1024 and 128 x 64. The reference holds no code of either package;
this holds its statement of the port's rules to the JAX engine,
independently of the port. A file of its own: the JAX engine's compile and
batches take most of a minute.

Tolerances are ``tests/test_torch_two_layer_jax.py``'s: the JAX block sort
of the continuation is unstable, so two live rows of a block with equal
keys may take either of two lanes of the next layer (the reference breaks
the tie by row, as the port does); the layers after the first are held by
totals with an allowance of TIE_RAYS swapped rays a layer boundary and by
8 x 8 box sums of the image.

XLA on the CPU flushes subnormal floats to zero and torch keeps them: at 14
hits a deep exit's weight falls below float32's smallest normal in some
0.2% of the traced segments, which the JAX engine then counts dead. The
reference's traced segments are counted here with those exits flushed, as
XLA does (they carry no weight that lands: the weights agree either way).

    python -m pytest tests/test_torch_pyramid_heavy_jax.py -q -p no:cacheprovider
"""

import copy
import json
import os

import numpy as np
import pytest
import torch

from ice_halo_sim_tpu.config.loader import load_project as jax_load_project
from ice_halo_sim_tpu.engine.simulator import Engine as JEngine
from portbench.reference import mixed_layers, oracle
from portbench.reference.plain.config.loader import load_project as ref_load
from tests.test_torch_multilayer import SUM_RTOL, TIE_RAYS, _box

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 1024
SEED = 3100000019

with open(os.path.join(ROOT, "portbench", "configs", "pyramid_heavy_ms3.json")) as f:
    DOC = json.load(f)["document"]
DOC["render"][0]["resolution"] = [128, 64]


@pytest.fixture(autouse=True)
def _general_env(monkeypatch):
    monkeypatch.setenv("IHT_PALLAS_TRACE", "0")
    monkeypatch.setenv("IHT_FOLD", "sort")
    monkeypatch.setenv("IHT_STEPS_PER_DISPATCH", "1")


def _flushed_trace(monkeypatch):
    """The reference's layer trace with exit weights below float32's
    smallest normal flushed to zero, as XLA on the CPU computes them."""
    from portbench.reference.plain.core import trace_layer

    real = trace_layer.trace_layer_soa
    tiny = torch.finfo(torch.float32).tiny

    def flushed(*args, **kw):
        ex = real(*args, **kw)
        return ex._replace(w=torch.where(ex.w.abs() < tiny, 0.0, ex.w))

    monkeypatch.setattr(trace_layer, "trace_layer_soa", flushed)


def test_the_reference_agrees_with_the_jax_engine(monkeypatch):
    """One calibrating batch and one more in the JAX engine; the reference
    replays the two. Equal plans (each layer's lanes, each setting's lanes
    and shapes) and calibration (slot cap); segments, landed and dropped
    weight within TIE_RAYS swapped rays a layer boundary; the image after
    an 8 x 8 box sum to rtol 1e-3 with the same allowance."""
    j = JEngine(jax_load_project(copy.deepcopy(DOC)), seed=SEED, batch_size=B,
                accum_method="sort", geom_clock=mixed_layers.GEOM_CLOCK)
    scene = mixed_layers.Scene(ref_load(copy.deepcopy(DOC)), SEED, B, "cpu")

    def plan(layers):
        return [(l.lanes, [s.lanes for s in l.settings], [s.k for s in l.settings])
                for l in layers]

    assert [(l.cont_cap, list(l.setting_counts), list(l.k_per_setting)) for l in j.layers] \
        == plan(scene.layers)
    j.run(n_batches=1)
    j.run(n_batches=1)
    _flushed_trace(monkeypatch)
    zeros = [torch.zeros((pp.height * pp.width, 3)) for pp in scene.proj_plans]
    ref = oracle.replay(scene, zeros, range(2))
    assert j._slot_cap == scene.slot_cap < scene.max_hits
    assert [l.cont_cap for l in j.layers] == [l.lanes for l in scene.layers]
    js = j.drain_stats()
    w_ray = float(scene._w0_tbl.max())
    ties = TIE_RAYS * (len(scene.layers) - 1)
    assert abs(js.ray_segments - ref["segs"]) <= ties * scene.max_hits
    assert abs(js.landed_weight - ref["landed"]) <= SUM_RTOL * ref["landed"] + ties * w_ray
    assert abs(js.dropped_cont_weight - ref["dropped"]) <= \
        1e-6 * ref["landed"] + ties * w_ray
    cell = ties * w_ray * float(scene.basis_tbl.max())
    for r, pp in enumerate(scene.proj_plans):
        a = _box(ref["images"][r].numpy().reshape(pp.height, pp.width, 3))
        b = _box(np.array(j.raw_xyz(r)))
        np.testing.assert_allclose(a.sum(), b.sum(), rtol=1e-4)
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=cell)
