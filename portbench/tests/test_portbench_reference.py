"""The reference that decides ``correct``, on the CPU at a small batch.

The port's plain kernels (the CPU's only set) render each configuration of
the benchmark; the reference (``portbench/reference``) works the same
batches out again from the configuration and the seed and must land on the
port's image to float64 rounding, with its segments exactly and its landed
and dropped weights to float32 rounding. A run one precision lower must
fail the comparison: the reference with bfloat16 rows and stats.

    python -m pytest portbench/tests -q -p no:cacheprovider
"""

import copy
import json
import os

import pytest
import torch

from portbench.reference import oracle
from portbench.reference.plain.config.loader import load_project as ref_load
from portbench.reference.scene import Scene

HERE = os.path.dirname(os.path.abspath(__file__))
PB = os.path.dirname(HERE)
SEED = 3000000019          # over 2**31, as the benchmark's seeds are
BATCH = 4096
STEPS = 3                  # batches a dispatch
CONFIGS = ["light_single_ms"]

torch.set_num_threads(2)


def _doc(name):
    with open(os.path.join(PB, "configs", f"{name}.json")) as f:
        return json.load(f)["document"]


def _limits(cell):
    with open(os.path.join(PB, "workloads", f"{cell}.json")) as f:
        return json.load(f)["limits"]


def _port_images(doc, monkeypatch):
    """The port's image per render after its set-up (a calibrating batch and
    one dispatch) and one dispatch more, with its traced segments."""
    from ice_halo_sim_tpu_torch.config.loader import load_project
    from ice_halo_sim_tpu_torch.engine.simulator import Engine

    monkeypatch.setenv("IHT_STEPS_PER_DISPATCH", str(STEPS))
    eng = Engine(load_project(copy.deepcopy(doc)), seed=SEED, batch_size=BATCH, device="cpu")
    eng.run(n_batches=1)
    eng.run(n_batches=STEPS)
    eng.run(n_batches=STEPS)
    images = [torch.from_numpy(eng.raw_xyz(r).reshape(-1, 3).astype("float32"))
              for r in range(len(eng.proj_plans))]
    return images, eng.drain_stats(), eng


def _reference(doc, bf16=False):
    scene = Scene(ref_load(copy.deepcopy(doc)), SEED, BATCH, "cpu")
    n = 1 + 2 * STEPS
    zeros = [torch.zeros((pp.height * pp.width, 3)) for pp in scene.proj_plans]
    return oracle.replay(scene, zeros, range(n), bf16=bf16), zeros


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_lands_on_the_port(name, monkeypatch):
    doc = _doc(name)
    port, st, eng = _port_images(doc, monkeypatch)
    ref, zeros = _reference(doc)
    gap = oracle.image_gap(port, ref["images"], zeros)
    assert ref["batches"] == eng.batch_counter == 1 + 2 * STEPS
    assert st.ray_segments == ref["segs"]
    stats = oracle.stats_gap(st.landed_weight, st.dropped_cont_weight, ref, 0.0, 0.0)
    assert ref["dropped"] != 0.0
    # Float32 sums in another order on the port's side; the CPU's plain twin
    # takes the dropped weight as a difference of two float32 sums of every
    # row (the card's kernel sums the terms: 1e-14 of the landed weight).
    assert stats["landed"] <= 1e-6 and stats["dropped"] <= 1e-7, stats
    assert gap["added_l1"] > 0
    # The CPU's plain scan takes each pixel's sum as a difference of two
    # float64 running sums: some 1e-14 of the image, far under the limit.
    assert gap["gap_l1"] <= 1e-12 * gap["added_l1"], gap


@pytest.mark.parametrize("cell", ["light_single.r512", "light_single.r2048"])
def test_bfloat16_rows_and_stats_fail(cell):
    ref, zeros = _reference(_doc("light_single_ms"))
    low, _ = _reference(_doc("light_single_ms"), bf16=True)
    gap = oracle.image_gap(low["images"], ref["images"], zeros)
    lim = _limits(cell)
    assert low["segs"] == ref["segs"]
    assert gap["gap_l1"] > 10 * lim["image_gap_l1"] * gap["added_l1"], gap
    assert gap["ulp_max"] > 10 * lim["image_gap_ulp"], gap
    # The bfloat16 running total of the landed weight: 3e-3 off after these
    # seven batches from zero; on the card, from the program's total before a
    # window dispatch, 0.79 or more (PERF.md).
    stats = oracle.stats_gap(low["landed"], low["dropped"], ref, 0.0, 0.0)
    assert stats["landed"] > 1e-3, stats
