"""The port's checkpoint (engine/checkpoint.py, the JAX package's format 1)
and crystal mesh (core/mesh.py) on the CPU: twins of the checkpoint and mesh
tests of tests/test_persistence.py, each package resuming the other's file,
and the mesh against the JAX package's.

Tolerances: within the port a resume is bit for bit. Across the packages,
the traced segments and ray count exact, landed weight rtol 1e-5, and the
images as tests/test_torch_server.py holds them (per pixel rtol 1e-4 with
atol 1e-6 of the maximum; the sum rtol 1e-5 but for the sun's pixel). The
emit floor and slot cap are off on the JAX side's XLA path (the port's
kernel path has neither). Mesh vertices within 1e-6, triangles and face
numbers equal.
"""

import json

import numpy as np
import pytest
import torch

from ice_halo_sim_tpu.config.loader import load_project as jax_load_project
from ice_halo_sim_tpu.core import mesh as jax_mesh
from ice_halo_sim_tpu.engine import checkpoint as jax_checkpoint
from ice_halo_sim_tpu_torch.config.loader import load_project
from ice_halo_sim_tpu_torch.core.mesh import (
    crystal_mesh,
    crystal_mesh_from_json,
    is_closed_tri_mesh,
    mesh_to_obj,
)
from ice_halo_sim_tpu_torch.engine.checkpoint import (
    load_checkpoint,
    load_jax_checkpoint,
    save_checkpoint,
)
from ice_halo_sim_tpu_torch.engine.simulator import Engine
from tests.test_persistence import CFG
from tests.test_torch_server import SUM_RTOL, assert_images_close

# Tier-1 runs six workers; keep each one to two torch threads.
torch.set_num_threads(2)

PYRAMID_DOC = {
    **CFG,
    "crystal": [
        {
            "id": 1,
            "type": "pyramid",
            "shape": {
                "upper_h": 0.5,
                "prism_h": 0.4,
                "lower_h": 0.5,
                "upper_indices": [1, 0, 1],
            },
            "axis": {"zenith": {"type": "uniform", "mean": 90, "std": 360}},
        }
    ],
}


@pytest.fixture()
def cross_env(monkeypatch):
    monkeypatch.setenv("IHT_MIN_EMIT_W", "0")
    monkeypatch.setenv("IHT_SLOT_CAP", "off")
    monkeypatch.setenv("IHT_STEPS_PER_DISPATCH", "1")


def test_checkpoint_resume_bit_exact(tmp_path):
    cfg = load_project(CFG)
    path = str(tmp_path / "ckpt.npz")

    a = Engine(cfg, seed=11, batch_size=1 << 14, device="cpu")
    a.run(n_batches=2)
    save_checkpoint(path, a)
    a.run(n_batches=2)

    b = load_checkpoint(path, device="cpu")
    assert b.batch_counter == 2
    assert b.stats.rays_traced == 2 * b.batch_size
    b.run(n_batches=2)

    for x, y in zip(a.accum, b.accum):
        assert torch.equal(x, y)
    assert a.drain_stats() == b.drain_stats()


def test_checkpoint_rejects_wrong_shape(tmp_path):
    cfg = load_project(CFG)
    eng = Engine(cfg, seed=1, batch_size=1 << 14, device="cpu")
    eng.run(n_batches=1)
    path = str(tmp_path / "ckpt.npz")
    save_checkpoint(path, eng)
    data = dict(np.load(path, allow_pickle=False))
    header = json.loads(str(data["header"]))
    header["project"]["render"][0]["resolution"] = [32, 32]
    data["header"] = json.dumps(header)
    np.savez_compressed(path, **data)
    with pytest.raises(ValueError):
        load_checkpoint(path, device="cpu")


def test_checkpoint_header_is_format_1(tmp_path):
    """The header carries the JAX package's keys and no other."""
    eng = Engine(load_project(CFG), seed=1, batch_size=1 << 12, device="cpu")
    eng.run(n_batches=1)
    path = str(tmp_path / "ckpt.npz")
    save_checkpoint(path, eng)
    with np.load(path) as data:
        header = json.loads(str(data["header"]))
        assert sorted(data.files) == ["accum_0", "accum_1", "header"]
    assert set(header) == {"format_version", "project", "seed", "batch_size", "geom_clock",
                           "batch_counter", "stats", "n_accum", "slot_cap"}
    assert header["format_version"] == 1 and header["n_accum"] == 2
    assert load_jax_checkpoint is load_checkpoint


def _assert_same_run(port_eng, jax_eng):
    ps, js = port_eng.drain_stats(), jax_eng.drain_stats()
    assert ps.rays_traced == js.rays_traced
    assert ps.ray_segments == js.ray_segments
    np.testing.assert_allclose(ps.landed_weight, js.landed_weight, rtol=SUM_RTOL)
    assert_images_close(port_eng.raw_xyz(0), np.asarray(jax_eng.raw_xyz(0)))


def test_port_file_resumes_in_jax(tmp_path, cross_env):
    path = str(tmp_path / "port.npz")
    t = Engine(load_project(CFG), seed=11, batch_size=1 << 14, device="cpu")
    t.run(n_batches=2)
    save_checkpoint(path, t)
    j = jax_checkpoint.load_checkpoint(path)
    assert j.batch_counter == 2 and j.stats.rays_traced == 2 * (1 << 14)
    for eng in (t, j):
        eng.run(n_batches=2)
    _assert_same_run(t, j)


def test_jax_file_resumes_in_port(tmp_path, cross_env):
    path = str(tmp_path / "jax.npz")
    j = jax_checkpoint.Engine(jax_load_project(CFG), seed=11, batch_size=1 << 14)
    j.run(n_batches=2)
    jax_checkpoint.save_checkpoint(path, j)
    t = load_checkpoint(path, device="cpu")
    assert t.batch_counter == 2 and t.stats.rays_traced == 2 * (1 << 14)
    for eng in (t, j):
        eng.run(n_batches=2)
    _assert_same_run(t, j)


def test_prism_mesh_is_closed():
    cfg = load_project(CFG)
    mesh = crystal_mesh(cfg.crystals[1].shape)
    assert mesh.vertices.shape == (12, 3)
    assert mesh.triangles.shape[0] == 20
    assert is_closed_tri_mesh(len(mesh.vertices), len(mesh.triangles))
    assert set(mesh.face_numbers.tolist()) == {1, 2, 3, 4, 5, 6, 7, 8}
    obj = mesh_to_obj(mesh)
    assert obj.count("\nv ") == 12
    assert obj.count("\nf ") == 20


def test_pyramid_mesh_closed():
    cfg = load_project(PYRAMID_DOC)
    mesh = crystal_mesh(cfg.crystals[1].shape)
    assert len(mesh.triangles) > 20
    assert is_closed_tri_mesh(len(mesh.vertices), len(mesh.triangles))
    assert (mesh.face_numbers >= 1).all()


@pytest.mark.parametrize("doc", [CFG, PYRAMID_DOC], ids=["prism", "pyramid"])
def test_mesh_matches_jax(doc):
    got = crystal_mesh(load_project(doc).crystals[1].shape)
    want = jax_mesh.crystal_mesh(jax_load_project(doc).crystals[1].shape)
    np.testing.assert_allclose(got.vertices, want.vertices, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got.triangles, want.triangles)
    np.testing.assert_array_equal(got.face_numbers, want.face_numbers)
    text = json.dumps(doc["crystal"][0])
    np.testing.assert_array_equal(crystal_mesh_from_json(text).triangles,
                                  jax_mesh.crystal_mesh_from_json(text).triangles)
