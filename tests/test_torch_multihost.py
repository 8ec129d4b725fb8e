"""Several processes (parallel/distributed.py): two local processes of two
CPU shards each, joined by gloo on a localhost port, are one four-shard
run. The twin of tests/test_multihost.py, which runs the JAX package's
multi-controller path the same way (and is slow, so tier-1 never runs it).

Held: the two ranks drain bit-equal images; the image equals the
single-process four-shard ShardedEngine's to rtol 1e-6 per pixel (the
all-reduce adds the two ranks' local sums, the single process sums the four
shards in order); the total matches the JAX sequential oracle to rel 1e-5
(tests/test_multihost.py's bound). A rank whose calibrated plan differs
makes both ranks fail with the RuntimeError, not hang.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from ice_halo_sim_tpu_torch.config.loader import load_project
from ice_halo_sim_tpu_torch.parallel import ShardedEngine
from tests.test_e2e import SMOKE_CFG
from tests.test_torch_sharding import _jax_oracle

# Tier-1 runs six workers; keep each one to two torch threads.
torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 2048
TIMEOUT = 240

WORKER = textwrap.dedent(
    """
    import json, sys
    import numpy as np
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    rank, port, scene, out = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
    from ice_halo_sim_tpu_torch.config.loader import load_project
    from ice_halo_sim_tpu_torch.parallel.distributed import MultiHostEngine, init_multi_host

    init_multi_host(f"localhost:{port}", 2, rank, backend="gloo")
    try:
        with open(scene) as f:
            cfg = load_project(json.load(f))
        eng = MultiHostEngine(cfg, seed=13, per_device_batch=2048, mesh=["cpu"] * 2)
        assert (eng.process_index, eng.process_count, eng.n_dev) == (rank, 2, 4)
        assert [e.shard for e in eng.engines] == [(2 * rank, 4), (2 * rank + 1, 4)]
        eng.run(n_batches=2)
        np.savez(out, xyz=eng.raw_xyz(0), rays=eng.rays_traced, segs=eng.ray_segments,
                 landed=eng.drained_accum()[-1].numpy())
    finally:
        dist.destroy_process_group()
    """
)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _two_ranks(tmp_path, env_of_rank):
    """Run the worker as ranks 0 and 1; returns [(returncode, stderr, npz)]."""
    scene = tmp_path / "scene.json"
    scene.write_text(json.dumps(SMOKE_CFG))
    port = str(_free_port())
    procs, outs = [], []
    for rank in range(2):
        env = dict(os.environ, PYTHONPATH=ROOT, IHT_MIN_EMIT_W="0", IHT_FOLD="sort")
        env.update(env_of_rank(rank))
        outs.append(tmp_path / f"rank{rank}.npz")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", WORKER, str(rank), port, str(scene), str(outs[-1])],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=ROOT))
    results = []
    try:
        for p, out in zip(procs, outs):
            _, err = p.communicate(timeout=TIMEOUT)
            results.append((p.returncode, err, out))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return results


def test_two_processes_equal_one_run(tmp_path, monkeypatch):
    monkeypatch.setenv("IHT_MIN_EMIT_W", "0")
    monkeypatch.setenv("IHT_SLOT_CAP", "off")
    monkeypatch.setenv("IHT_FOLD", "sort")
    monkeypatch.delenv("IHT_PALLAS_TRACE", raising=False)
    results = _two_ranks(tmp_path, lambda rank: {"IHT_SLOT_CAP": "off"})
    for rc, err, _ in results:
        assert rc == 0, err[-3000:]
    a, b = (np.load(out) for _, _, out in results)
    assert np.array_equal(a["xyz"].view(np.int32), b["xyz"].view(np.int32))
    assert np.array_equal(a["landed"].view(np.int32), b["landed"].view(np.int32))
    assert int(a["rays"]) == int(b["rays"]) == 2 * 4 * B
    assert int(a["segs"]) == int(b["segs"])

    se = ShardedEngine(load_project(SMOKE_CFG), ["cpu"] * 4, seed=13, per_device_batch=B)
    se.run(n_batches=2)
    one = se.raw_xyz(0)
    assert se.ray_segments == int(a["segs"]) and se.rays_traced == int(a["rays"])
    np.testing.assert_allclose(a["xyz"], one, rtol=1e-6)
    ref = _jax_oracle(SMOKE_CFG, seed=13)
    assert float(a["xyz"].sum()) == pytest.approx(float(ref["imgs"][0].sum()), rel=1e-5)


def test_diverged_calibration_fails_every_rank(tmp_path):
    """Rank 1 pins another slot cap (the general path, where it counts):
    both ranks exit non-zero with the RuntimeError within the timeout."""
    results = _two_ranks(tmp_path, lambda rank: {
        "IHT_PALLAS_TRACE": "0", "IHT_SLOT_CAP": "off" if rank == 0 else "2"})
    for rc, err, out in results:
        assert rc != 0 and "calibrated plans diverged" in err, err[-3000:]
        assert not out.exists()
