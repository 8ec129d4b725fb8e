"""Data parallel (parallel/sharding.py): the port's ShardedEngine on CPU
shards against the JAX package's sequential oracle, against JAX's own
ShardedEngine, and against the port's own Engines run one shard at a time.

The oracle is tests/test_sharding.py's: one JAX Engine on its XLA path,
calibrated by run(n_batches=1) and reset(), then ``_step`` at every counter
and every shard's 64-bit ray base. The JAX tests that run it are slow and
never run in tier-1; these run it at a small size.

Tolerances: rays exact; image sum rtol 1e-5; per pixel rtol 1e-4 with atol
1e-6 of the maximum; segments within FLIP_SEGMENTS and at most FLIP_PIXELS
pixels outside the per-pixel tolerance, each by at most one ray's weight
(tests/test_torch_engine.py's budget for a ray that flips in the last bit of
a float stage). One ray does flip here: at seed 9 the batch at ray base
8192 (shard 2 of batch 0 at four shards, shard 0 of batch 1 at two), ray
547 leaves other exit slots in JAX's jitted XLA trace than in the JAX
package's own eager trace of the same batch, which the port's equals slot
for slot (the jit fuses and rounds otherwise): one segment fewer. And over
these 16384 rays five exit rows land on a pixel edge that XLA and torch
round differently in the last bit, each moving its weight to the
neighbouring pixel: ten pixels, the same ten as the port's unsharded
Engine over the same eight batches against JAX (the bases of two batches
at four shards are an unsharded engine's first eight), so FLIP_PIXELS is
16 here. A
two-layer scene is held by tests/test_torch_multilayer.py's criterion
(its docstring says why a continuation is not held ray for ray), with its
TIE_RAYS allowance per shard-batch. Within the port a sharded run equals
its shards run one at a time and summed in shard order, bit for bit.
"""

import json
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ice_halo_sim_tpu.config.loader import load_project as jax_load_project
from ice_halo_sim_tpu.core import rng as jrng
from ice_halo_sim_tpu.engine.simulator import Engine as JEngine
from ice_halo_sim_tpu_torch import scenes
from ice_halo_sim_tpu_torch.config.loader import load_project
from ice_halo_sim_tpu_torch.engine import simulator
from ice_halo_sim_tpu_torch.engine.simulator import Engine
from ice_halo_sim_tpu_torch.parallel import ShardedEngine, make_mesh
from tests.conftest import clean_jax_env
from tests.test_e2e import SMOKE_CFG

# Tier-1 runs six workers; keep each one to two torch threads.
torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 2048
N_SHARDS = 4
N_BATCHES = 2
M32 = 0xFFFFFFFF
SUM_RTOL = 1e-5
PIX_RTOL, PIX_ATOL_FRAC = 1e-4, 1e-6
TIE_RAYS = 16           # tests/test_torch_multilayer.py's, here per shard-batch
FLIP_SEGMENTS = 8       # tests/test_torch_engine.py's flip budget
FLIP_PIXELS = 16        # two pixels per row on a pixel edge (docstring)
ENV = {"IHT_MIN_EMIT_W": "0", "IHT_SLOT_CAP": "off", "IHT_FOLD": "sort"}

# tests/test_sharding.py's two-layer scene (MS_SCRIPT).
MS_DOC = {
    "crystal": [
        {"id": 1, "type": "prism",
         "shape": {"height": {"type": "gauss", "mean": 1.0, "std": 0.2}},
         "axis": {
             "zenith": {"type": "gauss", "mean": 90.0, "std": 2.0},
             "azimuth": {"type": "uniform", "mean": 0.0, "std": 360.0},
             "roll": {"type": "uniform", "mean": 0.0, "std": 360.0},
         }},
    ],
    "filter": [],
    "scene": {
        "light_source": {
            "type": "sun", "altitude": 25.0, "azimuth": 0.0, "diameter": 0.5,
            "spectrum": [{"wavelength": 550.0, "weight": 1.0}],
        },
        "ray_num": 100000,
        "max_hits": 5,
        "scattering": [
            {"prob": 0.7, "entries": [{"crystal": 1, "proportion": 100.0}]},
            {"prob": 0.0, "entries": [{"crystal": 1, "proportion": 100.0}]},
        ],
    },
    "render": [
        {"id": 1, "lens": {"type": "fisheye_equal_area", "fov": 150.0},
         "resolution": [128, 64], "view": {"elevation": 30.0}, "visible": "full"},
    ],
}


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    for k, v in ENV.items():
        monkeypatch.setenv(k, v)
    monkeypatch.delenv("IHT_PALLAS_TRACE", raising=False)
    monkeypatch.delenv("IHT_STEPS_PER_DISPATCH", raising=False)


def _jax_oracle(doc, seed, n_shards=N_SHARDS, n_batches=N_BATCHES):
    """The sequential oracle: images, segments, dropped and landed weight."""
    with pytest.MonkeyPatch.context() as mp:
        for k, v in ENV.items():
            mp.setenv(k, v)
        mp.setenv("IHT_PALLAS_TRACE", "0")
        mp.setenv("IHT_STEPS_PER_DISPATCH", "1")     # spares the multi-step compile
        j = JEngine(jax_load_project(doc), seed=seed, batch_size=B, accum_method="sort")
        assert j.trace_path == "xla"
        j.run(n_batches=1)
        j.reset()
        accum = j.accum
        span = j.batch_size * (len(j.layers) + 1)
        segs, dropped = 0, 0.0
        for c in range(n_batches):
            for d in range(n_shards):
                base = (c * n_shards + d) * span
                out = j._step(accum, np.uint32(base & M32), np.uint32(c), j._compact_keep,
                              j._plan_version, None, np.uint32(base >> 32))
                accum = out[0]
                dropped += float(out[1])
                segs += int(out[2])
    imgs = [np.asarray(accum[r][:, :3]).reshape(p.height, p.width, 3)
            for r, p in enumerate(j.proj_plans)]
    return {"imgs": imgs, "segs": segs, "dropped": dropped,
            "landed": float(np.asarray(accum[-1], np.float64).sum()),
            "slot_cap": j._slot_cap, "caps": [l.cont_cap for l in j.layers]}


@pytest.fixture(scope="module")
def smoke_oracle():
    return _jax_oracle(SMOKE_CFG, seed=9)


def _assert_image_close(img, ref, eng):
    """Image sum, then per pixel with the flipped-ray budget: a flipped ray
    moves its rows, so no pixel is off by more than its weight through the
    largest basis value on every exit slot."""
    np.testing.assert_allclose(img.sum(), ref.sum(), rtol=SUM_RTOL)
    diff = np.abs(img - ref)
    off = (diff > PIX_RTOL * np.abs(ref) + PIX_ATOL_FRAC * float(np.abs(ref).max())).any(-1)
    assert int(off.sum()) <= FLIP_PIXELS, int(off.sum())
    one_ray = float(eng._w0_tbl.max()) * float(eng.basis_tbl.max()) * eng.max_hits
    assert float(diff[off].max(initial=0.0)) <= one_ray


def _bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.int32)


# --------------------------------------------------------------------------
# The shard's ray base
# --------------------------------------------------------------------------

@pytest.mark.parametrize("doc", [SMOKE_CFG, MS_DOC], ids=["one-layer", "two-layer"])
def test_shard_base_words_match_jax(doc):
    """Shard d of 4 at counter c: the low and high words of (c * 4 + d) *
    span equal JAX's c * 4 * span plus mul_u32_split(d, span) with its carry
    (parallel/sharding.py's step), exactly, from the python counter and from
    the device counter, below 2^32, across it and past it, and at a carry
    out of the low word (a span that does not divide 2^32: batch 3 * 1024).
    The graph key changes with the shard."""
    t = Engine(load_project(doc), seed=9, batch_size=3 * 1024, device="cpu")
    span = t.span
    assert span == 3 * 1024 * (len(t.layers) + 1)
    wrap = (1 << 32) // (N_SHARDS * span)
    counters = [0, 1, 5, wrap - 1, wrap, wrap + 1, 3 * wrap + 7, (1 << 31) // span]
    carried = 0
    keys = set()
    for d in range(N_SHARDS):
        t.shard = (d, N_SHARDS)
        keys.add(t._graph_key())
        off_lo, off_hi = jrng.mul_u32_split(jnp.uint32(d), span)
        for c in counters:
            base64 = c * N_SHARDS * span
            lo = (base64 + int(off_lo)) & M32
            carry = int(lo < (base64 & M32))
            carried += carry
            hi = ((base64 >> 32) + int(off_hi) + carry) & M32
            assert t.ray_base(c) == (c * N_SHARDS + d) * span
            assert tuple(int(x) for x in t._ray_base_words(c)) == (lo, hi)
            assert tuple(int(x) for x in t._ray_base_words(torch.tensor(c))) == (lo, hi)
    assert carried > 0 and len(keys) == N_SHARDS
    with pytest.raises(ValueError, match="shard index"):
        t.shard = (4, 4)


def test_shards_share_shapes_and_salt():
    """The counter is not sharded: every shard of a stochastic scene samples
    the same crystal shapes (the pool sampler's tables) and the same
    continuation shuffle at a counter, and traces its own rays."""
    se = ShardedEngine(load_project(scenes.POOL_CFG), ["cpu"] * 2, seed=3,
                       per_device_batch=B, calibrate=False)
    a, b = se.engines
    assert (a.shard, b.shard) == ((0, 2), (1, 2))
    for c in (0, 7):
        for x, y in zip(a._pool_tables(c), b._pool_tables(c)):
            assert torch.equal(x, y)
        assert a.ray_base(c) != b.ray_base(c)
    np.testing.assert_array_equal(simulator.shuffle_hash(64, 5, 7, "cpu").numpy(),
                                  simulator.shuffle_hash(64, 5, torch.tensor(7), "cpu").numpy())


# --------------------------------------------------------------------------
# Against the JAX sequential oracle
# --------------------------------------------------------------------------

@pytest.mark.parametrize("path", ["kernel", "general"])
def test_sharded_matches_jax_oracle(smoke_oracle, monkeypatch, path):
    """SMOKE_CFG over 4 CPU shards, 2 batches, on the port's trace kernel
    path (its plain version) and on its general path."""
    if path == "general":
        monkeypatch.setenv("IHT_PALLAS_TRACE", "0")
    se = ShardedEngine(load_project(SMOKE_CFG), make_mesh(["cpu"] * N_SHARDS), seed=9,
                       per_device_batch=B)
    assert se.engine.trace_path == ("plain-torch" if path == "kernel" else "plain-torch (general)")
    assert [e.shard for e in se.engines] == [(d, N_SHARDS) for d in range(N_SHARDS)]
    se.run(n_batches=N_BATCHES)
    assert se.rays_traced == N_BATCHES * N_SHARDS * B
    assert abs(se.ray_segments - smoke_oracle["segs"]) <= FLIP_SEGMENTS
    _assert_image_close(se.raw_xyz(0), smoke_oracle["imgs"][0], se.engine)
    np.testing.assert_allclose(float(se.drained_accum()[-1].double().sum()),
                               smoke_oracle["landed"], rtol=SUM_RTOL)
    img = se.snapshot()[0]
    assert img.shape == (256, 256, 3) and img.dtype == np.uint8 and img.max() > 0


def _box(img, k=8):
    h, w, c = img.shape
    return img.reshape(h // k, k, w // k, k, c).sum(axis=(1, 3))


def test_two_layer_sharded_matches_jax_oracle(monkeypatch):
    """tests/test_sharding.py's two-layer scene over 4 shards: the same
    calibration; rays exact; segments, landed and dropped weight within
    TIE_RAYS swapped rays per shard-batch; 8 x 8 box sums at rtol 1e-3."""
    ref = _jax_oracle(MS_DOC, seed=11)
    se = ShardedEngine(load_project(MS_DOC), ["cpu"] * N_SHARDS, seed=11, per_device_batch=B)
    assert se.engine.trace_path == "plain-torch (general)"
    assert se.engine._slot_cap == ref["slot_cap"]
    assert [l.cont_cap for l in se.engine.layers] == ref["caps"]
    se.run(n_batches=N_BATCHES)
    ties = TIE_RAYS * N_SHARDS * N_BATCHES
    w_ray = float(se.engine._w0_tbl.max())
    assert se.rays_traced == N_BATCHES * N_SHARDS * B
    assert abs(se.ray_segments - ref["segs"]) <= ties * se.engine.max_hits
    landed = float(se.drained_accum()[-1].double().sum())
    assert abs(landed - ref["landed"]) <= SUM_RTOL * ref["landed"] + ties * w_ray
    assert abs(se.dropped_weight - ref["dropped"]) <= 1e-6 * ref["landed"] + ties * w_ray
    a, b = _box(se.raw_xyz(0)), _box(ref["imgs"][0])
    np.testing.assert_allclose(a.sum(), b.sum(), rtol=1e-4)
    np.testing.assert_allclose(a, b, rtol=1e-3,
                               atol=ties * w_ray * float(se.engine.basis_tbl.max()))


# --------------------------------------------------------------------------
# Within the port: sharded = shards one at a time, summed in shard order
# --------------------------------------------------------------------------

CASES = {
    "kernel": (SMOKE_CFG, {}),
    "general": (SMOKE_CFG, {"IHT_PALLAS_TRACE": "0"}),
    "two-layer": (MS_DOC, {}),
    "pool": (scenes.POOL_CFG, {}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_equals_shard_engines(monkeypatch, case):
    """3 shards, 2 batches (the second run a dispatch of its own), against 3
    Engines calibrated the same way, each at shard (d, 3), summed in shard
    order: every render and the landed weights bit for bit, rays, segments
    and dropped weight exact."""
    doc, env = CASES[case]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    n = 3
    cfg = load_project(doc)
    se = ShardedEngine(cfg, ["cpu"] * n, seed=5, per_device_batch=B)
    se.run(n_batches=1)
    se.run(n_batches=1)
    acc, segs, dropped = None, 0, 0.0
    for d in range(n):
        e = Engine(cfg, seed=5, batch_size=B, device="cpu")
        e.run(n_batches=1)
        e.reset()
        e.shard = (d, n)
        e.run(n_batches=2)
        acc = [a.clone() for a in e.accum] if acc is None else [x.add_(a) for x, a in
                                                                 zip(acc, e.accum)]
        st = e.drain_stats()
        segs += st.ray_segments
        dropped += st.dropped_cont_weight
    assert se.rays_traced == 2 * n * B
    assert se.ray_segments == segs and se.dropped_weight == pytest.approx(dropped, rel=1e-12)
    drained = se.drained_accum()
    assert len(drained) == len(acc)
    for x, y in zip(drained, acc):
        assert torch.equal(x, y)
    for r, p in enumerate(se.engine.proj_plans):
        want = acc[r][:, :3].numpy().reshape(p.height, p.width, 3)
        assert np.array_equal(_bits(se.raw_xyz(r)), _bits(want))


# --------------------------------------------------------------------------
# Against JAX's own ShardedEngine
# --------------------------------------------------------------------------

JAX_SHARDED = textwrap.dedent(
    """
    import json, sys
    import numpy as np
    import jax
    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, sys.argv[1])
    from ice_halo_sim_tpu.config.loader import load_project
    from ice_halo_sim_tpu.parallel.sharding import ShardedEngine, make_mesh

    assert len(jax.devices()) == 2, jax.devices()
    with open(sys.argv[2]) as f:
        doc = json.load(f)
    se = ShardedEngine(load_project(doc), make_mesh(), seed=9, per_device_batch=2048,
                       accum_method="sort")
    se.run(n_batches=2)
    np.savez(sys.argv[3], xyz=se.raw_xyz(0), rays=se.rays_traced, segs=se.ray_segments)
    """
)


def test_matches_jax_sharded_engine(tmp_path):
    """JAX's ShardedEngine on 2 CPU devices (its XLA path, in a subprocess
    with its own device count) against the port's on 2 CPU shards."""
    doc_path, out = tmp_path / "scene.json", tmp_path / "jax.npz"
    doc_path.write_text(json.dumps(SMOKE_CFG))
    env = clean_jax_env(2)
    env.update(ENV)
    env.update({"IHT_TEST_REEXEC": "1", "IHT_PALLAS_TRACE": "0", "IHT_STEPS_PER_DISPATCH": "1"})
    proc = subprocess.run([sys.executable, "-c", JAX_SHARDED, ROOT, str(doc_path), str(out)],
                          capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert proc.returncode == 0, (proc.stdout[-2000:], proc.stderr[-3000:])
    ref = np.load(out)
    se = ShardedEngine(load_project(SMOKE_CFG), ["cpu"] * 2, seed=9, per_device_batch=B)
    se.run(n_batches=2)
    assert se.rays_traced == int(ref["rays"]) == 2 * 2 * B
    assert abs(se.ray_segments - int(ref["segs"])) <= FLIP_SEGMENTS
    _assert_image_close(se.raw_xyz(0), ref["xyz"], se.engine)


# --------------------------------------------------------------------------
# Refusals
# --------------------------------------------------------------------------

def test_diverged_calibration_raises(monkeypatch):
    """Shards whose calibrated plans differ (the second shard's slot cap
    pinned one lower after its calibration) raise instead of summing
    images of two plans."""
    monkeypatch.setenv("IHT_PALLAS_TRACE", "0")
    monkeypatch.setenv("IHT_SLOT_CAP", "auto")
    calibrated = []
    orig = Engine._maybe_calibrate

    def skewed(self, *a, **kw):
        orig(self, *a, **kw)
        calibrated.append(self)
        if len(calibrated) == 2:
            self._slot_cap = max(1, self._slot_cap - 1)

    monkeypatch.setattr(Engine, "_maybe_calibrate", skewed)
    with pytest.raises(RuntimeError, match="calibrated plans diverged"):
        ShardedEngine(load_project(SMOKE_CFG), ["cpu"] * 2, seed=9, per_device_batch=B)
    assert len(calibrated) == 2
    a, b = (e._calibration_digest() for e in calibrated)
    assert a[0] == b[0] + 1 and (a[1:] == b[1:]).all()


def test_make_mesh_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ShardedEngine(load_project(SMOKE_CFG), seed=9, per_device_batch=B)


def test_make_mesh_takes_devices_listed_twice():
    mesh = make_mesh(["cpu"] * 2)
    assert mesh == [torch.device("cpu")] * 2
    with pytest.raises(ValueError, match="no devices"):
        make_mesh([])
    se = ShardedEngine(load_project(SMOKE_CFG), mesh, seed=9, per_device_batch=B,
                       calibrate=False)
    assert se.n_dev == 2 and se.span == 2 * B and se.engine is se.engines[0]
    assert se.engine._calibrated and se.engine._compact_keep is None


# --------------------------------------------------------------------------
# The launch order: batch i on every shard before batch i + 1
# --------------------------------------------------------------------------

K_DISPATCH = 4
SEED_ORDER = 4          # shard 0's batch 1 holds the most live rows (asserted)


def _lives_of_next(eng, n):
    """Live fold rows of render 0 in the next n batches, run eagerly with
    the host's choice."""
    lives = []
    for _ in range(n):
        before = eng._dev.live.clone()
        eng._dev.counter.fill_(eng.batch_counter)
        eng._batch(host_choice=True)
        eng.batch_counter += 1
        lives.append(int((eng._dev.live - before)[0]))
    return lives


def test_interleaved_launch_with_an_overflow_mid_dispatch(monkeypatch):
    """Two CPU shards, one dispatch of K_DISPATCH batches, keep forced
    below the live rows of exactly one batch, batch 1 of shard 0 (in the
    middle of the dispatch): before the first read the batches launch in
    the order (shard 0, batch 0), (shard 1, batch 0), (shard 0, batch 1),
    ... (``Engine._step`` instrumented); only shard 0 replays its overflow,
    inside its own read; every render, the landed weights, rays, segments
    and dropped weight equal two shard Engines given the same keep and run
    one at a time, bit for bit."""
    monkeypatch.setenv("IHT_STEPS_PER_DISPATCH", str(K_DISPATCH))
    cfg = load_project(scenes.BENCH_CFG)
    lives = []
    for d in range(2):
        probe = Engine(cfg, seed=SEED_ORDER, batch_size=B, device="cpu")
        probe.run(n_batches=1)
        probe.reset()
        probe.shard = (d, 2)
        lives.append(_lives_of_next(probe, K_DISPATCH))
    lives = np.array(lives)
    assert np.unravel_index(lives.argmax(), lives.shape) == (0, 1)
    assert (lives == lives.max()).sum() == 1
    keep = (int(np.sort(lives.ravel())[-2]),)

    se = ShardedEngine(cfg, ["cpu"] * 2, seed=SEED_ORDER, per_device_batch=B)
    for e in se.engines:
        e._compact_keep = keep
    events = []
    step, read = Engine._step, Engine._read

    def logged_step(self, graph):
        events.append(("step", self.shard[0], int(self._dev.counter)))
        step(self, graph)

    def logged_read(self):
        events.append(("read", self.shard[0]))
        read(self)

    monkeypatch.setattr(Engine, "_step", logged_step)
    monkeypatch.setattr(Engine, "_read", logged_read)
    se.run(n_batches=K_DISPATCH)
    monkeypatch.setattr(Engine, "_step", step)
    monkeypatch.setattr(Engine, "_read", read)
    first_read = events.index(("read", 0))
    assert events[:first_read] == [("step", d, i) for i in range(K_DISPATCH) for d in range(2)]
    assert [e for e in events[first_read:] if e[0] == "read"] == [("read", 0), ("read", 0),
                                                                  ("read", 1)]
    assert [e.overflow_replays for e in se.engines] == [1, 0]

    acc, segs, dropped = None, 0, 0.0
    for d in range(2):
        e = Engine(cfg, seed=SEED_ORDER, batch_size=B, device="cpu")
        e.run(n_batches=1)
        e.reset()
        e.shard = (d, 2)
        e._compact_keep = keep
        e.run(n_batches=K_DISPATCH)
        assert e.overflow_replays == (1 if d == 0 else 0)
        acc = [a.clone() for a in e.accum] if acc is None else [x.add_(a) for x, a in
                                                                 zip(acc, e.accum)]
        st = e.drain_stats()
        segs += st.ray_segments
        dropped += st.dropped_cont_weight
    assert se.rays_traced == 2 * K_DISPATCH * B
    assert se.ray_segments == segs and se.dropped_weight == pytest.approx(dropped, rel=1e-12)
    for x, y in zip(se.drained_accum(), acc):
        assert torch.equal(x, y)
    p = se.engine.proj_plans[0]
    assert np.array_equal(_bits(se.raw_xyz(0)),
                          _bits(acc[0][:, :3].numpy().reshape(p.height, p.width, 3)))
