"""The port's Server (engine/server.py) on the CPU with the plain kernels:
twins of every test of tests/test_server.py (commit/reuse protocol,
lifecycle, result frames, display-time colour control), the JAX Server and
the port's on one config, frames bit-equal whatever the pump's grain, and a
pump that raises.

Against the JAX Server (CFG, seed 9, batch 1 << 14, four batches), with the
emit floor and slot cap off on the JAX side's XLA path (the port's kernel
path has neither; tests/test_torch_engine.py): traced segments and ray
count exact; landed weight rtol 1e-5; raw XYZ per pixel rtol 1e-4 with atol
1e-6 of the maximum; uint8 images within 1 level; ev_auto within 1e-4;
generation, reuse flag and lifecycle equal. The image sum is held at rtol
1e-5 over every pixel but the brightest (the sun's spot, 28% of the mass):
there some 25000 rays of equal weight add up per batch, which the JAX fold
sums in float32 in order (each addition rounds the same way, 1.3e-5 low per
batch) and the port's scan in float64; that pixel is held by the per-pixel
tolerance.

Every server is shut down in a ``with`` or ``finally``; every wait has a
timeout.
"""

import dataclasses
import time

import numpy as np
import pytest
import torch

from ice_halo_sim_tpu_torch.config.loader import load_project
from ice_halo_sim_tpu_torch.engine import server as server_mod
from ice_halo_sim_tpu_torch.engine.server import ResultFrame, Server, SimState
from ice_halo_sim_tpu_torch.engine.simulator import Engine
from tests.test_server import CFG, CFG_COLOR

# Tier-1 runs six workers; keep each one to two torch threads.
torch.set_num_threads(2)

SUM_RTOL = 1e-5
PIX_RTOL, PIX_ATOL_FRAC = 1e-4, 1e-6
EV_ATOL = 1e-4
WAIT = 120


@pytest.fixture(autouse=True)
def _dispatch(monkeypatch):
    # Four batches per dispatch: an infinite budget's pump holds the lock
    # for four batches, not 64.
    monkeypatch.setenv("IHT_STEPS_PER_DISPATCH", "4")


@pytest.fixture(scope="module")
def server():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("IHT_STEPS_PER_DISPATCH", "4")
        with Server(seed=9, batch_size=1 << 14, device="cpu") as s:
            yield s


def test_cuda_default_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from ice_halo_sim_tpu_torch.gui.app import serve

    with pytest.raises(RuntimeError, match="CUDA device"):
        Server()
    with pytest.raises(RuntimeError, match="CUDA device"):
        serve(CFG, port=0, block=False)


def test_commit_runs_to_idle(server):
    reused = server.commit(CFG)
    assert reused is False
    assert server.wait_idle(timeout=WAIT)
    assert server.state() == SimState.IDLE
    frame = server.acquire_frame()
    assert isinstance(frame, ResultFrame)
    assert frame.is_idle
    assert frame.ray_count >= CFG["scene"]["ray_num"]
    assert frame.images[0].shape == (64, 64, 3)
    assert frame.raw_xyz[0].shape == (64, 64, 3)
    assert float(frame.raw_xyz[0].sum()) > 0


def test_identical_commit_reuses(server):
    server.commit(CFG)
    server.wait_idle(timeout=WAIT)
    gen = server.generation()
    count = server.sim_ray_count()
    assert server.commit(CFG) is True
    assert server.generation() == gen
    assert server.sim_ray_count() == count


def test_appearance_only_commit_keeps_accumulation(server):
    server.commit(CFG)
    server.wait_idle(timeout=WAIT)
    before = server.acquire_frame()
    cfg2 = {**CFG, "render": [dict(CFG["render"][0], background=[0.3, 0.0, 0.0])]}
    assert server.commit(cfg2) is True
    after = server.acquire_frame()
    np.testing.assert_array_equal(before.raw_xyz[0], after.raw_xyz[0])
    assert not np.array_equal(before.images[0], after.images[0])


def test_layout_change_resets(server):
    server.commit(CFG)
    server.wait_idle(timeout=WAIT)
    gen = server.generation()
    cfg2 = {**CFG, "render": [dict(CFG["render"][0], resolution=[32, 32])]}
    assert server.commit(cfg2) is False
    assert server.generation() == gen + 1
    server.wait_idle(timeout=WAIT)
    frame = server.acquire_frame()
    assert frame.images[0].shape == (32, 32, 3)
    assert frame.generation == gen + 1


def test_infinite_budget_runs_until_stopped(server):
    cfg = {**CFG, "scene": {**CFG["scene"], "ray_num": -1}}
    server.commit(cfg)
    deadline = time.time() + 60
    first = server.sim_ray_count()
    while server.sim_ray_count() <= first and time.time() < deadline:
        time.sleep(0.1)
    assert server.sim_ray_count() > first
    assert server.state() == SimState.RUNNING
    server.stop()
    assert server.wait_idle(timeout=60)
    assert server.state() == SimState.IDLE
    assert server.acquire_frame().ray_count > 0


def test_typed_config_commit(server):
    cfg = load_project(CFG)
    server.commit(dataclasses.replace(cfg))
    server.wait_idle(timeout=WAIT)
    assert server.acquire_frame().ray_count >= cfg.scene.ray_num


def test_set_raypath_colors_display_time(server):
    from ice_halo_sim_tpu_torch.engine.server import ColorClassDisplay

    server.commit(CFG_COLOR)
    server.wait_idle(timeout=WAIT)
    before = server.acquire_frame()
    assert before.composites[0] is not None
    gen = server.generation()

    displays = [
        ColorClassDisplay(color=(0.1, 0.1, 1.0)),
        ColorClassDisplay(color=(1.0, 1.0, 0.1)),
    ]
    server.set_raypath_colors(displays, z_order=[1, 0], mode="painter")
    after = server.acquire_frame()
    assert server.generation() == gen
    np.testing.assert_array_equal(before.raw_xyz[0], after.raw_xyz[0])
    assert not np.array_equal(before.composites[0], after.composites[0])

    with pytest.raises(ValueError):
        server.set_raypath_colors(displays[:1])
    with pytest.raises(ValueError):
        server.set_raypath_colors(displays, z_order=[0, 0])
    with pytest.raises(ValueError):
        server.set_raypath_colors(displays, mode="nope")
    # The JSON form (the C API's entry) takes the same display update.
    server.set_raypath_colors_json('{"classes": [{"color": [1, 0, 0]}, {"color": [0, 1, 0]}]}')
    assert server.config().raypath_color.classes[0].color == (1.0, 0.0, 0.0)


def test_set_composite_exposure(server):
    server.commit(CFG_COLOR)
    server.wait_idle(timeout=WAIT)
    f0 = server.acquire_frame()
    server.set_composite_exposure(-6.0)
    f1 = server.acquire_frame()
    assert f1.composites[0].sum() < f0.composites[0].sum()
    np.testing.assert_array_equal(f0.raw_xyz[0], f1.raw_xyz[0])
    server.set_composite_exposure(0.0)


def test_color_class_signal(server):
    server.commit(CFG_COLOR)
    server.wait_idle(timeout=WAIT)
    flags = server.color_class_signal()
    assert len(flags) == 2
    assert flags[0] == 1


def test_color_overflow_info(server):
    server.commit(CFG_COLOR)
    info = server.color_overflow_info()
    assert info["component_overflow_count"] == 0
    assert info["component_capacity"] == 32


def test_color_overflow_degrades_not_fails():
    many = {
        **CFG,
        "scene": {**CFG["scene"], "ray_num": 4096},
        "raypath_color": {
            "classes": [
                {"name": f"c{i}", "match": [
                    {"layer": 0, "crystal": 1, "raypath": [3, 3 + (i % 5)]}],
                 "color": [1, 1, 1]}
                for i in range(33)
            ]
        },
    }
    with Server(seed=3, batch_size=1 << 12, device="cpu") as s:
        s.commit(many)
        assert s.color_overflow_info()["component_overflow_count"] == 1


def test_drain_status_and_lifecycle(server):
    server.commit(CFG)
    server.wait_idle(timeout=WAIT)
    ds = server.drain_status()
    assert ds.drained_epoch == ds.current_epoch
    lc = server.lifecycle()
    assert lc["state"] == "idle"
    assert lc["epoch"] == server.generation()


def test_frame_ev_auto_and_landed(server):
    server.commit(CFG)
    server.wait_idle(timeout=WAIT)
    f = server.acquire_frame()
    assert len(f.landed) == 1 and f.landed[0] > 0
    from ice_halo_sim_tpu_torch.engine import ev_auto as ev
    expect = ev.compute_ev_auto(ev.compute_p99_y(f.raw_xyz[0]), f.landed[0])
    assert f.ev_auto[0] == expect
    assert -6.0 <= f.ev_auto[0] <= 6.0


# ---------------------------------------------------------------------------
# Beyond the JAX tests
# ---------------------------------------------------------------------------


def assert_images_close(got, want):
    """Raw XYZ images [H, W, 3] of the two packages: per pixel rtol 1e-4
    with atol 1e-6 of the maximum; the sum rtol 1e-5 over every pixel but
    the brightest (the module docstring says why)."""
    a, b = np.asarray(want, np.float64), np.asarray(got, np.float64)
    np.testing.assert_allclose(b, a, rtol=PIX_RTOL, atol=PIX_ATOL_FRAC * np.abs(a).max())
    sun = np.unravel_index(np.argmax(a[..., 1]), a.shape[:2])
    rest = np.ones(a.shape[:2], bool)
    rest[sun] = False
    np.testing.assert_allclose(b[rest].sum(), a[rest].sum(), rtol=SUM_RTOL)


def _frame_of(server_cls, **kw):
    with server_cls(seed=9, batch_size=1 << 14, **kw) as s:
        reused = s.commit(CFG)
        assert s.wait_idle(timeout=300)
        return s.acquire_frame(), reused, s.lifecycle()


def test_frames_match_jax_server(monkeypatch):
    from ice_halo_sim_tpu.engine.server import Server as JServer

    monkeypatch.setenv("IHT_MIN_EMIT_W", "0")
    monkeypatch.setenv("IHT_SLOT_CAP", "off")
    jf, jreused, jlife = _frame_of(JServer)
    tf, treused, tlife = _frame_of(Server, device="cpu")
    assert (tf.generation, treused, tlife) == (jf.generation, jreused, jlife)
    assert tf.ray_count == jf.ray_count == CFG["scene"]["ray_num"]
    assert tf.stats.ray_segments == jf.stats.ray_segments
    np.testing.assert_allclose(tf.landed, jf.landed, rtol=SUM_RTOL)
    assert_images_close(tf.raw_xyz[0], jf.raw_xyz[0])
    assert np.abs(tf.images[0].astype(int) - jf.images[0].astype(int)).max() <= 1
    np.testing.assert_allclose(tf.ev_auto, jf.ev_auto, atol=EV_ATOL)


@pytest.mark.parametrize("spd", [1, 2, 64])
def test_frames_bit_equal_whatever_the_grain(monkeypatch, spd):
    """Four batches of budget: pumps of 1, 1, 1, 1 (spd 1), 1, 2, 1 (spd
    2) or 1, 3 (spd 64) batches; each frame equals an Engine that ran one
    batch at a time, bit for bit."""
    monkeypatch.setenv("IHT_STEPS_PER_DISPATCH", str(spd))
    frame = _frame_of(Server, device="cpu")[0]
    monkeypatch.setenv("IHT_STEPS_PER_DISPATCH", "1")
    twin = Engine(load_project(CFG), seed=9, batch_size=1 << 14, device="cpu")
    for _ in range(4):
        twin.run(n_batches=1)
    np.testing.assert_array_equal(frame.raw_xyz[0], twin.raw_xyz(0))
    assert frame.landed == tuple(float(x) for x in twin.accum[-1])
    assert frame.stats == twin.drain_stats()


def test_pump_exception_is_raised_not_hung(monkeypatch):
    class Boom(RuntimeError):
        pass

    class FailingEngine(Engine):
        def run(self, *a, **kw):
            if self._calibrated:
                raise Boom("a launch failed")
            return super().run(*a, **kw)

    monkeypatch.setattr(server_mod, "Engine", FailingEngine)
    s = Server(seed=9, batch_size=1 << 12, device="cpu")
    try:
        s.commit(CFG)
        t0 = time.time()
        with pytest.raises(RuntimeError) as exc:
            s.wait_idle(timeout=60)
        assert isinstance(exc.value.__cause__, Boom) and time.time() - t0 < 60
        assert s.state() == SimState.STOPPED
        assert s.lifecycle()["state"] == "stopped"
        with pytest.raises(RuntimeError):
            s.acquire_frame()
        with pytest.raises(RuntimeError):
            s.commit(CFG)
    finally:
        s.shutdown()
    assert not s._thread.is_alive()


def test_callers_are_not_starved_by_the_pump():
    """Eight threads read frames while an infinite budget pumps, with a
    short switch interval: each gets its frames (none starves behind the
    pump's back-to-back calls), the pump goes on between them, ray counts
    never go back, the generation stays."""
    import sys
    import threading

    cfg = {**CFG, "scene": {**CFG["scene"], "ray_num": -1}}
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    s = Server(seed=9, batch_size=1 << 12, device="cpu")
    got, errors = [[] for _ in range(8)], []

    def reader(out):
        try:
            t_end = time.time() + 1.5
            while time.time() < t_end:
                f = s.acquire_frame()
                out.append((f.ray_count, f.generation))
        except Exception as e:  # reported below
            errors.append(e)

    try:
        s.commit(cfg)
        threads = [threading.Thread(target=reader, args=(g,)) for g in got]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads) and not errors, errors
        for g in got:
            assert len(g) >= 2
            assert all(a[0] <= b[0] for a, b in zip(g, g[1:]))
            assert {gen for _, gen in g} == {1}
        # Nor does the pump starve behind the readers.
        assert len({n for g in got for n, _ in g}) >= 3
        assert s.sim_ray_count() > 0 and s.state() == SimState.RUNNING
        s.stop()
        assert s.wait_idle(timeout=60)
    finally:
        sys.setswitchinterval(old)
        s.shutdown()
