"""The port's host loop: several batches per dispatch, calibration from the
first dispatch's mean counts, the device-resident batch counter, and the
in-step overflow choice made without a host read (a dispatch that
overflowed is replayed up to the batch at fault, which runs eagerly).

Against the JAX engine at IHT_STEPS_PER_DISPATCH=4: BENCH_CFG, seed 7,
batch 4096, two dispatches of four batches (the first calibrates), through
the port's trace kernel path and through its general path, against one JAX
run of its XLA path (emit floor and slot cap off, as
scripts/make_torch_port_ref.py runs it). Tolerances are
tests/test_torch_engine.py's: segments and rays exact, landed weight and
image sum rtol 1e-5, per pixel rtol 1e-4 with atol 1e-6 of the maximum,
with tests/test_torch_general.py's allowance of FLIP_PIXELS pixels outside
it, each by at most one ray's weight: over eight batches a direction on a
pixel edge, rounded in its last bit differently by XLA and torch, moves one
ray's row to the neighbouring pixel (two such rays in this run, on both
port paths alike). Everything inside the port is held bit for bit.
"""

import numpy as np
import pytest
import torch

from bench import BENCH_CFG
from ice_halo_sim_tpu.config.loader import load_project as jax_load_project
from ice_halo_sim_tpu.engine.simulator import Engine as JEngine
from ice_halo_sim_tpu_torch.config.loader import load_project
from ice_halo_sim_tpu_torch.core import accum, block_ops
from ice_halo_sim_tpu_torch.engine.simulator import Engine
from ice_halo_sim_tpu_torch.kernels import kernel_set

# Tier-1 runs six workers; keep each one to two torch threads.
torch.set_num_threads(2)

B = 4096
K_STEPS = 4
SUM_RTOL = 1e-5
PIX_RTOL, PIX_ATOL_FRAC = 1e-4, 1e-6
FLIP_PIXELS = 8
ENV = {"IHT_MIN_EMIT_W": "0", "IHT_SLOT_CAP": "off", "IHT_STEPS_PER_DISPATCH": str(K_STEPS)}


@pytest.fixture(scope="module")
def jax_run():
    with pytest.MonkeyPatch.context() as mp:
        for k, v in ENV.items():
            mp.setenv(k, v)
        mp.setenv("IHT_PALLAS_TRACE", "0")
        j = JEngine(jax_load_project(BENCH_CFG), seed=7, batch_size=B, accum_method="sort")
        assert j.trace_path == "xla" and j.steps_per_dispatch == K_STEPS
        j.run(n_batches=K_STEPS)
        keep = j._compact_keep
        j.run(n_batches=K_STEPS)
        st = j.drain_stats()
    return j.raw_xyz(0), st, keep


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    for k, v in ENV.items():
        monkeypatch.setenv(k, v)
    monkeypatch.delenv("IHT_PALLAS_TRACE", raising=False)


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("path", ["kernel", "general"])
def test_dispatches_match_jax(jax_run, monkeypatch, path):
    """Two dispatches of four: calibration after the first from its mean
    live rows (the same keep as the JAX engine's), one host read for the
    calibration and one per steady dispatch, none per batch."""
    ref_img, ref_st, ref_keep = jax_run
    if path == "general":
        monkeypatch.setenv("IHT_PALLAS_TRACE", "0")
    t = Engine(load_project(BENCH_CFG), seed=7, batch_size=B, device="cpu")
    assert t.steps_per_dispatch == K_STEPS and t.graph_mode == "eager (graphs off)"
    assert t.trace_path == ("plain-torch" if path == "kernel" else "plain-torch (general)")
    t.run(n_batches=K_STEPS)
    assert t.batch_counter == K_STEPS and t._compact_keep == ref_keep is not None
    assert t.host_syncs == 1                      # the calibration (nothing could overflow)
    t.run(n_batches=K_STEPS)
    assert t.host_syncs == 2 and t.overflow_replays == 0
    st = t.drain_stats()
    assert (st.rays_traced, st.ray_segments) == (ref_st.rays_traced, ref_st.ray_segments)
    np.testing.assert_allclose(st.landed_weight, ref_st.landed_weight, rtol=SUM_RTOL)
    img = t.raw_xyz(0)
    np.testing.assert_allclose(img.sum(), ref_img.sum(), rtol=SUM_RTOL)
    tol = PIX_RTOL * np.abs(ref_img) + PIX_ATOL_FRAC * float(np.abs(ref_img).max())
    off = np.abs(img - ref_img) > tol
    assert int(off.any(-1).sum()) <= FLIP_PIXELS
    # A flipped ray moves its rows to a neighbouring pixel: no more than one
    # ray's weight through the largest basis value.
    one_ray = float(t._w0_tbl.max())
    assert np.abs(img - ref_img)[off].max(initial=0.0) <= one_ray * float(t.basis_tbl.max())


def test_dispatch_size_does_not_change_the_image(monkeypatch):
    """With the first dispatch of one batch, any later dispatch size gives
    the same bits: 1 + 4 + 4 batches at IHT_STEPS_PER_DISPATCH=4 against
    1 + 8 at 1 (and the tail rule: a 3.5-batch budget runs 3 then the tail
    alone)."""
    out = []
    for spd, runs in (("4", (1, 4, 4)), ("1", (1, 8))):
        monkeypatch.setenv("IHT_STEPS_PER_DISPATCH", spd)
        t = Engine(load_project(BENCH_CFG), seed=7, batch_size=B, device="cpu")
        for n in runs:
            t.run(n_batches=n)
        st = t.drain_stats()
        out.append((t.raw_xyz(0), st, t.host_syncs))
    (a, sa, ha), (b, sb, hb) = out
    assert np.array_equal(_bits(a), _bits(b)) and sa == sb
    assert (ha, hb) == (1 + 2, 1 + 8)
    monkeypatch.setenv("IHT_STEPS_PER_DISPATCH", "4")
    t = Engine(load_project(BENCH_CFG), seed=7, batch_size=B, device="cpu")
    t.run(total_rays=3 * B + B // 2)
    assert t.batch_counter == 4 and t.stats.rays_traced == 3 * B + B // 2


def test_device_counter_streams_match_python_counter(monkeypatch):
    """A batch traced from the device counter tensor is the batch traced
    from the python int, bit for bit, past the 2^32 ray-index wrap: the
    general path's rows, landed and dropped weight and continuation (two
    layers), and the pool sampler's tables."""
    import copy

    from ice_halo_sim_tpu_torch import scenes

    monkeypatch.setenv("IHT_PALLAS_TRACE", "0")
    doc = copy.deepcopy(scenes.MS_CFG)
    t = Engine(load_project(doc), seed=7, batch_size=1024, device="cpu", geom_clock=128)
    c = (1 << 32) // t.ray_base(1) + 1
    assert (t.ray_base(c) >> 32) == 1
    a = t._trace_batch_impl(c)
    b = t._trace_batch_impl(torch.tensor(c))
    for r in range(len(t.proj_plans)):
        for x, y in zip(a[0][r].flat(), b[0][r].flat()):
            assert (x is None and y is None) or torch.equal(x, y)
    for x, y in zip(a[1:6], b[1:6]):
        for p, q in zip(x if isinstance(x, list) else [x], y if isinstance(y, list) else [y]):
            assert torch.equal(p, q)
    for x, y in zip(t._sample_layer_pool(c, li=1), t._sample_layer_pool(torch.tensor(c), li=1)):
        assert torch.equal(x, y)


def _lives_of_next(eng, n):
    """Live fold rows per render of the next n batches, run eagerly with the
    host's choice (the reference loop: a per-batch lax.cond)."""
    lives = []
    for _ in range(n):
        before = eng._dev.live.clone()
        eng._dev.counter.fill_(eng.batch_counter)
        eng._batch(host_choice=True)
        eng.batch_counter += 1
        lives.append((eng._dev.live - before).tolist())
    return np.array(lives)


@pytest.mark.parametrize("path", ["kernel", "general"])
def test_overflow_replay_is_the_per_batch_choice(monkeypatch, path):
    """keep forced between the live rows of a dispatch's batches, so that
    exactly one batch (the one with the most live rows) overflows: the
    dispatch replays up to it and runs it on the full fold, and images and
    stats equal the per-batch loop's bit for bit; one replay, and host
    reads: the dispatch's two (one per pass) and the eager batch's one."""
    if path == "general":
        monkeypatch.setenv("IHT_PALLAS_TRACE", "0")
    engines = []
    for _ in range(3):
        e = Engine(load_project(BENCH_CFG), seed=7, batch_size=B, device="cpu")
        e.run(n_batches=1)
        engines.append(e)
    probe, ref, eng = engines
    lives = _lives_of_next(probe, K_STEPS)[:, 0]
    j = int(np.argmax(lives))
    assert (lives < lives[j]).sum() == K_STEPS - 1
    keep = (int(np.delete(lives, j).max()),)
    ref._compact_keep = eng._compact_keep = keep
    _lives_of_next(ref, K_STEPS)
    syncs = eng.host_syncs
    eng.run(n_batches=K_STEPS)
    assert eng.overflow_replays == 1 and eng.batch_counter == ref.batch_counter
    # A pass's read, the eager batch's read, and a second pass's read when
    # batches follow the one at fault.
    assert eng.host_syncs == syncs + 2 + (j < K_STEPS - 1)
    assert np.array_equal(_bits(eng.raw_xyz(0)), _bits(ref.raw_xyz(0)))
    assert np.array_equal(_bits(eng.accum[-1]), _bits(ref.accum[-1]))
    se, sr = eng.drain_stats(), ref.drain_stats()
    assert (se.ray_segments, se.landed_weight, se.dropped_cont_weight) == (
        sr.ray_segments, sr.landed_weight, sr.dropped_cont_weight)


def test_graphs_argument():
    cfg = load_project(BENCH_CFG)
    with pytest.raises(ValueError, match="graphs=True needs"):
        Engine(cfg, seed=7, batch_size=B, device="cpu", graphs=True)
    assert Engine(cfg, seed=7, batch_size=B, device="cpu").graphs is False


# --------------------------------------------------------------------------
# The compacted branches with more live rows than they keep: each writes its
# output and nothing past it (the kernels' forms are in test_torch_cuda.py).
# --------------------------------------------------------------------------

def _rows(n, live_frac, seed):
    g = np.random.default_rng(seed)
    live = g.random(n) < live_frac
    key = np.where(live, g.integers(0, 1 << 20, n), 0xFFFFFFFF).astype(np.uint32)
    w = np.where(live, g.random(n) + 0.5, 0.0).astype(np.float32)
    return torch.as_tensor(key.view(np.int32)), torch.as_tensor(w), int(live.sum())


def test_compact_rows_overflow_keeps_its_prefix():
    """compact_valid (compact_rows) with live > keep: keep rows out, the
    first `keep` live rows in order; the count says how many were live."""
    ks = kernel_set("plain")
    key, w, n_live = _rows(5 * 4096 + 100, 0.5, 1)
    keep = 4096
    assert n_live > keep
    (k2, w2), n = accum.compact_valid(key, [w], keep, ks)
    assert int(n) == n_live and k2.shape == (keep,) and w2.shape == (keep,)
    live = key != -1
    assert torch.equal(k2, key[live][:keep]) and torch.equal(w2, w[live][:keep])


def test_scatter_marker_tail_overflow_stays_in_bounds():
    """The kernel path's compacted branch (K3 with the marker tail) with
    live > keep: out_total rows out, the markers intact at [keep, keep + P),
    the live rows before them the first `keep` in block order."""
    ks = kernel_set("plain")
    G, blk, P, shift = 6, 1024, 3000, 7
    key, w, _ = _rows(G * blk, 0.6, 2)
    pk, pw, counts = block_ops.pack_rows_plain(key, w, blk)
    keep = int(counts.sum()) // 2
    out_total = -(-(keep + P) // 4096) * 4096
    ck, cw = ks.scatter_blocks_multi(
        [pk.view(G, blk), pw.view(G, blk)], accum._exclusive_starts(counts), out_total, blk,
        marker_tail=(keep, P, shift, 127))
    assert ck.shape == (out_total,) and cw.shape == (out_total,)
    live = pk.view(G, blk) != -1
    assert torch.equal(ck[:keep], pk.view(G, blk)[live][:keep])
    marks = (torch.arange(P, dtype=torch.int64) << shift) | 127
    assert torch.equal(ck[keep:keep + P].to(torch.int64) & 0xFFFFFFFF, marks)
    assert torch.equal(cw[:keep], pw.view(G, blk)[live][:keep])


def test_continuation_overflow_without_host_choice_stays_in_bounds():
    """compact_by_key (the continuation's block compaction) with live > cap:
    cap rows out, the first cap packed rows; the engine's continuation
    without the host's choice returns exactly its lanes and the live count
    that flags the overflow."""
    ks = kernel_set("plain")
    key, w, n_live = _rows(4 * 4096, 0.7, 3)
    cap = 4096
    outs, n = accum.compact_by_key(key, [w], cap, ks)
    assert int(n) == n_live > cap and all(o.shape == (cap,) for o in outs)
    full, _ = accum.compact_by_key(key, [w], 4 * 4096, ks)
    assert all(torch.equal(o, f[:cap]) for o, f in zip(outs, full))
    t = Engine(load_project(BENCH_CFG), seed=7, batch_size=B, device="cpu")
    cols = [w, torch.arange(w.shape[0], dtype=torch.int32)]
    picked, live = t._continuation(w, cols, cap, 0x55, 4, host_choice=False)
    assert int(live) == n_live and all(p.shape == (cap,) for p in picked)
    assert t.host_syncs == 0


@pytest.mark.parametrize("path", ["sort", "kernel"])
def test_graph_mode_and_key(monkeypatch, path):
    """The calibrating dispatch runs eagerly on either trace path (its plan
    goes at calibration); once calibrated the batch is captured. On the
    trace kernel's path the graph key covers the calibrated keep, which the
    captured compaction and marker tail are built for."""
    if path == "sort":
        monkeypatch.setenv("IHT_PALLAS_TRACE", "0")
    t = Engine(load_project(BENCH_CFG), seed=7, batch_size=B, device="cpu")
    assert (t._trace_plan is not None) == (path == "kernel") and t.fold_kind == "sort"
    t.graphs = True          # the mode's words only: nothing is captured on the CPU
    assert t.graph_mode == "eager (the calibrating dispatch; captured once calibrated)"
    t.run(n_batches=1)
    assert t.graph_mode == "cuda graph"
    if path == "sort":
        return
    key = t._graph_key()
    keep = t._compact_keep
    assert keep is not None
    t._compact_keep = (keep[0] + 4096,)
    assert t._graph_key() != key
    t._compact_keep = keep
    assert t._graph_key() == key
