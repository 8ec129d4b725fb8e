"""The general path's layer trace: KL (csrc/trace_layer.cu, the render mode
of ``core/trace_soa.trace_layer_soa`` in one launch), its emit mode (the
trace and ``trace_soa.layer_epilogue`` in one launch) and their wiring.

On the CPU: which function each kernel set traces with, the wrappers'
refusals, that every call the engine makes on the general path's scenes
meets the wrapper's contract (so the card's engine never meets a refusal),
which epilogue each layer takes and why, and that ``layer_epilogue`` gives
the rows of the epilogue the engine inlined before it (a frozen copy here).
On the card (marker ``cuda``): KL against ``trace_layer_soa`` and the emit
mode against its plain twin on the calls the engine makes, every output bit
for bit.

    python -m pytest tests/test_torch_trace_layer.py -q -p no:cacheprovider
    python -m pytest -m cuda tests/test_torch_trace_layer.py -q --noconftest   # on the card
"""

import copy
import json
import os

import numpy as np
import pytest
import torch

from ice_halo_sim_tpu_torch.config.loader import load_project
from ice_halo_sim_tpu_torch.core import projection, rng, trace_soa
from ice_halo_sim_tpu_torch.core.bits import F32, I64, MASK32
from ice_halo_sim_tpu_torch.engine.simulator import Engine
from ice_halo_sim_tpu_torch.kernels import build, kernel_set
from ice_halo_sim_tpu_torch.scenes import (BENCH_CFG, COLOR_CFG, MS_CFG, MULTI_CFG, POOL_CFG,
                                           PYRAMID3_CFG)
from ice_halo_sim_tpu_torch.utils import profiling

# Tier-1 runs six workers; keep each one to two torch threads.
torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL_BATCH = 229376     # light_two_layer.r512's batch


def _two_layer_doc():
    with open(os.path.join(ROOT, "portbench", "configs", "light_two_layer_ms.json")) as f:
        return json.load(f)["document"]


def _last_gate_doc():
    """BENCH_CFG's one layer at prob 0.3: a last layer whose gate drops what
    would continue (the general path, with IHT_PALLAS_TRACE=0)."""
    doc = copy.deepcopy(BENCH_CFG)
    doc["scene"]["scattering"][0]["prob"] = 0.3
    return doc


# Scenes of the general path: (document, IHT_PALLAS_TRACE, what it exercises).
SCENES = {
    "two_layer": (_two_layer_doc(), None),      # one shared shape; layer 2's tail lanes
    "ms": (MS_CFG, None),                       # several settings a layer, filters
    "pool": (POOL_CFG, "0"),                    # K > 1 sampled shapes (pool rows per lane)
    "color": (COLOR_CFG, None),                 # colour classes
    "pyramid": (PYRAMID3_CFG, None),            # 20 face slots, three layers
    "multi": (MULTI_CFG, None),                 # a gate that both continues and emits
    "last_gate": (_last_gate_doc(), "0"),       # a last layer with prob > 0
}


def _recorded_calls(monkeypatch, name, batch, device, check=False):
    """Run one batch of scene `name` with the plain kernel set, recording
    every call of ``ks.trace_layer`` (its arguments); with `check`, each
    call first goes through KL's input check."""
    doc, pallas = SCENES[name]
    monkeypatch.setenv("IHT_STEPS_PER_DISPATCH", "1")
    for knob in ("IHT_PALLAS_TRACE", "IHT_SLOT_CAP", "IHT_MIN_EMIT_W"):
        monkeypatch.delenv(knob, raising=False)
    if pallas is not None:
        monkeypatch.setenv("IHT_PALLAS_TRACE", pallas)
    eng = Engine(load_project(copy.deepcopy(doc)), seed=3000000019, batch_size=batch,
                 device=device, kernels="plain")
    assert eng.trace_path == "plain-torch (general)"
    calls = []

    def record(*args, **kw):
        if check:
            trace_soa.check_layer_inputs(*args[:8])
        calls.append((args, kw))
        return trace_soa.trace_layer_soa(*args, **kw)

    eng.ks = eng.ks._replace(trace_layer=record)
    eng.run(n_batches=1)
    assert len(calls) >= len(eng.layers)
    return eng, calls


@pytest.mark.parametrize("kind", ["cuda", "plain"])
def test_kernel_sets_expose_trace_layer(kind):
    """The "cuda" set traces a layer with KL's wrapper, the "plain" set with
    the plain function (which the gradient path also calls)."""
    want = {"cuda": trace_soa.trace_layer_cuda, "plain": trace_soa.trace_layer_soa}[kind]
    assert kernel_set(kind).trace_layer is want


def _lane_args(B=256, nf=8):
    """A valid call's arguments on the CPU: B lanes, one shape of nf face
    slots (4 nf entry triangles)."""
    g = torch.Generator().manual_seed(5)
    T = 4 * nf
    f = lambda *s: torch.rand(*s, generator=g)  # noqa: E731
    pool = trace_soa.GeomPool(
        plane_n=f(1, nf, 3), plane_d=f(1, nf), face_present=torch.ones(1, nf, dtype=torch.bool),
        face_number=torch.arange(nf, dtype=torch.int32)[None], tri_v0=f(1, T, 3),
        tri_e1=f(1, T, 3), tri_e2=f(1, T, 3), tri_cross_half=f(1, T, 3),
        tri_face=torch.zeros(1, T, dtype=torch.int32))
    idx = torch.arange(B, dtype=torch.int64)
    return [idx ^ 0x5A5A, idx, tuple(f(B) for _ in range(3)), f(B),
            tuple(f(B) for _ in range(9)), pool, f(B) + 1.0, 7]


@pytest.mark.parametrize("fault", ["cpu tensors", "wrong dtype", "strided column"])
def test_kl_wrapper_refuses(fault):
    """The wrapper raises ValueError before any launch: on CPU tensors (the
    plain function is the CPU's trace), on a column of the wrong dtype, and
    on a strided column; no launch is counted."""
    args = _lane_args()
    match = {"cpu tensors": "runs on CUDA tensors", "wrong dtype": "w0 as a",
             "strided column": "contiguous lane columns; rot.4. is strided"}[fault]
    if fault == "wrong dtype":
        args[3] = args[3].double()
    elif fault == "strided column":
        rot = list(args[4])
        rot[4] = torch.rand(256, 2)[:, 0]
        args[4] = tuple(rot)
    before = build.LAUNCHES["trace_layer"]
    with pytest.raises(ValueError, match=match):
        trace_soa.trace_layer_cuda(*args)
    assert build.LAUNCHES["trace_layer"] == before
    if fault == "cpu tensors":
        # The same valid call is what the plain function takes.
        assert trace_soa.check_layer_inputs(*args) == 256
        assert trace_soa.trace_layer_soa(*args).w.shape == (7, 256)


@pytest.mark.parametrize("name", ["two_layer", "ms", "pool", "color", "pyramid"])
def test_engine_calls_meet_kl_contract(monkeypatch, name):
    """Every layer-trace call the engine makes on the general path's scenes
    passes KL's input check, so the "cuda" kernel set takes each of them."""
    eng, calls = _recorded_calls(monkeypatch, name, 2048, "cpu", check=True)
    shared = [args[5].plane_n.shape[0] == 1 and len(kw["setting_blocks"]) == 1
              for args, kw in calls]
    if name == "pool":
        assert not any(shared)
    if name == "two_layer":
        assert all(shared) and len(calls) == 2


# Which epilogue each layer takes after its calibrating batch, and why.
EPILOGUES = {
    "two_layer": ["kernel", "kernel"],
    "multi": ["kernel", "kernel"],
    "pyramid": ["kernel", "kernel", "kernel"],
    "ms": ["plain: lens 2", "plain: filter"],   # fisheye equidistant; layer 2's filter
    "color": ["plain: colour"],
}


def _engine(monkeypatch, name, batch, device="cpu", kernels="plain", slot_cap=None):
    doc, pallas = SCENES[name]
    monkeypatch.setenv("IHT_STEPS_PER_DISPATCH", "1")
    for knob in ("IHT_PALLAS_TRACE", "IHT_SLOT_CAP", "IHT_MIN_EMIT_W", "IHT_EMIT_FLOOR"):
        monkeypatch.delenv(knob, raising=False)
    if pallas is not None:
        monkeypatch.setenv("IHT_PALLAS_TRACE", pallas)
    if slot_cap is not None:
        monkeypatch.setenv("IHT_SLOT_CAP", slot_cap)
    return Engine(load_project(copy.deepcopy(doc)), seed=3000000019, batch_size=batch,
                  device=device, kernels=kernels)


@pytest.mark.parametrize("name", sorted(EPILOGUES))
def test_layer_epilogue_record(monkeypatch, name):
    """Engine.layer_epilogue (and profiling.snapshot) names the epilogue of
    every layer: the calibrating batch's is the plain one ("plain:
    calibrating"), then KL's emit mode ("kernel") on light_two_layer_ms,
    MULTI_CFG and PYRAMID3_CFG, and the plain one with its first reason on
    MS_CFG and COLOR_CFG. The emit mode's calls go to the kernel set's
    trace_layer_emit (its plain twin here), the others to trace_layer."""
    eng = _engine(monkeypatch, name, 2048)
    calls = {"trace_layer": 0, "trace_layer_emit": 0}

    def counted(field):
        fn = getattr(eng.ks, field)

        def call(*args, **kw):
            calls[field] += 1
            return fn(*args, **kw)
        return call

    eng.ks = eng.ks._replace(trace_layer=counted("trace_layer"),
                             trace_layer_emit=counted("trace_layer_emit"))
    n = len(eng.layers)
    assert eng.layer_epilogue == [None] * n
    eng.run(n_batches=1)
    assert eng.layer_epilogue == ["plain: calibrating"] * n
    assert calls == {"trace_layer": n, "trace_layer_emit": 0}
    eng.run(n_batches=1)
    want = EPILOGUES[name]
    assert eng.layer_epilogue == want
    assert profiling.snapshot(eng)["engines"][0]["layer_epilogue"] == want
    n_kernel = want.count("kernel")
    assert calls == {"trace_layer": 2 * n - n_kernel, "trace_layer_emit": n_kernel}


def _emit_args(B=256, lens=None, n_renders=1):
    """A valid emit-mode call's arguments on the CPU (_lane_args and a spec
    at cap 5 into BENCH_CFG's render)."""
    cfg = load_project(copy.deepcopy(BENCH_CFG))
    plan = projection.make_proj_plan(cfg.renders[0])
    if lens is not None:
        plan = plan._replace(lens_type=int(lens))
    spec = trace_soa.EmitSpec(prob=0.5, last=False, emit_frac=1e-3, rr=True, cap=5,
                              renders=(plan,) * n_renders)
    return _lane_args(B), dict(w_scale=torch.tensor(0.5), spec=spec)


@pytest.mark.parametrize("fault", ["lens", "renders", "strided column", "no cap",
                                   "cpu tensors"])
def test_kl_emit_wrapper_refuses(fault):
    """The emit mode's wrapper raises ValueError before any launch: a lens
    outside SUPPORTED_LENSES (fisheye equidistant), more renders than the
    kernel's kMaxR, a strided lane column, the calibrating batch's missing
    cap, and CPU tensors (the plain twin is the CPU's); no launch is
    counted. Where it refuses a spec, the engine's rule says why."""
    args, kw = _emit_args(lens=2 if fault == "lens" else None,
                          n_renders=5 if fault == "renders" else 1)
    match = {"lens": "cannot project here: lens 2", "renders": "cannot project here: 5 renders",
             "strided column": "contiguous lane columns; rot.4. is strided",
             "no cap": "needs a slot cap", "cpu tensors": "runs on CUDA tensors"}[fault]
    if fault == "strided column":
        rot = list(args[4])
        rot[4] = torch.rand(256, 2)[:, 0]
        args[4] = tuple(rot)
    if fault == "no cap":
        kw["spec"] = kw["spec"]._replace(cap=None)
    before = build.LAUNCHES["trace_layer_emit"]
    with pytest.raises(ValueError, match=match):
        trace_soa.trace_layer_emit_cuda(*args, **kw)
    assert build.LAUNCHES["trace_layer_emit"] == before
    reason = trace_soa.emit_refusal(kw["spec"].renders)
    assert reason == {"lens": "lens 2", "renders": "5 renders"}.get(fault)
    if fault == "cpu tensors":
        rows = trace_soa.trace_layer_emit_plain(*args, **kw)
        assert [x.shape for x in rows.pix] == [(5, 256)] * 2    # main and overlap pass
        assert rows.cont[0].shape == (7, 256) and rows.dropped.shape == (256,)


def _uniform_slots(seed_vec, ray_idx, slots):
    """The engine's per-slot draw as it was (frozen)."""
    idx = rng._t(ray_idx)[None, :]
    inner = rng.pcg_hash((idx * 1000003 + slots) & MASK32)
    return rng.u01(rng.pcg_hash(rng._t(seed_vec)[None, :] ^ inner))


def _inline_epilogue(exits, seed, ray_idx, w_scale, spec):
    """The epilogue as the engine inlined it in _trace_batch_impl before
    trace_soa.layer_epilogue took it out (frozen; the paths without a
    filter or a colour class). Returns (per render the flat (pix, w) rows,
    main pass then overlap pass; landed [R]; dropped; segments; the
    continuing weight [H * B] or None; slot mass [H])."""
    H, b_l = exits.w.shape
    dev = exits.w.device
    slot_ids = torch.arange(H, dtype=I64, device=dev)[:, None]
    slot_len = torch.arange(1, H + 1, dtype=I64, device=dev)[:, None]
    dropped_w = torch.zeros((), dtype=F32, device=dev)
    slot_mass = torch.zeros(H, dtype=F32, device=dev)
    exit_w = exits.w
    seg_count = torch.where(exit_w > 0.0, slot_len, 0).amax(dim=0).sum()
    to_continue = None
    acc_mask = None
    if spec.prob > 0.0:
        u = _uniform_slots(seed ^ rng.NONCE_GATE, ray_idx, 100 + slot_ids)
        if spec.last:
            acc_mask = u >= spec.prob
        else:
            to_continue = (u < spec.prob) & (exit_w > 0.0)
            acc_mask = ~to_continue
    acc_w = exit_w if acc_mask is None else torch.where(acc_mask, exit_w, 0.0)
    if spec.emit_frac > 0.0:
        w_cut = w_scale * float(np.float32(spec.emit_frac))
        tiny = (acc_w > 0.0) & (acc_w < w_cut)
        if spec.rr:
            u_rr = _uniform_slots(seed ^ rng.NONCE_EMIT, ray_idx, slot_ids)
            new_w = torch.where(
                tiny, torch.where(u_rr * w_cut < acc_w, w_cut, 0.0), acc_w)
        else:
            new_w = torch.where(tiny, 0.0, acc_w)
        dropped_w = dropped_w + torch.sum(acc_w) - torch.sum(new_w)
        acc_w = new_w
    cap = spec.cap if spec.cap is not None else H
    if spec.cap is None:
        lv = acc_w > 0.0
        rank = torch.cumsum(lv.to(I64), dim=0) - lv.to(I64)
        slot_mass = slot_mass + torch.stack([
            torch.sum(torch.where(lv & (rank == c), acc_w, 0.0)) for c in range(H)])
    if cap < H:
        comp, keep_m, _ = trace_soa.compact_slots(
            acc_w > 0.0, [acc_w, exits.dx, exits.dy, exits.dz], cap)
        cw = torch.where(keep_m, comp[0], 0.0)
        dropped_w = dropped_w + torch.sum(acc_w) - torch.sum(cw)
        flat_w = cw.reshape(-1)
        flat_dx, flat_dy, flat_dz = (comp[i].reshape(-1) for i in (1, 2, 3))
    else:
        flat_w = acc_w.reshape(-1)
        flat_dx, flat_dy, flat_dz = (x.reshape(-1) for x in (exits.dx, exits.dy, exits.dz))
    rows, landed = [], []
    for pplan in spec.renders:
        hits = projection.project_components(pplan, flat_dx, flat_dy, flat_dz)
        main_ok = (hits.main >= 0) & (flat_w > 0.0)
        w_row = torch.where(main_ok, flat_w, 0.0)
        rows.append((torch.where(main_ok, hits.main, -1), w_row))
        landed.append(torch.sum(w_row))
        if pplan.max_abs_dz > 0.0:
            ov_ok = (hits.overlap >= 0) & (flat_w > 0.0)
            rows.append((torch.where(ov_ok, hits.overlap, -1),
                         torch.where(ov_ok, flat_w, 0.0)))
    cont = None
    if not spec.last:
        cont = (torch.zeros(H * b_l, dtype=F32, device=dev) if to_continue is None
                else torch.where(to_continue, exit_w, 0.0).reshape(-1))
    return rows, torch.stack(landed), dropped_w, seg_count, cont, slot_mass


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


@pytest.mark.parametrize("case", ["two_layer", "two_layer_cap7", "multi", "last_gate"])
def test_layer_epilogue_equals_the_inline_epilogue(monkeypatch, case):
    """trace_soa.layer_epilogue gives the rows of the engine's former inline
    epilogue bit for bit on the engine's first batches (the calibrating one,
    then two at the calibrated cap; "_cap7": the cap pinned at max_hits, no
    compaction): every (render, pass) column's pixels and weights, the
    landed weight's sums, the segments, the continuing weight and the slot
    mass. The dropped weight, now a per-lane running sum, agrees with the
    former float32 sum differences to their rounding."""
    name = case.replace("_cap7", "")
    pinned = case.endswith("_cap7")
    eng = _engine(monkeypatch, name, 2048, slot_cap="off" if pinned else None)
    seen = []
    real = trace_soa.layer_epilogue

    def record(exits, seed, ray_idx, w_scale, spec, **kw):
        rows = real(exits, seed, ray_idx, w_scale, spec, **kw)
        seen.append((exits, seed, ray_idx, w_scale, spec, rows))
        return rows

    monkeypatch.setattr(trace_soa, "layer_epilogue", record)
    eng.run(n_batches=1)
    eng.run(n_batches=2)
    assert len(seen) == 3 * len(eng.layers)
    caps = [spec.cap for *_, spec, _ in seen]
    assert caps == [7 if pinned else None] * len(eng.layers) + [eng._slot_cap] * (2 * len(eng.layers))
    assert (eng._slot_cap == eng.max_hits) == pinned, eng._slot_cap
    for exits, seed, ray_idx, w_scale, spec, rows in seen:
        want_rows, landed, dropped, segs, cont, slot_mass = _inline_epilogue(
            exits, seed, ray_idx, w_scale, spec)
        assert len(rows.pix) == len(want_rows)
        for (pix, w), got_pix, got_w in zip(want_rows, rows.pix, rows.w):
            assert torch.equal(pix, got_pix.reshape(-1))
            assert torch.equal(_bits(w), _bits(got_w.reshape(-1)))
        k, got_landed = 0, []
        for pp in spec.renders:
            got_landed.append(torch.sum(rows.w[k].reshape(-1)))
            k += 2 if pp.max_abs_dz > 0.0 else 1
        assert torch.equal(_bits(torch.stack(got_landed)), _bits(landed))
        assert int(rows.seg.sum()) == int(segs)
        if cont is None:
            assert rows.cont is None
        else:
            assert torch.equal(_bits(rows.cont[0].reshape(-1)), _bits(cont))
        if spec.cap is None:
            assert torch.equal(_bits(rows.slot_mass), _bits(slot_mass))
        else:
            assert rows.slot_mass is None
        # The former float32 sums rounded at the scale of the layer's mass.
        got = float(rows.dropped.double().sum())
        assert abs(got - float(dropped)) <= 1e-5 * float(exits.w.double().sum()), (
            got, float(dropped))


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (KL has no CPU mode)")
    return torch.device("cuda", 0)


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["two_layer", "pool", "ms", "pyramid", "no_entry"])
def test_kl_bit_equal_to_plain(monkeypatch, dev, case):
    """KL's six outputs equal trace_layer_soa's bit for bit on the calls of
    one engine batch: the cell's two layers at its batch (layer 2's lanes
    with their zero-weight tail), POOL_CFG's sampled shapes (K > 1), MS_CFG's
    settings, the pyramid's 20 face slots, and the cell's first layer with
    every third lane's direction zeroed (no entry triangle there). Each
    launch is synchronised and counted once."""
    scene = "two_layer" if case == "no_entry" else case
    batch = {"two_layer": CELL_BATCH, "pyramid": 8192}.get(scene, 32768)
    _, calls = _recorded_calls(monkeypatch, scene, batch, dev)
    if case == "no_entry":
        args, kw = calls[0]
        dead = torch.arange(args[1].shape[0], device=dev) % 3 == 0
        args = list(args)
        args[2] = tuple(torch.where(dead, 0.0, x) for x in args[2])
        calls = [(tuple(args), kw)]
    if case == "two_layer":
        lanes = [args[1].shape[0] for args, _ in calls]
        assert lanes[0] == CELL_BATCH and lanes[1] > CELL_BATCH, lanes
        assert (calls[1][0][3] == 0).any()              # the tail's zero-weight lanes
    for args, kw in calls:
        before = build.LAUNCHES["trace_layer"]
        got = trace_soa.trace_layer_cuda(*args, **kw)
        torch.cuda.synchronize(dev)
        assert build.LAUNCHES["trace_layer"] == before + 1
        want = trace_soa.trace_layer_soa(*args, **kw)
        for field, a, b in zip(want._fields, got, want):
            assert a.dtype == b.dtype and a.shape == b.shape, field
            assert torch.equal(_bits(a), _bits(b)), (
                case, field, int((_bits(a) != _bits(b)).sum()))
        if case == "no_entry":
            assert not got.entry_ok[dead].any() and got.entry_ok[~dead].any()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["two_layer", "multi", "pyramid", "last_gate", "tail"])
def test_kl_emit_bit_equal_to_plain(monkeypatch, dev, case):
    """KL's emit mode equals its plain twin (trace_layer_soa, then
    layer_epilogue) bit for bit on the emit-mode calls of one steady engine
    batch: light_two_layer_ms at the cell's batch, MULTI_CFG, PYRAMID3_CFG,
    a last layer with prob > 0 (BENCH_CFG's one layer at 0.3), and the
    cell's configuration in a tail batch (n_active < B). Every (render,
    pass) column, the per-lane segments and dropped mass and the
    continuation's columns, and each main column's torch.sum (the landed
    weight) from both. Each launch is synchronised and counted once."""
    scene = "two_layer" if case == "tail" else case
    batch = {"two_layer": CELL_BATCH, "pyramid": 8192}.get(scene, 32768)
    eng = _engine(monkeypatch, scene, batch, device=dev)
    calls = []
    real = eng.ks.trace_layer_emit

    def record(*args, **kw):
        calls.append((args, kw))
        return real(*args, **kw)

    eng.ks = eng.ks._replace(trace_layer_emit=record)
    eng.run(n_batches=1)                               # the calibrating batch
    assert not calls
    if case == "tail":
        eng._trace_batch_impl(torch.tensor(1, device=dev), n_active=batch // 3)
        assert (calls[0][0][3][batch // 3:] == 0).all() and (calls[0][0][3] > 0).any()
    else:
        eng.run(n_batches=1)
    assert len(calls) == len(eng.layers)
    if scene == "two_layer":
        specs = [kw["spec"] for _, kw in calls]
        assert [s.prob for s in specs] == [1.0, 0.0] and specs[0].cap < eng.max_hits
        assert [s.last for s in specs] == [False, True]
    for args, kw in calls:
        before = build.LAUNCHES["trace_layer_emit"]
        got = trace_soa.trace_layer_emit_cuda(*args, **kw)
        torch.cuda.synchronize(dev)
        assert build.LAUNCHES["trace_layer_emit"] == before + 1
        want = trace_soa.trace_layer_emit_plain(*args, **kw)
        assert len(got.pix) == len(want.pix) and len(got.w) == len(want.w)
        for field, a, b in [("pix", *p) for p in zip(got.pix, want.pix)] + \
                [("w", *p) for p in zip(got.w, want.w)] + \
                [("seg", got.seg, want.seg), ("dropped", got.dropped, want.dropped)] + \
                [("cont", *p) for p in zip(got.cont or (), want.cont or ())]:
            assert a.dtype == b.dtype and a.shape == b.shape, field
            assert torch.equal(_bits(a), _bits(b)), (case, field, int((_bits(a) != _bits(b)).sum()))
        assert (got.cont is None) == (want.cont is None) == kw["spec"].last
        assert got.mask is None and want.mask is None and want.slot_mass is None
        k = 0
        for pp in kw["spec"].renders:
            assert torch.equal(_bits(torch.sum(got.w[k].reshape(-1))),
                               _bits(torch.sum(want.w[k].reshape(-1))))
            k += 2 if pp.max_abs_dz > 0.0 else 1
