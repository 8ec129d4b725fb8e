"""The general path's layer trace: KL (csrc/trace_layer.cu, the render mode
of ``core/trace_soa.trace_layer_soa`` in one launch) and its wiring.

On the CPU: which function each kernel set traces with, the wrapper's
refusals, and that every call the engine makes on the general path's scenes
meets the wrapper's contract (so the card's engine never meets a refusal).
On the card (marker ``cuda``): KL against ``trace_layer_soa`` on the calls
the engine makes, every output bit for bit.

    python -m pytest tests/test_torch_trace_layer.py -q -p no:cacheprovider
    python -m pytest -m cuda tests/test_torch_trace_layer.py -q --noconftest   # on the card
"""

import copy
import json
import os

import pytest
import torch

from ice_halo_sim_tpu_torch.config.loader import load_project
from ice_halo_sim_tpu_torch.core import trace_soa
from ice_halo_sim_tpu_torch.engine.simulator import Engine
from ice_halo_sim_tpu_torch.kernels import build, kernel_set
from ice_halo_sim_tpu_torch.scenes import COLOR_CFG, MS_CFG, POOL_CFG, PYRAMID3_CFG

# Tier-1 runs six workers; keep each one to two torch threads.
torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL_BATCH = 229376     # light_two_layer.r512's batch


def _two_layer_doc():
    with open(os.path.join(ROOT, "portbench", "configs", "light_two_layer_ms.json")) as f:
        return json.load(f)["document"]


# Scenes of the general path: (document, IHT_PALLAS_TRACE, what it exercises).
SCENES = {
    "two_layer": (_two_layer_doc(), None),      # one shared shape; layer 2's tail lanes
    "ms": (MS_CFG, None),                       # several settings a layer, filters
    "pool": (POOL_CFG, "0"),                    # K > 1 sampled shapes (pool rows per lane)
    "color": (COLOR_CFG, None),                 # colour classes
    "pyramid": (PYRAMID3_CFG, None),            # 20 face slots, three layers
}


def _recorded_calls(monkeypatch, name, batch, device, check=False):
    """Run one batch of scene `name` with the plain kernel set, recording
    every call of ``ks.trace_layer`` (its arguments); with `check`, each
    call first goes through KL's input check."""
    doc, pallas = SCENES[name]
    monkeypatch.setenv("IHT_STEPS_PER_DISPATCH", "1")
    for knob in ("IHT_PALLAS_TRACE", "IHT_FOLD", "IHT_SLOT_CAP", "IHT_MIN_EMIT_W"):
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


@pytest.mark.parametrize("name", sorted(SCENES))
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
