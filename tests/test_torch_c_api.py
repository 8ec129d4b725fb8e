"""The port's C API (ice_halo_sim_tpu_torch/native/, built by
kernels/capi.py into _build/) on the CPU: twins of tests/test_c_api.py, in
process through ctypes with IHT_PLATFORM=cpu (the library joins the running
interpreter and drives the port's Server), and the standalone C front-end
iht_smoke (marked slow, as there). Without a card and with IHT_PLATFORM
unset, IHT_CreateServer fails with the Server's message.

Every server the C side creates is destroyed; every wait has a timeout.
"""

import ctypes
import json
import os
import subprocess
import sys

import pytest
import torch

from ice_halo_sim_tpu_torch.kernels import capi
from tests.test_c_api import COLOR_SCENE, SCENE

# Tier-1 runs six workers; keep each one to two torch threads.
torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IHT_ERR_RUNTIME = -2


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("IHT_PLATFORM", "cpu")


@pytest.fixture(scope="module")
def native_build():
    return capi.build()


def test_build_goes_to_build_dir(native_build):
    out = os.path.join(REPO, "ice_halo_sim_tpu_torch", "_build", "native")
    assert native_build == {"lib": os.path.join(out, "libiht.so"),
                            "smoke": os.path.join(out, "iht_smoke")}
    mtimes = [os.path.getmtime(p) for p in native_build.values()]
    assert capi.build() == native_build       # up to date: nothing rebuilt
    assert [os.path.getmtime(p) for p in native_build.values()] == mtimes


@pytest.mark.slow
def test_standalone_c_frontend(native_build, tmp_path):
    """iht_smoke embeds Python itself and exercises the full C surface."""
    scene = tmp_path / "scene.json"
    scene.write_text(json.dumps(SCENE))
    env = dict(os.environ, IHT_PLATFORM="cpu",
               PYTHONPATH=os.pathsep.join([REPO] + [p for p in sys.path if p]))
    res = subprocess.run([native_build["smoke"], str(scene)], env=env, capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0, f"stderr: {res.stderr}\nstdout: {res.stdout}"
    assert "iht_smoke OK" in res.stdout


@pytest.fixture(scope="module")
def lib(native_build):
    lib = ctypes.CDLL(native_build["lib"])
    lib.IHT_ApiVersion.restype = ctypes.c_int
    lib.IHT_LastError.restype = ctypes.c_char_p
    lib.IHT_CreateServer.argtypes = [ctypes.POINTER(ctypes.c_void_p), ctypes.c_uint,
                                     ctypes.c_int]
    lib.IHT_CommitSceneJson.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                        ctypes.POINTER(ctypes.c_int)]
    lib.IHT_WaitIdle.argtypes = [ctypes.c_void_p, ctypes.c_double]
    lib.IHT_GetSimRayCount.argtypes = [ctypes.c_void_p]
    lib.IHT_GetSimRayCount.restype = ctypes.c_longlong
    lib.IHT_AcquireResultFrame.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p)]
    lib.IHT_FrameGetRenderSize.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                           ctypes.POINTER(ctypes.c_int),
                                           ctypes.POINTER(ctypes.c_int)]
    lib.IHT_FrameGetRender.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p,
                                       ctypes.c_size_t]
    lib.IHT_FrameGetGeneration.argtypes = [ctypes.c_void_p]
    lib.IHT_FrameGetGeneration.restype = ctypes.c_longlong
    lib.IHT_DestroyServer.argtypes = [ctypes.c_void_p]
    lib.IHT_ReleaseResultFrame.argtypes = [ctypes.c_void_p]
    lib.IHT_ValidateRaypathText.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.IHT_FrameHasComposite.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.IHT_FrameGetComposite.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                          ctypes.POINTER(ctypes.c_float), ctypes.c_size_t]
    lib.IHT_FrameGetLanded.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                       ctypes.POINTER(ctypes.c_double)]
    lib.IHT_FrameGetEvAuto.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                       ctypes.POINTER(ctypes.c_double)]
    lib.IHT_SetRaypathColors.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.IHT_SetCompositeExposure.argtypes = [ctypes.c_void_p, ctypes.c_double]
    lib.IHT_GetColorClassSignal.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
                                            ctypes.c_int]
    lib.IHT_GetColorOverflowInfo.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
                                             ctypes.POINTER(ctypes.c_int)]
    lib.IHT_GetDrainStatus.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong),
                                       ctypes.POINTER(ctypes.c_longlong)]
    lib.IHT_GetSimLifecycle.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
                                        ctypes.POINTER(ctypes.c_longlong)]
    lib.IHT_SetLogLevel.argtypes = [ctypes.c_char_p]
    lib.IHT_GetCrystalMesh.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int), ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_int)]
    lib.IHT_IsShapeScalarApplicable.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.IHT_ShapeScalarSyncKeyName.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.IHT_ShapeScalarSyncKeyName.restype = ctypes.c_char_p
    return lib


def _create(lib, seed):
    server = ctypes.c_void_p()
    assert lib.IHT_CreateServer(ctypes.byref(server), seed, 16384) == 0, lib.IHT_LastError()
    return server


def test_create_server_needs_a_card_unless_told(lib, monkeypatch):
    """IHT_PLATFORM unset: the Server takes "cuda" and, without a card,
    fails with its message; nothing runs on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.delenv("IHT_PLATFORM")
    server = ctypes.c_void_p()
    assert lib.IHT_CreateServer(ctypes.byref(server), 7, 16384) == IHT_ERR_RUNTIME
    assert b"needs a CUDA device" in lib.IHT_LastError()
    assert server.value is None
    monkeypatch.setenv("IHT_PLATFORM", "tpu")
    assert lib.IHT_CreateServer(ctypes.byref(server), 7, 16384) == IHT_ERR_RUNTIME
    assert b"IHT_PLATFORM" in lib.IHT_LastError()


def test_inprocess_ctypes_roundtrip(lib):
    """libiht joins the running interpreter (GUI/FFI embedding mode)."""
    assert lib.IHT_ApiVersion() == 1
    server = _create(lib, 7)
    try:
        reused = ctypes.c_int(-1)
        rc = lib.IHT_CommitSceneJson(server, json.dumps(SCENE).encode(), ctypes.byref(reused))
        assert rc == 0, lib.IHT_LastError()
        assert reused.value == 0
        assert lib.IHT_WaitIdle(server, 300.0) == 0
        assert lib.IHT_GetSimRayCount(server) >= SCENE["scene"]["ray_num"]
        frame = ctypes.c_void_p()
        assert lib.IHT_AcquireResultFrame(server, ctypes.byref(frame)) == 0
        w, h = ctypes.c_int(), ctypes.c_int()
        assert lib.IHT_FrameGetRenderSize(frame, 0, ctypes.byref(w), ctypes.byref(h)) == 0
        assert (w.value, h.value) == (64, 64)
        buf = ctypes.create_string_buffer(w.value * h.value * 3)
        assert lib.IHT_FrameGetRender(frame, 0, buf, len(buf)) == 0
        assert any(b > 10 for b in buf.raw)
        assert lib.IHT_ReleaseResultFrame(frame) == 0
    finally:
        assert lib.IHT_DestroyServer(server) == 0


def test_validation_helpers_no_python(lib):
    assert lib.IHT_ValidateRaypathText(b"3-5-1", -1) == 0
    assert lib.IHT_ValidateRaypathText(b"3-5-", -1) == 1
    assert lib.IHT_ValidateRaypathText(b"3--5", -1) == 2
    assert lib.IHT_ValidateRaypathText(b"3-13", 0) == 2
    assert lib.IHT_ValidateRaypathText(b"3-13", 1) == 0


def test_display_time_color_control(lib):
    """Composites, colour-class signal, raypath-colour updates, drain
    status and lifecycle through the C surface."""
    server = _create(lib, 3)
    try:
        rc = lib.IHT_CommitSceneJson(server, json.dumps(COLOR_SCENE).encode(), None)
        assert rc == 0, lib.IHT_LastError()
        assert lib.IHT_WaitIdle(server, 300.0) == 0

        cur, drained = ctypes.c_longlong(-1), ctypes.c_longlong(-1)
        assert lib.IHT_GetDrainStatus(server, ctypes.byref(cur), ctypes.byref(drained)) == 0
        assert cur.value == drained.value == 1
        state, epoch = ctypes.c_int(-1), ctypes.c_longlong(-1)
        assert lib.IHT_GetSimLifecycle(server, ctypes.byref(state), ctypes.byref(epoch)) == 0
        assert state.value == 0 and epoch.value == 1

        sig = (ctypes.c_int * 8)()
        assert lib.IHT_GetColorClassSignal(server, sig, 8) == 2
        assert sig[1] == 1
        oc, cap = ctypes.c_int(-1), ctypes.c_int(-1)
        assert lib.IHT_GetColorOverflowInfo(server, ctypes.byref(oc), ctypes.byref(cap)) == 0
        assert oc.value == 0 and cap.value > 0

        frame = ctypes.c_void_p()
        assert lib.IHT_AcquireResultFrame(server, ctypes.byref(frame)) == 0
        assert lib.IHT_FrameHasComposite(frame, 0) == 1
        w, h = ctypes.c_int(), ctypes.c_int()
        lib.IHT_FrameGetRenderSize(frame, 0, ctypes.byref(w), ctypes.byref(h))
        comp = (ctypes.c_float * (w.value * h.value * 3))()
        assert lib.IHT_FrameGetComposite(frame, 0, comp, len(comp)) == 0
        arr = list(comp)
        assert max(arr) > 0.0
        landed = ctypes.c_double(-1)
        assert lib.IHT_FrameGetLanded(frame, 0, ctypes.byref(landed)) == 0
        assert landed.value > 0
        ev = ctypes.c_double()
        assert lib.IHT_FrameGetEvAuto(frame, 0, ctypes.byref(ev)) == 0
        lib.IHT_ReleaseResultFrame(frame)

        upd = {"classes": [{"color": [0, 0, 1]}, {"color": [0, 1, 0], "visible": False}]}
        assert lib.IHT_SetRaypathColors(server, json.dumps(upd).encode()) == 0, \
            lib.IHT_LastError()
        assert lib.IHT_SetCompositeExposure(server, 1.5) == 0
        frame2 = ctypes.c_void_p()
        assert lib.IHT_AcquireResultFrame(server, ctypes.byref(frame2)) == 0
        assert lib.IHT_FrameGetGeneration(frame2) == 1
        comp2 = (ctypes.c_float * (w.value * h.value * 3))()
        assert lib.IHT_FrameGetComposite(frame2, 0, comp2, len(comp2)) == 0
        assert list(comp2) != arr
        lib.IHT_ReleaseResultFrame(frame2)
        bad = {"classes": [{"color": [1, 0, 0]}]}
        assert lib.IHT_SetRaypathColors(server, json.dumps(bad).encode()) != 0
    finally:
        assert lib.IHT_DestroyServer(server) == 0


def test_crystal_mesh_and_shape_scalars(lib):
    nv, nt = ctypes.c_int(-1), ctypes.c_int(-1)
    cjson = json.dumps({"type": "prism", "shape": {"height": 1.0}}).encode()
    assert lib.IHT_GetCrystalMesh(cjson, None, 0, ctypes.byref(nv), None, 0,
                                  ctypes.byref(nt)) == 0
    assert nv.value == 12 and nt.value == 20
    verts = (ctypes.c_float * (nv.value * 3))()
    tris = (ctypes.c_int * (nt.value * 3))()
    assert lib.IHT_GetCrystalMesh(cjson, verts, len(verts), ctypes.byref(nv), tris, len(tris),
                                  ctypes.byref(nt)) == 0
    assert max(verts) > 0 and 0 <= min(tris) and max(tris) < nv.value
    pjson = json.dumps({"type": "pyramid",
                        "shape": {"upper_h": 0.5, "prism_h": 1.0, "lower_h": 0.0}}).encode()
    assert lib.IHT_GetCrystalMesh(pjson, None, 0, ctypes.byref(nv), None, 0,
                                  ctypes.byref(nt)) == 0
    assert nv.value >= 12 and nt.value >= 20
    assert lib.IHT_IsShapeScalarApplicable(0, 0) == 1
    assert lib.IHT_IsShapeScalarApplicable(0, 1) == 0
    assert lib.IHT_IsShapeScalarApplicable(1, 0) == 0
    assert all(lib.IHT_IsShapeScalarApplicable(k, s) == 1 for k in (0, 1) for s in range(4, 10))
    assert lib.IHT_ShapeScalarSyncKeyName(0, 0) == b"height"
    assert lib.IHT_ShapeScalarSyncKeyName(1, 2) == b"prism_h"
    assert lib.IHT_ShapeScalarSyncKeyName(0, 5) == b"face_distance"
    assert lib.IHT_ShapeScalarSyncKeyName(1, 0) is None


def test_log_level_and_callback(lib):
    from ice_halo_sim_tpu_torch.utils.log import get_logger

    assert lib.IHT_SetLogLevel(b"debug") == 0
    assert lib.IHT_SetLogLevel(b"nonsense") != 0
    seen = []
    CB = ctypes.CFUNCTYPE(None, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
                          ctypes.c_void_p)
    cb = CB(lambda level, logger, msg, user: seen.append((level, msg)))
    lib.IHT_SetLogCallback.argtypes = [CB, ctypes.c_void_p]
    assert lib.IHT_SetLogCallback(cb, None) == 0
    get_logger("test").warning("hello from C callback test")
    assert any(b"hello from C callback test" in m for _, m in seen)
    assert lib.IHT_SetLogCallback(ctypes.cast(None, CB), None) == 0
    n0 = len(seen)
    get_logger("test").warning("after uninstall")
    assert len(seen) == n0
    assert lib.IHT_SetLogLevel(b"warning") == 0
